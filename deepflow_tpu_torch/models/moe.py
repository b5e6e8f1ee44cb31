"""Mixture-of-Experts FFN with expert parallelism over an 'ep' mesh axis.

Port of ``deepflow_tpu/models/moe.py``. Top-1 (switch) routing: the
router's product in the activations' dtype, then float32 logits, the
argmax (ties to the first expert, in both frameworks) and the softmax
gate; the chosen expert's up / ReLU / down products on its tokens
(capacity-free, exact); the gated combine. ``moe_ffn`` cuts the experts
over the axis: each rank computes its experts' share for the replicated
tokens and an all-reduce over the axis (the reference's ``psum``)
combines them. ``jax.nn.one_hot`` gives a zero row for an id outside
its range, where ``torch.nn.functional.one_hot`` raises, so a token
routed to another rank's expert is masked explicitly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deepflow_tpu_torch.device import resolve_device
from deepflow_tpu_torch.parallel.collectives import Axis, reduce_from


def init_moe_params(d_model: int, d_ff: int, n_experts: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = "cuda",
                    generator: torch.Generator | None = None) -> dict:
    """The reference's tree: normal * 1/sqrt(fan_in) in float32, cast to
    ``dtype`` (other numbers than jax.random's for the same seed)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(dtype)

    s1, s2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {"router": draw((d_model, n_experts), s1),
            "w_up": draw((n_experts, d_model, d_ff), s1),
            "w_down": draw((n_experts, d_ff, d_model), s2)}


def _route(router: torch.Tensor, x: torch.Tensor):
    """(expert of each token, its gate value) from the router."""
    logits = (x @ router).float()
    assign = logits.argmax(-1)                                # (T,)
    gate = torch.softmax(logits, dim=-1)
    return assign, gate.gather(1, assign[:, None])[:, 0]


def _experts(w_up: torch.Tensor, w_down: torch.Tensor, x: torch.Tensor,
             onehot: torch.Tensor, gate_val: torch.Tensor) -> torch.Tensor:
    # expert_in[e] = tokens routed to e (zeros elsewhere): exact, capacity-free
    expert_in = torch.einsum("te,td->etd", onehot, x)
    h = F.relu(torch.einsum("etd,edf->etf", expert_in, w_up))
    out = torch.einsum("etf,efd->etd", h, w_down)
    combined = torch.einsum("etd,te->td", out, onehot)
    return combined * gate_val[:, None].to(x.dtype)


def moe_ffn_dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Reference evaluation (no sharding): top-1 switch FFN.
    x: (T, D) -> (T, D)."""
    assign, gate_val = _route(params["router"], x)
    onehot = F.one_hot(assign, params["w_up"].shape[0]).to(x.dtype)
    return _experts(params["w_up"], params["w_down"], x, onehot, gate_val)


def moe_ffn(params: dict, x: torch.Tensor, mesh, axis: str = "ep"
            ) -> torch.Tensor:
    """Expert-parallel top-1 MoE FFN. ``params`` is the full tree: each
    rank keeps its contiguous block of experts (the leading dim of w_up /
    w_down, which must divide by the axis size); the router and the
    tokens are replicated, and so is the result."""
    ax = Axis.of(mesh, axis)
    n_experts = params["w_up"].shape[0]
    if n_experts % ax.size:
        raise ValueError(f"{n_experts} experts do not divide by the "
                         f"{axis!r} axis of {ax.size}")
    e_local = n_experts // ax.size
    lo = ax.index * e_local
    assign, gate_val = _route(params["router"], x)
    # local expert ids cover [lo, lo + e_local); other tokens get a zero row
    local = assign - lo
    mine = (local >= 0) & (local < e_local)
    onehot = (F.one_hot(local.clamp(0, e_local - 1), e_local)
              * mine[:, None]).to(x.dtype)
    out = _experts(params["w_up"][lo:lo + e_local],
                   params["w_down"][lo:lo + e_local], x, onehot, gate_val)
    return reduce_from(out, ax)
