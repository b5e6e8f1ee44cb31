"""Llama-style decoder-only transformer in PyTorch: the flagship workload
under observation.

Port of ``deepflow_tpu/models/llama.py``. The numerics follow the JAX
reference op for op, so the same weights give the same logits:

- parameters keep the reference's stacked tree (leading dim = n_layers),
  named ``tok_embed``, ``layers.<name>`` and ``final_norm``; the scanned
  layer body becomes a loop over slices of the stacked tensors, and
  autograd accumulates into the stacked leaves;
- RMSNorm, the RoPE rotation and SiLU run in float32 and cast back;
- attention repeats each KV head (``repeat_interleave``, as ``jnp.repeat``),
  takes bf16 scores, divides them by sqrt(head_dim) in float32 (the
  reference's numpy-scalar divisor promotes there), masks with -1e30 and
  softmaxes in float32, then casts the probabilities back before ``@ V``.
  It is plain tensor code like the reference's ``_attention``, not
  ``scaled_dot_product_attention``;
- the LM head is tied to the embedding and returns float32 logits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepflow_tpu_torch.device import resolve_device

LAYER_PARAMS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 11008
    max_seq: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        d = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=128, max_seq=128)
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def llama7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)  # defaults are 7B


def param_shapes(cfg: LlamaConfig) -> dict:
    """The reference's stacked parameter tree, as shapes."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    return {
        "tok_embed": (V, D),
        "layers": {
            "attn_norm": (L, D),
            "wq": (L, D, nh * hd),
            "wk": (L, D, nkv * hd),
            "wv": (L, D, nkv * hd),
            "wo": (L, nh * hd, D),
            "mlp_norm": (L, D),
            "w_gate": (L, D, F_),
            "w_up": (L, D, F_),
            "w_down": (L, F_, D),
        },
        "final_norm": (D,),
    }


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2) float32."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)  # rotation in f32, activations stay bf16


def rope_tables(cfg: LlamaConfig, seq: int, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables computed in float64 numpy, then cast to float32."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2) / hd))
    freqs = np.outer(np.arange(seq), inv)
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device))


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: LlamaConfig) -> torch.Tensor:
    """Causal GQA attention. q: (B,S,H,hd) k,v: (B,S,KV,hd)."""
    S, hd = q.shape[1], q.shape[3]
    groups = cfg.n_heads // cfg.n_kv_heads
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _layer(cfg: LlamaConfig, cos: torch.Tensor, sin: torch.Tensor,
           x: torch.Tensor, lp: dict) -> torch.Tensor:
    B, S, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    h = _rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, nh, hd)
    k = (h @ lp["wk"]).reshape(B, S, nkv, hd)
    v = (h @ lp["wv"]).reshape(B, S, nkv, hd)
    q = _rope(q, cos, sin)
    k = _rope(k, cos, sin)
    attn = _attention(q, k, v, cfg).reshape(B, S, nh * hd)
    x = x + attn @ lp["wo"]

    h = _rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu((h @ lp["w_gate"]).float()).to(x.dtype)
    return x + (gate * (h @ lp["w_up"])) @ lp["w_down"]


class Llama(nn.Module):
    """Parameters named and shaped as the reference's stacked tree.

    Weights are drawn as the reference's ``init_params`` draws them
    (normal * 1/sqrt(fan_in) in float32, cast to cfg.dtype; norms at one),
    from ``generator``; the numbers differ from jax.random's, so tests
    carry one set of weights across with ``params_from_numpy``.
    """

    def __init__(self, cfg: LlamaConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        shapes = param_shapes(cfg)

        def init(name: str, shape: tuple) -> nn.Parameter:
            if name.endswith("norm"):
                t = torch.ones(shape, dtype=cfg.dtype, device=dev)
            else:
                t = (torch.randn(shape, generator=generator, device=dev)
                     / math.sqrt(shape[-2])).to(cfg.dtype)
            return nn.Parameter(t)

        self.tok_embed = init("tok_embed", shapes["tok_embed"])
        self.layers = nn.ParameterDict(
            {n: init(n, shapes["layers"][n]) for n in LAYER_PARAMS})
        self.final_norm = init("final_norm", shapes["final_norm"])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, V) float32."""
        cfg = self.cfg
        cos, sin = rope_tables(cfg, tokens.shape[1], tokens.device)
        x = self.tok_embed[tokens]
        for i in range(cfg.n_layers):
            x = _layer(cfg, cos, sin, x,
                       {n: self.layers[n][i] for n in LAYER_PARAMS})
        x = _rms_norm(x, self.final_norm, cfg.norm_eps)
        # tied embeddings for the LM head
        return torch.einsum("bsd,vd->bsv", x, self.tok_embed).float()


def loss_fn(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over tokens[:, :-1] -> tokens[:, 1:]."""
    logits = model(tokens[:, :-1])
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean()


def make_train_step(model: Llama, optimizer: torch.optim.Optimizer | None
                    = None):
    """Returns (train_step, optimizer). SGD with momentum 0.9 at lr 3e-4
    by default, as the reference's optax.sgd(3e-4, momentum=0.9).
    train_step(tokens) updates the model in place and returns the loss
    computed before the update."""
    if optimizer is None:
        optimizer = torch.optim.SGD(model.parameters(), lr=3e-4,
                                    momentum=0.9)

    def train_step(tokens: torch.Tensor) -> torch.Tensor:
        loss = loss_fn(model, tokens)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step, optimizer


def params_from_numpy(tree: dict, device: str | torch.device = "cuda"
                      ) -> dict[str, torch.Tensor]:
    """The reference's nested numpy tree -> a state dict for
    ``Llama.load_state_dict``. bfloat16 leaves (ml_dtypes) widen exactly to
    float32 on the way and come back as torch.bfloat16."""
    dev = resolve_device(device)

    def conv(a) -> torch.Tensor:
        arr = np.asarray(a)
        bf16 = arr.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(arr, dtype=np.float32 if bf16
                                      else arr.dtype))
        return t.to(dev, torch.bfloat16 if bf16 else t.dtype)

    out = {"tok_embed": conv(tree["tok_embed"]),
           "final_norm": conv(tree["final_norm"])}
    for n in LAYER_PARAMS:
        out[f"layers.{n}"] = conv(tree["layers"][n])
    return out


def params_to_numpy(model: Llama) -> dict:
    """Model weights -> the reference's nested tree, as float32 numpy
    (exact for bfloat16 weights; cast back with ``astype``)."""
    def conv(p: torch.Tensor) -> np.ndarray:
        return p.detach().float().cpu().numpy()

    return {"tok_embed": conv(model.tok_embed),
            "layers": {n: conv(model.layers[n]) for n in LAYER_PARAMS},
            "final_norm": conv(model.final_norm)}
