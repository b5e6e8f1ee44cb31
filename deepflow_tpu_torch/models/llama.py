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

With a mesh (``Llama(..., mesh=...)``, ``parallel/mesh.py``) each rank
holds its block of every parameter under ``param_specs``, the reference's
PartitionSpecs over (data, fsdp, tensor), and the step issues the
collectives that GSPMD inserts for the reference, written out as Megatron
does (``parallel/collectives.py``):

- ``wq``/``wk``/``wv``/``w_gate``/``w_up`` are cut over ``tensor`` by
  columns (heads and the MLP's hidden units), ``wo``/``w_down`` by rows:
  a column-parallel product's input is ``copy_to`` the tensor group and a
  row-parallel product's partial sums are ``reduce_from`` it. Every
  dimension ``param_specs`` cuts must divide by its axis, as the
  reference's ``device_put`` requires (ValueError otherwise); heads need
  not. Where query heads divide over the tensor axis, and KV heads divide
  over it or divide it, each rank attends with whole heads: fewer KV
  heads than tensor ranks are replicated as Megatron does for
  grouped-query attention (each KV head lives on the
  ``tensor / n_kv_heads`` ranks whose query heads use it, and its
  ``wk``/``wv`` gradient is summed over those ranks after the backward
  pass, ``_sum_kv_replicas_``). Where a head straddles ranks (6 heads on
  4), each rank's query, key and value columns are ``all_gather``-ed over
  the tensor axis, every rank attends with all heads, and keeps the
  columns of the output that its rows of ``wo`` take: the reference's
  result, its gradients summed back to each rank's columns;
- every weight's ``fsdp`` cut is ``gather_from`` the fsdp group before
  use, layer by layer (autograd keeps the gathered weights for the
  backward pass, which gathers nothing again); its gradient is
  reduce-scattered back;
- ``tok_embed`` is cut (``tensor``, ``fsdp``): the lookup is
  vocab-parallel (each rank looks up the tokens of its rows, zeros
  elsewhere, summed over ``tensor``), the tied LM head gives logits cut
  over the vocabulary, and the cross-entropy is the full vocabulary's
  ``log_softmax``: the maximum, the sum of exponentials and the target's
  logit each reduced over ``tensor``;
- the batch is cut over ``data`` (the reference's tokens are
  ``P("data", None)``); gradients and the loss are averaged over it, as
  ``parallel/dp.py`` does, in buckets.

With ``sp_axis`` (the reference's long-context mode) the activations are
cut along the sequence over that axis: each rank embeds and runs its
block of positions, attention is ring attention
(``parallel/ring_attention.py``), RoPE and the causal mask take global
positions, and gradients and the loss are averaged over ``sp`` as over
``data``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepflow_tpu_torch.device import resolve_device
from deepflow_tpu_torch.parallel import collectives as pc
from deepflow_tpu_torch.parallel.dp import average_, make_buckets
from deepflow_tpu_torch.parallel.mesh import gather_of, shard_of
from deepflow_tpu_torch.parallel.ring_attention import ring_local
from deepflow_tpu_torch.tpuprobe.comms import CALLS

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


def param_specs(cfg: LlamaConfig) -> dict:
    """The reference's PartitionSpecs over ('data', 'fsdp', 'tensor'), as
    tuples of axis names.

    Megatron-style: attention heads and MLP hidden dim split on 'tensor';
    the orthogonal dim sharded on 'fsdp' (ZeRO-3-ish weight sharding).
    """
    return {
        "tok_embed": ("tensor", "fsdp"),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, "fsdp", "tensor"),
            "wk": (None, "fsdp", "tensor"),
            "wv": (None, "fsdp", "tensor"),
            "wo": (None, "tensor", "fsdp"),
            "mlp_norm": (None, None),
            "w_gate": (None, "fsdp", "tensor"),
            "w_up": (None, "fsdp", "tensor"),
            "w_down": (None, "tensor", "fsdp"),
        },
        "final_norm": (None,),
    }


_SPECS = param_specs(LlamaConfig())
# each leaf's spec by its name in the state dict's last part
_LEAF_SPECS = {**_SPECS["layers"], "tok_embed": _SPECS["tok_embed"],
               "final_norm": _SPECS["final_norm"]}


@dataclasses.dataclass(frozen=True)
class _Axes:
    """The rank's mesh axes a step uses; an axis the mesh lacks is a
    one-rank axis, whose collectives are identities."""
    data: pc.Axis
    fsdp: pc.Axis
    tensor: pc.Axis
    sp: pc.Axis

    @staticmethod
    def of(mesh, sp_axis: str | None = None) -> "_Axes":
        names = () if mesh is None else mesh.mesh_dim_names

        def ax(name: str) -> pc.Axis:
            return (pc.Axis.of(mesh, name) if name in names
                    else pc.Axis(name, None, 1, 0))
        return _Axes(ax("data"), ax("fsdp"), ax("tensor"),
                     ax(sp_axis) if sp_axis else pc.Axis("sp", None, 1, 0))


_SOLO = _Axes.of(None)


def _whole_heads(cfg: LlamaConfig, axes: _Axes) -> bool:
    """True when each tensor rank can attend with whole heads: the query
    heads divide over the axis and the KV heads divide over it or
    divide it. Otherwise heads straddle ranks (``_layer`` gathers)."""
    t, nkv = axes.tensor.size, cfg.n_kv_heads
    return cfg.n_heads % t == 0 and (nkv % t == 0 or t % nkv == 0)


def _kv_replicas(cfg: LlamaConfig, axes: _Axes) -> int:
    """Tensor ranks that hold each KV head: ``tensor / n_kv_heads`` when
    the KV heads are fewer and each rank attends with whole heads
    (Megatron's replication for grouped-query attention), else 1."""
    t, nkv = axes.tensor.size, cfg.n_kv_heads
    return t // nkv if nkv < t and _whole_heads(cfg, axes) else 1


def _check_divides(cfg: LlamaConfig, axes: _Axes) -> None:
    """The reference's rule: every dimension ``param_specs`` cuts divides
    by its mesh axis (JAX's ``device_put`` refuses the rest)."""
    t, f, hd = axes.tensor.size, axes.fsdp.size, cfg.head_dim
    bad = [f"{name} = {n} does not divide by the {axis} axis of {k}"
           for name, n, axis, k in (
               ("n_heads * head_dim (wq columns, wo rows)",
                cfg.n_heads * hd, "tensor", t),
               ("n_kv_heads * head_dim (wk, wv columns)",
                cfg.n_kv_heads * hd, "tensor", t),
               ("d_ff", cfg.d_ff, "tensor", t),
               ("vocab", cfg.vocab, "tensor", t),
               ("d_model", cfg.d_model, "fsdp", f)) if n % k]
    if bad:
        raise ValueError("the sharded Llama cuts every sharded dimension "
                         "into equal blocks: " + "; ".join(bad))


def _shard_leaf(t, name: str, cfg: LlamaConfig, axes: _Axes, mesh):
    """This rank's block of a full leaf under its spec; a replicated KV
    weight's block is all the columns of the KV head its query heads
    use, cut over fsdp only."""
    spec = _LEAF_SPECS[name]
    r = _kv_replicas(cfg, axes)
    if name in ("wk", "wv") and r > 1:
        hd, j = cfg.head_dim, axes.tensor.index // r
        t = t[..., j * hd:(j + 1) * hd]
        spec = tuple(None if a == "tensor" else a for a in spec)
    return shard_of(t, spec, mesh)


def _gather_leaf(p: torch.Tensor, name: str, cfg: LlamaConfig, axes: _Axes,
                 mesh) -> torch.Tensor:
    """The full leaf from every rank's block (every rank must call it);
    of a replicated KV weight, one copy of each head."""
    full = gather_of(p, _LEAF_SPECS[name], mesh)
    r = _kv_replicas(cfg, axes)
    if name in ("wk", "wv") and r > 1:
        *lead, cols = full.shape
        full = full.reshape(*lead, cols // (r * cfg.head_dim), r,
                            cfg.head_dim)[..., 0, :].reshape(*lead, -1)
    return full


def _sum_kv_replicas_(g: torch.Tensor, cfg: LlamaConfig,
                      axes: _Axes) -> None:
    """A replicated KV block's gradient summed over the tensor ranks
    that share it, in place: each rank puts its partial gradient at its
    KV head's slot of a zero buffer, one all-reduce over the tensor
    axis adds the slots, and each rank takes its head's slot back."""
    j = axes.tensor.index // _kv_replicas(cfg, axes)
    buf = g.new_zeros((cfg.n_kv_heads, *g.shape))
    buf[j] = g
    pc.all_reduce_(buf, axes.tensor)
    g.copy_(buf[j])


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
    groups = q.shape[2] // k.shape[2]  # this rank's query heads per KV
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _layer(cfg: LlamaConfig, cos: torch.Tensor, sin: torch.Tensor,
           x: torch.Tensor, lp: dict, axes: _Axes = _SOLO) -> torch.Tensor:
    """One block on this rank's heads and hidden units (all of them
    without a mesh); ``lp`` holds the gathered weights."""
    B, S, _ = x.shape
    t = axes.tensor.size
    hd = cfg.head_dim
    whole = _whole_heads(cfg, axes)
    if whole:
        nh = cfg.n_heads // t
        nkv = max(1, cfg.n_kv_heads // t)  # one replicated head when fewer
    else:
        nh, nkv = cfg.n_heads, cfg.n_kv_heads

    def heads(w: torch.Tensor, n: int) -> torch.Tensor:
        y = h @ w
        if not whole:  # heads straddle ranks: every rank takes them all
            y = pc.all_gather(y, axes.tensor, -1)
        return y.reshape(B, S, n, hd)

    h = pc.copy_to(_rms_norm(x, lp["attn_norm"], cfg.norm_eps), axes.tensor)
    q = _rope(heads(lp["wq"], nh), cos, sin)
    k = _rope(heads(lp["wk"], nkv), cos, sin)
    v = heads(lp["wv"], nkv)
    if axes.sp.group is not None:
        attn = ring_local(q, k, v, axes.sp, causal=True)
    else:
        attn = _attention(q, k, v, cfg)
    attn = attn.reshape(B, S, nh * hd)
    if not whole:  # the columns this rank's rows of wo take
        n = nh * hd // t
        attn = attn[..., axes.tensor.index * n:(axes.tensor.index + 1) * n]
    x = x + pc.reduce_from(attn @ lp["wo"], axes.tensor)

    h = pc.copy_to(_rms_norm(x, lp["mlp_norm"], cfg.norm_eps), axes.tensor)
    gate = F.silu((h @ lp["w_gate"]).float()).to(x.dtype)
    return x + pc.reduce_from((gate * (h @ lp["w_up"])) @ lp["w_down"],
                              axes.tensor)


def _gathered(w: torch.Tensor, name: str, axes: _Axes) -> torch.Tensor:
    """A weight's fsdp blocks put together (one layer's slice, whose
    dims are the spec's less the stacked one)."""
    spec = _LEAF_SPECS[name]
    if name in LAYER_PARAMS:
        spec = spec[1:]
    if axes.fsdp.size == 1 or "fsdp" not in spec:
        return w
    return pc.gather_from(w, axes.fsdp, spec.index("fsdp"))


class Llama(nn.Module):
    """Parameters named and shaped as the reference's stacked tree.

    Weights are drawn as the reference's ``init_params`` draws them
    (normal * 1/sqrt(fan_in) in float32, cast to cfg.dtype; norms at one),
    from ``generator``; the numbers differ from jax.random's, so tests
    carry one set of weights across with ``params_from_numpy``.

    With ``mesh`` each parameter is this rank's block under
    ``param_specs`` (every rank draws the full tensor from the same seed
    and keeps its block), and ``sp_axis`` names the mesh axis the
    sequence is cut over (the module's note).
    """

    def __init__(self, cfg: LlamaConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, mesh=None,
                 sp_axis: str | None = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.axes = _Axes.of(mesh, sp_axis)
        _check_divides(cfg, self.axes)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        shapes = param_shapes(cfg)

        def init(name: str, shape: tuple) -> nn.Parameter:
            if name.endswith("norm"):
                t = torch.ones(shape, dtype=cfg.dtype, device=dev)
            else:
                t = (torch.randn(shape, generator=generator, device=dev)
                     / math.sqrt(shape[-2])).to(cfg.dtype)
            if mesh is not None:
                t = _shard_leaf(t, name, cfg, self.axes, mesh).clone()
            return nn.Parameter(t)

        self.tok_embed = init("tok_embed", shapes["tok_embed"])
        self.layers = nn.ParameterDict(
            {n: init(n, shapes["layers"][n]) for n in LAYER_PARAMS})
        self.final_norm = init("final_norm", shapes["final_norm"])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, V) float32.

        With a mesh: ``tokens`` is this rank's block of the batch at the
        whole sequence; the logits are its block of positions (all of
        them unless ``sp_axis``) over its block of the vocabulary."""
        cfg, axes = self.cfg, self.axes
        S = tokens.shape[1]
        cos, sin = rope_tables(cfg, S, tokens.device)
        if axes.sp.size > 1:
            if S % axes.sp.size:
                raise ValueError(f"sequence {S} does not divide by the "
                                 f"{axes.sp.name!r} axis of {axes.sp.size}")
            n = S // axes.sp.size
            lo = axes.sp.index * n  # global positions of this rank's block
            tokens, cos, sin = (tokens[:, lo:lo + n], cos[lo:lo + n],
                                sin[lo:lo + n])
        embed = _gathered(self.tok_embed, "tok_embed", axes)
        x = self._lookup(embed, tokens)
        for i in range(cfg.n_layers):
            x = _layer(cfg, cos, sin, x,
                       {n: _gathered(self.layers[n][i], n, axes)
                        for n in LAYER_PARAMS}, axes)
        x = _rms_norm(x, self.final_norm, cfg.norm_eps)
        # tied embeddings for the LM head
        x = pc.copy_to(x, axes.tensor)
        return torch.einsum("bsd,vd->bsv", x, embed).float()

    def _lookup(self, embed: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        """Embedding rows of the tokens; over a vocabulary cut on the
        tensor axis, each rank's rows and zeros elsewhere, summed."""
        tensor = self.axes.tensor
        if tensor.size == 1:
            return embed[tokens]
        n = embed.shape[0]
        local = tokens - tensor.index * n
        mine = (local >= 0) & (local < n)
        rows = embed[local.clamp(0, n - 1)]
        rows = torch.where(mine[..., None], rows, rows.new_zeros(()))
        return pc.reduce_from(rows, tensor)


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                        tensor: pc.Axis) -> torch.Tensor:
    """-log_softmax(logits)[target] over the full vocabulary, from this
    rank's block of it: the maximum, the sum of exponentials and the
    target's logit are reduced over the tensor axis."""
    n = logits.shape[-1]
    m = pc.all_reduce_max(logits.detach().amax(-1, keepdim=True), tensor)
    z = logits - m
    sumexp = pc.reduce_from(z.exp().sum(-1), tensor)
    local = targets.long() - tensor.index * n
    mine = (local >= 0) & (local < n)
    tz = z.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    tz = pc.reduce_from(torch.where(mine, tz, tz.new_zeros(())), tensor)
    return torch.log(sumexp) - tz


def loss_fn(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over tokens[:, :-1] -> tokens[:, 1:].

    With a mesh: the mean over this rank's tokens (its block of the
    batch and, with ``sp_axis``, of the positions); the step averages it
    over ``data`` and ``sp``."""
    logits = model(tokens[:, :-1])
    targets = tokens[:, 1:]
    if model.mesh is None:
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(-1, targets[:, :, None].long())[..., 0]
        return -ll.mean()
    sp = model.axes.sp
    n = targets.shape[1] // sp.size
    targets = targets[:, sp.index * n:(sp.index + 1) * n]
    return _vocab_parallel_nll(logits, targets, model.axes.tensor).mean()


def make_train_step(model: Llama, optimizer: torch.optim.Optimizer | None
                    = None):
    """Returns (train_step, optimizer). SGD with momentum 0.9 at lr 3e-4
    by default, as the reference's optax.sgd(3e-4, momentum=0.9).
    train_step(tokens) updates the model in place and returns the loss
    computed before the update.

    With a mesh, ``tokens`` is this rank's block of the batch (rows cut
    over ``data``) at the whole sequence, the returned loss is the mean
    over every rank's tokens (equal on every rank), and
    ``train_step.calls`` holds the collective calls of the last step by
    mesh axis."""
    if optimizer is None:
        optimizer = torch.optim.SGD(model.parameters(), lr=3e-4,
                                    momentum=0.9)
    if model.mesh is not None:
        return _ShardedStep(model, optimizer), optimizer

    def train_step(tokens: torch.Tensor) -> torch.Tensor:
        loss = loss_fn(model, tokens)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step, optimizer


class _ShardedStep:
    """One sharded step: this rank's loss and gradients (with the
    tensor and fsdp collectives inside them), then the gradients and the
    loss averaged over ``data`` and ``sp`` in buckets, then the update
    of this rank's blocks."""

    BUCKET_CAP_BYTES = 25 << 20   # as DataParallelStep's default

    def __init__(self, model: Llama, optimizer) -> None:
        self.model = model
        self.optimizer = optimizer
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.buckets = make_buckets(self.params, self.BUCKET_CAP_BYTES)
        self.calls: dict[str, int] = {}

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        axes = self.model.axes
        before = CALLS.counts()
        loss = loss_fn(self.model, tokens)
        loss.backward()
        if _kv_replicas(self.model.cfg, axes) > 1:
            for name in ("wk", "wv"):
                _sum_kv_replicas_(self.model.layers[name].grad,
                                  self.model.cfg, axes)
        replicas = [a for a in (axes.data, axes.sp) if a.size > 1]

        def sum_(t: torch.Tensor) -> None:
            for a in replicas:
                pc.all_reduce_(t, a)
        mean = average_(self.buckets, loss,
                        math.prod(a.size for a in replicas), sum_)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        after = CALLS.counts()
        self.calls = {k: v - before.get(k, 0) for k, v in after.items()
                      if v > before.get(k, 0)}
        return mean


def params_from_numpy(tree: dict, device: str | torch.device = "cuda",
                      mesh=None, cfg: LlamaConfig | None = None
                      ) -> dict[str, torch.Tensor]:
    """The reference's nested numpy tree -> a state dict for
    ``Llama.load_state_dict``. bfloat16 leaves (ml_dtypes) widen exactly to
    float32 on the way and come back as torch.bfloat16. With a mesh, each
    leaf is this rank's block under ``param_specs``; with ``cfg`` too,
    KV heads fewer than the tensor ranks are replicated as the model
    holds them (the tree's shapes do not give the head size)."""
    dev = resolve_device(device)
    axes = _Axes.of(mesh)

    def conv(a, name: str) -> torch.Tensor:
        arr = np.asarray(a)
        if mesh is not None:
            arr = (_shard_leaf(arr, name, cfg, axes, mesh) if cfg
                   else shard_of(arr, _LEAF_SPECS[name], mesh))
        bf16 = arr.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(arr, dtype=np.float32 if bf16
                                      else arr.dtype))
        return t.to(dev, torch.bfloat16 if bf16 else t.dtype)

    out = {"tok_embed": conv(tree["tok_embed"], "tok_embed"),
           "final_norm": conv(tree["final_norm"], "final_norm")}
    for n in LAYER_PARAMS:
        out[f"layers.{n}"] = conv(tree["layers"][n], n)
    return out


def params_to_numpy(model: Llama) -> dict:
    """Model weights -> the reference's nested tree, as float32 numpy
    copies (exact for bfloat16 weights; cast back with ``astype``), which
    later updates leave as they are. With a mesh, the full tensors
    gathered from every rank's blocks (every rank must call it)."""
    def conv(p: torch.Tensor, name: str) -> np.ndarray:
        p = p.detach()
        if model.mesh is not None:
            p = _gather_leaf(p, name, model.cfg, model.axes, model.mesh)
        return np.array(p.float().cpu())

    return {"tok_embed": conv(model.tok_embed, "tok_embed"),
            "layers": {n: conv(model.layers[n], n) for n in LAYER_PARAMS},
            "final_norm": conv(model.final_norm, "final_norm")}
