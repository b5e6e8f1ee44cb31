"""ResNet (v1.5-style bottlenecks) in PyTorch: the data-parallel workload.

Port of ``deepflow_tpu/models/resnet.py``. The numerics follow the JAX
reference op for op, so the same weights give the same logits:

- parameters keep the reference's tree and names: ``stem``,
  ``stem_scale``, ``stem_bias``, ``stages.<i>.<b>.{conv1, conv2, conv3,
  scale1, scale2, scale3, proj}`` and ``head``; convolution weights are
  stored as torch's (out, in, kh, kw) in ``channels_last`` memory, the
  reference's HWIO moved through ``params_from_numpy`` /
  ``params_to_numpy``;
- images come in NHWC as the reference's; the forward runs on the same
  tensor viewed as NCHW in ``channels_last`` memory, so the layout in
  memory is the reference's NHWC;
- "SAME" padding is the reference's (``lax.conv_general_dilated`` and
  ``reduce_window``): total ``max((ceil(n/s)-1)*s + k - n, 0)`` with the
  odd pixel on the high side, padded explicitly (zeros for a
  convolution, -inf for the max pool); ``nn.Conv2d``'s symmetric padding
  gives other numbers at the same output size;
- batch statistics as ``_bn_relu``: the mean of the activations in their
  own dtype (accumulated in float32, as ``jnp.mean`` does), the variance
  in float32, ``rsqrt`` cast back before the product; the stem adds
  ``stem_bias`` after its ReLU;
- the head's product runs in the model's dtype and the logits come back
  in float32.

``make_dp_train_step`` is the reference's ``make_pmap_train_step`` on
``torch.distributed`` (see ``parallel/dp.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepflow_tpu_torch.device import resolve_device

BLOCK_CONVS = ("conv1", "conv2", "conv3", "proj")
BLOCK_SCALES = ("scale1", "scale2", "scale3")


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)       # ResNet-50
    width: int = 64
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(**kw) -> "ResNetConfig":
        d = dict(stage_sizes=(1, 1), width=8, num_classes=10)
        d.update(kw)
        return ResNetConfig(**d)


def param_shapes(cfg: ResNetConfig) -> dict:
    """The reference's parameter tree, as shapes (convolutions in HWIO)."""
    tree = {"stem": (7, 7, 3, cfg.width), "stem_scale": (cfg.width,),
            "stem_bias": (cfg.width,), "stages": []}
    cin = cfg.width
    for i, n_blocks in enumerate(cfg.stage_sizes):
        cout = cfg.width * (2 ** i) * 4
        mid = cfg.width * (2 ** i)
        stage = []
        for b in range(n_blocks):
            blk = {"conv1": (1, 1, cin, mid), "conv2": (3, 3, mid, mid),
                   "conv3": (1, 1, mid, cout), "scale1": (mid,),
                   "scale2": (mid,), "scale3": (cout,)}
            if b == 0 and cin != cout:
                blk["proj"] = (1, 1, cin, cout)
            stage.append(blk)
            cin = cout
        tree["stages"].append(stage)
    tree["head"] = (cin, cfg.num_classes)
    return tree


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of one spatial dim under XLA's "SAME"."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0
              ) -> torch.Tensor:
    """x (N, C, H, W): pad H and W as "SAME" does for a k x k window at
    stride s (the odd pixel on the high side)."""
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1
          ) -> torch.Tensor:
    """The reference's ``_conv``: w in (out, in, k, k)."""
    return F.conv2d(_pad_same(x, w.shape[-1], stride), w, stride=stride)


def _bn_relu(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Batch-statistics normalization over (N, H, W), then ReLU."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3), keepdim=True).to(x.dtype)
    var = x32.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + 1e-5).to(x.dtype)
    return F.relu(x * _channel(scale))


def _channel(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over (N, C, H, W)."""
    return v[None, :, None, None]


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 / 2 max pool with "SAME" padding by -inf."""
    return F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)


def block_forward(x: torch.Tensor, blk, stride: int) -> torch.Tensor:
    """One bottleneck block, as the reference's loop body. ``blk`` maps
    the block's parameter names to tensors."""
    residual = x
    h = _bn_relu(_conv(x, blk["conv1"]), blk["scale1"])
    h = _bn_relu(_conv(h, blk["conv2"], stride=stride), blk["scale2"])
    h = _conv(h, blk["conv3"]) * _channel(blk["scale3"])
    if "proj" in blk:
        residual = _conv(residual, blk["proj"], stride=stride)
    elif stride != 1:
        # the reference's strided identity: a 1x1 convolution by eye.
        # No ResNetConfig reaches it (each stage's first block changes
        # width and takes proj)
        c = x.shape[1]
        eye = torch.eye(c, dtype=x.dtype, device=x.device)[:, :, None, None]
        residual = _conv(residual, eye, stride=stride)
    return F.relu(h + residual)


def _conv_param(shape_hwio: tuple, generator: torch.Generator,
                dtype: torch.dtype, device: torch.device) -> nn.Parameter:
    """The reference's ``_conv_init``: normal * sqrt(2 / fan_in) in
    float32, cast; kept as (out, in, kh, kw) in channels_last memory."""
    kh, kw, cin, cout = shape_hwio
    w = torch.randn((kh, kw, cin, cout), generator=generator, device=device)
    w = (w * math.sqrt(2.0 / (kh * kw * cin))).to(dtype)
    return nn.Parameter(_hwio_to_torch(w))


def _hwio_to_torch(w: torch.Tensor) -> torch.Tensor:
    """(kh, kw, in, out) -> (out, in, kh, kw) in channels_last memory."""
    return w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


class ResNet(nn.Module):
    """Parameters named as the reference's tree.

    Weights are drawn as the reference's ``init_params`` draws them, from
    ``generator`` (a CPU or CUDA ``torch.Generator`` on the model's
    device); the numbers differ from jax.random's, so the tests carry
    one set of weights across with ``params_from_numpy``.
    """

    def __init__(self, cfg: ResNetConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        shapes = param_shapes(cfg)

        def ones(n: int) -> nn.Parameter:
            return nn.Parameter(torch.ones(n, dtype=cfg.dtype, device=dev))

        self.stem = _conv_param(shapes["stem"], generator, cfg.dtype, dev)
        self.stem_scale = ones(cfg.width)
        self.stem_bias = nn.Parameter(
            torch.zeros(cfg.width, dtype=cfg.dtype, device=dev))
        stages = []
        for stage in shapes["stages"]:
            blocks = []
            for blk in stage:
                p = {}
                for name in BLOCK_CONVS:
                    if name in blk:
                        p[name] = _conv_param(blk[name], generator,
                                              cfg.dtype, dev)
                for name in BLOCK_SCALES:
                    p[name] = ones(blk[name][0])
                blocks.append(nn.ParameterDict(p))
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        head = torch.randn(shapes["head"], generator=generator, device=dev)
        self.head = nn.Parameter((head * 0.01).to(cfg.dtype))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) -> logits (B, num_classes) float32."""
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = _conv(x, self.stem, stride=2)
        x = _bn_relu(x, self.stem_scale) + _channel(self.stem_bias)
        x = _max_pool_same(x)
        for si, stage in enumerate(self.stages):
            for bi, blk in enumerate(stage):
                stride = 2 if (bi == 0 and si > 0) else 1
                x = block_forward(x, blk, stride)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)
        return (x @ self.head).float()


def loss_fn(model: ResNet, images: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
    """Mean cross-entropy of the float32 logits, as the reference's."""
    logp = torch.log_softmax(model(images), dim=-1)
    return -logp.gather(1, labels[:, None].long())[:, 0].mean()


def make_dp_train_step(model: ResNet, lr: float = 0.1, group=None,
                       bucket_cap_mb: float = 25.0):
    """The reference's ``make_pmap_train_step`` on torch.distributed:
    per-rank loss and gradients, the gradients and the loss averaged over
    ``group`` (the default group when None), then ``p - lr * g``.
    Returns a ``parallel.dp.DataParallelStep``: ``step(images, labels)``
    updates the model in place and returns the mean loss, equal on every
    rank."""
    from deepflow_tpu_torch.parallel.dp import DataParallelStep
    optimizer = torch.optim.SGD(model.parameters(), lr=lr)
    return DataParallelStep(model, lambda m, x, y: loss_fn(m, x, y),
                            optimizer, group=group,
                            bucket_cap_mb=bucket_cap_mb)


def synthetic_batch(cfg: ResNetConfig, batch: int, image: int,
                    generator: torch.Generator, device: torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded images (B, image, image, 3) in float32 and labels (B,)."""
    images = torch.randn((batch, image, image, 3), generator=generator,
                         device=device)
    labels = torch.randint(0, cfg.num_classes, (batch,),
                           generator=generator, device=device)
    return images, labels


def _state_items(tree: dict):
    """(state-dict name, numpy leaf, is a convolution) of the reference's
    tree."""
    for name in ("stem", "stem_scale", "stem_bias", "head"):
        yield name, tree[name], name == "stem"
    for i, stage in enumerate(tree["stages"]):
        for b, blk in enumerate(stage):
            for name, leaf in blk.items():
                yield f"stages.{i}.{b}.{name}", leaf, name in BLOCK_CONVS


def params_from_numpy(tree: dict, device: str | torch.device = "cuda"
                      ) -> dict[str, torch.Tensor]:
    """The reference's nested numpy tree -> a state dict for
    ``ResNet.load_state_dict``; HWIO convolutions become (out, in, kh, kw)
    in channels_last memory. bfloat16 leaves (ml_dtypes) widen exactly to
    float32 on the way and come back as torch.bfloat16."""
    dev = resolve_device(device)
    out = {}
    for name, leaf, is_conv in _state_items(tree):
        arr = np.asarray(leaf)
        bf16 = arr.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(arr, dtype=np.float32 if bf16
                                      else arr.dtype))
        t = t.to(dev, torch.bfloat16 if bf16 else t.dtype)
        out[name] = _hwio_to_torch(t) if is_conv else t
    return out


def params_to_numpy(model: ResNet) -> dict:
    """Model weights -> the reference's nested tree (convolutions in
    HWIO), as float32 numpy (exact for bfloat16 weights)."""
    def conv(p: torch.Tensor, is_conv: bool) -> np.ndarray:
        a = p.detach().float().cpu()
        return (a.permute(2, 3, 1, 0) if is_conv else a).numpy().copy()

    tree = {"stem": conv(model.stem, True),
            "stem_scale": conv(model.stem_scale, False),
            "stem_bias": conv(model.stem_bias, False),
            "stages": [[{name: conv(p, name in BLOCK_CONVS)
                         for name, p in blk.items()} for blk in stage]
                       for stage in model.stages],
            "head": conv(model.head, False)}
    return tree
