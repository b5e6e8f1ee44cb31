"""The port's ResNet held against the JAX reference on the CPU: the same
weights (carried through numpy) give the same logits on odd and even
image sizes, one SGD step gives the same loss and weights as
``jax.value_and_grad`` of the reference's loss, and weights survive a
round trip through numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from deepflow_tpu.models import resnet as jr
from deepflow_tpu_torch.models import resnet as tr

# float32: the frameworks differ only in convolution and reduction order
F32_LOGITS_ATOL = 2e-4
F32_LOSS_RTOL = 1e-5
# each leaf's update against lr * its gradient, relative to the leaf's
# largest gradient: batch statistics over a few pixels amplify the
# order differences in the deeper stages (5e-4 measured at (3, 4, 6, 3))
F32_GRAD_RTOL = 2e-3
# bfloat16: the frameworks round intermediates at different places
BF16_LOGITS_ATOL = 0.15

# the reference's forward, compiled once per configuration (op by op it
# takes seconds a call on the CPU)
_forward = jax.jit(jr.forward, static_argnums=0)

SHAPES = {"tiny": {}, "r50w8": {"stage_sizes": (3, 4, 6, 3), "width": 8}}


def _cfgs(kind, jdtype, tdtype):
    kw = SHAPES[kind]
    return (jr.ResNetConfig(**{**dict(stage_sizes=(1, 1), width=8,
                                       num_classes=10), **kw},
                            dtype=jdtype),
            tr.ResNetConfig.tiny(**kw, dtype=tdtype))


def _pair(kind, jdtype, tdtype, seed=0):
    jcfg, tcfg = _cfgs(kind, jdtype, tdtype)
    params = jr.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    model = tr.ResNet(tcfg, device="cpu")
    model.load_state_dict(tr.params_from_numpy(tree, device="cpu"))
    return jcfg, params, model


def _images(b, hw, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, hw, hw, 3)).astype(np.float32)


def _labels(b, n, seed=2):
    return np.random.default_rng(seed).integers(0, n, (b,), dtype=np.int32)


@pytest.mark.parametrize("n,k,s,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 1, (1, 1)),
    (57, 3, 2, (1, 1)), (15, 7, 2, (3, 3)), (28, 1, 2, (0, 0))])
def test_same_padding_is_xlas(n, k, s, want):
    """The stem on 224 pads (2, 3) and a 3x3/2 on an even size (0, 1):
    the odd pixel goes on the high side."""
    assert tr.same_pads(n, k, s) == want


@pytest.mark.parametrize("hw", [32, 33, 17])
@pytest.mark.parametrize("kind", ["tiny", "r50w8"])
def test_forward_f32_matches_jax(kind, hw):
    jcfg, params, model = _pair(kind, jnp.float32, torch.float32)
    images = _images(3, hw)
    ref = np.asarray(_forward(jcfg, params, jnp.asarray(images)))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.shape == ref.shape == (3, jcfg.num_classes)
    assert got.dtype == np.float32
    assert np.max(np.abs(got - ref)) <= F32_LOGITS_ATOL


@pytest.mark.parametrize("hw", [32, 33])
@pytest.mark.parametrize("kind", ["tiny", "r50w8"])
def test_forward_bf16_matches_jax(kind, hw):
    jcfg, params, model = _pair(kind, jnp.bfloat16, torch.bfloat16)
    images = _images(4, hw)
    ref = np.asarray(_forward(jcfg, params, jnp.asarray(images)))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.max(np.abs(got - ref)) <= BF16_LOGITS_ATOL


def _jax_loss(cfg):
    def loss_fn(params, images, labels):
        logp = jax.nn.log_softmax(_forward(cfg, params, images))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))
    return loss_fn


@pytest.mark.parametrize("kind", ["tiny", "r50w8"])
def test_sgd_step_matches_value_and_grad(kind):
    """One step of SGD at the reference's lr: the loss before the step and
    every weight after it."""
    lr = 0.1
    jcfg, params, model = _pair(kind, jnp.float32, torch.float32)
    images, labels = _images(4, 19), _labels(4, jcfg.num_classes)
    loss, grads = jax.value_and_grad(_jax_loss(jcfg))(
        params, jnp.asarray(images), jnp.asarray(labels))
    before = tr.params_to_numpy(model)

    opt = torch.optim.SGD(model.parameters(), lr=lr)
    got_loss = tr.loss_fn(model, torch.from_numpy(images),
                          torch.from_numpy(labels))
    got_loss.backward()
    opt.step()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=F32_LOSS_RTOL)
    got = tr.params_to_numpy(model)
    flat_g, tree_g = jax.tree.flatten(grads)
    flat_b, tree_b = jax.tree.flatten(before)
    flat_a, tree_a = jax.tree.flatten(got)
    assert tree_g == tree_b == tree_a
    for g, b, a in zip(flat_g, flat_b, flat_a):
        g = np.asarray(g)
        assert a.shape == g.shape
        # the update is p - lr * g, as the reference's
        err = np.max(np.abs((b - a) - lr * g))
        assert err <= lr * F32_GRAD_RTOL * np.max(np.abs(g))


@pytest.mark.parametrize("tdtype", [torch.float32, torch.bfloat16])
def test_weights_round_trip_through_numpy(tdtype):
    cfg = tr.ResNetConfig.tiny(dtype=tdtype)
    model = tr.ResNet(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    tree = tr.params_to_numpy(model)
    shapes = tr.param_shapes(cfg)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        tuple, shapes, is_leaf=lambda x: isinstance(x, tuple))
    back = tr.ResNet(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(4))
    sd = tr.params_from_numpy(tree, device="cpu")
    if tdtype == torch.bfloat16:
        sd = {k: v.to(tdtype) for k, v in sd.items()}
    back.load_state_dict(sd)
    for (na, a), (nb, b) in zip(model.state_dict().items(),
                                back.state_dict().items()):
        assert na == nb and a.dtype == b.dtype == tdtype
        assert torch.equal(a, b)
    assert model.stem.is_contiguous(memory_format=torch.channels_last)
    assert back.stem.is_contiguous(memory_format=torch.channels_last)


def test_init_draws_the_references_scales():
    """He-normal convolutions (std sqrt(2/fan_in)), unit scales, zero
    stem bias, a head at std 0.01, from an explicit generator."""
    cfg = tr.ResNetConfig.tiny(dtype=torch.float32, width=16)
    a = tr.ResNet(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = tr.ResNet(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (_, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y)
    conv = a.stages[1][0]["conv2"]  # 3x3, fan_in 9 * 32
    assert abs(float(conv.detach().std()) - (2.0 / (9 * 32)) ** 0.5) < 0.01
    assert abs(float(a.head.detach().std()) - 0.01) < 0.002
    assert torch.equal(a.stem_bias, torch.zeros(16))
    assert torch.equal(a.stages[0][0]["scale3"], torch.ones(64))


def test_strided_identity_block_matches_jax():
    """The reference's strided identity residual (a 1x1 convolution by
    eye) is unreachable from any ResNetConfig; held here through a tree
    whose second stage's first block keeps its width and has no proj."""
    w, classes = 8, 5
    rng = np.random.default_rng(7)

    def conv(kh, cin, cout):
        return (rng.standard_normal((kh, kh, cin, cout))
                * np.sqrt(2.0 / (kh * kh * cin))).astype(np.float32)

    def block():
        return {"conv1": conv(1, w, 4), "conv2": conv(3, 4, 4),
                "conv3": conv(1, 4, w),
                "scale1": np.ones(4, np.float32),
                "scale2": np.full(4, 1.5, np.float32),
                "scale3": np.full(w, 0.5, np.float32)}

    tree = {"stem": conv(7, 3, w), "stem_scale": np.ones(w, np.float32),
            "stem_bias": np.full(w, 0.1, np.float32),
            "stages": [[block()], [block()]],
            "head": (rng.standard_normal((w, classes)) * 0.1
                     ).astype(np.float32)}
    jcfg = jr.ResNetConfig(dtype=jnp.float32)
    images = _images(2, 21)
    ref = np.asarray(_forward(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(images)))

    model = tr.ResNet(tr.ResNetConfig.tiny(dtype=torch.float32, width=w,
                                           num_classes=classes),
                      device="cpu")
    sd = tr.params_from_numpy(tree, device="cpu")
    model.stages = nn.ModuleList(
        nn.ModuleList([nn.ParameterDict({
            k: nn.Parameter(sd[f"stages.{i}.0.{k}"]) for k in block()})])
        for i in range(2))
    model.head = nn.Parameter(sd["head"])
    with torch.no_grad():
        model.stem.copy_(sd["stem"])
        model.stem_bias.copy_(sd["stem_bias"])
        got = model(torch.from_numpy(images)).numpy()
    assert np.max(np.abs(got - ref)) <= F32_LOGITS_ATOL
