"""The port's ring attention and the Llama's sequence-parallel mode held
against the JAX package on the CPU.

One gloo world of four spawned ranks (``torch_world.py``) runs the port
on a ("data", "sp") mesh; JAX runs ``ring_attention`` and the reference's
``forward`` / ``make_train_step(mesh=..., sp_axis="sp")`` on a Mesh of
four virtual CPU devices in the same shape. The same inputs go both ways
through numpy. The reference's own test of the sequence-parallel step
checks only that its loss is finite; here its loss and updated weights
are the expected values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deepflow_tpu.models import llama as jl
from deepflow_tpu.parallel.ring_attention import ring_attention

import torch_world

AXES = ("data", "sp")
# float32, the same online softmax in the same block order: rounding only
RING_ATOL = 2e-6
F32_LOGITS_ATOL = 1e-4
F32_LOSS_RTOL = 1e-5
# an updated weight's distance from the reference's, as a share of the
# reference's whole update over two steps (lr 3e-4, momentum 0.9), beside
# the weight's own float32 rounding
F32_UPDATE_RTOL = 1e-3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = torch_world.World(str(tmp_path_factory.mktemp("ring") / "store"))
    try:
        yield w
    finally:
        w.close()


def _mesh(shape):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape), AXES)


def _qkv(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _assemble(got):
    """The sp blocks in order (ranks that share an sp place agree)."""
    blocks = {}
    for i, out in got:
        if i in blocks:
            np.testing.assert_array_equal(blocks[i], out)
        blocks[i] = out
    return np.concatenate([blocks[i] for i in sorted(blocks)], axis=1)


@pytest.mark.parametrize("sp,H,KV,causal", [
    (4, 8, 2, True), (2, 8, 2, True), (4, 4, 4, False), (2, 8, 4, False)],
    ids=["gqa-causal-sp4", "gqa-causal-sp2", "mha-noncausal-sp4",
         "gqa-noncausal-sp2"])
def test_ring_attention_matches_reference(world, sp, H, KV, causal):
    q, k, v = _qkv(2, 32, H, KV, 16, seed=3)
    want = np.asarray(ring_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        Mesh(np.asarray(jax.devices()[:sp]), ("sp",)), axis="sp",
        causal=causal))
    got = _assemble(world.run("ring", sp, q, k, v, causal))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RING_ATOL)


def _tree(jdtype, seed=0):
    cfg = jl.LlamaConfig.tiny(dtype=jdtype)
    params = jl.init_params(cfg, jax.random.key(seed))
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=str)
def test_sp_forward_matches_reference(world, shape):
    """The sequence-parallel forward (GQA, ring attention at global
    positions) against the reference's on the same mesh."""
    cfg, params, tree = _tree(jnp.float32)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 64),
                                               dtype=np.int32)
    mesh = _mesh(shape)
    t = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh,
                                                          P("data", "sp")))
    want = np.asarray(jax.jit(lambda p, t: jl.forward(
        cfg, p, t, mesh=mesh, sp_axis="sp"))(params, t))
    got = world.run("forward", shape, "float32", {}, tree, tokens, AXES,
                    "sp")
    rows = {}
    for d, s, logits in got:
        rows.setdefault(d, []).append((s, logits))
    full = np.concatenate([_assemble(rows[d]) for d in sorted(rows)])
    assert full.shape == want.shape
    assert np.max(np.abs(full - want)) <= F32_LOGITS_ATOL


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=str)
def test_sp_train_step_matches_reference(world, shape):
    """Two sequence-parallel steps: the loss (the mean over every token
    of every shard) and every updated weight against the reference's
    ``make_train_step(cfg, mesh=..., sp_axis="sp")``."""
    cfg, params, tree = _tree(jnp.float32)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 65),
                                               dtype=np.int32)
    mesh = _mesh(shape)
    train_step, init_opt = jl.make_train_step(cfg, mesh=mesh, sp_axis="sp")
    step = jax.jit(train_step)
    opt = init_opt(params)
    t = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh,
                                                          P("data", None)))
    p, want = params, []
    for _ in range(2):
        p, opt, loss = step(p, opt, t)
        want.append(float(loss))
    got = world.run("train", shape, "float32", {}, tree, tokens, 2, AXES,
                    "sp")
    for losses, _, calls in got:
        np.testing.assert_allclose(losses, want, rtol=F32_LOSS_RTOL)
        assert losses == got[0][0]
        # 2 layers x 2 directions x (sp - 1) rotations, one more all-reduce
        # for the gradients and one for the loss
        assert calls["sp"] == 2 * 2 * (shape[1] - 1) + 2
    torch_world.assert_updates_close(
        jax.tree.leaves(got[0][1]),
        jax.tree.leaves(jax.tree.map(np.asarray, p)),
        jax.tree.leaves(tree), F32_UPDATE_RTOL)
