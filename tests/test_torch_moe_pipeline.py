"""The port's GPipe pipeline and expert-parallel MoE held against the JAX
package on the CPU.

One gloo world of four spawned ranks (``torch_world.py``) runs the port
on a four-rank "pp" or "ep" axis; JAX runs ``pipeline_forward`` and
``moe_ffn`` on a Mesh of four virtual CPU devices, and ``moe_ffn_dense``.
The same weights and inputs go both ways through numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from deepflow_tpu.models import moe as jmoe
from deepflow_tpu.parallel.pipeline import pipeline_forward

import torch_world

# float32: the same products in the same order, sums of one real output
# and zeros across ranks
PIPE_ATOL = 1e-6
MOE_ATOL = 2e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = torch_world.World(str(tmp_path_factory.mktemp("pp") / "store"))
    try:
        yield w
    finally:
        w.close()


def _mesh(axis):
    return Mesh(np.asarray(jax.devices()[:4]), (axis,))


@pytest.mark.parametrize("n_layers,n_micro", [(8, 4), (4, 2), (4, 8)])
def test_pipeline_matches_reference(world, n_layers, n_micro):
    rng = np.random.default_rng(n_layers * 10 + n_micro)
    w = (rng.standard_normal((n_layers, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, 16)).astype(np.float32)

    def stage_fn(stage_w, h):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, h, stage_w)[0]

    want = np.asarray(pipeline_forward(jnp.asarray(w), jnp.asarray(x),
                                       stage_fn, _mesh("pp"), axis="pp",
                                       n_micro=n_micro))
    ref = x
    for i in range(n_layers):
        ref = np.tanh(ref @ w[i])
    for out in world.run("pipeline", w, x, n_micro):
        np.testing.assert_allclose(out, want, rtol=0, atol=PIPE_ATOL)
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


def test_pipeline_divisibility_checked(world):
    """7 layers on 4 stages and 6 rows in 4 microbatches: the
    reference's messages, as ValueError."""
    w = np.zeros((7, 4, 4), np.float32)
    got = world.run("pipeline", w, np.zeros((4, 4), np.float32), 2)
    assert all(m == "layer dim 7 must divide by pp=4" for m in got), got
    with pytest.raises(AssertionError, match="divide by pp"):
        pipeline_forward(jnp.asarray(w), jnp.zeros((4, 4)), lambda p, x: x,
                         _mesh("pp"), n_micro=2)
    w = np.zeros((8, 4, 4), np.float32)
    got = world.run("pipeline", w, np.zeros((6, 4), np.float32), 4)
    assert all(m == "batch must divide into microbatches" for m in got)


@pytest.mark.parametrize("n_experts,seed", [(8, 0), (4, 5), (12, 2)])
def test_moe_matches_reference(world, n_experts, seed):
    """Expert-parallel and dense top-1 MoE against the reference's, with
    tokens routed onto every rank's experts."""
    params = jmoe.init_moe_params(jax.random.key(seed), d_model=32, d_ff=64,
                                  n_experts=n_experts, dtype=jnp.float32)
    x = jax.random.normal(jax.random.key(seed + 1), (48, 32),
                          dtype=jnp.float32)
    dense = np.asarray(jmoe.moe_ffn_dense(params, x))
    ep = np.asarray(jmoe.moe_ffn(params, x, _mesh("ep"), axis="ep"))
    per = n_experts // 4
    assign = np.argmax(np.asarray(x @ params["router"]), -1)
    assert set((assign // per).tolist()) == {0, 1, 2, 3}
    tree = jax.tree.map(np.asarray, params)
    for got_ep, got_dense in world.run("moe", tree, np.asarray(x)):
        np.testing.assert_allclose(got_ep, ep, rtol=0, atol=MOE_ATOL)
        np.testing.assert_allclose(got_dense, dense, rtol=0, atol=MOE_ATOL)
