"""The port's Llama held against the JAX reference on the CPU: the same
weights (carried through numpy) give the same logits, and three training
steps give the same losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflow_tpu.models import llama as jl
from deepflow_tpu_torch.models import llama as tl

# float32: the two frameworks differ only in summation order
F32_LOGITS_ATOL = 1e-4
F32_LOSS_RTOL = 1e-5
# bfloat16: the frameworks round intermediates at different places
BF16_LOGITS_ATOL = 5e-2
BF16_LOSS_RTOL = 1e-2

CASES = [
    (jnp.float32, torch.float32, F32_LOGITS_ATOL, F32_LOSS_RTOL),
    (jnp.bfloat16, torch.bfloat16, BF16_LOGITS_ATOL, BF16_LOSS_RTOL),
]


def _pair(jdtype, tdtype, seed=0):
    jcfg = jl.LlamaConfig.tiny(dtype=jdtype)
    tcfg = tl.LlamaConfig.tiny(dtype=tdtype)
    params = jl.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    model = tl.Llama(tcfg, device="cpu")
    model.load_state_dict(tl.params_from_numpy(tree, device="cpu"))
    return jcfg, params, model


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("jdtype,tdtype,atol,_rtol", CASES,
                         ids=["f32", "bf16"])
def test_forward_matches_jax(jdtype, tdtype, atol, _rtol):
    jcfg, params, model = _pair(jdtype, tdtype)
    tokens = _tokens(jcfg.vocab, (2, 16))
    ref = np.asarray(jl.forward(jcfg, params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (2, 16, jcfg.vocab)
    assert got.dtype == np.float32
    assert np.max(np.abs(got - ref)) <= atol


@pytest.mark.parametrize("jdtype,tdtype,_atol,rtol", CASES,
                         ids=["f32", "bf16"])
def test_train_steps_match_jax(jdtype, tdtype, _atol, rtol):
    jcfg, params, model = _pair(jdtype, tdtype)
    tokens = _tokens(jcfg.vocab, (4, 33))
    train_step, init_opt = jl.make_train_step(jcfg)
    step = jax.jit(train_step)
    opt_state = init_opt(params)
    ref = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(tokens))
        ref.append(float(loss))
    ref.append(float(jl.loss_fn(jcfg, params, jnp.asarray(tokens))))

    tstep, opt = tl.make_train_step(model)
    assert isinstance(opt, torch.optim.SGD)
    t = torch.from_numpy(tokens)
    got = [float(tstep(t)) for _ in range(3)]
    with torch.no_grad():
        got.append(float(tl.loss_fn(model, t)))
    np.testing.assert_allclose(got, ref, rtol=rtol)
    # the updates moved the weights as the reference's did
    assert got[-1] < got[0]


def test_initial_loss_near_uniform():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = tl.Llama(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(_tokens(cfg.vocab, (2, 17)))
    with torch.no_grad():
        loss = float(tl.loss_fn(model, tokens))
    assert np.isfinite(loss)
    assert loss == pytest.approx(np.log(cfg.vocab), rel=0.2)


def test_params_round_trip_numpy():
    jcfg, params, model = _pair(jnp.bfloat16, torch.bfloat16)
    back = tl.params_to_numpy(model)
    names = {n: p.shape for n, p in model.named_parameters()}
    assert names["layers.wq"] == (jcfg.n_layers, jcfg.d_model,
                                  jcfg.n_heads * jcfg.head_dim)
    flat_ref = jax.tree.leaves(params)
    flat_got = jax.tree.leaves(back)
    assert len(flat_ref) == len(flat_got) == 11
    for r, g in zip(flat_ref, flat_got):
        np.testing.assert_array_equal(np.asarray(r, np.float32), g)
