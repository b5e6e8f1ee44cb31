"""The port's (data, fsdp, tensor) mesh and sharded Llama step held
against the JAX package on the CPU.

One gloo world of four spawned ranks (``torch_world.py``) runs the port;
JAX runs on a Mesh of four of the eight virtual CPU devices in the same
shape, the weights placed by ``shard_params`` under ``param_specs`` and
the tokens ``P("data", None)``, as the reference's sharded test does.
The same weights and tokens go both ways through numpy. Every rank's
blocks must be the ones NamedSharding puts on the device at its mesh
position; after two sharded steps on each mesh shape every rank's loss
and every gathered weight must match the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deepflow_tpu.models import llama as jl
from deepflow_tpu.parallel import mesh as jm
from deepflow_tpu_torch.models import llama as tl
from deepflow_tpu_torch.parallel import mesh as pm

import torch_world

SHAPES = [(1, 2, 2), (2, 1, 2), (1, 1, 4), (4, 1, 1)]
TINY = {"n_heads": 8, "n_kv_heads": 4}
# float32: summation order only; the tensor axis sums each row-parallel
# product's partial sums over ranks, so the loss moves in the 7th digit
F32_LOSS_RTOL = 1e-5
# an updated weight's distance from the reference's, as a share of the
# reference's whole update over two steps (lr 3e-4, momentum 0.9), beside
# the weight's own float32 rounding
F32_UPDATE_RTOL = 1e-3
# bfloat16: each rank rounds its partial products before they are summed
BF16_LOSS_RTOL = 2e-2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = torch_world.World(str(tmp_path_factory.mktemp("mesh") / "store"))
    try:
        yield w
    finally:
        w.close()


def _jax_mesh(shape):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape), jm.AXES)


def _reference(shape, jdtype, steps, seed=0, kw=TINY):
    """(numpy weights, tokens, the sharded step's losses and weights)."""
    cfg = jl.LlamaConfig.tiny(dtype=jdtype, **kw)
    params = jl.init_params(cfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (4, 17), dtype=np.int32)
    mesh = _jax_mesh(shape)
    p = jm.shard_params(params, jl.param_specs(cfg), mesh)
    train_step, init_opt = jl.make_train_step(cfg)
    step = jax.jit(train_step)
    opt = init_opt(p)
    t = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh,
                                                          P("data", None)))
    losses = []
    for _ in range(steps):
        p, opt, loss = step(p, opt, t)
        losses.append(float(loss))
    return tree, tokens, losses, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("n", range(1, 65))
def test_factor_devices_equals_reference(n):
    assert pm.factor_devices(n) == jm.factor_devices(n)
    assert np.prod(pm.factor_devices(n)) == n


def test_specs_equal_the_reference():
    cfg = jl.LlamaConfig.tiny()
    want = jax.tree.map(lambda s: tuple(s), jl.param_specs(cfg),
                        is_leaf=lambda x: isinstance(x, P))
    assert tl.param_specs(tl.LlamaConfig.tiny()) == want


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_shard_layout_equals_named_sharding(world, shape):
    """Each rank's blocks are the data NamedSharding places on the device
    at the rank's mesh position (rank r = position r in row-major order,
    as on the JAX mesh)."""
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **TINY)
    tree = jax.tree.map(np.asarray, jl.init_params(cfg, jax.random.key(0)))
    got = world.run("layout", shape, tree)
    mesh = _jax_mesh(shape)
    devices = list(mesh.devices.flat)
    specs = jl.param_specs(cfg)
    flat = {"tok_embed": (tree["tok_embed"], specs["tok_embed"]),
            "final_norm": (tree["final_norm"], specs["final_norm"]),
            **{f"layers.{n}": (tree["layers"][n], specs["layers"][n])
               for n in tree["layers"]}}
    for name, (full, spec) in flat.items():
        placed = jax.device_put(full, NamedSharding(mesh, spec))
        for shard in placed.addressable_shards:
            rank = devices.index(shard.device)
            np.testing.assert_array_equal(got[rank][name],
                                          np.asarray(shard.data))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_sharded_train_step_matches_reference(world, shape):
    """Two float32 steps: every rank's mean loss and every gathered
    weight against the reference's sharded step on the same mesh shape;
    each communicator issues its calls (one-rank axes none)."""
    tree, tokens, want, want_params = _reference(shape, jnp.float32, 2)
    got = world.run("train", shape, "float32", TINY, tree, tokens, 2)
    for losses, _, _ in got:
        np.testing.assert_allclose(losses, want, rtol=F32_LOSS_RTOL)
        assert losses == got[0][0]   # equal on every rank
    torch_world.assert_updates_close(
        jax.tree.leaves(got[0][1]), jax.tree.leaves(want_params),
        jax.tree.leaves(tree), F32_UPDATE_RTOL)
    calls = got[0][2]
    d, f, t = shape
    assert set(calls) == {a for a, n in zip(pm.AXES, shape) if n > 1}
    L = TINY.get("n_layers", 2)
    if f > 1:  # seven weights a layer and the embedding, there and back
        assert calls["fsdp"] == 2 * (7 * L + 1)
    if t > 1:  # per layer two row- and two column-parallel products each
        # way, the lookup, the LM head's input, the loss's three
        assert calls["tensor"] == 4 * L + 1 + 1 + 3
    if d > 1:  # one bucket and the loss
        assert calls["data"] == 2
    assert all(c[2] == calls for c in got)


def test_bf16_loss_matches_reference(world):
    shape = (1, 2, 2)
    tree, tokens, want, _ = _reference(shape, jnp.bfloat16, 2)
    got = world.run("train", shape, "bfloat16", TINY, tree, tokens, 2)
    for losses, _, _ in got:
        np.testing.assert_allclose(losses, want, rtol=BF16_LOSS_RTOL)


def test_tiny_replicates_kv_heads_over_the_tensor_axis(world):
    """tiny() has 2 KV heads on 4 tensor ranks: each KV head lives on the
    two ranks whose query heads use it, and its wk/wv gradient is summed
    over them. Two float32 steps match the reference's sharded step (the
    dividing shapes' tolerances), and the sums are one tensor all-reduce
    each for wk and wv beside the dividing shapes' calls."""
    shape = (1, 1, 4)
    tree, tokens, want, want_params = _reference(shape, jnp.float32, 2,
                                                 kw={})
    got = world.run("train", shape, "float32", {}, tree, tokens, 2)
    for losses, _, calls in got:
        np.testing.assert_allclose(losses, want, rtol=F32_LOSS_RTOL)
        assert losses == got[0][0]
        assert calls == {"tensor": 4 * 2 + 1 + 1 + 3 + 2}
    torch_world.assert_updates_close(
        jax.tree.leaves(got[0][1]), jax.tree.leaves(want_params),
        jax.tree.leaves(tree), F32_UPDATE_RTOL)


STRADDLING = [{"n_heads": 6}, {"n_heads": 6, "d_model": 48}]


@pytest.mark.parametrize("kw", STRADDLING, ids=str)
def test_heads_that_straddle_ranks_match_reference(world, kw):
    """Six query heads on four tensor ranks (head_dim 10, then 8): the
    reference cuts wq's 60 (48) columns into blocks of 15 (12), so heads
    and the GQA groups of the two KV heads straddle ranks. The port
    gathers each rank's query, key and value columns, attends with all
    heads and keeps its columns: two float32 steps match the reference's
    sharded step within the dividing shapes' tolerances, and per layer
    the three gathers each way join the two row- and two column-parallel
    products."""
    shape = (1, 1, 4)
    tree, tokens, want, want_params = _reference(shape, jnp.float32, 2,
                                                 kw=kw)
    got = world.run("train", shape, "float32", kw, tree, tokens, 2)
    for losses, _, calls in got:
        np.testing.assert_allclose(losses, want, rtol=F32_LOSS_RTOL)
        assert losses == got[0][0]
        assert calls == {"tensor": (4 + 6) * 2 + 1 + 1 + 3}
    torch_world.assert_updates_close(
        jax.tree.leaves(got[0][1]), jax.tree.leaves(want_params),
        jax.tree.leaves(tree), F32_UPDATE_RTOL)


def test_heads_that_do_not_divide_raise(world):
    """Heads need not divide over the tensor axis (6 on 4 builds and
    trains, above), but every dimension param_specs cuts must: d_ff = 130
    on a tensor axis of 4 is refused by the reference's device_put and by
    the port, which names the dimension; d_model over fsdp likewise."""
    assert world.run("construct", (1, 1, 4), "float32",
                     {"n_heads": 6}) == ["ok"] * 4
    assert world.run("construct", (1, 1, 4), "float32", {}) == ["ok"] * 4
    assert world.run("construct", (1, 2, 2), "float32", {}) == ["ok"] * 4
    got = world.run("construct", (1, 1, 4), "float32", {"d_ff": 130})
    assert all("d_ff = 130 does not divide by the tensor axis of 4"
               in msg for msg in got), got
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, d_ff=130)
    params = jl.init_params(cfg, jax.random.key(0))
    with pytest.raises(ValueError, match="divisible by 4"):
        jm.shard_params(params, jl.param_specs(cfg), _jax_mesh((1, 1, 4)))
    with pytest.raises(ValueError, match="d_model = 64 does not divide"):
        tl._check_divides(tl.LlamaConfig.tiny(), tl._Axes(
            *(tl.pc.Axis(a, None, n, 0) for a, n in
              (("data", 1), ("fsdp", 3), ("tensor", 1), ("sp", 1)))))


def test_make_mesh_refuses_a_shape_that_misses_ranks(world):
    got = world.run("construct", (1, 2, 4), "float32", TINY)
    assert all("!= 4 ranks" in m for m in got), got


def test_every_call_is_logged_with_its_communicator(world):
    """Each collective of a sharded step leaves its host window in the
    probe's call log under its axis's communicator, with the group's
    size: the windows per communicator are the step's calls."""
    from deepflow_tpu_torch.tpuprobe.comms import comm_axis, comm_id
    for windows, sizes, calls in world.run("calls_logged", (2, 1, 2)):
        assert sizes == {comm_id("data"): 2, comm_id("tensor"): 2}
        counted = {}
        for t0, t1, comm in windows:
            assert t0 <= t1
            counted[comm_axis(comm)] = counted.get(comm_axis(comm), 0) + 1
        assert counted == calls and set(calls) == {"data", "tensor"}
        assert [w[0] for w in windows] == sorted(w[0] for w in windows)


def test_example_under_torchrun_with_a_mesh_ships_per_rank(tmp_path):
    """python -m torch.distributed.run --nproc-per-node 4 -m runner -m
    example --mesh 1,2,2, all on the CPU: every rank trains its shard
    over gloo, prints its mesh and each communicator's calls a step, the
    mean loss is equal across ranks at every step, and each rank's agent
    ships under its own id into one port server with no duplicate."""
    import json
    import os
    import subprocess
    import sys
    import time

    from deepflow_tpu_torch.server import Server

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    server = Server(ingest_port=0, query_port=0,
                    selfstats_interval_s=3600).start()
    try:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "4", "-m", "deepflow_tpu_torch.cli.runner",
               "--device", "cpu", "--server",
               f"127.0.0.1:{server.ingest_port}", "--service", "mp-train",
               "-m", "deepflow_tpu_torch.examples.train_with_observability",
               "--device", "cpu", "--mesh", "1,2,2", "--d-model", "64",
               "--layers", "2", "--seq", "33", "--batch", "4", "--steps", "3"]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            env.pop(k, None)
        out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             timeout=240, env=env)
        assert out.returncode == 0, out.stderr[-4000:]
        lines = [json.loads(x) for x in out.stdout.splitlines()
                 if x.startswith("{")]
        by_rank = {}
        for line in lines:
            by_rank.setdefault(line["rank"], []).append(line)
        assert sorted(by_rank) == [0, 1, 2, 3]
        for steps in by_rank.values():
            assert [s["step"] for s in steps] == [0, 1, 2]
            assert all(s["world"] == 4 and s["mesh"] == {
                "data": 1, "fsdp": 2, "tensor": 2} and s["calls"] == {
                "fsdp": 30, "tensor": 13} for s in steps)
        for i in range(3):
            assert len({by_rank[r][i]["loss"] for r in by_rank}) == 1
        assert by_rank[0][-1]["loss"] < by_rank[0][0]["loss"]

        def agents(table):
            t = server.db.table(table)
            return set(t.column_concat(["agent_id"])["agent_id"].tolist())
        want = {1, 2, 3, 4}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                agents("deepflow_system.deepflow_system") != want
                or agents("profile.in_process_profile") != want):
            time.sleep(0.1)
        assert agents("deepflow_system.deepflow_system") == want
        assert agents("profile.in_process_profile") == want
        assert server.dedup.stats["dups"] == 0
        assert all(d.stats["dups"] == 0 and d.stats["errors"] == 0
                   for d in server.decoders)
    finally:
        server.stop()


def test_entry_points_raise_without_cuda():
    """No fallback: the mesh, the sharded model and the MoE's weights
    default to the card and raise where there is none (this sandbox)."""
    import torch

    from deepflow_tpu_torch.models import moe as tm
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.make_mesh((1, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_moe_params(8, 16, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.Llama(tl.LlamaConfig.tiny(), mesh=None)
