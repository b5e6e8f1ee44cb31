"""The port's data-parallel ResNet step held against the reference's
``make_pmap_train_step`` on the CPU: gloo process groups of 2 and 4 ranks
(one world of 4 spawned processes for the module, rendezvous through a
FileStore) against ``jax.pmap`` over as many virtual CPU devices, the
same weights and per-rank batches carried through numpy. After one step
every rank holds the same weights as the reference and returns its mean
loss. Then the example runs under ``torch.distributed.run`` and the
runner on the CPU, each rank's agent shipping into one port server."""

import json
import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LR = 0.1
# float32: summation order only (the single-device step's bounds, as
# tests/test_torch_resnet.py states them)
F32_LOSS_RTOL = 1e-5
F32_GRAD_RTOL = 2e-3


# -- the spawned world ----------------------------------------------------------------

def _worker(rank, store_path, commands, results):
    import torch.distributed as dist

    from deepflow_tpu_torch.models import resnet as tr
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD)
    groups = {2: dist.new_group([0, 1]), WORLD: None}
    try:
        while True:
            cmd = commands[rank].get(timeout=120)
            if cmd is None:
                return
            n, tree, images, labels, cap_mb = cmd
            if rank >= n:
                continue
            cfg = tr.ResNetConfig.tiny(dtype=torch.float32)
            # only the group's first rank starts from the shared weights:
            # the step's broadcast gives them to the others
            model = tr.ResNet(cfg, device="cpu", generator=torch.Generator()
                              .manual_seed(100 + rank))
            if rank == 0:
                model.load_state_dict(tr.params_from_numpy(tree, "cpu"))
            step = tr.make_dp_train_step(model, lr=LR, group=groups[n],
                                         bucket_cap_mb=cap_mb)
            loss = step(torch.from_numpy(images[rank]),
                        torch.from_numpy(labels[rank]))
            results.put((rank, float(loss), tr.params_to_numpy(model),
                         len(step.buckets), step.calls_per_step))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ctx = mp.get_context("spawn")
    store = str(tmp_path_factory.mktemp("dp") / "store")
    commands = [ctx.Queue() for _ in range(WORLD)]
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, store, commands, results),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()

    def run(n, tree, images, labels, cap_mb=25.0):
        for q in commands:
            q.put((n, tree, images, labels, cap_mb))
        got = sorted((results.get(timeout=120) for _ in range(n)),
                     key=lambda r: r[0])
        return got

    try:
        yield run
    finally:
        for q in commands:
            q.put(None)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


# -- the reference --------------------------------------------------------------------

def _reference(n, seed=0):
    """(numpy weights, per-rank images and labels, pmap's weights after one
    step and its mean loss) over n virtual devices."""
    import jax
    import jax.numpy as jnp

    from deepflow_tpu.models import resnet as jr

    cfg = jr.ResNetConfig(stage_sizes=(1, 1), width=8, num_classes=10,
                          dtype=jnp.float32)
    params = jr.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 1)
    images = rng.standard_normal((n, 3, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (n, 3), dtype=np.int32)
    step = jr.make_pmap_train_step(cfg, lr=LR)
    rep = jax.tree.map(lambda x: jnp.stack([x] * n), params)
    new, loss = step(rep, jnp.asarray(images), jnp.asarray(labels))
    assert len({float(x) for x in np.asarray(loss)}) == 1
    return (jax.tree.map(np.asarray, params), images, labels,
            jax.tree.map(lambda x: np.asarray(x)[0], new),
            float(np.asarray(loss)[0]))


def _leaves(tree):
    import jax
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_pmap(world, n):
    tree, images, labels, want, want_loss = _reference(n)
    got = world(n, tree, images, labels)
    assert [r[0] for r in got] == list(range(n))
    for rank, loss, params, n_buckets, calls in got:
        np.testing.assert_allclose(loss, want_loss, rtol=F32_LOSS_RTOL)
        assert calls == n_buckets + 1
        for b, w, a in zip(_leaves(tree), _leaves(want), _leaves(params)):
            assert a.shape == w.shape
            # the update is p - lr * mean(g), as pmap's
            assert np.max(np.abs(a - w)) <= \
                F32_GRAD_RTOL * max(np.max(np.abs(b - w)), 1e-12)
    # every rank holds the same weights and the same mean loss
    for _, loss, params, _, _ in got[1:]:
        assert loss == got[0][1]
        for a, b in zip(_leaves(params), _leaves(got[0][2])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_buckets_give_the_per_leaf_mean(world, n):
    """One leaf per bucket (the reference's per-leaf pmean) and one
    bucket for all: the same weights, to float32 rounding."""
    tree, images, labels, _, _ = _reference(n, seed=3)
    per_leaf = world(n, tree, images, labels, cap_mb=1e-9)
    one = world(n, tree, images, labels, cap_mb=1024.0)
    assert one[0][3] == 1
    assert per_leaf[0][3] == len(_leaves(tree))
    for (_, la, pa, _, _), (_, lb, pb, _, _) in zip(per_leaf, one):
        assert la == lb
        for a, b in zip(_leaves(pa), _leaves(pb)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# -- the example under a launcher ----------------------------------------------------

def test_example_under_torchrun_ships_per_rank(tmp_path):
    """python -m torch.distributed.run --nproc-per-node 2 -m runner -m
    example --preset resnet-tiny, all on the CPU: each rank trains
    data-parallel over gloo and prints its step lines with its rank, the
    mean loss is equal across ranks at every step, and each rank's agent
    ships under its own id into one port server with no duplicate."""
    from deepflow_tpu_torch.server import Server

    server = Server(ingest_port=0, query_port=0,
                    selfstats_interval_s=3600).start()
    try:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "deepflow_tpu_torch.cli.runner",
               "--device", "cpu", "--server",
               f"127.0.0.1:{server.ingest_port}", "--service", "dp-train",
               "-m", "deepflow_tpu_torch.examples.train_with_observability",
               "--preset", "resnet-tiny", "--device", "cpu", "--steps", "4",
               "--image", "16", "--batch", "2"]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            env.pop(k, None)
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=240, env=env)
        assert out.returncode == 0, out.stderr[-4000:]
        lines = [json.loads(x) for x in out.stdout.splitlines()
                 if x.startswith("{")]
        by_rank = {}
        for line in lines:
            by_rank.setdefault(line["rank"], []).append(line)
        assert sorted(by_rank) == [0, 1]
        for r, steps in by_rank.items():
            assert [s["step"] for s in steps] == [0, 1, 2, 3]
            assert all(s["world"] == 2 and s["allreduce_calls"] == 2
                       for s in steps)
        for a, b in zip(by_rank[0], by_rank[1]):
            assert a["loss"] == b["loss"]
        assert by_rank[0][-1]["loss"] < by_rank[0][0]["loss"]

        def agents(table):
            t = server.db.table(table)
            return set(t.column_concat(["agent_id"])["agent_id"].tolist())
        import time
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                agents("deepflow_system.deepflow_system") != {1, 2}
                or agents("profile.in_process_profile") != {1, 2}):
            time.sleep(0.1)
        assert agents("deepflow_system.deepflow_system") == {1, 2}
        assert agents("profile.in_process_profile") == {1, 2}
        assert server.dedup.stats["dups"] == 0
        assert all(d.stats["dups"] == 0 and d.stats["errors"] == 0
                   for d in server.decoders)
        assert server.receiver.stats["bad_frames"] == 0
    finally:
        server.stop()
