"""One gloo world of four spawned ranks for the port's model-parallel
tests, and the bodies each rank runs in it.

A test module starts one ``World`` (FileStore rendezvous, as
``test_torch_dp.py``'s) and sends it commands: the name of a body below
and its arguments. Every rank runs the body on its own mesh position and
returns its result; a body that raises on any rank fails the command
with that rank's traceback. This file imports torch and the port only,
so the ranks load no JAX; the test modules hold the port against the
JAX package in the parent process.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback

import numpy as np

WORLD = 4
TIMEOUT_S = 240


def _worker(rank, store_path, commands, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD)
    try:
        while True:
            cmd = commands[rank].get(timeout=TIMEOUT_S)
            if cmd is None:
                return
            name, args = cmd
            try:
                results.put((rank, True, globals()[name](rank, *args)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    def __init__(self, store_path: str) -> None:
        ctx = mp.get_context("spawn")
        self.commands = [ctx.Queue() for _ in range(WORLD)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, daemon=True, args=(
            r, store_path, self.commands, self.results))
            for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args) -> list:
        """Every rank's result of body ``name``, in rank order."""
        for q in self.commands:
            q.put((name, args))
        got = sorted((self.results.get(timeout=TIMEOUT_S)
                      for _ in range(WORLD)), key=lambda r: r[0])
        failed = [f"rank {r}:\n{out}" for r, ok, out in got if not ok]
        if failed:
            raise AssertionError("\n".join(failed))
        return [out for _, _, out in got]

    def close(self) -> None:
        for q in self.commands:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


def assert_updates_close(got, want, before, rtol: float) -> None:
    """Leaf by leaf, an updated weight's distance from the reference's is
    at most ``rtol`` of the reference's whole update, plus the float32
    rounding of the weight itself (two ulps of its largest value)."""
    for a, w, b in zip(got, want, before):
        assert a.shape == w.shape
        moved = np.max(np.abs(w - b))
        ulps = 2 * np.finfo(np.float32).eps * np.max(np.abs(w))
        assert np.max(np.abs(a - w)) <= rtol * moved + ulps, \
            (np.max(np.abs(a - w)), moved, ulps)


# -- the bodies: each runs on every rank ----------------------------------

def _cfg(dtype: str, kw: dict):
    import torch

    from deepflow_tpu_torch.models import llama as tl
    return tl.LlamaConfig.tiny(dtype=getattr(torch, dtype), **kw)


def _mesh(shape, axes=None):
    from deepflow_tpu_torch.parallel import mesh as pm
    return pm.make_mesh(tuple(shape), device="cpu",
                        **({"axes": tuple(axes)} if axes else {}))


def layout(rank, shape, tree):
    """This rank's blocks of the tree, as params_from_numpy cuts them;
    shard_params must cut the same tree of tensors alike."""
    import torch

    from deepflow_tpu_torch.models import llama as tl
    from deepflow_tpu_torch.parallel import mesh as pm
    mesh = _mesh(shape)
    state = tl.params_from_numpy(tree, "cpu", mesh=mesh)
    full = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                {n: torch.from_numpy(a) for n, a in v.items()})
            for k, v in tree.items()}
    cut = pm.shard_params(full, tl.param_specs(tl.LlamaConfig()), mesh)
    flat = {"tok_embed": cut["tok_embed"], "final_norm": cut["final_norm"],
            **{f"layers.{n}": t for n, t in cut["layers"].items()}}
    assert all(torch.equal(flat[k], v) for k, v in state.items())
    return {k: v.float().numpy() for k, v in state.items()}


def _model(shape, dtype, kw, tree, axes=None, sp_axis=None):
    from deepflow_tpu_torch.models import llama as tl
    mesh = _mesh(shape, axes)
    model = tl.Llama(_cfg(dtype, kw), device="cpu", mesh=mesh,
                     sp_axis=sp_axis)
    model.load_state_dict(tl.params_from_numpy(tree, "cpu", mesh=mesh,
                                               cfg=model.cfg))
    return model, mesh


def _rows(mesh, tokens):
    """This rank's block of the batch: rows cut over ``data``."""
    import torch

    from deepflow_tpu_torch.parallel.mesh import axis_index, axis_size
    n = tokens.shape[0] // axis_size(mesh, "data")
    i = axis_index(mesh, "data")
    return torch.from_numpy(tokens[i * n:(i + 1) * n])


def train(rank, shape, dtype, kw, tree, tokens, steps, axes=None,
          sp_axis=None):
    """``steps`` sharded steps: every rank's losses and calls, the full
    weights after them (gathered; rank 0 returns them)."""
    from deepflow_tpu_torch.models import llama as tl
    model, mesh = _model(shape, dtype, kw, tree, axes, sp_axis)
    step, _ = tl.make_train_step(model)
    t = _rows(mesh, tokens)
    losses = [float(step(t)) for _ in range(steps)]
    params = tl.params_to_numpy(model)
    return losses, params if rank == 0 else None, step.calls


def construct(rank, shape, dtype, kw):
    """The sharded model's construction: "ok" or the ValueError's text."""
    from deepflow_tpu_torch.models import llama as tl
    try:
        tl.Llama(_cfg(dtype, kw), device="cpu", mesh=_mesh(shape))
    except ValueError as e:
        return str(e)
    return "ok"


def forward(rank, shape, dtype, kw, tree, tokens, axes=None, sp_axis=None):
    """This rank's logits block and its (data, sp) coordinates."""
    import torch

    from deepflow_tpu_torch.parallel.mesh import axis_index
    model, mesh = _model(shape, dtype, kw, tree, axes, sp_axis)
    with torch.no_grad():
        logits = model(_rows(mesh, tokens))
    return (axis_index(mesh, "data"), axis_index(mesh, sp_axis or "-"),
            logits.numpy())


def ring(rank, sp, q, k, v, causal):
    """Ring attention over an sp axis of ``sp`` ranks (data the rest):
    this rank's output block and its sp coordinate."""
    import torch

    from deepflow_tpu_torch.parallel.mesh import axis_index
    from deepflow_tpu_torch.parallel.ring_attention import ring_attention
    mesh = _mesh((WORLD // sp, sp), ("data", "sp"))
    i = axis_index(mesh, "sp")
    n = q.shape[1] // sp

    def block(a):
        return torch.from_numpy(a[:, i * n:(i + 1) * n])
    out = ring_attention(block(q), block(k), block(v), mesh, axis="sp",
                         causal=causal)
    return i, out.numpy()


def pipeline(rank, w, x, n_micro):
    """pipeline_forward of the tanh MLP over four stages, or the
    ValueError's text."""
    import torch

    from deepflow_tpu_torch.parallel.pipeline import pipeline_forward

    def stage_fn(stage_w, h):  # apply this stage's layers in order
        for wi in stage_w:
            h = torch.tanh(h @ wi)
        return h
    try:
        out = pipeline_forward(torch.from_numpy(w), torch.from_numpy(x),
                               stage_fn, _mesh((WORLD,), ("pp",)),
                               axis="pp", n_micro=n_micro)
    except ValueError as e:
        return str(e)
    return out.numpy()


def moe(rank, params, x):
    """moe_ffn over four expert-parallel ranks and moe_ffn_dense."""
    import torch

    from deepflow_tpu_torch.models import moe as tm
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    return (tm.moe_ffn(p, xt, _mesh((WORLD,), ("ep",)), axis="ep").numpy(),
            tm.moe_ffn_dense(p, xt).numpy())


def calls_logged(rank, shape):
    """One sharded tiny step's call log: the windows since the step began
    and the communicators' sizes."""
    import time

    from deepflow_tpu_torch.models import llama as tl
    from deepflow_tpu_torch.tpuprobe.comms import CALLS
    CALLS.clear()   # earlier bodies in this rank logged other axes
    model = tl.Llama(_cfg("float32", {"n_heads": 8, "n_kv_heads": 4}),
                     device="cpu", mesh=_mesh(shape))
    step, _ = tl.make_train_step(model)
    t0 = time.time_ns()
    tokens = np.random.default_rng(1).integers(0, 256, (4, 9))
    step(_rows(model.mesh, tokens))
    return CALLS.since(t0), CALLS.sizes(), step.calls
