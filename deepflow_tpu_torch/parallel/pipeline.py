"""Pipeline parallelism: a GPipe microbatch schedule over a 'pp' axis.

Port of ``deepflow_tpu/parallel/pipeline.py``, forward only as the
reference's ``pipeline_forward``. Each rank of the axis is a stage
holding a contiguous slice of the layers; activations pass stage to stage
with ``collectives.ppermute`` (one ``batch_isend_irecv`` a tick, the
ring's wrap from the last stage to the first kept, as the reference's
perm) while microbatches fill the pipeline: ``n_micro + n_stages - 1``
ticks. Only the last stage holds real outputs, the others zeros; a final
all-reduce over the axis (the reference's ``psum``) gives every stage
the result.
"""

from __future__ import annotations

import torch

from deepflow_tpu_torch.parallel.collectives import (
    Axis, ppermute, reduce_from)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _pipeline_local(stage_params, micro: torch.Tensor, axis: Axis,
                    stage_fn, n_micro: int) -> torch.Tensor:
    """This stage's body. stage_params: its layer slice (leading layer
    dim); micro: (n_micro, mb, ...) microbatched input (only stage 0
    reads it). Returns the outputs, replicated over the axis."""
    n_stages, stage = axis.size, axis.index
    cur = micro.new_zeros(micro.shape[1:])
    outs: list = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (when one remains)
        if stage == 0 and t < n_micro:
            cur = micro[t]
        # every stage applies its layers to whatever it holds
        y = stage_fn(stage_params, cur)
        # last stage retires microbatch (t - (n_stages-1)) at this tick
        done = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= done < n_micro:
            outs[done] = y
        # activations advance one stage
        (cur,) = ppermute(axis, y)
    out = (torch.stack(outs) if stage == n_stages - 1
           else torch.zeros_like(micro))
    # only the last stage holds real outputs (zeros elsewhere): the sum
    # over the axis replicates them
    return reduce_from(out, axis)


def pipeline_forward(params, x: torch.Tensor, stage_fn, mesh,
                     axis: str = "pp", n_micro: int = 4) -> torch.Tensor:
    """Run x through layers pipelined across mesh axis ``axis``.

    params: a tensor or a dict tree of them, every leaf's leading layer
    dim divisible by the axis size (each stage takes its contiguous
    slice); x: (batch, ...) with batch divisible by n_micro;
    stage_fn(stage_params, mb) applies one stage's layer slice.
    Returns (batch, ...) outputs on every stage."""
    ax = Axis.of(mesh, axis)
    n_stages = ax.size
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError("batch must divide into microbatches")
    n_layers = _first_leaf(params).shape[0]
    if n_layers % n_stages:
        raise ValueError(
            f"layer dim {n_layers} must divide by pp={n_stages}")
    per = n_layers // n_stages
    lo = ax.index * per
    stage_params = _tree_map(lambda p: p[lo:lo + per], params)
    micro = x.reshape(n_micro, batch // n_micro, *x.shape[1:])
    out = _pipeline_local(stage_params, micro, ax, stage_fn, n_micro)
    return out.reshape(batch, *x.shape[1:])
