"""The collectives of the port's sharded modules, written out as Megatron
does, each an autograd function with its conjugate backward, each call
logged for the probe.

The reference leaves its collectives to XLA: GSPMD inserts them from the
PartitionSpecs (the sharded Llama), or ``shard_map`` bodies name them
(``psum``, ``ppermute``). The port issues them through
``torch.distributed`` on one mesh axis's group:

=====================  ===========================  =======================
function               forward                      backward
=====================  ===========================  =======================
``reduce_from``        all-reduce (SUM)             identity
``copy_to``            identity                     all-reduce (SUM)
``gather_from``        all-gather along a dim       reduce-scatter, mean
``all_gather``         all-gather along a dim       reduce-scatter, sum
``ppermute``           send to +1, receive from -1  the same, the other way
=====================  ===========================  =======================

``reduce_from`` ends a row-parallel product: each rank holds a partial
sum and every rank goes on with the total, whose gradient reaches each
partial unchanged. ``copy_to`` starts a column-parallel one: each rank
uses the same input for its columns, so the input's gradient is the sum
of the ranks' partial gradients. ``gather_from`` puts a weight's blocks
together before use (fsdp): the ranks of its group compute on the same
batch (the reference splits tokens over ``data`` only), so the gathered
weight's gradient is the same on each, and its reduce-scatter is divided
by the group's size, the mean of equal copies. ``all_gather`` puts an
activation's column blocks together (the sharded Llama's queries, keys
and values when heads straddle tensor ranks): each rank then uses a
different part of the whole, so the gradient of its block is the sum of
the ranks' partial gradients. ``ppermute`` is the
reference's ``lax.ppermute`` around a ring of the axis (ring attention's
K/V blocks, the pipeline's activations): one ``batch_isend_irecv`` per
call, and its backward sends each gradient back to the rank its value
came from.

A call on a one-rank group is an identity and issues nothing, as a
one-device axis has no collective to run. Every other call is logged
(``tpuprobe/comms.py``) under its axis's communicator, so the probe tells
apart the NCCL kernels of several communicators on one rank.
``all_reduce_`` and ``all_reduce_max`` are the in-place, gradient-free
forms for gradients, losses and softmax maxima.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from deepflow_tpu_torch.tpuprobe.comms import logged


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its group, size and place."""
    name: str
    group: object
    size: int
    index: int

    @staticmethod
    def of(mesh, name: str) -> "Axis":
        return Axis(name, mesh.get_group(name),
                    mesh.size(mesh.mesh_dim_names.index(name)),
                    mesh.get_local_rank(name))

    def peer(self, shift: int) -> int:
        """The global rank ``shift`` places along the ring of this axis."""
        return dist.get_global_rank(self.group,
                                    (self.index + shift) % self.size)


def all_reduce_(t: torch.Tensor, axis: Axis,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over the axis (no autograd)."""
    if axis.size > 1:
        with logged(axis.name, axis.size):
            dist.all_reduce(t, op=op, group=axis.group)
    return t


def all_reduce_max(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    return all_reduce_(t, axis, dist.ReduceOp.MAX)


def _all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
    with logged(axis.name, axis.size):
        dist.all_gather_into_tensor(out, x, group=axis.group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // axis.size, *x.shape[1:]))
    with logged(axis.name, axis.size):
        dist.reduce_scatter_tensor(out, x, group=axis.group)
    return out.movedim(0, dim)


def _rotate(tensors: tuple, axis: Axis, shift: int) -> tuple:
    """Every tensor to the rank ``shift`` places on, from the rank as
    many places back: one batch of sends and receives."""
    send_to, recv_from = axis.peer(shift), axis.peer(-shift)
    outs, ops = [], []
    for t in tensors:
        t = t.contiguous()
        out = torch.empty_like(t)
        outs.append(out)
        ops += [dist.P2POp(dist.isend, t, send_to, axis.group),
                dist.P2POp(dist.irecv, out, recv_from, axis.group)]
    with logged(axis.name, axis.size):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(outs)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mean):
        ctx.axis, ctx.dim, ctx.mean = axis, dim, mean
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        out = _reduce_scatter(g, ctx.axis, ctx.dim)
        if ctx.mean:
            out.div_(ctx.axis.size)
        return out, None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, shift, *tensors):
        ctx.axis, ctx.shift = axis, shift
        return _rotate(tensors, axis, shift)

    @staticmethod
    def backward(ctx, *grads):
        grads = tuple(torch.zeros_like(g) if g is None else g for g in grads)
        return (None, None, *_rotate(grads, ctx.axis, -ctx.shift))


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return x if axis.size == 1 else _GatherFrom.apply(x, axis, dim, True)


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return x if axis.size == 1 else _GatherFrom.apply(x, axis, dim, False)


def ppermute(axis: Axis, *tensors: torch.Tensor, shift: int = 1) -> tuple:
    """Each tensor from the rank ``shift`` places back along the axis's
    ring (the reference's perm ``[(i, (i + shift) % n)]``)."""
    if axis.size == 1:
        return tensors
    return _Ppermute.apply(axis, shift, *tensors)
