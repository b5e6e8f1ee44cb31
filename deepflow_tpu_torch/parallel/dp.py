"""Data parallelism on torch.distributed: the reference's ``jax.pmap`` DP
step (``deepflow_tpu/models/resnet.py::make_pmap_train_step``).

Every rank computes its loss and gradients on its own batch; the
gradients are averaged over the data group (the reference's
``lax.pmean``), the optimizer applies them, and the loss is averaged the
same way, so every rank returns the same mean loss.

- The average is an all-reduce by SUM followed by a division by the
  group's size, on NCCL as on gloo (gloo has no ``ReduceOp.AVG``), as
  ``pmean`` is ``psum`` then a division.
- Gradients travel in buckets, as DDP's do: the parameters, last first
  (the order backward finishes them), are packed into flat buffers of at
  most ``bucket_cap_mb`` each (one dtype per bucket; a larger leaf takes
  a bucket of its own). Each bucket is one all-reduce call. The sum of a
  flat buffer is elementwise the sum of its leaves, so the numbers are
  the per-leaf mean's.
- The loss's mean is one more all-reduce, issued before the optimizer
  step: a step's collectives then all come before its optimizer step,
  which is where the probe's step hook marks the step's end.
- At construction the parameters are broadcast from the group's first
  rank through the same buckets, so ranks start equal whatever their
  initialisation.

``calls_per_step`` is the number of all-reduce calls one step issues:
the buckets plus the loss.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class DataParallelStep:
    def __init__(self, model: torch.nn.Module, loss_fn,
                 optimizer: torch.optim.Optimizer, group=None,
                 bucket_cap_mb: float = 25.0) -> None:
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.group = group
        self.world = dist.get_world_size(group)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.buckets = make_buckets(self.params,
                                    int(bucket_cap_mb * (1 << 20)))
        self.calls_per_step = len(self.buckets) + 1
        src = dist.get_global_rank(group, 0) if group is not None else 0
        with torch.no_grad():
            for bucket in self.buckets:
                flat = _flatten([p.detach() for p in bucket])
                dist.broadcast(flat, src=src, group=group)
                _unflatten_into(flat, [p.data for p in bucket])

    def __call__(self, *batch) -> torch.Tensor:
        """One step on this rank's batch; returns the mean loss over the
        group (detached)."""
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        def sum_(t: torch.Tensor) -> None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        mean = average_(self.buckets, loss, self.world, sum_)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return mean


def average_(buckets: list[list], loss: torch.Tensor, n: int, sum_
             ) -> torch.Tensor:
    """The buckets' gradients, in place, and the loss averaged over n
    replicas: ``sum_(t)`` sums a flat buffer over them in place. Returns
    the mean loss (detached)."""
    with torch.no_grad():
        for bucket in buckets:
            grads = [p.grad if p.grad is not None
                     else torch.zeros_like(p) for p in bucket]
            flat = _flatten(grads)
            sum_(flat)
            flat.div_(n)
            for p, g in zip(bucket, grads):
                if p.grad is None:
                    p.grad = g
            _unflatten_into(flat, [p.grad for p in bucket])
        mean = loss.detach().clone()
        sum_(mean)
        return mean.div_(n)


def make_buckets(params: list, cap_bytes: int) -> list[list]:
    """Parameters, last first, packed into buckets of one dtype and at
    most ``cap_bytes`` (a larger parameter is a bucket of its own)."""
    buckets: list[list] = []
    cur: list = []
    size = 0
    for p in reversed(params):
        nbytes = p.numel() * p.element_size()
        if cur and (size + nbytes > cap_bytes or cur[0].dtype != p.dtype):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(p)
        size += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _flatten(tensors: list) -> torch.Tensor:
    """One flat buffer of the tensors' elements in logical order."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten_into(flat: torch.Tensor, tensors: list) -> None:
    """Copy a flat buffer back into the tensors (whatever their memory
    format)."""
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n
