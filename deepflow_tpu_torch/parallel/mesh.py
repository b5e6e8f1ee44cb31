"""Device mesh construction and parameter sharding on torch.distributed.

Port of ``deepflow_tpu/parallel/mesh.py``. The mesh is a torch
``DeviceMesh`` over the default process group with the reference's axis
names, one sub-group per axis; a rank's shard of a parameter is the block
that JAX's ``NamedSharding`` puts on the device at the same mesh
position (each dimension a PartitionSpec names is cut into equal
contiguous blocks along that axis, block i on the axis's i-th device).

- ``factor_devices`` is the reference's, copied.
- ``make_mesh`` needs the default process group (NCCL on the card, gloo
  with ``device="cpu"``) and one rank per mesh position.
- ``shard_params`` keeps this rank's block of each full tensor, and
  ``gather_of`` puts a full tensor back together.
- The reference's ``named_sharding_tree`` has no counterpart: a torch
  tensor carries no sharding, each rank holds its block as a plain
  tensor, and the sharded step issues its collectives itself
  (``parallel/collectives.py``).
- The reference's ``shard_map`` shim has none either: the per-rank
  bodies of ring attention, the pipeline and MoE are plain functions of
  the rank's blocks.

Specs are the reference's PartitionSpecs kept as tuples of axis names
(None for a dimension that is not cut), e.g. ``(None, "fsdp", "tensor")``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from deepflow_tpu_torch.device import resolve_device

AXES = ("data", "fsdp", "tensor")


def factor_devices(n: int) -> tuple[int, int, int]:
    """Factor n devices into (data, fsdp, tensor) mesh dims.

    Heuristic: tensor gets up to 4 (ICI-local), fsdp absorbs the middle,
    data the rest — mirrors common v5e fsdp+tp layouts.
    """
    tensor = 1
    for t in (4, 2):
        if n % t == 0 and n >= t:
            tensor = t
            break
    rem = n // tensor
    fsdp = 1
    for f in (8, 4, 2):
        if rem % f == 0 and rem >= f:
            fsdp = f
            break
    data = rem // fsdp
    return (data, fsdp, tensor)


def make_mesh(shape: tuple[int, ...] | None = None,
              device: str | torch.device = "cuda",
              axes: tuple[str, ...] = AXES):
    """A DeviceMesh of ``shape`` (default ``factor_devices(world)``) over
    the default process group, with dimension names ``axes``. Raises
    ValueError when the shape does not hold the world's ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    world = dist.get_world_size()
    if shape is None:
        shape = factor_devices(world)
    shape = tuple(int(x) for x in shape)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh {shape} over axes {axes} != {world} ranks")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def axis_size(mesh, axis: str) -> int:
    """The axis's size; 1 for an axis the mesh does not have (a spec's
    cut over it is no cut)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 off the mesh's axes)."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def shard_of(x, spec: tuple, mesh):
    """This rank's block of the full array ``x`` under ``spec`` (a torch
    tensor or a numpy array; a view where the cut allows one). Raises
    ValueError when a cut dimension does not divide by its axis."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide by the {axis!r} axis of {n}")
        step = x.shape[dim] // n
        i = axis_index(mesh, axis)
        index = [slice(None)] * x.ndim
        index[dim] = slice(i * step, (i + 1) * step)
        x = x[tuple(index)]
    return x


def shard_params(params: dict, specs: dict, mesh) -> dict:
    """A nested tree of full tensors -> the same tree of this rank's
    blocks (contiguous copies) under the spec tree."""
    out: dict = {}
    for k, v in params.items():
        out[k] = (shard_params(v, specs[k], mesh) if isinstance(v, dict)
                  else shard_of(v, specs[k], mesh).contiguous())
    return out


def gather_of(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from every rank's block ``x`` under ``spec``: an
    all-gather along each cut dimension's axis (every rank gets it)."""
    for dim in reversed(range(len(spec))):
        axis = spec[dim]
        n = 1 if axis is None else axis_size(mesh, axis)
        if n == 1:
            continue
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
        x = torch.cat(parts, dim=dim)
    return x
