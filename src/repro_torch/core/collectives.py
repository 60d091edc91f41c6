"""The collectives over a device mesh's named axes, on torch.distributed.

The HE core (bfv.kswitch_gathered) and the query engine
(engine/sharded.py) split work by rank through these helpers, and
gradient compression (train/compression.compressed_psum) sums over them;
the mesh factories live in launch/mesh.py.  The query engine runs one
process per rank on replicated state (every rank holds every ciphertext
and key); the scan step (launch/nshedb_step.query_step_sharded) holds
only its shard.  A collective here is the only place where ranks
exchange data.

Every helper adds the bytes of its result, by the kinds the JAX
package's dry-run parses from HLO, to a per-process record
(`collective_record`, `reset_collective_record`): the logical
collective, whatever the backend does underneath, so a gloo run and the
dry-run's count compare.  An axis of one rank, or none, communicates
nothing and records nothing.  A meta tensor carries no data: the helper
returns a meta tensor of its result's shape and records it, and sends
nothing (the dry-run, launch/dryrun.py, drives the step so on a stand-in
of the production mesh).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
_RECORD = dict.fromkeys(COLLECTIVE_KINDS, 0)


def collective_record() -> dict[str, int]:
    """Result bytes by collective kind since the last reset."""
    return dict(_RECORD)


def reset_collective_record() -> None:
    for kind in _RECORD:
        _RECORD[kind] = 0


def _record(kind: str, shape, t: torch.Tensor) -> None:
    _RECORD[kind] += math.prod(shape) * t.element_size()


def visible_ranks() -> int:
    """Ranks of the initialised process group (0 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"expected a torch DeviceMesh with named axes, got {mesh!r}")
    return dict(zip(names, mesh.shape))


def axis_index(mesh, axis: str) -> int:
    """This rank's index along `axis` (0 when the mesh lacks the axis)."""
    return mesh.get_local_rank(axis) if axis in mesh_axes(mesh) else 0


def gather_axis(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """All-gather `t` over the ranks of `axis`, concatenated along `dim`
    in rank order (the identity on an axis of one rank or none)."""
    size = mesh_axes(mesh).get(axis, 1)
    if size == 1:
        return t
    shape = list(t.shape)
    shape[dim] *= size
    _record("all-gather", shape, t)
    if t.is_meta:
        return t.new_empty(shape)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def sum_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum `t` in place over the ranks of `axis` and return it."""
    if mesh_axes(mesh).get(axis, 1) > 1:
        _record("all-reduce", t.shape, t)
        if not t.is_meta:
            dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def reduce_scatter_axis(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Sum `t` over the ranks of `axis` and return this rank's contiguous
    slice of `dim` (its index along `axis` of `size` equal parts); `t`
    is left as it was.  NCCL reduce-scatters; gloo has none, so there
    the sum is an all-reduce of a copy, then sliced: the same result, and
    recorded as the reduce-scatter it stands for."""
    size = mesh_axes(mesh).get(axis, 1)
    if size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{size} ranks of {axis!r}")
    moved = t.movedim(dim, 0)
    per = moved.shape[0] // size
    shape = (per, *moved.shape[1:])
    _record("reduce-scatter", shape, t)
    if t.is_meta:
        return moved.new_empty(shape).movedim(0, dim)
    group = mesh.get_group(axis)
    if dist.get_backend(group) == "nccl":
        out = moved.new_empty(shape)
        dist.reduce_scatter_tensor(out, moved.contiguous(), group=group)
    else:
        full = moved.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(full, group=group)
        lo = axis_index(mesh, axis) * per
        out = full[lo:lo + per].clone()
    return out.movedim(0, dim)


def max_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum of `t` over the ranks of `axis`, in place;
    returns `t`."""
    if mesh_axes(mesh).get(axis, 1) > 1:
        _record("all-reduce", t.shape, t)
        if not t.is_meta:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return t
