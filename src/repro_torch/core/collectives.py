"""The collectives over a device mesh's named axes, on torch.distributed.

The HE core (bfv.kswitch_gathered) and the query engine
(engine/sharded.py) split work by rank through these helpers, and
gradient compression (train/compression.compressed_psum) sums over them;
the mesh factories live in launch/mesh.py.  The port runs one process
per rank on replicated state (every rank holds every ciphertext and
key), so a collective here is the only place where ranks exchange data.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def sum_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum `t` in place over the ranks of `axis` and return it."""
    if mesh_axes(mesh).get(axis, 1) > 1:
        dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def max_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum of `t` over the ranks of `axis`, in place;
    returns `t`."""
    if mesh_axes(mesh).get(axis, 1) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return t
