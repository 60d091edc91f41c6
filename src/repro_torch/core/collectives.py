"""The collectives over a device mesh's named axes, on torch.distributed.

The HE core (bfv.kswitch_gathered) and the query engine
(engine/sharded.py) split work by rank through these helpers, and
gradient compression (train/compression.compressed_psum) sums over them;
the mesh factories live in launch/mesh.py.  The query engine runs one
process per rank, each holding its lanes of every stacked batch and its
limbs of them, and every key switch key by its output-limb slice
(`gather_axis` over "data" gathers a batch's lanes, over "model" its
limbs); the scan step (launch/nshedb_step.query_step_sharded) holds only
its shard.  A
collective here is the only place where ranks exchange data.

Every helper adds the bytes of its result, by the kinds the JAX
package's dry-run parses from HLO, to a per-process record
(`collective_record`, `reset_collective_record`): the logical
collective, whatever the backend does underneath, so a gloo run and the
dry-run's count compare.  An axis of one rank, or none, communicates
nothing and records nothing.  A meta tensor carries no data: the helper
returns a meta tensor of its result's shape and records it, and sends
nothing (the dry-run, launch/dryrun.py, drives the step so on a stand-in
of the production mesh).

While a query records (runtime/tracing.py), each exchange is a span
`coll.<kind>` whose attrs hold the axis, its ranks and the result's
bytes; it times the host's issue of the collective (on NCCL the device
runs it later, in the collective's own kernel).

`gather_axis` and `reduce_scatter_axis` take `async_op`: the exchange is
issued and a `Pending` returned, whose `wait()` gives the result once
the current stream (on gloo, the host) has waited for it, so that a
caller can issue work of its own in between (the scan step's lanes,
launch/nshedb_step.py).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..runtime import tracing

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
_RECORD = dict.fromkeys(COLLECTIVE_KINDS, 0)


def collective_record() -> dict[str, int]:
    """Result bytes by collective kind since the last reset."""
    return dict(_RECORD)


def reset_collective_record() -> None:
    for kind in _RECORD:
        _RECORD[kind] = 0


def _record(kind: str, shape, t: torch.Tensor) -> int:
    nbytes = math.prod(shape) * t.element_size()
    _RECORD[kind] += nbytes
    return nbytes


def _span(kind: str, axis: str, ranks: int, nbytes: int):
    """The span of one exchange (the shared no-op context unless a query
    records)."""
    sp = tracing.span("coll." + kind)
    if tracing.recording():
        sp.attrs.update(axis=axis, ranks=ranks, bytes=nbytes)
    return sp


class Pending:
    """An exchange issued with `async_op`: `wait()` makes the current
    stream (on gloo, the host) wait for it and returns its result."""

    def __init__(self, work, finish):
        self._work, self._finish = work, finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._finish()


def _result(value: torch.Tensor, async_op: bool):
    """`value` as a helper returns it: itself, or a `Pending` already done."""
    return Pending(None, lambda: value) if async_op else value


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


def gather_axis(t: torch.Tensor, mesh, axis: str, dim: int, *, async_op: bool = False):
    """All-gather `t` over the ranks of `axis`, concatenated along `dim`
    in rank order (the identity on an axis of one rank or none); a
    `Pending` of it with `async_op`."""
    size = mesh_axes(mesh).get(axis, 1)
    if size == 1:
        return _result(t, async_op)
    shape = list(t.shape)
    shape[dim] *= size
    nbytes = _record("all-gather", shape, t)
    if t.is_meta:
        return _result(t.new_empty(shape), async_op)
    parts = [torch.empty_like(t) for _ in range(size)]
    with _span("all-gather", axis, size, nbytes):
        work = dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis),
                               async_op=async_op)
    if async_op:
        return Pending(work, lambda: torch.cat(parts, dim=dim))
    return torch.cat(parts, dim=dim)


def sum_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum `t` in place over the ranks of `axis` and return it."""
    size = mesh_axes(mesh).get(axis, 1)
    if size > 1:
        nbytes = _record("all-reduce", t.shape, t)
        if not t.is_meta:
            with _span("all-reduce", axis, size, nbytes):
                dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def reduce_scatter_axis(t: torch.Tensor, mesh, axis: str, dim: int, *,
                        async_op: bool = False):
    """Sum `t` over the ranks of `axis` and return this rank's contiguous
    slice of `dim` (its index along `axis` of `size` equal parts), or a
    `Pending` of it with `async_op`; `t` is left as it was.  NCCL
    reduce-scatters; gloo has none, so there the sum is an all-reduce of
    a copy, then sliced: the same result, and recorded as the
    reduce-scatter it stands for."""
    size = mesh_axes(mesh).get(axis, 1)
    if size == 1:
        return _result(t, async_op)
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{size} ranks of {axis!r}")
    moved = t.movedim(dim, 0)
    per = moved.shape[0] // size
    shape = (per, *moved.shape[1:])
    nbytes = _record("reduce-scatter", shape, t)
    if t.is_meta:
        return _result(moved.new_empty(shape).movedim(0, dim), async_op)
    group = mesh.get_group(axis)
    nccl = dist.get_backend(group) == "nccl"
    lo = axis_index(mesh, axis) * per
    with _span("reduce-scatter", axis, size, nbytes):
        if nccl:
            out = moved.new_empty(shape)
            work = dist.reduce_scatter_tensor(out, moved.contiguous(), group=group,
                                              async_op=async_op)
        else:
            out = moved.clone(memory_format=torch.contiguous_format)
            work = dist.all_reduce(out, group=group, async_op=async_op)

    def finish():
        return (out if nccl else out[lo:lo + per].clone()).movedim(0, dim)

    return Pending(work, finish) if async_op else finish()


def max_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum of `t` over the ranks of `axis`, in place;
    returns `t`."""
    size = mesh_axes(mesh).get(axis, 1)
    if size > 1:
        nbytes = _record("all-reduce", t.shape, t)
        if not t.is_meta:
            with _span("all-reduce", axis, size, nbytes):
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return t
