"""Mesh construction on torch.distributed (the collectives over a
mesh's axes are in core/collectives.py).

Defined as functions (no module-level state) so importing this module
touches no process group.

Every factory routes through one `_device_mesh` helper: the first
`prod(shape)` ranks of the initialised process group reshaped to the
axis grid, so the production, host, scan and query meshes all agree on
rank ordering — a worker id on the flattened grid maps to the same rank
no matter which factory built the mesh.  A mesh lives on "cuda" when the
group's backend is NCCL or the caller's tensors lie on the card
(`device`), else on "cpu".  Building a mesh creates its axes' process
groups, so every rank of the group calls the factory together.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core.collectives import visible_ranks


def _device_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None):
    """The one mesh constructor: first prod(shape) ranks, row-major."""
    from torch.distributed.device_mesh import DeviceMesh

    need = math.prod(shape)
    have = visible_ranks()
    if not have:
        raise ValueError(f"mesh {shape} over {axes} needs an initialised "
                         f"torch.distributed process group")
    if need > have:
        raise ValueError(f"mesh {shape} over {axes} needs {need} ranks "
                         f"but only {have} are in the process group")
    on_card = (dist.get_backend() == "nccl"
               or (device is not None and torch.device(device).type == "cuda"))
    return DeviceMesh("cuda" if on_card else "cpu",
                      torch.arange(need).reshape(shape), mesh_dim_names=axes)


def production_mesh_shape(*, multi_pod: bool = False):
    """(shape, axis names) of the production mesh: 16x16 = 256 ranks;
    2 x 16 x 16 = 512 multi-pod."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    return _device_mesh(*production_mesh_shape(multi_pod=multi_pod), device)


def make_host_mesh(device=None):
    """Every rank of the process group on one ("data",) axis."""
    return _device_mesh((visible_ranks(),), ("data",), device)


def make_scan_mesh(shards: int, device=None):
    """1-D ("data",) mesh over the first `shards` ranks: the sharded scan
    executor (engine/sharded.py) partitions stacked ciphertext-block
    columns over it; elastic re-planning (runtime/elastic.py) may shrink
    it after a straggler exclusion."""
    return _device_mesh((shards,), ("data",), device)


def make_query_mesh(data: int, model: int, device=None):
    """2-D ("data", "model") mesh for sharded query execution: block lanes
    over "data", the k RNS limbs of every (nblocks, 2, k, n) batch over
    "model", so only the key-switch digit all-gather crosses it
    (engine/sharded.py, core/bfv.py: kswitch_gathered)."""
    return _device_mesh((data, model), ("data", "model"), device)


def make_step_mesh(pod: int, data: int, model: int, device=None):
    """3-D ("pod", "data", "model") mesh for the scan step
    (launch/nshedb_step.query_step_sharded): blocks over "pod" and
    "data", limbs over "model" — the multi-pod production mesh's axes at
    any size."""
    return _device_mesh((pod, data, model), ("pod", "data", "model"), device)
