"""Dry-run of the paper's scan cells on a production mesh, from shapes:
per (cell x mesh) the argument and output bytes each device holds, read
from the step's meta tensors (`nshedb_step.input_specs`) and placements
(`nshedb_step.shardings`), in a JSON record with the JAX package's field
names.  Nothing is allocated and no process group is needed: the mesh is
its shape and axis names (`mesh.production_mesh_shape`).

The fields only a compiler gives — flops, HLO bytes, temporary and peak
bytes, collective bytes parsed from HLO, lower and compile seconds — are
null, each with its reason under `null_reasons`.  The language-model
cells are recorded as skipped: the training slice is ported, but their
parameter placements come from the reference's `repro.dist.sharding`,
which is not in the tree.

Usage:
  python -m repro_torch.launch.dryrun --arch nshedb --shape scan_2m
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from .mesh import production_mesh_shape

_NO_COMPILER = "no XLA compiler in the port: the record is computed from shapes"
NULL_REASONS = {
    "lower_s": _NO_COMPILER, "compile_s": _NO_COMPILER,
    "flops": "XLA cost analysis of the compiled HLO; " + _NO_COMPILER,
    "hlo_bytes": "XLA cost analysis of the compiled HLO; " + _NO_COMPILER,
    "temp_bytes": "XLA memory analysis of the compiled HLO; " + _NO_COMPILER,
    "peak_bytes": "argument + temporary bytes, and the temporaries need the compiler",
    "collective_bytes": "parsed from the optimized HLO; " + _NO_COMPILER,
    "collective_total": "parsed from the optimized HLO; " + _NO_COMPILER,
}
LM_SKIP = ("the training slice is ported, but the cell's parameter placements "
           "come from repro.dist.sharding, which is not in the tree")


def bytes_per_device(spec: torch.Tensor, placement, axis_sizes: dict) -> int:
    """Bytes of one device's shard of `spec` under `placement` (one entry
    per dimension: None, an axis name or a tuple of names): a dimension
    split over axes of total size s holds ceil(dim / s) entries."""
    total = spec.element_size()
    for dim, axes in zip(spec.shape, placement):
        names = () if axes is None else (axes,) if isinstance(axes, str) else axes
        total *= -(-dim // math.prod(axis_sizes[a] for a in names))
    return total


def nshedb_bytes(shape: str, mesh_kind: str) -> dict:
    """Argument and output bytes per device of one scan cell: the inputs
    as `shardings` places them; the (2, k, n) aggregate with its limbs
    over "model", summed over the block axes."""
    from ..configs.nshedb import CONFIG, SHAPES
    from . import nshedb_step as Q

    dims, axes = production_mesh_shape(multi_pod=mesh_kind == "multi")
    sizes = dict(zip(axes, dims))
    nblocks = SHAPES[shape]["nblocks"]
    specs = Q.input_specs(CONFIG, nblocks)
    place = Q.shardings(axes, CONFIG, nblocks)
    out = torch.empty((2, CONFIG.k, CONFIG.n), dtype=torch.int64, device="meta")
    model = "model" if "model" in axes else None
    return {"argument_bytes": sum(bytes_per_device(specs[k], place[k], sizes) for k in specs),
            "output_bytes": bytes_per_device(out, (None, model, None), sizes)}


def run_cell(arch: str, shape: str, mesh_kind: str) -> dict:
    dims, _ = production_mesh_shape(multi_pod=mesh_kind == "multi")
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "mesh_shape": list(dims), "status": "ok"}
    t0 = time.time()
    if arch == "nshedb":
        rec.update({field: None for field in NULL_REASONS})
        rec.update(nshedb_bytes(shape, mesh_kind))
        rec["null_reasons"] = dict(NULL_REASONS)
    else:
        rec.update(status="skip", reason=LM_SKIP)
    rec["wall_s"] = round(time.time() - t0, 3)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import ARCHS, shape_cells
    from ..configs.nshedb import SHAPES as NSHAPES

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape) for arch in ARCHS
                 for shape, skip in shape_cells(arch) if skip is None]
        cells += [("nshedb", shape) for shape in NSHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    records = [run_cell(arch, shape, mk) for arch, shape in cells for mk in meshes]
    for rec in records:
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
