"""Dry-run of the paper's scan cells on a production mesh: per (cell x
mesh) what one device holds, computes and sends, with no process group
and nothing allocated.

The step itself runs: `nshedb_step.query_step_sharded` for rank 0 of the
production mesh (`mesh.production_mesh_shape`), on meta tensors of one
device's shard shapes (`nshedb_step.shard_inputs`), under a stand-in
mesh (`ShapeMesh`) whose collectives return meta tensors of their
result's shape and add to `core/collectives`' record.  A
`TorchDispatchMode` (`StepCounter`) reads every op.  The record keeps
the JAX package's field names; the numbers are the port's own, not
XLA's:

  argument_bytes    one device's shard of every input
                    (`nshedb_step.input_specs`) as
                    `nshedb_step.step_shardings` places it (q, mu and
                    perm whole)
  output_bytes      the step's result on that device: the (2, k, n)
                    aggregate with its limbs over "model"
  flops             integer operations: each mul_mod / add_mod call the
                    operations per element of its CUDA body
                    (`KERNEL_OPS`) times its elements; every other
                    arithmetic op one per output element; copies,
                    indexing and views none
  hlo_bytes         each op's inputs read once and its output written
                    once, int64: a kernel call its operands as the
                    wrapper hands them over (kernels/modops/ops.
                    kernel_operands, whose copies count as ops of
                    their own); an input the op reads through a
                    broadcast counted at its distinct elements; views
                    nothing
  temp_bytes        the most bytes live at once in tensors the step
                    made (the arguments and the constant tables apart;
                    the collectives' results included, their
                    backends' staging buffers not)
  peak_bytes        argument_bytes + temp_bytes
  collective_bytes  result bytes of the collectives by the JAX
                    package's five kinds (core/collectives.
                    collective_record): the all-gather of the key
                    switch's digits, or its reduce-scatter, and the
                    all-reduce of the aggregate over each block axis
                    of more than one rank ("pod" and "data" apart)
  collective_total  their sum
  lower_s, compile_s  null, with the reason under `null_reasons`

`ks_mode`, `key_placement` and `chunk` name what ran.  The
language-model cells are recorded as skipped: the training slice is
ported, but their parameter placements come from the reference's
`repro.dist.sharding`, which is not in the tree.  One JSON file a cell
goes to `--out` (default `.scratch/dryrun/` in the checkout);
`--skip-existing` keeps a cell whose file says "ok".

Usage:
  python -m repro_torch.launch.dryrun --arch nshedb --shape scan_2m
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core import collectives
from ..kernels.modops import ops as modops
from ..kernels.tables import LimbTables
from . import nshedb_step as Q
from .mesh import production_mesh_shape

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
                       ".scratch", "dryrun")
_NO_COMPILER = "no compiler in the port: the step runs eagerly, one op at a time"
NULL_REASONS = {"lower_s": _NO_COMPILER, "compile_s": _NO_COMPILER}
LM_SKIP = ("the training slice is ported, but the cell's parameter placements "
           "come from repro.dist.sharding, which is not in the tree")

# Integer operations per element of each kernel: the functor that
# pointwise_kernel applies (csrc/modops.cu:25-37) over csrc/u32.cuh.
#   mul_mod  barrett_mulmod (u32.cuh:27-33): the 64-bit product, the high
#            product with mu, qhat * q, the difference, the compare and
#            the conditional subtraction
#   add_mod  add_mod (u32.cuh:35-38): the sum, the compare and the
#            conditional subtraction
# The loop's index arithmetic (modops.cu:55-56) is not counted.
KERNEL_OPS = {"mul_mod": 6, "add_mod": 3}
# ops counted one operation per output element (in place or not)
_ARITH = frozenset({"add", "sub", "rsub", "mul", "div", "remainder", "fmod", "floor_divide",
                    "neg", "abs", "eq", "ne", "lt", "le", "gt", "ge", "where", "maximum",
                    "minimum", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
                    "sum"})
# ops that allocate without reading or writing data
_ALLOC = frozenset({"empty", "new_empty", "empty_like", "empty_strided", "new_empty_strided"})


class ShapeMesh:
    """Stand-in for a DeviceMesh of a given shape and axis names, seen
    from the rank at coordinate 0 of every axis.  It has no process
    group: `core/collectives` reads its axes and this rank's index and,
    given meta tensors, sends nothing."""

    def __init__(self, shape, mesh_dim_names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(mesh_dim_names)

    def get_local_rank(self, axis: str) -> int:
        return 0

    def get_group(self, axis: str):
        raise RuntimeError("a ShapeMesh has no process group: give its collectives "
                           "meta tensors")


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor reaches (a broadcast dimension,
    stride 0, once)."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st) * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts the operations and bytes of every op (the module
    docstring's `flops` and `hlo_bytes`) and the most bytes live at
    once in the storages the ops make (`peak_temp`): a storage lives
    while a tensor over it does.  `args` are tensors that exist before
    (inputs, tables); their storages are not counted."""

    def __init__(self, args):
        super().__init__()
        self.flops = self.bytes = self.live = self.peak_temp = 0
        self._args = {_storage(t) for t in args}
        self._refs: dict[int, list] = {}

    def _drop(self, key: int) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if not ref[0]:
            self.live -= ref[1]
            del self._refs[key]

    def _hold(self, t: torch.Tensor) -> None:
        key = _storage(t)
        if key in self._args:
            return
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += ref[1]
            self.peak_temp = max(self.peak_temp, self.live)
        ref[0] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__.rstrip("_")
        if not func.is_view and name not in _ALLOC:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_distinct_bytes, ins)) + sum(map(_distinct_bytes, outs))
            if name in _ARITH:
                self.flops += sum(t.numel() for t in outs)
        for t in outs:
            self._hold(t)
        return out

    def kernel(self, name: str, a, b, tabs):
        """A mul_mod / add_mod call as the card runs it: the wrapper's
        operand copies (ops of their own), then the kernel's output, its
        operations and its bytes."""
        shape, a, b = modops.kernel_operands(a, b, tabs)
        out = a.new_empty(shape)
        self.flops += KERNEL_OPS[name] * out.numel()
        self.bytes += (a.numel() + b.numel() + out.numel()) * out.element_size()
        return out


@contextlib.contextmanager
def _kernels_counted(counter: StepCounter):
    """The scan step's mul_mod / add_mod calls go to `counter.kernel`
    (the plain versions would count their own int64 ops instead)."""
    saved = Q.mul_mod, Q.add_mod
    Q.mul_mod = lambda a, b, tabs: counter.kernel("mul_mod", a, b, tabs)
    Q.add_mod = lambda a, b, tabs: counter.kernel("add_mod", a, b, tabs)
    try:
        yield
    finally:
        Q.mul_mod, Q.add_mod = saved


def meta_tables(k: int, n: int) -> LimbTables:
    """`LimbTables` of k limbs at ring degree n on the meta device."""
    def e(*shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    return LimbTables(k=k, n=n, device=torch.device("meta"), q=e(k), psi=e(k, n),
                      ipsi=e(k, n), ninv=e(k), q32=e(k, dtype=i32), psi32=e(k, n, dtype=i32),
                      psi_shoup=e(k, n, dtype=i32), ipsi32=e(k, n, dtype=i32),
                      ipsi_shoup=e(k, n, dtype=i32), ninv32=e(k, dtype=i32),
                      ninv_shoup=e(k, dtype=i32), mu64=e(k))


def measure_step(cfg, mesh_shape, axes, nblocks: int, *, rot_steps: int | None = None,
                 ks_mode: str | None = None, chunk: int | None = None) -> dict:
    """The module docstring's argument_bytes, output_bytes, flops,
    hlo_bytes, temp_bytes, collective_bytes and collective_total of rank
    0's `query_step_sharded` at `cfg` on `nblocks` blocks over a mesh of
    this shape and axes (`chunk`: all of the rank's blocks when None)."""
    mesh = ShapeMesh(mesh_shape, axes)
    local = Q.shard_inputs(Q.input_specs(cfg, nblocks), mesh, ks_mode)
    nbytes = lambda t: t.numel() * t.element_size()
    tabs = meta_tables(cfg.k, cfg.n)
    names = ("cts_col", "cts_val", "rlk_b", "rlk_a", "gk_b", "gk_a")
    args = [local[key] for key in names]
    held = args + [local["perm"]] + [v for v in vars(tabs).values()
                                     if isinstance(v, torch.Tensor)]
    counter = StepCounter(held)
    collectives.reset_collective_record()
    with _kernels_counted(counter), counter:
        out = Q.query_step_sharded(*args, tabs, local["perm"], mesh, eq_levels=cfg.eq_levels,
                                   rot_steps=cfg.rot_steps if rot_steps is None else rot_steps,
                                   ks_mode=ks_mode, chunk=chunk)
        output_bytes = nbytes(out)
        del out
    coll = collectives.collective_record()
    collectives.reset_collective_record()
    return {"argument_bytes": sum(map(nbytes, local.values())), "output_bytes": output_bytes,
            "flops": counter.flops, "hlo_bytes": counter.bytes,
            "temp_bytes": counter.peak_temp, "collective_bytes": coll,
            "collective_total": sum(coll.values()), "chunk": chunk or args[0].shape[0]}


def run_cell(arch: str, shape: str, mesh_kind: str) -> dict:
    dims, axes = production_mesh_shape(multi_pod=mesh_kind == "multi")
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "mesh_shape": list(dims), "status": "ok"}
    t0 = time.time()
    if arch == "nshedb":
        from ..configs.nshedb import CONFIG, SHAPES

        cell = SHAPES[shape]
        mode = cell.get("ks_mode") or Q.KS_MODE
        rec.update(lower_s=None, compile_s=None)
        got = measure_step(CONFIG, dims, axes, cell["nblocks"],
                           rot_steps=cell.get("rot_steps"), ks_mode=mode)
        rec.update({key: got[key] for key in ("argument_bytes", "output_bytes", "flops",
                                              "hlo_bytes", "temp_bytes", "collective_bytes",
                                              "collective_total")})
        rec["peak_bytes"] = rec["argument_bytes"] + rec["temp_bytes"]
        rec.update(ks_mode=mode, chunk=got["chunk"],
                   key_placement=list(Q.step_shardings(axes, mode)["rlk_b"]),
                   null_reasons=dict(NULL_REASONS))
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
    ap.add_argument("--out", default=OUT_DIR, help="directory of the record files")
    ap.add_argument("--skip-existing", action="store_true",
                    help="keep a cell whose record file says ok")
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
    os.makedirs(args.out, exist_ok=True)
    records = []
    for arch, shape in cells:
        for mk in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mk}.json".replace("/", "_"))
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") == "ok":
                        print(json.dumps({"arch": arch, "shape": shape, "mesh": mk,
                                          "skipped": path}), flush=True)
                        continue
            rec = run_cell(arch, shape, mk)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
