"""Sharded query execution over ciphertext blocks and RNS limbs (DESIGN §4).

Two orthogonal axes of parallelism, on one 2-D `("data", "model")` grid:

* **data** — scan-first execution is embarrassingly parallel across
  ciphertext blocks: a stacked column is a `(nblocks, 2, k, n)` batch,
  and every mask-evaluation / combination / plaintext-mul step is
  block-local.  Lanes partition over "data"; the block fold is the one
  collective.

* **model** — inside every block, the k RNS limbs are embarrassingly
  parallel for all pointwise mul/add and NTT work, so limbs partition
  over "model" — except key-switching (relinearization after a ct-ct
  multiply, and every Galois rotation), the only cross-limb step in
  core/bfv.py, which gathers the centered decomposition digits along
  "model" before the gadget fold (a multiply of held limbs gathers its
  operands' limbs instead: the HPS tensor's float sums need them all).

This module owns the runtime plumbing:

* `ShardContext` — the per-run distribution plan.  It carries both axis
  sizes, an optional real mesh and a 2-D cost ledger: *distributed*
  units (lanes of a multi-block batch — divide by the data-shard count),
  *replicated* units (singletons and post-fold reductions), fold
  collectives, and *limb-local* bytes (work that divides by the
  per-device limb count) vs *all-gather* bytes (key-switch digit
  movement across "model").
  `modeled_seconds(costs)` prices the ledger with measured per-op
  costs; the limb factor k / ceil(k/M) divides every limb-local term
  and the gather bytes pay `costs["gather_byte"]` seconds each.

* Limb padding: when `k % limb_shards != 0` the limb axis pads up to
  `limb_pad_to(k, M)` — padded limbs are pure ledger entities, so
  decrypt/OpStats stay byte-identical to single-device regardless of M.

* `activate(bk, ctx)` — installs the context on a backend for the
  duration of an execution.  While active, `stack_blocks` pads the lane
  count up to a multiple of `ctx.shards` with zero blocks (uneven
  tables compile to one even launch; `CiphertextBatch.live` records the
  logical count so fold/unstack/decrypt ignore the pads) and every
  `OpStats` charge is mirrored into the ledger.

* A real mesh (launch/mesh.py, a torch DeviceMesh) is attached by
  `make_shard_context("auto")` when a torch.distributed process group
  has at least shards x limb_shards ranks; without one the context is
  logical (padding + ledger on the backend's one device).  Every rank
  runs the same program — the same seed gives every rank the same keys
  and the same block lists — and charges the same ledger, so a rank's
  `ledger_snapshot()` equals the logical context's but for its
  `real_mesh` flag.  A batch stacked on the mesh is held as the
  reference's `batch_sharding` places it (`place_batch`): each rank
  stacks, holds and computes only its `nphys / D` lanes over "data",
  and of them only its `k / M` limbs over "model" where k divides
  (elsewhere every limb).  Each rank holds every key switch key by its
  output-limb slice (`place_keys`, done once by the backend when it
  first key-switches under such a mesh).  Ranks exchange lanes and limbs
  only where the reference's partitioning does: `sharded_fold` (a
  weighted sum of this rank's lanes, an all-reduce over "data", then
  the folded singleton's limbs gathered over "model"), the lane and
  limb all-gathers before a batch is unstacked, decrypted or refreshed
  (BFVBackend), and the key switch's all-gathers over "model" among the
  ranks that hold the same lanes (core/bfv.py).  Singletons, `sk`,
  `pk` and the engine's block lists stay replicated.  A rank outside the
  mesh holds whole batches and keys and computes the one-device path.

Parity contract: padding lanes (block or limb) are exact additive
identities, `_count`/`_nblocks` keep returning *live* lane counts, and
noise accounting never sees the pads — so OpStats, noise trajectories,
refresh schedules and decrypted outputs are byte-identical to the
single-device path for every (shards, limb_shards) combination.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..core.bfv import Keys, KSwitchKey, LaneShard, LimbShard, model_limbs
from ..core.collectives import axis_index, gather_axis, mesh_axes, sum_axis, visible_ranks
from ..launch.mesh import make_query_mesh, make_scan_mesh
from ..runtime.elastic import elastic_limb_plan, elastic_scan_plan

# Modeled interconnect cost of moving one byte in a model-axis
# all-gather (~25 GB/s effective bisection — host-interconnect class).
# Callers override via costs["gather_byte"]; at paper parameters a
# key-switch gather is ~0.3 ms/block against a ~15 s multiply, so the
# limb axis is compute-dominated by 4+ orders of magnitude.
GATHER_BYTE_SECONDS = 4e-11


def pad_to(nblocks: int, shards: int) -> int:
    """Lane count after padding nblocks up to a multiple of shards."""
    if shards <= 1 or nblocks <= 1:
        return nblocks
    return nblocks + (-nblocks) % shards


def limb_pad_to(limbs: int, limb_shards: int) -> int:
    """Limb count after padding k up to a multiple of the model axis.

    Unlike block lanes, a single limb still pads (every ciphertext has
    the full k-limb tower) — the pad limbs are ledger/placement
    entities only and never materialize in ciphertext data."""
    if limb_shards <= 1:
        return limbs
    return limbs + (-limbs) % limb_shards


class ShardContext:
    """2-D distribution plan + cost ledger for one sharded execution."""

    def __init__(self, shards: int, mesh=None, limb_shards: int = 1,
                 limbs: int | None = None, ring_n: int = 0):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if limb_shards < 1:
            raise ValueError(f"limb_shards must be >= 1, got {limb_shards}")
        self.shards = int(shards)          # data axis
        self.limb_shards = int(limb_shards)  # model axis
        self.limbs = limbs                 # k of the backend's RNS tower
        self.ring_n = int(ring_n)          # polynomial degree n
        self.mesh = mesh
        # op -> units that run data-parallel over the shard axis
        # (physical lanes of multi-block batches, pads included — pads
        # occupy a device lane even though OpStats never count them).
        self.dist: dict[str, float] = {}
        # op -> units with no block axis to shard (singletons, folded
        # aggregates, refreshes of single blocks) — serial time.
        self.repl: dict[str, float] = {}
        self.folds = 0         # cross-shard fold collectives issued
        self.gathers = 0       # model-axis key-switch all-gathers issued
        self.gather_bytes = 0.0      # digit bytes moved across "model"
        self.limb_local_bytes = 0.0  # op bytes that stayed limb-local

    # ----------------------------------------------------------- geometry
    @property
    def workers(self) -> int:
        """Flattened worker count: id = data_row * limb_shards + limb."""
        return self.shards * self.limb_shards

    @property
    def limb_mesh(self):
        """The mesh iff it carries a real model axis to key-switch over."""
        if (self.mesh is not None and self.limb_shards > 1
                and "model" in mesh_axes(self.mesh)):
            return self.mesh
        return None

    def limb_factor(self) -> float:
        """Speedup of limb-local work: k over the padded per-device limb
        count, k / ceil(k/M) — exactly M when M divides k, less when
        padding wastes device rows (k=30, M=4 -> 30/8 = 3.75x)."""
        if self.limb_shards <= 1:
            return 1.0
        if not self.limbs:
            return float(self.limb_shards)
        kpad = limb_pad_to(self.limbs, self.limb_shards)
        return self.limbs / (kpad // self.limb_shards)

    def _block_bytes(self) -> int:
        """Device bytes of one (2, kpad, n) int64 block (pads occupy
        device rows, matching the physical-lane ledger philosophy)."""
        if not self.limbs or not self.ring_n:
            return 0
        return 2 * limb_pad_to(self.limbs, self.limb_shards) * self.ring_n * 8

    def _digit_bytes(self) -> int:
        """Bytes of one (kpad, n) int64 centered-digit polynomial — the
        payload a key-switch all-gathers along the model axis."""
        if not self.limbs or not self.ring_n:
            return 0
        return limb_pad_to(self.limbs, self.limb_shards) * self.ring_n * 8

    # ------------------------------------------------------------- ledger
    def record(self, field: str, units: float, distributed: bool) -> None:
        ledger = self.dist if distributed else self.repl
        ledger[field] = ledger.get(field, 0) + units
        self.limb_local_bytes += units * self._block_bytes()

    def record_fold(self, live: int, phys: int) -> None:
        """A block-fold: shard-local adds + one tree combine."""
        local = max(phys - self.shards, 0) if self.shards > 1 else max(phys - 1, 0)
        if local:
            self.dist["add"] = self.dist.get("add", 0) + local
            self.limb_local_bytes += local * self._block_bytes()
        self.folds += 1

    def record_gather(self, units: float) -> None:
        """A key-switch digit all-gather over "model": each unit moves
        one block's (kpad, n) centered-digit polynomial.  Only called
        when limb_shards > 1 — at M=1 there is nothing to gather and
        the ledger must price identically to the 1-D context."""
        self.gathers += 1
        self.gather_bytes += units * self._digit_bytes()

    def modeled_seconds(self, costs: dict) -> float:
        """Price the ledger: distributed time divides by the data-shard
        count AND the limb factor (every op is limb-local), replicated
        time divides by the limb factor alone, the fold tree moves
        limb-sharded payloads, and the gather bytes pay the model-axis
        interconnect — each device already holds its own 1/M slice, so
        only (M-1)/M of every gathered byte crosses the wire."""
        lf = self.limb_factor()
        dist = sum(n * costs.get(op, 0.0) for op, n in self.dist.items())
        repl = sum(n * costs.get(op, 0.0) for op, n in self.repl.items())
        tree = math.ceil(math.log2(self.shards)) if self.shards > 1 else 0
        coll = self.folds * tree * costs.get("add", 0.0)
        gather = (self.gather_bytes
                  * costs.get("gather_byte", GATHER_BYTE_SECONDS)
                  * (self.limb_shards - 1) / max(self.limb_shards, 1))
        return dist / (self.shards * lf) + repl / lf + coll / lf + gather

    def heartbeats(self, costs: dict, slowdowns: dict | None = None,
                   baseline: float = 0.0) -> dict:
        """Per-worker synthetic step times from the cost ledger.

        The sharded scan is bulk-synchronous: every worker carries an
        equal share of the distributed units plus the replicated tail,
        so the modeled per-run seconds *are* each worker's step time.
        Workers enumerate the flattened 2-D grid — id = data_row *
        limb_shards + limb_col — so a straggling chip shows up on
        exactly one (row, column) coordinate.  `slowdowns` scales
        individual workers (real hardware skew, or an injected
        straggler — runtime/faults.py); `baseline` subtracts a prior
        `modeled_seconds` snapshot so a heartbeat reflects one
        execution, not the context's lifetime.  The executor feeds
        these to StragglerDetector.report after every sharded run.
        """
        step = max(self.modeled_seconds(costs) - baseline, 0.0)
        slow = slowdowns or {}
        return {w: step * float(slow.get(w, 1.0)) for w in range(self.workers)}

    def ledger_snapshot(self) -> dict:
        return {"shards": self.shards, "limb_shards": self.limb_shards,
                "dist": dict(self.dist), "repl": dict(self.repl),
                "folds": self.folds, "gathers": self.gathers,
                "gather_bytes": self.gather_bytes,
                "limb_local_bytes": self.limb_local_bytes,
                "limb_factor": self.limb_factor(),
                "real_mesh": self.mesh is not None}

    def reshard(self, excluded, axis: str = "data") -> "ShardContext":
        """Shrink one mesh axis onto the surviving workers after
        straggler exclusion; the other axis is preserved.  `excluded`
        holds data-row ids for axis="data", limb-column ids for
        axis="model"."""
        if axis == "model":
            plan = elastic_limb_plan(self.limb_shards, excluded,
                                     limbs=self.limbs)
            return make_shard_context(self.shards,
                                      limb_shards=plan["limb_shards"],
                                      limbs=self.limbs, ring_n=self.ring_n,
                                      device=self._device())
        plan = elastic_scan_plan(self.shards, excluded)
        return make_shard_context(plan["shards"],
                                  limb_shards=self.limb_shards,
                                  limbs=self.limbs, ring_n=self.ring_n,
                                  device=self._device())

    def _device(self):
        """The device type of the attached mesh, None without one."""
        return getattr(self.mesh, "device_type", None)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"ShardContext(shards={self.shards}, "
                f"limb_shards={self.limb_shards}, "
                f"mesh={'real' if self.mesh is not None else None}, "
                f"folds={self.folds}, gathers={self.gathers})")


def make_shard_context(shards: int, mesh="auto", limb_shards: int = 1,
                       limbs: int | None = None, ring_n: int = 0,
                       device=None) -> ShardContext:
    """Build a context; 'auto' attaches a real mesh when an initialised
    process group has enough ranks, else runs logical-only (padding +
    ledger, single device) so shard plans stay testable on one card.
    `device` is where the backend's tensors lie (launch/mesh.py builds
    the mesh there).

    The model axis gets real placement only when the limb count divides
    evenly (k % M == 0) — otherwise limb sharding stays a ledger/padding
    model (the data axis may still get a real 1-D mesh), keeping device
    arithmetic byte-exact with no materialized pad limbs.
    """
    if isinstance(mesh, str) and mesh == "auto":
        ranks = visible_ranks()
        real_limb_axis = (limb_shards > 1 and limbs is not None
                          and limbs % limb_shards == 0)
        if real_limb_axis and shards * limb_shards <= ranks:
            mesh = make_query_mesh(shards, limb_shards, device=device)
        elif 1 < shards <= ranks:
            mesh = make_scan_mesh(shards, device=device)
        else:
            mesh = None
    return ShardContext(shards, mesh, limb_shards=limb_shards,
                        limbs=limbs, ring_n=ring_n)


def lint_shard_context(ctx: ShardContext, limbs: int | None = None,
                       ring_n: int = 0) -> list:
    """Static placement lint (engine/verify.py): check a shard context's
    2-D geometry against the backend it will execute on.  Returns
    (code, message) tuples; empty means the placement is consistent.

    Rules: the context's recorded RNS tower / ring degree must match the
    backend's; a *real* model axis requires k % M == 0 (the limb-padding
    rule — padded limbs are ledger-only entities and must never get
    device placement); and a real mesh's axis extents must match the
    declared shard counts."""
    out = []
    if limbs is not None and ctx.limbs is not None and ctx.limbs != limbs:
        out.append(("mesh.limbs",
                    f"context RNS tower k={ctx.limbs} != backend k={limbs} "
                    f"— gather-byte and limb-factor accounting would be "
                    f"priced for the wrong ciphertext geometry"))
    if ring_n and ctx.ring_n and ctx.ring_n != ring_n:
        out.append(("mesh.ring",
                    f"context ring_n={ctx.ring_n} != backend slots={ring_n}"))
    if (ctx.limb_mesh is not None and ctx.limbs is not None
            and ctx.limbs % ctx.limb_shards != 0):
        out.append(("mesh.pad",
                    f"real model axis with k={ctx.limbs} % M="
                    f"{ctx.limb_shards} != 0 — padded limbs must stay "
                    f"ledger-only, never device-placed"))
    if ctx.mesh is not None:
        shape = mesh_axes(ctx.mesh)
        if "data" in shape and shape["data"] != ctx.shards:
            out.append(("mesh.data",
                        f"mesh data axis has {shape['data']} devices, "
                        f"context declares shards={ctx.shards}"))
        if "model" in shape and shape["model"] != ctx.limb_shards:
            out.append(("mesh.model",
                        f"mesh model axis has {shape['model']} devices, "
                        f"context declares limb_shards={ctx.limb_shards}"))
    return out


@contextlib.contextmanager
def activate(bk, ctx: ShardContext | None):
    """Install ctx as bk.shard_ctx for the duration.  Reentrant: if the
    same context is already active this is a no-op, so nested scopes
    (executor -> evaluator flush) do not double-install."""
    prev = getattr(bk, "shard_ctx", None)
    if ctx is None or prev is ctx:
        yield prev
        return
    bk.shard_ctx = ctx
    try:
        yield ctx
    finally:
        bk.shard_ctx = prev


def batch_sharding(mesh) -> tuple:
    """Placement of a (nblocks, 2, k, n) batch, one entry per dimension:
    block lanes on "data", RNS limbs on "model" when the mesh carries
    that axis."""
    return ("data", None, "model" if "model" in mesh_axes(mesh) else None, None)


def stack_lanes(rows: list, lo: int, hi: int) -> torch.Tensor:
    """Lanes [lo, hi) of the batch whose lanes are `rows` ((2, k, n)
    tensors) followed by zero pads, stacked: only these lanes, pads
    included, are ever materialised."""
    own = rows[lo:hi]
    return torch.stack(own + [torch.zeros_like(rows[0])] * (hi - lo - len(own)))


def place_batch(rows: list, nphys: int, mesh
                ) -> tuple[torch.Tensor, LaneShard | None, LimbShard | None]:
    """This rank's part of the (nphys, 2, k, n) batch whose lanes are
    `rows` then zero pads, placed on the query mesh as
    `batch_sharding(mesh)` says: lanes over "data", limbs over "model".
    Only that part is ever materialised.  Raises when a dimension does
    not split evenly over its axis, or when the rows lie on another
    device type than the mesh.  Returns (data, lanes, limbs): a
    `LaneShard` with this rank's `nphys / D` lanes, or None and every
    lane where the rank keeps them all (outside the mesh, or a "data"
    axis of one rank); a `LimbShard` with its `k / M` limbs, or None and
    every limb (outside the mesh, or no "model" axis of more ranks)."""
    sizes = mesh_axes(mesh)
    shape = (nphys, *rows[0].shape)
    for dim, axis in zip(shape, batch_sharding(mesh)):
        if axis is not None and dim % sizes[axis]:
            raise ValueError(f"batch {shape} does not split over "
                             f"the {axis!r} axis of {sizes[axis]} (pad first)")
    if rows[0].device.type != mesh.device_type:
        raise ValueError(f"batch on {rows[0].device} but the mesh on "
                         f"{mesh.device_type}")
    k = shape[2]
    held = model_limbs(mesh, k)
    limbs = None
    if held is not None:
        rows = [r[:, held[0]:held[1]] for r in rows]
        limbs = LimbShard(*held, k, mesh)
    D = sizes.get("data", 1)
    if D == 1 or mesh.get_coordinate() is None:
        return stack_lanes(rows, 0, nphys), None, limbs
    per = nphys // D
    lo = axis_index(mesh, "data") * per
    return stack_lanes(rows, lo, lo + per), LaneShard(lo, lo + per, nphys, mesh), limbs


def place_key(key: KSwitchKey, mesh) -> KSwitchKey:
    """A key switch key as this rank holds it on `mesh`: its output-limb
    slice [:, lo:hi] (a copy, so the whole can be freed), as the
    reference's key switch reads it (`P(None, "model", None)`, the scan
    step's `shard_inputs` too); the key as it is where the rank holds
    every limb.  A key placed with other limbs raises."""
    held = model_limbs(mesh, key.b.shape[0])
    if key.limbs is not None:
        if held is None or tuple(key.limbs) != held:
            raise ValueError(f"a key held by output limbs {tuple(key.limbs)} cannot be placed "
                             f"at limbs {held} of this mesh")
        return key
    if held is None:
        return key
    lo, hi = held
    return KSwitchKey(b=key.b[:, lo:hi].contiguous(), a=key.a[:, lo:hi].contiguous(),
                      limbs=held)


def place_keys(keys: Keys, mesh) -> Keys:
    """`keys` with `rlk` and every Galois key placed by `place_key`; the
    secret and public keys stay whole."""
    return dataclasses.replace(keys, rlk=place_key(keys.rlk, mesh),
                               gks={g: place_key(key, mesh) for g, key in keys.gks.items()})


def sharded_fold(data, live: int, mesh, lanes: LaneShard | None = None,
                 limbs: LimbShard | None = None):
    """Fold a padded batch over the "data" axis: this rank's lanes,
    weighted by 0/1 so that the pads (global lanes >= `live`) drop out,
    summed, then all-reduced over "data".  `data` is this rank's lanes of
    a batch held sharded when `lanes` is given, else the whole
    (nphys, 2, ., n) batch, of which each rank sums its own lanes (a rank
    outside the mesh sums every lane itself); the sums are limb-local, so
    a batch held over "model" (`limbs`) sums its own limbs, and the
    folded singleton's limbs are then all-gathered over "model".
    Returns the raw (2, k, n) sum — the caller reduces mod q (residues
    are < 2^30, so even ~190 int64 partial sums cannot overflow before
    the reduction)."""
    outside = mesh.get_coordinate() is None
    if lanes is not None:
        lo = lanes.lo
    elif outside:
        lo = 0
    else:
        per = data.shape[0] // mesh_axes(mesh).get("data", 1)
        lo = axis_index(mesh, "data") * per
        data = data[lo:lo + per]
    weights = (torch.arange(lo, lo + data.shape[0], device=data.device) < live).to(data.dtype)
    local = (data * weights[:, None, None, None]).sum(0)
    if outside:
        return local
    total = sum_axis(local, mesh, "data")
    return total if limbs is None else gather_axis(total, limbs.mesh, "model", dim=-2)
