"""Static plan verification (DESIGN.md §10): prove a compiled QueryPlan
sound *before* any ciphertext is touched.

Three cooperating analyses over the physical IR of a `CompiledQuery`:

  noise abstract interpretation
      Re-executes the compiled DAG against an `AbstractBackend` whose
      values carry only (noise bound, depth, lane metadata) — the exact
      transfer functions of core/noise.py, the exact refresh policy of
      engine/backend.py, the exact cache-admission rule of
      engine/workload.py — but no payload.  Every decrypt boundary must
      end with positive invariant-noise headroom; every planned refresh
      is checked for sufficiency (exhaustion downstream of it is an
      error) and non-redundancy (a second, suppressed trajectory `nr`
      tracks what the noise *would* have been without the planned
      refresh — a refresh whose every observing decrypt clears the
      budget on the suppressed trajectory too is flagged dead).

  IR type / level checking
      Block shapes at lift time ((slots,) mock vectors, (2, k, n) RNS
      ciphertexts), and the scheduler's downstream-product annotations
      re-derived from the plan structure: a `downstream_muls` that does
      not match `annotate_downstream`'s recurrence means a planned
      refresh somewhere is sized from a tampered or stale level count —
      the statically visible form of "someone dropped a refresh".

  cache-aliasing + mesh-placement linting
      No in-place refresh may rejuvenate a cache entry that more than
      one consumer of this plan already holds (the noise-unaware CSE
      bug class): entry blocks are tagged at insert/clone and every
      refresh event records how often its entry had been served.  Shard
      contexts are linted against the backend geometry (limb count,
      ring size, the k % M padding rule, data/model mesh axis extents)
      and the abstract run's collective counts are reconciled with the
      shadow ledger.

Verification is *pure*: it never touches the planner's backend, tables
or cache — everything is lifted into abstract shadows first.  The real
`OpStats` is untouched and no fault trigger is consumed (the abstract
backend deliberately never calls runtime/faults.py).

Entry points: `verify_plan(planner, plan)` / `verify_compiled(planner,
cq)`, `Planner.verify(plan)`, the executor's pre-run hook (opt out with
`Planner(..., verify=False)` or `run_via_plan(..., verify=False)`), and
`python -m repro_torch.engine.verify` over every registered TPC-H
builder.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..runtime import tracing
from .backend import _BackendBase
from .storage import EncryptedColumn, EncryptedTable
from .workload import CacheEntry, WorkloadCache


class PlanVerificationError(RuntimeError):
    """A compiled plan failed static verification (error-severity)."""


@dataclasses.dataclass
class Finding:
    severity: str        # 'error' | 'warning'
    code: str            # machine-readable rule id, e.g. 'noise.exhausted'
    where: str           # IR-node / stage provenance
    detail: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.code} @ {self.where}: {self.detail}"


@dataclasses.dataclass
class VerifyReport:
    """Structured result of one static verification pass."""

    name: str
    optimized: bool
    findings: list = dataclasses.field(default_factory=list)
    # Abstract decrypt boundaries, in execution order: each records the
    # static headroom (bits), the suppressed-refresh headroom, and the
    # planned-refresh sites whose effect reaches this decrypt.
    decrypts: list = dataclasses.field(default_factory=list)
    refresh_events: list = dataclasses.field(default_factory=list)
    predicted_depth: int = 0
    measured_depth: int = 0
    predicted_refreshes: int = 0
    budget_levels: int = 0
    skipped: bool = False      # plan not lowered (correlated / missing IR)

    @property
    def errors(self) -> list:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def add(self, severity: str, code: str, where: str, detail: str) -> None:
        self.findings.append(Finding(severity, code, where, detail))

    def raise_on_error(self) -> None:
        if self.errors:
            raise PlanVerificationError(
                f"{self.name}: static verification failed\n"
                + "\n".join(f"  {f}" for f in self.errors))

    def crosscheck(self, exec_report, eps: float = 1e-6) -> None:
        """Soundness obligation against a fault-free execution: the
        static headroom at every decrypt boundary must be no larger
        than the runtime-observed headroom (static noise bounds may
        only over-approximate), with identical boundary count/order."""
        obs = exec_report.decrypt_headrooms
        assert len(obs) == len(self.decrypts), (
            f"{self.name}: verifier saw {len(self.decrypts)} decrypt "
            f"boundaries, execution saw {len(obs)}")
        for i, (d, o) in enumerate(zip(self.decrypts, obs)):
            assert d["headroom"] <= o + eps, (
                f"{self.name}: decrypt #{i} static headroom "
                f"{d['headroom']:.3f} bits exceeds observed {o:.3f} — "
                f"the abstract model under-approximated noise")

    def summary(self) -> str:
        regime = "optimized" if self.optimized else "unoptimized"
        if self.skipped:
            why = "; ".join(f.code for f in self.findings) or "not lowered"
            return f"{self.name:<4} [{regime:<11}] SKIP ({why})"
        status = "ok" if self.ok else "FAIL"
        worst = min((d["headroom"] for d in self.decrypts), default=float("inf"))
        return (f"{self.name:<4} [{regime:<11}] {status}: depth "
                f"{self.measured_depth}/{self.predicted_depth} "
                f"(budget {self.budget_levels}), refreshes "
                f"{len([e for e in self.refresh_events if not e['admission']])}"
                f"/{self.predicted_refreshes} predicted, "
                f"{len(self.decrypts)} decrypts (min headroom "
                f"{worst:.1f} bits), {len(self.errors)} errors, "
                f"{len(self.warnings)} warnings")


# ---------------------------------------------------------------------------
# The abstract domain.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AbstractCipher:
    """A ciphertext with the payload erased: noise bound + lane metadata.

    `nr` is the counterfactual noise trajectory with planned refreshes
    suppressed (auto refreshes still apply — they would fire either
    way); comparing decrypt headroom on both trajectories is what
    separates a load-bearing planned refresh from a dead one.  `sites`
    carries the ids of the planned-refresh events whose effect reaches
    this value."""

    noise: "float | np.ndarray"
    nr: "float | np.ndarray"
    depth: int = 0
    nb: int = 1                  # logical (live) block lanes
    nphys: int = 1               # physical lanes incl. shard padding
    batch: bool = False
    sites: frozenset = frozenset()
    entry_key: "tuple | None" = None   # workload-cache entry this block IS


def _copy_noise(v):
    return float(v) if np.ndim(v) == 0 else np.asarray(v, dtype=np.float64).copy()


def _pack(noises: list) -> "float | np.ndarray":
    vals = [float(v) for v in noises]
    if all(v == vals[0] for v in vals):
        return vals[0]
    return np.asarray(vals, dtype=np.float64)


class AbstractBackend(_BackendBase):
    """MockBackend's noise/depth/charge semantics with no data.

    The whole operator surface (engine/ops.py, core/compare.py, the
    physical evaluator) runs unmodified against this class — every
    payload access in the engine lives inside backend methods, so the
    duck type holds.  Differences from the executing backends are
    deliberate and limited to: no payload math, no fault hooks (a
    verification pass must never consume a scheduled fault trigger),
    and event recording (refresh + decrypt boundaries)."""

    def __init__(self, bk):
        super().__init__()
        self.t = bk.t
        self.slots = bk.slots
        self.model = bk.model
        self.limbs = getattr(bk, "limbs", None)
        self.refresh_events: list = []
        self.decrypts: list = []
        self._stage = "compile"
        self._admission_key = None      # set by _VerifyCache.serve
        self._pending_refresh = None
        self._cache = None              # the _VerifyCache, for serve counts
        self._folds = 0
        self._gather_calls = 0

    # -- lane metadata ----------------------------------------------------
    def _nblocks(self, ct) -> int:
        return ct.nb if ct.batch else 1

    def _nblocks_phys(self, ct) -> int:
        return ct.nphys if ct.batch else 1

    def _meta(self, *cts):
        for c in cts:
            if c.batch:
                return c.nb, c.nphys, True
        return 1, 1, False

    @staticmethod
    def _sites(*cts) -> frozenset:
        out = frozenset()
        for c in cts:
            out |= c.sites
        return out

    def _mk(self, noise, nr, depth, *srcs) -> AbstractCipher:
        nb, nphys, batch = self._meta(*srcs)
        return AbstractCipher(noise, nr, depth, nb, nphys, batch,
                              self._sites(*srcs))

    def _entry_serves(self, key) -> int:
        if key is None or self._cache is None:
            return 0
        return self._cache.serve_log.get(key, 0)

    # -- refresh event recording ------------------------------------------
    def _charge_refresh(self, ct, lanes, what: str) -> None:
        super()._charge_refresh(ct, lanes, what)
        ev = {
            "id": len(self.refresh_events),
            "kind": "planned" if what.startswith("planned") else "auto",
            "what": what,
            "stage": self._stage,
            "lanes": list(lanes) if lanes is not None else None,
            "blocks": self._nblocks(ct) if lanes is None else len(lanes),
            "entry_key": ct.entry_key,
            # Inside a cache serve: the admission refresh the runtime's
            # validate() nets out of the plan-model invariants.
            "admission": self._admission_key is not None,
            "prior_serves": self._entry_serves(ct.entry_key),
        }
        self.refresh_events.append(ev)
        self._pending_refresh = ev

    def refresh_inplace(self, ct: AbstractCipher, lanes=None) -> None:
        ev, self._pending_refresh = self._pending_refresh, None
        planned = ev is not None and ev["kind"] == "planned"
        fresh = self.model.fresh()
        if lanes is not None and np.ndim(ct.noise):
            per = np.asarray(ct.noise, dtype=np.float64).copy()
            per[lanes] = fresh
            ct.noise = _pack(list(per))
            if planned:
                ct.sites = ct.sites | {ev["id"]}
            else:
                nr = (np.asarray(ct.nr, dtype=np.float64).copy()
                      if np.ndim(ct.nr)
                      else np.full(len(per), float(ct.nr)))
                nr[lanes] = fresh
                ct.nr = _pack(list(nr))
            return   # depth unchanged: un-refreshed lanes keep history
        ct.noise = fresh
        ct.depth = 0
        if planned:
            ct.sites = ct.sites | {ev["id"]}
        else:
            ct.nr = fresh

    def refresh(self, ct: AbstractCipher) -> AbstractCipher:
        fresh = self.model.fresh()
        return AbstractCipher(fresh, fresh, 0, ct.nb, ct.nphys, ct.batch,
                              ct.sites)

    def _charge_gather(self, *cts, mult: int = 1) -> None:
        ctx = self.shard_ctx
        if ctx is not None and getattr(ctx, "limb_shards", 1) > 1 and mult > 0:
            self._gather_calls += 1
        super()._charge_gather(*cts, mult=mult)

    # -- io ----------------------------------------------------------------
    def encrypt(self, vec) -> AbstractCipher:
        self.stats.encrypt += 1
        fresh = self.model.fresh()
        return AbstractCipher(fresh, fresh, 0)

    def decrypt(self, ct: AbstractCipher) -> np.ndarray:
        self.stats.decrypt += self._nblocks(ct)
        self.decrypts.append({
            "stage": self._stage,
            "headroom": float(np.min(self.model.budget(ct.noise))),
            "headroom_nr": float(np.min(self.model.budget(ct.nr))),
            "sites": set(ct.sites),
            "depth": ct.depth,
        })
        if ct.batch:
            return np.zeros((self._nblocks(ct), self.slots), dtype=np.int64)
        return np.zeros(self.slots, dtype=np.int64)

    def budget(self, ct: AbstractCipher) -> float:
        return self.model.min_budget(ct.noise)

    def depth(self, ct: AbstractCipher) -> int:
        return ct.depth

    # -- block batching ---------------------------------------------------
    def stack_blocks(self, blocks: list) -> AbstractCipher:
        assert all(not b.batch for b in blocks)
        nb = nphys = len(blocks)
        ctx = self.shard_ctx
        if ctx is not None and ctx.shards > 1 and nb > 1:
            from .sharded import pad_to
            nphys = pad_to(nb, ctx.shards)
        return AbstractCipher(_pack([b.noise for b in blocks]),
                              _pack([b.nr for b in blocks]),
                              max(b.depth for b in blocks), nb, nphys, True,
                              self._sites(*blocks))

    def unstack_blocks(self, batch: AbstractCipher) -> list:
        per_n = np.asarray(batch.noise) if np.ndim(batch.noise) else None
        per_r = np.asarray(batch.nr) if np.ndim(batch.nr) else None
        return [AbstractCipher(
                    float(per_n[i]) if per_n is not None else batch.noise,
                    float(per_r[i]) if per_r is not None else batch.nr,
                    batch.depth, sites=batch.sites)
                for i in range(self._nblocks(batch))]

    def fold_blocks(self, batch: AbstractCipher) -> AbstractCipher:
        # NB: the executing backends probe faults.maybe_device_loss here;
        # the abstract fold must not, or verification would consume the
        # chaos schedule meant for the real run.
        nb = self._nblocks(batch)
        self.stats.add += max(nb - 1, 0)
        self.stats.launches += 1
        if self.shard_ctx is not None:
            self.shard_ctx.record_fold(nb, self._nblocks_phys(batch))
        self._folds += 1
        per_n = batch.noise if np.ndim(batch.noise) else None
        per_r = batch.nr if np.ndim(batch.nr) else None
        noise = float(per_n[0]) if per_n is not None else batch.noise
        nr = float(per_r[0]) if per_r is not None else batch.nr
        for i in range(1, nb):
            noise = self.model.add(
                noise, float(per_n[i]) if per_n is not None else batch.noise)
            nr = self.model.add(
                nr, float(per_r[i]) if per_r is not None else batch.nr)
        return AbstractCipher(noise, nr, self._track_depth(batch.depth),
                              sites=batch.sites)

    # -- ring ops ----------------------------------------------------------
    def add(self, a, b):
        self._charge("add", a, b)
        return self._mk(self.model.add(a.noise, b.noise),
                        self.model.add(a.nr, b.nr),
                        self._track_depth(max(a.depth, b.depth)), a, b)

    def sub(self, a, b):
        self._charge("add", a, b)
        return self._mk(self.model.add(a.noise, b.noise),
                        self.model.add(a.nr, b.nr),
                        self._track_depth(max(a.depth, b.depth)), a, b)

    def neg(self, a):
        return self._mk(a.noise, a.nr, a.depth, a)

    def mul(self, a, b):
        post = self.model.keyswitch(self.model.mul(a.noise, b.noise))
        if np.any(np.asarray(self._budget(post)) <= 0):
            a = self._maybe_refresh(a, post, "mul")
            b = self._maybe_refresh(
                b, self.model.keyswitch(self.model.mul(a.noise, b.noise)),
                "mul")
        self._charge("mul", a, b)
        self._charge_gather(a, b)
        return self._mk(
            self.model.keyswitch(self.model.mul(a.noise, b.noise)),
            self.model.keyswitch(self.model.mul(a.nr, b.nr)),
            self._track_depth(max(a.depth, b.depth) + 1), a, b)

    def mul_plain(self, a, vec):
        a = self._maybe_refresh(a, self.model.mul_plain(a.noise), "mul_plain")
        self._charge("mul_plain", a)
        return self._mk(self.model.mul_plain(a.noise),
                        self.model.mul_plain(a.nr),
                        self._track_depth(a.depth + 1), a)

    def add_plain(self, a, vec):
        self._charge("add", a)
        return self._mk(self.model.add(a.noise, a.noise),
                        self.model.add(a.nr, a.nr), a.depth, a)

    def mul_scalar(self, a, c: int):
        self._charge("mul_scalar", a)
        return self._mk(self.model.mul_scalar(a.noise, c),
                        self.model.mul_scalar(a.nr, c), a.depth, a)

    def add_scalar(self, a, c: int):
        self._charge("add", a)
        return self._mk(self.model.add(a.noise, a.noise),
                        self.model.add(a.nr, a.nr), a.depth, a)

    def sub_from_scalar(self, c: int, a):
        self._charge("add", a)
        return self._mk(self.model.add(a.noise, a.noise),
                        self.model.add(a.nr, a.nr), a.depth, a)

    def dot_plain(self, cts: list, coeffs) -> AbstractCipher:
        cs = np.asarray(coeffs, dtype=np.int64) % self.t
        nz = [i for i in range(len(cts)) if cs[i] != 0]
        assert nz, "all-zero dot"
        used = [cts[i] for i in nz]
        nb = self._count(*used)
        phys = max(self._nblocks_phys(c) for c in used)
        dist = any(self._nblocks_phys(c) > 1 for c in used)
        self._charge_units("mul_scalar", len(nz) * nb, len(nz) * phys, dist)
        self._charge_units("add", max(0, len(nz) - 1) * nb,
                           max(0, len(nz) - 1) * phys, dist)
        noise = self.model.add_many(
            [self.model.mul_scalar(cts[i].noise, int(cs[i])) for i in nz])
        nr = self.model.add_many(
            [self.model.mul_scalar(cts[i].nr, int(cs[i])) for i in nz])
        depth = max(cts[i].depth for i in nz)
        return self._mk(noise, nr, self._track_depth(depth), *used)

    # -- data movement -----------------------------------------------------
    def rotate(self, a, step: int):
        hops = bin(step % (self.slots // 2)).count("1")
        self._charge("rotate", a, mult=hops)
        self._charge_gather(a, mult=hops)
        return self._mk(self.model.rotate(a.noise), self.model.rotate(a.nr),
                        a.depth, a)

    def swap_rows(self, a):
        self._charge("rotate", a)
        self._charge_gather(a)
        return self._mk(self.model.rotate(a.noise), self.model.rotate(a.nr),
                        a.depth, a)


# ---------------------------------------------------------------------------
# Shadow state: cache clone, lifted tables, shadow planner.
# ---------------------------------------------------------------------------

class _VerifyCache(WorkloadCache):
    """The workload cache over abstract entries, instrumented with
    per-entry serve counts (alias detection) and an admission scope on
    the backend so serve-time refreshes are distinguishable from
    translate-time planned refreshes.  Integrity is off: abstract
    handles carry no payload to fingerprint."""

    def __init__(self):
        super().__init__(policy="refresh", integrity="off")
        self.serve_log: dict = {}

    def serve(self, bk, atom, need_levels: int):
        bk._admission_key = atom.key
        try:
            out = super().serve(bk, atom, need_levels)
        finally:
            bk._admission_key = None
        if out is not None:
            self.serve_log[atom.key] = self.serve_log.get(atom.key, 0) + 1
        return out

    def insert(self, bk, atom, blocks: list) -> None:
        super().insert(bk, atom, blocks)
        for b in blocks:
            b.entry_key = atom.key


def _clone_cache(src: WorkloadCache, real_bk, abk) -> _VerifyCache:
    """Abstract shadow of the planner's cache: same keys, born levels
    and epoch, entries lifted to AbstractCipher at their *current* noise
    (an entry rejuvenated by an earlier run's refresh is served at that
    fresher level — exactly what the runtime would do)."""
    dst = _VerifyCache()
    dst.policy = src.policy
    dst.max_entries = src.max_entries
    dst._run = src._run
    for key, e in src.entries.items():
        blocks = [AbstractCipher(_copy_noise(b.noise), _copy_noise(b.noise),
                                 real_bk.depth(b), entry_key=key)
                  for b in e.blocks]
        dst.entries[key] = CacheEntry(blocks, e.table, e.born_levels,
                                      e.born_run, None)
    for key, e in src.fk_banks.items():
        bank = [[AbstractCipher(_copy_noise(b.noise), _copy_noise(b.noise),
                                real_bk.depth(b))
                 for b in masks] for masks in e.blocks]
        dst.fk_banks[key] = CacheEntry(bank, e.table, e.born_levels,
                                       e.born_run, None)
    return dst


class _ShimDB:
    """The minimal Database surface the planner/evaluator/executor touch."""

    def __init__(self, bk, tables: dict):
        self.bk = bk
        self.tables = tables

    def add_reload_hook(self, fn) -> None:
        pass     # shadow tables never reload


def _lift_block(b, real_bk, abk, rep: VerifyReport, where: str) -> AbstractCipher:
    """Lift one stored ciphertext handle, shape-checking it on the way."""
    vec = getattr(b, "vec", None)
    data = getattr(b, "data", None)
    if vec is not None:
        if vec.ndim != 1 or vec.shape[-1] != abk.slots:
            rep.add("error", "ir.shape", where,
                    f"stored mock block has shape {vec.shape}, "
                    f"expected ({abk.slots},)")
    elif data is not None:
        shape = tuple(np.shape(data))
        want = (2, abk.limbs, abk.slots)
        if abk.limbs is not None and shape != want:
            rep.add("error", "ir.shape", where,
                    f"stored ciphertext has shape {shape}, expected {want}")
    return AbstractCipher(_copy_noise(b.noise), _copy_noise(b.noise),
                          real_bk.depth(b))


def _lift_db(db, abk, rep: VerifyReport) -> _ShimDB:
    tables = {}
    for tname, t in db.tables.items():
        cols = {}
        for cname, c in t.columns.items():
            blocks = [_lift_block(b, db.bk, abk, rep, f"{tname}.{cname}[{i}]")
                      for i, b in enumerate(c.blocks)]
            cols[cname] = EncryptedColumn(c.name, c.spec, blocks, c.nrows)
        tables[tname] = EncryptedTable(t.name, t.schema, cols, t.nrows,
                                       t.slots)
    return _ShimDB(abk, tables)


def _shadow_planner(planner, adb, vcache):
    from .planner import Planner
    from .sharded import ShardContext
    spl = Planner(adb, optimized=planner.optimized, cache=vcache,
                  verify=False)
    spl.budget_levels = planner.budget_levels
    spl.fuse_masks = planner.fuse_masks
    spl.share_masks = planner.share_masks
    spl.guards = False
    ctx = getattr(planner, "shard_ctx", None)
    if ctx is not None:
        # Same geometry, fresh ledger, never a real mesh: verification
        # must not place anything on devices.
        spl.shard_ctx = ShardContext(ctx.shards, None,
                                     limb_shards=ctx.limb_shards,
                                     limbs=ctx.limbs, ring_n=ctx.ring_n)
    return spl


# ---------------------------------------------------------------------------
# The abstract driver: the executor's stage skeleton, minus fault hooks.
# ---------------------------------------------------------------------------

def _abstract_run(sx, cq, warm: bool) -> None:
    """Mirror of Executor._execute over the shadow state.  Kept separate
    from the real method because every real stage boundary probes
    faults.maybe_device_loss — a verification pass must not consume the
    chaos schedule armed for the actual execution."""
    from . import ops
    from .physical import run_mask_node

    pl, bk = sx.pl, sx.bk
    plan, fact = cq.plan, cq.fact
    group_cols, per_col_items = cq.group_cols, cq.per_col_items

    if pl.optimized:
        ev = sx.ev
        bk._stage = "atoms[fused]"
        if not warm:
            sx.request_atoms(cq, ev)
            ev.flush()
        bk._stage = "where"
        where = (run_mask_node(cq.where_node, ev, pl)
                 if cq.where_node is not None else None)
        aux = {}
        for name, (a, node) in cq.aux_nodes.items():
            bk._stage = f"aux:{name}"
            aux[name] = sx._translate_aux(a, node, ev, None)
        bk._stage = "gmasks"
        gmasks = {
            col: dict(ev.eq_masks(fact, col, [vid for _n, vid in items],
                                  need_levels=cq.inject_layers))
            for col, items in zip(group_cols, per_col_items)
        } if group_cols else {}
    else:
        bk._stage = "where"
        where = (pl.where_mask(fact, cq.where_expr)
                 if cq.where_expr is not None else None)
        aux = {}
        for name, (a, node) in cq.aux_nodes.items():
            bk._stage = f"aux:{name}"
            fk_ov = (ops.mask_columns(bk, fact.col(a.hop.fk).blocks, where)
                     if where is not None else None)
            aux[name] = sx._translate_aux(a, node, None, fk_ov)
        bk._stage = "gmasks"
        gmasks = {
            col: dict(ops.group_masks(bk, fact, col,
                                      [vid for _n, vid in items]))
            for col, items in zip(group_cols, per_col_items)
        } if group_cols else {}

    bk._stage = "aggregate"
    if group_cols:
        sx._grouped(plan, fact, per_col_items, gmasks, where, aux)
    else:
        sx._ungrouped(plan, fact, where)


# ---------------------------------------------------------------------------
# Rule analyses.
# ---------------------------------------------------------------------------

def _walk_annotations(node, expect: int, rep: VerifyReport, path: str) -> None:
    """Re-derive annotate_downstream's recurrence and flag any node whose
    recorded downstream_muls deviates: planned refreshes are sized from
    these counts, so a stale/tampered annotation is a mis-sized (or
    silently dropped) refresh."""
    if node.downstream_muls != expect:
        rep.add("error", "ir.levels", path,
                f"{node.kind} node on {node.table!r}: downstream_muls="
                f"{node.downstream_muls}, scheduler recurrence expects "
                f"{expect} — planned refreshes at/below this node are "
                f"sized from a stale level count")
    if node.kind in ("and", "or"):
        layers = math.ceil(math.log2(max(len(node.children), 2)))
        for i, c in enumerate(node.children):
            _walk_annotations(c, expect + layers, rep,
                              f"{path}.{node.kind}[{i}]")
    elif node.kind == "not":
        _walk_annotations(node.children[0], expect, rep, f"{path}.not")
    elif node.kind == "translated":
        _walk_annotations(node.children[0], expect + 2, rep,
                          f"{path}.translated({node.hop.fk})")


def _check_annotations(cq, rep: VerifyReport) -> None:
    expect_inject = ((2 if cq.group_cols else 1)
                     + max((a.mul_depth() for a in cq.plan.aggs), default=0))
    if cq.inject_layers != expect_inject:
        rep.add("error", "ir.levels", "inject",
                f"inject_layers={cq.inject_layers}, plan structure "
                f"requires {expect_inject}")
    if cq.where_node is not None:
        _walk_annotations(cq.where_node, cq.inject_layers, rep, "where")
    for name, (_a, node) in cq.aux_nodes.items():
        _walk_annotations(node, 2, rep, f"aux:{name}")


def _dead_refresh_ids(events: list, decrypts: list) -> list:
    """Planned (non-admission) refresh events whose every observing
    decrypt boundary clears the budget on the suppressed trajectory too
    — the refresh bought nothing.  Exposed pure for unit tests.

    Any auto refresh poisons the counterfactual: autos trigger off the
    *real* trajectory but reset both, so the suppressed trajectory may
    only stay positive because an auto rescued it — removing the
    planned refresh would then shift where the autos fire, and no
    single-trajectory argument proves it redundant.  Analysis is
    skipped (empty result) in that case."""
    if any(e["kind"] == "auto" for e in events):
        return []
    planned = {e["id"] for e in events
               if e["kind"] == "planned" and not e["admission"]}
    seen, needed = set(), set()
    for d in decrypts:
        for sid in d["sites"]:
            seen.add(sid)
            if d["headroom_nr"] <= 0:
                needed.add(sid)
    return sorted((planned & seen) - needed)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def verify_compiled(planner, cq, mirror_begin_run: bool = True,
                    warm: bool = False) -> VerifyReport:
    """Statically verify one CompiledQuery against `planner`'s state.

    `mirror_begin_run` replays the serve-epoch bump `Executor.run` will
    perform right after verification; the warm workload path
    (`run_compiled`) passes False because its epoch already advanced.
    Pure: the planner's backend, tables and cache are never touched.
    A span `verify` while the query records (runtime/tracing.py),
    carrying the number of findings."""
    with tracing.span("verify") as sp:
        rep = _verify_compiled(planner, cq, mirror_begin_run, warm)
        if sp is not None:
            sp.attrs["findings"] = len(rep.findings)
    return rep


def _verify_compiled(planner, cq, mirror_begin_run: bool, warm: bool) -> VerifyReport:
    import dataclasses as _dc

    rep = VerifyReport(cq.plan.name, planner.optimized)
    pr = planner.report(cq.plan)
    rep.predicted_depth = pr.predicted_depth
    rep.predicted_refreshes = pr.predicted_refreshes
    rep.budget_levels = pr.budget_levels

    # --- IR typing: scheduler annotations (pure tree walk) ---------------
    _check_annotations(cq, rep)

    # --- mesh placement lint ---------------------------------------------
    ctx = getattr(planner, "shard_ctx", None)
    if ctx is not None:
        from .sharded import lint_shard_context
        for code, msg in lint_shard_context(
                ctx, limbs=getattr(planner.bk, "limbs", None),
                ring_n=getattr(planner.bk, "slots", 0)):
            rep.add("error", code, "shard_ctx", msg)

    # --- abstract interpretation -----------------------------------------
    from .executor import Executor

    abk = AbstractBackend(planner.bk)
    vcache = _clone_cache(planner.mask_cache, planner.bk, abk)
    abk._cache = vcache
    adb = _lift_db(planner.db, abk, rep)
    spl = _shadow_planner(planner, adb, vcache)
    if mirror_begin_run and planner.optimized and planner.share_masks:
        vcache.begin_run()
    acq = _dc.replace(cq, fact=adb.tables[cq.plan.fact])
    sx = Executor(spl, evaluator=spl.evaluator())
    from .sharded import activate
    try:
        with activate(abk, spl.shard_ctx):
            _abstract_run(sx, acq, warm)
    except Exception as e:    # noqa: BLE001 — any abstract failure is a finding
        rep.add("error", "verify.crash", abk._stage,
                f"abstract interpretation failed: {e!r}")
        return rep

    events, decrypts = abk.refresh_events, abk.decrypts
    rep.refresh_events = events
    rep.decrypts = decrypts
    rep.measured_depth = abk.stats.max_depth

    # --- noise: every decrypt boundary must clear the budget -------------
    for i, d in enumerate(decrypts):
        if d["headroom"] <= 0:
            rep.add("error", "noise.exhausted", d["stage"],
                    f"decrypt #{i}: static invariant-noise headroom "
                    f"{d['headroom']:.2f} bits <= 0 — the result would "
                    f"decrypt to garbage")

    # --- refreshes: the runtime validate() invariants, proven statically -
    non_admission = [e for e in events if not e["admission"]]
    if pr.predicted_refreshes == 0 and non_admission:
        code = "refresh.unplanned" if planner.optimized else "refresh.unpredicted"
        rep.add("error", code, non_admission[0]["stage"],
                f"plan predicts refresh-free execution but the abstract "
                f"run pays {len(non_admission)} refresh(es), first: "
                f"{non_admission[0]['what']}")

    for rid in _dead_refresh_ids(events, decrypts):
        e = events[rid]
        rep.add("warning", "refresh.dead", e["stage"],
                f"planned refresh '{e['what']}' is redundant: every "
                f"decrypt it reaches clears the budget without it")

    # --- cache aliasing (the noise-unaware CSE bug class) -----------------
    for e in events:
        if e["admission"] or e["entry_key"] is None:
            continue
        if e["prior_serves"] >= 2:
            sev = ("error" if planner.optimized
                   and pr.predicted_refreshes == 0 else "warning")
            rep.add(sev, "cache.alias", e["stage"],
                    f"in-place {e['kind']} refresh '{e['what']}' "
                    f"rejuvenates cache entry {e['entry_key']} already "
                    f"served to {e['prior_serves']} consumers — their "
                    f"noise trajectories diverge from the model")

    # --- depth: the plan model's slack bounds ------------------------------
    from .executor import DEPTH_SLACK_OVER, DEPTH_SLACK_UNDER
    if rep.measured_depth > pr.predicted_depth + DEPTH_SLACK_OVER:
        rep.add("error", "depth.over", "plan",
                f"abstract depth {rep.measured_depth} exceeds predicted "
                f"{pr.predicted_depth} (+{DEPTH_SLACK_OVER})")
    if (planner.optimized and vcache.stats.hits == 0
            and pr.predicted_depth > rep.measured_depth + DEPTH_SLACK_UNDER):
        rep.add("error", "depth.under", "plan",
                f"prediction {pr.predicted_depth} overshoots abstract "
                f"depth {rep.measured_depth} (+{DEPTH_SLACK_UNDER})")

    # --- mesh ledger reconciliation ----------------------------------------
    sctx = spl.shard_ctx
    if sctx is not None:
        if sctx.folds != abk._folds:
            rep.add("error", "mesh.ledger", "shard_ctx",
                    f"ledger recorded {sctx.folds} folds, abstract run "
                    f"performed {abk._folds}")
        if sctx.gathers != abk._gather_calls:
            rep.add("error", "mesh.ledger", "shard_ctx",
                    f"ledger recorded {sctx.gathers} key-switch gathers, "
                    f"abstract run charged {abk._gather_calls}")
        if sctx.limb_shards == 1 and sctx.gather_bytes != 0.0:
            rep.add("error", "mesh.ledger", "shard_ctx",
                    f"1-D mesh charged {sctx.gather_bytes} gather bytes — "
                    f"model-axis collectives on a data-only mesh")
    return rep


def verify_plan(planner, plan) -> VerifyReport:
    """Compile + statically verify one QueryPlan.  Plans the physical
    compiler cannot lower yet are reported as skipped (warning), not as
    verification failures."""
    from .executor import Executor

    rep = VerifyReport(plan.name, planner.optimized)
    try:
        cq = Executor(planner).compile(plan)
    except NotImplementedError as e:
        code = "ir.correlated" if plan.correlated else "ir.unsupported"
        rep.add("warning", code, plan.name, str(e))
        rep.skipped = True
        return rep
    except KeyError as e:
        rep.add("warning", "ir.unsupported", plan.name,
                f"plan references IR the compiler cannot lower yet: {e}")
        rep.skipped = True
        return rep
    return verify_compiled(planner, cq)


# ---------------------------------------------------------------------------
# CLI: verify every registered TPC-H plan builder in both regimes.
# ---------------------------------------------------------------------------

def _main(argv=None) -> int:
    import argparse
    import time

    from . import queries, tpch
    from .backend import MockBackend
    from .planner import Planner

    p = argparse.ArgumentParser(
        description="Static verification of all registered TPC-H plans "
                    "(noise abstract interpretation + IR typing + mesh "
                    "lint), both depth regimes, no ciphertext work.")
    p.add_argument("--only", default=None, help="verify a single query")
    p.add_argument("--shards", type=int, default=None,
                   help="lint against an N-way data-sharded context")
    p.add_argument("--limb-shards", type=int, default=None,
                   help="lint against an M-way limb-sharded model axis")
    args = p.parse_args(argv)

    bk = MockBackend()
    db = tpch.load(bk, tpch.Scale.tiny())
    stats0 = bk.stats.clone()
    errors = 0
    for name in sorted(queries.QUERIES):
        if args.only and name != args.only:
            continue
        plan = queries.QUERIES[name][0]()
        for optimized in (True, False):
            pl = Planner(db, optimized=optimized, verify=False)
            if args.shards or args.limb_shards:
                from .sharded import make_shard_context
                pl.shard_ctx = make_shard_context(
                    args.shards or 1, limb_shards=args.limb_shards or 1,
                    limbs=bk.limbs, ring_n=bk.slots,
                    device=getattr(bk, "device", None))
            t0 = time.perf_counter()
            rep = verify_plan(pl, plan)
            dt = time.perf_counter() - t0
            print(f"{rep.summary()}  [{dt * 1000:.0f} ms]")
            for f in rep.findings:
                if not rep.skipped:
                    print(f"    {f}")
            errors += len(rep.errors)
    moved = [f.name for f in dataclasses.fields(stats0)
             if getattr(bk.stats, f.name) != getattr(stats0, f.name)]
    if moved:
        print(f"FATAL: verification touched real ciphertexts: {moved}")
        return 2
    print(f"{'FAIL' if errors else 'ok'}: {errors} error finding(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(_main())
