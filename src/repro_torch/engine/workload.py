"""Persistent noise-aware mask cache + cross-query workload scheduling.

The CSE store of engine/physical.py used to be a bare dict on one
Planner: it died with the query mix and — the bug this module fixes —
served cached mask blocks with *no noise-level check*.  Mask blocks are
live ciphertext handles: a planned refresh inside one consumer mutates
them in place (engine/backend.py `_maybe_refresh`/`ensure_levels`), so a
cached entry's remaining noise budget drifts away from what a fresh
derivation would carry.  A later plan admitting that entry then executes
a noise trajectory its PlanReport never priced: refreshes the model
never predicted, or measured depth far below the Table-3 prediction —
either way `ExecReport.validate` trips.

`WorkloadCache` makes admission noise-aware (§4.3.2's i* rule applied at
the cache boundary): every entry records the levels its blocks carried
at birth, and a hit is served only after comparing the blocks' *current*
levels against the consumer's downstream multiplication count:

  serve               levels >= min(need, born_levels): the entry is at
                      least as good as re-deriving it, so the consumer's
                      noise model holds by construction.
  refresh-then-serve  degraded below the cold-equivalence bar: one
                      planned refresh at admission (charged to OpStats,
                      counted in `admit_refreshes`, reported separately
                      by ExecReport so it is never an *unpredicted*
                      refresh).
  re-derive           policy='rederive': drop the entry and re-run the
                      circuit inside the next fused launch instead.

The cache is keyed on `CmpAtom.key = (table, column, circuit, const,
flip, rhs)` and persists across planners and queries — the encrypted
analogue of PartitionCache's partition-key condition store: one cached
EQ/LT mask serves a whole dashboard's query mix.  `fk_lookup/fk_store`
additionally cache the per-parent-key join EQ banks of
`ops.translate_mask_down`, so repeated FK translations stop re-running
nparent EQ circuits.  Invalidation is wired to `Database.load_table`
through `bind()`: re-loading a table drops every entry derived from it.

`run_workload(planner, plans)` is the scheduler on top: it compiles a
*batch* of QueryPlans through one physical pass — every distinct
comparison circuit of every query in the batch is requested up front and
evaluated in ONE stacked launch per circuit shape (Q1+Q6+Q12+Q19's EQs
together, their LTs together) — then executes each plan against the warm
evaluator.  See DESIGN.md §8 for the keying/admission/invalidation
contract.
"""
from __future__ import annotations

import dataclasses

from ..runtime import faults


@dataclasses.dataclass
class CacheStats:
    """Hit/miss/refresh accounting for one WorkloadCache."""

    hits: int = 0                 # served entries born in an earlier run
    intra_hits: int = 0           # served entries born in the current run
    misses: int = 0               # atom circuits evaluated and inserted
    admit_refreshes: int = 0      # refresh-on-admit events (entries)
    admit_refresh_blocks: int = 0  # blocks refreshed at admission
                                   # (OpStats.refresh units, for netting)
    rederives: int = 0            # degraded entries dropped (policy)
    invalidations: int = 0        # entries dropped by table re-loads
    fk_hits: int = 0              # per-key join EQ bank reuses
    fk_misses: int = 0            # per-key join EQ banks built
    evictions: int = 0            # entries dropped by the LRU bound
    poison_drops: int = 0         # entries failing their content
                                  # fingerprint at serve (dropped or,
                                  # under integrity='fail', fatal)

    def clone(self) -> "CacheStats":
        return dataclasses.replace(self)

    @property
    def hit_rate(self) -> float:
        """Cross-query hit rate: served-from-a-previous-run over all
        cache-resolving lookups (intra-run reuse excluded — that is CSE,
        not workload caching)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def delta(self, start: "CacheStats") -> "CacheStats":
        out = CacheStats()
        for f in dataclasses.fields(CacheStats):
            setattr(out, f.name, getattr(self, f.name) - getattr(start, f.name))
        return out


@dataclasses.dataclass
class CacheEntry:
    blocks: list                  # live ciphertext handles (mutable noise)
    table: str
    born_levels: int              # min levels_left across blocks at insert
    born_run: int                 # begin_run() epoch that derived it
    fp: list | None = None        # content fingerprints at insert (None
                                  # when the backend's handles are opaque
                                  # — real BFV — or integrity is off)


class WorkloadCache:
    """Persistent encrypted-mask store with noise-aware admission.

    One instance outlives planners and queries; pass it to
    `Planner(db, cache=...)` to share masks across a workload.  All
    mutation of entry noise happens through the live block handles —
    admission reads `bk.levels_left` at serve time, never a snapshot.
    """

    def __init__(self, policy: str = "refresh", max_entries: int | None = None,
                 integrity: str = "rederive"):
        assert policy in ("refresh", "rederive"), policy
        assert max_entries is None or max_entries > 0, max_entries
        assert integrity in ("off", "rederive", "fail"), integrity
        self.policy = policy
        # At-rest integrity: entries record content fingerprints at
        # insert and re-verify at serve.  'rederive' (default) silently
        # drops a tampered entry and lets the consumer re-run the
        # circuit; 'fail' raises a typed CachePoisonFault; 'off' skips
        # the check.  Opaque backends (real BFV) degrade to 'off'
        # automatically — see _BackendBase.fingerprint.
        self.integrity = integrity
        # LRU bound, applied independently to the atom store and the FK
        # bank store.  None = unbounded (the historical behaviour).  A
        # hit moves its entry to the MRU end; insertion past the bound
        # pops the LRU end and counts it in `stats.evictions`.
        self.max_entries = max_entries
        self.entries: dict[tuple, CacheEntry] = {}
        self.fk_banks: dict[tuple, CacheEntry] = {}
        self.stats = CacheStats()
        self._run = 0
        self._budget: dict[int, int] = {}      # id(bk) -> budget levels

    # ------------------------------------------------------------- wiring
    def bind(self, db) -> None:
        """Subscribe to `Database.load_table` so re-loading a table drops
        every mask derived from its (now replaced) ciphertexts."""
        db.add_reload_hook(self._on_table_load)

    def _on_table_load(self, table: str) -> None:
        self.invalidate_table(table)

    def invalidate_table(self, table: str) -> None:
        dead = [k for k, e in self.entries.items() if e.table == table]
        for k in dead:
            del self.entries[k]
        dead_banks = [k for k, e in self.fk_banks.items() if e.table == table]
        for k in dead_banks:
            del self.fk_banks[k]
        self.stats.invalidations += len(dead) + len(dead_banks)

    def clear(self) -> None:
        self.stats.invalidations += len(self.entries) + len(self.fk_banks)
        self.entries.clear()
        self.fk_banks.clear()

    def __len__(self) -> int:
        return len(self.entries)

    # --------------------------------------------------------------- runs
    def begin_run(self) -> int:
        """Open a new derivation epoch: entries inserted from now on are
        'this run's' — serving them again within the run is CSE
        (intra_hits), serving them from a later run is a workload hit."""
        self._run += 1
        return self._run

    # ------------------------------------------------------------ budget
    def _budget_levels(self, bk) -> int:
        key = id(bk)
        if key not in self._budget:
            from .planner import noise_budget_levels
            self._budget[key] = noise_budget_levels(bk)
        return self._budget[key]

    # -------------------------------------------------------------- atoms
    def contains(self, key: tuple) -> bool:
        return key in self.entries

    def usable(self, bk, atom, need_levels: int) -> bool:
        """Whether a request for `atom` can be satisfied without running
        its circuit (under the current admission policy)."""
        e = self.entries.get(atom.key)
        if e is None:
            return False
        if self.policy != "rederive":
            return True                        # refresh-on-admit always serves
        have = min(bk.levels_left(b) for b in e.blocks)
        return have >= min(need_levels, e.born_levels)

    def _touch(self, store: dict, key) -> None:
        """Move `key` to the MRU end of the insertion-ordered store."""
        store[key] = store.pop(key)

    def _evict(self, store: dict) -> None:
        if self.max_entries is None:
            return
        while len(store) > self.max_entries:
            store.pop(next(iter(store)))       # LRU = oldest-ordered key
            self.stats.evictions += 1

    # ---------------------------------------------------------- integrity
    def _fps(self, bk, flat_blocks):
        if self.integrity == "off":
            return None
        return faults.fingerprint_blocks(bk, flat_blocks)

    def _intact(self, bk, key, entry, flat_blocks, store: dict) -> bool:
        """Re-verify an entry's content fingerprints at serve time.  A
        mismatch means the ciphertext payload changed outside the
        legitimate mutation channel (refresh touches only noise) — the
        cache-poison fault class.  The entry is dropped either way;
        integrity='fail' escalates to a typed fault."""
        if entry.fp is None:
            return True
        now = faults.fingerprint_blocks(bk, flat_blocks)
        if now == entry.fp:
            return True
        del store[key]
        self.stats.poison_drops += 1
        if self.integrity == "fail":
            raise faults.CachePoisonFault(
                f"cache entry {key} failed its content fingerprint "
                f"({len([a for a, b in zip(entry.fp, now) if a != b])} of "
                f"{len(entry.fp)} blocks tampered)",
                stage="cache-serve", detail={"key": list(map(str, key))})
        return False

    def insert(self, bk, atom, blocks: list) -> None:
        self.entries[atom.key] = CacheEntry(
            blocks, atom.table,
            min(bk.levels_left(b) for b in blocks), self._run,
            self._fps(bk, blocks))
        self.stats.misses += 1
        self._evict(self.entries)

    def serve(self, bk, atom, need_levels: int):
        """Noise-aware admission (the fix for the noise-unaware CSE hit).

        `need_levels` is the consumer's downstream multiplication count —
        the same quantity the i* rule sizes planned refreshes with.  The
        cold-equivalence bar is min(need, born_levels): a fresh
        derivation could not do better than born_levels either, so a plan
        whose model already prices a mid-chain refresh keeps paying it
        identically.  Returns the block list, or None on miss/re-derive.
        """
        e = self.entries.get(atom.key)
        if e is None:
            return None
        if not self._intact(bk, atom.key, e, e.blocks, self.entries):
            return None                      # poisoned: force re-derive
        have = min(bk.levels_left(b) for b in e.blocks)
        required = min(need_levels, e.born_levels)
        if have < required:
            if self.policy == "rederive":
                del self.entries[atom.key]
                self.stats.rederives += 1
                return None
            want = min(need_levels, self._budget_levels(bk))
            for b in e.blocks:
                if bk.levels_left(b) < want:
                    bk.ensure_levels(b, want)
                    self.stats.admit_refresh_blocks += 1
            self.stats.admit_refreshes += 1
        if e.born_run < self._run:
            self.stats.hits += 1
        else:
            self.stats.intra_hits += 1
        self._touch(self.entries, atom.key)
        return e.blocks

    # ----------------------------------------------- per-key join EQ banks
    def fk_lookup(self, bk, table: str, fk: str, nparent: int):
        """Cached `_per_key_eq` bank for (child table, fk, nparent).
        Each per-key mask absorbs exactly one ct-ct multiply before the
        translate accumulation, so admission needs one level."""
        e = self.fk_banks.get((table, fk, nparent))
        if e is None:
            return None
        flat = [b for masks in e.blocks for b in masks]
        if not self._intact(bk, (table, fk, nparent), e, flat, self.fk_banks):
            return None                      # poisoned: rebuild the bank
        if any(bk.levels_left(b) < 1 for masks in e.blocks for b in masks):
            del self.fk_banks[(table, fk, nparent)]   # degraded: rebuild
            self.stats.rederives += 1
            return None
        self.stats.fk_hits += 1
        self._touch(self.fk_banks, (table, fk, nparent))
        return e.blocks

    def fk_store(self, bk, table: str, fk: str, nparent: int, bank: list) -> None:
        flat = [b for masks in bank for b in masks]
        self.fk_banks[(table, fk, nparent)] = CacheEntry(
            bank, table, min(bk.levels_left(b) for b in flat), self._run,
            self._fps(bk, flat))
        self.stats.fk_misses += 1
        self._evict(self.fk_banks)


# ---------------------------------------------------------------------------
# Cross-query fused scheduling.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkloadReport:
    """One `run_workload` pass: per-query results/reports + the cache and
    op-stat deltas attributable to the batch."""

    results: list
    reports: list
    cache: CacheStats             # delta over this pass
    launches: int
    muls: int
    refreshes: int

    @property
    def hit_rate(self) -> float:
        return self.cache.hit_rate


def run_workload(planner, plans, validate: bool = True,
                 verify: bool | None = None) -> WorkloadReport:
    """Compile a batch of QueryPlans through ONE physical pass.

    Optimized regime: all plans' mask trees are lowered and their atoms
    requested against a single shared AtomEvaluator before anything runs,
    so same-shape comparison circuits fuse *between* queries into one
    stacked launch (the cross-query generalization of per-query fusion).
    Atoms already in the planner's WorkloadCache are admitted noise-aware
    and never re-run.  Each plan then executes against the warm evaluator
    and validates its ExecReport as usual.

    Unoptimized planners (or fuse_masks=False) fall back to sequential
    per-plan execution — the classical no-sharing baseline.

    `verify` overrides the planner's static-verification knob for this
    batch only (None keeps the planner default); each plan is verified
    against the warm cache state right before it executes.
    """
    from .executor import Executor
    bk = planner.bk
    cache = planner.mask_cache
    cs0 = cache.stats.clone()
    s0 = bk.stats.clone()
    results, reports = [], []
    prev_verify = getattr(planner, "verify_plans", True)
    if verify is not None:
        planner.verify_plans = verify
    try:
        if planner.optimized and planner.fuse_masks:
            ev = planner.evaluator()
            cache.begin_run()                 # batch derivation epoch
            compiled = []
            for plan in plans:
                ex = Executor(planner, evaluator=ev)
                cq = ex.compile(plan)
                ex.request_atoms(cq, ev)
                compiled.append((ex, cq))
            ev.flush()                        # one stacked launch per shape
            for ex, cq in compiled:
                results.append(ex.run_compiled(cq, validate=validate))
                reports.append(ex.report)
        else:
            for plan in plans:
                ex = Executor(planner)
                results.append(ex.run(plan, validate=validate))
                reports.append(ex.report)
    finally:
        planner.verify_plans = prev_verify
    s1 = bk.stats
    return WorkloadReport(
        results=results, reports=reports,
        cache=cache.stats.delta(cs0),
        launches=s1.launches - s0.launches,
        muls=s1.mul - s0.mul,
        refreshes=s1.refresh - s0.refresh)
