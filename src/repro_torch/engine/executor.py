"""Compiled-DAG query execution (DESIGN.md §7).

`run_via_plan(planner, plan)` executes a declarative `QueryPlan` end to
end: the logical WHERE/aux/group structure is lowered through
engine/physical.py into atom + combine + translate + aggregate stages,
the scheduler fuses distinct comparison circuits into cross-column
batched launches (optimized regime), reuses mask subgraphs through the
planner's CSE cache, and places planned refreshes for translated masks
with the §4.3.2 i* rule.  The same plan runs in both regimes:

  optimized    R1 atom isolation + fused circuit launches + R2 balanced
               combine trees + R3 late injection at the aggregate.
  unoptimized  the classical pipeline: sequential mask chains, joins
               over already-filtered FK columns, group EQs on masked
               columns — the Fig. 3(a) baseline, unfused.

Every execution produces an `ExecReport` (the recorded op history) that
is checked against the planner's `PlanReport`: measured multiplicative
depth must stay within a small constant of the Table-3 prediction, and
refresh events may only occur when the model predicted bootstraps.  The
legacy `run_qN` bodies in engine/queries.py are kept verbatim as parity
oracles — `run_via_plan` must reproduce their decrypted output exactly.

Fault tolerance (DESIGN.md §9): execution is staged through a
`StageCheckpoint` — materialized mask blocks are recorded at every DAG
stage boundary (atoms / where / aux / gmasks), so a `DeviceLossFault`
resumes from the last completed stage on a re-sharded mesh
(`ShardContext.reshard` via `elastic_scan_plan`) instead of from
scratch.  With guards armed (an injected FaultPlan, or
`Planner(guards=True)`), every decrypt boundary runs the headroom check
of runtime/faults.py plus a plaintext sentinel lane, and a
`NoiseOverflowFault` triggers bounded recovery: refresh the
checkpointed masks and retry, then re-derive from base columns, then
fail typed.  A recovered run never validates against the plan model —
its op history spans partial attempts — but must still decrypt
byte-identical to the fault-free run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools

from ..runtime import faults, tracing
from . import ops
from .physical import (CmpAtom, annotate_downstream, compile_mask,
                       run_mask_node)
from .plan import And, Pred, QueryPlan

# Tolerances between the Table-3 depth model and the executed history:
# the model counts only ct-ct multiplies, while measured depth includes
# plaintext-multiply steps (validity, broadcasts) and BSGS slack.
DEPTH_SLACK_OVER = 3      # measured may exceed predicted by at most this
DEPTH_SLACK_UNDER = 7     # optimized predictions may overshoot by this

# Bounded recovery (DESIGN §9): one refresh-and-retry, one re-derive
# from base columns, then a typed NoiseOverflowFault.
MAX_OVERFLOW_RETRIES = 2
# Device-loss resumes halve the mesh each time; a handful of attempts
# exhausts any realistic shard count before this trips.
MAX_DEVICE_LOSS_RECOVERIES = 4


@dataclasses.dataclass
class ExecReport:
    """Recorded op history of one compiled-DAG execution."""

    name: str
    optimized: bool
    predicted_depth: int
    predicted_refreshes: int
    budget_levels: int
    measured_depth: int = 0
    refreshes: int = 0
    launches: int = 0
    muls: int = 0
    # Workload-cache accounting for this execution: masks served from
    # earlier runs, and refresh charges paid at cache admission (the
    # noise-aware serve of engine/workload.py).  Admission refreshes are
    # *predicted by construction* — the cache priced them against the
    # consumer's downstream_muls — so validate() nets them out of the
    # plan-model refresh invariants instead of calling them unpredicted.
    cache_hits: int = 0
    cache_admit_refreshes: int = 0
    history: list = dataclasses.field(default_factory=list)
    # Observed noise headroom (bits) at every decrypt boundary, in
    # execution order — the runtime half of the static verifier's
    # soundness cross-check (VerifyReport.crosscheck): the abstract
    # bound must never be tighter than what execution observed.
    decrypt_headrooms: list = dataclasses.field(default_factory=list)
    # Recovery events this execution survived (overflow retries, device
    # -loss resumes, straggler exclusions) — see DESIGN §9.  A run that
    # recovered from overflow/device-loss executed partial attempts, so
    # plan-model validation is skipped for it; the typed-or-identical
    # contract is asserted by the chaos suite instead.
    recoveries: list = dataclasses.field(default_factory=list)

    def record(self, label: str, before, after) -> None:
        self.history.append({
            "stage": label,
            "mul": after.mul - before.mul,
            "add": after.add - before.add,
            "rotate": after.rotate - before.rotate,
            "launches": after.launches - before.launches,
            "refresh": after.refresh - before.refresh,
            "max_depth": after.max_depth,
        })

    def op_history_diff(self) -> str:
        """Expected-vs-observed accounting plus the per-stage history
        table — appended to every validate() assertion so a chaos-test
        failure is diagnosable from the message alone."""
        unplanned = self.refreshes - self.cache_admit_refreshes
        lines = [
            f"op-history diff for {self.name} "
            f"(optimized={self.optimized}):",
            f"  depth     predicted={self.predicted_depth} "
            f"measured={self.measured_depth} budget={self.budget_levels} "
            f"slack=+{DEPTH_SLACK_OVER}/-{DEPTH_SLACK_UNDER}",
            f"  refreshes predicted={self.predicted_refreshes} "
            f"observed={self.refreshes} admit={self.cache_admit_refreshes} "
            f"unplanned={unplanned}",
            f"  launches  {self.launches}  muls {self.muls}  "
            f"cache_hits {self.cache_hits}",
            f"  {'stage':<20} {'mul':>6} {'add':>6} {'rot':>6} "
            f"{'launch':>6} {'refr':>5} {'depth':>5}",
        ]
        for h in self.history:
            lines.append(
                f"  {h['stage']:<20} {h['mul']:>6} {h['add']:>6} "
                f"{h['rotate']:>6} {h['launches']:>6} {h['refresh']:>5} "
                f"{h['max_depth']:>5}")
        for r in self.recoveries:
            lines.append(f"  recovery: {r}")
        return "\n".join(lines)

    def validate(self) -> None:
        """Assert the §4.3 noise model against the executed history.

        Cache-served masks may legally be *fresher* than a cold
        derivation (an earlier plan's planned refresh rejuvenated them in
        place), so the undershoot bound only applies to cold executions;
        and refreshes charged at cache admission are planned by the
        cache's own i*-style sizing, so the plan-model refresh invariants
        apply to the net (unplanned) count."""
        if any(r.get("kind") in ("overflow", "device-loss")
               for r in self.recoveries):
            # Partial attempts make the op history incomparable to the
            # single-pass plan model; the recovery contract (identical
            # result or typed fault) is what holds here.
            return
        diff = "\n" + self.op_history_diff()
        assert self.measured_depth <= self.predicted_depth + DEPTH_SLACK_OVER, (
            f"{self.name}: executed depth {self.measured_depth} exceeds "
            f"predicted {self.predicted_depth} (+{DEPTH_SLACK_OVER})" + diff)
        unplanned = self.refreshes - self.cache_admit_refreshes
        if self.optimized:
            if self.cache_hits == 0:
                assert self.predicted_depth <= self.measured_depth + DEPTH_SLACK_UNDER, (
                    f"{self.name}: prediction {self.predicted_depth} overshoots "
                    f"measured {self.measured_depth} (+{DEPTH_SLACK_UNDER})"
                    + diff)
            if self.predicted_refreshes == 0:
                assert unplanned <= 0, (
                    f"{self.name}: plan predicted refresh-free but executor "
                    f"paid {unplanned} unplanned refreshes "
                    f"({self.refreshes} total, {self.cache_admit_refreshes} "
                    f"at cache admission)" + diff)
        if unplanned > 0:
            assert self.predicted_refreshes > 0, (
                f"{self.name}: {unplanned} unplanned refreshes but the model "
                f"predicted none" + diff)


@dataclasses.dataclass
class StageCheckpoint:
    """Materialized-mask checkpoints at DAG stage boundaries.

    Mid-query recovery state: each completed stage stores its payload
    (the structure the aggregate consumes) plus the flat ciphertext
    handles it materialized.  On device loss the executor re-enters
    `_execute` with the same checkpoint — completed stages return their
    payload instead of re-running, so only work after the last boundary
    repeats on the re-sharded mesh.  On noise overflow `refresh_all`
    rejuvenates every checkpointed block in place (the refresh-and-retry
    arm) and `clear` drops everything (the re-derive-from-base arm).
    """

    done: dict = dataclasses.field(default_factory=dict)
    blocks: dict = dataclasses.field(default_factory=dict)
    resumes: int = 0

    def has(self, stage: str) -> bool:
        return stage in self.done

    def get(self, stage: str):
        return self.done[stage]

    def put(self, stage: str, payload, blocks=()) -> None:
        self.done[stage] = payload
        self.blocks[stage] = [b for b in blocks if b is not None]

    def completed(self) -> list:
        return list(self.done)

    def clear(self) -> None:
        self.done.clear()
        self.blocks.clear()

    def refresh_all(self, bk) -> None:
        """Rejuvenate every checkpointed mask block (client
        re-encryption under NSHEDB's trust model), charged as refreshes
        so recovery cost stays visible in OpStats."""
        seen = set()
        for blocks in self.blocks.values():
            for b in blocks:
                if id(b) in seen:
                    continue
                seen.add(id(b))
                bk._charge_refresh(b, None, "recovery(overflow)")
                bk.refresh_inplace(b)


@dataclasses.dataclass
class CompiledQuery:
    """One QueryPlan lowered to the physical IR, ready to execute:
    annotated mask trees + group enumeration, but no ciphertext touched
    yet.  `run_workload` compiles a whole batch first so every query's
    atoms can fuse into the same stacked launches."""

    plan: QueryPlan
    fact: object
    group_cols: list
    where_expr: object
    group_values: dict
    per_col_items: list
    where_node: object
    aux_nodes: dict
    inject_layers: int


class Executor:
    """Runs one lowered QueryPlan against the planner's backend.

    `evaluator` (optional) shares one AtomEvaluator across executors —
    the workload scheduler passes the batch-wide evaluator so circuits
    fuse between queries; standalone runs build their own."""

    def __init__(self, planner, evaluator=None):
        self.pl = planner
        self.bk = planner.bk
        self.db = planner.db
        self.ev = evaluator
        self.report: ExecReport | None = None
        self._guards = False          # decrypt-boundary guards armed?
        self._sentinel = None         # plaintext sentinel lane (guarded)
        self._verify_report = None    # static VerifyReport of the last run

    # ------------------------------------------------------------ public
    def run(self, plan: QueryPlan, validate: bool = True) -> dict:
        with self._query_span(plan):
            cq = self.compile(plan)
            self._static_verify(cq, mirror_begin_run=True, warm=False)
            if self.pl.optimized and self.pl.share_masks:
                # New serve epoch: masks derived by earlier runs on this
                # planner's cache now count as cross-query hits.
                self.pl.mask_cache.begin_run()
            return self._run(cq, validate, warm=False)

    def run_compiled(self, cq: CompiledQuery, validate: bool = True) -> dict:
        """Workload path: atoms were requested and flushed batch-wide by
        `run_workload`; execute against the warm shared evaluator."""
        with self._query_span(cq.plan):
            self._static_verify(cq, mirror_begin_run=False, warm=True)
            return self._run(cq, validate, warm=True)

    def _query_span(self, plan: QueryPlan):
        """The query's root span (runtime/tracing.py), counting the
        backend's `OpStats.launches` in it."""
        return tracing.query(plan.name, lambda: {"launches": self.bk.stats.launches})

    @contextlib.contextmanager
    def _stage(self, label: str):
        """One stage of `_execute`: a span `label` that, when the stage
        completes, records its `OpStats` deltas in the report and carries
        them."""
        stats = self.bk.stats
        snap = stats.clone()
        with tracing.span(label) as sp:
            yield
            self.report.record(label, snap, stats.clone())
            if sp is not None:
                sp.attrs.update(self.report.history[-1])

    def _static_verify(self, cq: CompiledQuery, mirror_begin_run: bool,
                       warm: bool) -> None:
        """Static admission (DESIGN §10): abstract-interpret the compiled
        DAG against the noise/level/placement model before any ciphertext
        work; error-severity findings reject the plan here.  Opt out with
        Planner(..., verify=False)."""
        self._verify_report = None
        if not getattr(self.pl, "verify_plans", True):
            return
        from .verify import verify_compiled
        rep = verify_compiled(self.pl, cq, mirror_begin_run=mirror_begin_run,
                              warm=warm)
        self._verify_report = rep
        rep.raise_on_error()

    def _run(self, cq: CompiledQuery, validate: bool, warm: bool) -> dict:
        pl, bk = self.pl, self.bk
        pr = pl.report(cq.plan)
        self.report = ExecReport(cq.plan.name, pl.optimized,
                                 pr.predicted_depth, pr.predicted_refreshes,
                                 pr.budget_levels)
        cache = pl.mask_cache
        cs0 = cache.stats.clone()
        start = bk.stats.clone()
        prior_max = bk.stats.max_depth
        bk.stats.max_depth = 0
        # Guards are armed by an injected FaultPlan or Planner(guards=
        # True).  The sentinel lane only makes sense where the plan
        # promises refresh-free depth (optimized): it replays the run's
        # observed depth on a known plaintext with auto-refresh off.
        self._guards = faults.active() is not None or getattr(pl, "guards", False)
        self._sentinel = (faults.SentinelLane(bk)
                          if self._guards and pl.optimized
                          and pr.predicted_refreshes == 0 else None)
        det = getattr(pl, "straggler_det", None)
        costs = getattr(pl, "op_costs", None) or {}
        ctx0 = getattr(pl, "shard_ctx", None)
        led0 = ctx0.modeled_seconds(costs) if (det and ctx0) else 0.0
        ckpt = StageCheckpoint()
        overflow_tries = 0
        loss_tries = 0
        from .sharded import activate
        try:
            while True:
                try:
                    # Sharded scan execution: with a planner shard
                    # context every stacked column launched below
                    # pads/places its block lanes over the mesh data
                    # axis (no-op when shard_ctx is None).  Re-read per
                    # attempt: device-loss recovery swaps the context.
                    with activate(bk, getattr(pl, "shard_ctx", None)):
                        with faults.tampered_noise_model(bk):
                            out = self._execute(cq, warm, ckpt=ckpt)
                    break
                except faults.DeviceLossFault as f:
                    self._recover_device_loss(f, ckpt, loss_tries)
                    loss_tries += 1
                except faults.NoiseOverflowFault as f:
                    self._recover_overflow(f, ckpt, overflow_tries)
                    overflow_tries += 1
            if det is not None and getattr(pl, "shard_ctx", None) is not None:
                self._straggler_round(det, costs, ctx0, led0)
        finally:
            end = bk.stats.clone()
            self.report.measured_depth = bk.stats.max_depth
            self.report.refreshes = end.refresh - start.refresh
            self.report.launches = end.launches - start.launches
            self.report.muls = end.mul - start.mul
            self.report.cache_hits = cache.stats.hits - cs0.hits
            self.report.cache_admit_refreshes = (
                cache.stats.admit_refresh_blocks - cs0.admit_refresh_blocks)
            bk.stats.max_depth = max(prior_max, bk.stats.max_depth)
            self._sentinel = None
        if validate:
            self.report.validate()
            if (self._verify_report is not None and not self.report.recoveries
                    and faults.active() is None):
                # Soundness: the static bound at every decrypt boundary
                # must be no tighter than what execution observed.
                self._verify_report.crosscheck(self.report)
        return out

    # --------------------------------------------------------- recovery
    def _recover_device_loss(self, f, ckpt: StageCheckpoint,
                             tries: int) -> None:
        """Reshard onto the survivors and resume from the checkpoint.
        Raises the fault through when no viable mesh remains or the
        retry budget is spent."""
        pl = self.pl
        ctx = getattr(pl, "shard_ctx", None)
        if ctx is None or tries >= MAX_DEVICE_LOSS_RECOVERIES:
            raise f
        try:
            new_ctx = ctx.reshard([f.worker if f.worker is not None else 0])
        except RuntimeError as e:
            raise faults.DeviceLossFault(
                f"{self.report.name}: no viable scan mesh after losing "
                f"worker {f.worker}: {e}", query=self.report.name,
                stage=f.stage, worker=f.worker) from e
        pl.shard_ctx = new_ctx
        ckpt.resumes += 1
        self.report.recoveries.append({
            "kind": f.kind, "stage": f.stage, "worker": f.worker,
            "action": f"reshard {ctx.shards}->{new_ctx.shards}, resume "
                      f"after {ckpt.completed()}"})

    def _recover_overflow(self, f, ckpt: StageCheckpoint,
                          tries: int) -> None:
        """Bounded overflow recovery: refresh-and-retry, then re-derive
        from base columns, then typed failure (DESIGN §9)."""
        pl, bk = self.pl, self.bk
        if tries >= MAX_OVERFLOW_RETRIES:
            raise f
        if tries == 0:
            # The tracked noise of every materialized mask is suspect —
            # rejuvenate the checkpointed blocks, drop cache entries
            # (their born_levels were priced with the bad model), retry.
            ckpt.refresh_all(bk)
            pl.mask_cache.clear()
            action = "refresh-and-retry"
        else:
            # Refreshing did not clear the overflow: the materialized
            # values themselves are suspect.  Re-derive everything from
            # base columns.
            ckpt.clear()
            pl.mask_cache.clear()
            action = "re-derive-from-base"
        if self._sentinel is not None:
            self._sentinel = faults.SentinelLane(bk)
        self.report.recoveries.append({
            "kind": f.kind, "stage": f.stage, "action": action,
            "detail": f.detail})

    def _straggler_round(self, det, costs: dict, ctx0, led0: float) -> None:
        """Elastic loop: per-worker heartbeats from this run's cost-
        ledger delta, detector evaluation, and reshard away exclusions.
        Workers enumerate the flattened 2-D grid (id = data_row *
        limb_shards + limb_col); either mesh axis shrinks independently:
        a limb *column* whose every data row is flagged is a model-axis
        exclusion (elastic_limb_plan), anything else shrinks the data
        axis by the flagged rows (elastic_scan_plan) — at limb_shards=1
        this reduces exactly to the 1-D policy.  A fleet with no viable
        survivor mesh raises a typed fault."""
        pl = self.pl
        ctx = pl.shard_ctx
        plan = faults.active()
        slow = plan.straggler_slowdown if plan is not None else {}
        base = led0 if ctx is ctx0 else 0.0
        for worker, t in ctx.heartbeats(costs, slow, baseline=base).items():
            det.report(worker, t)
        excluded = [w for w in det.evaluate() if w < ctx.workers]
        if not excluded:
            return
        M = ctx.limb_shards
        flagged = set(excluded)
        limb_cols = [m for m in range(M)
                     if all(d * M + m in flagged for d in range(ctx.shards))]
        if M > 1 and limb_cols and len(limb_cols) < M:
            axis, drop = "model", limb_cols
        else:
            axis, drop = "data", sorted({w // M for w in excluded})
        try:
            new_ctx = ctx.reshard(drop, axis=axis)
        except RuntimeError as e:
            raise faults.StragglerFault(
                f"{self.report.name}: straggler exclusion {excluded} "
                f"leaves no viable scan mesh: {e}",
                query=self.report.name, stage="straggler",
                detail={"excluded": excluded, "axis": axis}) from e
        pl.shard_ctx = new_ctx
        self.report.recoveries.append({
            "kind": "straggler", "excluded": excluded, "axis": axis,
            "action": (f"reshard {axis} "
                       f"{ctx.shards}x{ctx.limb_shards}->"
                       f"{new_ctx.shards}x{new_ctx.limb_shards}")})

    # ------------------------------------------------------- compilation
    def _split_group_in(self, where, group_cols):
        """Group pushdown: an IN predicate on the (single) group column
        defines the group domain and leaves the WHERE tree — the group
        enumeration already restricts to exactly those values."""
        group_values: dict[str, list] = {}
        if len(group_cols) != 1 or where is None:
            return where, group_values
        col = group_cols[0]
        is_group_in = lambda e: isinstance(e, Pred) and e.col == col and e.op == "in"
        if is_group_in(where):
            return None, {col: list(where.value)}
        if isinstance(where, And):
            hit = [c for c in where.children if is_group_in(c)]
            if hit:
                # Absorb exactly one IN into the group enumeration; any
                # further predicates on the group column stay in WHERE.
                kept = [c for c in where.children if c is not hit[0]]
                group_values[col] = list(hit[0].value)
                if not kept:
                    where = None
                elif len(kept) == 1:
                    where = kept[0]
                else:
                    where = And(tuple(kept))
        return where, group_values

    def _group_items(self, fact, group_cols, group_values):
        """Per group column: [(name, encoded id), ...] in output order.
        Pushed-down values encode with predicate semantics (constants
        absent from the data map to a no-match id -> empty group)."""
        per_col = []
        for col in group_cols:
            spec = fact.schema.col(col)
            if col in group_values:
                per_col.append([(v, spec.encode_scalar(v))
                                for v in group_values[col]])
            elif spec.dictionary is not None:
                per_col.append(sorted(spec.dictionary.items()))
            else:
                raise NotImplementedError(
                    f"group_by {col}: no dictionary and no IN predicate to "
                    f"enumerate the domain from")
        return per_col

    # ------------------------------------------------------- compilation
    def compile(self, plan: QueryPlan) -> CompiledQuery:
        """Lower one plan to annotated mask trees (no ciphertext work)."""
        if plan.correlated:
            raise NotImplementedError(
                f"{plan.name}: correlated subqueries are not lowered yet")
        db = self.db
        fact = db.tables[plan.fact]
        group_cols = ([c.strip() for c in plan.group_by.split(",")]
                      if plan.group_by else [])
        where_expr, group_values = self._split_group_in(plan.where, group_cols)
        per_col_items = self._group_items(fact, group_cols, group_values)
        where_node = (compile_mask(db, fact, where_expr)
                      if where_expr is not None else None)
        aux_nodes = {a.name: (a, compile_mask(db, db.tables[a.hop.parent], a.expr))
                     for a in plan.aux_masks}
        inject_layers = (2 if group_cols else 1) \
            + max((a.mul_depth() for a in plan.aggs), default=0)
        if where_node is not None:
            annotate_downstream(where_node, inject_layers)
        for _, node in aux_nodes.values():
            annotate_downstream(node, 2)   # AND with base + R3 injection
        return CompiledQuery(plan, fact, group_cols, where_expr, group_values,
                             per_col_items, where_node, aux_nodes,
                             inject_layers)

    def request_atoms(self, cq: CompiledQuery, ev) -> None:
        """Register every distinct comparison circuit of the query (WHERE
        + aux + group EQs) with the shared evaluator, each carrying its
        downstream-product requirement for noise-aware cache admission."""
        if cq.where_node is not None:
            ev.request_tree(cq.where_node)
        for _, node in cq.aux_nodes.values():
            ev.request_tree(node)
        for col, items in zip(cq.group_cols, cq.per_col_items):
            for _name, vid in items:
                ev.request(CmpAtom(cq.fact.name, col, "eq", int(vid)),
                           cq.inject_layers)

    # --------------------------------------------------------- execution
    @staticmethod
    def _gmask_blocks(gmasks: dict) -> list:
        return [b for d in gmasks.values() for blocks in d.values()
                for b in blocks]

    def _execute(self, cq: CompiledQuery, warm: bool = False,
                 ckpt: StageCheckpoint | None = None) -> dict:
        pl, bk = self.pl, self.bk
        plan, fact = cq.plan, cq.fact
        group_cols, per_col_items = cq.group_cols, cq.per_col_items
        where_expr, where_node, aux_nodes = (cq.where_expr, cq.where_node,
                                             cq.aux_nodes)
        # Stage boundaries double as checkpoints: a completed stage's
        # payload is replayed on resume instead of re-derived, and as
        # injection points for the device-loss fault class.
        ckpt = ckpt if ckpt is not None else StageCheckpoint()

        if pl.optimized:
            # Stage 1 — fused atom evaluation: every distinct comparison
            # circuit in the query is requested up front and evaluated in
            # one stacked launch per shape.  Warm (workload) executions
            # arrive with the batch-wide flush already done.
            ev = self.ev if self.ev is not None else pl.evaluator()
            if not ckpt.has("atoms"):
                faults.maybe_device_loss("atoms")
                with self._stage("atoms[fused]"):
                    if not warm:
                        self.request_atoms(cq, ev)
                        ev.flush()
                ckpt.put("atoms", True)

            if ckpt.has("where"):
                where = ckpt.get("where")
            else:
                faults.maybe_device_loss("where")
                with self._stage("where"):
                    where = (run_mask_node(where_node, ev, pl)
                             if where_node is not None else None)
                ckpt.put("where", where, blocks=where or ())

            aux = {}
            for name, (a, node) in aux_nodes.items():
                stage = f"aux:{name}"
                if ckpt.has(stage):
                    aux[name] = ckpt.get(stage)
                    continue
                faults.maybe_device_loss(stage)
                with self._stage(stage):
                    aux[name] = self._translate_aux(a, node, ev, None)
                ckpt.put(stage, aux[name], blocks=aux[name])

            if ckpt.has("gmasks"):
                gmasks = ckpt.get("gmasks")
            elif group_cols:
                faults.maybe_device_loss("gmasks")
                with tracing.span("gmasks"):     # no stage of the report
                    gmasks = {
                        col: dict(ev.eq_masks(fact, col,
                                              [vid for _n, vid in items],
                                              need_levels=cq.inject_layers))
                        for col, items in zip(group_cols, per_col_items)
                    }
                ckpt.put("gmasks", gmasks,
                         blocks=self._gmask_blocks(gmasks))
            else:
                gmasks = {}
        else:
            # Classical pipeline: sequential chains, no fusion, joins over
            # filtered FK columns, raw group EQs combined after the WHERE.
            if ckpt.has("where"):
                where = ckpt.get("where")
            else:
                faults.maybe_device_loss("where")
                with self._stage("where[seq]"):
                    where = (pl.where_mask(fact, where_expr)
                             if where_expr is not None else None)
                ckpt.put("where", where, blocks=where or ())
            aux = {}
            for name, (a, node) in aux_nodes.items():
                stage = f"aux:{name}"
                if ckpt.has(stage):
                    aux[name] = ckpt.get(stage)
                    continue
                faults.maybe_device_loss(stage)
                with self._stage(f"{stage}[pushdown]"):
                    fk_ov = (ops.mask_columns(bk, fact.col(a.hop.fk).blocks, where)
                             if where is not None else None)
                    aux[name] = self._translate_aux(a, node, None, fk_ov)
                ckpt.put(stage, aux[name], blocks=aux[name])
            if ckpt.has("gmasks"):
                gmasks = ckpt.get("gmasks")
            elif group_cols:
                faults.maybe_device_loss("gmasks")
                with tracing.span("gmasks"):     # no stage of the report
                    gmasks = {
                        col: dict(ops.group_masks(bk, fact, col,
                                                  [vid for _n, vid in items]))
                        for col, items in zip(group_cols, per_col_items)
                    }
                ckpt.put("gmasks", gmasks,
                         blocks=self._gmask_blocks(gmasks))
            else:
                gmasks = {}

        # The aggregate is never checkpointed — its outputs are the
        # decrypted results themselves, which must re-derive under any
        # recovery so the guards re-check them.
        faults.maybe_device_loss("aggregate")
        with self._stage("aggregate"):
            out = (self._grouped(plan, fact, per_col_items, gmasks, where, aux)
                   if group_cols else self._ungrouped(plan, fact, where))
        return out

    def _translate_aux(self, a, node, ev, fk_override):
        """Aux mask: parent-table subtree -> translated fact mask."""
        pl, bk, db = self.pl, self.bk, self.db
        if ev is not None:
            parent_mask = run_mask_node(node, ev, pl)
        else:
            parent_mask = pl.where_mask(db.tables[a.hop.parent], a.expr)
        assert len(parent_mask) == 1, "aux translate: single-block parent"
        need = pl.translate_levels(node.downstream_muls)
        return ops.translate_mask_down(bk, parent_mask[0], db.tables[a.hop.child],
                                       a.hop.fk, db.tables[a.hop.parent].nrows,
                                       fk_override=fk_override, need_levels=need,
                                       eq_cache=None if ev is None else ev.cache)

    # ------------------------------------------------------- aggregation
    def _dec(self, ct):
        """The decrypt boundary.  With guards armed every result passes
        the headroom check (tracked budget minus any model-hidden growth
        must clear zero) and the sentinel lane replays the run's
        observed depth on a known plaintext — both raise a typed
        NoiseOverflowFault *before* a garbage value can be returned."""
        if self._guards:
            faults.check_decrypt(self.bk, ct,
                                 query=self.report.name if self.report else "")
            if self._sentinel is not None:
                self._sentinel.verify(
                    self.bk.stats.max_depth,
                    query=self.report.name if self.report else "")
        if self.report is not None:
            self.report.decrypt_headrooms.append(float(self.bk.budget(ct)))
        return int(self.bk.decrypt(ct)[0])

    def _dec_agg(self, agg, r):
        if agg.kind == "avg":
            return (self._dec(r[0]), self._dec(r[1]))
        return self._dec(r)

    def _ungrouped(self, plan, fact, where) -> dict:
        pl = self.pl
        return {agg.name: self._dec_agg(agg, pl.aggregate(fact, agg, where))
                for agg in plan.aggs}

    def _grouped(self, plan, fact, per_col_items, gmasks, where, aux) -> dict:
        pl, bk = self.pl, self.bk
        out = {}
        for combo in itertools.product(*per_col_items):
            key = combo[0][0] if len(combo) == 1 else tuple(n for n, _ in combo)
            gm_lists = [gmasks[col][vid]
                        for col, (_n, vid) in zip(gmasks, combo)]
            legs = gm_lists + ([where] if where is not None else [])
            if pl.optimized:
                base = ops.and_masks(bk, legs) if len(legs) > 1 else legs[0]
            else:
                seq = ([where] + gm_lists) if where is not None else gm_lists
                base = ops.and_masks_seq(bk, seq) if len(seq) > 1 else seq[0]
            base = ops.apply_validity(bk, base, fact)
            row, parts = {}, {}
            for agg in plan.aggs:
                if agg.partition is None:
                    row[agg.name] = self._dec_agg(
                        agg, pl._agg_with_mask(fact, agg, base))
                    continue
                if agg.partition not in parts:
                    am = aux[agg.partition]
                    parts[agg.partition] = (
                        ops.and_masks(bk, [base, am]) if pl.optimized
                        else ops.and_masks_seq(bk, [base, am]))
                hit = parts[agg.partition]
                m = ([bk.sub(b, h) for b, h in zip(base, hit)]
                     if agg.negated else hit)      # complement = base - hit
                row[agg.name] = self._dec_agg(
                    agg, pl._agg_with_mask(fact, agg, m))
            out[key] = row
        return out


def run_via_plan(planner, plan: QueryPlan, validate: bool = True,
                 shards: int | None = None,
                 limb_shards: int | None = None,
                 verify: bool | None = None) -> dict:
    """Execute a QueryPlan through the compiled operator DAG.  Returns
    the same decrypted result structure as the legacy `run_qN` body.

    `shards=N` runs this plan's scan phase sharded over N mesh data
    lanes and `limb_shards=M` shards the k RNS limbs over M model-axis
    lanes (engine/sharded.py) without mutating the planner's default:
    the context is installed for this call only.  `verify` overrides the
    planner's static-verification knob for this call only (None keeps
    the planner default)."""
    prev_verify = getattr(planner, "verify_plans", True)
    if verify is not None:
        planner.verify_plans = verify
    try:
        if shards is None and limb_shards is None:
            # No context installed: leave planner.shard_ctx alone so a
            # mid-run recovery's resharding stays observable post-call.
            return Executor(planner).run(plan, validate=validate)
        from .sharded import make_shard_context
        prev = getattr(planner, "shard_ctx", None)
        planner.shard_ctx = make_shard_context(
            shards if shards is not None else 1,
            limb_shards=limb_shards if limb_shards is not None else 1,
            limbs=getattr(planner.bk, "limbs", None),
            ring_n=getattr(planner.bk, "slots", 0),
            device=getattr(planner.bk, "device", None))
        try:
            return Executor(planner).run(plan, validate=validate)
        finally:
            planner.shard_ctx = prev
    finally:
        planner.verify_plans = prev_verify
