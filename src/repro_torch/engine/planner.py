"""Noise-sensitive query optimization (paper §4.3).

The planner's job is to keep every multiplication chain inside the noise
budget B (levels) so the engine never refreshes.  It implements the three
rewrites of §4.3.2 and exposes the same building blocks in two regimes:

  optimized   R1 mask isolation: every predicate is evaluated against the
              *original* columns into its own mask subgraph.
              R2 independent evaluation: conjunctions become balanced
              product trees (depth max+log k instead of max+k-1).
              R3 late injection: the combined mask is multiplied into the
              plan exactly once, at the deepest point that still fits the
              budget (the i* rule below).

  unoptimized the classical pipeline: predicate pushdown multiplies masks
              into columns immediately, so later comparisons run on
              deepened inputs and chains add up — exactly the Fig. 3(a)
              behaviour whose depth is m stages x d_s each.

Cost-and-decision model (§4.3.2): for a fragment of m stages of per-stage
depth d_s, injecting the mask after stage i leaves depth D_i = (m-i)*d_s
on top of the mask and costs i extra mask multiplications:

    Cost(i) = (m-i)*C_mul + i*C_mul + [D_i > B] * C_boot
    i*      = max{ i : D_i <= B }   if feasible else m (pay one refresh)

In the optimized regime, mask construction, group-by enumeration and
ORDER BY all route through the physical IR (engine/physical.py): masks
compile to CmpAtom DAG nodes that are CSE-deduplicated on the planner's
`mask_cache` and fused into cross-column batched circuit launches; see
engine/executor.py for whole-plan execution (DESIGN.md §7).
"""
from __future__ import annotations

import dataclasses
import math

from ..core import compare as cmp
from . import ops
from .plan import And, Not, Or, Pred, QueryPlan, Translated, child_depth, eq_depth
from .storage import Database, EncryptedTable


def noise_budget_levels(bk) -> int:
    """How many sequential ct-ct multiplications a fresh ciphertext
    supports under this backend's parameters — B_noise in levels."""
    m = bk.model
    v = m.fresh()
    d = 0
    while True:
        v2 = m.keyswitch(m.mul(v, v))
        if m.budget(v2) <= 0:
            return d
        v, d = v2, d + 1


def injection_depth(m_stages: int, d_s: int, budget: int) -> int:
    """i* from the §4.3.2 cost model."""
    for i in range(m_stages + 1):
        if (m_stages - i) * d_s <= budget:
            return i
    return m_stages


@dataclasses.dataclass
class PlanReport:
    name: str
    optimized: bool
    predicted_depth: int
    budget_levels: int
    predicted_refreshes: int

    @property
    def fits(self) -> bool:
        return self.predicted_depth <= self.budget_levels


class Planner:
    def __init__(self, db: Database, optimized: bool = True, cache=None,
                 shards: int | None = None, mesh="auto",
                 guards: bool = False, limb_shards: int | None = None,
                 verify: bool = True):
        from .workload import WorkloadCache
        self.db = db
        self.bk = db.bk
        self.optimized = optimized
        self.budget_levels = noise_budget_levels(self.bk)
        # Static admission (DESIGN §10): the executor verifies every
        # compiled plan against the abstract noise/level/placement model
        # before touching ciphertexts; verify=False opts out (chaos
        # harnesses and benchmarks that deliberately run broken plans).
        self.verify_plans = verify
        # Sharded execution (DESIGN §4): shards=N partitions every
        # stacked block column over the mesh "data" axis; limb_shards=M
        # partitions each block's k RNS limbs over the "model" axis
        # (key-switches all-gather their digits across it).  The
        # executor and evaluator activate this context around
        # execution; None/None keeps the classic single-device path.
        if (shards is not None and shards >= 1) or (
                limb_shards is not None and limb_shards >= 1):
            from .sharded import make_shard_context
            self.shard_ctx = make_shard_context(
                shards if shards is not None else 1, mesh,
                limb_shards=limb_shards if limb_shards is not None else 1,
                limbs=getattr(self.bk, "limbs", None),
                ring_n=getattr(self.bk, "slots", 0),
                device=getattr(self.bk, "device", None))
        else:
            self.shard_ctx = None
        # Noise-aware mask store shared by every compiled mask: WHERE
        # predicates, group-by EQ enumerations, aux/join masks and sort
        # passes all read and write the same subgraph store through
        # noise-checked admission.  Pass an external WorkloadCache to
        # persist masks across planners/queries (engine/workload.py).
        self.mask_cache = cache if cache is not None else WorkloadCache()
        self.mask_cache.bind(db)       # invalidate on table re-loads
        # Scheduler knobs (benchmarks flip these to measure the pre-DAG
        # schedule): fuse_masks batches distinct circuits cross-column,
        # share_masks enables the CSE cache.  Both default to the regime.
        self.fuse_masks = optimized
        self.share_masks = optimized
        # Fault-tolerant runtime (DESIGN §9): guards=True arms the
        # decrypt-boundary headroom check, the plaintext sentinel lane
        # and bounded overflow recovery even outside an injection scope
        # (the executor always guards while a FaultPlan is armed).
        self.guards = guards
        # Elastic wiring: attach_straggler_detector populates these;
        # after every sharded run the executor synthesizes per-shard
        # heartbeats from the cost-ledger delta, reports them, and
        # re-shards away excluded workers.
        self.straggler_det = None
        self.op_costs: dict | None = None

    def attach_straggler_detector(self, det, costs: dict) -> None:
        """Wire a runtime/elastic.py StragglerDetector into execution:
        per-shard step times come from `ShardContext.heartbeats` priced
        with `costs` (measured per-op seconds), and exclusion feeds
        `ShardContext.reshard` — the scan-axis elasticity loop."""
        self.straggler_det = det
        self.op_costs = dict(costs)

    def evaluator(self):
        """A physical-atom evaluator bound to this planner's mask cache;
        circuit fusion is enabled only in the optimized regime.  With
        sharing disabled the evaluator gets a private throwaway store."""
        from .physical import AtomEvaluator
        return AtomEvaluator(self.db, self.bk,
                             self.mask_cache if self.share_masks else None,
                             fuse=self.fuse_masks, shard_ctx=self.shard_ctx)

    def translate_levels(self, downstream_muls: int) -> int:
        """Planned-refresh sizing for a mask about to cross an FK hop —
        the i* rule on levels: the translated bit must absorb the hop
        internals (broadcast + EQ x bit, ~2 levels) plus every downstream
        mask product; if that exceeds the whole budget the infeasible
        branch pays its single planned refresh inside ensure_levels."""
        return min(2 + downstream_muls, self.budget_levels)

    def verify(self, plan: QueryPlan):
        """Statically verify `plan` against this planner's state (noise
        abstract interpretation + IR typing + mesh lint, engine/verify.py)
        without executing it.  Returns a VerifyReport."""
        from .verify import verify_plan
        return verify_plan(self, plan)

    # ------------------------------------------------------------- report
    def report(self, plan: QueryPlan) -> PlanReport:
        t = self.bk.t
        d = plan.total_depth(t, self.optimized)
        boots = 0 if d <= self.budget_levels else math.ceil(
            (d - self.budget_levels) / max(self.budget_levels, 1))
        return PlanReport(plan.name, self.optimized, d, self.budget_levels, boots)

    # ------------------------------------------------- mask construction
    def where_mask(self, table: EncryptedTable, expr) -> list:
        """Evaluate a MaskExpr tree into one mask per block.

        Optimized regime: the tree is lowered through engine/physical.py
        — R1 isolation becomes a set of CmpAtoms (CSE-deduplicated on the
        planner cache), all atoms sharing a circuit shape run in one
        fused cross-column launch, and the combine layers replay R2's
        balanced trees.  Unoptimized keeps the sequential pipeline."""
        if not self.optimized:
            return self._mask_seq(table, expr)
        from .physical import annotate_downstream, compile_mask, run_mask_node
        from .sharded import activate
        node = compile_mask(self.db, table, expr)
        annotate_downstream(node, 1)     # R3: one injection at the aggregate
        ev = self.evaluator()
        with activate(self.bk, self.shard_ctx):
            ev.request_tree(node)
            ev.flush()
            return run_mask_node(node, ev, self)

    def _mask_seq(self, table, expr) -> list:
        """Unoptimized: classical pipeline semantics.  Conjunctions chain
        sequentially (depth max + k - 1 instead of max + log k); the far
        deeper pushdown penalty — joins running over already-masked
        columns, Fig. 3(a)'s 3*log(p-1) chains — lives in the unoptimized
        branches of the query bodies (translate-after-filter)."""
        bk = self.bk
        if isinstance(expr, Pred):
            return ops.pred_mask(bk, table, expr)
        if isinstance(expr, Not):
            return ops.not_mask(bk, self._mask_seq(table, expr.child))
        if isinstance(expr, Translated):
            parent = self.db.tables[expr.hop.parent]
            pm = self._mask_seq(parent, expr.expr)
            assert len(pm) == 1, "translated: single-block parent"
            return ops.translate_mask_down(bk, pm[0],
                                           self.db.tables[expr.hop.child],
                                           expr.hop.fk, parent.nrows)
        kids = [self._mask_seq(table, c) for c in expr.children]
        if isinstance(expr, Or):
            return ops.or_masks_seq(bk, kids)
        return ops.and_masks_seq(bk, kids)

    # ------------------------------------------------------- aggregation
    def aggregate(self, table: EncryptedTable, agg, mask: list | None):
        """SUM/COUNT/AVG with R3 late injection in the optimized regime:
        the mask meets the fully-formed expression exactly once, at the
        aggregation input."""
        bk = self.bk
        if mask is not None:
            mask = ops.apply_validity(bk, mask, table)
        if agg.kind == "count":
            assert mask is not None
            return ops.count(bk, mask)
        if self.optimized or mask is None:
            vals = ops.expr_blocks(bk, table, agg.factors)
            if mask is None:
                v = table.validity(table.nblocks - 1)
                if v is not None:
                    vals = vals[:-1] + [bk.mul_plain(vals[-1], v)]
                return ops.reduce_blocks(bk, vals)
            if agg.kind == "avg":
                return (ops.masked_sum(bk, vals, mask), ops.count(bk, mask))
            return ops.masked_sum(bk, vals, mask)
        # Unoptimized: mask every column first, then form the expression
        # on filtered inputs (pushdown).
        mask = ops.admit_inject(bk, mask)
        masked = {
            f.col: ops.mask_columns(bk, table.col(f.col).blocks, mask)
            for f in agg.factors if f.col is not None
        }
        vals = ops.expr_blocks(bk, table, agg.factors, masked=masked)
        if agg.kind == "avg":
            return (ops.reduce_blocks(bk, vals), ops.count(bk, mask))
        return ops.reduce_blocks(bk, vals)

    # ----------------------------------------------- group-by / order-by
    def group_masks(self, table: EncryptedTable, col: str, domain) -> list:
        """Per-value EQ masks for GROUP BY / ORDER BY enumeration.

        Optimized: memoized on the planner's CSE cache and fused into a
        single stacked launch for all uncached values — repeated group
        pairs (Q1), sorts after grouping, and re-run queries all reuse
        the identical `eq_scalar` subgraphs.  Unoptimized recomputes,
        like the classical pipeline it models."""
        if not self.optimized:
            return ops.group_masks(self.bk, table, col, domain)
        return self.evaluator().eq_masks(table, col, domain)

    def sort_column(self, table: EncryptedTable, col: str, domain,
                    descending: bool = False):
        """§4.2.3 ORDER BY through the memoized EQ-mask store."""
        if not self.optimized:
            return ops.sort_column(self.bk, table, col, domain, descending)
        masks = dict(self.group_masks(table, col, domain))
        return ops.sort_column(self.bk, table, col, domain, descending,
                               mask_provider=lambda v: masks[v])

    # ------------------------------------------------------------- joins
    def semi_join_mask(self, hop, parent_mask_block) -> list:
        """Translate a parent-row mask to the child through hop.fk."""
        child = self.db.tables[hop.child]
        nparent = self.db.tables[hop.parent].nrows
        return ops.translate_mask_down(self.bk, parent_mask_block, child, hop.fk, nparent)

    def group_aggregate(self, table: EncryptedTable, group_col: str, domain,
                        aggs, mask: list | None):
        """GROUP BY: one EQ mask per group value, combined with the WHERE
        mask (optimized: one balanced multiply; unoptimized: the group EQ
        is evaluated on masked columns)."""
        bk = self.bk
        results = {}
        if mask is not None:
            mask = ops.apply_validity(bk, mask, table)
        for v, gmask in self.group_masks(table, group_col, domain):
            if mask is None:
                m = gmask
            elif self.optimized:
                m = ops.mul_lists(bk, gmask, mask)
            else:
                col = table.col(group_col)
                filtered = ops.mask_columns(bk, col.blocks, mask)
                gm = [cmp.eq_scalar(bk, ct, int(v)) for ct in filtered]
                m = ops.mul_lists(bk, gm, mask)
            row = {}
            for agg in aggs:
                row[agg.name] = self._agg_with_mask(table, agg, m)
            results[v] = row
        return results

    def _agg_with_mask(self, table, agg, m):
        bk = self.bk
        if agg.kind == "count":
            return ops.count(bk, m)
        vals = ops.expr_blocks(bk, table, agg.factors)
        if agg.kind == "avg":
            return (ops.masked_sum(bk, vals, m), ops.count(bk, m))
        return ops.masked_sum(bk, vals, m)
