"""Logical plan nodes and the multiplicative-depth model (paper Table 3).

The planner treats multiplicative depth as the primary cost (§4.3).  Every
node can report its depth under the *optimized* regime (independent
subgraphs, balanced trees) and the *unoptimized* regime (sequential
pipeline with predicate pushdown — masks applied to columns as soon as
they are produced, so later comparisons run on already-deepened inputs).

Depth table (t = plaintext prime, n = slots):
  equality            ceil(log2(t-1))            square chain
  range (<,<=,>,>=)   ceil(log2(t-1)) + 1        sgn interpolant via BSGS
  between             range + 1                  product of two masks
  in                  equality                   balanced sum of EQs
  aggregation         ~log(n)/t (rotations)      effectively 0 mul-depth
  join                equality + 1               EQ mask x attribute
  group by/order by   equality                   one EQ mask per value
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any


def eq_depth(t: int) -> int:
    return math.ceil(math.log2(t - 1))


def lt_depth(t: int) -> int:
    return eq_depth(t) + 1


@dataclasses.dataclass(frozen=True)
class Pred:
    """A comparison: col <op> value, or col <op> rhs_col (column form)."""

    col: str
    op: str                       # = | != | < | <= | > | >= | between | in
    value: Any = None
    rhs_col: str | None = None

    def depth(self, t: int) -> int:
        if self.op in ("=", "!=", "in"):
            return eq_depth(t)
        if self.op == "between":
            return lt_depth(t) + 1
        return lt_depth(t)


@dataclasses.dataclass(frozen=True)
class And:
    children: tuple

    def depth(self, t: int, optimized: bool = True) -> int:
        ds = [child_depth(c, t, optimized) for c in self.children]
        if optimized:
            # R2 independent evaluation + balanced product tree.
            return max(ds) + math.ceil(math.log2(len(ds))) if len(ds) > 1 else ds[0]
        # Sequential: each conjunct multiplied in one after another.
        return max(ds) + len(ds) - 1


@dataclasses.dataclass(frozen=True)
class Or:
    children: tuple

    def depth(self, t: int, optimized: bool = True) -> int:
        ds = [child_depth(c, t, optimized) for c in self.children]
        if optimized:
            return max(ds) + math.ceil(math.log2(len(ds))) if len(ds) > 1 else ds[0]
        return max(ds) + len(ds) - 1


@dataclasses.dataclass(frozen=True)
class Not:
    child: Any

    def depth(self, t: int, optimized: bool = True) -> int:
        return child_depth(self.child, t, optimized)


def child_depth(c, t: int, optimized: bool = True) -> int:
    if isinstance(c, Pred):
        return c.depth(t)
    return c.depth(t, optimized)


MaskExpr = Any  # Pred | And | Or | Not | Translated (defined below)


@dataclasses.dataclass(frozen=True)
class Translated:
    """A mask evaluated on `hop.parent` and pushed down to the child
    table through the FK (Fig. 2 Extract+Broadcast+EQ).  This is the
    *executable* form of a filtering join: Q19's per-branch part masks
    are `Translated(JoinHop(part -> lineitem), <part predicate tree>)`
    nodes sitting inside the fact table's WHERE tree.

    Depth: the EQ on the fk column meets the broadcast parent bit
    (parent depth + 1 plaintext multiply) in one ct-ct product — the
    same recurrence as a JoinHop with a parent_filter."""

    hop: "JoinHop"
    expr: Any                     # MaskExpr over hop.parent's columns

    def depth(self, t: int, optimized: bool = True) -> int:
        return max(eq_depth(t), child_depth(self.expr, t, optimized) + 1) + 1


@dataclasses.dataclass(frozen=True)
class AuxMask:
    """A named auxiliary fact-table mask: `expr` evaluated over
    `hop.parent`, translated down through `hop.fk`.  Aggregates can
    partition on it (Q12's high/low priority line counts) without the
    mask participating in the WHERE conjunction."""

    name: str
    hop: "JoinHop"
    expr: Any                     # MaskExpr over hop.parent's columns


@dataclasses.dataclass(frozen=True)
class Factor:
    """(add + mult * col): the affine factors appearing in aggregates,
    e.g. extendedprice * (1 - discount) with discount scaled by 100 is
    Factor('l_extendedprice') * Factor('l_discount', mult=-1, add=100)."""

    col: str | None = None
    mult: int = 1
    add: int = 0


@dataclasses.dataclass(frozen=True)
class Agg:
    kind: str                     # sum | count | avg
    factors: tuple = ()           # product of Factors (empty for count)
    name: str = ""
    partition: str | None = None  # AuxMask name this aggregate is CASEd on
    negated: bool = False         # count the complement of the partition

    def mul_depth(self) -> int:
        """ct-ct multiplies needed to form the aggregate's expression."""
        ncols = sum(1 for f in self.factors if f.col is not None)
        return max(0, ncols - 1)


@dataclasses.dataclass(frozen=True)
class JoinHop:
    """FK -> PK hop: child.fk references parent.key (dense 1..|parent|)."""

    parent: str
    fk: str
    child: str
    parent_filter: MaskExpr | None = None

    def depth(self, t: int, incoming: int = 0) -> int:
        # EQ on the fk column + multiply by the (broadcast) parent mask.
        return max(eq_depth(t), incoming) + 1


@dataclasses.dataclass
class QueryPlan:
    """Declarative description of one benchmark query: enough structure
    for the depth/cost model; execution is composed from the same pieces
    by engine/queries.py."""

    name: str
    fact: str
    where: MaskExpr | None = None
    hops: tuple = ()              # JoinHops, outermost parent first
    group_by: str | None = None   # column on fact (or translated) domain
    group_domain: int = 0
    aggs: tuple = ()
    order_by: str | None = None
    correlated: bool = False      # Q4/Q17-style subquery (extra LT stage)
    aux_masks: tuple = ()         # AuxMasks aggregates may partition on

    def describe(self) -> str:
        """One-line structural summary (verifier CLI / report headers)."""
        bits = [f"fact={self.fact}"]
        if self.where is not None:
            bits.append("where")
        if self.hops:
            bits.append(f"hops={len(self.hops)}")
        if self.group_by:
            bits.append(f"group_by={self.group_by}")
        if self.aux_masks:
            bits.append(f"aux={len(self.aux_masks)}")
        if self.correlated:
            bits.append("correlated")
        bits.append(f"aggs={len(self.aggs)}")
        return f"{self.name}({', '.join(bits)})"

    # ---- Table-3 depth model ------------------------------------------
    def mask_depth(self, t: int, optimized: bool) -> int:
        parts = []
        if self.where is not None:
            parts.append(child_depth(self.where, t, optimized))
        d_chain = 0
        for hop in self.hops:
            base = eq_depth(t)
            if hop.parent_filter is not None:
                base = max(base, child_depth(hop.parent_filter, t, optimized) + 1)
            if optimized:
                d_chain = max(d_chain, base) + 1
            else:
                # pushdown: the EQ runs on an already-masked column.
                d_chain = d_chain + base + 1
        if d_chain:
            parts.append(d_chain)
        if self.correlated:
            parts.append(eq_depth(t) + lt_depth(t) + 2)
        if not parts:
            return 0
        if optimized:
            return max(parts) + (math.ceil(math.log2(len(parts))) if len(parts) > 1 else 0)
        return max(parts) + len(parts) - 1

    def total_depth(self, t: int, optimized: bool = True) -> int:
        d_mask = self.mask_depth(t, optimized)
        d_group = eq_depth(t) if self.group_by else 0
        d_agg = max((a.mul_depth() for a in self.aggs), default=0)
        if optimized:
            # R3 late injection: group mask, where mask and the aggregate
            # expression meet in one balanced product.
            legs = [d for d in (d_mask, d_group) if d]
            inject = (max(legs) + len(legs) - 1) if legs else 0
            return inject + d_agg + 1
        # Unoptimized: group-by EQ runs on masked columns, aggregates on
        # masked expressions.
        return d_mask + d_group + d_agg + 1
