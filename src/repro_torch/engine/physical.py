"""Logical -> physical lowering of mask expressions (DESIGN.md §7).

This module turns the declarative `MaskExpr` trees of engine/plan.py into
a small physical IR that the noise-aware scheduler can optimize before a
single ciphertext is touched:

  CmpAtom      one comparison *circuit* application: an affine shift
               z = ±col + c (or col - rhs_col) followed by either the
               EQ square chain (`eq_zero`) or the sgn/Paterson-Stockmeyer
               interpolant (`lt_zero`).  Every predicate in the SQL
               surface lowers to 1..k atoms plus cheap post-processing —
               the expensive part of query evaluation is exactly the set
               of distinct atoms.
  PredProgram  the atoms of one predicate plus its combiner (negate /
               product for BETWEEN / balanced sum for IN).
  MaskNode     the lowered expression tree: pred | and | or | not |
               translated (FK push-down of a parent-table subtree).

Two scheduler optimizations act on the atom set:

  CSE          atoms are keyed on (table, column, circuit, shift); the
               planner-wide WorkloadCache (engine/workload.py) means
               `l_returnflag = 'A'` is evaluated once no matter how many
               group pairs, sort passes or repeated queries mention it —
               and every hit passes noise-aware admission, so cached
               masks are refreshed or re-derived (never served blind)
               when a deeper consumer needs more remaining levels.
  Fusion       all *distinct* atoms that share a circuit shape — every
               EQ in the query, every LT in the query — are stacked
               across columns (and tables) into one `(nblocks_total, ...)`
               batch and run through a single circuit call: the
               cross-column generalization of the per-column batched path
               (one `(ncols*nblocks, 2, k, n)` kernel launch on the BFV
               backend instead of one launch per predicate).

Both preserve the noise/depth accounting exactly: ops are charged per
block, every atom's z starts from fresh column blocks (equal noise), so
OpStats totals, refresh behaviour and `max_depth` match the unfused
schedule minus the work CSE provably removed.
"""
from __future__ import annotations

import dataclasses
import math

from ..core import compare as cmp
from .plan import And, JoinHop, Not, Or, Pred, Translated
from .storage import EncryptedTable


# ---------------------------------------------------------------------------
# Atoms.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CmpAtom:
    """One comparison-circuit application over a whole column.

    z = col - const            (flip=False)   |  col - rhs  (rhs set)
    z = const - col            (flip=True)    |  rhs - col
    followed by circuit 'eq' (eq_zero) or 'lt' (lt_zero).
    """

    table: str
    col: str
    circuit: str                  # 'eq' | 'lt'
    const: int = 0                # encoded comparison constant
    flip: bool = False
    rhs: str | None = None

    @property
    def key(self):
        return (self.table, self.col, self.circuit, self.const, self.flip, self.rhs)


@dataclasses.dataclass
class PredProgram:
    """Atoms of one predicate + the cheap combiner that rebuilds it."""

    atoms: list
    negs: list                    # post-circuit negation per atom (1 - m)
    combine: str                  # 'one' | 'mul' | 'sum' | 'zero'
    table: str = ""               # source table/column (for the 'zero' case)
    col: str = ""


def compile_pred(table: EncryptedTable, pred: Pred) -> PredProgram:
    """Lower one Pred to atoms, reproducing core/compare.py circuits
    op-for-op (see eq_scalar / lt_scalar / between_scalar / in_set)."""
    tname = table.name
    if pred.rhs_col is not None:
        a = lambda circ, flip: CmpAtom(tname, pred.col, circ, 0, flip, pred.rhs_col)
        return {
            "=":  PredProgram([a("eq", False)], [False], "one"),
            "!=": PredProgram([a("eq", False)], [True], "one"),
            "<":  PredProgram([a("lt", False)], [False], "one"),
            ">":  PredProgram([a("lt", True)], [False], "one"),
            ">=": PredProgram([a("lt", False)], [True], "one"),
            "<=": PredProgram([a("lt", True)], [True], "one"),
        }[pred.op]
    spec = table.col(pred.col).spec
    enc = spec.encode_scalar
    a = lambda circ, c, flip=False: CmpAtom(tname, pred.col, circ, int(c), flip)
    if pred.op == "=":
        return PredProgram([a("eq", enc(pred.value))], [False], "one")
    if pred.op == "!=":
        return PredProgram([a("eq", enc(pred.value))], [True], "one")
    if pred.op == "<":
        return PredProgram([a("lt", enc(pred.value))], [False], "one")
    if pred.op == ">":
        return PredProgram([a("lt", enc(pred.value), True)], [False], "one")
    if pred.op == ">=":
        return PredProgram([a("lt", enc(pred.value))], [True], "one")
    if pred.op == "<=":
        return PredProgram([a("lt", enc(pred.value), True)], [True], "one")
    if pred.op == "between":
        lo, hi = enc(pred.value[0]), enc(pred.value[1])
        # between = ge * le = (1 - LT(x-lo)) * (1 - LT(hi-x))
        return PredProgram([a("lt", lo), a("lt", hi, True)], [True, True], "mul")
    if pred.op == "in":
        if not pred.value:
            return PredProgram([], [], "zero", table=tname, col=pred.col)
        atoms = [a("eq", enc(v)) for v in pred.value]
        return PredProgram(atoms, [False] * len(atoms), "sum")
    raise ValueError(pred.op)


# ---------------------------------------------------------------------------
# Lowered mask tree.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MaskNode:
    kind: str                     # 'pred' | 'and' | 'or' | 'not' | 'translated'
    table: str = ""
    pred: PredProgram | None = None
    children: list = dataclasses.field(default_factory=list)
    hop: JoinHop | None = None
    # scheduler annotation: ct-ct mask multiplies applied to this node's
    # result before the aggregation injection point (drives i*/ensure_levels)
    downstream_muls: int = 0

    def atoms(self) -> list:
        out = list(self.pred.atoms) if self.pred is not None else []
        for c in self.children:
            out.extend(c.atoms())
        return out

    def clone(self) -> "MaskNode":
        """Structural deep copy (pred/hop are shared read-only): lets
        plan-mutation tooling graft a subtree into several positions
        without aliasing the per-position scheduler annotations."""
        return MaskNode(self.kind, self.table, self.pred,
                        [c.clone() for c in self.children], self.hop,
                        self.downstream_muls)

    def atom_needs(self) -> list:
        """(atom, need_levels) pairs for the whole subtree: how many ct-ct
        multiplications each atom's mask must absorb downstream — the
        node's annotated products plus the predicate's own combiner
        (BETWEEN multiplies its legs before leaving the predicate).
        Drives noise-aware WorkloadCache admission."""
        out = []
        if self.pred is not None:
            extra = (len(self.pred.atoms) - 1
                     if self.pred.combine == "mul" else 0)
            for a in self.pred.atoms:
                out.append((a, self.downstream_muls + extra))
        for c in self.children:
            out.extend(c.atom_needs())
        return out


def compile_mask(db, table: EncryptedTable, expr) -> MaskNode:
    """Recursively lower a MaskExpr over `table` into a MaskNode tree."""
    if isinstance(expr, Pred):
        return MaskNode("pred", table.name, pred=compile_pred(table, expr))
    if isinstance(expr, Not):
        return MaskNode("not", table.name,
                        children=[compile_mask(db, table, expr.child)])
    if isinstance(expr, Translated):
        parent = db.tables[expr.hop.parent]
        return MaskNode("translated", table.name, hop=expr.hop,
                        children=[compile_mask(db, parent, expr.expr)])
    kids = [compile_mask(db, table, c) for c in expr.children]
    return MaskNode("and" if isinstance(expr, And) else "or", table.name,
                    children=kids)


def annotate_downstream(node: MaskNode, above: int) -> None:
    """Scheduler pass: record, per node, how many ct-ct mask products sit
    between it and the aggregation injection point (`above` counts the
    combine layers of its ancestors plus the final R3 injection).  Used
    to size planned refreshes with the §4.3.2 i* rule."""
    node.downstream_muls = above
    if node.kind in ("and", "or"):
        layers = math.ceil(math.log2(max(len(node.children), 2)))
        for c in node.children:
            annotate_downstream(c, above + layers)
    elif node.kind == "not":
        annotate_downstream(node.children[0], above)
    elif node.kind == "translated":
        # the parent-side subtree feeds the broadcast bit: one plaintext
        # multiply (broadcast) + one ct-ct (EQ x bit) before rejoining.
        annotate_downstream(node.children[0], above + 2)


# ---------------------------------------------------------------------------
# Fused atom evaluation (CSE + cross-column batching).
# ---------------------------------------------------------------------------

# Default admission requirement when a consumer's downstream product
# count is unknown: one combine layer + the R3 injection.
DEFAULT_NEED_LEVELS = 2


class AtomEvaluator:
    """Evaluates CmpAtoms against a backend with CSE and circuit fusion.

    `cache` is a WorkloadCache (engine/workload.py) mapping atom.key ->
    mask block entries; shared planner-wide (and, for workload batches,
    across planners), so group-by EQ masks, sort passes, repeated
    predicates and repeated *queries* all hit it.  Every lookup goes
    through the cache's noise-aware admission: the consumer's
    `need_levels` (downstream ct-ct products) is compared against the
    entry's remaining noise budget, so a mask cached by a shallow plan is
    refreshed (charged + counted) or re-derived before a deeper plan may
    consume it — never served blind.
    `fuse=True` stacks every pending atom of one circuit kind into a
    single batched call (cross-mask batching); `fuse=False` evaluates
    atom-at-a-time (each still column-batched over its own blocks).
    `shard_ctx` (engine/sharded.py) shards the stacked launches over the
    mesh data axis: flush() activates it on the backend so every fused
    circuit batch pads/places its lanes across the shards.
    """

    def __init__(self, db, bk, cache=None, fuse: bool = True, shard_ctx=None):
        from .workload import WorkloadCache
        self.db = db
        self.bk = bk
        # No shared cache (share_masks off): a private throwaway store —
        # CSE within this evaluator only, nothing outlives it.
        self.cache = cache if cache is not None else WorkloadCache()
        self.fuse = fuse
        self.shard_ctx = shard_ctx
        self._pending: dict[str, list] = {"eq": [], "lt": []}

    # ------------------------------------------------------------- intake
    def request(self, atom: CmpAtom,
                need_levels: int = DEFAULT_NEED_LEVELS) -> None:
        if self.cache.usable(self.bk, atom, need_levels):
            return
        pend = self._pending[atom.circuit]
        # Unfused mode models the pre-DAG schedule: no sharing at all,
        # duplicate occurrences re-run their circuits.
        if not self.fuse or all(atom.key != p.key for p in pend):
            pend.append(atom)

    def request_tree(self, node: MaskNode) -> None:
        for atom, need in node.atom_needs():
            self.request(atom, need)

    # --------------------------------------------------------------- eval
    def _z_blocks(self, atom: CmpAtom) -> list:
        """The cheap affine shift, column-batched: same op charges as the
        sub_scalar / sub_from_scalar / sub prelude of compare.py."""
        bk = self.bk
        table = self.db.tables[atom.table]
        blocks = table.col(atom.col).blocks
        x = bk.stack_blocks(blocks) if len(blocks) > 1 else blocks[0]
        if atom.rhs is not None:
            rblocks = table.col(atom.rhs).blocks
            y = bk.stack_blocks(rblocks) if len(rblocks) > 1 else rblocks[0]
            z = bk.sub(y, x) if atom.flip else bk.sub(x, y)
        elif atom.flip:
            z = bk.sub_from_scalar(atom.const, x)
        else:
            z = bk.sub_scalar(x, atom.const)
        return bk.unstack_blocks(z) if len(blocks) > 1 else [z]

    def _circuit(self, kind: str, x):
        return cmp.eq_zero(self.bk, x) if kind == "eq" else cmp.lt_zero(self.bk, x)

    def flush(self) -> None:
        """Run every pending circuit.  With fusion, all atoms of a kind
        share ONE stacked launch; op_log still charges one logical eq/cmp
        per atom so the baseline cost models see identical counts.
        Under a shard context the stacked launch is padded/placed over
        the mesh data axis (activation is reentrant, so flushes nested
        inside an already-activated executor run are no-ops here)."""
        bk = self.bk
        from .sharded import activate
        with activate(bk, self.shard_ctx):
            self._flush_inner()

    def _flush_inner(self) -> None:
        bk = self.bk
        for kind, atoms in self._pending.items():
            if not atoms:
                continue
            if not self.fuse or len(atoms) == 1:
                for atom in atoms:
                    zs = self._z_blocks(atom)
                    x = bk.stack_blocks(zs) if len(zs) > 1 else zs[0]
                    out = self._circuit(kind, x)
                    outs = bk.unstack_blocks(out) if len(zs) > 1 else [out]
                    self.cache.insert(bk, atom, outs)
                self._pending[kind] = []
                continue
            per_atom = [(atom, self._z_blocks(atom)) for atom in atoms]
            all_blocks = [b for _, zs in per_atom for b in zs]
            if len(all_blocks) == 1:
                out_blocks = [self._circuit(kind, all_blocks[0])]
            else:
                out = self._circuit(kind, bk.stack_blocks(all_blocks))
                out_blocks = bk.unstack_blocks(out)
            if hasattr(bk, "op_log"):     # one logical circuit per atom
                bk.op_log["eq" if kind == "eq" else "cmp"] += len(atoms) - 1
            i = 0
            for atom, zs in per_atom:
                self.cache.insert(bk, atom, out_blocks[i : i + len(zs)])
                i += len(zs)
            self._pending[kind] = []

    def get(self, atom: CmpAtom,
            need_levels: int = DEFAULT_NEED_LEVELS) -> list:
        """Fetch an atom's mask through noise-aware admission: a cached
        entry is served only if its blocks can still absorb `need_levels`
        products (or as much as a fresh derivation could); otherwise the
        cache refreshes it at admission or drops it for re-derivation."""
        blocks = self.cache.serve(self.bk, atom, need_levels)
        if blocks is None:
            self.request(atom, need_levels)
            self.flush()
            blocks = self.cache.serve(self.bk, atom, need_levels)
        return blocks

    # ------------------------------------------------- group-by EQ masks
    def eq_masks(self, table: EncryptedTable, col: str, values,
                 need_levels: int = DEFAULT_NEED_LEVELS) -> list:
        """Memoized per-value EQ masks (GROUP BY / ORDER BY dictionary
        enumeration), fused into one launch per flush."""
        atoms = [CmpAtom(table.name, col, "eq", int(v)) for v in values]
        for atom in atoms:
            self.request(atom, need_levels)
        self.flush()
        return [(int(v), self.get(atom, need_levels))
                for v, atom in zip(values, atoms)]


# ---------------------------------------------------------------------------
# Mask-tree execution (optimized regime: R1 isolation + R2 balanced trees).
# ---------------------------------------------------------------------------

def run_mask_node(node: MaskNode, ev: AtomEvaluator, planner) -> list:
    """Execute a lowered tree bottom-up against pre-evaluated atoms.
    Combiners reproduce the legacy optimized circuits exactly (balanced
    mul/or trees, batched negation)."""
    from . import ops
    bk = ev.bk
    if node.kind == "pred":
        return _run_pred(node.pred, ev, node.downstream_muls)
    if node.kind == "not":
        return ops.not_mask(bk, run_mask_node(node.children[0], ev, planner))
    if node.kind == "translated":
        parent_mask = run_mask_node(node.children[0], ev, planner)
        assert len(parent_mask) == 1, "translated: single-block parent"
        child = ev.db.tables[node.hop.child]
        nparent = ev.db.tables[node.hop.parent].nrows
        need = planner.translate_levels(node.downstream_muls)
        return ops.translate_mask_down(bk, parent_mask[0], child, node.hop.fk,
                                       nparent, need_levels=need,
                                       eq_cache=ev.cache)
    kids = [run_mask_node(c, ev, planner) for c in node.children]
    # Noise-aware combine ordering: pair shallow masks first so the deep
    # legs (translated joins) enter the balanced tree as late as possible
    # — same depth, strictly less noise than arbitrary pairing.
    kids.sort(key=lambda m: bk.depth(m[0]))
    if node.kind == "and":
        return ops.and_masks(bk, kids)
    return ops.or_masks(bk, kids)


def _run_pred(prog: PredProgram, ev: AtomEvaluator,
              downstream_muls: int = DEFAULT_NEED_LEVELS) -> list:
    from . import ops
    bk = ev.bk
    if prog.combine == "zero":                      # empty IN set: all-zero
        blocks = ev.db.tables[prog.table].col(prog.col).blocks
        x, batched = ops._stacked(bk, blocks)
        return ops._unstacked(bk, bk.mul_scalar(x, 0), batched)
    # BETWEEN's legs absorb the in-predicate products on top of the
    # tree-level downstream count (mirrors MaskNode.atom_needs).
    need = downstream_muls + (len(prog.atoms) - 1 if prog.combine == "mul" else 0)
    parts = []
    for atom, neg in zip(prog.atoms, prog.negs):
        m = ev.get(atom, need)
        parts.append(ops.not_mask(bk, m) if neg else m)
    if prog.combine == "one":
        return parts[0]
    if prog.combine == "mul":                       # BETWEEN
        out = parts[0]
        for nxt in parts[1:]:
            out = ops.mul_lists(bk, out, nxt)
        return out
    # 'sum' — IN: balanced addition tree over stacked masks (Eq. 6).
    nblocks = len(parts[0])
    stacked = ([p[0] for p in parts] if nblocks == 1
               else [bk.stack_blocks(p) for p in parts])
    out = cmp.add_tree(bk, stacked)
    return bk.unstack_blocks(out) if nblocks > 1 else [out]
