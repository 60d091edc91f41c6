"""Physical scan-first operators (paper §4.2).

Every operator maps over the ciphertext blocks of a column — there is no
positional access (Table 1).  All functions take the backend `bk` first
and work identically on BFVBackend and MockBackend.

Column-at-a-time execution: operators stack a column's block list into
one batched handle (`bk.stack_blocks`), run the circuit once — the
comparison circuits in core/compare.py are backend-polymorphic, so a
single pass evaluates every block through one batched call per primitive
— and unstack at the boundary.  Blocks share an op history, so OpStats
and the planner's noise/depth model are identical to the per-block loop;
singleton columns skip the batch layer entirely.

Cross-mask batching extends this across *columns*: distinct comparison
circuits of one query fuse into a single stacked launch per circuit
shape (engine/physical.py), and the per-key join EQs of
translate/fk_masks fuse the same way (`_per_key_eq`).

Masks are lists of blocks of encrypted {0,1}; aggregates are single
ciphertexts with the result replicated in every slot (the paper's
fixed-size output leakage).
"""
from __future__ import annotations

import numpy as np

from ..core import compare as cmp
from .plan import Factor, Pred
from .storage import EncryptedColumn, EncryptedTable


# ---------------------------------------------------------------------------
# Block-batch plumbing.
# ---------------------------------------------------------------------------

def _stacked(bk, blocks: list):
    """Stack a block list for one batched call; singletons pass through."""
    if len(blocks) == 1:
        return blocks[0], False
    return bk.stack_blocks(blocks), True


def _unstacked(bk, out, batched: bool) -> list:
    return bk.unstack_blocks(out) if batched else [out]


def mul_lists(bk, xs: list, ys: list) -> list:
    """Blockwise ct x ct product of two aligned block lists."""
    x, batched = _stacked(bk, xs)
    y, _ = _stacked(bk, ys)
    return _unstacked(bk, bk.mul(x, y), batched)


# ---------------------------------------------------------------------------
# Predicate masks.
# ---------------------------------------------------------------------------

def _scalar_cmp(bk, ct, op: str, v) -> object:
    if op == "=":
        return cmp.eq_scalar(bk, ct, v)
    if op == "!=":
        return cmp.not_(bk, cmp.eq_scalar(bk, ct, v))
    if op == "<":
        return cmp.lt_scalar(bk, ct, v)
    if op == ">":
        return cmp.gt_scalar(bk, ct, v)
    if op == "<=":
        return cmp.le_scalar(bk, ct, v)
    if op == ">=":
        return cmp.ge_scalar(bk, ct, v)
    if op == "between":
        lo, hi = v
        return cmp.between_scalar(bk, ct, lo, hi)
    if op == "in":
        if not v:
            return bk.mul_scalar(ct, 0)    # empty set: all-zero mask
        return cmp.in_set(bk, ct, v)
    raise ValueError(op)


def _col_cmp(bk, ct_l, op: str, ct_r) -> object:
    z = bk.sub(ct_l, ct_r)
    if op == "=":
        return cmp.eq_zero(bk, z)
    if op == "!=":
        return cmp.not_(bk, cmp.eq_zero(bk, z))
    if op == "<":
        return cmp.lt_zero(bk, z)
    if op == ">":
        return cmp.lt_zero(bk, bk.neg(z))
    if op == "<=":
        return cmp.not_(bk, cmp.lt_zero(bk, bk.neg(z)))
    if op == ">=":
        return cmp.not_(bk, cmp.lt_zero(bk, z))
    raise ValueError(op)


def pred_mask(bk, table: EncryptedTable, pred: Pred, col_override=None) -> list:
    """Evaluate one predicate over every block of its column(s) — the
    whole column runs through one batched comparison circuit.

    col_override substitutes pre-masked blocks (the unoptimized pipeline
    evaluates comparisons on filtered columns — that is the point)."""
    col = table.col(pred.col)
    blocks = col_override if col_override is not None else col.blocks
    if pred.rhs_col is not None:
        rhs = table.col(pred.rhs_col).blocks
        lhs_b, batched = _stacked(bk, blocks)
        rhs_b, _ = _stacked(bk, rhs)
        return _unstacked(bk, _col_cmp(bk, lhs_b, pred.op, rhs_b), batched)
    spec = col.spec
    if pred.op == "between":
        v = (spec.encode_scalar(pred.value[0]), spec.encode_scalar(pred.value[1]))
    elif pred.op == "in":
        v = [spec.encode_scalar(x) for x in pred.value]
    else:
        v = spec.encode_scalar(pred.value)
    x, batched = _stacked(bk, blocks)
    return _unstacked(bk, _scalar_cmp(bk, x, pred.op, v), batched)


# ---------------------------------------------------------------------------
# Mask algebra (blockwise).
# ---------------------------------------------------------------------------

def and_masks(bk, masks: list[list]) -> list:
    """Balanced product tree per block (R2 / §4.3.1), all blocks batched."""
    if len(masks[0]) == 1:
        return [cmp.mul_tree(bk, [m[0] for m in masks])]
    stacked = [bk.stack_blocks(m) for m in masks]
    return bk.unstack_blocks(cmp.mul_tree(bk, stacked))


def _chain_lists(bk, lists: list[list], combine) -> list:
    """Sequential pairwise combine of block lists, stacking each column
    once up front (not per step) and unstacking once at the end."""
    if len(lists[0]) == 1:
        out = lists[0][0]
        for m in lists[1:]:
            out = combine(out, m[0])
        return [out]
    stacked = [bk.stack_blocks(m) for m in lists]
    out = stacked[0]
    for m in stacked[1:]:
        out = combine(out, m)
    return bk.unstack_blocks(out)


def and_masks_seq(bk, masks: list[list]) -> list:
    """Sequential chain — the unoptimized baseline."""
    return _chain_lists(bk, masks, bk.mul)


def or_masks_seq(bk, masks: list[list]) -> list:
    """Sequential OR chain — the unoptimized baseline."""
    return _chain_lists(bk, masks, lambda a, b: cmp.or_(bk, a, b))


def or_masks(bk, masks: list[list]) -> list:
    if len(masks[0]) == 1:
        stacked = [m[0] for m in masks]
    else:
        stacked = [bk.stack_blocks(m) for m in masks]
    layer = stacked
    while len(layer) > 1:
        nxt = [cmp.or_(bk, layer[i], layer[i + 1]) for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return _unstacked(bk, layer[0], len(masks[0]) > 1)


def not_mask(bk, mask: list) -> list:
    x, batched = _stacked(bk, mask)
    return _unstacked(bk, cmp.not_(bk, x), batched)


def apply_validity(bk, mask: list, table: EncryptedTable) -> list:
    """Zero out the padding slots of the last block (plaintext multiply —
    row counts are public metadata)."""
    out = list(mask)
    v = table.validity(table.nblocks - 1)
    if v is not None:
        out[-1] = bk.mul_plain(out[-1], v)
    return out


def mask_columns(bk, blocks: list, mask: list) -> list:
    """Filter a column: col x mask (the SELECT of Eq. 5)."""
    return mul_lists(bk, blocks, mask)


# ---------------------------------------------------------------------------
# Aggregation (paper §4.2.2).
# ---------------------------------------------------------------------------

def expr_blocks(bk, table: EncryptedTable, factors: tuple, masked: dict | None = None) -> list:
    """Product of affine column factors: prod_f (f.add + f.mult * col_f)."""
    assert factors
    per_factor = []
    batched = False
    for f in factors:
        src = (masked or {}).get(f.col) if masked else None
        blocks = src if src is not None else table.col(f.col).blocks
        x, batched = _stacked(bk, blocks)
        if f.mult != 1:
            x = bk.mul_scalar(x, f.mult)
        if f.add != 0:
            x = bk.add_scalar(x, f.add)
        per_factor.append(x)
    out = per_factor[0]
    for nxt in per_factor[1:]:
        out = bk.mul(out, nxt)
    return _unstacked(bk, out, batched)


def reduce_blocks(bk, blocks: list) -> object:
    """Sum across blocks then rotate-reduce within the ciphertext: the
    doubling pattern of §4.2.2 COUNT/SUM — result in every slot."""
    if len(blocks) == 1:
        acc = blocks[0]
    else:
        acc = bk.fold_blocks(bk.stack_blocks(blocks))
    return bk.sum_slots(acc)


# One level per ct-ct product the mask still has to absorb, plus one
# level of slack for the fold/sum_slots add-and-rotate tail, whose noise
# is real but below a full multiplicative level.  Without the slack,
# edge-of-budget plans (Q19 optimized at depth 24 on a 25-level budget)
# decrypt ~1.4 bits past the budget.
INJECT_ADMIT_SLACK = 1


def admit_inject(bk, mask: list, muls: int = 1) -> list:
    """Decrypt-headroom admission where a mask enters an aggregation
    tail: past here it absorbs `muls` ct-ct products plus the reduction
    slop, so a lane that cannot take muls+1 more levels pays its planned
    refresh now instead of decrypting past the budget.  A no-op whenever
    the plan fits — the static verifier (engine/verify.py) proves every
    decrypt boundary positive.

    The top-up is noise maintenance, not a new encryption epoch, so the
    handle keeps its multiplicative chain length: whether the admission
    fires depends on the launch layout (fused CSE, per-block derivation
    and the legacy bodies reach here with slightly different noise), and
    depth accounting must not."""
    out = []
    for b in mask:
        d0 = bk.depth(b)
        b = bk.ensure_levels(b, muls + INJECT_ADMIT_SLACK)
        if bk.depth(b) < d0:
            bk.set_depth(b, d0)
        out.append(b)
    return out


def masked_sum(bk, value_blocks: list, mask: list) -> object:
    bk.op_log["sum"] += 1
    mask = admit_inject(bk, mask)
    return reduce_blocks(bk, mask_columns(bk, value_blocks, mask))


def count(bk, mask: list) -> object:
    bk.op_log["count"] += 1
    mask = admit_inject(bk, mask, muls=0)
    return reduce_blocks(bk, mask)


def partial_sums(bk, value_blocks: list, mask: list, chunk: int) -> list:
    """Exact-sum variant (beyond-paper): stop the rotate-reduce early so
    each ciphertext carries n/chunk partial sums that the client combines
    exactly — avoids mod-t wraparound for big aggregates at *fewer*
    rotations than the full reduction."""
    mask = admit_inject(bk, mask)
    filtered = mask_columns(bk, value_blocks, mask)
    out, batched = _stacked(bk, filtered)
    step = 1
    while step < chunk:
        out = bk.add(out, bk.rotate(out, step))
        step *= 2
    return _unstacked(bk, out, batched)


# ---------------------------------------------------------------------------
# Join / group-by machinery (paper §4.2.2, Fig. 2).
# ---------------------------------------------------------------------------

def group_masks(bk, table: EncryptedTable, col: str, domain: list[int]) -> list[tuple[int, list]]:
    """One EQ mask per distinct value — GROUP BY (§4.2.2) and ORDER BY
    (§4.2.3, enumerate the dictionary in order)."""
    x, batched = _stacked(bk, table.col(col).blocks)
    return [(v, _unstacked(bk, cmp.eq_scalar(bk, x, int(v)), batched)) for v in domain]


def sort_column(bk, table: EncryptedTable, col: str, domain: list[int],
                descending: bool = False, mask_provider=None):
    """Homomorphic ORDER BY (§4.2.3): reconstruct the column as an
    encrypted *sorted sequence*, scanning the domain in order.

    For each value v (ascending): its encrypted count c_v places |c_v|
    copies of v at slots [P_{v-1}, P_v) where P is the running prefix sum
    — realized as plaintext-slot-index comparisons against the encrypted
    prefix:  slot i holds v  iff  P_{v-1} <= i < P_v.  Fixed |D| domain
    iterations regardless of data (the §3 leakage argument: value
    frequencies stay hidden inside the comparisons).

    Cost: |D| x (1 EQ + aggregation + 2 comparisons) — Table 2's
    O(|D| * n/S) scan behaviour.  Single-block columns only (the paper's
    32K-row setting).

    mask_provider, if given, maps a domain value to its EQ mask block
    list — the planner passes its memoized/fused per-value EQ cache so a
    sort after a GROUP BY on the same column re-evaluates nothing."""
    assert table.nblocks == 1, "sort_column: single-block reconstruction"
    S = bk.slots
    idx = np.arange(S, dtype=np.int64)        # plaintext slot indices 0..S-1
    order = sorted(domain, reverse=descending)
    prefix = None                             # encrypted running count
    out = None
    for v in order:
        if mask_provider is not None:
            mask = list(mask_provider(int(v)))
        else:
            mask = [cmp.eq_scalar(bk, ct, int(v)) for ct in table.col(col).blocks]
        mask = apply_validity(bk, mask, table)
        c_v = count(bk, mask)                 # count in every slot
        new_prefix = c_v if prefix is None else bk.add(prefix, c_v)
        # prefix sits ~eq_depth deep and each placement costs ~lt_depth
        # more: planned refresh (i* infeasible branch), once per value.
        new_prefix = bk.ensure_levels(new_prefix, _eqd(bk.t) + 4)
        # slot i gets v  iff  prefix_{v-1} <= i  AND  i < prefix_v
        # i < P  <=>  0 < P - i  <=>  GT(P - i, 0); P-i in centered range.
        lo_ok = (cmp.not_(bk, cmp.lt_zero(bk, bk.add_plain(bk.neg(prefix), idx)))
                 if prefix is not None else None)   # i >= P_{v-1}
        hi_ct = bk.add_plain(bk.neg(new_prefix), idx)       # i - P_v
        hi_ok = cmp.lt_zero(bk, hi_ct)                      # i < P_v
        pos = hi_ok if lo_ok is None else bk.mul(lo_ok, hi_ok)
        term = bk.mul_scalar(pos, int(v))
        out = term if out is None else bk.add(out, term)
        prefix = new_prefix
    return out


def _per_key_eq(bk, fact_blocks: list, nparent: int) -> list[list]:
    """EQ(fk, j+1) for every dense parent key — all nparent circuits run
    in ONE cross-mask batched launch (the per-key square chains share a
    shape, so the scheduler stacks them like any other fused atoms).
    op_log still charges one logical EQ per key; per-block OpStats and
    noise are identical to the per-key loop."""
    x, batched = _stacked(bk, fact_blocks)
    nb = len(fact_blocks)
    zs = []
    for j in range(nparent):
        z = bk.sub_scalar(x, j + 1)
        zs.extend(bk.unstack_blocks(z) if batched else [z])
    if len(zs) == 1:
        flat = [cmp.eq_zero(bk, zs[0])]
    else:
        flat = bk.unstack_blocks(cmp.eq_zero(bk, bk.stack_blocks(zs)))
        if hasattr(bk, "op_log"):
            bk.op_log["eq"] += nparent - 1
    return [flat[j * nb : (j + 1) * nb] for j in range(nparent)]


def fk_masks(bk, table: EncryptedTable, fk: str, nparent: int,
             eq_cache=None) -> list[list]:
    """EQ masks for every dense parent key 1..nparent (JOIN step 2).

    With an `eq_cache` (a WorkloadCache), the whole per-key bank is
    memoized on (child table, fk, nparent): repeated FK translations —
    several hops over one fk within a query, or the same join across a
    workload's queries — stop re-running nparent EQ circuits."""
    if eq_cache is not None:
        bank = eq_cache.fk_lookup(bk, table.name, fk, nparent)
        if bank is None:
            bank = _per_key_eq(bk, table.col(fk).blocks, nparent)
            eq_cache.fk_store(bk, table.name, fk, nparent, bank)
        return bank
    return _per_key_eq(bk, table.col(fk).blocks, nparent)


def pack_scalars(bk, scalar_cts: list) -> object:
    """Pack per-key scalar ciphertexts (value in every slot) into one
    ciphertext with value j at slot j: sum_j ct_j x basis_j."""
    S = bk.slots
    acc = None
    for j, ct in enumerate(scalar_cts):
        basis = np.zeros(S, dtype=np.int64)
        basis[j] = 1
        term = bk.mul_plain(ct, basis)
        acc = term if acc is None else bk.add(acc, term)
    return acc


from .plan import eq_depth as _eqd


def translate_mask_down(bk, parent_mask_block, fact_table: EncryptedTable,
                        fk: str, nparent: int, fk_override: list | None = None,
                        need_levels: int = 6, eq_cache=None) -> list:
    """Push a parent-row mask through an FK: child_mask[r] =
    parent_mask[key(r)].  Per parent key: Extract+Broadcast the mask bit,
    EQ the fk column, multiply, accumulate (Fig. 2 steps 1-3).
    Cost O(nparent * nblocks) ops — Table 2's JOIN row.

    The fk column is stacked once and every per-key EQ runs batched over
    all its blocks; the broadcast mask bit joins by broadcasting into the
    batch (single x batch products are supported by both backends).

    The parent mask is refreshed *once* here if it cannot absorb the hop
    (planned, not per-key: the i* model's pay-one-bootstrap branch).

    fk_override substitutes pre-masked fk blocks: the unoptimized pipeline
    joins over already-filtered columns (Fig. 3(a)'s deep chains).

    need_levels sizes the planned refresh: the compiled-DAG scheduler
    passes 2 (translate internals) + the IR-counted downstream mask
    products, clamped by the i* rule; the legacy default of 6 matches
    the hand-written query bodies.

    eq_cache memoizes the per-key EQ bank (see fk_masks); it is skipped
    under fk_override — pre-masked fk columns are data-dependent and
    must not be shared."""
    parent_mask_block = bk.ensure_levels(parent_mask_block, need_levels)
    if fk_override is not None:
        return _translate_down(bk, parent_mask_block, fk_override, nparent)
    fact_blocks = fact_table.col(fk).blocks
    per_key = (fk_masks(bk, fact_table, fk, nparent, eq_cache)
               if eq_cache is not None else None)
    return _translate_down(bk, parent_mask_block, fact_blocks, nparent, per_key)


def translate_values_down(bk, packed_values, fact_table: EncryptedTable,
                          fk: str, nparent: int) -> list:
    """Pull per-parent values (packed: value_j at slot j) down to child
    rows: child_val[r] = value[key(r)].  Used by correlated subqueries
    (Q17's per-part AVG)."""
    packed_values = bk.ensure_levels(packed_values, 6)
    return _translate_down(bk, packed_values, fact_table.col(fk).blocks, nparent)


def broadcast_slots(bk, packed, idxs) -> list:
    """Fused broadcast_slot: extract+replicate many slots of one packed
    ciphertext in a single stacked launch.

    The per-slot loop (`bk.broadcast_slot` per key) pays one mul_plain
    plus a full log2(n) rotate-add reduction *per key* — it dominated
    translate launch counts.  Stacking nparent copies of `packed`
    against an (nparent, slots) one-hot basis matrix runs the same ops
    on every lane of one batch: identical per-block op counts, noise
    and depth, ~nparent x fewer launches.  The batch runs in lane chunks
    (`bk.map_lanes`), each against its rows of the basis."""
    idxs = list(idxs)
    if len(idxs) == 1:
        return [bk.broadcast_slot(packed, int(idxs[0]))]
    basis = np.zeros((len(idxs), bk.slots), dtype=np.int64)
    basis[np.arange(len(idxs)), np.asarray(idxs, dtype=np.int64)] = 1
    batch = bk.stack_blocks([packed] * len(idxs))
    out = bk.map_lanes(lambda b, lanes: bk.sum_slots(bk.mul_plain(b, basis[lanes])),
                       batch, cmp.POW_HELD, "broadcast")
    return bk.unstack_blocks(out)


def _translate_down(bk, packed, fact_blocks: list, nparent: int,
                    per_key: list | None = None) -> list:
    """Shared FK scatter: sum_j EQ(fk, j+1) x broadcast(packed, j).
    The nparent per-key EQ circuits run in one fused launch (or arrive
    pre-evaluated from the workload cache's fk bank), and the nparent
    slot broadcasts of `packed` fuse into one stacked launch too."""
    batched = len(fact_blocks) > 1
    if per_key is None:
        per_key = _per_key_eq(bk, fact_blocks, nparent)
    pjs = broadcast_slots(bk, packed, range(nparent))  # encrypted bits/values
    out = None
    for j in range(nparent):
        e = bk.stack_blocks(per_key[j]) if batched else per_key[j][0]
        term = bk.mul(e, pjs[j])
        out = term if out is None else bk.add(out, term)
    return _unstacked(bk, out, batched)


def join_aggregate(bk, fact_table: EncryptedTable, fk: str, nparent: int,
                   value_blocks: list | None, extra_mask: list | None = None) -> list:
    """Fused JOIN+aggregate (the paper's memory optimization): for each
    parent key j return SUM(value | fk = j [and mask]) — |P| scalar
    ciphertexts, never materializing the joined table."""
    results = []
    masks = fk_masks(bk, fact_table, fk, nparent)
    for j in range(nparent):
        m = masks[j]
        if extra_mask is not None:
            m = mul_lists(bk, m, extra_mask)
        if value_blocks is None:
            results.append(count(bk, m))
        else:
            results.append(masked_sum(bk, value_blocks, m))
    return results
