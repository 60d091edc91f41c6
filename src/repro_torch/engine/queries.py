"""The paper's nine TPC-H benchmark queries (§5.1): Q1, 4, 5, 6, 8, 12,
14, 17, 19 — scan+aggregation, multi-way equi-joins, semi-/nested joins
and complex predicates.

Each query has:
  plan_qN()            declarative QueryPlan (drives the depth model and,
                       for the ported queries, compiled-DAG execution)
  run_qN(planner, ...) encrypted execution composed from engine.ops —
                       kept verbatim as the parity oracle for the
                       compiled path
  oracle_qN(db, ...)   plaintext reference (numpy over the client shadow
                       copies) returning the same mod-t values

Q1, Q6, Q12 and Q19 additionally execute through the physical operator
DAG: `run_via_plan(planner, plan_qN())` (engine/executor.py) lowers the
plan, fuses comparison circuits across columns, reuses mask subgraphs
via CSE, and must decrypt to exactly the same result as `run_qN`.

Aggregate results follow the paper's conventions: AVG is returned as a
(SUM, COUNT) pair; fixed-point scales multiply through products and the
client rescales after decryption; sums are mod-t (the engine also offers
ops.partial_sums for exact client-side reconstruction — see DESIGN.md).
"""
from __future__ import annotations

import numpy as np

from ..core import compare as cmp
from . import ops
from .executor import run_via_plan  # noqa: F401  (re-exported: the DAG path)
from .plan import (Agg, And, AuxMask, Factor, JoinHop, Or, Pred, QueryPlan,
                   Translated)
from .planner import Planner
from .schema import date_to_int
from .storage import Database

D = date_to_int


def _dec(bk, ct) -> int:
    return int(bk.decrypt(ct)[0])


def _dec_pair(bk, pair):
    return (_dec(bk, pair[0]), _dec(bk, pair[1]))


def _dict_of(db: Database, table: str, col: str) -> dict:
    return db.tables[table].schema.col(col).dictionary


# ===========================================================================
# Q1 — pricing summary report (scan + multi-column GROUP BY + aggregates).
# ===========================================================================

def plan_q1() -> QueryPlan:
    return QueryPlan(
        name="Q1", fact="lineitem",
        where=Pred("l_shipdate", "<=", D("1998-09-02")),
        group_by="l_returnflag,l_linestatus", group_domain=6,
        aggs=(
            Agg("sum", (Factor("l_quantity"),), "sum_qty"),
            Agg("sum", (Factor("l_extendedprice"),), "sum_base_price"),
            Agg("sum", (Factor("l_extendedprice"), Factor("l_discount", -1, 100)),
                "sum_disc_price"),
            Agg("sum", (Factor("l_extendedprice"), Factor("l_discount", -1, 100),
                        Factor("l_tax", 1, 100)), "sum_charge"),
            Agg("avg", (Factor("l_quantity"),), "avg_qty"),
            Agg("avg", (Factor("l_extendedprice"),), "avg_price"),
            Agg("avg", (Factor("l_discount"),), "avg_disc"),
            Agg("count", (), "count_order"),
        ),
        order_by="l_returnflag,l_linestatus")


def run_q1(pl: Planner, cutoff: str = "1998-09-02") -> dict:
    bk, db = pl.bk, pl.db
    li = db.tables["lineitem"]
    where = pl.where_mask(li, Pred("l_shipdate", "<=", D(cutoff)))
    rf_dict = _dict_of(db, "lineitem", "l_returnflag")
    ls_dict = _dict_of(db, "lineitem", "l_linestatus")
    plan = plan_q1()
    out = {}
    # ORDER BY rf, ls == enumerate dictionaries in sorted order (§4.2.3).
    for rf_name, rf_id in sorted(rf_dict.items()):
        rf_mask = [cmp.eq_scalar(bk, ct, rf_id) for ct in li.col("l_returnflag").blocks]
        for ls_name, ls_id in sorted(ls_dict.items()):
            ls_mask = [cmp.eq_scalar(bk, ct, ls_id) for ct in li.col("l_linestatus").blocks]
            if pl.optimized:
                gmask = ops.and_masks(bk, [rf_mask, ls_mask, where])
            else:
                gmask = ops.and_masks_seq(bk, [where, rf_mask, ls_mask])
            gmask = ops.apply_validity(bk, gmask, li)
            row = {}
            for agg in plan.aggs:
                r = pl._agg_with_mask(li, agg, gmask)
                row[agg.name] = _dec_pair(bk, r) if agg.kind == "avg" else _dec(bk, r)
            out[(rf_name, ls_name)] = row
    return out


def oracle_q1(db: Database, cutoff: str = "1998-09-02") -> dict:
    t = db.bk.t
    li = db.plain["lineitem"]
    sel = li["l_shipdate"] <= D(cutoff)
    out = {}
    rf_dict = _dict_of(db, "lineitem", "l_returnflag")
    ls_dict = _dict_of(db, "lineitem", "l_linestatus")
    for rf_name, rf_id in sorted(rf_dict.items()):
        for ls_name, ls_id in sorted(ls_dict.items()):
            m = sel & (li["l_returnflag"] == rf_id) & (li["l_linestatus"] == ls_id)
            price, qty = li["l_extendedprice"][m], li["l_quantity"][m]
            disc, tax = li["l_discount"][m], li["l_tax"][m]
            cnt = int(m.sum())
            out[(rf_name, ls_name)] = {
                "sum_qty": int(qty.sum()) % t,
                "sum_base_price": int(price.sum()) % t,
                "sum_disc_price": int((price * (100 - disc)).sum()) % t,
                "sum_charge": int((price * (100 - disc) % t * (100 + tax)).sum()) % t,
                "avg_qty": (int(qty.sum()) % t, cnt % t),
                "avg_price": (int(price.sum()) % t, cnt % t),
                "avg_disc": (int(disc.sum()) % t, cnt % t),
                "count_order": cnt % t,
            }
    return out


# ===========================================================================
# Q6 — forecasting revenue change (pure scan, the paper's Table 5 query).
# ===========================================================================

def plan_q6() -> QueryPlan:
    return QueryPlan(
        name="Q6", fact="lineitem",
        where=And((
            Pred("l_shipdate", ">=", D("1994-01-01")),
            Pred("l_shipdate", "<", D("1995-01-01")),
            Pred("l_discount", "between", (0.05, 0.07)),
            Pred("l_quantity", "<", 24),
        )),
        aggs=(Agg("sum", (Factor("l_extendedprice"), Factor("l_discount")), "revenue"),))


def run_q6(pl: Planner, year: int = 1994, disc=(0.05, 0.07), qty: int = 24) -> dict:
    bk, db = pl.bk, pl.db
    li = db.tables["lineitem"]
    expr = And((
        Pred("l_shipdate", ">=", D(f"{year}-01-01")),
        Pred("l_shipdate", "<", D(f"{year + 1}-01-01")),
        Pred("l_discount", "between", disc),
        Pred("l_quantity", "<", qty),
    ))
    mask = pl.where_mask(li, expr)
    rev = pl.aggregate(li, Agg("sum", (Factor("l_extendedprice"),
                                       Factor("l_discount")), "revenue"), mask)
    return {"revenue": _dec(bk, rev)}


def oracle_q6(db: Database, year: int = 1994, disc=(0.05, 0.07), qty: int = 24) -> dict:
    t = db.bk.t
    li = db.plain["lineitem"]
    lo, hi = int(round(disc[0] * 100)), int(round(disc[1] * 100))
    m = ((li["l_shipdate"] >= D(f"{year}-01-01"))
         & (li["l_shipdate"] < D(f"{year + 1}-01-01"))
         & (li["l_discount"] >= lo) & (li["l_discount"] <= hi)
         & (li["l_quantity"] < qty))
    return {"revenue": int((li["l_extendedprice"][m] * li["l_discount"][m]).sum()) % t}


# ===========================================================================
# Q4 — order priority checking (EXISTS semi-join).
# ===========================================================================

def plan_q4() -> QueryPlan:
    return QueryPlan(
        name="Q4", fact="orders",
        where=And((Pred("o_orderdate", ">=", D("1993-07-01")),
                   Pred("o_orderdate", "<", D("1993-10-01")))),
        hops=(JoinHop("orders", "l_orderkey", "lineitem"),),
        group_by="o_orderpriority", group_domain=5,
        aggs=(Agg("count", (), "order_count"),),
        correlated=True)


def run_q4(pl: Planner, d0: str = "1993-07-01", d1: str = "1993-10-01") -> dict:
    bk, db = pl.bk, pl.db
    orders, li = db.tables["orders"], db.tables["lineitem"]
    norders = orders.nrows
    assert norders <= bk.slots, "Q4 packs per-order counts into one ciphertext"
    # EXISTS(lineitem: commit < receipt, same order) as a per-order count.
    late = ops.pred_mask(bk, li, Pred("l_commitdate", "<", rhs_col="l_receiptdate"))
    late = ops.apply_validity(bk, late, li)
    counts = ops.join_aggregate(bk, li, "l_orderkey", norders, None, extra_mask=late)
    packed = ops.pack_scalars(bk, counts)
    # The packed counts sit ~eq_depth deep; the GT circuit needs ~eq_depth
    # more.  The planner injects one refresh here if the budget cannot
    # carry both (mask-injection tuning's "pay one bootstrap" branch).
    from .plan import lt_depth
    packed = bk.ensure_levels(packed, lt_depth(bk.t) + 2)
    exists = [cmp.gt_scalar(bk, packed, 0)]        # aligned with orders block 0
    date = pl.where_mask(orders, And((Pred("o_orderdate", ">=", D(d0)),
                                      Pred("o_orderdate", "<", D(d1)))))
    if pl.optimized:
        mask = ops.and_masks(bk, [exists, date])
    else:
        mask = ops.and_masks_seq(bk, [date, exists])
    out = {}
    pr_dict = _dict_of(db, "orders", "o_orderpriority")
    res = pl.group_aggregate(orders, "o_orderpriority",
                             [pr_dict[k] for k in sorted(pr_dict)],
                             (Agg("count", (), "order_count"),), mask)
    for name, pid in sorted(pr_dict.items()):
        out[name] = {"order_count": _dec(bk, res[pid]["order_count"])}
    return out


def oracle_q4(db: Database, d0: str = "1993-07-01", d1: str = "1993-10-01") -> dict:
    t = db.bk.t
    o, li = db.plain["orders"], db.plain["lineitem"]
    late_orders = set(li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]].tolist())
    exists = np.isin(o["o_orderkey"], list(late_orders))
    date = (o["o_orderdate"] >= D(d0)) & (o["o_orderdate"] < D(d1))
    out = {}
    for name, pid in sorted(_dict_of(db, "orders", "o_orderpriority").items()):
        m = exists & date & (o["o_orderpriority"] == pid)
        out[name] = {"order_count": int(m.sum()) % t}
    return out


# ===========================================================================
# Q12 — shipping modes and order priority (join + CASE aggregation).
# ===========================================================================

def plan_q12() -> QueryPlan:
    hop = JoinHop("orders", "l_orderkey", "lineitem")
    return QueryPlan(
        name="Q12", fact="lineitem",
        where=And((Pred("l_shipmode", "in", ["MAIL", "SHIP"]),
                   Pred("l_commitdate", "<", rhs_col="l_receiptdate"),
                   Pred("l_shipdate", "<", rhs_col="l_commitdate"),
                   Pred("l_receiptdate", ">=", D("1994-01-01")),
                   Pred("l_receiptdate", "<", D("1995-01-01")))),
        hops=(hop,),
        group_by="l_shipmode", group_domain=2,
        # CASE aggregation: both counts partition on the translated
        # high-priority mask (the IN on l_shipmode doubles as the group
        # domain — the executor's group-pushdown rule).
        aggs=(Agg("count", (), "high_line_count", partition="high"),
              Agg("count", (), "low_line_count", partition="high",
                  negated=True)),
        aux_masks=(AuxMask("high", hop,
                           Pred("o_orderpriority", "in",
                                ["1-URGENT", "2-HIGH"])),))


def run_q12(pl: Planner, modes=("MAIL", "SHIP"), year: int = 1994) -> dict:
    bk, db = pl.bk, pl.db
    orders, li = db.tables["orders"], db.tables["lineitem"]
    pr_dict = _dict_of(db, "orders", "o_orderpriority")
    high_ids = [pr_dict[k] for k in ("1-URGENT", "2-HIGH") if k in pr_dict]
    # Priority mask computed on orders, pulled down to lineitem via the FK.
    high_orders = ops.pred_mask(bk, orders, Pred("o_orderpriority", "in",
                                                 [k for k in ("1-URGENT", "2-HIGH") if k in pr_dict]))
    assert orders.nblocks == 1
    where = pl.where_mask(li, And((
        Pred("l_commitdate", "<", rhs_col="l_receiptdate"),
        Pred("l_shipdate", "<", rhs_col="l_commitdate"),
        Pred("l_receiptdate", ">=", D(f"{year}-01-01")),
        Pred("l_receiptdate", "<", D(f"{year + 1}-01-01")))))
    where = ops.apply_validity(bk, where, li)
    # Unoptimized pipeline joins over the already-filtered fk column —
    # the Fig. 3(a) deep chain; the optimized plan joins the raw column.
    fk_ov = None if pl.optimized else ops.mask_columns(bk, li.col("l_orderkey").blocks, where)
    high_li = ops.translate_mask_down(bk, high_orders[0], li, "l_orderkey",
                                      orders.nrows, fk_override=fk_ov)
    sm_dict = _dict_of(db, "lineitem", "l_shipmode")
    out = {}
    for mode in modes:
        mmask = [cmp.eq_scalar(bk, ct, sm_dict[mode]) for ct in li.col("l_shipmode").blocks]
        if pl.optimized:
            base = ops.and_masks(bk, [mmask, where])
            hi = ops.and_masks(bk, [base, high_li])
        else:
            base = ops.and_masks_seq(bk, [where, mmask])
            hi = ops.and_masks_seq(bk, [base, high_li])
        lo = [bk.sub(b, h) for b, h in zip(base, hi)]     # low = base AND NOT high
        out[mode] = {"high_line_count": _dec(bk, ops.count(bk, hi)),
                     "low_line_count": _dec(bk, ops.count(bk, lo))}
    return out


def oracle_q12(db: Database, modes=("MAIL", "SHIP"), year: int = 1994) -> dict:
    t = db.bk.t
    o, li = db.plain["orders"], db.plain["lineitem"]
    pr_dict = _dict_of(db, "orders", "o_orderpriority")
    sm_dict = _dict_of(db, "lineitem", "l_shipmode")
    high_ids = {pr_dict[k] for k in ("1-URGENT", "2-HIGH") if k in pr_dict}
    order_high = np.isin(o["o_orderpriority"], list(high_ids))
    li_high = order_high[li["l_orderkey"] - 1]
    base = ((li["l_commitdate"] < li["l_receiptdate"])
            & (li["l_shipdate"] < li["l_commitdate"])
            & (li["l_receiptdate"] >= D(f"{year}-01-01"))
            & (li["l_receiptdate"] < D(f"{year + 1}-01-01")))
    out = {}
    for mode in modes:
        m = base & (li["l_shipmode"] == sm_dict[mode])
        out[mode] = {"high_line_count": int((m & li_high).sum()) % t,
                     "low_line_count": int((m & ~li_high).sum()) % t}
    return out


# ===========================================================================
# Q14 — promotion effect (2-way join + conditional aggregate).
# ===========================================================================

def plan_q14() -> QueryPlan:
    return QueryPlan(
        name="Q14", fact="lineitem",
        where=And((Pred("l_shipdate", ">=", D("1995-09-01")),
                   Pred("l_shipdate", "<", D("1995-10-01")))),
        hops=(JoinHop("part", "l_partkey", "lineitem",
                      parent_filter=Pred("p_type", "in", [])),),
        aggs=(Agg("sum", (Factor("l_extendedprice"), Factor("l_discount", -1, 100)),
                  "promo_revenue"),))


def run_q14(pl: Planner, d0: str = "1995-09-01", d1: str = "1995-10-01") -> dict:
    bk, db = pl.bk, pl.db
    part, li = db.tables["part"], db.tables["lineitem"]
    ty_dict = _dict_of(db, "part", "p_type")
    promo_ids = [v for k, v in ty_dict.items() if k.startswith("PROMO")]
    promo_part = ops.pred_mask(bk, part, Pred("p_type", "in",
                                              [k for k in ty_dict if k.startswith("PROMO")]))
    assert part.nblocks == 1
    date = pl.where_mask(li, And((Pred("l_shipdate", ">=", D(d0)),
                                  Pred("l_shipdate", "<", D(d1)))))
    date = ops.apply_validity(bk, date, li)
    fk_ov = None if pl.optimized else ops.mask_columns(bk, li.col("l_partkey").blocks, date)
    promo_li = ops.translate_mask_down(bk, promo_part[0], li, "l_partkey",
                                       part.nrows, fk_override=fk_ov)
    vals = ops.expr_blocks(bk, li, (Factor("l_extendedprice"), Factor("l_discount", -1, 100)))
    if pl.optimized:
        pm = ops.and_masks(bk, [promo_li, date])
    else:
        pm = ops.and_masks_seq(bk, [date, promo_li])
    return {"promo_revenue": _dec(bk, ops.masked_sum(bk, vals, pm)),
            "total_revenue": _dec(bk, ops.masked_sum(bk, vals, date))}


def oracle_q14(db: Database, d0: str = "1995-09-01", d1: str = "1995-10-01") -> dict:
    t = db.bk.t
    p, li = db.plain["part"], db.plain["lineitem"]
    ty_dict = _dict_of(db, "part", "p_type")
    promo_ids = {v for k, v in ty_dict.items() if k.startswith("PROMO")}
    part_promo = np.isin(p["p_type"], list(promo_ids))
    li_promo = part_promo[li["l_partkey"] - 1]
    date = (li["l_shipdate"] >= D(d0)) & (li["l_shipdate"] < D(d1))
    rev = li["l_extendedprice"] * (100 - li["l_discount"]) % t
    return {"promo_revenue": int(rev[date & li_promo].sum()) % t,
            "total_revenue": int(rev[date].sum()) % t}


# ===========================================================================
# Q19 — discounted revenue (three-branch disjunction of conjunctions).
# ===========================================================================

_Q19_BRANCHES = (
    dict(brand="Brand#12", containers=["SM BAG", "SM BOX", "SM CASE", "SM PACK"],
         qty=(1, 11), size=(1, 5)),
    dict(brand="Brand#23", containers=["MED BAG", "MED BOX", "MED JAR", "MED PACK"],
         qty=(10, 20), size=(1, 10)),
    dict(brand="Brand#34", containers=["LG BOX", "LG CASE", "LG PACK", "LG PKG"],
         qty=(20, 30), size=(1, 15)),
)


def plan_q19() -> QueryPlan:
    """The full three-branch disjunction as an executable IR tree: each
    branch's part-side conjunction sits under a Translated node (the
    l_partkey hop), ANDed with its lineitem quantity window; the common
    lineitem predicates join the disjunction at the top."""
    hop = JoinHop("part", "l_partkey", "lineitem")
    branches = []
    for br in _Q19_BRANCHES:
        part_expr = And((Pred("p_brand", "=", br["brand"]),
                         Pred("p_container", "in", br["containers"]),
                         Pred("p_size", "between", br["size"])))
        branches.append(And((Translated(hop, part_expr),
                             Pred("l_quantity", "between", br["qty"]))))
    return QueryPlan(
        name="Q19", fact="lineitem",
        where=And((Or(tuple(branches)),
                   Pred("l_shipmode", "in", ["AIR", "REG AIR"]),
                   Pred("l_shipinstruct", "=", "DELIVER IN PERSON"))),
        aggs=(Agg("sum", (Factor("l_extendedprice"), Factor("l_discount", -1, 100)),
                  "revenue"),))


def run_q19(pl: Planner) -> dict:
    bk, db = pl.bk, pl.db
    part, li = db.tables["part"], db.tables["lineitem"]
    assert part.nblocks == 1
    common = pl.where_mask(li, And((
        Pred("l_shipmode", "in", ["AIR", "REG AIR"]),
        Pred("l_shipinstruct", "=", "DELIVER IN PERSON"))))
    branch_masks = []
    for br in _Q19_BRANCHES:
        pmask = pl.where_mask(part, And((
            Pred("p_brand", "=", br["brand"]),
            Pred("p_container", "in", br["containers"]),
            Pred("p_size", "between", br["size"]))))
        down = ops.translate_mask_down(bk, pmask[0], li, "l_partkey", part.nrows)
        qmask = ops.pred_mask(bk, li, Pred("l_quantity", "between", br["qty"]))
        if pl.optimized:
            branch_masks.append(ops.and_masks(bk, [down, qmask]))
        else:
            branch_masks.append(ops.and_masks_seq(bk, [down, qmask]))
    disj = ops.or_masks(bk, branch_masks)
    full = (ops.and_masks(bk, [disj, common]) if pl.optimized
            else ops.and_masks_seq(bk, [disj, common]))
    full = ops.apply_validity(bk, full, li)
    vals = ops.expr_blocks(bk, li, (Factor("l_extendedprice"), Factor("l_discount", -1, 100)))
    return {"revenue": _dec(bk, ops.masked_sum(bk, vals, full))}


def oracle_q19(db: Database) -> dict:
    t = db.bk.t
    p, li = db.plain["part"], db.plain["lineitem"]
    br_d = _dict_of(db, "part", "p_brand")
    ct_d = _dict_of(db, "part", "p_container")
    sm_d = _dict_of(db, "lineitem", "l_shipmode")
    si_d = _dict_of(db, "lineitem", "l_shipinstruct")
    common = (np.isin(li["l_shipmode"], [sm_d.get("AIR", -1), sm_d.get("REG AIR", -1)])
              & (li["l_shipinstruct"] == si_d.get("DELIVER IN PERSON", -1)))
    disj = np.zeros(len(li["l_partkey"]), dtype=bool)
    for br in _Q19_BRANCHES:
        pm = ((p["p_brand"] == br_d.get(br["brand"], -1))
              & np.isin(p["p_container"], [ct_d.get(c, -1) for c in br["containers"]])
              & (p["p_size"] >= br["size"][0]) & (p["p_size"] <= br["size"][1]))
        lm = pm[li["l_partkey"] - 1] & (li["l_quantity"] >= br["qty"][0]) \
            & (li["l_quantity"] <= br["qty"][1])
        disj |= lm
    m = disj & common
    rev = li["l_extendedprice"] * (100 - li["l_discount"]) % t
    return {"revenue": int(rev[m].sum()) % t}


# ===========================================================================
# Q5 — local supplier volume (six-table join; paper runs it projected-only
# for the baselines).  Late injection: the region/nation membership bit is
# multiplied into the per-nation aggregate at the very end (R3, i* = m).
# ===========================================================================

def plan_q5() -> QueryPlan:
    return QueryPlan(
        name="Q5", fact="lineitem",
        where=And((Pred("o_orderdate", ">=", D("1994-01-01")),
                   Pred("o_orderdate", "<", D("1995-01-01")))),
        hops=(JoinHop("region", "n_regionkey", "nation",
                      parent_filter=Pred("r_name", "=", "ASIA")),
              JoinHop("nation", "s_nationkey", "supplier"),
              JoinHop("supplier", "l_suppkey", "lineitem"),
              JoinHop("orders", "l_orderkey", "lineitem")),
        group_by="n_name", group_domain=25,
        aggs=(Agg("sum", (Factor("l_extendedprice"), Factor("l_discount", -1, 100)),
                  "revenue"),))


def run_q5(pl: Planner, region: str = "ASIA", year: int = 1994) -> dict:
    bk, db = pl.bk, pl.db
    nation = db.tables["nation"]
    supplier, customer = db.tables["supplier"], db.tables["customer"]
    orders, li = db.tables["orders"], db.tables["lineitem"]
    r_dict = _dict_of(db, "region", "r_name")
    n_dict = _dict_of(db, "nation", "n_name")

    # Region membership, translated region -> nation (5 broadcasts).
    rmask = ops.pred_mask(bk, db.tables["region"], Pred("r_name", "=", region))
    asia_nation = ops.translate_mask_down(bk, rmask[0], nation, "n_regionkey", 5)

    # Date window on orders, translated down to lineitem rows.
    date = pl.where_mask(orders, And((Pred("o_orderdate", ">=", D(f"{year}-01-01")),
                                      Pred("o_orderdate", "<", D(f"{year + 1}-01-01")))))
    assert orders.nblocks == 1
    li_date = ops.translate_mask_down(bk, date[0], li, "l_orderkey", orders.nrows)

    # Customer-nation pulled to lineitem level through orders (two hops).
    o_custnat = ops.translate_values_down(
        bk, customer.col("c_nationkey").blocks[0], orders, "o_custkey", customer.nrows)
    li_custnat = ops.translate_values_down(bk, o_custnat[0], li, "l_orderkey", orders.nrows)
    # Supplier-nation pulled to lineitem level (one hop).
    li_suppnat = ops.translate_values_down(
        bk, supplier.col("s_nationkey").blocks[0], li, "l_suppkey", supplier.nrows)

    # The per-nation EQ below adds eq_depth on top of the translated value
    # columns: refresh them once here (planned) instead of per nation.
    from .plan import eq_depth
    need = eq_depth(bk.t) + 4
    li_custnat = [bk.ensure_levels(x, need) for x in li_custnat]
    li_suppnat = [bk.ensure_levels(x, need) for x in li_suppnat]

    vals = ops.expr_blocks(bk, li, (Factor("l_extendedprice"), Factor("l_discount", -1, 100)))
    out = {}
    for name, nid in sorted(n_dict.items()):
        supp_eq = [cmp.eq_scalar(bk, ct, nid) for ct in li_suppnat]
        cust_eq = [cmp.eq_scalar(bk, ct, nid) for ct in li_custnat]
        if pl.optimized:
            m = ops.and_masks(bk, [supp_eq, cust_eq, li_date])
        else:
            m = ops.and_masks_seq(bk, [li_date, supp_eq, cust_eq])
        m = ops.apply_validity(bk, m, li)
        # R3 late injection with the i* decision: inject the encrypted
        # "nation in region" bit on the aggregate (1 mul) when the budget
        # allows, else one level earlier on the mask (nblocks muls) —
        # extra multiplications are cheaper than a refresh (§4.3.2).
        bit = bk.broadcast_slot(asia_nation[0], nid - 1)
        rev = ops.masked_sum(bk, vals, m)
        if bk.levels_left(rev) >= 1:
            rev = bk.mul(rev, bit)
        else:
            m = [bk.mul(x, bit) for x in m]
            rev = ops.masked_sum(bk, vals, m)
        out[name] = {"revenue": _dec(bk, rev)}
    return out


def oracle_q5(db: Database, region: str = "ASIA", year: int = 1994) -> dict:
    t = db.bk.t
    r, n = db.plain["region"], db.plain["nation"]
    s, c = db.plain["supplier"], db.plain["customer"]
    o, li = db.plain["orders"], db.plain["lineitem"]
    r_dict = _dict_of(db, "region", "r_name")
    n_dict = _dict_of(db, "nation", "n_name")
    rid = r_dict[region]
    asia_nations = set((n["n_nationkey"][n["n_regionkey"] == rid]).tolist())
    date_ok = (o["o_orderdate"] >= D(f"{year}-01-01")) & (o["o_orderdate"] < D(f"{year + 1}-01-01"))
    li_date = date_ok[li["l_orderkey"] - 1]
    li_custnat = c["c_nationkey"][o["o_custkey"][li["l_orderkey"] - 1] - 1]
    li_suppnat = s["s_nationkey"][li["l_suppkey"] - 1]
    rev = li["l_extendedprice"] * (100 - li["l_discount"]) % t
    out = {}
    for name, nid in sorted(n_dict.items()):
        m = li_date & (li_custnat == nid) & (li_suppnat == nid)
        v = int(rev[m].sum()) % t if nid in asia_nations else 0
        out[name] = {"revenue": v}
    return out


# ===========================================================================
# Q8 — national market share.
# ===========================================================================

def plan_q8() -> QueryPlan:
    return QueryPlan(
        name="Q8", fact="lineitem",
        where=And((Pred("o_orderdate", ">=", D("1995-01-01")),
                   Pred("o_orderdate", "<=", D("1996-12-31")))),
        hops=(JoinHop("region", "n_regionkey", "nation",
                      parent_filter=Pred("r_name", "=", "AMERICA")),
              JoinHop("nation", "c_nationkey", "customer"),
              JoinHop("customer", "o_custkey", "orders"),
              JoinHop("orders", "l_orderkey", "lineitem"),
              JoinHop("part", "l_partkey", "lineitem"),
              JoinHop("supplier", "l_suppkey", "lineitem")),
        group_by="o_year", group_domain=2,
        aggs=(Agg("sum", (Factor("l_extendedprice"), Factor("l_discount", -1, 100)),
                  "mkt_share"),))


def run_q8(pl: Planner, region: str = "AMERICA", nation: str = "BRAZIL",
           ptype: str = "ECONOMY ANODIZED") -> dict:
    bk, db = pl.bk, pl.db
    nat, cust = db.tables["nation"], db.tables["customer"]
    supp, part = db.tables["supplier"], db.tables["part"]
    orders, li = db.tables["orders"], db.tables["lineitem"]
    n_dict = _dict_of(db, "nation", "n_name")

    # region -> nation -> customer membership chain (shallow: each hop is an
    # EQ on a fresh key column x broadcast bit).
    rmask = ops.pred_mask(bk, db.tables["region"], Pred("r_name", "=", region))
    nmask = ops.translate_mask_down(bk, rmask[0], nat, "n_regionkey", 5)
    cmask = ops.translate_mask_down(bk, nmask[0], cust, "c_nationkey", 25)
    omask = ops.translate_mask_down(bk, cmask[0], orders, "o_custkey", cust.nrows)

    vals = ops.expr_blocks(bk, li, (Factor("l_extendedprice"), Factor("l_discount", -1, 100)))
    # part-type mask down to lineitem (stage 1 of the classical pipeline).
    pmask = ops.pred_mask(bk, part, Pred("p_type", "=", ptype))
    li_part = ops.translate_mask_down(bk, pmask[0], li, "l_partkey", part.nrows)
    # supplier-is-<nation> mask at supplier level, then down to lineitem.
    # Unoptimized: this join scans the fk already filtered by stage 1.
    nid = n_dict.get(nation, len(n_dict) + 1)
    smask = [cmp.eq_scalar(bk, supp.col("s_nationkey").blocks[0], nid)]
    fk_s = None if pl.optimized else ops.mask_columns(bk, li.col("l_suppkey").blocks, li_part)
    li_braz = ops.translate_mask_down(bk, smask[0], li, "l_suppkey", supp.nrows,
                                      fk_override=fk_s)

    out = {}
    for yr in (1995, 1996):
        dmask = pl.where_mask(orders, And((Pred("o_orderdate", ">=", D(f"{yr}-01-01")),
                                           Pred("o_orderdate", "<=", D(f"{yr}-12-31")))))
        oy = ([bk.mul(a, b) for a, b in zip(omask, dmask)] if pl.optimized
              else ops.and_masks_seq(bk, [omask, dmask]))
        fk_o = None if pl.optimized else ops.mask_columns(bk, li.col("l_orderkey").blocks, li_part)
        li_amer = ops.translate_mask_down(bk, oy[0], li, "l_orderkey", orders.nrows,
                                          fk_override=fk_o)
        if pl.optimized:
            base = ops.and_masks(bk, [li_amer, li_part])
            braz = ops.and_masks(bk, [base, li_braz])
        else:
            base = ops.and_masks_seq(bk, [li_amer, li_part])
            braz = ops.and_masks_seq(bk, [base, li_braz])
        base = ops.apply_validity(bk, base, li)
        braz = ops.apply_validity(bk, braz, li)
        out[yr] = {"nation_volume": _dec(bk, ops.masked_sum(bk, vals, braz)),
                   "total_volume": _dec(bk, ops.masked_sum(bk, vals, base))}
    return out


def oracle_q8(db: Database, region: str = "AMERICA", nation: str = "BRAZIL",
              ptype: str = "ECONOMY ANODIZED") -> dict:
    t = db.bk.t
    n, c = db.plain["nation"], db.plain["customer"]
    s, p = db.plain["supplier"], db.plain["part"]
    o, li = db.plain["orders"], db.plain["lineitem"]
    rid = _dict_of(db, "region", "r_name").get(region, -1)
    nid = _dict_of(db, "nation", "n_name").get(nation, -1)
    tid = _dict_of(db, "part", "p_type").get(ptype, -1)
    amer_nat = set(n["n_nationkey"][n["n_regionkey"] == rid].tolist())
    cust_amer = np.isin(c["c_nationkey"], list(amer_nat))
    ord_amer = cust_amer[o["o_custkey"] - 1]
    li_amer = ord_amer[li["l_orderkey"] - 1]
    li_part = (p["p_type"] == tid)[li["l_partkey"] - 1]
    li_braz = (s["s_nationkey"] == nid)[li["l_suppkey"] - 1]
    rev = li["l_extendedprice"] * (100 - li["l_discount"]) % t
    odate = o["o_orderdate"][li["l_orderkey"] - 1]
    out = {}
    for yr in (1995, 1996):
        dm = (odate >= D(f"{yr}-01-01")) & (odate <= D(f"{yr}-12-31"))
        base = li_amer & li_part & dm
        out[yr] = {"nation_volume": int(rev[base & li_braz].sum()) % t,
                   "total_volume": int(rev[base].sum()) % t}
    return out


# ===========================================================================
# Q17 — small-quantity-order revenue (correlated subquery on per-part AVG).
# ===========================================================================

def plan_q17() -> QueryPlan:
    return QueryPlan(
        name="Q17", fact="lineitem",
        where=And((Pred("p_brand", "=", "Brand#23"),
                   Pred("p_container", "=", "MED BOX"))),
        hops=(JoinHop("part", "l_partkey", "lineitem"),),
        aggs=(Agg("sum", (Factor("l_extendedprice"),), "avg_yearly_x7"),),
        correlated=True)


def run_q17(pl: Planner, brand: str = "Brand#23", container: str = "MED BOX") -> dict:
    bk, db = pl.bk, pl.db
    part, li = db.tables["part"], db.tables["lineitem"]
    npart = part.nrows
    assert part.nblocks == 1 and npart <= bk.slots

    # Per-part SUM(l_quantity) and COUNT (the paper's AVG-as-pair rewrite).
    ones = None
    qty = li.col("l_quantity").blocks
    valid = li.validity(li.nblocks - 1)
    sums = ops.join_aggregate(bk, li, "l_partkey", npart, qty)
    cnts = ops.join_aggregate(bk, li, "l_partkey", npart, None)
    packed_sum = ops.pack_scalars(bk, sums)
    packed_cnt = ops.pack_scalars(bk, cnts)
    # Pull per-part aggregates down to lineitem rows.
    li_sum = ops.translate_values_down(bk, packed_sum, li, "l_partkey", npart)
    li_cnt = ops.translate_values_down(bk, packed_cnt, li, "l_partkey", npart)
    # qty < 0.2 * sum/cnt  ==  5*qty*cnt < sum  (query rewriting, §4.2.2).
    from .plan import lt_depth
    lhs = [bk.mul_scalar(bk.mul(q, c), 5) for q, c in zip(qty, li_cnt)]
    # Planned refresh: the LT operands carry ~eq_depth+2 levels already and
    # the comparison needs ~eq_depth+1 more — one refresh per block beats
    # the mid-circuit thrash (the i* cost model's infeasible branch).
    need = lt_depth(bk.t) + 1
    lhs = [bk.ensure_levels(x, need) for x in lhs]
    li_sum = [bk.ensure_levels(x, need) for x in li_sum]
    small = [ops._col_cmp(bk, a, "<", b) for a, b in zip(lhs, li_sum)]

    pmask = pl.where_mask(part, And((Pred("p_brand", "=", brand),
                                     Pred("p_container", "=", container))))
    li_pm = ops.translate_mask_down(bk, pmask[0], li, "l_partkey", npart)
    full = (ops.and_masks(bk, [small, li_pm]) if pl.optimized
            else ops.and_masks_seq(bk, [li_pm, small]))
    full = ops.apply_validity(bk, full, li)
    total = ops.masked_sum(bk, li.col("l_extendedprice").blocks, full)
    return {"avg_yearly_x7": _dec(bk, total)}


def oracle_q17(db: Database, brand: str = "Brand#23", container: str = "MED BOX") -> dict:
    t = db.bk.t
    p, li = db.plain["part"], db.plain["lineitem"]
    bid = _dict_of(db, "part", "p_brand").get(brand, -1)
    cid = _dict_of(db, "part", "p_container").get(container, -1)
    pm = (p["p_brand"] == bid) & (p["p_container"] == cid)
    li_pm = pm[li["l_partkey"] - 1]
    nparts = len(p["p_partkey"])
    sums = np.zeros(nparts + 1, dtype=np.int64)
    cnts = np.zeros(nparts + 1, dtype=np.int64)
    np.add.at(sums, li["l_partkey"], li["l_quantity"])
    np.add.at(cnts, li["l_partkey"], 1)
    small = 5 * li["l_quantity"] * cnts[li["l_partkey"]] < sums[li["l_partkey"]]
    m = small & li_pm
    return {"avg_yearly_x7": int(li["l_extendedprice"][m].sum()) % t}


# Queries whose plans lower fully to the physical operator DAG:
# run_via_plan(planner, plan_qN()) must equal run_qN(planner) exactly.
PLAN_EXECUTABLE = ("Q1", "Q6", "Q12", "Q19")

QUERIES = {
    "Q1": (plan_q1, run_q1, oracle_q1),
    "Q4": (plan_q4, run_q4, oracle_q4),
    "Q5": (plan_q5, run_q5, oracle_q5),
    "Q6": (plan_q6, run_q6, oracle_q6),
    "Q8": (plan_q8, run_q8, oracle_q8),
    "Q12": (plan_q12, run_q12, oracle_q12),
    "Q14": (plan_q14, run_q14, oracle_q14),
    "Q17": (plan_q17, run_q17, oracle_q17),
    "Q19": (plan_q19, run_q19, oracle_q19),
}
