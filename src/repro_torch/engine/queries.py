"""TPC-H Q6 — the paper's Table 5 query and this engine's first surface.

  plan_q6()            declarative QueryPlan (drives the depth model)
  run_q6(planner, ...) encrypted execution composed from the planner's
                       mask construction and late-injected aggregation
  oracle_q6(db, ...)   plaintext reference (numpy over the client shadow
                       copies) returning the same mod-t value

Aggregate results follow the paper's conventions: fixed-point scales
multiply through products and the client rescales after decryption; sums
are mod-t.  The other TPC-H queries and the compiled-DAG path
(`run_via_plan`) join this module together with engine/executor.py.
"""
from __future__ import annotations

from .plan import Agg, And, Factor, Pred, QueryPlan
from .planner import Planner
from .schema import date_to_int
from .storage import Database

D = date_to_int


def _dec(bk, ct) -> int:
    return int(bk.decrypt(ct)[0])


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

