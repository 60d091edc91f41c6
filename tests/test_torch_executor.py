"""The second slice of the port as a whole, against the JAX package: the
compiled-DAG executor (`run_via_plan`), the cross-query scheduler
(`run_workload`) and all nine TPC-H queries, through both engines on the
same seeded data.  Exact equality throughout: decrypted results,
`OpStats`, `ExecReport` op history and depth, cache counters.

The Mock runs use a 64-slot profile at the paper's t and limb count (the
multi-block profile of the JAX package's own chaos and sharding tests):
Mock's per-op cost scales with its slot count, and 64 slots split the
192-row tiny LINEITEM into three blocks, so the batched paths run too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.noise import NoiseProfile as JNoiseProfile
from repro.core.params import make_params as jax_make_params
from repro.engine import backend as jbackend
from repro.engine import executor as jexecutor
from repro.engine import plan as jplan
from repro.engine import planner as jplanner
from repro.engine import queries as jqueries
from repro.engine import schema as jschema
from repro.engine import storage as jstorage
from repro.engine import tpch as jtpch
from repro.engine import workload as jworkload
from repro_torch.core.noise import NoiseProfile
from repro_torch.core.params import make_params
from repro_torch.engine import backend as tbackend
from repro_torch.engine import executor as texecutor
from repro_torch.engine import plan as tplan
from repro_torch.engine import planner as tplanner
from repro_torch.engine import queries as tqueries
from repro_torch.engine import schema as tschema
from repro_torch.engine import storage as tstorage
from repro_torch.engine import tpch as ttpch
from repro_torch.engine import workload as tworkload

JAX = dict(backend=jbackend, executor=jexecutor, plan=jplan, planner=jplanner,
           queries=jqueries, schema=jschema, storage=jstorage, tpch=jtpch,
           workload=jworkload, profile=JNoiseProfile)
PORT = dict(backend=tbackend, executor=texecutor, plan=tplan, planner=tplanner,
            queries=tqueries, schema=tschema, storage=tstorage, tpch=ttpch,
            workload=tworkload, profile=NoiseProfile)


def _mock_db(mods, kernel_reduce=False):
    prof = mods["profile"](n=64, t=65537, k=30)
    kw = dict(kernel_reduce=kernel_reduce)
    if mods is PORT:
        kw["device"] = "cpu"
    bk = mods["backend"].MockBackend(prof, **kw)
    return mods["tpch"].load(bk, mods["tpch"].Scale.tiny())


def _via_plan(mods, qn, optimized, kernel_reduce=False):
    db = _mock_db(mods, kernel_reduce)
    pl = mods["planner"].Planner(db, optimized=optimized)
    ex = mods["executor"].Executor(pl)
    got = ex.run(mods["queries"].QUERIES[qn][0]())
    return dict(db=db, got=got, report=dataclasses.asdict(ex.report),
                stats=dataclasses.asdict(db.bk.stats), op_log=dict(db.bk.op_log),
                refresh_log=list(db.bk.refresh_log),
                findings=[(f.severity, f.code, f.where)
                          for f in ex._verify_report.findings])


@pytest.mark.parametrize("optimized", [True, False])
@pytest.mark.parametrize("qn", ["Q1", "Q6", "Q12", "Q19"])
def test_run_via_plan_matches_jax_legacy_and_oracle(qn, optimized):
    t = _via_plan(PORT, qn, optimized)
    j = _via_plan(JAX, qn, optimized)
    for key in ("got", "report", "stats", "op_log", "refresh_log", "findings"):
        assert t[key] == j[key], key
    assert t["report"]["measured_depth"] > 0 and t["report"]["history"]
    plan_fn, run_fn, oracle_fn = tqueries.QUERIES[qn]
    assert t["got"] == oracle_fn(t["db"])
    assert run_fn(tplanner.Planner(t["db"], optimized=optimized)) == t["got"]


def test_run_via_plan_with_kernel_reduce_matches_jax():
    """Q1's group aggregates through rotate_reduce's plain version (port)
    and the Pallas kernel in interpret mode (JAX)."""
    t = _via_plan(PORT, "Q1", True, kernel_reduce=True)
    j = _via_plan(JAX, "Q1", True, kernel_reduce=True)
    for key in ("got", "report", "stats", "op_log"):
        assert t[key] == j[key], key
    assert t["got"] == tqueries.oracle_q1(t["db"])


def _workload(mods, optimized):
    db = _mock_db(mods)
    pl = mods["planner"].Planner(db, optimized=optimized)
    Q = mods["queries"]
    rep = mods["workload"].run_workload(pl, [Q.QUERIES[qn][0]()
                                             for qn in ("Q1", "Q6", "Q12", "Q19")])
    return dict(db=db, results=rep.results,
                reports=[dataclasses.asdict(r) for r in rep.reports],
                cache=dataclasses.asdict(rep.cache),
                counters=(rep.launches, rep.muls, rep.refreshes, rep.hit_rate),
                stats=dataclasses.asdict(db.bk.stats))


@pytest.mark.parametrize("optimized", [True, False])
def test_run_workload_matches_jax(optimized):
    t = _workload(PORT, optimized)
    j = _workload(JAX, optimized)
    for key in ("results", "reports", "cache", "counters", "stats"):
        assert t[key] == j[key], key
    for qn, got in zip(("Q1", "Q6", "Q12", "Q19"), t["results"]):
        assert got == tqueries.QUERIES[qn][2](t["db"]), qn
    if optimized:
        assert t["cache"]["misses"] > 0


@pytest.mark.parametrize("optimized", [True, False])
@pytest.mark.parametrize("qn", ["Q4", "Q5", "Q8", "Q14", "Q17"])
def test_legacy_only_queries_match_jax_and_oracle(qn, optimized):
    out = []
    for mods in (PORT, JAX):
        db = _mock_db(mods)
        got = mods["queries"].QUERIES[qn][1](mods["planner"].Planner(db, optimized=optimized))
        out.append((got, dataclasses.asdict(db.bk.stats), db))
    (tgot, tstats, tdb), (jgot, jstats, _) = out
    assert tgot == jgot == tqueries.QUERIES[qn][2](tdb)
    assert tstats == jstats


def test_query_registry_matches():
    assert tqueries.PLAN_EXECUTABLE == jqueries.PLAN_EXECUTABLE
    assert sorted(tqueries.QUERIES) == sorted(jqueries.QUERIES)
    for qn in tqueries.QUERIES:
        tp, jp = tqueries.QUERIES[qn][0](), jqueries.QUERIES[qn][0]()
        assert repr(tp) == repr(jp), qn
        for t in (257, 65537):
            for opt in (True, False):
                assert tp.total_depth(t, opt) == jp.total_depth(t, opt), qn


def _q1_micro(mods, bk):
    """A Q1-shaped query — date cutoff, two-column GROUP BY, SUM / SUM of
    a product / AVG / COUNT — on a 40-row table whose domains fit t=257
    (TPC-H's own columns do not)."""
    S, P = mods["schema"], mods["plan"]
    rng = np.random.default_rng(9)
    n = 40
    db = mods["storage"].Database(bk)
    db.load_table(S.TableSchema("li", [
        S.ColumnSpec("day", "int"), S.ColumnSpec("qty", "int"),
        S.ColumnSpec("price", "int"), S.ColumnSpec("flag", "str"),
        S.ColumnSpec("status", "str")]), {
        "day": rng.integers(1, 101, n), "qty": rng.integers(1, 11, n),
        "price": rng.integers(1, 101, n),
        "flag": [["A", "N", "R"][i] for i in rng.integers(0, 3, n)],
        "status": [["F", "O"][i] for i in rng.integers(0, 2, n)]}, n)
    plan = P.QueryPlan(
        name="q1_micro", fact="li", where=P.Pred("day", "<=", 60),
        group_by="flag,status", group_domain=6,
        aggs=(P.Agg("sum", (P.Factor("qty"),), "sum_qty"),
              P.Agg("sum", (P.Factor("price"), P.Factor("qty")), "sum_base"),
              P.Agg("avg", (P.Factor("price"),), "avg_price"),
              P.Agg("count", (), "count_order")))
    pl = mods["planner"].Planner(db, optimized=True)
    ex = mods["executor"].Executor(pl)
    got = ex.run(plan)
    return db, got, dataclasses.asdict(ex.report), dataclasses.asdict(bk.stats)


def test_q1_group_by_on_real_ciphertexts_matches_jax():
    kw = dict(n=128, t=257, k=12)
    tdb, tgot, trep, tstats = _q1_micro(
        PORT, tbackend.BFVBackend(make_params(**kw), seed=0, device="cpu"))
    _, jgot, jrep, jstats = _q1_micro(
        JAX, jbackend.BFVBackend(jax_make_params(**kw), seed=0, kernel_backend="ref"))
    assert tgot == jgot and trep == jrep and tstats == jstats
    assert tstats["refresh"] == 0
    plain, t = tdb.plain["li"], 257
    sel = plain["day"] <= 60
    fdict = tdb.tables["li"].schema.col("flag").dictionary
    sdict = tdb.tables["li"].schema.col("status").dictionary
    assert len(tgot) == 6
    for (f, s), row in tgot.items():
        m = sel & (plain["flag"] == fdict[f]) & (plain["status"] == sdict[s])
        assert row == {"sum_qty": int(plain["qty"][m].sum()) % t,
                       "sum_base": int((plain["price"][m] * plain["qty"][m]).sum()) % t,
                       "avg_price": (int(plain["price"][m].sum()) % t, int(m.sum()) % t),
                       "count_order": int(m.sum()) % t}, (f, s)
