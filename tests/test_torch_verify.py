"""The port's static plan verifier against the JAX package's: for every
TPC-H plan builder in both regimes, and for seeded plan mutations, the
two `VerifyReport`s carry the same findings (severity, code, stage), the
same refresh events and the same static headroom at every decrypt
boundary.  Mock backend at the paper profile over the tiny TPC-H scale —
verification does no payload work, so the full ring costs nothing."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine import backend as jbackend
from repro.engine import executor as jexecutor
from repro.engine import physical as jphysical
from repro.engine import plan as jplan
from repro.engine import planner as jplanner
from repro.engine import queries as jqueries
from repro.engine import tpch as jtpch
from repro.engine import verify as jverify
from repro_torch.engine import backend as tbackend
from repro_torch.engine import executor as texecutor
from repro_torch.engine import physical as tphysical
from repro_torch.engine import plan as tplan
from repro_torch.engine import planner as tplanner
from repro_torch.engine import queries as tqueries
from repro_torch.engine import tpch as ttpch
from repro_torch.engine import verify as tverify

JAX = dict(backend=jbackend, executor=jexecutor, physical=jphysical, plan=jplan,
           planner=jplanner, queries=jqueries, tpch=jtpch, verify=jverify)
PORT = dict(backend=tbackend, executor=texecutor, physical=tphysical, plan=tplan,
            planner=tplanner, queries=tqueries, tpch=ttpch, verify=tverify)


def _db(mods):
    return mods["tpch"].load(mods["backend"].MockBackend(), mods["tpch"].Scale.tiny())


@pytest.fixture(scope="module")
def dbs():
    return _db(PORT), _db(JAX)


def _summary(rep):
    """Everything a VerifyReport decides, in comparable form."""
    return dict(
        findings=[(f.severity, f.code, f.where) for f in rep.findings],
        skipped=rep.skipped, ok=rep.ok,
        depths=(rep.predicted_depth, rep.measured_depth, rep.predicted_refreshes,
                rep.budget_levels),
        decrypts=[(d["stage"], float(d["headroom"]), float(d["headroom_nr"]),
                   sorted(d["sites"]), d["depth"]) for d in rep.decrypts],
        events=[(e["kind"], e["what"], e["stage"], e["admission"], e["blocks"],
                 e["prior_serves"]) for e in rep.refresh_events])


def _planner(mods, db, optimized):
    return mods["planner"].Planner(db, optimized=optimized, verify=False)


@pytest.mark.parametrize("optimized", [True, False])
@pytest.mark.parametrize("qn", sorted(jqueries.QUERIES))
def test_every_plan_builder_verifies_alike(dbs, qn, optimized):
    tdb, jdb = dbs
    trep = _planner(PORT, tdb, optimized).verify(tqueries.QUERIES[qn][0]())
    jrep = _planner(JAX, jdb, optimized).verify(jqueries.QUERIES[qn][0]())
    assert isinstance(trep, tverify.VerifyReport)
    assert _summary(trep) == _summary(jrep)
    assert trep.summary() == jrep.summary()
    assert trep.ok
    assert trep.skipped or trep.decrypts
    if qn in tqueries.PLAN_EXECUTABLE:
        assert not trep.skipped


def test_q19_optimized_inject_admission(dbs):
    """Q19 optimized sits at depth 24 on a 25-level budget: the inject
    point's admission refresh (`ops.admit_inject`) is what keeps its
    decrypt inside the budget, and both verifiers see it."""
    tdb, jdb = dbs
    trep = _planner(PORT, tdb, True).verify(tqueries.plan_q19())
    jrep = _planner(JAX, jdb, True).verify(jqueries.plan_q19())
    assert _summary(trep) == _summary(jrep)
    admit = [e for e in trep.refresh_events
             if e["stage"] == "aggregate" and e["what"] == "planned(levels=2)"]
    assert admit and trep.decrypts[-1]["headroom"] > 0


def test_verification_touches_no_ciphertexts(dbs):
    tdb, _ = dbs
    pl = _planner(PORT, tdb, False)
    before = dataclasses.asdict(tdb.bk.stats)
    logs = len(tdb.bk.refresh_log)
    rep = pl.verify(tqueries.plan_q12())
    assert rep.ok and rep.refresh_events
    assert dataclasses.asdict(tdb.bk.stats) == before
    assert len(tdb.bk.refresh_log) == logs
    assert not pl.mask_cache.entries


def _find(node, kind):
    if node.kind == kind:
        return node
    for c in node.children:
        got = _find(c, kind)
        if got is not None:
            return got
    return None


def _dropped_refresh_sizing(mods, db):
    pl = _planner(mods, db, True)
    cq = mods["executor"].Executor(pl).compile(mods["queries"].plan_q19())
    _find(cq.where_node, "translated").downstream_muls = 0
    return mods["verify"].verify_compiled(pl, cq)


def _deepened_subtree(mods, db):
    pl = _planner(mods, db, True)
    cq = mods["executor"].Executor(pl).compile(mods["queries"].plan_q6())
    root = cq.where_node
    for _ in range(8):
        root = mods["physical"].MaskNode("and", root.table,
                                         children=[root, cq.where_node.clone()])
    mods["physical"].annotate_downstream(root, cq.inject_layers)
    cq.where_node = root
    return mods["verify"].verify_compiled(pl, cq)


def _aliased_cache(mods, db):
    """A warm cache whose shared entry serves at born level 0 with
    near-exhausted noise: the first product refreshes it in place under
    every consumer already holding it."""
    P = mods["plan"]
    p = P.Pred("l_shipmode", "=", "MAIL")
    q = P.Pred("l_quantity", "<", 25)
    plan = P.QueryPlan(name="alias", fact="lineitem", where=P.And((p, P.Or((p, q)))),
                       aggs=(P.Agg("count", (), "n"),))
    pl = _planner(mods, db, True)
    mods["executor"].Executor(pl).run(plan, validate=True)
    for entry in pl.mask_cache.entries.values():
        entry.born_levels = 0
        for b in entry.blocks:
            b.noise = -1.5
    return mods["verify"].verify_plan(pl, plan)


@pytest.mark.parametrize("mutation,code", [(_dropped_refresh_sizing, "ir.levels"),
                                           (_deepened_subtree, None),
                                           (_aliased_cache, "cache.alias")])
def test_seeded_mutations_rejected_alike(mutation, code):
    trep = mutation(PORT, _db(PORT))
    jrep = mutation(JAX, _db(JAX))
    assert _summary(trep) == _summary(jrep)
    assert trep.errors
    if code is not None:
        assert code in {f.code for f in trep.errors}


def test_admission_raises_before_any_ciphertext_op():
    db = _db(PORT)
    pl = _planner(PORT, db, True)
    cq = texecutor.Executor(pl).compile(tqueries.plan_q6())
    cq.where_node.downstream_muls += 1
    pl.verify_plans = True
    before = dataclasses.asdict(db.bk.stats)
    with pytest.raises(tverify.PlanVerificationError, match="ir.levels"):
        texecutor.Executor(pl).run_compiled(cq)
    assert dataclasses.asdict(db.bk.stats) == before


def test_crosscheck_static_headroom_is_sound(dbs):
    tdb, _ = dbs
    ex = texecutor.Executor(tplanner.Planner(tdb, optimized=True))
    ex.run(tqueries.plan_q6())
    rep = ex._verify_report
    assert rep is not None and rep.ok
    obs = ex.report.decrypt_headrooms
    assert np.allclose([d["headroom"] for d in rep.decrypts], obs)
    ex.report.decrypt_headrooms = [obs[0] - 1.0]
    with pytest.raises(AssertionError, match="under-approximated"):
        rep.crosscheck(ex.report)


def test_verify_under_a_shard_context_is_not_ported_yet(dbs):
    """Verifying under a logical shard context runs the mesh lint and the
    ledger reconciliation, as in the JAX package (tests/test_torch_sharded.py
    holds every query).  A context carrying a device mesh is linted like
    the reference's: a mesh whose axes disagree with the context is an
    error.  Each package gets a mesh of its own kind (a torch DeviceMesh
    names its axes in `mesh_dim_names`, its `shape` a tuple)."""
    import types

    from repro.engine import sharded as jsharded
    from repro_torch.engine import sharded as tsharded

    meshes = {"port": types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,)),
              "jax": types.SimpleNamespace(axis_names=("data",), shape={"data": 4})}
    out = []
    for mods, S, db, mesh in ((PORT, tsharded, dbs[0], meshes["port"]),
                              (JAX, jsharded, dbs[1], meshes["jax"])):
        pl = _planner(mods, db, True)
        kw = dict(limbs=db.bk.limbs, ring_n=db.bk.slots)
        pl.shard_ctx = S.ShardContext(2, None, limb_shards=4, **kw)
        logical = _summary(pl.verify(mods["queries"].plan_q6()))
        pl.shard_ctx = S.ShardContext(2, mesh, **kw)
        meshed = _summary(pl.verify(mods["queries"].plan_q6()))
        out.append((logical, meshed))
    assert out[0] == out[1]
    logical, meshed = out[0]
    assert logical["ok"] and not logical["skipped"] and logical["findings"] == []
    assert ("error", "mesh.data", "shard_ctx") in meshed["findings"] and not meshed["ok"]


def test_cli_prints_what_the_reference_prints(capsys):
    assert tverify._main([]) == 0
    port_out = capsys.readouterr().out
    assert jverify._main([]) == 0
    jax_out = capsys.readouterr().out
    strip = lambda out: [line.split("  [")[0] for line in out.splitlines()]
    assert strip(port_out) == strip(jax_out)
    assert port_out.splitlines()[-1] == "ok: 0 error finding(s)"


def test_dead_refresh_analysis_matches():
    ev = [{"id": 0, "kind": "planned", "admission": False},
          {"id": 1, "kind": "planned", "admission": False},
          {"id": 2, "kind": "planned", "admission": True}]
    dec = [{"sites": {0}, "headroom_nr": 3.0}, {"sites": {1, 2}, "headroom_nr": -1.0}]
    assert tverify._dead_refresh_ids(ev, dec) == jverify._dead_refresh_ids(ev, dec) == [0]
    ev.append({"id": 3, "kind": "auto", "admission": False})
    assert tverify._dead_refresh_ids(ev, dec) == []
