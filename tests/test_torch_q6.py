"""The first slice of the port as a whole, against the JAX package: the
quickstart query and TPC-H Q6 through both engines on the same seeded
data — equal decrypts, equal `OpStats`, equal noise floats, and on real
ciphertexts equal residues.  Exact equality throughout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import noise as jnoise
from repro.core.params import make_params as jax_make_params
from repro.engine import backend as jbackend
from repro.engine import plan as jplan
from repro.engine import planner as jplanner
from repro.engine import queries as jqueries
from repro.engine import schema as jschema
from repro.engine import storage as jstorage
from repro.engine import tpch as jtpch
from repro_torch.core import noise as tnoise
from repro_torch.core.params import make_params
from repro_torch.engine import backend as tbackend
from repro_torch.engine import plan as tplan
from repro_torch.engine import planner as tplanner
from repro_torch.engine import queries as tqueries
from repro_torch.engine import schema as tschema
from repro_torch.engine import storage as tstorage
from repro_torch.engine import tpch as ttpch

JAX = dict(backend=jbackend, plan=jplan, planner=jplanner, schema=jschema,
           storage=jstorage)
PORT = dict(backend=tbackend, plan=tplan, planner=tplanner, schema=tschema,
            storage=tstorage)


def _quickstart(mods, bk, optimized=True):
    """examples/quickstart.py's query; returns everything comparable."""
    P, S = mods["plan"], mods["schema"]
    rng = np.random.default_rng(42)
    n = 50
    data = {"day": rng.integers(1, 101, n), "price": rng.integers(1, 101, n),
            "qty": rng.integers(1, 11, n)}
    schema = S.TableSchema("sales", [S.ColumnSpec("day", "int"),
                                     S.ColumnSpec("price", "int"),
                                     S.ColumnSpec("qty", "int")])
    db = mods["storage"].Database(bk)
    db.load_table(schema, data, n)
    pl = mods["planner"].Planner(db, optimized=optimized)
    tbl = db.tables["sales"]
    where = P.And((P.Pred("day", "<", 50), P.Pred("qty", ">=", 3)))
    mask = pl.where_mask(tbl, where)
    total = pl.aggregate(tbl, P.Agg("sum", (P.Factor("price"),), "s"), mask)
    cnt = pl.aggregate(tbl, P.Agg("count", (), "c"), mask)
    sel = (data["day"] < 50) & (data["qty"] >= 3)
    return dict(
        sum=int(bk.decrypt(total)[0]), count=int(bk.decrypt(cnt)[0]),
        exp_sum=int(data["price"][sel].sum()) % bk.t, exp_count=int(sel.sum()),
        stats=dataclasses.asdict(bk.stats), op_log=dict(bk.op_log),
        refresh_log=list(bk.refresh_log), budget_levels=pl.budget_levels,
        noises=[float(np.max(m.noise)) for m in mask] + [float(total.noise), float(cnt.noise)],
        depths=[bk.depth(total), bk.depth(cnt)], handles=(mask, total, cnt))


def _assert_same_run(t, j):
    for key in ("sum", "count", "stats", "op_log", "refresh_log", "budget_levels",
                "noises", "depths"):
        assert t[key] == j[key], key
    assert (t["sum"], t["count"]) == (t["exp_sum"], t["exp_count"])


@pytest.mark.parametrize("optimized", [True, False])
def test_quickstart_on_mock_backend(optimized):
    t = _quickstart(PORT, tbackend.MockBackend(), optimized)
    j = _quickstart(JAX, jbackend.MockBackend(), optimized)
    _assert_same_run(t, j)
    for a, b in zip(t["handles"][0] + [t["handles"][1]], j["handles"][0] + [j["handles"][1]]):
        assert np.array_equal(a.vec, b.vec)


def test_quickstart_on_real_ciphertexts():
    kw = dict(n=128, t=257, k=12)
    t = _quickstart(PORT, tbackend.BFVBackend(make_params(**kw), seed=0, device="cpu"))
    j = _quickstart(JAX, jbackend.BFVBackend(jax_make_params(**kw), seed=0,
                                             kernel_backend="ref"))
    _assert_same_run(t, j)
    assert t["stats"]["refresh"] == 0
    tm, tt, tc = t["handles"]
    jm, jt, jc = j["handles"]
    for a, b in zip(tm + [tt, tc], jm + [jt, jc]):
        assert np.array_equal(a.data.numpy(), np.asarray(b.data))


def test_bfv_backend_defaults_to_cuda():
    import inspect
    sig = inspect.signature(tbackend.BFVBackend.__init__)
    assert sig.parameters["device"].default == "cuda"


@pytest.fixture(scope="module")
def tiny_dbs():
    tbk, jbk = tbackend.MockBackend(), jbackend.MockBackend()
    return (ttpch.load(tbk, ttpch.Scale.tiny(), tables=["lineitem"]),
            jtpch.load(jbk, jtpch.Scale.tiny(), tables=["lineitem"]))


def test_tpch_data_and_schema_match(tiny_dbs):
    tr, jr = ttpch.generate(ttpch.Scale.tiny()), jtpch.generate(jtpch.Scale.tiny())
    assert tr.keys() == jr.keys()
    for name in tr:
        for col in tr[name]:
            assert np.array_equal(np.asarray(tr[name][col]), np.asarray(jr[name][col])), (name, col)
    assert dataclasses.asdict(ttpch.Scale()) == dataclasses.asdict(jtpch.Scale())
    tdb, jdb = tiny_dbs
    tli, jli = tdb.tables["lineitem"], jdb.tables["lineitem"]
    assert (tli.nrows, tli.nblocks, tli.ct_count) == (jli.nrows, jli.nblocks, jli.ct_count)
    for col in tdb.plain["lineitem"]:
        assert np.array_equal(tdb.plain["lineitem"][col], jdb.plain["lineitem"][col]), col


@pytest.mark.parametrize("optimized", [True, False])
def test_q6_on_mock_backend(tiny_dbs, optimized):
    tdb, jdb = tiny_dbs
    for db in (tdb, jdb):
        db.bk.stats.reset()
        db.bk.op_log.clear()
        db.bk.refresh_log.clear()
    tpl = tplanner.Planner(tdb, optimized=optimized)
    jpl = jplanner.Planner(jdb, optimized=optimized)
    got, ref = tqueries.run_q6(tpl), jqueries.run_q6(jpl)
    assert got == ref == tqueries.oracle_q6(tdb) == jqueries.oracle_q6(jdb)
    assert dataclasses.asdict(tdb.bk.stats) == dataclasses.asdict(jdb.bk.stats)
    assert dict(tdb.bk.op_log) == dict(jdb.bk.op_log)
    assert tdb.bk.refresh_log == jdb.bk.refresh_log
    assert dataclasses.asdict(tpl.report(tqueries.plan_q6())) == \
        dataclasses.asdict(jpl.report(jqueries.plan_q6()))


def test_q6_stage_noise_matches_on_mock(tiny_dbs):
    tdb, jdb = tiny_dbs
    out = []
    for db, P, planner, queries in ((tdb, tplan, tplanner, tqueries),
                                    (jdb, jplan, jplanner, jqueries)):
        pl = planner.Planner(db, optimized=True)
        li = db.tables["lineitem"]
        mask = pl.where_mask(li, queries.plan_q6().where)
        rev = pl.aggregate(li, P.Agg("sum", (P.Factor("l_extendedprice"),
                                             P.Factor("l_discount")), "revenue"), mask)
        out.append(([float(np.max(m.noise)) for m in mask], float(rev.noise),
                    rev.depth, int(db.bk.decrypt(rev)[0]), db.bk.budget(rev)))
    assert out[0] == out[1]


def test_q6_other_arguments_match(tiny_dbs):
    tdb, jdb = tiny_dbs
    kw = dict(year=1995, disc=(0.02, 0.04), qty=30)
    got = tqueries.run_q6(tplanner.Planner(tdb), **kw)
    assert got == jqueries.run_q6(jplanner.Planner(jdb), **kw) == tqueries.oracle_q6(tdb, **kw)


def test_plan_depth_model_matches():
    tp, jp = tqueries.plan_q6(), jqueries.plan_q6()
    for t in (257, 65537):
        for opt in (True, False):
            assert tp.total_depth(t, opt) == jp.total_depth(t, opt)


def _walk_model(mod, profile):
    m = mod.NoiseModel(profile)
    v = m.fresh()
    vals = [v, m.keyswitch_addend(), m.max_depth(), m.levels_left(v), m.eq_depth(),
            m.lt_depth(), m.agg_depth(), m.join_depth()]
    for _ in range(6):
        v = m.keyswitch(m.mul(v, v))
        vals += [v, m.budget(v), m.rotate(v), m.mul_plain(v), m.mul_scalar(v, 40000),
                 m.add(v, v - 3.0), m.add_many([v, v - 1.0, v])]
    vec = np.array([v, v - 5.0, v + 2.0])
    vals += list(m.mul(vec, vec[::-1])) + list(m.add(vec, vec[::-1])) + [m.min_budget(vec)]
    return [float(x) for x in vals]


def test_noise_model_to_the_float():
    assert _walk_model(tnoise, tnoise.paper_profile()) == _walk_model(jnoise, jnoise.paper_profile())
    kw = dict(n=128, t=257, k=12)
    assert _walk_model(tnoise, make_params(**kw)) == _walk_model(jnoise, jax_make_params(**kw))
    tp, jp = tnoise.paper_profile(), jnoise.paper_profile()
    assert (tp.logQ, tp.q_max, tp.ct_bytes, tp.expansion_ratio()) == \
        (jp.logQ, jp.q_max, jp.ct_bytes, jp.expansion_ratio())


def test_under_reporting_noise_model_matches():
    outs = []
    for mod in (tnoise, jnoise):
        m = mod.UnderReportingNoiseModel(mod.NoiseModel(mod.paper_profile()), 4.0, skip=1)
        v = m.fresh()
        seq = []
        for _ in range(3):
            v = m.keyswitch(m.mul(v, v))
            seq.append(float(v))
        outs.append((seq, m.hidden_bits))
    assert outs[0] == outs[1]


def test_later_slices_raise_not_implemented(tiny_dbs):
    tdb, _ = tiny_dbs
    with pytest.raises(NotImplementedError):
        tbackend.MockBackend(kernel_reduce=True)
    with pytest.raises(NotImplementedError):
        tplanner.Planner(tdb, shards=2)
    with pytest.raises(NotImplementedError):
        tplanner.Planner(tdb, limb_shards=2)
    with pytest.raises(NotImplementedError):
        tplanner.Planner(tdb).verify(tqueries.plan_q6())


def test_refresh_inplace_keeps_aliases_consistent():
    """A partial refresh rebuilds the batch tensor instead of editing the
    one other handles may share."""
    bk = tbackend.BFVBackend(make_params(n=128, t=257, k=12), seed=3, device="cpu")
    blocks = [bk.encrypt(np.arange(10) + i) for i in range(3)]
    batch = bk.stack_blocks(blocks)
    batch.noise = np.array([batch.noise, batch.noise + 1.0, batch.noise])
    before = batch.data
    snapshot = before.clone()
    bk.refresh_inplace(batch, lanes=[1])
    assert torch.equal(before, snapshot)            # old tensor untouched
    assert batch.data is not before
    assert np.array_equal(bk.decrypt(batch)[:, :10],
                          np.stack([np.arange(10) + i for i in range(3)]))
    bk.refresh_inplace(batch)
    assert np.ndim(batch.noise) == 0 and bk.depth(batch) == 0
