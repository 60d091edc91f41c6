"""Sharded query execution in the port against the JAX package: logical
shard contexts (one device, no mesh) at every (shards, limb_shards) cell
the JAX package's own logical tests cover (tests/test_sharded_exec.py,
tests/test_limb_sharding.py).

Each case runs the same seeded data through both packages and holds the
port to the JAX package's decrypts, `OpStats`, `ExecReport` (its
`recoveries` included) and ledger snapshot with tolerance 0 — the ledger's
floats compared with `==` — and the sharded run to the port's own
unsharded run and the plaintext oracle.  The Mock runs use the
multi-block paper-noise profile (n=64, t=65537, k=30: tiny LINEITEM packs
to 3 blocks, so shards=2 and 4 pad 3 -> 4 lanes and k=30 pads to 32 limbs
at limb_shards=4); the BFV runs use real ciphertexts at micro parameters.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.noise import NoiseProfile as JNoiseProfile
from repro.core.params import make_params as jax_make_params
from repro.engine import backend as jbackend
from repro.engine import executor as jexecutor
from repro.engine import ops as jops
from repro.engine import plan as jplan
from repro.engine import planner as jplanner
from repro.engine import queries as jqueries
from repro.engine import schema as jschema
from repro.engine import sharded as jsharded
from repro.engine import storage as jstorage
from repro.engine import tpch as jtpch
from repro.engine import verify as jverify
from repro.engine import workload as jworkload
from repro.runtime import elastic as jelastic
from repro.runtime import faults as jfaults
from repro_torch.core.noise import NoiseProfile
from repro_torch.core.params import make_params
from repro_torch.engine import backend as tbackend
from repro_torch.engine import executor as texecutor
from repro_torch.engine import ops as tops
from repro_torch.engine import plan as tplan
from repro_torch.engine import planner as tplanner
from repro_torch.engine import queries as tqueries
from repro_torch.engine import schema as tschema
from repro_torch.engine import sharded as tsharded
from repro_torch.engine import storage as tstorage
from repro_torch.engine import tpch as ttpch
from repro_torch.engine import verify as tverify
from repro_torch.engine import workload as tworkload
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import faults as tfaults

from torch_cases import (bfv_shard_db, bfv_shard_oracle, bfv_shard_plans,
                         sharded_run)

JAX = dict(backend=jbackend, executor=jexecutor, ops=jops, plan=jplan,
           planner=jplanner, queries=jqueries, schema=jschema, sharded=jsharded,
           storage=jstorage, tpch=jtpch, workload=jworkload, elastic=jelastic,
           faults=jfaults, verify=jverify, profile=JNoiseProfile)
PORT = dict(backend=tbackend, executor=texecutor, ops=tops, plan=tplan,
            planner=tplanner, queries=tqueries, schema=tschema, sharded=tsharded,
            storage=tstorage, tpch=ttpch, workload=tworkload, elastic=telastic,
            faults=tfaults, verify=tverify, profile=NoiseProfile)
BOTH = {"port": PORT, "jax": JAX}

MIX = tqueries.PLAN_EXECUTABLE                 # Q1 Q6 Q12 Q19
COSTS = {"mul": 0.05, "mul_plain": 0.055, "mul_scalar": 0.002,
         "add": 0.0015, "rotate": 0.105, "refresh": 44.0}
# (shards, limb_shards) cells of the JAX package's logical tests: the data
# axis at 2 in both regimes (test_sharded_exec.py) and the 2-D grid on the
# optimized planner (test_limb_sharding.py)
OPT_CELLS = [(2, 1), (1, 1), (4, 1), (1, 2), (4, 2)]
CASES = ([(qn, True, c) for qn in MIX for c in OPT_CELLS]
         + [(qn, False, (2, 1)) for qn in MIX])
BFV_CELLS = [(2, 1), (2, 4), (4, 2)]
JAX_BFV_CELLS = [(2, 1), (2, 4)]   # the JAX package's BFV cell, and the card's


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The micro BFV runs are thousands of tiny tensor ops: one intra-op
    thread runs them as fast alone, and ten times faster when the test
    workers share the cores (idle pool threads spin for busy ones)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mock_bk(mods):
    prof = mods["profile"](n=64, t=65537, k=30)
    return mods["backend"].MockBackend(prof, **({"device": "cpu"} if mods is PORT else {}))


def _mock_db(mods):
    return mods["tpch"].load(_mock_bk(mods), mods["tpch"].Scale.tiny())


@pytest.fixture(scope="module")
def dbs():
    return {name: _mock_db(mods) for name, mods in BOTH.items()}


@pytest.fixture(scope="module")
def runs(dbs):
    """(query, optimized, cell) -> {"port", "jax"} runs; cell None is the
    port's unsharded run."""
    out = {}
    for qn in MIX:
        for opt in (True, False):
            out[(qn, opt, None)] = {"port": sharded_run(
                PORT, dbs["port"], tqueries.QUERIES[qn][0](), None, opt)}
    for qn, opt, cell in CASES:
        out[(qn, opt, cell)] = {
            name: sharded_run(mods, dbs[name], mods["queries"].QUERIES[qn][0](), cell, opt)
            for name, mods in BOTH.items()}
    return out


def _id(case):
    qn, opt, cell = case
    return f"{qn}-{'opt' if opt else 'unopt'}-{cell[0]}x{cell[1]}"


# ---------------------------------------------------------------------------
# 1. Mock parity at every cell: port == JAX, sharded == unsharded == oracle.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_id)
def test_mock_parity_decrypt_identical(runs, dbs, case):
    qn, opt, _ = case
    port, jax_ = runs[case]["port"], runs[case]["jax"]
    assert port["got"] == jax_["got"]
    assert port["got"] == runs[(qn, opt, None)]["port"]["got"]
    assert port["got"] == tqueries.QUERIES[qn][2](dbs["port"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_mock_parity_stats_and_report_identical(runs, case):
    """Neither padding lanes nor gather charges reach OpStats; the
    executor's report (history, depth, recoveries) equals the JAX
    package's."""
    qn, opt, _ = case
    port, jax_ = runs[case]["port"], runs[case]["jax"]
    assert port["stats"] == jax_["stats"]
    assert port["stats"] == runs[(qn, opt, None)]["port"]["stats"]
    assert port["report"] == jax_["report"]
    assert port["report"]["recoveries"] == []


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_mock_ledger_matches_jax(runs, case):
    """The 2-D ledger, float sums included, equals the JAX package's
    bit for bit; gathers appear exactly when the limb axis is split."""
    _, _, (s, m) = case
    led, jled = runs[case]["port"]["ledger"], runs[case]["jax"]["ledger"]
    assert led == jled
    assert (led["shards"], led["limb_shards"], led["real_mesh"]) == (s, m, False)
    assert led["folds"] > 0 and led["dist"]
    if m > 1:
        assert led["gathers"] > 0 and led["gather_bytes"] > 0
        assert led["limb_local_bytes"] > 0
    else:
        assert led["gathers"] == 0 and led["gather_bytes"] == 0


def test_ledger_models_speedup(dbs):
    """Q6 priced at 1 vs 4 shards and at limb_shards 1 vs 2: modeled
    seconds drop on both axes, and equal the JAX package's."""
    secs = {}
    for name, mods in BOTH.items():
        for cell in ((1, 1), (4, 1), (1, 2)):
            pl = mods["planner"].Planner(dbs[name], shards=cell[0], limb_shards=cell[1])
            mods["executor"].run_via_plan(pl, mods["queries"].QUERIES["Q6"][0]())
            secs[(name, cell)] = pl.shard_ctx.modeled_seconds(COSTS)
    for cell in ((1, 1), (4, 1), (1, 2)):
        assert secs[("port", cell)] == secs[("jax", cell)]
    assert secs[("port", (4, 1))] < secs[("port", (1, 1))]
    assert secs[("port", (1, 2))] < secs[("port", (1, 1))]


def test_run_via_plan_installs_context_for_one_call(dbs):
    """run_via_plan(shards=, limb_shards=) runs under a context of its own
    and restores the planner's afterwards."""
    db = dbs["port"]
    pl = tplanner.Planner(db)
    base = texecutor.run_via_plan(pl, tqueries.plan_q6())
    assert texecutor.run_via_plan(pl, tqueries.plan_q6(), shards=2, limb_shards=4) == base
    assert pl.shard_ctx is None
    pl4 = tplanner.Planner(db, shards=4)
    ctx = pl4.shard_ctx
    assert texecutor.run_via_plan(pl4, tqueries.plan_q6(), shards=2) == base
    assert pl4.shard_ctx is ctx and ctx.folds == 0


# ---------------------------------------------------------------------------
# 2. BFV micro parity: real ciphertexts under logical contexts.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bfv_dbs():
    kw = dict(n=128, t=257, k=12)
    out = {}
    for name, mods in BOTH.items():
        bk = (tbackend.BFVBackend(make_params(**kw), seed=11, device="cpu")
              if mods is PORT else
              jbackend.BFVBackend(jax_make_params(**kw), seed=11, kernel_backend="ref"))
        out[name] = bfv_shard_db(mods, bk)
    return out


@pytest.fixture(scope="module")
def bfv_base(bfv_dbs):
    """Each micro plan's unsharded run on the port."""
    return {pname: sharded_run(PORT, bfv_dbs["port"][0], plan, None)
            for pname, plan in bfv_shard_plans(tplan).items()}


@pytest.mark.parametrize("cell", BFV_CELLS, ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("pname", ["g1", "j1", "f1"])
def test_bfv_micro_sharded_parity(bfv_dbs, bfv_base, pname, cell):
    """Real ciphertexts under a logical context: the port's sharded run
    equals its unsharded run and the oracle, and — at the JAX package's
    own cell (2, 1) and at the card's (2, 4) — the JAX package's run."""
    tdb, data, pdata = bfv_dbs["port"]
    port = sharded_run(PORT, tdb, bfv_shard_plans(tplan)[pname], cell)
    base = bfv_base[pname]
    if cell in JAX_BFV_CELLS:
        jax_ = sharded_run(JAX, bfv_dbs["jax"][0], bfv_shard_plans(jplan)[pname], cell)
        for key in ("got", "stats", "report", "ledger"):
            assert port[key] == jax_[key], key
    assert port["got"] == base["got"] == bfv_shard_oracle(pname, data, pdata)
    assert port["stats"] == base["stats"] and port["stats"]["refresh"] == 0
    assert port["report"]["recoveries"] == []
    assert port["ledger"]["folds"] > 0
    if cell[1] > 1:
        assert port["ledger"]["gathers"] > 0 and port["ledger"]["gather_bytes"] > 0


def test_bfv_padding_invisible_under_four_shards(bfv_dbs):
    """shards=4 over 3 blocks materializes one zero lane; unstack, fold
    and decrypt see only the 3 live lanes, and a broadcasted op's
    garbage in the pad lane never reaches a result."""
    bk = bfv_dbs["port"][0].bk
    vecs = [np.arange(bk.slots) % 7 + i for i in range(3)]
    plain = bk.stack_blocks([bk.encrypt(v) for v in vecs])
    with tsharded.activate(bk, tsharded.make_shard_context(4)):
        padded = bk.stack_blocks([bk.encrypt(v) for v in vecs])
        assert padded.nphys == 4 and padded.nblocks == 3
        assert not padded.data[3].any()
        shifted = bk.add_plain(padded, np.ones(bk.slots, dtype=np.int64))
        folded = bk.fold_blocks(shifted)
        dec = bk.decrypt(shifted)
    assert dec.shape == (3, bk.slots)
    np.testing.assert_array_equal(dec, (np.stack(vecs) + 1) % bk.t)
    np.testing.assert_array_equal(bk.decrypt(folded), (np.sum(vecs, axis=0) + 3) % bk.t)
    outs = bk.unstack_blocks(padded)
    assert len(outs) == 3
    for o, v in zip(outs, vecs):
        np.testing.assert_array_equal(bk.decrypt(o), v % bk.t)
    np.testing.assert_array_equal(bk.decrypt(bk.fold_blocks(plain)), np.sum(vecs, axis=0) % bk.t)


def test_bfv_real_mesh_context_raises(bfv_dbs):
    """A context's mesh is a torch DeviceMesh (real ones run in
    tests/test_torch_mesh.py): anything else makes the backend raise
    instead of running on one device."""
    bk = bfv_dbs["port"][0].bk
    blocks = [bk.encrypt(np.arange(4)) for _ in range(3)]
    with tsharded.activate(bk, tsharded.ShardContext(2, mesh=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            bk.stack_blocks(blocks)


# ---------------------------------------------------------------------------
# 3. Padding and geometry.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nblocks,shards,want", [
    (3, 2, 4), (3, 4, 4), (8, 4, 8), (5, 8, 8), (3, 1, 3), (1, 8, 1), (7, 3, 9)])
def test_pad_to(nblocks, shards, want):
    assert tsharded.pad_to(nblocks, shards) == jsharded.pad_to(nblocks, shards) == want


@pytest.mark.parametrize("limbs,m,want", [
    (12, 2, 12), (12, 4, 12), (30, 4, 32), (30, 7, 35), (30, 1, 30), (1, 4, 4)])
def test_limb_pad_to(limbs, m, want):
    assert tsharded.limb_pad_to(limbs, m) == jsharded.limb_pad_to(limbs, m) == want


@pytest.mark.parametrize("m,limbs,want", [(4, 30, 30 / 8), (2, 30, 2.0), (3, 30, 3.0),
                                          (1, 30, 1.0), (4, None, 4.0)])
def test_limb_factor_matches_jax(m, limbs, want):
    t = tsharded.ShardContext(1, limb_shards=m, limbs=limbs, ring_n=64)
    j = jsharded.ShardContext(1, limb_shards=m, limbs=limbs, ring_n=64)
    assert t.limb_factor() == j.limb_factor() == want
    assert t.workers == j.workers == m


def test_make_shard_context_is_logical():
    """Without a torch.distributed process group 'auto' attaches no mesh:
    the context runs on the backend's own device (under one it attaches a
    DeviceMesh, tests/test_torch_mesh.py)."""
    for shards, m, limbs in ((1, 4, 30), (2, 1, 30), (4, 2, 12), (8, 8, 32)):
        ctx = tsharded.make_shard_context(shards, limb_shards=m, limbs=limbs, ring_n=64)
        assert ctx.mesh is None and ctx.limb_mesh is None
        assert (ctx.shards, ctx.limb_shards, ctx.workers) == (shards, m, shards * m)


@pytest.mark.parametrize("args", [(0,), (1, None, 0), (0, None, 2)])
def test_shard_context_validates(args):
    with pytest.raises(ValueError):
        tsharded.ShardContext(*args)
    with pytest.raises(ValueError):
        jsharded.ShardContext(*args)


def test_ledger_charges_match_jax():
    """The same charges on both packages' contexts give equal snapshots
    and modeled seconds; without geometry the byte ledgers stay inert."""
    snaps = {}
    for name, mods in BOTH.items():
        S = mods["sharded"]
        for key, ctx in (("geom", S.ShardContext(2, limb_shards=4, limbs=30, ring_n=64)),
                         ("bare", S.ShardContext(2, limb_shards=2))):
            ctx.record("mul", 4, distributed=True)
            ctx.record("rotate", 3, distributed=False)
            ctx.record("mul", 0.5, distributed=True)
            ctx.record_fold(3, 4)
            ctx.record_gather(4)
            snaps[(name, key)] = (ctx.ledger_snapshot(), ctx.modeled_seconds(COSTS),
                                  ctx.modeled_seconds({**COSTS, "gather_byte": 1e-9}),
                                  ctx.heartbeats(COSTS, {1: 3.0}, baseline=0.01))
    for key in ("geom", "bare"):
        assert snaps[("port", key)] == snaps[("jax", key)]
    bare = snaps[("port", "bare")][0]
    assert bare["gathers"] == 1 and bare["gather_bytes"] == 0
    assert bare["limb_local_bytes"] == 0
    geom = snaps[("port", "geom")][0]
    assert geom["gather_bytes"] == 4 * 32 * 64 * 8


def test_lint_shard_context_matches_jax():
    """The same geometry linted by both packages, each given a mesh of its
    own kind (a JAX Mesh names its axes in `axis_names` with a {name:
    size} `shape`; a torch DeviceMesh in `mesh_dim_names`, `shape` a
    tuple)."""
    fake_mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 4))
    jfake_mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                       shape={"data": 4, "model": 4})
    for name, mods in BOTH.items():
        S = mods["sharded"]
        ok = S.ShardContext(2, limb_shards=4, limbs=30, ring_n=64)
        assert S.lint_shard_context(ok, limbs=30, ring_n=64) == []
    for args, kw in (((2,), dict(limb_shards=4, limbs=30, ring_n=64)),
                     ((2, fake_mesh), dict(limb_shards=4, limbs=30, ring_n=64))):
        jargs = tuple(jfake_mesh if a is fake_mesh else a for a in args)
        t = tsharded.lint_shard_context(tsharded.ShardContext(*args, **kw), limbs=12, ring_n=128)
        j = jsharded.lint_shard_context(jsharded.ShardContext(*jargs, **kw), limbs=12, ring_n=128)
        assert t == j and t
    codes = [c for c, _ in tsharded.lint_shard_context(
        tsharded.ShardContext(2, fake_mesh, limb_shards=4, limbs=30, ring_n=64), 30, 64)]
    assert codes == ["mesh.pad", "mesh.data"]


def test_stack_pads_only_under_context(dbs):
    bk = dbs["port"].bk
    blocks = [bk.encrypt(np.full(bk.slots, i + 1)) for i in range(3)]
    plain = bk.stack_blocks(blocks)
    assert bk._nblocks_phys(plain) == 3 and bk._nblocks(plain) == 3
    with tsharded.activate(bk, tsharded.make_shard_context(2, mesh=None)):
        padded = bk.stack_blocks(blocks)
        assert bk._nblocks_phys(padded) == 4       # 3 -> 4 lanes
        assert bk._nblocks(padded) == 3            # live count unchanged
        f_pad = bk.fold_blocks(padded)
    f_plain = bk.fold_blocks(plain)
    np.testing.assert_array_equal(bk.decrypt(f_pad), bk.decrypt(f_plain))
    outs = bk.unstack_blocks(padded)
    assert len(outs) == 3
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(bk.decrypt(o), bk.decrypt(blocks[i]))
    bk.stats.reset()


# ---------------------------------------------------------------------------
# 4. Per-lane noise vectors, the bounded cache and fused broadcasts — the
#    satellites that ride the sharded path, each against the JAX package.
# ---------------------------------------------------------------------------

def _burned_pair(bk):
    """(fresh, nearly-exhausted) same-plaintext pair."""
    fresh = bk.encrypt(np.full(bk.slots, 2))
    hot = bk.encrypt(np.full(bk.slots, 3))
    while bk.levels_left(hot) > 0:
        hot = bk.mul(hot, bk.encrypt(np.ones(bk.slots)))
    return fresh, hot


def _partial_refresh(mods):
    bk = _mock_bk(mods)
    fresh, hot = _burned_pair(bk)
    batch = bk.stack_blocks([fresh, hot])
    vector_noise = np.ndim(batch.noise) == 1
    bk.stats.reset()
    out = bk.mul(batch, batch)
    return (vector_noise, bk.stats.refresh, [bk.decrypt(b).tolist() for b in bk.unstack_blocks(out)],
            dataclasses.asdict(bk.stats), list(np.atleast_1d(out.noise)))


def test_partial_refresh_charges_exhausted_lane_only():
    t, j = _partial_refresh(PORT), _partial_refresh(JAX)
    assert t == j
    assert t[0] and t[1] == 1
    assert t[2] == [[4] * 64, [9] * 64]


def _ensure_levels(mods):
    bk = _mock_bk(mods)
    fresh, hot = _burned_pair(bk)
    batch = bk.stack_blocks([fresh, hot])
    per0 = np.asarray(batch.noise).copy()
    bk.stats.reset()
    bk.ensure_levels(batch, 3)
    return (bk.stats.refresh, float(np.max(batch.noise)), float(per0[0]),
            bk.levels_left(batch))


def test_ensure_levels_refreshes_short_lanes_only():
    t, j = _ensure_levels(PORT), _ensure_levels(JAX)
    assert t == j
    assert t[0] == 1 and t[1] == t[2] and t[3] >= 3


def test_pack_noises_scalar_when_uniform():
    for mods in (PORT, JAX):
        bk = _mock_bk(mods)
        batch = bk.stack_blocks([bk.encrypt(np.zeros(bk.slots)) for _ in range(3)])
        assert np.ndim(batch.noise) == 0


def _atom(i):
    return types.SimpleNamespace(key=("tbl", "c", i), table="tbl")


def _lru(mods):
    bk = _mock_bk(mods)
    blocks = [bk.encrypt(np.zeros(bk.slots))]
    W = mods["workload"]
    evict = W.WorkloadCache(max_entries=2)
    for i in range(4):
        evict.insert(bk, _atom(i), blocks)
    serve = W.WorkloadCache(max_entries=2)
    serve.insert(bk, _atom(0), blocks)
    serve.insert(bk, _atom(1), blocks)
    served = serve.serve(bk, _atom(0), 1) is not None
    serve.insert(bk, _atom(2), blocks)
    banks = W.WorkloadCache(max_entries=1)
    bank = [[bk.encrypt(np.zeros(bk.slots))]]
    banks.fk_store(bk, "t", "fk_a", 4, bank)
    banks.fk_store(bk, "t", "fk_b", 4, bank)
    unbounded = W.WorkloadCache()
    for i in range(8):
        unbounded.insert(bk, _atom(i), blocks)
    return {
        "evict": (len(evict.entries), evict.stats.evictions,
                  [evict.contains(_atom(i).key) for i in range(4)]),
        "serve": (served, [serve.contains(_atom(i).key) for i in range(3)],
                  serve.stats.evictions),
        "banks": (len(banks.fk_banks), banks.stats.evictions,
                  banks.fk_lookup(bk, "t", "fk_b", 4) is not None,
                  banks.fk_lookup(bk, "t", "fk_a", 4) is None),
        "unbounded": (len(unbounded.entries), unbounded.stats.evictions),
    }


@pytest.mark.parametrize("what", ["evict", "serve", "banks", "unbounded"])
def test_lru_cache_matches_jax(what):
    t, j = _lru(PORT)[what], _lru(JAX)[what]
    assert t == j
    want = {"evict": (2, 2, [False, False, True, True]),
            "serve": (True, [True, False, True], 1),
            "banks": (1, 1, True, True),
            "unbounded": (8, 0)}[what]
    assert t == want


def _broadcast(mods):
    bk = _mock_bk(mods)
    packed = bk.encrypt(np.arange(1, bk.slots + 1))
    idxs = [0, 3, 7, 11]
    bk.stats.reset()
    loop = [bk.decrypt(bk.broadcast_slot(packed, i)).tolist() for i in idxs]
    loop_stats = dataclasses.asdict(bk.stats)
    bk.stats.reset()
    fused = [bk.decrypt(c).tolist() for c in mods["ops"].broadcast_slots(bk, packed, idxs)]
    return loop, fused, loop_stats, dataclasses.asdict(bk.stats)


def test_broadcast_slots_fused_parity():
    t, j = _broadcast(PORT), _broadcast(JAX)
    assert t == j
    loop, fused, ls, fs = t
    assert loop == fused
    for field in ("mul_plain", "rotate", "add", "refresh"):
        assert fs[field] == ls[field], field
    assert fs["launches"] < ls["launches"]


# ---------------------------------------------------------------------------
# 5. Elastic planning and re-sharding on each axis.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards,excluded", [(8, [3]), (4, []), (4, [0, 2]), (2, [1])])
def test_elastic_scan_plan_matches_jax(shards, excluded):
    t = telastic.elastic_scan_plan(shards, excluded)
    assert t == jelastic.elastic_scan_plan(shards, excluded)
    assert t["shards"] & (t["shards"] - 1) == 0 and not set(t["workers"]) & set(excluded)


@pytest.mark.parametrize("m,excluded,limbs", [(4, [2], 30), (4, [0, 3], 30),
                                              (7, [0, 1, 2], 30), (4, [1], None)])
def test_elastic_limb_plan_matches_jax(m, excluded, limbs):
    t = telastic.elastic_limb_plan(m, excluded, limbs=limbs)
    assert t == jelastic.elastic_limb_plan(m, excluded, limbs=limbs)
    assert t["limb_shards"] == m - len(excluded)


def test_elastic_plans_all_excluded_raise():
    for E in (telastic, jelastic):
        with pytest.raises(RuntimeError):
            E.elastic_scan_plan(2, [0, 1])
        with pytest.raises(RuntimeError):
            E.elastic_limb_plan(2, [0, 1])


@pytest.mark.parametrize("excluded,axis,shape", [
    ([1], "model", (4, 1)), ([1, 3], "data", (2, 2)), ([0], "data", (2, 2)),
    ([0, 1], "model", None), ([0, 1, 2, 3], "data", None)])
def test_reshard_axes_independent(excluded, axis, shape):
    """Either axis shrinks and the other is preserved; the result equals
    the JAX package's context (geometry and a fresh ledger); no survivor
    raises in both."""
    t = tsharded.make_shard_context(4, limb_shards=2, limbs=30, ring_n=64)
    j = jsharded.make_shard_context(4, limb_shards=2, limbs=30, ring_n=64)
    if shape is None:
        for ctx in (t, j):
            with pytest.raises(RuntimeError):
                ctx.reshard(excluded, axis=axis)
        return
    t.record("mul", 3, True)
    rt, rj = t.reshard(excluded, axis=axis), j.reshard(excluded, axis=axis)
    assert (rt.shards, rt.limb_shards) == shape
    assert rt.ledger_snapshot() == rj.ledger_snapshot()
    assert (rt.limbs, rt.ring_n) == (30, 64)


def _straggler_reshard(mods, db):
    """The detector flags a slow worker; the elastic plan shrinks the
    planner's context; the rerun at the survivor count decrypts alike."""
    det = mods["elastic"].StragglerDetector(threshold=2.0, patience=1)
    for step in range(3):
        for w in range(4):
            det.report(w, 10.0 if w == 3 else 1.0, now=float(step))
    excluded = det.evaluate(now=3.0)
    pl = mods["planner"].Planner(db, shards=4)
    before = mods["executor"].run_via_plan(pl, mods["queries"].QUERIES["Q6"][0]())
    pl.shard_ctx = pl.shard_ctx.reshard(excluded)
    after = mods["executor"].run_via_plan(pl, mods["queries"].QUERIES["Q6"][0]())
    return excluded, pl.shard_ctx.shards, before, after, pl.shard_ctx.ledger_snapshot()


def test_straggler_exclusion_to_resharded_parity(dbs):
    t = _straggler_reshard(PORT, dbs["port"])
    j = _straggler_reshard(JAX, dbs["jax"])
    assert t == j
    assert t[0] == [3] and t[1] == 2 and t[2] == t[3]


def _per_axis(mods, db, grid, slow):
    pl = mods["planner"].Planner(db, optimized=True, shards=grid[0], limb_shards=grid[1])
    det = mods["elastic"].StragglerDetector(threshold=2.0, patience=2, timeout_s=1e9)
    pl.attach_straggler_detector(det, COSTS)
    outs, recs = [], []
    F = mods["faults"]
    with F.inject(F.FaultPlan(straggler_slowdown=dict(slow))):
        for _ in range(2):      # strikes reach patience on round 2
            ex = mods["executor"].Executor(pl)
            outs.append(ex.run(mods["queries"].QUERIES["Q6"][0]()))
            recs.append(ex.report.recoveries)
    return outs, recs, (pl.shard_ctx.shards, pl.shard_ctx.limb_shards)


@pytest.mark.parametrize("grid,slow,shape", [
    # workers flatten as data_row * M + limb_col.  Straggler sets stay a
    # fleet minority so the EWMA median tracks the healthy workers.
    # 2x4 grid: limb column 2 = workers {2, 6} -> model axis 4 -> 3
    ((2, 4), {2: 10.0, 6: 10.0}, (2, 3)),
    # 4x2 grid: data row 3 = workers {6, 7} -> data axis 4 -> 2 (pow2)
    ((4, 2), {6: 10.0, 7: 10.0}, (2, 2)),
])
def test_straggler_excludes_per_axis(dbs, runs, grid, slow, shape):
    t = _per_axis(PORT, dbs["port"], grid, slow)
    j = _per_axis(JAX, dbs["jax"], grid, slow)
    assert t == j
    base = runs[("Q6", True, None)]["port"]["got"]
    assert all(o == base for o in t[0])
    assert t[2] == shape
    assert t[1][0] == [] and t[1][1][-1]["kind"] == "straggler"


def test_straggler_recovery_logs_axis(dbs):
    recs = {}
    for name, mods in BOTH.items():
        pl = mods["planner"].Planner(dbs[name], optimized=True, shards=2, limb_shards=4)
        det = mods["elastic"].StragglerDetector(threshold=2.0, patience=1, timeout_s=1e9)
        pl.attach_straggler_detector(det, COSTS)
        ex = mods["executor"].Executor(pl)
        F = mods["faults"]
        with F.inject(F.FaultPlan(straggler_slowdown={2: 10.0, 6: 10.0})):
            ex.run(mods["queries"].QUERIES["Q6"][0]())
        recs[name] = ex.report.recoveries
    assert recs["port"] == recs["jax"]
    rec = [r for r in recs["port"] if r["kind"] == "straggler"]
    assert rec and rec[-1]["axis"] == "model"
    assert "2x4->2x3" in rec[-1]["action"]


# ---------------------------------------------------------------------------
# 6. Static verification under a shard context.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paper_dbs():
    """Mock at the paper profile (n=32768) over tiny TPC-H, as the
    verifier's CLI runs."""
    return {name: mods["tpch"].load(
                mods["backend"].MockBackend(**({"device": "cpu"} if mods is PORT else {})),
                mods["tpch"].Scale.tiny())
            for name, mods in BOTH.items()}


def _verify(mods, db, qn, cell, limbs=None):
    pl = mods["planner"].Planner(db, optimized=True, verify=False)
    pl.shard_ctx = mods["sharded"].make_shard_context(
        cell[0], limb_shards=cell[1], limbs=limbs or db.bk.limbs, ring_n=db.bk.slots)
    rep = mods["verify"].verify_plan(pl, mods["queries"].QUERIES[qn][0]())
    return dict(findings=[(f.severity, f.code, f.where) for f in rep.findings],
                skipped=rep.skipped, ok=rep.ok, depth=rep.measured_depth,
                headrooms=[float(d["headroom"]) for d in rep.decrypts],
                ledger=pl.shard_ctx.ledger_snapshot())


@pytest.mark.parametrize("cell", [(2, 4), (4, 1)], ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("qn", MIX)
def test_verify_under_context_matches_jax(paper_dbs, qn, cell):
    """A sharded plan is verified, not skipped: the mesh lint and the
    ledger reconciliation run and find nothing, as in the JAX package;
    the planner's own context is never charged."""
    t = _verify(PORT, paper_dbs["port"], qn, cell)
    assert t == _verify(JAX, paper_dbs["jax"], qn, cell)
    assert not t["skipped"] and t["ok"] and t["findings"] == []
    assert t["ledger"]["folds"] == 0 and not t["ledger"]["dist"]


def test_verify_lints_a_mismatched_context(paper_dbs):
    t = _verify(PORT, paper_dbs["port"], "Q6", (2, 4), limbs=12)
    assert t == _verify(JAX, paper_dbs["jax"], "Q6", (2, 4), limbs=12)
    assert ("error", "mesh.limbs", "shard_ctx") in t["findings"] and not t["ok"]


def test_verify_cli_with_shards(capsys):
    assert tverify._main(["--shards", "2", "--limb-shards", "4"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "ok: 0 error finding(s)"
