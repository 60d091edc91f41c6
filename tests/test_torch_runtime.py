"""The port's runtime substrate against the JAX package: checkpoints
(round trip, garbage collection, atomicity, the async double buffer, and
snapshots written by one package restored by the other, leaf for leaf),
the synthetic token pipeline's determinism across a restore, straggler
detection and elastic planning, and the cost models of engine/baseline.py
on the same `OpStats` and `OpCosts`.  Tolerance 0 throughout: the same
floats in the same order."""
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core.noise import paper_profile as jax_paper_profile
from repro.core.params import make_params as jax_make_params
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.engine import backend as jbackend
from repro.engine import baseline as jbaseline
from repro.runtime import checkpoint as jcheckpoint
from repro.runtime import elastic as jelastic
from repro_torch.core.noise import NoiseProfile, paper_profile
from repro_torch.core.params import make_params
from repro_torch.data import TokenPipeline
from repro_torch.engine import backend as tbackend
from repro_torch.engine import baseline as tbaseline
from repro_torch.engine import queries as tqueries
from repro_torch.engine import tpch as ttpch
from repro_torch.engine.executor import run_via_plan
from repro_torch.engine.planner import Planner
from repro_torch.runtime import CheckpointManager, StragglerDetector, elastic_mesh_plan
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime.checkpoint import _flatten


def _tree(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    # keys out of order: leaves are named and ordered by sorted key
    return {"b": {"c": torch.arange(6, dtype=torch.int32)},
            "a": torch.randn(8, 4, generator=g, dtype=dtype),
            "layers": [{"w": torch.full((3,), 2.0, dtype=torch.float64)},
                       (torch.tensor([1, 2], dtype=torch.int64), None)]}


def _np(tree):
    return {name: np.asarray(leaf) if not isinstance(leaf, torch.Tensor) else leaf.numpy()
            for name, leaf in _flatten(tree).items()}


def _scaled(tree, k):
    return {"b": {"c": tree["b"]["c"] * k}, "a": tree["a"] * k,
            "layers": [{"w": tree["layers"][0]["w"] * k},
                       (tree["layers"][1][0] * k, None)]}


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    params = _tree()
    opt = {"m": {k: torch.zeros(3) for k in ("x", "y")}}
    for step in (10, 20, 30):
        mgr.save(step, _scaled(params, step), opt,
                 extra={"pipeline": {"step": step, "seed": 1234, "shard": 0}})
    assert mgr.all_steps() == [20, 30]          # keep-last-2 GC
    assert mgr.latest_step() == 30
    got, gopt, extra = mgr.restore(30, params, opt, device="cpu")
    assert torch.equal(got["a"], params["a"] * 30)
    assert torch.equal(got["b"]["c"], params["b"]["c"] * 30)
    assert got["b"]["c"].dtype == torch.int32
    assert isinstance(got["layers"][1], tuple) and got["layers"][1][1] is None
    assert torch.equal(got["layers"][1][0], torch.tensor([30, 60]))
    assert torch.equal(gopt["m"]["y"], torch.zeros(3))
    assert extra["pipeline"]["step"] == 30


def test_checkpoint_leaf_names_sorted_like_jax():
    """Manifest names follow jax.tree_util's flatten order: dict keys
    sorted, sequence items by index, None contributing nothing."""
    jtree = jax.tree.map(lambda x: jnp.asarray(x.numpy()), _tree(),
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert list(_flatten(_tree())) == list(jcheckpoint._flatten(jtree))
    assert list(_flatten(_tree())) == ["a", "b/c", "layers/0/w", "layers/1/0"]


def test_checkpoint_atomicity(tmp_path):
    """A stale tmp dir (crash mid-write) is not visible as a step."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert mgr.all_steps() == []
    mgr.save(5, _tree())
    assert mgr.all_steps() == [5]


def test_checkpoint_crash_between_write_and_rename(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    mgr.save(1, _tree(), extra={"cursor": 1})

    def crash_rename(src, dst):
        raise OSError("simulated crash before publish")

    monkeypatch.setattr(os, "rename", crash_rename)
    with pytest.raises(OSError):
        mgr.save(2, _scaled(_tree(), 2), extra={"cursor": 2})
    monkeypatch.undo()
    assert mgr.all_steps() == [1]
    assert os.path.isdir(tmp_path / "step_00000002.tmp")
    step, got, _, extra = mgr.restore_latest_valid(_tree(), device="cpu")
    assert step == 1 and extra == {"cursor": 1}
    assert torch.equal(got["a"], _tree()["a"])


def test_checkpoint_async_double_buffer(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    params = _tree()
    mgr.save(1, params)
    params["a"].add_(1.0)       # the host copy was taken before save returned
    mgr.save(2, params)         # waits for the in-flight write first
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    one, _, _ = mgr.restore(1, params, device="cpu")
    two, _, _ = mgr.restore(2, params, device="cpu")
    assert torch.equal(one["a"] + 1.0, two["a"])
    assert torch.equal(two["a"], params["a"])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def test_checkpoint_rejects_bfloat16(tmp_path):
    """bfloat16 leaves, once refused, now round-trip bit for bit (their
    raw bits on disk, "bfloat16" in the manifest)."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    params = _tree(torch.bfloat16)
    mgr.save(1, params)
    info = json.load(open(tmp_path / "step_00000001" / "manifest.json"))["leaves"]
    assert info["params/a"]["dtype"] == "bfloat16" and info["params/a"]["shape"] == [8, 4]
    assert mgr.verify_step(1)
    got, _, _ = mgr.restore(1, params, device="cpu")
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["a"]), _bits(params["a"]))
    assert torch.equal(got["b"]["c"], params["b"]["c"])


def test_bfloat16_leaf_matches_jax_on_disk(tmp_path):
    """A bfloat16 leaf the JAX package writes (an ml_dtypes array) restores
    in the port to the same bits, and the port's file for the same values
    is byte-equal to it, manifest entry included."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    vals = torch.randn(5, 7, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    jleaf = jnp.asarray(_bits(vals).view(ml_dtypes.bfloat16))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcheckpoint.CheckpointManager(str(jdir), async_write=False).save(2, {"w": jleaf})
    CheckpointManager(str(tdir), async_write=False).save(2, {"w": vals})
    got, _, _ = CheckpointManager(str(jdir), async_write=False).restore(
        2, {"w": vals}, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["w"]), _bits(vals))
    step = "step_00000002"
    assert ((jdir / step / "params__w.npy").read_bytes()
            == (tdir / step / "params__w.npy").read_bytes())
    jman = json.load(open(jdir / step / "manifest.json"))
    tman = json.load(open(tdir / step / "manifest.json"))
    assert jman == tman and tman["leaves"]["params/w"]["dtype"] == "bfloat16"


def test_checkpoint_restore_defaults_to_the_card():
    for fn in (CheckpointManager.restore, CheckpointManager.restore_latest_valid):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_port_snapshot_restores_in_jax(tmp_path):
    params, opt = _tree(), {"m": [torch.ones(2), torch.zeros(2, 2)]}
    CheckpointManager(str(tmp_path), async_write=False).save(
        3, params, opt, extra={"cursor": 7})
    like = jax.tree.map(lambda x: jnp.zeros(x.shape, x.numpy().dtype), (params, opt),
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    jmgr = jcheckpoint.CheckpointManager(str(tmp_path), async_write=False)
    assert jmgr.all_steps() == [3] and jmgr.verify_step(3)
    got, gopt, extra = jmgr.restore(3, *like)
    assert extra == {"cursor": 7}
    for mine, theirs in ((params, got), (opt, gopt)):
        want = _np(mine)
        have = {n: np.asarray(v) for n, v in jcheckpoint._flatten(theirs).items()}
        assert list(want) == list(have)
        for name in want:
            assert want[name].dtype == have[name].dtype, name
            np.testing.assert_array_equal(have[name], want[name])


def test_jax_snapshot_restores_in_port(tmp_path):
    params = _tree()
    jparams = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
    jcheckpoint.CheckpointManager(str(tmp_path), async_write=False).save(
        4, jparams, extra={"cursor": 9})
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    assert mgr.verify_step(4)
    got, gopt, extra = mgr.restore(4, params, device="cpu")
    assert gopt is None and extra == {"cursor": 9}
    have, want = _np(got), _np(params)
    assert list(have) == list(want)
    for name in want:
        assert have[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(have[name], want[name])


def test_both_packages_write_the_same_manifest(tmp_path):
    params = _tree()
    jparams = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(1, params)
    jcheckpoint.CheckpointManager(str(tmp_path / "jax"), async_write=False).save(1, jparams)
    manifests = []
    for d in ("port", "jax"):
        with open(tmp_path / d / "step_00000001" / "manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert list(manifests[0]["leaves"]) == list(manifests[1]["leaves"])
    for info in manifests[0]["leaves"].values():
        a = (tmp_path / "port" / "step_00000001" / info["file"]).read_bytes()
        b = (tmp_path / "jax" / "step_00000001" / info["file"]).read_bytes()
        assert a == b, info["file"]


# ---------------------------------------------------------------------------
# The token pipeline.
# ---------------------------------------------------------------------------

def test_pipeline_determinism_across_restore():
    p1 = TokenPipeline(vocab=100, seq_len=16, batch=2)
    batches = [p1.next_batch() for _ in range(5)]
    p2 = TokenPipeline(vocab=100, seq_len=16, batch=2)
    p2.load_state_dict({"step": 3, "seed": 1234, "shard": 0})
    b3 = p2.next_batch()
    np.testing.assert_array_equal(b3["tokens"], batches[3]["tokens"])
    assert p1.state_dict() == {"step": 5, "seed": 1234, "shard": 0}
    p3 = TokenPipeline(vocab=100, seq_len=16, batch=2, shard=1, num_shards=2)
    assert not np.array_equal(p3.next_batch()["tokens"], batches[0]["tokens"])
    with pytest.raises(AssertionError):
        p3.load_state_dict({"step": 0, "seed": 1234, "shard": 0})


@pytest.mark.parametrize("shard", [0, 1])
def test_pipeline_matches_jax(shard):
    t = TokenPipeline(vocab=300, seq_len=32, batch=3, shard=shard, num_shards=2, seed=9)
    j = JTokenPipeline(vocab=300, seq_len=32, batch=3, shard=shard, num_shards=2, seed=9)
    for _ in range(4):
        bt, bj = t.next_batch(), j.next_batch()
        for key in ("tokens", "labels"):
            assert bt[key].dtype == bj[key].dtype
            np.testing.assert_array_equal(bt[key], bj[key])
    assert t.state_dict() == j.state_dict()


# ---------------------------------------------------------------------------
# Straggler detection and elastic planning.
# ---------------------------------------------------------------------------

def _detect(E):
    det = E.StragglerDetector(threshold=2.0, patience=2, timeout_s=10.0)
    now, rounds = 1000.0, []
    for t in range(6):                      # periodic heartbeat rounds
        for w in range(4):
            det.report(w, 1.0 if w != 3 else 5.0, now=now + t)
        rounds.append(det.evaluate(now=now + t))
    det2 = E.StragglerDetector(timeout_s=5.0)
    det2.report(0, 1.0, now=0.0)
    det2.report(1, 1.0, now=0.0)
    det2.report(0, 1.0, now=20.0)
    stats = {w: dataclasses.asdict(st) for w, st in det.workers.items()}
    return rounds, det2.evaluate(now=20.0), stats


def test_straggler_detection():
    t, j = _detect(telastic), _detect(jelastic)
    assert t == j
    rounds, dead, _ = t
    assert rounds[-1] == [3]                 # worker 3 is slow
    assert dead == [1]                       # worker 1 stopped reporting
    assert StragglerDetector is telastic.StragglerDetector


@pytest.mark.parametrize("total,excluded,mp", [(512, 16, 16), (512, 0, 16), (64, 3, 8),
                                               (20, 10, 16)])
def test_elastic_mesh_plan(total, excluded, mp):
    if total - excluded < mp:
        for fn in (elastic_mesh_plan, jelastic.elastic_mesh_plan):
            with pytest.raises(RuntimeError):
                fn(total, excluded=excluded, model_parallel=mp)
        return
    plan = elastic_mesh_plan(total, excluded=excluded, model_parallel=mp)
    assert plan == jelastic.elastic_mesh_plan(total, excluded=excluded, model_parallel=mp)
    want = {(512, 16): (16, 16), (512, 0): (32, 16), (64, 3): (4, 8)}[(total, excluded)]
    assert plan["mesh_shape"] == want


# ---------------------------------------------------------------------------
# The cost models of engine/baseline.py.
# ---------------------------------------------------------------------------

COSTS = dict(n=4096, k=6, mul=0.031, mul_plain=0.0121, mul_scalar=0.0009,
             add=0.0004, rotate=0.027)


@pytest.fixture(scope="module")
def q6_stats():
    """OpStats and op_log of Q6 on the port's Mock at the paper profile."""
    bk = tbackend.MockBackend(NoiseProfile(n=64, t=65537, k=30), device="cpu")
    db = ttpch.load(bk, ttpch.Scale.tiny())
    run_via_plan(Planner(db), tqueries.plan_q6())
    return bk.stats.clone(), dict(bk.op_log)


@pytest.mark.parametrize("system", ["he3db", "arcedb", "nshedb_paper"])
def test_baseline_seconds_matches_jax(q6_stats, system):
    _, op_log = q6_stats
    log = dict(op_log, count=3, sum=2, cmp=5, between=1)
    got = tbaseline.baseline_seconds(system, log, 32768)
    assert got == jbaseline.baseline_seconds(system, log, 32768)
    assert got > 0


@pytest.mark.parametrize("n2,k2", [(32768, 30), (8192, 12), (4096, 6)])
def test_extrapolate_costs_matches_jax(n2, k2):
    t = tbaseline.extrapolate_costs(tbaseline.OpCosts(**COSTS), n2, k2)
    j = jbaseline.extrapolate_costs(jbaseline.OpCosts(**COSTS), n2, k2)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.as_dict() == j.as_dict()
    if (n2, k2) == (4096, 6):
        assert t.as_dict() == tbaseline.OpCosts(**COSTS).as_dict()


def test_nshedb_seconds_matches_jax(q6_stats):
    stats, _ = q6_stats
    jstats = jbackend.OpStats(**dataclasses.asdict(stats))
    for costs in (COSTS, dict(COSTS, n=32768, k=30)):
        t = tbaseline.nshedb_seconds(stats, tbaseline.OpCosts(**costs))
        j = jbaseline.nshedb_seconds(jstats, jbaseline.OpCosts(**costs))
        assert t == j and t > 0
    refreshed = dataclasses.replace(stats, refresh=2)
    assert (tbaseline.nshedb_seconds(refreshed, tbaseline.OpCosts(**COSTS))
            - tbaseline.nshedb_seconds(stats, tbaseline.OpCosts(**COSTS))
            == pytest.approx(2 * tbaseline.C_BOOT_SECONDS))


@pytest.mark.parametrize("rows,ncols", [(32768, 16), (6_001_215, 16), (65536, 7)])
def test_storage_report_matches_jax(rows, ncols):
    for t_prof, j_prof in ((make_params(n=128, t=257, k=12), jax_make_params(n=128, t=257, k=12)),
                           (paper_profile(), jax_paper_profile())):
        t = tbaseline.storage_report(t_prof, rows, ncols)
        assert t == jbaseline.storage_report(j_prof, rows, ncols)
        assert t["nshedb_bytes"] == -(-rows // t_prof.n) * ncols * t_prof.ct_bytes


def test_paper_constants_match_jax():
    assert tbaseline.TABLE4_MS_PER_SLOT == jbaseline.TABLE4_MS_PER_SLOT
    assert tbaseline.PAPER_QUERY_SECONDS == jbaseline.PAPER_QUERY_SECONDS
    assert (tbaseline.C_BOOT_SECONDS, tbaseline.PAPER_SLOTS) == (
        jbaseline.C_BOOT_SECONDS, jbaseline.PAPER_SLOTS)


def test_measure_costs_on_the_cpu():
    """measure_costs keygens its own backend on the device it is given
    (the card by default) and returns positive per-op seconds."""
    assert inspect.signature(tbaseline.measure_costs).parameters["device"].default == "cuda"
    c = tbaseline.measure_costs(make_params(n=128, t=257, k=12), reps=1, device="cpu")
    assert (c.n, c.k) == (128, 12)
    assert all(v > 0 for v in c.as_dict().values())
    assert c.refresh == tbaseline.C_BOOT_SECONDS
