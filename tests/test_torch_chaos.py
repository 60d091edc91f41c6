"""The chaos suite on the port, case for case with tests/test_chaos.py:
deterministic fault injection (the port's runtime/faults.py) against its
executor, elastic re-sharding and checkpoints.

The contract under test is the JAX package's (DESIGN.md §9): for every
injected fault class — noise under-prediction, device loss mid-scan,
straggler exclusion, cache corruption, checkpoint truncation — a query
over the Q1/Q6/Q12/Q19 mix either decrypts byte-identical to the
fault-free run or raises a typed ExecutionFault.  Each scenario also runs
on the JAX package with the same seed, and the port's outcome — the
decrypted result or the fault's class and kind, the executor's
`recoveries`, the fault plan's firing counts — must equal it; the
fault-free baselines are held against the JAX package's too.

The profile is the multi-block paper-noise set (n=64, t=65537, k=30):
tiny LINEITEM packs to 3 blocks, so padding, the block fold and the
per-stage checkpoints all run.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import noise as jnoise
from repro.engine import backend as jbackend
from repro.engine import executor as jexecutor
from repro.engine import planner as jplanner
from repro.engine import queries as jqueries
from repro.engine import tpch as jtpch
from repro.engine import workload as jworkload
from repro.runtime import checkpoint as jcheckpoint
from repro.runtime import elastic as jelastic
from repro.runtime import faults as jfaults
from repro_torch.core import noise as tnoise
from repro_torch.core.params import make_params
from repro_torch.engine import backend as tbackend
from repro_torch.engine import executor as texecutor
from repro_torch.engine import planner as tplanner
from repro_torch.engine import queries as tqueries
from repro_torch.engine import tpch as ttpch
from repro_torch.engine import workload as tworkload
from repro_torch.engine.executor import MAX_DEVICE_LOSS_RECOVERIES, ExecReport
from repro_torch.runtime import checkpoint as tcheckpoint
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.checkpoint import CheckpointManager

JAX = dict(noise=jnoise, backend=jbackend, executor=jexecutor, planner=jplanner,
           queries=jqueries, tpch=jtpch, workload=jworkload, checkpoint=jcheckpoint,
           elastic=jelastic, faults=jfaults)
PORT = dict(noise=tnoise, backend=tbackend, executor=texecutor, planner=tplanner,
            queries=tqueries, tpch=ttpch, workload=tworkload, checkpoint=tcheckpoint,
            elastic=telastic, faults=tfaults)
BOTH = {"port": PORT, "jax": JAX}

SEED = int(os.environ.get("NSHEDB_CHAOS_SEED", "1234"))
MIX = tqueries.PLAN_EXECUTABLE                      # Q1 Q6 Q12 Q19
COSTS = {"mul": 0.05, "mul_plain": 0.055, "mul_scalar": 0.002,
         "add": 0.0015, "rotate": 0.105, "refresh": 44.0}


def _mock(mods):
    prof = mods["noise"].NoiseProfile(n=64, t=65537, k=30)
    return mods["backend"].MockBackend(prof, **({"device": "cpu"} if mods is PORT else {}))


@pytest.fixture(scope="module")
def dbs():
    return {name: mods["tpch"].load(_mock(mods), mods["tpch"].Scale.tiny(), seed=7)
            for name, mods in BOTH.items()}


@pytest.fixture(scope="module")
def baselines(dbs):
    """Fault-free results per query and package (single-device, no
    guards — the bytes every recovered run must reproduce)."""
    return {name: {qn: mods["executor"].run_via_plan(
                mods["planner"].Planner(dbs[name], optimized=True),
                mods["queries"].QUERIES[qn][0]()) for qn in MIX}
            for name, mods in BOTH.items()}


def _outcome(fn):
    """fn()'s result as ("ok", value), or ("fault", class name, kind)
    when it raises a typed ExecutionFault."""
    try:
        return ("ok", fn())
    except Exception as e:   # noqa: BLE001 — classified below, else re-raised
        if any(c.__name__ == "ExecutionFault" for c in type(e).__mro__):
            return ("fault", type(e).__name__, e.kind)
        raise


def _both(scenario, dbs, *args):
    """scenario(mods, db, *args) on both packages: (port, jax) outcomes."""
    return tuple(_outcome(lambda m=mods, n=name: scenario(m, dbs[n], *args))
                 for name, mods in BOTH.items())


def _faulted(mods, db, qname, fp_kw, shards=2, planner_kw=None):
    """One query under FaultPlan(**fp_kw) on a `shards`-way planner:
    (result, final shard count, recoveries, fired counts)."""
    F = mods["faults"]
    fp = F.FaultPlan(**fp_kw)
    pl = mods["planner"].Planner(db, optimized=True, shards=shards, **(planner_kw or {}))
    ex = mods["executor"].Executor(pl)
    with F.inject(fp):
        out = ex.run(mods["queries"].QUERIES[qname][0]())
    fired = {k: fp.fired(k) for k in ("underpredict", "device-loss")}
    return out, pl.shard_ctx.shards if pl.shard_ctx else None, ex.report.recoveries, fired


def test_baselines_match_jax_and_oracle(baselines, dbs):
    assert baselines["port"] == baselines["jax"]
    for qn in MIX:
        assert baselines["port"][qn] == tqueries.QUERIES[qn][2](dbs["port"]), qn


# ---------------------------------------------------------------------------
# Guards are inert on healthy runs.
# ---------------------------------------------------------------------------

def _guarded(mods, db, qname):
    out, _, recs, _ = _faulted(mods, db, qname, {})
    pl = mods["planner"].Planner(db, optimized=True, guards=True)
    return out, recs, mods["executor"].run_via_plan(pl, mods["queries"].QUERIES[qname][0]())


@pytest.mark.parametrize("qname", MIX)
def test_guarded_run_matches_fault_free(dbs, baselines, qname):
    t, j = _both(_guarded, dbs, qname)
    assert t == j
    out, recs, guarded = t[1]
    assert out == guarded == baselines["port"][qname] and recs == []


# ---------------------------------------------------------------------------
# Fault class: noise under-prediction (overflow).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", MIX)
def test_underprediction_recovers_identical(dbs, baselines, qname):
    t, j = _both(_faulted, dbs, qname, dict(underpredict_bits=500.0, underpredict_count=3))
    assert t == j
    out, _, recs, fired = t[1]
    assert out == baselines["port"][qname]
    assert fired["underpredict"] == 3


def test_underprediction_recovery_is_reported(dbs, baselines):
    t, j = _both(_faulted, dbs, "Q6", dict(underpredict_bits=500.0, underpredict_count=3))
    assert t == j
    out, _, recs, _ = t[1]
    assert out == baselines["port"]["Q6"]
    assert "overflow" in [r["kind"] for r in recs]
    assert "refresh-and-retry" in [r["action"] for r in recs]


@pytest.mark.parametrize("qname", MIX)
def test_persistent_underprediction_raises_typed(dbs, qname):
    t, j = _both(_faulted, dbs, qname, dict(underpredict_bits=500.0,
                                            underpredict_count=10**9))
    assert t == j == ("fault", "NoiseOverflowFault", "overflow")


def test_underreporting_model_tracks_hidden_bits():
    out = {}
    for name, mods in BOTH.items():
        inner = _mock(mods).model
        m = mods["noise"].UnderReportingNoiseModel(inner, 100.0, skip=1)
        v = m.fresh()
        a = m.mul(v, v)            # skipped: truthful
        b = m.mul(v, v)            # tampered: 100 bits hidden
        out[name] = (a, b, m.hidden_bits, m.budget(v), m.inner.budget(v))
    assert out["port"] == out["jax"]
    a, b, hidden, budget, inner_budget = out["port"]
    assert a == b + 100.0 and hidden == 100.0 and budget == inner_budget


# ---------------------------------------------------------------------------
# Fault class: device loss mid-scan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", MIX)
@pytest.mark.parametrize("stage", ["where", "fold", "aggregate"])
def test_device_loss_resumes_identical(dbs, baselines, qname, stage):
    """Losing a worker mid-stage (the block fold included) reshards onto
    the survivors and resumes from the last checkpoint."""
    t, j = _both(_faulted, dbs, qname, dict(device_loss_stage=stage, device_loss_worker=1))
    assert t == j
    out, shards, recs, fired = t[1]
    assert out == baselines["port"][qname]
    assert shards == 1 and fired["device-loss"] == 1
    assert [r["kind"] for r in recs] == ["device-loss"]


def _resume(mods, db):
    pl = mods["planner"].Planner(db, optimized=True, shards=2)
    ex = mods["executor"].Executor(pl)
    F = mods["faults"]
    with F.inject(F.FaultPlan(device_loss_stage="aggregate", device_loss_worker=1)):
        out = ex.run(mods["queries"].QUERIES["Q6"][0]())
    return out, ex.report.recoveries, [h["stage"] for h in ex.report.history]


def test_device_loss_resume_skips_completed_stages(dbs, baselines):
    """Loss at the aggregate resumes *after* the mask stages — the
    checkpoint, not a from-scratch rerun."""
    t, j = _both(_resume, dbs)
    assert t == j
    out, recs, stages = t[1]
    assert out == baselines["port"]["Q6"]
    (rec,) = [r for r in recs if r["kind"] == "device-loss"]
    assert "atoms" in rec["action"] and "where" in rec["action"]
    assert stages.count("where") == 1


def _repeated_loss(mods, db):
    F = mods["faults"]
    fp = F.FaultPlan(device_loss_stage="aggregate", device_loss_worker=0,
                     device_loss_count=10**9)
    pl = mods["planner"].Planner(db, optimized=True, shards=2)
    try:
        with F.inject(fp):
            mods["executor"].run_via_plan(pl, mods["queries"].QUERIES["Q6"][0]())
    except F.DeviceLossFault as e:
        return e.kind, fp.fired("device-loss")
    return None


def test_repeated_device_loss_exhausts_typed(dbs):
    t, j = _both(_repeated_loss, dbs)
    assert t == j
    kind, fired = t[1]
    assert kind == "device-loss"
    assert fired <= MAX_DEVICE_LOSS_RECOVERIES + 1


def _loss_unsharded(mods, db):
    F = mods["faults"]
    with F.inject(F.FaultPlan(device_loss_stage="aggregate", device_loss_worker=0)):
        return mods["executor"].run_via_plan(mods["planner"].Planner(db, optimized=True),
                                             mods["queries"].QUERIES["Q6"][0]())


def test_device_loss_without_shards_is_typed(dbs):
    """No shard context -> nothing to reshard onto: the fault propagates
    typed instead of looping."""
    t, j = _both(_loss_unsharded, dbs)
    assert t == j == ("fault", "DeviceLossFault", "device-loss")


# ---------------------------------------------------------------------------
# Fault class: straggler exclusion.
# ---------------------------------------------------------------------------

def _straggler(mods, db, qname, rounds, slow, patience, shards=4):
    pl = mods["planner"].Planner(db, optimized=True, shards=shards)
    det = mods["elastic"].StragglerDetector(threshold=2.0, patience=patience, timeout_s=1e9)
    pl.attach_straggler_detector(det, COSTS)
    F = mods["faults"]
    outs, recs = [], []
    with F.inject(F.FaultPlan(straggler_slowdown=slow)):
        for _ in range(rounds):
            ex = mods["executor"].Executor(pl)
            outs.append(ex.run(mods["queries"].QUERIES[qname][0]()))
            recs.append(ex.report.recoveries)
    stats = {w: (st.ewma, st.strikes) for w, st in det.workers.items()}
    return outs, recs, pl.shard_ctx.shards, stats


@pytest.mark.parametrize("qname", MIX)
def test_straggler_excluded_and_resharded(dbs, baselines, qname):
    """A 10x-slow worker (synthetic heartbeats from the cost ledger) is
    struck out after `patience` rounds; the mesh shrinks 4->2 and
    results stay identical throughout."""
    t, j = _both(_straggler, dbs, qname, 3, {3: 10.0}, 2)
    assert t == j
    outs, recs, shards, stats = t[1]
    assert all(o == baselines["port"][qname] for o in outs)
    assert shards == 2 and stats[3][1] >= 2
    assert any(r["kind"] == "straggler" for rr in recs for r in rr)


def test_straggler_heartbeats_come_from_ledger(dbs):
    """Heartbeats are the run's modeled seconds, not wall-clock: equal
    for healthy workers, scaled for the slowed one."""
    t, j = _both(_straggler, dbs, "Q6", 1, {2: 5.0}, 3)
    assert t == j
    stats = t[1][3]
    e0, e2 = stats[0][0], stats[2][0]
    assert e0 > 0 and abs(e2 - 5.0 * e0) < 1e-9


# ---------------------------------------------------------------------------
# Fault class: cache poisoning.
# ---------------------------------------------------------------------------

def _poisoned(mods, db, qname, integrity="rederive", entries=None):
    cache = mods["workload"].WorkloadCache(integrity=integrity)
    pl = mods["planner"].Planner(db, optimized=True, cache=cache)
    first = mods["executor"].run_via_plan(pl, mods["queries"].QUERIES[qname][0]())
    mods["faults"].poison_cache(cache, db.bk, entries=entries)
    second = mods["executor"].run_via_plan(pl, mods["queries"].QUERIES[qname][0]())
    return first, second, cache.stats.poison_drops


def test_cache_poison_detected_and_rederived(dbs, baselines):
    """Default integrity ('rederive'): tampered entries fail their
    fingerprint at serve, are dropped, and the circuits re-derive."""
    t, j = _both(_poisoned, dbs, "Q6")
    assert t == j
    first, second, drops = t[1]
    assert first == second == baselines["port"]["Q6"] and drops > 0


@pytest.mark.parametrize("qname", MIX)
def test_cache_poison_matrix(dbs, baselines, qname):
    t, j = _both(_poisoned, dbs, qname)
    assert t == j
    _, second, drops = t[1]
    assert second == baselines["port"][qname] and drops > 0


def test_cache_poison_strict_mode_raises_typed(dbs):
    t, j = _both(_poisoned, dbs, "Q6", "fail", 1)
    assert t == j == ("fault", "CachePoisonFault", "cache-poison")


def test_cache_poison_silent_without_integrity(dbs, baselines):
    """Negative control: with integrity off the poisoned entry IS a silent
    wrong answer — proof the fingerprint check is load-bearing."""
    t, j = _both(_poisoned, dbs, "Q6", "off")
    assert t == j
    assert t[1][1] != baselines["port"]["Q6"]


def test_bfv_fingerprints_degrade_to_none():
    """Opaque handles (real BFV: refresh re-encrypts content) yield
    fp=None entries — integrity silently off, never a spurious poison
    verdict."""
    bk = tbackend.BFVBackend(make_params(n=128, t=257, k=12), seed=11, device="cpu")
    assert bk.fingerprint(bk.encrypt(np.arange(4))) is None
    assert tfaults.fingerprint_blocks(bk, [bk.encrypt(np.arange(4))]) is None


# ---------------------------------------------------------------------------
# Fault class: checkpoint truncation.
# ---------------------------------------------------------------------------

class TestCheckpointCorruption:
    PARAMS = {"w": np.arange(64, dtype=np.float32),
              "b": np.ones(8, dtype=np.float64)}

    def _params(self):
        return {k: torch.from_numpy(v) for k, v in self.PARAMS.items()}

    def test_truncated_leaf_falls_back(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
        mgr.save(1, self._params(), extra={"cursor": 10})
        mgr.save(2, self._params(), extra={"cursor": 20})
        tfaults.truncate_checkpoint(str(tmp_path), 2)
        assert not mgr.verify_step(2) and mgr.verify_step(1)
        step, params, _, extra = mgr.restore_latest_valid(self._params(), device="cpu")
        assert step == 1 and extra == {"cursor": 10}
        assert torch.equal(params["w"], self._params()["w"])
        # the JAX package reads the same snapshot the same way
        jmgr = jcheckpoint.CheckpointManager(str(tmp_path), keep=3, async_write=False)
        jstep, jparams, _, jextra = jmgr.restore_latest_valid(self.PARAMS)
        assert (jstep, jextra) == (step, extra)
        np.testing.assert_array_equal(np.asarray(jparams["w"]), params["w"].numpy())

    def test_all_corrupt_raises_typed(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
        mgr.save(1, self._params())
        mgr.save(2, self._params())
        tfaults.truncate_checkpoint(str(tmp_path), 1)
        tfaults.truncate_checkpoint(str(tmp_path), 2)
        with pytest.raises(tfaults.CheckpointCorruptFault) as ei:
            mgr.restore_latest_valid(self._params(), device="cpu")
        assert ei.value.kind == "checkpoint-corrupt"
        assert sorted(ei.value.detail["skipped"]) == [1, 2]

    def test_direct_restore_of_corrupt_step_is_typed(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
        mgr.save(1, self._params())
        tfaults.truncate_checkpoint(str(tmp_path), 1)
        with pytest.raises(tfaults.CheckpointCorruptFault):
            mgr.restore(1, self._params(), device="cpu")


# ---------------------------------------------------------------------------
# The seeded acceptance matrix: every fault class x the query mix.
# ---------------------------------------------------------------------------

FAULT_CLASSES = ["overflow-transient", "overflow-persistent",
                 "device-loss", "straggler", "cache-poison"]


def _matrix(mods, db, fault, qname):
    rng = np.random.default_rng(SEED)        # the same draws in both packages
    if fault == "overflow-transient":
        return _faulted(mods, db, qname, dict(
            underpredict_bits=400.0 + 100 * rng.integers(3), underpredict_count=2))[0]
    if fault == "overflow-persistent":
        return _faulted(mods, db, qname, dict(underpredict_bits=500.0,
                                              underpredict_count=10**9))[0]
    if fault == "device-loss":
        return _faulted(mods, db, qname, dict(device_loss_stage="any",
                                              device_loss_worker=int(rng.integers(2))))[0]
    if fault == "straggler":
        return _straggler(mods, db, qname, 2, {1: 8.0}, 1)[0][-1]
    return _poisoned(mods, db, qname)[1]


@pytest.mark.parametrize("qname", MIX)
@pytest.mark.parametrize("fault", FAULT_CLASSES)
def test_chaos_matrix_no_silent_wrong_answers(dbs, baselines, fault, qname):
    """Each fault class on each query of the mix ends in byte-identical
    decrypts or a typed ExecutionFault — the same one as the JAX
    package's."""
    t, j = _both(_matrix, dbs, fault, qname)
    assert t == j
    if t[0] == "fault":
        assert t[2] in ("overflow", "device-loss", "straggler", "cache-poison"), t
    else:
        assert t[1] == baselines["port"][qname], f"{fault}/{qname}: silent wrong answer"


# ---------------------------------------------------------------------------
# Satellite regressions.
# ---------------------------------------------------------------------------

def test_straggler_evaluate_idempotent():
    """Re-evaluating without fresh heartbeats must not accrue strikes."""
    det = telastic.StragglerDetector(threshold=2.0, patience=3, timeout_s=1e9)
    for w in range(4):
        det.report(w, 1.0 if w != 3 else 9.0, now=1.0)
    for _ in range(5):                       # one round, five evaluations
        excluded = det.evaluate(now=1.0)
    assert excluded == []
    assert det.workers[3].strikes == 1       # one strike, not five
    for t in (2.0, 3.0):                     # genuine slow rounds do exclude
        for w in range(4):
            det.report(w, 1.0 if w != 3 else 9.0, now=t)
        excluded = det.evaluate(now=t)
    assert excluded == [3]


def test_straggler_reset_readmits():
    det = telastic.StragglerDetector(threshold=2.0, patience=1, timeout_s=1e9)
    for w in range(4):
        det.report(w, 1.0 if w != 2 else 9.0, now=1.0)
    assert det.evaluate(now=1.0) == [2]
    det.reset(2)                             # e.g. replaced hardware
    assert 2 not in det.workers
    for w in range(4):
        det.report(w, 1.0, now=2.0)
    assert det.evaluate(now=2.0) == []       # back at full speed, readmitted


def test_checkpoint_crash_between_write_and_rename(tmp_path, monkeypatch):
    """A crash after the tmp dir is written but before the atomic rename:
    the step does not exist, and restore falls back to the previous one."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    params = TestCheckpointCorruption()._params()
    mgr.save(1, params, extra={"cursor": 1})

    def crash_rename(src, dst):
        raise OSError("simulated crash before publish")

    monkeypatch.setattr(os, "rename", crash_rename)
    with pytest.raises(OSError):
        mgr.save(2, params, extra={"cursor": 2})
    monkeypatch.undo()

    assert mgr.all_steps() == [1]            # step 2 never published
    step, got, _, extra = mgr.restore_latest_valid(params, device="cpu")
    assert step == 1 and extra == {"cursor": 1}
    assert torch.equal(got["w"], params["w"])
    empty = CheckpointManager(str(tmp_path / "empty"), async_write=False)
    with pytest.raises(tfaults.CheckpointCorruptFault):
        empty.restore_latest_valid(params, device="cpu")


def test_validate_failure_prints_op_history_diff():
    rep = ExecReport("Qx", True, predicted_depth=4, predicted_refreshes=0,
                     budget_levels=12, measured_depth=30, refreshes=2,
                     launches=7, muls=9)
    rep.history.append({"stage": "where", "mul": 9, "add": 3, "rotate": 1,
                        "launches": 7, "refresh": 2, "max_depth": 30})
    with pytest.raises(AssertionError) as ei:
        rep.validate()
    msg = str(ei.value)
    assert "op-history diff for Qx" in msg
    assert "predicted=4" in msg and "measured=30" in msg
    assert "where" in msg


def test_recovered_report_skips_plan_model_validation():
    rep = ExecReport("Qx", True, predicted_depth=4, predicted_refreshes=0,
                     budget_levels=12, measured_depth=30, refreshes=2)
    rep.recoveries.append({"kind": "overflow", "action": "refresh-and-retry"})
    rep.validate()                           # incomparable history: no raise
    rep2 = ExecReport("Qy", True, predicted_depth=4, predicted_refreshes=0,
                      budget_levels=12, measured_depth=30, refreshes=2)
    rep2.recoveries.append({"kind": "straggler", "action": "reshard 4->2"})
    with pytest.raises(AssertionError):      # straggler does NOT exempt
        rep2.validate()
