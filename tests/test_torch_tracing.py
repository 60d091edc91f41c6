"""The port's span recorder (`runtime/tracing.py`) alone, then inside the
query path: `run_via_plan` with recording on and off gives the same
answers, `OpStats` and `ExecReport` history; the stage spans follow the
report's stages, and every backend op span lies inside its query's
span."""
import dataclasses
import time
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.noise import NoiseProfile  # noqa: E402
from repro_torch.core.params import make_params  # noqa: E402
from repro_torch.engine import backend, executor, planner, queries, storage, tpch  # noqa: E402
from repro_torch.engine import plan as P  # noqa: E402
from repro_torch.engine import schema as S  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402


@pytest.fixture(autouse=True)
def fresh():
    tracing.enable(False)
    tracing.take()
    yield
    tracing.enable(False)
    tracing.take()


@tracing.traced("op")
def _op(x):
    return x + 1


# ------------------------------------------------------------ the recorder
def test_off_records_and_keeps_nothing():
    assert tracing.query("q") is tracing.span("a") is tracing.span("b")
    with tracing.query("q") as root:
        assert root is None and not tracing.recording()
        with tracing.span("a") as sp:
            assert sp is None
    tracemalloc.start()
    try:
        _op(0)
        before = tracemalloc.get_traced_memory()[0]
        for i in range(2000):
            with tracing.span("a"):
                _op(i)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 256
    assert tracing.take() == ([], 0)


def test_nesting_parents_and_one_id_a_query():
    tracing.enable()
    t0 = time.time_ns()
    for _ in range(2):
        with tracing.query("Q", lambda: {"n": 3}):
            with tracing.span("a") as a:
                a.attrs["k"] = 1
                _op(1)
            _op(2)
    t1 = time.time_ns()
    spans, dropped = tracing.take()
    assert dropped == 0 and tracing.clock_ns is time.time_ns
    assert [s.name for s in spans] == ["op", "a", "op", "query"] * 2
    for q in (spans[:4], spans[4:]):
        root = q[-1]
        assert root.parent_id == 0 and {s.query_id for s in q} == {root.span_id}
        assert root.attrs == {"plan": "Q", "n": 0, "wrapper_launches": 0, "issue_ns": 0}
        op_a, a, op_q = q[:3]
        assert op_a.parent_id == a.span_id and a.parent_id == op_q.parent_id == root.span_id
        assert a.attrs == {"k": 1} and op_a.attrs is None
        for s in q:
            assert t0 <= root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns <= t1
    assert spans[3].query_id != spans[7].query_id


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 5)
    tracing.enable()
    with tracing.query("Q"):
        for i in range(10):
            _op(i)
    spans, dropped = tracing.take()
    assert [s.name for s in spans] == ["op"] * 5 and dropped == 6     # the root is the 11th
    assert tracing.take() == ([], 0)


def test_profiler_turns_recording_on_for_one_query():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.profiling()
        with tracing.query("Q"):
            assert tracing.recording()
            _op(1)
    assert not tracing.profiling()
    with tracing.query("Q"):
        assert not tracing.recording()
        _op(1)
    spans, _ = tracing.take()
    assert [s.name for s in spans] == ["op", "query"]


def test_issue_counter_sums_into_the_query():
    timed = tracing.timed_issue(lambda x: x * 2)
    timed(1)                                   # not recording: not counted
    tracing.enable()
    with tracing.query("Q"):
        for i in range(7):
            timed(i)
    (root,), _ = tracing.take()
    assert root.attrs["wrapper_launches"] == 7 and root.attrs["issue_ns"] > 0


# ------------------------------------------------------------ the query path
def _mock_q6():
    bk = backend.MockBackend(NoiseProfile(n=64, t=65537, k=30), device="cpu")
    db = tpch.load(bk, tpch.Scale.tiny())
    ex = executor.Executor(planner.Planner(db, optimized=True))
    return ex.run(queries.QUERIES["Q6"][0]()), ex, bk


def _bfv_micro(optimized):
    """A WHERE and a SUM on real ciphertexts at micro size (t = 257)."""
    bk = backend.BFVBackend(make_params(n=128, t=257, k=12), seed=0, device="cpu")
    rng = np.random.default_rng(9)
    db = storage.Database(bk)
    db.load_table(S.TableSchema("li", [S.ColumnSpec("day", "int"), S.ColumnSpec("qty", "int")]),
                  {"day": rng.integers(1, 101, 40), "qty": rng.integers(1, 11, 40)}, 40)
    plan = P.QueryPlan(name="micro", fact="li", where=P.Pred("day", "<=", 60),
                       aggs=(P.Agg("sum", (P.Factor("qty"),), "sum_qty"),))
    ex = executor.Executor(planner.Planner(db, optimized=optimized))
    return ex.run(plan), ex, bk


@pytest.mark.parametrize("case", ["mock_q6", "bfv_opt", "bfv_seq"])
def test_run_via_plan_same_with_spans_and_stage_spans_follow_the_report(case):
    run = {"mock_q6": _mock_q6, "bfv_opt": lambda: _bfv_micro(True),
           "bfv_seq": lambda: _bfv_micro(False)}[case]
    outs = []
    for on in (False, True):
        tracing.enable(on)
        got, ex, bk = run()
        outs.append((got, dataclasses.asdict(bk.stats), ex.report.history))
    assert outs[0] == outs[1]
    spans, dropped = tracing.take()
    assert dropped == 0
    (root,) = [s for s in spans if s.parent_id == 0]
    assert root.name == "query" and root.attrs["plan"] == ex.report.name
    assert root.attrs["launches"] == bk.stats.launches > 0
    stages = sorted((s for s in spans if s.parent_id == root.span_id
                     and s.name not in ("verify",) and not s.name.startswith("bk.")),
                    key=lambda s: s.start_ns)
    history = ex.report.history
    assert [s.name for s in stages] == [h["stage"] for h in history]
    assert [s.attrs for s in stages] == history
    (verify,) = [s for s in spans if s.name == "verify"]
    assert verify.parent_id == root.span_id and verify.attrs == {"findings": 0}
    ops = [s for s in spans if s.name.startswith("bk.")]
    assert bool(ops) == isinstance(bk, backend.BFVBackend)
    assert {"bk.mul", "bk.decrypt"} <= {s.name for s in ops} or not ops
    for s in spans:
        assert s.query_id == root.span_id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns


def test_one_recorder_no_profiler_annotations_no_switch_in_the_environment():
    import os
    import re
    pkg = os.path.dirname(os.path.dirname(tracing.__file__))
    found = []
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(base, f)).read()
                code = re.sub(r'"""(?:.|\n)*?"""', "", text)
                if re.search(r"record_function|nvtx|RecordFunction", code):
                    found.append(f)
    assert found == []
    src = open(tracing.__file__).read()
    assert "environ" not in src and "getenv" not in src
    assert [f for f in os.listdir(os.path.dirname(tracing.__file__)) if "trac" in f] == [
        "tracing.py"]
