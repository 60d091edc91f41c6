"""The readers of the program's spans (`program_trace.py` and the five
metrics that use it) on made-up device records and program spans."""
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT) if p not in sys.path]

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from nshedb_bench import harness  # noqa: E402
from nshedb_bench.trace import Trace  # noqa: E402
from repro_torch.runtime.tracing import Span  # noqa: E402

READERS = ("verify_s", "backend_host_s", "idle_in_backend_s", "idle_above_backend_s",
           "issue_us_per_launch")
K = "void pointwise_kernel<MulOp>(long const*, long*)"


def _trace(busy, start=0, end=200):
    return Trace((np.array([s for s, _ in busy], dtype=np.int64),
                  np.array([e for _, e in busy], dtype=np.int64),
                  np.zeros(len(busy), dtype=np.int64), [K]), start, end, [])


def _spans():
    """A query [5, 150] in the traced window [0, 200], and queries that
    opened before it and after it."""
    root = Span(1, 0, 1, "query", 5, 150, {"plan": "Q6", "launches": 9,
                                           "wrapper_launches": 2, "issue_ns": 3000})
    inner = [Span(2, 1, 1, "verify", 5, 9, {"findings": 0}),
             Span(3, 1, 1, "atoms[fused]", 9, 140, None),
             Span(4, 3, 1, "bk.dot_plain", 33, 49, None),
             Span(5, 4, 1, "bk.mul_scalar", 35, 48, None),
             Span(6, 3, 1, "bk.add", 62, 70, None)]
    early = [Span(7, 0, 7, "query", -100, -10, {"wrapper_launches": 5, "issue_ns": 5}),
             Span(8, 7, 7, "bk.add", -90, -20, None)]
    late = [Span(9, 0, 9, "query", 210, 260, {"wrapper_launches": 5, "issue_ns": 5}),
            Span(10, 9, 9, "verify", 211, 250, None)]
    return inner + [root] + early[::-1] + late[::-1]


def _run(trace=True, spans=None):
    facts = {"window_start_ns": 0, "trace_end_ns": 200}
    if spans is not None:
        facts["program_spans"] = spans
    # device busy [10, 30), [50, 60), [100, 120)
    return types.SimpleNamespace(trace=_trace([(10, 30), (50, 60), (100, 120)]) if trace else None,
                                 facts=facts, queries=[], mix={})


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_gaps_inside_backend_spans_and_above_them():
    run = _run(spans=_spans())
    # the gaps cut to the query: [5, 10) above; [30, 50) midpoint 40 in
    # bk.mul_scalar: the backend; [60, 100) midpoint 80 outside bk.add,
    # inside atoms[fused]: above; [120, 150) above
    assert read("idle_in_backend_s", run) == pytest.approx(20e-9)
    assert read("idle_above_backend_s", run) == pytest.approx(75e-9)
    total = run.trace.window_s - run.trace.busy_s()
    outside = (5 - 0 + 200 - 150) * 1e-9
    assert read("idle_in_backend_s", run) + read("idle_above_backend_s", run) == pytest.approx(
        total - outside)


def test_backend_union_verify_and_issue():
    run = _run(spans=_spans())
    assert read("backend_host_s", run) == pytest.approx((49 - 33 + 70 - 62) * 1e-9)
    assert read("verify_s", run) == pytest.approx(4e-9)
    assert read("issue_us_per_launch", run) == pytest.approx(1.5)


def test_means_over_the_traced_queries():
    spans = _spans() + [Span(11, 12, 12, "bk.add", 170, 180, None),
                        Span(12, 0, 12, "query", 160, 190, {"wrapper_launches": 2,
                                                            "issue_ns": 1000})]
    run = _run(spans=spans)
    assert read("backend_host_s", run) == pytest.approx((24 + 10) / 2 * 1e-9)
    # the second query: its one gap [160, 190), midpoint 175 in bk.add
    assert read("idle_in_backend_s", run) == pytest.approx((20 + 30) / 2 * 1e-9)
    assert read("idle_above_backend_s", run) == pytest.approx(75 / 2 * 1e-9)
    assert read("issue_us_per_launch", run) == pytest.approx(1.0)


def test_spans_outside_the_traced_window_are_ignored():
    early_late = [s for s in _spans() if s.query_id != 1]
    run = _run(spans=early_late)
    for name in READERS:
        assert read(name, run) is None, name


@pytest.mark.parametrize("name", READERS)
def test_untraced_run_reads_nothing(name):
    assert read(name, _run(trace=False, spans=_spans())) is None


@pytest.mark.parametrize("name", READERS)
def test_program_without_spans_reads_nothing(name, monkeypatch):
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    run = _run()
    assert read(name, run) is None and run.facts["program_spans"] is None


def test_spans_taken_from_the_program_once():
    from repro_torch.runtime import tracing
    tracing.take()
    tracing.enable()
    try:
        with tracing.query("Q"):
            with tracing.span("verify"):
                pass
    finally:
        tracing.enable(False)
    run = _run()
    run.facts["trace_end_ns"] = tracing.clock_ns()
    run.trace = _trace([], end=run.facts["trace_end_ns"])
    assert read("verify_s", run) > 0 and read("verify_s", run) > 0
    assert tracing.take() == ([], 0) and run.facts["program_spans_dropped"] == 0
