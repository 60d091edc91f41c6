"""The trace's interval arithmetic on made-up device records."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT) if p not in sys.path]

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from nshedb_bench.trace import Trace, short_name  # noqa: E402

MUL = ("void (anonymous namespace)::pointwise_kernel<(anonymous namespace)::MulOp>"
       "(long const*, long*)")
REM = "void at::native::elementwise_kernel<128, 2>(int, at::native::remainder_kernel_cuda)"


def trace(records, start=0, end=100, spans=()):
    names = sorted({n for _, _, n in records})
    return Trace((np.array([s for s, _, _ in records], dtype=np.int64),
                  np.array([e for _, e, _ in records], dtype=np.int64),
                  np.array([names.index(n) for _, _, n in records], dtype=np.int64), names),
                 start, end, list(spans))


def test_union_not_sum():
    t = trace([(10, 30, MUL), (20, 40, REM), (50, 60, MUL), (55, 58, REM)])
    assert t.busy_s() == pytest.approx(40e-9)             # [10, 40) and [50, 60)
    assert t.time_s() == pytest.approx((20 + 20 + 10 + 3) * 1e-9)
    assert t.time_s(r"MulOp") == pytest.approx(30e-9)
    assert t.window_s == pytest.approx(100e-9)


def test_clipped_to_the_window():
    t = trace([(-10, 10, MUL), (90, 130, REM), (200, 300, MUL)])
    assert t.busy_s() == pytest.approx(20e-9) and t.time_s() == pytest.approx(20e-9)


def test_idle_charged_to_the_innermost_span():
    spans = [(0, 100, "Q"), (0, 45, "Q:atoms"), (45, 100, "Q:aggregate")]
    t = trace([(10, 30, MUL), (20, 40, REM), (50, 60, MUL)], spans=spans)
    idle = dict(t.idle_by_label())
    # gaps [0, 10), [40, 50) (midpoint 45: aggregate), [60, 100)
    assert idle == pytest.approx({"Q:atoms": 10e-9, "Q:aggregate": 50e-9})
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s())


def test_gap_outside_spans():
    t = trace([(10, 20, MUL)], spans=[(0, 15, "Q")])
    assert dict(t.idle_by_label()) == pytest.approx({"Q": 10e-9, "outside every span": 80e-9})


def test_no_device_operation():
    t = trace([])
    assert t.busy_s() == 0 and t.by_name() == []
    assert t.idle_by_label() == [("outside every span", pytest.approx(100e-9))]


def test_short_names():
    assert short_name(MUL) == "pointwise_kernel<MulOp>"
    assert short_name(REM) == "elementwise_kernel<128, 2>"
    t = trace([(10, 30, MUL), (40, 41, REM)])
    assert [k for k, _ in t.by_name()] == [short_name(MUL), short_name(REM)]
