"""The program's own spans (`repro_torch.runtime.tracing`) beside the
device trace, for the readers of `metrics/` that read them.

A traced run opens the profiler before the window, which turns the
program's recording on for each query that starts under it.  After the
window the spans are taken from the program once and kept in
`run.facts["program_spans"]`; those of the queries whose root span
opened in the traced part of the window ([window_start_ns,
trace_end_ns]) are read.  Each idle gap between the device's busy
segments, cut to its query's root span, is charged by its midpoint: to
the backend when a `bk.*` span is around it, else to what runs above
the backend.  Every function returns None where the run has nothing to
read: an untraced run, or a program that records no spans.
"""
from __future__ import annotations

import numpy as np

from .trace import Trace

BACKEND = "bk."        # the prefix of the backend's op spans


def program_spans(run):
    """Every span the program recorded in the run, or None."""
    if "program_spans" not in run.facts:
        try:
            from repro_torch.runtime import tracing
        except ImportError:
            run.facts["program_spans"] = None
        else:
            run.facts["program_spans"], run.facts["program_spans_dropped"] = tracing.take()
    return run.facts["program_spans"]


def traced_queries(run):
    """[(root span, [its spans])] of the traced queries, in order, or None."""
    if run.trace is None:
        return None
    spans = program_spans(run)
    if not spans:
        return None
    lo, hi = run.facts["window_start_ns"], run.facts["trace_end_ns"]
    roots = sorted((s for s in spans if s.parent_id == 0 and lo <= s.start_ns <= hi),
                   key=lambda s: s.start_ns)
    by_query = {r.query_id: [] for r in roots}
    for s in spans:
        if s.query_id in by_query and s.parent_id != 0:
            by_query[s.query_id].append(s)
    return [(r, by_query[r.query_id]) for r in roots] or None


def backend_union(root, spans) -> Trace:
    """The union of a query's `bk.*` spans, by the trace's interval
    arithmetic (its busy segments, cut to the query's root span)."""
    bk = [(s.start_ns, s.end_ns) for s in spans if s.name.startswith(BACKEND)]
    return Trace((np.array([a for a, _ in bk], dtype=np.int64),
                  np.array([b for _, b in bk], dtype=np.int64),
                  np.zeros(len(bk), dtype=np.int64), [BACKEND]), root.start_ns, root.end_ns, [])


def idle_split(run, root, spans) -> tuple[float, float]:
    """(idle seconds in the backend, idle seconds above it) inside one
    query's root span: the device's idle gaps cut to the span, each
    charged by its midpoint."""
    tr = run.trace
    lo = np.append(tr.start_ns, tr.seg_ends)
    hi = np.append(tr.seg_starts, tr.end_ns)
    lo, hi = np.maximum(lo, root.start_ns), np.minimum(hi, root.end_ns)
    gap = hi > lo
    lo, hi = lo[gap], hi[gap]
    mid = (lo + hi) // 2
    bk = backend_union(root, spans)
    b_lo, b_hi = bk.seg_starts, bk.seg_ends
    j = np.searchsorted(b_lo, mid, side="right") - 1
    inside = (j >= 0) & (mid < b_hi[np.maximum(j, 0)]) if len(b_lo) else np.zeros(len(mid), bool)
    idle = hi - lo
    return float(idle[inside].sum()) / 1e9, float(idle[~inside].sum()) / 1e9


def mean_per_query(run, fn):
    """The mean of `fn(root, spans)` over the traced queries, or None."""
    queries = traced_queries(run)
    if not queries:
        return None
    return sum(fn(root, spans) for root, spans in queries) / len(queries)
