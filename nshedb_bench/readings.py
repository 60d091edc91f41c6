"""Arithmetic the metric readers of `metrics/` share.  Each returns None
where the run has nothing to read, and the harness then leaves the
metric out of the result."""
from __future__ import annotations


def mean_stage_s(run, label: str):
    """Seconds of executor stage `label` a query, over the traced window."""
    vals = [q["stages_s"][label] for q in run.queries if label in q.get("stages_s", {})]
    return sum(vals) / len(vals) if vals else None


def limb_roofline(run, kernels):
    """Percent: the summed least time of the launches of `kernels` (their
    cost files over the launch counts by shape) over the device time the
    trace gives those kernels."""
    if run.trace is None:
        return None
    by_shape = run.facts.get("launches_by_shape", {})
    bound = busy = 0.0
    for name in kernels:
        cost = run.costs[name]
        bound += sum(count * cost.bound_s(shape, run.config["n"], run.peaks)
                     for shape, count in by_shape.get(name, {}).items())
        busy += run.trace.time_s(cost.TRACE)
    return 100.0 * bound / busy if bound > 0 and busy > 0 else None


def idle_share(run):
    """Percent of the traced window in which the device ran nothing."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy = run.trace.busy_s()
    return 100.0 * (1.0 - busy / run.trace.window_s) if busy > 0 else None


def peak_gb(run):
    """Peak device memory allocated in the window, GB (1e9 bytes)."""
    peak = run.facts.get("peak_window_bytes", 0)
    return peak / 1e9 if peak else None
