"""scan_step_roofline: percent — the least time of the window's scan
steps, counted from the algorithm (costs/scan_step.py), over the
device's busy time in the window (the union of its intervals)."""


def read(run):
    if run.trace is None or not run.queries:
        return None
    bound = run.costs["scan_step"].step_bound_s(run.config, run.peaks) * len(run.queries)
    busy = run.trace.busy_s()
    return 100.0 * bound / busy if busy > 0 else None
