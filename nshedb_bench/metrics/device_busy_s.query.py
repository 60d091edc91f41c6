"""device_busy_s.query: seconds a query in which the device runs any
operation (the union of its intervals over the traced queries, per
query): the device's share of `query_s`, steadier than it where the
host sets the pace."""


def read(run):
    if run.trace is None:
        return None
    traced = run.mix.get("trace_queries") or len(run.queries)
    busy = run.trace.busy_s()
    return busy / min(traced, len(run.queries)) if busy > 0 else None
