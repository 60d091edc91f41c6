"""launches_per_query: the backend's `OpStats.launches` (batched engine
calls) a query, over the traced window: an exact count."""


def read(run):
    vals = [q["launches"] for q in run.queries if "launches" in q]
    return sum(vals) / len(vals) if vals else None
