"""collective_gb_per_query.mesh: GB (1e9 bytes) of collective results a
query on rank 0, all kinds: the root span's counts of
`core/collectives.collective_record`, over the traced queries."""
from nshedb_bench.program_trace import traced_queries

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def read(run):
    queries = traced_queries(run)
    if not queries:
        return None
    vals = [sum(root.attrs.get(k, 0) for k in KINDS) for root, _ in queries if root.attrs]
    return sum(vals) / len(vals) / 1e9 if vals and any(vals) else None
