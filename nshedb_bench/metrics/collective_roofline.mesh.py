"""collective_roofline.mesh: percent — the least time of the traced
queries' collectives on rank 0 (costs/collectives.py over each
`coll.<kind>` span's kind, ranks and result bytes) over the device time
of NCCL's kernels in the traced window."""
from nshedb_bench.program_trace import traced_queries

PREFIX = "coll."


def read(run):
    queries = traced_queries(run)
    if not queries:
        return None
    cost = run.costs["collectives"]
    bound = sum(cost.bound_s(s.name[len(PREFIX):], s.attrs["bytes"], s.attrs["ranks"])
                for _, spans in queries for s in spans
                if s.name.startswith(PREFIX) and s.attrs)
    busy = run.trace.time_s(cost.TRACE)
    return 100.0 * bound / busy if bound > 0 and busy > 0 else None
