"""issue_us_per_launch: microseconds of host time a kernel launch, from
a launch wrapper's entry to its return (`kernels/*/*.py`), summed by
the program into each traced query's span, over the launches summed
with them."""
from nshedb_bench.program_trace import traced_queries


def read(run):
    queries = traced_queries(run)
    if not queries:
        return None
    ns = sum(root.attrs.get("issue_ns", 0) for root, _ in queries)
    launches = sum(root.attrs.get("wrapper_launches", 0) for root, _ in queries)
    return ns / launches / 1e3 if launches else None
