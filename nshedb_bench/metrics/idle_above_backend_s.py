"""idle_above_backend_s: device-idle seconds a traced query inside its
`query` span but outside every `bk.*` span: the card waiting while the
host runs the executor, planner, circuits or verifier."""
from nshedb_bench.program_trace import idle_split, mean_per_query


def read(run):
    return mean_per_query(run, lambda root, spans: idle_split(run, root, spans)[1])
