"""idle_in_backend_s: device-idle seconds a traced query whose gap (cut
to the query's span) has its midpoint inside one of the program's
`bk.*` spans: the card waiting while the host runs a backend op."""
from nshedb_bench.program_trace import idle_split, mean_per_query


def read(run):
    return mean_per_query(run, lambda root, spans: idle_split(run, root, spans)[0])
