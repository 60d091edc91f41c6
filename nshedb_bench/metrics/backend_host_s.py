"""backend_host_s: seconds a traced query in which the host is inside a
`BFVBackend` op (the union of the program's `bk.*` spans): the host's
time issuing ciphertext operations."""
from nshedb_bench.program_trace import backend_union, mean_per_query


def read(run):
    return mean_per_query(run, lambda root, spans: backend_union(root, spans).busy_s())
