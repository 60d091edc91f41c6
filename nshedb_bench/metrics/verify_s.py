"""verify_s: seconds a traced query in the program's `verify` span (the
static verification inside `engine/verify.verify_compiled`, before any
ciphertext work)."""
from nshedb_bench.program_trace import mean_per_query


def read(run):
    return mean_per_query(run, lambda root, spans: sum(
        s.end_ns - s.start_ns for s in spans if s.name == "verify") / 1e9)
