"""aggregate_s: seconds of the executor's `aggregate` stage a query
(group masks, masked sums with their rotations, the decrypts), host
clock after a synchronize."""
from nshedb_bench.readings import mean_stage_s


def read(run):
    return mean_stage_s(run, "aggregate")
