"""atoms_s: seconds of the executor's `atoms[fused]` stage a query (the
fused comparison circuits), host clock after a synchronize."""
from nshedb_bench.readings import mean_stage_s


def read(run):
    return mean_stage_s(run, "atoms[fused]")
