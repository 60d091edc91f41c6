"""limb_kernels_roofline.query: percent — the least time of the query's
launches of the five limb kernels over their device time."""
from nshedb_bench.readings import limb_roofline


def read(run):
    return limb_roofline(run, ("ntt_fwd", "ntt_inv", "mul_mod", "add_mod", "sub_mod"))
