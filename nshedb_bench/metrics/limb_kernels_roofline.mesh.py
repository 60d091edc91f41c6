"""limb_kernels_roofline.mesh: percent — the least time of rank 0's
mul_mod and add_mod launches over their device time on rank 0's card."""
from nshedb_bench.readings import limb_roofline


def read(run):
    return limb_roofline(run, ("mul_mod", "add_mod"))
