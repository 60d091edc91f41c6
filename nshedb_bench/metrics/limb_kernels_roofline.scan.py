"""limb_kernels_roofline.scan: percent — the least time of the scan's
mul_mod and add_mod launches over their device time."""
from nshedb_bench.readings import limb_roofline


def read(run):
    return limb_roofline(run, ("mul_mod", "add_mod"))
