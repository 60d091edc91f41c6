"""keyswitch_roofline.scan: percent — the least time of the scan's
keyswitch launches (costs/keyswitch.py) over their device time; in the
mesh cell rank 0's launches on rank 0's card."""
from nshedb_bench.readings import limb_roofline


def read(run):
    return limb_roofline(run, ("keyswitch",))
