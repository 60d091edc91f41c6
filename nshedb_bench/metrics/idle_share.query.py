"""Percent of the traced window in which the device ran nothing: one
minus the union of the device's intervals over the window."""
from nshedb_bench.readings import idle_share


def read(run):
    return idle_share(run)
