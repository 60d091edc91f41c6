"""Percent of the traced window in which rank 0's card ran nothing: one
minus the union of its intervals over the window."""
from nshedb_bench.readings import idle_share


def read(run):
    return idle_share(run)
