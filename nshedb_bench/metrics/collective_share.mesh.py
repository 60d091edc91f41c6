"""collective_share.mesh: percent of rank 0's busy device time (the union
of its intervals over the traced window) spent in NCCL's kernels."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.busy_s()
    nccl = run.trace.time_s(run.costs["collectives"].TRACE)
    return 100.0 * nccl / busy if nccl > 0 and busy > 0 else None
