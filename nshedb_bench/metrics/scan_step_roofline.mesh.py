"""scan_step_roofline.mesh: percent — the least time of rank 0's part of
the window's scan steps on the mesh, counted from the algorithm
(costs/scan_step_mesh.py: its blocks, its output limbs of all k digits
and the digits' all-gather), over rank 0's device busy time in the
window (the union of its intervals)."""


def read(run):
    if run.trace is None or not run.queries or "mesh" not in run.config:
        return None
    bound = run.costs["scan_step_mesh"].rank_bound_s(run.config, run.peaks,
                                                     run.costs["collectives"])
    busy = run.trace.busy_s()
    return 100.0 * bound * len(run.queries) / busy if busy > 0 else None
