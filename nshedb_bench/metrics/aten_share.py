"""aten_share: percent of the device's time in the window spent in
operations other than the port's own limb kernels (every kernel with a
cost file): PyTorch's own kernels, copies and fills."""

LIMB_KERNELS = ("ntt_fwd", "ntt_inv", "mul_mod", "add_mod", "sub_mod")


def read(run):
    if run.trace is None:
        return None
    total = run.trace.time_s()
    own = sum(run.trace.time_s(run.costs[k].TRACE) for k in LIMB_KERNELS)
    return 100.0 * (total - own) / total if total > 0 else None
