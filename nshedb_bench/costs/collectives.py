"""The least time of a collective over M ranks of one host's cards: the
bytes a rank must receive, at the link's peak rate in one direction.

A rank of an all-gather receives the M - 1 parts it lacks: (M - 1) / M
of the result.  A rank of an all-reduce must receive, for every element
of its result, at least one value made from the other ranks' data: the
result's bytes (a ring receives 2 (M - 1) / M of them, which is as many
at M = 2); of a reduce-scatter, likewise its own slice, the result.
Sent bytes overlap received ones (the links are full duplex).

The link: NVLink 4 of an H100 SXM5, 18 links of 25 GB/s a direction,
450 GB/s a direction (900 GB/s both ways: NVIDIA's H100 data sheet).
What joined the four cards measured here: PERF.md (`nvidia-smi topo -m`).
"""
LINK_BYTES_PER_S = 450e9
TRACE = r"nccl"          # NCCL's kernels, as the profiler names them


def received_bytes(kind: str, result_bytes: float, ranks: int) -> float:
    """The fewest bytes one rank receives in a collective of `kind` whose
    result on that rank is `result_bytes`."""
    if ranks <= 1:
        return 0.0
    if kind == "all-gather":
        return (ranks - 1) / ranks * result_bytes
    if kind in ("all-reduce", "reduce-scatter"):
        return float(result_bytes)
    raise ValueError(f"no bound for a collective of kind {kind!r}")


def bound_s(kind: str, result_bytes: float, ranks: int) -> float:
    return received_bytes(kind, result_bytes, ranks) / LINK_BYTES_PER_S
