"""Public entry of the rotate-and-add reduction.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version.  Both take the same arguments and refuse the same ones.
"""
from __future__ import annotations

import torch

from .ref import rotate_reduce_ref
from .rotate_reduce import check_args, rotate_reduce_cuda


def rotate_reduce(x: torch.Tensor, t, chunk: int | None = None) -> torch.Tensor:
    """x: (rows, n) int32 or int64 values in [0, t_row), n a power of two
    -> the same shape and dtype.  t: an int, standing for every row, or a
    (rows, 1) int32 / int64 table of per-row moduli on x's device, each
    in (1, 2^31) — what `rotate_reduce_pallas` takes.

    chunk=None reduces fully (every slot = row total mod t); chunk=c, a
    power of two <= n, stops after log2(c) stages: slot i holds the
    wrapped window sum x[i] + ... + x[i + c - 1] mod t.  Chunk mode takes
    n up to `rotate_reduce.MAX_CHUNK_N`."""
    if x.dim() != 2:
        raise ValueError(f"expected (rows, n), got {tuple(x.shape)}")
    n = x.shape[1]
    if chunk is not None and (chunk < 1 or chunk & (chunk - 1) or chunk > n):
        raise ValueError(f"chunk={chunk} must be a power of two <= n={n}")
    stop_log = (n if chunk is None else chunk).bit_length() - 1
    if x.is_cuda:
        return rotate_reduce_cuda(x.contiguous(), t, stop_log)
    check_args(x, t, stop_log)
    return rotate_reduce_ref(x, t, chunk)
