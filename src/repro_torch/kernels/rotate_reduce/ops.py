"""Public entry of the rotate-and-add reduction.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version.
"""
from __future__ import annotations

import torch

from .ref import rotate_reduce_ref
from .rotate_reduce import rotate_reduce_cuda


def rotate_reduce(x: torch.Tensor, t: int, chunk: int | None = None) -> torch.Tensor:
    """x: (rows, n) int64 values in [0, t), n a power of two -> same shape.

    chunk=None reduces fully (every slot = row total mod t); chunk=c, a
    power of two <= n, stops after log2(c) stages: slot i holds the
    wrapped window sum x[i] + ... + x[i + c - 1] mod t."""
    if x.dim() != 2:
        raise ValueError(f"expected (rows, n), got {tuple(x.shape)}")
    n = x.shape[1]
    if chunk is not None and (chunk < 1 or chunk & (chunk - 1) or chunk > n):
        raise ValueError(f"chunk={chunk} must be a power of two <= n={n}")
    if x.is_cuda:
        stop = n if chunk is None else chunk
        return rotate_reduce_cuda(x.contiguous(), t, stop.bit_length() - 1)
    return rotate_reduce_ref(x, t, chunk)
