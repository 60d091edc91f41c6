"""Plain PyTorch version of the rotate_reduce kernel: the doubling loop."""
from __future__ import annotations

import torch


def rotate_reduce_ref(x: torch.Tensor, t, chunk: int | None = None) -> torch.Tensor:
    """x: (rows, n) int32 or int64 values mod t; t an int or a (rows, 1)
    table of per-row moduli.  Full reduce -> every slot = row sum;
    chunked -> slot i holds sum of its chunk's wrapped window.  The loop
    adds in int64 (two values below t < 2^31 pass int32) and returns x's
    dtype."""
    stop = x.shape[1] if chunk is None else chunk
    out = x.to(torch.int64)
    s = 1
    while s < stop:
        out = torch.remainder(out + torch.roll(out, -s, dims=1), t)
        s *= 2
    return out.to(x.dtype)
