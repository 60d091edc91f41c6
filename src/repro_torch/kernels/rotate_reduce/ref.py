"""Plain PyTorch version of the rotate_reduce kernel: the doubling loop."""
from __future__ import annotations

import torch


def rotate_reduce_ref(x: torch.Tensor, t: int, chunk: int | None = None) -> torch.Tensor:
    """x: (rows, n) ints mod t.  Full reduce -> every slot = row sum;
    chunked -> slot i holds sum of its chunk's wrapped window."""
    stop = x.shape[1] if chunk is None else chunk
    out = x
    s = 1
    while s < stop:
        out = torch.remainder(out + torch.roll(out, -s, dims=1), t)
        s *= 2
    return out
