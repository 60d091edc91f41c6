"""Public entry of the fast base conversion over the (..., k, n) int64
limb layout.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version.  On the card the leading axes are flattened to the
kernel's rows without a copy where they collapse to one stride (one
component of a stacked ciphertext does); otherwise the rows are copied
out first.
"""
from __future__ import annotations

import torch

from .baseconv import base_conv_cuda, readable
from .ref import base_conv_ref


def base_conv(x: torch.Tensor, tabs) -> torch.Tensor:
    """(..., ka, n) residues in [0, a_i) mod the input base of `tabs` (a
    `kernels.tables.BaseConvTables`) -> (..., kb, n) in [0, b_j) mod its
    output base: the centered value of x, exactly."""
    if x.dim() < 2 or x.shape[-2] != tabs.ka:
        raise ValueError(f"expected (..., {tabs.ka}, n), got {tuple(x.shape)}")
    if not x.is_cuda:
        return base_conv_ref(x, tabs)
    *lead, ka, n = x.shape
    rows = x.reshape(-1, ka, n)
    if not readable(rows):
        rows = rows.contiguous()
    return base_conv_cuda(rows, tabs).view(*lead, tabs.kb, n)
