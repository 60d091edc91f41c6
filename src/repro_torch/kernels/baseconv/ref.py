"""Plain PyTorch version of the fast base conversion kernel
(csrc/baseconv.cu): exact int64 residues, a float64 sum over limbs."""
from __future__ import annotations

import torch


def limb_dot_f64(y, w):
    """sum_i y[..., i, :] * w[i] in float64, accumulated limb by limb
    in index order (a fixed order keeps the rounding reproducible)."""
    acc = y[..., 0, :].to(torch.float64) * w[0]
    for i in range(1, y.shape[-2]):
        acc = acc + y[..., i, :].to(torch.float64) * w[i]
    return acc


def base_conv_ref(x, tabs):
    """Exact fast base conversion of the centered value of x.

    x: (..., ka, n) residues mod the input base of `tabs` (a
    `BaseConvTables`) -> (..., kb, n) mod its output base.  Products stay
    < 2^62, exact in int64.  The sum over input limbs runs one limb at a
    time, so the (ka, kb, n) term tensor is never held whole.
    """
    hat_inv, hat_mod_b, a_mod_b, a_inv = tabs.hat_inv, tabs.hat_mod_b, tabs.a_mod_b, tabs.a_inv
    y = (x * hat_inv[:, None]) % tabs.in_q[:, None]
    v = torch.round(limb_dot_f64(y, a_inv)).to(torch.int64)
    ob = tabs.out_q[:, None]
    acc = None                                        # (..., kb, n) < ka * b_j
    for i in range(y.shape[-2]):
        term = (y[..., i, None, :] * hat_mod_b[i][:, None]) % ob
        acc = term if acc is None else acc + term
    return (acc - v[..., None, :] * a_mod_b[:, None]) % ob
