"""Public NTT entry points over the (..., k, n) int64 limb layout.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version.  `tabs` is the base's `LimbTables` on the tensor's device.
"""
from __future__ import annotations

from .ntt import ntt_fwd_cuda, ntt_inv_cuda
from .ref import ntt_fwd_ref, ntt_inv_ref


def _check(a, tabs):
    if a.shape[-2:] != (tabs.k, tabs.n):
        raise ValueError(f"expected (..., {tabs.k}, {tabs.n}), got {tuple(a.shape)}")


def ntt_fwd(a, tabs):
    """Forward negacyclic NTT over (..., k, n)."""
    _check(a, tabs)
    if a.is_cuda:
        return ntt_fwd_cuda(a.contiguous().view(-1, tabs.n), tabs).view(a.shape)
    return ntt_fwd_ref(a, tabs.psi, tabs.q)


def ntt_inv(a, tabs):
    """Inverse negacyclic NTT over (..., k, n)."""
    _check(a, tabs)
    if a.is_cuda:
        return ntt_inv_cuda(a.contiguous().view(-1, tabs.n), tabs).view(a.shape)
    return ntt_inv_ref(a, tabs.ipsi, tabs.ninv, tabs.q)
