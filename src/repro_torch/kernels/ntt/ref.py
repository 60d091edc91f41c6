"""Plain PyTorch version of the NTT kernels: core/ntt.py's int64 transform."""
from __future__ import annotations

from ...core.ntt import intt_ref, ntt_ref  # noqa: F401


def ntt_fwd_ref(a_i64, psi_rev_i64, q_i64):
    """(..., k, n) int64 forward negacyclic NTT (exact 62-bit products)."""
    return ntt_ref(a_i64, psi_rev_i64, q_i64)


def ntt_inv_ref(a_i64, ipsi_rev_i64, n_inv_i64, q_i64):
    return intt_ref(a_i64, ipsi_rev_i64, n_inv_i64, q_i64)
