"""Plain PyTorch version of the pointwise kernels: exact int64 arithmetic."""
from __future__ import annotations


def mul_mod_ref(a_i64, b_i64, q_i64):
    """(..., k, n) x (..., k, n) mod q[k]; products < 2^62, exact int64."""
    return (a_i64 * b_i64) % q_i64[:, None]


def add_mod_ref(a_i64, b_i64, q_i64):
    return (a_i64 + b_i64) % q_i64[:, None]


def sub_mod_ref(a_i64, b_i64, q_i64):
    return (a_i64 - b_i64) % q_i64[:, None]
