"""Plain PyTorch version of the pointwise kernels: exact int64 arithmetic.

Inputs are residues in [0, q).  The sum and the difference are brought
back into [0, q) by one conditional correction, as the kernels do
(`csrc/u32.cuh`), not by a division."""
from __future__ import annotations


def mul_mod_ref(a_i64, b_i64, q_i64):
    """(..., k, n) x (..., k, n) mod q[k]; products < 2^62, exact int64."""
    return (a_i64 * b_i64) % q_i64[:, None]


def add_mod_ref(a_i64, b_i64, q_i64):
    q = q_i64[:, None]
    s = a_i64 + b_i64
    return s - q * (s >= q)


def sub_mod_ref(a_i64, b_i64, q_i64):
    q = q_i64[:, None]
    d = a_i64 - b_i64
    return d + q * (d < 0)
