"""Plain PyTorch version of the pointwise kernels: exact int64 arithmetic.

Inputs are residues in [0, q).  The sum and the difference are brought
back into [0, q) by one conditional correction, as the kernels do
(`csrc/u32.cuh`), not by a division.

The key switch's plain version reduces each digit product mod q_j and
then their sum: the contraction the kernel computes with lazy reduction.
"""
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


def keyswitch_ref(digits, key_b, key_a, q_i64):
    """(..., kd, n) digits (below 2^31) by two (kd, kj, n) keys (below
    q_j): sum_i (digit_i * key[i, j] mod q_j), mod q_j, for each key, in
    exact int64 — each product below 2^62, the sum of kd residues below
    kd * 2^31 — one digit at a time, so nothing of size (..., kd, kj, n)
    is held."""
    d = digits.to(dtype=q_i64.dtype).unsqueeze(-2)          # (..., kd, 1, n)
    q = q_i64[:, None]
    out = []
    for key in (key_b, key_a):
        acc = d[..., 0, :, :] * key[0] % q
        for i in range(1, key.shape[0]):
            acc += d[..., i, :, :] * key[i] % q
        out.append(acc % q)
    return tuple(out)
