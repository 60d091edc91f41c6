"""Exact modular arithmetic on 32-bit residues — plain PyTorch twins of the
device functions in csrc/u32.cuh, and the host-side constant precompute.

The tensors are int64 holding values in [0, 2^32); every function keeps
its intermediates inside int64 without relying on wrap-around, so the
property tests can hold each one against Python big-int arithmetic:

  mulhi_u32      high 32 bits of a 32x32 product
  mullo_u32      low 32 bits of a 32x32 product
  shoup_mulmod   a * w mod q with w' = floor(w * 2^32 / q) precomputed —
                 one mulhi + one wrapping mul-sub (twiddles)
  barrett_mulmod general a * b mod q with mu = floor(2^64 / q): quotient
                 estimate from the high half of a 64x64 product, one
                 conditional subtraction
  add_mod / sub_mod

Moduli are odd with 2^28 < q < 2^31 (`check_modulus`): the 30-bit
ciphertext base and the 31-bit auxiliary base both qualify.
"""
from __future__ import annotations

import torch

Q_MIN, Q_MAX = 1 << 28, 1 << 31
_M32 = 0xFFFFFFFF


def check_modulus(q: int) -> int:
    """q if the kernels accept it as a modulus, else ValueError."""
    q = int(q)
    if not (Q_MIN < q < Q_MAX and q % 2 == 1):
        raise ValueError(f"modulus {q} outside the kernels' window: "
                         f"odd, 2^28 < q < 2^31")
    return q


def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product of two u32-valued int64 tensors."""
    a1, a0 = a >> 16, a & 0xFFFF
    b1, b0 = b >> 16, b & 0xFFFF
    lo = a0 * b0
    mid1 = a1 * b0
    mid2 = a0 * b1
    t = (lo >> 16) + (mid1 & 0xFFFF) + (mid2 & 0xFFFF)       # < 3 * 2^16
    return a1 * b1 + (mid1 >> 16) + (mid2 >> 16) + (t >> 16)


def mullo_u32(a, b):
    """Low 32 bits of the product (what a wrapping uint32 multiply gives)."""
    a1, a0 = a >> 16, a & 0xFFFF
    b1, b0 = b >> 16, b & 0xFFFF
    return (a0 * b0 + (((a1 * b0 + a0 * b1) & 0xFFFF) << 16)) & _M32


def shoup_precompute(w: int, q: int) -> int:
    """w' = floor(w * 2^32 / q) — host-side Python int math."""
    return (int(w) << 32) // int(q)


def shoup_mulmod(a, w, w_shoup, q):
    """a * w mod q with precomputed w' (Longa-Naehrig).  Result < q."""
    hi = mulhi_u32(a, w_shoup)
    r = (mullo_u32(a, w) - mullo_u32(hi, q)) & _M32   # true value in [0, 2q)
    return torch.where(r >= q, r - q, r)


def barrett_precompute(q: int) -> int:
    """mu = floor(2^64 / q); q > 2^28 keeps mu < 2^36."""
    return (1 << 64) // check_modulus(q)


def _umul64hi(p, mu):
    """High 64 bits of p * mu for p < 2^62, mu < 2^36 (int64 tensors)."""
    p1, p0 = p >> 32, p & _M32
    m1, m0 = mu >> 32, mu & _M32
    mid = p1 * m0 + p0 * m1 + mulhi_u32(p0, m0)       # < 2^62 + 2^36 + 2^32
    return p1 * m1 + (mid >> 32)


def barrett_mulmod(a, b, q, mu):
    """General a*b mod q (a, b < q < 2^31).

    P = a*b < 2^62; qhat = floor(P * mu / 2^64) is floor(P/q) or one
    less, so r = P - qhat*q lies in [0, 2q): one conditional subtraction.
    """
    p = a * b
    r = p - _umul64hi(p, mu) * q
    return torch.where(r >= q, r - q, r)


def add_mod(a, b, q):
    s = a + b                                         # < 2q < 2^32
    return torch.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    return torch.where(a >= b, a - b, a + q - b)
