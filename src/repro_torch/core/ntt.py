"""Negacyclic number-theoretic transform — plain PyTorch versions.

Layout convention: polynomials are (k, n) int64 tensors — k RNS limbs of
an n-coefficient polynomial, coefficients in [0, q_i). The forward
transform uses Cooley-Tukey butterflies with premultiplied psi powers
(Longa-Naehrig) and produces the evaluation vector in bit-reversed order;
the inverse uses Gentleman-Sande butterflies and consumes that order, so
pointwise products round-trip without explicit bit-reversal passes.

This module is (a) the execution path for tensors on the CPU and (b) the
plain version the CUDA kernels in kernels/ntt are held against. Products
are <= (2^31-1)^2 < 2^63: exact in int64.  `%` on tensors is
`torch.remainder`, which floors like Python for a positive modulus.
"""
from __future__ import annotations

import numpy as np
import torch


def ntt_ref(a, psi_rev, q):
    """Forward negacyclic NTT. a: (..., k, n); psi_rev: (k, n); q: (k,).

    Leading batch axes share the per-limb tables by broadcasting."""
    shape = a.shape
    lead, n = shape[:-1], shape[-1]
    qc = q[:, None, None]
    log_n = n.bit_length() - 1
    for s in range(log_n):
        m = 1 << s
        t_len = n >> (s + 1)
        a = a.reshape(*lead, m, 2, t_len)
        S = psi_rev[:, m : 2 * m]  # (k, m)
        U = a[..., 0, :]
        V = (a[..., 1, :] * S[:, :, None]) % qc
        a = torch.stack([(U + V) % qc, (U - V) % qc], dim=-2)
    return a.reshape(shape)


def intt_ref(a, ipsi_rev, n_inv, q):
    """Inverse negacyclic NTT (consumes bit-reversed evaluation order)."""
    shape = a.shape
    lead, n = shape[:-1], shape[-1]
    qc = q[:, None, None]
    log_n = n.bit_length() - 1
    for s in range(log_n):
        t_len = 1 << s
        h = n >> (s + 1)
        a = a.reshape(*lead, h, 2, t_len)
        S = ipsi_rev[:, h : 2 * h]  # (k, h)
        U = a[..., 0, :]
        V = a[..., 1, :]
        a = torch.stack([(U + V) % qc, ((U - V) * S[:, :, None]) % qc], dim=-2)
    a = a.reshape(shape)
    return (a * n_inv[:, None]) % q[:, None]


def pointwise_mul(a, b, q):
    """Hadamard product of evaluation vectors. (k, n) x (k, n) -> (k, n)."""
    return (a * b) % q[:, None]


def polymul_ref(a, b, tables):
    """Full negacyclic polynomial product via NTT (test helper).

    `tables` is an `NttTables`; its numpy arrays are moved to a's device."""
    dev = a.device
    q = torch.from_numpy(tables.q).to(dev)
    psi = torch.from_numpy(tables.psi_rev).to(dev)
    ipsi = torch.from_numpy(tables.ipsi_rev).to(dev)
    ninv = torch.from_numpy(tables.n_inv).to(dev)
    fa = ntt_ref(a, psi, q)
    fb = ntt_ref(b, psi, q)
    return intt_ref(pointwise_mul(fa, fb, q), ipsi, ninv, q)


def negacyclic_naive(a, b, q):
    """O(n^2) schoolbook negacyclic product — independent oracle for tests.

    a, b: (n,) python/numpy int arrays (single limb); returns (n,) mod q.
    """
    n = len(a)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        ai = int(a[i])
        if ai == 0:
            continue
        for j in range(n):
            e = i + j
            v = ai * int(b[j])
            if e < n:
                out[e] += v
            else:
                out[e - n] -= v
    return np.array([int(x) % q for x in out], dtype=np.int64)
