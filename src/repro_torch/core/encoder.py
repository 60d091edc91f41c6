"""BFV batch encoder: n integer slots per plaintext polynomial.

Slots are the CRT components of R_t = Z_t[X]/(X^n+1) (t prime, 2n | t-1),
laid out as 2 rows x n/2 columns so that the Galois element 3^r rotates
rows by r and 2n-1 swaps rows (see params._make_slot_map).

Encoding is client-side work: it runs on the CPU through the plain NTT
and hands numpy polynomials to the caller, which moves each across to
the evaluation device once.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ntt as nttm
from .params import HEParams


class BatchEncoder:
    def __init__(self, params: HEParams):
        self.params = params
        T = params.T
        self.qt = torch.from_numpy(T.q)
        self.psi = torch.from_numpy(T.psi_rev)
        self.ipsi = torch.from_numpy(T.ipsi_rev)
        self.ninv = torch.from_numpy(T.n_inv)
        self.slot_to_coeff = np.asarray(params.slot_to_coeff)
        # inverse permutation: coeff index -> slot
        inv = np.zeros(params.n, dtype=np.int32)
        inv[self.slot_to_coeff] = np.arange(params.n)
        self.coeff_to_slot = inv

    def encode(self, values) -> np.ndarray:
        """values: up to n ints (taken mod t); returns plaintext poly (n,)."""
        p = self.params
        vals = np.asarray(values, dtype=np.int64) % p.t
        if vals.shape[0] < p.n:
            vals = np.concatenate([vals, np.zeros(p.n - vals.shape[0], dtype=np.int64)])
        evals = torch.from_numpy(vals[self.coeff_to_slot][None, :])
        poly = nttm.intt_ref(evals, self.ipsi, self.ninv, self.qt)
        return poly[0].numpy()

    def decode(self, poly) -> np.ndarray:
        poly = torch.as_tensor(np.asarray(poly, dtype=np.int64))
        evals = nttm.ntt_ref(poly[None, :], self.psi, self.qt)[0].numpy()
        return evals[self.slot_to_coeff]

    def decode_signed(self, poly) -> np.ndarray:
        """Decode with centered representatives in (-t/2, t/2]."""
        v = self.decode(poly)
        t = self.params.t
        return v - t * (v > t // 2)

    # Common mask plaintexts -------------------------------------------------
    def constant(self, c: int) -> np.ndarray:
        return self.encode(np.full(self.params.n, c, dtype=np.int64))

    def basis(self, slot: int) -> np.ndarray:
        """All-zeros except a single 1 at `slot` (the paper's Extract mask)."""
        v = np.zeros(self.params.n, dtype=np.int64)
        v[slot] = 1
        return self.encode(v)
