"""Plain reference of the paper's encrypted equality scan step, in
PyTorch int64 operations, on whatever device its inputs lie.

For every block (a ciphertext (2, k, n) of residues in the evaluation
domain): an EQ mask by `eq_levels` squarings, each relinearised by a key
switch; one multiply by the value block, relinearised; a rotate-reduce of
`rot_steps` hops, each x + rotate(x), a rotate being a permutation of the
slots and a key switch of its second component; then the sum over
blocks.  Every operation is mod q_j on limb j.

The key switch of a polynomial p (limb i of which is digit i) by a key K
(k digits x k limbs x n) is, on output limb j, sum_i p_i * K[i, j] mod
q_j: the digit is its limb's residue, not reduced mod q_j.

`mulmod` is "exact" (the int64 product of two residues below 2^30,
below 2^60, then mod q) or "float64" — the product rounded to float64's
53 bits first: the control that a lower precision fails.

Imports nothing of the program.  The moduli and the permutation are
worked out here from the configuration (`primes`, `galois_perm`).
"""
from __future__ import annotations

import numpy as np
import torch


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    small = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41)
    for p in small:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in small:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def primes(n: int, bits: int, count: int) -> list[int]:
    """The `count` largest primes q = 1 mod 2n below 2^bits, descending:
    the configuration's RNS base."""
    step = 2 * n
    q = (1 << bits) - ((1 << bits) - 1) % step
    out = []
    while len(out) < count:
        if q <= step:
            raise ValueError(f"no {count} {bits}-bit primes = 1 mod {step}")
        if _is_prime(q):
            out.append(q)
        q -= step
    return out


def galois_perm(n: int) -> np.ndarray:
    """The configuration's stand-in Galois map: the permutation of the n
    slots drawn by numpy's generator seeded with 0."""
    return np.random.default_rng(0).permutation(n).astype(np.int64)


class Step:
    """The step's arithmetic over the moduli `q` ((k,) int64 tensor)."""

    def __init__(self, q: torch.Tensor, perm: torch.Tensor, mulmod: str = "exact"):
        if mulmod not in ("exact", "float64"):
            raise ValueError(f"mulmod {mulmod!r}")
        self.q = q[:, None]                  # (k, 1): broadcasts over (..., k, n)
        self.qf = self.q.double()
        self.perm = perm
        self.exact = mulmod == "exact"

    def mul(self, a, b):
        if self.exact:
            return a * b % self.q
        return torch.remainder(a.double() * b.double(), self.qf).long()

    def add(self, a, b):
        return (a + b) % self.q

    def keyswitch(self, p, key):
        """p (B, k, n) digits, key (k, k, n) -> (B, k, n)."""
        acc = torch.zeros_like(p)
        for i in range(p.shape[-2]):
            acc += self.mul(p[:, i:i + 1, :], key[i])
        return acc % self.q

    def relin(self, d0, d1, d2, kb, ka):
        return torch.stack([self.add(d0, self.keyswitch(d2, kb)),
                            self.add(d1, self.keyswitch(d2, ka))], 1)

    def square(self, ct, kb, ka):
        c0, c1 = ct[:, 0], ct[:, 1]
        d1 = self.mul(c0, c1)
        return self.relin(self.mul(c0, c0), self.add(d1, d1), self.mul(c1, c1), kb, ka)

    def ct_mul(self, a, b, kb, ka):
        d1 = self.add(self.mul(a[:, 0], b[:, 1]), self.mul(a[:, 1], b[:, 0]))
        return self.relin(self.mul(a[:, 0], b[:, 0]), d1, self.mul(a[:, 1], b[:, 1]), kb, ka)

    def rotate(self, ct, kb, ka):
        rot = ct[..., self.perm]
        return torch.stack([self.add(rot[:, 0], self.keyswitch(rot[:, 1], kb)),
                            self.keyswitch(rot[:, 1], ka)], 1)


def scan(col, val, keys, q, perm, *, eq_levels: int, rot_steps: int,
         mulmod: str = "exact"):
    """The step's aggregate (2, k, n) of `col` and `val` ((nblocks, 2, k,
    n) residues, all blocks in one pass: 64 blocks take a few GB);
    `keys` = (rlk_b, rlk_a, gk_b, gk_a), each (k, k, n)."""
    st = Step(q, perm, mulmod)
    rlk_b, rlk_a, gk_b, gk_a = keys
    mask = col
    for _ in range(eq_levels):
        mask = st.square(mask, rlk_b, rlk_a)
    out = st.ct_mul(mask, val, rlk_b, rlk_a)
    for _ in range(rot_steps):
        out = st.add(out, st.rotate(out, gk_b, gk_a))
    return out.sum(0) % st.q
