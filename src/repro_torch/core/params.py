"""BFV parameter sets and precomputed tables.

NSHEDB (the paper) uses SEAL BFV with n = 32,768, log Q = 881, t = 65,537
(HE-standard 128-bit row).  We realize the same scheme in double-CRT (RNS)
form: Q is a product of 30-bit NTT-friendly primes so that all runtime
arithmetic is exact in int64 on the host path and exact in uint32
limb arithmetic inside the CUDA kernels (see kernels/modops).

Bases:
  Q  — the ciphertext base (k limbs).
  P  — the auxiliary base used by HPS RNS multiplication (k+1 limbs),
       P > n * Q / 2 guarantees the tensor product never wraps in Q∪P.

All tables are numpy arrays computed once per parameter set with exact
Python integer arithmetic (mathutil.py).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .mathutil import (
    bit_reverse,
    find_ntt_primes,
    modinv,
    primitive_root,
    root_of_unity,
)

# Galois generator for slot rotations (standard BFV batching uses 3).
GALOIS_GEN = 3


@dataclasses.dataclass(frozen=True, eq=False)
class NttTables:
    """Per-base NTT tables: bit-reversed twiddles for CT/GS butterflies."""

    primes: tuple[int, ...]
    q: np.ndarray          # (k,) int64
    psi_rev: np.ndarray    # (k, n) int64  — psi^bitrev(i), psi a 2n-th root
    ipsi_rev: np.ndarray   # (k, n) int64  — psi^-bitrev(i)
    n_inv: np.ndarray      # (k,) int64    — n^-1 mod q

    @property
    def k(self) -> int:
        return len(self.primes)


def _make_ntt_tables(primes: list[int], n: int) -> NttTables:
    log_n = n.bit_length() - 1
    k = len(primes)
    psi_rev = np.zeros((k, n), dtype=np.int64)
    ipsi_rev = np.zeros((k, n), dtype=np.int64)
    n_inv = np.zeros((k,), dtype=np.int64)
    for li, q in enumerate(primes):
        psi = root_of_unity(2 * n, q)
        ipsi = modinv(psi, q)
        pw, ipw = 1, 1
        pws = np.zeros(n, dtype=np.int64)
        ipws = np.zeros(n, dtype=np.int64)
        for i in range(n):
            pws[i] = pw
            ipws[i] = ipw
            pw = pw * psi % q
            ipw = ipw * ipsi % q
        rev = np.array([bit_reverse(i, log_n) for i in range(n)])
        psi_rev[li] = pws[rev]
        ipsi_rev[li] = ipws[rev]
        n_inv[li] = modinv(n, q)
    return NttTables(
        primes=tuple(primes),
        q=np.array(primes, dtype=np.int64),
        psi_rev=psi_rev,
        ipsi_rev=ipsi_rev,
        n_inv=n_inv,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class BaseConv:
    """Constants for exact HPS fast base conversion A -> B.

    For x given by residues x_i mod a_i with centered value X:
      y_i = x_i * AHatInv_i  mod a_i
      v   = round(sum_i y_i / a_i)                (float64)
      X   = sum_i y_i * AHat_i  -  v * A          (exact)
      out_j = (sum_i y_i * AHat_i - v*A) mod b_j
    """

    a_hat_inv_mod_a: np.ndarray  # (ka,)
    a_hat_mod_b: np.ndarray      # (ka, kb)
    a_mod_b: np.ndarray          # (kb,)
    a_inv: np.ndarray            # (ka,) float64 = 1/a_i


def _make_base_conv(a: list[int], b: list[int]) -> BaseConv:
    A = 1
    for ai in a:
        A *= ai
    a_hat = [A // ai for ai in a]
    return BaseConv(
        a_hat_inv_mod_a=np.array([modinv(h, ai) for h, ai in zip(a_hat, a)], dtype=np.int64),
        a_hat_mod_b=np.array([[h % bj for bj in b] for h in a_hat], dtype=np.int64),
        a_mod_b=np.array([A % bj for bj in b], dtype=np.int64),
        a_inv=np.array([1.0 / ai for ai in a], dtype=np.float64),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class GaloisTable:
    """sigma_g in the coefficient domain: out[i] = sign[i] * a[src[i]]."""

    g: int
    src: np.ndarray   # (n,) int32
    sign: np.ndarray  # (n,) int64  (+1 / -1; applied then reduced mod q)


def _make_galois_table(g: int, n: int) -> GaloisTable:
    src = np.zeros(n, dtype=np.int32)
    sign = np.zeros(n, dtype=np.int64)
    for j in range(n):
        e = (j * g) % (2 * n)
        if e < n:
            src[e] = j
            sign[e] = 1
        else:
            src[e - n] = j
            sign[e - n] = -1
    return GaloisTable(g=g, src=src, sign=sign)


@dataclasses.dataclass(frozen=True, eq=False)
class HEParams:
    """A full BFV parameter set (immutable; hashable by id)."""

    n: int
    t: int
    Q: NttTables
    P: NttTables
    T: NttTables                 # plaintext-modulus NTT (for batch encoding)
    conv_q_to_p: BaseConv
    conv_p_to_q: BaseConv
    delta_mod_q: np.ndarray      # (k,)  floor(Q/t) mod q_i
    q_inv_mod_p: np.ndarray      # (kp,) Q^-1 mod p_j
    q_mod_t: int                 # Q mod t (decryption integer-part constant)
    # Batch encoder slot maps.
    slot_to_coeff: np.ndarray    # (n,) int32: NTT-domain index of logical slot s
    # Galois tables: rotations by powers of two + row swap.
    galois: dict[int, GaloisTable]
    rot_gs: dict[int, int]       # rotation step (power of two) -> galois element
    rowswap_g: int
    # Error distribution.
    err_std: float = 3.2
    sec_level: int = 128

    # ---- derived ----
    @property
    def k(self) -> int:
        return self.Q.k

    @property
    def log_n(self) -> int:
        return self.n.bit_length() - 1

    @property
    def slots(self) -> int:
        return self.n

    @property
    def row(self) -> int:
        return self.n // 2

    @property
    def logQ(self) -> float:
        return float(sum(np.log2(np.array(self.Q.primes, dtype=np.float64))))

    def bigQ(self) -> int:
        Q = 1
        for q in self.Q.primes:
            Q *= q
        return Q

    @property
    def ct_bytes(self) -> int:
        """Wire size of one ciphertext (2 polys, k limbs, packed to limb width)."""
        bits_per_coeff = max(q.bit_length() for q in self.Q.primes)
        return 2 * self.k * self.n * ((bits_per_coeff + 7) // 8)

    def expansion_ratio(self, raw_bits: int = 16) -> float:
        """Ciphertext bytes per raw data byte when fully packed (paper: ~28x)."""
        raw_bytes = self.slots * raw_bits / 8
        return self.ct_bytes / raw_bytes


def _discrete_log_table(psi: int, t: int, order: int) -> dict[int, int]:
    tbl, w = {}, 1
    for e in range(order):
        tbl[w] = e
        w = w * psi % t
    return tbl


def _make_slot_map(n: int, t: int, T: NttTables) -> np.ndarray:
    """Map logical slot s -> NTT-output index k via numeric probing.

    NTT output position k holds the evaluation of the polynomial at
    psi_t^{e_k}; we discover e_k by transforming the basis polynomial X
    (whose evaluation at psi^e is psi^e itself) and reading discrete logs.
    Slots are laid out as 2 rows of n/2: row 0 slot j <-> exponent 3^j,
    row 1 slot j <-> exponent -3^j (mod 2n) — the standard BFV layout, so
    sigma_{3^r} rotates each row left by r and sigma_{2n-1} swaps rows.
    """
    from . import ntt as nttmod  # local import to avoid cycle

    x_poly = np.zeros((1, n), dtype=np.int64)
    x_poly[0, 1] = 1
    evals = nttmod.ntt_ref(torch.from_numpy(x_poly),
                           torch.from_numpy(T.psi_rev[:1]),
                           torch.from_numpy(T.q[:1]))[0].numpy()
    psi_t = root_of_unity(2 * n, t)
    dlog = _discrete_log_table(psi_t, t, 2 * n)
    e_of_k = np.array([dlog[int(v)] for v in evals])
    k_of_e = {int(e): k for k, e in enumerate(e_of_k)}
    slot_to_coeff = np.zeros(n, dtype=np.int32)
    half = n // 2
    e = 1
    for j in range(half):
        slot_to_coeff[j] = k_of_e[e]
        slot_to_coeff[half + j] = k_of_e[(2 * n - e) % (2 * n)]
        e = e * GALOIS_GEN % (2 * n)
    return slot_to_coeff


@lru_cache(maxsize=None)
def make_params(n: int = 4096, t: int = 65537, k: int = 6, qbits: int = 30) -> HEParams:
    """Construct a parameter set.

    n      ring degree (power of two); slots = n.
    t      plaintext modulus, prime with 2n | t-1 (needed for batching).
    k      number of 30-bit limbs in Q  (log Q ~ 30k).
    """
    assert n & (n - 1) == 0, "n must be a power of two"
    assert (t - 1) % (2 * n) == 0, f"batching needs 2n | t-1 (t={t}, n={n})"
    q_primes = find_ntt_primes(n, qbits, k, avoid=(t,))
    p_primes = find_ntt_primes(n, qbits + 1, k + 1, avoid=tuple(q_primes) + (t,))

    Q = _make_ntt_tables(q_primes, n)
    P = _make_ntt_tables(p_primes, n)
    T = _make_ntt_tables([t], n)

    bigQ = 1
    for q in q_primes:
        bigQ *= q
    bigP = 1
    for p in p_primes:
        bigP *= p
    assert bigP > n * bigQ // 2, "aux base too small for HPS tensor product"

    delta = bigQ // t
    delta_mod_q = np.array([delta % q for q in q_primes], dtype=np.int64)
    q_inv_mod_p = np.array([modinv(bigQ, p) for p in p_primes], dtype=np.int64)

    slot_to_coeff = _make_slot_map(n, t, T)

    # Galois elements: rotations by 2^j (within rows of n/2), plus row swap.
    rot_gs: dict[int, int] = {}
    galois: dict[int, GaloisTable] = {}
    step = 1
    while step < n // 2:
        g = pow(GALOIS_GEN, step, 2 * n)
        rot_gs[step] = g
        galois[g] = _make_galois_table(g, n)
        step *= 2
    rowswap_g = 2 * n - 1
    galois[rowswap_g] = _make_galois_table(rowswap_g, n)

    return HEParams(
        n=n,
        t=t,
        Q=Q,
        P=P,
        T=T,
        conv_q_to_p=_make_base_conv(q_primes, p_primes),
        conv_p_to_q=_make_base_conv(p_primes, q_primes),
        delta_mod_q=delta_mod_q,
        q_inv_mod_p=q_inv_mod_p,
        q_mod_t=bigQ % t,
        slot_to_coeff=slot_to_coeff,
        galois=galois,
        rot_gs=rot_gs,
        rowswap_g=rowswap_g,
    )


# ---------------------------------------------------------------------------
# Named parameter sets.
# ---------------------------------------------------------------------------

def test_params() -> HEParams:
    """Tiny, fast, full code path (used by unit tests). 2n=512 | 7680."""
    return make_params(n=256, t=7681, k=3)


def small_params() -> HEParams:
    """Medium set for integration tests / small benches. 2n=4096 | 65536."""
    return make_params(n=2048, t=65537, k=5)


def paper_params() -> HEParams:
    """The paper's production set: n=32768, t=65537, log Q ~ 881.

    30 limbs x ~29.4 effective bits ~ 884 bits — the HE-standard row the
    paper cites (n=32768 admits log Q up to 881 at 128-bit security; we
    match it to within one limb's rounding).
    """
    return make_params(n=32768, t=65537, k=30)
