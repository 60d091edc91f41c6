"""Arithmetic comparison circuits for word-level BFV (paper §2.1.7, §4.3.1).

Everything here is written against a duck-typed backend `ops` (see
engine/backend.py) exposing add/sub/mul/mul_scalar/add_scalar/
sub_from_scalar and the plaintext modulus `ops.t`.  The identical circuit
therefore runs on real RNS-BFV ciphertexts (tests, small benches) and on
the mock Z_t backend (full-scale TPC-H benches) without drift.

Equality  — Fermat's little theorem (paper Eq. 3):
    EQ(x, y) = 1 - (x-y)^(p-1),   depth = ceil(log2(p-1))  via square chain.

Less-than — the paper's Eq. 4 is a sum over the whole negative half-range;
evaluated literally it costs (p-1)/2 equality circuits.  Following the
optimization the paper adopts from Iliashenko-Zucca [38], we instead
interpolate once:

    sgn(z)  = sum_{j} s_j z^(2j+1)      (odd polynomial, degree p-2)
    LT(x,y) = ( z^(p-1) - sgn(z) ) / 2,     z = x - y

since z^(p-1) is 1 iff z != 0 and sgn is +-1 on the positive/negative
halves.  The odd interpolant needs only (p-1)/2 coefficients

    s_k = -2 * sum_{a=1..(p-1)/2} a^(p-1-k)  (mod p),  k odd,

and is evaluated in the variable w = z^2 with a depth-balanced
divide-and-conquer Paterson-Stockmeyer scheme: ~2*sqrt(p) ciphertext
multiplications at multiplicative depth ceil(log2(p-1)) + 2 — matching the
paper's Table 3 ("Equality: log(p-1); Join: log(p-1)+1") up to the BSGS
slack noted in §5.3 ("inequality checks ... lookup table accesses (BSGS)").
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

# ---------------------------------------------------------------------------
# Interpolation coefficients (host-side precompute, cached on disk).
# ---------------------------------------------------------------------------

_CACHE_DIR = os.path.join(os.path.dirname(__file__), "_coeff_cache")


def _modpow_vec(base: np.ndarray, e: int, p: int) -> np.ndarray:
    """Vectorized modular exponentiation; products < p^2 < 2^34, exact int64."""
    out = np.ones_like(base)
    b = base % p
    while e:
        if e & 1:
            out = out * b % p
        b = b * b % p
        e >>= 1
    return out


@lru_cache(maxsize=None)
def sgn_odd_coeffs(p: int) -> np.ndarray:
    """s[j] = coefficient of z^(2j+1) in the interpolant of sgn over Z_p.

    Returned as int64 array of length (p-1)//2 (degree p-2 polynomial).
    Cached to disk: the p=65537 table costs ~2^30 modmuls to build.
    """
    path = os.path.join(_CACHE_DIR, f"sgn_{p}.npy")
    if os.path.exists(path):
        return np.load(path)
    half = (p - 1) // 2
    a = np.arange(1, half + 1, dtype=np.int64)
    # k = 2j+1:  s_j = -2 * sum_a a^(p-1-k).  Iterate v_a = a^(p-1-k)
    # starting at k=1 (v = a^(p-2)) and multiply by a^-2 each step.
    v = _modpow_vec(a, p - 2, p)
    ainv2 = _modpow_vec(a, p - 3, p)  # a^(p-3) = a^-2
    s = np.zeros(half, dtype=np.int64)
    for j in range(half):
        s[j] = (-2 * int(v.sum() % p)) % p
        if j + 1 < half:
            v = v * ainv2 % p
    os.makedirs(_CACHE_DIR, exist_ok=True)
    np.save(path, s)
    return s


@lru_cache(maxsize=None)
def indicator_coeffs(p: int, lo: int, hi: int) -> np.ndarray:
    """Dense interpolant f with f(a) = 1 for a in [lo, hi] (centered reps),
    0 elsewhere.  f_0 = g(0); f_k = -sum_{a != 0} g(a) a^(p-1-k).
    Used for small-p tests and as an oracle for the sgn decomposition."""
    members = [a % p for a in range(lo, hi + 1)]
    g = np.zeros(p, dtype=np.int64)
    g[members] = 1
    coeffs = np.zeros(p, dtype=np.int64)
    coeffs[0] = g[0]
    a = np.arange(1, p, dtype=np.int64)
    ga = g[1:]
    v = _modpow_vec(a, p - 2, p)  # a^(p-1-k) at k=1
    ainv = _modpow_vec(a, p - 2, p)
    for k in range(1, p):
        coeffs[k] = (-int((ga * v % p).sum() % p)) % p
        if k + 1 < p:
            v = v * ainv % p
    return coeffs


# ---------------------------------------------------------------------------
# Circuits.
# ---------------------------------------------------------------------------

def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def pow_ct(ops, x, e: int):
    """x^e by square-and-multiply (depth ceil(log2 e) for e a power of two)."""
    assert e >= 1
    acc = None
    base = x
    while e:
        if e & 1:
            acc = base if acc is None else ops.mul(acc, base)
        e >>= 1
        if e:
            base = ops.mul(base, base)
    return acc


def eq_zero(ops, z):
    """EQ(z, 0) = 1 - z^(p-1); depth ceil(log2(p-1)) (16 for t=65537)."""
    if hasattr(ops, "op_log"):
        ops.op_log["eq"] += 1
    return ops.sub_from_scalar(1, pow_ct(ops, z, ops.t - 1))


def eq_ct(ops, x, y):
    """Paper Eq. 3: EQ(x, y) = 1 - (x-y)^(p-1)."""
    return eq_zero(ops, ops.sub(x, y))


def eq_scalar(ops, x, c: int):
    return eq_zero(ops, ops.sub_scalar(x, c))


class _PSEvaluator:
    """Depth-balanced Paterson-Stockmeyer over w-powers of one ciphertext.

    Baby powers w^1..w^(B-1) built by balanced products (depth log2 B);
    giant powers w^(B*2^j) from the squaring chain; a polynomial of degree
    d is split recursively at power-of-two multiples of B, costing one
    ct-ct mul per split and depth log2(d/B) above the baby level.
    """

    def __init__(self, ops, w, max_degree: int):
        self.ops = ops
        self.w = w
        b = 1
        while b * b < max_degree + 1:
            b *= 2
        self.B = b
        self._baby = {1: w}   # w^i
        self._pow2 = {1: w}   # w^(2^j) keyed by 2^j
        for i in range(2, b):
            self._baby[i] = ops.mul(self.baby(i // 2), self.baby(i - i // 2))
        m = 2
        while m <= max_degree + 1:
            prev = self._pow2[m // 2]
            self._pow2[m] = self._baby[m] if m in self._baby else ops.mul(prev, prev)
            m *= 2

    def baby(self, i: int):
        return self._baby[i]

    def pow2(self, m: int):
        return self._pow2[m]

    def eval(self, coeffs: np.ndarray):
        """sum_i coeffs[i] * w^i as a ciphertext (None if identically 0)."""
        return self._eval(np.asarray(coeffs, dtype=np.int64))

    def _eval(self, c: np.ndarray):
        ops, p = self.ops, self.ops.t
        n = len(c)
        if n <= self.B:
            acc = None
            if any(int(x) % p for x in c[1:]):
                cts = [self.baby(i) for i in range(1, n)]
                acc = ops.dot_plain(cts, c[1:])
            c0 = int(c[0]) % p
            if c0:
                if acc is None:
                    raise ValueError("constant-only polynomial: fold into caller")
                acc = ops.add_scalar(acc, c0)
            return acc
        m = self.B
        while m * 2 < n:
            m *= 2
        lo = self._eval(c[:m])
        hi = self._eval(c[m:])
        if hi is None:
            return lo
        hi = ops.mul(hi, self.pow2(m))
        return hi if lo is None else ops.add(lo, hi)


def lt_zero(ops, z):
    """LT(z, 0): encrypted 1 iff z is in the negative half range, else 0."""
    if hasattr(ops, "op_log"):
        ops.op_log["cmp"] += 1
    p = ops.t
    assert _is_pow2(p - 1), "sgn decomposition assumes a Fermat prime t"
    s = sgn_odd_coeffs(p)                      # h(w): sgn(z) = z * h(z^2)
    w = ops.mul(z, z)
    ps = _PSEvaluator(ops, w, len(s) - 1)
    h = ps.eval(s)
    sgn = ops.mul(z, h)
    ez = ps.pow2((p - 1) // 2)                 # w^((p-1)/2) = z^(p-1)
    inv2 = (p + 1) // 2
    return ops.mul_scalar(ops.sub(ez, sgn), inv2)


def lt_ct(ops, x, y):
    """LT(x, y) (paper Eq. 4, evaluated via the interpolant)."""
    return lt_zero(ops, ops.sub(x, y))


def lt_scalar(ops, x, c: int):
    return lt_zero(ops, ops.sub_scalar(x, c))


def gt_scalar(ops, x, c: int):
    """x > c  ==  c - x < 0."""
    return lt_zero(ops, ops.sub_from_scalar(c, x))


def ge_scalar(ops, x, c: int):
    """x >= c  ==  NOT (x < c)."""
    return ops.sub_from_scalar(1, lt_scalar(ops, x, c))


def le_scalar(ops, x, c: int):
    return ops.sub_from_scalar(1, gt_scalar(ops, x, c))


def between_scalar(ops, x, lo: int, hi: int):
    """Paper §4.2.2 BETWEEN: product of the two one-sided masks (+1 depth)."""
    return ops.mul(ge_scalar(ops, x, lo), le_scalar(ops, x, hi))


def in_set(ops, x, values):
    """Paper Eq. 6: IN(x, S) = sum_{y in S} EQ(x, y), summed as a balanced
    tree (the §4.3.1 divide-and-conquer addition)."""
    terms = [eq_scalar(ops, x, int(v)) for v in values]
    return add_tree(ops, terms)


def add_tree(ops, terms: list):
    """Balanced binary addition tree (§4.3.1 BETWEEN/IN noise optimization)."""
    assert terms
    layer = list(terms)
    while len(layer) > 1:
        nxt = [ops.add(layer[i], layer[i + 1]) for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


def mul_tree(ops, terms: list):
    """Balanced product tree — depth log2(len) instead of len-1."""
    assert terms
    layer = list(terms)
    while len(layer) > 1:
        nxt = [ops.mul(layer[i], layer[i + 1]) for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


# Boolean algebra on {0,1} masks (paper Table 2 footnote).
def and_(ops, a, b):
    return ops.mul(a, b)


def or_(ops, a, b):
    return ops.sub(ops.add(a, b), ops.mul(a, b))


def not_(ops, a):
    return ops.sub_from_scalar(1, a)
