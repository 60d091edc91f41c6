"""Pure-Python number theory used at parameter-construction time.

Everything here runs once per parameter set (host side, Python ints), so
clarity beats speed. All runtime polynomial arithmetic lives in ntt.py /
kernels/ and operates on fixed-size torch tensors.
"""
from __future__ import annotations

from functools import lru_cache


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all our primes)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def modinv(a: int, m: int) -> int:
    return pow(a % m, -1, m)


def find_ntt_primes(n: int, bits: int, count: int, avoid: tuple[int, ...] = ()) -> list[int]:
    """`count` distinct primes q ≡ 1 (mod 2n), q < 2**bits, descending from 2**bits.

    q ≡ 1 (mod 2n) guarantees a primitive 2n-th root of unity mod q, which
    the negacyclic NTT needs.
    """
    step = 2 * n
    q = (1 << bits) - ((1 << bits) - 1) % step  # largest q < 2^bits with q ≡ 1 (mod 2n)
    out: list[int] = []
    while len(out) < count:
        if q <= step:
            raise ValueError(f"ran out of {bits}-bit NTT primes for n={n}")
        if is_prime(q) and q not in avoid and q not in out:
            out.append(q)
        q -= step
    return out


def _factorize(n: int) -> list[int]:
    fs, d = [], 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


@lru_cache(maxsize=None)
def primitive_root(q: int) -> int:
    """Smallest generator of (Z/q)* for prime q."""
    factors = _factorize(q - 1)
    for g in range(2, q):
        if all(pow(g, (q - 1) // f, q) != 1 for f in factors):
            return g
    raise ValueError(f"no generator found for {q}")


def root_of_unity(order: int, q: int) -> int:
    """A primitive `order`-th root of unity mod prime q (order | q-1)."""
    if (q - 1) % order != 0:
        raise ValueError(f"{order} does not divide {q}-1")
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    # Certify primitivity: w^(order/p) != 1 for every prime p | order.
    for p in _factorize(order):
        if pow(w, order // p, q) == 1:
            raise AssertionError("non-primitive root")
    return w


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def crt_reconstruct(residues: list[int], moduli: list[int]) -> int:
    """Exact CRT: the unique X in [0, prod(moduli)) with X ≡ r_i (mod m_i)."""
    Q = 1
    for m in moduli:
        Q *= m
    X = 0
    for r, m in zip(residues, moduli):
        Qi = Q // m
        X = (X + int(r) * Qi * modinv(Qi, m)) % Q
    return X


def centered(x: int, q: int) -> int:
    """Centered representative in (-q/2, q/2]."""
    x %= q
    return x - q if x > q // 2 else x
