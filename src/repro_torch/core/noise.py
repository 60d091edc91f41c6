"""Analytic invariant-noise accounting.

We track, per ciphertext, log2 of the *invariant noise* |v|, where
decrypting computes (t/Q)(c0 + c1 s) = m + v + t*K and succeeds iff
|v| < 1/2. `budget_bits = -log2(2|v|)` matches SEAL's
invariant_noise_budget. The planner (engine/planner.py) consumes the same
model; tests cross-check these bounds against exact noise measured with
the secret key (core/bfv.py:noise_budget_exact).

Bounds follow the standard BFV worst-case analysis (Fan-Vercauteren /
SEAL manual), specialized to our RNS layout:
  fresh:      |v| <= (t/Q) * B * (2 n W + W + 1),  W = Hamming-ish bound 1
              for ternary u/s, B = ceil(6 sigma) error bound
  add:        v = v1 + v2
  mul:        |v| <~ (v1 + v2) * t * n + small cross terms
  keyswitch:  additive (t/Q) * n * k * q_max * B / 2  (per-limb digits)
  mul_plain:  |v| *= n * ||m||_inf  (<= n * t/2 for arbitrary masks)
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .params import HEParams


@dataclasses.dataclass(frozen=True)
class NoiseProfile:
    """Lightweight stand-in for HEParams: just what NoiseModel reads.

    Used by the mock backend to run *paper-scale* parameter accounting
    (n=32768, 30 limbs) without building NTT tables.
    """

    n: int
    t: int
    k: int
    qbits: int = 30
    err_std: float = 3.2

    @property
    def logQ(self) -> float:
        return self.k * (self.qbits - 2e-5)  # primes sit just below 2^qbits

    @property
    def q_max(self) -> int:
        return (1 << self.qbits) - 1

    @property
    def slots(self) -> int:
        return self.n

    @property
    def ct_bytes(self) -> int:
        return 2 * self.k * self.n * ((self.qbits + 7) // 8)

    def expansion_ratio(self, raw_bits: int = 16) -> float:
        return self.ct_bytes / (self.n * raw_bits / 8)


def paper_profile() -> NoiseProfile:
    """The paper's SEAL set: n=32768, log Q = 881, t = 65537."""
    return NoiseProfile(n=32768, t=65537, k=30)


@dataclasses.dataclass
class NoiseModel:
    params: "HEParams | NoiseProfile"

    def __post_init__(self) -> None:
        p = self.params
        self.logQ = p.logQ
        self.log_t = math.log2(p.t)
        self.log_n = math.log2(p.n)
        self.log_B = math.log2(math.ceil(6 * p.err_std))

    # All values are log2|v| of invariant noise.
    def fresh(self) -> float:
        p = self.params
        return self.log_t - self.logQ + self.log_B + math.log2(2 * p.n + p.n + 1)

    @staticmethod
    def _logadd(v1, v2):
        """log2(2^v1 + 2^v2), stable — |u + w| <= |u| + |w|.  Sequential
        sums of k equal-noise terms grow by log2(k), not by k bits.

        Accepts floats or numpy arrays (per-block noise vectors); scalar
        inputs take the original scalar path bit-for-bit.
        """
        if np.ndim(v1) == 0 and np.ndim(v2) == 0:
            hi, lo = (v1, v2) if v1 >= v2 else (v2, v1)
            d = lo - hi
            if d < -50:
                return hi
            return hi + math.log2(1.0 + 2.0 ** d)
        hi = np.maximum(v1, v2)
        d = np.minimum(v1, v2) - hi
        return np.where(d < -50, hi, hi + np.log2(1.0 + 2.0 ** np.maximum(d, -60.0)))

    def add(self, v1, v2):
        return self._logadd(v1, v2)

    def add_many(self, vs):
        shift = math.log2(max(len(vs), 1))
        if all(np.ndim(v) == 0 for v in vs):
            return max(vs) + shift
        hi = vs[0]
        for v in vs[1:]:
            hi = np.maximum(hi, v)
        return hi + shift

    def mul(self, v1, v2):
        # (|v1|+|v2|) * t * n  + tensor rounding term (t/Q-scale, negligible
        # until the very bottom of the budget).
        grow = self.log_t + self.log_n + 1.0
        base = self._logadd(v1, v2) + grow
        floor_term = self.log_t + self.log_n - self.logQ + 2.0
        if np.ndim(base) == 0:
            return max(base, floor_term)
        return np.maximum(base, floor_term)

    def levels_left(self, v) -> int:
        """Sequential ct-ct multiplications this ciphertext still supports.

        For a per-block noise vector this is the *worst* lane's count."""
        if np.ndim(v):
            v = float(np.max(v))
        d = 0
        while True:
            v2 = self.keyswitch(self.mul(v, v))
            if self.budget(v2) <= 0:
                return d
            v, d = v2, d + 1

    def keyswitch_addend(self) -> float:
        p = self.params
        q_max = max(p.Q.primes) if hasattr(p, "Q") else p.q_max
        return self.log_t - self.logQ + self.log_n + math.log2(p.k) + math.log2(q_max) + self.log_B - 1.0

    def keyswitch(self, v):
        addend = self.keyswitch_addend()
        if np.ndim(v) == 0:
            return max(v, addend) + 1.0
        return np.maximum(v, addend) + 1.0

    def rotate(self, v):
        return self.keyswitch(v)

    def mul_plain(self, v, plain_inf_norm: float | None = None):
        norm = plain_inf_norm if plain_inf_norm is not None else self.params.t / 2
        return v + self.log_n + math.log2(max(norm, 1.0))

    def mul_scalar(self, v, c: int):
        """Multiply by a constant polynomial (degree 0): |v| grows by |c| only,
        no n factor — the reason BSGS coefficient multiplies are cheap."""
        t = self.params.t
        cc = abs(c % t if (c % t) <= t // 2 else (c % t) - t)
        return v + math.log2(max(cc, 1))

    def budget(self, v):
        """Remaining invariant-noise budget in bits (<0 means failure).
        Elementwise over per-block noise vectors."""
        return -(v + 1.0)

    def min_budget(self, v) -> float:
        """Worst-lane remaining budget in bits as a scalar — the decrypt
        -boundary headroom both the executing backends and the static
        verifier report."""
        return float(np.min(self.budget(v)))

    # --- planner-facing depth model (paper Table 3) ---
    def max_depth(self) -> int:
        """Supported sequential ct-ct multiplication depth from fresh."""
        v = self.fresh()
        d = 0
        while True:
            v2 = self.mul(v, v)
            if self.budget(v2) <= 0:
                return d
            v = v2
            d += 1

    def eq_depth(self) -> int:
        return math.ceil(math.log2(self.params.t - 1))

    def lt_depth(self) -> int:
        return self.eq_depth() + 1  # BSGS: baby chain + giant chain ~ log(p-1), +1 slack

    def agg_depth(self) -> float:
        return math.log2(self.params.n) / self.params.t

    def join_depth(self) -> int:
        return self.eq_depth() + 1


class UnderReportingNoiseModel:
    """Delegating NoiseModel wrapper that *under-reports* ct-ct multiply
    noise growth — the fault-injection stand-in for a mis-calibrated
    model (runtime/faults.py, DESIGN.md §9 'overflow').

    On each tampered `mul` the reported noise is `extra_bits` lower than
    the inner model's answer, and the shortfall accumulates in
    `hidden_bits`.  The engine's refresh policy then under-provisions:
    ciphertexts reach decrypt with less real headroom than their
    tracked noise claims.  The decrypt-boundary guard
    (`faults.check_decrypt`) subtracts `hidden_bits` to detect exactly
    this — the injected equivalent of a real backend's noise exceeding
    the analytic bound.

    `skip` passes through the first N mul calls untouched (placing the
    fault mid-plan); `take()` is consulted per call so the armed
    FaultPlan can bound how many tampered muls fire across retries.
    Every other model method (budget, keyswitch, levels_left, ...)
    delegates verbatim, so planning and refresh sizing stay coherent
    with the lie — the scenario is a consistent model bias, not a
    one-off glitch the accounting would immediately expose.
    """

    def __init__(self, inner: NoiseModel, extra_bits: float,
                 skip: int = 0, take=None):
        self.inner = inner
        self.extra_bits = float(extra_bits)
        self._skip = int(skip)
        self._take = take if take is not None else (lambda: True)
        self.hidden_bits = 0.0

    def mul(self, v1, v2):
        out = self.inner.mul(v1, v2)
        if self._skip > 0:
            self._skip -= 1
            return out
        if not self._take():
            return out
        self.hidden_bits += self.extra_bits
        return out - self.extra_bits

    def __getattr__(self, name):
        return getattr(self.inner, name)
