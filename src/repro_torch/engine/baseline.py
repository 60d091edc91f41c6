"""Baseline cost models and the NSHEDB timing model (paper §5).

Three time sources feed the comparison tables:

1. **NSHEDB (ours)** — executable.  Small parameter sets run genuinely on
   the BFV backend; paper-scale runs execute on the mock backend and are
   priced as  sum(op_count x per-op seconds) + refreshes x C_boot,  with
   per-op seconds *measured* on this package's BFV backend (on the card
   by default) and extrapolated to paper parameters with the analytic
   complexity model
   below (cost ~ a*k*n*log n NTT work + b*k^2*n base-conversion work).

2. **HE3DB / ArcEDB** — the paper's baselines, not reimplementable in
   scope (each is a CCS-paper-sized system).  We price them from the
   paper's own primitive-operation measurements (Table 4, per-slot ms on
   the same 32K-row setting), applied to the operator counts our engine
   logs: time = sum_ops count x cost_per_slot x rows.  Where the paper
   quotes whole-query times (Q1/Q6/Q8 in §5.2.2, Table 5) we report
   those verbatim as "paper-reported" anchors.

3. **Bootstrap constant** — C_boot = 44 s per ciphertext refresh, the
   CKKS figure the paper cites from [3] (44 s / 32,768 elements); used to
   price our (rare, planned) refreshes and the unoptimized plans.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

# --------------------------------------------------------------------------
# Paper constants.
# --------------------------------------------------------------------------

# Table 4: per-slot milliseconds at 32K rows.
TABLE4_MS_PER_SLOT = {
    "he3db":  {"count": 1.27, "sum": 1.27, "eq": 283.33, "cmp": 150.83,
               "between": 287.35, "in": 283.33, "groupby": 283.33},
    "arcedb": {"count": 1.27, "sum": 1.27, "eq": 16.00, "cmp": 16.00,
               "between": 33.69, "in": 16.00, "groupby": 16.00},
    "nshedb_paper": {"count": 0.04, "sum": 0.04, "eq": 0.09, "cmp": 3.66,
                     "between": 7.32, "in": 0.09, "groupby": 0.09},
}

# §5.2.2 / Table 5: whole-query seconds quoted in the text (32K rows).
PAPER_QUERY_SECONDS = {
    "Q1": {"he3db": 14454.0, "arcedb": 4748.0, "nshedb_noopt": 477.0},
    "Q6": {"he3db": 11802.0, "arcedb": 3257.0, "nshedb": 590.0},
    "Q8": {"he3db": 8423.0, "arcedb": 3351.0, "nshedb": 178.0},
}

C_BOOT_SECONDS = 44.0          # CKKS bootstrap of one 32K ciphertext [3]
PAPER_SLOTS = 32768


def baseline_seconds(system: str, op_log: dict, rows: int) -> float:
    """Bit-level baseline estimate: operator counts x Table-4 per-slot
    cost x live rows (bit-level systems pay per row, not per block)."""
    tab = TABLE4_MS_PER_SLOT[system]
    sec = 0.0
    for op, cnt in op_log.items():
        if op in tab:
            sec += cnt * tab[op] * rows / 1000.0
    return sec


# --------------------------------------------------------------------------
# NSHEDB per-op cost calibration (measured on our BFV backend, extrapolated).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpCosts:
    """Per-op seconds for one parameter set (n, k)."""

    n: int
    k: int
    mul: float
    mul_plain: float
    mul_scalar: float
    add: float
    rotate: float
    refresh: float = C_BOOT_SECONDS

    def as_dict(self) -> dict[str, float]:
        return {"mul": self.mul, "mul_plain": self.mul_plain,
                "mul_scalar": self.mul_scalar, "add": self.add,
                "rotate": self.rotate, "refresh": self.refresh}


def measure_costs(params, reps: int = 3, seed: int = 0,
                  device="cuda") -> OpCosts:
    """Wall-clock per-op costs of the real BFV backend at `params` on
    `device`.  Each timed call ends in a synchronize on a CUDA device,
    so the seconds are the card's work, not the host's time to queue
    it.  Keygens its own backend (at `paper_params()`, ~8 GB of keys)."""
    from .backend import BFVBackend

    bk = BFVBackend(params, seed=seed, device=device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    a = bk.encrypt(np.arange(params.n) % params.t)
    b = bk.encrypt(np.arange(params.n)[::-1] % params.t)
    mask = (np.arange(params.n) % 2).astype(np.int64)

    def timeit(fn):
        fn()                                 # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            sync()
        return (time.perf_counter() - t0) / reps

    return OpCosts(
        n=params.n, k=params.k,
        mul=timeit(lambda: bk.mul(a, b)),
        mul_plain=timeit(lambda: bk.mul_plain(a, mask)),
        mul_scalar=timeit(lambda: bk.mul_scalar(a, 3)),
        add=timeit(lambda: bk.add(a, b)),
        rotate=timeit(lambda: bk.rotate(a, 1)),
    )


def extrapolate_costs(measured: OpCosts, n2: int, k2: int) -> OpCosts:
    """Scale measured costs to another (n, k).

    Complexity model per op (RNS-BFV):
      mul        ~ k*n*log n (NTTs)  +  k^2*n (HPS base conversions + KS)
      rotate     ~ k*n*log n          +  k^2*n (key-switch digits)
      mul_plain  ~ k*n*log n
      mul_scalar ~ k*n
      add        ~ k*n
    We conservatively attribute half the measured mul/rotate cost to each
    term at the measured point, then scale each term independently.
    """
    n1, k1 = measured.n, measured.k
    ntt = (k2 * n2 * np.log2(n2)) / (k1 * n1 * np.log2(n1))
    ks = (k2 * k2 * n2) / (k1 * k1 * n1)
    lin = (k2 * n2) / (k1 * n1)

    def two_term(c):
        return 0.5 * c * ntt + 0.5 * c * ks

    return OpCosts(
        n=n2, k=k2,
        mul=two_term(measured.mul),
        mul_plain=measured.mul_plain * ntt,
        mul_scalar=measured.mul_scalar * lin,
        add=measured.add * lin,
        rotate=two_term(measured.rotate),
    )


def nshedb_seconds(stats, costs: OpCosts) -> float:
    """Our engine's modeled wall-clock: op counts x per-op seconds."""
    c = costs.as_dict()
    return (stats.mul * c["mul"] + stats.mul_plain * c["mul_plain"]
            + stats.mul_scalar * c["mul_scalar"] + stats.add * c["add"]
            + stats.rotate * c["rotate"] + stats.refresh * c["refresh"])


def storage_report(profile_or_params, rows: int, ncols: int,
                   raw_bits: int = 16) -> dict:
    """Fig. 7(a): storage for `rows` x `ncols` 16-bit values.

    NSHEDB: ceil(rows/slots) ciphertexts per column.
    Bit-level baselines: ~8000x raw (the paper's §2.2 figure).
    """
    slots = profile_or_params.n
    nblocks = (rows + slots - 1) // slots
    nshedb = nblocks * ncols * profile_or_params.ct_bytes
    raw = rows * ncols * raw_bits // 8
    bitlevel = raw * 8000
    return {"raw_bytes": raw, "nshedb_bytes": nshedb,
            "bitlevel_bytes": bitlevel,
            "nshedb_expansion": nshedb / raw,
            "reduction_vs_bitlevel": bitlevel / nshedb}
