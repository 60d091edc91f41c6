#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: builds the CUDA kernels from
the sources in this checkout, holds each against its plain PyTorch
version on the card, and drives the port's main path — encrypted TPC-H
Q6 on real BFV ciphertexts at the paper's parameters (n = 32768,
t = 65537, 30 RNS limbs, LINEITEM at 32768 rows) — checking the decrypted
revenue against the numpy oracle.

    python3 chip_smoke.py            # needs one NVIDIA GPU and nvcc

Output: one JSON object per line (`env`, `kernel_checks`, `micro`,
`main`, `kernels`),
the card's name and power limit as nvidia-smi prints them, and as the
last line `{"ok": true, "device": {...}}`.  Any failed phase raises, so
the exit code is non-zero and no result line is printed.

`--phases` runs a subset (env always runs), e.g. `--phases kernels` for a
first check of a changed kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Published H100 SXM peaks: HBM3 bytes/s; integer lane operations per
# second outside the tensor cores, taken as a quarter of the 67 TFLOP/s
# float32 rate (a fused multiply-add counts as two FLOPs, and the int32
# pipes issue at half the float32 instruction rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 67e12 / 4

LANES = 5            # Q6's five `lt` atoms run as one stacked batch
SEED = 0


def emit(tag: str, obj: dict) -> None:
    print(json.dumps({tag: obj}), flush=True)


def gpu_ms(fn, reps: int, inner: int = 5, warmup: int = 2) -> float:
    """Median milliseconds of one fn() on the card: CUDA events around
    `inner` back-to-back calls, divided by `inner`, median over `reps`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


# --------------------------------------------------------------------- env
def phase_env() -> None:
    from repro_torch import kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[-2]
    t0 = time.perf_counter()
    kernels.build_all()
    for name in kernels.SOURCES:
        kernels.library(name)
    build_s = time.perf_counter() - t0
    env = {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": nvcc, "kernel_build_s": round(build_s, 3)}
    emit("env", env)
    print(smi, flush=True)


# ----------------------------------------------------------------- kernels
def _rand_limbs(rng, primes, lead, n, dev):
    q = np.array(primes, dtype=np.int64)[:, None]
    return torch.from_numpy(rng.integers(0, q, tuple(lead) + (len(primes), n))).to(dev)


def _check_equal(name, got, exp, what) -> int:
    """Raise unless got == exp bit for bit; returns the measured max |got - exp|."""
    torch.cuda.synchronize()
    err = int((got - exp).abs().max())
    if err != 0 or not torch.equal(got, exp):
        bad = int((got != exp).sum())
        raise AssertionError(f"{name} disagrees with its plain version at {what}: "
                             f"{bad} of {got.numel()} elements differ, max |diff| {err}")
    return err


def phase_kernels(paper) -> dict:
    """Bit-equality of every kernel with its plain version at n in
    {128, 4096, 32768} on the Q (30-bit) and P (31-bit) bases, then
    timings at the main path's shapes."""
    from repro_torch.core.limbops import LimbOps, force_ref
    from repro_torch.core.params import make_params

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    checks = 0
    for params, lead in ((make_params(n=128, t=257, k=12), (3,)),
                         (make_params(n=4096, t=65537, k=6), (2, 3)),
                         (paper, (2,))):
        for base, tables in (("Q", params.Q), ("P", params.P)):
            ops = LimbOps(tables, device=dev)
            a = _rand_limbs(rng, tables.primes, lead, params.n, dev)
            b = _rand_limbs(rng, tables.primes, lead, params.n, dev)
            qm1 = (ops.q[:, None] - 1).expand(a.shape[-2:]).contiguous()
            what = f"n={params.n} base {base}"
            cases = [(a, b), (a, b[0]), (qm1, qm1), (torch.zeros_like(qm1), qm1)]
            for x, y in cases:
                for op in ("mul", "add", "sub"):
                    got = getattr(ops, op)(x, y)
                    with force_ref():
                        exp = getattr(ops, op)(x, y)
                    _check_equal(f"{op}_mod", got, exp, what)
                    checks += 1
            for x in (a, qm1):
                fwd = ops.ntt(x)
                with force_ref():
                    fwd_ref = ops.ntt(x)
                    inv_ref = ops.intt(x)
                _check_equal("ntt_fwd", fwd, fwd_ref, what)
                _check_equal("ntt_inv", ops.intt(x), inv_ref, what)
                _check_equal("ntt_inv(ntt_fwd)", ops.intt(fwd), x, what)
                checks += 3

    # timings at the shapes Q6 gives the kernels (5 lanes, k = 30, n = 32768)
    k, n = paper.k, paper.n
    lq = LimbOps(paper.Q, device=dev)
    digits = _rand_limbs(rng, paper.Q.primes, (LANES, k), n, dev)    # key-switch digits
    ksk = _rand_limbs(rng, paper.Q.primes, (k,), n, dev)             # one key half
    lane = _rand_limbs(rng, paper.Q.primes, (LANES,), n, dev)        # one ct component
    ct1 = _rand_limbs(rng, paper.Q.primes, (LANES, 2), n, dev)       # ciphertext payloads
    ct2 = _rand_limbs(rng, paper.Q.primes, (LANES, 2), n, dev)
    e8 = 8  # bytes per element at the kernel boundary (int64)
    log_n = n.bit_length() - 1
    bfly_ops = 10        # integer operations per radix-2 butterfly
    specs = {
        "ntt_fwd": (lambda: lq.ntt(digits), tuple(digits.shape),
                    2 * digits.numel() * e8, digits.numel() // 2 * log_n * bfly_ops),
        "ntt_inv": (lambda: lq.intt(lane), tuple(lane.shape),
                    2 * lane.numel() * e8, lane.numel() // 2 * log_n * bfly_ops + 6 * lane.numel()),
        "mul_mod": (lambda: lq.mul(digits, ksk), tuple(digits.shape),
                    (2 * digits.numel() + ksk.numel()) * e8, 8 * digits.numel()),
        "add_mod": (lambda: lq.add(ct1, ct2), tuple(ct1.shape),
                    3 * ct1.numel() * e8, 3 * ct1.numel()),
        "sub_mod": (lambda: lq.sub(ct1, ct2), tuple(ct1.shape),
                    3 * ct1.numel() * e8, 3 * ct1.numel()),
    }
    out = {}
    for name, (fn, shape, nbytes, nops) in specs.items():
        got = fn()
        with force_ref():
            exp = fn()
        err = _check_equal(name, got, exp, f"main-path shape {shape}")
        del got, exp
        ms = gpu_ms(fn, reps=10)
        with force_ref():
            plain_ms = gpu_ms(fn, reps=3, inner=2, warmup=1)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_INT_OPS_PER_S * 1e3
        out[name] = {"shape": list(shape), "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": None}
    # the inverse NTT also at the key-switch batch (rows = 5*30*30), for
    # comparison with the forward kernel at equal work
    out["ntt_inv"]["ms_at_4500_rows"] = gpu_ms(lambda: lq.intt(digits), reps=10)
    emit("kernel_checks", {"equal_to_plain_version": checks,
                           "tolerance": "exact (torch.equal)"})
    return out


# ------------------------------------------------------------------- micro
def phase_micro() -> None:
    """The quickstart query at micro parameters through the port."""
    from repro_torch.core.params import make_params
    from repro_torch.engine.backend import BFVBackend
    from repro_torch.engine.plan import Agg, And, Factor, Pred
    from repro_torch.engine.planner import Planner
    from repro_torch.engine.schema import ColumnSpec, TableSchema
    from repro_torch.engine.storage import Database

    t0 = time.perf_counter()
    bk = BFVBackend(make_params(n=128, t=257, k=12), seed=0)
    rng = np.random.default_rng(42)
    n = 50
    data = {"day": rng.integers(1, 101, n), "price": rng.integers(1, 101, n),
            "qty": rng.integers(1, 11, n)}
    schema = TableSchema("sales", [ColumnSpec("day", "int"), ColumnSpec("price", "int"),
                                   ColumnSpec("qty", "int")])
    db = Database(bk)
    db.load_table(schema, data, n)
    pl = Planner(db, optimized=True)
    tbl = db.tables["sales"]
    mask = pl.where_mask(tbl, And((Pred("day", "<", 50), Pred("qty", ">=", 3))))
    total = pl.aggregate(tbl, Agg("sum", (Factor("price"),), "s"), mask)
    cnt = pl.aggregate(tbl, Agg("count", (), "c"), mask)
    sel = (data["day"] < 50) & (data["qty"] >= 3)
    got = {"sum": int(bk.decrypt(total)[0]), "count": int(bk.decrypt(cnt)[0])}
    exp = {"sum": int(data["price"][sel].sum()) % bk.t, "count": int(sel.sum())}
    torch.cuda.synchronize()
    res = {"got": got, "expected": exp, "refresh": bk.stats.refresh,
           "seconds": round(time.perf_counter() - t0, 3)}
    emit("micro", res)
    if got != exp or bk.stats.refresh != 0:
        raise AssertionError(f"micro query wrong: {res}")


# -------------------------------------------------------------------- main
def _profile_summary(prof, wall_s: float) -> dict:
    """Device time by kernel name from a torch.profiler run of the query."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"query_wall_s": round(wall_s, 3), "device_busy_ms": round(busy_ms, 1),
            "device_idle_share": round(1.0 - busy_ms / (wall_s * 1e3), 4),
            "kernel_events": int(sum(r[2] for r in rows)),
            "top": [{"name": k[:200], "ms": round(ms, 2), "calls": int(c)}
                    for k, ms, c in rows[:25]]}


def phase_main(paper, profile: bool = False) -> dict:
    """Encrypted TPC-H Q6 at the paper's parameters, LINEITEM 32768 rows.
    With `profile`, the query runs under torch.profiler and the device
    time by kernel is printed as a `profile` line (the stage seconds then
    include the profiler's overhead)."""
    from repro_torch import kernels
    from repro_torch.engine import queries, tpch
    from repro_torch.engine.backend import BFVBackend
    from repro_torch.engine.planner import Planner

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    secs = {}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    t0 = clock()
    bk = BFVBackend(paper, seed=SEED)
    secs["keygen"] = clock() - t0

    t0 = clock()
    db = tpch.load(bk, tpch.Scale(), tables=["lineitem"])
    secs["load_encrypt"] = clock() - t0
    li = db.tables["lineitem"]

    pl = Planner(db, optimized=True)
    # run_q6 as a user calls it, with its three stages timed apart
    seen = {}

    def timed(obj, method, key):
        fn = getattr(obj, method)

        def wrapper(*args, **kwargs):
            if key == "decrypt":
                seen["budget_bits"] = float(bk.budget(args[0]))
            t0 = clock()
            out = fn(*args, **kwargs)
            secs[key] = secs.get(key, 0.0) + clock() - t0
            return out
        setattr(obj, method, wrapper)

    timed(pl, "where_mask", "where")
    timed(pl, "aggregate", "aggregate")
    timed(bk, "decrypt", "decrypt")
    prof_ctx = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        prof_ctx = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = clock()
    with prof_ctx as prof:
        got = queries.run_q6(pl)
        query_s = clock() - t0
    budget_bits = seen["budget_bits"]
    if profile:
        emit("profile", _profile_summary(prof, query_s))

    exp = queries.oracle_q6(db)
    launches = kernels.launch_counts()
    res = {
        "params": {"n": paper.n, "t": paper.t, "k": paper.k},
        "lineitem_rows": li.nrows, "blocks_per_column": li.nblocks,
        "got": got, "expected": exp,
        "seconds": {k: round(v, 3) for k, v in secs.items()},
        "op_stats": dataclasses.asdict(bk.stats),
        "noise_budget_bits_at_decrypt": round(budget_bits, 2),
        "kernel_launches": launches,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    emit("main", res)
    if got != exp:
        raise AssertionError(f"Q6 revenue {got} != oracle {exp}")
    idle = [name for name, count in launches.items() if count <= 0]
    if idle:
        raise AssertionError(f"main path launched no {idle} kernel")
    return launches


KERNEL_META = {
    "ntt_fwd": ("src/repro_torch/kernels/csrc/ntt.cu", "src/repro/kernels/ntt/ntt.py:68"),
    "ntt_inv": ("src/repro_torch/kernels/csrc/ntt.cu", "src/repro/kernels/ntt/ntt.py:92"),
    "mul_mod": ("src/repro_torch/kernels/csrc/modops.cu", "src/repro/kernels/modops/modops.py:44"),
    "add_mod": ("src/repro_torch/kernels/csrc/modops.cu", "src/repro/kernels/modops/modops.py:59"),
    "sub_mod": ("src/repro_torch/kernels/csrc/modops.cu", "src/repro/kernels/modops/modops.py:69"),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,micro,main",
                    help="comma-separated subset of kernels,micro,main")
    ap.add_argument("--profile", action="store_true",
                    help="run the main phase under torch.profiler and report "
                         "device time by kernel")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    unknown = phases - {"kernels", "micro", "main"}
    if unknown:
        raise SystemExit(f"unknown phases: {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

    from repro_torch.core.params import paper_params

    phase_env()
    paper = paper_params() if phases & {"kernels", "main"} else None
    timings = phase_kernels(paper) if "kernels" in phases else {}
    if "micro" in phases:
        phase_micro()
    launches = {}
    if "main" in phases:
        launches = phase_main(paper, profile=args.profile)

    records = []
    for name, (source, replaces) in KERNEL_META.items():
        rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches.get(name, 0)}
        rec.update(timings.get(name, {}))
        records.append(rec)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
