#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: builds the CUDA kernels from
the sources in this checkout, holds each against its plain PyTorch
version on the card, and drives the port's paths: the encrypted query
engine at the paper's parameters (n = 32768, t = 65537, 30 RNS limbs,
LINEITEM at 32768 rows), the LM substrate's serving path at gemma2-27b's
full width and depth, and its training path at starcoder2-3b's:

  kernels   every kernel against its plain version (the limb kernels and
            rotate_reduce exactly, both NTTs at every n = 2 .. 32768,
            flash_attn within 1e-4 in float32 and 2e-2 in bfloat16 on
            its tile edges too), then timed at its main path's shapes;
  micro     the quickstart twin (`examples/quickstart_torch.py`) at micro
            parameters;
  main      encrypted TPC-H Q6 (the legacy `run_q6` body) on real BFV
            ciphertexts, checked against the numpy oracle;
  workload  TPC-H Q1 through the compiled DAG (`run_via_plan`, static
            verification on) on the same BFV backend and table, and,
            in a child process beside it, the cross-query scheduler
            `run_workload([Q1, Q6])` on `MockBackend(kernel_reduce=True)`,
            whose `sum_slots` runs the rotate_reduce kernel; every result
            checked against its oracle;
  tpch      the paper's join queries on the same keys: TPC-H Q12 and Q19
            through `run_via_plan` on LINEITEM at 32,768 rows (one block)
            with ORDERS and PART cut (`TPCH_SCALE`), each against its
            oracle with no refresh but those the planner placed (Q19
            refreshes its three translated part masks), batched circuits
            in lane chunks sized to the card's free memory; beside each,
            the plan's OpStats on `MockBackend` at the paper's noise
            profile;
  legacy    the five queries with hand-written bodies only, on the same
            keys: TPC-H Q4, Q14, Q17, Q5 and Q8 through `run_qN` over all
            eight tables (LINEITEM 4,096 rows in one block, the parents
            cut: `LEGACY_SCALE`, a few rows planted: `legacy_tables`), each
            equal to its oracle with a field that is not 0, its stages
            and join hops timed (each outermost engine call ended by a
            synchronize); beside each, the same
            body on `MockBackend` at the paper's noise profile (a child
            process), whose mul / rotate / refresh / max_depth and refresh
            log must equal the BFV run's;
  shard     sharded execution on logical shard contexts, under the same
            keys: Q1 on LINEITEM at 65,536 rows (two blocks) unsharded, at
            shards=2 x limb_shards=4, and at shards=2 losing a worker
            mid-query (resharded 2 -> 1, resumed from a stage checkpoint),
            all equal to the oracle with equal OpStats; the cost model
            (per-op seconds measured on the card, op-count and ledger
            pricing); a checkpoint of Q1's encrypted columns restored onto
            the card; and, in a child process beside the three runs, the
            chaos suite's fault classes over the Q1/Q6/Q12/Q19 mix on
            `MockBackend(kernel_reduce=True)`;
  serve     gemma2-27b, 46 layers in bfloat16 from a seeded generator,
            through `repro_torch.launch.serve.main` (`--dtype bfloat16`):
            2 prompts of 5120 tokens through the prefill step (every
            attention layer one flash_attn launch), then 16 greedy decode
            steps; first a float32 check at full width with 4 layers that
            decode(prefill(x[:-1]), x[-1]) equals prefill(x)'s last logits;
  scan      the paper's encrypted-scan step (`launch/nshedb_step.query_step`)
            at `configs/nshedb.CONFIG` (n = 32768, k = 32, t = 65537) on
            64 blocks (2.1 M rows) for the scan_2m, scan_33m_pagg and
            scan_33m_rs cells (the last is scan_2m's arithmetic on one
            device under the other ks_mode, and must equal it), every product and
            sum on the mul_mod / add_mod kernels; one block's key switch,
            square, multiply and rotation held exactly against plain
            versions;
  mesh      four ranks sharing the card over gloo (CUDA tensors) on a
            2 x 2 ("data", "model") mesh, each running Q1 at the paper's
            parameters with every stacked batch held over "data" and
            "model" (Q1's one block stacks one fused 6-lane batch of its
            5 EQ atoms: 3 lanes a rank, 15 of 30 limbs of them) and every
            key switch key held by its 15-limb output slice, its ledger
            equal to a logical 2 x 2 context's, its all-gather bytes to
            the count; then in the same ranks, at the same parameters, a
            4-lane BFV batch of 3 live blocks held so (2 lanes, 15 limbs a
            rank) through mul, rotate, fold, decrypt and a refresh of
            lanes 0 and 2, then one more encryption, each against the
            same calls on one device from the same generator state (run
            once, in the parent, with whole keys, beside the ranks); then the
            scan step on the mesh (`nshedb_step.query_step_sharded`) at
            `CONFIG` on 16 blocks, 8 a "data" rank and 16 limbs a "model"
            rank, each rank holding only its shard, in both key-switch
            modes: every rank's aggregate equal to the one-device
            `query_step` on the card, its collective bytes equal to the
            dry-run's count (`launch/dryrun.measure_step`) and its peak
            beside the dry-run's; beside the ranks, one rank under NCCL;
  train     (a) the attention gradient (flash_attn forward, torch-op
            backward) against autograd through the plain version on the
            card, float32, four cases up to S = 4500; (b) starcoder2-3b at
            full width and depth in float32 through
            `repro_torch.launch.train.main` for 6 steps of 2 x 1024
            tokens (one flash_attn launch per layer a step, the backward
            in torch ops); (c) at full width with 2 layers: one step on the
            card against the same step on the CPU, a --compress-grads
            step, and save at step 2 / resume to step 4 against an
            uninterrupted run.

    python3 chip_smoke.py            # needs one NVIDIA GPU and nvcc

Output: one JSON object per line (`env`, `kernel_checks`, `micro`,
`main`, `workload`, `tpch`, `legacy`, `shard`, `shard_chaos`,
`serve_consistency`, `serve`, `scan`, `mesh`, `train`, `phase_seconds`,
`kernels`),
the card's name and power limit as nvidia-smi prints them, and as the
last line `{"ok": true, "device": {...}}`.  Any failed phase raises, so
the exit code is non-zero and no result line is printed.

`--phases` runs a subset (env always runs), e.g. `--phases kernels` for a
first check of a changed kernel or `--phases serve` for the LM path
alone; the end check then asks launches only of the kernels of the paths
that ran.  `--profile` adds device time by kernel (`profile`,
`serve_profile`, `train_profile` lines).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import shutil
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
PEAK_BF16_FLOPS = 989e12     # dense tensor-core rate

# the spin kernel's cycles per second of host issue time it must cover: at
# least the H100's 1.98 GHz boost clock, so a spin never ends early
SPIN_CYCLES_PER_S = 2e9

LANES = 5            # Q6's five `lt` atoms run as one stacked batch
SEED = 0
# the kernels under every BFV ciphertext operation (core/limbops.py)
BFV_KERNELS = ("ntt_fwd", "ntt_inv", "mul_mod", "add_mod", "sub_mod")
# the kernels each driven path must launch
PATH_KERNELS = {"main": BFV_KERNELS, "workload_q1_bfv": BFV_KERNELS, "tpch": BFV_KERNELS,
                "legacy": BFV_KERNELS, "workload_mock": ("rotate_reduce",),
                "shard_q1_bfv": BFV_KERNELS,
                "shard_chaos_mock": ("rotate_reduce",), "serve": ("flash_attn",),
                "scan": ("mul_mod", "add_mod"), "mesh": BFV_KERNELS,
                "mesh_scan": ("mul_mod", "add_mod"), "train": ("flash_attn",)}
# flash_attn against its plain version: the kernel and the dense version
# sum in different orders (float32), and bfloat16 outputs round at 2^-8
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# q's scale in the softcap cases: scores then reach tens, where a cap of 50
# bends them, so a kernel without the softcap fails the check
SOFTCAP_Q_SCALE = 12.0
# torch.compile's caches (the flex_attention yardstick) stay in the checkout
BUILD_DIR = os.path.join(HERE, "src", "repro_torch", "kernels", "_build")


def emit(tag: str, obj: dict) -> None:
    print(json.dumps({tag: obj}), flush=True)


def gpu_ms(fn, reps: int, inner: int = 5, warmup: int = 2, queued: bool = True) -> float:
    """Median milliseconds of one fn() on the card: CUDA events around
    `inner` back-to-back calls, divided by `inner`, median over `reps`.

    `queued`: the calls are queued behind a spin kernel long enough for
    the host to issue all of them before the card reaches the first, so
    the time is the card's alone even where one call costs the host more
    than the card (small kernels behind Python wrappers).  Without it the
    card waits for the host between calls wherever that is so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    issue_s = time.perf_counter() - t0         # the host's time to issue `inner` calls
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(int((2 * issue_s + 1e-3) * SPIN_CYCLES_PER_S))
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
def _draw_residues(gen, q, shape):
    """Residues below q (a (limbs, 1) int64 tensor) in `shape`, drawn on
    q's device from the torch generator `gen`: a draw on the host at the
    paper's shapes costs tens of seconds."""
    x = torch.randint(0, 1 << 62, tuple(shape), generator=gen, device=q.device)
    return x.remainder_(q)


def _rand_limbs(rng, primes, lead, n, dev):
    """(*lead, len(primes), n) residues on `dev`, from a generator seeded
    by the next draw of `rng`."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 62)))
    q = torch.tensor(primes, dtype=torch.int64, device=dev)[:, None]
    return _draw_residues(gen, q, tuple(lead) + (len(primes), n))


def _check_equal(name, got, exp, what) -> int:
    """Raise unless got == exp bit for bit; returns the measured max |got - exp|."""
    torch.cuda.synchronize()
    err = int((got - exp).abs().max())
    if err != 0 or not torch.equal(got, exp):
        bad = int((got != exp).sum())
        raise AssertionError(f"{name} disagrees with its plain version at {what}: "
                             f"{bad} of {got.numel()} elements differ, max |diff| {err}")
    return err


def _ntt_every_n(paper, rng, dev) -> int:
    """ntt_fwd and ntt_inv against their plain versions at every n =
    2^1 .. 2^15 the wrappers accept, on three limbs of each of the
    paper's bases (30-bit Q, 31-bit P; their primes are 1 mod 2^16, so
    they serve every such n): random rows, rows of q - 1 and zero rows,
    and intt(ntt(x)) == x."""
    from repro_torch.core.limbops import LimbOps, force_ref
    from repro_torch.core.params import _make_ntt_tables

    checks = 0
    for log_n in range(1, 16):
        n = 1 << log_n
        for base, tables in (("Q", paper.Q), ("P", paper.P)):
            ops = LimbOps(_make_ntt_tables(list(tables.primes[:3]), n), device=dev)
            q = ops.q[:, None]
            x = torch.cat([_rand_limbs(rng, ops.primes, (2,), n, dev),
                           (q - 1).expand(3, n)[None], torch.zeros_like(q).expand(3, n)[None]])
            what = f"n={n} base {base}"
            fwd = ops.ntt(x)
            with force_ref():
                fwd_ref, inv_ref = ops.ntt(x), ops.intt(x)
            _check_equal("ntt_fwd", fwd, fwd_ref, what)
            _check_equal("ntt_inv", ops.intt(x), inv_ref, what)
            _check_equal("ntt_inv(ntt_fwd)", ops.intt(fwd), x, what)
            checks += 3
    return checks


def _limb_slice_checks(paper, rng, dev) -> int:
    """`LimbLocalOps` over each half of the paper's Q base (the limb
    slices a 2-way "model" axis gives `kswitch_gathered`) at the mesh
    path's shapes: ntt of the gathered digits (lanes, k, k/2, n), mul by
    the key's output-limb slice (k, k/2, n) and intt of the digit sums
    (lanes, k/2, n), for 1 lane (Q1's one block) and 2 (a 4-lane batch
    over a 2-way "data" axis).  Each kernel call is held against the same
    call under `force_ref` and against the whole base's plain version
    on a (..., k, n) tensor holding the slice in limbs [lo, hi) — a
    check of the slice's tables that does not read them."""
    from repro_torch.core.limbops import LimbLocalOps, LimbOps, force_ref

    k, n = paper.k, paper.n
    whole = LimbOps(paper.Q, device=dev)

    def in_base(x, lo, hi):
        full = torch.zeros(*x.shape[:-2], k, n, dtype=x.dtype, device=x.device)
        full[..., lo:hi, :] = x
        return full

    checks = 0
    for lo, hi in ((0, k // 2), (k // 2, k)):
        ops = LimbLocalOps(paper.Q, lo, hi, device=dev)
        key = _rand_limbs(rng, ops.primes, (k,), n, dev)
        for lanes in (1, 2):
            digits = _rand_limbs(rng, ops.primes, (lanes, k), n, dev)
            sums = _rand_limbs(rng, ops.primes, (lanes,), n, dev)
            what = f"limbs [{lo}, {hi}) x {lanes} lanes"
            for name, fn, whole_fn in (
                    ("ntt_fwd", lambda: ops.ntt(digits),
                     lambda: whole.ntt(in_base(digits, lo, hi))),
                    ("mul_mod", lambda: ops.mul(digits, key),
                     lambda: whole.mul(in_base(digits, lo, hi), in_base(key, lo, hi))),
                    ("ntt_inv", lambda: ops.intt(sums),
                     lambda: whole.intt(in_base(sums, lo, hi)))):
                got = fn()
                with force_ref():
                    exp, exp_whole = fn(), whole_fn()[..., lo:hi, :]
                _check_equal(name, got, exp, what)
                _check_equal(name, got, exp_whole, what + " (whole base)")
                checks += 2
            del digits, sums
    return checks


E8 = 8               # bytes per element at the kernel boundary (int64)
BFLY_OPS = 10        # integer operations per radix-2 butterfly


def _ntt_cost(x, n: int, inverse: bool) -> tuple[int, int]:
    """(bytes, integer operations) an NTT of x's rows must take: each row
    read and written once in int64, n/2 butterflies per stage, and for the
    inverse the multiply by n^-1."""
    ops = x.numel() // 2 * (n.bit_length() - 1) * BFLY_OPS
    return 2 * x.numel() * E8, ops + (6 * x.numel() if inverse else 0)


def _timed(name, fn, x, nbytes: int, nops: int, plain=None) -> dict:
    """A kernel's call fn() against its plain version on the same inputs
    (exact), then its time on the card (`ms`), the time of back-to-back
    calls that the card waits for the host to issue (`issue_ms`: the
    wrapper's host cost where it exceeds the kernel's), the plain
    version's and the bound.  The plain version is `plain()`, or fn()
    under `force_ref` (a LimbOps call) when None."""
    from repro_torch.core.limbops import force_ref

    def plain_fn():
        if plain is not None:
            return plain()
        with force_ref():
            return fn()

    got = fn()
    exp = plain_fn()
    err = _check_equal(name, got, exp, f"shape {tuple(x.shape)}")
    del got, exp
    ms = gpu_ms(fn, reps=10, inner=20)
    issue_ms = gpu_ms(fn, reps=10, inner=20, queued=False)
    plain_ms = gpu_ms(plain_fn, reps=3, inner=2, warmup=1)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_INT_OPS_PER_S * 1e3
    return {"shape": list(x.shape), "max_abs_err": err, "ms": ms, "issue_ms": issue_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def phase_kernels(paper) -> dict:
    """Bit-equality of every kernel with its plain version at n in
    {128, 4096, 32768} on the Q (30-bit) and P (31-bit) bases and of the
    NTTs at every n, then timings at the main path's shapes."""
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

    checks += _ntt_every_n(paper, rng, dev)
    checks += _limb_slice_checks(paper, rng, dev)

    # timings at the shapes Q6 gives the kernels (5 lanes, k = 30, n = 32768)
    k, n = paper.k, paper.n
    lq = LimbOps(paper.Q, device=dev)
    lp = LimbOps(paper.P, device=dev)
    digits = _rand_limbs(rng, paper.Q.primes, (LANES, k), n, dev)    # key-switch digits
    ksk = _rand_limbs(rng, paper.Q.primes, (k,), n, dev)             # one key half
    lane = _rand_limbs(rng, paper.Q.primes, (LANES,), n, dev)        # one ct component
    ct1 = _rand_limbs(rng, paper.Q.primes, (LANES, 2), n, dev)       # ciphertext payloads
    ct2 = _rand_limbs(rng, paper.Q.primes, (LANES, 2), n, dev)
    specs = {
        "ntt_fwd": (lambda: lq.ntt(digits), digits, _ntt_cost(digits, n, inverse=False)),
        "ntt_inv": (lambda: lq.intt(lane), lane, _ntt_cost(lane, n, inverse=True)),
        "mul_mod": (lambda: lq.mul(digits, ksk), digits,
                    ((2 * digits.numel() + ksk.numel()) * E8, 8 * digits.numel())),
        "add_mod": (lambda: lq.add(ct1, ct2), ct1, (3 * ct1.numel() * E8, 3 * ct1.numel())),
        "sub_mod": (lambda: lq.sub(ct1, ct2), ct1, (3 * ct1.numel() * E8, 3 * ct1.numel())),
    }
    out = {name: _timed(name, fn, x, *cost) for name, (fn, x, cost) in specs.items()}
    # both NTTs also at the other row counts the paths give them
    # (`ntt_launches_by_rows`): one multiply's limb set is (1 or 5 lanes) x
    # k rows in Q (k = 30) or P (31), the key-switch digits 4500 rows
    one = _rand_limbs(rng, paper.Q.primes, (1,), n, dev)
    one_p = _rand_limbs(rng, paper.P.primes, (1,), n, dev)
    lane_p = _rand_limbs(rng, paper.P.primes, (LANES,), n, dev)
    out["ntt_inv"]["at_rows"] = {
        str(x.numel() // n): _timed("ntt_inv", lambda ops=ops, x=x: ops.intt(x), x,
                                    *_ntt_cost(x, n, inverse=True))
        for ops, x in ((lq, one), (lp, one_p), (lp, lane_p), (lq, digits))}
    out["ntt_fwd"]["at_rows"] = {
        str(x.numel() // n): _timed("ntt_fwd", lambda x=x: lq.ntt(x), x,
                                    *_ntt_cost(x, n, inverse=False))
        for x in (lane, one)}
    # the pointwise kernels also at the other shapes that carry most of
    # their launches on Q6 and Q1 (`modops_launches_by_shape`, "rows_a/rows_b")
    for name, op, per_elem, shapes in (("mul_mod", lq.mul, 8, ((30, 30), (900, 900), (150, 150))),
                                       ("add_mod", lq.add, 3, ((60, 60),))):
        out[name]["at_shapes"] = {}
        for rows, rows_b in shapes:
            a = _rand_limbs(rng, paper.Q.primes, (rows // k,), n, dev)
            b = _rand_limbs(rng, paper.Q.primes, (rows_b // k,), n, dev)
            out[name]["at_shapes"][f"{rows}/{rows_b}"] = _timed(
                name, lambda op=op, a=a, b=b: op(a, b), a,
                (2 * a.numel() + b.numel()) * E8, per_elem * a.numel())
    rr_checks, out["rotate_reduce"] = _rotate_reduce_kernel(paper, dev)
    fa_checks, out["flash_attn"] = _flash_attn_kernel(rng, dev)
    emit("kernel_checks", {"equal_to_plain_version": checks + rr_checks,
                           "tolerance": "exact (torch.equal)",
                           "flash_attn": fa_checks})
    return out


RR_NS = (1, 32, 256, 16384, 65536)
RR_ROWS = (1, 2, 3, 368)
RR_RING = 4          # distinct inputs a cold-L2 timing cycles through


def _rr_rows(gen, rows, n, t, dev):
    """(rows, n) int64 values in [0, t_row) on the card (t: an int or a
    (rows, 1) table): lane 0 at t - 1, the last lane 0 in every other row,
    row 2 all t - 1."""
    x = torch.randint(0, 1 << 62, (rows, n), generator=gen, device=dev) % t
    tcol = t if isinstance(t, int) else t[:, 0]
    x[:, 0] = tcol - 1
    x[1::2, -1] = 0
    if rows > 2:
        x[2] = (t if isinstance(t, int) else int(t[2, 0])) - 1
    return x


def _cold_ms(fn, inputs) -> float:
    """gpu_ms of fn over a ring of distinct inputs, each output held until
    its slot comes round again: every call finds its operands and its
    output buffer out of the 50 MB L2 when the ring is well past it."""
    outs = [None] * len(inputs)
    at = [0]

    def step():
        k = at[0] % len(inputs)
        at[0] += 1
        outs[k] = fn(inputs[k])

    return gpu_ms(step, reps=10, inner=20)


def _rr_bound(x, chunk_mode: bool) -> tuple[float, str]:
    """(bound ms, what bounds it): each value read once and written once
    in x's width; one add mod t a value in full mode, three (the prefix
    add, the window's subtract and, for a wrapped window, an add) in
    chunk mode."""
    t_bytes = 2 * x.numel() * x.element_size() / PEAK_BYTES_PER_S * 1e3
    t_ops = (3 if chunk_mode else 1) * x.numel() / PEAK_INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _rotate_reduce_kernel(paper, dev) -> tuple[int, dict]:
    """rotate_reduce against its plain version, exactly: full mode and
    each of the chunks 1, 8, n/16 and n that is a power of two <= n, n in
    RR_NS, rows in RR_ROWS, int32 and int64, one t and a per-row table of
    distinct primes below 2^30 (in the rows' dtype).  Then timed at the
    half-row shapes `MockBackend.sum_slots` gives it, int32 as it sends
    them and int64 as it sent them before: (2, n/2) for LINEITEM at 32768
    rows (one block) and (368, n/2) for TPC-H SF-1 (6,001,215 rows, 184
    blocks), the latter over a ring of inputs and outputs past the L2;
    chunk n/16 at (368, n/2); each beside the library yardstick, and the
    (2, n/2) one beside an empty launch queued the same way; the three
    int32 shapes at every cluster size."""
    from repro_torch.core.mathutil import find_ntt_primes
    from repro_torch.kernels.rotate_reduce import rotate_reduce as rr_launch
    from repro_torch.kernels.rotate_reduce.ops import rotate_reduce
    from repro_torch.kernels.rotate_reduce.ref import rotate_reduce_ref

    t = paper.t
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # distinct primes below 2^30 (odd: 1 mod 2), whose sums stay inside
    # int32 as the Pallas kernel adds
    table = torch.tensor(find_ntt_primes(1, 30, max(RR_ROWS)), device=dev)[:, None]
    checks = 0
    for n in RR_NS:
        chunks = [None] + sorted({c for c in (1, 8, n // 16, n) if 1 <= c <= n})
        for rows in RR_ROWS:
            for ts in (t, table[:rows]):
                x64 = _rr_rows(gen, rows, n, ts, dev)
                for dtype in (torch.int32, torch.int64):
                    x = x64.to(dtype)
                    tx = ts if isinstance(ts, int) else ts.to(dtype)
                    kind = "one t" if isinstance(ts, int) else "per-row t"
                    for chunk in chunks:
                        _check_equal("rotate_reduce", rotate_reduce(x, tx, chunk),
                                     rotate_reduce_ref(x, tx, chunk),
                                     f"({rows}, {n}) {dtype} {kind} chunk={chunk}")
                        checks += 1
                del x64, x
    half = paper.n // 2
    library = lambda x: (x.sum(-1, keepdim=True) % t).expand_as(x).contiguous()  # noqa: E731
    timed = {}
    for dtype in (torch.int32, torch.int64):
        for rows, chunk in ((2, None), (368, None), (368, half // 16)):
            if dtype == torch.int64 and chunk is not None:
                continue
            x = _rr_rows(gen, rows, half, t, dev).to(dtype)
            stop_log = (half if chunk is None else chunk).bit_length() - 1
            err = _check_equal("rotate_reduce", rotate_reduce(x, t, chunk),
                               rotate_reduce_ref(x, t, chunk),
                               f"main-path shape {(rows, half)} {dtype} chunk={chunk}")
            bound, by = _rr_bound(x, chunk is not None)
            cold = rows > 2
            ring = [x] + [_rr_rows(gen, rows, half, t, dev).to(dtype)
                          for _ in range(RR_RING - 1)] if cold else None

            def time_it(fn):
                return _cold_ms(fn, ring) if cold else gpu_ms(lambda: fn(x), reps=10, inner=20)

            rec = {"shape": [rows, half], "dtype": str(dtype).split(".")[-1],
                   "chunk": chunk, "l2": "cold" if cold else "warm", "max_abs_err": err,
                   "cluster": rr_launch.cluster_size(rows, half, torch.cuda.get_device_properties(
                       dev).multi_processor_count, chunk is not None),
                   "ms": time_it(lambda a: rotate_reduce(a, t, chunk)),
                   "plain_ms": gpu_ms(lambda: rotate_reduce_ref(x, t, chunk), reps=5),
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": time_it(library) if chunk is None else None}
            if rows == 2:
                rec["empty_launch_ms"] = gpu_ms(lambda: torch.cuda._sleep(1), reps=10, inner=20)
            if dtype == torch.int32:
                rec["ms_by_cluster"] = {
                    str(c): time_it(lambda a, c=c: rr_launch.rotate_reduce_cuda(
                        a, t, stop_log, cluster=c)) for c in (1, 2, 4, 8)}
            key = f"{rows}x{half}_{rec['dtype']}" + ("" if chunk is None else f"_chunk{chunk}")
            timed[key] = rec
            del ring, x
    main = timed.pop(f"2x{half}_int32")
    return checks, {**main, "at_shapes": timed}


def _visible_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask leaves visible, positions from 0."""
    q = np.arange(sq)
    hi = np.minimum(q + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def _attn_inputs(rng, B, H, Hkv, Sq, Sk, D, dtype, dev, *, q_scale=1.0, strided=False):
    """q (B, H, Sq, D) and k, v (B, Hkv, Sk, D) from a seeded normal, q
    times `q_scale`.  `strided` gives `.transpose(1, 2)` views of (B, S,
    heads, D) buffers, the layout `models.layers.attn_scores` passes;
    otherwise contiguous tensors."""
    out = []
    for shape, scale in (((B, Sq, H, D), q_scale), ((B, Sk, Hkv, D), 1.0),
                         ((B, Sk, Hkv, D), 1.0)):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))
        x = x.to(dev, dtype).transpose(1, 2)
        out.append(x if strided else x.contiguous())
    return out


def _check_close(got, exp, what) -> float:
    """Raise unless flash_attn's result is within FLASH_TOL of its plain
    version's; returns the measured max |got - exp|."""
    torch.cuda.synchronize()
    err = float((got.float() - exp.float()).abs().max())
    if not err <= FLASH_TOL[got.dtype]:
        raise AssertionError(f"flash_attn disagrees with its plain version at {what}: "
                             f"max |diff| {err} > {FLASH_TOL[got.dtype]}")
    return err


def _flex_attention_call(q, k, v, kw):
    """One PyTorch call computing flash_attn's function with a softcap:
    `flex_attention` under `torch.compile`, the softcap as its score_mod
    and the causal (and window) mask as a block mask built here, outside
    the returned call.  A yardstick only: the port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    cap, window = kw["softcap"], kw.get("window")

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        keep = q_idx >= kv_idx
        if window is not None:
            keep = keep & (q_idx - kv_idx < window)
        return keep

    block_mask = create_block_mask(mask_mod, None, None, q.shape[2], k.shape[2],
                                   device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(q, k, v, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)


# flash_attn's checks: (B, H, Hkv, Sq, Sk, D, kwargs)
FLASH_CASES = [
    (2, 4, 2, 256, 256, 128, dict(causal=True)),
    (1, 4, 4, 320, 320, 64, dict(causal=True, window=64)),
    (2, 4, 2, 256, 256, 96, dict(causal=True, softcap=50.0)),
    (1, 12, 1, 200, 200, 256, dict(causal=True, window=96, softcap=50.0)),
    (1, 4, 2, 130, 300, 128, dict(causal=False)),
    (1, 2, 1, 300, 100, 64, dict(causal=False, window=50)),   # rows >= 149 see no key
    (1, 32, 16, 1000, 1000, 128, dict(causal=True, window=256, softcap=50.0)),
]
# the edges of the tensor-core kernel's tiles (64 query rows; 64 keys, past
# D = 128 32 or 16): lengths 1, 15, 17, 127, 129 and 65 (one past a query
# tile), every head dim the configs use, GQA 8 (qwen2-72b's 64 / 8), and
# window edges inside a tile
FLASH_EDGE_CASES = [
    (1, 2, 1, 1, 1, 16, dict(causal=True)),
    (1, 2, 2, 15, 15, 64, dict(causal=True, softcap=50.0)),
    (2, 2, 1, 17, 17, 96, dict(causal=True, window=5)),
    (1, 4, 2, 127, 127, 128, dict(causal=True)),
    (1, 2, 1, 129, 129, 256, dict(causal=True, softcap=50.0)),
    (1, 2, 2, 65, 65, 64, dict(causal=True, window=40)),
    (1, 2, 1, 1, 129, 128, dict(causal=False)),
    (1, 2, 1, 129, 15, 64, dict(causal=False)),
    (1, 2, 1, 17, 127, 16, dict(causal=True)),
    (1, 2, 1, 127, 17, 96, dict(causal=True, softcap=50.0)),
    (1, 4, 2, 129, 129, 16, dict(causal=True, softcap=50.0)),
    (1, 16, 2, 129, 129, 128, dict(causal=True, softcap=50.0)),
    (1, 2, 1, 300, 300, 128, dict(causal=True, window=100)),
    (1, 2, 1, 200, 130, 256, dict(causal=False, window=70)),
]


def _flash_attn_checks(dev) -> dict:
    """flash_attn against its plain version (`mha_ref`, dense float32) on
    FLASH_CASES and FLASH_EDGE_CASES, float32 and bfloat16, each with
    contiguous inputs and with the strided views the serving path passes;
    the softcap cases scale q by SOFTCAP_Q_SCALE and check that leaving
    the softcap out would fail the comparison.  Inputs from their own
    seeded generator."""
    from repro_torch.kernels.flash_attn.ops import mha
    from repro_torch.kernels.flash_attn.ref import mha_ref

    rng = np.random.default_rng(SEED)
    cases = FLASH_CASES + FLASH_EDGE_CASES
    errs, softcap_effect = {}, float("inf")
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for B, H, Hkv, Sq, Sk, D, kw in cases:
            for strided in (False, True):
                # softcap cases scale q so that |scores| reach the cap's order
                q, k, v = _attn_inputs(rng, B, H, Hkv, Sq, Sk, D, dtype, dev, strided=strided,
                                       q_scale=SOFTCAP_Q_SCALE if "softcap" in kw else 1.0)
                exp = mha_ref(q, k, v, **kw)
                what = f"{(B, H, Hkv, Sq, Sk, D)} {kw} {dtype} strided={strided}"
                worst = max(worst, _check_close(mha(q, k, v, **kw), exp, what))
                if "softcap" in kw:
                    # a kernel that left the softcap out must fail this check
                    uncapped = mha_ref(q, k, v, **dict(kw, softcap=None))
                    effect = float((uncapped.float() - exp.float()).abs().max())
                    if not effect > 5 * FLASH_TOL[dtype]:
                        raise AssertionError(f"softcap changes the result by only {effect} "
                                             f"at {what}: the check cannot see it")
                    softcap_effect = min(softcap_effect, effect)
        errs[str(dtype).replace("torch.", "")] = worst
    return {"cases": 4 * len(cases), "layouts": ["contiguous", "(B, S, H, D) transposed"],
            "edge_cases": len(FLASH_EDGE_CASES),
            "max_abs_err": errs,
            "tolerance": {str(k).replace("torch.", ""): v for k, v in FLASH_TOL.items()},
            "tolerance_reason": "summation order (float32); bfloat16 output rounding",
            "softcap_q_scale": SOFTCAP_Q_SCALE,
            "softcap_effect_min_abs": softcap_effect}


def _flash_attn_kernel(rng, dev) -> tuple[dict, dict]:
    """`_flash_attn_checks`, then flash_attn timed at gemma2-27b's prefill
    shape (B=2, H=32, Hkv=16, S=5120, D=128, bf16) for a global and a
    local layer beside `flex_attention`, for a global layer without the
    softcap (what the softcap costs) and at starcoder2-3b's (H=24,
    Hkv=2), causal with no softcap, both beside
    `scaled_dot_product_attention`."""
    from repro_torch.kernels.flash_attn.ops import mha
    from repro_torch.kernels.flash_attn.ref import mha_ref

    checks = _flash_attn_checks(dev)

    def timed(B, H, Hkv, S, D, kw, library=False):
        # the layout the serving path passes: views of (B, S, heads, D)
        q, k, v = _attn_inputs(rng, B, H, Hkv, S, S, D, torch.bfloat16, dev, strided=True)
        exp = mha_ref(q, k, v, **kw)
        err = _check_close(mha(q, k, v, **kw), exp,
                           f"main-path shape {(B, H, Hkv, S, D)} {kw}")
        pairs = _visible_pairs(S, S, kw.get("causal", True), kw.get("window"))
        flops = 4 * D * pairs * B * H
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        rec = {"shape": {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "dtype": "bfloat16"},
               "mask": kw, "visible_pairs_per_head": pairs, "max_abs_err": err,
               "ms": gpu_ms(lambda: mha(q, k, v, **kw), reps=5, inner=2),
               "plain_ms": gpu_ms(lambda: mha_ref(q, k, v, **kw), reps=3, inner=1, warmup=1),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None}
        if "softcap" in kw:
            t0 = clock()
            call = _flex_attention_call(q, k, v, kw)
            lib_err = _check_close(call(), exp, f"flex_attention at {(B, H, Hkv, S, D)} {kw}")
            rec["library_compile_s"] = clock() - t0
            rec["library_ms"] = gpu_ms(call, reps=5, inner=2)
            rec["library_max_abs_err"] = lib_err
            rec["library_call"] = ("torch.compile(flex_attention)(score_mod=softcap, "
                                   "block_mask=causal/window, enable_gqa=True)")
        elif library:
            rep = H // Hkv
            kr = k.repeat_interleave(rep, dim=1)
            vr = v.repeat_interleave(rep, dim=1)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            rec["library_ms"] = gpu_ms(lambda: sdpa(q, kr, vr, is_causal=True), reps=5, inner=2)
            rec["library_call"] = "scaled_dot_product_attention(is_causal=True), KV heads repeated"
        return rec

    g = dict(causal=True, softcap=50.0)
    rec = timed(2, 32, 16, 5120, 128, g)
    rec["at_local_layer"] = timed(2, 32, 16, 5120, 128, dict(g, window=4096))
    rec["at_global_layer_no_softcap"] = timed(2, 32, 16, 5120, 128, dict(causal=True),
                                              library=True)
    rec["at_starcoder2_causal"] = timed(2, 24, 2, 5120, 128, dict(causal=True), library=True)
    return checks, rec


# ------------------------------------------------------------------- micro
def phase_micro() -> None:
    """The quickstart twin (`examples/quickstart_torch.py`) on the card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(HERE, "examples", "quickstart_torch.py"))
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out = quickstart.main([], device="cuda")
    torch.cuda.synchronize()
    res = {"got": out["got"], "expected": out["expected"], "refresh": out["stats"].refresh,
           "seconds": round(time.perf_counter() - t0, 3)}
    emit("micro", res)
    if out["got"] != out["expected"] or out["stats"].refresh != 0:
        raise AssertionError(f"micro query wrong: {res}")


# -------------------------------------------------------------------- main
def _profile_summary(prof, wall_s: float) -> dict:
    """Device time by kernel name from a torch.profiler run of a query or
    a serving stage."""
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


def ntt_launches_by_rows() -> dict:
    """ntt_fwd and ntt_inv launches since the last reset, by row count."""
    from repro_torch.kernels.ntt import ntt
    return {fn: {str(rows): n for rows, n in sorted(by_rows.items())}
            for fn, by_rows in ntt.LAUNCHES_BY_ROWS.items()}


def modops_launches_by_shape() -> dict:
    """mul_mod, add_mod and sub_mod launches since the last reset, by the
    row counts of their operands as "rows_a/rows_b" (n = 32768 on the
    paths), most launched first."""
    from repro_torch.kernels.modops import modops
    return {fn: {f"{a}/{b}": n for (a, b), n in sorted(by_shape.items(), key=lambda kv: -kv[1])}
            for fn, by_shape in modops.LAUNCHES_BY_SHAPE.items()}


def clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def load_paper_lineitem(paper):
    """Keygen at the paper's parameters and LINEITEM (32768 rows) loaded
    encrypted: (backend, database, stage seconds)."""
    from repro_torch.engine import tpch
    from repro_torch.engine.backend import BFVBackend

    secs = {}
    t0 = clock()
    bk = BFVBackend(paper, seed=SEED)
    secs["keygen"] = clock() - t0
    t0 = clock()
    db = tpch.load(bk, tpch.Scale(), tables=["lineitem"])
    secs["load_encrypt"] = clock() - t0
    return bk, db, secs


def phase_main(paper, profile: bool = False):
    """Encrypted TPC-H Q6 at the paper's parameters, LINEITEM 32768 rows.
    With `profile`, the query runs under torch.profiler and the device
    time by kernel is printed as a `profile` line (the stage seconds then
    include the profiler's overhead).  Returns the launch counts of the
    query and the backend and database, for the workload phase."""
    from repro_torch import kernels
    from repro_torch.engine import queries
    from repro_torch.engine.planner import Planner

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    bk, db, secs = load_paper_lineitem(paper)
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
    by_rows = ntt_launches_by_rows()
    res = {
        "params": {"n": paper.n, "t": paper.t, "k": paper.k},
        "lineitem_rows": li.nrows, "blocks_per_column": li.nblocks,
        "got": got, "expected": exp,
        "seconds": {k: round(v, 3) for k, v in secs.items()},
        "op_stats": dataclasses.asdict(bk.stats),
        "noise_budget_bits_at_decrypt": round(budget_bits, 2),
        "kernel_launches": launches,
        "ntt_launches_by_rows": by_rows,
        "modops_launches_by_shape": modops_launches_by_shape(),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    emit("main", res)
    if got != exp:
        raise AssertionError(f"Q6 revenue {got} != oracle {exp}")
    idle = [name for name in BFV_KERNELS if launches[name] <= 0]
    if idle:
        raise AssertionError(f"main path launched no {idle} kernel")
    return launches, bk, db


# ---------------------------------------------------------------- workload
def _via_plan(bk, pl, faults_plan=None, plan=None) -> dict:
    """A TPC-H plan (`plan_q1()` when None) through `run_via_plan(pl, plan)`
    on real ciphertexts, static verification on (the planner's default),
    optionally under `faults.inject(faults_plan)`.  Stage seconds come from
    the executor's own stage boundaries (`ExecReport.record`), the
    verifier's from `verify_compiled`; the decrypts are timed apart and are
    part of the aggregate stage.  Launch counts are set to 0 just before
    the query and read just after."""
    from repro_torch import kernels
    from repro_torch.engine import executor, queries, verify
    from repro_torch.runtime import faults

    bk.stats.reset()
    bk.op_log.clear()
    bk.refresh_log.clear()
    bk.lane_log.clear()
    secs, seen = {}, {}
    mark = [0.0]
    orig_record, orig_verify, orig_decrypt = (
        executor.ExecReport.record, verify.verify_compiled, bk.decrypt)

    def record(self, label, before, after):
        now = clock()
        secs[label] = secs.get(label, 0.0) + now - mark[0]
        mark[0] = now
        seen["report"] = self
        return orig_record(self, label, before, after)

    def verify_compiled(*args, **kwargs):
        t0 = clock()
        rep = orig_verify(*args, **kwargs)
        secs["static_verify"] = secs.get("static_verify", 0.0) + clock() - t0
        seen["verify"] = rep
        mark[0] = clock()
        return rep

    def decrypt(ct):
        t0 = clock()
        out = orig_decrypt(ct)
        secs["decrypt"] = secs.get("decrypt", 0.0) + clock() - t0
        return out

    torch.cuda.reset_peak_memory_stats()
    executor.ExecReport.record = record
    verify.verify_compiled = verify_compiled
    bk.decrypt = decrypt
    scope = faults.inject(faults_plan) if faults_plan is not None else contextlib.nullcontext()
    kernels.reset_launch_counts()
    t0 = clock()
    try:
        with scope:
            got = queries.run_via_plan(pl, plan or queries.plan_q1())
    finally:
        executor.ExecReport.record = orig_record
        verify.verify_compiled = orig_verify
        bk.decrypt = orig_decrypt
    query_s = clock() - t0
    severities = {}
    for f in seen["verify"].findings:
        severities[f.severity] = severities.get(f.severity, 0) + 1
    return {"got": got, "query_s": query_s, "secs": secs, "report": seen["report"],
            "verify": seen["verify"], "verify_findings": severities,
            "launches": kernels.launch_counts(), "ntt_launches_by_rows": ntt_launches_by_rows(),
            "modops_launches_by_shape": modops_launches_by_shape(),
            "op_stats": dataclasses.asdict(bk.stats), "refresh_log": list(bk.refresh_log),
            "lane_chunks": list(bk.lane_log),
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


def workload_q1_bfv(bk, db) -> dict:
    """TPC-H Q1 through `run_via_plan` on real ciphertexts: optimized
    planner, static verification on (the default)."""
    from repro_torch.engine import queries
    from repro_torch.engine.planner import Planner

    run = _via_plan(bk, Planner(db, optimized=True))
    got, rep, vrep, launches = run["got"], run["report"], run["verify"], run["launches"]
    rep.validate()
    exp = queries.oracle_q1(db)
    res = {
        "query": "Q1", "path": "run_via_plan on BFVBackend(paper_params())",
        "groups": len(got), "values_checked": sum(len(row) for row in exp.values()),
        "equal_to_oracle": got == exp,
        "seconds": {"query": round(run["query_s"], 3),
                    **{k: round(v, 3) for k, v in run["secs"].items()}},
        "history": rep.history,
        "depth": {"measured": rep.measured_depth, "predicted": rep.predicted_depth,
                  "budget_levels": rep.budget_levels},
        "op_stats": run["op_stats"],
        "verify_findings": run["verify_findings"],
        "noise_budget_bits_at_last_decrypt": round(rep.decrypt_headrooms[-1], 2),
        "min_noise_budget_bits": round(min(rep.decrypt_headrooms), 2),
        "kernel_launches": launches,
        "ntt_launches_by_rows": run["ntt_launches_by_rows"],
        "modops_launches_by_shape": run["modops_launches_by_shape"],
        "peak_device_bytes": run["peak_device_bytes"],
    }
    emit("workload", res)
    if got != exp or len(got) != 6 or any(len(row) != 8 for row in got.values()):
        raise AssertionError(f"Q1 on BFV disagrees with oracle_q1: {got} != {exp}")
    if bk.stats.refresh != 0 or vrep.errors:
        raise AssertionError(f"Q1 on BFV: refresh {bk.stats.refresh}, "
                             f"verifier errors {[str(f) for f in vrep.errors]}")
    idle = [name for name in BFV_KERNELS if launches[name] <= 0]
    if idle:
        raise AssertionError(f"Q1 on BFV launched no {idle} kernel")
    return launches, run["op_stats"]


def workload_mock() -> tuple:
    """`run_workload(Planner(db), [Q1, Q6])` on the Mock backend at the
    paper profile with `kernel_reduce=True`: every `sum_slots` of both
    queries is one rotate_reduce launch on the card.  Runs in a child
    process beside `workload_q1_bfv`; returns `_report`'s arguments."""
    from repro_torch import kernels
    from repro_torch.engine import queries, tpch
    from repro_torch.engine.backend import MockBackend
    from repro_torch.engine.planner import Planner
    from repro_torch.engine.workload import run_workload

    t0 = time.perf_counter()
    bk = MockBackend(kernel_reduce=True, device="cuda")
    db = tpch.load(bk, tpch.Scale(), tables=["lineitem"])
    load_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = clock()
    rep = run_workload(Planner(db), [queries.plan_q1(), queries.plan_q6()])
    wall_s = clock() - t0
    launches = kernels.launch_counts()
    exp = [queries.oracle_q1(db), queries.oracle_q6(db)]
    res = {
        "query": "run_workload([Q1, Q6])",
        "path": f"MockBackend(kernel_reduce=True, device={str(bk.device)!r}), paper profile",
        "lineitem_rows": db.tables["lineitem"].nrows,
        "equal_to_oracle": rep.results == exp,
        "seconds": {"load_encrypt": round(load_s, 3), "workload": round(wall_s, 3)},
        "workload_report": {"launches": rep.launches, "muls": rep.muls,
                            "refreshes": rep.refreshes, "hit_rate": rep.hit_rate,
                            "cache": dataclasses.asdict(rep.cache)},
        "op_stats": dataclasses.asdict(bk.stats),
        "sum_slots_calls": bk.op_log["sum"] + bk.op_log["count"],
        "kernel_launches": launches,
    }
    bad = []
    if rep.results != exp:
        bad.append(f"run_workload disagrees with the oracles: {rep.results} != {exp}")
    if launches["rotate_reduce"] < 66:
        bad.append(f"rotate_reduce launched {launches['rotate_reduce']} "
                   f"times, Q1's 66 group aggregates need at least 66")
    return "workload", res, launches, bad


# -------------------------------------------------------------------- tpch
# The paper's join queries on real ciphertexts: LINEITEM at the paper's
# 32,768 rows (one block, §5.1), its parents cut.  A join hop costs one
# EQ circuit, one slot broadcast and one product per parent row, so the
# parents set the phase's time: ORDERS 32 and PART 48 (of Scale()'s
# 8,192 and 1,024), about 0.17 s a key.  At PART 48 some part meets a Q19
# branch (its revenue is not 0; at PART 64 and 96 none does).  Q12's bank
# (32 lanes) fits one lane chunk on the card; Q19's part hops (48 lanes)
# and its `lt` still enter their circuits in lane chunks.  ORDERS 128 and
# PART 192 took the whole script to 1,005-1,270 s of its 1,200 s.
TPCH_SCALE = dict(lineitem=32768, orders=32, part=48)
TPCH_TABLES = ["lineitem", "orders", "part"]
TPCH_QUERIES = ("Q12", "Q19")
MOCK_MATCH = ("mul", "rotate", "refresh", "max_depth")


def _mock_runs(qns, scale: dict, tables, via_plan: bool, planted: bool = False) -> dict:
    """Each query on `MockBackend` at the paper's noise profile over the
    tables at `scale` (`tables`: None for all eight; `planted`: the
    legacy phase's tables, `legacy_tables`), through
    `run_via_plan(pl, plan_qN())` when `via_plan`, else its legacy body
    `run_qN(pl)`: {qn: result, OpStats, refresh_log, seconds}.  A child
    process runs this beside the BFV runs (`_beside`)."""
    from repro_torch.engine import queries, tpch
    from repro_torch.engine.backend import MockBackend
    from repro_torch.engine.planner import Planner

    bk = MockBackend(device="cpu")
    db = (load_raw(bk, legacy_tables(tpch.Scale(**scale))) if planted
          else tpch.load(bk, tpch.Scale(**scale), tables=tables))
    out = {}
    for qn in qns:
        plan_fn, body, _ = queries.QUERIES[qn]
        bk.stats.reset()
        bk.refresh_log.clear()
        pl = Planner(db, optimized=True)
        t0 = time.perf_counter()
        got = queries.run_via_plan(pl, plan_fn()) if via_plan else body(pl)
        out[qn] = {"got": got, "op_stats": dataclasses.asdict(bk.stats),
                   "refresh_log": list(bk.refresh_log),
                   "seconds": round(time.perf_counter() - t0, 3)}
    return out


CHILD_TIMEOUT_S = 900


@contextlib.contextmanager
def _beside(fn, *args):
    """`fn(*args)` in a spawned child process while the caller runs on;
    yields a function that waits for its result (or raises the child's
    exception).  The process ends with the block."""
    import concurrent.futures
    import multiprocessing

    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool:
        future = pool.submit(fn, *args)
        yield lambda: future.result(timeout=CHILD_TIMEOUT_S)


def _report(tag: str, rec: dict, launches: dict, bad: list) -> dict:
    """Print a child process's record, raise on its failures, and return
    its launch counts."""
    emit(tag, rec)
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))
    return launches


def phase_tpch(bk) -> dict:
    """TPC-H Q12 (the orders -> lineitem hop: a CASE count partitioned on a
    translated mask, column-to-column comparisons) and Q19 (three
    part -> lineitem hops under an OR of ANDs) through
    `run_via_plan(Planner(db, optimized=True), plan)` on `bk`
    (`paper_params()`), static verification on, each against its oracle
    and paying no refresh but the planned ones; beside each, the same
    plan's OpStats on `MockBackend` at the paper's noise profile over the
    same tables (a child process).  Returns the launch counts summed over
    both queries, each set to 0 just before its query."""
    from repro_torch.engine import queries, tpch
    from repro_torch.engine.planner import Planner

    scale, full = tpch.Scale(**TPCH_SCALE), tpch.Scale()
    reduced = [
        f"lineitem: {scale.lineitem:,} rows, the paper's sample (SF-1: 6,001,215)",
        f"orders: {scale.orders:,} rows of Scale()'s {full.orders:,} (SF-1: 1,500,000)",
        f"part: {scale.part:,} rows of Scale()'s {full.part:,} (SF-1: 200,000)",
        f"l_orderkey fan-out: {scale.lineitem / scale.orders:.0f} lines an order "
        f"against TPC-H's about 4",
        f"l_partkey fan-out: {scale.lineitem / scale.part:.0f} lines a part "
        f"against TPC-H's about 30",
    ]
    with _beside(_mock_runs, TPCH_QUERIES, TPCH_SCALE, TPCH_TABLES, True) as mock_result:
        t0 = clock()
        db = tpch.load(bk, scale, tables=TPCH_TABLES)
        load_s = clock() - t0
        runs = {qn: _via_plan(bk, Planner(db, optimized=True), plan=queries.QUERIES[qn][0]())
                for qn in TPCH_QUERIES}
        mocks = mock_result()
    launches = {}
    for qn in TPCH_QUERIES:
        run, mock = runs[qn], mocks[qn]
        got, rep, vrep = run["got"], run["report"], run["verify"]
        exp = queries.QUERIES[qn][2](db)
        mstats = mock["op_stats"]
        planned = sum(h["refresh"] for h in rep.history)
        res = {
            "query": qn, "path": "run_via_plan on BFVBackend(paper_params())",
            "rows": {name: db.tables[name].nrows for name in TPCH_TABLES},
            "reduced": reduced,
            "got": got, "expected": exp, "equal_to_oracle": got == exp,
            "seconds": {"load_encrypt": round(load_s, 3), "query": round(run["query_s"], 3),
                        **{k: round(v, 3) for k, v in run["secs"].items()}},
            "history": rep.history,
            "depth": {"measured": rep.measured_depth, "predicted": rep.predicted_depth,
                      "budget_levels": rep.budget_levels},
            "op_stats": run["op_stats"], "refresh_log": run["refresh_log"],
            "refreshes_placed": planned, "predicted_refreshes": rep.predicted_refreshes,
            "verify_findings": run["verify_findings"],
            "noise_budget_bits_at_last_decrypt": round(rep.decrypt_headrooms[-1], 2),
            "min_noise_budget_bits": round(min(rep.decrypt_headrooms), 2),
            "kernel_launches": run["launches"],
            "ntt_launches_by_rows": run["ntt_launches_by_rows"],
            "modops_launches_by_shape": run["modops_launches_by_shape"],
            "lane_chunks": [{"circuit": c, "lanes": n, "per_chunk": k}
                            for c, n, k in run["lane_chunks"]],
            "peak_device_bytes": run["peak_device_bytes"],
            "mock": {"op_stats": mstats, "equal_to_oracle": mock["got"] == exp,
                     "seconds": mock["seconds"],
                     "matches_bfv": {f: mstats[f] == run["op_stats"][f] for f in MOCK_MATCH}},
        }
        emit("tpch", res)
        rep.validate()
        if got != exp:
            raise AssertionError(f"{qn} on BFV disagrees with its oracle: {got} != {exp}")
        if vrep.errors:
            raise AssertionError(f"{qn} on BFV: verifier errors {[str(f) for f in vrep.errors]}")
        unplanned = [what for what in run["refresh_log"] if not what.startswith("planned")]
        if unplanned or run["op_stats"]["refresh"] != planned:
            raise AssertionError(f"{qn} on BFV: {run['op_stats']['refresh']} refreshes, "
                                 f"{planned} in the history, unplanned {unplanned}")
        idle = [name for name in BFV_KERNELS if run["launches"][name] <= 0]
        if idle:
            raise AssertionError(f"{qn} on BFV launched no {idle} kernel")
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches


# ------------------------------------------------------------------ legacy
# The five queries whose only bodies are the hand-written `run_qN` (Q4,
# Q5, Q8, Q14, Q17), on real ciphertexts over all eight tables.  LINEITEM
# fills an eighth of one block (4,096 of its 32,768 slots: every
# ciphertext is the same size as at 32,768 rows); a hop costs an EQ
# circuit per parent row, so the parents are cut, PART most (seven of the
# nineteen hops are on l_partkey).  Q17 compares 5 x quantity x count
# with the part's quantity sum mod t: when the Brand#23 / MED BOX part has
# more than about 146 lines the difference wraps past t/2 and the answer
# differs from the oracle's (the reference's own arithmetic), so PART
# stays near LINEITEM / 146 rows or more.  PART 32 keeps 98-157 lines a
# part; the planted Brand#23 / MED BOX part has 102.
LEGACY_SCALE = dict(lineitem=4096, orders=32, customer=48, supplier=12, part=32)
LEGACY_QUERIES = ("Q4", "Q14", "Q17", "Q5", "Q8")
# Rows planted so that more answers are not 0: the generated tables have
# no Brand#23 / MED BOX part and no AMERICA customer with an order of 1995
# or 1996, and leave four of Q4's five priorities and all of Q5's nations
# at 0.  Each planted row keeps its other fields (an order's lines keep
# their dates).
LEGACY_Q4_ORDERS = (10, 13, 1, 8, 11, 5, 16, 17, 18, 19, 21)  # into Q4's quarter
LEGACY_Q17_PART = 8                                            # Brand#23, MED BOX
LEGACY_AMERICA_CUSTOMERS = (12, 40, "CANADA")                  # Q8: 1995, 1996 orders
LEGACY_BRAZIL_SUPPLIER = 4                                     # Q8's nation_volume
LEGACY_ASIA_PAIRS = ((13, 7, "INDIA"), (21, 11, "JAPAN"))      # Q5: customer, supplier


def legacy_tables(scale) -> dict:
    """`tpch.generate(scale)` at LEGACY_SCALE with the rows planted: the
    orders LEGACY_Q4_ORDERS dated one a day from 1993-08-01 (Q4's
    quarter, none of them of 1994-1996, which Q5 and Q8 read; each keeps
    its priority), part LEGACY_Q17_PART of Brand#23 in a MED BOX, the
    customers of LEGACY_AMERICA_CUSTOMERS in its nation, supplier
    LEGACY_BRAZIL_SUPPLIER in BRAZIL, and the customer and supplier of
    each of LEGACY_ASIA_PAIRS in its nation."""
    from repro_torch.engine import tpch
    from repro_torch.engine.schema import date_to_int

    raw = tpch.generate(scale)
    nation = dict(zip(raw["nation"]["n_name"], raw["nation"]["n_nationkey"]))
    orders, supplier, customer = raw["orders"], raw["supplier"], raw["customer"]
    for i, key in enumerate(LEGACY_Q4_ORDERS):
        orders["o_orderdate"][key - 1] = date_to_int("1993-08-01") + i
    raw["part"]["p_brand"][LEGACY_Q17_PART - 1] = "Brand#23"
    raw["part"]["p_container"][LEGACY_Q17_PART - 1] = "MED BOX"
    *custs, name = LEGACY_AMERICA_CUSTOMERS
    for cust in custs:
        customer["c_nationkey"][cust - 1] = nation[name]
    supplier["s_nationkey"][LEGACY_BRAZIL_SUPPLIER - 1] = nation["BRAZIL"]
    for cust, supp, name in LEGACY_ASIA_PAIRS:
        customer["c_nationkey"][cust - 1] = supplier["s_nationkey"][supp - 1] = nation[name]
    return raw


def load_raw(bk, raw: dict):
    """Encode and encrypt generated tables into a Database, as `tpch.load`
    does."""
    from repro_torch.engine import tpch
    from repro_torch.engine.storage import Database

    schemas, db = tpch.schemas(), Database(bk)
    for name, data in raw.items():
        db.load_table(schemas[name], data, len(next(iter(data.values()))))
    return db


def _legacy_reduced(scale, full) -> list:
    """The cuts of the legacy tables, beside Scale()'s and SF-1's rows."""
    sf1 = dict(lineitem=6_001_215, orders=1_500_000, customer=150_000, supplier=10_000,
               part=200_000, partsupp=800_000)
    out = [f"lineitem: {scale.lineitem:,} rows of the paper's 32,768-row sample, in one "
           f"block of 32,768 slots (SF-1: {sf1['lineitem']:,})"]
    out += [f"{name}: {getattr(scale, name):,} rows of Scale()'s {getattr(full, name):,} "
            f"(SF-1: {sf1[name]:,})" for name in ("orders", "customer", "supplier", "part",
                                                   "partsupp")]
    out += [f"region, nation: 5 and 25 rows, as in TPC-H",
            f"l_orderkey fan-out: {scale.lineitem / scale.orders:.0f} lines an order "
            f"against TPC-H's about 4",
            f"l_partkey fan-out: {scale.lineitem / scale.part:.0f} lines a part "
            f"against TPC-H's about 30",
            f"l_suppkey fan-out: {scale.lineitem / scale.supplier:.0f} lines a supplier "
            f"against TPC-H's about 600",
            f"o_custkey fan-out: {scale.orders / scale.customer:.2f} orders a customer "
            f"against TPC-H's about 10",
            f"planted: orders {list(LEGACY_Q4_ORDERS)} dated 1993-08-01 on (Q4), "
            f"part {LEGACY_Q17_PART} of Brand#23 in a MED BOX (Q17), customers "
            f"{list(LEGACY_AMERICA_CUSTOMERS[:-1])} in {LEGACY_AMERICA_CUSTOMERS[-1]} and "
            f"supplier {LEGACY_BRAZIL_SUPPLIER} in BRAZIL (Q8), "
            + ", ".join(f"customer {c} and supplier {s} in {n}" for c, s, n in LEGACY_ASIA_PAIRS)
            + " (Q5)"]
    return out


# the share of a legacy query's seconds that may fall outside its timed
# engine calls (host glue between them) before the phase takes the stage
# split for a misattribution
LEGACY_OTHER_SHARE = 0.05


@contextlib.contextmanager
def _legacy_stages(bk, entered: dict):
    """Seconds by stage of a legacy body, and each join hop's: the engine
    calls the bodies make are wrapped and timed, each outermost one ended
    by a synchronize; a call inside another timed call counts to the
    outer one.  `entered` counts each wrapped call, at any depth, across
    queries.  Yields (stage seconds, hops, {"budget_bits": the noise
    budget at the last decrypt, "synchronizes": the timed calls})."""
    import functools
    import inspect

    from repro_torch.core import compare
    from repro_torch.engine import ops
    from repro_torch.engine.planner import Planner

    targets = [(ops, "translate_mask_down", "join"), (ops, "translate_values_down", "join"),
               (ops, "join_aggregate", "join"), (ops, "pack_scalars", "pack"),
               (ops, "pred_mask", "where"), (Planner, "where_mask", "where"),
               (ops, "and_masks", "where"), (ops, "apply_validity", "where"),
               (compare, "gt_scalar", "compare"), (compare, "eq_scalar", "compare"),
               (ops, "_col_cmp", "compare"), (Planner, "group_aggregate", "group"),
               (ops, "masked_sum", "aggregate"), (ops, "count", "aggregate"),
               (ops, "expr_blocks", "aggregate"), (bk, "mul", "multiply"),
               (bk, "mul_scalar", "multiply"), (bk, "ensure_levels", "refresh"),
               (bk, "broadcast_slot", "broadcast"), (bk, "decrypt", "decrypt")]
    secs, hops, seen, depth = {}, [], {"synchronizes": 0}, [0]

    def wrap(fn, name, stage):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            entered[name] = entered.get(name, 0) + 1
            if depth[0]:
                return fn(*args, **kwargs)
            if stage == "decrypt":
                seen["budget_bits"] = round(float(bk.budget(args[0])), 2)
            depth[0] += 1
            seen["synchronizes"] += 1
            t0 = clock()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = clock() - t0
                depth[0] -= 1
                secs[stage] = secs.get(stage, 0.0) + dt
                if stage == "join":
                    a = sig.bind(*args, **kwargs).arguments
                    hops.append({"op": name, "child": a["fact_table"].name, "fk": a["fk"],
                                 "keys": a["nparent"], "s": round(dt, 3)})
        return timed

    for _, name, _ in targets:
        entered.setdefault(name, 0)
    saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in targets]
    for obj, name, stage in targets:
        setattr(obj, name, wrap(getattr(obj, name), name, stage))
    try:
        yield secs, hops, seen
    finally:
        for obj, name, orig in saved:
            if orig is None:
                delattr(obj, name)        # the instance's own wrapper: the class's again
            else:
                setattr(obj, name, orig)


def phase_legacy(bk) -> dict:
    """TPC-H Q4, Q14, Q17, Q5 and Q8 through their legacy bodies
    (`QUERIES[qn][1](Planner(db, optimized=True))`) on `bk`
    (`paper_params()`) over all eight tables at LEGACY_SCALE, each against
    its oracle with at least one field not 0; beside each, the same body's
    OpStats and refresh log on `MockBackend` at the paper's noise profile
    (a child process), which must equal the BFV run's in
    MOCK_MATCH and the log.  Returns the launch counts summed over the
    five queries, each set to 0 just before its query."""
    from repro_torch import kernels
    from repro_torch.engine import baseline, queries, tpch
    from repro_torch.engine.planner import Planner

    scale, full = tpch.Scale(**LEGACY_SCALE), tpch.Scale()
    reduced = _legacy_reduced(scale, full)
    with _beside(_mock_runs, LEGACY_QUERIES, LEGACY_SCALE, None, False, True) as mock_result:
        t0 = clock()
        db = load_raw(bk, legacy_tables(scale))
        load_s = clock() - t0
        runs, entered = {}, {}
        for qn in LEGACY_QUERIES:
            _, body, oracle = queries.QUERIES[qn]
            bk.stats.reset()
            bk.op_log.clear()
            bk.refresh_log.clear()
            bk.lane_log.clear()
            pl = Planner(db, optimized=True)
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            with _legacy_stages(bk, entered) as (stages, hops, seen):
                t0 = clock()
                got = body(pl)
                query_s = clock() - t0
            runs[qn] = dict(got=got, exp=oracle(db), query_s=query_s, stages=stages, hops=hops,
                            budget_bits=seen["budget_bits"], syncs=seen["synchronizes"],
                            op_stats=dataclasses.asdict(bk.stats),
                            refresh_log=list(bk.refresh_log), lane_log=list(bk.lane_log),
                            launches=kernels.launch_counts(),
                            ntt_launches_by_rows=ntt_launches_by_rows(),
                            modops_launches_by_shape=modops_launches_by_shape(),
                            peak_device_bytes=torch.cuda.max_memory_allocated())
        mocks = mock_result()
    launches, bad = {}, []
    for qn in LEGACY_QUERIES:
        run, mock = runs[qn], mocks[qn]
        got, exp = run["got"], run["exp"]
        stats, mstats = run["op_stats"], mock["op_stats"]
        fields = [v for row in exp.values() for v in (row.values() if isinstance(row, dict)
                                                      else [row])]
        stages = {k: round(v, 3) for k, v in run["stages"].items()}
        other = run["query_s"] - sum(run["stages"].values())
        res = {
            "query": qn, "path": f"run_{qn.lower()} on BFVBackend(paper_params())",
            "rows": {name: t.nrows for name, t in db.tables.items()},
            "reduced": reduced,
            "got": got, "expected": exp, "equal_to_oracle": got == exp,
            "nonzero_fields": sum(1 for v in fields if v), "fields": len(fields),
            "seconds": {"load_encrypt": round(load_s, 3), "query": round(run["query_s"], 3),
                        **stages, "other": round(other, 3)},
            "synchronizes": run["syncs"],
            "hops": run["hops"],
            "op_stats": stats,
            "refresh_log": {"planned": [w for w in run["refresh_log"] if w.startswith("planned")],
                            "unplanned": [w for w in run["refresh_log"]
                                          if not w.startswith("planned")]},
            "noise_budget_bits_at_last_decrypt": run["budget_bits"],
            "kernel_launches": run["launches"],
            "ntt_launches_by_rows": run["ntt_launches_by_rows"],
            "modops_launches_by_shape": run["modops_launches_by_shape"],
            "lane_chunks": [{"circuit": c, "lanes": n, "per_chunk": k}
                            for c, n, k in run["lane_log"]],
            "peak_device_bytes": run["peak_device_bytes"],
            "mock": {"op_stats": mstats, "refresh_log": mock["refresh_log"],
                     "equal_to_oracle": mock["got"] == exp, "seconds": mock["seconds"],
                     "matches_bfv": {f: mstats[f] == stats[f] for f in MOCK_MATCH}},
        }
        if qn == "Q8":
            res["paper_quoted_s"] = baseline.PAPER_QUERY_SECONDS["Q8"]["nshedb"]
            res["paper_quoted_note"] = ("the paper's own NSHEDB figure for Q8: its machine "
                                        "and its parent sizes, not a time of this run")
        emit("legacy", res)
        if got != exp:
            bad.append(f"{qn} on BFV disagrees with its oracle: {got} != {exp}")
        if not any(fields):
            bad.append(f"{qn}: the oracle answers 0 in every field at this cut")
        if other > LEGACY_OTHER_SHARE * run["query_s"]:
            bad.append(f"{qn}: {other:.3f} of {run['query_s']:.3f} s outside the timed "
                       f"engine calls (a call the stage split does not wrap)")
        if (not all(res["mock"]["matches_bfv"].values())
                or mock["refresh_log"] != run["refresh_log"]):
            bad.append(f"{qn}: Mock {[mstats[f] for f in MOCK_MATCH]} {mock['refresh_log']} "
                       f"!= BFV {[stats[f] for f in MOCK_MATCH]} {run['refresh_log']}")
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
    idle = [name for name in BFV_KERNELS if launches.get(name, 0) <= 0]
    if idle:
        bad.append(f"the legacy queries launched no {idle} kernel")
    never = sorted(name for name, n in entered.items() if n == 0)
    if never:
        bad.append(f"the stage split wraps {never}, which no legacy body entered")
    if bad:
        raise AssertionError("legacy phase: " + "; ".join(bad))
    return launches


# ------------------------------------------------------------------- shard
SHARD_ROWS = 65536           # two blocks of n = 32768: a block axis to shard
SHARD_CELL = (2, 4)          # (shards, limb_shards): k = 30 pads to 32 limbs
# the columns Q1 reads, checkpointed and restored on the card
Q1_COLUMNS = ("l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax")
CKPT_DIR = os.path.join(HERE, ".scratch", "shard_checkpoint")
# the Mock chaos mix: the multi-block paper-noise profile of the chaos suite
CHAOS_PROFILE = dict(n=64, t=65537, k=30)
CHAOS_MIX = ("Q1", "Q6", "Q12", "Q19")
CHAOS_COSTS = {"mul": 0.05, "mul_plain": 0.055, "mul_scalar": 0.002,
               "add": 0.0015, "rotate": 0.105, "refresh": 44.0}


def _shard_run_record(run, exp) -> dict:
    rep = run["report"]
    return {"equal_to_oracle": run["got"] == exp,
            "seconds": {"query": round(run["query_s"], 3),
                        **{k: round(v, 3) for k, v in run["secs"].items()}},
            "refresh": run["op_stats"]["refresh"],
            "verify_findings": run["verify_findings"],
            "recoveries": rep.recoveries,
            "kernel_launches": run["launches"],
            "peak_device_bytes": run["peak_device_bytes"]}


def _tee_ledger(ctx, other) -> None:
    """Mirror every block-op and fold charge of `ctx` into `other`, a
    context of another geometry, so that both price the same run."""
    record, record_fold = ctx.record, ctx.record_fold

    def tee_record(field, units, distributed):
        record(field, units, distributed)
        other.record(field, units, distributed)

    def tee_fold(live, phys):
        record_fold(live, phys)
        other.record_fold(live, phys)

    ctx.record, ctx.record_fold = tee_record, tee_fold


def shard_q1_bfv(paper, bk, before_costs=lambda: None) -> dict:
    """Q1 on LINEITEM at 65,536 rows (two blocks) under `bk`'s keys: (a)
    unsharded, (b) on a logical (2, 4) shard context, (c) on a 2-shard
    context losing worker 1 at the `where` stage (the executor reshards
    2 -> 1 and resumes from the `atoms` checkpoint); then the cost model
    (`baseline.measure_costs` on the card, the op-count model and both
    contexts' ledgers priced with it) and a checkpoint of the encrypted
    columns Q1 reads.  `before_costs()` runs just before the cost model,
    which times ops on the card alone.  Returns the launch counts summed
    over the three runs, each set to 0 just before its query and read
    just after."""
    from repro_torch.engine import baseline, queries, tpch
    from repro_torch.engine.backend import OpStats
    from repro_torch.engine.planner import Planner
    from repro_torch.engine.sharded import ShardContext
    from repro_torch.runtime import faults

    t0 = clock()
    db = tpch.load(bk, tpch.Scale(lineitem=SHARD_ROWS), tables=["lineitem"])
    load_s = clock() - t0
    li = db.tables["lineitem"]
    exp = queries.oracle_q1(db)
    shards, limb_shards = SHARD_CELL

    runs, launches = {}, {}
    pl_a = Planner(db, optimized=True)
    runs["a"] = _via_plan(bk, pl_a)
    runs["a"]["report"].validate()
    pl_b = Planner(db, optimized=True, shards=shards, limb_shards=limb_shards)
    one = ShardContext(1, limbs=bk.limbs, ring_n=bk.slots)
    _tee_ledger(pl_b.shard_ctx, one)
    runs["b"] = _via_plan(bk, pl_b)
    runs["b"]["report"].validate()
    pl_c = Planner(db, optimized=True, shards=2)
    runs["c"] = _via_plan(bk, pl_c, faults.FaultPlan(device_loss_stage="where",
                                                         device_loss_worker=1))
    for name in BFV_KERNELS:
        launches[name] = sum(r["launches"][name] for r in runs.values())

    ledger = pl_b.shard_ctx.ledger_snapshot()
    rec = {"lineitem_rows": li.nrows, "blocks_per_column": li.nblocks,
           "params": {"n": paper.n, "t": paper.t, "k": paper.k},
           "load_encrypt_s": round(load_s, 3), "values_checked": 48,
           "runs": {"a_unsharded": _shard_run_record(runs["a"], exp),
                    f"b_shards_{shards}_limb_shards_{limb_shards}":
                        _shard_run_record(runs["b"], exp),
                    "c_device_loss_at_where": _shard_run_record(runs["c"], exp)},
           "op_stats_equal_a_b": runs["a"]["op_stats"] == runs["b"]["op_stats"],
           "op_stats_a": runs["a"]["op_stats"],
           "ledger_b": ledger, "ledger_1x1_same_run": one.ledger_snapshot(),
           "c_final_shards": pl_c.shard_ctx.shards,
           "kernel_launches": launches}
    recs_c = runs["c"]["report"].recoveries
    bad = []
    for key, run in runs.items():
        if run["got"] != exp or len(run["got"]) != 6:
            bad.append(f"({key}) decrypts {run['got']} != oracle_q1 {exp}")
        if run["op_stats"]["refresh"] != 0 or run["verify"].errors:
            bad.append(f"({key}) refresh {run['op_stats']['refresh']}, verifier errors "
                       f"{[str(f) for f in run['verify'].errors]}")
    if runs["a"]["op_stats"] != runs["b"]["op_stats"]:
        bad.append(f"OpStats differ: (a) {runs['a']['op_stats']} (b) {runs['b']['op_stats']}")
    if not (ledger["folds"] > 0 and ledger["gathers"] > 0 and ledger["gather_bytes"] > 0):
        bad.append(f"(b) ledger charged no fold or gather: {ledger}")
    if (pl_c.shard_ctx.shards != 1 or [r["kind"] for r in recs_c] != ["device-loss"]
            or "reshard 2->1" not in recs_c[0]["action"] or "atoms" not in recs_c[0]["action"]):
        bad.append(f"(c) recovered as {recs_c}, final shards {pl_c.shard_ctx.shards}")
    for key in ("a", "b"):
        idle = [k for k in BFV_KERNELS if runs[key]["launches"][k] <= 0]
        if idle:
            bad.append(f"({key}) launched no {idle} kernel")
    if bad:
        emit("shard", rec)
        raise AssertionError("shard phase: " + "; ".join(bad))

    # the cost model: free the runs' ciphertexts, then keygen and time each op
    before_costs()
    query_s = {k: runs[k]["query_s"] for k in runs}
    stats_a = OpStats(**runs["a"]["op_stats"])
    ctx_b = pl_b.shard_ctx
    del runs, pl_a, pl_b, pl_c
    gc.collect()
    torch.cuda.empty_cache()
    t0 = clock()
    costs = baseline.measure_costs(paper, seed=SEED)
    costs_s = clock() - t0
    gc.collect()
    torch.cuda.empty_cache()
    rec["cost_model"] = {
        "measure_costs_s": round(costs_s, 3),
        "op_seconds": costs.as_dict(),
        "nshedb_seconds_a": baseline.nshedb_seconds(stats_a, costs),
        "measured_query_seconds_a": query_s["a"],
        "modeled_seconds_b": ctx_b.modeled_seconds(costs.as_dict()),
        "modeled_seconds_1x1_same_run": one.modeled_seconds(costs.as_dict()),
        "measured_query_seconds_b": query_s["b"]}
    rec["checkpoint"] = _checkpoint_columns(bk, li)
    emit("shard", rec)
    return launches


def _checkpoint_columns(bk, li) -> dict:
    """Save Q1's encrypted columns (CUDA int64 tensors) twice with the
    async writer, restore onto the card (byte-identical, one decrypt per
    block equal to the original's), truncate the newer snapshot: restore
    raises the typed fault and restore_latest_valid falls back."""
    from repro_torch.core.bfv import Ciphertext
    from repro_torch.runtime import faults
    from repro_torch.runtime.checkpoint import CheckpointManager

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    cols = {c: [b.data for b in li.col(c).blocks] for c in Q1_COLUMNS}
    mgr = CheckpointManager(CKPT_DIR, keep=2, async_write=True)
    t0 = clock()
    mgr.save(1, cols, extra={"rows": li.nrows})
    mgr.save(2, cols, extra={"rows": li.nrows})
    mgr.wait()
    save_s = clock() - t0
    t0 = clock()
    got, _, extra = mgr.restore(2, cols, device="cuda")
    restore_s = clock() - t0
    identical = all(torch.equal(g, c) for name in cols for g, c in zip(got[name], cols[name]))
    decrypts = all(
        np.array_equal(bk.decrypt(Ciphertext(g, b.noise, b.params)), bk.decrypt(b))
        for name in cols for g, b in zip(got[name], li.col(name).blocks))
    on_card = all(g.device.type == "cuda" for name in got for g in got[name])
    faults.truncate_checkpoint(CKPT_DIR, 2)
    try:
        mgr.restore(2, cols, device="cuda")
        typed = False
    except faults.CheckpointCorruptFault:
        typed = True
    step, back, _, _ = mgr.restore_latest_valid(cols, device="cuda")
    fell_back = step == 1 and all(torch.equal(g, c) for name in cols
                                  for g, c in zip(back[name], cols[name]))
    nbytes = sum(t.numel() * t.element_size() for ts in cols.values() for t in ts)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    res = {"columns": list(cols), "leaves": sum(len(v) for v in cols.values()),
           "bytes_per_step": nbytes, "save_two_steps_s": round(save_s, 3),
           "restore_s": round(restore_s, 3), "byte_identical": identical,
           "decrypts_equal": decrypts, "restored_on_card": on_card,
           "extra": extra, "truncated_raises_typed": typed,
           "fell_back_to_step": step, "fallback_identical": fell_back}
    if not (identical and decrypts and on_card and typed and fell_back):
        raise AssertionError(f"checkpoint round trip on the card failed: {res}")
    return res


def shard_chaos_mock() -> tuple:
    """The chaos suite's fault classes on the card: MockBackend at the
    multi-block paper-noise profile with `kernel_reduce=True` (every
    `sum_slots` one rotate_reduce launch), tiny LINEITEM in 3 blocks, the
    Q1/Q6/Q12/Q19 mix with shards=2 (3 blocks pad to 4 lanes) under
    under-prediction, device loss, a straggler struck out after
    `patience` rounds (a 2 x 2 grid: of two workers the slow one is the
    median) and cache poison.  Each run must decrypt identical to its
    fault-free run or raise a typed fault.  Runs in a child process
    beside `shard_q1_bfv`'s query runs; returns `_report`'s arguments."""
    from repro_torch import kernels
    from repro_torch.core.noise import NoiseProfile
    from repro_torch.engine import queries, tpch
    from repro_torch.engine.backend import MockBackend
    from repro_torch.engine.executor import Executor
    from repro_torch.engine.planner import Planner
    from repro_torch.engine.workload import WorkloadCache
    from repro_torch.runtime import faults
    from repro_torch.runtime.elastic import StragglerDetector

    bk = MockBackend(NoiseProfile(**CHAOS_PROFILE), kernel_reduce=True, device="cuda")
    db = tpch.load(bk, tpch.Scale.tiny(), seed=7)
    kernels.reset_launch_counts()
    t0 = clock()
    base = {qn: queries.run_via_plan(Planner(db, optimized=True), queries.QUERIES[qn][0]())
            for qn in CHAOS_MIX}

    def faulted(qn, fp, shards=2, limb_shards=None, rounds=1, patience=None, cache=None):
        pl = Planner(db, optimized=True, shards=shards, limb_shards=limb_shards, cache=cache)
        if patience is not None:
            pl.attach_straggler_detector(
                StragglerDetector(threshold=2.0, patience=patience, timeout_s=1e9), CHAOS_COSTS)
        recs = []
        with faults.inject(fp):
            for _ in range(rounds):
                ex = Executor(pl)
                out = ex.run(queries.QUERIES[qn][0]())
                recs += ex.report.recoveries
        return out, recs, (pl.shard_ctx.shards, pl.shard_ctx.limb_shards)

    def poisoned(qn):
        cache = WorkloadCache()
        faulted(qn, faults.FaultPlan(), cache=cache)
        faults.poison_cache(cache, bk, entries=None)
        out, recs, cell = faulted(qn, faults.FaultPlan(), cache=cache)
        return out, recs + [{"kind": "cache-poison", "drops": cache.stats.poison_drops}], cell

    # fault class -> (the recovery it must report, its run of one query)
    scenarios = {
        "underprediction": ("overflow", lambda qn: faulted(qn, faults.FaultPlan(
            underpredict_bits=500.0, underpredict_count=3))),
        "device_loss": ("device-loss", lambda qn: faulted(qn, faults.FaultPlan(
            device_loss_stage="any", device_loss_worker=1))),
        "straggler": ("straggler", lambda qn: faulted(
            qn, faults.FaultPlan(straggler_slowdown={3: 10.0}), limb_shards=2, rounds=2,
            patience=1)),
        "cache_poison": ("cache-poison", poisoned),
    }
    outcomes, bad = {}, []
    for fault, (kind, run) in scenarios.items():
        for qn in CHAOS_MIX:
            try:
                out, recs, cell = run(qn)
            except faults.ExecutionFault as e:
                outcomes[f"{fault}/{qn}"] = {"typed_fault": e.kind}
                continue
            same = out == base[qn]
            outcomes[f"{fault}/{qn}"] = {"identical": same, "final_cell": list(cell),
                                         "recoveries": [r.get("kind") for r in recs]}
            if not same:
                bad.append(f"{fault}/{qn}: silent wrong answer")
            if not any(r["kind"] == kind and r.get("drops", 1) > 0 for r in recs):
                bad.append(f"{fault}/{qn}: the fault never fired ({recs})")
    wall_s = clock() - t0
    launches = kernels.launch_counts()
    oracle_ok = all(base[qn] == queries.QUERIES[qn][2](db) for qn in CHAOS_MIX)
    rec = {"path": f"MockBackend(NoiseProfile(n=64, t=65537, k=30), kernel_reduce=True, "
                   f"device={str(bk.device)!r})",
           "lineitem_rows": db.tables["lineitem"].nrows,
           "blocks": db.tables["lineitem"].nblocks, "baselines_equal_to_oracle": oracle_ok,
           "outcomes": outcomes, "seconds": round(wall_s, 3), "kernel_launches": launches}
    if not oracle_ok:
        bad.append("fault-free Mock runs disagree with the oracles")
    if launches["rotate_reduce"] <= 0:
        bad.append("rotate_reduce never launched")
    return "shard_chaos", rec, launches, bad


# ------------------------------------------------------------------- serve
SERVE_DEVICE = "cuda"
SERVE_ARCH = "gemma2-27b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 5120, 16
CONSISTENCY_LAYERS, CONSISTENCY_PROMPT = 4, 4608


def serve_consistency() -> dict:
    """decode(prefill(x[:-1]), x[-1]) against prefill(x)'s last logits at
    gemma2-27b's full width with 4 layers (2 local, 2 global), float32 with
    TF32 off, one 4608-token prompt — past the 4096 window, so the local
    layers mask and trim.  The prefills run flash_attn, the decode the
    dense path: this holds the kernel against the dense lowering at the
    card's shapes, within tests/test_models.py's rtol = atol = 2e-3."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=CONSISTENCY_LAYERS)
    gen = torch.Generator(device=SERVE_DEVICE).manual_seed(SEED)
    params = lm.init_params(gen, cfg, torch.float32, SERVE_DEVICE)
    toks = serve.make_batch(cfg, 1, CONSISTENCY_PROMPT, seed=SEED + 1,
                            device=SERVE_DEVICE)["tokens"]
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    kernels.reset_launch_counts()
    full, _ = prefill(params, {"tokens": toks})
    _, caches = prefill(params, {"tokens": toks[:, :-1]})
    after_prefills = kernels.launch_counts()["flash_attn"]
    dec, caches = decode(params, caches, {"tokens": toks[:, -1:]}, pos=CONSISTENCY_PROMPT - 1)
    after_decode = kernels.launch_counts()["flash_attn"]
    err = float((dec - full).abs().max())
    close = bool(torch.allclose(dec, full, rtol=2e-3, atol=2e-3))
    res = {"arch": SERVE_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": "float32", "tf32": False, "prompt": CONSISTENCY_PROMPT,
           "max_abs_diff": err, "max_abs_logit": float(full.abs().max()),
           "rtol": 2e-3, "atol": 2e-3, "allclose": close,
           "flash_attn_launches": {"prefills": after_prefills,
                                   "decode": after_decode - after_prefills},
           "cache_positions": {"local": caches["units"][0]["k"].shape[2],
                               "global": caches["units"][1]["k"].shape[2]}}
    emit("serve_consistency", res)
    if not close or not torch.isfinite(full).all():
        raise AssertionError(f"decode after prefill disagrees with the prefill: {res}")
    if after_prefills != 2 * cfg.n_layers or after_decode != after_prefills:
        raise AssertionError(f"flash_attn launches {res['flash_attn_launches']}: expected "
                             f"{cfg.n_layers} per prefill and 0 in decode")
    return res


SERVE_ARGV = ["--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
              str(SERVE_PROMPT), "--gen", str(SERVE_GEN), "--dtype", "bfloat16"]


def _serve_main(on_generate, on_step):
    """`serve.main(SERVE_ARGV)` on the card, as a user runs it, with
    `serve.generate` wrapped so that `on_generate(params)` runs once the
    parameters and the batch are made, just before the prefill.  Returns
    the generated tokens and the seconds from the call to the prefill."""
    from repro_torch.launch import serve

    orig_generate = serve.generate
    setup = {}

    def generate(params, *args, **kwargs):
        setup["s"] = clock() - t0
        on_generate(params)
        return orig_generate(params, *args, **kwargs)

    serve.generate = generate
    try:
        t0 = clock()
        out = serve.main(SERVE_ARGV, device=SERVE_DEVICE, on_step=on_step)
    finally:
        serve.generate = orig_generate
    return out, setup["s"]


def _serve_profile() -> None:
    """The serving run again under torch.profiler, one profiler for the
    prefill and one for the decode steps: device time by kernel, busy and
    idle share of each, as a `serve_profile` line."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    profs, walls = {"prefill": profile(activities=acts)}, {}
    mark = [0.0]

    def on_generate(params):
        mark[0] = clock()
        profs["prefill"].start()

    def on_step(stage, logits, caches):
        if stage == "prefill":
            walls["prefill"] = clock() - mark[0]
            profs["prefill"].stop()
            profs["decode"] = profile(activities=acts)
            mark[0] = clock()
            profs["decode"].start()

    _serve_main(on_generate, on_step)
    walls["decode"] = clock() - mark[0]
    profs["decode"].stop()
    emit("serve_profile", {stage: _profile_summary(prof, walls[stage])
                           for stage, prof in profs.items()})


def phase_serve(profile: bool = False) -> dict:
    """gemma2-27b at full width and depth in bfloat16 through
    `serve.main(SERVE_ARGV)`: init in place from a seeded generator, 2 x
    5120-token prefill, 16 greedy decode steps, timed through its
    `on_step` hook ("init" is the time from the call to the prefill:
    argument parsing, `init_params` and `make_batch`).  With `profile`,
    the run is repeated under
    torch.profiler afterwards.  Returns the launch counts of the measured
    run."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    serve_consistency()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    steps_s, fa_after, finite, seen = [], [], [], {}
    mark = [0.0]

    def on_generate(params):
        seen["param_bytes"] = sum(t.numel() * t.element_size() for t in lm.tree_leaves(params))
        kernels.reset_launch_counts()
        mark[0] = clock()

    def on_step(stage, logits, caches):
        steps_s.append((stage, clock() - mark[0]))
        fa_after.append(kernels.launch_counts()["flash_attn"])
        finite.append(bool(torch.isfinite(logits).all()))
        seen["cache_len"] = {"local": caches["units"][0]["k"].shape[2],
                             "global": caches["units"][1]["k"].shape[2]}
        mark[0] = clock()

    out, init_s = _serve_main(on_generate, on_step)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    prefill_s = steps_s[0][1]
    decode_s = [t for stage, t in steps_s[1:]]
    cache_len, param_bytes = seen["cache_len"], seen["param_bytes"]
    res = {
        "arch": SERVE_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": "bfloat16",
        "params": lm.param_count(cfg), "param_bytes": param_bytes,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "decode_steps": SERVE_GEN,
        "seconds": {"init": init_s, "prefill": prefill_s, "decode_steps": decode_s,
                    "decode_step_median": float(np.median(decode_s))},
        "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
        "decode_tokens_per_s": SERVE_BATCH / float(np.median(decode_s)),
        "flash_attn_launches": {"prefill": fa_after[0], "decode": fa_after[-1] - fa_after[0]},
        "kernel_launches": launches,
        "cache_positions": cache_len,
        "logits_finite": all(finite),
        "generated_first_prompt": out[0].tolist(),
        "device_bytes_held_before": held_before,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    emit("serve", res)
    if not all(finite):
        raise AssertionError("serve: non-finite logits")
    if res["flash_attn_launches"] != {"prefill": cfg.n_layers, "decode": 0}:
        raise AssertionError(f"serve: flash_attn launched {res['flash_attn_launches']}, "
                             f"expected {cfg.n_layers} in prefill and 0 in decode")
    if cache_len != {"local": cfg.window, "global": SERVE_PROMPT + SERVE_GEN}:
        raise AssertionError(f"serve: cache positions {cache_len}")
    if tuple(out.shape) != (SERVE_BATCH, SERVE_GEN + 1):
        raise AssertionError(f"serve: generated {tuple(out.shape)}")
    if profile:
        del out
        _serve_profile()
    return launches


# -------------------------------------------------------------------- scan
# the paper's scan cells (configs/nshedb.SHAPES) at CONFIG's full width
# (n = 32768, k = 32, t = 65537) on scan_2m's 64 blocks.  The scan_33m
# cells take 1024 blocks; they run at the same 64 to keep this smoke run
# short (1024 blocks are 16 times the device work and a 32 GiB numpy draw
# on the host a cell).  Whether one card holds 1024 blocks was not tried.
# scan_33m_rs differs from scan_2m only in ks_mode, which changes what
# crosses a mesh (the mesh phase runs both modes on one): on one device it
# is the same arithmetic, so its run repeats scan_2m's and its output must
# equal scan_2m's bit for bit.
SCAN_CELLS = ("scan_2m", "scan_33m_pagg", "scan_33m_rs")
SCAN_BLOCKS = 64


def _plain_step(tabs):
    """ct_square, ct_mul and rotate of one block in plain int64 torch ops
    over the u32 primitives (kernels/u32.py: barrett_mulmod, add_mod) and
    the key switch as a direct contraction: the yardstick of the kernels'
    path."""
    from repro_torch.kernels import u32

    q, mu = tabs.q[:, None], tabs.mu64[:, None]
    mul = lambda a, b: u32.barrett_mulmod(a, b, q, mu)
    add = lambda a, b: u32.add_mod(a, b, q)

    def ks(poly, kb, ka):
        return tuple((poly[:, None] * key % q).sum(0) % q for key in (kb, ka))

    def square(ct, kb, ka):
        d1 = mul(ct[0], ct[1])
        ks0, ks1 = ks(mul(ct[1], ct[1]), kb, ka)
        return torch.stack([add(mul(ct[0], ct[0]), ks0), add(add(d1, d1), ks1)])

    def ct_mul(a, b, kb, ka):
        ks0, ks1 = ks(mul(a[1], b[1]), kb, ka)
        return torch.stack([add(mul(a[0], b[0]), ks0),
                            add(add(mul(a[0], b[1]), mul(a[1], b[0])), ks1)])

    def rotate(ct, perm, kb, ka):
        rot = ct[..., perm]
        ks0, ks1 = ks(rot[1], kb, ka)
        return torch.stack([add(rot[0], ks0), ks1])

    return ks, square, ct_mul, rotate


def _scan_checks(S, consts, col, val, keys) -> dict:
    """One block through the kernels against the plain versions, exactly:
    `keyswitch` of a reduced residue and of digits above every key
    limb's prime (the unreduced digits the scan step feeds it), then
    `ct_square`, `ct_mul` and `rotate`."""
    tabs, perm = consts["tabs"], consts["perm"]
    ks, square, ct_mul, rotate = _plain_step(tabs)
    rlk_b, rlk_a, gk_b, gk_a = keys
    rng = np.random.default_rng(SEED + 1)
    big = torch.from_numpy(rng.integers(int(tabs.q.max()), 1 << 30, tuple(col.shape[1:]))).cuda()
    errs = {}
    for what, poly in (("reduced", col[1]), ("above_key_primes", big)):
        got, exp = S.keyswitch(poly, rlk_b, rlk_a, tabs), ks(poly, rlk_b, rlk_a)
        errs[f"keyswitch_{what}"] = max(_check_equal("keyswitch", g, e, what)
                                        for g, e in zip(got, exp))
    errs["ct_square"] = _check_equal("ct_square", S.ct_square(col, rlk_b, rlk_a, tabs),
                                     square(col, rlk_b, rlk_a), "one block")
    errs["ct_mul"] = _check_equal("ct_mul", S.ct_mul(col, val, rlk_b, rlk_a, tabs),
                                  ct_mul(col, val, rlk_b, rlk_a), "one block")
    errs["rotate"] = _check_equal("rotate", S.rotate(col, perm, gk_b, gk_a, tabs),
                                  rotate(col, perm, gk_b, gk_a), "one block")
    return errs


def _scan_kernel_times(by_shape, tabs) -> dict:
    """mul_mod and add_mod timed at the scan path's shapes that move the
    most bytes (launches x rows): the key switch's digit products and the
    first round of its digit fold (`tabs`: the step's LimbTables)."""
    from repro_torch.kernels.modops import ops, ref

    k, n = tabs.k, tabs.n
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q = tabs.q.to(torch.int64)[:, None]
    out = {}
    for name, per_elem in (("mul_mod", 8), ("add_mod", 3)):
        (rows, rows_b), launches = max(by_shape[name].items(), key=lambda kv: kv[0][0] * kv[1])
        a = _draw_residues(gen, q, (rows // k, k, n))
        b = _draw_residues(gen, q, (rows_b // k, k, n))
        kern, plain = getattr(ops, name), getattr(ref, f"{name}_ref")
        rec = _timed(name, lambda kern=kern, a=a, b=b: kern(a, b, tabs), a,
                     (2 * a.numel() + b.numel()) * E8, per_elem * a.numel(),
                     plain=lambda plain=plain, a=a, b=b: plain(a, b, tabs.q))
        rec["launches_at_shape"] = launches
        out[name] = {f"{rows}/{rows_b}": rec}
        del a, b
    return out


def phase_scan() -> tuple[dict, dict]:
    """`nshedb_step.query_step` — EQ mask (16 squarings), a multiply and
    the rotate-reduce, every step a key switch — at CONFIG on 64 blocks
    (2.1 M rows), for scan_2m and the scan_33m_pagg / scan_33m_rs
    settings; residues drawn from the seed.  Returns the launch counts
    summed over the three runs (each set to 0 just before its run and read
    just after) and the kernels' times at the path's shapes."""
    from repro_torch import kernels
    from repro_torch.configs.nshedb import CONFIG, SHAPES
    from repro_torch.launch import nshedb_step as S

    cfg = CONFIG
    t0 = clock()
    consts = S.make_constants(cfg, device="cuda")
    tabs, perm = consts["tabs"], consts["perm"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = tabs.q.to(torch.int64)[:, None]
    draw = lambda *lead: _draw_residues(gen, q, lead + (cfg.k, cfg.n))
    cts_col, cts_val = draw(SCAN_BLOCKS, 2), draw(SCAN_BLOCKS, 2)
    keys = [draw(cfg.k) for _ in range(4)]
    setup_s = clock() - t0
    checks = _scan_checks(S, consts, cts_col[0], cts_val[0], keys)

    runs, outs, launches, by_shape = {}, {}, {}, {}
    for cell in SCAN_CELLS:
        spec = SHAPES[cell]
        rot = spec.get("rot_steps", cfg.rot_steps)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        chunk = S.default_chunk(cts_col, cfg.k)
        kernels.reset_launch_counts()
        t0 = clock()
        outs[cell] = S.query_step(cts_col, cts_val, *keys, tabs, perm, eq_levels=cfg.eq_levels,
                                  rot_steps=rot, ks_mode=spec.get("ks_mode"), chunk=chunk)
        secs = clock() - t0
        counts = kernels.launch_counts()
        shapes = modops_launches_by_shape()
        for name, n_ in counts.items():
            launches[name] = launches.get(name, 0) + n_
        for name in ("mul_mod", "add_mod"):
            for key, n_ in shapes[name].items():
                rows = tuple(int(x) for x in key.split("/"))
                by_shape.setdefault(name, {})[rows] = by_shape.get(name, {}).get(rows, 0) + n_
        runs[cell] = {
            "nblocks": SCAN_BLOCKS, "rows": SCAN_BLOCKS * cfg.n,
            "cut": None if spec["nblocks"] == SCAN_BLOCKS else
            f"{spec['nblocks']} -> {SCAN_BLOCKS} blocks to keep the smoke run short "
            f"(the cell's inputs are {spec['nblocks'] * 2 * 2 * cfg.k * cfg.n * E8 / 2**30:.0f} "
            f"GiB); whether one card holds them was not tried",
            "same_arithmetic_as": "scan_2m" if spec.get("ks_mode") else None,
            "eq_levels": cfg.eq_levels, "rot_steps": rot, "ks_mode": spec.get("ks_mode") or S.KS_MODE,
            "key_switches_per_block": cfg.eq_levels + 1 + rot, "chunk": chunk,
            "query_s": secs, "s_per_block": secs / SCAN_BLOCKS,
            "kernel_launches": {k: v for k, v in counts.items() if v},
            "modops_launches_by_shape": {k: v for k, v in shapes.items() if v},
            "peak_device_bytes": torch.cuda.max_memory_allocated()}
    bad = [cell for cell, out in outs.items()
           if tuple(out.shape) != (2, cfg.k, cfg.n) or not bool(((out >= 0) & (out < tabs.q[:, None])).all())]
    rs_equal = torch.equal(outs["scan_33m_rs"], outs["scan_2m"])
    rec = {"config": dataclasses.asdict(cfg), "setup_s": round(setup_s, 3),
           "exact_checks_max_abs_err": checks, "outputs_below_q": not bad,
           "rs_equal_all_gather": rs_equal, "runs": runs}
    emit("scan", rec)
    if bad or not rs_equal:
        raise AssertionError(f"scan: outputs out of range in {bad}, rs == all_gather: {rs_equal}")
    idle = [k for k in ("mul_mod", "add_mod") if launches.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"scan launched no {idle} kernel")
    del cts_col, cts_val, keys, outs, consts, perm
    gc.collect()
    torch.cuda.empty_cache()
    return launches, _scan_kernel_times(by_shape, tabs)


# -------------------------------------------------------------------- mesh
MESH_GRID = (2, 2)           # ("data", "model"): k = 30 splits over model = 2
MESH_DIR = os.path.join(HERE, ".scratch", "mesh")
MESH_TIMEOUT_S = 900         # rendezvous, each collective, and the joins


def _mesh_logical_ledger() -> dict:
    """Q1's ledger on a logical 2 x 2 context (no process group): the
    Mock backend at the paper's noise profile over the same LINEITEM
    32768 rows charges what BFV charges (the ledger counts op units, not
    launches), in seconds on the host.  Runs in a child process beside
    the ranks."""
    from repro_torch.engine import queries, tpch
    from repro_torch.engine.backend import MockBackend
    from repro_torch.engine.planner import Planner

    db = tpch.load(MockBackend(device="cpu"), tpch.Scale(), tables=["lineitem"])
    pl = Planner(db, optimized=True, shards=MESH_GRID[0], limb_shards=MESH_GRID[1])
    if pl.shard_ctx.mesh is not None:
        raise AssertionError("the logical ledger's context has a mesh")
    queries.run_via_plan(pl, queries.plan_q1())
    return pl.shard_ctx.ledger_snapshot()


def _circuit_lanes(bk) -> list:
    """(lanes held, lanes of the whole batch, limbs held) of every stacked
    batch that enters a circuit (`bk.map_lanes`) from now on, appended to
    the list returned."""
    from repro_torch.core.bfv import CiphertextBatch

    seen, orig = [], bk.map_lanes

    def map_lanes(fn, x, *args):
        if isinstance(x, CiphertextBatch):
            seen.append((int(x.data.shape[0]), x.nphys, int(x.data.shape[-2])))
        return orig(fn, x, *args)

    bk.map_lanes = map_lanes
    return seen


# Q1's all-gather bytes a rank on the 2 x 2 mesh, counted from its plan
# (30 limbs, n = 32768, int64): 1,453 singleton key switches each gather
# their centred digits and both outputs over "model" (3 x 7,864,320 B);
# the 16 squarings of the 6-lane EQ batch each gather their operand's
# limbs (3 lanes x 2 x 30 limbs: 47,185,920 B) and no digits; its unstack
# gathers 6 lanes of 15 limbs (47,185,920 B), then their limbs
# (94,371,840 B)
MESH_Q1_ALL_GATHER = 1453 * 3 * 7_864_320 + 16 * 47_185_920 + 47_185_920 + 94_371_840


def _key_bytes(keys) -> int:
    """Bytes of `rlk` and every Galois key a rank holds."""
    return sum(t.numel() * t.element_size()
               for key in (keys.rlk, *keys.gks.values()) for t in (key.b, key.a))


def _mesh_q1(expect_stats) -> dict:
    """One rank's TPC-H Q1 at `paper_params()` on LINEITEM 32768 rows on
    a real ("data", "model") mesh (CUDA tensors, gloo): the same keys and
    table in every rank (seeded), every stacked batch held as its rank's
    lanes over "data" and its limbs over "model", every key switch key
    held by its output-limb slice from the first key switch on.  The
    table is one block: Q1 stacks one fused 6-lane batch of its 5 EQ
    atoms (3 lanes, 15 of 30 limbs a rank) and folds nothing;
    `_mesh_data_axis` then drives the fold and the other lane-crossing
    calls.  `expect_stats`: the unsharded run's OpStats (None to skip).
    The parent holds the ledger against a logical 2 x 2 context's."""
    from repro_torch.core import collectives as C
    from repro_torch.core.params import paper_params
    from repro_torch.engine import queries
    from repro_torch.engine.planner import Planner

    paper = paper_params()
    bk, db, secs = load_paper_lineitem(paper)
    pl = Planner(db, optimized=True, shards=MESH_GRID[0], limb_shards=MESH_GRID[1])
    mesh = pl.shard_ctx.mesh
    lanes = _circuit_lanes(bk)
    C.reset_collective_record()
    run = _via_plan(bk, pl)
    record = C.collective_record()
    ledger = pl.shard_ctx.ledger_snapshot()
    exp = queries.oracle_q1(db)
    keys = [bk.keys.rlk, *bk.keys.gks.values()]
    key_limbs = sorted({int(key.b.shape[1]) for key in keys})
    data_axis = _mesh_data_axis(bk, pl.shard_ctx)
    bad = []
    if mesh is None or pl.shard_ctx.limb_mesh is None or mesh.device_type != "cuda":
        bad.append(f"no real CUDA query mesh: {mesh}")
    if run["got"] != exp or sum(len(row) for row in run["got"].values()) != 48:
        bad.append(f"decrypts {run['got']} != oracle_q1 {exp}")
    if expect_stats is not None and run["op_stats"] != expect_stats:
        bad.append(f"OpStats {run['op_stats']} != unsharded {expect_stats}")
    if run["op_stats"]["refresh"] != 0 or not ledger["gather_bytes"] > 0:
        bad.append(f"refresh {run['op_stats']['refresh']}, gather bytes {ledger['gather_bytes']}")
    batches = [b for b in lanes if b[1] > 1]
    kl = paper.k // MESH_GRID[1]
    if not batches or any(held != whole // MESH_GRID[0] or limbs != kl
                          for held, whole, limbs in batches):
        bad.append(f"circuit batches (held lanes, whole lanes, held limbs) {lanes}: not held "
                   f"over \"data\" and \"model\"")
    if key_limbs != [kl]:
        bad.append(f"keys hold output limbs {key_limbs}, not {kl} of {paper.k}")
    if record["all-gather"] != MESH_Q1_ALL_GATHER:
        bad.append(f"all-gather bytes {record['all-gather']} != the count {MESH_Q1_ALL_GATHER}")
    bad += data_axis.pop("failures")
    return {"mesh": {"device_type": mesh.device_type, "shape": list(mesh.shape),
                     "axes": list(mesh.mesh_dim_names)} if mesh is not None else None,
            "keygen_s": round(secs["keygen"], 3), "load_encrypt_s": round(secs["load_encrypt"], 3),
            "query_s": run["query_s"], "stage_s": {k: round(v, 3) for k, v in run["secs"].items()},
            "equal_to_oracle": run["got"] == exp, "op_stats": run["op_stats"],
            "circuit_lanes": {"held_max": max(b[0] for b in batches) if batches else None,
                              "held_min": min(b[0] for b in batches) if batches else None,
                              "whole": sorted({b[1] for b in batches}),
                              "batches": len(batches)},
            "circuit_limbs": {"held": sorted({b[2] for b in batches}), "whole": paper.k},
            "key_limbs": {"held": key_limbs, "whole": paper.k},
            "key_bytes_held": _key_bytes(bk.keys),
            "collective_bytes": record, "all_gather_count": MESH_Q1_ALL_GATHER,
            "ledger": ledger,
            "kernel_launches": run["launches"], "peak_device_bytes": run["peak_device_bytes"],
            "data_axis": data_axis, "failures": bad}


# the data-axis calls start from this generator (a stated state, the
# same in the ranks and in the parent's one-device run)
MESH_DATA_SEED = SEED + 5
MESH_DATA_EXPECT = os.path.join(MESH_DIR, "data_axis_expected.pt")


def _data_axis_calls(bk, shard_ctx) -> dict:
    """3 blocks encrypted from the generator at `MESH_DATA_SEED`, stacked
    (under `shard_ctx`: 4 lanes held sharded) and put through mul,
    rotate, fold_blocks, decrypt and `refresh_inplace` of the global lanes
    0 and 2, then one more encryption: the gathered residues, decrypts
    and noise on the host, and the lanes and limbs each batch held."""
    from repro_torch.engine.sharded import activate

    bk.ctx.rng.bit_generator.state = np.random.default_rng(MESH_DATA_SEED).bit_generator.state
    vecs = [(np.arange(bk.slots) * (i + 3)) % 1000 for i in range(3)]
    cts = [bk.encrypt(v) for v in vecs]
    out = {}
    with activate(bk, shard_ctx):
        x = bk.stack_blocks(cts)
        prod, rot = bk.mul(x, x), bk.rotate(x, 1)
        out["held"] = [int(b.data.shape[0]) for b in (x, prod, rot)]
        out["limbs"] = [int(b.data.shape[-2]) for b in (x, prod, rot)]
        out["mul"] = torch.stack([c.data for c in bk.unstack_blocks(prod)]).cpu()
        out["rotate"] = torch.stack([c.data for c in bk.unstack_blocks(rot)]).cpu()
        out["fold"] = bk.fold_blocks(prod).data.cpu()
        out["decrypt"] = bk.decrypt(rot)
        bk.refresh_inplace(prod, [0, 2])
        out["refreshed"] = torch.stack([c.data for c in bk.unstack_blocks(prod)]).cpu()
        out["refreshed_decrypt"] = bk.decrypt(prod)
        out["noise"] = np.asarray(prod.noise)
    out["encrypt"] = bk.encrypt(vecs[0]).data.cpu()
    return out


def _mesh_data_axis_expected() -> dict:
    """In the parent, while the ranks run Q1: `_data_axis_calls` on one
    device (the card, no shard context) with whole keys from the ranks'
    seed, saved for the ranks to compare with; then freed."""
    import hashlib

    from repro_torch.core.params import paper_params
    from repro_torch.engine.backend import BFVBackend

    t0 = clock()
    bk = BFVBackend(paper_params(), seed=SEED)
    keygen_s = clock() - t0
    t0 = clock()
    out = _data_axis_calls(bk, None)
    secs = clock() - t0
    torch.save(out, MESH_DATA_EXPECT + ".tmp")
    os.replace(MESH_DATA_EXPECT + ".tmp", MESH_DATA_EXPECT)
    del bk
    gc.collect()
    torch.cuda.empty_cache()
    return {"keygen_s": keygen_s, "one_device_s": secs, "held": out["held"],
            "limbs": out["limbs"],
            "encrypt_after_sha256": hashlib.sha256(out["encrypt"].numpy().tobytes()).hexdigest()}


def _wait_for(path: str):
    """`torch.load(path)` once the parent has written it; raise if it
    wrote `path`.err instead, or after MESH_TIMEOUT_S."""
    deadline = time.monotonic() + MESH_TIMEOUT_S
    while not os.path.exists(path):
        if os.path.exists(path + ".err"):
            raise RuntimeError(f"the parent failed to write {path}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written within {MESH_TIMEOUT_S} s")
        time.sleep(0.5)
    return torch.load(path, weights_only=False)


def _mesh_data_axis(bk, shard_ctx) -> dict:
    """Real ciphertexts held sharded over "data" and "model", at the
    paper's parameters on the same mesh: `_data_axis_calls` under the
    rank's shard context — 2 of the batch's 4 lanes a rank, 15 of their
    30 limbs, through mul (the operand's limbs gathered, the tensor
    whole, the key switch on the rank's output limbs), rotate (digits
    gathered), fold_blocks (summed over "data", its limbs gathered),
    decrypt and the refresh (lanes and limbs gathered) — against the same
    calls on one device, which the parent ran with whole keys.  Every
    gathered residue, decrypt, noise and the last encryption must be
    equal (the refresh re-encrypts from the generator on every rank in the
    same order)."""
    import hashlib

    t0 = clock()
    held = _data_axis_calls(bk, shard_ctx)
    secs = clock() - t0
    one = _wait_for(MESH_DATA_EXPECT)
    equal = {}
    for key, got in held.items():
        if key in ("held", "limbs"):
            continue
        ref = one[key]
        equal[key] = (torch.equal(got, ref) if isinstance(got, torch.Tensor)
                      else bool(np.array_equal(got, ref)))
    bad = []
    if not all(equal.values()):
        bad.append(f"data axis: sharded calls != one device: {equal}")
    kl = bk.params.k // MESH_GRID[1]
    if (held["held"] != [2, 2, 2] or held["limbs"] != [kl] * 3 or one["held"] != [3, 3, 3]
            or one["limbs"] != [bk.params.k] * 3):
        bad.append(f"data axis: lanes, limbs held {held['held']}, {held['limbs']} "
                   f"(one device {one['held']}, {one['limbs']})")
    if np.ndim(held["noise"]) != 1:
        bad.append(f"data axis: refresh of lanes 0, 2 left noise {held['noise']}")
    digest = hashlib.sha256(held["encrypt"].numpy().tobytes()).hexdigest()
    return {"lanes": 4, "live": 3, "held": held["held"], "limbs": held["limbs"],
            "equal_to_one_device": equal, "sharded_s": secs, "encrypt_after_sha256": digest,
            "failures": bad}


# the scan step on the same ranks: CONFIG at full width on 16 blocks
# (scan_2m's 64 cut for time), 8 a "data" rank, all of them in one pass
MESH_SCAN_BLOCKS = 16
MESH_SCAN_CHUNK = 8
MESH_SCAN_EXPECT = os.path.join(MESH_DIR, "scan_expected.pt")
SCAN_KEYS = ("rlk_b", "rlk_a", "gk_b", "gk_a")


def _mesh_scan_inputs(cfg, q) -> dict:
    """The step's whole inputs on the host, drawn on the card from the
    seed (`q`: the limbs' moduli there): every rank and the one-device
    run draw the same."""
    gen = torch.Generator(device=q.device).manual_seed(SEED + 4)
    q = q.to(torch.int64)[:, None]
    draw = lambda *lead: _draw_residues(gen, q, lead + (cfg.k, cfg.n)).cpu()
    out = {"cts_col": draw(MESH_SCAN_BLOCKS, 2), "cts_val": draw(MESH_SCAN_BLOCKS, 2)}
    out.update((key, draw(cfg.k)) for key in SCAN_KEYS)
    return out


def _mesh_scan_expected() -> dict:
    """Before the ranks start: `query_step` on one device (the card) over
    the 16 blocks, saved for the ranks to compare with, and the dry-run's
    count for one rank's shard on the 2 x 2 mesh in both modes."""
    from repro_torch.configs.nshedb import CONFIG
    from repro_torch.launch import dryrun
    from repro_torch.launch import nshedb_step as S

    cfg = CONFIG
    consts = S.make_constants(cfg, device="cuda")
    full = {key: t.cuda() for key, t in _mesh_scan_inputs(cfg, consts["q"]).items()}
    chunk = S.default_chunk(full["cts_col"], cfg.k)
    t0 = clock()
    out = S.query_step(full["cts_col"], full["cts_val"], *(full[k] for k in SCAN_KEYS),
                       consts["tabs"], consts["perm"], eq_levels=cfg.eq_levels,
                       rot_steps=cfg.rot_steps, chunk=chunk)
    secs = clock() - t0
    torch.save(out.cpu(), MESH_SCAN_EXPECT)
    del full, out, consts
    gc.collect()
    torch.cuda.empty_cache()
    pred = {}
    for mode in S.KS_MODES:
        got = dryrun.measure_step(cfg, MESH_GRID, ("data", "model"), MESH_SCAN_BLOCKS,
                                  ks_mode=mode, chunk=MESH_SCAN_CHUNK)
        pred[mode] = dict(got, peak_bytes=got["argument_bytes"] + got["temp_bytes"])
    return {"one_device_s": secs, "one_device_chunk": chunk, "dryrun": pred}


def _mesh_scan() -> dict:
    """One rank's part of the scan step on a 2 x 2 ("data", "model")
    mesh at CONFIG: its shard of the 16 blocks (8 blocks, 16 limbs) and
    of the keys, placed for each mode, on the card; seconds (from a
    barrier, synchronized), peak allocated bytes, launches, the
    collective record of the step, and whether the aggregate gathered
    along "model" equals the one-device run's."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs.nshedb import CONFIG
    from repro_torch.core import collectives as C
    from repro_torch.launch import nshedb_step as S
    from repro_torch.launch.mesh import make_query_mesh

    cfg = CONFIG
    mesh = make_query_mesh(*MESH_GRID, device="cuda")
    consts = S.make_constants(cfg, device="cuda")
    full = _mesh_scan_inputs(cfg, consts["q"])
    expect = torch.load(MESH_SCAN_EXPECT).cuda()
    runs, launches, bad = {}, {}, []
    for mode in S.KS_MODES:
        local = {key: t.cuda() for key, t in S.shard_inputs(full, mesh, mode).items()}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        C.reset_collective_record()
        kernels.reset_launch_counts()
        t0 = clock()
        agg = S.query_step_sharded(local["cts_col"], local["cts_val"],
                                   *(local[k] for k in SCAN_KEYS), consts["tabs"],
                                   consts["perm"], mesh, eq_levels=cfg.eq_levels,
                                   rot_steps=cfg.rot_steps, ks_mode=mode, chunk=MESH_SCAN_CHUNK)
        secs = clock() - t0
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        record = C.collective_record()
        peak = torch.cuda.max_memory_allocated()
        equal = torch.equal(C.gather_axis(agg, mesh, "model", dim=1), expect)
        for name, n_ in counts.items():
            launches[name] = launches.get(name, 0) + n_
        runs[mode] = {"step_s": secs, "peak_device_bytes": peak, "collective_bytes": record,
                      "blocks": local["cts_col"].shape[0], "limbs": local["cts_col"].shape[-2],
                      "chunk": MESH_SCAN_CHUNK, "kernel_launches": counts,
                      "equal_to_one_device": equal}
        if not equal:
            bad.append(f"scan step ({mode}): aggregate != one-device query_step")
        del local, agg
    idle = [k for k in ("mul_mod", "add_mod") if launches.get(k, 0) <= 0]
    if idle:
        bad.append(f"scan step launched no {idle} kernel")
    return {"runs": runs, "kernel_launches": launches, "failures": bad}


def _mesh_nccl() -> dict:
    """One rank under NCCL (a 1 x 1 mesh): `kswitch_gathered` of a 5-lane
    batch and `sharded_fold` at `paper_params()`, the fold both of the
    whole batch and of it held as this rank's lanes (`LaneShard`: all
    five here), against the one-device key switch and sum."""
    from repro_torch.core.bfv import BFVContext, LaneShard
    from repro_torch.core.params import paper_params
    from repro_torch.engine.sharded import sharded_fold
    from repro_torch.launch.mesh import make_query_mesh

    paper = paper_params()
    ctx = BFVContext(paper, seed=SEED)
    rlk = ctx.keygen(galois_steps=()).rlk
    poly = _rand_limbs(np.random.default_rng(SEED), paper.Q.primes, (LANES,), paper.n, "cuda")
    mesh = make_query_mesh(1, 1)
    got = ctx.kswitch_gathered(poly, rlk, mesh)
    exp = ctx._kswitch_inner(poly, rlk.b, rlk.a)
    data = torch.stack([poly, poly.flip(0)], dim=1)
    lanes = LaneShard(0, LANES, LANES, mesh)
    return {"mesh": {"device_type": mesh.device_type, "shape": list(mesh.shape)},
            "kswitch_gathered_equal": all(torch.equal(g, e) for g, e in zip(got, exp)),
            "sharded_fold_equal": all(torch.equal(sharded_fold(data, 3, mesh, held),
                                                  data[:3].sum(0)) for held in (None, lanes)),
            "failures": []}


def _mesh_rank(rank: int, world: int, backend: str, expect_stats) -> None:
    """A rank process: join the group (file rendezvous under MESH_DIR),
    run its part, write its record (or its traceback) there."""
    import datetime
    import traceback

    import torch.distributed as dist
    torch.set_num_threads(2)
    path = os.path.join(MESH_DIR, f"{backend}.{rank}")
    try:
        dist.init_process_group(backend, init_method=f"file://{MESH_DIR}/{backend}.rendezvous",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        if backend == "gloo":
            rec = _mesh_q1(expect_stats)
            gc.collect()
            torch.cuda.empty_cache()
            rec["scan_step"] = _mesh_scan()
            rec["failures"] += rec["scan_step"].pop("failures")
        else:
            rec = _mesh_nccl()
        with open(path + ".json", "w") as f:
            json.dump(rec, f)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(world: int, backend: str, expect_stats=None, meanwhile=None):
    """Start `world` rank processes, run `meanwhile()` here if given (the
    ranks wait for what it writes; if it raises, it writes
    MESH_DATA_EXPECT.err so that they stop), wait for all (killing any
    still alive after MESH_TIMEOUT_S) and return their records, and
    `meanwhile`'s result when given; raise on any failure."""
    import multiprocessing
    import traceback
    spawn = multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=_mesh_rank, args=(r, world, backend, expect_stats))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_TIMEOUT_S
    recs, bad, extra = [], [], None
    if meanwhile is not None:
        try:
            extra = meanwhile()
        except Exception:
            bad.append(f"parent raised:\n{traceback.format_exc()}")
            with open(MESH_DATA_EXPECT + ".err", "w") as f:
                f.write(bad[-1])
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    for r, p in enumerate(procs):
        base = os.path.join(MESH_DIR, f"{backend}.{r}")
        if os.path.exists(base + ".json"):
            with open(base + ".json") as f:
                recs.append(json.load(f))
            bad += [f"{backend} rank {r}: {msg}" for msg in recs[-1]["failures"]]
        elif os.path.exists(base + ".err"):
            with open(base + ".err") as f:
                bad.append(f"{backend} rank {r} raised:\n{f.read()}")
        else:
            bad.append(f"{backend} rank {r} {'hung' if r in hung else f'exited {p.exitcode}'}")
    if bad:
        raise AssertionError("mesh phase: " + "\n".join(bad))
    return recs if meanwhile is None else (recs, extra)


def _summed(counts) -> dict:
    out = {}
    for rec in counts:
        for name, n_ in rec.items():
            out[name] = out.get(name, 0) + n_
    return out


def _mesh_parent_side() -> tuple[dict, dict, float]:
    """What the parent runs while the gloo ranks run: the data-axis
    calls on one device (`_mesh_data_axis_expected`), then the one NCCL
    rank (its own process and group), timed."""
    data_expect = _mesh_data_axis_expected()
    t0 = time.perf_counter()
    nccl = _run_ranks(1, "nccl")[0]
    return data_expect, nccl, time.perf_counter() - t0


def phase_mesh(expect_stats) -> tuple[dict, dict]:
    """Four ranks sharing the card over gloo on a 2 x 2 ("data", "model")
    mesh, each running Q1 on real ciphertexts held over "data" and
    "model", its keys by output-limb slice (every rank equal to the
    oracle, OpStats equal to the unsharded run's, its ledger to a logical
    2 x 2 context's), then a sharded BFV batch's mul, rotate, fold,
    decrypt and refresh against one device (the parent's, run beside the
    ranks), then the scan step on the mesh against one device and the
    dry-run; beside them, one rank under NCCL.  Returns the launch counts
    of the four ranks' queries and of their scan steps, each summed over the ranks (the
    checks after Q1 and the one-device scan are not counted)."""
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    t0 = time.perf_counter()
    with _beside(_mesh_logical_ledger) as logical:
        scan_expect = _mesh_scan_expected()
        expect_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        world = MESH_GRID[0] * MESH_GRID[1]
        recs, (data_expect, nccl, nccl_s) = _run_ranks(world, "gloo", expect_stats,
                                                       meanwhile=_mesh_parent_side)
        gloo_s = time.perf_counter() - t0
        ledger = logical()
    for rec in recs:
        rec["ledger_equal_to_logical"] = (rec["ledger"]["real_mesh"]
                                          and dict(rec["ledger"], real_mesh=False) == ledger)
    scans = [rec.pop("scan_step") for rec in recs]
    pred = scan_expect["dryrun"]
    beside = {mode: {"dryrun": {k: pred[mode][k] for k in (
                         "collective_bytes", "peak_bytes", "argument_bytes", "temp_bytes",
                         "flops", "hlo_bytes", "chunk")},
                     "ranks": [{k: scan["runs"][mode][k] for k in (
                         "step_s", "peak_device_bytes", "collective_bytes")} for scan in scans]}
              for mode in pred}
    emit("mesh", {"grid": list(MESH_GRID), "backend": "gloo", "tensors": "cuda",
                  "phase_s": round(expect_s + gloo_s, 3), "ranks": recs,
                  "data_axis_one_device": data_expect,
                  "scan_step": {"blocks": MESH_SCAN_BLOCKS, "chunk": MESH_SCAN_CHUNK,
                                "one_device_s": scan_expect["one_device_s"],
                                "one_device_chunk": scan_expect["one_device_chunk"],
                                "one_device_and_dryrun_s": round(expect_s, 3),
                                "by_mode": beside, "ranks": scans},
                  "nccl_1x1": nccl, "nccl_s": round(nccl_s, 3),
                  "kernel_launches": _summed(rec["kernel_launches"] for rec in recs),
                  "scan_kernel_launches": _summed(scan["kernel_launches"] for scan in scans)})
    if not (nccl["kswitch_gathered_equal"] and nccl["sharded_fold_equal"]):
        raise AssertionError(f"mesh phase: NCCL 1 x 1 run disagrees: {nccl}")
    off = [r for r, rec in enumerate(recs) if not rec["ledger_equal_to_logical"]]
    if off:
        raise AssertionError(f"mesh phase: ranks {off}: ledgers differ from the logical "
                             f"2 x 2 context's {ledger}")
    digests = {rec["data_axis"]["encrypt_after_sha256"] for rec in recs}
    if digests != {data_expect["encrypt_after_sha256"]}:
        raise AssertionError(f"mesh phase: the ranks' generators left step: {digests}, one "
                             f"device {data_expect['encrypt_after_sha256']}")
    off = [(mode, r) for mode, rec in beside.items() for r, got in enumerate(rec["ranks"])
           if got["collective_bytes"] != rec["dryrun"]["collective_bytes"]]
    if off:
        raise AssertionError(f"mesh phase: scan step collective bytes differ from the "
                             f"dry-run's in (mode, rank) {off}")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return (_summed(rec["kernel_launches"] for rec in recs),
            _summed(scan["kernel_launches"] for scan in scans))


# ------------------------------------------------------------------- train
# starcoder2-3b (arXiv:2402.19173) at full width and depth in float32, as
# the reference launcher trains; the dry-run's train_4k cell (batch 256 x
# 4096 tokens) is cut to 2 x 1024 by one card's 80 GB (parameters,
# gradients and both AdamW moments take 48.5 GB)
TRAIN_ARCH = "starcoder2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 6
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--steps", str(TRAIN_STEPS), "--log-every", "1"]
# the two-layer checks at full width: batch 1 x 256 tokens
CHECK_LAYERS, CHECK_BATCH, CHECK_SEQ = 2, 1, 256
CHECK_ARGV = ["--arch", TRAIN_ARCH, "--batch", str(CHECK_BATCH), "--seq", str(CHECK_SEQ),
              "--log-every", "100"]
TRAIN_CKPT_DIR = os.path.join(HERE, ".scratch", "train_checkpoint")
# the attention gradient with the kernel forward against autograd through
# the plain version, float32: the two sum in other orders
ATTN_GRAD_TOL = 1e-4           # of the largest |gradient|
# card step against CPU step: matmuls and attention sum in other orders
TRAIN_STEP_RTOL = 1e-4
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores (TF32 off)
# (B, H, Hkv, S, D, kwargs): starcoder2-3b's training shape; a gemma2-like
# layer (softcap 50, window 4096, GQA 2:1) past the window and past one
# 2048-query chunk, S not a multiple of it; two whole chunks
ATTN_GRAD_CASES = [
    (2, 24, 2, 1024, 128, dict(causal=True)),
    (1, 8, 4, 4500, 128, dict(causal=True, window=4096, softcap=50.0)),
    (1, 4, 1, 3000, 128, dict(causal=True)),
    (1, 4, 2, 4096, 128, dict(causal=True)),
]


def _attn_grad_checks(dev) -> dict:
    """`mha` under autograd (the kernel forward, `grad.mha_backward`)
    against autograd through `mha_ref`, on the card in float32, on
    ATTN_GRAD_CASES: the output within FLASH_TOL, dq, dk, dv within
    ATTN_GRAD_TOL of the largest |gradient|."""
    from repro_torch.kernels.flash_attn.ops import mha
    from repro_torch.kernels.flash_attn.ref import mha_ref

    rng = np.random.default_rng(SEED + 7)
    out = []
    for B, H, Hkv, S, D, kw in ATTN_GRAD_CASES:
        q, k, v = _attn_inputs(rng, B, H, Hkv, S, S, D, torch.float32, dev, strided=True,
                               q_scale=SOFTCAP_Q_SCALE if "softcap" in kw else 1.0)
        w = torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32)).to(dev)
        res = []
        for fn in (mha, mha_ref):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, **kw)
            res.append((o.detach(), torch.autograd.grad((o * w).sum(), leaves)))
            del o, leaves
        (o_k, g_k), (o_r, g_r) = res
        what = f"{(B, H, Hkv, S, D)} {kw}"
        rec = {"shape": [B, H, Hkv, S, D], "mask": kw,
               "out_max_abs_err": _check_close(o_k, o_r, f"train attention {what}")}
        for name, a, b in zip(("dq", "dk", "dv"), g_k, g_r):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            rec[name] = {"max_abs_err": err, "max_abs": scale}
            if not err <= ATTN_GRAD_TOL * scale:
                raise AssertionError(f"attention gradient {name} disagrees at {what}: "
                                     f"{err} > {ATTN_GRAD_TOL} x {scale}")
        out.append(rec)
        del res, g_k, g_r, q, k, v, w
    torch.cuda.empty_cache()
    return {"cases": out, "tolerance": f"{ATTN_GRAD_TOL} x max |gradient|"}


def _attn_train_times(dev) -> dict:
    """flash_attn at starcoder2-3b's training shape (B 2, H 24 / Hkv 2,
    S 1024, D 128, float32, causal): the kernel forward beside its plain
    version and `scaled_dot_product_attention`, then the backward
    (`grad.mha_backward`, torch ops) beside SDPA's backward, KV heads
    repeated outside the timed calls."""
    from repro_torch.kernels.flash_attn.grad import mha_backward
    from repro_torch.kernels.flash_attn.ops import mha
    from repro_torch.kernels.flash_attn.ref import mha_ref

    B, H, Hkv, S, D = TRAIN_BATCH, 24, 2, TRAIN_SEQ, 128
    rng = np.random.default_rng(SEED + 8)
    q, k, v = _attn_inputs(rng, B, H, Hkv, S, S, D, torch.float32, dev, strided=True)
    dout = torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32)).to(dev)
    err = _check_close(mha(q, k, v), mha_ref(q, k, v), "starcoder2 training shape")
    pairs = _visible_pairs(S, S, True, None)
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = 4 * D * pairs * B * H / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    rec = {"shape": {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "dtype": "float32"},
           "mask": {"causal": True}, "max_abs_err": err,
           "ms": gpu_ms(lambda: mha(q, k, v), reps=5, inner=5),
           "plain_ms": gpu_ms(lambda: mha_ref(q, k, v), reps=3, inner=2, warmup=1),
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": gpu_ms(lambda: sdpa(q, kr, vr, is_causal=True), reps=5, inner=5),
           "library_call": "scaled_dot_product_attention(is_causal=True), float32, "
                           "KV heads repeated"}
    # backward: recompute the scores (2·D per pair), dV, dP, dQ, dK (2·D each)
    b_ops = 10 * D * pairs * B * H / PEAK_F32_FLOPS * 1e3
    b_bytes = 4 * (3 * q.numel() + 3 * k.numel() + 3 * v.numel()) / PEAK_BYTES_PER_S * 1e3
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, kr, vr))
    lo = sdpa(lq, lk, lv, is_causal=True)
    rec["backward"] = {
        "route": "torch ops (kernels/flash_attn/grad.py)",
        "ms": gpu_ms(lambda: mha_backward(q, k, v, dout), reps=5, inner=3),
        "bound_ms": max(b_ops, b_bytes), "bound_by": "operations" if b_ops >= b_bytes else "bytes",
        "library_ms": gpu_ms(lambda: torch.autograd.grad(lo, (lq, lk, lv), dout,
                                                         retain_graph=True), reps=5, inner=3),
        "library_call": "scaled_dot_product_attention backward, float32, KV heads repeated"}
    return rec


@contextlib.contextmanager
def _train_depth(n_layers: int):
    """`launch.train` building TRAIN_ARCH with `n_layers` layers (full
    width): the two-layer checks drive the launcher as a user does."""
    from repro_torch.launch import train as train_launch

    orig = train_launch.get_config
    train_launch.get_config = lambda arch: dataclasses.replace(orig(arch), n_layers=n_layers)
    try:
        yield train_launch
    finally:
        train_launch.get_config = orig


def _rel_err(got, exp) -> float:
    return float((got.cpu() - exp).abs().max()) / max(float(exp.abs().max()), 1e-30)


# AdamW's step g / (|g| + eps), eps = 1e-8: where |g| is within a few
# hundred eps the step turns on the gradient's last float32 digits, which
# two summation orders (the card's and the CPU's; two CPU thread counts do
# the same) leave different.  Parameters are held at TRAIN_STEP_RTOL where
# |g| >= TINY_GRAD and within lr elsewhere; the moments everywhere.
TINY_GRAD = 1e-6


def _step_errors(card, cpu, lr: float) -> dict:
    """Largest relative differences, over the leaves, of one card step's
    parameters and AdamW moments against the CPU step's."""
    from repro_torch.models.lm import tree_leaves as lm_leaves

    m_c = lm_leaves(cpu[1]["adam"]["m"])
    out = {"moments_max_rel_err": max(_rel_err(a, b) for a, b in zip(
        lm_leaves([card[1]["adam"]["m"], card[1]["adam"]["v"]]),
        lm_leaves([cpu[1]["adam"]["m"], cpu[1]["adam"]["v"]])))}
    big, small, n_small = 0.0, 0.0, 0
    for a, b, m in zip(lm_leaves(card[0]), lm_leaves(cpu[0]), m_c):
        d = (a.cpu() - b).abs()
        tiny = m.abs() < (1 - 0.9) * TINY_GRAD      # m = (1 - b1) g after one step
        if (~tiny).any():
            big = max(big, float(d[~tiny].max()) / max(float(b.abs().max()), 1e-30))
        if tiny.any():
            small = max(small, float(d[tiny].max()) / lr)
            n_small += int(tiny.sum())
    out.update({"params_max_rel_err": big, "tiny_grad_elements": n_small,
                "tiny_grad_params_max_err_over_lr": small})
    return out


def _train_two_layer_checks(dev) -> dict:
    """At starcoder2-3b's full width with two layers, batch 1 x 256: one
    train step on the card against the same step on the host's CPU (the
    plain versions) from the same parameters and batch; one launcher step
    with --compress-grads; save at step 2 and resume to step 4 against an
    uninterrupted 4-step run."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train import steps

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=CHECK_LAYERS)
    params = lm.init_params(torch.Generator(dev).manual_seed(SEED), cfg, torch.float32, dev)
    host = lm.tree_map(lambda t: t.to("cpu", copy=True), params)
    np_batch = TokenPipeline(vocab=cfg.vocab, seq_len=CHECK_SEQ, batch=CHECK_BATCH).next_batch()
    runs, secs = {}, {}
    for where, p in (("cuda", params), ("cpu", host)):
        batch = {k_: torch.from_numpy(v_).to(p["embed"].device, torch.int64)
                 for k_, v_ in np_batch.items()}
        t0 = clock()
        p, opt, m = steps.make_train_step(cfg, lr=1e-3)(p, steps.init_opt(cfg, p), batch)
        runs[where] = (p, opt, {k_: float(v_) for k_, v_ in m.items()})
        secs[where] = clock() - t0
    gm, cm = runs["cuda"][2], runs["cpu"][2]
    metric_err = {k_: abs(gm[k_] - cm[k_]) / abs(cm[k_]) for k_ in gm}
    step_err = _step_errors(runs["cuda"], runs["cpu"], lr=1e-3)
    del params, host, runs
    gc.collect()
    torch.cuda.empty_cache()

    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    with _train_depth(CHECK_LAYERS) as train_launch:
        plain = train_launch.main(CHECK_ARGV + ["--steps", "4"], device=dev)
        compressed = train_launch.main(CHECK_ARGV + ["--steps", "1", "--compress-grads"],
                                       device=dev)
        t0 = clock()
        train_launch.main(CHECK_ARGV + ["--steps", "2", "--ckpt-dir", TRAIN_CKPT_DIR,
                                        "--ckpt-every", "100"], device=dev)
        resumed = train_launch.main(CHECK_ARGV + ["--steps", "4", "--ckpt-dir", TRAIN_CKPT_DIR,
                                                  "--ckpt-every", "100", "--resume"],
                                    device=dev)
        ckpt_s = clock() - t0
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    res = {"n_layers": CHECK_LAYERS, "batch": CHECK_BATCH, "seq": CHECK_SEQ,
           "card_vs_cpu": {"card": gm, "cpu": cm, "metric_rel_err": metric_err, **step_err,
                           "rtol": TRAIN_STEP_RTOL, "tiny_grad": TINY_GRAD, "seconds": secs},
           "losses": plain, "compressed_first_loss": compressed[0],
           "resumed_losses": resumed, "save_resume_seconds": ckpt_s}
    if not (max(metric_err.values()) <= TRAIN_STEP_RTOL
            and step_err["moments_max_rel_err"] <= TRAIN_STEP_RTOL
            and step_err["params_max_rel_err"] <= TRAIN_STEP_RTOL
            and step_err["tiny_grad_params_max_err_over_lr"] <= 1.0):
        raise AssertionError(f"train: the card's step disagrees with the CPU's: {res}")
    if not (np.isfinite(compressed[0]) and abs(compressed[0] - plain[0]) <= 1e-6 * abs(plain[0])):
        raise AssertionError(f"train: the compressed run's first loss {compressed[0]} != "
                             f"the plain run's {plain[0]}")
    if not np.allclose(resumed, plain[2:], rtol=1e-5, atol=0):
        raise AssertionError(f"train: resumed losses {resumed} != uninterrupted {plain[2:]}")
    return res


def _train_profile(dev) -> None:
    """starcoder2-3b's training run again, 3 steps under TRAIN_ARGV's
    shapes, with torch.profiler over steps 2 and 3 (step 1 warms up):
    device time by kernel, busy and idle share, as a `train_profile`
    line."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as train_launch

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    mark = {}

    def on_step(step, loss, seconds):
        if step == 0:
            mark["t0"] = clock()
            prof.start()
        elif step == 2:
            mark["wall"] = clock() - mark["t0"]
            prof.stop()

    argv = TRAIN_ARGV[:TRAIN_ARGV.index("--steps")] + ["--steps", "3", "--log-every", "1"]
    train_launch.main(argv, device=dev, on_step=on_step)
    emit("train_profile", {"steps": 2, **_profile_summary(prof, mark["wall"])})


def phase_train(profile: bool = False) -> tuple[dict, dict]:
    """(a) the attention gradient with the kernel forward against the
    plain version's, and the kernel and its torch-op backward timed at the
    training shape; (b) starcoder2-3b at full width and depth in float32
    through `launch.train.main(TRAIN_ARGV)`, per step loss, seconds and
    flash_attn launches, peak memory; (c) the two-layer checks; with
    `profile`, (b) again under torch.profiler afterwards.  Returns the
    launch counts of (b) and flash_attn's times at the training shape."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launch
    from repro_torch.models import lm

    dev = torch.device("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"train: torch.backends.cuda.matmul.allow_tf32 = {tf32}", flush=True)
    if tf32:
        raise AssertionError("train: TF32 matmuls are on; the float32 checks need them off")
    grads = _attn_grad_checks(dev)
    times = _attn_train_times(dev)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(TRAIN_ARCH)
    per_step = []
    mark = [0]

    def on_step(step, loss, seconds):
        fa = kernels.launch_counts()["flash_attn"]
        per_step.append({"step": step, "loss": loss, "seconds": seconds,
                         "flash_attn_launches": fa - mark[0]})
        mark[0] = fa

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = clock()
    losses = train_launch.main(TRAIN_ARGV, device=dev, on_step=on_step)
    wall = clock() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = [r["seconds"] for r in per_step]
    median = float(np.median(step_s[1:]))
    full = {"arch": TRAIN_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "params": lm.param_count(cfg), "dtype": "float32",
            "tf32": tf32, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": per_step,
            "step_seconds_median_2_to_6": median,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median,
            "peak_device_bytes": peak,
            "peak_device_bytes_reserved": torch.cuda.max_memory_reserved(),
            "wall_s_with_init": wall, "kernel_launches": launches,
            "reduced": "train_4k's batch 256 x 4096 tokens cut to 2 x 1024: one card's 80 GB"}
    gc.collect()
    torch.cuda.empty_cache()
    two = _train_two_layer_checks(dev)
    emit("train", {"attention_grad": grads, "attention_at_training_shape": times,
                   "full_width": full, "two_layer": two})
    if not (len(losses) == TRAIN_STEPS and all(np.isfinite(losses))):
        raise AssertionError(f"train: losses {losses}")
    if any(r["flash_attn_launches"] != cfg.n_layers for r in per_step):
        raise AssertionError(f"train: flash_attn launches per step "
                             f"{[r['flash_attn_launches'] for r in per_step]}, expected "
                             f"{cfg.n_layers} (forward only)")
    if profile:
        gc.collect()
        torch.cuda.empty_cache()
        _train_profile(dev)
    return launches, {"flash_attn": {"starcoder2_train_f32": times}}


KERNEL_META = {
    "ntt_fwd": ("src/repro_torch/kernels/csrc/ntt.cu", "src/repro/kernels/ntt/ntt.py:68"),
    "ntt_inv": ("src/repro_torch/kernels/csrc/ntt.cu", "src/repro/kernels/ntt/ntt.py:92"),
    "mul_mod": ("src/repro_torch/kernels/csrc/modops.cu", "src/repro/kernels/modops/modops.py:44"),
    "add_mod": ("src/repro_torch/kernels/csrc/modops.cu", "src/repro/kernels/modops/modops.py:59"),
    "sub_mod": ("src/repro_torch/kernels/csrc/modops.cu", "src/repro/kernels/modops/modops.py:69"),
    "rotate_reduce": ("src/repro_torch/kernels/csrc/rotate_reduce.cu",
                      "src/repro/kernels/rotate_reduce/rotate_reduce.py:29"),
    "flash_attn": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                   "src/repro/kernels/flash_attn/flash_attn.py:74"),
}
PHASES = ("kernels", "micro", "main", "workload", "tpch", "legacy", "shard", "serve",
          "scan", "mesh", "train")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (serve: "
                         f"gemma2-27b prefill and decode on the flash_attn kernel)")
    ap.add_argument("--profile", action="store_true",
                    help="run the main phase under torch.profiler, and the serve "
                         "and train phases once more under it, and report device "
                         "time by kernel")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases: {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(BUILD_DIR, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR, "triton"))

    from repro_torch.core.params import paper_params
    from repro_torch.engine.backend import BFVBackend
    from repro_torch.engine.planner import Planner

    # wall seconds of each phase that ran, kernel build in `env`
    phase_s, last = {}, [time.perf_counter()]

    def mark(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = round(now - last[0], 3)
        last[0] = now

    phase_env()
    mark("env")
    paper = (paper_params() if phases & {"kernels", "main", "workload", "tpch", "legacy", "shard"}
             else None)
    timings = phase_kernels(paper) if "kernels" in phases else {}
    if "kernels" in phases:
        mark("kernels")
    if "micro" in phases:
        phase_micro()
        mark("micro")
    # launch counts per driven path, each set to 0 just before it runs
    by_path = {}
    bk = db = q1_stats = None
    if "main" in phases:
        by_path["main"], bk, db = phase_main(paper, profile=args.profile)
        mark("main")
    if "workload" in phases:
        if bk is None:           # reuse main's keys and table when main ran
            bk, db, _ = load_paper_lineitem(paper)
        with _beside(workload_mock) as mock:
            by_path["workload_q1_bfv"], q1_stats = workload_q1_bfv(bk, db)
            by_path["workload_mock"] = _report(*mock())
        mark("workload")
    db = None                    # the tpch and shard phases load their own tables
    if "tpch" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        if bk is None:           # reuse the earlier phases' keys when they ran
            bk = BFVBackend(paper, seed=SEED)
        by_path["tpch"] = phase_tpch(bk)
        mark("tpch")
    if "legacy" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        if bk is None:           # reuse the earlier phases' keys when they ran
            bk = BFVBackend(paper, seed=SEED)
        by_path["legacy"] = phase_legacy(bk)
        mark("legacy")
    if "shard" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        if bk is None:           # reuse the earlier phases' keys when they ran
            bk = BFVBackend(paper, seed=SEED)
        with _beside(shard_chaos_mock) as chaos:
            by_path["shard_q1_bfv"] = shard_q1_bfv(paper, bk, before_costs=chaos)
        bk = None
        by_path["shard_chaos_mock"] = _report(*chaos())
        mark("shard")
    if "serve" in phases:
        bk = db = None           # the BFV phases' keys and table hold ~33 GB
        gc.collect()
        torch.cuda.empty_cache()
        by_path["serve"] = phase_serve(profile=args.profile)
        mark("serve")
    if "scan" in phases:
        bk = db = None
        gc.collect()
        torch.cuda.empty_cache()
        by_path["scan"], scan_times = phase_scan()
        mark("scan")
        for name, at in scan_times.items():
            timings.setdefault(name, {}).setdefault("at_shapes", {}).update(at)
    if "mesh" in phases:
        if q1_stats is None:     # the unsharded Q1's OpStats, when workload did not run
            bk, db, _ = load_paper_lineitem(paper_params())
            q1_stats = _via_plan(bk, Planner(db, optimized=True))["op_stats"]
        bk = db = None           # the four ranks hold ~13 GB each
        gc.collect()
        torch.cuda.empty_cache()
        by_path["mesh"], by_path["mesh_scan"] = phase_mesh(q1_stats)
        mark("mesh")
    if "train" in phases:
        bk = db = None
        gc.collect()
        torch.cuda.empty_cache()
        by_path["train"], train_times = phase_train(profile=args.profile)
        mark("train")
        for name, at in train_times.items():
            timings.setdefault(name, {}).setdefault("at_shapes", {}).update(at)

    records = []
    for name, (source, replaces) in KERNEL_META.items():
        rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(counts.get(name, 0) for counts in by_path.values()),
               "launches_by_path": {path: counts.get(name, 0)
                                    for path, counts in by_path.items()}}
        rec.update(timings.get(name, {}))
        records.append(rec)
    idle = sorted({f"{name} on {path}" for path, counts in by_path.items()
                   for name in PATH_KERNELS[path] if counts.get(name, 0) <= 0})
    if idle:
        raise AssertionError(f"kernels of a path that ran were never launched: {idle}")
    emit("phase_seconds", phase_s)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
