"""The paper's encrypted equality scan, SUM(val) WHERE col = v, as the
system under test: the program's `launch/nshedb_step.query_step` on
`nblocks` ciphertext blocks.

Set-up: the program's constants (`make_constants`: its RNS tables and
Galois permutation); the column and value blocks and the four keys drawn
as residues on the device from the seed, below the moduli the benchmark
works out itself (`reference/scan_step.primes`); the chunk of blocks a
pass takes, asked of the program once (`default_chunk`) and kept for
every query; and the mix's `warmup` queries.

A query draws its constant v (the mix's `EQ_CONST`) and hands the step
the column minus v, as BFV subtracts a plaintext constant: Delta * v
taken from the first component, limb by limb, Delta = floor(Q / t).
The step's (2, k, n) aggregate is kept, and the query ends in a
synchronize.

The check: the mix's `check_sample` queries of the window, drawn from
the seed, recomputed by `reference/scan_step.scan` from the same inputs,
residue for residue (limit 0 residues that differ).
"""
from __future__ import annotations

import math
import time

import torch

from .. import traffic
from ..reference import scan_step as ref
from . import sync


def draw_inputs(cfg: dict, seed: int, device) -> tuple:
    """(q, Delta mod q, column blocks, value blocks, [rlk_b, rlk_a, gk_b,
    gk_a]): the moduli worked out here, and residues below them drawn on
    `device` by a torch generator seeded from `seed`."""
    n, k, nb = cfg["n"], cfg["k"], cfg["nblocks"]
    primes = ref.primes(n, cfg["prime_bits"], k)
    q = torch.tensor(primes, dtype=torch.int64, device=device)
    big_q = math.prod(primes)
    delta = torch.tensor([big_q // cfg["t"] % p for p in primes], dtype=torch.int64,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))

    def draw(*lead):
        x = torch.randint(0, 1 << 62, lead + (k, n), generator=gen, device=device)
        return x.remainder_(q[:, None])

    col, val = draw(nb, 2), draw(nb, 2)
    return q, delta, col, val, [draw(k) for _ in range(4)]


def minus(col, v: int, q, delta, out) -> None:
    """out[:, 0] = col[:, 0] - Delta * v mod q, limb by limb."""
    c = (delta * v % q)[:, None]
    torch.sub(col[:, 0], c, out=out[:, 0])
    out[:, 0].remainder_(q[:, None])


def reference(cfg: dict, q, delta, col, val, keys, v: int, mulmod: str = "exact"):
    """The plain reference's aggregate of the query with constant `v`."""
    col_v = col.clone()
    minus(col, v, q, delta, col_v)
    perm = torch.from_numpy(ref.galois_perm(cfg["n"])).to(col.device)
    return ref.scan(col_v, val, keys, q, perm, eq_levels=cfg["eq_levels"],
                    rot_steps=cfg["rot_steps"], mulmod=mulmod).cpu()


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, trace: bool):
        from repro_torch import kernels
        from repro_torch.configs.nshedb import NshedbConfig
        from repro_torch.launch import nshedb_step

        self.cfg, self.mix, self.seed, self.trace = cfg, mix, seed, trace
        self.kernels, self.step = kernels, nshedb_step
        self.device = device
        self.setup_parts = parts = {}
        t0 = time.perf_counter()
        pcfg = NshedbConfig(n=cfg["n"], k=cfg["k"], t=cfg["t"], eq_levels=cfg["eq_levels"],
                            rot_steps=cfg["rot_steps"])
        self.consts = nshedb_step.make_constants(pcfg, device=device)
        sync(device)
        parts["constants"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.q, self.delta, self.col, self.val, self.keys = draw_inputs(cfg, seed, device)
        self.col_v = self.col.clone()          # the column minus a query's v
        sync(device)
        parts["inputs"] = time.perf_counter() - t0
        self.chunk = nshedb_step.default_chunk(self.col, cfg["k"])
        self.outputs = {}
        t0 = time.perf_counter()
        for i in range(int(mix.get("warmup", 0))):
            self._run(traffic.query(mix, seed, "warmup", i), keep=False)
        parts["warmup"] = time.perf_counter() - t0

    def _run(self, q: dict, keep: bool = True, index: int | None = None) -> dict:
        cfg = self.cfg
        start = time.time_ns()
        minus(self.col, q["params"]["EQ_CONST"], self.q, self.delta, self.col_v)
        out = self.step.query_step(self.col_v, self.val, *self.keys, self.consts["tabs"],
                                   self.consts["perm"], eq_levels=cfg["eq_levels"],
                                   rot_steps=cfg["rot_steps"], ks_mode=cfg["ks_mode"],
                                   chunk=self.chunk)
        sync(self.device)
        end = time.time_ns()
        if keep:
            self.outputs[index] = out
        rec = {"start_ns": start, "end_ns": end, "params": q["params"]}
        if self.trace:
            rec["spans"] = [(start, end, "scan:query_step")]
        return rec

    def before_window(self) -> None:
        self.kernels.reset_launch_counts()

    def query(self, i: int) -> dict:
        return self._run(traffic.query(self.mix, self.seed, "window", i), index=i)

    def launches_by_shape(self) -> dict:
        """The kernel wrappers' launches since `before_window`, by shape."""
        from repro_torch.kernels.modops import modops

        return {k: dict(v) for k, v in modops.LAUNCHES_BY_SHAPE.items()}

    def after_window(self, run) -> None:
        run.facts.update(rows_per_query=self.cfg["nblocks"] * self.cfg["n"], chunk=self.chunk)

    def release(self) -> None:
        self.outputs = {i: o.cpu() for i, o in self.outputs.items()}
        del self.consts, self.col_v

    # -------------------------------------------------------------- check
    def sample(self, count: int) -> list:
        """The queries checked: `check_sample` of them, drawn from the seed."""
        gen = traffic.rng(self.seed, "check", 0)
        m = min(int(self.mix.get("check_sample", 1)), count)
        return sorted(int(i) for i in gen.choice(count, size=m, replace=False))

    def check(self, run) -> tuple[dict, int]:
        wrong, failed = 0, 0
        for i in self.sample(len(run.queries)):
            exp = reference(self.cfg, self.q, self.delta, self.col, self.val, self.keys,
                            run.queries[i]["params"]["EQ_CONST"])
            bad = int((self.outputs[i] != exp).sum())
            wrong += bad
            failed += bad > 0
        return {"residues_wrong": (wrong, 0)}, failed
