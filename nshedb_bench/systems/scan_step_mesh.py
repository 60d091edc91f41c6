"""The paper's encrypted equality scan, SUM(val) WHERE col = v, over one
host's cards as the system under test: the program's mesh scan loop
(`launch/nshedb_step.serve_mesh_scan`) on the configuration's ("data",
"model") mesh, one rank a card, this process rank 0.

Set-up: the program's launcher starts the other ranks, and every rank
builds its part of the loop (its mesh, the program's constants, its
shard, its chunk sized from its own card); then the mix's `warmup`
queries.

Inputs (`rank_inputs`, run on each rank): block b's column and value
ciphertexts are residues drawn on the rank's card by a torch generator
seeded from (seed, b) alone, so any rank can draw any block whole; a
rank draws the blocks the program places on it and keeps its limbs of
them.  The four keys are drawn whole from the seed and sliced as
`ks_mode` places them.  The moduli are worked out here
(`reference/scan_step.primes`).

A query hands the loop its constant v (the mix's `EQ_CONST`); the loop
subtracts Delta * v on each rank's limbs, runs the step and gathers the
(2, k, n) aggregate to rank 0.  It ends when rank 0's card has
synchronized and every rank has answered.  Launch counts are rank 0's.

The check: for the mix's `check_sample` queries of the window, drawn
from the seed, each card recomputes its group of nblocks / world blocks,
whole in limbs, with the plain reference (`scan_step.reference`:
`reference/scan_step.scan` after the same subtraction); the partials are
summed mod q and compared residue for residue with rank 0's aggregate
(limit 0 residues that differ).  `mulmod` "float64" is the control one
width below.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import traffic
from ..reference import scan_step as ref
from . import scan_step

MODULE = "nshedb_bench.systems.scan_step_mesh"
KEYS = ("rlk_b", "rlk_a", "gk_b", "gk_a")


def moduli(cfg: dict, device) -> tuple:
    """(q, Delta mod q) as (k,) int64 tensors on `device`."""
    primes = ref.primes(cfg["n"], cfg["prime_bits"], cfg["k"])
    delta = math.prod(primes) // cfg["t"]
    return (torch.tensor(primes, dtype=torch.int64, device=device),
            torch.tensor([delta % p for p in primes], dtype=torch.int64, device=device))


def _generator(device, seed: int, *key: int) -> torch.Generator:
    state = np.random.SeedSequence([seed % (1 << 64), *key]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def draw_block(cfg: dict, seed: int, block: int, q) -> torch.Tensor:
    """Block `block`'s (column, value) ciphertexts, (2, 2, k, n) residues
    below `q` on q's device, from (seed, block) alone."""
    gen = _generator(q.device, seed, 0, block)
    x = torch.randint(0, 1 << 62, (2, 2, cfg["k"], cfg["n"]), generator=gen, device=q.device)
    return x.remainder_(q[:, None])


def draw_keys(cfg: dict, seed: int, q) -> list:
    """[rlk_b, rlk_a, gk_b, gk_a], each (k, k, n) residues below `q`."""
    gen = _generator(q.device, seed, 1)
    k, n = cfg["k"], cfg["n"]
    return [torch.randint(0, 1 << 62, (k, k, n), generator=gen, device=q.device)
            .remainder_(q[:, None]) for _ in KEYS]


def rank_inputs(scan, cfg: dict, seed: int) -> dict:
    """A rank's shard (the `shard` of `serve_mesh_scan`): the blocks and
    limbs the program's placement (`step_shardings`) gives this rank of
    `scan.mesh`, and its keys' slices for `scan.mode`."""
    from repro_torch.launch.nshedb_step import local_shard, step_shardings

    q, _ = moduli(cfg, scan.device)
    place = step_shardings(scan.mesh.mesh_dim_names, scan.mode)
    blocks = local_shard(torch.arange(cfg["nblocks"]), place["cts_col"][:1], scan.mesh).tolist()
    held = [local_shard(draw_block(cfg, seed, b, q), (None,) + place["cts_col"][1:], scan.mesh)
            for b in blocks]
    out = {"cts_col": torch.stack([h[0] for h in held]),
           "cts_val": torch.stack([h[1] for h in held])}
    out.update((name, local_shard(key, place[name], scan.mesh))
               for name, key in zip(KEYS, draw_keys(cfg, seed, q)))
    return out


def rank_reference(scan, cfg: dict, seed: int, v: int, mulmod: str) -> np.ndarray:
    """The plain reference's aggregate of this card's group of blocks
    (nblocks / world of them, by rank), whole in limbs, for constant `v`."""
    world = math.prod(scan.mesh.shape)
    group = cfg["nblocks"] // world
    q, delta = moduli(cfg, scan.device)
    blocks = torch.stack([draw_block(cfg, seed, b, q)
                          for b in range(scan.rank * group, (scan.rank + 1) * group)])
    out = scan_step.reference(cfg, q, delta, blocks[:, 0], blocks[:, 1],
                              draw_keys(cfg, seed, q), v, mulmod)
    return out.numpy()


class System(scan_step.System):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, trace: bool):
        from repro_torch import kernels
        from repro_torch.configs.nshedb import NshedbConfig
        from repro_torch.launch import nshedb_step, ranks  # noqa: F401  (the launcher)

        self.cfg, self.mix, self.seed, self.trace = cfg, mix, seed, trace
        self.kernels, self.device = kernels, device
        self.mulmod = "exact"
        self.setup_parts = parts = {}
        t0 = time.perf_counter()
        pcfg = NshedbConfig(n=cfg["n"], k=cfg["k"], t=cfg["t"], eq_levels=cfg["eq_levels"],
                            rot_steps=cfg["rot_steps"])
        self.loop = nshedb_step.serve_mesh_scan(
            pcfg, cfg["mesh"]["data"], cfg["mesh"]["model"], f"{MODULE}:rank_inputs",
            (cfg, seed), ks_mode=cfg["ks_mode"], device=device)
        parts["ranks"] = time.perf_counter() - t0
        self.chunk = self.loop.worker.chunk
        self.q = moduli(cfg, "cpu")[0].numpy()
        self.outputs = {}
        t0 = time.perf_counter()
        for i in range(int(mix.get("warmup", 0))):
            self._run(traffic.query(mix, seed, "warmup", i), keep=False)
        parts["warmup"] = time.perf_counter() - t0

    def _run(self, q: dict, keep: bool = True, index: int | None = None) -> dict:
        start = time.time_ns()
        out = self.loop.call("query", q["params"]["EQ_CONST"])[0]
        end = time.time_ns()
        if keep:
            self.outputs[index] = out
        rec = {"start_ns": start, "end_ns": end, "params": q["params"]}
        if self.trace:
            rec["spans"] = [(start, end, "scan_mesh:query")]
        return rec

    def release(self) -> None:
        self.outputs = {i: o.cpu() for i, o in self.outputs.items()}
        self.loop.call("release")

    def check(self, run) -> tuple[dict, int]:
        wrong, failed = 0, 0
        try:
            for i in self.sample(len(run.queries)):
                parts = self.loop.run(f"{MODULE}:rank_reference", self.cfg, self.seed,
                                      run.queries[i]["params"]["EQ_CONST"], self.mulmod)
                exp = np.sum(parts, axis=0) % self.q[:, None]
                bad = int((self.outputs[i].numpy() != exp).sum())
                wrong += bad
                failed += bad > 0
        finally:
            self.loop.close()
        return {"residues_wrong": (wrong, 0)}, failed
