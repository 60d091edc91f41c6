"""A one-table TPC-H scan query on real BFV as the system under test:
the program's `engine/executor.run_via_plan` on `BFVBackend` with one
`Planner` for the run.

Set-up: key generation at the configuration's parameters, the fact
table's raw columns drawn by `tables.generate` from the seed and handed
to the program's load and encrypt path (`Database.load_table`), the
planner, and the mix's `warmup` queries (drawn from their own stream).

A query: the mix's predicates with this query's draws, built into a
`QueryPlan` with the program's plan nodes, run through `run_via_plan`;
it returns the decrypted answer, which waits for the device.  Every
query meets a cold mask cache, as the first query after a table is
loaded or re-loaded does (the planner's cache drops its masks on a
re-load): the cache is emptied before each query, so every query
derives its masks afresh and does the same work whatever its draws.
With TPC-H's parameter domains, masks of earlier queries would otherwise
serve later ones on some seeds and not on others.

Traced runs mark the executor's stage boundaries (static verification,
then each `ExecReport.record`) on the host clock after a synchronize:
those are the spans that `atoms_s` / `aggregate_s` read and that the
idle gaps are charged to.

The check: every query of the window against `reference/scan_query.py`
over the same raw columns, exactly (limit 0 numbers that differ).
"""
from __future__ import annotations

import time

import torch

from .. import tables, traffic
from ..reference import scan_query
from . import sync


def _tensor_bytes(obj, seen: set) -> int:
    """Device bytes of a ciphertext handle's tensors: each view's own
    elements, a view seen before counted once (a column whose blocks
    share one storage with other columns is charged only its part)."""
    total = 0
    for v in vars(obj).values():
        if isinstance(v, torch.Tensor):
            key = (v.data_ptr(), v.numel(), v.element_size())
            if key not in seen:
                seen.add(key)
                total += v.numel() * v.element_size()
    return total


def columns_read(mix: dict) -> list:
    cols = [c for c, _, _ in mix.get("where", ())] + list(mix.get("group_by", ()))
    cols += [c for _, _, factors in mix["aggs"] for c, _, _ in factors]
    return sorted(set(cols))


def build_plan(mix: dict, where: list):
    """The program's `QueryPlan` of a mix with resolved predicates."""
    from repro_torch.engine.plan import Agg, And, Factor, Pred, QueryPlan

    preds = [Pred(col, op, value) for col, op, value in where]
    cond = None if not preds else preds[0] if len(preds) == 1 else And(tuple(preds))
    group = ",".join(mix.get("group_by", ())) or None
    aggs = tuple(Agg(kind, tuple(Factor(c, m, a) for c, m, a in factors), name)
                 for kind, name, factors in mix["aggs"])
    return QueryPlan(name=mix["query"], fact=mix["fact"], where=cond, group_by=group,
                     group_domain=mix.get("group_domain", 0), aggs=aggs, order_by=group)


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, trace: bool):
        from repro_torch import kernels
        from repro_torch.core.params import make_params
        from repro_torch.engine import tpch
        from repro_torch.engine.backend import BFVBackend
        from repro_torch.engine.planner import Planner
        from repro_torch.engine.storage import Database

        self.cfg, self.mix, self.seed, self.trace = cfg, mix, seed, trace
        self.kernels = kernels
        self.setup_parts = parts = {}
        t0 = time.perf_counter()
        params = make_params(n=cfg["n"], t=cfg["t"], k=cfg["k"], qbits=cfg["prime_bits"])
        bits = sorted({int(q).bit_length() for q in params.Q.primes})
        if params.k != cfg["k"] or bits != [cfg["prime_bits"]]:
            raise ValueError(f"{params.k} limbs of {bits} bits, where the configuration "
                             f"states {cfg['k']} of {cfg['prime_bits']}")
        parts["params"] = time.perf_counter() - t0
        self.bk = BFVBackend(params, seed=seed % (1 << 63), device=device)
        self.device = self.bk.device
        sync(self.device)
        parts["keygen"] = time.perf_counter() - t0 - parts["params"]
        t0 = time.perf_counter()
        fact = mix["fact"]
        self.raw = tables.generate(cfg["tables"], seed, tables=(fact,))[fact]
        nrows = int(cfg["tables"][fact])
        self.db = Database(self.bk)
        table = self.db.load_table(tpch.schemas()[fact], self.raw, nrows)
        sync(self.device)
        parts["tables_load_encrypt"] = time.perf_counter() - t0
        seen = set()
        cols = columns_read(mix)
        self.storage_bytes = sum(_tensor_bytes(ct, seen)
                                 for c in cols for ct in table.col(c).blocks)
        self.raw_bytes = nrows * len(cols) * cfg["raw_bits"] // 8
        self.pl = Planner(self.db, optimized=cfg["planner"]["optimized"],
                          verify=cfg["planner"]["verify"])
        self._marks = None
        self._patched = []
        if trace:
            self._mark_stages()
        t0 = time.perf_counter()
        for i in range(int(mix.get("warmup", 0))):
            self._run(traffic.query(mix, seed, "warmup", i))
        parts["warmup"] = time.perf_counter() - t0

    # ------------------------------------------------------------- spans
    def _mark_stages(self) -> None:
        """Record (label, time) at the end of static verification and of
        each executor stage, after a synchronize."""
        from repro_torch.engine import executor, verify

        orig_record, orig_verify = executor.ExecReport.record, verify.verify_compiled
        dev = self.device

        def record(rep, label, before, after):
            sync(dev)
            if self._marks is not None:
                self._marks.append((label, time.time_ns()))
            return orig_record(rep, label, before, after)

        def verify_compiled(*args, **kwargs):
            out = orig_verify(*args, **kwargs)
            sync(dev)
            if self._marks is not None:
                self._marks.append(("static_verify", time.time_ns()))
            return out

        executor.ExecReport.record = record
        verify.verify_compiled = verify_compiled
        self._patched = [(executor.ExecReport, "record", orig_record),
                         (verify, "verify_compiled", orig_verify)]

    # ------------------------------------------------------------ queries
    def _run(self, q: dict) -> dict:
        from repro_torch.engine import executor

        plan = build_plan(self.mix, q["where"])
        self.pl.mask_cache.clear()
        launches0 = self.bk.stats.launches
        self._marks = [] if self.trace else None
        start = time.time_ns()
        answer = executor.run_via_plan(self.pl, plan)
        sync(self.device)
        end = time.time_ns()
        rec = {"start_ns": start, "end_ns": end, "answer": answer, "where": q["where"],
               "params": q["params"], "launches": self.bk.stats.launches - launches0}
        if self._marks is not None:
            name = self.mix["query"]
            spans, stages, prev = [(start, end, name)], {}, start
            for label, t in self._marks:
                spans.append((prev, t, f"{name}:{label}"))
                stages[label] = stages.get(label, 0.0) + (t - prev) / 1e9
                prev = t
            spans.append((prev, end, f"{name}:after_stages"))
            rec["spans"], rec["stages_s"] = spans, stages
        return rec

    def before_window(self) -> None:
        self.kernels.reset_launch_counts()

    def query(self, i: int) -> dict:
        return self._run(traffic.query(self.mix, self.seed, "window", i))

    def launches_by_shape(self) -> dict:
        """The kernel wrappers' launches since `before_window`, by shape."""
        from repro_torch.kernels.modops import modops
        from repro_torch.kernels.ntt import ntt

        by_shape = {k: dict(v) for k, v in modops.LAUNCHES_BY_SHAPE.items()}
        by_shape.update({k: dict(v) for k, v in ntt.LAUNCHES_BY_ROWS.items()})
        return by_shape

    def after_window(self, run) -> None:
        run.facts.update(storage_bytes=self.storage_bytes, raw_bytes=self.raw_bytes)

    def release(self) -> None:
        for owner, attr, orig in self._patched:
            setattr(owner, attr, orig)
        self._patched = []
        del self.pl, self.db, self.bk

    # -------------------------------------------------------------- check
    def reference(self, where, modulus: int) -> dict:
        mix = self.mix
        return scan_query.answer(self.raw, self.cfg["decimal_scales"], where,
                                 mix.get("group_by", ()), mix["aggs"], modulus)

    def check(self, run) -> tuple[dict, int]:
        wrong, failed = 0, 0
        for q in run.queries:
            bad = scan_query.mismatches(q["answer"], self.reference(q["where"], self.cfg["t"]))
            wrong += bad
            failed += bad > 0
        return {"answers_wrong": (wrong, 0)}, failed
