"""HE execution backends for the query engine.

One operator implementation (engine/ops.py, core/compare.py) runs against
either backend through the same method surface:

  BFVBackend  — real RNS-BFV ciphertexts (core/bfv.py).  Used by tests and
                small benchmarks; every op is genuinely homomorphic.
  MockBackend — plaintext Z_t arrays with *identical* noise accounting,
                depth tracking and op counting.  Used for full-32K-row
                TPC-H op-count studies on the CPU and as the parity
                oracle for the real backend's accounting.

Batched evaluation path
-----------------------
Both backends additionally operate on *block batches* — a whole column
of ciphertext blocks stacked on a leading axis (`CiphertextBatch` for
BFV, a (nblocks, slots) MockCipher for the mock).  `stack_blocks` /
`unstack_blocks` convert between the engine's block lists and the
batched handle; every arithmetic method accepts either form (and mixed
single × batch operands, which broadcast), so the comparison circuits in
core/compare.py evaluate an entire column per batched call instead of one
Python iteration per block.  OpStats counting is per *block*, not per
call: an op on an 8-block batch charges 8, so refresh-free profiles are
identical to the looped path.  Batches with *non-uniform* block noise
carry a per-block noise vector, and `_maybe_refresh`/`ensure_levels`
refresh only the exhausted lanes — matching the looped schedule's
refresh counts.  One approximation remains: a mid-circuit refresh hits
the stacked temporary rather than the stored column blocks (decrypted
results never differ).

Sharded execution (engine/sharded.py, DESIGN §4): when a shard context
is active on the backend, `stack_blocks` pads lane counts to a multiple
of the shard count with zero blocks (`live` on the batch keeps stats,
noise and decrypt on the logical count) and every charge is mirrored
into the context's distributed/replicated cost ledger.  Contexts that
carry a real device mesh are not supported yet and raise.

Both count operations in OpStats and track (noise, depth) per value, so
the planner's predictions are validated against the same model regardless
of backend.  A `refresh` (the paper's "bootstrapping" event: client-side
re-encryption in NSHEDB's trust model) triggers automatically whenever an
op would exhaust the invariant-noise budget — the unoptimized plans pay
these, the noise-optimized plans are expected to avoid them entirely.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.bfv import BFVContext, Ciphertext, CiphertextBatch, Keys
from ..runtime import faults
from ..core.encoder import BatchEncoder
from ..core.noise import NoiseModel, NoiseProfile, paper_profile
from ..core.params import HEParams

_MESH_MSG = ("shard contexts with a real device mesh arrive with the port of "
             "the sharded execution slice")


@dataclasses.dataclass
class OpStats:
    """Homomorphic-operation counters (the engine's "profile")."""

    mul: int = 0            # ct x ct multiply (incl. relinearization)
    mul_plain: int = 0      # ct x plaintext-vector multiply
    mul_scalar: int = 0     # ct x constant multiply (no NTT)
    add: int = 0            # ct +- ct / plain
    rotate: int = 0         # Galois rotation (incl. key switch)
    encrypt: int = 0
    decrypt: int = 0
    refresh: int = 0        # noise-budget exhaustion events ("bootstraps")
    max_depth: int = 0      # deepest multiplicative chain observed
    launches: int = 0       # primitive *calls* (a batched op over N blocks
                            # is 1 launch but charges N to the op counters)

    def clone(self) -> "OpStats":
        return dataclasses.replace(self)

    def merged(self, other: "OpStats") -> "OpStats":
        out = self.clone()
        for f in dataclasses.fields(OpStats):
            if f.name == "max_depth":
                out.max_depth = max(out.max_depth, other.max_depth)
            else:
                setattr(out, f.name, getattr(out, f.name) + getattr(other, f.name))
        return out

    def cost_seconds(self, costs: dict[str, float]) -> float:
        """Wall-clock model: sum(count * per-op seconds)."""
        return sum(getattr(self, k) * v for k, v in costs.items() if hasattr(self, k))

    def reset(self) -> None:
        for f in dataclasses.fields(OpStats):
            setattr(self, f.name, 0)


class _BackendBase:
    """Shared bookkeeping: budget checks, refresh policy, stats."""

    def __init__(self) -> None:
        self.stats = OpStats()
        self.auto_refresh = True   # refresh (count a bootstrap) on exhaustion
        self.refresh_log: list[str] = []
        # Active ShardContext (engine/sharded.py) or None.  When set,
        # stack_blocks pads lane counts to the shard count and every
        # charge is mirrored into the context's distribution ledger.
        self.shard_ctx = None
        from collections import Counter
        self.op_log = Counter()    # operator-level counts (eq/cmp/sum/...)

    # -- subclass must provide -------------------------------------------
    t: int
    slots: int
    model: NoiseModel

    def _nblocks(self, ct) -> int:
        """Blocks carried by a value: batches charge per-block stats.
        Reports *live* blocks — shard padding lanes are never counted."""
        raise NotImplementedError

    def _nblocks_phys(self, ct) -> int:
        """Physical lanes incl. shard padding (device-time accounting)."""
        return self._nblocks(ct)

    def _count(self, *cts) -> int:
        self.stats.launches += 1
        return max(self._nblocks(c) for c in cts)

    def _charge_units(self, field: str, units: int,
                      phys_units: int | None = None,
                      distributed: bool = False) -> None:
        """Charge `units` to stats.<field>; mirror into the shard ledger
        (physical units — pads occupy device lanes) when one is active."""
        setattr(self.stats, field, getattr(self.stats, field) + units)
        if self.shard_ctx is not None and units:
            self.shard_ctx.record(
                field, phys_units if phys_units is not None else units,
                distributed)

    def _charge(self, field: str, *cts, mult: int = 1) -> None:
        """The standard per-op charge: one launch, max-blocks units."""
        units = self._count(*cts) * mult
        phys = max(self._nblocks_phys(c) for c in cts) * mult
        dist = any(self._nblocks_phys(c) > 1 for c in cts)
        self._charge_units(field, units, phys, dist)

    def _charge_gather(self, *cts, mult: int = 1) -> None:
        """Mirror a key-switch digit all-gather into the 2-D shard
        ledger (model-axis bytes, ShardContext.record_gather): one unit
        per physical block lane per key-switch.  No-op at limb_shards=1,
        so 1-D ledgers stay byte-identical; never touches OpStats, so
        op counts stay backend- and mesh-independent."""
        ctx = self.shard_ctx
        if ctx is None or getattr(ctx, "limb_shards", 1) <= 1 or mult <= 0:
            return
        ctx.record_gather(max(self._nblocks_phys(c) for c in cts) * mult)

    def _budget(self, noise):
        return self.model.budget(noise)

    def _refresh_lanes(self, ct, exhausted) -> "list[int] | None":
        """Lanes of `ct` to refresh given an elementwise exhaustion mask.
        None means 'all of it' (scalar noise, or every lane exhausted)."""
        if np.ndim(ct.noise) == 0 or self._nblocks(ct) == 1:
            return None
        mask = np.broadcast_to(np.asarray(exhausted), (self._nblocks(ct),))
        lanes = [i for i in range(self._nblocks(ct)) if mask[i]]
        return None if len(lanes) == self._nblocks(ct) else lanes

    def _charge_refresh(self, ct, lanes, what: str) -> None:
        n = self._nblocks(ct) if lanes is None else len(lanes)
        self._charge_units("refresh", n, n, self._nblocks_phys(ct) > 1)
        self.refresh_log.append(what)

    def _maybe_refresh(self, ct, post_noise, what: str):
        """If the upcoming op would exhaust the budget, refresh `ct` first.

        Refreshes mutate the ciphertext IN PLACE: every plan-DAG edge that
        still references this value sees the refreshed version, exactly as
        a real engine bootstraps a value once (not per consumer).  With a
        per-block noise vector, only the exhausted lanes are refreshed.
        """
        exhausted = np.asarray(self._budget(post_noise)) <= 0
        if not exhausted.any():
            return ct
        if not self.auto_refresh:
            raise RuntimeError(
                f"noise budget exhausted in {what} "
                f"(post-op budget {float(np.min(self._budget(post_noise))):.1f} bits)")
        lanes = self._refresh_lanes(ct, exhausted)
        self._charge_refresh(ct, lanes, what)
        self.refresh_inplace(ct, lanes)
        return ct

    def _track_depth(self, d: int) -> int:
        self.stats.max_depth = max(self.stats.max_depth, d)
        return d

    def set_depth(self, ct, d: int) -> None:
        """Restore a handle's tracked multiplicative chain length after
        noise maintenance that must stay depth-neutral (the planner's
        inject admission).  Never raises the run's max-depth watermark."""
        ct.depth = d

    def fingerprint(self, ct) -> int | None:
        """Content hash of a ciphertext handle for at-rest integrity
        checks (WorkloadCache poison detection), or None when handles
        are opaque.  Real BFV returns None: `refresh_inplace`
        re-encrypts the payload under fresh randomness, so no stable
        content hash can survive legitimate noise maintenance."""
        return None

    def levels_left(self, ct) -> int:
        noise = ct.noise if hasattr(ct, "noise") else ct
        return self.model.levels_left(noise)

    def ensure_levels(self, ct, levels: int):
        """Planned refresh (§2.1.1 'selectively apply bootstrapping'): if
        the ciphertext cannot absorb `levels` more multiplications, refresh
        it *once* here rather than thrashing mid-circuit.  Per-block noise
        vectors refresh only the lanes that are actually short."""
        what = f"planned(levels={levels})"
        if np.ndim(ct.noise) and self._nblocks(ct) > 1:
            per = np.asarray(ct.noise)
            short = np.array([self.model.levels_left(float(per[i])) < levels
                              for i in range(self._nblocks(ct))])
            if not short.any():
                return ct
            lanes = self._refresh_lanes(ct, short)
            self._charge_refresh(ct, lanes, what)
            self.refresh_inplace(ct, lanes)
            return ct
        if self.levels_left(ct) >= levels:
            return ct
        self._charge_refresh(ct, None, what)
        self.refresh_inplace(ct, None)
        return ct

    # convenience aliases used by compare.py ------------------------------
    def sub_scalar(self, a, c: int):
        return self.add_scalar(a, -c % self.t)

    # shared slot-movement compositions ----------------------------------
    def sum_slots(self, a):
        """All slots <- total sum (log2(n) rotate+add, paper §4.2.2)."""
        out = a
        step = 1
        while step < self.slots // 2:
            out = self.add(out, self.rotate(out, step))
            step *= 2
        return self.add(out, self.swap_rows(out))

    def broadcast_slot(self, a, i: int):
        """Extract slot i then replicate everywhere (paper §2.1.6)."""
        basis = np.zeros(self.slots, dtype=np.int64)
        basis[i] = 1
        return self.sum_slots(self.mul_plain(a, basis))


# ---------------------------------------------------------------------------
# Real-ciphertext backend.
# ---------------------------------------------------------------------------

class BFVBackend(_BackendBase):
    def __init__(self, params: HEParams, seed: int = 0, device="cuda"):
        super().__init__()
        self.params = params
        self.t = params.t
        self.slots = params.n
        self.ctx = BFVContext(params, seed=seed, device=device)
        self.keys: Keys = self.ctx.keygen()
        self.enc = BatchEncoder(params)
        self.model = self.ctx.noise_model
        self.limbs = params.k          # RNS tower height (model-axis extent)
        self._depth: dict[int, int] = {}

    def _limb_mesh(self):
        """The active context's 2-D mesh iff key-switches should
        all-gather over a real model axis (engine/sharded.py)."""
        ctx = self.shard_ctx
        return ctx.limb_mesh if ctx is not None else None

    def _nblocks(self, ct) -> int:
        return ct.nblocks if isinstance(ct, CiphertextBatch) else 1

    def _nblocks_phys(self, ct) -> int:
        return ct.nphys if isinstance(ct, CiphertextBatch) else 1

    # -- depth side-table (Ciphertext is a frozen-ish dataclass) ----------
    def _d(self, ct) -> int:
        return self._depth.get(id(ct), 0)

    def _set_d(self, ct, d: int):
        self._depth[id(ct)] = self._track_depth(d)
        return ct

    # -- block batching ---------------------------------------------------
    def stack_blocks(self, blocks: list) -> CiphertextBatch:
        """Stack a column's block list for one batched call (pure layout).

        Under an active ShardContext the lane count is padded up to a
        multiple of the shard count with zero blocks (exact additive
        identities; `live` keeps accounting on the logical count) —
        uneven tables compile to one even launch."""
        batch = self.ctx.stack_cts(blocks)
        ctx = self.shard_ctx
        if (ctx is not None and len(blocks) > 1
                and (ctx.shards > 1 or ctx.limb_mesh is not None)):
            from .sharded import pad_to
            if ctx.mesh is not None:
                raise NotImplementedError(_MESH_MSG)
            nphys = pad_to(len(blocks), ctx.shards)
            data = batch.data
            if nphys > len(blocks):
                pad = torch.zeros_like(batch.data[:1])
                data = torch.cat(
                    [batch.data] + [pad] * (nphys - len(blocks)))
            batch = CiphertextBatch(data, batch.noise, batch.params,
                                    live=len(blocks))
        return self._set_d(batch, max(self._d(b) for b in blocks))

    def unstack_blocks(self, batch: CiphertextBatch) -> list:
        d = self._d(batch)
        return [self._set_d(ct, d) for ct in self.ctx.unstack_cts(batch)]

    def fold_blocks(self, batch: CiphertextBatch) -> Ciphertext:
        """Cross-block sum of a batch (the inter-block half of SUM/COUNT).
        Charges the same nblocks-1 adds as the sequential fold."""
        faults.maybe_device_loss("fold")
        ctx = self.shard_ctx
        self.stats.add += max(batch.nblocks - 1, 0)
        self.stats.launches += 1
        if ctx is not None:
            # ledger: shard-local adds + one psum tree (record_fold owns
            # the split; stats.add above stays the sequential-fold charge)
            ctx.record_fold(batch.nblocks, self._nblocks_phys(batch))
        if ctx is not None and ctx.mesh is not None:
            raise NotImplementedError(_MESH_MSG)
        out = self.ctx.fold_add(batch)
        return self._set_d(out, self._d(batch))

    # -- io ----------------------------------------------------------------
    def encrypt(self, vec) -> Ciphertext:
        self.stats.encrypt += 1
        v = np.zeros(self.slots, dtype=np.int64)
        arr = np.asarray(vec, dtype=np.int64) % self.t
        v[: len(arr)] = arr
        return self._set_d(self.ctx.encrypt(self.enc.encode(v), self.keys.pk), 0)

    def decrypt(self, ct) -> np.ndarray:
        self.stats.decrypt += self._nblocks(ct)
        polys = self.ctx.decrypt(ct, self.keys.sk).cpu().numpy()
        if isinstance(ct, CiphertextBatch):
            # live lanes only: shard padding never reaches the client
            return np.stack([self.enc.decode(polys[i])
                             for i in range(ct.nblocks)])
        return self.enc.decode(polys)

    def refresh(self, ct: Ciphertext) -> Ciphertext:
        """Client-side re-encryption (NSHEDB's trust model allows it; the
        engine's planner exists to make sure this is never reached)."""
        return self.encrypt(self.decrypt(ct))

    def refresh_inplace(self, ct, lanes: list | None = None) -> None:
        if isinstance(ct, CiphertextBatch):
            if lanes is not None:
                # partial: refresh only the exhausted lanes of the batch
                per = (np.asarray(ct.noise, dtype=np.float64).copy()
                       if np.ndim(ct.noise)
                       else np.full(ct.nblocks, float(ct.noise)))
                data = ct.data.clone()    # handles alias: never edit in place
                for i in lanes:
                    fb = self.refresh(Ciphertext(ct.data[i], float(per[i]),
                                                 self.params))
                    data[i] = fb.data
                    per[i] = fb.noise
                ct.data, ct.noise = data, self.ctx.pack_noises(list(per))
                return  # depth unchanged: un-refreshed lanes keep history
            fresh = [self.refresh(b) for b in self.ctx.unstack_cts(ct)]
            batch = self.ctx.stack_cts(fresh)
            if ct.nphys > batch.nphys:  # padded: keep the zero pad lanes
                ct.data = torch.cat([batch.data, ct.data[batch.nphys:]])
                ct.noise = batch.noise
            else:
                ct.data, ct.noise = batch.data, batch.noise
        else:
            fresh = self.refresh(ct)
            ct.data = fresh.data
            ct.noise = fresh.noise
        self._depth[id(ct)] = 0

    def budget(self, ct) -> float:
        return ct.budget

    def depth(self, ct) -> int:
        return self._d(ct)

    def set_depth(self, ct, d: int) -> None:
        self._depth[id(ct)] = d

    # -- ring ops ------------------------------------------------------------
    def add(self, a, b):
        self._charge("add", a, b)
        return self._set_d(self.ctx.add(a, b), max(self._d(a), self._d(b)))

    def sub(self, a, b):
        self._charge("add", a, b)
        return self._set_d(self.ctx.sub(a, b), max(self._d(a), self._d(b)))

    def neg(self, a):
        return self._set_d(self.ctx.neg(a), self._d(a))

    def mul(self, a, b):
        post = self.model.keyswitch(self.model.mul(a.noise, b.noise))
        if np.any(np.asarray(self._budget(post)) <= 0):
            a = self._maybe_refresh(a, post, "mul")
            b = self._maybe_refresh(b, self.model.keyswitch(
                self.model.mul(a.noise, b.noise)), "mul")
        self._charge("mul", a, b)
        self._charge_gather(a, b)
        out = self.ctx.mul(a, b, self.keys.rlk, mesh=self._limb_mesh())
        return self._set_d(out, max(self._d(a), self._d(b)) + 1)

    def mul_plain(self, a, vec):
        post = self.model.mul_plain(a.noise)
        a = self._maybe_refresh(a, post, "mul_plain")
        self._charge("mul_plain", a)
        arr = np.asarray(vec, dtype=np.int64) % self.t
        if arr.ndim == 2:
            # per-block plaintexts against a batch (fused broadcast_slot):
            # zero rows cover any shard padding lanes
            nphys = self._nblocks_phys(a)
            rows = np.zeros((nphys, self.slots), dtype=np.int64)
            rows[: arr.shape[0], : arr.shape[1]] = arr
            poly = np.stack([self.enc.encode(r) for r in rows])
        else:
            poly = self.enc.encode(arr)
        return self._set_d(self.ctx.mul_plain(a, poly), self._d(a) + 1)

    def add_plain(self, a, vec):
        self._charge("add", a)
        poly = self.enc.encode(np.asarray(vec, dtype=np.int64) % self.t)
        return self._set_d(self.ctx.add_plain(a, poly), self._d(a))

    def mul_scalar(self, a, c: int):
        self._charge("mul_scalar", a)
        return self._set_d(self.ctx.mul_scalar(a, c), self._d(a))

    def add_scalar(self, a, c: int):
        self._charge("add", a)
        return self._set_d(self.ctx.add_scalar(a, c), self._d(a))

    def sub_from_scalar(self, c: int, a):
        self._charge("add", a)
        return self._set_d(self.ctx.sub_from_scalar(c, a), self._d(a))

    def dot_plain(self, cts: list, coeffs) -> Ciphertext:
        """sum_i coeffs[i] * cts[i] — the BSGS baby-step inner product.
        Same accounting as len(cts) mul_scalar + adds."""
        acc = None
        for ct, c in zip(cts, coeffs):
            c = int(c) % self.t
            if c == 0:
                continue
            term = self.mul_scalar(ct, c)
            acc = term if acc is None else self.add(acc, term)
        assert acc is not None
        return acc

    # -- data movement ---------------------------------------------------
    def rotate(self, a, step: int):
        """Rotate rows (2 x n/2 layout) left by step."""
        hops = bin(step % (self.slots // 2)).count("1")
        self._charge("rotate", a, mult=hops)
        self._charge_gather(a, mult=hops)      # one kswitch per pow-2 hop
        return self._set_d(
            self.ctx.rotate_rows(a, step, self.keys.gks,
                                 mesh=self._limb_mesh()), self._d(a))

    def swap_rows(self, a):
        self._charge("rotate", a)
        self._charge_gather(a)
        return self._set_d(
            self.ctx.swap_rows(a, self.keys.gks, mesh=self._limb_mesh()),
            self._d(a))


# ---------------------------------------------------------------------------
# Mock backend: Z_t arrays, same accounting.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MockCipher:
    vec: np.ndarray          # (slots,) — or (nblocks, slots) for a batch
    noise: "float | np.ndarray"   # log2 |invariant noise|, per-block if array
    depth: int = 0
    live: int | None = None  # logical blocks when shard-padded (see bfv.py)

    def __post_init__(self):
        self.vec = np.asarray(self.vec, dtype=np.int64)


class MockBackend(_BackendBase):
    """Executes the operator DAG on plaintext arrays mod t while charging
    the exact same noise/ops as the BFV path.  The paper-scale profile
    (n=32768, k=30 limbs) is the default.

    `kernel_reduce=True` (the data half of `sum_slots` through a
    rotate-reduce kernel, one launch for all log2(n) doubling stages)
    raises NotImplementedError until that kernel is ported."""

    def __init__(self, profile: NoiseProfile | None = None, *,
                 kernel_reduce: bool = False):
        super().__init__()
        self.profile = profile or paper_profile()
        self.t = self.profile.t
        self.slots = self.profile.n
        self.model = NoiseModel(self.profile)
        self.limbs = self.profile.k    # RNS tower height (model-axis extent)
        if kernel_reduce:
            raise NotImplementedError(
                "kernel_reduce=True needs the rotate_reduce kernel, which "
                "is not ported yet")

    def _nblocks(self, ct) -> int:
        if ct.vec.ndim != 2:
            return 1
        return ct.live if ct.live is not None else ct.vec.shape[0]

    def _nblocks_phys(self, ct) -> int:
        return ct.vec.shape[0] if ct.vec.ndim == 2 else 1

    @staticmethod
    def _live(*cts) -> int | None:
        """live marker the result of an op inherits (batched operand's)."""
        for c in cts:
            if c.vec.ndim == 2 and c.live is not None:
                return c.live
        return None

    @staticmethod
    def _pack_noises(noises: list) -> "float | np.ndarray":
        vals = [float(v) for v in noises]
        if all(v == vals[0] for v in vals):
            return vals[0]
        return np.asarray(vals, dtype=np.float64)

    # -- block batching ---------------------------------------------------
    def stack_blocks(self, blocks: list) -> MockCipher:
        assert all(b.vec.ndim == 1 for b in blocks)
        vec = np.stack([b.vec for b in blocks])
        live = None
        ctx = self.shard_ctx
        if ctx is not None and ctx.shards > 1 and len(blocks) > 1:
            from .sharded import pad_to
            nphys = pad_to(len(blocks), ctx.shards)
            if nphys > len(blocks):
                vec = np.concatenate(
                    [vec, np.zeros((nphys - len(blocks), self.slots),
                                   dtype=np.int64)])
            live = len(blocks)
        return MockCipher(vec, self._pack_noises([b.noise for b in blocks]),
                          max(b.depth for b in blocks), live)

    def unstack_blocks(self, batch: MockCipher) -> list:
        per = batch.noise if np.ndim(batch.noise) else None
        return [MockCipher(batch.vec[i].copy(),
                           float(per[i]) if per is not None else batch.noise,
                           batch.depth)
                for i in range(self._nblocks(batch))]

    def fold_blocks(self, batch: MockCipher) -> MockCipher:
        faults.maybe_device_loss("fold")
        nb = self._nblocks(batch)
        self.stats.add += max(nb - 1, 0)
        self.stats.launches += 1
        if self.shard_ctx is not None:
            self.shard_ctx.record_fold(nb, self._nblocks_phys(batch))
        per = batch.noise if np.ndim(batch.noise) else None
        noise = float(per[0]) if per is not None else batch.noise
        for i in range(1, nb):
            noise = self.model.add(
                noise, float(per[i]) if per is not None else batch.noise)
        # live lanes only: pads may hold garbage after broadcasted ops
        return MockCipher(batch.vec[:nb].sum(axis=0) % self.t, noise,
                          self._track_depth(batch.depth))

    # -- io ----------------------------------------------------------------
    def encrypt(self, vec) -> MockCipher:
        self.stats.encrypt += 1
        v = np.zeros(self.slots, dtype=np.int64)
        arr = np.asarray(vec, dtype=np.int64) % self.t
        v[: len(arr)] = arr
        return MockCipher(v, self.model.fresh(), 0)

    def decrypt(self, ct: MockCipher) -> np.ndarray:
        self.stats.decrypt += self._nblocks(ct)
        if ct.vec.ndim == 2:
            return ct.vec[: self._nblocks(ct)].copy()
        return ct.vec.copy()

    def refresh(self, ct: MockCipher) -> MockCipher:
        return MockCipher(ct.vec.copy(), self.model.fresh(), 0, ct.live)

    def refresh_inplace(self, ct: MockCipher, lanes: list | None = None) -> None:
        if lanes is not None and np.ndim(ct.noise):
            per = np.asarray(ct.noise, dtype=np.float64).copy()
            per[lanes] = self.model.fresh()
            ct.noise = self._pack_noises(list(per))
            return  # depth unchanged: un-refreshed lanes keep history
        ct.noise = self.model.fresh()
        ct.depth = 0

    def budget(self, ct: MockCipher) -> float:
        return self.model.min_budget(ct.noise)

    def depth(self, ct: MockCipher) -> int:
        return ct.depth

    def fingerprint(self, ct: MockCipher) -> int:
        """Mock handles expose stable content: every op builds a new
        MockCipher and `refresh_inplace` rewrites only noise/depth, so
        the vec hash changes iff the payload was tampered with."""
        return faults.crc_array(ct.vec)

    # -- ring ops ------------------------------------------------------------
    def add(self, a, b):
        self._charge("add", a, b)
        return MockCipher((a.vec + b.vec) % self.t,
                          self.model.add(a.noise, b.noise),
                          self._track_depth(max(a.depth, b.depth)),
                          self._live(a, b))

    def sub(self, a, b):
        self._charge("add", a, b)
        return MockCipher((a.vec - b.vec) % self.t,
                          self.model.add(a.noise, b.noise),
                          self._track_depth(max(a.depth, b.depth)),
                          self._live(a, b))

    def neg(self, a):
        return MockCipher((-a.vec) % self.t, a.noise, a.depth, self._live(a))

    def mul(self, a, b):
        post = self.model.keyswitch(self.model.mul(a.noise, b.noise))
        if np.any(np.asarray(self._budget(post)) <= 0):
            a = self._maybe_refresh(a, post, "mul")
            b = self._maybe_refresh(
                b, self.model.keyswitch(self.model.mul(a.noise, b.noise)), "mul")
        self._charge("mul", a, b)
        self._charge_gather(a, b)
        return MockCipher((a.vec * b.vec) % self.t,
                          self.model.keyswitch(self.model.mul(a.noise, b.noise)),
                          self._track_depth(max(a.depth, b.depth) + 1),
                          self._live(a, b))

    def mul_plain(self, a, vec):
        a = self._maybe_refresh(a, self.model.mul_plain(a.noise), "mul_plain")
        self._charge("mul_plain", a)
        arr = np.asarray(vec, dtype=np.int64) % self.t
        if arr.ndim == 2:
            # per-block plaintexts against a batch (fused broadcast_slot):
            # zero rows cover any shard padding lanes
            v = np.zeros((self._nblocks_phys(a), self.slots), dtype=np.int64)
            v[: arr.shape[0], : arr.shape[1]] = arr
        else:
            v = np.zeros(self.slots, dtype=np.int64)
            v[: len(arr)] = arr
        return MockCipher((a.vec * v) % self.t, self.model.mul_plain(a.noise),
                          self._track_depth(a.depth + 1), self._live(a))

    def add_plain(self, a, vec):
        self._charge("add", a)
        v = np.zeros(self.slots, dtype=np.int64)
        arr = np.asarray(vec, dtype=np.int64) % self.t
        v[: len(arr)] = arr
        return MockCipher((a.vec + v) % self.t, self.model.add(a.noise, a.noise),
                          a.depth, self._live(a))

    def mul_scalar(self, a, c: int):
        self._charge("mul_scalar", a)
        return MockCipher((a.vec * (c % self.t)) % self.t,
                          self.model.mul_scalar(a.noise, c), a.depth,
                          self._live(a))

    def add_scalar(self, a, c: int):
        self._charge("add", a)
        return MockCipher((a.vec + c) % self.t,
                          self.model.add(a.noise, a.noise), a.depth,
                          self._live(a))

    def sub_from_scalar(self, c: int, a):
        self._charge("add", a)
        return MockCipher((c - a.vec) % self.t,
                          self.model.add(a.noise, a.noise), a.depth,
                          self._live(a))

    def dot_plain(self, cts: list, coeffs) -> MockCipher:
        """Vectorized sum_i coeffs[i]*cts[i]; charged as the equivalent
        mul_scalar/add sequence so op counts stay backend-independent."""
        cs = np.asarray(coeffs, dtype=np.int64) % self.t
        nz = [i for i in range(len(cts)) if cs[i] != 0]
        assert nz, "all-zero dot"
        used = [cts[i] for i in nz]
        nb = self._count(*used)
        phys = max(self._nblocks_phys(c) for c in used)
        dist = any(self._nblocks_phys(c) > 1 for c in used)
        self._charge_units("mul_scalar", len(nz) * nb, len(nz) * phys, dist)
        self._charge_units("add", max(0, len(nz) - 1) * nb,
                           max(0, len(nz) - 1) * phys, dist)
        out = None
        for i in nz:                       # products < 2^34, running sums
            term = cts[i].vec * cs[i]      # < 2^34 * 2^15 — exact int64
            out = term if out is None else out + term
        out = out % self.t
        noises = [self.model.mul_scalar(cts[i].noise, int(cs[i])) for i in nz]
        depth = max(cts[i].depth for i in nz)
        return MockCipher(out, self.model.add_many(noises),
                          self._track_depth(depth), self._live(*used))

    # -- data movement ---------------------------------------------------
    def rotate(self, a, step: int):
        """Row-rotation semantics matching the BFV 2 x n/2 slot layout."""
        hops = bin(step % (self.slots // 2)).count("1")
        self._charge("rotate", a, mult=hops)
        self._charge_gather(a, mult=hops)
        half = self.slots // 2
        vec = np.concatenate([np.roll(a.vec[..., :half], -step, axis=-1),
                              np.roll(a.vec[..., half:], -step, axis=-1)], axis=-1)
        return MockCipher(vec, self.model.rotate(a.noise), a.depth, self._live(a))

    def swap_rows(self, a):
        self._charge("rotate", a)
        self._charge_gather(a)
        half = self.slots // 2
        vec = np.concatenate([a.vec[..., half:], a.vec[..., :half]], axis=-1)
        return MockCipher(vec, self.model.rotate(a.noise), a.depth, self._live(a))


Backend = Any  # duck type: BFVBackend | MockBackend
