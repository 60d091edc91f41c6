"""Deterministic fault injection + the typed execution-fault taxonomy.

NSHEDB's correctness hinges on the planner's noise predictions holding
at runtime: one under-predicted level means silent garbage at decrypt,
a device lost mid-`sharded_fold` kills the query, a poisoned cache
entry corrupts every consumer.  This module gives the engine (a) a
typed fault vocabulary so every failure is *reported*, never silent,
and (b) a deterministic injection harness so the chaos suite can force
each failure class and assert the recovery contract of DESIGN.md §9:

    every injected fault ends in either a byte-identical result or a
    typed ExecutionFault — zero silent wrong answers.

Injection is scoped, not ambient: `with inject(FaultPlan(...)):` arms
the hooks; outside the context every hook is a cheap no-op, so the
production path pays one attribute read per guard site.  A FaultPlan is
deterministic by construction — faults fire on fixed call counts, never
on randomness or wall-clock — which is what lets the CI chaos lane run
the same matrix on every commit.

Fault classes (see DESIGN.md §9 for the recovery contract of each):

  overflow            noise-model under-prediction -> decrypt garbage.
                      Injected by wrapping `bk.model` in an
                      UnderReportingNoiseModel (core/noise.py) that
                      hides mul growth; detected by the decrypt-boundary
                      headroom guard (`check_decrypt`) and the
                      plaintext sentinel lane (`SentinelLane`).
  device-loss         a shard worker dies mid-stage.  Injected by
                      `maybe_device_loss(stage)` hooks at executor
                      stage boundaries and inside the block fold;
                      recovered by reshard + stage-checkpoint resume.
  straggler           a worker runs slow without dying.  Injected as a
                      per-worker slowdown factor applied to the
                      synthetic heartbeats the executor derives from
                      the shard cost ledger; handled by
                      StragglerDetector exclusion + reshard.
  cache-poison        a WorkloadCache entry's ciphertext is corrupted
                      at rest.  Injected by `poison_cache`; detected by
                      content fingerprints at serve time.
  checkpoint-corrupt  a snapshot is truncated after publish.  Injected
                      by `truncate_checkpoint`; handled by
                      CheckpointManager.restore_latest_valid falling
                      back to the previous intact snapshot.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# Typed faults.
# ---------------------------------------------------------------------------

class ExecutionFault(RuntimeError):
    """Base of every typed runtime failure.  Carrying the query, stage
    and worker makes chaos-matrix assertions and operator triage
    possible without parsing messages."""

    kind = "fault"

    def __init__(self, message: str, *, query: str = "", stage: str = "",
                 worker: int | None = None, detail: dict | None = None):
        super().__init__(message)
        self.query = query
        self.stage = stage
        self.worker = worker
        self.detail = detail or {}


class NoiseOverflowFault(ExecutionFault):
    """Noise budget exhausted (or about to be) at a decrypt boundary —
    the result can not be trusted.  Raised only after bounded recovery
    (refresh-and-retry, then re-derive) failed."""

    kind = "overflow"


class DeviceLossFault(ExecutionFault):
    """A shard worker vanished mid-execution.  Recoverable while a
    viable (power-of-two) survivor mesh remains."""

    kind = "device-loss"


class StragglerFault(ExecutionFault):
    """Straggler exclusion left no viable scan mesh."""

    kind = "straggler"


class CachePoisonFault(ExecutionFault):
    """A served WorkloadCache entry failed its content fingerprint
    (strict-integrity mode; the default policy silently drops and
    re-derives instead)."""

    kind = "cache-poison"


class CheckpointCorruptFault(ExecutionFault):
    """A checkpoint snapshot is unreadable/truncated and no intact
    fallback exists (restore_latest_valid exhausts older snapshots
    before raising)."""

    kind = "checkpoint-corrupt"


# ---------------------------------------------------------------------------
# The injection plan.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultPlan:
    """One deterministic injection schedule.

    Counters are *consumed* as faults fire (a plan with
    ``device_loss_count=1`` loses a device exactly once, so the retry
    succeeds); ``events`` logs every fired fault for test assertions.
    """

    # overflow: hide `underpredict_bits` of noise growth from the model
    # on `underpredict_count` ct-ct multiplies, skipping the first
    # `underpredict_after` calls of each execution attempt.
    underpredict_bits: float = 0.0
    underpredict_count: int = 0
    underpredict_after: int = 0

    # device loss: raise DeviceLossFault when execution enters `stage`
    # ("atoms"/"where"/"aux:<name>"/"gmasks"/"aggregate"/"fold", or
    # "any"), `count` times in total.
    device_loss_stage: str | None = None
    device_loss_worker: int = 0
    device_loss_count: int = 1

    # straggler: per-worker heartbeat slowdown factors, e.g. {3: 10.0}.
    straggler_slowdown: dict = dataclasses.field(default_factory=dict)

    events: list = dataclasses.field(default_factory=list)

    def log(self, kind: str, **detail) -> None:
        self.events.append({"kind": kind, **detail})

    def fired(self, kind: str) -> int:
        return sum(1 for e in self.events if e["kind"] == kind)


_ACTIVE: FaultPlan | None = None


def active() -> FaultPlan | None:
    return _ACTIVE


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm `plan` for the duration of the with-block (not reentrant —
    one chaos scenario at a time keeps the schedule deterministic)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("fault injection is already active")
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


# ---------------------------------------------------------------------------
# Hooks the engine calls (each is a no-op when nothing is armed).
# ---------------------------------------------------------------------------

def maybe_device_loss(stage: str) -> None:
    """Raise an injected DeviceLossFault when the armed plan targets
    this stage.  Called at executor stage boundaries and at the top of
    both backends' `fold_blocks` (the mid-`sharded_fold` case)."""
    p = _ACTIVE
    if p is None or p.device_loss_stage is None or p.device_loss_count <= 0:
        return
    if p.device_loss_stage != "any" and p.device_loss_stage != stage:
        return
    p.device_loss_count -= 1
    p.log("device-loss", stage=stage, worker=p.device_loss_worker)
    raise DeviceLossFault(
        f"injected device loss: worker {p.device_loss_worker} lost during "
        f"stage '{stage}'", stage=stage, worker=p.device_loss_worker)


@contextlib.contextmanager
def tampered_noise_model(bk):
    """Install an UnderReportingNoiseModel on `bk` for one execution
    attempt when the armed plan schedules noise under-prediction.

    The tampered-call budget lives on the *plan*, so a recovery retry
    does not re-arm an already-exhausted injection — exactly the
    transient-mispredict scenario the refresh-and-retry arm targets.
    """
    p = _ACTIVE
    if p is None or p.underpredict_count <= 0 or p.underpredict_bits <= 0:
        yield None
        return
    from ..core.noise import UnderReportingNoiseModel

    def take() -> bool:
        if p.underpredict_count <= 0:
            return False
        p.underpredict_count -= 1
        p.log("underpredict", bits=p.underpredict_bits)
        return True

    wrapper = UnderReportingNoiseModel(bk.model, p.underpredict_bits,
                                       skip=p.underpredict_after, take=take)
    bk.model = wrapper
    try:
        yield wrapper
    finally:
        bk.model = wrapper.inner


def hidden_noise_bits(bk) -> float:
    """Noise growth the backend's model failed to account for (nonzero
    only under an armed under-prediction injection)."""
    return float(getattr(bk.model, "hidden_bits", 0.0))


def check_decrypt(bk, ct, *, query: str = "", stage: str = "decrypt",
                  headroom_bits: float = 0.0) -> None:
    """Decrypt-boundary headroom guard.

    The worst lane's remaining budget, minus any growth the model is
    known to be hiding, must clear `headroom_bits` — otherwise the
    plaintext under this ciphertext can not be trusted and the caller
    must recover (refresh-and-retry / re-derive) instead of decrypting
    garbage.
    """
    noise = getattr(ct, "noise", None)
    if noise is None:
        return
    b = float(np.min(np.asarray(bk.model.budget(noise))))
    hidden = hidden_noise_bits(bk)
    if b - hidden <= headroom_bits:
        raise NoiseOverflowFault(
            f"{query or '<query>'}: headroom check failed at {stage}: "
            f"budget {b:.1f} bits - {hidden:.1f} hidden <= "
            f"headroom {headroom_bits:.1f}",
            query=query, stage=stage,
            detail={"budget_bits": b, "hidden_bits": hidden})


class SentinelLane:
    """Plaintext-sentinel canary for one guarded execution.

    A known-plaintext ciphertext is squared to the run's observed
    multiplicative depth with auto-refresh disabled: if the engine's
    real depth does not fit the budget, the sentinel either exhausts
    (backend raises) or decodes wrong — both surface as a typed
    NoiseOverflowFault *before* any query result is trusted.  All
    sentinel ops run outside the accounting: OpStats are snapshot and
    restored so plan-model validation never sees the canary.
    """

    def __init__(self, bk, value: int = 2):
        self.bk = bk
        self.ct = None
        self.expected = int(value) % bk.t
        self.depth = 0

    def verify(self, depth: int, query: str = "") -> None:
        bk = self.bk
        snap = bk.stats.clone()
        prev_auto, prev_ctx = bk.auto_refresh, bk.shard_ctx
        bk.auto_refresh = False
        bk.shard_ctx = None
        try:
            if self.ct is None:
                self.ct = bk.encrypt(
                    np.full(bk.slots, self.expected, dtype=np.int64))
            while self.depth < depth:
                self.ct = bk.mul(self.ct, self.ct)
                self.expected = (self.expected * self.expected) % bk.t
                self.depth += 1
            got = int(bk.decrypt(self.ct)[0])
        except RuntimeError as e:
            if isinstance(e, ExecutionFault):
                raise
            raise NoiseOverflowFault(
                f"{query or '<query>'}: sentinel lane exhausted at depth "
                f"{self.depth}/{depth}: {e}",
                query=query, stage="sentinel") from e
        finally:
            for f in dataclasses.fields(type(snap)):
                setattr(bk.stats, f.name, getattr(snap, f.name))
            bk.auto_refresh, bk.shard_ctx = prev_auto, prev_ctx
        if got != self.expected:
            raise NoiseOverflowFault(
                f"{query or '<query>'}: sentinel decoded {got}, expected "
                f"{self.expected} at depth {self.depth} — launch noise "
                f"exceeded the model", query=query, stage="sentinel",
                detail={"depth": self.depth})


# ---------------------------------------------------------------------------
# State-corruption injectors (one-shot helpers, still logged on the plan).
# ---------------------------------------------------------------------------

def poison_cache(cache, bk, entries: int | None = 1) -> list:
    """Corrupt the ciphertext content of the first `entries` atom
    entries of a WorkloadCache in place (None = all).  Only mock
    ciphertext handles expose their content for deterministic
    tampering; the BFV handles are opaque by design."""
    keys = list(cache.entries)
    keys = keys if entries is None else keys[:entries]
    for key in keys:
        for b in cache.entries[key].blocks:
            if not hasattr(b, "vec"):
                raise NotImplementedError(
                    "poison_cache tampers mock ciphertext handles only")
            b.vec = (b.vec + 1) % bk.t
    if _ACTIVE is not None:
        _ACTIVE.log("cache-poison", entries=len(keys))
    return keys


def truncate_checkpoint(directory: str, step: int, keep_bytes: int = 16) -> str:
    """Truncate the first leaf file of a published snapshot — the
    classic partially-written-at-rest corruption (disk full, torn
    copy).  Returns the truncated file path."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    name = sorted(manifest["leaves"])[0]
    path = os.path.join(d, manifest["leaves"][name]["file"])
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
    if _ACTIVE is not None:
        _ACTIVE.log("checkpoint-truncate", step=step, leaf=name)
    return path


def fingerprint_blocks(bk, blocks) -> list | None:
    """Content fingerprints for a list of ciphertext handles, or None
    when the backend's handles are opaque (real BFV: refresh re-encrypts
    the payload, so no stable content hash exists)."""
    fp = getattr(bk, "fingerprint", None)
    if fp is None:
        return None
    out = []
    for b in blocks:
        h = fp(b)
        if h is None:
            return None
        out.append(h)
    return out


def crc_array(arr) -> int:
    """Stable content hash of a numpy payload (shape included, so a
    reshape never collides with its flat twin)."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(repr(a.shape).encode() + a.tobytes())
