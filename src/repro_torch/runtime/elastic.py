"""Straggler detection and elastic mesh planning.

StragglerDetector consumes per-worker step-time reports (heartbeats) and
maintains an EWMA per worker; a worker slower than `threshold` x the
fleet median for `patience` consecutive heartbeats — or silent past the
timeout — lands on the exclusion list.  The launcher feeds the exclusion
list to elastic_mesh_plan() on restart to pick the largest viable mesh
from the surviving devices, and CheckpointManager.restore() puts the
last snapshot back onto the device it is given (leaves are stored
unsharded, so any device count works).
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class WorkerStat:
    ewma: float = 0.0
    last_seen: float = 0.0
    strikes: int = 0
    reports: int = 0    # heartbeats received
    judged: int = 0     # heartbeats already consumed by evaluate()


class StragglerDetector:
    def __init__(self, threshold: float = 2.0, patience: int = 3,
                 timeout_s: float = 60.0, alpha: float = 0.3):
        self.threshold = threshold
        self.patience = patience
        self.timeout_s = timeout_s
        self.alpha = alpha
        self.workers: dict[int, WorkerStat] = {}

    def report(self, worker: int, step_time: float, now: float | None = None):
        now = time.monotonic() if now is None else now
        st = self.workers.setdefault(worker, WorkerStat())
        st.ewma = step_time if st.ewma == 0 else \
            self.alpha * step_time + (1 - self.alpha) * st.ewma
        st.last_seen = now
        st.reports += 1

    def _median(self) -> float:
        vals = sorted(w.ewma for w in self.workers.values() if w.ewma > 0)
        return vals[len(vals) // 2] if vals else 0.0

    def evaluate(self, now: float | None = None) -> list[int]:
        """Returns the exclusion list (dead or persistently slow).

        Idempotent over a heartbeat window: strikes advance only for
        workers with reports not yet judged, so calling evaluate()
        repeatedly between heartbeats never double-counts a window
        toward `patience`.  The deadness check stays unconditional — a
        silent worker has no new reports by definition.
        """
        now = time.monotonic() if now is None else now
        med = self._median()
        out = []
        for wid, st in self.workers.items():
            dead = now - st.last_seen > self.timeout_s
            if st.reports > st.judged:
                slow = med > 0 and st.ewma > self.threshold * med
                st.strikes = st.strikes + 1 if slow else 0
                st.judged = st.reports
            if dead or st.strikes >= self.patience:
                out.append(wid)
        return sorted(out)

    def reset(self, worker: int) -> None:
        """Readmission: forget a worker's history entirely (it returns
        as a blank slate after replacement/repair — stale EWMA from its
        degraded era must not bias the new incarnation)."""
        self.workers.pop(worker, None)


def elastic_mesh_plan(total_devices: int, excluded: int,
                      model_parallel: int = 16) -> dict:
    """Pick the largest (data, model) mesh from surviving devices.

    model_parallel is kept fixed (TP size is baked into layouts and must
    divide head/expert counts); the data axis absorbs the loss — the
    standard elasticity policy for TP x FSDP jobs.
    """
    alive = total_devices - excluded
    if alive < model_parallel:
        raise RuntimeError(f"only {alive} devices left, need >= {model_parallel} for TP")
    data = alive // model_parallel
    # largest power-of-two data axis keeps batch divisibility
    d = 1
    while d * 2 <= data:
        d *= 2
    used = d * model_parallel
    return {"mesh_shape": (d, model_parallel), "axes": ("data", "model"),
            "devices_used": used, "devices_idle": alive - used,
            "global_batch_scale": d}


def elastic_scan_plan(shards: int, excluded) -> dict:
    """Re-shard plan for the 1-D sharded scan mesh after exclusions.

    The scan path shards ciphertext blocks over a pure data axis, so
    unlike elastic_mesh_plan there is no TP constraint — any surviving
    power-of-two worker count is viable (power of two keeps the padded
    nblocks divisibility stable across re-shards).
    """
    dropped = set(excluded)
    alive = [w for w in range(shards) if w not in dropped]
    if not alive:
        raise RuntimeError("all scan shard workers excluded")
    d = 1
    while d * 2 <= len(alive):
        d *= 2
    return {"shards": d, "workers": alive[:d], "axes": ("data",),
            "workers_idle": len(alive) - d, "excluded": sorted(dropped)}


def elastic_limb_plan(limb_shards: int, excluded, limbs: int | None = None) -> dict:
    """Re-shard plan for the model (RNS-limb) axis after exclusions.

    Unlike the data axis there is no power-of-two constraint: the limb
    padding rule (limb_pad_to in engine/sharded.py) absorbs any survivor
    count M' by padding k up to the next multiple of M', so every
    non-empty survivor set is viable and no worker idles.
    """
    dropped = set(excluded)
    alive = [m for m in range(limb_shards) if m not in dropped]
    if not alive:
        raise RuntimeError("all limb shard workers excluded")
    plan = {"limb_shards": len(alive), "workers": alive, "axes": ("model",),
            "excluded": sorted(dropped)}
    if limbs is not None:
        m = len(alive)
        plan["limb_pad"] = (m - limbs % m) % m
    return plan
