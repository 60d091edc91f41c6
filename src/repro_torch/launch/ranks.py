"""One process a rank and one rank a card: the launcher of the port's
programs over a mesh of one host's cards.

`RankGroup(world, setup, args, device=...)` makes the calling process
rank 0 and starts ranks 1 .. world - 1 itself, each from a fresh
interpreter (the "spawn" start method: CUDA does not survive a fork)
with the caller's `sys.path`.  Rank r takes card r
(`torch.cuda.set_device`), and every rank joins one process group —
"nccl" bound to its card, or "gloo" when `device` is the CPU — through
a `file://` rendezvous in a temporary directory of the group's own,
with `timeout_s` on every collective.  Then each rank builds its worker,
`setup(rank, world, device, *args)`, `setup` named "module:attribute"
so that a spawned rank can import it.

Rank 0 drives.  `call(method, *args)` runs `worker.<method>(*args)` on
every rank at once (rank 0's in the calling process, after the others
have been sent theirs) and returns the results in rank order once every
rank has returned; `run(fn, *args)` does the same with `fn(worker,
*args)` for a function named "module:attribute".  Commands and results
travel through one pipe a rank, pickled by value.  A rank waiting for
its next command holds no collective open, so the time between calls is
not bounded; collectives happen only inside the workers' methods.

Failure.  A rank that raises sends its traceback and stops; a rank that
dies is seen by its process sentinel; a rank that does not answer within
`timeout_s` of a call is taken as hung.  Each kills every rank and
raises RuntimeError in rank 0 with what the ranks said.  A rank left
waiting in a collective for a peer that is gone fails at the process
group's timeout (NCCL's watchdog ends the process), and no rank
outlives rank 0: each dies with its parent (Linux `PR_SET_PDEATHSIG`).
Ranks 1 .. world - 1 write nothing to standard output (theirs goes to
standard error).
"""
from __future__ import annotations

import ctypes
import datetime
import importlib
import multiprocessing
import os
import pickle
import shutil
import signal
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.distributed as dist

TIMEOUT_S = 180.0        # rendezvous, each collective, and each call's answers
_PR_SET_PDEATHSIG = 1


def resolve(name: str):
    """The object named "module:attribute" (the attribute may be dotted)."""
    module, _, attr = name.partition(":")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _rank_device(rank: int, device) -> torch.device:
    """Card `rank` when `device` is a CUDA device, else the CPU."""
    return torch.device("cuda", rank) if torch.device(device).type == "cuda" else torch.device("cpu")


def _join(rank: int, world: int, work_dir: str, device: torch.device, timeout_s: float) -> None:
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{work_dir}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def _leave(failed: bool) -> None:
    """Leave the process group; after a failure an NCCL group is aborted
    rather than shut down, which could wait on a peer that is gone."""
    if not dist.is_initialized():
        return
    if failed and dist.get_backend() == "nccl":
        dist.distributed_c10d._abort_process_group()
    else:
        dist.destroy_process_group()


def _send(conn, kind: str, value) -> None:
    conn.send_bytes(pickle.dumps((kind, value)))


def _rank_main(rank, world, work_dir, device, timeout_s, setup, args, conn, parent) -> None:
    """A spawned rank: join, build the worker, serve commands until "close"."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:            # the parent died before the line above
        os._exit(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    try:
        if device.type == "cpu":
            torch.set_num_threads(1)      # gloo ranks share the host's cores
        make = resolve(setup)
        _send(conn, "ready", None)
        _join(rank, world, work_dir, device, timeout_s)
        worker = make(rank, world, device, *args)
        _send(conn, "ok", None)
        while True:
            kind, name, cargs = pickle.loads(conn.recv_bytes())
            if kind == "close":
                break
            fn = getattr(worker, name) if kind == "call" else resolve(name)
            _send(conn, "ok", fn(*cargs) if kind == "call" else fn(worker, *cargs))
    except BaseException:
        try:
            _send(conn, "error", traceback.format_exc())
        except OSError:
            pass
        sys.stderr.flush()
        os._exit(1)                       # no teardown that could wait on a peer
    _leave(False)


class RankGroup:
    """`world` ranks of `setup`'s workers on `device` ("cuda": one a card;
    "cpu": gloo ranks); this process is rank 0 and holds `worker`."""

    def __init__(self, world: int, setup: str, args=(), *, device="cuda",
                 timeout_s: float = TIMEOUT_S):
        self.world, self.timeout_s = world, timeout_s
        self.device = _rank_device(0, device)
        self.work_dir = tempfile.mkdtemp(prefix="ranks-")
        self.procs, self.conns, self.closed = [], [], False
        self.worker = None
        spawn = multiprocessing.get_context("spawn")
        try:
            for r in range(1, world):
                mine, theirs = spawn.Pipe()
                p = spawn.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                                  args=(r, world, self.work_dir, _rank_device(r, device),
                                        timeout_s, setup, tuple(args), theirs, os.getpid()))
                p.start()
                theirs.close()
                self.procs.append(p)
                self.conns.append(mine)
            self._answers()                        # every rank imported `setup`
            _join(0, world, self.work_dir, self.device, timeout_s)
            self.worker = resolve(setup)(0, world, self.device, *args)
            self._answers()
        except BaseException:
            self._close(failed=True)
            raise

    def call(self, method: str, *args) -> list:
        """`worker.<method>(*args)` on every rank: the results, rank 0's first."""
        return self._all(("call", method, args), lambda: getattr(self.worker, method)(*args))

    def run(self, fn: str, *args) -> list:
        """`fn(worker, *args)` on every rank, `fn` named "module:attribute"."""
        return self._all(("run", fn, args), lambda: resolve(fn)(self.worker, *args))

    def close(self) -> None:
        """End every rank (a shutdown message, then a kill for any rank
        still alive) and leave the process group; idempotent."""
        self._close(failed=False)

    # ------------------------------------------------------------------
    def _all(self, msg, mine) -> list:
        if self.closed:
            raise RuntimeError("the rank group is closed")
        payload = pickle.dumps(msg)
        for conn in self.conns:
            conn.send_bytes(payload)
        try:
            first = mine()
        except BaseException as e:
            self._fail(f"rank 0 raised {type(e).__name__}: {e}", grace_s=2.0)
        return [first] + self._answers()

    def _answers(self) -> list:
        """One answer of every rank 1 .. world - 1, in rank order."""
        pending = dict(enumerate(self.conns, 1))
        out = {}
        deadline = time.monotonic() + self.timeout_s
        while pending:
            waits = list(pending.values()) + [self.procs[r - 1].sentinel for r in pending]
            if not wait(waits, timeout=max(deadline - time.monotonic(), 0.0)):
                self._fail(f"ranks {sorted(pending)} did not answer within "
                           f"{self.timeout_s:.0f} s")
            for r, conn in list(pending.items()):
                if conn.poll():
                    try:
                        kind, value = pickle.loads(conn.recv_bytes())
                    except EOFError:
                        self._fail(f"rank {r} exited with code {self.procs[r - 1].exitcode}")
                    if kind == "error":
                        self._fail(f"rank {r} raised:\n{value}")
                    out[r] = value
                    del pending[r]
                elif not self.procs[r - 1].is_alive():
                    self._fail(f"rank {r} exited with code {self.procs[r - 1].exitcode}")
        return [out[r] for r in sorted(out)]

    def _fail(self, what: str, grace_s: float = 0.0):
        """Gather what the other ranks say within `grace_s`, kill every
        rank, raise."""
        said = []
        deadline = time.monotonic() + grace_s
        for r, conn in enumerate(self.conns, 1):
            try:
                while conn.poll(max(deadline - time.monotonic(), 0.0)):
                    kind, value = pickle.loads(conn.recv_bytes())
                    if kind == "error":
                        said.append(f"rank {r} raised:\n{value}")
            except (EOFError, OSError):
                self.procs[r - 1].join(1)
                said.append(f"rank {r} exited with code {self.procs[r - 1].exitcode}")
        self._close(failed=True)
        raise RuntimeError("\n".join([what] + said))

    def _close(self, failed: bool) -> None:
        if self.closed:
            return
        self.closed = True
        self.worker = None
        try:
            if not failed:
                for conn in self.conns:
                    try:
                        conn.send_bytes(pickle.dumps(("close", None, ())))
                    except OSError:
                        pass
                _leave(False)          # beside the ranks: a shutdown may wait for every rank
                for p in self.procs:
                    p.join(self.timeout_s)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
            for conn in self.conns:
                conn.close()
            if failed:
                _leave(True)
            shutil.rmtree(self.work_dir, ignore_errors=True)
