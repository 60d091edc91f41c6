"""Shard-context hooks the single-device engine already calls.

Only the two helpers the planner, the atom evaluator and the backends
import: `activate` (install a shard context on a backend for a scope)
and `pad_to` (lane count after padding to a multiple of the shard
count).  `ShardContext`, the cost ledger and the collectives are not
here yet, so the only context ever installed is None.
"""
from __future__ import annotations

import contextlib


def pad_to(nblocks: int, shards: int) -> int:
    """Lane count after padding nblocks up to a multiple of shards."""
    if shards <= 1 or nblocks <= 1:
        return nblocks
    return nblocks + (-nblocks) % shards


@contextlib.contextmanager
def activate(bk, ctx):
    """Install ctx as bk.shard_ctx for the duration.  Reentrant: if the
    same context is already active this is a no-op, so nested scopes
    (planner -> evaluator flush) do not double-install."""
    prev = getattr(bk, "shard_ctx", None)
    if ctx is None or prev is ctx:
        yield prev
        return
    bk.shard_ctx = ctx
    try:
        yield ctx
    finally:
        bk.shard_ctx = prev
