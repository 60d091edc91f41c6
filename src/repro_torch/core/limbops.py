"""Batched limb-level dispatch: CUDA kernels vs the plain PyTorch versions.

`LimbOps` binds one RNS base (an `NttTables`) to one device and exposes
the hot primitives of BFV evaluation — pointwise mul/add/sub-mod and the
forward/inverse negacyclic NTT.  Which code runs is decided by where the
tensor lies, never by a flag:

    CUDA tensor  the hand-written kernels (`kernels/modops`,
                 `kernels/ntt`), or an exception — nothing stands in
                 for a kernel on the card
    CPU tensor   the exact int64 plain versions

`backend` names the route an instance takes ("cuda" or "ref").  The
kernels accept every odd prime in (2^28, 2^31), so the 30-bit ciphertext
base Q and the 31-bit HPS auxiliary base P both run through them; a base
outside that window raises at construction.

Every entry point accepts tensors of shape (..., k, n) — any number of
leading batch axes over the (limb, coefficient) layout.  Batches are
flattened to the (rows, n) layout the kernels grid over; the per-limb
tables are shared by the whole batch (row r reads limb r % k), so a
column of ciphertext blocks runs as one kernel launch.

`force_ref()` routes every primitive through the plain versions for the
duration, on whatever device the tensors lie: the explicit request of a
caller that wants the plain arithmetic (tests).

`LimbLocalOps` is the same over a contiguous slice of a base's limbs: what
one rank of a mesh's "model" axis runs between the key switch's gathers.
"""
from __future__ import annotations

import contextlib
import dataclasses

from ..kernels.modops import ops as mod_ops
from ..kernels.modops import ref as mod_ref
from ..kernels.ntt import ops as ntt_ops
from ..kernels.ntt import ref as ntt_ref
from ..kernels.tables import limb_tables
from .params import NttTables

BACKENDS = ("ref", "cuda")

# Depth of nested force_ref() contexts.
_FORCE_REF = 0


@contextlib.contextmanager
def force_ref():
    """Route all limb primitives through the plain PyTorch versions."""
    global _FORCE_REF
    _FORCE_REF += 1
    try:
        yield
    finally:
        _FORCE_REF -= 1


def ref_forced() -> bool:
    """Whether a `force_ref()` context is open (BFVContext's base
    conversion reads it too)."""
    return _FORCE_REF > 0


class LimbOps:
    """Pointwise + NTT primitives for one RNS base on one device."""

    def __init__(self, tables: NttTables, device="cuda"):
        self.tables = tables
        self.primes = tuple(int(q) for q in tables.primes)
        self.tabs = limb_tables(tables, device)
        self.device = self.tabs.device
        self.k, self.n = self.tabs.k, self.tabs.n
        self.backend = "cuda" if self.device.type == "cuda" else "ref"
        # plain-version tables (int64), also read by BFVContext
        self.q, self.psi = self.tabs.q, self.tabs.psi
        self.ipsi, self.ninv = self.tabs.ipsi, self.tabs.ninv

    # ----------------------------------------------------- pointwise ops
    def mul(self, a, b):
        """Pointwise a*b mod q over (..., k, n); exact, result in [0, q)."""
        if _FORCE_REF:
            return mod_ref.mul_mod_ref(a, b, self.q)
        return mod_ops.mul_mod(a, b, self.tabs)

    def add(self, a, b):
        if _FORCE_REF:
            return mod_ref.add_mod_ref(a, b, self.q)
        return mod_ops.add_mod(a, b, self.tabs)

    def sub(self, a, b):
        if _FORCE_REF:
            return mod_ref.sub_mod_ref(a, b, self.q)
        return mod_ops.sub_mod(a, b, self.tabs)

    # -------------------------------------------------------------- NTT
    def ntt(self, a):
        """Forward negacyclic NTT over (..., k, n)."""
        if _FORCE_REF:
            return ntt_ref.ntt_fwd_ref(a, self.psi, self.q)
        return ntt_ops.ntt_fwd(a, self.tabs)

    def intt(self, a):
        """Inverse negacyclic NTT over (..., k, n)."""
        if _FORCE_REF:
            return ntt_ref.ntt_inv_ref(a, self.ipsi, self.ninv, self.q)
        return ntt_ops.ntt_inv(a, self.tabs)


class LimbLocalOps(LimbOps):
    """The primitives of limbs [lo, hi) of one base on one device:
    ntt, intt and mul (and add, sub) on a (..., hi - lo, n) slice, with
    the slice's own tables (core/bfv.py: kswitch_gathered).  Dispatch is
    LimbOps': a CUDA tensor goes to the kernels, a CPU tensor to the
    plain versions."""

    def __init__(self, tables: NttTables, lo: int, hi: int, device="cuda"):
        if not 0 <= lo < hi <= len(tables.primes):
            raise ValueError(f"limb slice [{lo}, {hi}) outside a base of "
                             f"{len(tables.primes)} limbs")
        super().__init__(dataclasses.replace(
            tables, primes=tuple(tables.primes[lo:hi]), q=tables.q[lo:hi],
            psi_rev=tables.psi_rev[lo:hi], ipsi_rev=tables.ipsi_rev[lo:hi],
            n_inv=tables.n_inv[lo:hi]), device=device)
        self.lo, self.hi = lo, hi
