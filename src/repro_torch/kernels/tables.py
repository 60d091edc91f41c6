"""Per-base device tables shared by the kernel wrappers.

One `LimbTables` holds, on one device, everything the limb-level
primitives of an RNS base read: the int64 tables of the plain versions
and the 32-bit words the CUDA kernels read.  32-bit values up to 2^32-1
(the Shoup companions) are stored as raw bit patterns in `torch.int32`
tensors and the 64-bit Barrett constants likewise in `torch.int64`; the
kernels reinterpret them as unsigned.  Tables are per limb, (k, n) or
(k,): a batch of any size indexes them by row % k.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import NttTables
from .u32 import barrett_precompute, check_modulus


@dataclasses.dataclass(frozen=True, eq=False)
class LimbTables:
    k: int
    n: int
    device: torch.device
    # plain versions (int64)
    q: torch.Tensor            # (k,)
    psi: torch.Tensor          # (k, n)
    ipsi: torch.Tensor         # (k, n)
    ninv: torch.Tensor         # (k,)
    # kernels (bit patterns)
    q32: torch.Tensor          # (k,)   int32
    psi32: torch.Tensor        # (k, n) int32
    psi_shoup: torch.Tensor    # (k, n) int32
    ipsi32: torch.Tensor       # (k, n) int32
    ipsi_shoup: torch.Tensor   # (k, n) int32
    ninv32: torch.Tensor       # (k,)   int32
    ninv_shoup: torch.Tensor   # (k,)   int32
    mu64: torch.Tensor         # (k,)   int64, floor(2^64 / q)


def _bits32(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(x.astype(np.uint32)).view(np.int32)).to(device)


def limb_tables(tables: NttTables, device) -> LimbTables:
    """Build the device tables of one RNS base.  Raises ValueError when a
    modulus lies outside the kernels' window (odd, 2^28 < q < 2^31)."""
    device = torch.device(device)
    primes = [check_modulus(q) for q in tables.primes]
    q64 = np.asarray(tables.q, dtype=np.uint64)
    psi = np.asarray(tables.psi_rev, dtype=np.uint64)
    ipsi = np.asarray(tables.ipsi_rev, dtype=np.uint64)
    ninv = np.asarray(tables.n_inv, dtype=np.uint64)
    sh = np.uint64(32)
    mu = np.array([barrett_precompute(q) for q in primes], dtype=np.uint64)

    def i64(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)

    q = i64(tables.q)
    return LimbTables(
        k=len(primes), n=int(tables.psi_rev.shape[1]),
        device=q.device,       # as tensors report it ("cuda" -> "cuda:0")
        q=q, psi=i64(tables.psi_rev), ipsi=i64(tables.ipsi_rev),
        ninv=i64(tables.n_inv),
        q32=_bits32(q64, device),
        psi32=_bits32(psi, device),
        psi_shoup=_bits32((psi << sh) // q64[:, None], device),
        ipsi32=_bits32(ipsi, device),
        ipsi_shoup=_bits32((ipsi << sh) // q64[:, None], device),
        ninv32=_bits32(ninv, device),
        ninv_shoup=_bits32((ninv << sh) // q64, device),
        mu64=torch.from_numpy(mu.view(np.int64)).to(device),
    )


def slice_limbs(tabs: LimbTables, lo: int, hi: int) -> LimbTables:
    """The tables of limbs [lo, hi) of `tabs`: views of its tensors."""
    if not 0 <= lo < hi <= tabs.k:
        raise ValueError(f"limb slice [{lo}, {hi}) outside a base of {tabs.k} limbs")
    return dataclasses.replace(tabs, k=hi - lo, **{
        f.name: getattr(tabs, f.name)[lo:hi] for f in dataclasses.fields(tabs)
        if isinstance(getattr(tabs, f.name), torch.Tensor)})
