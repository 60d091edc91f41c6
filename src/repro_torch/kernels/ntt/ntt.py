"""Launch wrappers of the CUDA negacyclic NTT kernels (csrc/ntt.cu).

Replaces `repro/kernels/ntt/ntt.py`: `ntt_fwd_pallas` (`_fwd_kernel`) and
`ntt_inv_pallas` (`_inv_kernel`).

Bound on the card: bytes.  A row is read once and written once in the
engine's int64 layout — 16 bytes per coefficient against ~10 integer
operations for each of the log2(n) butterflies it takes part in — plus
the (k, n) twiddle tables, which every batch element shares.  Reads and
writes are int64 directly, with no cast pass, and the tables are
indexed by limb (row % k) so they are never tiled to the batch.  The
forward kernel runs two blocks per row, one per half after the first
stage, with 32 values per thread in registers and five stages per
shared-memory exchange; the inverse kernel runs a thread-block cluster
of eight blocks per row, each with an eighth of the row in shared
memory and 16 values per thread in registers, and the last three stages
across the cluster through distributed shared memory (source note in
csrc/ntt.cu).

`LAUNCHES` counts kernel launches, one per call that reaches the card;
`LAUNCHES_BY_ROWS` counts the same launches by their row count.  While a
query records spans (runtime/tracing.py), each launch's host time is
added to it.
"""
from __future__ import annotations

import ctypes

import torch

from ...runtime import tracing
from .. import library
from .. import on_device as _on

LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0}
# the same launches by row count ({rows: launches}), so that a kernel's
# cost on a path can be read at the shapes the path gives it
LAUNCHES_BY_ROWS: dict[str, dict[int, int]] = {"ntt_fwd": {}, "ntt_inv": {}}

# a row of n 32-bit residues must fit one block's dynamic shared memory
_SMEM_LIMIT = 232448

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    lib = library("ntt")
    if lib.ntt_fwd_launch.argtypes is None:
        lib.ntt_fwd_launch.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _P]
        lib.ntt_fwd_launch.restype = _I
        lib.ntt_inv_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P]
        lib.ntt_inv_launch.restype = _I
    return lib


def _check_rows(a: torch.Tensor, tabs) -> tuple[int, int]:
    """Validate a (rows, n) kernel operand against its tables; (rows, log_n)."""
    if not a.is_cuda:
        raise ValueError("the NTT kernel takes CUDA tensors")
    if a.dtype != torch.int64 or a.dim() != 2 or not a.is_contiguous():
        raise ValueError(f"expected a contiguous (rows, n) int64 tensor, got "
                         f"{tuple(a.shape)} {a.dtype}")
    rows, n = a.shape
    if n != tabs.n or n & (n - 1) or n < 2 or n * 4 > _SMEM_LIMIT:
        raise ValueError(f"n={n} does not match the tables (n={tabs.n}) or "
                         f"is not a power of two that fits shared memory")
    if rows % tabs.k or tabs.device != a.device:
        raise ValueError(f"rows={rows} on {a.device} against k={tabs.k} "
                         f"tables on {tabs.device}")
    return rows, n.bit_length() - 1


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


@tracing.timed_issue
def ntt_fwd_cuda(a: torch.Tensor, tabs) -> torch.Tensor:
    """Forward NTT of every row of a (rows, n) int64 CUDA tensor; row r
    uses limb r % k of `tabs` (a `LimbTables`).  Output bit-reversed."""
    rows, log_n = _check_rows(a, tabs)
    out = torch.empty_like(a)
    if rows == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with _on(a.device):
        err = lib.ntt_fwd_launch(a.data_ptr(), out.data_ptr(),
                                 tabs.psi32.data_ptr(), tabs.psi_shoup.data_ptr(),
                                 tabs.q32.data_ptr(), rows, tabs.k, log_n, stream)
    LAUNCHES["ntt_fwd"] += 1
    LAUNCHES_BY_ROWS["ntt_fwd"][rows] = LAUNCHES_BY_ROWS["ntt_fwd"].get(rows, 0) + 1
    _raise_on(err, "ntt_fwd")
    return out


@tracing.timed_issue
def ntt_inv_cuda(a: torch.Tensor, tabs) -> torch.Tensor:
    """Inverse NTT (consumes bit-reversed order, scales by n^-1)."""
    rows, log_n = _check_rows(a, tabs)
    out = torch.empty_like(a)
    if rows == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with _on(a.device):
        err = lib.ntt_inv_launch(a.data_ptr(), out.data_ptr(),
                                 tabs.ipsi32.data_ptr(), tabs.ipsi_shoup.data_ptr(),
                                 tabs.q32.data_ptr(), tabs.ninv32.data_ptr(),
                                 tabs.ninv_shoup.data_ptr(), rows, tabs.k, log_n,
                                 stream)
    LAUNCHES["ntt_inv"] += 1
    LAUNCHES_BY_ROWS["ntt_inv"][rows] = LAUNCHES_BY_ROWS["ntt_inv"].get(rows, 0) + 1
    _raise_on(err, "ntt_inv")
    return out
