"""Launch wrapper of the CUDA rotate-and-add reduction (csrc/rotate_reduce.cu).

Replaces `repro/kernels/rotate_reduce/rotate_reduce.py`:
`rotate_reduce_pallas` (`_kernel`).

Bound on the card: bytes — each int64 slot value is read once and written
once, with a few integer operations between.  The Pallas kernel runs the
log2(c) doubling stages on a VMEM-resident row; here the full reduction
(c = n, the one `MockBackend.sum_slots` uses) needs no stages at all: one
thread block sums its row in registers and writes the total back, so the
row never touches shared memory.  Chunk mode keeps the doubling stages on
the row in shared memory.

`LAUNCHES` counts kernel launches, one per call that reaches the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import library
from .. import on_device as _on

LAUNCHES = {"rotate_reduce": 0}

# chunk mode holds a row of 32-bit values in one block's shared memory
# (1024 threads x 32 values in registers between the stage barriers)
MAX_CHUNK_N = 32768

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    lib = library("rotate_reduce")
    if lib.rotate_reduce_launch.argtypes is None:
        lib.rotate_reduce_launch.argtypes = [_P, _P, _LL, _I, _I, _LL, _P]
        lib.rotate_reduce_launch.restype = _I
    return lib


def rotate_reduce_cuda(x: torch.Tensor, t: int, stop_log: int) -> torch.Tensor:
    """`stop_log` doubling stages of x <- (x + roll(x, -2^s)) mod t on every
    row of a contiguous (rows, n) int64 CUDA tensor with values in [0, t).
    stop_log = log2 n gives every slot its row's total."""
    if not x.is_cuda:
        raise ValueError("the rotate_reduce kernel takes CUDA tensors")
    if x.dtype != torch.int64 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous (rows, n) int64 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    rows, n = x.shape
    log_n = n.bit_length() - 1
    if n < 1 or n & (n - 1) or rows >= 1 << 31:
        raise ValueError(f"n={n} must be a power of two and rows={rows} < 2^31")
    if not 0 <= stop_log <= log_n:
        raise ValueError(f"stop_log={stop_log} outside [0, log2 n = {log_n}]")
    if stop_log < log_n and n > MAX_CHUNK_N:
        raise ValueError(f"chunk mode keeps the row in shared memory: "
                         f"n={n} > {MAX_CHUNK_N}")
    if not 1 < t < 1 << 31:
        raise ValueError(f"t={t} must be in (1, 2^31)")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with _on(x.device):
        err = lib.rotate_reduce_launch(x.data_ptr(), out.data_ptr(), rows,
                                       log_n, stop_log, int(t), stream)
    LAUNCHES["rotate_reduce"] += 1
    if err != 0:
        raise RuntimeError(f"rotate_reduce: CUDA launch failed with error {err}")
    return out
