"""Launch wrapper of the CUDA rotate-and-add reduction (csrc/rotate_reduce.cu).

Replaces `repro/kernels/rotate_reduce/rotate_reduce.py`:
`rotate_reduce_pallas` (`_kernel`), whose log2(c) doubling stages
x <- (x + roll(x, -2^s)) mod t leave slot i with the wrapped window sum
x[i] + ... + x[i + c - 1] mod t_row (c = n: the row total everywhere).

Bound on the card: bytes — each slot value is read once and written once
in the rows' own width (int32, as the reference moves them, or int64),
with a few integer operations between.  At the shape
`MockBackend.sum_slots` gives it, (2, 16384), the bytes take less than
one launch, so one launch is the bound.  The kernel computes the window
sums in one pass from the row's prefix sums, kept mod t in 32 bits; a
row is split over a thread-block cluster of `cluster_size(...)`
blocks, so that a few rows still spread over many SMs, and the blocks
exchange their sums through distributed shared memory.  Chunk mode keeps
the row's prefix sums in the cluster's shared memory, 4 bytes a slot: n
up to `MAX_CHUNK_N`.  Full mode keeps no row and takes any power-of-two n.

`LAUNCHES` counts kernel launches, one per call that reaches the card.
While a query records spans (runtime/tracing.py), each launch's host
time is added to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...runtime import tracing
from .. import library
from .. import on_device as _on

LAUNCHES = {"rotate_reduce": 0}

MAX_CLUSTER = 8          # blocks a row: the portable cluster size
MAX_SLICE = 32768        # chunk mode: slots of a block's slice (128 KiB of sums)
MAX_CHUNK_N = MAX_CLUSTER * MAX_SLICE
MIN_SLICE = 2048         # a row is split no finer than this many slots a block
T_LIMIT = 1 << 31        # moduli in (1, 2^31): two sums below t add below 2^32

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    lib = library("rotate_reduce")
    if lib.rotate_reduce_launch.argtypes is None:
        lib.rotate_reduce_launch.argtypes = [_P, _P, _LL, _I, _I, _I, _I, _P, _LL, _I, _LL, _P]
        lib.rotate_reduce_launch.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_size(rows: int, n: int, sms: int, chunk_mode: bool) -> int:
    """Blocks a row is split over: doubled from 1 while the rows' blocks
    leave SMs idle and a block keeps at least MIN_SLICE slots, up to
    MAX_CLUSTER; in chunk mode at least enough that a block's slice of the
    prefix sums fits its shared memory."""
    c = 1
    while c < MAX_CLUSTER and rows * c < sms and n // (2 * c) >= MIN_SLICE:
        c *= 2
    if chunk_mode:
        c = max(c, n // MAX_SLICE)
    return min(c, n)


def check_args(x: torch.Tensor, t, stop_log: int) -> None:
    """Raise ValueError unless x is a (rows, n) int32 or int64 tensor with
    n a power of two, 0 <= stop_log <= log2 n, n <= MAX_CHUNK_N in chunk
    mode (stop_log < log2 n), and t an int in (1, 2^31) or a (rows, 1)
    int32 / int64 table of such moduli on x's device."""
    if x.dtype not in (torch.int32, torch.int64) or x.dim() != 2:
        raise ValueError(f"expected a (rows, n) int32 or int64 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    rows, n = x.shape
    log_n = n.bit_length() - 1
    if n < 1 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    if not 0 <= stop_log <= log_n:
        raise ValueError(f"stop_log={stop_log} outside [0, log2 n = {log_n}]")
    if stop_log < log_n and n > MAX_CHUNK_N:
        raise ValueError(f"chunk mode keeps the row's prefix sums in a cluster's shared "
                         f"memory: n={n} > {MAX_CHUNK_N}")
    if not isinstance(t, torch.Tensor):
        if not 1 < t < T_LIMIT:
            raise ValueError(f"t={t} must be in (1, 2^31)")
        return
    if t.device != x.device or t.shape != (rows, 1) or t.dtype not in (torch.int32,
                                                                        torch.int64):
        raise ValueError(f"t table must be ({rows}, 1) int32 or int64 on {x.device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    wide = t.to(torch.int64)                   # 2^31 is past int32
    if bool(((wide <= 1) | (wide >= T_LIMIT)).any()):
        raise ValueError("every t in the table must be in (1, 2^31)")


@tracing.timed_issue
def rotate_reduce_cuda(x: torch.Tensor, t, stop_log: int, *,
                       cluster: int | None = None) -> torch.Tensor:
    """`stop_log` doubling stages of x <- (x + roll(x, -2^s)) mod t_row on
    every row of a contiguous (rows, n) int32 or int64 CUDA tensor with
    values in [0, t_row), computed as windows of 2^stop_log slots;
    stop_log = log2 n gives every slot its row's total.  `t`: an int, or a
    (rows, 1) int32 / int64 table on x's device (`check_args`).
    `cluster`: blocks a row, a power of two <= MAX_CLUSTER; None takes
    `cluster_size`."""
    if not x.is_cuda:
        raise ValueError("the rotate_reduce kernel takes CUDA tensors")
    if not x.is_contiguous():
        raise ValueError("the rotate_reduce kernel takes a contiguous tensor")
    check_args(x, t, stop_log)
    rows, n = x.shape
    log_n = n.bit_length() - 1
    chunk_mode = stop_log < log_n
    if cluster is None:
        cluster = cluster_size(rows, n, _sm_count(x.device.index), chunk_mode)
    if cluster < 1 or cluster & (cluster - 1) or cluster > min(MAX_CLUSTER, n) or (
            chunk_mode and n // cluster > MAX_SLICE):
        raise ValueError(f"cluster={cluster}: a power of two <= {MAX_CLUSTER} and n={n}, "
                         f"with slices of <= {MAX_SLICE} slots in chunk mode")
    if rows * cluster >= 1 << 31:
        raise ValueError(f"rows={rows} x {cluster} blocks exceed the grid")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    if isinstance(t, torch.Tensor):
        table, stride, wide, t_all = t.data_ptr(), t.stride(0), int(t.dtype == torch.int64), 0
    else:
        table, stride, wide, t_all = None, 0, 0, int(t)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with _on(x.device):
        err = lib.rotate_reduce_launch(x.data_ptr(), out.data_ptr(), rows, log_n, stop_log,
                                       cluster.bit_length() - 1, x.element_size(), table,
                                       stride, wide, t_all, stream)
    LAUNCHES["rotate_reduce"] += 1
    if err != 0:
        raise RuntimeError(f"rotate_reduce: CUDA launch failed with error {err}")
    return out
