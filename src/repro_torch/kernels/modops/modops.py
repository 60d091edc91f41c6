"""Launch wrappers of the CUDA modular kernels (csrc/modops.cu): the
pointwise ones and the scan step's key switch.

Replaces `repro/kernels/modops/modops.py`: `mul_mod_pallas`,
`add_mod_pallas` and `sub_mod_pallas`.  The key switch (`keyswitch_cuda`)
replaces no Pallas kernel: the JAX package's `keyswitch`
(`repro/launch/nshedb_step.py`) is plain array code.

Bound on the card: bytes — two int64 operands read and one written per
element, a dozen integer operations between.  The design reads and
writes the engine's int64 layout directly (no cast pass on either side),
takes the modulus and Barrett constant per limb (row % k) instead of a
tiled per-row table, and lets the second operand be shorter than the
first (`b` indexed modulo its length), so a key or plaintext shared by
the whole batch is never materialised at batch size.

The key switch multiplies (..., kd, n) digits by two (kd, kj, n) keys and
sums over the digits mod q_j: one launch for both keys, reading the
digits and the keys as they lie.  Bound on the card: between bytes and
multiply-accumulates (source note in csrc/modops.cu); the design keeps a
tile of both keys in shared memory and adds `accumulation_depth`
products in 64-bit registers between reductions, so no (kd, ..., kj, n)
product is ever written.

`LAUNCHES` counts kernel launches, one per call that reaches the card;
`LAUNCHES_BY_SHAPE` counts the same launches by the row counts of their
two operands, (rows of a, rows of b), and a key switch's by (blocks, kd,
kj), blocks the product of the digits' lead dimensions.  While a query
records spans (runtime/tracing.py), each launch's host time is added to
it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...runtime import tracing
from .. import library
from .. import on_device as _on

LAUNCHES = {"mul_mod": 0, "add_mod": 0, "sub_mod": 0, "keyswitch": 0}
# the same launches by operand shape ({(rows, rows_b): launches}; for the
# key switch {(blocks, kd, kj): launches}), so that a kernel's cost on a
# path can be read at the shapes the path gives it
LAUNCHES_BY_SHAPE: dict[str, dict[tuple[int, ...], int]] = {name: {} for name in LAUNCHES}

# the key switch keeps its tile of both keys for every digit in shared
# memory, kd x 2 KB a block: up to 128 KB
KS_MAX_DIGITS = 64

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    lib = library("modops")
    if lib.mul_mod_launch.argtypes is None:
        lib.mul_mod_launch.argtypes = [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P]
        lib.mul_mod_launch.restype = _I
        for fn in (lib.add_mod_launch, lib.sub_mod_launch):
            fn.argtypes = [_P, _P, _P, _P, _LL, _LL, _I, _I, _P]
            fn.restype = _I
        lib.keyswitch_launch.argtypes = [_P, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
        lib.keyswitch_launch.restype = _I
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, tabs) -> int:
    """Validate kernel operands: `a` is (rows, n), `b` is (rows_b, n) with
    rows_b a multiple of k dividing rows.  Returns log2 n."""
    for x in (a, b):
        if not x.is_cuda or x.device != tabs.device:
            raise ValueError(f"the pointwise kernels take CUDA tensors on "
                             f"{tabs.device}, got {x.device}")
        if x.dtype != torch.int64 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"expected contiguous (rows, n) int64 tensors, "
                             f"got {tuple(x.shape)} {x.dtype}")
    rows, n = a.shape
    rows_b = b.shape[0]
    if n != tabs.n or b.shape[1] != n or n & (n - 1):
        raise ValueError(f"n={n} must be the tables' power-of-two n={tabs.n}")
    if rows % tabs.k or rows_b % tabs.k or rows_b == 0 or rows % rows_b:
        raise ValueError(f"rows {rows} / {rows_b} must be multiples of "
                         f"k={tabs.k}, the second dividing the first")
    return n.bit_length() - 1


def _count(name: str, *shape: int) -> None:
    """Record one launch of `name` at `shape`: (rows, rows_b) of the
    pointwise kernels' operands, (blocks, kd, kj) of a key switch."""
    LAUNCHES[name] += 1
    by_shape = LAUNCHES_BY_SHAPE[name]
    by_shape[shape] = by_shape.get(shape, 0) + 1


@tracing.timed_issue
def _launch(name: str, a, b, tabs):
    log_n = _check(a, b, tabs)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    head = (a.data_ptr(), b.data_ptr(), out.data_ptr(), tabs.q32.data_ptr())
    tail = (a.numel(), b.numel(), tabs.k, log_n, stream)
    with _on(a.device):
        if name == "mul_mod":
            err = lib.mul_mod_launch(*head, tabs.mu64.data_ptr(), *tail)
        else:
            err = getattr(lib, f"{name}_launch")(*head, *tail)
    _count(name, a.shape[0], b.shape[0])
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    return out


def mul_mod_cuda(a, b, tabs):
    """a * b mod q per limb; operands reduced ([0, q)), result in [0, q)."""
    return _launch("mul_mod", a, b, tabs)


def add_mod_cuda(a, b, tabs):
    return _launch("add_mod", a, b, tabs)


def sub_mod_cuda(a, b, tabs):
    return _launch("sub_mod", a, b, tabs)


def accumulation_depth(q_max: int, digit_bits: int) -> int:
    """How many products of a digit below 2^digit_bits and a key residue
    below q_max a uint64 holds on top of a residue below q_max, the most
    the key switch adds between reductions:
    floor((2^64 - q_max) / ((2^digit_bits - 1) * (q_max - 1))); 16 at
    30-bit primes and digits, 4 at 31-bit."""
    return ((1 << 64) - q_max) // (((1 << digit_bits) - 1) * (q_max - 1))


def _check_keyswitch(digits, key_b, key_a, tabs) -> tuple:
    """Validate the key switch's operands: (..., kd, n) int32 or int64
    digits and two (kd, kj, n) int64 keys, kj the tables' limbs, all
    contiguous CUDA tensors on the tables' device.  Returns (lead, kd)."""
    for x in (digits, key_b, key_a):
        if not x.is_cuda or x.device != tabs.device:
            raise ValueError(f"the key switch kernel takes CUDA tensors on "
                             f"{tabs.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"the key switch reads contiguous tensors, got "
                             f"{tuple(x.shape)} at strides {x.stride()}")
    if digits.dtype not in (torch.int32, torch.int64) or digits.dim() < 2:
        raise ValueError(f"expected (..., kd, n) int32 or int64 digits, got "
                         f"{tuple(digits.shape)} {digits.dtype}")
    *lead, kd, n = digits.shape
    for key in (key_b, key_a):
        if key.dtype != torch.int64 or tuple(key.shape) != (kd, tabs.k, n):
            raise ValueError(f"expected ({kd}, {tabs.k}, {n}) int64 keys for {kd} digits "
                             f"and {tabs.k} output limbs, got {tuple(key.shape)} {key.dtype}")
    if n != tabs.n:
        raise ValueError(f"n={n} must be the tables' n={tabs.n}")
    if not 1 <= kd <= KS_MAX_DIGITS:
        raise ValueError(f"the key switch takes 1 to {KS_MAX_DIGITS} digits, not {kd}")
    return tuple(lead), kd


@tracing.timed_issue
def keyswitch_cuda(digits, key_b, key_a, tabs, digit_bits: int | None = None):
    """sum_i digits[..., i, :] * key[i, j, :] mod q_j for both keys: the
    two (..., kj, n) results, in [0, q_j), one launch.  Digits lie below
    2^digit_bits (the bit width of the tables' largest prime when None),
    keys below q_j."""
    lead, kd = _check_keyswitch(digits, key_b, key_a, tabs)
    q_max = tabs.q_max
    bits = digit_bits or q_max.bit_length()
    depth = accumulation_depth(q_max, bits)
    if depth < 1:
        raise ValueError(f"{bits}-bit digits by residues below {q_max} overflow a 64-bit sum")
    blocks, n = math.prod(lead), tabs.n
    out = torch.empty((2, *lead, tabs.k, n), dtype=torch.int64, device=digits.device)
    if out.numel() == 0:
        return out[0], out[1]
    lib = _lib()
    stream = torch.cuda.current_stream(digits.device).cuda_stream
    with _on(digits.device):
        err = lib.keyswitch_launch(digits.data_ptr(), digits.element_size(), key_b.data_ptr(),
                                   key_a.data_ptr(), out.data_ptr(), tabs.q32.data_ptr(),
                                   tabs.mu64.data_ptr(), blocks, kd, tabs.k, n, depth, stream)
    _count("keyswitch", blocks, kd, tabs.k)
    if err != 0:
        raise RuntimeError(f"keyswitch: CUDA launch failed with error {err}")
    return out[0], out[1]
