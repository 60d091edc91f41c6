"""Launch wrappers of the CUDA pointwise modular kernels (csrc/modops.cu).

Replaces `repro/kernels/modops/modops.py`: `mul_mod_pallas`,
`add_mod_pallas` and `sub_mod_pallas`.

Bound on the card: bytes — two int64 operands read and one written per
element, a dozen integer operations between.  The design reads and
writes the engine's int64 layout directly (no cast pass on either side),
takes the modulus and Barrett constant per limb (row % k) instead of a
tiled per-row table, and lets the second operand be shorter than the
first (`b` indexed modulo its length), so a key or plaintext shared by
the whole batch is never materialised at batch size.

`LAUNCHES` counts kernel launches, one per call that reaches the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import library
from .. import on_device as _on

LAUNCHES = {"mul_mod": 0, "add_mod": 0, "sub_mod": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    lib = library("modops")
    if lib.mul_mod_launch.argtypes is None:
        lib.mul_mod_launch.argtypes = [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P]
        lib.mul_mod_launch.restype = _I
        for fn in (lib.add_mod_launch, lib.sub_mod_launch):
            fn.argtypes = [_P, _P, _P, _P, _LL, _LL, _I, _I, _P]
            fn.restype = _I
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
    LAUNCHES[name] += 1
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
