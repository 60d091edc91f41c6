"""Launch wrapper of the CUDA fast base conversion kernel (csrc/baseconv.cu).

Replaces no Pallas kernel: the JAX package computes the HPS fast base
conversion (`BFVContext._fbc`) as plain array code.  Here the plain loop
issued about 4 * ka small torch operations a call, ten calls in every
ciphertext-ciphertext multiply.

Bound on the card: integer operations — ka lazy Shoup products and 64-bit
sums per output residue against 8 bytes in and 8 out per limb of the
engine's int64 layout.  The design (source note in csrc/baseconv.cu)
keeps a coefficient's ka residues in registers, loops over the outputs,
reads the (ka, kb) table from shared memory as a broadcast, and reads and
writes int64 directly.

`LAUNCHES` counts kernel launches, one per call that reaches the card;
`LAUNCHES_BY_SHAPE` counts the same launches by (rows, ka, kb).  While a
query records spans (runtime/tracing.py), each launch's host time is
added to it.
"""
from __future__ import annotations

import ctypes

import torch

from ...runtime import tracing
from .. import library
from .. import on_device as _on

LAUNCHES = {"base_conv": 0}
# the same launches by shape ({(rows, ka, kb): launches})
LAUNCHES_BY_SHAPE: dict[str, dict[tuple[int, int, int], int]] = {"base_conv": {}}

# the kernel keeps a coefficient's input residues in registers and the
# (ka, kb) table in shared memory, both sized for this many limbs
MAX_LIMBS = 32

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    lib = library("baseconv")
    if lib.base_conv_launch.argtypes is None:
        lib.base_conv_launch.argtypes = [_P, _LL, _P, _I, _I, _I, _I,
                                         _P, _P, _P, _P, _P, _P, _P, _P]
        lib.base_conv_launch.restype = _I
    return lib


def readable(x: torch.Tensor) -> bool:
    """Whether the kernel reads a (rows, ka, n) tensor as it lies: each
    row's (ka, n) block contiguous, rows at any stride that does not make
    them overlap (one component of a stacked ciphertext is such)."""
    rows, ka, n = x.shape
    return x.stride(2) == 1 and (ka == 1 or x.stride(1) == n) and (
        rows == 1 or x.stride(0) >= ka * n)


def check_input(x: torch.Tensor, tabs) -> None:
    """Validate a (rows, ka, n) kernel operand: a CUDA int64 tensor on the
    tables' device with ka input limbs, laid out as `readable` says."""
    if x.dtype != torch.int64 or x.dim() != 3:
        raise ValueError(f"expected a (rows, ka, n) int64 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    ka = x.shape[1]
    if ka != tabs.ka:
        raise ValueError(f"input has {ka} limbs, the conversion's base has {tabs.ka}")
    if not (1 <= tabs.ka <= MAX_LIMBS and 1 <= tabs.kb <= MAX_LIMBS):
        raise ValueError(f"the kernel converts bases of 1 to {MAX_LIMBS} limbs, "
                         f"not {tabs.ka} -> {tabs.kb}")
    if not readable(x):
        raise ValueError(f"each row's ({ka}, n) block must be contiguous and rows "
                         f"must not overlap, got strides {x.stride()}")
    if not x.is_cuda or x.device != tabs.device:
        raise ValueError(f"the base conversion kernel takes CUDA tensors on "
                         f"{tabs.device}, got {x.device}")


def _count(rows: int, ka: int, kb: int) -> None:
    """Record one launch on (rows, ka, n) -> (rows, kb, n)."""
    LAUNCHES["base_conv"] += 1
    by_shape = LAUNCHES_BY_SHAPE["base_conv"]
    by_shape[rows, ka, kb] = by_shape.get((rows, ka, kb), 0) + 1


@tracing.timed_issue
def base_conv_cuda(x: torch.Tensor, tabs) -> torch.Tensor:
    """(rows, ka, n) residues mod base A -> (rows, kb, n) mod base B,
    in [0, b_j); inputs reduced ([0, a_i))."""
    check_input(x, tabs)
    rows, ka, n = x.shape
    out = torch.empty((rows, tabs.kb, n), dtype=torch.int64, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with _on(x.device):
        err = lib.base_conv_launch(
            x.data_ptr(), x.stride(0), out.data_ptr(), rows, ka, tabs.kb, n,
            tabs.in_q32.data_ptr(), tabs.hat_inv32.data_ptr(), tabs.a_inv.data_ptr(),
            tabs.out_q32.data_ptr(), tabs.out_mu64.data_ptr(), tabs.a_mod_b32.data_ptr(),
            tabs.hat_mod_b32.data_ptr(), stream)
    _count(rows, ka, tabs.kb)
    if err != 0:
        raise RuntimeError(f"base_conv: CUDA launch failed with error {err}")
    return out
