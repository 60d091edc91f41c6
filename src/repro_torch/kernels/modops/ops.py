"""Public pointwise entry points over the (..., k, n) int64 limb layout.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version.  Operands broadcast against each other like tensors do;
on the card a second operand whose shape is a trailing part of the
result's (a key or plaintext shared by the batch) is passed as it is and
indexed modulo its length by the kernel.
"""
from __future__ import annotations

import torch

from .modops import add_mod_cuda, mul_mod_cuda, sub_mod_cuda
from .ref import add_mod_ref, mul_mod_ref, sub_mod_ref


def _result_shape(a, b, tabs):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if shape[-2:] != (tabs.k, tabs.n):
        raise ValueError(f"expected (..., {tabs.k}, {tabs.n}), got {tuple(shape)}")
    return shape


def kernel_operands(a, b, tabs):
    """(result shape, a, b) as the kernel reads them: (rows, n) views,
    `a` copied out to the result's shape, `b` as it is when its shape is
    a trailing part of the result's, else copied out too."""
    shape = _result_shape(a, b, tabs)
    a = a.expand(shape).contiguous().view(-1, tabs.n)
    core = tuple(b.shape)
    while len(core) > 2 and core[0] == 1:
        core = core[1:]
    if len(core) >= 2 and core == tuple(shape[len(shape) - len(core):]):
        b = b.contiguous().view(-1, tabs.n)       # trailing part: no copy
    else:
        b = b.expand(shape).contiguous().view(-1, tabs.n)
    return shape, a, b


def _pointwise(a, b, tabs, kern_fn, ref_fn):
    if not (a.is_cuda or b.is_cuda):
        _result_shape(a, b, tabs)
        return ref_fn(a, b, tabs.q)
    shape, a, b = kernel_operands(a, b, tabs)
    return kern_fn(a, b, tabs).view(shape)


def mul_mod(a, b, tabs):
    """Pointwise a*b mod q over (..., k, n); exact, result in [0, q)."""
    return _pointwise(a, b, tabs, mul_mod_cuda, mul_mod_ref)


def add_mod(a, b, tabs):
    return _pointwise(a, b, tabs, add_mod_cuda, add_mod_ref)


def sub_mod(a, b, tabs):
    return _pointwise(a, b, tabs, sub_mod_cuda, sub_mod_ref)
