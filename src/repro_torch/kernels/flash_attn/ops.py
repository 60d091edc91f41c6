"""Public entry of attention: multi-head attention with GQA handling.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version.  The kernel indexes a query head's KV head as
h // (H / Hkv), so the KV heads are never repeated in memory.

Where autograd records (grad mode on and an input that requires grad),
the same forward runs inside `_MHA`, a `torch.autograd.Function` that
saves q, k and v and whose backward is `grad.mha_backward` (torch ops;
that module says why).  Elsewhere — serving, `torch.no_grad` — nothing is
saved.
"""
from __future__ import annotations

import torch

from .flash_attn import flash_attn_cuda
from .grad import mha_backward
from .ref import mha_ref


def _forward(q, k, v, causal, window, softcap):
    if q.is_cuda:
        return flash_attn_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
    return mha_ref(q, k, v, causal=causal, window=window, softcap=softcap)


class _MHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return _forward(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = mha_backward(q, k, v, dout, **ctx.opts)
        return dq, dk, dv, None, None, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
        window: int | None = None, softcap: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with H % Hkv == 0 ->
    (B, H, Sq, D) in q's dtype.  Query and key positions both start at 0;
    any Sq and Sk.  On the card the result is a view of a (B, Sq, H, D)
    buffer, so `.transpose(1, 2)` of it is contiguous."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected 4-d q, k, v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"H={q.shape[1]} is not a multiple of Hkv={k.shape[1]}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _MHA.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap)
