"""Public entry of attention: multi-head attention with GQA handling.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version.  The kernel indexes a query head's KV head as
h // (H / Hkv), so the KV heads are never repeated in memory.
"""
from __future__ import annotations

import torch

from .flash_attn import flash_attn_cuda
from .ref import mha_ref


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
    if q.is_cuda:
        return flash_attn_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
    return mha_ref(q, k, v, causal=causal, window=window, softcap=softcap)
