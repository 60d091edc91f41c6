"""Plain PyTorch version of the flash_attn kernel: dense softmax attention
with the same masking variants, computed in float32 throughout."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float | None = None, sm_scale: float | None = None):
    """q: (bh, sq, d); k, v: (bh, sk, d), any sq and sk.  Query and key
    positions both start at 0.  Softcap applies before the mask; a row
    with no visible key gives 0."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask[None], p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bqk,bkd->bqd", p / denom, v.float())
    return out.to(q.dtype)


def mha_ref(q, k, v, *, causal: bool = True, window: int | None = None,
            softcap: float | None = None):
    """`mha`'s layout on the plain version: q (B, H, Sq, D), k, v
    (B, Hkv, Sk, D) with H % Hkv == 0 -> (B, H, Sq, D)."""
    B, H, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    out = attention_ref(q.reshape(B * H, Sq, D), k.reshape(B * H, -1, D),
                        v.reshape(B * H, -1, D), causal=causal, window=window,
                        softcap=softcap)
    return out.reshape(B, H, Sq, D)
