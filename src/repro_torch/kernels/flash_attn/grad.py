"""Gradient of attention (`ops.mha`), in torch ops.

The JAX package has no backward kernel for this function: its Pallas
kernel (`repro/kernels/flash_attn/flash_attn.py:74`) has no `custom_vjp`,
and its models train by differentiating the jnp lowering, rematerialized
per chunk of 2048 queries (`repro/models/layers.py`, `CHUNK_Q`).  So here,
as a plain matmul stays `torch.matmul`, the backward is torch ops and the
forward stays the flash_attn kernel: `mha_backward` recomputes the
softmax per chunk of at most `CHUNK_Q` queries from q, k and v alone (the
forward's output is not needed) and never holds more than one chunk's
(B, H, CHUNK_Q, keys) scores.

The function differentiated is the kernel's: scores q·k·D^-0.5, the tanh
softcap c·tanh(s / c) before the mask, the causal mask q_pos >= k_pos and
the window q_pos - k_pos < window (positions of queries and keys both from
0), a row with no visible key giving 0, and GQA with query head h reading
KV head h // (H / Hkv).  In float32 throughout; the gradients come back in
the inputs' dtypes.
"""
from __future__ import annotations

import torch

# queries per recomputed chunk: the reference's CHUNK_Q
CHUNK_Q = 2048


def _visible(q0: int, q1: int, k0: int, k1: int, causal: bool, window, device):
    """(q1 - q0, k1 - k0) mask of the (query, key) pairs the kernel sees."""
    qp = torch.arange(q0, q1, device=device)[:, None]
    kp = torch.arange(k0, k1, device=device)[None, :]
    ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    return ok


def mha_backward(q, k, v, dout, *, causal: bool = True, window: int | None = None,
                 softcap: float | None = None):
    """(dq, dk, dv) of `mha(q, k, v)` for the output cotangent `dout`.

    q, dout: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with H % Hkv == 0."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    do = dout.float().reshape(B, Hkv, G, Sq, D)
    kf, vf = k.float(), v.float()
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, Hkv, Sk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, CHUNK_Q):
        q1 = min(q0 + CHUNK_Q, Sq)
        # the keys any query of the chunk sees
        k0 = max(0, q0 - window + 1) if window is not None else 0
        k1 = min(Sk, q1) if causal else Sk
        if k1 <= k0:
            continue
        qc, doc = qf[:, :, :, q0:q1], do[:, :, :, q0:q1]
        kc, vc = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        ok = _visible(q0, q1, k0, k1, causal, window, q.device)
        s = torch.where(ok, s, -torch.inf)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(m == -torch.inf, 0.0, m))
        denom = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(denom == 0.0, 1.0, denom)
        del s
        dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vc)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        del p, dp
        if softcap is not None:
            ds = ds * (1.0 - t * t)
            del t
        ds = ds * scale
        dq[:, :, :, q0:q1] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kc)
        dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc)
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
