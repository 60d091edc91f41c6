"""Shared neural layers: RMSNorm, RoPE, (GQA/local/softcap) attention,
MLA attention with compressed-latent cache, gated MLP.

Parameters are plain nested dicts of tensors; every apply function is
pure (returns new tensors, never writes its inputs).  Attention supports
two modes:
  train/prefill  full sequence, optionally returning a KV cache
  decode         one new token against a cache
Local attention masks by window.  A call whose query and key positions
both start at 0 — prefill from an empty cache, the cache-free forward,
the encoder, cross-attention — runs the flash_attn kernel (`mha`: the
CUDA kernel for a CUDA tensor, its plain version on the CPU); every other
call (decode against a cache) runs the dense lowering below in torch ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attn.ops import mha
from .config import ModelConfig


def normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std²) values of `dtype` drawn from `gen` on `device`."""
    return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)


def rmsnorm(x, w, eps: float = 1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * (1.0 + w)


def init_norm(cfg: ModelConfig, dtype, device):
    return torch.zeros((cfg.d_model,), dtype=dtype, device=device)


def rope(x, positions, theta: float):
    """x: (..., S, H, D) rotary over last dim; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., :, None, None].float() * freqs        # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Standard (GQA) attention.
# ---------------------------------------------------------------------------

def init_attn(gen, cfg: ModelConfig, dtype, device):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = d ** -0.5
    p = {
        "wq": normal(gen, (d, H * hd), scale, dtype, device),
        "wk": normal(gen, (d, Hkv * hd), scale, dtype, device),
        "wv": normal(gen, (d, Hkv * hd), scale, dtype, device),
        "wo": normal(gen, (H * hd, d), (H * hd) ** -0.5, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hkv * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _mask(sq, sk, q_start, k_start, window, dtype, device):
    """(sq, sk) additive mask: causal plus optional local window.

    k_start is the global position of the first key — nonzero when a
    local layer's cache keeps only the last `window` positions."""
    q_pos = q_start + torch.arange(sq, device=device)[:, None]
    k_pos = k_start + torch.arange(sk, device=device)[None, :]
    ok = q_pos >= k_pos
    if window:
        ok &= (q_pos - k_pos) < window
    return torch.where(ok, 0.0, -1e30).to(dtype)


# Above this many query positions, the dense lowering runs in query chunks
# of this size, so the (B, H, S, Sk) score tensor never materializes whole.
CHUNK_Q = 2048


def _attn_dense(q, k, v, cfg: ModelConfig, *, q_start, k_start, window, causal):
    B, S, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (D ** -0.5)
    if cfg.attn_softcap:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    if causal:
        s = s + _mask(S, k.shape[1], q_start, k_start, window, s.dtype, s.device)[None, None]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.reshape(B, S, H * D)


def attn_scores(q, k, v, cfg: ModelConfig, *, q_start=0, k_start=0, window=0,
                causal=True):
    """q: (B,S,H,D); k/v: (B,Sk,Hkv,D) -> (B,S,H*D).

    Routing is a rule on the call's positions alone: q_start == k_start
    == 0 goes to `mha` (the flash_attn kernel), anything else to the
    dense lowering."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if q_start == 0 and k_start == 0:
        out = mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=causal, window=(window or None) if causal else None,
                  softcap=cfg.attn_softcap or None)
        return out.transpose(1, 2).reshape(B, S, H * D)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    if causal and S > CHUNK_Q and S % CHUNK_Q == 0:
        outs = [_attn_dense(q[:, i:i + CHUNK_Q], k, v, cfg, q_start=q_start + i,
                            k_start=k_start, window=window, causal=True)
                for i in range(0, S, CHUNK_Q)]
        return torch.cat(outs, dim=1)
    return _attn_dense(q, k, v, cfg, q_start=q_start, k_start=k_start,
                       window=window, causal=causal)


def apply_attn(p, x, cfg: ModelConfig, *, window=0, cache=None, pos=0,
               causal=True, kv_override=None):
    """Returns (out, new_cache).  cache = dict(k=(B,Sc,Hkv,D), v=...) holding
    the last Sc positions (Sc = window for local layers); decode appends
    the current token's kv.  kv_override: cross-attention — kv computed
    from the given memory, no rope, no cache."""
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kv_src = kv_override if kv_override is not None else x
    q = x @ p["wq"]
    k = kv_src @ p["wk"]
    v = kv_src @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, kv_src.shape[1], Hkv, hd)
    v = v.reshape(B, kv_src.shape[1], Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if kv_override is not None:
        out = attn_scores(q, k, v, cfg, causal=False)
        return out @ p["wo"], None
    positions = (pos + torch.arange(S, device=x.device)).expand(B, S)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        k_all = torch.cat([cache["k"], k], dim=1)
        v_all = torch.cat([cache["v"], v], dim=1)
    else:
        k_all, v_all = k, v
    k_start = pos + S - k_all.shape[1]
    out = attn_scores(q, k_all, v_all, cfg, q_start=pos, k_start=k_start,
                      window=window, causal=causal)
    if cache is not None and window and k_all.shape[1] > window:
        k_all = k_all[:, -window:]
        v_all = v_all[:, -window:]
    new_cache = {"k": k_all, "v": v_all}
    return out @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v2).  The KV cache stores
# only the compressed latent (kv_lora_rank + rope_head_dim per token).
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig, dtype, device):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    ql, kl, rd = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim
    s = d ** -0.5
    return {
        "q_down": normal(gen, (d, ql), s, dtype, device),
        "q_norm": torch.zeros((ql,), dtype=dtype, device=device),
        "q_up": normal(gen, (ql, H * (hd + rd)), ql ** -0.5, dtype, device),
        "kv_down": normal(gen, (d, kl + rd), s, dtype, device),
        "kv_norm": torch.zeros((kl,), dtype=dtype, device=device),
        "k_up": normal(gen, (kl, H * hd), kl ** -0.5, dtype, device),
        "v_up": normal(gen, (kl, H * hd), kl ** -0.5, dtype, device),
        "wo": normal(gen, (H * hd, d), (H * hd) ** -0.5, dtype, device),
    }


def apply_mla(p, x, cfg: ModelConfig, *, cache=None, pos=0, causal=True, **_):
    B, S, d = x.shape
    H, hd, rd, kl = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.kv_lora_rank
    q = rmsnorm(x @ p["q_down"], p["q_norm"], cfg.norm_eps) @ p["q_up"]
    q = q.reshape(B, S, H, hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    kv = x @ p["kv_down"]                             # (B,S,kl+rd)
    latent = rmsnorm(kv[..., :kl], p["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., kl:][:, :, None, :]              # (B,S,1,rd) shared head
    posb = (pos + torch.arange(S, device=x.device)).expand(B, S)
    q_rope = rope(q_rope, posb, cfg.rope_theta)
    k_rope = rope(k_rope, posb, cfg.rope_theta)
    lat_rope = torch.cat([latent, k_rope[:, :, 0, :]], dim=-1)  # cacheable
    if cache is not None:
        lat_all = torch.cat([cache["latent"], lat_rope], dim=1)
    else:
        lat_all = lat_rope
    latent_all, k_rope_all = lat_all[..., :kl], lat_all[..., kl:]
    k_nope = (latent_all @ p["k_up"]).reshape(B, -1, H, hd)
    vv = (latent_all @ p["v_up"]).reshape(B, -1, H, hd)
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
         + torch.einsum("bqhr,bkr->bhqk", q_rope, k_rope_all)).float()
    s = s * ((hd + rd) ** -0.5)
    if causal:
        k_start = pos + S - lat_all.shape[1]
        s = s + _mask(S, lat_all.shape[1], pos, k_start, 0, s.dtype, s.device)[None, None]
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", pr, vv).reshape(B, S, H * hd)
    return out @ p["wo"], {"latent": lat_all}


# ---------------------------------------------------------------------------
# Gated MLP.
# ---------------------------------------------------------------------------

def activation(name: str):
    """The MLP activation; "gelu" is the tanh approximation, JAX's default."""
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def init_mlp(gen, cfg: ModelConfig, dtype, device, ff: int | None = None):
    d = cfg.d_model
    ff = ff or cfg.d_ff
    p = {
        "w_gate": normal(gen, (d, ff), d ** -0.5, dtype, device),
        "w_down": normal(gen, (ff, d), ff ** -0.5, dtype, device),
    }
    if cfg.mlp_gated:
        p["w_up"] = normal(gen, (d, ff), d ** -0.5, dtype, device)
    return p


def apply_mlp(p, x, cfg: ModelConfig):
    h = activation(cfg.mlp_act)(x @ p["w_gate"])
    if cfg.mlp_gated:
        h = h * (x @ p["w_up"])
    return h @ p["w_down"]
