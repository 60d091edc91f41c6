"""Sequence mixers without attention: Mamba2 SSD and RG-LRU.

Mamba2 (SSD, state-space duality form): scalar-per-head decay a_t =
exp(dt * A_h); chunked evaluation — quadratic attention-like path inside
chunks of Q tokens, linear state recurrence across chunks (a loop over
chunks).  Decode is the O(1) recurrence  S <- a S + dt * B x;  y = C S + D x.

RG-LRU (recurrentgemma): gated linear recurrence
  r_t = sigmoid(W_r x), i_t = sigmoid(W_i x)
  log a_t = -c * softplus(L) * r_t
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
evaluated by a loop over positions for train/prefill (the JAX package's
associative scan computes the same recurrence) and the same O(1) update
for decode, preceded by a width-4 causal conv.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal

RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# Mamba2 SSD.
# ---------------------------------------------------------------------------

def init_ssm(gen, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    di = cfg.ssm_heads * cfg.ssm_head_dim
    N = cfg.ssm_state
    H = cfg.ssm_heads
    return {
        # projections for z (gate), x, B, C, dt
        "w_in": normal(gen, (d, 2 * di + 2 * N + H), d ** -0.5, dtype, device),
        "conv": normal(gen, (cfg.conv_width, di + 2 * N), 0.1, dtype, device),
        "A_log": torch.zeros((H,), dtype=dtype, device=device),
        "D": torch.ones((H,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((H,), dtype=dtype, device=device),
        "w_out": normal(gen, (di, d), di ** -0.5, dtype, device),
        "gate_norm": torch.zeros((di,), dtype=dtype, device=device),
    }


def _causal_conv(x, w):
    """x: (B, S, C); w: (W, C) depthwise causal conv via shifted adds."""
    W = w.shape[0]
    out = x * w[W - 1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1], :]
        out = out + shifted * w[W - 1 - i]
    return out


def _ssd_chunked(xh, a, B_, C_, chunk):
    """SSD scan.  xh: (B,S,H,P) dt-scaled inputs; a: (B,S,H) decay in (0,1];
    B_, C_: (B,S,N).  Returns ((B,S,H,P), final state (B,H,P,N))."""
    B, S, H, P = xh.shape
    N = B_.shape[-1]
    nc = S // chunk
    xc = xh.reshape(B, nc, chunk, H, P)
    ac = a.reshape(B, nc, chunk, H)
    Bc = B_.reshape(B, nc, chunk, N)
    Cc = C_.reshape(B, nc, chunk, N)
    loga = torch.log(ac + 1e-20)
    cum = torch.cumsum(loga, dim=2)                       # (B,nc,Q,H)
    # intra-chunk: y_t += C_t . sum_{s<=t} prod_{s<u<=t} a_u B_s x_s
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    decay = torch.where(tri[None, None, :, :, None], decay, 0.0)
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)           # (B,nc,Q,Q)
    y_intra = torch.einsum("bcts,bctsh,bcshp->bcthp", cb, decay, xc)
    # chunk states: S_c = sum_s prod_{s<u<=Q} a_u B_s x_s
    tail = torch.exp(cum[:, :, -1:, :] - cum)              # (B,nc,Q,H)
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc, tail, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)

    s = torch.zeros((B, H, P, N), dtype=xh.dtype, device=xh.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)                                     # state entering chunk c
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)                        # (B,nc,H,P,N)
    inter_decay = torch.exp(cum)                           # (B,nc,Q,H)
    y_inter = torch.einsum("bctn,bcth,bchpn->bcthp", Cc, inter_decay, s_in)
    return (y_intra + y_inter).reshape(B, S, H, P), s


def apply_ssm(p, x, cfg: ModelConfig, *, cache=None, **_):
    """Returns (out, new_cache); cache = dict(state=(B,H,P,N), conv=(B,W-1,C))."""
    B, S, d = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = H * P
    proj = x @ p["w_in"]
    z, xin, B_, C_, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xin, B_, C_], dim=-1)
    if cache is not None and S == 1:
        hist = torch.cat([cache["conv"], conv_in], dim=1)   # (B,W,C)
        conv_out = (hist * p["conv"][None]).sum(dim=1, keepdim=True)
        new_conv = hist[:, 1:, :]
    else:
        conv_out = _causal_conv(conv_in, p["conv"])
        new_conv = conv_in[:, -(cfg.conv_width - 1):, :]
    conv_out = F.silu(conv_out)
    xin, B_, C_ = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                     # (B,S,H)
    A = -torch.exp(p["A_log"].float())                             # (H,)
    a = torch.exp(dt * A)                                          # (B,S,H)
    xh = xin.reshape(B, S, H, P) * dt[..., None].to(x.dtype)
    if cache is not None and S == 1:
        s_prev = cache["state"]                                    # (B,H,P,N)
        s_new = s_prev * a[:, 0, :, None, None] \
            + torch.einsum("bhp,bn->bhpn", xh[:, 0], B_[:, 0])
        # s_new is float32 (a is): the reference's einsum promotes C_ to it
        y = torch.einsum("bn,bhpn->bhp", C_[:, 0].to(s_new.dtype),
                         s_new)[:, None]                           # (B,1,H,P)
        new_state = s_new
    else:
        pad = (-S) % cfg.ssm_chunk
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            a = F.pad(a, (0, 0, 0, pad), value=1.0)
            B_ = F.pad(B_, (0, 0, 0, pad))
            C_ = F.pad(C_, (0, 0, 0, pad))
        y, s_final = _ssd_chunked(xh.float(), a, B_.float(), C_.float(), cfg.ssm_chunk)
        y = y[:, :S]
        xh = xh[:, :S]                                # drop chunk padding
        new_state = s_final.to(x.dtype)               # decode handoff
    y = y.to(x.dtype) + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, di) * F.silu(z)
    y = y * torch.rsqrt(y.float().square().mean(dim=-1, keepdim=True)
                        + 1e-6).to(x.dtype) * (1.0 + p["gate_norm"])
    out = y @ p["w_out"]
    return out, {"state": new_state, "conv": new_conv}


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma).
# ---------------------------------------------------------------------------

def init_rglru(gen, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_x": normal(gen, (d, w), d ** -0.5, dtype, device),
        "w_y": normal(gen, (d, w), d ** -0.5, dtype, device),
        "conv": normal(gen, (cfg.conv_width, w), 0.1, dtype, device),
        "w_r": normal(gen, (w, w), w ** -0.5, dtype, device),
        "w_i": normal(gen, (w, w), w ** -0.5, dtype, device),
        "Lambda": torch.full((w,), 2.0, dtype=dtype, device=device),  # softplus -> decay
        "w_out": normal(gen, (w, d), w ** -0.5, dtype, device),
    }


def apply_rglru(p, x, cfg: ModelConfig, *, cache=None, **_):
    """Returns (out, new_cache); cache = dict(h=(B,w), conv=(B,W-1,w))."""
    B, S, d = x.shape
    gate_branch = F.gelu(x @ p["w_y"], approximate="tanh")
    u = x @ p["w_x"]
    if cache is not None and S == 1:
        hist = torch.cat([cache["conv"], u], dim=1)
        u_c = (hist * p["conv"][None]).sum(dim=1, keepdim=True)
        new_conv = hist[:, 1:, :]
    else:
        u_c = _causal_conv(u, p["conv"])
        new_conv = u[:, -(cfg.conv_width - 1):, :]
    r = torch.sigmoid(u_c @ p["w_r"]).float()
    i = torch.sigmoid(u_c @ p["w_i"])
    log_a = -RGLRU_C * F.softplus(p["Lambda"].float()) * r
    a = torch.exp(log_a)                                 # (B,S,w)
    gated = (i * u_c).float()
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    v = beta * gated
    if cache is not None and S == 1:
        h = a[:, 0] * cache["h"] + v[:, 0]
        y = h[:, None, :]
        new_h = h
    else:
        h = torch.zeros_like(v[:, 0])
        ys = []
        for t in range(S):
            h = a[:, t] * h + v[:, t]
            ys.append(h)
        y = torch.stack(ys, dim=1)
        new_h = y[:, -1, :]
    out = (y.to(x.dtype) * gate_branch) @ p["w_out"]
    return out, {"h": new_h.to(x.dtype), "conv": new_conv}
