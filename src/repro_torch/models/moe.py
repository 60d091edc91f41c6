"""Grouped top-k mixture of experts (phi3.5-moe, deepseek-v2).

Capacity routing in the MaxText style: tokens are grouped by sequence
(group = one sequence), each expert gathers its top-C tokens per group
(C = S * k / E * capacity_factor), computes the FFN on the gathered
block, and scatter-adds (`index_add_`) weighted outputs back.

FLOPs land at E * C ~ k * capacity_factor per token — near the ideal
active-parameter count.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import activation, normal


def init_moe(gen, cfg: ModelConfig, dtype, device):
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": normal(gen, (d, E), d ** -0.5, dtype, device),
        "w_gate": normal(gen, (E, d, ff), d ** -0.5, dtype, device),
        "w_up": normal(gen, (E, d, ff), d ** -0.5, dtype, device),
        "w_down": normal(gen, (E, ff, d), ff ** -0.5, dtype, device),
    }
    if cfg.n_shared_experts:
        sf = ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": normal(gen, (d, sf), d ** -0.5, dtype, device),
            "w_up": normal(gen, (d, sf), d ** -0.5, dtype, device),
            "w_down": normal(gen, (sf, d), sf ** -0.5, dtype, device),
        }
    return p


def apply_moe(p, x, cfg: ModelConfig):
    """x: (B, S, d) — B is the group axis."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    C = max(1, int(S * k / E * cfg.capacity_factor))
    C = min(C, S)

    logits = (x @ p["router"]).float()                    # (B, S, E)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1, sorted=True)  # (B, S, k)
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    # dense (B, S, E) combine weights, zero outside top-k
    W = torch.zeros((B, S, E), dtype=torch.float32, device=x.device).scatter(-1, topi, topv)

    # per (group, expert): select top-C tokens by weight
    We = W.transpose(1, 2)                                # (B, E, S)
    sel_w, sel_i = torch.topk(We, C, dim=-1, sorted=True)  # (B, E, C)
    rows = torch.arange(B, device=x.device)[:, None, None]
    xg = x[rows, sel_i]                                   # (B, E, C, d)
    act = activation(cfg.mlp_act)
    h = act(torch.einsum("becd,edf->becf", xg, p["w_gate"])) \
        * torch.einsum("becd,edf->becf", xg, p["w_up"])
    y_e = torch.einsum("becf,efd->becd", h, p["w_down"])  # (B, E, C, d)
    y_e = y_e * sel_w[..., None].to(y_e.dtype)
    # scatter-add back to token positions (group-local segment sum)
    flat_i = (sel_i + rows * S).reshape(-1)
    out = torch.zeros((B * S, d), dtype=y_e.dtype, device=x.device)
    out.index_add_(0, flat_i, y_e.reshape(-1, d))
    out = out.reshape(B, S, d)

    if cfg.n_shared_experts:
        sp = p["shared"]
        out = out + (act(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    return out.to(x.dtype)
