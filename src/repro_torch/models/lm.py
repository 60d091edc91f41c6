"""Model assembly: parameter init, forward pass over stacked units, caches.

Depth is organized as repeating *units* (cfg.pattern).  Parameters of the
u-th unit's s-th slot live in params["units"][s] stacked along a leading
n_units axis (the JAX package's scanned layout, so parameters and caches
carry across between the packages as numpy arrays); the forward pass
loops over that axis.  Caches mirror the same layout.

Entry points, shared by every architecture:
  forward(..., tokens|embeds, caches=None, pos=0)       train / prefill
  forward(..., caches=filled, pos=ctx_len)              decode (S=1)
  forward_hidden + unembed                              the same, split at
                                                        the tied head
  loss_fn(..., tokens, labels)                          training loss
  enc-dec (whisper): the non-causal encoder stack runs on the
  frontend-stub embeddings; decoder blocks add cross-attention over it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .config import ModelConfig
from .layers import (apply_attn, apply_mla, apply_mlp, init_attn, init_mla,
                     init_mlp, init_norm, normal, rmsnorm)
from .moe import apply_moe, init_moe
from .seqmix import apply_rglru, apply_ssm, init_rglru, init_ssm


def tree_map(fn, *trees):
    """`fn` over the tensor leaves of nested dicts / lists with one layout."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *parts) for parts in zip(*trees)]
    if t0 is None:
        return None
    return fn(*trees)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# Block init / apply (one layer).
# ---------------------------------------------------------------------------

def init_block(gen, kind: str, cfg: ModelConfig, dtype, device):
    if kind == "ssm":
        return {"norm": init_norm(cfg, dtype, device),
                "ssm": init_ssm(gen, cfg, dtype, device)}
    if kind == "rglru":
        return {"norm1": init_norm(cfg, dtype, device),
                "rglru": init_rglru(gen, cfg, dtype, device),
                "norm2": init_norm(cfg, dtype, device),
                "mlp": init_mlp(gen, cfg, dtype, device)}
    # attention kinds: attn | local | xdec (decoder w/ cross-attention)
    p = {"norm1": init_norm(cfg, dtype, device),
         "attn": (init_mla(gen, cfg, dtype, device) if cfg.use_mla
                  else init_attn(gen, cfg, dtype, device)),
         "norm2": init_norm(cfg, dtype, device)}
    if kind == "xdec":
        p["xattn"] = init_attn(gen, cfg, dtype, device)
        p["norm_x"] = init_norm(cfg, dtype, device)
    if cfg.is_moe:
        p["mlp"] = init_moe(gen, cfg, dtype, device)
    elif cfg.d_ff:
        p["mlp"] = init_mlp(gen, cfg, dtype, device)
    return p


def apply_block(p, x, kind: str, cfg: ModelConfig, *, cache=None, pos=0,
                causal=True, enc_out=None):
    if kind == "ssm":
        y, nc = apply_ssm(p["ssm"], rmsnorm(x, p["norm"], cfg.norm_eps), cfg, cache=cache)
        return x + y, nc
    if kind == "rglru":
        y, nc = apply_rglru(p["rglru"], rmsnorm(x, p["norm1"], cfg.norm_eps), cfg, cache=cache)
        h = x + y
        h = h + apply_mlp(p["mlp"], rmsnorm(h, p["norm2"], cfg.norm_eps), cfg)
        return h, nc
    window = cfg.window if kind == "local" else 0
    attn_fn = apply_mla if cfg.use_mla else apply_attn
    y, nc = attn_fn(p["attn"], rmsnorm(x, p["norm1"], cfg.norm_eps), cfg,
                    window=window, cache=cache, pos=pos, causal=causal)
    h = x + y
    if kind == "xdec":
        # cross-attention: kv from the encoder output (no cache growth).
        q_in = rmsnorm(h, p["norm_x"], cfg.norm_eps)
        y, _ = apply_attn(p["xattn"], q_in, cfg, cache=None, pos=0, causal=False,
                          kv_override=enc_out)
        h = h + y
    if "mlp" in p:
        mlp_fn = apply_moe if cfg.is_moe else apply_mlp
        h = h + mlp_fn(p["mlp"], rmsnorm(h, p["norm2"], cfg.norm_eps), cfg)
    return h, nc


# ---------------------------------------------------------------------------
# Caches.
# ---------------------------------------------------------------------------

def _slot_cache_shape(kind: str, cfg: ModelConfig, B: int, ctx: int, dtype, device):
    """Empty/filled cache dict for ONE layer of `kind` with ctx tokens."""
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    if kind == "ssm":
        return {"state": z(B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                "conv": z(B, cfg.conv_width - 1,
                          cfg.ssm_heads * cfg.ssm_head_dim + 2 * cfg.ssm_state)}
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"h": z(B, w), "conv": z(B, cfg.conv_width - 1, w)}
    keep = min(ctx, cfg.window) if kind == "local" and cfg.window else ctx
    if cfg.use_mla:
        return {"latent": z(B, keep, cfg.kv_lora_rank + cfg.rope_head_dim)}
    return {"k": z(B, keep, cfg.n_kv_heads, cfg.hd),
            "v": z(B, keep, cfg.n_kv_heads, cfg.hd)}


def make_cache(cfg: ModelConfig, B: int, ctx: int, dtype=torch.bfloat16, device="cuda"):
    """Stacked per-slot caches matching the stacked parameter layout."""
    units = [tree_map(lambda a: a.expand((cfg.n_units,) + a.shape),
                      _slot_cache_shape(kind, cfg, B, ctx, dtype, device))
             for kind in cfg.unit]
    tail = [_slot_cache_shape(kind, cfg, B, ctx, dtype, device) for kind in cfg.tail]
    return {"units": units, "tail": tail}


# ---------------------------------------------------------------------------
# Parameter init.
# ---------------------------------------------------------------------------

def _stacked(gen, kind, count, cfg, dtype, device):
    """`count` layers of `kind` stacked on a leading axis, drawn one layer
    at a time into the preallocated stack (peak: the stack + one layer)."""
    shapes = init_block(None, kind, cfg, dtype, "meta")
    stack = tree_map(lambda a: torch.empty((count,) + a.shape, dtype=dtype, device=device),
                     shapes)
    for i in range(count):
        tree_map(lambda s, a: s[i].copy_(a), stack, init_block(gen, kind, cfg, dtype, device))
    return stack


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device="cuda"):
    """Random parameters from `gen` (a generator on `device`) in the JAX
    package's layout.  device="meta" gives the shapes without memory."""
    d, V = cfg.d_model, cfg.vocab
    params = {"embed": normal(gen, (V, d), 0.02, dtype, device),
              "final_norm": init_norm(cfg, dtype, device)}
    if not cfg.tie_embeddings:
        params["head"] = normal(gen, (d, V), d ** -0.5, dtype, device)
    params["units"] = [_stacked(gen, kind, cfg.n_units, cfg, dtype, device)
                       for kind in cfg.unit]
    params["tail"] = [init_block(gen, kind, cfg, dtype, device) for kind in cfg.tail]
    if cfg.is_enc_dec:
        params["enc_units"] = [_stacked(gen, "attn", cfg.enc_layers, cfg, dtype, device)]
        params["enc_norm"] = init_norm(cfg, dtype, device)
    return params


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count, from the tensors `init_params` makes on the
    meta device (no memory, no random draws)."""
    params = init_params(None, cfg, torch.bfloat16, "meta")
    return sum(math.prod(t.shape) for t in tree_leaves(params))


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """The JAX package's parameter pytree, leaves as numpy arrays (stacked
    unit axes included), as tensors on `device`.  Raises unless the tree
    has exactly the layout and shapes `init_params` gives for `cfg`."""
    like = init_params(None, cfg, torch.float32, "meta")

    def convert(path, ref, arr):
        if isinstance(ref, dict):
            if not isinstance(arr, dict) or set(arr) != set(ref):
                raise ValueError(f"{path}: keys {sorted(arr) if isinstance(arr, dict) else arr!r}"
                                 f" != {sorted(ref)}")
            return {k: convert(f"{path}/{k}", ref[k], arr[k]) for k in ref}
        if isinstance(ref, list):
            if not isinstance(arr, (list, tuple)) or len(arr) != len(ref):
                raise ValueError(f"{path}: expected a list of {len(ref)}")
            return [convert(f"{path}/{i}", r, a) for i, (r, a) in enumerate(zip(ref, arr))]
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(ref.shape)}")
        return torch.from_numpy(np.array(arr)).to(device)

    return convert("params", like, tree)


def caches_from_numpy(tree, device="cuda"):
    """The JAX package's cache pytree (`make_cache` / `forward` layout),
    leaves as numpy arrays, as tensors on `device`."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------

def _unstack(stack) -> list:
    """The layers of a stacked tree, each a tree of views: one
    `torch.unbind` per leaf, whose backward stacks the layers' gradients
    once (indexing each layer instead would add a zero tensor the size of
    the whole stack per layer)."""
    per_leaf = [a.unbind(0) for a in tree_leaves(stack)]
    layers = []
    for i in range(len(per_leaf[0]) if per_leaf else 0):
        it = iter(leaves[i] for leaves in per_leaf)
        layers.append(tree_map(lambda _: next(it), stack))
    return layers


def _run_units(params_units, caches_units, x, cfg, *, pos, causal, enc_out,
               unit=None):
    """One unit body per layer over the stacked unit parameters; the new
    caches are stacked again, one layer at a time into the new stack."""
    new_caches = []
    kinds = unit if unit is not None else cfg.unit
    for s, kind in enumerate(kinds):
        pstack = params_units[s]
        cstack = caches_units[s] if caches_units is not None else None
        count = tree_leaves(pstack)[0].shape[0]
        p_layers = _unstack(pstack)
        c_layers = _unstack(cstack) if cstack is not None else [None] * count
        stack = None
        for i in range(count):
            p_i, c_i = p_layers[i], c_layers[i]
            x, nc = apply_block(p_i, x, kind, cfg, cache=c_i, pos=pos,
                                causal=causal, enc_out=enc_out)
            if cstack is None:
                continue
            if stack is None:
                stack = tree_map(lambda a: torch.empty((count,) + a.shape, dtype=a.dtype,
                                                       device=a.device), nc)
            tree_map(lambda st, a: st[i].copy_(a), stack, nc)
            del nc
        if cstack is not None and stack is None:   # a slot with no layers
            stack = cstack
        new_caches.append(stack)
    return x, new_caches


def forward_hidden(params, cfg: ModelConfig, tokens=None, embeds=None, caches=None,
                   pos=0, enc_embeds=None, patches=None):
    """`forward` up to and including the final norm: (x, new_caches)."""
    d = cfg.d_model
    if embeds is not None:
        x = embeds
    else:
        embed = params["embed"]
        x = embed[tokens] * torch.tensor(d ** 0.5, dtype=embed.dtype, device=embed.device)
        if patches is not None:
            x[:, :patches.shape[1]] = patches.to(x.dtype)

    enc_out = None
    if cfg.is_enc_dec:
        if enc_embeds is None:
            raise ValueError("enc-dec needs encoder inputs")
        e, _ = _run_units(params["enc_units"], None, enc_embeds,
                          cfg, pos=0, causal=False, enc_out=None, unit=("attn",))
        enc_out = rmsnorm(e, params["enc_norm"], cfg.norm_eps)

    caches_units = caches["units"] if caches is not None else None
    x, new_unit_caches = _run_units(params["units"], caches_units, x, cfg,
                                    pos=pos, causal=True, enc_out=enc_out)
    new_tail = []
    for s, kind in enumerate(cfg.tail):
        c = caches["tail"][s] if caches is not None else None
        x, nc = apply_block(params["tail"][s], x, kind, cfg, cache=c, pos=pos,
                            causal=True, enc_out=enc_out)
        new_tail.append(nc)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    new_caches = {"units": new_unit_caches, "tail": new_tail} if caches is not None else None
    return x, new_caches


def unembed(params, cfg: ModelConfig, x):
    """Logits of final-normed hidden states x: the (tied) head, then the
    logit softcap."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["head"]
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def forward(params, cfg: ModelConfig, tokens=None, embeds=None, caches=None,
            pos=0, enc_embeds=None, patches=None):
    """Returns (logits, new_caches).

    tokens: (B, S) int64 — standard path.
    embeds: (B, S, d) — full frontend-stub path (embeds replace tokens).
    patches: (B, P, d) — vision-stub path: patch embeddings overwrite the
             first P positions of the token embedding (phi-3-vision).
    enc_embeds: (B, S_enc, d) — encoder input for enc-dec models.
    """
    x, new_caches = forward_hidden(params, cfg, tokens=tokens, embeds=embeds,
                                   caches=caches, pos=pos, enc_embeds=enc_embeds,
                                   patches=patches)
    return unembed(params, cfg, x), new_caches


def loss_fn(params, cfg: ModelConfig, tokens, labels, embeds=None,
            enc_embeds=None, patches=None):
    """Mean next-token cross-entropy: float32 logits, logsumexp minus the
    gold logit.  labels: (B, S) integer tensor."""
    logits, _ = forward(params, cfg, tokens=tokens, embeds=embeds,
                        enc_embeds=enc_embeds, patches=patches)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
