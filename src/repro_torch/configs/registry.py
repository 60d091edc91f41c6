"""Architecture registry + shape cells.

The 40 dry-run cells are (arch x its shape set); ``long_500k`` runs only
for sub-quadratic architectures (SSM / recurrent / local-dominated) and
is recorded as SKIP(full-attention) for the rest.  `input_specs` gives
each cell's inputs as meta tensors (shapes and dtypes, no storage).
"""
from __future__ import annotations

import importlib

import torch

from ..models.config import ModelConfig

_MODULES = {
    "mamba2-1.3b": "mamba2_1_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "phi3.5-moe-42b": "phi3_5_moe_42b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "gemma3-27b": "gemma3_27b",
    "qwen2-72b": "qwen2_72b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma2-27b": "gemma2_27b",
    "whisper-large-v3": "whisper_large_v3",
}

# Sub-quadratic archs that run the long_500k cell.
LONG_OK = {"mamba2-1.3b", "recurrentgemma-9b", "gemma3-27b", "gemma2-27b"}

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

ARCHS = list(_MODULES)


def _mod(arch: str):
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke()


def shape_cells(arch: str) -> list[tuple[str, str | None]]:
    """[(shape_name, skip_reason_or_None)] — all four, with skips marked."""
    out = []
    for name in SHAPES:
        if name == "long_500k" and arch not in LONG_OK:
            out.append((name, "SKIP(full-attention)"))
        else:
            out.append((name, None))
    return out


def input_specs(cfg: ModelConfig, shape: str, dtype=torch.bfloat16) -> dict:
    """Meta-tensor stand-ins (`device="meta"`) for every model input of
    one cell, under the reference's keys and shapes.

    train  : tokens + labels (+ frontend stubs)
    prefill: tokens (+ stubs) — builds the cache
    decode : one new token + a filled cache of seq_len context
    """
    info = SHAPES[shape]
    S, B, kind = info["seq"], info["batch"], info["kind"]
    d = cfg.d_model
    tok = lambda b, s: torch.empty((b, s), dtype=torch.int32, device="meta")
    emb = lambda b, s: torch.empty((b, s, d), dtype=dtype, device="meta")

    specs: dict = {"kind": kind, "seq": S, "batch": B}
    if kind == "train":
        specs["tokens"] = tok(B, S)
        specs["labels"] = tok(B, S)
        if cfg.frontend == "vision":
            from .phi_3_vision_4_2b import N_PATCHES
            specs["patches"] = emb(B, N_PATCHES)
        if cfg.is_enc_dec:
            specs["enc_embeds"] = emb(B, max(S // 4, 128))
    elif kind == "prefill":
        specs["tokens"] = tok(B, S)
        if cfg.frontend == "vision":
            from .phi_3_vision_4_2b import N_PATCHES
            specs["patches"] = emb(B, N_PATCHES)
        if cfg.is_enc_dec:
            specs["enc_embeds"] = emb(B, max(S // 4, 128))
    else:  # decode: one token against a seq_len cache
        specs["tokens"] = tok(B, 1)
        specs["cache_len"] = S
        if cfg.is_enc_dec:
            specs["enc_embeds"] = emb(B, max(S // 4, 128))
    return specs
