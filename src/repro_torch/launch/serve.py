"""Serving driver: prefill + batched greedy decode with KV caches, on one
device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b --smoke \
      --batch 4 --prompt-len 64 --gen 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..models import lm
from ..models.config import ModelConfig
from ..train import steps as steps_mod

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_batch(cfg: ModelConfig, B: int, S: int, *, seed: int = 0,
               dtype=torch.float32, device="cuda") -> dict:
    """Random prompts from numpy (tokens (B, S)) plus the frontend stubs:
    8 patch embeddings for the vision architecture, S // 4 encoder frames
    for the enc-dec one."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(device)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(
            rng.standard_normal((B, 8, cfg.d_model), dtype=np.float32)).to(device, dtype)
    if cfg.is_enc_dec:
        batch["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((B, S // 4, cfg.d_model), dtype=np.float32)).to(device, dtype)
    return batch


def generate(params, cfg: ModelConfig, batch: dict, gen: int, *, on_step=None):
    """Prefill the prompts, then `gen` greedy decode steps.  Returns the
    tokens (B, gen + 1) — the prefill's pick and one per decode step — and
    the final caches.  `on_step(stage, logits, caches)`, when given, runs
    after the prefill ("prefill") and after each decode step ("decode")."""
    S = batch["tokens"].shape[1]
    prefill = steps_mod.make_prefill_step(cfg)
    decode = steps_mod.make_decode_step(cfg)
    logits, caches = prefill(params, batch)
    if on_step is not None:
        on_step("prefill", logits, caches)
    tok = logits.argmax(dim=-1)[:, None]
    toks = [tok]
    for i in range(gen):
        dbatch = {"tokens": tok}
        if cfg.is_enc_dec:
            dbatch["enc_embeds"] = batch["enc_embeds"]
        logits, caches = decode(params, caches, dbatch, pos=S + i)
        if on_step is not None:
            on_step("decode", logits, caches)
        tok = logits.argmax(dim=-1)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1), caches


def main(argv=None, device="cuda", on_step=None):
    """Parse `argv`, init the parameters from a seeded generator, serve one
    random batch and print the first prompt's tokens.  `on_step` is passed
    on to `generate`, after the prefill time is printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="parameter and activation dtype")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(device)
    dtype = DTYPES[args.dtype]
    B, S = args.batch, args.prompt_len
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(gen, cfg, dtype, device)
    batch = make_batch(cfg, B, S, seed=0, dtype=dtype, device=device)

    t0 = [time.perf_counter()]

    def report(stage, logits, caches):
        if stage == "prefill":
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"prefill {B}x{S}: {time.perf_counter() - t0[0]:.2f}s")
        if on_step is not None:
            on_step(stage, logits, caches)

    out, _ = generate(params, cfg, batch, args.gen, on_step=report)
    print("generated:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
