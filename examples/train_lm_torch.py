"""Train a ~100M-parameter LM for a few hundred steps on the PyTorch/CUDA
port, with checkpoints: the twin of `examples/train_lm.py`.

The config is a scaled-down starcoder2 (same code path as the 3B
config), trained in float32 on the card (`main(device="cpu")` runs on
the host).  Checkpoints go under `.scratch/train_lm_torch/` in the
checkout unless `--ckpt-dir` says otherwise.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train import steps as steps_mod

CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        ".scratch", "train_lm_torch")


def config_100m() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-100m", d_model=512, n_layers=8, vocab=32768,
        n_heads=8, n_kv_heads=2, head_dim=64,
        pattern=("attn",), d_ff=2048, mlp_gated=False,
        tie_embeddings=True)


def main(argv=None, device="cuda") -> dict:
    """Train on `device`; returns the losses and the seconds of each step
    (ended by reading its loss), which it also prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args = ap.parse_args(argv)

    cfg = config_100m()
    device = torch.device(device)
    print(f"{cfg.name}: {lm.param_count(cfg)/1e6:.1f}M params")
    params = lm.init_params(torch.Generator(device).manual_seed(0), cfg, torch.float32, device)
    opt = steps_mod.init_opt(cfg, params)
    step = steps_mod.make_train_step(cfg, lr=3e-4)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    losses, seconds = [], []
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device, torch.int64)
                 for k, v in pipe.next_batch().items()}
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        seconds.append(time.perf_counter() - t0)
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}")
        if (i + 1) % 100 == 0:
            ckpt.save(i + 1, params, opt, extra={"pipeline": pipe.state_dict()})
    ckpt.wait()
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    print(f"step seconds on {device}: median {np.median(seconds[1:] or seconds):.5f} "
          f"(first step {seconds[0]:.5f}, ended by reading the loss)")
    return {"losses": losses, "seconds": seconds}


if __name__ == "__main__":
    main()
