"""Training driver: config -> parameters on one device -> train loop with
checkpoint / restart, straggler heartbeats and optional gradient
compression; the twin of `repro/launch/train.py`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
      --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

`main(argv, device="cuda")` returns the losses.  The reference shards the
parameters over a mesh through `repro.dist.sharding`, which is not in the
tree; this driver runs on one device, and `--production-mesh` raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke_config
from ..data.pipeline import TokenPipeline
from ..models import lm
from ..runtime.checkpoint import CheckpointManager
from ..runtime.elastic import StragglerDetector
from ..train import steps as steps_mod


def _batch(np_batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device, torch.int64) for k, v in np_batch.items()}


def main(argv=None, device="cuda", on_step=None):
    """Parse `argv`, init float32 parameters from a seeded generator on
    `device` and train.  `on_step(step, loss, seconds)`, when given, runs
    after each step (seconds: the step, ended by reading its loss)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise ValueError("--production-mesh: the reference shards parameters through "
                         "repro.dist.sharding, which is not in the tree; this driver "
                         "trains on one device")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(device)
    print(f"arch={cfg.name} params={lm.param_count(cfg):,} device={device}")

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    step_fn = steps_mod.make_train_step(cfg, lr=args.lr, compress_grads=args.compress_grads)
    params = lm.init_params(torch.Generator(device).manual_seed(0), cfg, torch.float32, device)
    opt = steps_mod.init_opt(cfg, params, compress_grads=args.compress_grads)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        s = ckpt.latest_step()
        params, opt, extra = ckpt.restore(s, params, opt, device=device)
        pipe.load_state_dict(extra["pipeline"])
        start = s
        print(f"resumed from step {s}")

    detector = StragglerDetector()
    losses = []
    for step in range(start, args.steps):
        batch = _batch(pipe.next_batch(), device)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        detector.report(worker=0, step_time=dt)
        losses.append(loss)
        if on_step is not None:
            on_step(step, loss, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} {dt*1e3:7.1f} ms")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, params, opt, extra={"pipeline": pipe.state_dict()})
    if ckpt:
        ckpt.save(args.steps, params, opt, extra={"pipeline": pipe.state_dict()})
        ckpt.wait()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
