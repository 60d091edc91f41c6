"""Deterministic, checkpointable synthetic token pipeline.

Each (step, shard) pair maps to an independent counter-mode stream —
restoring a checkpoint at step k reproduces exactly the batches a
never-interrupted run would have seen (the fault-tolerance contract),
and each data shard draws a disjoint stream (the multi-host contract).

The "text" is a deterministic Markov-ish mixture so the loss actually
decreases during the example training runs (pure uniform noise would
pin the loss at log V).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    batch: int
    shard: int = 0
    num_shards: int = 1
    seed: int = 1234
    step: int = 0                      # checkpointable cursor

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed, "shard": self.shard}

    def load_state_dict(self, st: dict) -> None:
        assert st["seed"] == self.seed and st["shard"] == self.shard, \
            "restoring a pipeline onto a different stream"
        self.step = int(st["step"])

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.shard, step]))

    def next_batch(self) -> dict:
        rng = self._rng(self.step)
        self.step += 1
        B, S, V = self.batch, self.seq_len, self.vocab
        # structured stream: tokens follow t_{i+1} = (a*t_i + b) mod V with
        # occasional resets — predictable enough for loss to fall.
        a = int(rng.integers(2, 64)) * 2 + 1
        starts = rng.integers(0, V, (B, 1))
        idx = np.arange(S + 1)
        toks = (starts + idx * a) % V
        noise = rng.random((B, S + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, V, (B, S + 1)), toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
