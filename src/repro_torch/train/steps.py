"""Step builders: prefill and decode.  The training step and its
optimizer state are not ported yet."""
from __future__ import annotations

from ..models import lm
from ..models.config import ModelConfig


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, compress_grads: bool = False):
    raise NotImplementedError("the training step (loss, AdamW, gradient "
                              "compression) is not ported yet")


def init_opt(cfg: ModelConfig, params, *, compress_grads: bool = False):
    raise NotImplementedError("the optimizer state is not ported yet")


def make_prefill_step(cfg: ModelConfig):
    """step(params, batch) -> (last_logits, caches).

    The logits are computed for the last position only, the one a server
    samples from (the same values as `forward`'s last row)."""

    def step(params, batch):
        embed = params["embed"]
        B = batch["tokens"].shape[0]
        cache0 = lm.make_cache(cfg, B, 0, embed.dtype, embed.device)
        x, caches = lm.forward_hidden(
            params, cfg, tokens=batch["tokens"], caches=cache0, pos=0,
            patches=batch.get("patches"), enc_embeds=batch.get("enc_embeds"))
        return lm.unembed(params, cfg, x[:, -1, :]), caches

    return step


def make_decode_step(cfg: ModelConfig):
    """step(params, caches, batch, *, pos) -> (logits, new_caches).

    batch["tokens"]: (B, 1); pos is the context length the caches hold."""

    def step(params, caches, batch, *, pos: int):
        logits, new_caches = lm.forward(
            params, cfg, tokens=batch["tokens"], caches=caches, pos=pos,
            enc_embeds=batch.get("enc_embeds"))
        return logits[:, -1, :], new_caches

    return step
