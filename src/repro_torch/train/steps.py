"""Step builders: train (loss + AdamW, optional gradient compression),
prefill, decode."""
from __future__ import annotations

import torch

from ..models import lm
from ..models.config import ModelConfig
from .compression import compress_with_feedback, init_error
from .optim import adamw_init, adamw_update


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, compress_grads: bool = False):
    """Returns step(params, opt, batch) -> (params, opt, metrics).

    batch: dict with tokens, labels (+ patches / enc_embeds stubs).  The
    gradients come from `torch.autograd.grad` over the parameter leaves
    (no `.grad` accumulates); params and opt are updated in place and
    returned, the reference launcher's donation.  metrics: "loss" and
    "grad_norm" (of the gradients AdamW receives, so the compressed ones
    under compression), 0-d float32 tensors on the parameters' device."""

    def step(params, opt, batch):
        live = lm.tree_map(lambda a: a.detach().requires_grad_(), params)
        with torch.enable_grad():
            lval = lm.loss_fn(live, cfg, batch["tokens"], batch["labels"],
                              enc_embeds=batch.get("enc_embeds"),
                              patches=batch.get("patches"))
            flat = torch.autograd.grad(lval, lm.tree_leaves(live))
        del live
        it = iter(flat)
        grads = lm.tree_map(lambda _: next(it), params)
        del flat, it
        if compress_grads:
            grads, err = compress_with_feedback(grads, opt["err"])
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in lm.tree_leaves(grads)))
        params, adam = adamw_update(grads, opt["adam"], params, lr=lr)
        new_opt = {"adam": adam}
        if compress_grads:
            new_opt["err"] = err
        return params, new_opt, {"loss": lval.detach(), "grad_norm": gnorm}

    return step


def init_opt(cfg: ModelConfig, params, *, compress_grads: bool = False) -> dict:
    opt = {"adam": adamw_init(params)}
    if compress_grads:
        opt["err"] = init_error(params)
    return opt


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
