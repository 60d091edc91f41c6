"""AdamW, the JAX package's hand-rolled optimizer (`repro/train/optim.py`).

The optimizer state is a tree congruent with the parameters: first and
second moments in float32 and the integer step count.  The update runs
leaf by leaf, in place, under `torch.no_grad`, and returns the tensors it
was given: the reference launcher donates parameters and state to its
jitted step, and at full width (starcoder2-3b, float32) parameters,
gradients and both moments take 48.5 of the card's 80 GB, so the only
transients are two of one leaf's size.  The arithmetic is the reference's
in its order: bias corrections in float32 from the integer step, decay
`wd * p` added to the normalized moment, the delta cast to p's dtype.
"""
from __future__ import annotations

import torch

from ..models.lm import tree_leaves, tree_map


def adamw_init(params) -> dict:
    """{"m", "v": float32 zeros like params, "step": int32 0} on the
    parameters' device."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(grads, opt, params, *, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.01):
    """One AdamW step.  Updates `params`, opt["m"], opt["v"] and
    opt["step"] in place and returns (params, opt)."""
    step = opt["step"]
    step += 1
    sf = step.float()
    bc1 = 1.0 - b1 ** sf
    bc2 = 1.0 - b2 ** sf
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt["m"]),
                          tree_leaves(opt["v"]), tree_leaves(params)):
        g32 = g.float()
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        denom = torch.div(v, bc2).sqrt_().add_(eps)
        delta = torch.div(m, bc1).div_(denom)
        del denom
        delta.add_(p.float(), alpha=wd)
        p.sub_(delta.to(p.dtype), alpha=lr)
    return params, opt
