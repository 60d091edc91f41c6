"""Gradient compression: int8 quantization with error feedback, the twin
of `repro/train/compression.py`.

  compress_with_feedback  per-leaf quantize / dequantize against one scale
                          per leaf (its largest |g + e| / 127), the
                          residual carried to the next step
  compressed_psum         int8-on-the-wire all-reduce over a mesh axis:
                          the ranks agree on one scale (MAX of their local
                          maxima), then sum the int8 payloads as int32

Rounding is half to even (`torch.round`, as `jnp.round`).
"""
from __future__ import annotations

import torch

from ..core.collectives import max_axis, sum_axis
from ..models.lm import tree_leaves, tree_map


def _quant(g32, scale):
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def _scale(max_abs):
    return torch.clamp(max_abs / 127.0, min=1e-12)


@torch.no_grad()
def compress_with_feedback(grads, error):
    """Returns (decompressed grads, new error).  The error tree (float32,
    congruent with grads; start from `init_error`) is updated in place
    and returned, as the launcher donates it."""
    out = []
    for g, e in zip(tree_leaves(grads), tree_leaves(error)):
        g32 = e.add_(g.float())
        scale = _scale(g32.abs().max())
        deq = _quant(g32, scale).float() * scale
        e.sub_(deq)
        out.append(deq.to(g.dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), grads), error


def init_error(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


@torch.no_grad()
def compressed_psum(g: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum `g` over the ranks of `axis` through int8 payloads: the MAX of
    the ranks' largest |g| sets one scale, each rank rounds g / scale to
    int8, and the int32 sum of the payloads comes back times the scale,
    in g's dtype."""
    g32 = g.float()
    scale = _scale(max_axis(g32.abs().max().reshape(1), mesh, axis)[0])
    total = sum_axis(_quant(g32, scale).to(torch.int32), mesh, axis)
    return (total.float() * scale).to(g.dtype)
