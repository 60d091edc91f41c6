"""Launch wrapper of the CUDA flash-attention kernel (csrc/flash_attn.cu).

Replaces `repro/kernels/flash_attn/flash_attn.py`: `flash_attention`
(`_attn_kernel`).

Bound on the card: operations — 4·D FLOPs per visible (query, key) pair
against q, k, v and o each moved once.  The Pallas kernel walks a
sequential kv grid axis with m, l and the accumulator in VMEM scratch;
here one CTA owns a (batch·head, 64-query) tile and loops over key tiles
staged in shared memory, keeping m, l and the accumulator in registers,
and skips key tiles that the causal or window mask hides whole.  Two
kernels behind one entry, chosen by dtype: bfloat16 runs both products
on Hopper's warpgroup tensor-core instructions (wgmma; Q, K and V tiles
in bf16 in 128-byte swizzled shared memory, K/V by cp.async into a
double-buffered ring, P kept in registers as bf16 hi + lo fragments);
float32 keeps float32 FMAs on the CUDA cores, whose 1e-4 tolerance rules
out bf16 or TF32 products (source note in csrc/flash_attn.cu).

`LAUNCHES` counts kernel launches, one per call that reaches the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import library
from .. import on_device as _on

LAUNCHES = {"flash_attn": 0}

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TC_ROWS = 64          # query rows per CTA of the bfloat16 kernel


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when every row it holds starts on a 16-byte boundary
    (base and (batch, head, seq) strides), else a contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]):
        return t
    return t.contiguous()


def _lib():
    lib = library("flash_attn")
    if lib.flash_attn_launch.argtypes is None:
        lib.flash_attn_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _F, _F, _I, _P]
        lib.flash_attn_launch.restype = _I
    return lib


def flash_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) CUDA tensors of one dtype
    (float32 or bfloat16), each with unit stride in D and any other
    strides.  Returns (B, H, Sq, D), a view of a contiguous (B, Sq, H, D)
    buffer."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError("the flash_attn kernel takes CUDA tensors")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected a 4-d tensor with unit stride in "
                             f"its last dim, got {tuple(t.shape)} strides {t.stride()}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {list(_DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v must lie on one device")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape:
        raise ValueError(f"k, v must be (B={B}, Hkv, Sk, D={D}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if D < 8 or D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D} must be a multiple of 8 in [8, {MAX_HEAD_DIM}]")
    if B * H >= 1 << 16 or max(Sq, Sk) >= 1 << 30:
        raise ValueError(f"B*H={B * H} must be < 65536 and Sq, Sk < 2^30")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1 or None")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap={softcap} must be > 0 or None")
    if q.dtype == torch.bfloat16:
        if -(-Sq // _TC_ROWS) > 65535:
            raise ValueError(f"Sq={Sq} must be at most {65535 * _TC_ROWS} in bfloat16")
        # the tensor-core kernel stages rows by 16-byte copies
        q, k, v = (_aligned16(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _on(q.device):
        err = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), B, H, Hkv, Sq, Sk, D,
            int(causal), window or 0, softcap or 0.0,
            sm_scale if sm_scale is not None else D ** -0.5, _DTYPES[q.dtype], stream)
    LAUNCHES["flash_attn"] += 1
    if err != 0:
        raise RuntimeError(f"flash_attn: CUDA launch failed with error {err}")
    return out
