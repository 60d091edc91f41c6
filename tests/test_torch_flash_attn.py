"""Port parity for the flash_attn kernel's plain version, on the CPU.

`attention_ref` and the CPU path of `mha` (which runs `attention_ref`)
against the JAX package's Pallas `flash_attention` in interpret mode
(through `repro.kernels.flash_attn.ops.mha`) and its `attention_ref`, on
the same numpy-made inputs.  Tolerance 2e-5 in float32 and 2e-2 in
bfloat16, as `tests/test_kernels.py` holds the Pallas kernel: the blocked
online softmax and the dense one sum in different orders, and bfloat16
outputs round at 2^-8 relative.  Ragged lengths go against the JAX
`attention_ref` only, since the Pallas wrapper asserts tile divisibility.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_gpu_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attn import ops as jax_ops
from repro.kernels.flash_attn.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attn import flash_attn as fa_launch
from repro_torch.kernels.flash_attn import ops
from repro_torch.kernels.flash_attn.ref import attention_ref, mha_ref
from torch_cases import qkv_arrays

VARIANTS = [dict(causal=True), dict(causal=True, window=32),
            dict(causal=True, softcap=50.0), dict(causal=False)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(B, H, Hkv, Sq, Sk, D, dtype, seed=0):
    """numpy normals, rounded to `dtype` once, as both packages' inputs."""
    jdt, tdt = DTYPES[dtype]
    jx = [jnp.asarray(a, jdt) for a in qkv_arrays(B, H, Hkv, Sq, Sk, D, seed)]
    tx = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt) for j in jx]
    return jx, tx


def _err(got, exp):
    return float(np.abs(got.float().numpy() - np.asarray(exp.astype(jnp.float32))).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kwargs", VARIANTS, ids=["causal", "window", "softcap", "full"])
def test_mha_matches_pallas_interpret(dtype, kwargs):
    """The sweep of tests/test_kernels.py (B=2, H=4, Hkv=2, S=128, D=32)."""
    B, H, Hkv, S, D = 2, 4, 2, 128, 32
    (jq, jk, jv), (q, k, v) = _qkv(B, H, Hkv, S, S, D, dtype)
    exp = jax_ops.mha(jq, jk, jv, **kwargs)
    got = ops.mha(q, k, v, **kwargs)
    assert got.shape == (B, H, S, D) and got.dtype == q.dtype
    assert _err(got, exp) < TOL[dtype]
    # attention_ref on the flattened heads is mha's plain version
    kr = k.repeat_interleave(H // Hkv, dim=1).reshape(B * H, S, D)
    vr = v.repeat_interleave(H // Hkv, dim=1).reshape(B * H, S, D)
    ref = attention_ref(q.reshape(B * H, S, D), kr, vr, **kwargs).reshape(B, H, S, D)
    assert torch.equal(ref, got)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, Sq, Sk, D, kwargs)
    (1, 2, 2, 64, 128, 32, dict(causal=False)),                     # cross-attention, Sq != Sk
    (1, 4, 1, 128, 128, 32, dict(causal=True, window=16, softcap=50.0)),  # GQA 4/1
    (2, 2, 1, 128, 128, 64, dict(causal=True, softcap=30.0)),       # D = 64
], ids=["cross", "gqa4", "d64"])
def test_mha_more_shapes_match_pallas_interpret(dtype, case):
    B, H, Hkv, Sq, Sk, D, kwargs = case
    (jq, jk, jv), (q, k, v) = _qkv(B, H, Hkv, Sq, Sk, D, dtype, seed=1)
    exp = jax_ops.mha(jq, jk, jv, **kwargs)
    got = ops.mha(q, k, v, **kwargs)
    assert got.shape == (B, H, Sq, D)
    assert _err(got, exp) < TOL[dtype]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [
    (200, 200, dict(causal=True, window=64, softcap=50.0)),
    (77, 133, dict(causal=False)),
    (133, 77, dict(causal=True)),
    (150, 40, dict(causal=False, window=30)),     # rows past 69 see no key: 0
], ids=["ragged-window", "ragged-cross", "ragged-causal", "masked-rows"])
def test_ragged_lengths_match_jax_attention_ref(dtype, case):
    Sq, Sk, kwargs = case
    (jq, jk, jv), (q, k, v) = _qkv(1, 3, 3, Sq, Sk, 32, dtype, seed=2)
    exp = jax_attention_ref(jq[0], jk[0], jv[0], **kwargs)
    got = attention_ref(q[0], k[0], v[0], **kwargs)
    assert _err(got, exp) < TOL[dtype]
    assert torch.equal(ops.mha(q, k, v, **kwargs)[0], got)
    if "window" in kwargs and not kwargs["causal"]:
        dead = np.arange(Sq) - (Sk - 1) >= kwargs["window"]
        assert dead.any() and not got[:, dead].any()


def test_cpu_call_leaves_launch_count_unchanged():
    from repro_torch import kernels
    assert "flash_attn" in kernels.launch_counts()
    _, (q, k, v) = _qkv(1, 2, 1, 16, 16, 8, "float32")
    before = kernels.launch_counts()
    ops.mha(q, k, v, causal=True, window=4)
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError):      # the launch wrapper itself refuses CPU tensors
        fa_launch.flash_attn_cuda(q, k, v)


def test_mha_refuses_bad_head_ratio():
    _, (q, k, v) = _qkv(1, 3, 2, 16, 16, 8, "float32")
    with pytest.raises(ValueError):
        ops.mha(q, k, v)


# ---------------------------------------------------------------- budget
# chip_smoke.py's softcap cases (B, H, Hkv, Sq, Sk, D, kwargs), q scaled by 12
SOFTCAP_CASES = [
    (2, 4, 2, 256, 256, 96, dict(causal=True, softcap=50.0)),
    (1, 12, 1, 200, 200, 256, dict(causal=True, window=96, softcap=50.0)),
    (1, 32, 16, 1000, 1000, 128, dict(causal=True, window=256, softcap=50.0)),
]
SOFTCAP_Q_SCALE = 12.0
BF16_TOL = 2e-2          # chip_smoke.py's FLASH_TOL for bfloat16, unchanged
NEG_INF = -1e30


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_replay(q, k, v, *, causal=True, window=None, softcap=None, split=True):
    """The bfloat16 kernel's arithmetic, tile by tile, in float32 on the
    CPU: 64-query tiles, key tiles of 64 (past D = 128: 32, 16 with a
    softcap) between the kernel's skip bounds, the mask only on the tiles
    the kernel masks, logits in the log2 domain (the softcap's tanh formed
    from exp2 and a reciprocal), the online softmax, and P rounded to bf16
    as the kernel feeds it to the tensor cores — hi + lo (`split`) or
    once — with l summed from the same rounded parts.  q (B, H, Sq, D),
    k, v (B, Hkv, Sk, D) bf16 -> (B, H, Sq, D) bf16."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    DP = -(-D // 64) * 64
    BM, BN = 64, (64 if DP <= 128 else 16 if softcap else 32)
    scale, log2e = D ** -0.5, 1.4426950408889634
    k = k.repeat_interleave(H // Hkv, dim=1).float()
    v = v.repeat_interleave(H // Hkv, dim=1).float()
    out = torch.zeros(B, H, Sq, D)
    for q0 in range(0, Sq, BM):
        rows = torch.arange(q0, min(q0 + BM, Sq))
        q_last = int(rows[-1])
        k_end = min(Sk, q_last + 1) if causal else Sk
        k_begin = max(0, q0 - window + 1) // BN * BN if window else 0
        qt = q[:, :, rows].float()
        m = torch.full((B, H, len(rows), 1), NEG_INF)
        l = torch.zeros((B, H, len(rows), 1))
        acc = torch.zeros((B, H, len(rows), D))
        for k0 in range(k_begin, k_end, BN):
            keys = torch.arange(k0, k0 + BN)
            kt = keys.clamp(max=Sk - 1)
            s = torch.einsum("bhqd,bhkd->bhqk", qt, k[:, :, kt])
            if softcap:      # tanh(y) = 1 - 2 / (1 + 2^(2 log2e y)), as the kernel forms it
                post = softcap * log2e
                s = post * (1 - 2 / (1 + torch.exp2(s * (2 * log2e * scale / softcap))))
            else:
                s = s * (scale * log2e)
            need_mask = (k0 + BN > Sk or (causal and k0 + BN - 1 > q0)
                         or (window and q_last - k0 >= window))
            if need_mask:
                ok = keys[None, :] < Sk
                if causal:
                    ok = ok & (rows[:, None] >= keys[None, :])
                if window:
                    ok = ok & (rows[:, None] - keys[None, :] < window)
                s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(s > NEG_INF, torch.exp2(s - m_new), 0.0)
            hi = _bf16(p)
            p = hi + _bf16(p - hi) if split else hi
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, kt])
            m = m_new
        out[:, :, rows] = acc / torch.where(l == 0, 1.0, l)
    return out.to(torch.bfloat16)


def _softcap_inputs(case, seed):
    B, H, Hkv, Sq, Sk, D, kw = case
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, Sq, D), dtype=np.float32)
                         * np.float32(SOFTCAP_Q_SCALE)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, kw


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", SOFTCAP_CASES, ids=["d96", "d256-window", "gqa-window"])
def test_bf16_p_split_fits_the_tolerance(case, seed):
    """The numerical budget of the bfloat16 kernel, where there is no card:
    P fed to the tensor cores as bf16 hi + lo keeps the output within the
    unchanged 2e-2 of `mha_ref` on chip_smoke.py's softcap cases."""
    q, k, v, kw = _softcap_inputs(case, seed)
    exp = mha_ref(q, k, v, **kw)
    got = _tensor_core_replay(q, k, v, **kw)
    assert float((got.float() - exp.float()).abs().max()) <= BF16_TOL


def test_bf16_p_rounded_once_breaks_the_tolerance():
    """Why the kernel splits P: rounded once to bf16 (2^-9 relative), P
    moves O by ~1e-3, which flips the bf16 rounding of an output above 4
    by one ulp (2^-5 = 0.03125 > 2e-2) — on 3 of these 10 draws of the
    largest softcap case (seeds 5, 6 and 8), where hi + lo stays inside."""
    case = SOFTCAP_CASES[2]
    worst = {True: 0.0, False: 0.0}
    for seed in range(10):
        q, k, v, kw = _softcap_inputs(case, seed)
        exp = mha_ref(q, k, v, **kw).float()
        for split in worst:
            got = _tensor_core_replay(q, k, v, split=split, **kw).float()
            worst[split] = max(worst[split], float((got - exp).abs().max()))
    assert worst[False] > BF16_TOL >= worst[True]
