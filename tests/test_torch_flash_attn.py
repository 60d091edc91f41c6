"""Port parity for the flash_attn kernel's plain version, on the CPU.

`attention_ref` and the CPU path of `mha` (which runs `attention_ref`)
against the JAX package's Pallas `flash_attention` in interpret mode
(through `repro.kernels.flash_attn.ops.mha`) and its `attention_ref`, on
the same numpy-made inputs.  Tolerance 2e-5 in float32 and 2e-2 in
bfloat16, as `tests/test_kernels.py` holds the Pallas kernel: the blocked
online softmax and the dense one sum in different orders, and bfloat16
outputs round at 2^-8 relative.  Ragged lengths go against the JAX
`attention_ref` only, since the Pallas wrapper asserts tile divisibility.

The CUDA kernel itself is held against the plain version on the card
(`gpu` marker; skipped without one).
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

VARIANTS = [dict(causal=True), dict(causal=True, window=32),
            dict(causal=True, softcap=50.0), dict(causal=False)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(B, H, Hkv, Sq, Sk, D, dtype, seed=0):
    """numpy normals, rounded to `dtype` once, as both packages' inputs."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
    jx = [jnp.asarray(a, jdt) for a in arrs]
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_kernel_matches_plain_version(cuda_device, dtype):
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    for B, H, Hkv, Sq, Sk, D, kwargs in [
            (2, 4, 2, 200, 200, 128, dict(causal=True, window=64, softcap=50.0)),
            (1, 12, 1, 96, 160, 64, dict(causal=False)),
            (1, 2, 2, 150, 40, 96, dict(causal=False, window=30))]:
        _, (q, k, v) = _qkv(B, H, Hkv, Sq, Sk, D, dtype, seed=3)
        q, k, v = q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
        got = ops.mha(q, k, v, **kwargs)
        exp = mha_ref(q, k, v, **kwargs)
        torch.cuda.synchronize()
        assert float((got.float() - exp.float()).abs().max()) <= tol
