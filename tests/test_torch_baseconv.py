"""The fast base conversion kernel family (kernels/baseconv), on the CPU.

* `ops.base_conv` on CPU tensors (the plain version) against the JAX
  package's `BFVContext._fbc`, at the paper's k = 30 limbs (31 in the
  auxiliary base) and a small n, both ways and over lane shapes;
* the kernel's arithmetic (csrc/baseconv.cu) replayed with the u32 twins
  of its device functions and the kernel's own tables, against the plain
  version: the same residues, bit for bit;
* the twins the kernel adds (lazy Shoup, Barrett reduction) against Python
  big-int arithmetic;
* dispatch (`force_ref()`), the launch wrapper's refusals and its counts.

The kernel itself is held against the plain version on the card by
tests/test_torch_gpu_kernels.py.  All comparisons are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import bfv as jbfv
from repro.core.params import make_params as jax_make_params
from repro_torch import kernels
from repro_torch.core import bfv as tbfv
from repro_torch.core.limbops import force_ref
from repro_torch.core.params import make_params
from repro_torch.kernels import u32
from repro_torch.kernels.baseconv import baseconv
from repro_torch.kernels.baseconv import ops as conv_ops
from repro_torch.kernels.baseconv import ref as conv_ref
from repro_torch.kernels.tables import conv_tables, limb_tables

N, K = 64, 30
LANES = [(), (1,), (5,), (2, 5)]


@pytest.fixture(scope="module")
def bases():
    """(torch params, JAX params, {"qp": tables, "pq": tables})."""
    p = make_params(n=N, t=65537, k=K)
    tq, tp = limb_tables(p.Q, "cpu"), limb_tables(p.P, "cpu")
    return (p, jax_make_params(n=N, t=65537, k=K),
            {"qp": conv_tables(p.conv_q_to_p, tq, tp), "pq": conv_tables(p.conv_p_to_q, tp, tq)})


def _residues(primes, lead, seed):
    """Random residues of shape (*lead, len(primes), N), with one limb row
    of zeros and one of q_i - 1 in the first lane."""
    q = np.array(primes, dtype=np.int64)[:, None]
    x = np.random.default_rng(seed).integers(0, q, (*lead, len(primes), N))
    flat = x.reshape(-1, len(primes), N)
    flat[0, :, :4] = 0
    flat[0, :, 4:8] = q - 1
    return x


def _jax_fbc(jp, way, x):
    conv = jp.conv_q_to_p if way == "qp" else jp.conv_p_to_q
    src, dst = (jp.Q, jp.P) if way == "qp" else (jp.P, jp.Q)
    tup = tuple(jnp.asarray(a) for a in (conv.a_hat_inv_mod_a, conv.a_hat_mod_b,
                                         conv.a_mod_b, conv.a_inv))
    return np.asarray(jbfv.BFVContext._fbc(jnp.asarray(x), tup, jnp.asarray(src.q),
                                           jnp.asarray(dst.q)))


@pytest.mark.parametrize("way", ["qp", "pq"])
@pytest.mark.parametrize("lead", LANES, ids=str)
def test_plain_version_equals_the_jax_package(bases, way, lead):
    p, jp, tabs = bases
    primes = p.Q.primes if way == "qp" else p.P.primes
    x = _residues(primes, lead, seed=len(lead) + (way == "pq"))
    got = conv_ops.base_conv(torch.from_numpy(x), tabs[way])
    assert got.shape == (*lead, tabs[way].kb, N) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), _jax_fbc(jp, way, x))


def test_plain_version_is_the_centred_value_mod_each_output_prime(bases):
    """The conversion's meaning, in big ints: out_j = X mod b_j for the
    centred CRT value X of each input coefficient."""
    p, _, tabs = bases
    x = _residues(p.Q.primes, (), seed=7)
    got = conv_ops.base_conv(torch.from_numpy(x), tabs["qp"]).numpy()
    A = 1
    for q in p.Q.primes:
        A *= q
    for c in range(0, N, 5):
        X = sum(int(x[i, c]) * (A // q) * pow(A // q, -1, q)
                for i, q in enumerate(p.Q.primes)) % A
        X = X - A if X > A // 2 else X
        assert [int(v) for v in got[:, c]] == [X % b for b in p.P.primes]


def _kernel_replay(x, t):
    """csrc/baseconv.cu's arithmetic on (rows, ka, n) int64 residues, step
    for step, from the kernel's own tables (bit patterns read back as
    unsigned) with the u32 twins of its device functions."""
    def u(a):
        return a.to(torch.int64) & 0xFFFFFFFF
    hat_inv, hat_ws = u(t.hat_inv32[:, 0])[:, None], u(t.hat_inv32[:, 1])[:, None]
    y = u32.shoup_mulmod(x, hat_inv, hat_ws, u(t.in_q32)[:, None])
    acc = torch.zeros(x.shape[0], x.shape[2], dtype=torch.float64)
    for i in range(t.ka):                       # __dadd_rn(acc, __dmul_rn(y_i, a_inv_i))
        acc = acc + y[:, i].to(torch.float64) * t.a_inv[i]
    v = torch.round(acc).to(torch.int64)        # rint: half to even
    out = torch.empty(x.shape[0], t.kb, x.shape[2], dtype=torch.int64)
    mu = t.out_mu64.numpy().view(np.uint64)
    for j in range(t.kb):
        b = int(u(t.out_q32[j]))
        s = t.ka * b - v * int(u(t.a_mod_b32[j]))
        assert int(s.min()) >= 0
        for i in range(t.ka):
            h, hs = int(u(t.hat_mod_b32[i, j, 0])), int(u(t.hat_mod_b32[i, j, 1]))
            r = u32.shoup_mulmod_lazy(y[:, i], h, hs, b)
            assert int(r.max()) < 2 * b
            s = s + r
        assert int(s.max()) < 1 << 38
        out[:, j] = u32.barrett_reduce(s, b, torch.tensor(int(mu[j])))
    return out


@pytest.mark.parametrize("way", ["qp", "pq"])
def test_kernel_arithmetic_equals_the_plain_version(bases, way):
    p, _, tabs = bases
    primes = p.Q.primes if way == "qp" else p.P.primes
    x = torch.from_numpy(_residues(primes, (3,), seed=11))
    assert torch.equal(_kernel_replay(x, tabs[way]), conv_ref.base_conv_ref(x, tabs[way]))


@pytest.mark.parametrize("bits", [30, 31])
def test_lazy_shoup_and_barrett_reduce_vs_bigint(bits):
    rng = np.random.default_rng(bits)
    q = int(make_params(n=N, t=65537, k=2).Q.primes[0] if bits == 30
            else make_params(n=N, t=65537, k=2).P.primes[0])
    a = [int(v) for v in rng.integers(0, 1 << 32, 3000)] + [0, 1, (1 << 32) - 1]
    w = [int(v) for v in rng.integers(0, q, 3000)] + [q - 1, 0, q - 1]
    ws = [u32.shoup_precompute(v, q) for v in w]
    t = lambda xs: torch.tensor(xs, dtype=torch.int64)  # noqa: E731
    lazy = u32.shoup_mulmod_lazy(t(a), t(w), t(ws), q).tolist()
    assert all(r < 2 * q and r % q == x * y % q for r, x, y in zip(lazy, a, w))
    xs = [int(v) for v in rng.integers(0, 1 << 62, 3000, dtype=np.int64)] + [0, q, (1 << 62) - 1]
    mu = torch.tensor(u32.barrett_precompute(q))
    assert u32.barrett_reduce(t(xs), q, mu).tolist() == [v % q for v in xs]


def test_force_ref_routes_the_context_to_the_plain_version(bases, monkeypatch):
    p, _, tabs = bases
    ctx = tbfv.BFVContext(p, device="cpu")
    x = torch.from_numpy(_residues(p.Q.primes, (2,), seed=3))
    calls = []
    real = conv_ops.base_conv
    monkeypatch.setattr(conv_ops, "base_conv", lambda *a: calls.append(a) or real(*a))
    got = ctx._fbc(x, ctx.c_qp)
    assert len(calls) == 1
    with force_ref():
        assert torch.equal(ctx._fbc(x, ctx.c_qp), got)
    assert len(calls) == 1
    assert torch.equal(got, conv_ref.base_conv_ref(x, tabs["qp"]))


def test_wrapper_refuses_what_the_kernel_does_not_take(bases):
    p, _, tabs = bases
    t = tabs["qp"]
    good = torch.zeros((2, K, N), dtype=torch.int64)
    cases = [
        (good.to(torch.int32), "int64"),
        (good[0], "int64"),                              # not (rows, ka, n)
        (torch.zeros((2, K + 1, N), dtype=torch.int64), "limbs"),
        (good.transpose(1, 2).contiguous().transpose(1, 2), "contiguous"),
        (good[..., ::2], "contiguous"),
        (good[:, :1].expand(2, K, N), "contiguous"),
        (good, "CUDA"),                                  # right in all but its device
    ]
    for x, what in cases:
        with pytest.raises(ValueError, match=what):
            baseconv.base_conv_cuda(x, t)
    with pytest.raises(ValueError):
        conv_ops.base_conv(torch.zeros((K + 1, N), dtype=torch.int64), t)
    assert kernels.launch_counts()["base_conv"] == 0


def test_one_component_of_a_stacked_batch_reaches_the_kernel_without_a_copy(bases):
    """The rows `ops.base_conv` hands the kernel for da[..., 0, :, :] of a
    (2, 5, 2, k, n) batch: a view of the batch, readable as it lies."""
    data = torch.zeros((2, 5, 2, K, N), dtype=torch.int64)
    rows = data[..., 0, :, :].reshape(-1, K, N)
    assert rows.data_ptr() == data.data_ptr() and baseconv.readable(rows)
    assert rows.stride(0) == 2 * K * N


def test_launches_are_counted_by_shape_and_reset():
    kernels.reset_launch_counts()
    assert baseconv.LAUNCHES_BY_SHAPE == {"base_conv": {}}
    for shape in ((5, 30, 31), (5, 30, 31), (1, 31, 30)):
        baseconv._count(*shape)
    assert baseconv.LAUNCHES_BY_SHAPE == {"base_conv": {(5, 30, 31): 2, (1, 31, 30): 1}}
    assert kernels.launch_counts()["base_conv"] == 3
    kernels.reset_launch_counts()
    assert baseconv.LAUNCHES_BY_SHAPE == {"base_conv": {}}
    assert kernels.launch_counts()["base_conv"] == 0
