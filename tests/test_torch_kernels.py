"""Port parity for the kernel layer, on the CPU.

* the plain PyTorch twins of the CUDA device functions (kernels/u32.py)
  against Python big-int arithmetic on 29-, 30- and 31-bit primes;
* the plain versions of the five kernels (the code a CPU tensor takes)
  against the JAX package's Pallas kernels in interpret mode, same
  numpy-seeded inputs;
* the CUDA kernels themselves against the plain versions — needs the
  card, skipped without one.

All comparisons are exact (integer arithmetic): tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.params import make_params as jax_make_params
from repro.kernels.modops import modops as jax_modops
from repro.kernels.ntt import ntt as jax_ntt
from repro.kernels import u32 as jax_u32
from repro_torch.core import ntt as tntt
from repro_torch.core.mathutil import find_ntt_primes
from repro_torch.core.params import make_params
from repro_torch.kernels import u32
from repro_torch.kernels.modops import ops as mod_ops
from repro_torch.kernels.modops import ref as mod_ref
from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.kernels.tables import limb_tables

# one NTT-friendly prime of each width the kernels accept
PRIMES = {bits: find_ntt_primes(128, bits, 1)[0] for bits in (29, 30, 31)}
M32 = (1 << 32) - 1


def _t(xs):
    return torch.tensor([int(x) for x in xs], dtype=torch.int64)


def _residues(q, seed, count=4000):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, q - 1, q - 2, q // 2, q // 2 + 1]
    return [int(x) for x in rng.integers(0, q, count)] + edge


@pytest.mark.parametrize("bits", sorted(PRIMES))
def test_prime_widths(bits):
    q = PRIMES[bits]
    assert q.bit_length() == bits and u32.check_modulus(q) == q


def test_mulhi_mullo_vs_bigint():
    rng = np.random.default_rng(0)
    a = [int(x) for x in rng.integers(0, 1 << 32, 5000)] + [0, M32, M32, 1, 1 << 31]
    b = [int(x) for x in rng.integers(0, 1 << 32, 5000)] + [M32, M32, 0, M32, 1 << 31]
    hi = u32.mulhi_u32(_t(a), _t(b)).tolist()
    lo = u32.mullo_u32(_t(a), _t(b)).tolist()
    assert hi == [(x * y) >> 32 for x, y in zip(a, b)]
    assert lo == [(x * y) & M32 for x, y in zip(a, b)]


def test_mulhi_matches_jax_twin():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 32, 2000, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 2000, dtype=np.uint64)
    got = u32.mulhi_u32(torch.from_numpy(a.astype(np.int64)),
                        torch.from_numpy(b.astype(np.int64))).numpy()
    exp = np.asarray(jax_u32.mulhi_u32(jnp.asarray(a.astype(np.uint32)),
                                       jnp.asarray(b.astype(np.uint32)))).astype(np.int64)
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("bits", sorted(PRIMES))
def test_barrett_mulmod_vs_bigint(bits):
    q = PRIMES[bits]
    a, b = _residues(q, bits), _residues(q, bits + 100)
    b = b[::-1]
    mu = u32.barrett_precompute(q)
    assert mu == (1 << 64) // q
    got = u32.barrett_mulmod(_t(a), _t(b), torch.tensor(q), torch.tensor(mu)).tolist()
    assert got == [x * y % q for x, y in zip(a, b)]
    qm1 = u32.barrett_mulmod(_t([q - 1]), _t([q - 1]), torch.tensor(q), torch.tensor(mu))
    assert int(qm1) == (q - 1) * (q - 1) % q          # the largest product


@pytest.mark.parametrize("bits", sorted(PRIMES))
def test_shoup_mulmod_vs_bigint(bits):
    q = PRIMES[bits]
    a, w = _residues(q, bits + 1), _residues(q, bits + 2)[::-1]
    ws = [u32.shoup_precompute(x, q) for x in w]
    assert max(ws) <= M32
    got = u32.shoup_mulmod(_t(a), _t(w), _t(ws), torch.tensor(q)).tolist()
    assert got == [x * y % q for x, y in zip(a, w)]
    # Shoup takes any 32-bit a, not only reduced ones (lazy butterflies)
    wide = [M32, M32 - 1, q, 2 * q - 1]
    got = u32.shoup_mulmod(_t(wide), _t(w[:4]), _t(ws[:4]), torch.tensor(q)).tolist()
    assert got == [x * y % q for x, y in zip(wide, w[:4])]


@pytest.mark.parametrize("bits", sorted(PRIMES))
def test_add_sub_mod_vs_bigint(bits):
    q = PRIMES[bits]
    a, b = _residues(q, bits + 3), _residues(q, bits + 4)[::-1]
    assert u32.add_mod(_t(a), _t(b), torch.tensor(q)).tolist() == \
        [(x + y) % q for x, y in zip(a, b)]
    assert u32.sub_mod(_t(a), _t(b), torch.tensor(q)).tolist() == \
        [(x - y) % q for x, y in zip(a, b)]


@pytest.mark.parametrize("q", [3, (1 << 28) - 57, 1 << 30, (1 << 31) + 11, 257])
def test_moduli_outside_window_raise(q):
    with pytest.raises(ValueError):
        u32.check_modulus(q)


def _jax_tables(tables):
    """uint32 twiddles + Shoup companions laid out as the Pallas kernels read them."""
    q64 = np.asarray(tables.q, dtype=np.uint64)
    psi = np.asarray(tables.psi_rev, dtype=np.uint64)
    ipsi = np.asarray(tables.ipsi_rev, dtype=np.uint64)
    ninv = np.asarray(tables.n_inv, dtype=np.uint64)
    sh = np.uint64(32)
    u = lambda x: jnp.asarray(x.astype(np.uint32))
    return dict(q=u(q64)[:, None], psi=u(psi), psis=u((psi << sh) // q64[:, None]),
                ipsi=u(ipsi), ipsis=u((ipsi << sh) // q64[:, None]),
                ninv=u(ninv)[:, None], ninvs=u((ninv << sh) // q64)[:, None])


@pytest.mark.parametrize("n,k", [(64, 1), (256, 3)])
def test_plain_ntt_equals_pallas_interpret(n, k):
    t = {64: 257, 256: 7681}[n]
    jp, tp = jax_make_params(n=n, t=t, k=k), make_params(n=n, t=t, k=k)
    rng = np.random.default_rng(n)
    a = rng.integers(0, np.array(tp.Q.primes)[:, None], (k, n))
    jt = _jax_tables(jp.Q)
    tabs = limb_tables(tp.Q, "cpu")
    au = jnp.asarray(a.astype(np.uint32))
    exp_f = np.asarray(jax_ntt.ntt_fwd_pallas(au, jt["psi"], jt["psis"], jt["q"],
                                              interpret=True)).astype(np.int64)
    got_f = ntt_ops.ntt_fwd(torch.from_numpy(a), tabs)
    assert np.array_equal(got_f.numpy(), exp_f)
    exp_i = np.asarray(jax_ntt.ntt_inv_pallas(au, jt["ipsi"], jt["ipsis"], jt["q"],
                                              jt["ninv"], jt["ninvs"],
                                              interpret=True)).astype(np.int64)
    got_i = ntt_ops.ntt_inv(torch.from_numpy(a), tabs)
    assert np.array_equal(got_i.numpy(), exp_i)
    assert torch.equal(ntt_ops.ntt_inv(got_f, tabs), torch.from_numpy(a))


@pytest.mark.parametrize("n,k", [(64, 2), (256, 3)])
def test_plain_modops_equal_pallas_interpret(n, k):
    t = {64: 257, 256: 7681}[n]
    tp = make_params(n=n, t=t, k=k)
    primes = tp.Q.primes
    rng = np.random.default_rng(n + k)
    a = rng.integers(0, np.array(primes)[:, None], (k, n))
    b = rng.integers(0, np.array(primes)[:, None], (k, n))
    qu = jnp.asarray(np.array(primes, dtype=np.uint32))[:, None]
    mu = jnp.asarray(np.array([jax_u32.barrett_precompute(q) for q in primes],
                              dtype=np.uint32))[:, None]
    au, bu = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    tabs = limb_tables(tp.Q, "cpu")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exp = np.asarray(jax_modops.mul_mod_pallas(au, bu, qu, mu, interpret=True))
    assert np.array_equal(mod_ops.mul_mod(ta, tb, tabs).numpy(), exp.astype(np.int64))
    exp = np.asarray(jax_modops.add_mod_pallas(au, bu, qu, interpret=True))
    assert np.array_equal(mod_ops.add_mod(ta, tb, tabs).numpy(), exp.astype(np.int64))
    exp = np.asarray(jax_modops.sub_mod_pallas(au, bu, qu, interpret=True))
    assert np.array_equal(mod_ops.sub_mod(ta, tb, tabs).numpy(), exp.astype(np.int64))


@pytest.mark.parametrize("base", ["Q", "P"])
def test_u32_twins_reproduce_the_plain_versions(base):
    """The device-function twins, composed as the CUDA kernels compose them
    (Shoup butterflies, Barrett products), give the plain versions' bits —
    on the 30-bit base and on the 31-bit auxiliary base."""
    p = make_params(n=64, t=257, k=2)
    tables = getattr(p, base)
    tabs = limb_tables(tables, "cpu")
    rng = np.random.default_rng(3)
    k, n = tabs.k, tabs.n
    a = torch.from_numpy(rng.integers(0, np.array(tables.primes)[:, None], (k, n)))
    b = torch.from_numpy(rng.integers(0, np.array(tables.primes)[:, None], (k, n)))
    q = tabs.q[:, None]
    mu = tabs.mu64[:, None]
    assert torch.equal(u32.barrett_mulmod(a, b, q, mu), mod_ref.mul_mod_ref(a, b, tabs.q))
    assert torch.equal(u32.add_mod(a, b, q), mod_ref.add_mod_ref(a, b, tabs.q))
    assert torch.equal(u32.sub_mod(a, b, q), mod_ref.sub_mod_ref(a, b, tabs.q))
    # forward NTT with the kernel's indexing: butterfly b of stage s
    psi = tabs.psi32.to(torch.int64) & M32
    psis = tabs.psi_shoup.to(torch.int64) & M32
    x = a.clone()
    log_n = n.bit_length() - 1
    for s in range(log_n):
        m, t_len = 1 << s, n >> (s + 1)
        bidx = torch.arange(n // 2)
        j, i = bidx // t_len, bidx % t_len
        lo = j * 2 * t_len + i
        hi = lo + t_len
        u = x[:, lo]
        v = u32.shoup_mulmod(x[:, hi], psi[:, m + j], psis[:, m + j], q)
        x[:, lo], x[:, hi] = u32.add_mod(u, v, q), u32.sub_mod(u, v, q)
    assert torch.equal(x, tntt.ntt_ref(a, tabs.psi, tabs.q))


def test_plain_ntt_is_a_negacyclic_product():
    p = make_params(n=64, t=257, k=1)
    rng = np.random.default_rng(5)
    q = p.Q.primes[0]
    a, b = rng.integers(0, q, (1, 64)), rng.integers(0, q, (1, 64))
    got = tntt.polymul_ref(torch.from_numpy(a), torch.from_numpy(b), p.Q)[0].numpy()
    assert np.array_equal(got, tntt.negacyclic_naive(a[0], b[0], q))


def test_wrappers_refuse_mixed_devices_and_bad_shapes():
    p = make_params(n=64, t=257, k=2)
    tabs = limb_tables(p.Q, "cpu")
    bad = torch.zeros((3, 64), dtype=torch.int64)
    with pytest.raises(ValueError):
        ntt_ops.ntt_fwd(bad, tabs)
    with pytest.raises(ValueError):
        mod_ops.mul_mod(bad, bad, tabs)


def test_build_without_nvcc_raises_and_substitutes_nothing():
    """Where nvcc is missing the lazy build raises; it never hands back
    something else in a kernel's place."""
    from repro_torch import kernels
    try:
        kernels.nvcc_path()
    except kernels.KernelBuildError:
        with pytest.raises(kernels.KernelBuildError):
            kernels.library("ntt")
        with pytest.raises(kernels.KernelBuildError):
            kernels.build_all()
        assert "ntt" not in kernels._LIBS
    else:
        pytest.skip("nvcc is installed here: the build would succeed")


def test_launch_counters_start_at_zero_and_reset():
    from repro_torch import kernels
    from repro_torch.kernels.ntt import ntt as ntt_launch
    assert set(kernels.launch_counts()) == {"ntt_fwd", "ntt_inv", "mul_mod",
                                            "add_mod", "sub_mod"}
    p = make_params(n=64, t=257, k=1)
    tabs = limb_tables(p.Q, "cpu")
    before = kernels.launch_counts()
    ntt_ops.ntt_fwd(torch.zeros((1, 64), dtype=torch.int64), tabs)   # CPU: plain version
    assert kernels.launch_counts() == before
    ntt_launch.LAUNCHES["ntt_fwd"] += 3
    kernels.reset_launch_counts()
    assert all(v == 0 for v in kernels.launch_counts().values())
    with pytest.raises(ValueError):      # the launch wrapper itself refuses CPU tensors
        ntt_launch.ntt_fwd_cuda(torch.zeros((1, 64), dtype=torch.int64), tabs)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,k", [(128, 257, 12), (2048, 65537, 5)])
def test_cuda_kernels_equal_plain_versions(cuda_device, n, t, k):
    from repro_torch.core.limbops import LimbOps, force_ref
    p = make_params(n=n, t=t, k=k)
    rng = np.random.default_rng(n)
    for tables in (p.Q, p.P):
        ops = LimbOps(tables, device=cuda_device)
        q = np.array(tables.primes)[:, None]
        a = torch.from_numpy(rng.integers(0, q, (3, len(tables.primes), n))).to(cuda_device)
        b = torch.from_numpy(rng.integers(0, q, (3, len(tables.primes), n))).to(cuda_device)
        for fn in (lambda: ops.mul(a, b), lambda: ops.add(a, b[0]),
                   lambda: ops.sub(a, b), lambda: ops.ntt(a), lambda: ops.intt(a)):
            got = fn()
            with force_ref():
                exp = fn()
            assert torch.equal(got, exp)
        assert torch.equal(ops.intt(ops.ntt(a)), a)
