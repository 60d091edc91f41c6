"""Port parity for the limb-op dispatch layer: the port's `LimbOps` on the
CPU against the JAX package's `LimbOps` on both of its routes — the jnp
reference and the Pallas kernels in interpret mode — across limb counts,
batch shapes and edge values (0, q-1).  Exact equality throughout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.limbops import LimbOps as JaxLimbOps
from repro.core.params import make_params as jax_make_params
from repro_torch.core import limbops
from repro_torch.core.limbops import LimbOps, force_ref
from repro_torch.core.params import make_params

POINTWISE = ("mul", "add", "sub")
GRID = [(64, 257, 1), (128, 257, 2), (256, 7681, 3)]


def _rand(rng, primes, shape_prefix, n):
    return rng.integers(0, np.array(primes)[:, None], shape_prefix + (len(primes), n))


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def param_grid():
    """(params, port LimbOps, JAX ref LimbOps, JAX Pallas-interpret LimbOps)."""
    out = []
    for n, t, k in GRID:
        tp, jp = make_params(n=n, t=t, k=k), jax_make_params(n=n, t=t, k=k)
        out.append((tp, LimbOps(tp.Q, device="cpu"),
                    JaxLimbOps(jp.Q, backend="ref"),
                    JaxLimbOps(jp.Q, backend="pallas", interpret=True)))
    return out


def test_default_device_is_cuda_and_cpu_is_ref():
    import inspect
    assert inspect.signature(LimbOps.__init__).parameters["device"].default == "cuda"
    p = make_params(n=64, t=257, k=1)
    ops = LimbOps(p.Q, device="cpu")
    assert ops.backend == "ref" and ops.backend in limbops.BACKENDS
    assert limbops.BACKENDS == ("ref", "cuda")


@pytest.mark.parametrize("op", POINTWISE)
def test_pointwise_parity(param_grid, op):
    rng = np.random.default_rng(7)
    for p, port, ref, pal in param_grid:
        a = _rand(rng, p.Q.primes, (), p.n)
        b = _rand(rng, p.Q.primes, (), p.n)
        got = getattr(port, op)(_t(a), _t(b)).numpy()
        assert np.array_equal(got, np.asarray(getattr(ref, op)(_j(a), _j(b)))), (op, p.n)
        assert np.array_equal(got, np.asarray(getattr(pal, op)(_j(a), _j(b)))), (op, p.n)


@pytest.mark.parametrize("op", POINTWISE)
@pytest.mark.parametrize("batch", [(2,), (3, 2)])
def test_pointwise_parity_batched(param_grid, op, batch):
    """Batched (.., k, n) inputs match the JAX package and the per-slice loop."""
    rng = np.random.default_rng(11)
    p, port, ref, pal = param_grid[-1]
    a = _rand(rng, p.Q.primes, batch, p.n)
    b = _rand(rng, p.Q.primes, batch, p.n)
    got = getattr(port, op)(_t(a), _t(b)).numpy()
    assert np.array_equal(got, np.asarray(getattr(pal, op)(_j(a), _j(b))))
    flat_a = a.reshape((-1,) + a.shape[-2:])
    flat_b = b.reshape((-1,) + b.shape[-2:])
    loop = np.stack([getattr(port, op)(_t(x), _t(y)).numpy()
                     for x, y in zip(flat_a, flat_b)])
    assert np.array_equal(got.reshape(loop.shape), loop)


@pytest.mark.parametrize("op", POINTWISE)
def test_pointwise_broadcast_over_batch(param_grid, op):
    """A (k, n) operand against a (B, k, n) batch — keys and plaintexts."""
    rng = np.random.default_rng(12)
    p, port, ref, _ = param_grid[-1]
    a = _rand(rng, p.Q.primes, (4,), p.n)
    b = _rand(rng, p.Q.primes, (), p.n)
    got = getattr(port, op)(_t(a), _t(b)).numpy()
    assert np.array_equal(got, np.asarray(getattr(ref, op)(_j(a), _j(b))))


def test_pointwise_edge_values(param_grid):
    """0 and q-1 lanes: the conditional-subtraction corner cases."""
    for p, port, ref, pal in param_grid:
        k, n = len(p.Q.primes), p.n
        qcol = np.array(p.Q.primes, dtype=np.int64)[:, None]
        zeros = np.zeros((k, n), dtype=np.int64)
        qm1 = np.broadcast_to(qcol - 1, (k, n)).copy()
        for a, b in [(zeros, zeros), (zeros, qm1), (qm1, zeros), (qm1, qm1)]:
            for op in POINTWISE:
                got = getattr(port, op)(_t(a), _t(b)).numpy()
                assert np.array_equal(got, np.asarray(getattr(pal, op)(_j(a), _j(b)))), op
        assert np.array_equal(port.mul(_t(qm1), _t(qm1)).numpy(), (qm1 * qm1) % qcol)


@pytest.mark.parametrize("batch", [(), (2,), (4,)])
def test_ntt_roundtrip_parity(param_grid, batch):
    rng = np.random.default_rng(13)
    for p, port, ref, pal in param_grid:
        a = _rand(rng, p.Q.primes, batch, p.n)
        fwd = port.ntt(_t(a))
        assert np.array_equal(fwd.numpy(), np.asarray(pal.ntt(_j(a)))), p.n
        assert np.array_equal(fwd.numpy(), np.asarray(ref.ntt(_j(a)))), p.n
        inv = port.intt(fwd)
        assert np.array_equal(inv.numpy(), np.asarray(pal.intt(_j(fwd.numpy()))))
        assert np.array_equal(inv.numpy(), a)


def test_ntt_edge_values(param_grid):
    for p, port, ref, pal in param_grid[:1]:
        k, n = len(p.Q.primes), p.n
        qcol = np.array(p.Q.primes, dtype=np.int64)[:, None]
        for arr in (np.zeros((k, n), dtype=np.int64),
                    np.broadcast_to(qcol - 1, (k, n)).copy()):
            assert np.array_equal(port.ntt(_t(arr)).numpy(), np.asarray(pal.ntt(_j(arr))))
            assert np.array_equal(port.intt(_t(arr)).numpy(), np.asarray(pal.intt(_j(arr))))


@pytest.mark.parametrize("op", POINTWISE + ("ntt", "intt"))
def test_aux_base_is_accepted_and_matches(op):
    """The 31-bit HPS auxiliary base runs through the same entry points
    (no route around them) and equals the JAX package's reference path."""
    tp, jp = make_params(n=64, t=257, k=2), jax_make_params(n=64, t=257, k=2)
    port, ref = LimbOps(tp.P, device="cpu"), JaxLimbOps(jp.P, backend="ref")
    assert all(q.bit_length() == 31 for q in port.primes)
    rng = np.random.default_rng(17)
    a = _rand(rng, tp.P.primes, (2,), tp.n)
    b = _rand(rng, tp.P.primes, (2,), tp.n)
    if op in POINTWISE:
        got, exp = getattr(port, op)(_t(a), _t(b)), getattr(ref, op)(_j(a), _j(b))
    else:
        got, exp = getattr(port, op)(_t(a)), getattr(ref, op)(_j(a))
    assert np.array_equal(got.numpy(), np.asarray(exp))


def test_base_outside_window_raises():
    from repro_torch.core.params import _make_ntt_tables
    with pytest.raises(ValueError):
        LimbOps(_make_ntt_tables([7681], 256), device="cpu")


def test_force_ref_is_reentrant_and_exact(param_grid):
    p, port, _, _ = param_grid[1]
    rng = np.random.default_rng(19)
    a = _t(_rand(rng, p.Q.primes, (2,), p.n))
    b = _t(_rand(rng, p.Q.primes, (2,), p.n))
    plain = {op: getattr(port, op)(a, b) for op in POINTWISE}
    plain["ntt"], plain["intt"] = port.ntt(a), port.intt(a)
    with force_ref():
        with force_ref():
            assert limbops._FORCE_REF == 2
        for op in POINTWISE:
            assert torch.equal(getattr(port, op)(a, b), plain[op])
        assert torch.equal(port.ntt(a), plain["ntt"])
        assert torch.equal(port.intt(a), plain["intt"])
    assert limbops._FORCE_REF == 0
