"""The rotate_reduce kernel of the port, on the CPU:

* its plain version (what a CPU tensor takes) against the JAX package's
  Pallas kernel in interpret mode and against its jnp oracle: int64 and
  int32 rows, one t or a per-row table of distinct primes below 2^30
  (the Pallas kernel adds in int32), chunk mode up to n = 65536;
* the arguments both devices refuse;
* `MockBackend(kernel_reduce=True, device="cpu")` against the JAX
  `MockBackend(kernel_reduce=True)` — slots, noise and every `OpStats`
  counter;
* the CUDA kernel against the plain version: on the card, in
  tests/test_torch_gpu_kernels.py.

All comparisons are exact (integer arithmetic): tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.noise import NoiseProfile as JNoiseProfile
from repro.engine import backend as jbackend
from repro.engine import schema as jschema
from repro.engine import storage as jstorage
from repro.kernels.rotate_reduce import ops as jrr_ops
from repro.kernels.rotate_reduce import ref as jrr_ref
from repro.kernels.rotate_reduce.rotate_reduce import rotate_reduce_pallas
from repro_torch import kernels
from repro_torch.core.mathutil import find_ntt_primes
from repro_torch.core.noise import NoiseProfile
from repro_torch.engine import backend as tbackend
from repro_torch.engine import schema as tschema
from repro_torch.engine import storage as tstorage
from repro_torch.kernels.rotate_reduce import ops as rr_ops
from repro_torch.kernels.rotate_reduce import ref as rr_ref
from repro_torch.kernels.rotate_reduce import rotate_reduce as rr_launch
from torch_cases import planted_rows, sum_slots_run

T = 65537


def pallas(x, t, chunk):
    """The JAX package's kernel in interpret mode on int32 rows and a
    (rows, 1) int32 table."""
    return np.asarray(rotate_reduce_pallas(jnp.asarray(x, dtype=jnp.int32),
                                           jnp.asarray(t, dtype=jnp.int32),
                                           chunk=chunk, interpret=True))


# the sweep of the JAX package's own kernel test, plus edge shapes
@pytest.mark.parametrize("rows,n,chunk", [(2, 256, None), (4, 1024, None),
                                          (3, 512, 8), (1, 1, None),
                                          (2, 64, 1), (2, 64, 64)])
def test_plain_version_matches_pallas_kernel(rows, n, chunk):
    rng = np.random.default_rng(n)
    x = rng.integers(0, T, (rows, n))
    x[0, 0], x[-1, -1] = 0, T - 1
    got = rr_ops.rotate_reduce(torch.from_numpy(x), T, chunk=chunk)
    exp = jrr_ops.rotate_reduce(x, T, chunk=chunk)
    assert got.dtype == torch.int64 and got.shape == (rows, n)
    assert np.array_equal(got.numpy(), np.asarray(exp))
    if chunk is None:
        assert int(got[0, 0]) == int(x[0].sum() % T)


@pytest.mark.parametrize("chunk", [None, 4, 32])
def test_int32_rows_keep_their_dtype_with_one_t(chunk):
    """The reference's width: int32 in, int32 out, one t for every row."""
    x = np.random.default_rng(3).integers(0, T, (3, 512))
    got = rr_ops.rotate_reduce(torch.from_numpy(x).to(torch.int32), T, chunk=chunk)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jrr_ops.rotate_reduce(x, T, chunk=chunk)))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,n,chunk", [(3, 256, None), (3, 256, 8), (4, 1024, 1),
                                          (2, 64, 64), (5, 32, 16), (3, 1, None),
                                          (4, 2048, 128), (2, 65536, 8), (2, 65536, 4096)])
def test_per_row_t_matches_pallas_kernel(rows, n, chunk, dtype):
    """A (rows, 1) table of distinct primes below 2^30, the table and the
    rows in `dtype`: the output keeps it, and equals the Pallas kernel's.
    n = 65536 in chunk mode is past the 32768 slots one block's shared
    memory held before; the cluster's capacity is 8 x 32768."""
    t = np.array(find_ntt_primes(1, 30, rows))[:, None]
    x = planted_rows(rows, n, t, seed=rows * n)
    got = rr_ops.rotate_reduce(torch.from_numpy(x).to(dtype), torch.from_numpy(t).to(dtype),
                               chunk=chunk)
    assert got.dtype == dtype and got.shape == (rows, n)
    assert np.array_equal(got.numpy(), pallas(x, t, chunk))
    if chunk is None:
        assert np.array_equal(got.numpy()[:, 0], x.sum(axis=1) % t[:, 0])


@pytest.mark.parametrize("t", [
    torch.full((3,), T), torch.full((3, 2), T), torch.full((2, 1), T),
    torch.full((3, 1), float(T)), torch.full((3, 1), T, device="meta"),
    torch.tensor([[T], [1], [T]]), torch.tensor([[T], [T], [1 << 31]]),
    1, 0, -5, 1 << 31])
def test_t_must_be_an_int_or_a_row_table_in_range(t):
    with pytest.raises(ValueError):
        rr_ops.rotate_reduce(torch.zeros((3, 64), dtype=torch.int64), t)


def test_chunk_mode_refuses_n_past_the_cluster_capacity():
    n = 2 * rr_launch.MAX_CHUNK_N
    with pytest.raises(ValueError, match="chunk mode"):
        rr_ops.rotate_reduce(torch.zeros((1, n), dtype=torch.int32), T, chunk=8)
    # full mode keeps no row: any power-of-two n
    assert int(rr_ops.rotate_reduce(torch.ones((1, n), dtype=torch.int32), T)[0, 0]) == n % T


@pytest.mark.parametrize("x", [torch.zeros((2, 64), dtype=torch.int16),
                               torch.zeros((2, 64), dtype=torch.float32),
                               torch.zeros((2, 48), dtype=torch.int64),
                               torch.zeros((64,), dtype=torch.int64)])
def test_rows_must_be_int32_or_int64_of_a_power_of_two(x):
    with pytest.raises(ValueError):
        rr_ops.rotate_reduce(x, T)


@pytest.mark.parametrize("rows,n,chunk_mode,sms,expect", [
    (2, 16384, False, 132, 8), (368, 16384, False, 132, 1), (100, 16384, False, 132, 2),
    (2, 256, False, 132, 1), (1, 1, False, 132, 1), (368, 65536, True, 132, 2),
    (2, 1 << 18, True, 132, 8)])
def test_cluster_size(rows, n, chunk_mode, sms, expect):
    assert rr_launch.cluster_size(rows, n, sms, chunk_mode) == expect


def test_plain_version_matches_jnp_oracle_at_sum_slots_shape():
    """(2, 16384): the two half-rows of one paper-scale block."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, T, (2, 16384))
    got = rr_ref.rotate_reduce_ref(torch.from_numpy(x), T)
    exp = jrr_ref.rotate_reduce_ref(jnp.asarray(x, dtype=jnp.int32), T)
    assert np.array_equal(got.numpy(), np.asarray(exp))
    assert np.array_equal(got.numpy()[:, 0], x.sum(axis=1) % T)


@pytest.mark.parametrize("chunk", [0, 3, 12, 512])
def test_chunk_must_be_a_power_of_two_within_the_row(chunk):
    with pytest.raises(ValueError):
        rr_ops.rotate_reduce(torch.zeros((2, 256), dtype=torch.int64), T, chunk=chunk)


def test_cpu_tensor_takes_plain_version_and_launch_wrapper_refuses_it():
    before = kernels.launch_counts()["rotate_reduce"]
    rr_ops.rotate_reduce(torch.ones((2, 8), dtype=torch.int64), T)
    assert kernels.launch_counts()["rotate_reduce"] == before
    with pytest.raises(ValueError):
        rr_launch.rotate_reduce_cuda(torch.ones((2, 8), dtype=torch.int64), T, 3)


def test_kernel_reduce_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbackend.MockBackend(kernel_reduce=True)
    assert tbackend.MockBackend(kernel_reduce=True, device="cpu").kernel_reduce


def test_mock_kernel_reduce_matches_jax_mock():
    port = tbackend.MockBackend(NoiseProfile(n=256, t=T, k=30),
                                kernel_reduce=True, device="cpu")
    ref = jbackend.MockBackend(JNoiseProfile(n=256, t=T, k=30), kernel_reduce=True)
    got, got_stats = sum_slots_run(port, dict(schema=tschema, storage=tstorage))
    exp, exp_stats = sum_slots_run(ref, dict(schema=jschema, storage=jstorage))
    assert got_stats == exp_stats
    for (gv, gn, gd), (ev, en, ed) in zip(got, exp):
        assert gv.dtype == np.int64 and np.array_equal(gv, ev)
        assert np.array_equal(np.asarray(gn), np.asarray(en)) and gd == ed
    assert got[1][0].shape == (3, 256)
    assert np.array_equal(got[1][0][:, 0], np.array([256, 512, 768]) % T)


def test_mock_kernel_reduce_matches_looped_sum_slots():
    """Same slots, noise and charged counters as the rotate+add loop; one
    launch in place of the loop's 2·log2(n/2)+2."""
    kern = tbackend.MockBackend(NoiseProfile(n=256, t=T, k=30),
                                kernel_reduce=True, device="cpu")
    loop = tbackend.MockBackend(NoiseProfile(n=256, t=T, k=30))
    mods = dict(schema=tschema, storage=tstorage)
    got, got_stats = sum_slots_run(kern, mods)
    exp, exp_stats = sum_slots_run(loop, mods)
    for (gv, gn, gd), (ev, en, ed) in zip(got, exp):
        assert np.array_equal(gv, ev) and gn == pytest.approx(en) and gd == ed
    assert got_stats.pop("launches") < exp_stats.pop("launches")
    assert got_stats == exp_stats
