"""The rotate_reduce kernel of the port, on the CPU:

* its plain version (what a CPU tensor takes) against the JAX package's
  Pallas kernel in interpret mode and against its jnp oracle;
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
from repro_torch import kernels
from repro_torch.core.noise import NoiseProfile
from repro_torch.engine import backend as tbackend
from repro_torch.engine import schema as tschema
from repro_torch.engine import storage as tstorage
from repro_torch.kernels.rotate_reduce import ops as rr_ops
from repro_torch.kernels.rotate_reduce import ref as rr_ref
from repro_torch.kernels.rotate_reduce import rotate_reduce as rr_launch
from torch_cases import sum_slots_run

T = 65537


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
