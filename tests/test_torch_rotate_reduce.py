"""The rotate_reduce kernel of the port, on the CPU and (marked `gpu`) on
the card:

* its plain version (what a CPU tensor takes) against the JAX package's
  Pallas kernel in interpret mode and against its jnp oracle;
* `MockBackend(kernel_reduce=True, device="cpu")` against the JAX
  `MockBackend(kernel_reduce=True)` — slots, noise and every `OpStats`
  counter;
* the CUDA kernel against the plain version — needs the card.

All comparisons are exact (integer arithmetic): tolerance 0.
"""
import dataclasses

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


def _mock_db(mods, bk, nrows=600):
    S = mods["schema"]
    schema = S.TableSchema("items", [S.ColumnSpec("grp", "int"),
                                     S.ColumnSpec("qty", "int")])
    rng = np.random.default_rng(4)
    data = {"grp": rng.integers(1, 6, nrows), "qty": rng.integers(0, 50, nrows)}
    db = mods["storage"].Database(bk)
    db.load_table(schema, data, nrows)
    return db


def _sum_slots_run(bk, mods):
    """The cases of the JAX package's kernel_reduce test: one single
    ciphertext, one 3-block batch, and a batched table column."""
    db = _mock_db(mods, bk)
    bk.stats.reset()
    single = bk.sum_slots(bk.encrypt(np.arange(200) % bk.t))
    batch = bk.sum_slots(bk.stack_blocks([bk.encrypt(np.full(256, i)) for i in (1, 2, 3)]))
    col = bk.sum_slots(bk.stack_blocks(db.tables["items"].col("qty").blocks))
    return ([(c.vec, c.noise, c.depth) for c in (single, batch, col)],
            dataclasses.asdict(bk.stats))


def test_mock_kernel_reduce_matches_jax_mock():
    port = tbackend.MockBackend(NoiseProfile(n=256, t=T, k=30),
                                kernel_reduce=True, device="cpu")
    ref = jbackend.MockBackend(JNoiseProfile(n=256, t=T, k=30), kernel_reduce=True)
    got, got_stats = _sum_slots_run(port, dict(schema=tschema, storage=tstorage))
    exp, exp_stats = _sum_slots_run(ref, dict(schema=jschema, storage=jstorage))
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
    got, got_stats = _sum_slots_run(kern, mods)
    exp, exp_stats = _sum_slots_run(loop, mods)
    for (gv, gn, gd), (ev, en, ed) in zip(got, exp):
        assert np.array_equal(gv, ev) and gn == pytest.approx(en) and gd == ed
    assert got_stats.pop("launches") < exp_stats.pop("launches")
    assert got_stats == exp_stats


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 16384])
@pytest.mark.parametrize("rows", [1, 3, 368])
def test_cuda_kernel_equals_plain_version(cuda_device, rows, n):
    rng = np.random.default_rng(rows * n)
    x = rng.integers(0, T, (rows, n))
    x[0, :3] = [0, T - 1, T - 1]
    x = torch.from_numpy(x).to(cuda_device)
    for chunk in (None, 8, n // 16):
        before = kernels.launch_counts()["rotate_reduce"]
        got = rr_ops.rotate_reduce(x, T, chunk=chunk)
        assert kernels.launch_counts()["rotate_reduce"] == before + 1
        assert torch.equal(got, rr_ref.rotate_reduce_ref(x, T, chunk))


@pytest.mark.gpu
def test_mock_kernel_reduce_on_the_card_matches_cpu(cuda_device):
    prof = NoiseProfile(n=256, t=T, k=30)
    mods = dict(schema=tschema, storage=tstorage)
    got, got_stats = _sum_slots_run(
        tbackend.MockBackend(prof, kernel_reduce=True, device=cuda_device), mods)
    exp, exp_stats = _sum_slots_run(
        tbackend.MockBackend(prof, kernel_reduce=True, device="cpu"), mods)
    assert got_stats == exp_stats
    for (gv, gn, _), (ev, en, _) in zip(got, exp):
        assert np.array_equal(gv, ev) and gn == en
