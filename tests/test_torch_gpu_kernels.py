"""The port's CUDA kernels against their plain PyTorch versions, on the
card (`gpu` marker; every test here skips where there is no CUDA device).

This file imports torch, numpy and the port only, so that it runs on a
machine with a GPU and no JAX:

    python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

(it puts this checkout's `src/` on the path itself).

The limb kernels, both NTTs and rotate_reduce are held exactly
(tolerance 0: integer arithmetic); flash_attn within 1e-4 in float32
(the kernel and the dense version sum in different orders) and 2e-2 in
bfloat16 (outputs round at 2^-8 relative).  Sharded BFV queries on the
card equal the unsharded run on the card, and checkpoints of CUDA
tensors restore onto the card byte for byte.  The encrypted-scan step
(`launch/nshedb_step.py`) on the card equals a plain int64 contraction
and its CPU run; a 2-rank gloo mesh with CUDA tensors folds and
key-switches BFV micro ciphertexts as one device does, computes on BFV
batches held sharded over it (each rank its own lanes, and on a (1, 2)
mesh its own limbs of them) as one device does, and runs the scan step sharded over it as one device does; TPC-H Q14's
legacy body on the card equals its CPU run and the oracle.  The CPU tests of the same
modules hold the plain versions against the JAX package.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the port from this checkout, with or without PYTHONPATH=src
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.core.mathutil import find_ntt_primes  # noqa: E402
from repro_torch.core.noise import NoiseProfile  # noqa: E402
from repro_torch.core.params import _make_ntt_tables, make_params  # noqa: E402
from repro_torch.engine import backend as tbackend  # noqa: E402
from repro_torch.engine import executor as texecutor  # noqa: E402
from repro_torch.engine import plan as tplan  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402
from repro_torch.engine import schema as tschema  # noqa: E402
from repro_torch.engine import storage as tstorage  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import mha_ref  # noqa: E402
from repro_torch.kernels.rotate_reduce import ops as rr_ops  # noqa: E402
from repro_torch.kernels.rotate_reduce import ref as rr_ref  # noqa: E402
from repro_torch.kernels.rotate_reduce import rotate_reduce as rr_launch  # noqa: E402
from repro_torch.configs.nshedb import CONFIG, smoke  # noqa: E402
from repro_torch.launch import nshedb_step  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from torch_cases import (bfv_shard_db, bfv_shard_oracle, bfv_shard_plans, engine_mods,  # noqa: E402
                         lane_chunk_run, legacy_query_run, planted_rows, qkv_arrays,
                         sharded_run, sum_slots_run)
from torch_mesh_ranks import BATCH_KEYS, MICRO, Ranks, batch_ops_run, scan_inputs  # noqa: E402

T = 65537
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def paper(cuda_device):
    from repro_torch.core.params import paper_params
    return paper_params()


# ------------------------------------------------------------ limb kernels
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


@pytest.mark.gpu
@pytest.mark.parametrize("log_n", range(1, 16))
def test_cuda_ntt_equals_plain_version_at_every_n(cuda_device, log_n):
    """Both NTT kernels at every n the wrappers accept, on a 30-bit and a
    31-bit prime: random rows, rows of q - 1 and zero rows, bit for bit,
    and intt(ntt(x)) == x."""
    from repro_torch.core.limbops import LimbOps, force_ref
    n = 1 << log_n
    primes = [find_ntt_primes(n, 30, 1)[0], find_ntt_primes(n, 31, 1)[0]]
    ops = LimbOps(_make_ntt_tables(primes, n), device=cuda_device)
    q = np.array(primes)[:, None]
    rng = np.random.default_rng(log_n)
    a = np.stack([rng.integers(0, q, (2, n)), np.broadcast_to(q - 1, (2, n)),
                  np.zeros((2, n), dtype=np.int64)])
    a = torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    fwd, inv = ops.ntt(a), ops.intt(a)
    with force_ref():
        assert torch.equal(fwd, ops.ntt(a)) and torch.equal(inv, ops.intt(a))
    assert torch.equal(ops.intt(fwd), a)


def _ntt_inv_cases(ops, x):
    """ntt_inv against its plain version on x, on rows of q - 1 and on
    zero rows of x's shape, one launch each; and intt(ntt(x)) == x."""
    from repro_torch.core.limbops import force_ref
    q = ops.q[:, None]
    for a in (x, (q - 1).expand(x.shape).contiguous(), torch.zeros_like(x)):
        before = kernels.launch_counts()["ntt_inv"]
        got = ops.intt(a)
        assert kernels.launch_counts()["ntt_inv"] == before + 1
        with force_ref():
            assert torch.equal(got, ops.intt(a))
    assert torch.equal(ops.intt(ops.ntt(x)), x)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,base", [(1, "Q"), (1, "P"), (5, "Q"), (5, "P")],
                         ids=["30rows", "31rows", "150rows", "155rows"])
def test_cuda_ntt_inv_at_the_paths_row_counts(paper, lanes, base):
    """The inverse NTT at the row counts the engine's paths give it at
    paper_params() (n = 32768): one multiply's limb set, 1 or 5 lanes of
    the 30-limb base Q or the 31-limb base P."""
    from repro_torch.core.limbops import LimbOps
    tables = getattr(paper, base)
    ops = LimbOps(tables, device="cuda")
    rng = np.random.default_rng(lanes * len(tables.primes))
    q = np.array(tables.primes)[:, None]
    x = torch.from_numpy(rng.integers(0, q, (lanes, len(tables.primes), paper.n)))
    _ntt_inv_cases(ops, x.to("cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("base,k", [("Q", 5), ("P", 7)])
def test_cuda_ntt_inv_limbs_cross_row_groups(paper, base, k):
    """3k rows over k limbs, k odd: the limb of row r is r % k, so the
    limb tables a cluster reads change at rows that are not multiples of
    any power of two."""
    from repro_torch.core.limbops import LimbOps
    primes = list(getattr(paper, base).primes[:k])
    ops = LimbOps(_make_ntt_tables(primes, paper.n), device="cuda")
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.integers(0, np.array(primes)[:, None], (3, k, paper.n)))
    _ntt_inv_cases(ops, x.to("cuda"))


# ----------------------------------------------------------- rotate_reduce
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


def _rr_chunks(n):
    """Full mode and each of the chunks 1, 8, n/16 and n that is a power
    of two no larger than n."""
    return [None] + sorted({c for c in (1, 8, n // 16, n) if 1 <= c <= n})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 32, 256, 16384, 65536])
@pytest.mark.parametrize("rows", [1, 2, 3, 368])
def test_cuda_kernel_equals_plain_version_per_row_t(cuda_device, rows, n, dtype):
    """Rows and a per-row table of distinct primes below 2^30 in `dtype`,
    and one t: every mode, one launch a call, the rows' dtype kept."""
    t = np.array(find_ntt_primes(1, 30, rows))[:, None]
    x = torch.from_numpy(planted_rows(rows, n, t, seed=rows + n)).to(cuda_device, dtype)
    table = torch.from_numpy(t).to(cuda_device, dtype)
    one = torch.from_numpy(planted_rows(rows, n, np.full((rows, 1), T), seed=n)).to(
        cuda_device, dtype)
    for xs, ts in ((x, table), (one, T)):
        for chunk in _rr_chunks(n):
            before = kernels.launch_counts()["rotate_reduce"]
            got = rr_ops.rotate_reduce(xs, ts, chunk=chunk)
            assert kernels.launch_counts()["rotate_reduce"] == before + 1
            assert got.dtype == dtype
            assert torch.equal(got, rr_ref.rotate_reduce_ref(xs, ts, chunk))


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_cuda_kernel_equals_plain_version_at_every_cluster_size(cuda_device, cluster):
    """The blocks a row is split over change no value (both modes)."""
    t = np.array(find_ntt_primes(1, 30, 3))[:, None]
    x = torch.from_numpy(planted_rows(3, 16384, t, seed=cluster)).to(cuda_device, torch.int32)
    table = torch.from_numpy(t).to(cuda_device)
    for stop_log in (14, 0, 3, 10):
        got = rr_launch.rotate_reduce_cuda(x, table, stop_log, cluster=cluster)
        chunk = None if stop_log == 14 else 1 << stop_log
        assert torch.equal(got, rr_ref.rotate_reduce_ref(x, table, chunk))


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_the_cpu_refuses(cuda_device):
    """A table on the host for rows on the card, t past 2^31 and n past
    the cluster's capacity in chunk mode raise before any launch."""
    x = torch.zeros((3, 64), dtype=torch.int32, device=cuda_device)
    before = kernels.launch_counts()["rotate_reduce"]
    for t in (torch.full((3, 1), T), 1 << 31,
              torch.tensor([[T], [T], [1 << 31]], device=cuda_device)):
        with pytest.raises(ValueError):
            rr_ops.rotate_reduce(x, t)
    with pytest.raises(ValueError, match="chunk mode"):
        rr_ops.rotate_reduce(torch.zeros((1, 2 * rr_launch.MAX_CHUNK_N), dtype=torch.int32,
                                         device=cuda_device), T, chunk=8)
    assert kernels.launch_counts()["rotate_reduce"] == before


@pytest.mark.gpu
def test_mock_kernel_reduce_on_the_card_matches_cpu(cuda_device):
    prof = NoiseProfile(n=256, t=T, k=30)
    mods = dict(schema=tschema, storage=tstorage)
    got, got_stats = sum_slots_run(
        tbackend.MockBackend(prof, kernel_reduce=True, device=cuda_device), mods)
    exp, exp_stats = sum_slots_run(
        tbackend.MockBackend(prof, kernel_reduce=True, device="cpu"), mods)
    assert got_stats == exp_stats
    for (gv, gn, _), (ev, en, _) in zip(got, exp):
        assert np.array_equal(gv, ev) and gn == en


# --------------------------------------------------- sharded BFV, checkpoints
SHARD_MODS = dict(schema=tschema, storage=tstorage, planner=tplanner, executor=texecutor)


@pytest.fixture(scope="module")
def bfv_shard(cuda_device):
    """The micro sharding table on the card and on the CPU, and each
    plan's unsharded run on the card."""
    dbs = {dev: bfv_shard_db(SHARD_MODS, tbackend.BFVBackend(
               make_params(n=128, t=257, k=12), seed=11, device=dev))
           for dev in ("cuda", "cpu")}
    plans = bfv_shard_plans(tplan)
    base = {name: sharded_run(SHARD_MODS, dbs["cuda"][0], plan, None)
            for name, plan in plans.items()}
    return dbs, plans, base


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [(2, 1), (2, 4), (4, 2)], ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("pname", ["g1", "j1", "f1"])
def test_cuda_sharded_bfv_equals_unsharded(bfv_shard, pname, cell):
    """A logical shard context on real ciphertexts on the card: padded
    lanes in the limb kernels, the same decrypts and OpStats as the
    unsharded run, and the same ledger as the plain versions' run."""
    dbs, plans, base = bfv_shard
    kernels.reset_launch_counts()
    got = sharded_run(SHARD_MODS, dbs["cuda"][0], plans[pname], cell)
    assert all(kernels.launch_counts()[k] > 0 for k in ("ntt_fwd", "ntt_inv", "mul_mod"))
    cpu = sharded_run(SHARD_MODS, dbs["cpu"][0], plans[pname], cell)
    _, data, pdata = dbs["cuda"]
    assert got["got"] == base[pname]["got"] == bfv_shard_oracle(pname, data, pdata)
    assert got["stats"] == base[pname]["stats"] and got["stats"]["refresh"] == 0
    assert got == cpu
    assert got["ledger"]["folds"] > 0


@pytest.mark.gpu
def test_cuda_checkpoint_round_trip(cuda_device, tmp_path):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = {"ct": torch.randint(0, 2**30, (2, 2, 12, 128), generator=gen,
                                  device=cuda_device, dtype=torch.int64),
              "w": [torch.randn(64, 32, generator=gen, device=cuda_device)]}
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, params, extra={"rows": 256})
    params["ct"].add_(1)            # the host copy was taken before save returned
    mgr.save(2, params)
    mgr.wait()
    one, _, extra = mgr.restore(1, params)
    two, _, _ = mgr.restore(2, params)
    assert extra == {"rows": 256}
    assert one["ct"].device.type == "cuda" and two["w"][0].device.type == "cuda"
    assert torch.equal(one["ct"] + 1, params["ct"]) and torch.equal(two["ct"], params["ct"])
    assert torch.equal(two["w"][0], params["w"][0])


@pytest.mark.gpu
def test_cuda_lane_chunks_equal_one_batch(cuda_device):
    """A 5-lane batch through eq / lt / the slot broadcast on the card in
    lane chunks of 2 (`max_lanes`) equals the one-batch run: decrypts,
    noise, depth and OpStats, launches included."""
    from repro_torch.core import compare as tcompare
    from repro_torch.engine import ops as tops
    runs = []
    for max_lanes in (None, 2):
        bk = tbackend.BFVBackend(make_params(n=128, t=257, k=12), seed=0,
                                 device=cuda_device, max_lanes=max_lanes)
        runs.append(lane_chunk_run(bk, tcompare, tops) + (bk.lane_log,))
    (one, one_stats, one_log), (chunked, stats, log) = runs
    assert not one_log and {what for what, _, step in log if step == 2} == {"pow", "lt", "broadcast"}
    assert stats == one_stats
    for (dec, noise, depth), (dec1, noise1, depth1) in zip(chunked, one):
        np.testing.assert_array_equal(dec, dec1)
        assert noise == noise1 and depth == depth1


@pytest.mark.gpu
def test_cuda_legacy_q14_equals_cpu_and_oracle(cuda_device):
    """TPC-H Q14's legacy body (`run_q14`: a part -> lineitem join hop, a
    date window, two masked sums) on real BFV ciphertexts at micro
    parameters, over the planted tables of the CPU tests: on the card its
    decrypts, OpStats (launches included) and refresh log equal the CPU
    run's, and the decrypts equal the oracle."""
    mods = engine_mods("repro_torch")
    runs, launches = {}, {}
    for dev in ("cuda", "cpu"):
        bk = tbackend.BFVBackend(make_params(n=256, t=T, k=30), seed=0, device=dev)
        kernels.reset_launch_counts()
        runs[dev] = legacy_query_run(mods, bk, "Q14")
        launches[dev] = kernels.launch_counts()
    card, cpu = runs["cuda"], runs["cpu"]
    assert all(launches["cuda"][k] > 0
               for k in ("ntt_fwd", "ntt_inv", "mul_mod", "add_mod", "sub_mod"))
    assert card["got"] == cpu["got"] == card["oracle"] and any(card["oracle"].values())
    assert card["stats"] == cpu["stats"] and card["refresh_log"] == cpu["refresh_log"]
    assert card["op_log"] == cpu["op_log"]


# -------------------------------------------------------------- scan step
def _scan_inputs(consts, lead_list, seed):
    q = consts["q"].cpu().numpy()[:, None]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, q, tuple(lead) + (consts["tabs"].k, consts["tabs"].n))
            for lead in lead_list]


@pytest.mark.gpu
def test_cuda_keyswitch_at_config_equals_contraction(cuda_device):
    """One block's key switch at CONFIG (n = 32768, k = 32) through the
    mul_mod / add_mod kernels against (poly * key mod q) summed over the
    digits in plain int64 ops, exactly."""
    consts = nshedb_step.make_constants(CONFIG, device=cuda_device)
    poly, kb, ka = (torch.from_numpy(x).to(cuda_device)
                    for x in _scan_inputs(consts, [(), (CONFIG.k,), (CONFIG.k,)], seed=0))
    q = consts["q"][:, None]
    kernels.reset_launch_counts()
    got = nshedb_step.keyswitch(poly, kb, ka, consts["tabs"])
    counts = kernels.launch_counts()
    assert counts["mul_mod"] == 2 and counts["add_mod"] == 10
    for g, key in zip(got, (kb, ka)):
        assert torch.equal(g, (poly[:, None] * key % q).sum(0) % q)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["all_gather", "reduce_scatter"])
def test_cuda_query_step_equals_cpu(cuda_device, mode):
    """query_step at smoke() on 4 blocks on the card equals its CPU run."""
    cfg = smoke()
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        consts = nshedb_step.make_constants(cfg, device=dev)
        col, val, *keys = (torch.from_numpy(x).to(dev) for x in _scan_inputs(
            consts, [(4, 2), (4, 2)] + [(cfg.k,)] * 4, seed=1))
        out[dev.type] = nshedb_step.query_step(
            col, val, *keys, consts["tabs"], consts["perm"], eq_levels=cfg.eq_levels,
            rot_steps=cfg.rot_steps, ks_mode=mode, chunk=2)
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


@pytest.mark.gpu
def test_cuda_gloo_mesh_folds_and_key_switches(cuda_device, tmp_path):
    """Two gloo ranks holding CUDA tensors: `kswitch_gathered` on a (1, 2)
    mesh with the whole key and with the rank's output-limb slice of it,
    the key switch of a batch held as the rank's limbs, and
    `sharded_fold` of a batch whole and held so; and a BFV micro fold
    under a real 2-rank scan mesh, each equal to the one-device result."""
    res = Ranks(2, ["kswitch", "bfv_fold"], tmp_path, device="cuda").results()
    for got in res["kswitch"]:
        assert got == {"batch": True, "single": True, "batch_placed": True,
                       "single_placed": True, "held": True, "fold": True, "fold_limbs": True}
    for got in res["bfv_fold"]:
        assert got["mesh"] == {"device_type": "cuda", "axes": ("data",), "shape": (2,)}
        np.testing.assert_array_equal(got["got"], got["base"])
        np.testing.assert_array_equal(got["got"], np.sum(got["vecs"], axis=0) % got["t"])


@pytest.mark.gpu
def test_cuda_gloo_batches_held_sharded(cuda_device, tmp_path):
    """Two gloo ranks holding CUDA tensors, a BFV micro batch of 3 blocks
    held sharded over a ("data",) mesh of 2 (4 lanes, 2 a rank, every
    limb) and over a (1, 2) ("data", "model") mesh (3 lanes, 6 of 12
    limbs a rank, the keys by output-limb slice): add, sub, mul_scalar,
    mul, rotate, sum_slots, a per-lane mul_plain, fold, unstack and
    decrypt (`batch_ops_run`) give every rank the residues, noise,
    decrypts and OpStats of the same calls on one device, the card."""
    exp = batch_ops_run(tbackend.BFVBackend(make_params(**MICRO), seed=11, device="cuda"))
    assert exp["held"] == [3, 3] and exp["limbs"] == [12, 12]
    res = Ranks(2, ["batch_ops", "batch_ops_1x2"], tmp_path, device="cuda").results()
    meshes = {"batch_ops": (("data",), (2,), 4, [2, 2], [12, 12]),
              "batch_ops_1x2": (("data", "model"), (1, 2), 3, [3, 3], [6, 6])}
    for case, (axes, shape, nphys, held, limbs) in meshes.items():
        for got in res[case]:
            assert got["mesh"] == {"device_type": "cuda", "axes": axes, "shape": shape}
            assert got["nphys"] == nphys and got["held"] == held and got["limbs"] == limbs
            for key in BATCH_KEYS:
                np.testing.assert_array_equal(got[key], exp[key], err_msg=f"{case}: {key}")
            assert got["stats"] == exp["stats"]


@pytest.mark.gpu
def test_cuda_gloo_scan_step_on_a_mesh(cuda_device, tmp_path):
    """Two gloo ranks holding CUDA tensors run `query_step_sharded` at
    smoke() on 4 blocks, each holding only its shard, on the ("data",) 2
    and the (1, 2) ("data", "model") mesh in both key-switch modes: every
    rank's aggregate, gathered along "model", equals the one-device step
    on the CPU."""
    cfg = smoke()
    consts = nshedb_step.make_constants(cfg, device="cpu")
    full = {key: torch.from_numpy(a)
            for key, a in scan_inputs(consts["q"].numpy(), cfg.k, cfg.n).items()}
    exp = nshedb_step.query_step(
        full["cts_col"], full["cts_val"], *(full[k] for k in ("rlk_b", "rlk_a", "gk_b", "gk_a")),
        consts["tabs"], consts["perm"], eq_levels=cfg.eq_levels, rot_steps=cfg.rot_steps).numpy()
    for got in Ranks(2, ["scan_step"], tmp_path, device="cuda").results()["scan_step"]:
        runs = [run for key, run in got.items() if key[2] != "keyswitch"]
        assert {key[0] for key in got} == {"data2", "1x2"} and len(runs) == 8
        for run in runs:
            assert np.array_equal(run["agg"], exp)


# -------------------------------------------------------------- flash_attn
def _qkv(B, H, Hkv, Sq, Sk, D, dtype, seed):
    """q (B, H, Sq, D) and k, v (B, Hkv, Sk, D): `qkv_arrays` rounded to
    `dtype` once."""
    return [torch.from_numpy(a).to(dtype) for a in qkv_arrays(B, H, Hkv, Sq, Sk, D, seed)]


# the edges of the bfloat16 kernel's tiles (64 query rows; 64 keys, past
# D = 128 32 or 16): lengths 1, 15, 17, 127, 129 and 65 (one past a query
# tile), the head dims the configs use, GQA 8, window edges inside a tile;
# chip_smoke.py's FLASH_EDGE_CASES
EDGE_CASES = [
    (1, 2, 1, 1, 1, 16, dict(causal=True)),
    (1, 2, 2, 15, 15, 64, dict(causal=True, softcap=50.0)),
    (2, 2, 1, 17, 17, 96, dict(causal=True, window=5)),
    (1, 4, 2, 127, 127, 128, dict(causal=True)),
    (1, 2, 1, 129, 129, 256, dict(causal=True, softcap=50.0)),
    (1, 2, 2, 65, 65, 64, dict(causal=True, window=40)),
    (1, 2, 1, 1, 129, 128, dict(causal=False)),
    (1, 2, 1, 129, 15, 64, dict(causal=False)),
    (1, 2, 1, 17, 127, 16, dict(causal=True)),
    (1, 2, 1, 127, 17, 96, dict(causal=True, softcap=50.0)),
    (1, 4, 2, 129, 129, 16, dict(causal=True, softcap=50.0)),
    (1, 16, 2, 129, 129, 128, dict(causal=True, softcap=50.0)),
    (1, 2, 1, 300, 300, 128, dict(causal=True, window=100)),
    (1, 2, 1, 200, 130, 256, dict(causal=False, window=70)),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "bshd"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", EDGE_CASES, ids=[f"e{i}" for i in range(len(EDGE_CASES))])
def test_cuda_kernel_matches_plain_version_at_tile_edges(cuda_device, case, dtype, strided):
    B, H, Hkv, Sq, Sk, D, kwargs = case
    q, k, v = _qkv(B, H, Hkv, Sq, Sk, D, DTYPES[dtype], seed=4)
    if "softcap" in kwargs:
        q = q * 12
    if strided:      # (B, S, heads, D) buffers, the layout the models pass
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    q, k, v = q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
    got = fa_ops.mha(q, k, v, **kwargs)
    exp = mha_ref(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert float((got.float() - exp.float()).abs().max()) <= FLASH_TOL[DTYPES[dtype]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_kernel_matches_plain_version(cuda_device, dtype):
    for B, H, Hkv, Sq, Sk, D, kwargs in [
            (2, 4, 2, 200, 200, 128, dict(causal=True, window=64, softcap=50.0)),
            (1, 12, 1, 96, 160, 64, dict(causal=False)),
            (1, 2, 2, 150, 40, 96, dict(causal=False, window=30))]:
        q, k, v = _qkv(B, H, Hkv, Sq, Sk, D, DTYPES[dtype], seed=3)
        q, k, v = q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
        got = fa_ops.mha(q, k, v, **kwargs)
        exp = mha_ref(q, k, v, **kwargs)
        torch.cuda.synchronize()
        assert float((got.float() - exp.float()).abs().max()) <= FLASH_TOL[DTYPES[dtype]]


# ------------------------------------------------------- LM training
# (B, H, Hkv, S, Sk, D, kwargs): starcoder2's heads at a short length, the
# gemma2 softcap and window with GQA 2:1, cross-attention, and S past one
# 2048-query chunk of the backward
GRAD_CASES = [
    (1, 24, 2, 256, 256, 128, dict(causal=True)),
    (1, 4, 2, 300, 300, 128, dict(causal=True, window=100, softcap=50.0)),
    (2, 4, 4, 96, 160, 64, dict(causal=False)),
    (1, 2, 1, 2100, 2100, 64, dict(causal=True)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GRAD_CASES, ids=[f"g{i}" for i in range(len(GRAD_CASES))])
def test_cuda_attention_gradients_match_plain_version(cuda_device, case):
    """`mha` under autograd on the card (the flash_attn kernel forward, the
    torch-op backward) against autograd through `mha_ref` on the card, in
    float32: dq, dk, dv within 1e-4 of the largest |gradient|."""
    B, H, Hkv, Sq, Sk, D, kwargs = case
    q, k, v = (t.to(cuda_device) for t in _qkv(B, H, Hkv, Sq, Sk, D, torch.float32, seed=6))
    if "softcap" in kwargs:
        q = q * 12
    w = torch.randn((B, H, Sq, D), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    grads = []
    for fn in (fa_ops.mha, mha_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = kernels.launch_counts()["flash_attn"]
        out = fn(*leaves, **kwargs)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad((out * w).sum(), leaves))
        launched = kernels.launch_counts()["flash_attn"] - before
        assert launched == (1 if fn is fa_ops.mha else 0)
    torch.cuda.synchronize()
    for got, exp in zip(*grads):
        assert float((got - exp).abs().max()) <= 1e-4 * float(exp.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma2-27b"])
def test_cuda_train_step_equals_cpu(cuda_device, arch):
    """Two train steps of a smoke config on the card and on the CPU from the
    same parameters and batches: losses, gradient norms and AdamW moments
    within 1e-4 relative (matmuls and the attention forward sum in other
    orders); parameters too, but where |m| < 1e-7 (|g| below about 1e-6 =
    100 AdamW eps, where g / (|g| + eps) turns on float32 rounding) within
    lr a step; one flash_attn launch per attention layer a step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train import steps

    cfg = get_smoke_config(arch)
    init = lm.init_params(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    runs = {}
    for dev in ("cpu", cuda_device):
        params = lm.tree_map(lambda t: t.to(dev, copy=True), init)
        opt = steps.init_opt(cfg, params)
        step = steps.make_train_step(cfg, lr=1e-3)
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, batch=2)
        metrics = []
        kernels.reset_launch_counts()
        for _ in range(2):
            batch = {k: torch.from_numpy(v).to(dev, torch.int64)
                     for k, v in pipe.next_batch().items()}
            params, opt, m = step(params, opt, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        runs[str(dev)] = (metrics, params, opt, kernels.launch_counts()["flash_attn"])
    (cm, cp, co, c_launch), (gm, gp, go, g_launch) = runs["cpu"], runs[str(cuda_device)]
    assert c_launch == 0 and g_launch == 2 * cfg.n_layers
    np.testing.assert_allclose(gm, cm, rtol=1e-4)
    for got, exp in zip(lm.tree_leaves([go["adam"]["m"], go["adam"]["v"]]),
                        lm.tree_leaves([co["adam"]["m"], co["adam"]["v"]])):
        assert float((got.cpu() - exp).abs().max()) <= 1e-4 * float(exp.abs().max())
    for got, exp, m in zip(lm.tree_leaves(gp), lm.tree_leaves(cp),
                           lm.tree_leaves(co["adam"]["m"])):
        d, tiny = (got.cpu() - exp).abs().numpy(), (m.abs() < 1e-7).numpy()
        assert float(d[~tiny].max(initial=0.0)) <= 1e-4 * float(exp.abs().max())
        assert float(d[tiny].max(initial=0.0)) <= 2 * 1e-3


MAMBA2_LAYERS, MAMBA2_PROMPT, MAMBA2_DECODE = 4, 256, 3
BF16_SERVE_TOL = 0.04    # of the largest reference logit, as tests/test_torch_serve_bf16.py


def _mamba2_serve(cfg, init, tokens, dev, dtype):
    """Prefill and teacher-forced decode of `tokens` with `init` cast to
    `dtype` on `dev`: the logits of every step (float32, on the CPU), the
    last step's logits dtype and the caches it left."""
    from repro_torch.models import lm
    from repro_torch.train import steps

    params = lm.tree_map(lambda t: t.to(dev, dtype) if t.is_floating_point() else t.to(dev),
                         init)
    tok = tokens.to(dev)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    logits, caches = prefill(params, {"tokens": tok[:, :MAMBA2_PROMPT]})
    out = [logits.float().cpu()]
    for i in range(MAMBA2_DECODE):
        pos = MAMBA2_PROMPT + i
        logits, caches = decode(params, caches, {"tokens": tok[:, pos:pos + 1]}, pos=pos)
        out.append(logits.float().cpu())
    return out, logits.dtype, caches


@pytest.mark.gpu
def test_cuda_mamba2_bf16_decode_at_full_width(cuda_device):
    """mamba2-1.3b at full width (d_model 2048, 64 heads of 64, state 128,
    vocab 50,280; MAMBA2_LAYERS of its 48 layers) in bfloat16 on the card:
    a 2 x 256-token prefill and three teacher-forced decode steps, the
    decode branch that casts the C projection to the float32 state.  The
    logits are bfloat16 and finite, the SSM state a decode step leaves is
    float32, and at every step the logits are within 0.04 of the largest
    reference logit of the same bfloat16 run on the CPU and of a float32
    run on the card from the same (bfloat16) parameters.  `pytest -s`
    prints the gaps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=MAMBA2_LAYERS)
    init = lm.init_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, MAMBA2_PROMPT + MAMBA2_DECODE)))
    got, dtype, caches = _mamba2_serve(cfg, init, tokens, cuda_device, torch.bfloat16)
    assert dtype == torch.bfloat16
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert {c["state"].dtype for c in caches["units"]} == {torch.float32}
    refs = {"cpu_bf16": _mamba2_serve(cfg, init, tokens, "cpu", torch.bfloat16)[0],
            "cuda_f32": _mamba2_serve(cfg, init, tokens, cuda_device, torch.float32)[0]}
    for name, ref in refs.items():
        gaps = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
        print(f"mamba2 bf16 on the card vs {name}: gaps {' '.join(f'{x:.4f}' for x in gaps)}")
        assert max(gaps) <= BF16_SERVE_TOL, (name, gaps)
