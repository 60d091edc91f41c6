"""The port's real-mesh paths against the JAX package's unsharded runs:
the twins of the reference's multidevice cases (tests/test_sharded_exec.py
and tests/test_limb_sharding.py, which skip on a one-device host), run
here in `gloo` ranks on the CPU (tests/torch_mesh_ranks.py).

Each mesh shape's ranks start once per module and run all its cases: two
ranks (a ("data",) scan mesh of 2, a (1, 2) query mesh) and four (a
(2, 2) query mesh).  Every rank runs the same program, holding only its
own lanes of every batch stacked on a mesh with a "data" axis of 2, and
of them only its 6 of the 12 limbs on a "model" axis of 2, and every key
switch key by its output-limb slice there; its gathered residues,
decrypts and `OpStats` must equal the JAX package's unsharded run
(tolerance 0), its `ExecReport` and ledger snapshot the port's logical
context at the same cell (compared with `==`, the ledger's `real_mesh`
flag aside).  The JAX runs, the port's one-device
runs and the logical ones run here, in the parent, where no process
group exists.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.noise import NoiseProfile as JNoiseProfile
from repro.core.params import make_params as jax_make_params
from repro.engine import backend as jbackend
from repro.engine import executor as jexecutor
from repro.engine import plan as jplan
from repro.engine import planner as jplanner
from repro.engine import queries as jqueries
from repro.engine import schema as jschema
from repro.engine import sharded as jsharded
from repro.engine import storage as jstorage
from repro.engine import tpch as jtpch
from repro_torch.core.noise import NoiseProfile
from repro_torch.core.params import make_params
from repro_torch.engine import backend as tbackend
from repro_torch.engine import executor as texecutor
from repro_torch.engine import plan as tplan
from repro_torch.engine import planner as tplanner
from repro_torch.engine import queries as tqueries
from repro_torch.engine import schema as tschema
from repro_torch.engine import sharded as tsharded
from repro_torch.engine import storage as tstorage
from repro_torch.engine import tpch as ttpch
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh

from torch_cases import bfv_shard_db, bfv_shard_oracle, bfv_shard_plans, sharded_run
from torch_mesh_ranks import (BATCH_KEYS, MICRO, REFRESH_KEYS, Ranks, batch_ops_run,
                              compressed_psum_expected, refresh_run)

JAX = dict(backend=jbackend, executor=jexecutor, plan=jplan, planner=jplanner,
           queries=jqueries, schema=jschema, sharded=jsharded, storage=jstorage, tpch=jtpch)
PORT = dict(backend=tbackend, executor=texecutor, plan=tplan, planner=tplanner,
            queries=tqueries, schema=tschema, sharded=tsharded, storage=tstorage, tpch=ttpch)
MESH_CELLS = [(1, 2), (2, 2)]
PLANS = ["g1", "j1", "f1"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The micro BFV runs are thousands of tiny tensor ops (see
    tests/test_torch_sharded.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Two and four gloo ranks, started before the reference runs so that
    both proceed together."""
    started = {2: Ranks(2, ["fold", "bfv_fold", "mock_q1", "bfv_1x2", "auto", "kswitch",
                            "compressed_psum", "batch_ops", "refresh_lanes", "batch_ops_1x2",
                            "refresh_lanes_1x2", "limbs_held"],
                        tmp_path_factory.mktemp("mesh2")),
               4: Ranks(4, ["bfv_2x2", "auto", "kswitch", "batch_ops", "refresh_lanes",
                            "limbs_held"],
                        tmp_path_factory.mktemp("mesh4"))}
    yield started
    for group in started.values():
        group.close()


@pytest.fixture(scope="module")
def ranks(started, bfv_reference):
    """{world: {case: [result per rank]}}."""
    return {world: r.results() for world, r in started.items()}


@pytest.fixture(scope="module")
def bfv_reference(started):
    """The JAX package's unsharded BFV micro runs, the port's logical runs
    at every mesh cell, and the plaintext oracles."""
    jdb, data, pdata = bfv_shard_db(JAX, jbackend.BFVBackend(
        jax_make_params(**MICRO), seed=11, kernel_backend="ref"))
    tdb, _, _ = bfv_shard_db(PORT, tbackend.BFVBackend(make_params(**MICRO), seed=11,
                                                       device="cpu"))
    jplans, tplans = bfv_shard_plans(jplan), bfv_shard_plans(tplan)
    out = {"jax": {p: sharded_run(JAX, jdb, jplans[p], None) for p in PLANS},
           "logical": {(p, c): sharded_run(PORT, tdb, tplans[p], c)
                       for p in PLANS for c in MESH_CELLS},
           "oracle": {p: bfv_shard_oracle(p, data, pdata) for p in PLANS}}
    # the batch cases' one-device runs, each on fresh keys (seed 11)
    for case, run in (("batch_ops", batch_ops_run), ("refresh_lanes", refresh_run)):
        out[case] = {
            "jax": run(jbackend.BFVBackend(jax_make_params(**MICRO), seed=11,
                                           kernel_backend="ref")),
            "port": run(tbackend.BFVBackend(make_params(**MICRO), seed=11, device="cpu"))}
    return out


def _ledger_as_logical(led):
    assert led["real_mesh"] is True
    return {**led, "real_mesh": False}


def test_sharded_fold_matches_numpy(ranks):
    for res in ranks[2]["fold"]:
        data = res["data"]
        np.testing.assert_array_equal(res["live3"], data[:3].sum(axis=0))
        # pads excluded: live=4 differs
        np.testing.assert_array_equal(res["live4"], data.sum(axis=0))
        assert not np.array_equal(res["live4"], data[:3].sum(axis=0))


def test_compressed_psum_matches_numpy(ranks):
    """Two ranks with gradients of different scales: both get the numpy
    formula's sum (the same float32 operations: tolerance 0), which is
    within half a bin a rank of the exact sum."""
    res = ranks[2]["compressed_psum"]
    gs = [r["g"] for r in res]
    exp = compressed_psum_expected(gs)
    scale = max(np.abs(g).max() for g in gs) / 127
    for r in res:
        np.testing.assert_array_equal(r["out"], exp)
    assert np.abs(exp - np.sum(gs, axis=0)).max() <= len(gs) * scale / 2 * (1 + 1e-5)
    assert not np.array_equal(gs[0], gs[1])


def test_bfv_fold_on_real_mesh_parity(ranks):
    for res in ranks[2]["bfv_fold"]:
        assert res["mesh"] == {"device_type": "cpu", "axes": ("data",), "shape": (2,)}
        assert res["nphys"] == 4 and res["nblocks"] == 3 and res["held"] == 2
        np.testing.assert_array_equal(res["got"], res["base"])
        np.testing.assert_array_equal(res["got"], np.sum(res["vecs"], axis=0) % res["t"])


def test_mock_query_with_real_mesh(ranks):
    """Q1 on the Mock backend under a real 2-rank mesh (only the ledger
    layer sees it) equals the JAX package's unsharded run, its ledger the
    port's logical context's."""
    jdb = jtpch.load(jbackend.MockBackend(JNoiseProfile(n=64, t=65537, k=30)),
                     jtpch.Scale.tiny())
    jax_ = sharded_run(JAX, jdb, jqueries.QUERIES["Q1"][0](), None)
    tdb = ttpch.load(tbackend.MockBackend(NoiseProfile(n=64, t=65537, k=30), device="cpu"),
                     ttpch.Scale.tiny())
    logical = sharded_run(PORT, tdb, tqueries.QUERIES["Q1"][0](), (2, 1))
    for res in ranks[2]["mock_q1"]:
        for run in (res["base"], res["shard"]):
            assert run["got"] == jax_["got"] == tqueries.QUERIES["Q1"][2](tdb)
            assert run["stats"] == jax_["stats"]
        assert res["shard"]["report"] == logical["report"]
        assert _ledger_as_logical(res["shard"]["ledger"]) == logical["ledger"]


@pytest.mark.parametrize("cell", MESH_CELLS, ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("pname", PLANS)
def test_bfv_micro_2d_parity(ranks, bfv_reference, pname, cell):
    """Real ciphertexts on a (1, 2) and a (2, 2) mesh, every stacked
    batch held as its rank's lanes and 6 of its 12 limbs, every key as
    its (12, 6, 128) output-limb slice: every rank's decrypts and OpStats
    equal the JAX package's unsharded run and the oracle, its report and
    ledger the port's logical context's; digits were gathered."""
    world, case = (2, "bfv_1x2") if cell == (1, 2) else (4, "bfv_2x2")
    jax_ = bfv_reference["jax"][pname]
    logical = bfv_reference["logical"][(pname, cell)]
    for res in ranks[world][case]:
        run = res[(pname, cell)]
        assert run["got"] == jax_["got"] == bfv_reference["oracle"][pname]
        assert run["stats"] == jax_["stats"] and run["stats"]["refresh"] == 0
        assert run["report"] == logical["report"]
        assert _ledger_as_logical(run["ledger"]) == logical["ledger"]
        assert run["ledger"]["gathers"] > 0 and run["ledger"]["gather_bytes"] > 0
        # a batch of many lanes is held nphys / D lanes a rank ("data" of
        # D), and k / M limbs of them ("model" of M)
        assert any(nphys > 1 for nphys, _, _ in run["stacked"])
        assert all(held == (nphys // cell[0] if nphys > 1 else 1)
                   for nphys, held, _ in run["stacked"]), run["stacked"]
        assert all(limbs == (MICRO["k"] // cell[1] if nphys > 1 else MICRO["k"])
                   for nphys, _, limbs in run["stacked"]), run["stacked"]
        assert run["key_limbs"] == [(MICRO["k"], MICRO["k"] // cell[1])]


def test_kswitch_gathered_equals_one_device(ranks):
    """A 4-lane batch and a single polynomial that every rank holds (limbs
    split over "model"), with the whole key and with the rank's output-
    limb slice of it; the batch held as the rank's limbs (digits
    gathered, outputs held); and `sharded_fold` of 3 live lanes (this
    rank's lanes summed, then over "data"), whole and held as the rank's
    limbs, each against the one-device arithmetic."""
    for world in (2, 4):
        for res in ranks[world]["kswitch"]:
            assert res == {"batch": True, "single": True, "batch_placed": True,
                           "single_placed": True, "held": True, "fold": True,
                           "fold_limbs": True}


MESH_OF = {2: {"device_type": "cpu", "axes": ("data",), "shape": (2,)},
           4: {"device_type": "cpu", "axes": ("data", "model"), "shape": (2, 2)}}


def _equal_runs(got, exp, keys):
    for key in keys:
        np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
    assert got["stats"] == exp["stats"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["batch_ops", "refresh_lanes"])
def test_batches_held_sharded_equal_one_device(ranks, bfv_reference, case, world):
    """A 3-block BFV micro batch (4 lanes) held sharded on a ("data",) 2
    and a (2, 2) mesh, 2 lanes a rank, and on the (2, 2) mesh 6 of 12
    limbs of them.  `batch_ops`: add, sub of a single ciphertext,
    mul_scalar, mul, rotate, sum_slots and a per-lane mul_plain, then
    fold, unstack and decrypt; `refresh_lanes`: `refresh_inplace` on the
    global lanes [0, 2] and on every lane.  Every rank's gathered
    residues, noise, decrypts and OpStats equal the JAX package's and the
    port's one-device run bit for bit, and so do the residues of the next
    encryption after the refreshes."""
    ref = bfv_reference[case]
    keys = BATCH_KEYS if case == "batch_ops" else REFRESH_KEYS
    if case == "refresh_lanes":
        assert np.ndim(ref["jax"]["lanes_noise"]) == 1      # lanes 0, 2 fresh, 1 not
    _equal_runs(ref["port"], ref["jax"], keys)
    limbs = MICRO["k"] // (2 if world == 4 else 1)
    for res in ranks[world][case]:
        _equal_runs(res, ref["jax"], keys)
        if case == "batch_ops":
            assert res["mesh"] == MESH_OF[world]
            assert res["nphys"] == 4 and res["held"] == [2, 2] and res["limbs"] == [limbs] * 2
        else:
            assert res["lanes_held"] == res["whole_held"] == 2
            assert res["lanes_limbs"] == res["whole_limbs"] == limbs


@pytest.mark.parametrize("case", ["batch_ops", "refresh_lanes"])
def test_batches_held_over_model_equal_one_device(ranks, bfv_reference, case):
    """The same batch on a (1, 2) mesh of two ranks: every lane (3, no
    pad), 6 of 12 limbs a rank; gathered residues, noise, decrypts,
    OpStats and the next encryption equal the JAX package's one-device
    run bit for bit."""
    ref = bfv_reference[case]
    keys = BATCH_KEYS if case == "batch_ops" else REFRESH_KEYS
    for res in ranks[2][case + "_1x2"]:
        _equal_runs(res, ref["jax"], keys)
        if case == "batch_ops":
            assert res["mesh"] == _desc(("data", "model"), (1, 2))
            assert res["nphys"] == 3 and res["held"] == [3, 3] and res["limbs"] == [6, 6]
        else:
            assert res["lanes_held"] == res["whole_held"] == 3
            assert res["lanes_limbs"] == res["whole_limbs"] == 6


@pytest.mark.parametrize("world", [2, 4])
def test_keys_held_by_output_limb_slice(ranks, world):
    """After its first key switch on a (1, 2) / (2, 2) mesh the backend
    holds `rlk` and every Galois key as (12, 6, 128): rank r of "model"
    the output limbs [6r, 6r + 6), equal to the whole key's slice and to
    `sharded.place_keys` of the whole keys, which a caller keeps whole."""
    M = 2
    for rank, res in enumerate(ranks[world]["limbs_held"]):
        lo = (rank % M) * 6
        assert res["limbs"] == (lo, lo + 6, 12)
        assert res["key_shapes"] == [(12, 6, 128)] and res["key_limbs"] == [(lo, lo + 6)]
        assert res["keys_equal_slices"] and res["whole_keys_kept"] and res["place_keys_equal"]


@pytest.mark.parametrize("world", [2, 4])
def test_placed_key_refused_off_its_slice(ranks, world):
    """A key held by output-limb slice raises on the one-device key
    switch, multiply and rotation, and where another rank's limbs are
    asked of it (a batch's multiply, a singleton's key switch)."""
    for res in ranks[world]["limbs_held"]:
        msgs = res["refused"]
        for name in ("kswitch_inner", "one_device_mul", "one_device_rotate"):
            assert "needs whole (k, k, n) keys, got (12, 6, 128)" in msgs[name], name
        for name in ("other_slice", "other_slice_single"):
            assert "cannot key-switch limbs [" in msgs[name], name


@pytest.mark.parametrize("world", [2, 4])
def test_limb_held_batch_refuses_other_limbs(ranks, world):
    """A batch held over "model" raises against the same lanes holding
    every limb."""
    for res in ranks[world]["limbs_held"]:
        msg = res["refused"]["other_limbs"]
        assert 'held over "model" (limbs [' in msg and "not every limb of" in msg


@pytest.mark.parametrize("world", [2, 4])
def test_limb_held_batch_refused_until_gathered(ranks, world):
    """unstack_cts, fold_add and decrypt refuse a batch held over "model";
    gathered, it unstacks into its 3 live lanes."""
    for res in ranks[world]["limbs_held"]:
        for name in ("unstack_cts", "fold_add", "decrypt"):
            msg = res["refused"][name]
            assert "needs every limb" in msg and "gather them first" in msg, name
        assert res["unstacked"] == 3


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_batch_refuses_other_lanes(ranks, world):
    """A batch held sharded raises against a whole batch of as many
    lanes and against a batch holding other lanes, and unstack_cts /
    fold_add refuse it until it is gathered."""
    for res in ranks[world]["batch_ops"]:
        msgs = res["refused"]
        assert "not a whole batch of 4 lanes" in msgs["whole_pair"]
        assert "not lanes [" in msgs["other_lanes"] and "of 4" in msgs["other_lanes"]
        assert all("gather them first" in msgs[k] for k in ("unstack_cts", "fold_add"))


def _desc(axes, shape):
    return {"device_type": "cpu", "axes": axes, "shape": shape}


def test_make_shard_context_auto(ranks):
    """Without a process group "auto" stays logical; under one it
    attaches a query mesh when shards x limb_shards ranks exist and
    k % limb_shards == 0, else a scan mesh when 1 < shards fits."""
    for shards, m, limbs in ((2, 1, 12), (1, 2, 12), (2, 2, 12), (1, 4, 30)):
        ctx = tsharded.make_shard_context(shards, limb_shards=m, limbs=limbs, ring_n=128)
        assert ctx.mesh is None and ctx.limb_mesh is None
    data2, q12, q22 = _desc(("data",), (2,)), _desc(("data", "model"), (1, 2)), \
        _desc(("data", "model"), (2, 2))
    want = {2: {(2, 1, 12): data2, (1, 2, 12): q12, (2, 2, 12): data2, (1, 4, 30): None,
                (1, 2, 30): q12, (4, 1, 12): None},
            4: {(2, 1, 12): data2, (1, 2, 12): q12, (2, 2, 12): q22, (1, 4, 30): None,
                (1, 2, 30): q12, (4, 1, 12): _desc(("data",), (4,))}}
    for world in (2, 4):
        for res in ranks[world]["auto"]:
            assert res["contexts"] == want[world]
            assert res["host"] == _desc(("data",), (world,))


def test_mesh_factories_raise(ranks):
    for fn in (lambda: tmesh.make_scan_mesh(1), lambda: tmesh.make_query_mesh(1, 1),
               tmesh.make_host_mesh):
        with pytest.raises(ValueError, match="process group"):
            fn()
    for res in ranks[2]["auto"]:
        assert set(res["raised"]) == {"query_2x2", "production", "scan_3"}
        assert all("ranks but only 2 are in the process group" in msg
                   for msg in res["raised"].values())
    for res in ranks[4]["auto"]:
        assert res["raised"]["query_2x2"] is None and res["raised"]["scan_3"] is None
        assert "needs 256 ranks but only 4" in res["raised"]["production"]


def test_dryrun_record_scan_2m(tmp_path):
    """scan_2m on a 16 x 16 mesh, one device's share with no process
    group: 64 blocks over 16 data ranks (4 a device), 32 limbs over 16
    model ranks.  Bytes held from shapes; the step run on meta tensors
    for flops, bytes moved, temporaries and the collectives: 32 key
    switches a block, each all-gathering the 4 blocks' digits (4 x 32 x
    32768 int32), and one all-reduce of the (2, 2, 32768) aggregate a
    block axis (two on the multi-pod mesh: "pod", then "data")."""
    import json
    import torch.distributed as dist
    rec = dryrun.run_cell("nshedb", "scan_2m", "single")
    assert not dist.is_initialized()
    n, k = 32768, 32
    ct = (64 // 16) * 2 * (k // 16) * n * 8
    key = k * (k // 16) * n * 8
    assert rec["argument_bytes"] == 2 * ct + 4 * key + 2 * k * 8 + n * 8
    assert rec["output_bytes"] == 2 * (k // 16) * n * 8
    assert rec["mesh_shape"] == [16, 16] and rec["status"] == "ok"
    ref_fields = {"arch", "shape", "mesh", "mesh_shape", "status", "lower_s", "compile_s",
                  "flops", "hlo_bytes", "argument_bytes", "output_bytes", "temp_bytes",
                  "peak_bytes", "collective_bytes", "collective_total", "wall_s"}
    assert ref_fields <= set(rec)
    assert {f for f in ref_fields if rec[f] is None} == set(rec["null_reasons"]) == {
        "lower_s", "compile_s"}
    gather = 32 * 4 * k * n * 4
    assert gather == 536_870_912
    assert rec["collective_bytes"] == {"all-gather": gather, "all-reduce": 1_048_576,
                                       "reduce-scatter": 0, "all-to-all": 0,
                                       "collective-permute": 0}
    assert rec["collective_total"] == gather + 1_048_576
    assert rec["ks_mode"] == "all_gather" and rec["key_placement"] == [None, "model", None]
    for field in ("flops", "hlo_bytes", "temp_bytes", "peak_bytes"):
        assert rec[field] > 0
    assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"] >= rec["argument_bytes"]
    multi = dryrun.run_cell("nshedb", "scan_2m", "multi")
    assert multi["argument_bytes"] == 2 * (ct // 2) + 4 * key + 2 * k * 8 + n * 8
    assert multi["collective_bytes"]["all-gather"] == gather // 2
    assert multi["collective_bytes"]["all-reduce"] == 2 * 1_048_576
    assert not dist.is_initialized()
    lm = dryrun.run_cell("gemma2-27b", "train_4k", "single")
    assert lm["status"] == "skip" and "training slice" in lm["reason"]
    # one record file a cell; --skip-existing keeps a file that says ok
    argv = ["--arch", "nshedb", "--shape", "scan_2m", "--out", str(tmp_path)]
    (first,) = dryrun.main(argv)
    path = tmp_path / "nshedb__scan_2m__single.json"
    assert json.loads(path.read_text()) == first
    path.write_text(json.dumps(dict(first, wall_s=-1.0)))
    assert dryrun.main(argv + ["--skip-existing"]) == []
    assert json.loads(path.read_text())["wall_s"] == -1.0
    path.write_text(json.dumps(dict(first, status="fail")))
    (again,) = dryrun.main(argv + ["--skip-existing"])
    assert again["status"] == "ok" and json.loads(path.read_text())["status"] == "ok"
    assert not dist.is_initialized()
