"""The scan step on a real device mesh (`nshedb_step.query_step_sharded`,
`keyswitch_sharded`) against one device and the JAX package, bit for bit
(tolerance 0: exact integer arithmetic), at `configs.nshedb.smoke()`
(n = 256, k = 4, t = 257) on 4 blocks.

`tests/torch_mesh_ranks.Ranks` runs gloo ranks on the CPU, each holding
only its shard, on meshes ("data",) 2 and ("data", "model") 1 x 2 (two
ranks), 2 x 2 and ("pod", "data", "model") 2 x 1 x 2 (four ranks), in
both key-switch modes, with chunks of all the rank's blocks and of 1.
Each rank's aggregate, gathered along "model", must equal the port's
one-device `query_step` and the JAX package's; the collectives a rank
records in the step must equal the dry-run's count for the same mesh,
blocks and chunk (`launch/dryrun.measure_step`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import nshedb as jcfg
from repro.launch import nshedb_step as J
from repro_torch.configs import nshedb as tcfg
from repro_torch.core import collectives
from repro_torch.launch import dryrun
from repro_torch.launch import nshedb_step as T

from torch_mesh_ranks import SCAN_BLOCKS, Ranks, scan_inputs

CFG = tcfg.smoke()
MESHES = {"data2": 2, "1x2": 2, "2x2": 4, "pod2x1x2": 4}     # name: world
KEYS = ("rlk_b", "rlk_a", "gk_b", "gk_a")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def consts():
    return J.make_constants(jcfg.smoke()), T.make_constants(CFG, device="cpu")


@pytest.fixture(scope="module")
def inputs(consts):
    return scan_inputs(consts[1]["q"].numpy(), CFG.k, CFG.n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds started at once; {world: {case: [per rank]}}."""
    started = {world: Ranks(world, ["scan_step"], tmp_path_factory.mktemp(f"scan{world}"))
               for world in (2, 4)}
    try:
        yield {world: r.results()["scan_step"] for world, r in started.items()}
    finally:
        for r in started.values():
            r.close()


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


@pytest.fixture(scope="module")
def expected(consts, inputs):
    """{mode: aggregate} of the JAX package (under a 1 x 1 mesh: its
    reduce_scatter mode places a constraint) and of the port on one
    device, which must agree."""
    jc, tc = consts
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    out = {}
    with jax.set_mesh(mesh):
        for mode in T.KS_MODES:
            jout = np.asarray(J.query_step(
                _j(inputs["cts_col"]), _j(inputs["cts_val"]), *(_j(inputs[k]) for k in KEYS),
                jnp.asarray(jc["q"]), jnp.asarray(jc["mu"]), jnp.asarray(jc["perm"]),
                eq_levels=CFG.eq_levels, rot_steps=CFG.rot_steps, ks_mode=mode)).astype(np.int64)
            tout = T.query_step(torch.from_numpy(inputs["cts_col"]),
                                torch.from_numpy(inputs["cts_val"]),
                                *(torch.from_numpy(inputs[k]) for k in KEYS), tc["tabs"],
                                tc["perm"], eq_levels=CFG.eq_levels, rot_steps=CFG.rot_steps,
                                ks_mode=mode).numpy()
            assert np.array_equal(jout, tout)
            out[mode] = tout
    return out


def _runs(ranks, name, mode):
    """[(chunk, result)] of every rank of mesh `name` in `mode`."""
    return [(key[2], res[key]) for res in ranks[MESHES[name]] for key in res
            if key[:2] == (name, mode) and key[2] != "keyswitch"]


@pytest.mark.parametrize("mode", T.KS_MODES)
@pytest.mark.parametrize("name", list(MESHES))
def test_aggregate_equals_one_device_and_jax(ranks, expected, name, mode):
    runs = _runs(ranks, name, mode)
    world = MESHES[name]
    assert len({chunk for chunk, _ in runs}) == 2 or runs[0][1]["blocks_per_rank"] == 1
    assert len(runs) >= world
    for _, res in runs:
        assert res["agg"].shape == (2, CFG.k, CFG.n)
        assert np.array_equal(res["agg"], expected[mode])
        assert res["blocks_per_rank"] * np.prod(
            [s for s, a in zip(*res["mesh"]) if a in T.BLOCK_AXES]) == SCAN_BLOCKS


@pytest.mark.parametrize("mode", T.KS_MODES)
@pytest.mark.parametrize("name", list(MESHES))
def test_keyswitch_sharded_equals_one_device(ranks, consts, inputs, name, mode):
    poly = torch.from_numpy(inputs["cts_col"][0, 1])
    exp = T.keyswitch(poly, torch.from_numpy(inputs["rlk_b"]), torch.from_numpy(inputs["rlk_a"]),
                      consts[1]["tabs"])
    for res in ranks[MESHES[name]]:
        got = res[name, mode, "keyswitch"]
        assert all(np.array_equal(g, e.numpy()) for g, e in zip(got, exp))


@pytest.mark.parametrize("mode", T.KS_MODES)
@pytest.mark.parametrize("name", list(MESHES))
def test_collective_record_equals_dryrun(ranks, name, mode):
    """The bytes each rank's collectives carried in the step are the
    dry-run's count for the same mesh, blocks and chunk; by kind, an
    all-gather of the digits or a reduce-scatter where "model" splits,
    an all-reduce where the blocks split."""
    for chunk, res in _runs(ranks, name, mode):
        shape, axes = res["mesh"]
        pred = dryrun.measure_step(CFG, shape, axes, SCAN_BLOCKS, ks_mode=mode, chunk=chunk)
        assert res["record"] == pred["collective_bytes"]
        sizes = dict(zip(axes, shape))
        model, blocks = sizes.get("model", 1), SCAN_BLOCKS // res["blocks_per_rank"]
        ks = CFG.eq_levels + 1 + CFG.rot_steps
        nb, kl = res["blocks_per_rank"], CFG.k // model
        # the digits cross as int32
        gather = ks * nb * CFG.k * CFG.n * 4 if model > 1 and mode == "all_gather" else 0
        scatter = ks * 2 * nb * kl * CFG.n * 8 if model > 1 and mode == "reduce_scatter" else 0
        reduce = sum(2 * kl * CFG.n * 8 for a in T.BLOCK_AXES if sizes.get(a, 1) > 1)
        assert blocks == np.prod([sizes.get(a, 1) for a in T.BLOCK_AXES])
        assert res["record"] == {"all-gather": gather, "all-reduce": reduce,
                                 "reduce-scatter": scatter, "all-to-all": 0,
                                 "collective-permute": 0}


def test_non_power_of_two_blocks_per_rank_raise(consts):
    """6 blocks over 2 "data" ranks leave 3 a rank: the halving tree
    refuses it before any collective (a stand-in mesh, CPU tensors); so
    does a model axis that does not divide the k = 4 limbs."""
    tc = consts[1]
    mesh = dryrun.ShapeMesh((2,), ("data",))
    full = {key: torch.from_numpy(a) for key, a in
            scan_inputs(tc["q"].numpy(), CFG.k, CFG.n, nblocks=6).items()}
    local = T.shard_inputs(full, mesh)
    assert local["cts_col"].shape[0] == 3
    with pytest.raises(ValueError, match="blocks per rank must be a power of two"):
        T.query_step_sharded(local["cts_col"], local["cts_val"], *(local[k] for k in KEYS),
                             tc["tabs"], tc["perm"], mesh, eq_levels=1, rot_steps=1)
    with pytest.raises(ValueError, match="do not split over a model axis of 3"):
        T.query_step_sharded(local["cts_col"], local["cts_val"], *(local[k] for k in KEYS),
                             tc["tabs"], tc["perm"], dryrun.ShapeMesh((3,), ("model",)),
                             eq_levels=1, rot_steps=1)


def test_shard_inputs_place_keys_by_mode(consts, inputs):
    """"all_gather" keys: the digit axis whole, output limbs over
    "model"; "reduce_scatter" keys: digits over "model", output limbs
    whole; blocks over ("pod", "data") major first, limbs over "model"."""
    mesh = dryrun.ShapeMesh((2, 1, 2), ("pod", "data", "model"))
    full = {key: torch.from_numpy(a) for key, a in inputs.items()}
    ag, rs = T.shard_inputs(full, mesh, "all_gather"), T.shard_inputs(full, mesh, "reduce_scatter")
    kl = CFG.k // 2
    assert torch.equal(ag["rlk_b"], full["rlk_b"][:, :kl])
    assert torch.equal(rs["rlk_b"], full["rlk_b"][:kl])
    assert torch.equal(ag["cts_col"], full["cts_col"][:2, :, :kl])
    assert torch.equal(rs["cts_col"], ag["cts_col"])
    with pytest.raises(ValueError, match="does not split"):
        T.local_shard(full["cts_col"], (None, None, "model", None),
                      dryrun.ShapeMesh((3,), ("model",)))


def test_collectives_on_a_stand_in_mesh_send_nothing():
    """Meta tensors under `ShapeMesh`: each helper returns its result's
    shape and records it; a CPU tensor there would need a group."""
    mesh = dryrun.ShapeMesh((4, 2), ("data", "model"))
    t = torch.empty(3, 8, 5, dtype=torch.int64, device="meta")
    collectives.reset_collective_record()
    assert collectives.gather_axis(t, mesh, "model", dim=1).shape == (3, 16, 5)
    assert collectives.reduce_scatter_axis(t, mesh, "model", dim=1).shape == (3, 4, 5)
    assert collectives.sum_axis(t, mesh, "data") is t
    assert collectives.gather_axis(t, mesh, "pod", dim=0) is t
    rec = collectives.collective_record()
    assert rec == {"all-gather": 3 * 16 * 5 * 8, "all-reduce": 3 * 8 * 5 * 8,
                   "reduce-scatter": 3 * 4 * 5 * 8, "all-to-all": 0, "collective-permute": 0}
    collectives.reset_collective_record()
    assert sum(collectives.collective_record().values()) == 0
    with pytest.raises(RuntimeError, match="no process group"):
        collectives.sum_axis(torch.zeros(2), mesh, "data")
