"""The port's encrypted-scan step (`repro_torch.launch.nshedb_step`) and
its configuration against the JAX package's, bit for bit (tolerance 0:
exact integer arithmetic), at `configs.nshedb.smoke()` (n = 256, k = 4,
t = 257) on the same numpy inputs.  The port runs the modops kernels'
plain versions here (CPU tensors); the JAX package runs its jnp uint32
Barrett code.  Also: the dry-run's shape stand-ins of both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs import input_specs as jinput_specs
from repro.configs import nshedb as jcfg
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import SHAPES as JLM_SHAPES
from repro.launch import nshedb_step as J
from repro_torch.configs import get_smoke_config, input_specs
from repro_torch.configs import nshedb as tcfg
from repro_torch.configs.registry import ARCHS, SHAPES as LM_SHAPES
from repro_torch.launch import nshedb_step as T

CFG = tcfg.smoke()


@pytest.fixture(scope="module")
def consts():
    return J.make_constants(jcfg.smoke()), T.make_constants(CFG, device="cpu")


@pytest.fixture(scope="module")
def inputs(consts):
    """Residues mod each limb's prime for 4 blocks of (col, val) and the
    four keys, drawn from one seeded generator."""
    q = consts[0]["q"].astype(np.int64)[:, None]
    rng = np.random.default_rng(3)
    draw = lambda *lead: rng.integers(0, q, lead + (CFG.k, CFG.n)).astype(np.int64)
    return {"col": draw(4, 2), "val": draw(4, 2),
            "keys": [draw(CFG.k) for _ in range(4)]}


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _eq(jx, tx):
    return np.array_equal(np.asarray(jx).astype(np.int64), tx.numpy())


def _jargs(jc):
    return jnp.asarray(jc["q"]), jnp.asarray(jc["mu"])


def test_configs_equal_the_reference():
    assert dataclasses.asdict(tcfg.CONFIG) == dataclasses.asdict(jcfg.CONFIG)
    assert dataclasses.asdict(tcfg.smoke()) == dataclasses.asdict(jcfg.smoke())
    assert tcfg.SHAPES == jcfg.SHAPES


def test_make_constants(consts):
    jc, tc = consts
    assert np.array_equal(tc["q"].numpy(), jc["q"].astype(np.int64))
    assert np.array_equal(tc["perm"].numpy(), jc["perm"].astype(np.int64))
    assert tc["tabs"].k == CFG.k and tc["tabs"].n == CFG.n
    # the port's Barrett constant is floor(2^64 / q), the reference's 2^60
    assert [int(m) for m in tc["mu"]] == [(1 << 64) // int(q) for q in jc["q"]]
    assert [int(m) for m in jc["mu"]] == [(1 << 60) // int(q) for q in jc["q"]]


@pytest.mark.parametrize("digits", ["reduced", "above_key_primes"])
def test_keyswitch(consts, inputs, digits):
    """Digit i is a residue mod q_i, not reduced mod the key limb's q_j:
    the second case draws every digit from [max q, 2^30), above every
    key limb's prime."""
    jc, tc = consts
    q = jc["q"].astype(np.int64)
    rng = np.random.default_rng(4)
    poly = (inputs["col"][0, 1] if digits == "reduced"
            else rng.integers(q.max(), 1 << 30, (CFG.k, CFG.n)))
    kb, ka = inputs["keys"][:2]
    jb, ja = J.keyswitch(_j(poly), _j(kb), _j(ka), *_jargs(jc))
    tb, ta = T.keyswitch(torch.from_numpy(poly), torch.from_numpy(kb),
                         torch.from_numpy(ka), tc["tabs"])
    assert _eq(jb, tb) and _eq(ja, ta)
    exp = (poly[:, None] * kb % q[:, None]).sum(0) % q[:, None]
    assert np.array_equal(tb.numpy(), exp)


@pytest.mark.parametrize("op", ["ct_square", "ct_mul", "rotate"])
def test_ciphertext_ops(consts, inputs, op):
    jc, tc = consts
    a, b = inputs["col"][0], inputs["val"][1]
    kb, ka = inputs["keys"][2:]
    if op == "ct_square":
        j = J.ct_square(_j(a), _j(kb), _j(ka), *_jargs(jc))
        t = T.ct_square(torch.from_numpy(a), torch.from_numpy(kb), torch.from_numpy(ka), tc["tabs"])
    elif op == "ct_mul":
        j = J.ct_mul(_j(a), _j(b), _j(kb), _j(ka), *_jargs(jc))
        t = T.ct_mul(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(kb),
                     torch.from_numpy(ka), tc["tabs"])
    else:
        j = J.rotate(_j(a), jnp.asarray(jc["perm"]), _j(kb), _j(ka), *_jargs(jc))
        t = T.rotate(torch.from_numpy(a), tc["perm"], torch.from_numpy(kb),
                     torch.from_numpy(ka), tc["tabs"])
    assert t.shape == (2, CFG.k, CFG.n) and _eq(j, t)


@pytest.fixture(scope="module")
def jax_query(consts, inputs):
    """The JAX package's query_step at 4 blocks in both key-switch modes,
    under a 1 x 1 mesh (its reduce_scatter mode places a constraint)."""
    jc = consts[0]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    out = {}
    with jax.set_mesh(mesh):
        for mode in J.KS_MODE, "reduce_scatter":
            out[mode] = np.asarray(J.query_step(
                _j(inputs["col"]), _j(inputs["val"]), *map(_j, inputs["keys"]),
                *_jargs(jc), jnp.asarray(jc["perm"]), eq_levels=CFG.eq_levels,
                rot_steps=CFG.rot_steps, ks_mode=mode)).astype(np.int64)
    return out


@pytest.mark.parametrize("chunk", [None, 1, 2])
@pytest.mark.parametrize("mode", ["all_gather", "reduce_scatter"])
def test_query_step(consts, inputs, jax_query, mode, chunk):
    tc = consts[1]
    got = T.query_step(torch.from_numpy(inputs["col"]), torch.from_numpy(inputs["val"]),
                       *map(torch.from_numpy, inputs["keys"]), tc["tabs"], tc["perm"],
                       eq_levels=CFG.eq_levels, rot_steps=CFG.rot_steps, ks_mode=mode,
                       chunk=chunk)
    assert np.array_equal(got.numpy(), jax_query[mode])
    assert np.array_equal(jax_query["all_gather"], jax_query["reduce_scatter"])


def test_lanes_take_turns_and_give_the_same_aggregate(consts, inputs, jax_query):
    """Step generators run in turns, one step each (`_interleave`: the
    order every rank issues its lanes' exchanges in), or through
    (`_run`); two lanes of 2 blocks give the JAX package's aggregate."""
    log = []

    def lane(name, steps):
        for i in range(steps):
            log.append((name, i))
            yield
        return name

    assert T._interleave([lane("a", 3), lane("b", 2)]) == ["a", "b"]
    assert log == [("a", 0), ("b", 0), ("a", 1), ("b", 1), ("a", 2)]
    assert T._run(lane("c", 2)) == "c"
    tc = consts[1]
    keys = T.tile_keys(list(map(torch.from_numpy, inputs["keys"])), 2)
    got = T._scan_chunks(torch.from_numpy(inputs["col"]), torch.from_numpy(inputs["val"]), keys,
                         tc["tabs"], tc["perm"], CFG.eq_levels, CFG.rot_steps, 2, lanes=2)
    assert np.array_equal(got.numpy(), jax_query["all_gather"])


def test_tree_fold(consts):
    jc, tc = consts
    q = jc["q"].astype(np.int64)[:, None]
    prod = np.random.default_rng(6).integers(0, q, (8, CFG.k, CFG.n))
    got = T._tree_fold(torch.from_numpy(prod), tc["tabs"])
    assert _eq(J._tree_fold(_j(prod), jnp.asarray(jc["q"])), got)
    assert np.array_equal(got.numpy(), prod.sum(0) % q)


def test_non_power_of_two_sizes_raise(consts, inputs):
    """The reference's halving trees drop a term at such sizes; the port
    refuses them."""
    tc = consts[1]
    three = torch.zeros(3, CFG.k, CFG.n, dtype=torch.int64)
    with pytest.raises(ValueError, match="power of two"):
        T._tree_fold(three, tc["tabs"])
    cts = torch.from_numpy(inputs["col"][:3])
    with pytest.raises(ValueError, match="power of two"):
        T.query_step(cts, cts, *map(torch.from_numpy, inputs["keys"]), tc["tabs"],
                     tc["perm"], eq_levels=1, rot_steps=1)
    cts = torch.from_numpy(inputs["col"][:4])
    with pytest.raises(ValueError, match="ks_mode"):
        T.query_step(cts, cts, *map(torch.from_numpy, inputs["keys"]), tc["tabs"],
                     tc["perm"], eq_levels=1, rot_steps=1, ks_mode="psum")


@pytest.mark.parametrize("shape", sorted(tcfg.SHAPES))
def test_input_specs_and_shardings(shape):
    nb = tcfg.SHAPES[shape]["nblocks"]
    jspecs = J.input_specs(jcfg.CONFIG, nb)
    tspecs = T.input_specs(tcfg.CONFIG, nb)
    assert list(tspecs) == list(jspecs)
    for key, spec in tspecs.items():
        assert spec.device.type == "meta" and spec.dtype == torch.int64
        assert tuple(spec.shape) == tuple(jspecs[key].shape)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jsh = J.shardings(mesh, jcfg.CONFIG, nb)
    tsh = T.shardings(mesh.axis_names, tcfg.CONFIG, nb)
    assert list(tsh) == list(jsh)
    for key, placement in tsh.items():
        assert placement == tuple(jsh[key].spec)
    assert T.shardings(("pod", "data", "model"), tcfg.CONFIG, nb)["cts_col"] == (
        ("pod", "data"), None, "model", None)


@pytest.mark.parametrize("shape", list(LM_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_registry_input_specs(arch, shape):
    assert ARCHS == JARCHS and list(LM_SHAPES) == list(JLM_SHAPES)
    jspecs = jinput_specs(jget_smoke_config(arch), shape)
    tspecs = input_specs(get_smoke_config(arch), shape)
    assert list(tspecs) == list(jspecs)
    for key, spec in tspecs.items():
        if isinstance(spec, torch.Tensor):
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(jspecs[key].shape)
            assert str(spec.dtype).split(".")[-1] == str(jspecs[key].dtype)
        else:
            assert spec == jspecs[key]
