"""Port parity for the BFV scheme: with equal seeds the port's keys,
ciphertext residues after every ported `BFVContext` op and decrypts equal
the JAX package's (reference limb backend) bit for bit, and state carries
across in both directions.  Micro parameters, exact equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import bfv as jbfv
from repro.core.encoder import BatchEncoder as JaxEncoder
from repro.core.params import make_params as jax_make_params
from repro_torch.core import bfv as tbfv
from repro_torch.core.encoder import BatchEncoder
from repro_torch.core.params import make_params

SEED = 5
KW = dict(n=128, t=257, k=12)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(t, j):
    return np.array_equal(_np(t), np.asarray(j))


class Pair:
    """The two contexts after identical call sequences, with their keys
    and two encrypted vectors each."""

    def __init__(self):
        self.tp, self.jp = make_params(**KW), jax_make_params(**KW)
        self.tc = tbfv.BFVContext(self.tp, seed=SEED, device="cpu")
        self.jc = jbfv.BFVContext(self.jp, seed=SEED, backend="ref")
        self.tk, self.jk = self.tc.keygen(), self.jc.keygen()
        self.tenc, self.jenc = BatchEncoder(self.tp), JaxEncoder(self.jp)
        rng = np.random.default_rng(0)
        self.v1 = rng.integers(0, 257, 128)
        self.v2 = rng.integers(0, 257, 128)
        self.t1, self.j1 = self.encrypt(self.v1)
        self.t2, self.j2 = self.encrypt(self.v2)

    def encrypt(self, v):
        return (self.tc.encrypt(self.tenc.encode(v), self.tk.pk),
                self.jc.encrypt(self.jenc.encode(v), self.jk.pk))

    def dec(self, t, j):
        td = self.tc.decrypt(t, self.tk.sk)
        jd = self.jc.decrypt(j, self.jk.sk)
        assert _eq(td, jd)
        return self.tenc.decode(_np(td))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _same_ct(t, j):
    return _eq(t.data, j.data) and np.array_equal(np.asarray(t.noise), np.asarray(j.noise))


def test_defaults_to_cuda():
    import inspect
    for fn in (tbfv.BFVContext.__init__, tbfv.keys_from_numpy, tbfv.ciphertext_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_encoder_matches(pair):
    for v in (pair.v1, np.arange(50)):
        poly = pair.tenc.encode(v)
        assert np.array_equal(poly, np.asarray(pair.jenc.encode(v)))
        assert np.array_equal(pair.tenc.decode(poly), np.asarray(pair.jenc.decode(jnp.asarray(poly))))
        assert np.array_equal(pair.tenc.decode_signed(poly),
                              np.asarray(pair.jenc.decode_signed(jnp.asarray(poly))))
    assert np.array_equal(pair.tenc.basis(3), np.asarray(pair.jenc.basis(3)))
    assert np.array_equal(pair.tenc.constant(9), np.asarray(pair.jenc.constant(9)))


def test_same_seed_same_keys(pair):
    tk, jk = pair.tk, pair.jk
    assert np.array_equal(tk.sk.s, jk.sk.s)
    assert _eq(tk.sk.s_ntt, jk.sk.s_ntt)
    assert _eq(tk.pk.b_ntt, jk.pk.b_ntt) and _eq(tk.pk.a_ntt, jk.pk.a_ntt)
    assert _eq(tk.rlk.b, jk.rlk.b) and _eq(tk.rlk.a, jk.rlk.a)
    assert tk.gks.keys() == jk.gks.keys()
    for g in tk.gks:
        assert _eq(tk.gks[g].b, jk.gks[g].b) and _eq(tk.gks[g].a, jk.gks[g].a), g


def test_encrypt_decrypt(pair):
    assert _same_ct(pair.t1, pair.j1) and _same_ct(pair.t2, pair.j2)
    assert np.array_equal(pair.dec(pair.t1, pair.j1), pair.v1)


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub(pair, op):
    t = getattr(pair.tc, op)(pair.t1, pair.t2)
    j = getattr(pair.jc, op)(pair.j1, pair.j2)
    assert _same_ct(t, j)
    sign = 1 if op == "add" else -1
    assert np.array_equal(pair.dec(t, j), (pair.v1 + sign * pair.v2) % 257)


def test_neg_and_plain_scalar_ops(pair):
    m = pair.tenc.encode(pair.v2)
    for name, targs, jargs in [
            ("neg", (pair.t1,), (pair.j1,)),
            ("add_plain", (pair.t1, m), (pair.j1, jnp.asarray(m))),
            ("sub_from_plain", (m, pair.t1), (jnp.asarray(m), pair.j1)),
            ("mul_scalar", (pair.t1, 200), (pair.j1, 200)),
            ("add_scalar", (pair.t1, 77), (pair.j1, 77)),
            ("sub_from_scalar", (1, pair.t1), (1, pair.j1))]:
        t, j = getattr(pair.tc, name)(*targs), getattr(pair.jc, name)(*jargs)
        assert _same_ct(t, j), name
        pair.dec(t, j)
    # inputs were not touched by the cloning ops
    assert _same_ct(pair.t1, pair.j1)


def test_mul_plain(pair):
    m = pair.tenc.encode(pair.v2)
    t, j = pair.tc.mul_plain(pair.t1, m), pair.jc.mul_plain(pair.j1, jnp.asarray(m))
    assert _same_ct(t, j)
    assert np.array_equal(pair.dec(t, j), pair.v1 * pair.v2 % 257)


def test_mul(pair):
    t = pair.tc.mul(pair.t1, pair.t2, pair.tk.rlk)
    j = pair.jc.mul(pair.j1, pair.j2, pair.jk.rlk)
    assert _same_ct(t, j)
    assert np.array_equal(pair.dec(t, j), pair.v1 * pair.v2 % 257)
    t2, j2 = pair.tc.mul(t, t, pair.tk.rlk), pair.jc.mul(j, j, pair.jk.rlk)
    assert _same_ct(t2, j2)


def test_mul_tensor_and_base_conversion(pair):
    tr = pair.tc._mul_tensor_impl(pair.t1.data, pair.t2.data)
    jr = pair.jc._mul_tensor_impl(pair.j1.data, pair.j2.data)
    for a, b in zip(tr, jr):
        assert _eq(a, b)
    tl = pair.tc._fbc(pair.t1.data[0], pair.tc.c_qp, pair.tc.qQ, pair.tc.qP)
    jl = pair.jc._fbc(pair.j1.data[0], pair.jc.c_qp, pair.jc.qQ, pair.jc.qP)
    assert _eq(tl, jl)
    assert _eq(pair.tc._fbc(tl, pair.tc.c_pq, pair.tc.qP, pair.tc.qQ),
               pair.jc._fbc(jl, pair.jc.c_pq, pair.jc.qP, pair.jc.qQ))


@pytest.mark.parametrize("step", [1, 5, 32])
def test_rotate_rows(pair, step):
    t = pair.tc.rotate_rows(pair.t1, step, pair.tk.gks)
    j = pair.jc.rotate_rows(pair.j1, step, pair.jk.gks)
    assert _same_ct(t, j)
    half = 64
    exp = np.concatenate([np.roll(pair.v1[:half], -step), np.roll(pair.v1[half:], -step)])
    assert np.array_equal(pair.dec(t, j), exp)


def test_swap_rows_and_sum_slots(pair):
    t, j = pair.tc.swap_rows(pair.t1, pair.tk.gks), pair.jc.swap_rows(pair.j1, pair.jk.gks)
    assert _same_ct(t, j)
    t, j = pair.tc.sum_slots(pair.t1, pair.tk.gks), pair.jc.sum_slots(pair.j1, pair.jk.gks)
    assert _same_ct(t, j)
    assert np.array_equal(pair.dec(t, j), np.full(128, pair.v1.sum() % 257))


def test_batched_ops_and_fold_add(pair):
    tb = pair.tc.stack_cts([pair.t1, pair.t2, pair.t1])
    jb = pair.jc.stack_cts([pair.j1, pair.j2, pair.j1])
    assert _same_ct(tb, jb)
    tm, jm = pair.tc.mul(tb, tb, pair.tk.rlk), pair.jc.mul(jb, jb, pair.jk.rlk)
    assert _same_ct(tm, jm)
    assert isinstance(tm, tbfv.CiphertextBatch) and tm.nblocks == 3
    # single x batch broadcasts
    assert _same_ct(pair.tc.mul(pair.t2, tb, pair.tk.rlk),
                    pair.jc.mul(pair.j2, jb, pair.jk.rlk))
    polys = np.stack([pair.tenc.encode(pair.v1), pair.tenc.encode(pair.v2),
                      pair.tenc.basis(0)])
    assert _same_ct(pair.tc.mul_plain(tb, polys), pair.jc.mul_plain(jb, jnp.asarray(polys)))
    tr = pair.tc.rotate_rows(tb, 3, pair.tk.gks)
    jr = pair.jc.rotate_rows(jb, 3, pair.jk.gks)
    assert _same_ct(tr, jr)
    tf, jf = pair.tc.fold_add(tm), pair.jc.fold_add(jm)
    assert _same_ct(tf, jf)
    sq = (2 * pair.v1 * pair.v1 + pair.v2 * pair.v2) % 257
    assert np.array_equal(pair.dec(tf, jf), sq)
    for t, j in zip(pair.tc.unstack_cts(tm), pair.jc.unstack_cts(jm)):
        assert _same_ct(t, j)
    for t, j in zip(pair.tc.mul_many([pair.t1, pair.t2], [pair.t2, pair.t1], pair.tk.rlk),
                    pair.jc.mul_many([pair.j1, pair.j2], [pair.j2, pair.j1], pair.jk.rlk)):
        assert _same_ct(t, j)


def test_fold_add_live_lanes_and_noise_vector(pair):
    noises = np.array([pair.t1.noise, pair.t1.noise + 3.0, pair.t1.noise])
    data = torch.stack([pair.t1.data, pair.t2.data, pair.t1.data, torch.zeros_like(pair.t1.data)])
    tb = tbfv.CiphertextBatch(data, noises, pair.tp, live=3)
    jb = jbfv.CiphertextBatch(jnp.asarray(data.numpy()), noises, pair.jp, live=3)
    assert _same_ct(pair.tc.fold_add(tb), pair.jc.fold_add(jb))
    assert tb.nblocks == 3 and tb.nphys == 4 and tb.budget == jb.budget


def test_noise_budget_exact(pair):
    t = pair.tc.mul(pair.t1, pair.t2, pair.tk.rlk)
    j = pair.jc.mul(pair.j1, pair.j2, pair.jk.rlk)
    assert pair.tc.noise_budget_exact(t, pair.tk.sk) == pair.jc.noise_budget_exact(j, pair.jk.sk)
    assert pair.tc.noise_budget_exact(t, pair.tk.sk) >= t.budget


def _jax_keys_to_numpy(jk):
    pairs = lambda k: (np.asarray(k.b), np.asarray(k.a))
    return dict(s=np.asarray(jk.sk.s), s_ntt=np.asarray(jk.sk.s_ntt),
                pk_b=np.asarray(jk.pk.b_ntt), pk_a=np.asarray(jk.pk.a_ntt),
                rlk=pairs(jk.rlk), gks={g: pairs(k) for g, k in jk.gks.items()})


def test_carry_across_jax_to_port():
    """Keys and a ciphertext made by the JAX package (another seed than
    the port's context) are evaluated and decrypted by the port."""
    tp, jp = make_params(**KW), jax_make_params(**KW)
    jc = jbfv.BFVContext(jp, seed=21, backend="ref")
    jk = jc.keygen()
    jenc = JaxEncoder(jp)
    v = np.arange(128) % 257
    jct = jc.encrypt(jenc.encode(v), jk.pk)
    tc = tbfv.BFVContext(tp, seed=99, device="cpu")
    tk = tbfv.keys_from_numpy(**_jax_keys_to_numpy(jk), device="cpu")
    tct = tbfv.ciphertext_from_numpy(np.asarray(jct.data), jct.noise, tp, device="cpu")
    assert isinstance(tct, tbfv.Ciphertext)
    tsq = tc.mul(tct, tct, tk.rlk)
    jsq = jc.mul(jct, jct, jk.rlk)
    assert _same_ct(tsq, jsq)
    trot = tc.rotate_rows(tsq, 2, tk.gks)
    got = BatchEncoder(tp).decode(_np(tc.decrypt(trot, tk.sk)))
    half = 64
    sq = v * v % 257
    assert np.array_equal(got, np.concatenate([np.roll(sq[:half], -2), np.roll(sq[half:], -2)]))
    batch = tbfv.ciphertext_from_numpy(np.stack([np.asarray(jct.data)] * 2), jct.noise, tp, device="cpu")
    assert isinstance(batch, tbfv.CiphertextBatch) and batch.nblocks == 2
    with pytest.raises(ValueError):
        tbfv.ciphertext_from_numpy(np.zeros((3, 3)), 0.0, tp, device="cpu")


def test_carry_across_port_to_jax():
    """Keys and a ciphertext made by the port are evaluated and decrypted
    by the JAX package."""
    tp, jp = make_params(**KW), jax_make_params(**KW)
    tc = tbfv.BFVContext(tp, seed=33, device="cpu")
    tk = tc.keygen()
    v = (np.arange(128) * 7) % 257
    tct = tc.encrypt(BatchEncoder(tp).encode(v), tk.pk)
    jc = jbfv.BFVContext(jp, seed=1, backend="ref")
    ksk = lambda k: jbfv.KSwitchKey(b=jnp.asarray(_np(k.b)), a=jnp.asarray(_np(k.a)))
    jk = jbfv.Keys(sk=jbfv.SecretKey(s=tk.sk.s, s_ntt=jnp.asarray(_np(tk.sk.s_ntt))),
                   pk=jbfv.PublicKey(b_ntt=jnp.asarray(_np(tk.pk.b_ntt)),
                                     a_ntt=jnp.asarray(_np(tk.pk.a_ntt))),
                   rlk=ksk(tk.rlk), gks={g: ksk(k) for g, k in tk.gks.items()})
    jct = jbfv.Ciphertext(jnp.asarray(_np(tct.data)), tct.noise, jp)
    jsq = jc.mul(jct, jct, jk.rlk)
    assert _same_ct(tc.mul(tct, tct, tk.rlk), jsq)
    got = np.asarray(JaxEncoder(jp).decode(jc.decrypt(jsq, jk.sk)))
    assert np.array_equal(got, v * v % 257)


def test_mesh_paths_wait_for_the_sharded_slice(pair):
    with pytest.raises(NotImplementedError):
        pair.tc.mul(pair.t1, pair.t2, pair.tk.rlk, mesh=object())
    with pytest.raises(NotImplementedError):
        pair.tc.rotate_rows(pair.t1, 1, pair.tk.gks, mesh=object())
    with pytest.raises(NotImplementedError):
        pair.tc.kswitch_gathered(pair.t1.data[1], pair.tk.rlk, object())
