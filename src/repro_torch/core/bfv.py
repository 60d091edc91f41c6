"""RNS-BFV scheme (HPS multiplication variant) on torch tensors.

Layout conventions
------------------
* polynomial:  (k, n) int64, limb-major, coefficients in [0, q_i)
* ciphertext:  (2, k, n) — (c0, c1), coefficient domain
* block batch: (nblocks, 2, k, n) — a whole column of ciphertext blocks
               stacked on a leading axis (`CiphertextBatch`)
* keys:        stored in NTT (evaluation) domain
* key switch:  per-limb RNS gadget (digit i = centered residue mod q_i);
               the gadget matrix g_i mod q_j is exactly the identity, so
               the "encrypt g_i * s'" term touches only limb i.

Batched evaluation path
-----------------------
Every arithmetic impl below is written against trailing (2, k, n) axes
and broadcasts over any leading batch axes, so the same code serves one
ciphertext or a stacked column of blocks.  The limb-level hot loops —
pointwise RNS mul/add/sub and the forward/inverse NTT — are routed
through `core/limbops.LimbOps`: hand-written CUDA kernels when the
context lives on the card, the plain int64 versions when it was built
with `device="cpu"`.  Both produce bit-identical residues, so decryption
results do not depend on the device.  Ciphertext add and sub are the
same pointwise kernels over the (2, k, n) payload.  The HPS fast base
conversion (`_fbc`) is one kernel launch on the card
(`kernels/baseconv`).  Everything else (digit decomposition, the Galois
gather, scalar ops) is plain tensor code on the context's device.

On a ("data", "model") device mesh (launch/mesh.py) every rank runs the
same program.  A stacked batch the query engine places on the mesh is
held as the reference's `batch_sharding` places it: its lanes over
"data" (`CiphertextBatch.lanes`) and, where k divides over "model", its
RNS limbs over "model" (`CiphertextBatch.limbs`).  Each rank keeps and
computes only its lanes' limbs [lo, hi): every pointwise, NTT and Galois
step runs on them with that slice's moduli and tables.  Each rank holds
every key switch key by its output-limb slice [:, lo:hi] (`KSwitchKey.
limbs`).  A limb-held batch's key switch all-gathers its centred digits
over "model" (rotations) or, in `mul`, the operands' limbs, whose HPS
tensor every "model" peer computes whole; its outputs stay limb-held.
No float64 sum over limbs (`_fbc`'s v, decrypt's frac) ever sees a
partial set of them.  Singletons, `sk`, `pk` and the noise accounting
are whole and the same on every rank; a singleton's key switch slices
its limbs, gathers digits and outputs over "model" (`kswitch_gathered`).
A held batch pairs only with one holding the same lanes and limbs or
with a singleton; lanes and limbs cross ranks only where the engine
gathers or folds them, so every gathered result has the bytes one
device computes.

Tensors are never updated in place once they are part of a ciphertext:
handles are aliased by the engine's mask cache, so ops that rewrite one
component clone first.

Sampling happens host-side with a seeded numpy Generator, in a fixed
order of draws, so equal seeds give equal keys and ciphertexts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.baseconv import ops as conv_ops
from ..kernels.baseconv import ref as conv_ref
from ..kernels.tables import conv_tables
from .collectives import axis_index, gather_axis, mesh_axes
from .limbops import LimbLocalOps, LimbOps, ref_forced
from .mathutil import centered, crt_reconstruct
from .noise import NoiseModel
from .params import HEParams

@dataclasses.dataclass
class Ciphertext:
    data: torch.Tensor       # (2, k, n) int64, coefficient domain
    noise: float             # analytic log2 |invariant noise|
    params: HEParams

    @property
    def budget(self) -> float:
        return -(self.noise + 1.0)


class LaneShard(NamedTuple):
    """The lanes [lo, hi) of a `total`-lane batch that this rank holds,
    and the mesh whose "data" axis splits the batch."""
    lo: int
    hi: int
    total: int
    mesh: object


class LimbShard(NamedTuple):
    """The RNS limbs [lo, hi) of `total` that this rank holds of a batch,
    and the mesh whose "model" axis splits them."""
    lo: int
    hi: int
    total: int
    mesh: object


@dataclasses.dataclass
class CiphertextBatch:
    """A stacked column of ciphertext blocks with one shared op history.

    data is (nblocks, 2, k, n).  Blocks of an encrypted column go through
    identical circuits, so a single analytic noise scalar — the max over
    the stacked blocks — serves the whole batch.  When block noises do
    differ (e.g. after a validity multiply on the last block), `noise`
    is a per-block numpy vector of length `nblocks` instead, which lets
    `_maybe_refresh`/`ensure_levels` refresh only the exhausted lanes
    rather than paying a conservative-max penalty for the whole batch.

    `live` supports sharded execution: when the lane count is padded up
    to a multiple of the shard count with zero blocks, `live` records
    the logical block count.  `nblocks` reports the live count (so
    OpStats/noise accounting stay identical to the unpadded path) while
    `nphys` reports the padded leading axis.

    `lanes` is set when the batch is held sharded over a mesh's "data"
    axis, `limbs` when its RNS limbs are held over the "model" axis:
    `data` then holds only this rank's lanes, and of them its limbs,
    while `nblocks`, `nphys`, `noise` and `params.k` keep describing the
    whole (global) batch, the same on every rank.
    """
    data: torch.Tensor       # (nblocks, 2, k, n) int64; this rank's lanes / limbs if held
    noise: "float | np.ndarray"
    params: HEParams
    live: int | None = None
    lanes: LaneShard | None = None
    limbs: LimbShard | None = None

    @property
    def nblocks(self) -> int:
        return self.live if self.live is not None else self.nphys

    @property
    def nphys(self) -> int:
        return self.data.shape[0] if self.lanes is None else self.lanes.total

    @property
    def budget(self) -> float:
        return float(-(np.max(self.noise) + 1.0))


@dataclasses.dataclass
class SecretKey:
    s: np.ndarray            # (n,) ternary
    s_ntt: torch.Tensor      # (k, n)


@dataclasses.dataclass
class PublicKey:
    b_ntt: torch.Tensor      # (k, n)
    a_ntt: torch.Tensor      # (k, n)


@dataclasses.dataclass
class KSwitchKey:
    b: torch.Tensor          # (k, k, n) NTT domain, digit-major
    a: torch.Tensor          # (k, k, n)
    # (lo, hi) when this rank holds only the output limbs [lo, hi) of the
    # key, (k, hi - lo, n) (engine/sharded.place_keys); None when whole
    limbs: tuple[int, int] | None = None


@dataclasses.dataclass
class Keys:
    sk: SecretKey
    pk: PublicKey
    rlk: KSwitchKey
    gks: dict[int, KSwitchKey]   # galois element -> key


def _i64(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)


def keys_from_numpy(s, s_ntt, pk_b, pk_a, rlk, gks, device="cuda") -> Keys:
    """Build `Keys` from numpy int64 arrays (state carried across from
    another implementation of the same scheme).  `rlk` is a (b, a) pair
    of (k, k, n) arrays; `gks` maps a Galois element to such a pair."""
    def ksk(pair):
        return KSwitchKey(b=_i64(pair[0], device), a=_i64(pair[1], device))

    return Keys(sk=SecretKey(s=np.asarray(s, dtype=np.int64),
                             s_ntt=_i64(s_ntt, device)),
                pk=PublicKey(b_ntt=_i64(pk_b, device), a_ntt=_i64(pk_a, device)),
                rlk=ksk(rlk),
                gks={int(g): ksk(pair) for g, pair in gks.items()})


def ciphertext_from_numpy(data, noise, params: HEParams, device="cuda"):
    """Build a `Ciphertext` from a (2, k, n) numpy int64 array, or a
    `CiphertextBatch` from a (nblocks, 2, k, n) one."""
    data = np.asarray(data)
    if data.ndim == 3:
        return Ciphertext(_i64(data, device), float(noise), params)
    if data.ndim == 4:
        return CiphertextBatch(_i64(data, device), noise, params)
    raise ValueError(f"ciphertext data must be (2, k, n) or (nb, 2, k, n), "
                     f"got {data.shape}")


def _lane_text(ct) -> str:
    """What a ciphertext or batch holds, for an error message."""
    lanes = getattr(ct, "lanes", None)
    if lanes is not None:
        return f"lanes [{lanes.lo}, {lanes.hi}) of {lanes.total}"
    return f"a whole batch of {ct.data.shape[0]} lanes" if ct.data.ndim == 4 else "a ciphertext"


def _limb_text(ct) -> str:
    """Which limbs a ciphertext or batch holds, for an error message."""
    limbs = getattr(ct, "limbs", None)
    if limbs is not None:
        return f"limbs [{limbs.lo}, {limbs.hi}) of {limbs.total}"
    return f"every limb of {_lane_text(ct)}"


def _held(ct, axis: str):
    """The `LaneShard` / `LimbShard` of a batch held over a mesh axis
    ("lanes" or "limbs"), None for a ciphertext or a whole batch."""
    return getattr(ct, axis, None)


def _singleton(ct) -> bool:
    """A ciphertext, or a whole batch of one lane: it broadcasts."""
    return (_held(ct, "lanes") is None and _held(ct, "limbs") is None
            and (ct.data.ndim == 3 or ct.data.shape[0] == 1))


def model_limbs(mesh, k: int) -> tuple[int, int] | None:
    """This rank's limbs [lo, hi) of k on the mesh's "model" axis, or
    None where a rank holds every limb: a "model" axis of one rank or
    none, or a rank outside the mesh.  Raises when k does not split."""
    M = mesh_axes(mesh).get("model", 1)
    if M == 1 or mesh.get_coordinate() is None:
        return None
    if k % M:
        raise ValueError(f"k={k} limbs do not split over a model axis of {M}")
    lo = axis_index(mesh, "model") * (k // M)
    return lo, lo + k // M


def _whole(batch: CiphertextBatch, what: str) -> None:
    """Raise if `batch` is held sharded: `what` needs every lane and limb."""
    if batch.lanes is not None:
        raise ValueError(f"{what} needs the whole batch, but this rank holds "
                         f"{_lane_text(batch)}: gather them first (BFVContext.gather_lanes)")
    _all_limbs(batch, what)


def _all_limbs(ct, what: str) -> None:
    """Raise if `ct` is held over "model": `what` needs every limb."""
    if _held(ct, "limbs") is not None:
        raise ValueError(f"{what} needs every limb, but this rank holds {_limb_text(ct)}: "
                         f"gather them first (BFVContext.gather_limbs)")


class BFVContext:
    """Binds a parameter set to a device; owns the scheme's primitives.

    `device` selects where ciphertexts and keys live and with it the
    limb-level execution path (see module docstring); all ciphertext ops
    accept `Ciphertext` and `CiphertextBatch` interchangeably and
    preserve the input type.
    """

    def __init__(self, params: HEParams, seed: int = 0, device="cuda"):
        self.params = params
        self.noise_model = NoiseModel(params)
        self.rng = np.random.default_rng(seed)
        p = params
        self.limb_q = LimbOps(p.Q, device=device)
        self.limb_p = LimbOps(p.P, device=device)
        self.device = dev = self.limb_q.device
        self.qQ = self.limb_q.q
        self.qP = self.limb_p.q
        self.delta = _i64(p.delta_mod_q, dev)            # (k,)
        self.qinv_p = _i64(p.q_inv_mod_p, dev)           # (kp,)
        self.c_qp = conv_tables(p.conv_q_to_p, self.limb_q.tabs, self.limb_p.tabs)
        self.c_pq = conv_tables(p.conv_p_to_q, self.limb_p.tabs, self.limb_q.tabs)
        self._local_ops: dict[tuple[int, int], LimbLocalOps] = {}
        self._galois_tabs = {
            g: (torch.from_numpy(tab.src.astype(np.int64)).to(dev),
                _i64(tab.sign, dev))
            for g, tab in p.galois.items()
        }

    def _dev(self, x) -> torch.Tensor:
        """A numpy array or tensor as an int64 tensor on this device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return _i64(x, self.device)

    # --------------------------------------------------------- type glue
    @staticmethod
    def _like(ref, data, noise):
        """Result wrapper preserving Ciphertext vs CiphertextBatch type."""
        return dataclasses.replace(ref, data=data, noise=noise)

    @staticmethod
    def _pick(a, b):
        """Of two operands, the one whose type the result should take
        (the held or batched one, when single and batch are mixed).  A
        batch held sharded pairs with a batch holding the same lanes and
        limbs, or with a singleton (a ciphertext, or a whole batch of one
        lane), which broadcasts; any other pair raises rather than
        broadcast over the wrong lanes or limbs."""
        for axis, text, what in (("lanes", _lane_text, "sharded"),
                                 ("limbs", _limb_text, 'over "model"')):
            ha, hb = _held(a, axis), _held(b, axis)
            if ha == hb:
                continue
            held, other = (a, b) if ha is not None else (b, a)
            if _held(other, axis) is not None or not _singleton(other):
                raise ValueError(f"a batch held {what} ({text(held)}) pairs only with "
                                 f"the same {axis} or a singleton, not {text(other)}")
        for x, y in ((a, b), (b, a)):
            if (_held(x, "lanes") or _held(x, "limbs")) and _singleton(y):
                return x
        return a if a.data.ndim >= b.data.ndim else b

    def _pair(self, a, b):
        """(result's type, a's data, b's data, ops of the held limbs): a
        singleton paired with a limb-held batch sliced to its limbs."""
        out = self._pick(a, b)
        limbs = _held(out, "limbs")
        da, db = a.data, b.data
        if limbs is not None:
            da = da if _held(a, "limbs") else da[..., limbs.lo:limbs.hi, :]
            db = db if _held(b, "limbs") else db[..., limbs.lo:limbs.hi, :]
        return out, da, db, self._ops(out)

    def _ops(self, ct) -> LimbOps:
        """The primitives of the limbs `ct` holds: the whole base Q, or
        its slice's `LimbLocalOps` for a batch held over "model"."""
        limbs = _held(ct, "limbs")
        return self.limb_q if limbs is None else self._limb_slice(limbs.lo, limbs.hi)

    def _delta(self, ct) -> torch.Tensor:
        """delta mod each prime `ct` holds."""
        limbs = _held(ct, "limbs")
        return self.delta if limbs is None else self.delta[limbs.lo:limbs.hi]

    @staticmethod
    def pack_noises(noises: list) -> "float | np.ndarray":
        """Scalar when uniform (the common case), else a per-block vector."""
        vals = [float(v) for v in noises]
        if all(v == vals[0] for v in vals):
            return vals[0]
        return np.asarray(vals, dtype=np.float64)

    def stack_cts(self, cts: list) -> CiphertextBatch:
        """Stack single-block ciphertexts into one batch (pure layout)."""
        assert cts and all(isinstance(c, Ciphertext) for c in cts)
        return CiphertextBatch(torch.stack([c.data for c in cts]),
                               self.pack_noises([c.noise for c in cts]),
                               self.params)

    def unstack_cts(self, batch: CiphertextBatch) -> list:
        _whole(batch, "unstack")
        per = batch.noise if np.ndim(batch.noise) else None
        return [Ciphertext(batch.data[i],
                           float(per[i]) if per is not None else batch.noise,
                           self.params)
                for i in range(batch.nblocks)]

    @staticmethod
    def gather_lanes(batch: CiphertextBatch) -> CiphertextBatch:
        """A batch held sharded as every lane of it, on every rank (an
        all-gather of the lanes over "data"); any other batch as it is."""
        if batch.lanes is None:
            return batch
        data = gather_axis(batch.data, batch.lanes.mesh, "data", dim=0)
        return dataclasses.replace(batch, data=data, lanes=None)

    @staticmethod
    def gather_limbs(ct):
        """A batch held over "model" with every limb of its lanes, on every
        rank (an all-gather of the limbs over "model", dim -2); any other
        ciphertext or batch as it is."""
        limbs = _held(ct, "limbs")
        if limbs is None:
            return ct
        data = gather_axis(ct.data, limbs.mesh, "model", dim=-2)
        return dataclasses.replace(ct, data=data, limbs=None)

    @classmethod
    def gather(cls, ct):
        """Every lane and limb of `ct` on every rank: its lanes gathered
        over "data", then their limbs over "model"."""
        if isinstance(ct, CiphertextBatch):
            ct = cls.gather_lanes(ct)
        return cls.gather_limbs(ct)

    # ------------------------------------------------------------- sampling
    def _sample_uniform_ntt(self) -> torch.Tensor:
        p = self.params
        cols = [self.rng.integers(0, q, p.n, dtype=np.int64) for q in p.Q.primes]
        return _i64(np.stack(cols), self.device)

    def _sample_ternary(self) -> np.ndarray:
        return self.rng.integers(-1, 2, self.params.n).astype(np.int64)

    def _sample_err(self) -> np.ndarray:
        e = np.rint(self.rng.normal(0.0, self.params.err_std, self.params.n))
        bound = math.ceil(6 * self.params.err_std)
        return np.clip(e, -bound, bound).astype(np.int64)

    def _reduce_small(self, poly: np.ndarray) -> torch.Tensor:
        """(n,) small centered ints -> (k, n) residues."""
        return _i64(poly[None, :] % np.asarray(self.params.Q.primes)[:, None],
                    self.device)

    # -------------------------------------------------------------- keygen
    def keygen(self, galois_steps: tuple[int, ...] | None = None) -> Keys:
        p = self.params
        q = self.qQ[:, None]
        ntt = self.limb_q.ntt
        s = self._sample_ternary()
        s_ntt = ntt(self._reduce_small(s))
        a_ntt = self._sample_uniform_ntt()
        e_ntt = ntt(self._reduce_small(self._sample_err()))
        b_ntt = (-(a_ntt * s_ntt % q) - e_ntt) % q
        pk = PublicKey(b_ntt=b_ntt, a_ntt=a_ntt)
        sk = SecretKey(s=s, s_ntt=s_ntt)

        s2_ntt = (s_ntt * s_ntt) % q
        rlk = self._make_kswitch_key(s_ntt, s2_ntt)

        gks: dict[int, KSwitchKey] = {}
        steps = galois_steps if galois_steps is not None else tuple(p.rot_gs)
        gs = [p.rot_gs[st] for st in steps] + [p.rowswap_g]
        for g in gs:
            tab = p.galois[g]
            s_rot = tab.sign * s[tab.src]
            s_rot_ntt = ntt(self._reduce_small(s_rot))
            gks[g] = self._make_kswitch_key(s_ntt, s_rot_ntt)
        return Keys(sk=sk, pk=pk, rlk=rlk, gks=gks)

    def _make_kswitch_key(self, s_ntt, target_ntt) -> KSwitchKey:
        """KSK encrypting gadget(target): digit i carries target on limb i only."""
        q = self.qQ[:, None]
        bs, as_ = [], []
        for i in range(self.params.k):
            a_i = self._sample_uniform_ntt()
            e_i = self.limb_q.ntt(self._reduce_small(self._sample_err()))
            b_i = (-(a_i * s_ntt % q) - e_i) % q       # fresh tensor: safe to edit
            b_i[i] = (b_i[i] + target_ntt[i]) % self.qQ[i]
            bs.append(b_i)
            as_.append(a_i)
        return KSwitchKey(b=torch.stack(bs), a=torch.stack(as_))

    # ------------------------------------------------------------- encrypt
    def encrypt(self, m_poly, pk: PublicKey) -> Ciphertext:
        """m_poly: (n,) int64 mod t (use BatchEncoder to build it)."""
        u = self._reduce_small(self._sample_ternary())
        e0 = self._reduce_small(self._sample_err())
        e1 = self._reduce_small(self._sample_err())
        data = self._encrypt_impl(self._dev(m_poly), u, e0, e1, pk.b_ntt, pk.a_ntt)
        return Ciphertext(data=data, noise=self.noise_model.fresh(), params=self.params)

    def _encrypt_impl(self, m, u, e0, e1, pkb, pka):
        q = self.qQ[:, None]
        lq = self.limb_q
        u_ntt = lq.ntt(u)
        c0 = (lq.intt(lq.mul(pkb, u_ntt)) + e0 + self.delta[:, None] * m[None, :]) % q
        c1 = (lq.intt(lq.mul(pka, u_ntt)) + e1) % q
        return torch.stack([c0, c1])

    def encrypt_zero(self, pk: PublicKey) -> Ciphertext:
        return self.encrypt(np.zeros(self.params.n, dtype=np.int64), pk)

    # ------------------------------------------------------------- decrypt
    def decrypt(self, ct, sk: SecretKey) -> torch.Tensor:
        """Decrypt a Ciphertext -> (n,) or a CiphertextBatch -> (nb, n).
        `frac` is a float sum over every limb: a limb-held batch raises."""
        _all_limbs(ct, "decrypt")
        return self._decrypt_impl(ct.data, sk.s_ntt)

    def _decrypt_impl(self, data, s_ntt):
        p = self.params
        q = self.qQ[:, None]
        lq = self.limb_q
        c0, c1 = data[..., 0, :, :], data[..., 1, :, :]
        x = (c0 + lq.intt(lq.mul(lq.ntt(c1), s_ntt))) % q
        y = x * self.c_qp.hat_inv[:, None] % q
        yt = y * p.t
        int_part = torch.sum(yt // q, dim=-2)
        frac = conv_ref.limb_dot_f64(yt % q, self.c_qp.a_inv)
        return (int_part + torch.round(frac).to(torch.int64)) % p.t

    # ------------------------------------------------------- add/sub/neg
    def add(self, a, b):
        out, da, db, ops = self._pair(a, b)
        return self._like(out, ops.add(da, db), self.noise_model.add(a.noise, b.noise))

    def sub(self, a, b):
        out, da, db, ops = self._pair(a, b)
        return self._like(out, ops.sub(da, db), self.noise_model.add(a.noise, b.noise))

    def neg(self, a):
        return self._like(a, (-a.data) % self._ops(a).q[:, None], a.noise)

    def add_plain(self, a, m_poly):
        m = self._dev(m_poly)
        q = self._ops(a).q[:, None]
        data = a.data.clone()
        data[..., 0, :, :] = (data[..., 0, :, :] + self._delta(a)[:, None] * m[None, :]) % q
        return self._like(a, data, self.noise_model.add(a.noise, a.noise))

    def sub_from_plain(self, m_poly, a):
        """Encrypted (m - a)."""
        return self.add_plain(self.neg(a), m_poly)

    # ------------------------------------------------------ plain multiply
    def mul_plain(self, a, m_poly):
        data = self._mul_plain_impl(a.data, self._dev(m_poly), self._ops(a))
        return self._like(a, data, self.noise_model.mul_plain(a.noise))

    # ------------------------------------------------------ scalar constants
    def mul_scalar(self, a, c: int):
        """Multiply by the constant polynomial c — no NTT, tight noise growth."""
        c %= self.params.t
        data = (a.data * c) % self._ops(a).q[:, None]
        return self._like(a, data, self.noise_model.mul_scalar(a.noise, c))

    def add_scalar(self, a, c: int):
        """Add the constant c to every slot.

        The batch encoding of the all-c vector is the constant polynomial c,
        so only coefficient 0 of c0 moves (by delta*c per limb)."""
        c %= self.params.t
        data = a.data.clone()
        data[..., 0, :, 0] = (data[..., 0, :, 0] + self._delta(a) * c) % self._ops(a).q
        return self._like(a, data, self.noise_model.add(a.noise, a.noise))

    def sub_from_scalar(self, c: int, a):
        """Encrypted (c - a) for scalar c."""
        return self.add_scalar(self.neg(a), c)

    def _mul_plain_impl(self, data, m, lq: LimbOps | None = None):
        """The plaintext `m` reduced mod the primes of `lq` (the whole
        base by default), times `data`, which holds those limbs."""
        lq = lq or self.limb_q
        if m.ndim == 2:
            # per-block plaintexts: m is (nblocks, n) against a
            # (nblocks, 2, k, n) batch (fused broadcast_slot extraction)
            m_ntt = lq.ntt(m[:, None, :] % lq.q[None, :, None])
        else:
            m_ntt = lq.ntt(m[None, :] % lq.q[:, None])
        out0 = lq.intt(lq.mul(lq.ntt(data[..., 0, :, :]), m_ntt))
        out1 = lq.intt(lq.mul(lq.ntt(data[..., 1, :, :]), m_ntt))
        return torch.stack([out0, out1], dim=-3)

    # ------------------------------------------------- HPS base conversion
    @staticmethod
    def _fbc(x, conv):
        """Exact fast base conversion of the centered value of x: (..., ka,
        n) residues in [0, a_i) of conv's input base (`c_qp` or `c_pq`) ->
        (..., kb, n) of its output base.  One kernel launch for a CUDA
        tensor, the plain version for a CPU one or under `force_ref()`."""
        if ref_forced():
            return conv_ref.base_conv_ref(x, conv)
        return conv_ops.base_conv(x, conv)

    # ------------------------------------------------------- ct-ct multiply
    def mul(self, a, b, rlk: KSwitchKey, mesh=None):
        """HPS tensor + relinearization.  With a 2-D query mesh the relin
        key-switch of a singleton all-gathers its decomposition digits
        over the mesh "model" axis (`kswitch_gathered`) — the same bytes,
        a different collective structure.  A batch held over "model"
        all-gathers its operands' limbs there (once when `a is b`), runs
        the tensor whole — `_fbc`'s float sums see every limb — and keeps
        its own limbs of the result; `r2` is whole, so its key switch
        gathers nothing."""
        out = self._pick(a, b)
        limbs = _held(out, "limbs")
        if limbs is not None:
            da = self.gather_limbs(a).data
            db = da if b is a else self.gather_limbs(b).data
            r0, r1, r2 = self._mul_tensor_impl(da, db)
            lo, hi = limbs.lo, limbs.hi
            ks0, ks1 = self._ks_digits(self._centred(r2, self.qQ), self._key_limbs(rlk, lo, hi),
                                       lo, hi)
            q = self._ops(out).q[:, None]
            data = torch.stack([(r0[..., lo:hi, :] + ks0) % q, (r1[..., lo:hi, :] + ks1) % q],
                               dim=-3)
        elif mesh is None:
            data = self._mul_impl(a.data, b.data, rlk.b, rlk.a)
        else:
            r0, r1, r2 = self._mul_tensor_impl(a.data, b.data)
            ks0, ks1 = self.kswitch_gathered(r2, rlk, mesh)
            q = self.qQ[:, None]
            data = torch.stack([(r0 + ks0) % q, (r1 + ks1) % q], dim=-3)
        nz = self.noise_model
        return self._like(out, data, nz.keyswitch(nz.mul(a.noise, b.noise)))

    def _mul_tensor_impl(self, da, db):
        """Steps 1-4 of the HPS multiply: the degree-2 tensor scaled back
        to base Q, before relinearization."""
        p = self.params
        qQ, qP = self.qQ, self.qP
        lq, lp = self.limb_q, self.limb_p
        a0, a1 = da[..., 0, :, :], da[..., 1, :, :]
        b0, b1 = db[..., 0, :, :], db[..., 1, :, :]
        # 1. lift to Q ∪ P
        aP = (self._fbc(a0, self.c_qp), self._fbc(a1, self.c_qp))
        bP = (self._fbc(b0, self.c_qp), self._fbc(b1, self.c_qp))
        # 2. NTT + tensor in both bases
        fa = [lq.ntt(a0), lq.ntt(a1)]
        fb = [lq.ntt(b0), lq.ntt(b1)]
        ga = [lp.ntt(aP[0]), lp.ntt(aP[1])]
        gb = [lp.ntt(bP[0]), lp.ntt(bP[1])]
        tq = [
            lq.intt(lq.mul(fa[0], fb[0])),
            lq.intt(lq.add(lq.mul(fa[0], fb[1]), lq.mul(fa[1], fb[0]))),
            lq.intt(lq.mul(fa[1], fb[1])),
        ]
        tp = [
            lp.intt(lp.mul(ga[0], gb[0])),
            lp.intt(lp.add(lp.mul(ga[0], gb[1]), lp.mul(ga[1], gb[0]))),
            lp.intt(lp.mul(gb[1], ga[1])),
        ]
        # 3. scale by t/Q exactly: r = (t*E - [tE]_Q) / Q, computed in base P
        rs = []
        for eq, ep in zip(tq, tp):
            rem_q = (eq * p.t) % qQ[:, None]
            rem_p = self._fbc(rem_q, self.c_qp)
            r_p = ((ep * p.t - rem_p) % qP[:, None]) * self.qinv_p[:, None] % qP[:, None]
            rs.append(self._fbc(r_p, self.c_pq))               # 4. back to base Q
        return rs[0], rs[1], rs[2]

    def _mul_impl(self, da, db, rlk_b, rlk_a):
        r0, r1, r2 = self._mul_tensor_impl(da, db)
        # 5. relinearize r2
        ks0, ks1 = self._kswitch_inner(r2, rlk_b, rlk_a)
        q = self.qQ[:, None]
        return torch.stack([(r0 + ks0) % q, (r1 + ks1) % q], dim=-3)

    # --------------------------------------------------------- key switch
    @staticmethod
    def _centred(poly, q):
        """The centred residues of `poly` ((..., len(q), n)) mod `q`."""
        return poly - q[:, None] * (poly > (q // 2)[:, None])

    def _ks_digits(self, cent, keys, lo: int, hi: int):
        """The key switch's output limbs [lo, hi) from every centred digit
        `cent` ((..., k, n)) and the key's (b, a) of those output limbs:
        the digits reduced mod those limbs' primes, NTT'd with their
        tables, times each key, summed over the whole digit axis in order,
        INTT'd."""
        ops = self._limb_slice(lo, hi)
        ql = ops.q
        d_ntt = ops.ntt(cent[..., :, None, :] % ql[None, :, None])    # (..., kd, kL, n)
        return tuple(ops.intt(torch.sum(ops.mul(d_ntt, key), dim=-3) % ql[:, None])
                     for key in keys)

    def _key_limbs(self, ksk: KSwitchKey, lo: int, hi: int):
        """(b, a) of output limbs [lo, hi): a whole key's slice, or a key
        placed with exactly those limbs; a key placed with others raises
        (nothing re-slices it)."""
        if ksk.limbs is None:
            return ksk.b[:, lo:hi], ksk.a[:, lo:hi]
        if tuple(ksk.limbs) != (lo, hi):
            raise ValueError(f"a key held by output limbs [{ksk.limbs[0]}, {ksk.limbs[1]}) "
                             f"cannot key-switch limbs [{lo}, {hi})")
        return ksk.b, ksk.a

    def _kswitch_inner(self, poly, ksk_b, ksk_a):
        """Key-switch `poly` (coeff domain, (..., k, n)): coeff-domain pair.
        The one-device path: a key placed by output-limb slice raises."""
        k = self.params.k
        if ksk_b.shape[-2] != k or ksk_a.shape[-2] != k:
            raise ValueError(f"the one-device key switch needs whole (k, k, n) keys, got "
                             f"{tuple(ksk_b.shape)}: a key held by output-limb slice "
                             f"(engine/sharded.place_keys) runs only on its mesh")
        return self._ks_digits(self._centred(poly, self.qQ), (ksk_b, ksk_a), 0, k)

    def kswitch_gathered(self, poly, ksk: KSwitchKey, mesh):
        """`_kswitch_inner` on a ("data", "model") device mesh, of a
        polynomial every "model" peer holds whole (a singleton's, or the
        lanes of a batch held sharded over "data" only).

        Each rank takes its (kL = k/M)-limb slice of `poly`, centres its
        digits and all-gathers them along "model" — k*n int64 per block,
        the minimal cross-limb payload.  It then reduces the gathered
        digits mod its own primes, NTTs them with its slice's tables,
        multiplies by the key's output-limb slice (KSwitchKey axis 1: a
        whole key's, or a key placed with these limbs), sums over the
        whole digit axis and INTTs; the outputs all-gather back along
        "model".  Exact int64 throughout, so the result is byte-identical
        to the one-device path.  A rank outside the mesh computes that
        path."""
        mesh_axes(mesh)                     # a DeviceMesh, or TypeError
        if mesh.get_coordinate() is None:
            return self._kswitch_inner(poly, ksk.b, ksk.a)
        lo, hi = model_limbs(mesh, self.params.k) or (0, self.params.k)
        limbs = LimbShard(lo, hi, self.params.k, mesh)
        both = gather_axis(torch.stack(self._kswitch_held(poly[..., lo:hi, :], ksk, limbs)),
                           mesh, "model", dim=-2)
        return both[0], both[1]

    def _kswitch_held(self, part, ksk: KSwitchKey, limbs: LimbShard):
        """The key switch of a polynomial held as its limbs `limbs`
        ((..., kL, n)): its centred digits all-gathered over "model",
        then this rank's output limbs, which stay held."""
        cent = self._centred(part, self._limb_slice(limbs.lo, limbs.hi).q)
        whole = gather_axis(cent, limbs.mesh, "model", dim=-2)
        lo, hi = limbs.lo, limbs.hi
        return self._ks_digits(whole, self._key_limbs(ksk, lo, hi), lo, hi)

    def _limb_slice(self, lo: int, hi: int) -> LimbOps:
        """The ops of ciphertext limbs [lo, hi), built once per slice (the
        whole base's for every limb)."""
        if (lo, hi) == (0, self.params.k):
            return self.limb_q
        if (lo, hi) not in self._local_ops:
            self._local_ops[lo, hi] = LimbLocalOps(self.params.Q, lo, hi,
                                                   device=self.device)
        return self._local_ops[lo, hi]

    # ------------------------------------------------------------ rotation
    def _apply_galois_impl(self, data, g: int, q):
        """The Galois permutation of `data`, reduced mod the primes `q` of
        the limbs it holds: limb-local."""
        src, sign = self._galois_tabs[g]
        return (sign * data[..., src]) % q[:, None]

    def apply_galois(self, ct, g: int, gk: KSwitchKey, mesh=None):
        q = self._ops(ct).q
        rot = self._apply_galois_impl(ct.data, g, q)
        limbs = _held(ct, "limbs")
        if limbs is not None:
            ks0, ks1 = self._kswitch_held(rot[..., 1, :, :], gk, limbs)
        elif mesh is None:
            ks0, ks1 = self._kswitch_inner(rot[..., 1, :, :], gk.b, gk.a)
        else:
            ks0, ks1 = self.kswitch_gathered(rot[..., 1, :, :], gk, mesh)
        c0 = (rot[..., 0, :, :] + ks0) % q[:, None]
        return self._like(ct, torch.stack([c0, ks1], dim=-3),
                          self.noise_model.rotate(ct.noise))

    def rotate_rows(self, ct, step: int, gks: dict[int, KSwitchKey],
                    mesh=None):
        """Rotate both rows left by `step` (decomposed into power-of-two hops)."""
        p = self.params
        step %= p.row
        out = ct
        hop = 1
        while step:
            if step & 1:
                g = p.rot_gs[hop]
                out = self.apply_galois(out, g, gks[g], mesh=mesh)
            step >>= 1
            hop <<= 1
        return out

    def swap_rows(self, ct, gks: dict[int, KSwitchKey], mesh=None):
        g = self.params.rowswap_g
        return self.apply_galois(ct, g, gks[g], mesh=mesh)

    # --------------------------------------------------- slot-level helpers
    def sum_slots(self, ct, gks: dict[int, KSwitchKey]):
        """Rotate-and-add tree: every slot ends up holding the full sum.

        log2(n/2) row rotations + 1 row swap (paper §4.2.2 COUNT/SUM).
        """
        out = ct
        step = 1
        while step < self.params.row:
            out = self.add(out, self.rotate_rows(out, step, gks))
            step *= 2
        return self.add(out, self.swap_rows(out, gks))

    # ----------------------------------------------------- batched column API
    def add_many(self, a_cts: list, b_cts: list) -> list:
        """Blockwise a+b over two columns via one stacked call."""
        return self.unstack_cts(self.add(self.stack_cts(a_cts), self.stack_cts(b_cts)))

    def sub_many(self, a_cts: list, b_cts: list) -> list:
        return self.unstack_cts(self.sub(self.stack_cts(a_cts), self.stack_cts(b_cts)))

    def mul_plain_many(self, cts: list, m_poly) -> list:
        """One plaintext polynomial against every block of a column."""
        return self.unstack_cts(self.mul_plain(self.stack_cts(cts), m_poly))

    def mul_many(self, a_cts: list, b_cts: list, rlk: KSwitchKey) -> list:
        """Blockwise ct-ct products (tensor + relin) in one stacked call."""
        return self.unstack_cts(self.mul(self.stack_cts(a_cts), self.stack_cts(b_cts), rlk))

    def rotate_rows_many(self, cts: list, step: int, gks: dict[int, KSwitchKey]) -> list:
        return self.unstack_cts(self.rotate_rows(self.stack_cts(cts), step, gks))

    def sum_slots_many(self, cts: list, gks: dict[int, KSwitchKey]) -> list:
        return self.unstack_cts(self.sum_slots(self.stack_cts(cts), gks))

    def fold_add(self, batch: CiphertextBatch) -> Ciphertext:
        """Sum a batch across its block axis into one ciphertext — the
        cross-block half of an aggregation.  Residues match the
        sequential add chain exactly (mod-q sums commute); the noise
        bound replays the same sequential `add` recurrence.  Only the
        `live` lanes participate: shard padding lanes may hold garbage
        after broadcasted single×batch ops and must never enter a sum.
        A batch held sharded is folded by `engine/sharded.sharded_fold`."""
        _whole(batch, "fold_add")
        data = torch.sum(batch.data[:batch.nblocks], dim=0) % self.qQ[:, None]
        return Ciphertext(data, self.fold_noise(batch), self.params)

    def fold_noise(self, batch: CiphertextBatch) -> float:
        """The noise bound of a batch's fold: the sequential `add`
        recurrence over its live lanes."""
        per = batch.noise if np.ndim(batch.noise) else None
        noise = float(per[0]) if per is not None else batch.noise
        for i in range(1, batch.nblocks):
            noise = self.noise_model.add(
                noise, float(per[i]) if per is not None else batch.noise)
        return noise

    # ------------------------------------------------------- noise measure
    def noise_budget_exact(self, ct: Ciphertext, sk: SecretKey) -> float:
        """Exact invariant-noise budget in bits (host-side bigint; tests);
        a held ciphertext is gathered first."""
        ct = self.gather(ct)
        p = self.params
        q = self.qQ[:, None]
        lq = self.limb_q
        x = ((ct.data[0] + lq.intt(lq.mul(lq.ntt(ct.data[1]), sk.s_ntt))) % q
             ).cpu().numpy()
        m = self._decrypt_impl(ct.data, sk.s_ntt).cpu().numpy()
        Q = p.bigQ()
        tQ = p.t * Q
        worst = 1
        for j in range(p.n):
            X = crt_reconstruct([int(x[i, j]) for i in range(p.k)], list(p.Q.primes))
            w = centered((p.t * X - int(m[j]) * Q) % tQ, tQ)
            worst = max(worst, abs(w))
        return math.log2(Q) - 1.0 - math.log2(worst)
