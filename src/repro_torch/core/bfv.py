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
same pointwise kernels over the (2, k, n) payload.  Everything else
(base conversion, digit decomposition, the Galois gather, scalar ops) is
plain tensor code on the context's device.

Tensors are never updated in place once they are part of a ciphertext:
handles are aliased by the engine's mask cache, so ops that rewrite one
component clone first.

Sampling happens host-side with a seeded numpy Generator, in a fixed
order of draws, so equal seeds give equal keys and ciphertexts.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .limbops import LimbOps
from .mathutil import centered, crt_reconstruct
from .noise import NoiseModel
from .params import HEParams

_MESH_MSG = ("mesh-sharded key-switching (kswitch_gathered) arrives with the "
             "port of the sharded execution slice")


@dataclasses.dataclass
class Ciphertext:
    data: torch.Tensor       # (2, k, n) int64, coefficient domain
    noise: float             # analytic log2 |invariant noise|
    params: HEParams

    @property
    def budget(self) -> float:
        return -(self.noise + 1.0)


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
    """
    data: torch.Tensor       # (nblocks, 2, k, n) int64
    noise: "float | np.ndarray"
    params: HEParams
    live: int | None = None

    @property
    def nblocks(self) -> int:
        return self.live if self.live is not None else self.data.shape[0]

    @property
    def nphys(self) -> int:
        return self.data.shape[0]

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
        cqp, cpq = p.conv_q_to_p, p.conv_p_to_q
        self.c_qp = self._conv(cqp)
        self.c_pq = self._conv(cpq)
        self._galois_tabs = {
            g: (torch.from_numpy(tab.src.astype(np.int64)).to(dev),
                _i64(tab.sign, dev))
            for g, tab in p.galois.items()
        }

    def _conv(self, c):
        dev = self.device
        return (_i64(c.a_hat_inv_mod_a, dev), _i64(c.a_hat_mod_b, dev),
                _i64(c.a_mod_b, dev),
                torch.from_numpy(np.asarray(c.a_inv, dtype=np.float64)).to(dev))

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
        (the batched one, when single and batch are mixed)."""
        return a if a.data.ndim >= b.data.ndim else b

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
        per = batch.noise if np.ndim(batch.noise) else None
        return [Ciphertext(batch.data[i],
                           float(per[i]) if per is not None else batch.noise,
                           self.params)
                for i in range(batch.nblocks)]

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
        """Decrypt a Ciphertext -> (n,) or a CiphertextBatch -> (nb, n)."""
        return self._decrypt_impl(ct.data, sk.s_ntt)

    @staticmethod
    def _limb_dot_f64(y, w):
        """sum_i y[..., i, :] * w[i] in float64, accumulated limb by limb
        in index order (a fixed order keeps the rounding reproducible)."""
        acc = y[..., 0, :].to(torch.float64) * w[0]
        for i in range(1, y.shape[-2]):
            acc = acc + y[..., i, :].to(torch.float64) * w[i]
        return acc

    def _decrypt_impl(self, data, s_ntt):
        p = self.params
        q = self.qQ[:, None]
        lq = self.limb_q
        c0, c1 = data[..., 0, :, :], data[..., 1, :, :]
        x = (c0 + lq.intt(lq.mul(lq.ntt(c1), s_ntt))) % q
        hat_inv, _, _, q_inv_f = self.c_qp
        y = x * hat_inv[:, None] % q
        yt = y * p.t
        int_part = torch.sum(yt // q, dim=-2)
        frac = self._limb_dot_f64(yt % q, q_inv_f)
        return (int_part + torch.round(frac).to(torch.int64)) % p.t

    # ------------------------------------------------------- add/sub/neg
    def add(self, a, b):
        out = self._pick(a, b)
        return self._like(out, self.limb_q.add(a.data, b.data),
                          self.noise_model.add(a.noise, b.noise))

    def sub(self, a, b):
        out = self._pick(a, b)
        return self._like(out, self.limb_q.sub(a.data, b.data),
                          self.noise_model.add(a.noise, b.noise))

    def neg(self, a):
        return self._like(a, (-a.data) % self.qQ[:, None], a.noise)

    def add_plain(self, a, m_poly):
        m = self._dev(m_poly)
        data = a.data.clone()
        data[..., 0, :, :] = (data[..., 0, :, :]
                              + self.delta[:, None] * m[None, :]) % self.qQ[:, None]
        return self._like(a, data, self.noise_model.add(a.noise, a.noise))

    def sub_from_plain(self, m_poly, a):
        """Encrypted (m - a)."""
        return self.add_plain(self.neg(a), m_poly)

    # ------------------------------------------------------ plain multiply
    def mul_plain(self, a, m_poly):
        data = self._mul_plain_impl(a.data, self._dev(m_poly))
        return self._like(a, data, self.noise_model.mul_plain(a.noise))

    # ------------------------------------------------------ scalar constants
    def mul_scalar(self, a, c: int):
        """Multiply by the constant polynomial c — no NTT, tight noise growth."""
        c %= self.params.t
        data = (a.data * c) % self.qQ[:, None]
        return self._like(a, data, self.noise_model.mul_scalar(a.noise, c))

    def add_scalar(self, a, c: int):
        """Add the constant c to every slot.

        The batch encoding of the all-c vector is the constant polynomial c,
        so only coefficient 0 of c0 moves (by delta*c per limb)."""
        c %= self.params.t
        data = a.data.clone()
        data[..., 0, :, 0] = (data[..., 0, :, 0] + self.delta * c) % self.qQ
        return self._like(a, data, self.noise_model.add(a.noise, a.noise))

    def sub_from_scalar(self, c: int, a):
        """Encrypted (c - a) for scalar c."""
        return self.add_scalar(self.neg(a), c)

    def _mul_plain_impl(self, data, m):
        lq = self.limb_q
        if m.ndim == 2:
            # per-block plaintexts: m is (nblocks, n) against a
            # (nblocks, 2, k, n) batch (fused broadcast_slot extraction)
            m_ntt = lq.ntt(m[:, None, :] % self.qQ[None, :, None])
        else:
            m_ntt = lq.ntt(m[None, :] % self.qQ[:, None])
        out0 = lq.intt(lq.mul(lq.ntt(data[..., 0, :, :]), m_ntt))
        out1 = lq.intt(lq.mul(lq.ntt(data[..., 1, :, :]), m_ntt))
        return torch.stack([out0, out1], dim=-3)

    # ------------------------------------------------- HPS base conversion
    @classmethod
    def _fbc(cls, x, conv, in_mod, out_mod):
        """Exact fast base conversion of the centered value of x.

        x: (..., ka, n) residues mod in_mod; conv: BaseConv tensors;
        out_mod: (kb,). Products stay < 2^62, exact in int64.  The sum
        over input limbs runs one limb at a time, so the (ka, kb, n)
        term tensor is never held whole.
        """
        hat_inv, hat_mod_b, a_mod_b, a_inv = conv
        y = (x * hat_inv[:, None]) % in_mod[:, None]
        v = torch.round(cls._limb_dot_f64(y, a_inv)).to(torch.int64)
        ob = out_mod[:, None]
        acc = None                                        # (..., kb, n) < ka * b_j
        for i in range(y.shape[-2]):
            term = (y[..., i, None, :] * hat_mod_b[i][:, None]) % ob
            acc = term if acc is None else acc + term
        return (acc - v[..., None, :] * a_mod_b[:, None]) % ob

    # ------------------------------------------------------- ct-ct multiply
    def mul(self, a, b, rlk: KSwitchKey, mesh=None):
        """HPS tensor + relinearization."""
        if mesh is not None:
            raise NotImplementedError(_MESH_MSG)
        data = self._mul_impl(a.data, b.data, rlk.b, rlk.a)
        nz = self.noise_model
        return self._like(self._pick(a, b), data,
                          nz.keyswitch(nz.mul(a.noise, b.noise)))

    def _mul_tensor_impl(self, da, db):
        """Steps 1-4 of the HPS multiply: the degree-2 tensor scaled back
        to base Q, before relinearization."""
        p = self.params
        qQ, qP = self.qQ, self.qP
        lq, lp = self.limb_q, self.limb_p
        a0, a1 = da[..., 0, :, :], da[..., 1, :, :]
        b0, b1 = db[..., 0, :, :], db[..., 1, :, :]
        # 1. lift to Q ∪ P
        aP = (self._fbc(a0, self.c_qp, qQ, qP), self._fbc(a1, self.c_qp, qQ, qP))
        bP = (self._fbc(b0, self.c_qp, qQ, qP), self._fbc(b1, self.c_qp, qQ, qP))
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
            rem_p = self._fbc(rem_q, self.c_qp, qQ, qP)
            r_p = ((ep * p.t - rem_p) % qP[:, None]) * self.qinv_p[:, None] % qP[:, None]
            rs.append(self._fbc(r_p, self.c_pq, qP, qQ))       # 4. back to base Q
        return rs[0], rs[1], rs[2]

    def _mul_impl(self, da, db, rlk_b, rlk_a):
        r0, r1, r2 = self._mul_tensor_impl(da, db)
        # 5. relinearize r2
        ks0, ks1 = self._kswitch_inner(r2, rlk_b, rlk_a)
        q = self.qQ[:, None]
        return torch.stack([(r0 + ks0) % q, (r1 + ks1) % q], dim=-3)

    # --------------------------------------------------------- key switch
    def _kswitch_inner(self, poly, ksk_b, ksk_a):
        """Key-switch `poly` (coeff domain, (..., k, n)): coeff-domain pair."""
        q = self.qQ[:, None]
        qvec = self.qQ
        half = qvec // 2
        lq = self.limb_q
        cent = poly - qvec[:, None] * (poly > half[:, None])       # centered digits
        digits = cent[..., :, None, :] % qvec[None, :, None]       # (..., kd, k, n)
        d_ntt = lq.ntt(digits)
        acc_b = torch.sum(lq.mul(d_ntt, ksk_b), dim=-3) % q
        acc_a = torch.sum(lq.mul(d_ntt, ksk_a), dim=-3) % q
        return lq.intt(acc_b), lq.intt(acc_a)

    def kswitch_gathered(self, poly, ksk: KSwitchKey, mesh):
        """`_kswitch_inner` on a 2-D ("data", "model") mesh."""
        raise NotImplementedError(_MESH_MSG)

    # ------------------------------------------------------------ rotation
    def _apply_galois_impl(self, data, g: int):
        src, sign = self._galois_tabs[g]
        return (sign * data[..., src]) % self.qQ[:, None]

    def apply_galois(self, ct, g: int, gk: KSwitchKey, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_MESH_MSG)
        rot = self._apply_galois_impl(ct.data, g)
        ks0, ks1 = self._kswitch_inner(rot[..., 1, :, :], gk.b, gk.a)
        c0 = (rot[..., 0, :, :] + ks0) % self.qQ[:, None]
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
        after broadcasted single×batch ops and must never enter a sum."""
        nb = batch.nblocks
        data = torch.sum(batch.data[:nb], dim=0) % self.qQ[:, None]
        per = batch.noise if np.ndim(batch.noise) else None
        noise = float(per[0]) if per is not None else batch.noise
        for i in range(1, nb):
            noise = self.noise_model.add(
                noise, float(per[i]) if per is not None else batch.noise)
        return Ciphertext(data, noise, self.params)

    # ------------------------------------------------------- noise measure
    def noise_budget_exact(self, ct: Ciphertext, sk: SecretKey) -> float:
        """Exact invariant-noise budget in bits (host-side bigint; tests)."""
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
