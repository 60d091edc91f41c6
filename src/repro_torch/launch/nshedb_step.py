"""The paper's encrypted-scan step (its workload on the mesh) on torch
tensors.

query_step(cts_col, cts_val, ...):  for every ciphertext block — a packed
table segment in the NTT (evaluation) domain — evaluate

  mask  = EQ(column, const)  : eq_levels pointwise squarings, each
                               followed by an RNS key-switch
  out   = mask * values      : one more multiply + key-switch
  aggregate                  : rotate-reduce (rot_steps Galois hops, each
                               another key-switch), then a modular sum
                               over blocks

Every Barrett product goes to the `mul_mod` kernel and every modular sum
to `add_mod` (kernels/modops) when the tensors lie on the card; on CPU
tensors their plain versions run.  The Galois permutation is tensor
indexing.  No NTT runs here: the step works in the evaluation domain.

Layout.  A ciphertext is (2, ..., k, n) int64: component first, then any
block axes.  A key is (k_digit, k_limb, n).  A key switch expands its
polynomial to digit-major rows (k_digit, ..., k_limb, n): flattened, row
r has limb r % k, which is how the modops kernel indexes its tables, so a
one-block key (k, k, n) is a trailing part of the product and is read
without a copy.  `query_step` runs `chunk` blocks at a time and tiles
the keys once to (k, chunk, k, n) for them (`tile_keys`), so each digit
product reads its key as it is and the digit fold halves the leading
axis — contiguous halves, one add_mod launch a round for the chunk.

Sizes.  The digit count and the block count must be powers of two: the
halving trees raise ValueError on any other (the JAX package's trees
drop a term there).

Placement (`input_specs`, `shardings`): blocks over ("pod", "data"),
limbs over "model", keys on their output-limb axis.  `query_step` runs
on one device; `query_step_sharded` is the same step on a device mesh,
each rank holding only its shard (`shard_inputs`):

  blocks    its (blocks / (pod * data)) blocks, limbs [lo, lo + k/M) of
            its "model" index, computed with those limbs' tables
            (kernels/tables.slice_limbs);
  keys      placed as `ks_mode` needs them (`step_shardings`): in
            "all_gather" mode the digit axis whole and the output limbs
            over "model" (the JAX package's placement); in
            "reduce_scatter" mode the digit axis over "model" and the
            output limbs whole — the same bytes, another slice.  The JAX
            package places the keys one way and lets its compiler move
            them; the port places them as the mode reads them;
  key switch (`keyswitch_sharded`) "all_gather": the rank's digits are
            all-gathered along "model" (every output limb needs every
            digit), one (B, k, n) gather for both keys, sent as int32
            (residues lie below q_j < 2^31) and widened back, then
            multiplied by the key's output-limb slice and tree-folded;
            "reduce_scatter": the rank's own digits times all k output
            limbs, tree-folded locally, then reduce-scattered along
            "model" to its limbs and brought below q_j;
  lanes     a rank's chunk runs as two lanes of half its blocks in
            turns: the step's operations are generators that yield where
            a key switch has issued its exchange (`_interleave`), so one
            lane's exchange crosses the link while the other computes;
  aggregate the halving tree over its blocks, then a sum over "pod" and
            "data" (`core/collectives.sum_axis`) and mod q: the (2, k/M,
            n) result stays sharded over "model".

The Galois permutation and the EQ chain are block- and limb-local.  The
dry-run (launch/dryrun.py) runs `query_step_sharded` for rank 0 of the
production mesh on meta tensors.

The mesh scan loop (`serve_mesh_scan`) serves queries on a ("data",
"model") mesh of one host's cards, one rank a card (launch/ranks.py):
each rank holds only its shard (`MeshScan`); a query is its constant v,
sent by rank 0 to every rank, and its answer the (2, k, n) aggregate
that rank 0 holds once gathered along "model" and its card synchronized.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..configs.nshedb import NshedbConfig
from ..core.collectives import (axis_index, collective_record, gather_axis, mesh_axes,
                                reduce_scatter_axis, sum_axis)
from ..core.mathutil import find_ntt_primes
from ..core.params import _make_ntt_tables
from ..kernels.modops.ops import add_mod, mul_mod, sub_mod
from ..kernels.tables import LimbTables, limb_tables, slice_limbs
from ..runtime import tracing
from .mesh import make_query_mesh
from .ranks import TIMEOUT_S, RankGroup, resolve

KS_MODES = ("all_gather", "reduce_scatter")
KS_MODE = "all_gather"
BLOCK_AXES = ("pod", "data")


def make_constants(cfg: NshedbConfig, device="cuda") -> dict:
    """RNS primes, Barrett constants and a Galois permutation table, on
    `device`, plus the base's `LimbTables` (`tabs`) the kernels read.

    `q` and `perm` equal the JAX package's.  `mu` is the port's Barrett
    constant floor(2^64 / q) (kernels/u32.barrett_precompute), where the
    JAX package's is floor(2^60 / q) as uint32; both give exact
    products."""
    primes = find_ntt_primes(cfg.n, 30, cfg.k)
    tabs = limb_tables(_make_ntt_tables(primes, cfg.n), device)
    rng = np.random.default_rng(0)
    perm = rng.permutation(cfg.n).astype(np.int64)    # stand-in Galois map
    return {"q": tabs.q, "mu": tabs.mu64,
            "perm": torch.from_numpy(perm).to(tabs.device), "tabs": tabs}


def _check_pow2(what: str, count: int) -> None:
    if count < 1 or count & (count - 1):
        raise ValueError(f"{what} must be a power of two, got {count}")


def _tree_fold(prod, tabs: LimbTables):
    """Halving-tree modular sum over the leading (digit) axis: log2 k
    rounds of add_mod over the two contiguous halves."""
    kd = prod.shape[0]
    _check_pow2("the digit count", kd)
    while kd > 1:
        half = kd // 2
        prod = add_mod(prod[:half], prod[half:kd], tabs)
        kd = half
    return prod[0]


def tile_keys(keys, blocks: int) -> list:
    """Each (k, k, n) key as (k, blocks, k, n): the layout of a
    `blocks`-block key switch's digit products, made once per query."""
    return [kk[:, None].expand(kk.shape[0], blocks, *kk.shape[1:]).contiguous()
            for kk in keys]


def keyswitch(poly, ksk_b, ksk_a, tabs: LimbTables):
    """RNS key-switch of `poly` (..., k, n): digit-major gadget product.

    Digit i (the residue of limb i, not reduced mod the output limb's
    prime) times key limb j mod q_j, summed over i.  The key is
    (k, k, n), or tiled to (k, *lead, k, n) by `tile_keys`.  On a mesh
    the digits and the output limbs (`tabs.k` of them) may be different
    slices of the base: (kd, kj, n) keys for kd digits."""
    k = poly.shape[-2]
    lead = poly.shape[:-2]
    digits = poly.movedim(-2, 0).unsqueeze(-2).expand(k, *lead, tabs.k, poly.shape[-1])
    out = []
    for ksk in (ksk_b, ksk_a):
        if ksk.dim() != digits.dim():
            ksk = ksk.view(ksk.shape[0], *([1] * len(lead)), *ksk.shape[1:])
        out.append(_tree_fold(mul_mod(digits, ksk, tabs), tabs))
    return out[0], out[1]


def _now(ks):
    """A plain key switch as a step's key switch: a generator that waits
    on nothing (see `_run`)."""
    def steps(poly, ksk_b, ksk_a, tabs):
        yield from ()
        return ks(poly, ksk_b, ksk_a, tabs)
    return steps


def _run(steps):
    """The value of a step generator, run through: each `yield` is a
    point where it has issued an exchange, here waited for at once."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def _interleave(lanes: list) -> list:
    """The values of step generators run in turns, one step each, in a
    fixed order: while one lane's exchange crosses the link, the next
    lane's compute is issued.  Every rank issues the lanes' exchanges in
    the same order."""
    out, live = [None] * len(lanes), list(range(len(lanes)))
    while live:
        for i in list(live):
            try:
                next(lanes[i])
            except StopIteration as done:
                out[i] = done.value
                live.remove(i)
    return out


def _square(ct, rlk_b, rlk_a, tabs, ks):
    c0, c1 = ct[0], ct[1]
    d0 = mul_mod(c0, c0, tabs)
    d1 = mul_mod(c0, c1, tabs)
    d1 = add_mod(d1, d1, tabs)
    d2 = mul_mod(c1, c1, tabs)
    ks0, ks1 = yield from ks(d2, rlk_b, rlk_a, tabs)
    return torch.stack([add_mod(d0, ks0, tabs), add_mod(d1, ks1, tabs)])


def _mul(ct_a, ct_b, rlk_b, rlk_a, tabs, ks):
    a0, a1 = ct_a[0], ct_a[1]
    b0, b1 = ct_b[0], ct_b[1]
    d0 = mul_mod(a0, b0, tabs)
    d1 = add_mod(mul_mod(a0, b1, tabs), mul_mod(a1, b0, tabs), tabs)
    d2 = mul_mod(a1, b1, tabs)
    ks0, ks1 = yield from ks(d2, rlk_b, rlk_a, tabs)
    return torch.stack([add_mod(d0, ks0, tabs), add_mod(d1, ks1, tabs)])


def _rotate(ct, perm, gk_b, gk_a, tabs, ks):
    rot = ct[..., perm]
    ks0, ks1 = yield from ks(rot[1], gk_b, gk_a, tabs)
    return torch.stack([add_mod(rot[0], ks0, tabs), ks1])


def ct_square(ct, rlk_b, rlk_a, tabs: LimbTables):
    """Evaluation-domain ciphertext squaring + relinearization.
    ct: (2, ..., k, n)."""
    return _run(_square(ct, rlk_b, rlk_a, tabs, _now(keyswitch)))


def ct_mul(ct_a, ct_b, rlk_b, rlk_a, tabs: LimbTables):
    return _run(_mul(ct_a, ct_b, rlk_b, rlk_a, tabs, _now(keyswitch)))


def rotate(ct, perm, gk_b, gk_a, tabs: LimbTables):
    """Galois rotation: coefficient permutation + key switch."""
    return _run(_rotate(ct, perm, gk_b, gk_a, tabs, _now(keyswitch)))


def _scan_blocks(col, val, keys, tabs, perm, eq_levels, rot_steps, ks):
    """One chunk's steps: col/val (2, B, k, n); keys tiled for B blocks;
    `ks` a key switch's steps (`_now(keyswitch)`, or a rank's part of it
    on a mesh, `_keyswitch_sharded`)."""
    rlk_b, rlk_a, gk_b, gk_a = keys
    mask = col
    for _ in range(eq_levels):
        mask = yield from _square(mask, rlk_b, rlk_a, tabs, ks)
    out = yield from _mul(mask, val, rlk_b, rlk_a, tabs, ks)
    for _ in range(rot_steps):
        out = add_mod(out, (yield from _rotate(out, perm, gk_b, gk_a, tabs, ks)), tabs)
    return out


def _scan_chunks(cts_col, cts_val, keys, tabs, perm, eq_levels, rot_steps, chunk,
                 ks=None, lanes: int = 1):
    """Every block through `_scan_blocks`, `chunk` at a time and `lanes`
    chunks at once (`_interleave`), then the binary-tree modular block
    aggregation: log2(nblocks) halving rounds.  `ks` is the key switch's
    steps (`_now(keyswitch)` when None).  `keys` is consumed (the tiled
    keys go before the aggregation)."""
    ks = ks or _now(keyswitch)
    nb = cts_col.shape[0]
    outs = []
    for i in range(0, nb, chunk * lanes):
        steps = []
        for j in range(i, min(i + chunk * lanes, nb), chunk):
            col = cts_col[j:j + chunk].transpose(0, 1).contiguous()
            val = cts_val[j:j + chunk].transpose(0, 1).contiguous()
            steps.append(_scan_blocks(col, val, keys, tabs, perm, eq_levels, rot_steps, ks))
        outs += [out.transpose(0, 1) for out in _interleave(steps)]
    keys.clear()
    outs = torch.cat(outs)
    while nb > 1:
        half = nb // 2
        outs = add_mod(outs[:half], outs[half:nb], tabs)
        nb = half
    return outs[0]


def _check_chunk(chunk: int, nb: int) -> None:
    _check_pow2("chunk", chunk)
    if chunk > nb:
        raise ValueError(f"chunk {chunk} exceeds nblocks {nb}")


def _mode(ks_mode):
    mode = ks_mode or KS_MODE
    if mode not in KS_MODES:
        raise ValueError(f"ks_mode {ks_mode!r} is not one of {KS_MODES}")
    return mode


def default_chunk(cts, k: int) -> int:
    """Blocks per pass: all of them on the CPU; on the card the largest
    power of two whose working set fits in half the free device memory.
    A block's working set is the four tiled keys and about four
    digit-product buffers, 8 x (k, kl, n) int64 for the kl limbs `cts`
    holds ((B, 2, kl, n)): kl = k on one device; on a mesh of M "model"
    ranks kl = k / M in both key-switch modes ("all_gather": k digits by
    k / M output limbs; "reduce_scatter": k / M digits by k, and its
    (2, k, n) partial a block beside them).  A rank of a mesh counts its
    own card's free memory (`rank_chunk`)."""
    nb = cts.shape[0]
    if not cts.is_cuda:
        return nb
    free, _ = torch.cuda.mem_get_info(cts.device)
    per_block = 8 * k * cts.shape[-2] * cts.shape[-1] * cts.element_size()
    fit = max(1, free // 2 // per_block)
    return min(nb, 1 << (fit.bit_length() - 1))


def _shares(card: str) -> bool:
    """Whether another rank of the default process group names the same
    card: a collective, which every rank calls at once."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return False
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, card)
    return cards.count(card) > 1


def rank_chunk(cts, k: int) -> int:
    """`default_chunk` for a rank of a mesh, which every rank of the
    process group calls at once.  Ranks that share a card would each
    count its free memory whole, so a card that another rank also holds
    is refused: such ranks pass `chunk`."""
    if cts.is_cuda and _shares(str(torch.cuda.get_device_properties(cts.device).uuid)):
        raise ValueError("another rank shares this card: pass query_step_sharded a chunk")
    return default_chunk(cts, k)


def query_step(cts_col, cts_val, rlk_b, rlk_a, gk_b, gk_a, tabs: LimbTables, perm,
               *, eq_levels: int, rot_steps: int, ks_mode: str = None,
               chunk: int | None = None):
    """cts_col/cts_val: (nblocks, 2, k, n) int64 residues — EQ-mask the
    column, multiply the values, rotate-reduce, then sum across blocks.
    Returns the (2, k, n) aggregate.  `chunk` blocks (a power of two;
    `default_chunk` when None) run through each pass.

    `ks_mode` (`KS_MODE` when None) is one of `KS_MODES`.  On one device
    both modes compute the same products in the same order (they differ
    only in what crosses a mesh: `query_step_sharded`)."""
    _mode(ks_mode)
    nb, k = cts_col.shape[0], cts_col.shape[-2]
    _check_pow2("nblocks", nb)
    chunk = chunk or default_chunk(cts_col, k)
    _check_chunk(chunk, nb)
    keys = tile_keys((rlk_b, rlk_a, gk_b, gk_a), chunk)
    return _scan_chunks(cts_col, cts_val, keys, tabs, perm, eq_levels, rot_steps, chunk)


# ------------------------------------------------------------- on a mesh
def _local_tables(tabs: LimbTables, mesh) -> LimbTables:
    """The tables of this rank's limbs: the base's k over "model"."""
    size = mesh_axes(mesh).get("model", 1)
    if tabs.k % size:
        raise ValueError(f"k={tabs.k} limbs do not split over a model axis of {size}")
    kl = tabs.k // size
    lo = axis_index(mesh, "model") * kl
    return slice_limbs(tabs, lo, lo + kl)


def _keyswitch_sharded(tabs: LimbTables, mesh, mode: str):
    """A rank's part of `keyswitch` on a mesh as steps (`_scan_blocks`'
    `ks`): each yields once, after issuing its exchange, which it waits
    for when resumed; with no "model" axis, plain `keyswitch`."""
    local = _local_tables(tabs, mesh)
    if mesh_axes(mesh).get("model", 1) == 1:
        return _now(lambda poly, kb, ka, _tabs: keyswitch(poly, kb, ka, local))

    def steps(poly, ksk_b, ksk_a, _tabs):
        if mode == "all_gather":
            # residues lie below q_j < 2^31: the digits cross as int32
            pending = gather_axis(poly.to(torch.int32), mesh, "model", dim=-2, async_op=True)
            yield
            return keyswitch(pending.wait().to(torch.int64), ksk_b, ksk_a, local)
        both = torch.stack(keyswitch(poly, ksk_b, ksk_a, tabs))       # (2, ..., k, n)
        # each rank's fold is < q_j < 2^31, so the sum of M of them is below
        # M * 2^31: exact in int64, brought below q_j after the sum
        pending = reduce_scatter_axis(both, mesh, "model", dim=-2, async_op=True)
        yield
        part = pending.wait() % local.q[:, None]
        return part[0], part[1]
    return steps


def keyswitch_sharded(poly, ksk_b, ksk_a, tabs: LimbTables, mesh, ks_mode=None):
    """A rank's part of `keyswitch` on a mesh: `poly` (..., k/M, n) is
    its limbs' residues, `tabs` the whole base's tables; returns its
    output limbs (..., k/M, n) of both products.  The keys are placed
    as `step_shardings` places them for `ks_mode`: (k, [lead], k/M, n)
    in "all_gather" mode, (k/M, [lead], k, n) in "reduce_scatter"."""
    return _run(_keyswitch_sharded(tabs, mesh, _mode(ks_mode))(poly, ksk_b, ksk_a, tabs))


LANES = 2


def query_step_sharded(cts_col, cts_val, rlk_b, rlk_a, gk_b, gk_a, tabs: LimbTables,
                       perm, mesh, *, eq_levels: int, rot_steps: int,
                       ks_mode: str = None, chunk: int | None = None):
    """`query_step` on a mesh with axes among ("pod", "data", "model"):
    this rank's shards of the inputs (`shard_inputs`: cts (B, 2, k/M,
    n), B = nblocks / (pod * data), keys as `ks_mode` places them),
    `tabs` the whole base's tables, `perm` whole.  Returns this rank's
    (2, k/M, n) limbs of the aggregate over every rank's blocks; ranks
    with equal "model" index return equal tensors.

    `chunk` blocks of the rank's B run through each pass (a power of
    two; `rank_chunk` of the rank's card when None, which every rank
    then computes at once), as `LANES` lanes of chunk / `LANES` blocks
    in turns (`_interleave`): a lane's key-switch exchange crosses the
    link while the other lane computes."""
    mode = _mode(ks_mode)
    local = _local_tables(tabs, mesh)
    nb = cts_col.shape[0]
    _check_pow2("blocks per rank", nb)
    if tuple(cts_col.shape[1:]) != (2, local.k, local.n):
        raise ValueError(f"expected this rank's (B, 2, {local.k}, {local.n}) blocks, "
                         f"got {tuple(cts_col.shape)}")
    chunk = chunk or rank_chunk(cts_col, tabs.k)
    _check_chunk(chunk, nb)
    lanes = min(LANES, chunk)
    keys = tile_keys((rlk_b, rlk_a, gk_b, gk_a), chunk // lanes)
    out = _scan_chunks(cts_col, cts_val, keys, local, perm, eq_levels, rot_steps,
                       chunk // lanes, _keyswitch_sharded(tabs, mesh, mode), lanes)
    axes = [a for a in BLOCK_AXES if mesh_axes(mesh).get(a, 1) > 1]
    for axis in axes:
        sum_axis(out, mesh, axis)
    # each rank's aggregate is < q_j < 2^31; their sum over at most
    # 2^32 ranks stays exact in int64
    return out % local.q[:, None] if axes else out


def step_shardings(mesh_dim_names, ks_mode=None) -> dict:
    """`shardings` with the keys placed as `ks_mode` reads them: output
    limbs over "model" ("all_gather", the JAX package's placement) or
    digits over "model" ("reduce_scatter")."""
    place = shardings(mesh_dim_names, None, None)
    if _mode(ks_mode) == "reduce_scatter":
        model = "model" if "model" in tuple(mesh_dim_names) else None
        place.update({key: (model, None, None) for key in ("rlk_b", "rlk_a", "gk_b", "gk_a")})
    return place


def local_shard(t, placement, mesh):
    """This rank's block of `t` under `placement` (one entry per
    dimension: None, an axis name, or a tuple of names, major first),
    copied out contiguous.  A split dimension must divide evenly."""
    sizes = mesh_axes(mesh)
    index = []
    for dim, axes in zip(t.shape, placement):
        names = () if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)
        size, pos = 1, 0
        for name in names:
            size, pos = size * sizes.get(name, 1), pos * sizes.get(name, 1) + axis_index(mesh, name)
        if dim % size:
            raise ValueError(f"a dimension of {dim} does not split over {names} ({size} ranks)")
        index.append(slice(pos * (dim // size), (pos + 1) * (dim // size)))
    return t[tuple(index)].contiguous()


def shard_inputs(inputs: dict, mesh, ks_mode=None) -> dict:
    """This rank's shards of the step's whole inputs (keys of
    `input_specs`; q, mu and perm stay whole), placed by
    `step_shardings`."""
    place = step_shardings(mesh.mesh_dim_names, ks_mode)
    return {key: local_shard(t, place[key], mesh) for key, t in inputs.items()}


def input_specs(cfg: NshedbConfig, nblocks: int) -> dict:
    """Meta tensors (no storage) of the step's inputs, under the JAX
    package's keys and shapes, in the port's int64 residue layout.  In
    the port `q` and `mu` travel inside `make_constants`' `tabs`."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")

    return {
        "cts_col": meta(nblocks, 2, cfg.k, cfg.n), "cts_val": meta(nblocks, 2, cfg.k, cfg.n),
        "rlk_b": meta(cfg.k, cfg.k, cfg.n), "rlk_a": meta(cfg.k, cfg.k, cfg.n),
        "gk_b": meta(cfg.k, cfg.k, cfg.n), "gk_a": meta(cfg.k, cfg.k, cfg.n),
        "q": meta(cfg.k), "mu": meta(cfg.k), "perm": meta(cfg.n),
    }


def shardings(mesh_dim_names, cfg: NshedbConfig, nblocks: int) -> dict:
    """Each input's placement on a mesh with these axis names: one entry
    per dimension, an axis name, a tuple of two, or None (replicated) —
    the JAX package's PartitionSpecs as tuples."""
    names = tuple(mesh_dim_names)
    blocks = tuple(a for a in ("pod", "data") if a in names)
    blocks = blocks[0] if len(blocks) == 1 else blocks or None
    model = "model" if "model" in names else None
    ct = (blocks, None, model, None)
    ksk = (None, model, None)       # digit axis whole, output limb over model
    return {"cts_col": ct, "cts_val": ct,
            "rlk_b": ksk, "rlk_a": ksk, "gk_b": ksk, "gk_a": ksk,
            "q": (None,), "mu": (None,), "perm": (None,)}


# ------------------------------------------------------- the mesh scan loop
SCAN_KEYS = ("rlk_b", "rlk_a", "gk_b", "gk_a")


class MeshScan:
    """One rank's part of the mesh scan loop, built on every rank by
    `serve_mesh_scan`: the ("data", "model") mesh of `data` x `model`
    ranks, the constants of `cfg`, and only this rank's shard of the
    table and the keys, which `shard(self, *shard_args)` (a function
    named "module:attribute") returns as `shard_inputs` places them:
    "cts_col" and "cts_val" (B, 2, k/M, n), the keys by `step_shardings`
    for `ks_mode`.  Blocks per pass: `rank_chunk` of this rank's card,
    sized once, before the first query."""

    def __init__(self, rank: int, world: int, device, cfg: NshedbConfig, data: int,
                 model: int, shard: str, shard_args=(), ks_mode=None):
        if data * model != world:
            raise ValueError(f"a {data} x {model} mesh takes {data * model} ranks, not {world}")
        self.rank, self.device, self.cfg, self.mode = rank, device, cfg, _mode(ks_mode)
        self.mesh = make_query_mesh(data, model, device)
        consts = make_constants(cfg, device=device)
        self.tabs, self.perm = consts["tabs"], consts["perm"]
        self.local = _local_tables(self.tabs, self.mesh)
        held = resolve(shard)(self, *shard_args)
        self.col, self.val = held["cts_col"], held["cts_val"]
        self.keys = [held[key] for key in SCAN_KEYS]
        self.col_v = self.col.clone()            # the column less a query's constant
        self.chunk = rank_chunk(self.col, cfg.k)
        delta = math.prod(self.tabs.q.tolist()) // cfg.t       # Delta = floor(Q / t)
        self.delta = [(delta % p, p) for p in self.local.q.tolist()]

    def query(self, v: int):
        """SUM(val) WHERE col = v: Delta * v taken from the column's first
        component on this rank's limbs (BFV's subtraction of a plaintext
        constant), the step on this rank's shard, its (2, k/M, n) result
        gathered along "model", the card synchronized.  Returns the (2,
        k, n) aggregate on rank 0, None on the others.  A query that
        records (runtime/tracing.py) is a root span "scan_mesh" whose
        attrs carry its collectives' result bytes by kind."""
        with tracing.query("scan_mesh", counts=collective_record):
            # Python ints, reduced below p < 2^31 before they become int64
            c = torch.tensor([d * v % p for d, p in self.delta], dtype=torch.int64)
            c = c.to(self.device).view(-1, 1).expand(self.local.k, self.local.n).contiguous()
            self.col_v[:, 0] = sub_mod(self.col[:, 0], c, self.local)
            agg = query_step_sharded(self.col_v, self.val, *self.keys, self.tabs, self.perm,
                                     self.mesh, eq_levels=self.cfg.eq_levels,
                                     rot_steps=self.cfg.rot_steps, ks_mode=self.mode,
                                     chunk=self.chunk)
            whole = gather_axis(agg, self.mesh, "model", dim=1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return whole if self.rank == 0 else None

    def release(self) -> None:
        """Free this rank's shard."""
        del self.col, self.val, self.keys, self.col_v
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def serve_mesh_scan(cfg: NshedbConfig, data: int, model: int, shard: str, shard_args=(), *,
                    ks_mode=None, device="cuda",
                    timeout_s: float = TIMEOUT_S) -> RankGroup:
    """Start the mesh scan loop: `data` x `model` ranks (`RankGroup`: one
    a card, or gloo ranks when `device` is the CPU), this process rank 0,
    each holding its `MeshScan`.  `group.call("query", v)[0]` is a
    query's aggregate, `group.run(fn, ...)` runs `fn(scan, ...)` on
    every rank, `group.call("release")` frees the shards and
    `group.close()` ends the ranks."""
    return RankGroup(data * model, "repro_torch.launch.nshedb_step:MeshScan",
                     (cfg, data, model, shard, tuple(shard_args), ks_mode),
                     device=device, timeout_s=timeout_s)
