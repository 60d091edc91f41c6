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
            digit), one (B, k, n) gather for both keys, then multiplied
            by the key's output-limb slice and tree-folded;
            "reduce_scatter": the rank's own digits times all k output
            limbs, tree-folded locally, then reduce-scattered along
            "model" to its limbs and brought below q_j;
  aggregate the halving tree over its blocks, then a sum over "pod" and
            "data" (`core/collectives.sum_axis`) and mod q: the (2, k/M,
            n) result stays sharded over "model".

The Galois permutation and the EQ chain are block- and limb-local.  The
dry-run (launch/dryrun.py) runs `query_step_sharded` for rank 0 of the
production mesh on meta tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.nshedb import NshedbConfig
from ..core.collectives import axis_index, gather_axis, mesh_axes, reduce_scatter_axis, sum_axis
from ..core.mathutil import find_ntt_primes
from ..core.params import _make_ntt_tables
from ..kernels.modops.ops import add_mod, mul_mod
from ..kernels.tables import LimbTables, limb_tables, slice_limbs

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


def ct_square(ct, rlk_b, rlk_a, tabs: LimbTables, ks=keyswitch):
    """Evaluation-domain ciphertext squaring + relinearization.
    ct: (2, ..., k, n).  `ks` is the key switch (`keyswitch`, or a
    rank's part of it on a mesh)."""
    c0, c1 = ct[0], ct[1]
    d0 = mul_mod(c0, c0, tabs)
    d1 = mul_mod(c0, c1, tabs)
    d1 = add_mod(d1, d1, tabs)
    d2 = mul_mod(c1, c1, tabs)
    ks0, ks1 = ks(d2, rlk_b, rlk_a, tabs)
    return torch.stack([add_mod(d0, ks0, tabs), add_mod(d1, ks1, tabs)])


def ct_mul(ct_a, ct_b, rlk_b, rlk_a, tabs: LimbTables, ks=keyswitch):
    a0, a1 = ct_a[0], ct_a[1]
    b0, b1 = ct_b[0], ct_b[1]
    d0 = mul_mod(a0, b0, tabs)
    d1 = add_mod(mul_mod(a0, b1, tabs), mul_mod(a1, b0, tabs), tabs)
    d2 = mul_mod(a1, b1, tabs)
    ks0, ks1 = ks(d2, rlk_b, rlk_a, tabs)
    return torch.stack([add_mod(d0, ks0, tabs), add_mod(d1, ks1, tabs)])


def rotate(ct, perm, gk_b, gk_a, tabs: LimbTables, ks=keyswitch):
    """Galois rotation: coefficient permutation + key switch."""
    rot = ct[..., perm]
    ks0, ks1 = ks(rot[1], gk_b, gk_a, tabs)
    return torch.stack([add_mod(rot[0], ks0, tabs), ks1])


def _scan_blocks(col, val, keys, tabs, perm, eq_levels, rot_steps, ks=keyswitch):
    """One chunk: col/val (2, B, k, n); keys tiled for B blocks."""
    rlk_b, rlk_a, gk_b, gk_a = keys
    mask = col
    for _ in range(eq_levels):
        mask = ct_square(mask, rlk_b, rlk_a, tabs, ks)
    out = ct_mul(mask, val, rlk_b, rlk_a, tabs, ks)
    for _ in range(rot_steps):
        out = add_mod(out, rotate(out, perm, gk_b, gk_a, tabs, ks), tabs)
    return out


def _scan_chunks(cts_col, cts_val, keys, tabs, perm, eq_levels, rot_steps, chunk,
                 ks=keyswitch):
    """Every block through `_scan_blocks`, `chunk` at a time, then the
    binary-tree modular block aggregation: log2(nblocks) halving rounds.
    `keys` is consumed (the tiled keys go before the aggregation)."""
    nb = cts_col.shape[0]
    outs = []
    for i in range(0, nb, chunk):
        col = cts_col[i:i + chunk].transpose(0, 1).contiguous()
        val = cts_val[i:i + chunk].transpose(0, 1).contiguous()
        outs.append(_scan_blocks(col, val, keys, tabs, perm, eq_levels,
                                 rot_steps, ks).transpose(0, 1))
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
    power of two whose working set — the four tiled keys and about four
    digit-product buffers, 8 x (k, k, n) int64 a block — fits in half the
    free device memory."""
    nb = cts.shape[0]
    if not cts.is_cuda:
        return nb
    free, _ = torch.cuda.mem_get_info(cts.device)
    per_block = 8 * k * k * cts.shape[-1] * cts.element_size()
    fit = max(1, free // 2 // per_block)
    return min(nb, 1 << (fit.bit_length() - 1))


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


def keyswitch_sharded(poly, ksk_b, ksk_a, tabs: LimbTables, mesh, ks_mode=None):
    """A rank's part of `keyswitch` on a mesh: `poly` (..., k/M, n) is
    its limbs' residues, `tabs` the whole base's tables; returns its
    output limbs (..., k/M, n) of both products.  The keys are placed
    as `step_shardings` places them for `ks_mode`: (k, [lead], k/M, n)
    in "all_gather" mode, (k/M, [lead], k, n) in "reduce_scatter"."""
    local = _local_tables(tabs, mesh)
    if _mode(ks_mode) == "all_gather":
        return keyswitch(gather_axis(poly, mesh, "model", dim=-2), ksk_b, ksk_a, local)
    both = torch.stack(keyswitch(poly, ksk_b, ksk_a, tabs))       # (2, ..., k, n)
    # each rank's fold is < q_j < 2^31, so the sum of M of them is below
    # M * 2^31: exact in int64, brought below q_j after the sum
    part = reduce_scatter_axis(both, mesh, "model", dim=-2) % local.q[:, None]
    return part[0], part[1]


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
    two; all B when None, which a CUDA tensor may not take:
    `default_chunk` reads the card's free memory, which ranks sharing a
    card would each count whole, so the caller sizes the chunk)."""
    mode = _mode(ks_mode)
    local = _local_tables(tabs, mesh)
    nb = cts_col.shape[0]
    _check_pow2("blocks per rank", nb)
    if tuple(cts_col.shape[1:]) != (2, local.k, local.n):
        raise ValueError(f"expected this rank's (B, 2, {local.k}, {local.n}) blocks, "
                         f"got {tuple(cts_col.shape)}")
    if chunk is None:
        if cts_col.is_cuda:
            raise ValueError("query_step_sharded on the card needs an explicit chunk")
        chunk = nb
    _check_chunk(chunk, nb)
    keys = tile_keys((rlk_b, rlk_a, gk_b, gk_a), chunk)

    def ks(poly, kb, ka, _local):
        return keyswitch_sharded(poly, kb, ka, tabs, mesh, mode)

    out = _scan_chunks(cts_col, cts_val, keys, local, perm, eq_levels, rot_steps, chunk, ks)
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

