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
limbs over "model", keys on their output-limb axis — what the dry-run
reads (launch/dryrun.py); this module runs on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.nshedb import NshedbConfig
from ..core.mathutil import find_ntt_primes
from ..core.params import _make_ntt_tables
from ..kernels.modops.ops import add_mod, mul_mod
from ..kernels.tables import LimbTables, limb_tables

KS_MODES = ("all_gather", "reduce_scatter")
KS_MODE = "all_gather"


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
    (k, k, n), or tiled to (k, *lead, k, n) by `tile_keys`."""
    k = poly.shape[-2]
    lead = poly.shape[:-2]
    digits = poly.movedim(-2, 0).unsqueeze(-2).expand(k, *lead, k, poly.shape[-1])
    out = []
    for ksk in (ksk_b, ksk_a):
        if ksk.dim() != digits.dim():
            ksk = ksk.view(ksk.shape[0], *([1] * len(lead)), *ksk.shape[1:])
        out.append(_tree_fold(mul_mod(digits, ksk, tabs), tabs))
    return out[0], out[1]


def ct_square(ct, rlk_b, rlk_a, tabs: LimbTables):
    """Evaluation-domain ciphertext squaring + relinearization.
    ct: (2, ..., k, n)."""
    c0, c1 = ct[0], ct[1]
    d0 = mul_mod(c0, c0, tabs)
    d1 = mul_mod(c0, c1, tabs)
    d1 = add_mod(d1, d1, tabs)
    d2 = mul_mod(c1, c1, tabs)
    ks0, ks1 = keyswitch(d2, rlk_b, rlk_a, tabs)
    return torch.stack([add_mod(d0, ks0, tabs), add_mod(d1, ks1, tabs)])


def ct_mul(ct_a, ct_b, rlk_b, rlk_a, tabs: LimbTables):
    a0, a1 = ct_a[0], ct_a[1]
    b0, b1 = ct_b[0], ct_b[1]
    d0 = mul_mod(a0, b0, tabs)
    d1 = add_mod(mul_mod(a0, b1, tabs), mul_mod(a1, b0, tabs), tabs)
    d2 = mul_mod(a1, b1, tabs)
    ks0, ks1 = keyswitch(d2, rlk_b, rlk_a, tabs)
    return torch.stack([add_mod(d0, ks0, tabs), add_mod(d1, ks1, tabs)])


def rotate(ct, perm, gk_b, gk_a, tabs: LimbTables):
    """Galois rotation: coefficient permutation + key switch."""
    rot = ct[..., perm]
    ks0, ks1 = keyswitch(rot[1], gk_b, gk_a, tabs)
    return torch.stack([add_mod(rot[0], ks0, tabs), ks1])


def _scan_blocks(col, val, keys, tabs, perm, eq_levels, rot_steps):
    """One chunk: col/val (2, B, k, n); keys tiled for B blocks."""
    rlk_b, rlk_a, gk_b, gk_a = keys
    mask = col
    for _ in range(eq_levels):
        mask = ct_square(mask, rlk_b, rlk_a, tabs)
    out = ct_mul(mask, val, rlk_b, rlk_a, tabs)
    for _ in range(rot_steps):
        out = add_mod(out, rotate(out, perm, gk_b, gk_a, tabs), tabs)
    return out


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

    `ks_mode` (`KS_MODE` when None) is one of `KS_MODES`.  It is checked
    and nothing else: in the JAX package "reduce_scatter" only adds a
    sharding constraint on the digit products, and this step runs on one
    device, so both modes compute the same numbers."""
    if (ks_mode or KS_MODE) not in KS_MODES:
        raise ValueError(f"ks_mode {ks_mode!r} is not one of {KS_MODES}")
    nb, k = cts_col.shape[0], cts_col.shape[-2]
    _check_pow2("nblocks", nb)
    chunk = chunk or default_chunk(cts_col, k)
    _check_pow2("chunk", chunk)
    if chunk > nb:
        raise ValueError(f"chunk {chunk} exceeds nblocks {nb}")
    keys = tile_keys((rlk_b, rlk_a, gk_b, gk_a), chunk)
    outs = []
    for i in range(0, nb, chunk):
        col = cts_col[i:i + chunk].transpose(0, 1).contiguous()
        val = cts_val[i:i + chunk].transpose(0, 1).contiguous()
        outs.append(_scan_blocks(col, val, keys, tabs, perm, eq_levels,
                                 rot_steps).transpose(0, 1))
    del keys
    outs = torch.cat(outs)
    # binary-tree modular block aggregation: log2(nb) halving rounds
    while nb > 1:
        half = nb // 2
        outs = add_mod(outs[:half], outs[half:nb], tabs)
        nb = half
    return outs[0]


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

