"""Inputs shared by the port's CPU tests, which hold it against the JAX
package, and its card tests (tests/test_torch_gpu_kernels.py), which run
where there is no JAX: one copy, so both drive the same sequences.

Imports numpy only; the callers pass the modules they compare.
"""
import dataclasses

import numpy as np


def mock_db(mods, bk, nrows=600):
    """A two-column table of `nrows` rows loaded through `mods["storage"]`
    (either package's `engine.storage`, with its `engine.schema`)."""
    S = mods["schema"]
    schema = S.TableSchema("items", [S.ColumnSpec("grp", "int"),
                                     S.ColumnSpec("qty", "int")])
    rng = np.random.default_rng(4)
    data = {"grp": rng.integers(1, 6, nrows), "qty": rng.integers(0, 50, nrows)}
    db = mods["storage"].Database(bk)
    db.load_table(schema, data, nrows)
    return db


def sum_slots_run(bk, mods):
    """The cases of the JAX package's kernel_reduce test: one single
    ciphertext, one 3-block batch, and a batched table column, through
    `bk.sum_slots`: ([(slots, noise, depth)] of each, OpStats as a dict)."""
    db = mock_db(mods, bk)
    bk.stats.reset()
    single = bk.sum_slots(bk.encrypt(np.arange(200) % bk.t))
    batch = bk.sum_slots(bk.stack_blocks([bk.encrypt(np.full(256, i)) for i in (1, 2, 3)]))
    col = bk.sum_slots(bk.stack_blocks(db.tables["items"].col("qty").blocks))
    return ([(c.vec, c.noise, c.depth) for c in (single, batch, col)],
            dataclasses.asdict(bk.stats))


def qkv_arrays(B, H, Hkv, Sq, Sk, D, seed=0):
    """q (B, H, Sq, D) and k, v (B, Hkv, Sk, D): float32 numpy normals,
    drawn in that order from one generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
