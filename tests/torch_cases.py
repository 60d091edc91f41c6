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


def bfv_shard_db(mods, bk):
    """A 3-block fact table (300 rows at n=128) and a 4-row parent, all
    values inside [0, t/2) for t=257 — the JAX package's BFV micro
    sharding table: (database, fact data, parent data)."""
    S = mods["schema"]
    rng = np.random.default_rng(5)
    n = 300
    fact = S.TableSchema("fact", [S.ColumnSpec("g", "int"), S.ColumnSpec("m", "int"),
                                  S.ColumnSpec("v", "int"), S.ColumnSpec("pk_ref", "int")])
    parent = S.TableSchema("parent", [S.ColumnSpec("pid", "int"),
                                      S.ColumnSpec("region", "int")])
    data = {"g": rng.integers(1, 4, n), "m": rng.integers(1, 3, n),
            "v": rng.integers(0, 50, n), "pk_ref": rng.integers(1, 5, n)}
    pdata = {"pid": np.arange(1, 5), "region": np.array([1, 2, 1, 2])}
    db = mods["storage"].Database(bk)
    db.load_table(fact, data, n)
    db.load_table(parent, pdata, 4)
    return db, data, pdata


def bfv_shard_plans(P):
    """{name: QueryPlan} over `bfv_shard_db`'s tables, built from `P`
    (either package's `engine.plan`): a grouped aggregate, a join
    through the parent, and a range filter."""
    hop = P.JoinHop(parent="parent", child="fact", fk="pk_ref")
    return {
        "g1": P.QueryPlan("g1", "fact",
                          where=P.And((P.Pred("g", "in", (1, 2)), P.Pred("m", "=", 1))),
                          group_by="g", group_domain=2,
                          aggs=(P.Agg("sum", (P.Factor("v"),), "sv"), P.Agg("count", (), "ct"))),
        "j1": P.QueryPlan("j1", "fact",
                          where=P.And((P.Translated(hop, P.Pred("region", "=", 1)),
                                       P.Pred("m", "=", 2))),
                          aggs=(P.Agg("sum", (P.Factor("v"),), "sv"),)),
        "f1": P.QueryPlan("f1", "fact", where=P.Pred("v", "<", 20),
                          aggs=(P.Agg("sum", (P.Factor("v"),), "sv"), P.Agg("count", (), "ct"))),
    }


def bfv_shard_oracle(name, data, pdata, t=257):
    """The plaintext answer of `bfv_shard_plans()[name]` mod t."""
    if name == "g1":
        keep = data["m"] == 1
        return {v: {"sv": int(data["v"][keep & (data["g"] == v)].sum() % t),
                    "ct": int((keep & (data["g"] == v)).sum() % t)}
                for v in (1, 2)}
    if name == "j1":
        pr = dict(zip(pdata["pid"], pdata["region"]))
        keep = np.array([pr[k] == 1 for k in data["pk_ref"]]) & (data["m"] == 2)
        return {"sv": int(data["v"][keep].sum() % t)}
    keep = data["v"] < 20
    return {"sv": int(data["v"][keep].sum() % t), "ct": int(keep.sum() % t)}


def sharded_run(mods, db, plan, cell, optimized=True):
    """`plan` through `mods["executor"].Executor` on a planner with shard
    context `cell` = (shards, limb_shards), or none when `cell` is None:
    the decrypted result, OpStats and ExecReport as dicts, and the ledger
    snapshot (None without a context)."""
    pl = (mods["planner"].Planner(db, optimized=optimized, shards=cell[0],
                                  limb_shards=cell[1])
          if cell is not None else mods["planner"].Planner(db, optimized=optimized))
    db.bk.stats.reset()
    ex = mods["executor"].Executor(pl)
    got = ex.run(plan)
    return dict(got=got, stats=dataclasses.asdict(db.bk.stats),
                report=dataclasses.asdict(ex.report),
                ledger=pl.shard_ctx.ledger_snapshot() if pl.shard_ctx else None)
