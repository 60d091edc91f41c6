"""Inputs shared by the port's CPU tests, which hold it against the JAX
package, and its card tests (tests/test_torch_gpu_kernels.py), which run
where there is no JAX: one copy, so both drive the same sequences.

Imports numpy only at module level; the callers pass the modules they
compare, and the helpers that run a whole package's query import it
inside (`tpch_join_jax` in a child process, `tpch_join_pair`).
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


# The three branches of TPC-H Q19 (brand, first container, size and
# quantity inside the branch's windows), as engine/queries.py states them.
Q19_BRANCH_ROWS = (("Brand#12", "SM BAG", 3, 5), ("Brand#23", "MED BAG", 7, 15),
                   ("Brand#34", "LG BOX", 11, 25))


def tpch_join_db(mods, bk, scale):
    """LINEITEM, ORDERS and PART generated at `scale` by `mods["tpch"]`,
    loaded through `mods["storage"]` as `tpch.load` loads them.  At small
    scales the generator's tables answer 0 in every cell of Q12 and Q19,
    so rows are planted first: lines of a high- and a low-priority order
    in each of Q12's ship modes, received in 1994 after their commit and
    committed after shipping; and one part meeting each Q19 branch, with
    two lines each inside the branch's quantity window, shipped by air,
    delivered in person."""
    T = mods["tpch"]
    day = mods["schema"].date_to_int
    raw = T.generate(scale)
    orders, part, li = raw["orders"], raw["part"], raw["lineitem"]
    orders["o_orderpriority"][0] = "1-URGENT"
    orders["o_orderpriority"][1] = "5-LOW"
    for r in range(8):
        li["l_orderkey"][r] = 1 + r % 2
        li["l_shipmode"][r] = "MAIL" if r < 4 else "SHIP"
        li["l_receiptdate"][r] = day("1994-03-01") + r
        li["l_commitdate"][r] = li["l_receiptdate"][r] - 10
        li["l_shipdate"][r] = li["l_commitdate"][r] - 10
    for j, (brand, container, size, qty) in enumerate(Q19_BRANCH_ROWS):
        part["p_brand"][j], part["p_container"][j], part["p_size"][j] = brand, container, size
        for r in (8 + 2 * j, 9 + 2 * j):
            li["l_partkey"][r] = j + 1
            li["l_quantity"][r] = qty
            li["l_shipmode"][r] = "AIR"
            li["l_shipinstruct"][r] = "DELIVER IN PERSON"
    db = mods["storage"].Database(bk)
    schemas = T.schemas()
    for name, data in raw.items():
        if name in ("lineitem", "orders", "part"):
            db.load_table(schemas[name], data, len(next(iter(data.values()))))
    return db


def tpch_join_run(mods, bk, qn, scale):
    """TPC-H `qn` over `tpch_join_db(mods, bk, scale)` through the compiled
    DAG (`Executor(Planner(db)).run`, what `run_via_plan` calls; static
    verification on): the database, the result, the oracle's answer, and
    OpStats, op_log, refresh_log, the ExecReport and the verifier's
    findings as plain values."""
    db = tpch_join_db(mods, bk, scale)
    plan_fn, _, oracle_fn = mods["queries"].QUERIES[qn]
    bk.stats.reset()
    ex = mods["executor"].Executor(mods["planner"].Planner(db, optimized=True))
    got = ex.run(plan_fn())
    return dict(db=db, got=got, oracle=oracle_fn(db),
                stats=dataclasses.asdict(bk.stats), op_log=dict(bk.op_log),
                refresh_log=list(bk.refresh_log), report=dataclasses.asdict(ex.report),
                findings=[(f.severity, f.code, f.where)
                          for f in ex._verify_report.findings])


def lane_chunk_run(bk, cmp, ops):
    """A 5-lane batch through `cmp.eq_zero`, `cmp.lt_zero` and
    `ops.broadcast_slots` (either package's core.compare and engine.ops)
    on `bk`, a BFVBackend at t=257: each result's decrypts, noise and
    depth, then OpStats as a dict."""
    rng = np.random.default_rng(1)
    batch = bk.stack_blocks([bk.encrypt(rng.integers(0, bk.t, bk.slots)) for _ in range(5)])
    bk.stats.reset()
    eq = cmp.eq_zero(bk, batch)
    lt = cmp.lt_zero(bk, batch)
    bcast = bk.stack_blocks(ops.broadcast_slots(bk, bk.encrypt(np.arange(bk.slots) % 7), range(5)))
    return ([(np.asarray(bk.decrypt(c)), np.asarray(c.noise).tolist(), bk.depth(c))
             for c in (eq, lt, bcast)], dataclasses.asdict(bk.stats))


def tpch_join_jax(qn, parents, params):
    """`tpch_join_run` of the JAX package (plain limb path) at
    `make_params(**params)`, seed 0, over `Scale.tiny()` with `parents`
    replaced, without its database: what a child process hands back."""
    from repro.core.params import make_params
    from repro.engine import backend, executor, planner, queries, schema, storage, tpch
    mods = dict(executor=executor, planner=planner, queries=queries, schema=schema,
                storage=storage, tpch=tpch)
    bk = backend.BFVBackend(make_params(**params), seed=0, kernel_backend="ref")
    out = tpch_join_run(mods, bk, qn, dataclasses.replace(tpch.Scale.tiny(), **parents))
    del out["db"]
    return out


def tpch_join_pair(qn, parents, params, max_lanes):
    """(port, JAX) runs of `tpch_join_run` for `qn` on the same tables at
    `make_params(**params)`, seed 0: the port's on the CPU with
    `max_lanes` (its lane log added), on one torch thread; the JAX
    package's in a spawned child process at the same time."""
    import concurrent.futures
    import multiprocessing

    import torch

    from repro_torch.core.params import make_params
    from repro_torch.engine import backend, executor, planner, queries, schema, storage, tpch
    mods = dict(executor=executor, planner=planner, queries=queries, schema=schema,
                storage=storage, tpch=tpch)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        jax = pool.submit(tpch_join_jax, qn, parents, params)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)     # tiny CPU tensor ops: other threads only spin
        try:
            bk = backend.BFVBackend(make_params(**params), seed=0, device="cpu",
                                    max_lanes=max_lanes)
            port = tpch_join_run(mods, bk, qn,
                                 dataclasses.replace(tpch.Scale.tiny(), **parents))
            port["lane_log"] = list(bk.lane_log)
        finally:
            torch.set_num_threads(threads)
        return port, jax.result(timeout=1800)
