"""Inputs shared by the port's CPU tests, which hold it against the JAX
package, and its card tests (tests/test_torch_gpu_kernels.py), which run
where there is no JAX: one copy, so both drive the same sequences.

Imports numpy only at module level; the callers pass the modules they
compare, and the helpers that run a whole package's query import it
inside (`jax_bfv_run` in a child process, `bfv_pair`).
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


def planted_rows(rows, n, t, seed):
    """(rows, n) int64 values in [0, t_row) for the (rows, 1) moduli t:
    lane 0 at t - 1 and the last lane at 0 in every other row, row 2 all
    t - 1 (every add of the doubling loop then wraps)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, t, (rows, n))
    x[:, 0] = t[:, 0] - 1
    x[1::2, -1] = 0
    if rows > 2:
        x[2] = t[2, 0] - 1
    return x


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


def tpch_join_run(mods, bk, qn, parents):
    """TPC-H `qn` over `tpch_join_db` at `Scale.tiny()` with `parents`
    replaced, through the compiled DAG (`Executor(Planner(db)).run`, what
    `run_via_plan` calls; static verification on): the database, the
    result, the oracle's answer, and OpStats, op_log, refresh_log, the
    ExecReport and the verifier's findings as plain values."""
    db = tpch_join_db(mods, bk, dataclasses.replace(mods["tpch"].Scale.tiny(), **parents))
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


def engine_mods(package):
    """The engine modules the runs below take, of `package` ("repro" or
    "repro_torch")."""
    import importlib
    names = ("executor", "ops", "planner", "queries", "schema", "storage", "tpch")
    mods = {name: importlib.import_module(f"{package}.engine.{name}") for name in names}
    mods["compare"] = importlib.import_module(f"{package}.core.compare")
    mods["plan"] = importlib.import_module(f"{package}.engine.plan")
    return mods


def jax_bfv_run(run, params, *args):
    """`run(mods, bk, *args)` on the JAX package's BFVBackend (plain limb
    path) at `make_params(**params)`, seed 0, without a database in its
    result: what a child process hands back."""
    from repro.core.params import make_params
    from repro.engine import backend
    bk = backend.BFVBackend(make_params(**params), seed=0, kernel_backend="ref")
    out = run(engine_mods("repro"), bk, *args)
    out.pop("db", None)
    return out


def bfv_pair(run, params, max_lanes, *args):
    """(port, JAX) results of `run(mods, bk, *args)` on BFVBackend at
    `make_params(**params)`, seed 0: the port's on the CPU with
    `max_lanes` (its lane log added), on one torch thread; the JAX
    package's in a spawned child process at the same time."""
    import concurrent.futures
    import multiprocessing

    import torch

    from repro_torch.core.params import make_params
    from repro_torch.engine import backend
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        jax = pool.submit(jax_bfv_run, run, params, *args)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)     # tiny CPU tensor ops: other threads only spin
        try:
            bk = backend.BFVBackend(make_params(**params), seed=0, device="cpu",
                                    max_lanes=max_lanes)
            port = run(engine_mods("repro_torch"), bk, *args)
            port["lane_log"] = list(bk.lane_log)
        finally:
            torch.set_num_threads(threads)
        return port, jax.result(timeout=1800)


def tpch_join_pair(qn, parents, params, max_lanes):
    """(port, JAX) runs of `tpch_join_run` for `qn` on the same tables
    (`Scale.tiny()` with `parents` replaced) at `make_params(**params)`,
    seed 0, as `bfv_pair` runs them."""
    return bfv_pair(tpch_join_run, params, max_lanes, qn, parents)


# ---------------------------------------------------------------------------
# The legacy query bodies (run_q4, run_q5, run_q8, run_q14, run_q17) and
# the join helpers they reach, on all eight TPC-H tables.
# ---------------------------------------------------------------------------

# Parents of `Scale.tiny()` cut for the legacy runs on BFV at micro size:
# every hop costs an EQ circuit per parent row.
LEGACY_PARENTS = dict(orders=4, customer=2, supplier=2, part=4)


def tpch_legacy_db(mods, bk, parents=None):
    """All eight TPC-H tables generated at `Scale.tiny()` with `parents`
    (default `LEGACY_PARENTS`) replaced, loaded through `mods["storage"]`
    as `tpch.load` loads them.  The generator's tiny tables answer 0 in
    Q5, Q8 and Q17, so rows are planted first:

      Q17  part 1 is Brand#23 / MED BOX; lines 0-5 are of part 1 with
           quantity 1, below a fifth of the part's average;
      Q14  part 2 is PROMO PLATED; lines 6-7 are of part 2, shipped in
           September 1995;
      Q8   customer 1 and supplier 1 are in BRAZIL (AMERICA), part 3 is
           ECONOMY ANODIZED; orders 1 (1995) and 2 (1996) are customer
           1's; lines 8-11 are of orders 1, 1, 2, 2, part 3, supplier 1;
      Q5   customer 2 and supplier 2 are in nation 9 (ASIA); order 3
           (1994) is customer 2's; lines 12-13 are of order 3, supplier 2;
      Q4   order 4 (1993-08-01) is 1-URGENT; line 14 is of order 4,
           received after its commit date.

    Returns the database."""
    T = mods["tpch"]
    day = mods["schema"].date_to_int
    scale = dataclasses.replace(T.Scale.tiny(), **(parents or LEGACY_PARENTS))
    raw = T.generate(scale)
    part, supp, cust = raw["part"], raw["supplier"], raw["customer"]
    orders, li = raw["orders"], raw["lineitem"]
    part["p_brand"][0], part["p_container"][0] = "Brand#23", "MED BOX"
    for r in range(6):
        li["l_partkey"][r], li["l_quantity"][r] = 1, 1
    part["p_type"][1] = "PROMO PLATED"
    for r in (6, 7):
        li["l_partkey"][r], li["l_shipdate"][r] = 2, day("1995-09-10")
    cust["c_nationkey"][0] = supp["s_nationkey"][0] = 3
    part["p_type"][2] = "ECONOMY ANODIZED"
    orders["o_custkey"][0] = orders["o_custkey"][1] = 1
    orders["o_orderdate"][0], orders["o_orderdate"][1] = day("1995-06-01"), day("1996-06-01")
    for r, o in zip(range(8, 12), (1, 1, 2, 2)):
        li["l_orderkey"][r], li["l_partkey"][r], li["l_suppkey"][r] = o, 3, 1
    cust["c_nationkey"][1] = supp["s_nationkey"][1] = 9
    orders["o_custkey"][2], orders["o_orderdate"][2] = 2, day("1994-06-01")
    for r in (12, 13):
        li["l_orderkey"][r], li["l_suppkey"][r] = 3, 2
    orders["o_orderdate"][3], orders["o_orderpriority"][3] = day("1993-08-01"), "1-URGENT"
    li["l_orderkey"][14] = 4
    li["l_commitdate"][14] = li["l_receiptdate"][14] - 5
    db = mods["storage"].Database(bk)
    schemas = T.schemas()
    for name, data in raw.items():
        nrows = len(next(iter(data.values())))
        db.load_table(schemas[name], data, nrows)
    return db


def _trace(bk) -> dict:
    """OpStats, op_log and refresh_log of `bk` as plain values."""
    return dict(stats=dataclasses.asdict(bk.stats), op_log=dict(bk.op_log),
                refresh_log=list(bk.refresh_log))


def _reset(bk) -> None:
    bk.stats.reset()
    bk.op_log.clear()
    bk.refresh_log.clear()


def legacy_query_run(mods, bk, qn, parents=None):
    """The legacy body of TPC-H `qn` (`QUERIES[qn][1]` on an optimized
    Planner) over `tpch_legacy_db`: the result, the oracle's answer, and
    OpStats, op_log and refresh_log as plain values."""
    db = tpch_legacy_db(mods, bk, parents)
    _reset(bk)
    got = mods["queries"].QUERIES[qn][1](mods["planner"].Planner(db, optimized=True))
    return dict(got=got, oracle=mods["queries"].QUERIES[qn][2](db), **_trace(bk))


def _residues(ct) -> str:
    """A digest of a ciphertext's int64 residues."""
    import hashlib
    data = ct.data.cpu() if hasattr(ct.data, "cpu") else ct.data
    words = np.ascontiguousarray(np.asarray(data, dtype=np.int64))
    return hashlib.sha256(words.tobytes()).hexdigest()


def _cts(bk, cts) -> list:
    """(decrypt, noise, depth, residue digest) of each ciphertext, after
    the trace was taken."""
    return [(bk.decrypt(c).tolist(), np.asarray(c.noise).tolist(), bk.depth(c), _residues(c))
            for c in cts]


def legacy_helpers_run(mods, bk, parents=None):
    """The join helpers the legacy bodies reach, each from a cleared
    trace over `tpch_legacy_db`, none with an `lt` circuit: {case:
    {"cts": [(decrypt, noise, depth, residue digest)], stats, op_log,
    refresh_log}}.  The plaintext answer of each case is under "expect"."""
    ops, cmp, P = mods["ops"], mods["compare"], mods["plan"]
    db = tpch_legacy_db(mods, bk, parents)
    tables, plain = db.tables, db.plain
    li, orders, part = tables["lineitem"], tables["orders"], tables["part"]
    nord, npart, t = orders.nrows, part.nrows, bk.t
    out = {}

    def case(name, cts, expect=None, **extra):
        out[name] = dict(**_trace(bk), **extra)
        out[name]["cts"] = _cts(bk, cts)
        out[name]["expect"] = expect

    lpk, lok = plain["lineitem"]["l_partkey"], plain["lineitem"]["l_orderkey"]
    qty = plain["lineitem"]["l_quantity"]
    air_id = li.col("l_shipmode").spec.dictionary["AIR"]
    air = plain["lineitem"]["l_shipmode"] == air_id

    _reset(bk)
    mask = ops.pred_mask(bk, li, P.Pred("l_shipmode", "=", "AIR"))
    sums = ops.join_aggregate(bk, li, "l_partkey", npart, li.col("l_quantity").blocks,
                              extra_mask=mask)
    case("join_aggregate_sum_masked", sums,
         [int(qty[(lpk == j + 1) & air].sum()) % t for j in range(npart)])
    _reset(bk)
    counts = ops.join_aggregate(bk, li, "l_orderkey", nord, None)
    per_order = [int((lok == j + 1).sum()) % t for j in range(nord)]
    case("join_aggregate_count", counts, per_order)
    _reset(bk)
    packed = ops.pack_scalars(bk, counts)
    case("pack_scalars", [packed], per_order)
    _reset(bk)
    down = ops.translate_values_down(bk, packed, li, "l_orderkey", nord)
    case("translate_values_down", down, [per_order[k - 1] for k in lok])
    _reset(bk)
    bit = bk.broadcast_slot(packed, 3)
    case("broadcast_slot", [bit], per_order[3])

    # Q8's chain: region -> nation -> customer -> orders -> lineitem
    _reset(bk)
    nat, cust = tables["nation"], tables["customer"]
    rmask = ops.pred_mask(bk, tables["region"], P.Pred("r_name", "=", "AMERICA"))
    nmask = ops.translate_mask_down(bk, rmask[0], nat, "n_regionkey", 5)
    cmask = ops.translate_mask_down(bk, nmask[0], cust, "c_nationkey", 25)
    omask = ops.translate_mask_down(bk, cmask[0], orders, "o_custkey", cust.nrows)
    limask = ops.translate_mask_down(bk, omask[0], li, "l_orderkey", nord)
    rid = tables["region"].col("r_name").spec.dictionary["AMERICA"]
    n_ok = plain["nation"]["n_regionkey"] == rid
    c_ok = n_ok[plain["customer"]["c_nationkey"] - 1]
    o_ok = c_ok[plain["orders"]["o_custkey"] - 1]
    case("q8_chain", [nmask[0], cmask[0], omask[0], limask[0]],
         [n_ok.astype(int).tolist(), c_ok.astype(int).tolist(), o_ok.astype(int).tolist(),
          o_ok[lok - 1].astype(int).tolist()])
    _reset(bk)
    fk = ops.mask_columns(bk, li.col("l_orderkey").blocks, mask)
    over = ops.translate_mask_down(bk, omask[0], li, "l_orderkey", nord, fk_override=fk)
    case("q8_last_hop_fk_override", over, (o_ok[lok - 1] & air).astype(int).tolist())

    # planned refreshes: one ciphertext, and a batch with one short lane
    _reset(bk)
    fresh = bk.encrypt(np.arange(bk.slots) % 7)
    deep = bk.mul(bk.mul(fresh, fresh), fresh)
    need = bk.levels_left(deep) + 1
    one = bk.ensure_levels(deep, need)
    case("ensure_levels_one", [one], [(v ** 3) % t for v in np.arange(bk.slots) % 7],
         need=need)
    _reset(bk)
    lanes = [bk.encrypt(np.full(bk.slots, v)) for v in (2, 3)]
    short = bk.mul(bk.mul(lanes[1], lanes[1]), lanes[1])
    batch = bk.stack_blocks([lanes[0], short, lanes[0]])
    need = bk.levels_left(short) + 1
    batch = bk.ensure_levels(batch, need)
    case("ensure_levels_batch", bk.unstack_blocks(batch), [2, 27, 2], need=need)

    # Planner.group_aggregate over ORDERS: counts and a sum per priority
    _reset(bk)
    pl = mods["planner"].Planner(db, optimized=True)
    where = pl.where_mask(orders, P.Pred("o_custkey", "in", [1, 2]))
    pr = orders.col("o_orderpriority").spec.dictionary
    res = pl.group_aggregate(orders, "o_orderpriority", [pr[k] for k in sorted(pr)],
                             (P.Agg("count", (), "n"), P.Agg("sum", (P.Factor("o_custkey"),), "s")),
                             where)
    o = plain["orders"]
    keep = np.isin(o["o_custkey"], [1, 2])
    case("group_aggregate", [res[pid][a] for pid in sorted(res) for a in ("n", "s")],
         [v for pid in sorted(res)
          for v in (int((keep & (o["o_orderpriority"] == pid)).sum()) % t,
                    int(o["o_custkey"][keep & (o["o_orderpriority"] == pid)].sum()) % t)])
    return out
