"""TPC-H-shaped raw tables drawn from a seed.

A frozen copy of the generation arithmetic of the program's
`engine/tpch.generate` (value domains, dictionaries, draw order), so the
benchmark makes its inputs itself and hands the same raw columns to the
program's load path and to the plain reference.  Every table is drawn in
the generator's order, since LINEITEM's dates follow ORDERS' and the
generator's state runs through all of them; only the tables asked for
are returned.
"""
from __future__ import annotations

import numpy as np

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
SHIPINSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
CONTAINERS = [f"{s} {k}" for s in ("SM", "MED", "LG", "JUMBO", "WRAP")
              for k in ("BAG", "BOX", "CASE", "DRUM", "JAR", "PACK", "PKG", "CAN")]
TYPES = [f"{a} {b}" for a in ("ECONOMY", "STANDARD", "PROMO") for b in
         ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")]
SIZES = ("lineitem", "orders", "customer", "supplier", "part", "partsupp")


def generate(sizes: dict, seed: int, tables=("lineitem",)) -> dict:
    """Raw columns of `tables` ({table: {column: values}}) at `sizes`
    (rows a table, every key of `SIZES`), from `seed`.  Dates are day
    offsets (1 = 1992-01-01), decimals floats, strings strings."""
    missing = [k for k in SIZES if k not in sizes]
    if missing:
        raise ValueError(f"table sizes lack {missing}")
    sc = {k: int(sizes[k]) for k in SIZES}
    rng = np.random.default_rng(seed)

    def pick(options, n):
        return [options[i] for i in rng.integers(0, len(options), n)]

    out = {}
    out["supplier"] = {"s_suppkey": np.arange(1, sc["supplier"] + 1),
                       "s_nationkey": rng.integers(1, 26, sc["supplier"])}
    out["customer"] = {"c_custkey": np.arange(1, sc["customer"] + 1),
                       "c_nationkey": rng.integers(1, 26, sc["customer"]),
                       "c_mktsegment": pick(SEGMENTS, sc["customer"])}
    out["part"] = {"p_partkey": np.arange(1, sc["part"] + 1),
                   "p_brand": pick(BRANDS, sc["part"]),
                   "p_type": pick(TYPES, sc["part"]),
                   "p_container": pick(CONTAINERS, sc["part"]),
                   "p_size": rng.integers(1, 51, sc["part"])}
    out["partsupp"] = {"ps_partkey": rng.integers(1, sc["part"] + 1, sc["partsupp"]),
                       "ps_suppkey": rng.integers(1, sc["supplier"] + 1, sc["partsupp"]),
                       "ps_availqty": rng.integers(1, 10000, sc["partsupp"]),
                       "ps_supplycost": rng.integers(1, 1000, sc["partsupp"])}
    odate = rng.integers(1, 2401, sc["orders"])          # 1992..1998 day offsets
    out["orders"] = {"o_orderkey": np.arange(1, sc["orders"] + 1),
                     "o_custkey": rng.integers(1, sc["customer"] + 1, sc["orders"]),
                     "o_orderdate": odate,
                     "o_orderpriority": pick(PRIORITIES, sc["orders"])}
    n = sc["lineitem"]
    lorder = rng.integers(1, sc["orders"] + 1, n)
    ship = odate[lorder - 1] + rng.integers(1, 122, n)
    commit = odate[lorder - 1] + rng.integers(30, 91, n)
    receipt = ship + rng.integers(1, 31, n)
    out["lineitem"] = {
        "l_orderkey": lorder,
        "l_partkey": rng.integers(1, sc["part"] + 1, n),
        "l_suppkey": rng.integers(1, sc["supplier"] + 1, n),
        "l_quantity": rng.integers(1, 51, n),
        "l_extendedprice": rng.integers(100, 10001, n),
        "l_discount": rng.integers(0, 11, n) / 100.0,
        "l_tax": rng.integers(0, 9, n) / 100.0,
        "l_returnflag": pick(RETURNFLAGS, n),
        "l_linestatus": pick(LINESTATUS, n),
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": pick(SHIPINSTRUCT, n),
        "l_shipmode": pick(SHIPMODES, n)}
    return {name: out[name] for name in tables}
