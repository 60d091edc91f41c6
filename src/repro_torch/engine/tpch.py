"""TPC-H-style dataset generator + schemas (paper §5.1).

The paper loads all eight TPC-H tables at SF-1 with LINEITEM sampled to
32K rows and related tables scaled proportionally, storing 16-bit integer
encodings (Fig. 7).  We generate a deterministic dataset with the same
shape: value domains fit in [0, t/2) for t = 65537, dates are day offsets
from 1992-01-01, strings are dictionary-encoded, decimals fixed-point.

`Scale` controls row counts so tests run the identical schema at tiny
sizes while benchmarks run the paper's 32K-row setting.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .schema import ColumnSpec, TableSchema
from .storage import Database

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 1), ("ARGENTINA", 2), ("BRAZIL", 2), ("CANADA", 2),
    ("EGYPT", 5), ("ETHIOPIA", 1), ("FRANCE", 4), ("GERMANY", 4),
    ("INDIA", 3), ("INDONESIA", 3), ("IRAN", 5), ("IRAQ", 5),
    ("JAPAN", 3), ("JORDAN", 5), ("KENYA", 1), ("MOROCCO", 1),
    ("MOZAMBIQUE", 1), ("PERU", 2), ("CHINA", 3), ("ROMANIA", 4),
    ("SAUDI ARABIA", 5), ("VIETNAM", 3), ("RUSSIA", 4),
    ("UNITED KINGDOM", 4), ("UNITED STATES", 2),
]
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


@dataclasses.dataclass(frozen=True)
class Scale:
    lineitem: int = 32768
    orders: int = 8192
    customer: int = 1024
    supplier: int = 256
    part: int = 1024
    partsupp: int = 2048

    @staticmethod
    def tiny() -> "Scale":
        """Test scale: full schema, hundreds of rows."""
        return Scale(lineitem=192, orders=48, customer=12, supplier=6,
                     part=16, partsupp=24)

    @staticmethod
    def small() -> "Scale":
        return Scale(lineitem=2048, orders=512, customer=64, supplier=16,
                     part=64, partsupp=128)


def schemas() -> dict[str, TableSchema]:
    C = ColumnSpec
    return {
        "region": TableSchema("region", [C("r_regionkey", "int"), C("r_name", "str")]),
        "nation": TableSchema("nation", [
            C("n_nationkey", "int"), C("n_name", "str"), C("n_regionkey", "int")]),
        "supplier": TableSchema("supplier", [
            C("s_suppkey", "int"), C("s_nationkey", "int")]),
        "customer": TableSchema("customer", [
            C("c_custkey", "int"), C("c_nationkey", "int"), C("c_mktsegment", "str")]),
        "part": TableSchema("part", [
            C("p_partkey", "int"), C("p_brand", "str"), C("p_type", "str"),
            C("p_container", "str"), C("p_size", "int")]),
        "partsupp": TableSchema("partsupp", [
            C("ps_partkey", "int"), C("ps_suppkey", "int"),
            C("ps_availqty", "int"), C("ps_supplycost", "decimal", scale=1)]),
        "orders": TableSchema("orders", [
            C("o_orderkey", "int"), C("o_custkey", "int"),
            C("o_orderdate", "date"), C("o_orderpriority", "str")]),
        "lineitem": TableSchema("lineitem", [
            C("l_orderkey", "int"), C("l_partkey", "int"), C("l_suppkey", "int"),
            C("l_quantity", "int"), C("l_extendedprice", "decimal", scale=1),
            C("l_discount", "decimal", scale=100), C("l_tax", "decimal", scale=100),
            C("l_returnflag", "flag"), C("l_linestatus", "flag"),
            C("l_shipdate", "date"), C("l_commitdate", "date"),
            C("l_receiptdate", "date"), C("l_shipinstruct", "str"),
            C("l_shipmode", "str")]),
    }


def generate(scale: Scale, seed: int = 7) -> dict[str, dict]:
    """Deterministic raw (pre-encoding) table data."""
    rng = np.random.default_rng(seed)
    sc = scale

    def pick(options, n):
        return [options[i] for i in rng.integers(0, len(options), n)]

    data: dict[str, dict] = {}
    data["region"] = {
        "r_regionkey": np.arange(1, 6), "r_name": REGIONS}
    data["nation"] = {
        "n_nationkey": np.arange(1, 26),
        "n_name": [n for n, _ in NATIONS],
        "n_regionkey": np.array([r for _, r in NATIONS])}
    data["supplier"] = {
        "s_suppkey": np.arange(1, sc.supplier + 1),
        "s_nationkey": rng.integers(1, 26, sc.supplier)}
    data["customer"] = {
        "c_custkey": np.arange(1, sc.customer + 1),
        "c_nationkey": rng.integers(1, 26, sc.customer),
        "c_mktsegment": pick(SEGMENTS, sc.customer)}
    data["part"] = {
        "p_partkey": np.arange(1, sc.part + 1),
        "p_brand": pick(BRANDS, sc.part),
        "p_type": pick(TYPES, sc.part),
        "p_container": pick(CONTAINERS, sc.part),
        "p_size": rng.integers(1, 51, sc.part)}
    data["partsupp"] = {
        "ps_partkey": rng.integers(1, sc.part + 1, sc.partsupp),
        "ps_suppkey": rng.integers(1, sc.supplier + 1, sc.partsupp),
        "ps_availqty": rng.integers(1, 10000, sc.partsupp),
        "ps_supplycost": rng.integers(1, 1000, sc.partsupp)}

    odate = rng.integers(1, 2401, sc.orders)          # 1992..1998 day offsets
    data["orders"] = {
        "o_orderkey": np.arange(1, sc.orders + 1),
        "o_custkey": rng.integers(1, sc.customer + 1, sc.orders),
        "o_orderdate": odate,                          # already day ints
        "o_orderpriority": pick(PRIORITIES, sc.orders)}

    lorder = rng.integers(1, sc.orders + 1, sc.lineitem)
    ship = odate[lorder - 1] + rng.integers(1, 122, sc.lineitem)
    commit = odate[lorder - 1] + rng.integers(30, 91, sc.lineitem)
    receipt = ship + rng.integers(1, 31, sc.lineitem)
    data["lineitem"] = {
        "l_orderkey": lorder,
        "l_partkey": rng.integers(1, sc.part + 1, sc.lineitem),
        "l_suppkey": rng.integers(1, sc.supplier + 1, sc.lineitem),
        "l_quantity": rng.integers(1, 51, sc.lineitem),
        "l_extendedprice": rng.integers(100, 10001, sc.lineitem),
        "l_discount": rng.integers(0, 11, sc.lineitem) / 100.0,
        "l_tax": rng.integers(0, 9, sc.lineitem) / 100.0,
        "l_returnflag": pick(RETURNFLAGS, sc.lineitem),
        "l_linestatus": pick(LINESTATUS, sc.lineitem),
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": pick(SHIPINSTRUCT, sc.lineitem),
        "l_shipmode": pick(SHIPMODES, sc.lineitem)}
    return data


_ROWCOUNT = {"region": 5, "nation": 25}


def load(backend, scale: Scale, seed: int = 7, tables: list[str] | None = None) -> Database:
    """Generate, encode and encrypt the dataset into a Database."""
    raw = generate(scale, seed)
    sch = schemas()
    db = Database(backend)
    for name, tdata in raw.items():
        if tables is not None and name not in tables:
            continue
        schema = sch[name]
        nrows = _ROWCOUNT.get(name) or len(next(iter(tdata.values())))
        db.load_table(schema, tdata, nrows)
    return db
