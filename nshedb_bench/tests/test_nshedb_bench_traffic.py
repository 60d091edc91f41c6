"""The traffic generator: TPC-H's parameter ranges, the same draws for
the same seed, and plans that equal the program's own at TPC-H's
validation parameters."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT) if p not in sys.path]

import pytest  # noqa: E402

from nshedb_bench import traffic  # noqa: E402
from nshedb_bench.systems import tpch_query  # noqa: E402

SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_q1_delta_in_qgen_range(seed):
    mix = traffic.load("tpch_q1_cold")
    for i in range(40):
        q = traffic.query(mix, seed, "window", i)
        delta = q["params"]["DELTA"]
        assert 60 <= delta <= 120
        assert q["where"] == [("l_shipdate", "<=", traffic.day("1998-12-01") - delta)]


@pytest.mark.parametrize("seed", SEEDS)
def test_q6_parameters_in_qgen_range(seed):
    mix = traffic.load("tpch_q6_cold")
    seen = set()
    for i in range(60):
        p = traffic.query(mix, seed, "window", i)["params"]
        assert 1993 <= p["YEAR"] <= 1997
        assert 2 <= p["DISCOUNT"] <= 9
        assert p["QUANTITY"] in (24, 25)
        seen.add(p["YEAR"])
    assert len(seen) > 1


def test_q6_predicates_resolve():
    mix = traffic.load("tpch_q6_cold")
    where = [(c, op, traffic.resolve(f, {"YEAR": 1995, "DISCOUNT": 3, "QUANTITY": 25}))
             for c, op, f in mix["where"]]
    assert where == [("l_shipdate", ">=", traffic.day("1995-01-01")),
                     ("l_shipdate", "<", traffic.day("1996-01-01")),
                     ("l_discount", "between", (0.02, 0.04)),
                     ("l_quantity", "<", 25)]


@pytest.mark.parametrize("name", ["tpch_q1_cold", "tpch_q6_cold", "eq_scan"])
def test_same_seed_same_draws(name):
    mix = traffic.load(name)
    a = [traffic.query(mix, 123456789, "window", i) for i in range(8)]
    b = [traffic.query(mix, 123456789, "window", i) for i in range(8)]
    assert a == b
    other = [traffic.query(mix, 123456790, "window", i) for i in range(8)]
    warm = [traffic.query(mix, 123456789, "warmup", i) for i in range(8)]
    assert a != other and a != warm


def test_scan_constant_in_plaintext_range():
    mix = traffic.load("eq_scan")
    vals = [traffic.query(mix, 5, "window", i)["params"]["EQ_CONST"] for i in range(200)]
    assert min(vals) >= 0 and max(vals) < 65537 and len(set(vals)) > 150


def test_day_is_the_schema_encoding():
    from repro_torch.engine.schema import date_to_int
    for d in ("1992-01-01", "1994-01-01", "1998-09-02", "1998-12-01"):
        assert traffic.day(d) == date_to_int(d)


def test_plans_equal_the_programs_at_validation_parameters():
    """TPC-H's validation run: Q1 DELTA = 90 (1998-09-02), Q6 1994,
    0.06, 24 — the program's own plan_q1 / plan_q6."""
    from repro_torch.engine import queries
    q1 = traffic.load("tpch_q1_cold")
    where = [(c, op, traffic.resolve(f, {"DELTA": 90})) for c, op, f in q1["where"]]
    assert tpch_query.build_plan(q1, where) == queries.plan_q1()
    q6 = traffic.load("tpch_q6_cold")
    where = [(c, op, traffic.resolve(f, {"YEAR": 1994, "DISCOUNT": 6, "QUANTITY": 24}))
             for c, op, f in q6["where"]]
    assert tpch_query.build_plan(q6, where) == queries.plan_q6()
