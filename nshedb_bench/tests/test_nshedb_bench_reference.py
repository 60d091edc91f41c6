"""The plain references: hand-worked answers, agreement with the
program's own numpy oracles and scan step at small sizes on the CPU, and
the controls failing at a size a test run holds."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT) if p not in sys.path]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from nshedb_bench import control, harness, tables, traffic  # noqa: E402
from nshedb_bench.systems import scan_step  # noqa: E402
from nshedb_bench.reference import scan_query  # noqa: E402
from nshedb_bench.reference import scan_step as ref_step  # noqa: E402

T = 65537
SCALES = {"l_extendedprice": 1, "l_discount": 100, "l_tax": 100}
SMALL = dict(lineitem=256, orders=64, customer=12, supplier=6, part=16, partsupp=24)

# six rows worked by hand
HAND = {
    "l_shipdate": np.array([10, 20, 30, 40, 50, 60]),
    "l_returnflag": ["A", "N", "A", "R", "N", "A"],
    "l_linestatus": ["F", "O", "F", "F", "O", "O"],
    "l_quantity": np.array([5, 30, 20, 10, 25, 1]),
    "l_extendedprice": np.array([40000, 30000, 200, 100, 1000, 7]),
    "l_discount": np.array([0.05, 0.10, 0.06, 0.00, 0.07, 0.01]),
    "l_tax": np.array([0.08, 0.00, 0.02, 0.04, 0.01, 0.00]),
}


def test_hand_worked_q1():
    mix = traffic.load("tpch_q1_cold")
    ans = scan_query.answer(HAND, SCALES, [("l_shipdate", "<=", 50)],
                            mix["group_by"], mix["aggs"], T)
    assert set(ans) == {(f, s) for f in "ANR" for s in "FO"}
    af = ans[("A", "F")]          # rows 0 and 2
    assert af["sum_qty"] == 25
    assert af["sum_base_price"] == 40200
    assert af["sum_disc_price"] == (40000 * 95 + 200 * 94) % T          # 3,818,800 mod t
    assert af["sum_charge"] == (40000 * 95 * 108 + 200 * 94 * 102) % T
    assert af["avg_qty"] == (25, 2) and af["avg_disc"] == (11, 2)
    assert af["count_order"] == 2
    no = ans[("N", "O")]          # rows 1 and 4
    assert no["sum_base_price"] == 31000 and no["sum_disc_price"] == (30000 * 90 + 1000 * 93) % T
    assert ans[("A", "O")]["count_order"] == 0      # row 5 is past the cutoff
    assert ans[("R", "O")] == {k: ((0, 0) if k.startswith("avg") else 0) for k in af}


def test_hand_worked_q6():
    mix = traffic.load("tpch_q6_cold")
    where = [("l_shipdate", ">=", 10), ("l_shipdate", "<", 55),
             ("l_discount", "between", (0.05, 0.07)), ("l_quantity", "<", 24)]
    ans = scan_query.answer(HAND, SCALES, where, (), mix["aggs"], T)
    assert ans == {"revenue": (40000 * 5 + 200 * 6) % T}      # rows 0 and 2
    assert scan_query.answer(HAND, SCALES, where, (), mix["aggs"], 1 << 16) == \
        {"revenue": (40000 * 5 + 200 * 6) % (1 << 16)}


def test_mismatches_counts_every_number():
    a = {("A", "F"): {"x": 1, "p": (2, 3)}}
    assert scan_query.mismatches(a, a) == 0
    assert scan_query.mismatches({("A", "F"): {"x": 1, "p": (2, 4)}}, a) == 1
    assert scan_query.mismatches({}, a) == 3
    assert scan_query.mismatches({**a, "extra": 5}, a) == 1


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_tables_are_the_programs_generator(seed):
    from repro_torch.engine import tpch
    mine = tables.generate(SMALL, seed, tables=("lineitem", "orders"))
    theirs = tpch.generate(tpch.Scale(**SMALL), seed)
    for name in mine:
        for col, vals in mine[name].items():
            assert np.array_equal(np.asarray(vals), np.asarray(theirs[name][col])), col


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_reference_equals_the_programs_oracles(seed):
    """The program's numpy oracles over a Mock database of the same raw
    columns agree with the reference at TPC-H's validation parameters."""
    from repro_torch.engine import queries, tpch
    from repro_torch.engine.backend import MockBackend
    from repro_torch.engine.storage import Database
    raw = tables.generate(SMALL, seed)["lineitem"]
    db = Database(MockBackend(device="cpu"))
    db.load_table(tpch.schemas()["lineitem"], raw, SMALL["lineitem"])
    for name, params, oracle in (("tpch_q1_cold", {"DELTA": 90}, queries.oracle_q1),
                                 ("tpch_q6_cold", {"YEAR": 1994, "DISCOUNT": 6, "QUANTITY": 24},
                                  queries.oracle_q6)):
        mix = traffic.load(name)
        where = [(c, op, traffic.resolve(f, params)) for c, op, f in mix["where"]]
        ans = scan_query.answer(raw, SCALES, where, mix.get("group_by", ()), mix["aggs"], T)
        assert ans == oracle(db)


def test_query_control_fails():
    cfg = harness.load_json(ROOT, "nshedb_bench", "configs", "tpch_paper.json")
    cfg["tables"] = SMALL
    for name in ("tpch_q1_cold", "tpch_q6_cold"):
        for seed in (4, 5, 6):
            rec = control.query_control(cfg, traffic.load(name), seed, 2)
            assert rec["answers_wrong"] >= 2, (name, seed, rec)


SMOKE = dict(n=256, k=4, t=257, prime_bits=30, eq_levels=8, rot_steps=7, nblocks=4,
             ks_mode="all_gather")


def test_primes_and_perm_equal_the_programs():
    from repro_torch.configs.nshedb import CONFIG
    from repro_torch.launch import nshedb_step
    from repro_torch.core.mathutil import find_ntt_primes
    assert ref_step.primes(CONFIG.n, 30, CONFIG.k) == find_ntt_primes(CONFIG.n, 30, CONFIG.k)
    c = nshedb_step.make_constants(type(CONFIG)(n=256, k=4, t=257, eq_levels=8, rot_steps=7),
                                   device="cpu")
    assert np.array_equal(c["perm"].numpy(), ref_step.galois_perm(256))


@pytest.mark.parametrize("seed", [0, 2**31 + 1])
def test_scan_reference_equals_the_programs_step(seed):
    from repro_torch.configs.nshedb import NshedbConfig
    from repro_torch.launch import nshedb_step
    cfg = dict(SMOKE)
    dev = torch.device("cpu")
    q, delta, col, val, keys = scan_step.draw_inputs(cfg, seed, dev)
    col_v = col.clone()
    scan_step.minus(col, 17, q, delta, col_v)
    assert bool((col_v < q[:, None]).all()) and bool((col_v >= 0).all())
    consts = nshedb_step.make_constants(
        NshedbConfig(n=256, k=4, t=257, eq_levels=8, rot_steps=7), device="cpu")
    got = nshedb_step.query_step(col_v, val, *keys, consts["tabs"], consts["perm"],
                                 eq_levels=8, rot_steps=7)
    exp = scan_step.reference(cfg, q, delta, col, val, keys, 17)
    assert torch.equal(got, exp)
    low = scan_step.reference(cfg, q, delta, col, val, keys, 17, mulmod="float64")
    assert int((low != exp).sum()) > exp.numel() // 2


def test_scan_control_fails():
    for seed in (7, 8, 9):
        rec = control.scan_control(SMOKE, traffic.load("eq_scan"), seed, torch.device("cpu"))
        assert rec["residues_wrong"] > rec["residues"] // 2
