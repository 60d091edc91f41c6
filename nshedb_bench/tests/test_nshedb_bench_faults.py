"""The harness driven on the CPU at small sizes, past its look for a
chip: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct — once for each fault a cell
can have: a step that returns its state unchanged, half of the batch
left out (the rest counted double), an answer altered where it is
produced.  (One chip: no exchange between chips to leave out.)"""
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT) if p not in sys.path]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from nshedb_bench import harness, traffic  # noqa: E402

MANIFEST = harness.load_json(ROOT, "BENCHMARK.json")


def scan_cfg():
    cfg = harness.load_json(ROOT, "nshedb_bench", "configs", "nshedb_scan.json")
    cfg.update(n=256, k=4, t=257, eq_levels=8, rot_steps=7, nblocks=4)
    return cfg


def query_cfg():
    cfg = harness.load_json(ROOT, "nshedb_bench", "configs", "tpch_paper.json")
    cfg.update(n=256)
    cfg["tables"] = dict(lineitem=256, orders=64, customer=12, supplier=6, part=16, partsupp=24)
    return cfg


def scan_run(hook=None, trace=False):
    mix = dict(traffic.load("eq_scan"), check_sample=2)
    return harness.execute(MANIFEST, "scan_2m", 2**31 + 99, 1.5, trace, device="cpu",
                           config=scan_cfg(), mix=mix, hook=hook)


def _step_fault(kind):
    def hook(sut):
        real = sut.step

        def query_step(col, val, *args, **kw):
            if kind == "unchanged":
                return col[0].clone()
            if kind == "half":
                half = col.shape[0] // 2
                out = real.query_step(col[:half], val[:half], *args, **kw)
                return (2 * out) % sut.q[:, None]
            out = real.query_step(col, val, *args, **kw)
            out[0, 0, 0] = (out[0, 0, 0] + 1) % sut.q[0]
            return out

        sut.step = types.SimpleNamespace(query_step=query_step)
        if kind == "half":
            sut.chunk = min(sut.chunk, sut.cfg["nblocks"] // 2)
    return hook


def test_scan_sound_run_is_correct():
    rec, run = scan_run(trace=True)
    assert rec["correct"] and rec["checks"] == {"residues_wrong": {"value": 0, "limit": 0}}
    assert rec["attempted"] == len(run.queries) >= 2 and rec["failed"] == 0
    assert list(rec)[-1] == "checks"
    assert set(rec["device"]) >= {"platform", "kind", "count", "memory_peak_bytes",
                                  "busy_s", "window_s"}


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_scan_fault_is_not_correct(kind):
    rec, _ = scan_run(_step_fault(kind))
    assert not rec["correct"] and rec["checks"]["residues_wrong"]["value"] > 0
    assert rec["failed"] >= 1


def query_run(hook=None):
    mix = dict(traffic.load("tpch_q6_cold"), warmup=0)
    return harness.execute(MANIFEST, "q6_paper", 2**31 + 5, 0.0, False, device="cpu",
                           config=query_cfg(), mix=mix, hook=hook)


def _answer_altered(sut):
    real = sut.bk.decrypt

    def decrypt(ct):
        out = np.array(real(ct))
        out[0] = (out[0] + 1) % sut.bk.t
        return out

    sut.bk.decrypt = decrypt


@pytest.fixture
def half_rows(monkeypatch):
    """Every mask keeps only the first half of the table's rows, counted
    double: the sums see half of the batch."""
    from repro_torch.engine import ops
    real = ops.apply_validity

    def apply_validity(bk, mask, table):
        v = np.zeros(bk.slots, dtype=np.int64)
        v[: table.nrows // 2] = 2
        return [bk.mul_plain(b, v) for b in real(bk, mask, table)]

    monkeypatch.setattr(ops, "apply_validity", apply_validity)


def test_query_sound_run_is_correct():
    rec, run = query_run()
    assert rec["correct"] and rec["checks"]["answers_wrong"]["value"] == 0
    assert rec["attempted"] == 1 and run.queries[0]["launches"] > 0
    assert rec["metrics"]["storage_x"]["value"] == pytest.approx(2 * 30 * 8 / 2)


def test_query_answer_altered_is_not_correct():
    rec, _ = query_run(_answer_altered)
    assert not rec["correct"] and rec["checks"]["answers_wrong"]["value"] >= 1


def test_query_half_the_rows_is_not_correct(half_rows):
    rec, _ = query_run()
    assert not rec["correct"] and rec["checks"]["answers_wrong"]["value"] >= 1


def test_no_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would not refuse")
    rc = harness.main(["--workload", "scan_2m", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
