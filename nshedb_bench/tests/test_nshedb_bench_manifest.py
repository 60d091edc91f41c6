"""BENCHMARK.json against the contract's limits, and every name it gives
found as a file of its own."""
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT) if p not in sys.path]

import pytest  # noqa: E402

from nshedb_bench import harness  # noqa: E402

M = harness.load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRICS = M["end_to_end"] + M["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(M) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) for p in M["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert any(w.startswith(M["paths"][0] + "/") for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    r = M["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [x["name"] for x in M["configs"] + M["workloads"] + METRICS]
    names += [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]
    names += [k for c in M["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for group in (M["configs"], M["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_entries_have_just_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert _line(w["why"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def test_cells_and_configurations():
    cfgs = {c["name"]: c for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs) and 1 <= len(pairs) <= 24
    assert {w["config"] for w in M["workloads"]} == set(cfgs)
    assert len({c["file"] for c in M["configs"]}) == len(cfgs)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(pairs) // 4)
    for c in cfgs.values():
        assert c["file"].startswith(M["paths"][0] + "/")
        data = harness.load_json(ROOT, c["file"])
        assert data["name"] == c["name"] and data["source"] and data["guarantees"]
        assert set(c["reduced"]) <= set(data) and data["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, "nshedb_bench", "systems", data["system"] + ".py"))
    for w in M["workloads"]:
        assert os.path.isfile(os.path.join(ROOT, "nshedb_bench", "traffic", w["traffic"] + ".json"))


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_what_the_contract_asks(cell):
    e2e = {m["name"] for m in harness.cell_metrics(M, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(M, cell, True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_every_metric_has_a_reader_and_moves_a_reported_metric():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in METRICS:
        assert os.path.isfile(os.path.join(ROOT, "nshedb_bench", "metrics", m["name"] + ".py")), m
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", []):
            assert c in cells and c in e2e[m["moves"]].get("workloads", [c])
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in METRICS:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
