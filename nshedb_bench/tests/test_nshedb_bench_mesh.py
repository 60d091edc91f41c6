"""The four-card scan cell (`scan_8m_mesh4`, systems/scan_step_mesh.py)
through the harness on the CPU at a small size, its ranks gloo ranks of
this host started by the program's launcher: a sound run is correct and
its root spans carry the collectives' bytes, a run with one residue of
rank 1's shard changed is not correct, and a program without the
launcher fails before it starts a rank.  Then the collectives' cost file
and the cell's readers on made-up device records and program spans."""
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT) if p not in sys.path]

import multiprocessing  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from nshedb_bench import harness, traffic  # noqa: E402
from nshedb_bench.trace import Trace  # noqa: E402
from repro_torch.runtime.tracing import Span  # noqa: E402

MANIFEST = harness.load_json(ROOT, "BENCHMARK.json")
CELL = "scan_8m_mesh4"
COST = harness.costs()["collectives"]
PEAKS = harness.load_json(ROOT, "nshedb_bench", "peaks.json")


def mesh_cfg():
    cfg = harness.load_json(ROOT, "nshedb_bench", "configs", "nshedb_scan_mesh4.json")
    cfg.update(n=256, k=4, t=257, eq_levels=8, rot_steps=7, nblocks=8)
    return cfg


def mesh_run(hook=None, trace=False):
    mix = dict(traffic.load("eq_scan"), check_sample=2)
    return harness.execute(MANIFEST, CELL, 2**40 + 7, 0.3, trace, device="cpu",
                           config=mesh_cfg(), mix=mix, hook=hook)


def corrupt(scan, rank: int):
    """Rank `rank` adds one to one residue of its column shard."""
    if scan.rank == rank:
        scan.col[0, 0, 0, 0] = (scan.col[0, 0, 0, 0] + 1) % scan.local.q[0]


def test_sound_run_is_correct_and_counts_its_collectives():
    rec, run = mesh_run(trace=True)
    assert rec["correct"] and rec["checks"] == {"residues_wrong": {"value": 0, "limit": 0}}
    assert rec["attempted"] == len(run.queries) >= 2 and rec["failed"] == 0
    assert rec["device"]["count"] == 4 and run.facts["rows_per_query"] == 8 * 256
    # a rank's 4 blocks through 16 key switches, each all-gathering its
    # (4, 4, 256) digits over "model" as int32; the (2, 2, 256) sum over
    # "data"; the (2, 4, 256) answer gathered over "model"
    per_query = 16 * 4 * 4 * 256 * 4 + 2 * 2 * 256 * 8 + 2 * 4 * 256 * 8
    assert rec["metrics"]["collective_gb_per_query.mesh"]["value"] == pytest.approx(per_query / 1e9)
    assert "scan_rows_per_s" not in rec["metrics"]          # per-layer metrics when traced
    assert not multiprocessing.active_children()


def test_one_residue_changed_on_rank_1_is_not_correct():
    rec, _ = mesh_run(hook=lambda sut: sut.loop.run(f"{__name__}:corrupt", 1))
    assert not rec["correct"] and rec["checks"]["residues_wrong"]["value"] > 0
    assert rec["failed"] >= 1
    assert not multiprocessing.active_children()


def test_a_program_without_the_launcher_fails_before_any_rank(monkeypatch):
    import repro_torch.launch as launch
    monkeypatch.setitem(sys.modules, "repro_torch.launch.ranks", None)
    monkeypatch.delattr(launch, "ranks", raising=False)
    with pytest.raises(ImportError):
        mesh_run()
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("kind,ranks,result,received", [
    ("all-gather", 2, 1000, 500), ("all-gather", 4, 1000, 750), ("all-reduce", 2, 1000, 1000),
    ("reduce-scatter", 2, 1000, 1000), ("all-gather", 1, 1000, 0)])
def test_collective_bound_from_the_bytes_a_rank_receives(kind, ranks, result, received):
    assert COST.received_bytes(kind, result, ranks) == received
    assert COST.bound_s(kind, result, ranks) == pytest.approx(received / 450e9)
    with pytest.raises(ValueError):
        COST.bound_s("all-to-all", result, 2)


NCCL = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
MUL = "void (anonymous namespace)::pointwise_kernel<(anonymous namespace)::MulOp>(long const*)"


def _run(trace=True):
    """Device busy [0, 40) NCCL and [40, 100) MulOp in a window [0, 200]; one
    query of two all-gathers of 900 B over 2 ranks and an all-reduce of
    90 B over 2, and a query that opened before the window."""
    events = (np.array([0, 40], dtype=np.int64), np.array([40, 100], dtype=np.int64),
              np.array([0, 1], dtype=np.int64), [NCCL, MUL])
    root = Span(1, 0, 1, "query", 5, 150, {"plan": "scan_mesh", "all-gather": 1800,
                                           "all-reduce": 90, "reduce-scatter": 0})
    inner = [Span(2, 1, 1, "coll.all-gather", 6, 7, {"axis": "model", "ranks": 2, "bytes": 900}),
             Span(3, 1, 1, "coll.all-gather", 8, 9, {"axis": "model", "ranks": 2, "bytes": 900}),
             Span(4, 1, 1, "coll.all-reduce", 10, 11, {"axis": "data", "ranks": 2, "bytes": 90})]
    early = [Span(5, 0, 5, "query", -50, -10, {"all-gather": 7}),
             Span(6, 5, 5, "coll.all-gather", -40, -30, {"axis": "model", "ranks": 2,
                                                          "bytes": 7})]
    return types.SimpleNamespace(
        trace=Trace(events, 0, 200, []) if trace else None, costs=harness.costs(),
        facts={"window_start_ns": 0, "trace_end_ns": 200, "program_spans": inner + [root] + early,
               "peak_window_bytes": 0, "launches_by_shape": {}},
        queries=[], config={"n": 256}, peaks=PEAKS)


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_collective_readers():
    run = _run()
    assert read("collective_share.mesh", run) == pytest.approx(100 * 40 / 100)
    bound = (450 + 450 + 90) / 450e9
    assert read("collective_roofline.mesh", run) == pytest.approx(100 * bound / 40e-9)
    assert read("collective_gb_per_query.mesh", run) == pytest.approx(1890 / 1e9)
    assert read("idle_share.mesh", run) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["collective_share.mesh", "collective_roofline.mesh",
                                  "collective_gb_per_query.mesh", "limb_kernels_roofline.mesh",
                                  "idle_share.mesh", "peak_mem_gb.mesh",
                                  "scan_step_roofline.mesh"])
def test_readers_find_nothing_untraced(name):
    run = _run(trace=False)
    run.facts.pop("program_spans")
    assert read(name, run) is None


def test_a_ranks_scan_step_bound_is_its_digit_gather_at_the_link():
    """At the cell's configuration a rank does scan_2m's digit products
    (128 blocks x 16 output limbs x 32 digits = 64 x 32 x 32), and its
    least time is the link's: 4,096 key switches each receiving half of
    a (32, 32768) digit gather at 4 bytes, the (2, 16, n) sum over
    "data" and half of the (2, 32, n) answer, at 450 GB/s."""
    cost = harness.costs()["scan_step_mesh"]
    cfg = harness.load_json(ROOT, "nshedb_bench", "configs", "nshedb_scan_mesh4.json")
    one = harness.load_json(ROOT, "nshedb_bench", "configs", "nshedb_scan.json")
    assert cost.work(cfg)["macs"] == harness.costs()["scan_step"].work(one)["macs"]
    n = 32768
    link = (4096 * 32 * n * 4 / 2 + 2 * 16 * n * 4 + 2 * 32 * n * 4 / 2) / 450e9
    assert cost.rank_bound_s(cfg, PEAKS, COST) == pytest.approx(link)
    with pytest.raises(ValueError, match="ks_mode"):
        cost.rank_bound_s(dict(cfg, ks_mode="reduce_scatter"), PEAKS, COST)


def test_scan_step_roofline_reader():
    cfg = harness.load_json(ROOT, "nshedb_bench", "configs", "nshedb_scan_mesh4.json")
    run = _run()
    assert read("scan_step_roofline.mesh", run) is None          # no query in the window
    run.queries = [{}, {}]
    assert read("scan_step_roofline.mesh", run) is None          # not a mesh configuration
    run.config = cfg
    bound = harness.costs()["scan_step_mesh"].rank_bound_s(cfg, PEAKS, COST)
    assert read("scan_step_roofline.mesh", run) == pytest.approx(100 * 2 * bound / 100e-9)
