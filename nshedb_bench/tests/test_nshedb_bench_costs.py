"""The cost files at known shapes: residues at 4 bytes, each input read
once and each output written once."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT) if p not in sys.path]

import re  # noqa: E402

import pytest  # noqa: E402

from nshedb_bench import harness  # noqa: E402

PEAKS = harness.load_json(ROOT, "nshedb_bench", "peaks.json")
COSTS = harness.costs()
N = 32768
BW, INT, TC = PEAKS["hbm_bytes_per_s"], PEAKS["int32_ops_per_s"], PEAKS["int8_tensor_ops_per_s"]


def test_mul_mod_scan_shape_at_4_bytes():
    # the scan's digit products: 16384 rows by 16384, n = 32768
    s = COSTS["mul_mod"].bound_s((16384, 16384), N, PEAKS)
    assert s == pytest.approx(3 * 16384 * N * 4 / BW)          # 1.923 ms, bytes-bound
    assert s == pytest.approx(1.9230e-3, rel=1e-4)


@pytest.mark.parametrize("name,ops", [("add_mod", 3), ("sub_mod", 3), ("mul_mod", 6)])
def test_pointwise_shared_operand_read_once(name, ops):
    # a (30, n) key row block shared by 300 rows is read once
    s = COSTS[name].bound_s((300, 30), N, PEAKS)
    assert s == pytest.approx(max((300 + 30 + 300) * N * 4 / BW, ops * 300 * N / INT))


@pytest.mark.parametrize("name", ["ntt_fwd", "ntt_inv"])
@pytest.mark.parametrize("rows", [30, 150, 4500])
def test_ntt_rows(name, rows):
    s = COSTS[name].bound_s(rows, N, PEAKS)
    ops = 6 * rows * (N // 2) * 15
    assert s == pytest.approx(max(2 * rows * N * 4 / BW, ops / INT))
    assert s == pytest.approx(ops / INT)          # operations bound it at n = 32768


def test_every_kernel_cost_names_its_trace_kernel():
    """Names as the profiler's trace gives them on the card."""
    pw = "void (anonymous namespace)::pointwise_kernel<(anonymous namespace)::{}>(long const*)"
    names = {"mul_mod": pw.format("MulOp"), "add_mod": pw.format("AddOp"),
             "sub_mod": pw.format("SubOp"),
             "ntt_fwd": "void (anonymous namespace)::ntt_fwd_kernel<5>(long const*, long*)",
             "ntt_inv": "void (anonymous namespace)::ntt_inv_kernel<4, 3>(long const*, long*)"}
    for kernel, trace_name in names.items():
        hits = [k for k, c in COSTS.items()
                if hasattr(c, "TRACE") and re.search(c.TRACE, trace_name)]
        assert hits == [kernel]
        assert COSTS[kernel].KERNEL == kernel


def test_scan_step_counted_from_the_algorithm():
    cfg = harness.load_json(ROOT, "nshedb_bench", "configs", "nshedb_scan.json")
    w = COSTS["scan_step"].work(cfg)
    res = 32 * N
    assert w["bytes"] == 4 * (2 * 64 * 2 * res + 4 * 32 * res + 2 * res)   # 1.62 GB
    assert w["macs"] == 64 * 32 * 2 * res * 32                            # 1.37e11
    s = COSTS["scan_step"].step_bound_s(cfg, PEAKS)
    on_tensor = max(w["bytes"] / BW, w["int32_ops"] / INT, 32 * w["macs"] / TC)
    on_lanes = max(w["bytes"] / BW, (w["int32_ops"] + 2 * w["macs"]) / INT)
    assert s == pytest.approx(min(on_tensor, on_lanes))
    assert 1e-3 < s < 30e-3


def test_scan_step_bound_below_its_kernels_bound():
    """The fused step's least time is no more than the least time of the
    unfused kernels' launches at 4 bytes: the step's share can only read
    higher than the kernels' after a fusion, never past 100 %."""
    cfg = harness.load_json(ROOT, "nshedb_bench", "configs", "nshedb_scan.json")
    per_block_digit = COSTS["mul_mod"].bound_s((32 * 16 * 32, 32 * 16 * 32), N, PEAKS)
    switches = 64 * 32 * 2 // 16                 # chunks of 16 blocks, two keys
    assert COSTS["scan_step"].step_bound_s(cfg, PEAKS) < switches * per_block_digit
