"""The key switch's cost file (costs/keyswitch.py): counted as
costs/scan_step.py counts a switch, at or above the step's own bound, and
its TRACE matching the keyswitch kernel alone."""
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


def test_keyswitch_counted_as_the_scan_step_counts_a_switch():
    """One 64-block, 32 x 32 key switch at n = 32768: digits, both keys
    and both outputs at 4 bytes, 2 x 64 x 32 x 32 x n multiply-accumulates
    on the faster unit, one reduction a key an output residue."""
    s = COSTS["keyswitch"].bound_s((64, 32, 32), N, PEAKS)
    nbytes = 4 * N * (64 * 32 + 2 * 32 * 32 + 2 * 64 * 32)               # 1.07 GB
    macs = 2 * 64 * 32 * 32 * N                                         # 4.3 G
    red = 6 * 2 * 64 * 32 * N
    on_lanes = max(nbytes / BW, (red + 2 * macs) / INT)
    on_tensor = max(nbytes / BW, red / INT, 32 * macs / TC)
    assert s == pytest.approx(min(on_lanes, on_tensor))
    assert s == pytest.approx(nbytes / BW)                               # 0.32 ms, bytes-bound
    assert COSTS["keyswitch"].KERNEL == "keyswitch"


def test_scan_step_bound_at_or_under_its_keyswitch_bounds():
    """The whole step's least time is no more than the least time of a
    query's key switches alone (32 of them at one 64-block pass, ~10 ms
    against ~4 ms): the step's share stays at or under what its kernels'
    shares allow."""
    cfg = harness.load_json(ROOT, "nshedb_bench", "configs", "nshedb_scan.json")
    per_switch = COSTS["keyswitch"].bound_s((cfg["nblocks"], cfg["k"], cfg["k"]), N, PEAKS)
    switches = cfg["eq_levels"] + 1 + cfg["rot_steps"]
    assert COSTS["scan_step"].step_bound_s(cfg, PEAKS) <= switches * per_switch
    assert switches * per_switch == pytest.approx(10.26e-3, rel=1e-3)


def test_keyswitch_trace_names_its_kernel_alone():
    """The key switch's TRACE matches the kernel's names as the profiler
    gives them (int64 and int32 digits), and no other cost file's TRACE
    does; it matches none of the other kernels' names."""
    ks = [f"void (anonymous namespace)::keyswitch_kernel<{t}>({t} const*, long const*, "
          "long const*, long*, unsigned int const*, unsigned long const*, long long, int, "
          "int, int, int)" for t in ("long", "int")]
    pw = "void (anonymous namespace)::pointwise_kernel<(anonymous namespace)::{}>(long const*)"
    others = [pw.format(op) for op in ("MulOp", "AddOp", "SubOp")] + [
        "void (anonymous namespace)::ntt_fwd_kernel<5>(long const*, long*)",
        "void (anonymous namespace)::ntt_inv_kernel<4, 3>(long const*, long*)",
        "base_conv_kernel", "ncclDevKernel_AllGather_RING_LL"]
    for name in ks:
        assert [k for k, c in COSTS.items()
                if hasattr(c, "TRACE") and re.search(c.TRACE, name)] == ["keyswitch"]
    assert not any(re.search(COSTS["keyswitch"].TRACE, name) for name in others)
