"""keyswitch (kernels/modops, csrc/modops.cu): for every block b, output
limb j and coefficient c, and for both keys K,
out_j[b, c] = sum_i d_i[b, c] * K[i, j, c] mod q_j, at the shape
(blocks, kd, kj) of (blocks, kd, n) digits and (kd, kj, n) keys.

Least work, counted as costs/scan_step.py counts a key switch: the digits,
both keys and both outputs each read or written once, every residue at 4
bytes (each prime is below 2^31); the kd digit products of an output
residue are multiply-accumulates with lazy reduction, on the faster of
the int32 lanes at 2 operations each (a wide multiply-add) and the int8
tensor cores at 32 (each residue split into 4 bytes, 16 byte products of
2 operations); one reduction (6 operations, costs/mul_mod.py) a key an
output residue on the int32 lanes.  The least time is the largest of the
resources' times, as if they all overlapped.
"""
KERNEL = "keyswitch"
TRACE = r"keyswitch_kernel<"


def bound_s(shape, n, peaks) -> float:
    blocks, kd, kj = shape
    nbytes = 4 * n * (blocks * kd + 2 * kd * kj + 2 * blocks * kj)
    macs = 2 * blocks * kj * kd * n
    reductions = 6 * 2 * blocks * kj * n
    mem_s = nbytes / peaks["hbm_bytes_per_s"]
    lanes_s = reductions / peaks["int32_ops_per_s"]
    on_lanes = max(mem_s, lanes_s + 2 * macs / peaks["int32_ops_per_s"])
    on_tensor = max(mem_s, lanes_s, 32 * macs / peaks["int8_tensor_ops_per_s"])
    return min(on_lanes, on_tensor)
