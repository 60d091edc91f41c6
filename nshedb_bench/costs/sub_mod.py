"""sub_mod (kernels/modops, csrc/modops.cu): out = a - b mod q_j, for a of
(rows_a, n) residues and b of (rows_b, n), b repeating down a's rows.

Least work: a and b read once, out written once, every residue at 4
bytes; 3 integer operations an output residue (subtract, add q, min).
"""
KERNEL = "sub_mod"
TRACE = r"pointwise_kernel<.*SubOp>"


def bound_s(shape, n, peaks) -> float:
    rows_a, rows_b = shape
    nbytes = 4 * n * (2 * rows_a + rows_b)
    ops = 3 * rows_a * n
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["int32_ops_per_s"])
