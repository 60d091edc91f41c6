"""mul_mod (kernels/modops, csrc/modops.cu): out = a * b mod q_j, for a of
(rows_a, n) residues and b of (rows_b, n), b repeating down a's rows.

Least work: a and b read once, out written once, every residue at 4
bytes (each prime is below 2^31); 6 integer operations an output residue
— a Montgomery product's three multiplies (the wide a * b counting two),
a subtraction and one conditional correction — the fewest that reduce a
product of two 31-bit residues.
"""
KERNEL = "mul_mod"
TRACE = r"pointwise_kernel<.*MulOp>"


def bound_s(shape, n, peaks) -> float:
    rows_a, rows_b = shape
    nbytes = 4 * n * (2 * rows_a + rows_b)
    ops = 6 * rows_a * n
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["int32_ops_per_s"])
