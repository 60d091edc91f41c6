"""ntt_inv (kernels/ntt, csrc/ntt.cu): the inverse negacyclic NTT, with
its scaling by 1/n, of each of `rows` rows of n residues.

Least work: the rows read once and written once at 4 bytes a residue
(the twiddle tables not counted: they can be computed on the fly); n/2
log2 n butterflies a row at 6 integer operations each — a Shoup product
(one high and two low multiplies) and three lazily reduced adds and
subtracts, the fewest a butterfly takes (the scaling folds into the
last stage's twiddles).
"""
KERNEL = "ntt_inv"
TRACE = r"ntt_inv_kernel"


def bound_s(shape, n, peaks) -> float:
    rows = shape
    nbytes = 8 * rows * n
    ops = 6 * rows * (n // 2) * (n.bit_length() - 1)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["int32_ops_per_s"])
