"""ntt_fwd (kernels/ntt, csrc/ntt.cu): the forward negacyclic NTT of each
of `rows` rows of n residues.

Least work: the rows read once and written once at 4 bytes a residue
(the twiddle tables not counted: they can be computed on the fly); n/2
log2 n butterflies a row at 6 integer operations each — a Shoup product
(one high and two low multiplies) and three lazily reduced adds and
subtracts, the fewest a butterfly takes.
"""
KERNEL = "ntt_fwd"
TRACE = r"ntt_fwd_kernel"


def bound_s(shape, n, peaks) -> float:
    rows = shape
    nbytes = 8 * rows * n
    ops = 6 * rows * (n // 2) * (n.bit_length() - 1)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["int32_ops_per_s"])
