"""repro_torch.core — RNS-BFV leveled homomorphic encryption on torch tensors.

Parameter sets, negacyclic NTT, the BFV scheme with HPS RNS
multiplication, batch encoding, noise accounting, and the arithmetic
comparison circuits (Fermat equality, BSGS range).  All residue
arithmetic is exact in `torch.int64`.
"""
from .params import HEParams, make_params, paper_params, small_params, test_params  # noqa: F401
