"""repro_torch.engine — NSHEDB's scan-first encrypted query engine.

Layers:
  backend   duck-typed HE ops: BFVBackend (real ciphertexts) and
            MockBackend (Z_t arrays + identical noise/op accounting)
  schema    column types, dictionary encoding, fixed-point decimals
  storage   encrypted columnar tables (packed ciphertext blocks)
  ops       physical scan-first operators (masks, aggregates, join, ...)
  plan      logical plan nodes + the Table-3 depth model
  planner   noise-aware rewrites R1/R2/R3 + the i* injection cost model,
            CSE mask cache, memoized group/sort EQ masks
  physical  logical->physical lowering: CmpAtoms, CSE keys, cross-mask
            circuit fusion
  workload  the noise-aware mask cache
  sharded   the shard-context activation hook (single-device only so far)
  tpch      TPC-H datagen + plaintext oracle
  queries   TPC-H Q6: plan, encrypted run, plaintext oracle
"""
from .backend import BFVBackend, MockBackend, OpStats  # noqa: F401
