"""repro_torch.engine — NSHEDB's scan-first encrypted query engine.

Layers:
  backend   duck-typed HE ops: BFVBackend (real ciphertexts) and
            MockBackend (Z_t arrays + identical noise/op accounting;
            kernel_reduce=True sends sum_slots to the rotate_reduce kernel)
  schema    column types, dictionary encoding, fixed-point decimals
  storage   encrypted columnar tables (packed ciphertext blocks)
  ops       physical scan-first operators (masks, aggregates, join, ...)
  plan      logical plan nodes (incl. Translated/AuxMask join forms) +
            the Table-3 depth model
  planner   noise-aware rewrites R1/R2/R3 + the i* injection cost model,
            CSE mask cache, memoized group/sort EQ masks
  physical  logical->physical lowering: CmpAtoms, CSE keys, cross-mask
            circuit fusion (DESIGN.md §7)
  executor  run_via_plan: scheduled operator-DAG execution + ExecReport
            asserted against the planner's predictions
  verify    static plan verification before any ciphertext work
            (`python -m repro_torch.engine.verify`)
  workload  the noise-aware mask cache + run_workload, the cross-query
            scheduler
  sharded   logical shard contexts: lane / limb padding, the 2-D cost
            ledger, elastic re-sharding (one device; no collectives yet)
  tpch      TPC-H datagen + plaintext oracle
  queries   the paper's nine benchmark queries (Q1,4,5,6,8,12,14,17,19);
            Q1/Q6/Q12/Q19 also execute through the compiled DAG
  baseline  HE3DB / ArcEDB cost models, measured per-op costs and the
            NSHEDB timing model
"""
from .backend import BFVBackend, MockBackend, OpStats  # noqa: F401
from .executor import ExecReport, run_via_plan  # noqa: F401
