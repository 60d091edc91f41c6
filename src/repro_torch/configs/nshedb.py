"""The paper's own workload as a dry-run "architecture".

A distributed encrypted table scan: EQ-mask (16-level Fermat square
chain with per-level relinearization) + mask multiply + rotate-reduce
aggregation over packed RNS-BFV ciphertext blocks.

Distribution (DESIGN.md §4): ciphertext blocks (table row-segments)
shard over (pod, data) — scan-first is embarrassingly parallel across
segments; RNS limbs shard over model.  Key-switching needs every digit
of the target polynomial on every limb shard -> all-gather over model;
the final aggregate psums over (pod, data).  That digit all-gather is
the collective-bound part of the workload and hillclimb target #3.

k = 32 limbs (instead of SEAL's 30) so limbs divide the 16-way model
axis: logQ ~ 32 x 27.6 = 883 bits — the same HE-standard 128-bit budget
as the paper's logQ = 881 (DESIGN.md §3 hardware-adaptation table).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NshedbConfig:
    name: str = "nshedb"
    n: int = 32768            # ring degree (slots per ciphertext)
    k: int = 32               # RNS limbs (divisible by model=16)
    t: int = 65537
    eq_levels: int = 16       # ceil(log2(t-1)) square chain
    rot_steps: int = 15       # log2(n/2) rotate-reduce


CONFIG = NshedbConfig()

# shape cells for the paper workload: blocks = table segments of 32768
# rows each (SF~30 lineitem = 200M rows ~ 6144 blocks).
#   _pagg: partial aggregation (perf iteration #3a) — stop the
#          rotate-reduce at chunk 32 (5 hops instead of 15); the client
#          combines n/32 exact partials.  10 fewer key-switches/block.
#   _rs:   key-switch products constrained digit-local + tree-reduced
#          (reduce-scatter formulation) instead of digit all-gather.
SHAPES = {
    "scan_2m": dict(nblocks=64),       # 2.1M rows  — one block per device
    "scan_33m": dict(nblocks=1024),    # 33.6M rows — 32 blocks per shard
    "scan_33m_pagg": dict(nblocks=1024, rot_steps=5),
    "scan_33m_rs": dict(nblocks=1024, ks_mode="reduce_scatter"),
}


def smoke() -> NshedbConfig:
    return NshedbConfig(name="nshedb-smoke", n=256, k=4, t=257,
                        eq_levels=8, rot_steps=7)
