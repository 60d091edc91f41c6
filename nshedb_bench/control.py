"""The controls of `correct`: the plain reference put in the program's
place, computed below the precision the configuration states, on the
cell's own inputs at the cell's own size, scored as the benchmark scores
the program.

    python3 nshedb_bench/control.py --workload <cell> --seeds 11 12 13 [--queries N]

Query cells: the answers of the window's first `--queries` queries with
every number at 16 bits (sums wrap at 2^16 instead of reducing mod
t = 65537, the plaintext modulus of 17 bits) against the exact answers:
`answers_wrong`.  The scan cell: the sampled query's aggregate with each
residue product rounded to float64's 53 bits (the product of two 30-bit
residues needs 60) against the exact one: `residues_wrong`.  The program
does not run.  Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CONTROL_MODULUS = 1 << 16


def query_control(cfg: dict, mix: dict, seed: int, queries: int) -> dict:
    from nshedb_bench import tables, traffic
    from nshedb_bench.reference import scan_query

    fact = mix["fact"]
    raw = tables.generate(cfg["tables"], seed, tables=(fact,))[fact]
    wrong = 0
    for i in range(queries):
        where = traffic.query(mix, seed, "window", i)["where"]
        args = (raw, cfg["decimal_scales"], where, mix.get("group_by", ()), mix["aggs"])
        wrong += scan_query.mismatches(scan_query.answer(*args, CONTROL_MODULUS),
                                       scan_query.answer(*args, cfg["t"]))
    return {"answers_wrong": wrong, "queries": queries}


def scan_control(cfg: dict, mix: dict, seed: int, device) -> dict:
    from nshedb_bench import traffic
    from nshedb_bench.systems import scan_step

    q, delta, col, val, keys = scan_step.draw_inputs(cfg, seed, device)
    v = traffic.query(mix, seed, "window", 0)["params"]["EQ_CONST"]
    exact = scan_step.reference(cfg, q, delta, col, val, keys, v)
    low = scan_step.reference(cfg, q, delta, col, val, keys, v, mulmod="float64")
    return {"residues_wrong": int((low != exact).sum()), "residues": exact.numel()}


def main(argv=None) -> int:
    import torch

    from nshedb_bench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--queries", type=int, default=3)
    args = ap.parse_args(argv)
    cell, cfg, mix = harness.cell_spec(harness.load_json(ROOT, "BENCHMARK.json"), args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cfg["system"] == "scan_step":
            rec = scan_control(cfg, mix, seed, device)
        else:
            rec = query_control(cfg, mix, seed, args.queries)
        rec.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0,
                   device=torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu")
        print(json.dumps({"control": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
