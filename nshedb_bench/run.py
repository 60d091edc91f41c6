"""Entry point: `python3 nshedb_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout (or `python -m
nshedb_bench.run` there).  Puts the checkout and its `src/` on the path;
see harness.py for what a run does."""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

if __name__ == "__main__":
    from nshedb_bench import harness
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
