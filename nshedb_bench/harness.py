"""Run one cell of the benchmark once and print its result line.

    python3 nshedb_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in `BENCHMARK.json`, its
configuration in the file the manifest gives it (`configs/`), its traffic
mix in `traffic/<traffic>.json`, the module that runs the configuration's
system in `systems/<system>.py`, each metric's reader in
`metrics/<metric>.py` and each kernel's cost in `costs/`.

A run: set-up (imports, the kernel libraries, the system's set-up with
its warm-up) is timed from the start of the process; then queries run
back to back from the window's start, none starting after `--seconds`,
each ending in a device synchronize; the window ends when the last one
ends.  With `--trace 1` the window runs under the profiler and the
per-layer metrics are read from it; with `--trace 0` the end-to-end
metrics are.  After the window the program's state is freed and the
system compares what the timed queries produced with the plain
reference.  The last line of standard output is the result; the last
lines of standard error are the numbers compared beside their limits.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names a run may not load: JAX, Flax and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """A run that cannot give a result (no card, a forbidden import)."""


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`nshedb_bench/<kind>/<name>.py` (a name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise RunError(f"no {kind} file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(f"nshedb_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def costs() -> dict:
    """Every cost file of `costs/`, by name."""
    return {f[:-3]: load_module("costs", f[:-3])
            for f in sorted(os.listdir(os.path.join(HERE, "costs"))) if f.endswith(".py")}


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cell_spec(manifest: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of `workload`."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise RunError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(ROOT, entry["file"])
    mix = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    return cell, config, mix


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: end-to-end ones untraced,
    per-layer ones traced; an entry with a `workloads` list names its
    cells, one without it every cell that reports what it moves."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m["workloads"] or ("workloads" not in m and m["moves"] in moved)]


class Run:
    """What a run measured, as the metric readers read it."""

    def __init__(self, cell, config, mix, seed, seconds):
        self.cell, self.config, self.mix = cell, config, mix
        self.seed, self.seconds = seed, seconds
        self.setup_s = None
        self.window_s = None
        self.queries = []          # per query: start_ns, end_ns, and the system's fields
        self.facts = {}            # the system's counts and readings
        self.trace = None          # trace.Trace of a traced run
        self.peaks = load_json(HERE, "peaks.json")
        self.costs = costs()


def window(sut, run: Run, tracer=None) -> None:
    """Queries back to back, none starting after `run.seconds`; the window
    ends when the last one ends (each ends in a synchronize).  A tracer
    covers the first `trace_queries` of them (the mix's; all when it has
    none): reading the trace of a query of a million device operations
    takes the host about a minute."""
    import torch

    limit = run.mix.get("trace_queries")
    tracing = tracer is not None
    if tracing:
        tracer.__enter__()
    try:
        if sut.device.type == "cuda":
            torch.cuda.synchronize(sut.device)
        sut.before_window()
        t0, t0_ns = time.perf_counter(), time.time_ns()
        while not run.queries or time.perf_counter() - t0 < run.seconds:
            run.queries.append(sut.query(len(run.queries)))
            if tracing and len(run.queries) == limit:
                run.facts["trace_end_ns"] = time.time_ns()
                run.facts["launches_by_shape"] = sut.launches_by_shape()
                tracing = False
                tracer.__exit__(None, None, None)
        run.window_s = time.perf_counter() - t0
        run.facts["window_start_ns"], run.facts["window_end_ns"] = t0_ns, time.time_ns()
    finally:
        if tracing:
            tracer.__exit__(None, None, None)
    run.facts.setdefault("trace_end_ns", run.facts["window_end_ns"])
    run.facts.setdefault("launches_by_shape", sut.launches_by_shape())
    sut.after_window(run)


def read_metrics(entries: list, run: Run) -> dict:
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(manifest: dict, workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float | None = None, config=None, mix=None,
            hook=None) -> tuple[dict, Run]:
    """One run of `workload`: (the result record, what it measured).
    `config` and `mix` replace the cell's configuration and traffic, and
    `hook(system)` may change the system under test before the window
    (all three for the tests)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, mix_ = cell_spec(manifest, workload)
    cfg, mix = config or cfg, mix or mix_
    run = Run(cell, cfg, mix, seed, seconds)
    t_system = time.perf_counter()
    sut = load_module("systems", cfg["system"]).System(cfg, mix, seed, torch.device(device), trace)
    if hook is not None:
        hook(sut)
    on_card = sut.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(sut.device)
    run.setup_s = time.perf_counter() - t_start
    run.facts["setup_parts"] = {"before_system": t_system - t_start, **sut.setup_parts}
    setup_peak = torch.cuda.max_memory_allocated(sut.device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(sut.device)
    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer(sut.device)
    window(sut, run, tracer)
    run.facts["peak_window_bytes"] = (torch.cuda.max_memory_allocated(sut.device)
                                      if on_card else 0)
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded that a run may not load: {found}")
    if tracer is not None:
        from .trace import Trace
        spans = [s for q in run.queries for s in q.get("spans", ())]
        events = tracer.device_events()
        t0 = time.perf_counter()
        run.trace = Trace(events, run.facts["window_start_ns"], run.facts["trace_end_ns"], spans)
        run.facts["trace_seconds"] = dict(tracer.seconds, reduce=time.perf_counter() - t0,
                                          operations=len(run.trace.starts))
        del tracer
    sut.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = sut.check(run)
    metrics = read_metrics(cell_metrics(manifest, workload, trace), run)
    correct = all(v <= lim for v, lim in checks.values()) and bool(run.queries)
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(sut.device) if on_card else "cpu",
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": int(max(setup_peak, run.facts["peak_window_bytes"]))}
    rec = {"correct": bool(correct), "attempted": len(run.queries), "failed": int(failed),
           "metrics": metrics, "device": device_rec}
    if run.trace is not None:
        device_rec["busy_s"] = run.trace.busy_s()
        device_rec["window_s"] = run.trace.window_s
        rec["breakdown"] = {"device_ops": [[k, v] for k, v in run.trace.by_name()[:10]],
                            "idle_gaps": [[k, v] for k, v in run.trace.idle_by_label()[:10]]}
    rec["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return rec, run


def _env() -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ["USE_FLAX"] = "0"


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    try:
        manifest = load_json(ROOT, "BENCHMARK.json")
        cell, _, _ = cell_spec(manifest, args.workload)
        import torch
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < int(cell["chips"]):
            raise RunError(f"the cell needs {cell['chips']} CUDA device(s); torch sees {cards}")
        rec, run = execute(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=t_start)
        found = forbidden_modules()
        if found:
            raise RunError(f"modules loaded that a run may not load: {found}")
    except RunError as e:
        print(f"nshedb_bench: {e}", file=sys.stderr, flush=True)
        return 2
    secs = [(q["end_ns"] - q["start_ns"]) / 1e9 for q in run.queries]
    print(f"set-up {run.setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.facts.get("setup_parts", {}).items()), file=sys.stderr)
    print(f"queries in the window: {len(run.queries)} in {run.window_s:.3f} s; each "
          + " ".join(f"{s:.3f}" for s in secs), file=sys.stderr)
    if "trace_seconds" in run.facts:
        print("trace: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                    for k, v in run.facts["trace_seconds"].items()),
              file=sys.stderr)
    for name, c in rec["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(rec), flush=True)
    return 0
