"""The traced run's device records, reduced by interval arithmetic.

`Tracer` runs `torch.profiler` (device activity) around the window and
keeps the records in memory; `Trace` holds the device operations of the
window as intervals in the host's clock (the profiler converts the
device's timestamps to it), and answers what the per-layer readers ask:
busy time as the union of intervals, device time by name, the idle gaps
and, from the benchmark's own spans, what the host was running during
each gap.  A query launches hundreds of thousands of operations, so the
intervals are numpy arrays and names are reduced once each.
"""
from __future__ import annotations

import re
import time

import numpy as np


def short_name(name: str) -> str:
    """A kernel's name without its argument list, `void ` and the
    `at::native::` / anonymous namespaces, at most 160 characters."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and not name[i:].startswith("(anonymous"):
            name = name[:i]
            break
    for ns in ("at::native::", "(anonymous namespace)::"):
        name = name.replace(ns, "")
    return name[:160]


class Tracer:
    """torch.profiler over the window, the device's activity only (the
    host's spans are the benchmark's own, on the same clock), records
    kept in memory.  Off the card (the tests) it traces the host, and no
    device operation is found."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
        self._prof = profile(activities=[activity])
        self.seconds = {}          # what reading the trace cost, for the log

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        t0 = time.perf_counter()
        out = self._prof.__exit__(*exc)
        self.seconds["stop"] = time.perf_counter() - t0
        return out

    def device_events(self) -> tuple:
        """(starts, ends, name ids, names) of every operation the device
        ran: int64 arrays of ns and a list of the distinct names."""
        import torch
        t0 = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        starts, durs, ids, names, index = [], [], [], [], {}
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != cuda:
                continue
            name = ev.name()
            j = index.get(name)
            if j is None:
                j = index[name] = len(names)
                names.append(name)
            starts.append(ev.start_ns())
            durs.append(ev.duration_ns())
            ids.append(j)
        starts = np.asarray(starts, dtype=np.int64)
        ends = starts + np.asarray(durs, dtype=np.int64)
        self.seconds["events"] = time.perf_counter() - t0
        return starts, ends, np.asarray(ids, dtype=np.int64), names


class Trace:
    def __init__(self, events: tuple, start_ns: int, end_ns: int, spans: list):
        """`events` as `Tracer.device_events` gives them, clipped to the
        window [start_ns, end_ns]; `spans` (start_ns, end_ns, label) of
        the host, an inner span starting no earlier than its outer one."""
        starts, ends, ids, self.names = events
        keep = (ends > start_ns) & (starts < end_ns)
        order = np.argsort(starts[keep], kind="stable")
        self.starts = np.maximum(starts[keep][order], start_ns)
        self.ends = np.minimum(ends[keep][order], end_ns)
        self.ids = ids[keep][order]
        self.start_ns, self.end_ns = start_ns, end_ns
        self.spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))      # outer first
        self.per_name = np.bincount(self.ids, weights=self.ends - self.starts,
                                    minlength=len(self.names))
        # the union of the intervals: a segment starts where an interval
        # starts after every earlier one has ended
        if len(self.starts):
            reach = np.maximum.accumulate(self.ends)
            new = np.ones(len(self.starts), dtype=bool)
            new[1:] = self.starts[1:] > reach[:-1]
            first = np.flatnonzero(new)
            self.seg_starts = self.starts[first]
            self.seg_ends = reach[np.append(first[1:] - 1, len(reach) - 1)]
        else:
            self.seg_starts = self.seg_ends = np.zeros(0, dtype=np.int64)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_s(self) -> float:
        return float((self.seg_ends - self.seg_starts).sum()) / 1e9

    def time_s(self, pattern: str | None = None) -> float:
        """Summed device time of operations whose name matches `pattern`
        (a regular expression; every operation when None)."""
        rx = re.compile(pattern) if pattern else None
        return float(sum(t for name, t in zip(self.names, self.per_name)
                         if rx is None or rx.search(name))) / 1e9

    def by_name(self) -> list:
        """[(short name, seconds)], most time first."""
        tot = {}
        for name, t in zip(self.names, self.per_name):
            key = short_name(name)
            tot[key] = tot.get(key, 0.0) + float(t)
        return sorted(((k, v / 1e9) for k, v in tot.items() if v > 0), key=lambda kv: -kv[1])

    def idle_by_label(self) -> list:
        """[(span label, idle seconds)] summed over the gaps between the
        device's busy segments, each gap charged to the innermost span
        around its midpoint, most idle first."""
        lo = np.append(self.start_ns, self.seg_ends)
        hi = np.append(self.seg_starts, self.end_ns)
        gap = hi > lo
        lo, hi = lo[gap], hi[gap]
        mid = (lo + hi) // 2
        labels = ["outside every span"]
        which = np.zeros(len(mid), dtype=np.int64)
        for s, e, name in self.spans:                    # inner spans overwrite outer
            if name not in labels:
                labels.append(name)
            which[(mid >= s) & (mid < e)] = labels.index(name)
        tot = np.bincount(which, weights=hi - lo, minlength=len(labels))
        return sorted(((labels[i], float(t) / 1e9) for i, t in enumerate(tot) if t > 0),
                      key=lambda kv: -kv[1])
