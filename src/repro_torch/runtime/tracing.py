"""Spans of the query path, kept in memory, on the host's wall clock.

A span is `(span_id, parent_id, query_id, name, start_ns, end_ns,
attrs)`: spans nest through a stack, the spans of one query share the
id of its root span (`query`), and `attrs` holds what was counted at the
span's boundaries.  The clock is `clock_ns` (`time.time_ns`), the clock
`torch.profiler` places the device's operations on, so a device idle
gap can be charged to the host span around it.

Recording is decided once a query, when its root span opens: it records
while `enable()` is in force or while a `torch.profiler` session is
recording.  Every inner span (`span`, `traced`) then reads one
module-level bool; when it is false they return a shared no-op context,
allocate nothing and read no clock.  While a query records, the kernel
launch wrappers (`timed_issue`) add the host's nanoseconds from entry to
return, and one launch each, to its root span.

Finished spans stay here until `take()` drains them; past `MAX_SPANS`
they are dropped and counted.  Nothing is written out and nothing is
sent to the profiler (no `record_function`, no NVTX: either would
appear among the device's events).
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple

import torch

MAX_SPANS = 1 << 20            # finished spans held until take()

clock_ns = time.time_ns        # the one clock of every span


class Span(NamedTuple):
    span_id: int
    parent_id: int             # 0 for a query's root span
    query_id: int              # the root span's id
    name: str
    start_ns: int
    end_ns: int
    attrs: dict | None         # what was counted at the boundaries


_forced = False                # enable()
_recording = False             # a query span is open and records
_stack: list = []              # open spans, outermost first
_spans: list = []              # finished spans
_dropped = 0
_next_id = 1
_issue = [0, 0]                # the wrappers' host ns and launches while recording


def enable(on: bool = True) -> None:
    """Record every query from its next root span on (or stop, when
    `on` is false, from the next one), with or without a profiler."""
    global _forced
    _forced = bool(on)


def recording() -> bool:
    return _recording


def profiling() -> bool:
    """True while a `torch.profiler` (or autograd profiler) session records."""
    return bool(torch.autograd.profiler._is_profiler_enabled
                or torch._C._autograd._profiler_enabled())


def take() -> tuple[list, int]:
    """(the finished spans in the order they ended, spans dropped at the
    cap), and forget both."""
    global _spans, _dropped
    out, dropped = _spans, _dropped
    _spans, _dropped = [], 0
    return out, dropped


class _Open:
    """A span while it is open; `attrs` may be filled before it ends."""

    __slots__ = ("span_id", "parent_id", "query_id", "name", "start_ns", "attrs")

    def __init__(self, name: str):
        self.name = name
        self.attrs = {}

    def __enter__(self):
        global _next_id
        self.span_id = _next_id
        _next_id += 1
        parent = _stack[-1] if _stack else None
        self.parent_id = parent.span_id if parent else 0
        self.query_id = parent.query_id if parent else self.span_id
        _stack.append(self)
        self.start_ns = clock_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        end = clock_ns()
        _stack.pop()
        self._close()
        if len(_spans) < MAX_SPANS:
            _spans.append(Span(self.span_id, self.parent_id, self.query_id, self.name,
                               self.start_ns, end, self.attrs or None))
        else:
            _dropped += 1
        return False

    def _close(self) -> None:
        pass


class _Root(_Open):
    """A query's root span: recording is on while it is open."""

    __slots__ = ("_counts", "_before", "_issue")

    def __init__(self, plan: str, counts):
        super().__init__("query")
        self.attrs["plan"] = plan
        self._counts = counts

    def __enter__(self):
        global _recording
        _recording = True
        self._before = self._counts() if self._counts else {}
        self._issue = list(_issue)
        return super().__enter__()

    def _close(self) -> None:
        global _recording
        after = self._counts() if self._counts else {}
        self.attrs.update({k: after[k] - v for k, v in self._before.items()})
        self.attrs["wrapper_launches"] = _issue[1] - self._issue[1]
        self.attrs["issue_ns"] = _issue[0] - self._issue[0]
        _recording = False


class _Off:
    """The shared context of a span that does not record."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def query(name: str, counts=None):
    """A query's root span.  `counts`, a function returning {name: int},
    is read as the span opens and ends, and the differences go into its
    `attrs` beside `wrapper_launches` and `issue_ns` (the kernel
    wrappers' launches and host nanoseconds in it) and `plan`.  Inside
    a recording query it is a plain span."""
    if _recording:
        return _Open("query")
    return _Root(name, counts) if _forced or profiling() else _OFF


def span(name: str):
    """A span inside the open query (a no-op context when none records).
    `with span(name) as sp:` gives the open span, or None."""
    return _Open(name) if _recording else _OFF


def traced(name: str):
    """Decorator: every call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _recording:
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def timed_issue(fn):
    """Decorator of a kernel launch wrapper: while a query records, its
    host nanoseconds from entry to return and one launch are added to
    the query's count."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        if not _recording:
            return fn(*args, **kwargs)
        t0 = time.perf_counter_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            _issue[0] += time.perf_counter_ns() - t0
            _issue[1] += 1
    return inner
