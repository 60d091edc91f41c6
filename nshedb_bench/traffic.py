"""The one traffic generator: reads a mix file of `traffic/` and draws
each query's parameters from the seed.

A mix file is JSON.  `draws` names the parameters a query draws
({"DELTA": {"uniform_int": [60, 120]}}, bounds inclusive); the rest of
the file says what a system does with them (`where` predicates whose
values are written in the forms of `resolve`, `group_by`, `aggs`,
`warmup` queries in set-up, `check_sample` queries checked,
`trace_queries` of the window under the profiler in a traced run).

Query `i` of a stream draws from its own generator, seeded by (seed,
stream, i): the parameters of a query never depend on how many queries
came before it, and the warm-up stream never repeats the window's.
"""
from __future__ import annotations

import datetime as _dt
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STREAMS = {"window": 0, "warmup": 1, "check": 2}
EPOCH = _dt.date(1992, 1, 1)      # TPC-H's first order date


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def rng(seed: int, stream: str, i: int) -> np.random.Generator:
    """The generator of query `i` of `stream` under `seed` (any int)."""
    return np.random.default_rng([seed % (1 << 64), STREAMS[stream], i])


def draw(mix: dict, seed: int, stream: str, i: int) -> dict:
    """Query `i`'s parameters: one value for each of the mix's `draws`."""
    gen = rng(seed, stream, i)
    out = {}
    for name, dist in sorted(mix.get("draws", {}).items()):
        (kind, arg), = dist.items()
        if kind != "uniform_int":
            raise ValueError(f"draw {name}: unknown distribution {kind!r}")
        lo, hi = arg
        out[name] = int(gen.integers(lo, hi + 1))
    return out


def day(iso: str) -> int:
    """A date as the tables hold it: days since 1992-01-01, plus one (0
    pads a block)."""
    return (_dt.date.fromisoformat(iso) - EPOCH).days + 1


def resolve(form, params: dict):
    """A predicate value from its written form and a query's draws:

      literal                          itself
      [form, form]                     a pair (BETWEEN's bounds)
      {"draw": P}                      the draw P
      {"days_before": [DATE, P]}       day(DATE) - P
      {"jan1": P, "plus_years": Y}     day of January 1 of year P + Y
      {"hundredths": [P, A]}           (P + A) / 100
    """
    if isinstance(form, list):
        return tuple(resolve(f, params) for f in form)
    if not isinstance(form, dict):
        return form
    if "draw" in form:
        return params[form["draw"]]
    if "days_before" in form:
        date, p = form["days_before"]
        return day(date) - params[p]
    if "jan1" in form:
        return day(f"{params[form['jan1']] + form.get('plus_years', 0):04d}-01-01")
    if "hundredths" in form:
        p, add = form["hundredths"]
        return (params[p] + add) / 100
    raise ValueError(f"unknown value form {form!r}")


def query(mix: dict, seed: int, stream: str, i: int) -> dict:
    """Query `i` of `stream`: its draws and its predicates with their
    values resolved, [(column, op, value), ...]."""
    params = draw(mix, seed, stream, i)
    where = [(col, op, resolve(form, params)) for col, op, form in mix.get("where", ())]
    return {"params": params, "where": where}
