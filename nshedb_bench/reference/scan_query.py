"""Plain reference of a one-table scan query: WHERE, GROUP BY and the
SUM / COUNT / AVG aggregates, over the raw columns, in NumPy.

Semantics are those a TPC-H scan query has in the engine's fixed-point
encoding: a decimal column is held as round(value * scale) (its
`scales` entry), a date as its day offset, a string as itself.  An
aggregate's factor (column, mult, add) is add + mult * column; SUM is
the sum over matching rows of the product of its factors, AVG the pair
(SUM, COUNT), COUNT the number of matching rows, every number reduced
mod `modulus` — the plaintext modulus t for the exact answer.  GROUP BY
enumerates every combination of each group column's distinct values in
sorted order, empty groups included; a group is keyed by its value, or
by the tuple of its values over two or more columns.

Imports nothing of the program.
"""
from __future__ import annotations

import itertools

import numpy as np

_CMP = {"<": np.less, "<=": np.less_equal, ">": np.greater,
        ">=": np.greater_equal, "=": np.equal, "!=": np.not_equal}


def encode(raw: dict, scales: dict) -> dict:
    """Raw columns as the comparisons and sums read them."""
    out = {}
    for name, values in raw.items():
        arr = np.asarray(values)
        if name in scales:
            arr = np.round(arr.astype(np.float64) * scales[name]).astype(np.int64)
        elif arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
        out[name] = arr
    return out


def _const(col: str, v, scales: dict):
    return int(round(float(v) * scales[col])) if col in scales else v


def where_mask(cols: dict, where, scales: dict) -> np.ndarray:
    """AND of [(column, op, value), ...] over the encoded columns."""
    nrows = len(next(iter(cols.values())))
    mask = np.ones(nrows, dtype=bool)
    for col, op, value in where:
        x = cols[col]
        if op == "between":
            lo, hi = (_const(col, v, scales) for v in value)
            mask &= (x >= lo) & (x <= hi)
        elif op == "in":
            mask &= np.isin(x, [_const(col, v, scales) for v in value])
        else:
            mask &= _CMP[op](x, _const(col, value, scales))
    return mask


def _sum(cols: dict, m: np.ndarray, factors, modulus: int) -> int:
    """sum over rows of prod(add + mult * col) mod `modulus`, each partial
    product reduced, so no int64 overflows."""
    prod = np.ones(int(m.sum()), dtype=np.int64)
    for col, mult, add in factors:
        f = (add + mult * cols[col][m]) % modulus
        prod = prod * f % modulus
    return int(prod.sum() % modulus)


def _aggs(cols: dict, m: np.ndarray, aggs, modulus: int) -> dict:
    row = {}
    count = int(m.sum()) % modulus
    for kind, name, factors in aggs:
        if kind == "count":
            row[name] = count
        elif kind == "sum":
            row[name] = _sum(cols, m, factors, modulus)
        elif kind == "avg":
            row[name] = (_sum(cols, m, factors, modulus), count)
        else:
            raise ValueError(f"aggregate {name}: unknown kind {kind!r}")
    return row


def answer(raw: dict, scales: dict, where, group_by, aggs, modulus: int) -> dict:
    """The query's answer over the raw columns `raw`, as the engine
    returns it.  `aggs` is [(kind, name, [(column, mult, add), ...])]."""
    cols = encode(raw, scales)
    mask = where_mask(cols, where, scales)
    if not group_by:
        return _aggs(cols, mask, aggs, modulus)
    domains = [sorted(set(np.asarray(cols[g]).tolist())) for g in group_by]
    out = {}
    for combo in itertools.product(*domains):
        m = mask.copy()
        for g, v in zip(group_by, combo):
            m &= cols[g] == v
        key = combo[0] if len(combo) == 1 else tuple(combo)
        out[key] = _aggs(cols, m, aggs, modulus)
    return out


def flatten(ans) -> dict:
    """{path: int} of every number in an answer (a pair counts twice)."""
    out = {}

    def walk(path, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(path + (k,), x)
        elif isinstance(v, (tuple, list)):
            for j, x in enumerate(v):
                walk(path + (j,), x)
        else:
            out[path] = int(v)

    walk((), ans)
    return out


def mismatches(got, expected) -> int:
    """Numbers of `expected` that `got` lacks or gives otherwise, plus
    numbers of `got` that `expected` lacks."""
    g, e = flatten(got), flatten(expected)
    return sum(1 for p in e if g.get(p) != e[p]) + sum(1 for p in g if p not in e)
