"""Schema, type encodings and dictionary compression (paper §2.1.5).

BFV operates on Z_t, so every SQL type maps to small integers:
  int      — raw (must fit < t/2 so column-vs-column subtraction stays in
             the centered half-range the LT circuit decodes)
  decimal  — fixed point: value * 10^frac_digits, tracked via `scale`
  date     — days since 1992-01-01 (TPC-H epoch), +1 so 0 stays the pad
  str      — dictionary encoding: sequential ids 1..D (0 = padding);
             dictionary sizes are public metadata (paper §3 leakage L)
  flag     — small categorical, stored like str

Value domains are validated against t at load: the paper's evaluation
stores 16-bit integers under t=65537 (Fig. 7), and the LT circuit needs
|x - y| < t/2; we enforce both.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt

import numpy as np

EPOCH = _dt.date(1992, 1, 1)
PAD = 0  # slot-padding sentinel, outside every encoded domain


def date_to_int(d: str | _dt.date) -> int:
    if isinstance(d, str):
        d = _dt.date.fromisoformat(d)
    return (d - EPOCH).days + 1


@dataclasses.dataclass
class ColumnSpec:
    name: str
    kind: str                      # int | decimal | date | str | flag
    scale: int = 1                 # decimal fixed-point multiplier
    dictionary: dict[str, int] | None = None   # str -> id (built at load)

    def encode(self, values) -> np.ndarray:
        if self.kind == "str" or self.kind == "flag":
            if self.dictionary is None:
                uniq = sorted(set(values))
                self.dictionary = {v: i + 1 for i, v in enumerate(uniq)}
            return np.array([self.dictionary[v] for v in values], dtype=np.int64)
        if self.kind == "date":
            vals = np.asarray(values)
            if np.issubdtype(vals.dtype, np.integer):
                return vals.astype(np.int64)      # already day offsets
            return np.array([date_to_int(v) for v in values], dtype=np.int64)
        if self.kind == "decimal":
            # float64 product, rounded before the cast: scaled decimals
            # stay < t = 2^16 < 2^53 — exact int64.
            return np.round(np.asarray(values, dtype=np.float64) * self.scale).astype(np.int64)
        return np.asarray(values, dtype=np.int64)

    def encode_scalar(self, v) -> int:
        if self.kind in ("str", "flag"):
            assert self.dictionary is not None, f"{self.name}: dictionary not built"
            # Constants absent from the data map to an id that matches no
            # row (ids are 1..D, pads are 0) — the predicate is just empty.
            return self.dictionary.get(v, len(self.dictionary) + 1)
        if self.kind == "date":
            return int(v) if isinstance(v, (int, np.integer)) else date_to_int(v)
        if self.kind == "decimal":
            return int(round(float(v) * self.scale))
        return int(v)

    def decode(self, ids: np.ndarray):
        if self.kind in ("str", "flag") and self.dictionary is not None:
            rev = {i: s for s, i in self.dictionary.items()}
            return [rev.get(int(x), "<pad>") for x in ids]
        if self.kind == "decimal":
            return np.asarray(ids, dtype=np.float64) / self.scale
        return ids

    @property
    def domain_size(self) -> int | None:
        return len(self.dictionary) if self.dictionary is not None else None


@dataclasses.dataclass
class TableSchema:
    name: str
    columns: list[ColumnSpec]

    def col(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"{self.name}.{name}")


def validate_domain(arr: np.ndarray, t: int, name: str = "") -> None:
    """All engine values must stay in [0, t/2) so centered differences
    decode correctly in the comparison circuits."""
    mx, mn = int(arr.max(initial=0)), int(arr.min(initial=0))
    if mn < 0 or mx >= t // 2:
        raise ValueError(f"column {name}: domain [{mn},{mx}] outside [0, {t//2})")
