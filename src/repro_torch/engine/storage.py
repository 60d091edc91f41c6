"""Encrypted columnar storage (paper §4.1).

A column is a list of packed ciphertext blocks, S = slots values each;
the last block is zero-padded (PAD = 0 is outside every encoded domain).
Row counts, block counts and dictionary sizes are public metadata — the
leakage profile L the paper defines in §3.

The scan-first architecture means operators stream over blocks; there are
deliberately no indexes (Table 1: packing forces O(n) behaviour anyway).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .schema import ColumnSpec, TableSchema, validate_domain


@dataclasses.dataclass
class EncryptedColumn:
    name: str
    spec: ColumnSpec
    blocks: list[Any]                 # backend ciphertext handles
    nrows: int

    @property
    def nblocks(self) -> int:
        return len(self.blocks)


@dataclasses.dataclass
class EncryptedTable:
    name: str
    schema: TableSchema
    columns: dict[str, EncryptedColumn]
    nrows: int
    slots: int

    @property
    def nblocks(self) -> int:
        return (self.nrows + self.slots - 1) // self.slots

    def validity(self, block: int) -> np.ndarray | None:
        """Plaintext 0/1 vector of live rows in `block`; None if full."""
        full = self.slots
        if block < self.nblocks - 1 or self.nrows % full == 0:
            return None
        v = np.zeros(full, dtype=np.int64)
        v[: self.nrows - block * full] = 1
        return v

    def col(self, name: str) -> EncryptedColumn:
        return self.columns[name]

    @property
    def ct_count(self) -> int:
        return sum(c.nblocks for c in self.columns.values())


class Database:
    """A set of encrypted tables bound to one backend + plaintext shadow
    copies (the client's view, used only by tests/oracle — never by the
    engine operators)."""

    def __init__(self, backend):
        self.bk = backend
        self.tables: dict[str, EncryptedTable] = {}
        self.plain: dict[str, dict[str, np.ndarray]] = {}
        # Invalidation subscribers: called with the table name whenever a
        # table is (re)loaded — derived artifacts (cached masks) must not
        # outlive the ciphertexts they were computed from.
        self._reload_hooks: list = []

    def add_reload_hook(self, fn) -> None:
        if fn not in self._reload_hooks:
            self._reload_hooks.append(fn)

    def load_table(self, schema: TableSchema, data: dict[str, Any], nrows: int) -> EncryptedTable:
        bk = self.bk
        S = bk.slots
        cols: dict[str, EncryptedColumn] = {}
        shadow: dict[str, np.ndarray] = {}
        for spec in schema.columns:
            enc = spec.encode(data[spec.name])
            assert len(enc) == nrows, f"{schema.name}.{spec.name}: {len(enc)} != {nrows}"
            validate_domain(enc, bk.t, f"{schema.name}.{spec.name}")
            shadow[spec.name] = enc
            blocks = []
            for b0 in range(0, nrows, S):
                chunk = enc[b0 : b0 + S]
                blocks.append(bk.encrypt(chunk))
            cols[spec.name] = EncryptedColumn(spec.name, spec, blocks, nrows)
        tbl = EncryptedTable(schema.name, schema, cols, nrows, S)
        self.tables[schema.name] = tbl
        self.plain[schema.name] = shadow
        for fn in self._reload_hooks:
            fn(schema.name)
        return tbl

    def storage_bytes(self) -> int:
        per_ct = getattr(self.bk, "params", None)
        if per_ct is not None:
            ct_bytes = per_ct.ct_bytes
        else:
            ct_bytes = self.bk.profile.ct_bytes
        return ct_bytes * sum(t.ct_count for t in self.tables.values())

    def raw_bytes(self, bits: int = 16) -> int:
        return sum(t.nrows * len(t.schema.columns) * bits // 8 for t in self.tables.values())
