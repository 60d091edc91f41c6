"""Quickstart on the PyTorch/CUDA port: encrypted SQL in 60 lines.

The twin of `examples/quickstart.py`: loads a tiny table under real
RNS-BFV (t=257 micro parameters so it runs in seconds), then evaluates

    SELECT SUM(price), COUNT(*) FROM sales
    WHERE day < 50 AND qty >= 3

entirely on ciphertexts — equality/range masks via arithmetic circuits,
aggregation via rotate-reduce — and decrypts only the final scalars.
Runs on the card (the limb kernels); `main(device="cpu")` runs the
plain versions instead.

    PYTHONPATH=src python examples/quickstart_torch.py
"""
import argparse

import numpy as np

from repro_torch.core.params import make_params
from repro_torch.engine.backend import BFVBackend
from repro_torch.engine.plan import Agg, And, Factor, Pred
from repro_torch.engine.planner import Planner
from repro_torch.engine.schema import ColumnSpec, TableSchema
from repro_torch.engine.storage import Database


def main(argv=None, device="cuda") -> dict:
    """Run the query on `device`; returns the decrypted and plaintext
    results and the backend's OpStats.  Raises AssertionError on a wrong
    result."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)

    print("keygen (n=128, t=257, 12 RNS limbs) ...")
    bk = BFVBackend(make_params(n=128, t=257, k=12), seed=0, device=device)

    rng = np.random.default_rng(42)
    n = 50
    data = {"day": rng.integers(1, 101, n),
            "price": rng.integers(1, 101, n),
            "qty": rng.integers(1, 11, n)}
    schema = TableSchema("sales", [ColumnSpec("day", "int"),
                                   ColumnSpec("price", "int"),
                                   ColumnSpec("qty", "int")])
    db = Database(bk)
    db.load_table(schema, data, n)
    print(f"encrypted {n} rows into {db.tables['sales'].ct_count} ciphertexts")

    pl = Planner(db, optimized=True)
    tbl = db.tables["sales"]
    where = And((Pred("day", "<", 50), Pred("qty", ">=", 3)))
    mask = pl.where_mask(tbl, where)

    total = pl.aggregate(tbl, Agg("sum", (Factor("price"),), "s"), mask)
    cnt = pl.aggregate(tbl, Agg("count", (), "c"), mask)

    sel = (data["day"] < 50) & (data["qty"] >= 3)
    got = {"sum": int(bk.decrypt(total)[0]), "count": int(bk.decrypt(cnt)[0])}
    exp = {"sum": int(data["price"][sel].sum()) % bk.t, "count": int(sel.sum())}
    print(f"SUM(price) = {got['sum']}   (plaintext: {exp['sum']})")
    print(f"COUNT(*)   = {got['count']}   (plaintext: {exp['count']})")
    print(f"ct-ct muls: {bk.stats.mul}, rotations: {bk.stats.rotate}, "
          f"refreshes: {bk.stats.refresh} (planner kept the budget)")
    assert got == exp, (got, exp)
    print("OK")
    return {"got": got, "expected": exp, "stats": bk.stats}


if __name__ == "__main__":
    main()
