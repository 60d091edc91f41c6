"""TPC-H Q17 — the correlated subquery on a per-part average — through
its legacy body (`run_q17`) on real BFV ciphertexts, the port against
the JAX package.  The body reaches every join helper of the legacy
queries: two fused join-aggregates over `l_partkey` (per-part sums and
counts), `pack_scalars`, two `translate_values_down` banks, a
column-to-column `lt` on operands the planner refreshes first, and a
`translate_mask_down` hop.

Both packages run `make_params(n=256, t=65537, k=30)` with seed 0 over
the same eight tables (`Scale.tiny()` with its parents cut to 4 parts,
and a Brand#23 / MED BOX part planted with lines below a fifth of its
average quantity: the generator's tiny tables answer 0;
`torch_cases.tpch_legacy_db`).  The port runs on the CPU with a lane
budget of 2, so its EQ banks and slot broadcasts run in lane chunks; the
JAX package's plain path runs each in one batch, in a child process
beside the port's run.  Tolerance 0: the decrypts, OpStats (launches
included), op_log and refresh_log are equal; the Mock at the same
parameters pays the same refreshes."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro_torch.engine.backend import OpStats
from torch_cases import bfv_pair, legacy_query_run

QUERY = "Q17"
PARAMS = dict(n=256, t=65537, k=30)
MAX_LANES = 2
FIELDS = (["got", "stats", "op_log", "refresh_log"]
          + [f"stats.{f.name}" for f in dataclasses.fields(OpStats)])


@pytest.fixture(scope="module")
def runs():
    return bfv_pair(legacy_query_run, PARAMS, MAX_LANES, QUERY)


def _value(run, field):
    key, _, sub = field.partition(".")
    return run[key][sub] if sub else run[key]


@pytest.mark.parametrize("field", FIELDS)
def test_q17_on_bfv_matches_jax(runs, field):
    port, jax = runs
    assert _value(port, field) == _value(jax, field), field


def test_q17_on_bfv_equals_a_non_trivial_oracle(runs):
    port, _ = runs
    assert port["got"] == port["oracle"]
    assert port["oracle"]["avg_yearly_x7"] != 0


def test_q17_refreshes_equal_the_mocks(runs):
    """The body's planned refreshes (the `lt` operands), and no other:
    the Mock on the same parameters' noise model runs the same body over
    the same tables and pays the same ones."""
    from repro_torch.core.params import make_params
    from repro_torch.engine.backend import MockBackend
    from torch_cases import engine_mods
    port, _ = runs
    mock = legacy_query_run(engine_mods("repro_torch"),
                            MockBackend(make_params(**PARAMS), device="cpu"),
                            QUERY)
    assert mock["got"] == port["got"]
    assert mock["refresh_log"] == port["refresh_log"]
    for f in ("mul", "rotate", "refresh", "max_depth"):
        assert mock["stats"][f] == port["stats"][f], f
    assert port["refresh_log"] and all(w.startswith("planned") for w in port["refresh_log"])


def test_q17_batches_ran_in_lane_chunks(runs):
    port, _ = runs
    chunked = {what for what, lanes, step in port["lane_log"]
               if step == MAX_LANES and lanes > step}
    assert {"pow", "broadcast"} <= chunked, port["lane_log"]
