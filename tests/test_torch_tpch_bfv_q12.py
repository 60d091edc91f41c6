"""TPC-H Q12 — an orders -> lineitem join hop under a CASE count
partitioned on the translated mask, and column-to-column comparisons —
on real BFV ciphertexts through the compiled DAG, the port against the
JAX package.  Both run `make_params(n=256, t=65537, k=30)` with seed 0
over the same tables (`tpch.Scale.tiny()` with its parents cut to 16
orders and 8 parts, and planted rows so that no count is 0: the
generator's tiny tables answer 0 in every cell;
`torch_cases.tpch_join_db`).  The port runs on the CPU with a lane
budget of 2, so its EQ bank, slot broadcasts and comparison batch run in
several lane chunks; the JAX package's plain path runs each in one
batch, in a child process beside the port's run.  Tolerance 0: the
decrypts, OpStats (launches included), op_log, refresh_log, ExecReport
and the verifier's findings are equal."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro_torch.engine.backend import OpStats
from repro_torch.engine.executor import ExecReport
from torch_cases import tpch_join_pair

QUERY = "Q12"
PARAMS = dict(n=256, t=65537, k=30)
MAX_LANES = 2
# Each join hop costs one EQ circuit, slot broadcast and product per
# parent row: the parents are cut to keep the file short.
PARENTS = dict(orders=16, part=8)


@pytest.fixture(scope="module")
def runs():
    return tpch_join_pair(QUERY, PARENTS, PARAMS, MAX_LANES)


# What the two runs must share: each whole, then each OpStats and
# ExecReport field on its own (one case each, so a failure names it).
FIELDS = (["got", "stats", "op_log", "refresh_log", "report", "findings"]
          + [f"stats.{f.name}" for f in dataclasses.fields(OpStats)]
          + [f"report.{f.name}" for f in dataclasses.fields(ExecReport)])


def _value(run, field):
    key, _, sub = field.partition(".")
    return run[key][sub] if sub else run[key]


@pytest.mark.parametrize("field", FIELDS)
def test_q12_on_bfv_matches_jax(runs, field):
    port, jax = runs
    assert _value(port, field) == _value(jax, field), field


def test_q12_on_bfv_equals_a_non_trivial_oracle(runs):
    port, _ = runs
    assert port["got"] == port["oracle"]
    counts = [n for mode in port["oracle"].values() for n in mode.values()]
    assert len(counts) == 4 and all(counts), port["oracle"]
    assert port["stats"]["refresh"] == 0 and port["report"]["history"]
    assert not [f for f in port["findings"] if f[0] == "error"]


def test_q12_batches_ran_in_lane_chunks(runs):
    port, _ = runs
    chunked = {what for what, lanes, step in port["lane_log"]
               if step == MAX_LANES and lanes > step}
    assert {"pow", "lt", "broadcast"} <= chunked, port["lane_log"]
