"""TPC-H Q19 — three part -> lineitem join hops under an OR of ANDs,
the part-side conjunctions (equality, IN, BETWEEN) translated down and
ANDed with lineitem's quantity windows — on real BFV ciphertexts through
the compiled DAG, the port against the JAX package.  Both run
`make_params(n=256, t=65537, k=30)` with seed 0 over the same tables
(`tpch.Scale.tiny()` with its parents cut to 16 orders and 8 parts, and
planted rows so that the revenue is not 0, as it is on the generator's
tiny tables; `torch_cases.tpch_join_db`).  The port runs on the CPU with
a lane budget of 5, so its EQ batches and bank, slot broadcasts and
10-lane comparison batch run in two lane chunks or more; the JAX
package's plain path runs each in one batch, in a child process beside
the port's run.  Tolerance 0: the decrypts, OpStats (launches included),
op_log, refresh_log, ExecReport and the verifier's findings are equal."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro_torch.engine.backend import OpStats
from repro_torch.engine.executor import ExecReport
from torch_cases import tpch_join_pair

QUERY = "Q19"
PARAMS = dict(n=256, t=65537, k=30)
# Each chunk of the comparison batch repeats its 30,721-term inner
# product's launches: two chunks are enough to hold the chunked path.
MAX_LANES = 5
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
def test_q19_on_bfv_matches_jax(runs, field):
    port, jax = runs
    assert _value(port, field) == _value(jax, field), field


def test_q19_on_bfv_equals_a_non_trivial_oracle(runs):
    port, _ = runs
    assert port["got"] == port["oracle"] and port["oracle"]["revenue"] != 0
    assert port["stats"]["refresh"] == 0 and port["report"]["history"]
    assert not [f for f in port["findings"] if f[0] == "error"]


def test_q19_batches_ran_in_lane_chunks(runs):
    port, _ = runs
    chunked = {what for what, lanes, step in port["lane_log"]
               if step == MAX_LANES and lanes > step}
    assert {"pow", "lt", "broadcast"} <= chunked, port["lane_log"]
