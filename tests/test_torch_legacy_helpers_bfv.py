"""The join helpers of the legacy TPC-H bodies (Q4, Q5, Q8, Q14, Q17) on
real BFV ciphertexts, the port against the JAX package: the fused
join-aggregate with and without a mask and values, `pack_scalars`,
`translate_values_down`, the slot broadcast, Q8's chain region -> nation
-> customer -> orders -> lineitem through `translate_mask_down` (its last
hop also over a pre-masked fk column, which pays mid-circuit refreshes),
planned refreshes of one ciphertext and of a batch's short lane (the
refresh re-encrypts, so the residues are compared too), and
`Planner.group_aggregate` over ORDERS.  None has an `lt` circuit.

Both packages run `make_params(n=256, t=65537, k=30)` with seed 0 over
the same eight tables (`Scale.tiny()` with its parents cut and rows
planted so that the masks and sums are not 0:
`torch_cases.tpch_legacy_db`).  The port runs on the CPU with a lane
budget of 2, so every EQ bank and slot broadcast runs in lane chunks;
the JAX package's plain path runs each in one batch, in a child process
beside the port's run.  Tolerance 0: decrypts, noise, depth, OpStats
(launches included), op_log, refresh_log and the ciphertexts' residues
are equal: a refresh re-encrypts with the backend's generator, and a
lane chunk that met a refresh gives back its draws before the batch
reruns whole."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro_torch.engine.backend import OpStats
from torch_cases import bfv_pair, legacy_helpers_run

PARAMS = dict(n=256, t=65537, k=30)
MAX_LANES = 2
CASES = ("join_aggregate_sum_masked", "join_aggregate_count", "pack_scalars",
         "translate_values_down", "broadcast_slot", "q8_chain", "q8_last_hop_fk_override",
         "ensure_levels_one", "ensure_levels_batch", "group_aggregate")
FIELDS = (["cts", "stats", "op_log", "refresh_log"]
          + [f"stats.{f.name}" for f in dataclasses.fields(OpStats)])


@pytest.fixture(scope="module")
def runs():
    return bfv_pair(legacy_helpers_run, PARAMS, MAX_LANES)


def _value(case, field):
    key, _, sub = field.partition(".")
    return case[key][sub] if sub else case[key]


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", CASES)
def test_legacy_helper_on_bfv_matches_jax(runs, case, field):
    port, jax = runs
    assert _value(port[case], field) == _value(jax[case], field), (case, field)


@pytest.mark.parametrize("case", ["ensure_levels_one", "ensure_levels_batch"])
def test_planned_refresh_re_encrypts_as_jax_does(runs, case):
    """A planned refresh is a decrypt and a fresh encryption drawing from
    the backend's generator: the residues equal the JAX package's (the
    `cts` cases compare them), and only the short lane of the batch is
    refreshed."""
    port, jax = runs
    assert port[case]["need"] == jax[case]["need"]
    assert port[case]["refresh_log"] == [f"planned(levels={port[case]['need']})"]
    assert port[case]["stats"]["refresh"] == 1


def _flat(x):
    return [w for v in x for w in _flat(v)] if isinstance(x, list) else [x]


@pytest.mark.parametrize("case", CASES)
def test_legacy_helper_on_bfv_equals_plaintext(runs, case):
    """Each helper's decrypts against numpy over the client's shadow
    tables; none of them is all 0."""
    port, _ = runs
    decs = [dec for dec, _, _, _ in port[case]["cts"]]
    expect = port[case]["expect"]
    if case in ("join_aggregate_sum_masked", "join_aggregate_count", "group_aggregate",
                "ensure_levels_batch"):
        got = [dec[0] for dec in decs]
        assert all(dec == [dec[0]] * len(dec) for dec in decs)   # every slot
    elif case == "broadcast_slot":
        got = decs[0][0]
        assert decs[0] == [got] * len(decs[0])
    elif case in ("pack_scalars", "translate_values_down", "q8_last_hop_fk_override"):
        got = decs[0][:len(expect)]
        assert not any(decs[0][len(expect):])                  # padding slots stay 0
    elif case == "q8_chain":
        got = [dec[:len(e)] for dec, e in zip(decs, expect)]
    else:
        got = decs[0]
    assert got == expect
    assert any(_flat(expect))


def test_helper_batches_ran_in_lane_chunks(runs):
    port, jax = runs
    chunked = {what for what, lanes, step in port["lane_log"]
               if step == MAX_LANES and lanes > step}
    assert {"pow", "broadcast"} <= chunked, port["lane_log"]
    assert not jax.get("lane_log")


def test_pre_masked_fk_pays_mid_circuit_refreshes(runs):
    """Q8's unoptimized last hop joins over an fk column already
    multiplied by a mask: its EQ bank outruns the budget and refreshes
    mid-circuit ('mul'), in both packages alike.  In the port the refresh
    meets the bank inside a lane chunk, so the batch reruns whole: the
    residues of every later case hold that rerun to the reference's
    draws."""
    port, jax = runs
    case = "q8_last_hop_fk_override"
    assert port[case]["refresh_log"] == jax[case]["refresh_log"]
    assert port[case]["refresh_log"] and set(port[case]["refresh_log"]) == {"mul"}
