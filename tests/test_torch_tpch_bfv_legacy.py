"""TPC-H Q4, Q5, Q8 and Q14 through their legacy bodies (`run_q4` ...
`run_q14`) on real BFV ciphertexts, the port against the JAX package,
each query whole, as tests/test_torch_tpch_bfv_q17.py holds Q17.

Both packages run `make_params(n=256, t=65537, k=30)` with seed 0 over
the same eight tables (`torch_cases.tpch_legacy_db`: `Scale.tiny()` with
its parents cut, and rows planted so that every query answers something
other than 0).  The port runs on the CPU with a lane budget of 2; the
JAX package's plain path runs in a child process beside it.  Tolerance
0: the decrypts, OpStats (launches included), op_log and refresh_log are
equal; the Mock at the same parameters pays the same refreshes.

Each query takes one or two `lt` batches in each package, minutes on a
CPU, so the file runs in the `slow` lane only (`pytest -m slow`)."""
import dataclasses
import numbers

import pytest

pytest.importorskip("torch")

from repro_torch.engine.backend import OpStats
from torch_cases import bfv_pair, legacy_query_run

pytestmark = pytest.mark.slow

QUERIES = ("Q4", "Q5", "Q8", "Q14")
PARAMS = dict(n=256, t=65537, k=30)
MAX_LANES = 2
FIELDS = (["got", "stats", "op_log", "refresh_log"]
          + [f"stats.{f.name}" for f in dataclasses.fields(OpStats)])


@pytest.fixture(scope="module", params=QUERIES)
def runs(request):
    return request.param, bfv_pair(legacy_query_run, PARAMS, MAX_LANES, request.param)


def _value(run, field):
    key, _, sub = field.partition(".")
    return run[key][sub] if sub else run[key]


def _numbers(value):
    """Every number in a query's answer (nested dicts and lists)."""
    if isinstance(value, dict):
        return [x for v in value.values() for x in _numbers(v)]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _numbers(v)]
    return [value] if isinstance(value, numbers.Number) else []


@pytest.mark.parametrize("field", FIELDS)
def test_legacy_query_on_bfv_matches_jax(runs, field):
    qn, (port, jax) = runs
    assert _value(port, field) == _value(jax, field), (qn, field)


def test_legacy_query_on_bfv_equals_a_non_trivial_oracle(runs):
    qn, (port, _) = runs
    assert port["got"] == port["oracle"], qn
    assert any(x != 0 for x in _numbers(port["oracle"])), (qn, port["oracle"])


def test_legacy_query_refreshes_equal_the_mocks(runs):
    """The body's planned refreshes, and no other: the Mock on the same
    parameters' noise model runs the same body over the same tables and
    pays the same ones."""
    from repro_torch.core.params import make_params
    from repro_torch.engine.backend import MockBackend
    from torch_cases import engine_mods
    qn, (port, _) = runs
    mock = legacy_query_run(engine_mods("repro_torch"),
                            MockBackend(make_params(**PARAMS), device="cpu"), qn)
    assert mock["got"] == port["got"], qn
    assert mock["refresh_log"] == port["refresh_log"], qn
    for f in ("mul", "rotate", "refresh", "max_depth"):
        assert mock["stats"][f] == port["stats"][f], (qn, f)
