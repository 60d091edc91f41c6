"""Port parity: every precomputed table of a parameter set equals the JAX
package's, exactly (the precondition for bit-identical ciphertexts)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import params as jparams
from repro.core import mathutil as jmath
from repro_torch.core import mathutil as tmath
from repro_torch.core import params as tparams

SETS = {"micro": dict(n=128, t=257, k=12), "tiny": dict(n=256, t=7681, k=3),
        "k1": dict(n=64, t=257, k=1)}


def _pair(name):
    kw = SETS[name]
    return jparams.make_params(**kw), tparams.make_params(**kw)


def _same(a, b):
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(jparams.HEParams)])
@pytest.mark.parametrize("name", sorted(SETS))
def test_params_field_equal(name, field):
    jp, tp = _pair(name)
    assert _same(getattr(jp, field), getattr(tp, field)), (name, field)


@pytest.mark.parametrize("name", sorted(SETS))
def test_derived_properties_equal(name):
    jp, tp = _pair(name)
    for prop in ("k", "log_n", "slots", "row", "logQ", "ct_bytes"):
        assert getattr(jp, prop) == getattr(tp, prop), prop
    assert jp.bigQ() == tp.bigQ()
    assert jp.expansion_ratio() == tp.expansion_ratio()


def test_named_sets_match():
    for fn in ("test_params", "small_params"):
        jp, tp = getattr(jparams, fn)(), getattr(tparams, fn)()
        assert (jp.n, jp.t, jp.Q.primes, jp.P.primes) == (tp.n, tp.t, tp.Q.primes, tp.P.primes)
        assert np.array_equal(jp.slot_to_coeff, tp.slot_to_coeff)


def test_mathutil_twin():
    assert tmath.find_ntt_primes(128, 30, 4) == jmath.find_ntt_primes(128, 30, 4)
    assert tmath.find_ntt_primes(128, 31, 3, avoid=(257,)) == \
        jmath.find_ntt_primes(128, 31, 3, avoid=(257,))
    for q in (257, 7681, 65537, 1073479681):
        assert tmath.primitive_root(q) == jmath.primitive_root(q)
        assert tmath.root_of_unity(256, q) == jmath.root_of_unity(256, q)
    assert tmath.crt_reconstruct([2, 3, 2], [3, 5, 7]) == 23
    assert tmath.centered(6, 7) == -1 and tmath.bit_reverse(0b0011, 4) == 0b1100
