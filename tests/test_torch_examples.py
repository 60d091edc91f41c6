"""The port's example twins (`examples/*_torch.py`) on the CPU, held
against the JAX package's examples: the quickstart and the nine-query
analytics run whole and print what the reference prints (the analytics
on a 64-slot mock profile in both, so they take seconds; the workload
table's launch and wall-clock columns aside), and the training twin takes two steps
of the reference's 100M-parameter configuration."""
import contextlib
import dataclasses
import importlib.util
import io
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro.core.noise import NoiseProfile as JNoiseProfile
from repro.engine import backend as jbackend
from repro_torch.core.noise import NoiseProfile
from repro_torch.engine import backend as tbackend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return buf.getvalue(), out


def test_quickstart_twin_prints_what_the_reference_prints():
    ours, res = _printed(_example("quickstart_torch").main, [], device="cpu")
    theirs, _ = _printed(_example("quickstart").main)
    assert ours == theirs
    assert res["got"] == res["expected"] and res["stats"].refresh == 0


def _small_mock(module, backend_mod, profile):
    """Swap the example's MockBackend for one at a 64-slot profile."""
    real = backend_mod.MockBackend

    def make(**kw):
        return real(profile(n=64, t=65537, k=30), **kw)
    module.MockBackend = make
    return module


@pytest.mark.parametrize("argv", [["--scale", "tiny"], ["--scale", "tiny", "--shards", "2"]],
                         ids=["nine_queries", "shards"])
def test_analytics_twin_prints_what_the_reference_prints(monkeypatch, argv):
    ours_mod = _small_mock(_example("encrypted_analytics_torch"), tbackend, NoiseProfile)
    theirs_mod = _small_mock(_example("encrypted_analytics"), jbackend, JNoiseProfile)
    ours, res = _printed(ours_mod.main, argv, device="cpu")
    monkeypatch.setattr("sys.argv", ["encrypted_analytics.py"] + argv)
    theirs, _ = _printed(theirs_mod.main)
    assert ours == theirs
    assert all(rec["opt"][0] and rec["unopt"][0] for rec in res.values())


def test_analytics_twin_workload_matches_the_reference(monkeypatch):
    ours_mod = _small_mock(_example("encrypted_analytics_torch"), tbackend, NoiseProfile)
    theirs_mod = _small_mock(_example("encrypted_analytics"), jbackend, JNoiseProfile)
    ours, res = _printed(ours_mod.main, ["--workload"], device="cpu")
    monkeypatch.setattr("sys.argv", ["encrypted_analytics.py", "--workload"])
    theirs, _ = _printed(theirs_mod.main)

    def table(text):
        """Every line but the speedup's; of a pass's row every column but
        the launches (the twin's Mock sums slots in one rotate_reduce
        launch where the reference's rotates 15 times) and the wall clock."""
        lines = [ln.split() for ln in text.splitlines() if ln.strip()]
        return [ln[:2] + ln[3:-1] if ln[0] in ("cold", "warm") else ln
                for ln in lines if ln[0] != "warm-cache"]
    assert table(ours) == table(theirs)
    assert res["ok"] == {"cold": True, "warm": True}
    rows = [ln.split() for ln in ours.splitlines()]
    launches = {row[0]: int(row[2]) for row in rows if row and row[0] in ("cold", "warm")}
    assert launches == {label: rep.launches for label, rep in res["reports"].items()}


def test_train_lm_twin_trains_the_reference_config(tmp_path):
    ours = _example("train_lm_torch")
    theirs = _example("train_lm")
    assert dataclasses.asdict(ours.config_100m()) == dataclasses.asdict(theirs.config_100m())
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    assert tlm.param_count(ours.config_100m()) == jlm.param_count(theirs.config_100m())
    text, res = _printed(ours.main, ["--steps", "2", "--batch", "1", "--seq", "16",
                                     "--ckpt-dir", str(tmp_path)], device="cpu")
    assert len(res["losses"]) == 2 and all(math.isfinite(x) for x in res["losses"])
    assert text.startswith("starcoder2-100m: ") and "step    1  loss" in text
