"""The port's AST lint (tools/lint_rules_torch.py), case for case with
tests/test_lint_rules.py's lint cases, plus the torch forms of R001, the
allow-list and the CLI.  Stdlib and pytest only: no torch, no jax.
"""
import ast
import pathlib
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import lint_rules_torch as lint  # noqa: E402


def _lint_src(tmp_path, src, name="engine_mod.py", allowed=()):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return lint.lint_file(str(p), allowed)


def _codes(findings):
    return [f[0] for f in findings]


# ---------------------------------------------------------------------------
# R001: raw tensor modular arithmetic outside the dispatch layers.
# ---------------------------------------------------------------------------

def test_r001_fires_on_raw_torch_mod(tmp_path):
    out = _lint_src(tmp_path, """\
        import torch

        def bad(x, q):
            return torch.sum(x) % q
    """)
    assert _codes(out) == ["R001"]


def test_r001_allows_the_modular_layers(tmp_path):
    layer = tmp_path / "core"
    layer.mkdir()
    p = layer / "limbops.py"
    p.write_text("import torch\n\ndef ok(x, q):\n"
                 "    return torch.remainder(torch.add(x, x) % q[:, None], q)\n")
    assert lint.lint_file(str(p)) == []
    k = tmp_path / "kernels" / "u32.py"
    k.parent.mkdir()
    k.write_text("def ok(x, q):\n    return x.remainder(q[:, None]) % q[:, None]\n")
    assert lint.lint_file(str(k)) == []


def test_r001_ignores_plain_python_mod(tmp_path):
    assert _lint_src(tmp_path, "def ok(a, b):\n    x = a % b\n    x %= b\n"
                               "    return x\n") == []


def test_r001_ignores_numpy_mod_in_the_mock(tmp_path):
    assert _lint_src(tmp_path, """\
        import numpy as np

        class MockBackend:
            def add(self, a, b):
                return np.add(a.vec, b.vec) % self.t
    """) == []


@pytest.mark.parametrize("expr", [
    "torch.remainder(x, q)",
    "torch.fmod(x, q)",
    "x.remainder(q)",
    "x.remainder_(q)",
    "x.fmod(q)",
    "x % q[:, None]",
    "(x + y) % self.q[:, None, None]",
    "x % q.to(torch.int64)",
    "x % q.unsqueeze(-1)",
    "x % q.view(-1, 1)",
    "x % self.q.reshape(-1, 1)",
])
def test_r001_fires_on_each_torch_form(tmp_path, expr):
    out = _lint_src(tmp_path, f"""\
        import torch

        def bad(self, x, y, q):
            return {expr}
    """)
    assert _codes(out) == ["R001"], expr


@pytest.mark.parametrize("expr", [
    "np.remainder(x, q)",
    "np.fmod(x, q)",
    "numpy.remainder(x, q)",
    "math.fmod(x, q)",
    "'%d devices' % torch.cuda.device_count()",
    "f'{x}%' % y",
    "x % q.view(-1)",
])
def test_r001_ignores_numpy_math_and_string_formatting(tmp_path, expr):
    assert _lint_src(tmp_path, f"""\
        import math

        import numpy
        import numpy as np
        import torch

        def ok(x, y, q):
            return {expr}
    """) == [], expr


def test_r001_fires_on_an_augmented_tensor_mod(tmp_path):
    out = _lint_src(tmp_path, "def bad(x, q):\n    x %= q[:, None]\n    return x\n")
    assert _codes(out) == ["R001"]


# ---------------------------------------------------------------------------
# R002: int64 multiply without an overflow-guard note (the reference rule).
# ---------------------------------------------------------------------------

def test_r002_fires_on_unguarded_int64_mul(tmp_path):
    out = _lint_src(tmp_path, """\
        import numpy as np

        def bad(a, b):
            return (a * b).astype(np.int64)
    """)
    assert _codes(out) == ["R002"]


def test_r002_fires_on_unguarded_torch_int64_mul(tmp_path):
    out = _lint_src(tmp_path, """\
        import torch

        def bad(a, b):
            return (a * b).to(torch.int64)
    """)
    assert _codes(out) == ["R002"]


@pytest.mark.parametrize("guard", [
    "# products < 2^34, exact int64",
    "# stays below overflow",
    "# fits int64",
])
def test_r002_suppressed_by_line_comment(tmp_path, guard):
    out = _lint_src(tmp_path, f"""\
        import numpy as np

        def ok(a, b):
            {guard}
            return (a * b).astype(np.int64)
    """)
    assert out == []


def test_r002_suppressed_by_docstring_guard(tmp_path):
    out = _lint_src(tmp_path, '''\
        import numpy as np

        def ok(a, b):
            """Operands are 16-bit, so products < 2^34 — exact int64."""
            return (a * b).astype(np.int64)
    ''')
    assert out == []


def test_r002_ignores_mul_without_int64(tmp_path):
    assert _lint_src(tmp_path, "def ok(a, b):\n    return a * b\n") == []


# ---------------------------------------------------------------------------
# The allow-list: keyed by file and enclosing function, never stale.
# ---------------------------------------------------------------------------

SITE = """\
    import torch

    class Backend:
        def fold(self, x, q):
            return x % q[:, None]

        def other(self, x, q):
            return x % q[:, None]
"""


def test_allow_entry_suppresses_only_its_function(tmp_path):
    allowed = (("engine/site.py", "Backend.fold", "partial sums after a reduction"),)
    out = _lint_src(tmp_path, SITE, "engine/site.py", allowed)
    assert [(c, ln) for c, _, ln, _ in out] == [("R001", 8)]
    assert len(_lint_src(tmp_path, SITE, "engine/site.py")) == 2


def test_allow_entry_does_not_cover_r002(tmp_path):
    allowed = (("engine/site.py", "bad", "partial sums after a reduction"),)
    out = _lint_src(tmp_path, """\
        import torch

        def bad(a, b, q):
            return (a * b).to(torch.int64) % q[:, None]
    """, "engine/site.py", allowed)
    assert _codes(out) == ["R002"]


def test_stale_allow_entry_is_reported(tmp_path):
    p = tmp_path / "engine" / "site.py"
    p.parent.mkdir()
    p.write_text(textwrap.dedent(SITE))
    allowed = (("engine/site.py", "Backend.fold", "partial sums"),
               ("engine/site.py", "Backend.other", "partial sums"),
               ("engine/site.py", "Backend.gone", "was moved"),
               ("launch/elsewhere.py", "step", "not linted here"))
    out = lint.lint_paths([str(tmp_path)], allowed)
    assert [(c, msg.endswith("Backend.gone")) for c, _, _, msg in out] == [("S001", True)]


def test_every_allow_entry_states_a_reason():
    assert lint.R001_ALLOWED
    for path, fn, reason in lint.R001_ALLOWED:
        assert (ROOT / "src" / "repro_torch" / path).is_file(), path
        assert fn and len(reason) > 20, (path, fn)


# ---------------------------------------------------------------------------
# The CLI and the port itself (same invocation as the reference's CI job).
# ---------------------------------------------------------------------------

def test_main_exit_status(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("def ok(a, b):\n    return a % b\n")
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\ndef bad(x, q):\n    return torch.remainder(x, q)\n")
    assert lint.main([str(clean)]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert lint.main([str(tmp_path)]) == 1
    printed = capsys.readouterr().out
    assert f"{bad}:4: R001" in printed and "1 finding(s)" in printed


def test_port_is_lint_clean(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    assert lint.main([]) == 0
    assert capsys.readouterr().out.strip().endswith("0 finding(s) over ['src/repro_torch']")


def test_without_the_allow_list_exactly_its_sites_are_reported():
    findings = lint.lint_paths([str(ROOT / "src" / "repro_torch")], allowed=())
    assert {c for c, _, _, _ in findings} == {"R001"}
    sites = []
    for _, path, line, _ in findings:
        rel = pathlib.Path(path).relative_to(ROOT / "src" / "repro_torch").as_posix()
        scopes = lint._scopes(ast.parse(pathlib.Path(path).read_text()))
        sites.append((rel, lint._enclosing(scopes, line)))
    assert sorted(sites) == sorted((p, fn) for p, fn, _ in lint.R001_ALLOWED)
