"""What the benchmark's sources may load and read: no JAX, no Flax, no
JAX package (whole top-level names: the port's `repro_torch` begins with
`repro`), nothing of `benchmarks/`, `chip_smoke.py`, `results/` or
`src/repro/`; and the plain references nothing of the program."""
import ast
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [p for p in (os.path.join(ROOT, "src"), ROOT) if p not in sys.path]

import pytest  # noqa: E402

from nshedb_bench import harness  # noqa: E402

BENCH = os.path.join(ROOT, "nshedb_bench")
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs
                 if f.endswith(".py") and os.sep + "tests" not in d)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke", "results"}


def imported(path) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            out |= {a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant)}
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_forbidden_import(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_reads_nothing_of_the_jax_side(path):
    text = open(path).read()
    for word in ("benchmarks/", "chip_smoke", "results/", "src/repro/", "oracle_"):
        assert word not in text, word


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch", "nshedb_bench"})


def test_forbidden_modules_compares_whole_names():
    sys.modules.setdefault("repro_torch_like_name", sys)
    try:
        assert "repro_torch_like_name" not in harness.forbidden_modules()
        assert not [m for m in harness.forbidden_modules() if m.split(".")[0] == "repro_torch"]
    finally:
        del sys.modules["repro_torch_like_name"]
    sys.modules["repro"] = sys
    try:
        assert "repro" in harness.forbidden_modules()
    finally:
        del sys.modules["repro"]
