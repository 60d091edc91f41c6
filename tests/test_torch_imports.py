"""The port stands on torch and numpy alone: no module under
`src/repro_torch/`, nor `chip_smoke.py`, nor an example twin
(`examples/*_torch.py`) imports `jax` or the JAX package."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _examples():
    ex = os.path.join(ROOT, "examples")
    return sorted(os.path.join(ex, f) for f in os.listdir(ex) if f.endswith("_torch.py"))


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_sources():
    assert len(_sources()) > 20
    assert [os.path.basename(p) for p in _examples()] == [
        "encrypted_analytics_torch.py", "quickstart_torch.py", "train_lm_torch.py"]


@pytest.mark.parametrize("path", _sources() + _examples(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_package_import(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_triton_and_kernel_builds_are_not_import_time():
    """Importing every port module needs neither nvcc nor a card."""
    import importlib
    for path in _sources()[1:]:
        rel = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3]
        mod = rel.replace(os.sep, ".")
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        assert importlib.import_module(mod) is not None
