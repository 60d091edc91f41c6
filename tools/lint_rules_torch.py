#!/usr/bin/env python
"""Repo-specific AST lint for the PyTorch/CUDA port (`src/repro_torch`),
the twin of tools/lint_rules.py.

R001  raw-tensor-mod: modular arithmetic on torch tensors outside the
      blessed modular layers (core/{limbops,ntt,bfv,encoder} and
      kernels/).  Above them, residues go through `LimbOps` /
      kernels/u32.py so the kernel-or-plain decision stays in one
      place.  The rule fires on
        - a `%` (or `%=`) whose expression names `torch`;
        - a `%` whose right operand is a per-limb modulus vector made a
          column: indexed with `None` (`q[:, None]`), `.unsqueeze(...)`,
          or `.view(...)` / `.reshape(...)` with a last size of 1;
        - a call to `torch.remainder` / `torch.fmod`, or a
          `.remainder(`, `.remainder_(`, `.fmod(` or `.fmod_(` method
          of anything but `np`, `numpy` or `math`.
      Plain Python `%` on ints, string formatting (`"%d" % ...`) and
      numpy `% self.t` / `np.remainder` stay silent.
      Sites that must stay are listed in R001_ALLOWED, keyed by file and
      enclosing function with their reason; an entry that matches no
      finding in a linted file is itself reported (S001), so the list
      cannot go stale.

R002  bare-int64-mul: the reference tool's rule unchanged (`torch.int64`
      matches its INT64_RE).

Stdlib ast only, like the reference tool, whose visitor (and with it
GUARD_RE and INT64_RE) and MOD_ALLOWLIST this one reuses.  Exit status 1 iff a finding is emitted.

Usage:  python tools/lint_rules_torch.py [paths...]   (default: src/repro_torch)
"""
from __future__ import annotations

import ast
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lint_rules import MOD_ALLOWLIST, _Visitor  # noqa: E402

# (file, enclosing function, reason): R001 sites that stay as they are.
# Each reduces a sum of partial results, each below q_j < 2^31, that a
# torch.distributed reduction made: past the < 2q inputs LimbOps' and
# kernels.u32's modular ops take.
R001_ALLOWED = (
    ("engine/backend.py", "BFVBackend.fold_blocks",
     "the reference's own line (src/repro/engine/backend.py fold_blocks): "
     "the sum of the ranks' partial folds after sharded_fold's all-reduce "
     "over \"data\", brought below q_j once"),
    ("launch/nshedb_step.py", "_keyswitch_sharded.steps",
     "after reduce_scatter_axis over \"model\": M partial folds, their sum "
     "below M * 2^31, exact in int64, brought below q_j once"),
    ("launch/nshedb_step.py", "query_step_sharded",
     "after sum_axis over the block axes: the ranks' aggregates, their sum "
     "exact in int64, brought below q_j once"),
)

MOD_METHODS = {"remainder", "remainder_", "fmod", "fmod_"}
NOT_TENSORS = {"np", "numpy", "math"}

R001_MSG = ("raw torch modular arithmetic outside the limbops/ntt/bfv "
            "dispatch layers — route through LimbOps / kernels.u32 so the "
            "kernel-or-plain decision stays unified")


def _names_torch(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) and n.id == "torch" for n in ast.walk(node))


def _column(node: ast.AST) -> bool:
    """Whether `node` makes a vector a broadcast column: `q[:, None]`,
    `q.unsqueeze(-1)`, `q.view(-1, 1)` or `q.reshape(-1, 1)`."""
    if isinstance(node, ast.Subscript):
        parts = node.slice.elts if isinstance(node.slice, ast.Tuple) else [node.slice]
        return any(isinstance(p, ast.Constant) and p.value is None for p in parts)
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    if node.func.attr == "unsqueeze":
        return True
    last = node.args[-1] if node.args else None
    return (node.func.attr in ("view", "reshape") and isinstance(last, ast.Constant)
            and last.value == 1)


def _formats_string(node: ast.AST) -> bool:
    return isinstance(node, ast.JoinedStr) or (isinstance(node, ast.Constant)
                                               and isinstance(node.value, str))


def _in_modular_layer(rel: str) -> bool:
    """The reference tool's MOD_ALLOWLIST test."""
    return (any(rel.endswith(p) or ("/" + p) in rel
                for p in MOD_ALLOWLIST if p.endswith(".py"))
            or any(("/" + p) in rel for p in MOD_ALLOWLIST if p.endswith("/")))


class _TorchVisitor(_Visitor):
    """The reference visitor with R001 read for torch tensors; R002 and
    the docstring-guard scopes are the reference's."""

    def _r001(self, node: ast.AST) -> None:
        if not _in_modular_layer(self.rel):
            self.findings.append(("R001", node.lineno, R001_MSG))

    def visit_BinOp(self, node: ast.BinOp):
        if not isinstance(node.op, ast.Mod):
            return super().visit_BinOp(node)
        if not _formats_string(node.left) and (_names_torch(node) or _column(node.right)):
            self._r001(node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        if isinstance(node.op, ast.Mod) and (_names_torch(node) or _column(node.value)):
            self._r001(node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in MOD_METHODS
                and not (isinstance(f.value, ast.Name) and f.value.id in NOT_TENSORS)):
            self._r001(node)
        self.generic_visit(node)


def _scopes(tree: ast.AST) -> list[tuple[int, int, str]]:
    """(first line, last line, qualified name) of every def and class."""
    out = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                name = prefix + child.name
                out.append((child.lineno, child.end_lineno, name))
                walk(child, name + ".")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def _enclosing(scopes, line: int) -> str:
    """The innermost def or class around `line` ("" at module level)."""
    inside = [(lo, name) for lo, hi, name in scopes if lo <= line <= hi]
    return max(inside)[1] if inside else ""


def _is(rel: str, path: str) -> bool:
    """Whether the linted file `rel` is the allow-list's `path`."""
    return rel == path or rel.endswith("/" + path)


def _allowed(rel: str, func: str, allowed) -> int | None:
    """Index of the entry of `allowed` that covers (rel, func), or None."""
    for i, (path, fn, _reason) in enumerate(allowed):
        if _is(rel, path) and func == fn:
            return i
    return None


def lint_file(path: str, allowed=R001_ALLOWED, used: set | None = None
              ) -> list[tuple[str, str, int, str]]:
    """Findings of `path`; R001 findings that an entry of `allowed`
    covers are dropped and that entry's index added to `used`."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:  # pragma: no cover - repo code always parses
        return [("R000", path, e.lineno or 0, f"syntax error: {e.msg}")]
    v = _TorchVisitor(path, src)
    v.doc_stack.append(ast.get_docstring(tree) or "")
    v.visit(tree)
    scopes = _scopes(tree)
    out = []
    for code, line, msg in v.findings:
        hit = (_allowed(v.rel, _enclosing(scopes, line), allowed)
               if code == "R001" else None)
        if hit is None:
            out.append((code, path, line, msg))
        elif used is not None:
            used.add(hit)
    return out


def _py_files(paths: list[str]) -> list[str]:
    files = []
    for root in paths:
        if os.path.isfile(root):
            files.append(root)
            continue
        for dirpath, _dirs, names in os.walk(root):
            files.extend(os.path.join(dirpath, fn) for fn in sorted(names)
                         if fn.endswith(".py"))
    return files


def lint_paths(paths: list[str], allowed=R001_ALLOWED) -> list[tuple[str, str, int, str]]:
    """Findings over `paths`, and an S001 finding for each entry of
    `allowed` whose file was linted but which covered no R001 site."""
    files = _py_files(paths)
    used: set[int] = set()
    findings = []
    for path in files:
        findings.extend(lint_file(path, allowed, used))
    rels = [p.replace(os.sep, "/") for p in files]
    for i, (path, fn, _reason) in enumerate(allowed):
        seen = [r for r in rels if _is(r, path)]
        if seen and i not in used:
            findings.append(("S001", seen[0], 0,
                             f"stale allow-list entry: no R001 site in {fn}"))
    return findings


def main(argv: list[str] | None = None) -> int:
    args = (argv if argv is not None else sys.argv[1:]) or ["src/repro_torch"]
    findings = lint_paths(args)
    for code, path, line, msg in findings:
        print(f"{path}:{line}: {code} {msg}")
    print(f"lint_rules_torch: {len(findings)} finding(s) over {args}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
