#!/usr/bin/env python3
"""Static lint: no host synchronisation on the port's serving path.

    python3 tools/check_host_seams_torch.py [ROOT]   # ROOT: src/repro_torch

The port's observability plane rests on one convention: a request
without a profile adds no device synchronisation.  The serving path
enqueues kernels and copies the two answers (ids, scores) to the host
once a batch; any other ``torch.cuda.synchronize()``, ``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()`` or ``.nonzero()`` there stalls
the host on the card every batch, and so does ``int()``, ``float()`` or
``bool()`` of a tensor.  The lint has no types, so it flags those three
on any argument that is not a constant.  The JAX package's ``tools/check_host_seams.py`` guards its
convention (no host calls inside jitted bodies); this lint guards the
port's, in the serving modules:

* ``serve/engine.py``, ``serve/graphs.py``, ``core/search.py`` and
  ``cluster/router.py``, every function;
* ``dist/shard_index.py``, the functions of the search path
  (:data:`SEARCH_PATH`); ingest, delete and merges may read to the host.

A call is allowed inside a profile branch -- the body of an ``if`` whose
test names ``profile`` -- or inside a function whose name starts with
``profile`` (the fence of a profiled phase, ``ClusterEngine.profile``),
and on a line marked ``# host-seam: <reason>`` (the allow-list: the
answers' two copies, and a host value the lint cannot tell from a
tensor).  It does not see a boolean-mask index (``t[mask]``), which
also waits for the card: the synchronise counts of ``chip_smoke.py``'s
traced batches are the guard there.  Exit 0 when clean, 1 with
``file:line`` diagnostics otherwise.  Pure ``ast``: no torch, no repo
import.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import List, Optional, Tuple

DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src", "repro_torch")

SEARCH_PATH = ("search", "_shard_pages", "_shard_page", "_gather",
               "_generations", "_df", "_shards_df", "_generation_scores",
               "_gather_merge", "_stream_merge", "_take", "_merge_phase",
               "_quant_at")

# module -> the functions on the serving path (None: every function)
SERVING = {
    os.path.join("serve", "engine.py"): None,
    os.path.join("serve", "graphs.py"): None,
    os.path.join("core", "search.py"): None,
    os.path.join("cluster", "router.py"): None,
    os.path.join("dist", "shard_index.py"): SEARCH_PATH,
}

MARK = "# host-seam:"
_METHODS = ("item", "cpu", "tolist", "numpy", "nonzero")
_SCALARS = ("int", "float", "bool")


def _dotted(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _names_profile(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and n.id == "profile":
            return True
        if isinstance(n, ast.Attribute) and n.attr == "profile":
            return True
    return False


class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, lines: List[str]):
        self.path, self.lines = path, lines
        self.violations: List[Tuple[str, int, str]] = []

    def visit_If(self, node: ast.If):
        self.visit(node.test)
        if not _names_profile(node.test):       # a profile branch: allowed
            for stmt in node.body:
                self.visit(stmt)
        for stmt in node.orelse:
            self.visit(stmt)

    def visit_FunctionDef(self, node):
        if not node.name.startswith("profile"):
            self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, call: ast.Call):
        what = None
        d = _dotted(call.func)
        if d is not None and d.endswith("cuda.synchronize"):
            what = f"'{d}()'"
        elif (isinstance(call.func, ast.Attribute)
              and call.func.attr in _METHODS):
            what = f"'.{call.func.attr}()'"
        elif (d in _SCALARS and call.args
              and not isinstance(call.args[0], ast.Constant)):
            what = f"'{d}()' of a value that may be a tensor"
        if what is not None:
            last = getattr(call, "end_lineno", call.lineno)
            marked = any(MARK in self.lines[i - 1]
                         for i in range(call.lineno, last + 1))
            if not marked:
                self.violations.append((self.path, call.lineno,
                                        f"{what} on the serving path"))
        self.generic_visit(call)


def check_file(path: str, functions) -> List[Tuple[str, int, str]]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as exc:
        return [(path, exc.lineno or 0, f"syntax error: {exc.msg}")]
    checker = _Checker(path, src.splitlines())
    if functions is None:
        checker.visit(tree)
    else:
        for node in ast.walk(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in functions):
                for stmt in node.body:
                    checker.visit(stmt)
    return checker.violations


def main(argv: List[str]) -> int:
    root = argv[1] if len(argv) > 1 else DEFAULT_ROOT
    violations = []
    for rel, functions in sorted(SERVING.items()):
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            violations.append((path, 0, "serving module not found"))
            continue
        violations.extend(check_file(path, functions))
    if violations:
        for path, line, msg in violations:
            print(f"{path}:{line}: {msg}", file=sys.stderr)
        print(f"check_host_seams_torch: {len(violations)} violation(s) in "
              f"{root}", file=sys.stderr)
        return 1
    print(f"check_host_seams_torch: OK ({len(SERVING)} serving modules, "
          "no host synchronisation outside a profile branch)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
