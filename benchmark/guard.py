"""What a benchmark run may not load: JAX, its libraries and the JAX
package the port was made from.  Module names are compared by their
top-level name (the part before the first dot), whole: the port,
`dan_tpu_torch`, begins with `dan_tpu` and is allowed.

    loaded_forbidden()          # forbidden modules in sys.modules
    scan_imports(root)          # forbidden imports in the benchmark's sources
"""
from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dan_tpu"})
# The reference and the counts are the yardstick: they import nothing of
# the program either.
PROGRAM = "dan_tpu_torch"
YARDSTICK_DIRS = ("reference", "counts")


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def _imports(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.append(node.module)
    return out


def scan_imports(root: str) -> List[str]:
    """'file: module' for every import under `root` of a forbidden module,
    and of the program from the reference or the counts."""
    bad = []
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        yardstick = rel.split(os.sep)[0] in YARDSTICK_DIRS
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for mod in _imports(path):
                if top(mod) in FORBIDDEN or (yardstick and top(mod) == PROGRAM):
                    bad.append(f"{os.path.relpath(path, root)}: {mod}")
    return bad
