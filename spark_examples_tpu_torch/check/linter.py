"""The AST helpers the port's source checkers share.

The port's copy of the shared half of ``spark_examples_tpu/check/
linter.py``: import-alias resolution (``_collect_aliases``, ``_dotted``),
the package-relative path of a file (``_package_relpath``), the walk over a
tree's Python files (``_iter_py_files``) and the lock constructors
(``_LOCK_CTORS``), which ``check/hostmem.py`` and ``check/lockgraph.py``
read. The linter itself (``graftcheck lint``) waits for its torch rules
(ROADMAP.md §1).

Import-alias resolution makes the checkers' patterns robust to import
style: ``import numpy as np``, ``from numpy import frombuffer`` and
``from threading import Lock`` all resolve to their canonical dotted names
before matching.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Tuple

#: Lock constructors (mutual-exclusion primitives). Event is excluded: it
#: is a flag, and cannot take part in a lock-ordering deadlock by itself.
_LOCK_CTORS = (
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
)


def _dotted(node: ast.AST, alias: Dict[str, str]) -> Optional[str]:
    """Canonical dotted name of a Name/Attribute chain, with the leading
    segment resolved through the file's import aliases; ``None`` for
    anything else (subscripts, calls, literals)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    head = alias.get(parts[0], parts[0])
    return ".".join([head] + parts[1:])


def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map local names to canonical dotted module paths, normalizing the
    numpy spellings the rules match against."""
    alias: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for item in node.names:
                alias[item.asname or item.name.split(".")[0]] = (
                    item.name if item.asname else item.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for item in node.names:
                alias[item.asname or item.name] = f"{node.module}.{item.name}"
    # Canonical spellings for the matchers (np import styles collapse; the
    # reference's jax.numpy spelling is kept, so both packages resolve a
    # shared source alike).
    resolved = {}
    for name, target in alias.items():
        if target == "jax.numpy":
            resolved[name] = "jax.numpy"
        elif target in ("numpy", "np"):
            resolved[name] = "numpy"
        else:
            resolved[name] = target
    return resolved


def _package_relpath(path: str) -> str:
    """Scope-resolvable relpath of one file: relative to the topmost
    enclosing package root (the highest ancestor chain of directories that
    all carry ``__init__.py``), so a checker handed ``<pkg>/ops/gramian.py``
    sees the same ``ops/gramian.py`` relpath — and therefore the same
    scoped rules — as a whole-tree run."""
    path = os.path.abspath(path)
    top = cur = os.path.dirname(path)
    while os.path.exists(os.path.join(cur, "__init__.py")):
        top = cur  # the highest dir that is itself a package
        parent = os.path.dirname(cur)
        if parent == cur:
            break
        cur = parent
    return os.path.relpath(path, top).replace(os.sep, "/")


def _iter_py_files(root: str) -> Iterable[Tuple[str, str]]:
    """Yield ``(abs_path, relpath)`` for package .py files under ``root``
    (or the single file itself), skipping caches."""
    if os.path.isfile(root):
        yield root, _package_relpath(root)
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [
            d for d in dirnames if d not in ("__pycache__", ".git")
        ]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                yield full, os.path.relpath(full, root).replace(os.sep, "/")


__all__: List[str] = []
