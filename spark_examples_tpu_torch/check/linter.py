"""AST-walking torch-pitfall linter (the ``graftcheck lint`` engine).

The port's copy of ``spark_examples_tpu/check/linter.py``: one
:class:`_LintVisitor` pass per file, no type inference — every rule is a
syntactic pattern plus *scope* (which package subtree it applies to,
``rules.py``) plus a small amount of dataflow that stays inside one
function body (names assigned from ``torch.*`` expressions). The rule ids,
names and scopes are the reference's; each reads the reference's JAX
spelling of its pitfall in torch's: a *tensor value* is an expression
rooted at ``torch`` (the reference's ``jnp`` value) or a name assigned from
one, and a *compiled function* is one decorated with ``torch.compile`` or
``torch.jit.script``/``trace`` (the reference's ``jax.jit``/``shard_map``
body). Anything legitimately outside the rules carries a
``# graftcheck: disable=ID -- why`` escape hatch, so the port's tree lints
clean.

The module also holds the AST helpers the port's other source checkers
share (``check/hostmem.py``, ``check/lockgraph.py``): import-alias
resolution (``_collect_aliases``, ``_dotted``), the package-relative path of
a file (``_package_relpath``), the walk over a tree's Python files
(``_iter_py_files``) and the lock constructors (``_LOCK_CTORS``).

Import-alias resolution makes the patterns robust to import style:
``import numpy as np``, ``from torch import compile``, ``from torch.jit
import script`` and ``from threading import Lock`` all resolve to their
canonical dotted names before matching.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from spark_examples_tpu_torch.check.rules import (
    RULES,
    Finding,
    apply_disables,
    parse_disables,
)

#: Lock constructors (mutual-exclusion primitives). Event is excluded: it
#: is a flag, and cannot take part in a lock-ordering deadlock by itself.
_LOCK_CTORS = (
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
)


#: Call roots that convert a tensor value to host (GC001 sinks).
_HOST_SINKS = ("float", "int", "numpy.asarray", "numpy.array", "numpy.float64")

#: Tensor methods that fetch to the host whatever they are called on (GC001;
#: ``.item()`` is the reference's own sink, ``.cpu()`` and ``.numpy()``
#: torch's copies out of device memory).
_HOST_SYNC_METHODS = ("item", "cpu", "numpy")

#: How far above a lock construction the ``# lock order:`` comment may sit.
_LOCK_COMMENT_WINDOW = 3

#: Spellings for GC009's finding text (the common augmented operators).
_AUG_OPS = {"Add": "+", "Sub": "-", "Mult": "*", "BitOr": "|"}

#: Canonical dotted names that compile a function (the traced-body context
#: of GC002, GC003, GC008 and GC010 — the reference's ``jax.jit`` and
#: ``shard_map``).
_COMPILE_NAMES = ("torch.compile", "torch.jit.script", "torch.jit.trace")

#: GC011: cast targets narrow enough that the Gramian dtype ladder's
#: integer-exactness can silently break (anything with an exact-integer
#: window below f64's). A cast to one of these in ops/ must carry a
#: `# range:` comment (on the line, or within _RANGE_COMMENT_WINDOW lines
#: above — the `# lock order:` layout) stating why the operand range fits,
#: ideally naming its ops/contracts.py contract.
_NARROW_CAST_TARGETS = frozenset(
    {"int8", "uint8", "int16", "uint16", "int32", "uint32",
     "float16", "bfloat16", "float32"}
)

#: torch's short dtype aliases, by their canonical dotted name (matched
#: whole: a bare ``float`` is numpy's float64, not torch's float32).
_TORCH_DTYPE_ALIASES = {
    "torch.int": "int32",
    "torch.short": "int16",
    "torch.half": "float16",
    "torch.float": "float32",
}

#: How far above a narrowing cast the `# range:` justification may sit —
#: wider than the lock-order window because the cast often sits mid-way
#: down a multi-line chained expression whose node anchors a few lines in.
_RANGE_COMMENT_WINDOW = 6

#: GC012: callables whose result is a file handle. A READ-mode handle in
#: ``sources/``/``pipeline/`` may only live inside the one windowed stream
#: abstraction (``sources/stream.py``) — anywhere else, iterating it or
#: calling ``.read*()`` on it is the raw-ingest shape the hostmem totality
#: proof exists to keep out of the tree.
_FILE_OPEN_FNS = ("open", "io.open", "gzip.open", "bz2.open", "lzma.open")

#: The one module allowed to touch raw read handles (it IS the stream
#: abstraction), exempt from GC012 by construction.
_STREAM_MODULE = "sources/stream.py"

#: The one module allowed to construct journal protocol records (it IS
#: the protocol: its record constructors are the shapes `graftcheck
#: proto` proves the coordination protocol against), exempt from GC013
#: by construction.
_JOURNAL_MODULE = "serve/journal.py"

#: GC013: the protocol event names whose dict-literal construction is
#: reserved to serve/journal.py.
_JOURNAL_EVENTS = ("accepted", "began", "terminal", "lease")

#: numpy calls that are compile-time constants, not host compute: dtype
#: constructors used as cast arguments. These run on Python scalars and
#: metadata, never on tensors.
_NP_DTYPE_CTORS = frozenset(
    {"numpy.dtype", "numpy.int8", "numpy.int32", "numpy.int64",
     "numpy.uint8", "numpy.uint32", "numpy.uint64", "numpy.float32",
     "numpy.bool_"}
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


def _is_torch_rooted(node: ast.AST, alias: Dict[str, str]) -> bool:
    """Whether an expression's outermost call/attr chain starts at
    ``torch`` (covers ``torch.sum(x)``, ``torch.linalg.eigh(x)``)."""
    if isinstance(node, ast.Call):
        node = node.func
    name = _dotted(node, alias)
    return bool(name and name.startswith("torch."))


class _CompiledContext:
    """One compiled function on the stack: its traced parameter names, for
    GC002's branch test."""

    def __init__(self, traced_params: Set[str], fn_name: str):
        self.traced_params = traced_params
        self.fn_name = fn_name


def _compile_decoration(dec: ast.expr, alias: Dict[str, str]) -> bool:
    """Whether ``dec`` compiles the function it decorates. Recognized
    forms::

        @torch.compile                @torch.jit.script
        @torch.compile(fullgraph=True)
        @functools.partial(torch.compile, dynamic=False)
    """
    if _dotted(dec, alias) in _COMPILE_NAMES:
        return True
    if isinstance(dec, ast.Call):
        fn_name = _dotted(dec.func, alias)
        if fn_name in _COMPILE_NAMES:
            return True
        if fn_name in ("functools.partial", "partial") and dec.args:
            return _dotted(dec.args[0], alias) in _COMPILE_NAMES
    return False


def _compiled_call(node: ast.Call, name: Optional[str], alias: Dict[str, str]) -> bool:
    """Whether a call builds a compiled callable (bare or through
    ``functools.partial``)."""
    if name in _COMPILE_NAMES:
        return True
    return (
        name in ("functools.partial", "partial")
        and bool(node.args)
        and _dotted(node.args[0], alias) in _COMPILE_NAMES
    )


def _static_annotation(annotation: Optional[ast.expr]) -> bool:
    """Whether a parameter's annotation says it is no tensor (``n: int``).
    torch has no static arguments: a compiled function specializes on its
    Python scalars and traces its tensors, so an unannotated parameter —
    like any annotation that names a ``Tensor`` — counts as traced."""
    if annotation is None:
        return False
    for node in ast.walk(annotation):
        leaf = node.attr if isinstance(node, ast.Attribute) else (
            node.id if isinstance(node, ast.Name) else None)
        if leaf == "Tensor" or (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and "Tensor" in node.value
        ):
            return False
    return True


class _LintVisitor(ast.NodeVisitor):
    def __init__(
        self,
        relpath: str,
        source_lines: Sequence[str],
        alias: Dict[str, str],
    ):
        self.relpath = relpath
        self.lines = source_lines
        self.alias = alias
        self.findings: List[Finding] = []
        self._loop_depth = 0
        self._func_depth = 0
        self._compiled_stack: List[_CompiledContext] = []
        #: Per-function-scope set of names assigned from torch expressions.
        self._tensor_names: List[Set[str]] = []
        #: Per-scope read-mode file-handle names (GC012); index 0 is the
        #: module scope.
        self._read_handles: List[Set[str]] = [set()]

    # ------------------------------------------------------------- plumbing

    def emit(self, rule_id: str, node: ast.AST, detail: str) -> None:
        rule = RULES[rule_id]
        if not rule.applies_to(self.relpath):
            return
        self.findings.append(
            Finding(
                rule_id,
                self.relpath,
                getattr(node, "lineno", 0),
                getattr(node, "col_offset", 0) + 1,
                detail,
            )
        )

    def _has_lock_order_comment(self, lineno: int) -> bool:
        lo = max(0, lineno - 1 - _LOCK_COMMENT_WINDOW)
        window = self.lines[lo:lineno]
        return any("lock order:" in line for line in window)

    def _has_range_comment(self, lineno: int) -> bool:
        lo = max(0, lineno - 1 - _RANGE_COMMENT_WINDOW)
        window = self.lines[lo:lineno]
        return any(
            "range:" in line or "ops/contracts" in line for line in window
        )

    def _is_tensor_value(self, node: ast.expr) -> bool:
        return _is_torch_rooted(node, self.alias) or (
            isinstance(node, ast.Name)
            and any(node.id in scope for scope in self._tensor_names)
        )

    # ------------------------------------------------------ GC012 (raw file)

    def _read_mode_open(self, node: ast.expr) -> bool:
        """Whether a call opens a file for READING (default mode counts;
        an unresolvable dynamic mode is conservatively read — the stream
        abstraction is where dynamic file plumbing belongs anyway)."""
        if not isinstance(node, ast.Call):
            return False
        if _dotted(node.func, self.alias) not in _FILE_OPEN_FNS:
            return False
        mode = None
        if len(node.args) >= 2:
            mode = node.args[1]
        else:
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            return not any(c in mode.value for c in "wax")
        return True

    def _bind_read_handles(self, value: ast.expr, target: ast.expr) -> None:
        if (
            self.relpath != _STREAM_MODULE
            and self._read_mode_open(value)
            and isinstance(target, ast.Name)
        ):
            self._read_handles[-1].add(target.id)

    def _is_raw_handle_iter(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self._read_handles[-1]
        if isinstance(node, ast.Call) and _dotted(node.func, self.alias) in (
            "enumerate",
            "zip",
            "iter",
            "reversed",
        ):
            return any(self._is_raw_handle_iter(arg) for arg in node.args)
        return False

    # ------------------------------------------------------------ functions

    def _visit_function(self, node) -> None:
        compiled = any(
            _compile_decoration(dec, self.alias)
            for dec in getattr(node, "decorator_list", [])
        )
        if compiled:
            params = list(getattr(node.args, "posonlyargs", [])) + list(node.args.args)
            traced = {
                a.arg for a in params if not _static_annotation(a.annotation)
            }
            self._compiled_stack.append(_CompiledContext(traced - {"self"}, node.name))
        self._check_out_of_place_update(node)
        self._func_depth += 1
        self._tensor_names.append(set())
        self._read_handles.append(set())
        # Loops outside don't lexically contain this body's launches.
        outer_loop_depth, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = outer_loop_depth
        self._read_handles.pop()
        self._tensor_names.pop()
        self._func_depth -= 1
        if compiled:
            self._compiled_stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # A lambda body runs at CALL time: module-level `f = lambda x:
        # torch.sum(x)` must not trip the import-time rule (GC004).
        self._func_depth += 1
        self._read_handles.append(set())
        self.generic_visit(node)
        self._read_handles.pop()
        self._func_depth -= 1

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            if isinstance(item.optional_vars, ast.Name):
                self._bind_read_handles(
                    item.context_expr, item.optional_vars
                )
        self.generic_visit(node)

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    def _check_out_of_place_update(self, node) -> None:
        """GC005: accumulator-shaped updates must update in place (or carry
        a justification disable). Heuristic, the reference's: the function
        name says it updates state (update/accum/flush) and it takes at
        least two params; the accumulator is its first. torch's donation is
        the in-place update, so the finding is the out-of-place one: the
        accumulator combined by an operator or a ``torch.*`` call (no
        ``out=``) and returned, or bound back to its own name."""
        name = node.name.lower()
        if not any(tag in name for tag in ("update", "accum", "flush")):
            return
        params = [a.arg for a in getattr(node.args, "posonlyargs", [])] + [
            a.arg for a in node.args.args
        ]
        if len(params) < 2:
            return
        acc = params[1] if params[0] == "self" else params[0]

        def out_of_place(expr: Optional[ast.expr]) -> bool:
            if isinstance(expr, ast.BinOp):
                return any(
                    isinstance(side, ast.Name) and side.id == acc
                    for side in (expr.left, expr.right)
                )
            if isinstance(expr, ast.Call) and _is_torch_rooted(expr, self.alias):
                return (
                    bool(expr.args)
                    and isinstance(expr.args[0], ast.Name)
                    and expr.args[0].id == acc
                    and not any(kw.arg == "out" for kw in expr.keywords)
                )
            return False

        for sub in ast.walk(node):
            rebinds = isinstance(sub, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == acc for t in sub.targets
            )
            if (isinstance(sub, ast.Return) or rebinds) and out_of_place(sub.value):
                self.emit(
                    "GC005",
                    node,
                    f"accumulator update {node.name!r} builds {acc!r} out of "
                    "place, holding two live copies of it per step; update "
                    "it in place (add_, +=, out=) — updating in place halves "
                    "its peak memory (disable with a justification if the "
                    "copy is a measured win)",
                )
                return

    # ---------------------------------------------------------------- loops

    def _visit_loop(self, node) -> None:
        if isinstance(
            node, (ast.For, ast.AsyncFor)
        ) and self._is_raw_handle_iter(node.iter):
            self.emit(
                "GC012",
                node,
                "iterating a raw read-mode file handle outside the stream "
                "abstraction; route the read through sources/stream.py "
                "(iter_text_lines/iter_byte_windows) so the hostmem "
                "totality proof covers it",
            )
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop

    def visit_While(self, node: ast.While) -> None:
        self._check_branch_on_traced(node, "while")
        self._visit_loop(node)

    def visit_If(self, node: ast.If) -> None:
        self._check_branch_on_traced(node, "if")
        self.generic_visit(node)

    # ------------------------------------------------------- GC002 (branch)

    def _check_branch_on_traced(self, node, kind: str) -> None:
        if not self._compiled_stack:
            return
        ctx = self._compiled_stack[-1]
        # `x is None` / `x is not None` and isinstance() never read a
        # tensor's value; only value comparisons and bare names do.
        traced = self._traced_names_in_bool_test(node.test, ctx.traced_params)
        if traced:
            names = ", ".join(sorted(traced))
            self.emit(
                "GC002",
                node,
                f"Python `{kind}` on tensor value(s) {names} inside compiled "
                f"{ctx.fn_name!r}; use torch.where/torch.cond or pass the "
                "value as a Python scalar",
            )

    def _traced_names_in_bool_test(
        self, test: ast.expr, traced_params: Set[str]
    ) -> Set[str]:
        """Traced parameter names whose runtime VALUE the test branches on.

        Conservative by construction: identity tests (``is``/``is not``),
        ``isinstance``/callable probes, and attribute accesses (``x.ndim``,
        ``x.shape``) are compile-time Python values, not tensors — only
        bare names, value comparisons, boolean combinations, and negations
        of those read a tensor's value.
        """
        if isinstance(test, ast.Name):
            return {test.id} & traced_params
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._traced_names_in_bool_test(test.operand, traced_params)
        if isinstance(test, ast.BoolOp):
            out: Set[str] = set()
            for value in test.values:
                out |= self._traced_names_in_bool_test(value, traced_params)
            return out
        if isinstance(test, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
                return set()
            out = set()
            for operand in [test.left, *test.comparators]:
                if isinstance(operand, ast.Name):
                    out |= {operand.id} & traced_params
                elif isinstance(operand, ast.BinOp):
                    for sub in ast.walk(operand):
                        if isinstance(sub, ast.Name):
                            out |= {sub.id} & traced_params
            return out
        return set()

    # ----------------------------------------------------------- assignment

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._tensor_names and _is_torch_rooted(node.value, self.alias):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self._tensor_names[-1].add(target.id)
        for target in node.targets:
            self._bind_read_handles(node.value, target)
        self.generic_visit(node)

    # ------------------------------------------------- GC009 (stats bypass)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        """GC009: ``x.y += n`` where ``x`` is a stats/counters object —
        the mutation bypasses the owner's lock/registry-backed methods.
        Matched on the holder's name (any dotted segment named ``stats``/
        ``counters`` or suffixed ``_stats``/``_counters``), so the rule
        follows the objects wherever they are threaded."""
        target = node.target
        if isinstance(target, ast.Attribute):
            base = _dotted(target.value, self.alias)
            if base is not None and any(
                seg in ("stats", "counters")
                or seg.endswith("_stats")
                or seg.endswith("_counters")
                for seg in base.split(".")
            ):
                self.emit(
                    "GC009",
                    node,
                    f"direct `{base}.{target.attr} {_AUG_OPS.get(type(node.op).__name__, 'op')}= ...` "
                    "bypasses the stats object's accounting methods (lock "
                    "+ metrics registry); use its add_*() method so the "
                    "count is thread-safe and lands in the run manifest",
                )
        self.generic_visit(node)

    # ------------------------------------------- GC013 (journal records)

    def visit_Dict(self, node: ast.Dict) -> None:
        """GC013: a journal protocol record built as a dict literal
        outside serve/journal.py — matched on the shape itself (an
        ``"event"`` key naming a protocol event), so the rule catches a
        hand-rolled record whatever it is assigned to or passed into."""
        if self.relpath != _JOURNAL_MODULE:
            for key, value in zip(node.keys, node.values):
                if (
                    isinstance(key, ast.Constant)
                    and key.value == "event"
                    and isinstance(value, ast.Constant)
                    and value.value in _JOURNAL_EVENTS
                ):
                    self.emit(
                        "GC013",
                        node,
                        f"journal {value.value!r} record constructed as a "
                        "dict literal outside serve/journal.py; use "
                        f"journal.{value.value}_record(...) (or the "
                        "JobJournal method) so the record shape stays one "
                        "`graftcheck proto` has proven",
                    )
                    break
        self.generic_visit(node)

    # ----------------------------------------------------------------- call

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func, self.alias)
        method = node.func.attr if isinstance(node.func, ast.Attribute) else None

        # GC003: compile construction inside a loop body.
        if self._loop_depth > 0 and _compiled_call(node, name, self.alias):
            self.emit(
                "GC003",
                node,
                "a compiled callable constructed inside a loop — every "
                "iteration compiles a fresh callable (recompile storm); "
                "hoist it out of the loop",
            )

        # GC004: torch at import time (module/class body, not inside a def).
        if self._func_depth == 0 and name and name.startswith("torch."):
            self.emit(
                "GC004",
                node,
                f"{name}(...) executed at import time builds tensors (on a "
                "device: initializes CUDA, breaking a later fork) as an "
                "import side effect; move into a function or use numpy",
            )

        # GC006: bare lock construction in ingest code.
        if name in _LOCK_CTORS and not self._has_lock_order_comment(
            node.lineno
        ):
            self.emit(
                "GC006",
                node,
                f"{name}() in ingest code without the lock-ordering idiom; "
                "add a `# lock order: ...` comment on or just above this "
                "line stating what may be held when taking it",
            )

        # GC007: per-iteration device sync (torch.cuda.synchronize(), an
        # event's or a stream's .synchronize()).
        if self._loop_depth > 0 and method == "synchronize":
            self.emit(
                "GC007",
                node,
                f"{name or '.synchronize'}() inside a loop serializes launches "
                "against compute; sync once after the loop or bound the "
                "in-flight window",
            )

        # GC008: print under compile.
        if self._compiled_stack and name == "print":
            self.emit(
                "GC008",
                node,
                f"print() inside compiled {self._compiled_stack[-1].fn_name!r} "
                "breaks the graph; print outside the compiled function",
            )

        # GC010: host numpy call inside a compiled kernel body.
        if (
            self._compiled_stack
            and name
            and name.startswith("numpy.")
            and name not in _NP_DTYPE_CTORS
        ):
            self.emit(
                "GC010",
                node,
                f"{name.replace('numpy', 'np')}(...) inside compiled "
                f"{self._compiled_stack[-1].fn_name!r} runs on the HOST: it "
                "breaks the graph or bakes a compile-time constant into the "
                "compiled program; use the torch equivalent",
            )

        # GC012: .read*() on a raw read-mode handle outside stream.py.
        if (
            method in ("read", "read1", "readline", "readlines")
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in self._read_handles[-1]
        ):
            self.emit(
                "GC012",
                node,
                f"`{node.func.value.id}.{method}()` on a raw "
                "read-mode file handle outside the stream abstraction; "
                "route the read through sources/stream.py "
                "(open_binary/iter_byte_windows) so the hostmem totality "
                "proof covers it",
            )

        # GC013: a journal appender's private _append outside journal.py
        # (the public record methods are the protocol surface; _append
        # would smuggle an arbitrary record past the proven shapes).
        if (
            self.relpath != _JOURNAL_MODULE
            and method == "_append"
            and "journal" in (_dotted(node.func.value, self.alias) or "").lower()
        ):
            self.emit(
                "GC013",
                node,
                "journal._append() called outside serve/journal.py — the "
                "appender's private seam bypasses the record constructors "
                "`graftcheck proto` proves the protocol against; use the "
                "JobJournal record methods",
            )

        # GC011: narrowing cast without a range justification.
        self._check_narrowing_cast(node, method)

        # GC001: implicit device→host sync in hot paths.
        self._check_host_sink(node, name, method)

        self.generic_visit(node)

    def _check_narrowing_cast(self, node: ast.Call, method: Optional[str]) -> None:
        """GC011: ``.to(<narrow dtype>)``, ``.type(<narrow dtype>)`` and
        numpy's ``.astype(<narrow dtype>)`` in ops/ must carry a ``# range:``
        justification (or an ``ops/contracts`` reference) within the comment
        window — the operand-range claim behind a narrowing cast belongs
        next to the cast. Dynamic targets (a dtype held in a variable, e.g.
        ``operand_dtype``) are skipped: their range story lives at the
        variable's producer."""
        if method == "astype":
            candidates = node.args if len(node.args) == 1 and not node.keywords else []
        elif method in ("to", "type"):
            candidates = list(node.args) + [
                kw.value for kw in node.keywords if kw.arg == "dtype"
            ]
        else:
            return
        leaf = None
        for target in candidates:
            dotted = _dotted(target, self.alias)
            if dotted is None:
                continue  # dtype variable / np.dtype(...) call — producer's story
            dtype = _TORCH_DTYPE_ALIASES.get(dotted, dotted.rsplit(".", 1)[-1])
            if dtype in _NARROW_CAST_TARGETS:
                leaf = dtype
                break
        if leaf is None or self._has_range_comment(node.lineno):
            return
        self.emit(
            "GC011",
            node,
            f"narrowing cast to {leaf} without a range justification; add "
            "a `# range: ...` comment (or reference the operand's "
            "ops/contracts.py contract) stating why every value fits the "
            "destination's exact window",
        )

    def _check_host_sink(
        self, node: ast.Call, name: Optional[str], method: Optional[str]
    ) -> None:
        if name in _HOST_SINKS and len(node.args) == 1:
            if self._is_tensor_value(node.args[0]):
                self.emit(
                    "GC001",
                    node,
                    f"{name}() on a tensor value forces an implicit "
                    "device→host sync in hot-path code; keep the value on "
                    "device or batch the fetch",
                )
            return
        if node.args or node.keywords or method is None:
            return
        receiver = node.func.value
        if method == "tolist":
            syncs = self._is_tensor_value(receiver)
        else:
            # `.cpu().numpy()` is one fetch, reported at its .cpu().
            syncs = method in _HOST_SYNC_METHODS and not (
                method == "numpy"
                and isinstance(receiver, ast.Call)
                and isinstance(receiver.func, ast.Attribute)
                and receiver.func.attr == "cpu"
            )
        if syncs:
            self.emit(
                "GC001",
                node,
                f".{method}() forces a device→host sync per call in hot-path "
                "code; batch values and fetch once",
            )


def lint_source(
    source: str, relpath: str, honor_disables: bool = True
) -> List[Finding]:
    """Lint one file's text; ``relpath`` (package-relative, '/'-separated)
    drives rule scoping. Returns findings sorted by (line, rule)."""
    tree = ast.parse(source, filename=relpath)
    alias = _collect_aliases(tree)
    visitor = _LintVisitor(relpath, source.splitlines(), alias)
    visitor.visit(tree)
    findings = visitor.findings
    if honor_disables:
        per_line, whole_file = parse_disables(source)
        findings = apply_disables(findings, per_line, whole_file)
    return sorted(findings, key=lambda f: (f.line, f.rule_id, f.col))


def lint_paths(paths: Sequence[str]) -> Tuple[List[Finding], int]:
    """Lint files/trees; returns ``(findings, files_checked)``."""
    findings: List[Finding] = []
    checked = 0
    for root in paths:
        for full, relpath in _iter_py_files(root):
            with open(full, "r", encoding="utf-8") as f:
                source = f.read()
            try:
                findings.extend(lint_source(source, relpath))
            except SyntaxError as e:
                findings.append(
                    Finding(
                        "GC000",
                        relpath,
                        e.lineno or 0,
                        (e.offset or 0),
                        f"syntax error: {e.msg}",
                    )
                )
            checked += 1
    return findings, checked


def json_report(findings: Sequence[Finding], checked: int) -> str:
    """Machine-readable report (one stable schema for CI tooling)."""
    return json.dumps(
        {
            "tool": "graftcheck",
            "checked_files": checked,
            "finding_count": len(findings),
            "findings": [f.to_json() for f in findings],
        },
        indent=2,
    )


__all__ = ["lint_source", "lint_paths", "json_report"]
