"""Static lock-acquisition-order analysis (``graftcheck lockgraph``).

The port's copy of ``spark_examples_tpu/check/lockgraph.py``, over the
port's tree. Its threads are real: the parse-pool workers
(``sources/files.py``), the prefetch producer (``pipeline/datasets.py``),
the heartbeat thread (``obs/heartbeat.py``), the serve daemon's HTTP,
slice-worker, lease and steal threads (``serve/daemon.py``) and the driver
thread share the parsed-table caches, the metrics registry, the span
recorder, the job table and the journal. This pass builds the static
lock-acquisition graph the code can execute and rejects the four shapes
that turn that concurrency into a hang:

- **GL001** — a cycle in the acquisition-order graph (two threads taking
  the member locks in opposite orders deadlock);
- **GL002** — a lock held across a device sync (``torch.cuda.synchronize``,
  a stream's or event's ``synchronize``, or the reference's
  ``block_until_ready``): every contending thread stalls behind a device
  round-trip;
- **GL003** — a lock held across a blocking queue ``put``/``get`` (if the
  draining thread needs the same lock, backpressure becomes deadlock);
- **GL004** — a possible re-acquisition of a non-reentrant
  ``threading.Lock`` already held on the same call path.

The analysis is deliberately syntactic-plus-one-call-graph: per function it
records ``with <lock>:`` nesting and the calls made while holding, then
propagates acquired-lock/blocking-op summaries through the intra-package
call graph to a fixpoint. Attribute calls on untyped receivers resolve
only when the method name is unique (and not a generic stdlib name) across
the analyzed tree — a documented over/under-approximation: property
accesses that take locks (``Gauge.value``) and locks inside the stdlib
(``queue.Queue``'s internal mutex) are invisible, while branch-insensitive
merging may hold locks slightly longer than runtime does. Escape hatch:
``# graftcheck: disable=GLnnn -- why`` on the reported line. On the same
source both packages give the same graph and findings, save that the
port also counts a ``synchronize`` call as a device sync.

The graph itself is emitted as a DOT artifact (``--dot``), one node per
lock (``relpath::Class.attr``), one edge per observed acquisition order,
so the ordering contract is a reviewable artifact.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_examples_tpu_torch.check.linter import (
    _LOCK_CTORS,
    _collect_aliases,
    _dotted,
    _iter_py_files,
)
from spark_examples_tpu_torch.check.rules import Finding, apply_disables, parse_disables

#: The package whose dotted names resolve into the analyzed modules.
_PACKAGE = __name__.split(".", 1)[0]

#: Imported functions that wait for the device (GL002), besides any
#: ``.synchronize()``/``.block_until_ready()`` call.
_SYNC_CALLS = ("torch.cuda.synchronize", "jax.block_until_ready")

#: Attribute-call names never resolved through the unique-method heuristic:
#: too generic — they name stdlib/container methods far more often than a
#: package method, and a wrong edge is worse than a missing one.
_GENERIC_METHOD_NAMES = {
    "get",
    "put",
    "items",
    "keys",
    "values",
    "append",
    "extend",
    "pop",
    "add",
    "close",
    "read",
    "write",
    "join",
    "start",
    "run",
    "result",
    "submit",
    "acquire",
    "release",
    "update",
    "copy",
    "clear",
    "format",
    "split",
    "strip",
    "encode",
    "decode",
    "flush",
    "send",
    "recv",
    "next",
    "sort",
    "index",
    "count",
    "setdefault",
}

#: Max call-graph propagation rounds (the package call graph is shallow;
#: this bounds pathological recursion, not expected depth).
_FIXPOINT_ROUNDS = 30


# --------------------------------------------------------------------------
# Event model.
# --------------------------------------------------------------------------


@dataclass
class _Acquire:
    ref: Tuple  # unresolved lock reference
    line: int
    inner: List[object]


@dataclass
class _Call:
    ref: Tuple  # unresolved callee reference
    line: int
    label: str


@dataclass
class _Blocking:
    kind: str  # "sync" | "queue"
    line: int
    detail: str


@dataclass(frozen=True)
class LockNode:
    key: str
    relpath: str
    line: int
    ctor: str
    reentrant: bool


@dataclass(frozen=True)
class LockEdge:
    src: str
    dst: str
    relpath: str
    line: int
    via: str


@dataclass
class _ClassInfo:
    name: str
    bases: List[str]
    lock_attrs: Dict[str, str]  # attr -> lock key


@dataclass
class _FunctionInfo:
    fkey: Tuple[str, str]  # (relpath, qualname)
    events: List[object]
    cls: Optional[str]


@dataclass
class _Module:
    relpath: str
    classes: Dict[str, _ClassInfo]
    functions: Dict[str, _FunctionInfo]
    source: str


# --------------------------------------------------------------------------
# Per-module extraction.
# --------------------------------------------------------------------------


class _ModuleScanner:
    def __init__(self, relpath: str, tree: ast.Module, source: str):
        self.relpath = relpath
        self.alias = _collect_aliases(tree)
        self.classes: Dict[str, _ClassInfo] = {}
        self.functions: Dict[str, _FunctionInfo] = {}
        self.module_locks: Dict[str, str] = {}  # module-level name -> key
        self.lock_nodes: List[LockNode] = []
        self._scan_module(tree)
        self.module = _Module(relpath, self.classes, self.functions, source)

    # ------------------------------------------------------------ discovery

    def _lock_ctor(self, node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Call):
            name = _dotted(node.func, self.alias)
            if name in _LOCK_CTORS:
                return name
        return None

    def _register_lock(
        self, key: str, line: int, ctor: str
    ) -> None:
        self.lock_nodes.append(
            LockNode(key, self.relpath, line, ctor, ctor == "threading.RLock")
        )

    @staticmethod
    def _assign_targets(node: ast.stmt) -> Tuple[Optional[ast.expr], List[ast.expr]]:
        """``(value, targets)`` of a plain or annotated assignment —
        ``x: Lock = threading.Lock()`` must register exactly like the
        unannotated form (the strict-typing promotion makes annotations
        the norm, and an invisible lock disables every GL rule for it)."""
        if isinstance(node, ast.Assign):
            return node.value, list(node.targets)
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            return node.value, [node.target]
        return None, []

    def _scan_module(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._scan_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(node, cls=None, prefix="")
            else:
                value, targets = self._assign_targets(node)
                ctor = self._lock_ctor(value) if value is not None else None
                if ctor:
                    for target in targets:
                        if isinstance(target, ast.Name):
                            key = f"{self.relpath}::{target.id}"
                            self.module_locks[target.id] = key
                            self._register_lock(key, node.lineno, ctor)

    def _scan_class(self, node: ast.ClassDef) -> None:
        bases = [
            b.id for b in node.bases if isinstance(b, ast.Name)
        ]
        info = _ClassInfo(node.name, bases, {})
        self.classes[node.name] = info
        for item in node.body:
            # Class-body lock attributes (shared class-level locks),
            # plain or annotated.
            value, targets = self._assign_targets(item)
            ctor = self._lock_ctor(value) if value is not None else None
            if ctor:
                for target in targets:
                    if isinstance(target, ast.Name):
                        key = f"{self.relpath}::{node.name}.{target.id}"
                        info.lock_attrs[target.id] = key
                        self._register_lock(key, item.lineno, ctor)
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # Lock attribute definitions: self.X = threading.Lock(),
                # plain or annotated.
                for sub in ast.walk(item):
                    value, targets = self._assign_targets(sub)
                    ctor = self._lock_ctor(value) if value is not None else None
                    if not ctor:
                        continue
                    for target in targets:
                        if (
                            isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"
                        ):
                            key = (
                                f"{self.relpath}::{node.name}."
                                f"{target.attr}"
                            )
                            info.lock_attrs[target.attr] = key
                            self._register_lock(key, sub.lineno, ctor)
                self._scan_function(item, cls=node.name, prefix=f"{node.name}.")

    def _scan_function(
        self,
        node,
        cls: Optional[str],
        prefix: str,
    ) -> None:
        qualname = prefix + node.name
        events = self._events_of_body(node.body, cls)
        self.functions[qualname] = _FunctionInfo(
            (self.relpath, qualname), events, cls
        )
        # Nested defs become separately-callable entries (closures the
        # enclosing function hands to pools/threads).
        for item in ast.walk(node):
            if (
                isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                and item is not node
            ):
                inner_q = f"{qualname}.{item.name}"
                if inner_q not in self.functions:
                    self.functions[inner_q] = _FunctionInfo(
                        (self.relpath, inner_q),
                        self._events_of_body(item.body, cls),
                        cls,
                    )

    # --------------------------------------------------------------- events

    def _resolve_lock_ref(
        self, node: ast.expr, cls: Optional[str]
    ) -> Optional[Tuple]:
        """A lock *reference* at a use site, resolved later against the
        global table: ``self.X`` -> ("self", relpath, cls, X); bare module
        name -> ("module", relpath, name); anything else dotted ->
        ("attr", last_segment)."""
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and cls is not None
        ):
            return ("self", self.relpath, cls, node.attr)
        if isinstance(node, ast.Name):
            if node.id in self.module_locks:
                return ("module", self.relpath, node.id)
            return None
        if isinstance(node, ast.Attribute):
            return ("attr", node.attr)
        return None

    def _looks_like_lock(self, node: ast.expr, cls: Optional[str]) -> bool:
        """Whether a with-item plausibly names a lock: self.X where X is a
        known lock attr of this module, a module-level lock name, or any
        name/attr whose last segment contains 'lock'/'mutex'."""
        ref = self._resolve_lock_ref(node, cls)
        if ref is None:
            return False
        if ref[0] == "module":
            return True
        if ref[0] == "self":
            attr = ref[3]
            for info in self.classes.values():
                if attr in info.lock_attrs:
                    return True
            return "lock" in attr.lower() or "mutex" in attr.lower()
        return "lock" in ref[1].lower() or "mutex" in ref[1].lower()

    def _call_event(
        self, node: ast.Call, cls: Optional[str]
    ) -> Optional[object]:
        func = node.func
        # Blocking ops first — they are findings, not call-graph edges.
        if isinstance(func, ast.Attribute):
            if func.attr in ("block_until_ready", "synchronize"):
                return _Blocking("sync", node.lineno, f".{func.attr}()")
            if func.attr in ("put", "get"):
                receiver = _dotted(func.value, self.alias) or ""
                last = receiver.rsplit(".", 1)[-1].lower()
                if "queue" in receiver.lower() or last in ("q", "jobs"):
                    nonblocking = any(
                        kw.arg == "block"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is False
                        for kw in node.keywords
                    )
                    if not nonblocking:
                        return _Blocking(
                            "queue",
                            node.lineno,
                            f"{receiver}.{func.attr}()",
                        )
                return None
        name = _dotted(func, self.alias)
        if name in _SYNC_CALLS:
            return _Blocking("sync", node.lineno, f"{name}()")
        if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ):
            if func.value.id == "self" and cls is not None:
                return _Call(
                    ("self_method", self.relpath, cls, func.attr),
                    node.lineno,
                    f"self.{func.attr}",
                )
        if name is not None:
            head = name.split(".")[0]
            if "." not in name:
                return _Call(
                    ("local", self.relpath, name), node.lineno, name
                )
            if head not in ("self",):
                return _Call(("dotted", name), node.lineno, name)
        if isinstance(func, ast.Attribute):
            if func.attr not in _GENERIC_METHOD_NAMES:
                return _Call(
                    ("method", func.attr), node.lineno, f".{func.attr}"
                )
        return None

    def _expr_events(self, node: ast.AST, cls: Optional[str]) -> List[object]:
        events: List[object] = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                # `lock.acquire()` as an expression: modeled by the caller
                # (statement walker); other calls become events here.
                ev = self._call_event(sub, cls)
                if ev is not None:
                    events.append(ev)
        return events

    def _acquire_call(
        self, stmt: ast.stmt, cls: Optional[str]
    ) -> Optional[Tuple[Tuple, int]]:
        """`X.acquire()` statement -> (lock ref, line)."""
        node = stmt.value if isinstance(stmt, ast.Expr) else None
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "acquire"
        ):
            ref = self._resolve_lock_ref(node.func.value, cls)
            if ref is not None and self._looks_like_lock(node.func.value, cls):
                return ref, node.lineno
        return None

    def _events_of_body(
        self, stmts: Sequence[ast.stmt], cls: Optional[str]
    ) -> List[object]:
        events: List[object] = []
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                held_here: List[Tuple[Tuple, int]] = []
                for item in stmt.items:
                    ctx = item.context_expr
                    if self._looks_like_lock(ctx, cls):
                        ref = self._resolve_lock_ref(ctx, cls)
                        if ref is not None:
                            held_here.append((ref, ctx.lineno))
                            continue
                    events.extend(self._expr_events(ctx, cls))
                body = self._events_of_body(stmt.body, cls)
                for ref, line in reversed(held_here):
                    body = [_Acquire(ref, line, body)]
                events.extend(body)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                events.extend(self._expr_events(getattr(stmt, "iter", stmt), cls))
                events.extend(self._events_of_body(stmt.body, cls))
                events.extend(self._events_of_body(stmt.orelse, cls))
            elif isinstance(stmt, ast.If):
                events.extend(self._expr_events(stmt.test, cls))
                events.extend(self._events_of_body(stmt.body, cls))
                events.extend(self._events_of_body(stmt.orelse, cls))
            elif isinstance(stmt, ast.Try):
                events.extend(self._events_of_body(stmt.body, cls))
                for handler in stmt.handlers:
                    events.extend(self._events_of_body(handler.body, cls))
                events.extend(self._events_of_body(stmt.orelse, cls))
                events.extend(self._events_of_body(stmt.finalbody, cls))
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # separate entry via _scan_function
            else:
                acq = self._acquire_call(stmt, cls)
                if acq is not None:
                    # `.acquire()` without `with`: conservatively held for
                    # the remainder of this suite (release() is ignored).
                    rest = self._events_of_body(stmts[i + 1 :], cls)
                    events.append(_Acquire(acq[0], acq[1], rest))
                    break
                events.extend(self._expr_events(stmt, cls))
        return events


# --------------------------------------------------------------------------
# Global resolution + fixpoint.
# --------------------------------------------------------------------------


class LockGraph:
    """The resolved graph plus every GL finding."""

    def __init__(self) -> None:
        self.nodes: Dict[str, LockNode] = {}
        self.edges: Dict[Tuple[str, str], LockEdge] = {}
        self.findings: List[Finding] = []

    @property
    def ok(self) -> bool:
        return not self.findings

    def cycles(self) -> List[List[str]]:
        """Cycles in the acquisition-order graph (each reported once)."""
        adjacency: Dict[str, List[str]] = {}
        for (src, dst) in self.edges:
            adjacency.setdefault(src, []).append(dst)
        seen_cycles: List[List[str]] = []
        state: Dict[str, int] = {}  # 0 unvisited, 1 on stack, 2 done
        stack: List[str] = []

        def dfs(node: str) -> None:
            state[node] = 1
            stack.append(node)
            for nxt in adjacency.get(node, ()):
                if state.get(nxt, 0) == 0:
                    dfs(nxt)
                elif state.get(nxt) == 1:
                    cycle = stack[stack.index(nxt) :] + [nxt]
                    normalized = sorted(set(cycle))
                    if normalized not in [
                        sorted(set(c)) for c in seen_cycles
                    ]:
                        seen_cycles.append(cycle)
            stack.pop()
            state[node] = 2

        for node in list(adjacency):
            if state.get(node, 0) == 0:
                dfs(node)
        return seen_cycles

    def to_dot(self) -> str:
        lines = [
            "digraph lock_order {",
            "  rankdir=LR;",
            '  node [shape=box, fontname="monospace", fontsize=10];',
        ]
        for key in sorted(self.nodes):
            node = self.nodes[key]
            shape = "box" if not node.reentrant else "ellipse"
            lines.append(
                f'  "{key}" [shape={shape}, label="{key}\\n'
                f'{node.ctor} @ {node.relpath}:{node.line}"];'
            )
        for (src, dst), edge in sorted(self.edges.items()):
            lines.append(
                f'  "{src}" -> "{dst}" '
                f'[label="{edge.relpath}:{edge.line}{edge.via}"];'
            )
        lines.append("}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> str:
        return json.dumps(
            {
                "tool": "graftcheck-lockgraph",
                "ok": self.ok,
                "locks": [
                    {
                        "key": n.key,
                        "path": n.relpath,
                        "line": n.line,
                        "ctor": n.ctor,
                        "reentrant": n.reentrant,
                    }
                    for n in sorted(self.nodes.values(), key=lambda n: n.key)
                ],
                "edges": [
                    {
                        "src": e.src,
                        "dst": e.dst,
                        "path": e.relpath,
                        "line": e.line,
                        "via": e.via,
                    }
                    for e in sorted(
                        self.edges.values(), key=lambda e: (e.src, e.dst)
                    )
                ],
                "finding_count": len(self.findings),
                "findings": [f.to_json() for f in self.findings],
            },
            indent=2,
        )

    def format(self) -> str:
        lines = [
            f"  locks: {len(self.nodes)}, acquisition-order edges: "
            f"{len(self.edges)}"
        ]
        for (src, dst), edge in sorted(self.edges.items()):
            lines.append(f"  order: {src} -> {dst}  ({edge.relpath}:{edge.line})")
        for f in self.findings:
            lines.append(f"  {f.format()}")
        verdict = (
            "acyclic, clean"
            if self.ok
            else f"{len(self.findings)} finding(s)"
        )
        lines.append(f"graftcheck lockgraph: {verdict}")
        return "\n".join(lines)


def _resolve_lock(
    ref: Tuple,
    modules: Dict[str, _ModuleScanner],
    all_locks: Dict[str, LockNode],
) -> Optional[str]:
    kind = ref[0]
    if kind == "module":
        _, relpath, name = ref
        return modules[relpath].module_locks.get(name)
    if kind == "self":
        _, relpath, cls, attr = ref
        scanner = modules[relpath]
        seen: Set[str] = set()
        frontier = [cls]
        while frontier:
            cname = frontier.pop()
            if cname in seen:
                continue
            seen.add(cname)
            info = scanner.classes.get(cname)
            if info is None:
                continue
            if attr in info.lock_attrs:
                return info.lock_attrs[attr]
            frontier.extend(info.bases)
        # Fall through: unique attr-name match across the tree.
        kind, attr = "attr", attr
    if kind == "attr":
        attr = ref[-1]
        # Strip the module prefix BEFORE taking the attribute tail, or the
        # '.py' in 'mod.py::global_lock' eats the split and module-level
        # locks never match.
        candidates = [
            k
            for k in all_locks
            if k.split("::", 1)[-1].rsplit(".", 1)[-1] == attr
        ]
        if len(candidates) == 1:
            return candidates[0]
    return None


def _method_index(
    modules: Dict[str, _ModuleScanner],
) -> Dict[str, List[Tuple[str, str]]]:
    index: Dict[str, List[Tuple[str, str]]] = {}
    for relpath, scanner in modules.items():
        for qualname in scanner.functions:
            short = qualname.rsplit(".", 1)[-1]
            index.setdefault(short, []).append((relpath, qualname))
    return index


def _module_relpath_for(dotted: str, modules: Dict[str, _ModuleScanner]) -> Optional[Tuple[str, str]]:
    """``spark_examples_tpu_torch.obs.metrics.foo`` -> (relpath, "foo") when
    that module is in the analyzed set."""
    parts = dotted.split(".")
    if parts[0] != _PACKAGE or len(parts) < 3:
        return None
    mod_rel = "/".join(parts[1:-1]) + ".py"
    if mod_rel in modules:
        return mod_rel, parts[-1]
    return None


def _resolve_call(
    ref: Tuple,
    modules: Dict[str, _ModuleScanner],
    method_index: Dict[str, List[Tuple[str, str]]],
    caller: Optional[Tuple[str, str]] = None,
) -> Optional[Tuple[str, str]]:
    kind = ref[0]
    if kind == "self_method":
        _, relpath, cls, name = ref
        scanner = modules[relpath]
        seen: Set[str] = set()
        frontier = [cls]
        while frontier:
            cname = frontier.pop()
            if cname in seen:
                continue
            seen.add(cname)
            info = scanner.classes.get(cname)
            if info is None:
                continue
            qual = f"{cname}.{name}"
            if qual in scanner.functions:
                return (relpath, qual)
            frontier.extend(info.bases)
        return None
    if kind == "local":
        _, relpath, name = ref
        scanner = modules[relpath]
        # A bare call from inside a function first binds to a nested def
        # (closures the enclosing function hands to pools/threads) at any
        # enclosing level, then the module scope — mirror that.
        if caller is not None and caller[0] == relpath:
            parts = caller[1].split(".")
            for depth in range(len(parts), 0, -1):
                nested = ".".join(parts[:depth] + [name])
                if nested in scanner.functions:
                    return (relpath, nested)
        if name in scanner.functions:
            return (relpath, name)
        if name in scanner.classes:
            init = f"{name}.__init__"
            if init in scanner.functions:
                return (relpath, init)
        return None
    if kind == "dotted":
        dotted = ref[1]
        resolved = _module_relpath_for(dotted, modules)
        if resolved is not None:
            relpath, name = resolved
            scanner = modules[relpath]
            if name in scanner.functions:
                return (relpath, name)
            if name in scanner.classes:
                init = f"{name}.__init__"
                if init in scanner.functions:
                    return (relpath, init)
        # A class imported by name: `_Family(...)` resolves as local above;
        # `metrics._Family(...)` lands here with the class's dotted name.
        return None
    if kind == "method":
        name = ref[1]
        if name in _GENERIC_METHOD_NAMES:
            return None
        hits = method_index.get(name, [])
        # Unique across the tree, counting the bare and Class.name forms as
        # distinct candidates only when they live in different classes.
        if len(hits) == 1:
            return hits[0]
        return None
    return None


def build_lock_graph(paths: Sequence[str]) -> LockGraph:
    """Analyze ``paths`` (files or package trees) into a :class:`LockGraph`."""
    graph = LockGraph()
    modules: Dict[str, _ModuleScanner] = {}
    raw_findings: Dict[str, List[Finding]] = {}

    for root in paths:
        for full, relpath in _iter_py_files(root):
            with open(full, "r", encoding="utf-8") as f:
                source = f.read()
            try:
                tree = ast.parse(source, filename=relpath)
            except SyntaxError:
                continue  # GC000 is the linter's finding, not ours
            modules[relpath] = _ModuleScanner(relpath, tree, source)

    all_locks: Dict[str, LockNode] = {}
    for scanner in modules.values():
        for node in scanner.lock_nodes:
            all_locks[node.key] = node
    graph.nodes = all_locks
    method_index = _method_index(modules)

    # ------------------------------------------------- per-function summary
    acquires: Dict[Tuple[str, str], Set[str]] = {}
    blocking: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
    fn_table: Dict[Tuple[str, str], _FunctionInfo] = {}
    for relpath, scanner in modules.items():
        for qualname, info in scanner.functions.items():
            fn_table[(relpath, qualname)] = info
            acquires[(relpath, qualname)] = set()
            blocking[(relpath, qualname)] = set()

    def direct_pass(info: _FunctionInfo) -> Tuple[Set[str], Set[Tuple[str, str]], Set[Tuple[str, str]]]:
        acq: Set[str] = set()
        blk: Set[Tuple[str, str]] = set()
        calls: Set[Tuple[str, str]] = set()

        def walk(events: List[object]) -> None:
            for ev in events:
                if isinstance(ev, _Acquire):
                    key = _resolve_lock(ev.ref, modules, all_locks)
                    if key is not None:
                        acq.add(key)
                    walk(ev.inner)
                elif isinstance(ev, _Call):
                    fk = _resolve_call(
                        ev.ref, modules, method_index, caller=info.fkey
                    )
                    if fk is not None:
                        calls.add(fk)
                elif isinstance(ev, _Blocking):
                    blk.add((ev.kind, ev.detail))

        walk(info.events)
        return acq, blk, calls

    call_edges: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
    for fkey, info in fn_table.items():
        acq, blk, calls = direct_pass(info)
        acquires[fkey] = acq
        blocking[fkey] = blk
        call_edges[fkey] = calls

    for _ in range(_FIXPOINT_ROUNDS):
        changed = False
        for fkey, calls in call_edges.items():
            for callee in calls:
                if not acquires[callee] <= acquires[fkey]:
                    acquires[fkey] |= acquires[callee]
                    changed = True
                if not blocking[callee] <= blocking[fkey]:
                    blocking[fkey] |= blocking[callee]
                    changed = True
        if not changed:
            break

    # ------------------------------------------------- held-set final pass
    def emit(rule_id: str, relpath: str, line: int, detail: str) -> None:
        raw_findings.setdefault(relpath, []).append(
            Finding(rule_id, relpath, line, 1, detail)
        )

    def add_edge(src: str, dst: str, relpath: str, line: int, via: str) -> None:
        if src == dst:
            return
        self_key = (src, dst)
        if self_key not in graph.edges:
            graph.edges[self_key] = LockEdge(src, dst, relpath, line, via)

    def final_walk(
        info: _FunctionInfo, events: List[object], held: Tuple[str, ...]
    ) -> None:
        relpath = info.fkey[0]
        for ev in events:
            if isinstance(ev, _Acquire):
                key = _resolve_lock(ev.ref, modules, all_locks)
                if key is None:
                    final_walk(info, ev.inner, held)
                    continue
                for h in held:
                    add_edge(h, key, relpath, ev.line, "")
                if key in held and not all_locks[key].reentrant:
                    emit(
                        "GL004",
                        relpath,
                        ev.line,
                        f"non-reentrant {key} re-acquired while already "
                        "held on this call path — self-deadlock",
                    )
                final_walk(info, ev.inner, held + (key,))
            elif isinstance(ev, _Call):
                if not held:
                    continue
                fk = _resolve_call(
                    ev.ref, modules, method_index, caller=info.fkey
                )
                if fk is None:
                    continue
                for lock_key in acquires.get(fk, ()):
                    for h in held:
                        add_edge(
                            h, lock_key, relpath, ev.line, f" via {ev.label}"
                        )
                    if lock_key in held and not all_locks[lock_key].reentrant:
                        emit(
                            "GL004",
                            relpath,
                            ev.line,
                            f"call to {ev.label} may re-acquire "
                            f"non-reentrant {lock_key} already held here",
                        )
                for kind, detail in blocking.get(fk, ()):
                    rule = "GL002" if kind == "sync" else "GL003"
                    emit(
                        rule,
                        relpath,
                        ev.line,
                        f"lock(s) {', '.join(held)} held across {detail} "
                        f"(via {ev.label})",
                    )
            elif isinstance(ev, _Blocking):
                if not held:
                    continue
                rule = "GL002" if ev.kind == "sync" else "GL003"
                what = (
                    "a device sync"
                    if ev.kind == "sync"
                    else "a blocking queue op"
                )
                emit(
                    rule,
                    relpath,
                    ev.line,
                    f"lock(s) {', '.join(held)} held across {what}: "
                    f"{ev.detail}",
                )

    for fkey, info in fn_table.items():
        final_walk(info, info.events, ())

    # ---------------------------------------------------------- GL001 cycles
    for cycle in graph.cycles():
        first_edge = graph.edges.get((cycle[0], cycle[1]))
        relpath = first_edge.relpath if first_edge else cycle[0].split("::")[0]
        line = first_edge.line if first_edge else 0
        emit(
            "GL001",
            relpath,
            line,
            "lock-acquisition-order cycle: " + " -> ".join(cycle),
        )

    # -------------------------------------------------------- escape hatches
    for relpath, found in raw_findings.items():
        scanner = modules.get(relpath)
        if scanner is None:
            graph.findings.extend(found)
            continue
        per_line, whole_file = parse_disables(scanner.module.source)
        graph.findings.extend(apply_disables(found, per_line, whole_file))
    graph.findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return graph


def default_lock_paths() -> List[str]:
    """The package tree (locks live in the ingest, obs and serve layers,
    but scanning everything keeps new locks covered by default)."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


__all__ = [
    "LockEdge",
    "LockGraph",
    "LockNode",
    "build_lock_graph",
    "default_lock_paths",
]
