"""Static host-memory auditing (``graftcheck hostmem``) and the
configuration-level host-memory bound.

The port's copy of ``spark_examples_tpu/check/hostmem.py``, in two halves.

The proof half is an AST dataflow pass over the host-staging layers
(``sources/``, ``pipeline/``, ``ops/``, ``serve/``, ``analyses/``) that
classifies every ingest/consume path as **bounded-window** or **O(file)**:

- a per-function *taint* analysis marks values derived from file handles
  (``open``/``gzip.open``/``_open_text`` results), whole-file reads, and
  streaming block producers;
- five rules (GH001-GH005, ``check/rules.py``) flag the O(file) staging
  shapes: whole-file ``.read()``, unbounded accumulation of stream items
  inside the read loop, ``list()`` materialization of a block stream,
  one-shot ``*.decompress``, and whole-buffer numpy staging.

The audit is a **totality proof**: every source reads through the windowed
stream abstraction (``sources/stream.py``), so the ``hostmem(unbounded)``
escape hatch that would *declare* an O(file) site::

    raw = f.read()  # graftcheck: hostmem(unbounded) -- why this path is O(file)

is itself a finding (GH006). A justified hatch still routes its underlying
GH00x finding into the report's ``declared_unbounded`` inventory, but the
hatch line fails the audit regardless; the port's tree carries none. The
rules, their order and their text are the reference's, so both packages
give the same findings on the same source.

The formula half, :func:`conf_host_peak_bytes` and its private helpers,
resolves a parsed configuration into the arguments of
``parallel/mesh.py:host_peak_bytes`` (the bound the driver registers as
``host_static_bound_bytes`` and the manifest records beside the measured
peak RSS). Reference names and arithmetic are kept, so both packages give
the same bound for the same argv at the same device count and runtime
baseline.

The runtime baseline is the one term that differs by device
(:func:`runtime_baseline_bytes`): the reference's constant, set for a TPU
host, on the CPU; on the card, the process's peak RSS measured at the
driver's set-up once the CUDA runtime and libraries are up (``import
torch`` alone holds more than the constant there), so the bound's data
terms are what a run is held to.

Exit contract (``check/cli.py``): 0 = clean, 1 = findings (an escape hatch
counts as one).
"""

from __future__ import annotations

import ast
import functools
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from spark_examples_tpu_torch.check.linter import (
    _collect_aliases,
    _dotted,
    _iter_py_files,
    _package_relpath,
)
from spark_examples_tpu_torch.check.rules import HOSTMEM_RULES, Finding

#: Callables whose result is a file handle (taint root; `with ... as f`
#: or assignment binds the handle name).
_FILE_OPENERS = frozenset(
    {
        "open",
        "io.open",
        "gzip.open",
        "bz2.open",
        "lzma.open",
        "_open_text",
        "spark_examples_tpu_torch.sources.files._open_text",
    }
)

#: One-shot whole-buffer decompressors (GH004).
_DECOMPRESSORS = frozenset(
    {
        "gzip.decompress",
        "zlib.decompress",
        "bz2.decompress",
        "lzma.decompress",
    }
)

#: Streaming block producers: iterating one is the bounded-window idiom;
#: accumulating its items (GH002) or materializing it whole (GH003) is
#: exactly the O(file) regression the audit exists to catch. Matched on
#: the final attribute/name segment so `self.iter_chunk_arrays()` and
#: `source.stream_genotype_blocks(...)` both resolve.
_STREAM_PRODUCERS = frozenset(
    {
        "_iter_vcf_chunks",
        "iter_chunk_arrays",
        "stream_blocks",
        "stream_genotype_blocks",
        "genotype_blocks",
        "iter_shards",
        "iter_part",
        # sources/stream.py — the one windowed abstraction (its consumers
        # are everywhere; accumulating its items is exactly the O(file)
        # regression this audit exists to catch).
        "iter_byte_windows",
        "iter_text_lines",
        "windowed",
        "iter_records",
        "merge_join",
        "_iter_jsonl_lines",
    }
)

#: numpy staging calls GH005 audits when fed a whole-file buffer.
_NP_STAGING = frozenset(
    {
        "numpy.frombuffer",
        "numpy.packbits",
        "numpy.concatenate",
        "numpy.stack",
        "numpy.vstack",
        "numpy.hstack",
    }
)

#: Scalar extractors whose result does not carry the input's memory
#: footprint — they break taint propagation (``n += len(chunk)`` is
#: accounting, not accumulation).
_SCALAR_EXTRACTORS = frozenset(
    {"len", "int", "float", "bool", "min", "max", "sum", "ord", "hash"}
)

_HATCH_RE = re.compile(
    r"#\s*graftcheck:\s*hostmem\(unbounded\)\s*(?:--\s*(?P<why>.*\S))?\s*$"
)


def iter_hatch_comments(source: str) -> List[Tuple[int, int]]:
    """``(line, col)`` of every ``hostmem(unbounded)`` hatch comment,
    justified or not — GH006's subjects: the hatch SYNTAX is forbidden
    now that the declared inventory hit zero."""
    out: List[Tuple[int, int]] = []
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _HATCH_RE.search(line)
        if m is not None:
            out.append((lineno, m.start() + 1))
    return out


def parse_hostmem_hatches(source: str) -> Dict[int, str]:
    """``{line: justification}`` for every JUSTIFIED hostmem(unbounded)
    hatch; a hatch with no ``-- why`` text is ignored (declaring a site
    without saying why it is allowed to be O(file) declares nothing).

    A trailing hatch declares its own line; a comment-ONLY hatch line
    declares the next line (justifications routinely outgrow the code
    line — the same layout the ``# lock order:`` idiom uses).

    Note the hatch no longer PASSES anything: it routes the underlying
    GH00x finding into the report's ``declared_unbounded`` inventory for
    context, while GH006 flags the hatch line itself (see
    :func:`audit_source`)."""
    hatches: Dict[int, str] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _HATCH_RE.search(line)
        if m is None or not m.group("why"):
            continue
        why = m.group("why").strip()
        if line[: m.start()].strip() == "":
            hatches[lineno + 1] = why
        else:
            hatches[lineno] = why
    return hatches


@dataclass
class DeclaredSite:
    """One justified ``hostmem(unbounded)`` site: an O(file) path the tree
    acknowledges, inventoried for the streaming refactor."""

    rule_id: str
    path: str
    line: int
    detail: str
    justification: str

    def to_json(self) -> Dict[str, Any]:
        return {
            "rule": self.rule_id,
            "path": self.path,
            "line": self.line,
            "detail": self.detail,
            "justification": self.justification,
        }


@dataclass
class HostmemReport:
    """Audit result: undeclared findings fail; declared sites are listed."""

    findings: List[Finding] = field(default_factory=list)
    declared: List[DeclaredSite] = field(default_factory=list)
    checked_files: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> str:
        return json.dumps(
            {
                "tool": "graftcheck-hostmem",
                "ok": self.ok,
                "checked_files": self.checked_files,
                "finding_count": len(self.findings),
                "findings": [f.to_json() for f in self.findings],
                "declared_unbounded": [d.to_json() for d in self.declared],
            },
            indent=2,
        )

    def format(self) -> str:
        lines = [f.format() for f in self.findings]
        if self.declared:
            lines.append(
                f"declared hostmem(unbounded) sites "
                f"({len(self.declared)} — the streaming-refactor worklist):"
            )
            for d in self.declared:
                lines.append(
                    f"  {d.path}:{d.line}: {d.rule_id} -- {d.justification}"
                )
        verdict = (
            "clean" if self.ok else f"{len(self.findings)} undeclared finding(s)"
        )
        lines.append(
            f"graftcheck hostmem: {self.checked_files} file(s), {verdict}"
        )
        return "\n".join(lines)


def _call_name(node: ast.expr, alias: Dict[str, str]) -> Optional[str]:
    """Canonical dotted name of a call's callee, else None."""
    if isinstance(node, ast.Call):
        return _dotted(node.func, alias)
    return None


def _last_segment(name: Optional[str]) -> Optional[str]:
    return name.rsplit(".", 1)[-1] if name else None


def _attr_tail(node: ast.expr, alias: Dict[str, str]) -> Optional[str]:
    """Final attribute/name segment of a call's callee (``self.x.stream_blocks``
    → ``stream_blocks``) — _dotted rejects chains rooted at calls/subscripts,
    so producers reached through them still resolve."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return alias.get(func.id, func.id).rsplit(".", 1)[-1]
    return None


class _FunctionScope:
    """Per-function taint state (the analysis never crosses function
    boundaries: taint enters where a file is opened/read, and a function
    receiving a whole buffer as a parameter audits at its caller)."""

    def __init__(self) -> None:
        self.handles: Set[str] = set()
        #: names carrying ANY file/stream-derived data (a bounded window
        #: counts: accumulating windows is how O(file) creeps back in).
        self.tainted: Set[str] = set()
        #: names carrying WHOLE-INPUT buffers (no-size reads, decompress
        #: results) — the only tier GH005's numpy-staging rule fires on;
        #: staging one bounded chunk is the windowed idiom, not a finding.
        self.whole: Set[str] = set()
        #: list names that accumulated stream items (GH005's second source).
        self.accumulated: Set[str] = set()


class _HostmemVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str, alias: Dict[str, str]):
        self.relpath = relpath
        self.alias = alias
        self.findings: List[Finding] = []
        self._scopes: List[_FunctionScope] = [_FunctionScope()]
        self._loop_depth = 0

    # ------------------------------------------------------------- plumbing

    @property
    def scope(self) -> _FunctionScope:
        return self._scopes[-1]

    def emit(self, rule_id: str, node: ast.AST, detail: str) -> None:
        rule = HOSTMEM_RULES[rule_id]
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

    def _is_tainted(self, node: ast.expr) -> bool:
        """Whether an expression carries file/stream-derived data. Scalar
        extractor calls launder taint (their results are O(1))."""
        name = _call_name(node, self.alias)
        if name in _SCALAR_EXTRACTORS:
            return False
        if self._is_taint_source(node):
            return True
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and (
                sub.id in self.scope.tainted
                or sub.id in self.scope.handles
                or sub.id in self.scope.accumulated
            ):
                return True
            if isinstance(sub, ast.Call) and self._is_taint_source(sub):
                return True
        return False

    def _is_taint_source(self, node: ast.expr) -> bool:
        """Calls whose RESULT is file/stream data regardless of arguments:
        handle reads and whole-buffer decompressors."""
        if not isinstance(node, ast.Call):
            return False
        name = _call_name(node, self.alias)
        if name in _DECOMPRESSORS:
            return True
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr in ("read", "read1", "readline", "readlines")
            and isinstance(func.value, ast.Name)
            and func.value.id in self.scope.handles
        ):
            return True
        return False

    def _is_whole_source(self, node: ast.expr) -> bool:
        """Calls whose result is a WHOLE-input buffer: no-size reads,
        readlines, and one-shot decompressors."""
        if not isinstance(node, ast.Call):
            return False
        if _call_name(node, self.alias) in _DECOMPRESSORS:
            return True
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id in self.scope.handles
        ):
            if func.attr == "read" and not node.args and not node.keywords:
                return True
            if func.attr == "readlines":
                return True
        return False

    def _is_whole(self, node: ast.expr) -> bool:
        """Whether an expression carries a whole-input buffer (GH005's
        trigger tier)."""
        if _call_name(node, self.alias) in _SCALAR_EXTRACTORS:
            return False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and (
                sub.id in self.scope.whole
                or sub.id in self.scope.accumulated
            ):
                return True
            if isinstance(sub, ast.Call) and self._is_whole_source(sub):
                return True
        return False

    def _is_stream_iterable(self, node: ast.expr) -> bool:
        """Whether a for-loop iterable is a file handle or a streaming
        block producer (its items are then tainted window data)."""
        if isinstance(node, ast.Name) and node.id in self.scope.handles:
            return True
        tail = _attr_tail(node, self.alias)
        if tail in _STREAM_PRODUCERS:
            return True
        # Transparent iterator wrappers: ``enumerate(f)``, ``zip(a, f)``.
        if isinstance(node, ast.Call) and _call_name(node, self.alias) in (
            "enumerate",
            "zip",
            "iter",
            "reversed",
        ):
            return any(self._is_stream_iterable(arg) for arg in node.args)
        # Generator-expression shells over a stream, e.g.
        # ``(v for _, v in dataset.iter_shards())``.
        if isinstance(node, ast.GeneratorExp):
            return any(
                self._is_stream_iterable(gen.iter) for gen in node.generators
            )
        return False

    def _taint_target(self, target: ast.expr, whole: bool = False) -> None:
        if isinstance(target, ast.Name):
            self.scope.tainted.add(target.id)
            if whole:
                self.scope.whole.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for element in target.elts:
                self._taint_target(element, whole=whole)

    # ------------------------------------------------------------ functions

    def _visit_function(self, node: Any) -> None:
        self._scopes.append(_FunctionScope())
        outer_depth, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = outer_depth
        self._scopes.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function
    visit_Lambda = _visit_function

    # ---------------------------------------------------------------- binds

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            opener = _call_name(item.context_expr, self.alias)
            if opener in _FILE_OPENERS and isinstance(
                item.optional_vars, ast.Name
            ):
                self.scope.handles.add(item.optional_vars.id)
        self.generic_visit(node)

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    def visit_Assign(self, node: ast.Assign) -> None:
        opener = _call_name(node.value, self.alias)
        if opener in _FILE_OPENERS:
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self.scope.handles.add(target.id)
        elif self._is_tainted(node.value):
            whole = self._is_whole(node.value)
            for target in node.targets:
                self._taint_target(target, whole=whole)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        # ``buf += chunk`` inside the read loop is GH002's byte-buffer
        # spelling of unbounded accumulation.
        if (
            self._loop_depth > 0
            and isinstance(node.op, ast.Add)
            and isinstance(node.target, ast.Name)
            and self._is_tainted(node.value)
        ):
            self.emit(
                "GH002",
                node,
                f"`{node.target.id} += ...` accumulates stream-derived data "
                "inside the read loop — peak host memory grows with the "
                "input, not the window",
            )
            self.scope.tainted.add(node.target.id)
            self.scope.accumulated.add(node.target.id)
        self.generic_visit(node)

    # ---------------------------------------------------------------- loops

    def _visit_loop(self, node: Any) -> None:
        if isinstance(node, (ast.For, ast.AsyncFor)) and self._is_stream_iterable(
            node.iter
        ):
            self._taint_target(node.target)
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    # ---------------------------------------------------------------- calls

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node, self.alias)
        func = node.func

        # GH001: whole-file read on a known handle.
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id in self.scope.handles
        ):
            if func.attr == "read" and not node.args and not node.keywords:
                self.emit(
                    "GH001",
                    node,
                    f"`{func.value.id}.read()` with no size stages the whole "
                    "file in host RAM; read a bounded window in a loop",
                )
            elif func.attr == "readlines":
                self.emit(
                    "GH001",
                    node,
                    f"`{func.value.id}.readlines()` materializes every line "
                    "at once; iterate the handle instead",
                )

        # GH002: accumulation of stream-derived items inside a loop.
        if (
            self._loop_depth > 0
            and isinstance(func, ast.Attribute)
            and func.attr in ("append", "extend", "appendleft")
            and node.args
            and self._is_tainted(node.args[0])
        ):
            self.emit(
                "GH002",
                node,
                f".{func.attr}() of file/stream-derived data inside the "
                "read loop accumulates the whole input on host; consume "
                "per window instead",
            )
            if isinstance(func.value, ast.Name):
                self.scope.accumulated.add(func.value.id)
                self.scope.tainted.add(func.value.id)

        # GH003: whole-stream materialization.
        if (
            name in ("list", "tuple")
            and len(node.args) == 1
            and not node.keywords
            and self._is_stream_iterable(node.args[0])
        ):
            what = (
                "a file handle"
                if isinstance(node.args[0], ast.Name)
                else f"streaming producer "
                f"{_attr_tail(node.args[0], self.alias)!r}"
            )
            self.emit(
                "GH003",
                node,
                f"{name}() over {what} materializes the whole stream the "
                "producer keeps windowed",
            )

        # GH004: one-shot whole-buffer decompress.
        if name in _DECOMPRESSORS:
            self.emit(
                "GH004",
                node,
                f"{name}() holds compressed and decompressed copies of the "
                "payload simultaneously; stream through the module's file "
                "interface with windowed reads",
            )

        # GH005: numpy staging over a whole-file buffer (bounded-window
        # chunks are the staging idiom and stay clean — only the whole
        # tier and stream-accumulated lists fire).
        if name in _NP_STAGING and node.args and self._is_whole(node.args[0]):
            self.emit(
                "GH005",
                node,
                f"{name.replace('numpy', 'np')}() over a whole-file buffer "
                "(or stream-accumulated list) stages an O(input) host "
                "array; stage per chunk/block",
            )

        self.generic_visit(node)


def audit_source(
    source: str, relpath: str
) -> Tuple[List[Finding], List[DeclaredSite]]:
    """Audit one file's text. Returns ``(findings, declared sites)``.

    A finding on a line carrying a justified ``hostmem(unbounded)`` hatch
    moves to the declared inventory — the report still says WHAT a hatch
    hides — but the hatch itself fires GH006 (*declared-unbounded-
    forbidden*): with the inventory at zero and every source on the
    windowed stream abstraction, the hatch syntax is a finding, not a
    declaration, so the audit can never pass with one present."""
    tree = ast.parse(source, filename=relpath)
    alias = _collect_aliases(tree)
    visitor = _HostmemVisitor(relpath, alias)
    visitor.visit(tree)
    hatches = parse_hostmem_hatches(source)
    findings: List[Finding] = []
    declared: List[DeclaredSite] = []
    for f in sorted(visitor.findings, key=lambda f: (f.line, f.rule_id, f.col)):
        why = hatches.get(f.line)
        if why is not None:
            declared.append(
                DeclaredSite(f.rule_id, f.path, f.line, f.detail, why)
            )
        else:
            findings.append(f)
    gh006 = HOSTMEM_RULES["GH006"]
    if gh006.applies_to(relpath):
        for lineno, col in iter_hatch_comments(source):
            findings.append(
                Finding(
                    "GH006",
                    relpath,
                    lineno,
                    col,
                    "hostmem(unbounded) escape hatch: the declared-"
                    "inventory era is over — refactor the site through "
                    "the windowed stream abstraction (sources/stream.py) "
                    "instead of declaring it O(file)",
                )
            )
        findings.sort(key=lambda f: (f.line, f.rule_id, f.col))
    return findings, declared


def default_hostmem_paths() -> List[str]:
    """The audited host-staging layers of the installed package (kept in
    lockstep with ``check/rules.py:HOSTMEM_GLOBS``): the ingest stack,
    the resident service's control plane (``serve/``), and the
    population-genetics analyses (``analyses/`` — the per-site output
    layer whose boundedness is the whole point)."""
    package_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [
        os.path.join(package_dir, sub)
        for sub in ("sources", "pipeline", "ops", "serve", "analyses")
    ]


def audit_paths(paths: Sequence[str]) -> HostmemReport:
    """Audit files/trees (``graftcheck hostmem`` engine)."""
    report = HostmemReport()
    seen: Set[str] = set()
    for root in paths:
        for full, relpath in _iter_files_scoped(root):
            if full in seen:
                continue
            seen.add(full)
            with open(full, "r", encoding="utf-8") as f:
                source = f.read()
            try:
                findings, declared = audit_source(source, relpath)
            except SyntaxError as e:
                report.findings.append(
                    Finding(
                        "GH001",
                        relpath,
                        e.lineno or 0,
                        e.offset or 0,
                        f"file does not parse; the audit cannot vouch for "
                        f"it: {e.msg}",
                    )
                )
                report.checked_files += 1
                continue
            report.findings.extend(findings)
            report.declared.extend(declared)
            report.checked_files += 1
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    report.declared.sort(key=lambda d: (d.path, d.line, d.rule_id))
    return report


def _iter_files_scoped(root: str) -> Iterable[Tuple[str, str]]:
    """(abs_path, package-relative path) pairs, through the linter's shared
    package-root resolution so scope globs match regardless of the path the
    CLI was handed (a subdirectory, a single file, or the package root)."""
    if os.path.isfile(root):
        yield root, _package_relpath(root)
        return
    for full, _rel in _iter_py_files(root):
        yield full, _package_relpath(full)


# --------------------------------------------------------------------------
# The configuration-level budget resolver (formula in parallel/mesh.py).
# --------------------------------------------------------------------------


def conf_mesh_axes(conf: Any, device_count: Optional[int]) -> Tuple[int, int]:
    """(data, samples) a run of ``conf`` would build — the same resolution
    ``check/plan.py`` and ``pca_driver._make_mesh`` apply, shared here so
    the budget formula's geometry inputs cannot drift from either."""
    from spark_examples_tpu_torch.parallel.mesh import parse_mesh_shape

    mesh_shape = getattr(conf, "mesh_shape", None)
    if mesh_shape:
        shape = parse_mesh_shape(mesh_shape)
        return shape["data"], shape["samples"]
    devices = device_count if device_count is not None else 1
    data = max(1, min(devices, int(conf.num_reduce_partitions)))
    return data, 1


def _streamable_vcf_input(conf: Any) -> bool:
    """Whether the configured file ingest is the packed-streaming shape
    (``FileGenomicsSource.wants_streaming``'s static mirror): a single
    variant set whose selected input is a ``.vcf[.gz]`` file. Everything
    else (JSONL/SAM, checkpoint directories, multi-set configs) takes the
    wire-table path, which is bounded by its own closed-form term now —
    this predicate picks the FORMULA, it no longer gates provability."""
    input_files = list(getattr(conf, "input_files", None) or [])
    set_ids = list(getattr(conf, "variant_set_id", None) or [])
    if not input_files or len(set_ids) != 1:
        return False
    from spark_examples_tpu_torch.sources.files import file_set_ids

    by_id = dict(zip(file_set_ids(input_files), input_files))
    path = by_id.get(set_ids[0])
    if path is None or os.path.isdir(path):
        return False
    lowered = path[:-3] if path.endswith(".gz") else path
    return lowered.endswith(".vcf")


def _selected_paths(conf: Any) -> List[str]:
    """The input paths a file-source run of ``conf`` would actually read:
    ``--input-files`` filtered to the selected ``--variant-set-id``s (the
    same id derivation ``sources/files.py:file_set_ids`` applies), all of
    them when no set filter is configured or an id fails to resolve."""
    input_files = [str(p) for p in (getattr(conf, "input_files", None) or [])]
    set_ids = list(getattr(conf, "variant_set_id", None) or [])
    if not input_files:
        return []
    if not set_ids:
        return input_files
    from spark_examples_tpu_torch.sources.files import file_set_ids

    by_id = dict(zip(file_set_ids(input_files), input_files))
    selected = [by_id[s] for s in set_ids if s in by_id]
    return selected if selected else input_files


def _wire_record_bytes(num_samples: int) -> int:
    """Conservative host bytes of ONE wire/JSONL/SAM record object: a
    fixed per-record envelope (dict + key strings + position/id scalars)
    plus the per-sample call payload (one small int/str cell per sample
    after decode). 128 bytes/sample dominates any decoded call cell
    CPython allocates; 256 dominates the envelope."""
    return 256 + 128 * int(num_samples)


def _rows_bound_or_contract(path: str) -> int:
    """Total candidate rows one input path can yield, from the bytes on
    disk (``stream.wire_rows_bound``: min-line-width over the decompressed
    size bound), falling back to the DECLARED production geometry ceiling
    (``ops/contracts.py:DECLARED_MAX_SITES``) for paths that cannot be
    statted (plan-time validation of a path that does not exist yet) or
    directories with nothing listable. Always finite, never raises."""
    from spark_examples_tpu_torch.ops.contracts import DECLARED_MAX_SITES
    from spark_examples_tpu_torch.sources.stream import wire_rows_bound

    try:
        if os.path.isdir(path):
            rows = 0
            for name in sorted(os.listdir(path)):
                full = os.path.join(path, name)
                if os.path.isfile(full):
                    rows += wire_rows_bound(full)
            return rows if rows > 0 else DECLARED_MAX_SITES
        if os.path.isfile(path):
            rows = wire_rows_bound(path)
            return rows if rows > 0 else DECLARED_MAX_SITES
    except OSError:
        pass
    return DECLARED_MAX_SITES


def _wire_table_term(rows: int, num_samples: int) -> int:
    """Host-resident bytes of one wire-ingest table of ``rows`` records:
    the spool index (``SPOOL_INDEX_BYTES_PER_ROW`` per row) plus — taken
    conservatively as fully co-resident — every decoded record, plus four
    stream windows (reader carry + decode + spool write-behind)."""
    from spark_examples_tpu_torch.sources.stream import (
        DEFAULT_WINDOW_BYTES,
        SPOOL_INDEX_BYTES_PER_ROW,
    )

    per_row = SPOOL_INDEX_BYTES_PER_ROW + _wire_record_bytes(num_samples)
    return int(rows) * per_row + 4 * DEFAULT_WINDOW_BYTES


#: Width of the warm-up Gramian :func:`runtime_baseline_bytes` centers and
#: eigensolves on the card: a few tiles, enough to take the run's cuBLAS
#: and cuSOLVER paths, small enough to stage no data.
_WARMUP_SAMPLES = 256


@functools.lru_cache(maxsize=None)
def _warm_cuda_runtime(device_index: int) -> None:
    """Bring up, once per process and card, what every run on the card
    loads before its first result: the context, the kernels' libraries,
    and cuBLAS and cuSOLVER through one centering and one step of the
    subspace eigensolve on a small random Gramian."""
    import torch

    from spark_examples_tpu_torch.ops import devicegen, gramian
    from spark_examples_tpu_torch.ops.centering import gower_center
    from spark_examples_tpu_torch.ops.pca import principal_components_subspace

    dev = torch.device("cuda", device_index)
    devicegen._library()
    gramian._library()
    generator = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((_WARMUP_SAMPLES, _WARMUP_SAMPLES), generator=generator, device=dev)
    components, _ = principal_components_subspace(gower_center(x @ x.T), 2, iterations=1)
    components.cpu()


def runtime_baseline_bytes(device) -> int:
    """The runtime baseline of the host-memory bound of a run on
    ``device``. On the CPU the reference's constant
    (``parallel/mesh.py:HOST_RUNTIME_BASELINE_BYTES``), so the bound equals
    the reference's integer for integer. On the card the process's peak RSS
    once the CUDA runtime is up (:func:`_warm_cuda_runtime`), taken before
    the run stages any data: what the run adds past it is held to the data
    terms. The constant when the OS reports no peak RSS."""
    import torch

    from spark_examples_tpu_torch.obs.metrics import read_host_peak_rss_bytes
    from spark_examples_tpu_torch.parallel.mesh import HOST_RUNTIME_BASELINE_BYTES

    dev = torch.device(device)
    if dev.type != "cuda":
        return HOST_RUNTIME_BASELINE_BYTES
    _warm_cuda_runtime(dev.index if dev.index is not None else torch.cuda.current_device())
    peak = read_host_peak_rss_bytes()
    return int(peak) if peak is not None else HOST_RUNTIME_BASELINE_BYTES


def conf_host_peak_bytes(
    conf: Any,
    device_count: Optional[int] = None,
    num_samples: Optional[int] = None,
    num_hosts: int = 1,
    baseline_bytes: Optional[int] = None,
) -> int:
    """``host_peak_bytes`` for one parsed configuration. TOTAL: every
    (source kind x ingest mode x analysis x serve job kind) resolves to a
    finite closed-form bound — there is no ``None`` arm left, because
    every ingest path now runs through the windowed stream abstraction
    (``sources/stream.py``) whose residency is a formula, not the file.

    ``num_samples`` overrides the flag value with the DISCOVERED cohort
    width (file sources carry their cohort in the data; the driver passes
    its resolved matrix size, the static plan validator the declared flag).
    ``num_hosts > 1`` charges the host-sharded ingest merge term — a
    PER-HOST bound (the port's driver runs one process and passes 1).
    ``baseline_bytes`` is the runtime baseline (default: the reference's
    constant; the driver passes :func:`runtime_baseline_bytes`).

    Per-path terms, all monotone in the cohort width:

    - synthetic: the device-generation path stages nothing whole-file;
      only the runtime baseline and analysis terms apply.
    - file, single ``.vcf[.gz]`` set, packed/auto ingest: one streamed
      pass (O(workers x chunk) parse staging at the explicit
      ``--stream-chunk-bytes`` or the ``sources/files.py`` default) plus
      the packed columns' build/hand-off co-residency,
      ``2 x rows x (N + 48)`` (int8 genotype row + per-site metadata,
      builder AND final array alive across the final copy).
    - file wire / JSONL / SAM / multi-set: the wire-table term per
      selected input (spool index + conservatively co-resident decoded
      records + stream windows), plus a merge-join term
      ``n_sets x 64 x record_bytes`` when joining (64 = the per-stream
      tracked-group ceiling ``stream.merge_join`` accounts against).
    - REST: one wire table at the declared geometry ceiling
      (``DECLARED_MAX_SITES`` rows — the pagination protocol carries no
      size upfront, so the production contract is the bound).
    - checkpoint resume (``--input-path``): the wire-table term over the
      journal directory's parts (sizes from disk when statable, the
      geometry ceiling otherwise).
    """
    from spark_examples_tpu_torch.config import AssocConf, GrmConf, LdConf
    from spark_examples_tpu_torch.parallel.mesh import (
        HOST_RUNTIME_BASELINE_BYTES,
        host_peak_bytes,
    )
    from spark_examples_tpu_torch.sources.files import _resolve_ingest_workers

    if num_samples is None:
        num_samples = int(conf.num_samples)
    n = int(num_samples)
    source = getattr(conf, "source", "synthetic")
    stream_chunk = getattr(conf, "stream_chunk_bytes", None)
    ingest = getattr(conf, "ingest", "auto")
    chunk_bytes = 0
    wire_table_bytes = 0
    merge_join_bytes = 0
    input_path = getattr(conf, "input_path", None)
    if input_path:
        # Checkpoint resume replays journal parts through the windowed
        # JSONL reader into one wire table; charge it like any wire input.
        wire_table_bytes = _wire_table_term(
            _rows_bound_or_contract(str(input_path)), n
        )
    elif source == "file":
        if ingest != "wire" and _streamable_vcf_input(conf):
            from spark_examples_tpu_torch.sources.files import STREAM_CHUNK_BYTES

            chunk_bytes = (
                int(stream_chunk)
                if stream_chunk and stream_chunk > 0
                else STREAM_CHUNK_BYTES
            )
            rows = _rows_bound_or_contract(_selected_paths(conf)[0])
            wire_table_bytes = 2 * rows * (n + 48)
        else:
            paths = _selected_paths(conf)
            wire_table_bytes = sum(
                _wire_table_term(_rows_bound_or_contract(p), n)
                for p in paths
            )
            if len(paths) > 1:
                merge_join_bytes = (
                    len(paths) * 64 * _wire_record_bytes(n)
                )
    elif source == "rest":
        from spark_examples_tpu_torch.ops.contracts import DECLARED_MAX_SITES

        set_ids = list(getattr(conf, "variant_set_id", None) or [None])
        wire_table_bytes = len(set_ids) * _wire_table_term(
            DECLARED_MAX_SITES, n
        )
        if len(set_ids) > 1:
            merge_join_bytes = len(set_ids) * 64 * _wire_record_bytes(n)
    workers = _resolve_ingest_workers(getattr(conf, "ingest_workers", None))
    data, _samples = conf_mesh_axes(conf, device_count)
    # Mirrors pipeline/pca_driver._similarity_stage: a depth-2
    # PrefetchIterator and the double-buffered device feed exist whenever
    # parse workers do (any packed-path source). The pure device-generation
    # path has neither, so for it these terms only make the bound more
    # conservative — never smaller than reality.
    prefetch_depth = 2 if workers > 0 else 0
    pipeline_depth = 2 if workers > 0 else 0
    host_backend = getattr(conf, "pca_backend", "gpu") == "host"
    return host_peak_bytes(
        num_samples=n,
        block_size=int(conf.block_size),
        data_axis=data,
        ingest_workers=workers,
        chunk_bytes=chunk_bytes,
        prefetch_depth=prefetch_depth,
        pipeline_depth=pipeline_depth,
        # The host-oracle N×N accumulator exists only where the run builds
        # a Gramian (PCA, and GRM whose device work is the Gramian); LD and
        # assoc under --pca-backend host run O(window) NumPy oracles. The
        # GRM finalize's N×N host matrices belong to the grm verb, the W×W
        # per-window working set to ld-prune.
        host_accumulator=host_backend and not isinstance(conf, (LdConf, AssocConf)),
        grm_finalize=isinstance(conf, GrmConf),
        ld_window_sites=(
            int(getattr(conf, "ld_window_sites", 0) or 0) if isinstance(conf, LdConf) else 0
        ),
        num_hosts=int(num_hosts),
        wire_table_bytes=wire_table_bytes,
        merge_join_bytes=merge_join_bytes,
        baseline_bytes=(
            HOST_RUNTIME_BASELINE_BYTES if baseline_bytes is None else int(baseline_bytes)
        ),
    )


__all__ = [
    "DeclaredSite",
    "HostmemReport",
    "audit_paths",
    "audit_source",
    "conf_host_peak_bytes",
    "conf_mesh_axes",
    "default_hostmem_paths",
    "iter_hatch_comments",
    "parse_hostmem_hatches",
    "runtime_baseline_bytes",
]
