"""The port's source checkers against the reference's, on the reference's
own fixtures: ``graftcheck hostmem`` (the host-memory AST prover),
``graftcheck lockgraph`` (the lock-order analysis) and ``graftcheck
typecheck`` (the ``mypy`` baseline gate).

The fixtures are read out of the reference's test files, not copied: every
source string the hostmem tests audit (``tests/test_graftcheck_hostmem.py``,
each with the relpath its test gives it), and every source tree the
lock-graph tests build (``tests/test_graftcheck_ir.py``, the lock-order
section). Both packages then check the same text, and their findings,
declared sites, graphs and DOT artifacts must be equal. Over the port's own
tree both checkers must come out clean.
"""

import ast
import contextlib
import io
import json
import os
import textwrap
from pathlib import Path

import pytest

from spark_examples_tpu.check import hostmem as ref_hostmem
from spark_examples_tpu.check import lockgraph as ref_lockgraph
from spark_examples_tpu.check import typecheck as ref_typecheck
from spark_examples_tpu.check.cli import main as ref_main
from spark_examples_tpu_torch.check import hostmem as port_hostmem
from spark_examples_tpu_torch.check import lockgraph as port_lockgraph
from spark_examples_tpu_torch.check import typecheck as port_typecheck
from spark_examples_tpu_torch.check.cli import main as port_main

TESTS = Path(__file__).resolve().parent
PORT_ROOT = Path(port_hostmem.__file__).resolve().parent.parent


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


# ------------------------------------------------------------------ hostmem


def _string_value(node, names):
    """A fixture source: a string constant, ``textwrap.dedent`` of one, or
    a name bound to either in the same test."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return names.get(node.id)
    if isinstance(node, ast.Call) and ast.unparse(node.func) == "textwrap.dedent":
        inner = _string_value(node.args[0], names)
        return None if inner is None else textwrap.dedent(inner)
    return None


def _hostmem_fixtures():
    """``(test name, source, relpath)`` of every ``_audit``/``audit_source``
    call in the reference's hostmem tests (``_audit`` dedents and defaults
    to ``sources/fixture.py``, as it does there)."""
    tree = ast.parse((TESTS / "test_graftcheck_hostmem.py").read_text())
    fixtures = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        names = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                value = _string_value(node.value, names)
                if value is not None:
                    names[node.targets[0].id] = value
        calls = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Name)
                        and n.func.id in ("_audit", "audit_source")), key=lambda n: n.lineno)
        for k, call in enumerate(calls):
            source = _string_value(call.args[0], names)
            if call.func.id == "_audit":
                source = textwrap.dedent(source)
                relpath = next((kw.value.value for kw in call.keywords if kw.arg == "relpath"),
                               "sources/fixture.py")
            else:
                relpath = call.args[1].value
            fixtures.append((f"{fn.name}-{k}", source, relpath))
    return fixtures


HOSTMEM_FIXTURES = _hostmem_fixtures()


def test_every_reference_hostmem_fixture_is_read():
    assert len(HOSTMEM_FIXTURES) >= 17
    assert all(isinstance(source, str) for _, source, _ in HOSTMEM_FIXTURES)
    rules = {f.rule_id for _, source, relpath in HOSTMEM_FIXTURES
             for f in ref_hostmem.audit_source(source, relpath)[0]}
    assert rules == {f"GH00{i}" for i in range(1, 7)}


def _audit(module, source, relpath):
    findings, declared = module.audit_source(source, relpath)
    return [f.to_json() for f in findings], [d.to_json() for d in declared]


@pytest.mark.parametrize("name, source, relpath", HOSTMEM_FIXTURES,
                         ids=[f[0] for f in HOSTMEM_FIXTURES])
def test_hostmem_fixture_findings_equal_the_reference(name, source, relpath):
    ref = _audit(ref_hostmem, source, relpath)
    port = _audit(port_hostmem, source, relpath)
    assert port == ref
    assert port_hostmem.parse_hostmem_hatches(source) == ref_hostmem.parse_hostmem_hatches(source)
    assert [(f["rule"], f["line"]) for f in port[0]] == [(f["rule"], f["line"]) for f in ref[0]]


def test_hostmem_over_the_port_tree_is_clean_with_no_hatch():
    report = port_hostmem.audit_paths(port_hostmem.default_hostmem_paths())
    assert report.ok, report.format()
    assert report.findings == [] and report.declared == []
    assert report.checked_files > 10
    assert [os.path.basename(p) for p in port_hostmem.default_hostmem_paths()] == [
        os.path.basename(p) for p in ref_hostmem.default_hostmem_paths()]
    for path in port_hostmem.default_hostmem_paths():
        assert path.startswith(str(PORT_ROOT))
    rc, out = _cli(port_main, ["hostmem", "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["tool"] == "graftcheck-hostmem" and doc["ok"] is True
    assert doc["finding_count"] == 0 and doc["declared_unbounded"] == []


def test_port_escape_hatches_carry_their_reason():
    """The port's code carries no ``hostmem(unbounded)`` hatch, and every
    other ``# graftcheck:`` hatch says why (``-- reason``)."""
    for path in PORT_ROOT.rglob("*.py"):
        if path.parent.name == "check":
            continue  # the checkers document the hatch grammar
        for lineno, line in enumerate(path.read_text().splitlines(), start=1):
            if "# graftcheck:" not in line:
                continue
            assert "hostmem(unbounded)" not in line, (path, lineno)
            reason = line.split("# graftcheck:", 1)[1].partition("--")[2].strip()
            assert reason, (path, lineno, line)


def test_hostmem_cli_exit_codes_equal_the_reference(tmp_path):
    pkg = tmp_path / "pkg"
    dirty = pkg / "sources"
    dirty.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (dirty / "__init__.py").write_text("")
    (dirty / "bad.py").write_text("def f(path):\n    g = open(path)\n    return g.read()\n")
    clean = tmp_path / "clean.py"
    clean.write_text("def f(path):\n    return path\n")
    for argv, want in (([str(pkg)], 1), ([str(clean)], 0), ([str(tmp_path / "missing")], 2),
                       ([str(pkg), "--json"], 1)):
        ref, port = _cli(ref_main, ["hostmem", *argv]), _cli(port_main, ["hostmem", *argv])
        assert port == ref and port[0] == want, argv


# ---------------------------------------------------------------- lockgraph

#: The reference tests of the lock-order section that build a graph over
#: fixture files (``tests/test_graftcheck_ir.py``).
LOCK_TESTS = (
    "test_broken_lock_fixture_flags_every_gl_rule",
    "test_lockgraph_escape_hatch",
    "test_annotated_and_class_level_locks_are_visible",
    "test_closure_calls_resolve_in_the_lock_graph",
    "test_module_level_lock_resolves_through_attr_reference",
    "test_acquire_without_with_still_orders",
)


def _lock_fixtures():
    """``{test: (files, roots)}``: the files each reference lock-graph test
    writes under its ``tmp_path`` (relative path -> text) and the roots it
    hands ``build_lock_graph``, read by evaluating the test's path and
    string expressions."""
    tree = ast.parse((TESTS / "test_graftcheck_ir.py").read_text())
    module_names = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            value = _string_value(node.value, module_names)
            if value is not None:
                module_names[node.targets[0].id] = value
    fixtures = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name in LOCK_TESTS):
            continue
        env = dict(module_names, tmp_path="")

        def value(node):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                return os.path.join(value(node.left), value(node.right)).lstrip("/")
            if isinstance(node, ast.Call) and ast.unparse(node.func) == "str":
                return value(node.args[0])
            if isinstance(node, ast.Name):
                return env[node.id]
            return _string_value(node, env)

        files, roots = {}, []
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) and isinstance(stmt.targets[0], ast.Name):
                try:
                    env[stmt.targets[0].id] = value(stmt.value)
                except (KeyError, TypeError):
                    pass
            if isinstance(stmt, ast.Call) and isinstance(stmt.func, ast.Attribute):
                if stmt.func.attr == "write_text":
                    files[value(stmt.func.value)] = value(stmt.args[0])
            if isinstance(stmt, ast.Call) and ast.unparse(stmt.func) == "build_lock_graph":
                roots = [value(e) for e in stmt.args[0].elts]
        fixtures[fn.name] = (files, roots)
    return fixtures


LOCK_FIXTURES = _lock_fixtures()


def test_every_reference_lock_fixture_is_read():
    assert sorted(LOCK_FIXTURES) == sorted(LOCK_TESTS)
    for files, roots in LOCK_FIXTURES.values():
        assert files and roots and all(text is not None for text in files.values())


def _graph(module, roots):
    graph = module.build_lock_graph(roots)
    return json.loads(graph.to_json()), graph.to_dot(), graph.cycles()


@pytest.mark.parametrize("name", LOCK_TESTS)
def test_lock_graph_of_each_fixture_equals_the_reference(name, tmp_path):
    files, roots = LOCK_FIXTURES[name]
    for rel, text in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    roots = [str(tmp_path / r) for r in roots]
    ref, port = _graph(ref_lockgraph, roots), _graph(port_lockgraph, roots)
    assert port == ref
    if name == "test_broken_lock_fixture_flags_every_gl_rule":
        doc = port[0]
        assert {f["rule"] for f in doc["findings"]} == {"GL001", "GL002", "GL003", "GL004"}
        assert len(port[2]) == 1
        assert (_cli(port_main, ["lockgraph", *roots]) ==
                _cli(ref_main, ["lockgraph", *roots]))
    if name == "test_lockgraph_escape_hatch":
        assert port[0]["ok"] is True


def test_lock_graph_counts_torch_device_syncs(tmp_path):
    """GL002 covers the port's device syncs: ``torch.cuda.synchronize()``
    and a stream's ``synchronize()`` under a lock."""
    mod = tmp_path / "torch_locks.py"
    mod.write_text(textwrap.dedent(
        """
        import threading
        import torch
        from torch.cuda import synchronize

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()

            def drain(self, stream):
                with self._lock:
                    torch.cuda.synchronize()
                    stream.synchronize()
                    synchronize()
        """
    ))
    graph = port_lockgraph.build_lock_graph([str(mod)])
    assert [(f.rule_id, f.line) for f in graph.findings] == [
        ("GL002", 12), ("GL002", 13), ("GL002", 14)]


def test_lock_graph_of_the_port_is_acyclic_and_clean(tmp_path):
    roots = port_lockgraph.default_lock_paths()
    assert roots == [str(PORT_ROOT)]
    graph = port_lockgraph.build_lock_graph(roots)
    assert graph.ok, "\n".join(f.format() for f in graph.findings)
    assert graph.cycles() == []
    for key in ("serve/daemon.py::PcaService._lock", "serve/journal.py::JobJournal._lock",
                "serve/journal.py::LeaseStore._lock", "serve/queue.py::BoundedJobQueue._lock",
                "sources/files.py::FileGenomicsSource._lock",
                "obs/metrics.py::MetricsRegistry._lock", "obs/spans.py::SpanRecorder._lock"):
        assert key in graph.nodes, key
    assert ("obs/metrics.py::MetricsRegistry._lock", "obs/metrics.py::_Family._lock") \
        in graph.edges
    dot = tmp_path / "lockorder.dot"
    rc, out = _cli(port_main, ["lockgraph", "--dot", str(dot), "--json"])
    assert rc == 0 and json.loads(out)["ok"] is True
    assert dot.read_text() == graph.to_dot()


@pytest.mark.parametrize("argv", [
    ["--dot", "{tmp}/no_dir/g.dot"],
    ["{tmp}/missing"],
], ids=["unwritable-dot", "missing-path"])
def test_lockgraph_cli_usage_errors_equal_the_reference(argv, tmp_path):
    argv = ["lockgraph", *(a.format(tmp=tmp_path) for a in argv)]
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    if argv[1] == "--dot":
        argv.append(str(clean))
    assert port_main(argv) == ref_main(argv) == 2


# ---------------------------------------------------------------- typecheck


@pytest.mark.parametrize("strict", [False, True])
def test_typecheck_without_mypy_is_the_reference_s(strict, monkeypatch):
    for module in (ref_typecheck, port_typecheck):
        monkeypatch.setattr(module, "_run_mypy", lambda: None)
    argv = ["typecheck"] + (["--strict"] if strict else [])
    ref, port = _cli(ref_main, argv), _cli(port_main, argv)
    assert port == ref
    assert port[0] == (2 if strict else 0)
    assert "SKIP (mypy not installed" in port[1]


def test_typecheck_gate_reads_the_port_baseline(monkeypatch, tmp_path, capsys):
    baseline = tmp_path / "mypy_baseline.txt"
    monkeypatch.setattr(port_typecheck, "BASELINE_PATH", str(baseline))
    known = "spark_examples_tpu_torch/obs/report.py: error: old debt  [misc]"
    new = "spark_examples_tpu_torch/config.py: error: fresh  [arg-type]"
    monkeypatch.setattr(port_typecheck, "_run_mypy", lambda: ([known], ""))
    assert port_typecheck.run_typecheck(update_baseline=True) == 0
    assert known in baseline.read_text()
    assert port_typecheck.run_typecheck() == 0
    monkeypatch.setattr(port_typecheck, "_run_mypy", lambda: ([known, new], ""))
    assert port_typecheck.run_typecheck() == 1
    assert "1 NEW error(s)" in capsys.readouterr().out


def test_typecheck_targets_are_the_port_s():
    assert port_typecheck.BASELINE_PATH == str(PORT_ROOT / "check" / "mypy_baseline.txt")
    assert os.path.exists(port_typecheck.BASELINE_PATH)
    for target in port_typecheck.TARGETS + port_typecheck.STRICT_TARGETS:
        assert target.startswith(str(PORT_ROOT)) and os.path.exists(target), target
    assert port_typecheck._normalize(
        f"{PORT_ROOT}/config.py:12:5: error: x  [misc]"
    ) == "spark_examples_tpu_torch/config.py: error: x  [misc]"
