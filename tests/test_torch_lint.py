"""``graftcheck lint`` in both packages: the port's torch-idiom linter
against the reference's, on the reference's own fixtures.

The fixtures are read out of the reference's test files by AST, not copied:
every source string the reference's GC tests lint (``tests/test_graftcheck.py``,
``tests/test_graftcheck_ranges.py``'s GC011 section and
``tests/test_stream.py``'s GC012/GC013 section), each with the relpath its
test gives it. A fixture with no JAX spelling is linted as it stands by
both packages. A fixture that spells a pitfall in JAX has a line-for-line
torch translation below (``TORCH_TRANSLATIONS``): only the JAX spellings
change, the line count stays, and the port's ``(rule, line)`` list on the
translation must equal the reference's on the original.
"""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from spark_examples_tpu.check import rules as ref_rules
from spark_examples_tpu.check.cli import main as ref_main
from spark_examples_tpu.check.linter import json_report as ref_json_report
from spark_examples_tpu.check.linter import lint_paths as ref_lint_paths
from spark_examples_tpu.check.linter import lint_source as ref_lint_source
from spark_examples_tpu_torch.check import rules as port_rules
from spark_examples_tpu_torch.check.cli import _default_lint_root
from spark_examples_tpu_torch.check.cli import main as port_main
from spark_examples_tpu_torch.check.linter import (
    _package_relpath,
    json_report,
    lint_paths,
    lint_source,
)

TESTS = Path(__file__).resolve().parent
PORT_ROOT = Path(port_rules.__file__).resolve().parent.parent

#: The reference's lint fixtures: (test file, first and last line of the
#: tests that hold them).
FIXTURE_SPANS = (
    ("test_graftcheck.py", 38, 350),
    ("test_graftcheck_ranges.py", 486, 562),
    ("test_stream.py", 394, 537),
)

#: Spellings that make a fixture JAX's (and so in need of a translation).
JAX_SPELLING = re.compile(r"jax|jnp|lax|shard_map|block_until_ready")


def _ids(findings):
    return [(f.rule_id, f.line) for f in findings]


# ---------------------------------------------------------------- fixtures


def _string_value(node, env):
    """A fixture source: a string constant, ``textwrap.dedent`` of one, an
    f-string over bound names, or a name bound to any of those."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Call) and ast.unparse(node.func) == "textwrap.dedent":
        inner = _string_value(node.args[0], env)
        return None if inner is None else textwrap.dedent(inner)
    if isinstance(node, ast.JoinedStr):
        parts = []
        for value in node.values:
            if isinstance(value, ast.Constant):
                parts.append(value.value)
            elif isinstance(value.value, ast.Name) and value.value.id in env:
                parts.append(env[value.value.id])
            else:
                return None
        return "".join(parts)
    return None


def _fixture_calls(stmt):
    """The lint calls of one simple statement, in source order: the
    reference's ``lint_source`` and its two helpers (``_lint`` in the
    ranges tests, ``_lint_ids`` in the stream tests; both dedent)."""
    calls = [
        node for node in ast.walk(stmt)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
        and node.func.id in ("lint_source", "_lint", "_lint_ids")
    ]
    return sorted(calls, key=lambda node: (node.lineno, node.col_offset))


def _walk(stmts, env, test, out):
    """Statements in order, names bound as they run; a ``for`` over a tuple
    of constants runs its body once per value."""
    for stmt in stmts:
        if isinstance(stmt, ast.For) and isinstance(stmt.target, ast.Name) \
                and isinstance(stmt.iter, ast.Tuple):
            for elt in stmt.iter.elts:
                _walk(stmt.body, {**env, stmt.target.id: elt.value}, test, out)
            continue
        if isinstance(stmt, (ast.With, ast.If, ast.For)):
            _walk(stmt.body, env, test, out)
            continue
        for call in _fixture_calls(stmt):
            source = _string_value(call.args[0], env)
            if source is None:
                continue  # a source built at run time (a file's text)
            if call.func.id == "lint_source":
                if not isinstance(call.args[1], ast.Constant):
                    continue
                relpath = call.args[1].value
            else:
                source = textwrap.dedent(source)
                relpath = call.args[1].value if len(call.args) > 1 else next(
                    (kw.value.value for kw in call.keywords if kw.arg == "relpath"),
                    "ops/fixture.py")
            k = sum(1 for name, _, _ in out if name.startswith(f"{test}["))
            out.append((f"{test}[{k}]", source, relpath))
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            value = _string_value(stmt.value, env)
            if value is None:
                env.pop(stmt.targets[0].id, None)
            else:
                env[stmt.targets[0].id] = value


def _lint_fixtures():
    """``(id, source, relpath)`` of every reference lint fixture."""
    out = []
    for filename, first, last in FIXTURE_SPANS:
        tree = ast.parse((TESTS / filename).read_text())
        for fn in tree.body:
            if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_") \
                    and first <= fn.lineno <= last:
                _walk(fn.body, {}, f"{filename[:-3]}::{fn.name}", out)
    return out


LINT_FIXTURES = _lint_fixtures()

_GC001_JNP = """
import torch
def f(x):
    y = torch.sum(x)
    return float(y)
"""

_GC005_OUT_OF_PLACE = """
import torch
@torch.compile
def gram_update(G, X):
    return G + X
"""

_GC010_COMPILED_NUMPY = """
import functools
import numpy as np
import torch
@functools.partial(torch.compile, fullgraph=True)
def per_device(x):
    return np.packbits(x)
"""

_GC011_INT8 = """
import torch
def f(x):
    return x.to(torch.int8)
"""

#: The torch translation of every reference fixture that spells its pitfall
#: in JAX, by fixture id: ``jnp.*`` → ``torch.*``, ``jax.jit``/``shard_map``
#: → ``torch.compile``/``torch.jit.script``, ``block_until_ready`` →
#: ``torch.cuda.synchronize()``, donation → an in-place update, a static
#: argument → a Python-scalar annotation, ``astype``/
#: ``convert_element_type`` → ``.to``/``.type``.
TORCH_TRANSLATIONS = {
    "test_graftcheck::test_gc001_float_of_jnp_value[0]": _GC001_JNP,
    "test_graftcheck::test_gc001_scoped_to_hot_paths_only[0]": _GC001_JNP,
    "test_graftcheck::test_gc002_branch_on_traced_param[0]": """
import torch
@torch.compile
def f(x, n):
    if x > 0:
        return x
    while n:
        n = n - 1
    return n
""",
    "test_graftcheck::test_gc002_static_and_identity_tests_pass[0]": """
import functools, torch
@functools.partial(torch.compile, dynamic=False)
def f(x, n: int):
    if n > 0:
        return x
    if x is None:
        return x
    return x
""",
    "test_graftcheck::test_gc003_jit_inside_loop[0]": """
import torch
def f(xs):
    out = []
    for x in xs:
        g = torch.compile(lambda v: v + 1)
        out.append(g(x))
    return out
""",
    "test_graftcheck::test_gc004_jnp_at_import_time[0]": """
import torch
TABLE = torch.arange(16)
""",
    "test_graftcheck::test_gc004_jnp_at_import_time[1]":
        "import torch\ndef f():\n    return torch.arange(16)\n",
    "test_graftcheck::test_gc004_jnp_at_import_time[2]":
        "import torch\nf = lambda x: torch.sum(x)\n",
    "test_graftcheck::test_gc005_update_without_donation_and_with[0]": _GC005_OUT_OF_PLACE,
    "test_graftcheck::test_gc005_update_without_donation_and_with[1]": """
import functools, torch
@functools.partial(torch.compile, fullgraph=True)
def gram_update(G, X):
    return G.add_(X)
""",
    "test_graftcheck::test_gc005_update_without_donation_and_with[2]": _GC005_OUT_OF_PLACE,
    "test_graftcheck::test_gc007_block_until_ready_in_loop[0]": """
import torch
def feed(blocks, G):
    for b in blocks:
        G = G + b
        torch.cuda.synchronize()
    return G
""",
    "test_graftcheck::test_gc008_print_under_jit[0]": """
from torch.jit import script
@script
def f(x):
    print("tracing", x)
    return x
""",
    "test_graftcheck::test_gc010_host_numpy_under_jit[0]": """
import torch
import numpy as np
@torch.compile
def kernel(G, X):
    mask = np.asarray(X)
    return G + np.sum(mask)
""",
    "test_graftcheck::test_gc010_shard_map_decoration_and_scope[0]": _GC010_COMPILED_NUMPY,
    "test_graftcheck::test_gc010_shard_map_decoration_and_scope[1]": _GC010_COMPILED_NUMPY,
    "test_graftcheck::test_gc010_dtype_constructors_and_escape_hatch[0]": """
import torch
import numpy as np
@torch.compile
def kernel(G, X):
    return G + X.astype(np.dtype("float32"))
""",
    "test_graftcheck::test_gc010_dtype_constructors_and_escape_hatch[1]": (
        "import torch\n"
        "import numpy as np\n"
        "@torch.compile\n"
        "def kernel(G):\n"
        "    return G + np.sum(G)  # graftcheck: disable=GC010 -- trace-time constant, measured\n"
    ),
    "test_graftcheck_ranges::test_gc011_flags_unjustified_narrowing_cast[0]": _GC011_INT8,
    "test_graftcheck_ranges::test_gc011_range_comment_and_contract_reference_justify[0]": """
import torch
def f(x):
    # range: x is a {0,1} membership bit
    return x.to(torch.uint8)
def g(x):
    # values declared in ops/contracts.py:HAS_VARIATION
    return x.to(torch.uint8)
""",
    "test_graftcheck_ranges::test_gc011_convert_element_type_spelling[0]": """
import torch
from torch import int16
def f(x):
    return x.type(int16)
""",
    "test_graftcheck_ranges::test_gc011_skips_dynamic_and_wide_targets[0]": """
import torch
def f(x, operand_dtype):
    a = x.to(operand_dtype)
    b = x.to(torch.float64)
    return a, b
""",
    "test_graftcheck_ranges::test_gc011_scope_and_escape_hatch[0]": _GC011_INT8,
    "test_graftcheck_ranges::test_gc011_scope_and_escape_hatch[1]": """
import torch
def f(x):
    return x.to(torch.int8)  # graftcheck: disable=GC011 -- fixture
""",
}

_JAX_FREE = [f for f in LINT_FIXTURES if not JAX_SPELLING.search(f[1])]
_JAX_SPELLED = [f for f in LINT_FIXTURES if JAX_SPELLING.search(f[1])]


def test_every_reference_lint_fixture_is_read():
    assert len(LINT_FIXTURES) >= 50
    rules = {f.rule_id for _, source, relpath in LINT_FIXTURES
             for f in ref_lint_source(source, relpath)}
    assert rules == {f"GC0{i:02d}" for i in range(1, 14)}
    assert sorted(TORCH_TRANSLATIONS) == sorted(name for name, _, _ in _JAX_SPELLED)


@pytest.mark.parametrize("name, source, relpath", _JAX_FREE, ids=[f[0] for f in _JAX_FREE])
def test_jax_free_fixture_findings_equal_the_reference(name, source, relpath):
    keys = ("rule", "name", "path", "line", "col")
    port = [{k: f.to_json()[k] for k in keys} for f in lint_source(source, relpath)]
    ref = [{k: f.to_json()[k] for k in keys} for f in ref_lint_source(source, relpath)]
    assert port == ref


@pytest.mark.parametrize("name, source, relpath", _JAX_SPELLED, ids=[f[0] for f in _JAX_SPELLED])
def test_torch_translation_findings_equal_the_reference(name, source, relpath):
    translation = TORCH_TRANSLATIONS[name]
    assert translation.count("\n") == source.count("\n")
    assert not JAX_SPELLING.search(translation)
    assert _ids(lint_source(translation, relpath)) == _ids(ref_lint_source(source, relpath))


def test_gc000_unparseable_file_equals_the_reference(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n    pass\n")
    (tmp_path / "clean.py").write_text("X = 1\n")
    port, checked = lint_paths([str(tmp_path)])
    ref, ref_checked = ref_lint_paths([str(tmp_path)])
    assert checked == ref_checked == 2
    assert [f.to_json() for f in port] == [f.to_json() for f in ref]
    assert _ids(port) == [("GC000", 1)]


def test_rule_catalogue_keeps_the_reference_s_ids_names_and_scopes():
    assert list(port_rules.RULES) == list(ref_rules.RULES)
    for rule_id, rule in port_rules.RULES.items():
        ref = ref_rules.RULES[rule_id]
        assert (rule.name, rule.scope) == (ref.name, ref.scope)
        assert port_rules.ALL_RULES[rule_id] is rule
    for name in ("HOT_PATH_GLOBS", "INGEST_GLOBS", "TELEMETRY_GLOBS"):
        assert getattr(port_rules, name) == getattr(ref_rules, name)


# ------------------------------------------------- the torch spellings


@pytest.mark.parametrize("source, relpath, want", [
    # GC001: torch's copies out of device memory; one finding per fetch.
    ("def f(x):\n    return x.cpu()\n", "ops/a.py", [("GC001", 2)]),
    ("def f(x):\n    return x.cpu().numpy()\n", "ops/a.py", [("GC001", 2)]),
    ("def f(x):\n    return x.numpy()\n", "analyses/a.py", [("GC001", 2)]),
    ("import torch\ndef f(x):\n    y = torch.sum(x)\n    return y.tolist()\n",
     "pipeline/a.py", [("GC001", 4)]),
    ("def f(rows):\n    return rows.tolist()\n", "ops/a.py", []),
    ("import numpy as np, torch\ndef f(x):\n    return np.asarray(torch.sum(x))\n",
     "ops/a.py", [("GC001", 3)]),
    ("def f(x):\n    return x.cpu()\n", "serve/a.py", []),
    # GC002: a Tensor annotation is traced; a Python scalar's is not.
    ("import torch\n@torch.compile(fullgraph=True)\ndef f(x: torch.Tensor, n: int):\n"
     "    if n:\n        return x\n    if x:\n        return x\n    return x\n",
     "a.py", [("GC002", 6)]),
    ("import torch\n@torch.jit.script\ndef f(x: 'torch.Tensor'):\n    if x > 0:\n"
     "        return x\n    return x\n", "a.py", [("GC002", 4)]),
    # GC003: partial(torch.compile, ...) is a compile too.
    ("import functools, torch\ndef f(fns):\n    for fn in fns:\n"
     "        functools.partial(torch.compile, mode='max-autotune')(fn)\n", "a.py",
     [("GC003", 4)]),
    # GC004: a module-level decorator runs with its function, not alone.
    ("import torch\n@torch.no_grad()\ndef f(x):\n    return x\n", "a.py", []),
    ("import torch\nclass A:\n    ONES = torch.ones(4)\n", "a.py", [("GC004", 3)]),
    # GC005: the in-place forms are torch's donation.
    ("import torch\ndef gram_update(G, X):\n    G += X\n    return G\n", "ops/a.py", []),
    ("import torch\ndef accumulate(G, X):\n    return torch.add(G, X, out=G)\n",
     "ops/a.py", []),
    ("import torch\ndef accumulate(G, X):\n    return torch.add(G, X)\n", "ops/a.py",
     [("GC005", 2)]),
    ("class A:\n    def update(self, G, X):\n        G = G + X\n        return G\n",
     "ops/a.py", [("GC005", 2)]),
    # GC007: an event's and a stream's synchronize in a loop; once after it is fine.
    ("def f(events):\n    for e in events:\n        e.synchronize()\n", "ops/a.py",
     [("GC007", 3)]),
    ("import torch\ndef f(blocks):\n    while blocks:\n        blocks.pop()\n"
     "        torch.cuda.current_stream().synchronize()\n", "pipeline/a.py", [("GC007", 5)]),
    ("import torch\ndef f(blocks):\n    for b in blocks:\n        b.add_(1)\n"
     "    torch.cuda.synchronize()\n", "ops/a.py", []),
    # GC011: every dtype position of .to, torch's short aliases, not a bare float.
    ("import torch\ndef f(x, d):\n    return x.to(d, torch.int8)\n", "ops/a.py",
     [("GC011", 3)]),
    ("import torch\ndef f(x):\n    return x.to(dtype=torch.half)\n", "ops/a.py",
     [("GC011", 3)]),
    ("import torch\ndef f(x):\n    return x.to(torch.float)\n", "ops/a.py", [("GC011", 3)]),
    ("import numpy as np\ndef f(x):\n    return x.astype(float)\n", "ops/a.py", []),
    ("import numpy as np\ndef f(x):\n    return x.astype(np.int32)\n", "ops/a.py",
     [("GC011", 3)]),
    ("import torch\ndef f(x):\n    return x.to(x.device)\n", "ops/a.py", []),
    # GC012: a write-mode handle is no ingest; a read-mode one is.
    ("def f(path):\n    with open(path, 'w') as out:\n        for line in out:\n            pass\n",
     "sources/a.py", []),
    ("def f(path):\n    with open(path, mode='rb') as src:\n        for line in src:\n            pass\n",
     "sources/a.py", [("GC012", 3)]),
])
def test_torch_spellings(source, relpath, want):
    assert _ids(lint_source(source, relpath)) == want


# ------------------------------------------------------- hatches, report


def test_disable_silences_the_named_rule_only():
    src = "def f(x):\n    return x.cpu()  # graftcheck: disable=GC001 -- oracle\n"
    assert lint_source(src, "ops/fixture.py") == []
    wrong_id = "def f(x):\n    return x.cpu()  # graftcheck: disable=GC007\n"
    assert _ids(lint_source(wrong_id, "ops/fixture.py")) == [("GC001", 2)]
    assert _ids(lint_source(src, "ops/fixture.py", honor_disables=False)) == [("GC001", 2)]


def test_disable_file_and_disable_all():
    src = "# graftcheck: disable-file=GC001\ndef f(x):\n    return x.cpu()\n"
    assert lint_source(src, "ops/fixture.py") == []
    src_all = "def f(x):\n    return x.cpu()  # graftcheck: disable=all\n"
    assert lint_source(src_all, "ops/fixture.py") == []


def test_json_report_has_the_reference_s_schema():
    src = "def f(x):\n    return x.mean().item()\n"
    port = json.loads(json_report(lint_source(src, "ops/fixture.py"), checked=1))
    ref = json.loads(ref_json_report(ref_lint_source(src, "ops/fixture.py"), checked=1))
    assert list(port) == list(ref) == ["tool", "checked_files", "finding_count", "findings"]
    [entry] = port["findings"]
    [ref_entry] = ref["findings"]
    assert list(entry) == list(ref_entry)
    for key in ("rule", "name", "path", "line", "col"):
        assert entry[key] == ref_entry[key]
    assert (port["tool"], port["checked_files"], port["finding_count"]) == ("graftcheck", 1, 1)
    assert entry["name"] == port_rules.RULES["GC001"].name


# ------------------------------------------------------------ the tree, CLI


def _package_py_files():
    return sorted(p for p in PORT_ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def test_port_tree_lints_clean():
    findings, checked = lint_paths([str(PORT_ROOT)])
    assert checked > 40
    assert checked == len(_package_py_files())
    assert findings == [], "\n".join(f.format() for f in findings)
    assert _default_lint_root() == str(PORT_ROOT)


def test_cli_exit_codes(tmp_path):
    assert port_main(["lint", str(PORT_ROOT)]) == 0
    bad = tmp_path / "ops"
    bad.mkdir()
    (bad / "fixture.py").write_text("def f(x):\n    return x.item()\n")
    for argv, want in ((["lint", str(tmp_path)], 1),
                       (["lint", str(tmp_path), "--json"], 1),
                       (["lint", str(tmp_path / "missing")], 2),
                       (["nonsense"], 2)):
        assert port_main(argv) == ref_main(argv) == want, argv


#: Port modules that carry a hatch or a range comment, the marker a
#: scoped rule's finding hides behind, and that rule.
HATCHED = [
    ("ops/gramian.py", "# graftcheck: disable=GC007", "GC007"),
    ("ops/gramian.py", "# range:", "GC011"),
    ("ops/batched.py", "# graftcheck: disable=GC007", "GC007"),
    ("ops/ld.py", "# graftcheck: disable=GC001", "GC001"),
    ("pipeline/pca_driver.py", "# graftcheck: disable=GC001", "GC001"),
    ("analyses/reads_examples.py", "# graftcheck: disable=GC001", "GC001"),
]


@pytest.mark.parametrize("relpath, marker, rule_id", HATCHED,
                         ids=[f"{r}:{rule}" for r, _, rule in HATCHED])
def test_single_file_lint_keeps_scoped_rules(relpath, marker, rule_id):
    """Linting ONE file applies the same scoped rules as the tree walk; the
    hatch hides a finding that the stripped file shows again."""
    path = PORT_ROOT / relpath
    findings, checked = lint_paths([str(path)])
    assert (findings, checked) == ([], 1)
    assert _package_relpath(str(path)) == relpath
    stripped = path.read_text().replace(marker, "#")
    assert any(f.rule_id == rule_id for f in lint_source(stripped, relpath))


def test_lint_as_a_process_reads_the_package_from_anywhere(tmp_path):
    """``python -m spark_examples_tpu_torch graftcheck lint --json`` from a
    directory outside the repo lints the installed package."""
    env = dict(os.environ, PYTHONPATH=str(PORT_ROOT.parent))
    proc = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch", "graftcheck", "lint", "--json"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    report = json.loads(proc.stdout)
    assert report["tool"] == "graftcheck" and report["finding_count"] == 0
    assert report["checked_files"] == len(_package_py_files())
