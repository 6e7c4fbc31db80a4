"""``graftcheck sanitize`` of both packages, and the fuzz corpus it replays.

The port's ``check/corpus.py`` must give the reference's documents byte
for byte, so a document has one index in both packages. Over that corpus
the port's native serial parse equals the reference's (the same arrays,
or the same malformed-line ordinal), the port's chunk-parallel parse
reproduces its serial one, and the port's native parse equals its Python
parser. The port's ASan harness replays a part of the corpus clean; the
full three-mode replay is marked ``slow``, as the reference's is.

``run_sanitize``'s outcomes (no compiler, a mode that cannot build, a hung
harness, a harness exiting 99, a clean harness) are each driven in both
packages under the same stubs: stand-in harnesses are small shell scripts,
so the replay itself (corpus files, sanitizer options, timeout) runs as
written. The printed lines and exit codes must be equal, with and without
``strict``.
"""

import functools
import os
import re
import stat

import numpy as np
import pytest

from spark_examples_tpu.check import corpus as ref_corpus
from spark_examples_tpu.check import sanitize as ref_sanitize
from spark_examples_tpu.utils import native as ref_native
from spark_examples_tpu_torch.check import corpus as port_corpus
from spark_examples_tpu_torch.check import sanitize as port_sanitize
from spark_examples_tpu_torch.ops._kernels import BUILD_DIR
from spark_examples_tpu_torch.sources.files import (
    _native_parallel_vcf_arrays,
    _python_vcf_arrays,
)
from spark_examples_tpu_torch.utils import native as port_native

N_DOCUMENTS = len(port_corpus.corpus_documents())
MODES = ("asan", "ubsan", "tsan")


def _compiler_available():
    return port_native._compiler() is not None


def _need_native():
    if port_native.vcf_library() is None:
        pytest.skip(f"no native build: {port_native.native_unavailable_reason()}")


def _group_by_contig(contigs, positions, ends, af, hv):
    """{contig: (positions, ends, af, hv)} sorted by position (stable, so
    file order on ties): the packed view's grouping, on raw arrays."""
    out = {}
    for name in dict.fromkeys(contigs.tolist()):
        mask = contigs == name
        order = np.argsort(positions[mask], kind="stable")
        out[str(name)] = (positions[mask][order], ends[mask][order],
                          af[mask][order], hv[mask][order])
    return out


def _assert_same_arrays(a, b):
    """Equality of two array tuples, NaN-aware for floats."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
            np.testing.assert_array_equal(x[~np.isnan(x)], y[~np.isnan(y)])
        else:
            np.testing.assert_array_equal(x, y)


def _outcome(parse, text):
    """``("arrays", tuple)`` or ``("malformed", ordinal)`` or
    ``("error", message)``: a parse's result as a comparable value."""
    try:
        return "arrays", parse(text)
    except ValueError as e:
        ordinal = getattr(e, "ordinal", None)
        if ordinal is not None:
            return "malformed", ordinal
        return "error", str(e)


# ------------------------------------------------------------ the corpus


@pytest.mark.parametrize("n_random,seed", [(24, 20240803), (0, 1), (60, 7)])
def test_corpus_equals_the_reference(n_random, seed):
    port = port_corpus.corpus_documents(n_random, seed)
    assert port == ref_corpus.corpus_documents(n_random, seed)
    assert len(port) == len(ref_corpus._edge_documents()) + n_random
    assert port_corpus.AF_SPELLINGS == ref_corpus.AF_SPELLINGS


def test_corpus_is_deterministic_and_covers_edges():
    a = port_corpus.corpus_documents()
    assert a == port_corpus.corpus_documents()
    assert N_DOCUMENTS == 40
    assert b"" in a  # the empty buffer
    assert b"\r\n" in b"\n".join(a)  # CRLF documents
    assert any(doc and not doc.startswith(b"#") for doc in a)  # headerless


# ---------------------------------------------------- the parsers on it


@pytest.mark.parametrize("index", range(N_DOCUMENTS))
def test_native_parse_equals_the_reference(index):
    """Document ``index``: the port's native serial parse gives the
    reference's arrays, or the same malformed-line ordinal."""
    _need_native()
    if ref_native.vcf_library() is None:
        pytest.skip(f"no reference build: {ref_native.native_unavailable_reason()}")
    text = port_corpus.corpus_documents()[index]
    port_kind, port_value = _outcome(port_native.parse_vcf_arrays, text)
    ref_kind, ref_value = _outcome(ref_native.parse_vcf_arrays, text)
    assert port_kind == ref_kind, (port_value, ref_value)
    if port_kind == "arrays":
        _assert_same_arrays(port_value, ref_value)
    else:
        assert port_value == ref_value


def test_chunk_parallel_parse_reproduces_the_serial_one():
    """At 2 and 5 workers, every document's span-parallel parse gives the
    serial outcome: the same arrays, or the same file-level ordinal."""
    _need_native()
    checked = 0
    for i, text in enumerate(port_corpus.corpus_documents()):
        serial_kind, serial = _outcome(port_native.parse_vcf_arrays, text)
        for workers in (2, 5):
            kind, parallel = _outcome(
                functools.partial(_native_parallel_vcf_arrays, workers=workers), text)
            assert kind == serial_kind, f"corpus[{i}] workers={workers}"
            if kind == "arrays":
                _assert_same_arrays(serial, parallel)
                checked += 1
            elif kind == "malformed":
                assert parallel == serial, f"corpus[{i}] workers={workers}"
    assert checked >= 20


def test_native_parse_equals_the_python_parser(tmp_path):
    """Every document the native parser accepts parses to the same arrays,
    contig by contig, through the port's Python parser."""
    _need_native()
    checked = 0
    for i, doc in enumerate(port_corpus.corpus_documents()):
        try:
            native = port_native.parse_vcf_arrays(doc)
        except ValueError:
            continue  # malformed by design
        path = tmp_path / f"corpus-{i:03d}.vcf"
        path.write_bytes(doc)
        try:
            python = _python_vcf_arrays(str(path), "corpus")
        except ValueError:
            continue
        grouped_native = _group_by_contig(*native)
        grouped_python = _group_by_contig(*python)
        assert set(grouped_native) == set(grouped_python), f"corpus[{i}]"
        for contig in grouped_native:
            _assert_same_arrays(grouped_native[contig], grouped_python[contig])
        checked += 1
    assert checked >= 10


# ------------------------------------------------------- the harness


@pytest.mark.skipif(not _compiler_available(), reason="no C++ compiler")
def test_asan_harness_replays_mini_corpus_clean():
    proc = port_sanitize.replay_corpus(
        "asan", corpus=port_corpus.corpus_documents()[:8])
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.skipif(not _compiler_available(), reason="no C++ compiler")
def test_harness_lands_in_the_port_build_dir():
    path = port_native.build_sanitizer_harness("asan")
    assert os.path.dirname(path) == str(BUILD_DIR)
    assert BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    assert re.fullmatch(r"vcfparse-[0-9a-f]{16}-asan", os.path.basename(path))
    assert os.access(path, os.X_OK)
    assert port_native.build_sanitizer_harness("asan") == path  # cached


def test_harness_build_refusals(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="unknown sanitizer mode"):
        port_native.build_sanitizer_harness("msan")
    monkeypatch.setattr(port_native, "_REPO_NATIVE", str(tmp_path))
    with pytest.raises(RuntimeError, match="missing native source"):
        port_native.build_sanitizer_harness("asan")
    monkeypatch.undo()
    monkeypatch.setattr(port_native, "_compiler", lambda: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        port_native.build_sanitizer_harness("ubsan")


@pytest.mark.skipif(not _compiler_available(), reason="no C++ compiler")
def test_failed_harness_build_raises(monkeypatch):
    monkeypatch.setitem(port_native.SANITIZER_FLAGS, "asan",
                        ("-fno-such-flag-for-this-test",))
    with pytest.raises(RuntimeError, match="native build failed"):
        port_native.build_sanitizer_harness("asan")


def test_sanitizer_flags_equal_the_reference():
    assert port_native.SANITIZER_FLAGS == ref_native.SANITIZER_FLAGS
    assert port_sanitize._SANITIZER_ENV == ref_sanitize._SANITIZER_ENV
    assert port_sanitize.DEFAULT_MODES == ref_sanitize.DEFAULT_MODES == MODES


# ----------------------------------------- run_sanitize against the reference


def _script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


#: Exit codes of each outcome, without and with ``strict``.
OUTCOMES = {
    "no_compiler": (0, 2),
    "build_fails": (0, 1),
    "hangs": (1, 1),
    "exit_99": (1, 1),
    "clean": (0, 0),
}


def _stub(outcome, tmp_path, monkeypatch):
    """The same stand-in for both packages: ``_compiler`` gone, a build
    that raises, or a harness script in place of the built one."""
    harness = None
    if outcome == "hangs":
        harness = _script(tmp_path, "hangs", "exec sleep 30")
    elif outcome == "exit_99":
        harness = _script(
            tmp_path, "exit99",
            'echo "==1==ERROR: AddressSanitizer: heap-buffer-overflow ($# files,'
            ' $ASAN_OPTIONS)" >&2\nexit 99')
    elif outcome == "clean":
        harness = _script(tmp_path, "clean", "exit 0")
    for native, sanitize in ((ref_native, ref_sanitize), (port_native, port_sanitize)):
        if outcome == "no_compiler":
            monkeypatch.setattr(native, "_compiler", lambda: None)
            continue
        monkeypatch.setattr(native, "_compiler", lambda: "/usr/bin/c++")
        if outcome == "build_fails":
            def build(mode):
                raise RuntimeError(f"native build failed (no {mode} runtime)")
        else:
            def build(mode, harness=harness):
                return harness
        monkeypatch.setattr(native, "build_sanitizer_harness", build)
        if outcome == "hangs":
            monkeypatch.setattr(sanitize, "replay_corpus", functools.partial(
                sanitize.replay_corpus, timeout=0.2))


@pytest.mark.parametrize("strict", [False, True], ids=["lenient", "strict"])
@pytest.mark.parametrize("outcome", sorted(OUTCOMES))
def test_run_sanitize_equals_the_reference(outcome, strict, tmp_path, monkeypatch,
                                           capsys):
    _stub(outcome, tmp_path, monkeypatch)
    results = {}
    for name, sanitize in (("ref", ref_sanitize), ("port", port_sanitize)):
        rc = sanitize.run_sanitize(MODES, strict=strict)
        results[name] = (rc, capsys.readouterr().out)
    assert results["port"] == results["ref"]
    rc, out = results["port"]
    assert rc == OUTCOMES[outcome][strict]
    lines = [line for line in out.splitlines() if line.startswith("graftcheck sanitize")]
    if outcome == "no_compiler":
        assert lines == [out.strip()] and "SKIP (no C++ compiler" in out
        return
    assert [line.split(":")[0] for line in lines] == [
        f"graftcheck sanitize[{mode}]" for mode in MODES]
    verdict = {"build_fails": "SKIP (native build failed", "hangs": "FAIL (harness hung past 0s",
               "exit_99": "FAIL (exit 99)", "clean": f"OK — {N_DOCUMENTS} corpus documents"}
    assert all(verdict[outcome] in line for line in lines), out
    if outcome == "exit_99":
        assert f"({N_DOCUMENTS} files, detect_leaks=0" in out  # the options reached it


def test_cli_sanitize_runs_the_modes_asked(tmp_path, monkeypatch, capsys):
    """``graftcheck sanitize --modes`` through both CLIs, on a clean
    stand-in harness: one line a mode asked, in the order asked."""
    from spark_examples_tpu.check.cli import main as ref_main
    from spark_examples_tpu_torch.cli import main

    _stub("clean", tmp_path, monkeypatch)
    argv = ["sanitize", "--modes", "tsan, asan", "--strict"]
    assert main(["graftcheck", *argv]) == 0
    port_out = capsys.readouterr().out
    assert ref_main(argv) == 0
    assert capsys.readouterr().out == port_out
    assert [line.split(":")[0] for line in port_out.splitlines()] == [
        "graftcheck sanitize[tsan]", "graftcheck sanitize[asan]"]


@pytest.mark.slow
@pytest.mark.skipif(not _compiler_available(), reason="no C++ compiler")
@pytest.mark.parametrize("mode", MODES)
def test_sanitizer_full_corpus_replay(mode):
    proc = port_sanitize.replay_corpus(mode)
    assert proc.returncode == 0, proc.stderr[-2000:]
