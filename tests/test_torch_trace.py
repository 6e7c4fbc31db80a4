"""The flight recorder and the fleet trace (``obs/recorder.py``,
``obs/trace.py``) of both packages, held against each other.

Every case of the JAX package's ``tests/test_trace.py`` that covers these
two modules (trace ids, the recorder's ring, torn tails, incarnations, the
fault flush, the merge of steals, zombies and requeues, the validator and
the export CLI) runs here once per package (``pkg``). The cross checks:
a segment written by either package reads the same in both; one run
directory of journal plus segments, written with fixed timestamps, merges
to equal documents in both, and each validator passes the other's export;
and ``variants-pca --trace-dir`` writes the same sequence of
(name, ph, tid, arg keys) in the port (``--device cpu``) as in the
reference, on the same flags.
"""

import contextlib
import importlib
import io
import json
import os
import types

import pytest

PACKAGES = {"ref": "spark_examples_tpu", "port": "spark_examples_tpu_torch"}
PKGS = sorted(PACKAGES)


def _pkg(name):
    base = PACKAGES[name]
    return types.SimpleNamespace(
        recorder=importlib.import_module(f"{base}.obs.recorder"),
        trace=importlib.import_module(f"{base}.obs.trace"),
        journal=importlib.import_module(f"{base}.serve.journal"),
        faults=importlib.import_module(f"{base}.utils.faults"),
    )


def _write_segment(run_dir, m, replica, events):
    directory = m.recorder.trace_dir(str(run_dir))
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"{replica}.1.jsonl"), "w", encoding="utf-8") as f:
        for event in events:
            base = {"replica": replica, "pid": 1, "tid": "control"}
            base.update(event)
            f.write(json.dumps(base) + "\n")


def _write_journal(run_dir, m, records):
    with open(m.journal.journal_path(str(run_dir)), "w", encoding="utf-8") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")


# ------------------------------------------------------------ trace ids


@pytest.mark.parametrize("pkg", PKGS)
def test_trace_id_mint_and_normalize(pkg):
    t = _pkg(pkg).trace
    tid = t.mint_trace_id()
    assert t.normalize_trace_id(tid) == tid
    assert t.normalize_trace_id(tid.upper()) == tid
    assert t.normalize_trace_id("  " + tid + "  ") == tid
    for bad in (None, 42, "", "short", "g" * 32, "a b c d e f a b"):
        assert t.normalize_trace_id(bad) is None
    assert t.mint_trace_id() != t.mint_trace_id()
    assert t.TRACE_HEADER == "X-Trace-Id"


# ------------------------------------------------------------- recorder


@pytest.mark.parametrize("pkg", PKGS)
def test_recorder_round_trip(pkg, tmp_path):
    r = _pkg(pkg).recorder
    rec = r.FlightRecorder(str(tmp_path), "a", clock=lambda: 10.0)
    rec.record("accepted", job="job-1", trace="ab" * 16, job_class="small")
    rec.begin("job", job="job-1", tid="small-0")
    rec.end("job", job="job-1", tid="small-0", status="done")
    assert rec.flush() == 3
    events = r.read_segments(str(tmp_path))
    assert [e["name"] for e in events] == ["accepted", "job", "job"]
    assert [e["ph"] for e in events] == ["i", "B", "E"]
    assert events[0]["args"] == {"job_class": "small"}
    assert events[0]["trace"] == "ab" * 16
    assert events[1]["tid"] == "small-0"
    assert events[0]["replica"] == "a"
    rec.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_recorder_ring_bound_drops_oldest(pkg, tmp_path):
    r = _pkg(pkg).recorder
    rec = r.FlightRecorder(str(tmp_path), "a", capacity=3)
    for i in range(7):
        rec.record(f"e{i}")
    assert rec.flush() == 4  # 3 survivors + the ring-overflow marker
    events = r.read_segments(str(tmp_path))
    assert events[0]["name"] == "ring-overflow"
    assert events[0]["args"]["dropped"] == 4
    assert [e["name"] for e in events[1:]] == ["e4", "e5", "e6"]
    rec.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_recorder_torn_tail_skipped(pkg, tmp_path):
    r = _pkg(pkg).recorder
    rec = r.FlightRecorder(str(tmp_path), "a")
    rec.record("whole")
    rec.flush()
    rec.close()
    with open(rec.path, "a", encoding="utf-8") as f:
        f.write('{"ts": 1.0, "name": "torn", "ph": "i", "repl')
    assert [e["name"] for e in r.read_segments(str(tmp_path))] == ["whole"]


@pytest.mark.parametrize("pkg", PKGS)
def test_recorder_closed_ignores_and_bad_phase_raises(pkg, tmp_path):
    r = _pkg(pkg).recorder
    rec = r.FlightRecorder(str(tmp_path), "a")
    with pytest.raises(ValueError):
        rec.record("x", ph="Q")
    rec.close()
    rec.record("late")
    assert rec.flush() == 0
    assert r.read_segments(str(tmp_path)) == []


@pytest.mark.parametrize("pkg", PKGS)
def test_recorder_two_incarnations_do_not_collide(pkg, tmp_path):
    r = _pkg(pkg).recorder
    a1 = r.FlightRecorder(str(tmp_path), "a")
    a1.record("first-life")
    a1.flush()
    a1.close()
    a2 = r.FlightRecorder(str(tmp_path), "a")
    assert a2.path == a1.path  # same pid here: appends, still whole
    a2.record("second-life")
    a2.flush()
    a2.close()
    names = [e["name"] for e in r.read_segments(str(tmp_path))]
    assert names == ["first-life", "second-life"]


@pytest.mark.parametrize("pkg", PKGS)
def test_fault_kill_point_flushes_recorder(pkg, tmp_path):
    """A registered flush hook runs before an injected fault fires, so the
    ring reaches disk ahead of the kill (the port's driver registers its
    recorder so under ``--trace-dir``)."""
    m = _pkg(pkg)
    rec = m.recorder.FlightRecorder(str(tmp_path), "a")
    m.faults.add_flush_hook(rec.flush)
    try:
        m.faults.configure("raise@driver.post-flush")
        rec.record("about-to-die", job="job-1")
        with pytest.raises(m.faults.InjectedFault):
            m.faults.kill_point("driver.post-flush")
        events = m.recorder.read_segments(str(tmp_path))
        assert [e["name"] for e in events] == ["about-to-die"]
    finally:
        m.faults.remove_flush_hook(rec.flush)
        m.faults.configure(None)
        rec.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_fault_flush_hook_errors_are_swallowed(pkg):
    f = _pkg(pkg).faults

    def bad_hook():
        raise RuntimeError("telemetry bug")

    f.add_flush_hook(bad_hook)
    try:
        f.configure("raise@driver.post-flush")
        with pytest.raises(f.InjectedFault):
            f.kill_point("driver.post-flush")
    finally:
        f.remove_flush_hook(bad_hook)
        f.configure(None)


@pytest.mark.parametrize("pkg", PKGS)
def test_recorder_failed_flush_retains_events(pkg, tmp_path):
    r = _pkg(pkg).recorder
    blocker = tmp_path / "trace"
    blocker.write_text("in the way")
    rec = r.FlightRecorder(str(tmp_path), "a", capacity=2)
    rec.record("one")
    rec.record("two")
    rec.record("three")  # overflows: "one" dropped
    assert rec.flush() == 0
    assert rec.dropped == 1
    blocker.unlink()
    assert rec.flush() == 3
    events = r.read_segments(str(tmp_path))
    assert [e["name"] for e in events] == ["ring-overflow", "two", "three"]
    assert events[0]["args"]["dropped"] == 1
    rec.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_read_segments_skips_foreign_jsonl(pkg, tmp_path):
    m = _pkg(pkg)
    _write_segment(tmp_path, m, "solo", [
        {"ts": 1.0, "name": "job", "ph": "B", "job": "job-1"},
        {"ts": 2.0, "name": "job", "ph": "E", "job": "job-1"},
    ])
    with open(os.path.join(m.recorder.trace_dir(str(tmp_path)), "foreign.jsonl"), "w") as f:
        f.write('{"ts": 1.5, "name": "alien", "ph": "i"}\n')
        f.write('{"totally": "unrelated"}\n')
    assert [e["name"] for e in m.recorder.read_segments(str(tmp_path))] == ["job", "job"]
    assert m.trace.validate_chrome_trace(m.trace.merge_run_trace(str(tmp_path))) == []


# ------------------------------------------------------- merge + validate

STEAL_JOB = "job-a-000001"
STEAL_TRACE = "0123456789abcdef" * 2


def _steal_run(run_dir, m):
    """Owner ``a`` accepts and begins a job and dies (its ``job`` span never
    ends); stealer ``b`` steals and settles it."""
    job, trace = STEAL_JOB, STEAL_TRACE
    _write_segment(run_dir, m, "a", [
        {"ts": 1.0, "name": "accepted", "ph": "i", "trace": trace, "job": job},
        {"ts": 1.1, "name": "job", "ph": "B", "trace": trace, "job": job, "tid": "all-0",
         "args": {"epoch": 1}},
        {"ts": 1.2, "name": "device-began", "ph": "i", "trace": trace, "job": job,
         "tid": "all-0", "args": {"epoch": 1}},
    ])
    _write_segment(run_dir, m, "b", [
        {"ts": 3.0, "name": "steal", "ph": "i", "trace": trace, "job": job,
         "args": {"from": "a", "epoch": 2}},
        {"ts": 3.1, "name": "adopt", "ph": "i", "trace": trace, "job": job,
         "args": {"stolen": True, "device_began": True}},
        {"ts": 3.2, "name": "terminal", "ph": "i", "trace": trace, "job": job,
         "args": {"status": "failed"}},
    ])
    _write_journal(run_dir, m, [
        {"event": "accepted", "id": job, "request": {}, "job_class": "large",
         "submitted_unix": 1.0, "trace": trace, "replica": "a"},
        {"event": "lease", "id": job, "epoch": 1, "replica": "a"},
        {"event": "began", "id": job, "replica": "a", "epoch": 1},
        {"event": "lease", "id": job, "epoch": 2, "replica": "b", "stolen": True},
        {"event": "terminal", "id": job, "status": "failed", "replica": "b", "epoch": 2},
    ])


def _zombie_run(run_dir, m):
    job = STEAL_JOB
    _write_segment(run_dir, m, "a", [{"ts": 1.0, "name": "accepted", "ph": "i", "job": job}])
    _write_journal(run_dir, m, [
        {"event": "accepted", "id": job, "request": {}, "job_class": "small",
         "submitted_unix": 1.0, "replica": "a"},
        {"event": "lease", "id": job, "epoch": 2, "replica": "b"},
        {"event": "terminal", "id": job, "status": "done", "replica": "a", "epoch": 1},
        {"event": "terminal", "id": job, "status": "failed", "replica": "b", "epoch": 2},
    ])


def _requeue_run(run_dir, m):
    job = "job-000001"
    _write_segment(run_dir, m, "solo", [
        {"ts": 1.0, "name": "job", "ph": "B", "job": job},
        {"ts": 1.5, "name": "job", "ph": "E", "job": job, "args": {"status": "worker-crashed"}},
        {"ts": 2.0, "name": "job", "ph": "B", "job": job},
        {"ts": 3.0, "name": "job", "ph": "E", "job": job, "args": {"status": "done"}},
    ])


def _zombie_arrow_run(run_dir, m):
    job = STEAL_JOB
    _write_segment(run_dir, m, "a", [
        {"ts": 1.0, "name": "job", "ph": "B", "job": job},
        {"ts": 5.0, "name": "job", "ph": "E", "job": job,
         "args": {"status": "failed", "abandoned": "lease-lost"}},
        {"ts": 5.1, "name": "abandoned", "ph": "i", "job": job},
    ])
    _write_segment(run_dir, m, "b", [
        {"ts": 3.0, "name": "steal", "ph": "i", "job": job, "args": {"from": "a", "epoch": 2}},
        {"ts": 3.5, "name": "terminal", "ph": "i", "job": job, "args": {"status": "failed"}},
    ])


def _unmatched_run(run_dir, m):
    _write_segment(run_dir, m, "solo", [{"ts": 1.0, "name": "job", "ph": "E", "job": "job-1"}])


RUNS = {
    "steal": _steal_run,
    "zombie": _zombie_run,
    "requeue": _requeue_run,
    "zombie-arrow": _zombie_arrow_run,
    "unmatched-end": _unmatched_run,
}


@pytest.mark.parametrize("pkg", PKGS)
def test_merge_two_replica_steal_trace(pkg, tmp_path):
    m = _pkg(pkg)
    _steal_run(tmp_path, m)
    doc = m.trace.merge_run_trace(str(tmp_path))
    assert m.trace.validate_chrome_trace(doc) == []
    events = doc["traceEvents"]
    pids = {e["args"]["name"]: e["pid"] for e in events
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert set(pids) == {"replica a", "replica b"}
    spans = [e for e in events if e["ph"] == "X"]
    assert len(spans) == 1 and spans[0]["name"] == "job"
    assert spans[0]["pid"] == pids["replica a"]
    assert spans[0]["args"]["truncated"] is True and spans[0]["args"]["epoch"] == 1
    s = [e for e in events if e["ph"] == "s"]
    f = [e for e in events if e["ph"] == "f"]
    assert len(s) == 1 and len(f) == 1 and s[0]["id"] == f[0]["id"]
    assert s[0]["pid"] == pids["replica a"] and f[0]["pid"] == pids["replica b"]
    facts = doc["otherData"]["jobs"][STEAL_JOB]
    assert (facts["status"], facts["stolen"], facts["lease_epoch"], facts["trace"]) == (
        "failed", True, 2, STEAL_TRACE)
    assert doc["otherData"]["steal_arrows"] == 1
    assert doc["otherData"]["truncated_spans"] == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_merge_fences_zombie_terminal(pkg, tmp_path):
    m = _pkg(pkg)
    _zombie_run(tmp_path, m)
    assert m.trace.merge_run_trace(str(tmp_path))["otherData"]["jobs"][STEAL_JOB]["status"] == "failed"


@pytest.mark.parametrize("pkg", PKGS)
def test_merge_pairs_requeued_job_spans(pkg, tmp_path):
    m = _pkg(pkg)
    _requeue_run(tmp_path, m)
    doc = m.trace.merge_run_trace(str(tmp_path))
    assert m.trace.validate_chrome_trace(doc) == []
    spans = sorted((e for e in doc["traceEvents"] if e["ph"] == "X"), key=lambda e: e["ts"])
    assert [s["args"]["status"] for s in spans] == ["worker-crashed", "done"]
    assert [s["dur"] for s in spans] == [500_000, 1_000_000]


@pytest.mark.parametrize("pkg", PKGS)
def test_merge_unmatched_end_becomes_instant(pkg, tmp_path):
    m = _pkg(pkg)
    _unmatched_run(tmp_path, m)
    doc = m.trace.merge_run_trace(str(tmp_path))
    assert m.trace.validate_chrome_trace(doc) == []
    instants = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert len(instants) == 1 and instants[0]["args"]["unmatched_end"] is True


@pytest.mark.parametrize("pkg", PKGS)
def test_steal_arrow_anchors_at_or_before_the_steal(pkg, tmp_path):
    m = _pkg(pkg)
    _zombie_arrow_run(tmp_path, m)
    doc = m.trace.merge_run_trace(str(tmp_path))
    assert m.trace.validate_chrome_trace(doc) == []
    s = [e for e in doc["traceEvents"] if e["ph"] == "s"]
    f = [e for e in doc["traceEvents"] if e["ph"] == "f"]
    assert len(s) == 1 and len(f) == 1 and s[0]["ts"] <= f[0]["ts"]


@pytest.mark.parametrize("pkg", PKGS)
def test_merge_empty_run_dir_raises(pkg, tmp_path):
    with pytest.raises(FileNotFoundError):
        _pkg(pkg).trace.merge_run_trace(str(tmp_path))


MALFORMED = {
    "orphan span": {"traceEvents": [{"ph": "B", "name": "s", "pid": 1, "tid": 1, "ts": 0}]},
    "orphan end": {"traceEvents": [{"ph": "E", "name": "s", "pid": 1, "tid": 1, "ts": 0}]},
    "mismatched nesting": {"traceEvents": [
        {"ph": "B", "name": "outer", "pid": 1, "tid": 1, "ts": 0},
        {"ph": "B", "name": "inner", "pid": 1, "tid": 1, "ts": 1},
        {"ph": "E", "name": "outer", "pid": 1, "tid": 1, "ts": 2},
        {"ph": "E", "name": "inner", "pid": 1, "tid": 1, "ts": 3},
    ]},
    "orphan flow arrow": {"traceEvents": [
        {"ph": "s", "name": "arrow", "id": 7, "pid": 1, "tid": 1, "ts": 0}]},
    "bad dur": {"traceEvents": [
        {"ph": "X", "name": "s", "pid": 1, "tid": 1, "ts": 0, "dur": -1}]},
    "unknown phase": {"traceEvents": [{"ph": "?", "name": "s", "ts": 0}]},
}


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("problem", sorted(MALFORMED))
def test_validator_catches_malformed_traces(pkg, problem):
    validate = _pkg(pkg).trace.validate_chrome_trace
    assert validate([]) != []
    assert validate({"traceEvents": "nope"}) != []
    assert validate({"traceEvents": [
        {"ph": "B", "name": "s", "pid": 1, "tid": 1, "ts": 0},
        {"ph": "E", "name": "s", "pid": 1, "tid": 1, "ts": 5},
    ]}) == []
    assert any(problem in e for e in validate(MALFORMED[problem]))


# ------------------------------------------------------------ CLI verb


@pytest.mark.parametrize("pkg", PKGS)
def test_trace_export_cli(pkg, tmp_path):
    m = _pkg(pkg)
    _requeue_run(tmp_path, m)
    out = tmp_path / "merged.json"
    assert m.trace.export_main(["export", "--run-dir", str(tmp_path), "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert m.trace.validate_chrome_trace(doc) == []
    assert any(e["ph"] == "X" for e in doc["traceEvents"])
    assert m.trace.export_main(["export", "--run-dir", str(tmp_path)]) == 0
    assert os.path.exists(os.path.join(m.recorder.trace_dir(str(tmp_path)), "merged.trace.json"))


@pytest.mark.parametrize("pkg", PKGS)
def test_trace_export_cli_exit_codes(pkg, tmp_path):
    export_main = _pkg(pkg).trace.export_main
    assert export_main([]) == 2
    assert export_main(["frobnicate"]) == 2
    assert export_main(["export", "--run-dir", str(tmp_path / "nope")]) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert export_main(["export", "--run-dir", str(empty)]) == 1


def test_trace_cli_verb_runs_without_a_card(tmp_path):
    """The port's ``trace`` verb is device-free: it takes no ``--device``
    and runs on a machine with no card, its exit codes propagating."""
    from spark_examples_tpu_torch.cli import main

    assert main(["trace"]) == 2
    _requeue_run(tmp_path, _pkg("port"))
    assert main(["trace", "export", "--run-dir", str(tmp_path)]) == 0


# ---------------------------------------------------------- cross checks


@pytest.mark.parametrize("writer", PKGS)
def test_segments_read_the_same_in_both_packages(writer, tmp_path):
    w = _pkg(writer)
    rec = w.recorder.FlightRecorder(str(tmp_path), "host0", capacity=3,
                                    clock=iter([1.0, 2.0, 3.0, 4.0, 5.0]).__next__)
    rec.record("accepted", job="job-1", trace="ab" * 16, job_class="small")
    rec.begin("run", tid="pipeline")
    rec.end("run", tid="pipeline", status="done")
    rec.record("late", tid="pipeline", hosts=2)  # overflows the ring of 3
    rec.flush()
    rec.close()
    got = [_pkg(reader).recorder.read_segments(str(tmp_path)) for reader in PKGS]
    assert got[0] == got[1]
    assert [e["name"] for e in got[0]] == ["ring-overflow", "run", "run", "late"]
    with open(rec.path) as f:
        keys = [sorted(json.loads(line)) for line in f]
    assert keys[1] == ["name", "ph", "pid", "replica", "tid", "ts"]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_merged_documents_equal_in_both_packages(run, tmp_path):
    """One run directory (segments and journal with fixed timestamps),
    merged by each package: equal documents, and each validator passes the
    other's export."""
    RUNS[run](tmp_path, _pkg("ref"))
    docs = {pkg: _pkg(pkg).trace.merge_run_trace(str(tmp_path)) for pkg in PKGS}
    assert docs["ref"] == docs["port"]
    for validator in PKGS:
        for exported in PKGS:
            assert _pkg(validator).trace.validate_chrome_trace(docs[exported]) == []


TRACE_FLAGS = ["--num-samples", "12", "--references", "17:41196311:41217499"]


def _segment_shape(run_dir, m):
    return [(e["name"], e["ph"], e["tid"], sorted(e.get("args", {})))
            for e in m.recorder.read_segments(str(run_dir))]


@pytest.mark.parametrize("argv", [
    [],
    ["--ingest", "packed"],
    ["--references", "17:41196311:41217499,18:41196311:41217499", "--num-samples", "12"],
], ids=["device", "packed", "two-contigs"])
def test_variants_pca_trace_dir_matches_the_reference(argv, tmp_path):
    """``variants-pca --trace-dir`` at ``--device cpu``, and the reference
    on the same flags: the two segments hold the same sequence of (name,
    ph, tid, arg keys), and the port's export passes both validators."""
    from spark_examples_tpu.pipeline.pca_driver import run_pipeline as ref_run
    from spark_examples_tpu.config import PcaConf as RefConf
    from spark_examples_tpu_torch.cli import main
    from spark_examples_tpu_torch.config import PcaConf

    flags = TRACE_FLAGS + argv
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    with contextlib.redirect_stdout(io.StringIO()):
        ref_run(RefConf.parse(flags + ["--trace-dir", str(ref_dir)]))
        assert main(["variants-pca", *flags, "--device", "cpu", "--trace-dir", str(port_dir)]) == 0
    port_shape = _segment_shape(port_dir, _pkg("port"))
    assert port_shape == _segment_shape(ref_dir, _pkg("ref"))
    assert [n for n, *_ in port_shape] == [
        "run", "ingest+similarity", "ingest+similarity", "center+pca", "center+pca", "run"]
    assert os.listdir(port_dir / "trace") == [f"host0.{os.getpid()}.jsonl"]
    assert PcaConf.parse(flags + ["--trace-dir", str(port_dir)]).trace_dir == str(port_dir)
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(["trace", "export", "--run-dir", str(port_dir)]) == 0
    merged = json.loads((port_dir / "trace" / "merged.trace.json").read_text())
    for pkg in PKGS:
        assert _pkg(pkg).trace.validate_chrome_trace(merged) == []
