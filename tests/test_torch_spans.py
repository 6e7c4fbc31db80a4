"""Spans as profiler ranges: every span the port's recorder opens is a
``record_function`` range of a ``torch.profiler`` trace, nested as the span
tree and closed after the span's ``sync``; a PCoA run's roots are
``setup``, ``ingest+similarity``, ``center+pca`` and ``epilogue``, with
``callsets``, ``plan``/``walk``/``dispatch``/``counters``,
``center``/``eigh``/``rows`` and ``emit`` under them."""

import contextlib
import glob
import io
import json
import os
import threading

import pytest
import torch

from spark_examples_tpu_torch.config import PcaConf
from spark_examples_tpu_torch.obs.spans import SpanRecorder
from spark_examples_tpu_torch.pipeline import pca_driver
from spark_examples_tpu_torch.utils.tracing import StageTimes, device_trace

BASE = ["--references", "17:0:300000,18:0:200000", "--variant-set-id", "vs-a",
        "--num-samples", "24", "--seed", "5", "--bases-per-partition", "100000",
        "--block-size", "1024", "--blocks-per-dispatch", "8"]
RING = ["--mesh-shape", "1,4", "--similarity-strategy", "sharded"]


def _ranges(trace_dir):
    """The trace's ``user_annotation`` events of this thread:
    ``[(start, end, name)]`` sorted outer first."""
    (path,) = glob.glob(os.path.join(str(trace_dir), "*.json"))
    events = json.load(open(path))["traceEvents"]
    tid = threading.get_native_id()
    return sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("tid") == tid),
        key=lambda r: (r[0], -r[1]),
    )


def _range_tree(ranges):
    """``[(name, children)]`` by containment."""
    roots, stack = [], []
    for start, end, name in ranges:
        while stack and not (start >= stack[-1][0] and end <= stack[-1][1]):
            stack.pop()
        node = (name, [])
        (stack[-1][2][1] if stack else roots).append(node)
        stack.append((start, end, node))
    return roots


def _span_tree(spans, added=()):
    """``[(name, children)]`` of the recorder's tree, less the spans
    attached by ``add`` (no range)."""
    def walk(nodes):
        return [(s["name"], walk(s["children"])) for s in nodes if s["name"] not in added]

    return walk(spans.as_list())


def _run(argv, monkeypatch=None):
    syncs = []
    if monkeypatch is not None:
        # A CPU run has nothing to wait for (``synchronizer`` gives None);
        # a recording stand-in makes its spans ``synced`` as on the card.
        monkeypatch.setattr(pca_driver, "synchronizer",
                            lambda device: (lambda: syncs.append(device)))
    with contextlib.redirect_stdout(io.StringIO()):
        result = pca_driver.run_pipeline(PcaConf.parse(BASE + argv + ["--device", "cpu"]))
    return result, syncs


@pytest.mark.parametrize("arm, argv, outer, added", [
    ("device", ["--ingest", "device"], False, ()),
    ("device", ["--ingest", "device"], True, ()),
    ("ring", ["--ingest", "device"] + RING, False, ()),
    ("packed", ["--ingest", "packed"], False, ("dispatch", "chunk-parse")),
], ids=["device-profile-dir", "device-outer-trace", "ring-profile-dir", "packed-profile-dir"])
def test_trace_has_a_range_per_span_nested_as_the_tree(tmp_path, arm, argv, outer, added):
    trace_dir = tmp_path / "trace"
    if outer:
        with device_trace(str(trace_dir)):
            result, _ = _run(argv)
    else:
        result, _ = _run(argv + ["--profile-dir", str(trace_dir)])
    want = _span_tree(result.driver.spans, added)
    assert [name for name, _ in want] == ["setup", "ingest+similarity", "center+pca", "epilogue"]
    assert _range_tree(_ranges(trace_dir)) == want


@pytest.mark.parametrize("argv", [["--ingest", "device"], ["--ingest", "device"] + RING],
                         ids=["dense", "ring"])
def test_pcoa_span_tree(monkeypatch, argv):
    result, syncs = _run(argv, monkeypatch)
    driver = result.driver
    roots = driver.spans.as_list()
    assert [r["name"] for r in roots] == ["setup", "ingest+similarity", "center+pca", "epilogue"]
    children = {r["name"]: [c["name"] for c in r["children"]] for r in roots}
    assert children["setup"] == ["callsets"]
    assert children["ingest+similarity"] == ["plan", "walk", "counters"]
    assert children["center+pca"] == ["center", "eigh", "rows"]
    assert children["epilogue"] == ["emit"]
    walk = roots[1]["children"][1]
    assert {c["name"] for c in walk["children"]} == {"dispatch"}
    assert len(walk["children"]) == driver.accumulator.dispatches > 1
    synced = {row["path"]: row["synced"] for row in driver.spans.flat()}
    for path in ("ingest+similarity", "center+pca", "center+pca/center", "center+pca/eigh"):
        assert synced[path] is True
    assert not synced["setup"] and not synced["epilogue"] and not synced["center+pca/rows"]
    # Two stages and their two synchronised children.
    assert len(syncs) == 4
    assert all(r["seconds"] is not None for r in roots)


def test_manifest_holds_every_root_closed(tmp_path):
    result, _ = _run(["--ingest", "device", "--metrics-json", str(tmp_path / "m.json")])
    doc = json.loads((tmp_path / "m.json").read_text())
    assert [s["name"] for s in doc["spans"]] == [
        "setup", "ingest+similarity", "center+pca", "epilogue"]
    assert all(row["seconds"] is not None for row in result.driver.spans.flat())


@pytest.mark.parametrize("synced", [True, False])
def test_a_range_closes_after_its_sync(tmp_path, synced):
    spans, marks = SpanRecorder(), []

    def sync():
        marks.append(torch.arange(3).flip(0))  # an operator of its own: aten::flip

    with device_trace(str(tmp_path)):
        with spans.span("outer", sync=sync if synced else None):
            torch.ones(2)
        if not synced:
            sync()
    (span,) = spans.as_list()
    assert span["synced"] is synced
    (path,) = glob.glob(str(tmp_path / "*.json"))
    events = [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"]
    (rng,) = [e for e in events if e.get("cat") == "user_annotation"]
    (flip,) = [e for e in events if e["name"] == "aten::flip"]
    inside = rng["ts"] <= flip["ts"] and flip["ts"] + flip["dur"] <= rng["ts"] + rng["dur"]
    assert rng["name"] == "outer" and inside is synced


def test_an_added_span_opens_no_range(tmp_path):
    spans = SpanRecorder()
    with device_trace(str(tmp_path)):
        spans.add("dispatch", 0.25)
    assert _ranges(tmp_path) == []
    assert spans.flat() == [{"path": "dispatch", "seconds": 0.25, "synced": False}]


class _Flight:
    def __init__(self):
        self.events = []

    def begin(self, name, **kw):
        self.events.append(("B", name, kw["tid"]))

    def end(self, name, **kw):
        self.events.append(("E", name, kw["tid"]))


@pytest.mark.parametrize("fails", [False, True], ids=["completes", "raises"])
def test_stage_is_one_range_and_its_flight_pair(tmp_path, fails):
    flight = _Flight()
    times = StageTimes(flight=flight)
    with device_trace(str(tmp_path)):
        with contextlib.suppress(RuntimeError):
            with times.stage("ingest+similarity", sync=lambda: None):
                if fails:
                    raise RuntimeError("stage failed")
    assert [name for _, _, name in _ranges(tmp_path)] == ["ingest+similarity"]
    want = [("B", "ingest+similarity", "pipeline")]
    if not fails:
        want.append(("E", "ingest+similarity", "pipeline"))
    assert flight.events == want
    assert [name for name, _ in times.stages] == ["ingest+similarity"]
