"""The serve daemon (``serve/``) of both packages, held against each other.

The reference's ``tests/test_serve.py`` runs here once per package
(``pkg``): the protocol round trip and its schema violations, the queue's
class order and bounds, ``classify_conf``, the admission 400/413/429/503
matrix with a gated executor, cancellation, deadlines, retention, drain,
the HTTP routes and the ``submit`` verb. The cross checks: the same
request documents go to both daemons and get the same status codes, error
codes, plan-issue codes and plan geometry (the port also refuses
``--device``); over HTTP on the CPU (16 samples, a 10 kb window) the
port's ``similarity`` and ``grm`` summaries equal the reference's, its
``pca`` rows agree within 1e-4 after the sign convention and equal the
port's own batch CLI rows byte for byte, and every job's manifest passes
the port's validator; the service's metric families and heartbeat
segments are the reference's.
"""

import contextlib
import io
import json
import os
import urllib.error
import urllib.request
from dataclasses import asdict

import numpy as np
import pytest
import torch
from torch_serve_helpers import (
    LARGE_FLAGS,
    PKGS,
    TINY_FLAGS,
    GateExecutor,
    pkg_of,
    wait_for,
    wait_status,
)

@pytest.fixture(params=PKGS)
def pkg(request):
    return pkg_of(request.param)


@pytest.fixture
def both():
    return {name: pkg_of(name) for name in PKGS}


@pytest.fixture(autouse=True)
def _no_fault_plan():
    for name in PKGS:
        pkg_of(name).faults.configure(None)
    yield
    for name in PKGS:
        pkg_of(name).faults.configure(None)


@pytest.fixture
def gated(pkg, tmp_path):
    """A started service of ``pkg`` with a gated stub executor."""
    gate = GateExecutor(pkg)
    service = pkg.service(tmp_path / "serve", small_capacity=1, large_capacity=2,
                          executor=gate).start()
    yield pkg, service, gate
    gate.release.set()
    assert service.stop(timeout=60)


# ---------------------------------------------------------------- protocol


def test_protocol_round_trip(pkg):
    doc = pkg.doc(TINY_FLAGS, kind="similarity", deadline_seconds=5.0, tag="t1")
    req = pkg.protocol.parse_request(json.loads(json.dumps(doc)))
    assert (req.kind, list(req.flags), req.deadline_seconds, req.tag) == (
        "similarity", TINY_FLAGS, 5.0, "t1")


def test_protocol_version_rejected(pkg):
    doc = pkg.doc(TINY_FLAGS)
    doc["protocol"]["version"] = pkg.protocol.PROTOCOL_VERSION + 1
    with pytest.raises(pkg.protocol.ProtocolError) as e:
        pkg.protocol.parse_request(doc)
    assert e.value.code == "unsupported-protocol-version"


MUTATIONS = {
    "protocol-missing": lambda d: d.pop("protocol"),
    "protocol-id": lambda d: d["protocol"].update(id="other/proto"),
    "unknown-kind": lambda d: d.update(kind="mystery"),
    "reserved-kind": lambda d: d.update(kind="ld"),
    "bad-flags": lambda d: d.update(flags="--num-samples 8"),
    "bad-deadline": lambda d: d.update(deadline_seconds=-1),
    "bad-tag": lambda d: d.update(tag=7),
    "unknown-field": lambda d: d.update(surprise=True),
}


@pytest.mark.parametrize("code", sorted(MUTATIONS))
def test_protocol_schema_violations(pkg, code):
    doc = pkg.doc(TINY_FLAGS)
    MUTATIONS[code](doc)
    with pytest.raises(pkg.protocol.ProtocolError) as e:
        pkg.protocol.parse_request(doc)
    assert e.value.code == code


def test_error_doc_carries_protocol_and_plan(pkg):
    doc = pkg.protocol.error_doc("plan-rejected", "nope", plan={"issues": []},
                                 retry_after_seconds=2)
    assert doc["protocol"]["id"] == pkg.protocol.PROTOCOL_ID == "spark-examples-tpu/serve"
    assert doc["error"] == {"code": "plan-rejected", "message": "nope",
                            "retry_after_seconds": 2.0}
    assert doc["plan"] == {"issues": []}


def test_protocol_documents_equal_the_reference(both):
    ref, port = both["ref"].protocol, both["port"].protocol
    for name in ("PROTOCOL_ID", "PROTOCOL_VERSION", "JOB_KINDS", "RESERVED_KINDS",
                 "TERMINAL_STATUSES"):
        assert getattr(ref, name) == getattr(port, name), name
    args = dict(job_id="job-000001", kind="grm", job_class="small", status="done",
                submitted_unix=1.5, tag="t", started_unix=2.0, finished_unix=3.0,
                seconds=1.0, result={"grm": {"trace": 4.0}}, manifest_path="m.json",
                compile_cache="warm", plan_geometry={"samples": 8}, slice_name="shared",
                batch_size=2, fused_size=2, trace="ab" * 16, cost={"predicted_seconds": 1.0})
    assert ref.job_doc(**args) == port.job_doc(**args)
    assert ref.error_doc("x", "y", plan={"a": 1}) == port.error_doc("x", "y", plan={"a": 1})
    doc = ref.request_doc(TINY_FLAGS, kind="grm", deadline_seconds=3, tag="z")
    assert doc == port.request_doc(TINY_FLAGS, kind="grm", deadline_seconds=3, tag="z")
    assert asdict(ref.parse_request(doc)) == asdict(port.parse_request(doc))


# ------------------------------------------------------------------- queue


def _job(pkg, job_id, job_class):
    return pkg.queue.Job(id=job_id, request=pkg.protocol.parse_request(pkg.doc(TINY_FLAGS)),
                         conf=None, job_class=job_class, submitted_unix=0.0)


def test_queue_small_class_pops_first(pkg):
    q, S, L = pkg.queue.BoundedJobQueue(4, 4), pkg.queue.SMALL_CLASS, pkg.queue.LARGE_CLASS
    for job_id, cls in (("L1", L), ("S1", S), ("L2", L), ("S2", S)):
        q.put(_job(pkg, job_id, cls))
    assert [q.pop(timeout=1).id for _ in range(4)] == ["S1", "S2", "L1", "L2"]


def test_queue_bounded_and_closed(pkg):
    Q = pkg.queue
    q = Q.BoundedJobQueue(small_capacity=1, large_capacity=1)
    q.put(_job(pkg, "S1", Q.SMALL_CLASS))
    with pytest.raises(Q.QueueFull):
        q.put(_job(pkg, "S2", Q.SMALL_CLASS))
    q.put(_job(pkg, "L1", Q.LARGE_CLASS))
    assert q.depth() == {Q.SMALL_CLASS: 1, Q.LARGE_CLASS: 1}
    q.close()
    with pytest.raises(Q.QueueClosed):
        q.put(_job(pkg, "S3", Q.SMALL_CLASS))
    assert q.pop(timeout=1).id == "S1" and not q.drained
    assert q.pop(timeout=1).id == "L1"
    assert q.pop(timeout=0.05) is None and q.drained


def test_queue_remove_only_while_queued(pkg):
    q = pkg.queue.BoundedJobQueue()
    q.put(_job(pkg, "S1", pkg.queue.SMALL_CLASS))
    assert q.remove("S1").id == "S1"
    assert q.remove("S1") is None


CLASSIFY = {
    "brca1": ["--references", "17:41196311:41277499"],
    "past-limit": ["--references", "1:0:30000000"],
    "whole-genome": ["--all-references"],
    "file": ["--source", "file", "--input-files", "x.vcf"],
    "two-contigs": ["--references", "1:0:20000,2:0:20000"],
    "bad-references": ["--references", "bogus"],
}


@pytest.mark.parametrize("name", sorted(CLASSIFY))
def test_classify_conf_equals_the_reference(both, name):
    classes = [both[p].queue.classify_conf(both[p].config.PcaConf.parse(CLASSIFY[name]))
               for p in PKGS]
    assert classes[0] == classes[1]
    expected = "small" if name in ("brca1", "two-contigs") else "large"
    assert classes[0] == expected


# --------------------------------------------------------------- admission


def test_admission_rejects_protocol_and_flag_errors(gated):
    pkg, service, _gate = gated
    status, body = service.submit({"protocol": "nope"})
    assert status == 400 and body["error"]["code"] == "protocol-missing"
    status, body = service.submit(pkg.doc(["--no-such-flag"]))
    assert status == 400 and body["error"]["code"] == "flag-grammar"
    for extra in (["--metrics-json", "/tmp/x.json"], ["--process-id", "0"],
                  ["--output-path", "/tmp/e"], ["--profile-dir", "/tmp/e"],
                  ["--save-variants", "/tmp/e"], ["--fault-plan", "kill@serve.worker.claim"],
                  ["--gramian-checkpoint-dir", "/tmp/e"], ["--resume-from", "/tmp/e"]):
        status, body = service.submit(pkg.doc(TINY_FLAGS + extra))
        assert status == 400 and body["error"]["code"] == "reserved-flag", extra


def test_admission_mirrors_plan_rejections(gated):
    pkg, service, _gate = gated
    for flags, expected in (
        (["--num-samples", "8", "--num-pc", "99"], "num-pc-exceeds-cohort"),
        (["--block-size", "0"], "block-size"),
        (["--mesh-shape", "16,1", "--num-reduce-partitions", "16"], "mesh-exceeds-devices"),
        (["--references", "bogus"], "references-grammar"),
    ):
        status, body = service.submit(pkg.doc(flags))
        assert status == 400 and body["error"]["code"] == "plan-rejected", flags
        assert expected in [i["code"] for i in body["plan"]["issues"]]
        assert "geometry" in body["plan"]


def test_admission_memory_rejections_are_413(pkg, tmp_path):
    gate = GateExecutor(pkg)
    service = pkg.service(tmp_path / "serve", host_mem_budget=1 << 20, executor=gate).start()
    try:
        status, body = service.submit(pkg.doc(["--source", "file", "--input-files",
                                               "cohort.vcf"] + TINY_FLAGS))
        assert status == 413
        codes = [i["code"] for i in body["plan"]["issues"]]
        assert "host-mem-over-budget" in codes
        assert set(codes) & pkg.daemon.MEM_LIMIT_CODES
    finally:
        gate.release.set()
        assert service.stop(timeout=60)


def test_admission_backpressure_429(gated):
    pkg, service, gate = gated
    assert service.submit(pkg.doc(TINY_FLAGS))[0] == 202
    assert gate.started.wait(timeout=30)
    assert service.submit(pkg.doc(TINY_FLAGS))[0] == 202  # fills the small lane
    status, body = service.submit(pkg.doc(TINY_FLAGS))
    assert status == 429 and body["error"]["code"] == "queue-full"
    assert body["error"]["retry_after_seconds"] > 0


def test_small_jobs_run_ahead_of_queued_large_job(gated):
    pkg, service, gate = gated
    _, l1 = service.submit(pkg.doc(LARGE_FLAGS))
    assert gate.started.wait(timeout=30)
    _, l2 = service.submit(pkg.doc(LARGE_FLAGS))
    _, s1 = service.submit(pkg.doc(TINY_FLAGS))
    assert (l2["job"]["class"], s1["job"]["class"]) == ("large", "small")
    gate.release.set()
    wait_status(service, l2["job"]["id"], {"done"})
    assert gate.ids == [l1["job"]["id"], s1["job"]["id"], l2["job"]["id"]]


def test_cancellation_matrix(gated):
    pkg, service, gate = gated
    _, running = service.submit(pkg.doc(TINY_FLAGS))
    assert gate.started.wait(timeout=30)
    _, queued = service.submit(pkg.doc(TINY_FLAGS))
    status, body = service.cancel(queued["job"]["id"])
    assert status == 200 and body["job"]["status"] == "cancelled"
    status, body = service.cancel(running["job"]["id"])
    assert status == 409 and body["error"]["code"] == "job-running"
    status, body = service.cancel("job-999999")
    assert status == 404 and body["error"]["code"] == "unknown-job"
    gate.release.set()
    wait_status(service, running["job"]["id"], {"done"})
    status, body = service.cancel(running["job"]["id"])
    assert status == 409 and body["error"]["code"] == "job-finished"
    assert service.job_status(queued["job"]["id"])[1]["job"]["status"] == "cancelled"
    assert queued["job"]["id"] not in gate.ids


def test_deadline_exceeded_fails_without_running(gated):
    pkg, service, gate = gated
    service.deadline_feasibility = False
    _, blocker = service.submit(pkg.doc(TINY_FLAGS))
    assert gate.started.wait(timeout=30)
    _, doomed = service.submit(pkg.doc(TINY_FLAGS, deadline_seconds=0.2))
    import time

    expiry = doomed["job"]["submitted_unix"] + 0.2
    wait_for(lambda: time.time() > expiry + 0.05, 10, lambda: "clock never passed the deadline")
    gate.release.set()
    body = wait_status(service, doomed["job"]["id"], {"failed"})
    assert "deadline-exceeded" in body["error"]
    assert doomed["job"]["id"] not in gate.ids
    wait_status(service, blocker["job"]["id"], {"done"})


def test_terminal_retention_bounds_the_job_table(pkg, tmp_path):
    service = pkg.service(tmp_path / "serve", executor=lambda job, run_dir: pkg.outcome({"ok": 1}),
                          terminal_retention=2).start()
    try:
        ids = []
        for _ in range(5):
            status, doc = service.submit(pkg.doc(TINY_FLAGS))
            assert status == 202
            ids.append(doc["job"]["id"])
            wait_status(service, ids[-1], {"done"})
        assert [service.job_status(i)[0] for i in ids] == [404, 404, 404, 200, 200]
        health = service.healthz()
        assert (health["jobs"]["terminal"], health["jobs"]["tracked"]) == (5, 2)
    finally:
        assert service.stop(timeout=60)


def test_graceful_drain_503_and_worker_exit(gated):
    pkg, service, gate = gated
    _, inflight = service.submit(pkg.doc(TINY_FLAGS))
    assert gate.started.wait(timeout=30)
    service.begin_drain()
    assert service.healthz()["status"] == "draining"
    status, body = service.submit(pkg.doc(TINY_FLAGS))
    assert status == 503 and body["error"]["code"] == "draining"
    gate.release.set()
    assert service.wait_drained(timeout=60)
    assert service.job_status(inflight["job"]["id"])[1]["job"]["status"] == "done"
    assert not service.healthz()["queue"]["worker_alive"]


# ---------------------------------------------- admission against the reference

#: Request documents sent to both daemons; the port must answer each with
#: the reference's status, error code, plan-issue codes and geometry.
ADMISSION = {
    "protocol-missing": lambda p: {"protocol": "nope"},
    "bad-version": lambda p: dict(p.doc(TINY_FLAGS), protocol={"id": "spark-examples-tpu/serve",
                                                               "version": 99}),
    "reserved-kind": lambda p: p.doc(TINY_FLAGS, kind="assoc"),
    "flag-grammar": lambda p: p.doc(["--no-such-flag"]),
    "grm-flag-grammar": lambda p: p.doc(["--ld-window-sites", "4"], kind="grm"),
    "reserved-metrics-json": lambda p: p.doc(TINY_FLAGS + ["--metrics-json", "m.json"]),
    "reserved-process-id": lambda p: p.doc(TINY_FLAGS + ["--process-id", "0"]),
    "reserved-coordinator": lambda p: p.doc(TINY_FLAGS + ["--coordinator-address",
                                                          "127.0.0.1:1"]),
    "reserved-fault-plan": lambda p: p.doc(TINY_FLAGS + ["--fault-plan", "kill@driver.post-flush"]),
    "reserved-resume": lambda p: p.doc(TINY_FLAGS + ["--resume-from", "ck"]),
    "reserved-grm-out": lambda p: p.doc(TINY_FLAGS + ["--grm-out", "k.tsv"], kind="grm"),
    "num-pc-past-cohort": lambda p: p.doc(["--num-samples", "8", "--num-pc", "99"]),
    "block-size-zero": lambda p: p.doc(["--block-size", "0"]),
    "mesh-past-devices": lambda p: p.doc(["--mesh-shape", "16,1",
                                          "--num-reduce-partitions", "16"]),
    "references-grammar": lambda p: p.doc(["--references", "bogus"]),
    "dense-past-hbm": lambda p: p.doc(["--similarity-strategy", "dense",
                                       "--num-samples", "40000"]),
    "stacked-past-hbm": lambda p: p.doc(["--num-samples", "2504", "--fused-jobs", "700"]),
    "past-exactness": lambda p: p.doc(["--references", "1:0:300000000000"]),
    "grm-past-hbm": lambda p: p.doc(["--num-samples", "40000"], kind="grm"),
    "pca-small": lambda p: p.doc(TINY_FLAGS),
    "similarity-small": lambda p: p.doc(TINY_FLAGS, kind="similarity", tag="s"),
    "grm-small": lambda p: p.doc(TINY_FLAGS, kind="grm"),
    "pca-large": lambda p: p.doc(LARGE_FLAGS),
    "chr17-2504": lambda p: p.doc(["--num-samples", "2504", "--references",
                                   "17:0:81195210"]),
    "data-axis-4": lambda p: p.doc(TINY_FLAGS + ["--mesh-shape", "4,1",
                                                 "--num-reduce-partitions", "4"]),
}

#: Job-envelope keys that are the daemon's own (ids, clocks, trace ids,
#: the cost model's rates), not admission verdicts.
_VOLATILE = {"id", "trace", "submitted_unix", "started_unix", "finished_unix", "seconds",
             "cost", "status", "slice", "batch_size"}
_JAXPR_ONLY = {"ring_peak_live_bytes_per_device", "ring_bytes_per_flush_jaxpr"}


def _admit(pkg, tmp_path, doc_fn):
    gate = GateExecutor(pkg)
    service = pkg.service(tmp_path / pkg.name, executor=gate, small_slices=0).start()
    try:
        return service.submit(doc_fn(pkg))
    finally:
        gate.release.set()
        assert service.stop(timeout=60)


@pytest.mark.parametrize("name", sorted(ADMISSION))
def test_admission_equals_the_reference(both, tmp_path, name):
    (ref_status, ref), (port_status, port) = (
        _admit(both[p], tmp_path, ADMISSION[name]) for p in PKGS)
    assert ref_status == port_status, (ref, port)
    if ref_status != 202:
        assert ref["error"]["code"] == port["error"]["code"]
        assert ("plan" in ref) == ("plan" in port)
        if "plan" in ref:
            codes = lambda d: sorted((i["code"], i["severity"]) for i in d["plan"]["issues"])
            assert codes(ref) == codes(port)
            geometry = lambda d: {k: v for k, v in d["plan"]["geometry"].items()
                                  if k not in _JAXPR_ONLY}
            assert geometry(ref) == geometry(port)
        return
    strip = lambda d: {k: v for k, v in d["job"].items() if k not in _VOLATILE}
    assert strip(ref) == strip(port)
    assert ref["job"]["status"] in ("queued", "running")
    assert port["job"]["status"] in ("queued", "running")


def test_admission_status_matrix_covers_every_code(both, tmp_path):
    """The matrix reaches each status the daemon answers an admission with."""
    statuses = {name: _admit(both["port"], tmp_path / name, fn)[0]
                for name, fn in ADMISSION.items()
                if name in ("flag-grammar", "dense-past-hbm", "pca-small")}
    assert statuses == {"flag-grammar": 400, "dense-past-hbm": 413, "pca-small": 202}


@pytest.mark.parametrize("value", ["cpu", "cuda"])
def test_port_refuses_a_jobs_device(both, tmp_path, value):
    """A served job never picks its own device: the port refuses --device
    with the reserved-flag 400; the reference has no such flag."""
    status, body = _admit(both["port"], tmp_path, lambda p: p.doc(TINY_FLAGS + ["--device", value]))
    assert status == 400 and body["error"]["code"] == "reserved-flag"
    assert "--device" in body["error"]["message"]
    status, body = _admit(both["ref"], tmp_path / "ref",
                          lambda p: p.doc(TINY_FLAGS + ["--device", value]))
    assert status == 400 and body["error"]["code"] == "flag-grammar"


def test_admission_over_card_memory_is_413(both, tmp_path, monkeypatch):
    """Admission validates against the slice's device memory
    (``per_device_memory_bytes``): a Gramian past 80 GB is a 413
    ``dense-exceeds-hbm`` on a card's budget, as on the reference's."""
    from spark_examples_tpu_torch.ops import gramian

    port = both["port"]
    service = port.service(tmp_path, executor=GateExecutor(port, block_classes=())).start()
    try:
        monkeypatch.setattr(gramian, "per_device_memory_bytes", lambda device: 80 << 30)
        assert service.admission_device_bytes("large") == 80 << 30
        status, body = service.submit(port.doc(["--similarity-strategy", "dense",
                                                "--num-samples", "80000"]))
        assert status == 413
        assert "dense-exceeds-hbm" in [i["code"] for i in body["plan"]["issues"]]
        assert service.submit(port.doc(["--similarity-strategy", "dense",
                                        "--num-samples", "40000"]))[0] == 202
    finally:
        assert service.stop(timeout=60)


# ------------------------------------------------------------------- HTTP


@pytest.fixture
def http_gated(pkg, tmp_path):
    gate = GateExecutor(pkg, block_classes=())
    service = pkg.service(tmp_path / "serve", executor=gate).start()
    server = pkg.http.start_server(service)
    yield pkg, service, pkg.client.ServeClient(server.url)
    server.shutdown()
    server.server_close()
    assert service.stop(timeout=60)


def test_http_routes_and_health(http_gated):
    pkg, _service, client = http_gated
    health = client.healthz()
    assert health["status"] == "ok" and health["mesh"]["devices"] == 8
    assert health["queue"]["worker_alive"]
    with pytest.raises(pkg.client.ServeError) as e:
        client.status("job-404404")
    assert e.value.status == 404
    with pytest.raises(pkg.client.ServeError) as e:
        client._json("GET", "/v1/nothing")
    assert e.value.status == 404
    req = urllib.request.Request(client.url + "/v1/jobs", data=b"not json", method="POST",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=10)
    assert err.value.code == 400
    assert json.loads(err.value.read().decode())["error"]["code"] == "bad-json"
    done = client.wait(client.submit(TINY_FLAGS, tag="x")["job"]["id"], timeout=60)["job"]
    assert done["status"] == "done" and done["tag"] == "x" and done["result"] == {"stub": True}
    stats = client._json("GET", "/v1/fleet/stats")
    assert stats["jobs"]["terminal"] == 1 and stats["dispatch"]["serial_jobs"] == 1


def test_keep_alive_connection_survives_ignored_bodies(http_gated):
    import http.client
    from urllib.parse import urlparse

    _pkg, _service, client = http_gated
    parsed = urlparse(client.url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port, timeout=10)
    try:
        conn.request("POST", "/v1/jobs/job-nope/cancel", body=b'{"ignored": "body"}',
                     headers={"Content-Type": "application/json"})
        first = conn.getresponse()
        first.read()
        assert first.status == 404
        conn.request("GET", "/healthz")
        second = conn.getresponse()
        assert second.status == 200 and b'"status"' in second.read()
    finally:
        conn.close()


def test_http_plan_rejection_body(http_gated):
    pkg, _service, client = http_gated
    with pytest.raises(pkg.client.ServeError) as e:
        client.submit(["--num-samples", "8", "--num-pc", "99"])
    assert e.value.status == 400 and e.value.code == "plan-rejected"
    assert "num-pc-exceeds-cohort" in [i["code"] for i in e.value.body["plan"]["issues"]]


def test_submit_cli_verb(http_gated, capsys):
    pkg, _service, client = http_gated
    rc = pkg.client.submit_main(["--url", client.url, "--no-wait", "--"] + TINY_FLAGS)
    assert rc == 0
    job_id = capsys.readouterr().out.strip()
    assert job_id.startswith("job-")
    client.wait(job_id, timeout=60)
    rc = pkg.client.submit_main(["--url", client.url, "--", "--num-samples", "8",
                                 "--num-pc", "99"])
    assert rc == 2
    body = json.loads(capsys.readouterr().out)
    assert body["http_status"] == 400 and body["error"]["code"] == "plan-rejected"


def _families(text):
    return sorted(line for line in text.splitlines() if line.startswith(("# TYPE", "# HELP")))


def test_metric_families_equal_the_reference(both, tmp_path):
    """A started service's ``/metrics`` families (names, kinds, help) are
    the reference's."""
    texts = []
    for name in PKGS:
        p = both[name]
        service = p.service(tmp_path / name, executor=GateExecutor(p, block_classes=())).start()
        try:
            texts.append(service.metrics_text())
        finally:
            assert service.stop(timeout=60)
    ref, port = (_families(t) for t in texts)
    assert ref == port
    for family in ("serve_queue_depth", "serve_jobs_inflight", "serve_fused_groups_total",
                   "serve_job_wall_seconds", "cost_calibration_samples",
                   "compile_cache_geometry_hits", "serve_replicas_alive"):
        assert f"# TYPE {family} " in texts[1], family


# --------------------------------------------------------------- heartbeat

#: Registry states both packages' heartbeats sample: the serve segments,
#: the ring's traffic and the warm-geometry pair (the satellite segments).
HEARTBEAT_STATES = {
    "ring": {"counter:gramian_ring_bytes": 3 << 20, "gauge:ingest_sites_scanned": 1000},
    "compile-cache": {"gauge:compile_cache_geometry_hits": 3,
                      "gauge:compile_cache_geometry_misses": 2},
    "serve": {"gauge:serve_queue_depth": 2, "gauge:serve_jobs_inflight": 1,
              "gauge:serve_jobs_done": 7, "gauge:serve_slices": 2,
              "gauge:serve_slices_busy": 1, "counter:serve_batches_total": 2,
              "counter:serve_batch_jobs_total": 6, "counter:serve_fused_groups_total": 1,
              "counter:serve_fused_jobs_total": 4},
    "replicas": {"gauge:serve_replicas_alive": 2, "counter:serve_jobs_stolen_total": 1,
                 "counter:serve_lease_renewals_total": 9, "gauge:serve_queue_depth": 0},
    "cost": {"gauge:cost_calibration_samples": 17, "gauge:cost_predicted_mean_seconds": 3.2,
             "gauge:cost_measured_mean_seconds": 2.9, "gauge:compile_cache_geometry_hits": 1,
             "gauge:compile_cache_geometry_misses": 0},
    "cost-zero-predicted": {"gauge:cost_calibration_samples": 1,
                            "gauge:cost_predicted_mean_seconds": 0.0,
                            "gauge:cost_measured_mean_seconds": 1.0},
    "cost-nan": {"gauge:cost_calibration_samples": float("nan"),
                 "counter:gramian_ring_bytes": 0},
}


def _heartbeat_line(p, state):
    registry = p.metrics.MetricsRegistry()
    for key, value in state.items():
        kind, name = key.split(":")
        if kind == "counter":
            registry.counter(name, "h").inc(value)
        else:
            registry.gauge(name, "h").set(value)
    hb = p.heartbeat.Heartbeat(10.0, registry, emit=lambda _: None, clock=lambda: 12.0)
    hb._started_at = 0.0
    return hb.line()


@pytest.mark.parametrize("name", sorted(HEARTBEAT_STATES))
def test_heartbeat_segments_equal_the_reference(both, name):
    ref, port = (_heartbeat_line(both[p], HEARTBEAT_STATES[name]) for p in PKGS)
    assert ref == port
    expected = {
        "ring": "ring traffic 3.0 MiB",
        "compile-cache": "compile cache 3 warm/2 cold",
        "serve": "fused 1 K-job group(s) (K≈4.0)",
        "replicas": "replicas 2 alive (stolen 1, lease renewals 9)",
        "cost": "cost pred 3.2s / meas 2.9s (ratio 0.91, n=17)",
        "cost-zero-predicted": "cost pred 0.0s / meas 1.0s (n=1)",
        "cost-nan": "no progress metrics registered yet",
    }[name]
    assert expected in port


def test_service_heartbeat_shows_serve_segments(gated):
    pkg, service, gate = gated
    service.submit(pkg.doc(TINY_FLAGS))
    assert gate.started.wait(timeout=30)
    line = pkg.heartbeat.Heartbeat(60.0, service.registry).line()
    for segment in ("serve queue 0 (in-flight 1, done 0)", "slices 1/1 busy", "compile cache"):
        assert segment in line, line


# ---------------------------------------------------- end to end over HTTP

E2E_FLAGS = ["--num-samples", "16", "--references", "17:41196311:41206311"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One pca, similarity and grm job through each package's real daemon
    over HTTP, one package after the other (each routes its worker's
    stdout into the job's log), each job on a slice of one device.
    Returns {pkg: {kind: job doc}}."""
    out = {}
    for name in PKGS:
        p = pkg_of(name)
        p.cache.reset_compile_cache_stats()
        run_dir = tmp_path_factory.mktemp(f"served-{name}")
        # Both on one device: the small slice of a two-slice topology (the
        # reference's other seven test devices form its large slice).
        extra = {"devices": [torch.device("cpu")] * 2} if name == "port" else {}
        service = p.real_service(run_dir, small_slices=1, **extra).start()
        server = p.http.start_server(service)
        try:
            client = p.client.ServeClient(server.url)
            out[name] = {}
            for kind in ("pca", "similarity", "grm"):
                job_id = client.submit(E2E_FLAGS, kind=kind)["job"]["id"]
                out[name][kind] = client.wait(job_id, timeout=240)["job"]
            out[name]["metrics"] = client.metrics()
        finally:
            server.shutdown()
            server.server_close()
            assert service.stop(timeout=120)
            p.cache.reset_compile_cache_stats()
    return out


def test_served_jobs_complete_in_both_packages(served):
    for name in PKGS:
        for kind in ("pca", "similarity", "grm"):
            job = served[name][kind]
            assert job["status"] == "done", (name, kind, job["error"])
            assert job["compile_cache"] == "cold" and job["slice"] == "small-0"


@pytest.mark.parametrize("kind", ["similarity", "grm"])
def test_served_summaries_equal_the_reference(served, kind):
    assert served["port"][kind]["result"] == served["ref"][kind]["result"]


def test_served_pc_rows_agree_with_the_reference(served):
    ref, port = (served[p]["pca"]["result"]["pc_lines"] for p in PKGS)
    assert [l.split("\t")[:2] for l in ref] == [l.split("\t")[:2] for l in port]
    A = np.array([[float(x) for x in l.split("\t")[2:]] for l in ref])
    B = np.array([[float(x) for x in l.split("\t")[2:]] for l in port])
    signs = np.sign((A * B).sum(axis=0))
    signs[signs == 0] = 1
    np.testing.assert_allclose(B * signs, A, atol=1e-4, rtol=0)


def test_served_rows_equal_the_batch_cli(served):
    """The port's served rows are its batch CLI's, byte for byte, and the
    job's stdout log holds them."""
    from spark_examples_tpu_torch.pipeline import pca_driver

    with contextlib.redirect_stdout(io.StringIO()):
        lines = pca_driver.run(E2E_FLAGS + ["--device", "cpu"])
    job = served["port"]["pca"]
    assert job["result"]["pc_lines"] == lines
    with open(os.path.join(os.path.dirname(job["manifest_path"]), "stdout.log")) as f:
        log = f.read()
    assert all(line in log for line in lines)


@pytest.mark.parametrize("kind", ["pca", "similarity", "grm"])
def test_served_manifest_validates(served, kind):
    from spark_examples_tpu_torch.obs.manifest import read_manifest, validate_manifest

    job = served["port"][kind]
    assert job["manifest_path"].endswith(os.path.join("jobs", job["id"], "manifest.json"))
    doc = read_manifest(job["manifest_path"])
    assert validate_manifest(doc) == []
    assert doc["cost"]["measured_seconds"] == job["seconds"]
    assert doc["config"]["device"] == "cpu"


def test_served_metrics_count_the_jobs(served):
    text = served["port"]["metrics"]
    assert 'serve_jobs_completed_total{status="done"} 3' in text
    assert "serve_serial_jobs_total 3" in text and "serve_jobs_done 3" in text


# ------------------------------------------------------------------- CLI


def test_cli_runs_serve_and_submit_and_refuses_obs():
    """``serve`` and ``submit`` are the service's verbs; ``obs``, ported
    since, is device-free, and refuses only a missing subcommand (exit 2,
    as the reference's ``report_main([])``)."""
    from spark_examples_tpu_torch import cli

    assert cli.NOT_PORTED == ()
    assert set(cli.SERVICE) == {"serve", "submit"}
    assert "obs" in cli.DEVICE_FREE and "obs" not in cli.SERVICE
    assert cli.main(["obs"]) == 2


def test_serve_without_a_card_exits_nonzero(tmp_path, monkeypatch, capsys):
    """``serve`` at the default device with no card exits 1 before it
    binds or touches the run directory."""
    from spark_examples_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run_dir = tmp_path / "rd"
    assert cli.main(["serve", "--port", "0", "--run-dir", str(run_dir)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not run_dir.exists()


def test_service_on_cuda_without_a_card_raises(both, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    service = both["port"].daemon.PcaService(run_dir=str(tmp_path / "rd"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.start()
    assert service.stop(timeout=5)


def test_serve_help_names_the_device_flag(capsys):
    from spark_examples_tpu_torch.serve.http import serve_main

    with pytest.raises(SystemExit) as e:
        serve_main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device {cuda,cpu}" in out and "--endpoint-file" in out
