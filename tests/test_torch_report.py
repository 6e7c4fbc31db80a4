"""The fleet report (``obs report``) of both packages over the port's run
directories.

The port's serve daemons run a few tiny jobs; then both packages' reports
read what they left on disk (the journal, the calibration ledger and the
recorder segments, whose formats the port keeps record for record) and
must print the same bytes, text and ``--json``. Three fleets:

- ``solo``: one ``PcaService(device="cpu")`` with the real executor: a
  ``pca``, a ``similarity`` and a ``grm`` job;
- ``replicas``: two in-process replicas on one run directory with stub
  executors; ``a`` stops renewing its leases with a job queued behind a
  blocked one, ``b`` steals both (it runs the queued job and fails the
  begun one), and ``a``'s worker abandons the stolen job unrun;
- ``chaos``: two ``serve --device cpu`` processes; ``a`` is SIGKILLed at
  ``serve.worker.claim`` with the job in hand and ``b`` steals and runs
  it, as in ``tests/test_torch_serve_replicas_chaos.py``.

Each job is submitted under a trace id of the test's, and the port's
report must show every journaled job under the id its submit carried.
The usage exit codes are the reference's: 2 for no verb, a wrong verb or
a missing directory, 1 for a directory with nothing to report.
"""

import contextlib
import io
import json
import os
import signal

import pytest
from torch_serve_helpers import (
    TINY_FLAGS,
    TINY_FLAGS_B,
    GateExecutor,
    pkg_of,
    spawn_daemon,
    stop_daemon,
    wait_for,
    wait_status,
)

from spark_examples_tpu.obs.report import report_main as ref_report_main
from spark_examples_tpu_torch import cli
from spark_examples_tpu_torch.obs.report import report_main as port_report_main
from spark_examples_tpu_torch.obs.trace import mint_trace_id
from spark_examples_tpu_torch.serve.client import ServeClient, ServeError
from spark_examples_tpu_torch.serve.journal import journal_path

FLEETS = ("solo", "replicas", "chaos")
#: Short leases, so a replica that stops renewing is stolen from within
#: seconds (``tests/test_torch_serve_replicas.py``'s in-process replica).
REPLICA_LEASE = dict(lease_seconds=1.5, lease_grace_seconds=0.25, steal_interval_seconds=0.25)
CHAOS_COMMON = ["--executor-slices", "0", "--no-persistent-cache"]
CHAOS_VICTIM = ["--lease-seconds", "0.3", "--lease-grace-seconds", "0.2",
                "--steal-interval-seconds", "0.2"]
CHAOS_SURVIVOR = ["--lease-seconds", "3.0", "--lease-grace-seconds", "0.2",
                  "--steal-interval-seconds", "0.2"]


def _submit(service, traces, flags, **kw):
    trace = mint_trace_id()
    status, doc = service.submit(pkg_of("port").doc(flags, **kw), trace_id=trace)
    assert status == 202, doc
    traces[doc["job"]["id"]] = trace
    return doc["job"]["id"]


def _solo(run_dir):
    port = pkg_of("port")
    port.cache.reset_compile_cache_stats()
    traces = {}
    service = port.real_service(run_dir, small_slices=0).start()
    try:
        ids = [_submit(service, traces, TINY_FLAGS, kind=kind)
               for kind in ("pca", "similarity", "grm")]
        for job_id in ids:
            assert wait_status(service, job_id, {"done", "failed"}, timeout=120)["status"] == "done"
    finally:
        assert service.stop(timeout=120)
        port.cache.reset_compile_cache_stats()
    return traces


def _replicas(run_dir):
    port = pkg_of("port")
    traces = {}
    gate = GateExecutor(port, block_classes=("small",))
    a = port.service(run_dir, executor=gate, small_slices=0, replica_id="a",
                     **REPLICA_LEASE).start()
    b = None
    try:
        blocker = _submit(a, traces, TINY_FLAGS)
        assert gate.started.wait(timeout=30)
        queued = _submit(a, traces, TINY_FLAGS_B)
        a._lease_stop.set()  # a's renewals and heartbeat stop
        b = port.service(run_dir, executor=GateExecutor(port, block_classes=()), small_slices=0,
                         replica_id="b", **REPLICA_LEASE).start()
        assert wait_status(b, queued, {"done"})["status"] == "done"
        assert wait_status(b, blocker, {"failed"})["error"].startswith("replica-failover:")
        gate.release.set()
        assert wait_status(a, queued, {"failed"})["error"].startswith("lease-lost:")
    finally:
        gate.release.set()
        if b is not None:
            assert b.stop(timeout=60)
        assert a.stop(timeout=60)
    return traces


def _chaos(run_dir):
    traces = {}
    a_proc, a_url = spawn_daemon(
        run_dir, "a", CHAOS_COMMON + ["--replica-id", "a"] + CHAOS_VICTIM,
        env_extra={"SPARK_EXAMPLES_TPU_FAULTS": "kill@serve.worker.claim"})
    b_proc = None
    try:
        b_proc, b_url = spawn_daemon(run_dir, "b",
                                     CHAOS_COMMON + ["--replica-id", "b"] + CHAOS_SURVIVOR)
        trace = mint_trace_id()
        try:
            job_id = ServeClient(a_url, timeout=30).submit(TINY_FLAGS, trace_id=trace)["job"]["id"]
        except (ServeError, OSError):
            # The kill point may fire before the 202 is written; the
            # accepted record, journaled first, names the job.
            with open(journal_path(run_dir), encoding="utf-8") as f:
                (line,) = [line for line in f if '"accepted"' in line]
            job_id = json.loads(line)["id"]
        traces[job_id] = trace
        assert a_proc.wait(timeout=60) == -signal.SIGKILL
        client = ServeClient(b_url, timeout=30, max_retries=5)

        def settled():
            try:
                job = client.status(job_id)["job"]
            except ServeError as e:
                if e.status != 404:  # 404 until the survivor has stolen it
                    raise
                return None
            return job if job["status"] in ("done", "failed") else None

        job = wait_for(settled, 60, lambda: f"job {job_id} never settled", interval=0.1)
        assert job["status"] == "done", job
        assert stop_daemon(b_proc) == 0
    finally:
        for proc in (b_proc, a_proc):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    return traces


@pytest.fixture(scope="module", params=FLEETS)
def fleet(request, tmp_path_factory):
    """(run directory, {job id: the trace id its submit carried})."""
    run_dir = str(tmp_path_factory.mktemp(f"fleet-{request.param}"))
    build = {"solo": _solo, "replicas": _replicas, "chaos": _chaos}[request.param]
    return request.param, run_dir, build(run_dir)


def _report(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_report_text_is_the_reference_s(fleet):
    _, run_dir, _ = fleet
    argv = ["report", "--run-dir", run_dir]
    ref, port = _report(ref_report_main, argv), _report(port_report_main, argv)
    assert port == ref
    assert port[0] == 0 and port[1].startswith(f"fleet report: {os.path.abspath(run_dir)}\n")


def test_report_json_is_the_reference_s(fleet):
    _, run_dir, _ = fleet
    argv = ["report", "--run-dir", run_dir, "--json"]
    ref, port = _report(ref_report_main, argv), _report(port_report_main, argv)
    assert port == ref and port[0] == 0


def test_report_names_each_job_by_its_submit_s_trace(fleet):
    name, run_dir, traces = fleet
    rc, out = _report(port_report_main, ["report", "--run-dir", run_dir, "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["totals"]["journaled"] == len(traces)
    assert {job_id: job["trace"] for job_id, job in doc["jobs"].items()} == traces
    assert doc["recorder"] is not None and doc["recorder"]["events"] > 0
    protocol = doc["protocol"]["totals"]
    done = sum(1 for job in doc["jobs"].values() if job["status"] == "done")
    if name == "solo":
        assert doc["totals"]["statuses"] == {"done": 3} and doc["totals"]["stolen"] == 0
        assert doc["calibration"]["samples"] == done == 3
        assert set(doc["classes"]) == {"small"}
    if name == "replicas":
        assert doc["totals"]["statuses"] == {"done": 1, "failed": 1}
        assert doc["totals"]["stolen"] == 2 and protocol["steals"] >= 2
        assert sorted(doc["recorder"]["replicas"]) == ["a", "b"]
    if name == "chaos":
        assert doc["totals"]["statuses"] == {"done": 1} and doc["totals"]["stolen"] == 1
        assert protocol["steals"] >= 1
        (job,) = doc["jobs"].values()
        assert job["replicas"][:1] == ["a"] and "b" in job["replicas"]


def test_obs_verb_prints_the_report(fleet):
    _, run_dir, _ = fleet
    for extra in ([], ["--json"]):
        argv = ["report", "--run-dir", run_dir, *extra]
        assert _report(cli.main, ["obs", *argv]) == _report(port_report_main, argv)


@pytest.mark.parametrize("main", [ref_report_main, port_report_main], ids=["ref", "port"])
def test_report_cli_exit_codes(main, tmp_path, capsys):
    assert main([]) == 2  # usage
    assert main(["export"]) == 2  # wrong verb
    assert main(["report", "--run-dir", str(tmp_path / "nope")]) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main(["report", "--run-dir", str(empty)]) == 1  # nothing to report
    err = capsys.readouterr().err
    assert "usage:" in err and "nothing to report" in err

