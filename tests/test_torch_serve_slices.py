"""Executor slices, continuous batching, fused groups and restarts of the
serve daemon, in both packages.

The reference's ``tests/test_serve_slices.py`` runs here once per package
(``pkg``): ``plan_executor_slices`` and ``resolve_small_slices`` (their
tuples equal the reference's over a grid), the queue's class filter,
batching and linger, the sliced service (a small job beside a running
large one, per-slice admission, a crashing worker replaced), concurrent
submitters, journal replay across a daemon's death, and ``serve_main``'s
flag checks. The port's own: two slices on positions of one device, the
served jobs' placement, four same-geometry small jobs fused into one
stacked group whose lanes equal their serial runs, and a restart on the
same run directory that replays the journal, primes the geometry ledger
(a torn line skipped) and serves the repeat job warm.
"""

import contextlib
import io
import os
import threading
from dataclasses import asdict

import pytest
import torch
from torch_serve_helpers import (
    LARGE_FLAGS,
    PKGS,
    TINY_FLAGS,
    TINY_FLAGS_B,
    GateExecutor,
    pkg_of,
    wait_for,
    wait_status,
)

@pytest.fixture(params=PKGS)
def pkg(request):
    return pkg_of(request.param)


@pytest.fixture(autouse=True)
def _clean_process_state():
    """No fault plan and no attached geometry ledger leak between tests."""
    for name in PKGS:
        pkg_of(name).faults.configure(None)
    yield
    for name in PKGS:
        pkg_of(name).faults.configure(None)
        pkg_of(name).cache.reset_compile_cache_stats()


WHOLE_GENOME = ["--num-samples", "8", "--all-references"]


# -------------------------------------------------------- slice arithmetic


def test_plan_executor_slices_shared_topology(pkg):
    (only,) = pkg.mesh.plan_executor_slices(8)
    assert (only.name, only.job_classes, only.device_start, only.device_count) == (
        "shared", ("small", "large"), 0, 8)


def test_plan_executor_slices_partitions_disjoint_and_covering(pkg):
    slices = pkg.mesh.plan_executor_slices(8, small_slices=2, small_slice_devices=2)
    assert [s.name for s in slices] == ["large", "small-0", "small-1"]
    indices = [i for s in slices for i in s.device_indices()]
    assert sorted(indices) == list(range(8)) and len(set(indices)) == 8


def test_plan_executor_slices_rejects_starved_large_slice(pkg):
    with pytest.raises(ValueError, match="leaving none for the large"):
        pkg.mesh.plan_executor_slices(2, small_slices=2)


def test_resolve_small_slices_auto_rule(pkg):
    resolve = pkg.mesh.resolve_small_slices
    assert (resolve("auto", 1), resolve(None, 1), resolve("auto", 2), resolve("3", 8)) == (
        0, 0, 1, 3)
    with pytest.raises(ValueError):
        resolve(-1, 8)


def test_executor_slice_validation(pkg):
    with pytest.raises(ValueError, match="needs >= 1 device"):
        pkg.mesh.ExecutorSlice("x", ("small",), 0, 0)
    with pytest.raises(ValueError, match="serves no job class"):
        pkg.mesh.ExecutorSlice("x", (), 0, 1)


@pytest.mark.parametrize("devices", range(1, 9))
def test_slice_plans_equal_the_reference(devices):
    ref, port = pkg_of("ref").mesh, pkg_of("port").mesh
    for small in range(0, 4):
        for per_small in range(1, 4):
            outcomes = []
            for mesh in (ref, port):
                try:
                    outcomes.append([asdict(s) for s in mesh.plan_executor_slices(
                        devices, small, per_small)])
                except ValueError as e:
                    outcomes.append(str(e))
            assert outcomes[0] == outcomes[1], (devices, small, per_small)
        assert ref.resolve_small_slices("auto", devices) == port.resolve_small_slices(
            "auto", devices)


def test_classify_conf_honors_small_site_limit(pkg):
    conf = pkg.config.PcaConf.parse(["--references", "1:0:50000"])  # 501 sites
    assert pkg.queue.classify_conf(conf, small_site_limit=501) == "small"
    assert pkg.queue.classify_conf(conf, small_site_limit=500) == "large"


# ----------------------------------------------------------------- queue


def _job(pkg, job_id, job_class="small", batch_key=None):
    return pkg.queue.Job(id=job_id, request=pkg.protocol.parse_request(pkg.doc(TINY_FLAGS)),
                         conf=None, job_class=job_class, submitted_unix=0.0,
                         batch_key=batch_key)


def test_pop_classes_filter_and_drained_for(pkg):
    q = pkg.queue.BoundedJobQueue()
    q.put(_job(pkg, "L1", "large"))
    q.put(_job(pkg, "S1", "small"))
    assert q.pop(timeout=0.05, classes=("large",)).id == "L1"
    assert q.pop(timeout=0.05, classes=("large",)) is None
    q.close()
    assert q.drained_for(("large",)) and not q.drained_for(("small",))
    assert q.pop(timeout=0.05, classes=("small",)).id == "S1"
    assert q.drained_for(("small",))


def test_pop_unknown_class_rejected(pkg):
    with pytest.raises(ValueError):
        pkg.queue.BoundedJobQueue().pop(timeout=0.01, classes=("medium",))


def test_pop_batch_coalesces_same_key_small_jobs(pkg):
    q = pkg.queue.BoundedJobQueue()
    for job_id, key in (("A1", "a"), ("B1", "b"), ("A2", "a"), ("A3", "a")):
        q.put(_job(pkg, job_id, batch_key=key))
    assert [j.id for j in q.pop_batch(timeout=1, max_batch=8)] == ["A1", "A2", "A3"]
    assert [j.id for j in q.pop_batch(timeout=1, max_batch=8)] == ["B1"]


def test_pop_batch_respects_max_batch(pkg):
    q = pkg.queue.BoundedJobQueue()
    for i in range(5):
        q.put(_job(pkg, f"A{i}", batch_key="a"))
    assert len(q.pop_batch(timeout=1, max_batch=2)) == 2
    assert len(q.pop_batch(timeout=1, max_batch=8)) == 3


def test_pop_batch_large_and_keyless_jobs_never_coalesce(pkg):
    q = pkg.queue.BoundedJobQueue()
    q.put(_job(pkg, "L1", "large", batch_key="a"))
    q.put(_job(pkg, "L2", "large", batch_key="a"))
    q.put(_job(pkg, "S1", "small", batch_key=None))
    q.put(_job(pkg, "S2", "small", batch_key=None))
    groups = [[j.id for j in q.pop_batch(timeout=1, max_batch=8)] for _ in range(4)]
    assert groups == [["S1"], ["S2"], ["L1"], ["L2"]]


def test_pop_batch_linger_collects_a_late_arrival(pkg):
    """A lingering pop returns as soon as its group fills, whenever the
    second job lands inside the window."""
    q = pkg.queue.BoundedJobQueue()
    q.put(_job(pkg, "A1", batch_key="a"))
    got = []
    popper = threading.Thread(target=lambda: got.append(
        q.pop_batch(timeout=1, max_batch=2, linger_seconds=30.0)))
    popper.start()
    q.put(_job(pkg, "A2", batch_key="a"))
    popper.join(timeout=30)
    assert not popper.is_alive()
    assert [j.id for j in got[0]] == ["A1", "A2"]


def test_pop_batch_no_linger_dispatches_immediately(pkg):
    q = pkg.queue.BoundedJobQueue()
    q.put(_job(pkg, "A1", batch_key="a"))
    assert [j.id for j in q.pop_batch(timeout=1, max_batch=8, linger_seconds=0.0)] == ["A1"]


def test_batch_fingerprint_region_invariant_but_geometry_sensitive(pkg):
    fp = lambda flags: pkg.cache.batch_compile_fingerprint(pkg.config.PcaConf.parse(flags))
    assert fp(TINY_FLAGS) == fp(TINY_FLAGS_B)
    assert fp(TINY_FLAGS) != fp(["--num-samples", "16", "--references", "1:0:50000"])
    assert fp(TINY_FLAGS) != fp(TINY_FLAGS + ["--block-size", "64"])


def test_batch_fingerprints_equal_the_reference():
    for flags in (TINY_FLAGS, TINY_FLAGS_B, LARGE_FLAGS, WHOLE_GENOME):
        keys = {pkg_of(p).cache.batch_compile_fingerprint(pkg_of(p).config.PcaConf.parse(flags),
                                                        kind=kind)
                for p in PKGS for kind in ("similarity",)}
        assert len(keys) == 1, flags


def test_queue_put_capacity_exempt_for_readmissions(pkg):
    q = pkg.queue.BoundedJobQueue(small_capacity=1, large_capacity=1)
    q.put(_job(pkg, "S1"))
    with pytest.raises(pkg.queue.QueueFull):
        q.put(_job(pkg, "S2"))
    q.put(_job(pkg, "S2"), enforce_capacity=False)
    assert q.depth()["small"] == 2


def test_rejected_admission_leaves_journal_tombstone(pkg, tmp_path):
    gate = GateExecutor(pkg)
    service = pkg.service(tmp_path / "serve", small_capacity=1, executor=gate).start()
    try:
        assert service.submit(pkg.doc(TINY_FLAGS))[0] == 202
        assert gate.started.wait(timeout=30)
        assert service.submit(pkg.doc(TINY_FLAGS))[0] == 202
        assert service.submit(pkg.doc(TINY_FLAGS))[0] == 429
        pending, _ = pkg.journal.replay_journal(pkg.journal.journal_path(service.run_dir))
        assert len(pending) == 2
    finally:
        gate.release.set()
        assert service.stop(timeout=60)


# ------------------------------------------------------- the sliced daemon


@pytest.fixture
def sliced(pkg, tmp_path):
    gate = GateExecutor(pkg, block_classes=("large",))
    service = pkg.service(tmp_path / "serve", executor=gate, small_slices=1).start()
    yield pkg, service, gate
    gate.release.set()
    assert service.stop(timeout=60)


def test_sliced_service_topology_and_admission_devices(sliced):
    _pkg_, service, _gate = sliced
    health = service.healthz()
    assert [s["name"] for s in health["slices"]] == ["large", "small-0"]
    assert (service.admission_devices("small"), service.admission_devices("large")) == (1, 7)
    assert health["queue"]["worker_alive"]


def test_small_job_completes_while_large_job_runs(sliced):
    pkg, service, gate = sliced
    status, large = service.submit(pkg.doc(LARGE_FLAGS))
    assert status == 202
    assert gate.started.wait(timeout=30)
    status, small = service.submit(pkg.doc(TINY_FLAGS))
    assert status == 202
    assert wait_status(service, small["job"]["id"], {"done"})["slice"] == "small-0"
    running = service.job_status(large["job"]["id"])[1]["job"]
    assert (running["status"], running["slice"]) == ("running", "large")
    gate.release.set()
    wait_status(service, large["job"]["id"], {"done"})


def test_small_admission_validates_against_small_slice_devices(tmp_path):
    port = pkg_of("port")
    service = port.service(tmp_path / "serve", small_slices=1,
                           executor=GateExecutor(port, block_classes=())).start()
    try:
        mesh = ["--num-samples", "8", "--mesh-shape", "1,2"]
        status, body = service.submit(port.doc(mesh + ["--references", "1:0:50000"]))
        assert status == 400
        assert "mesh-exceeds-devices" in [i["code"] for i in body["plan"]["issues"]]
        assert body["plan"]["geometry"]["plan_devices"] == 1
        status, body = service.submit(port.doc(mesh + ["--references", "1:0:30000000"]))
        assert status == 202, body
        assert body["job"]["plan_geometry"]["plan_devices"] == 7
        wait_status(service, body["job"]["id"], {"done"})
    finally:
        assert service.stop(timeout=60)


def test_crashing_large_job_never_kills_small_slice(sliced):
    pkg, service, gate = sliced
    crashed_once = threading.Event()

    def crashing(job, run_dir):
        if job.job_class == "large" and not crashed_once.is_set():
            crashed_once.set()
            raise pkg.faults.InjectedWorkerCrash("large job crashed")
        return gate(job, run_dir)

    service._executor = crashing
    _, large = service.submit(pkg.doc(LARGE_FLAGS))
    assert wait_status(service, large["job"]["id"], {"failed"})["error"].startswith(
        "worker-crashed:")
    _, small = service.submit(pkg.doc(TINY_FLAGS))
    wait_status(service, small["job"]["id"], {"done"})
    health = service.healthz()
    assert health["queue"]["worker_restarts"] == 1
    assert all(s["worker_alive"] for s in health["slices"])
    gate.release.set()
    _, large2 = service.submit(pkg.doc(LARGE_FLAGS))
    wait_status(service, large2["job"]["id"], {"done"})


def test_concurrent_submitters_lose_and_duplicate_nothing(pkg, tmp_path):
    executed = []
    lock = threading.Lock()  # lock order: test-local leaf

    def executor(job, run_dir):
        with lock:
            executed.append(job.id)
        return pkg.outcome({"ok": True})

    service = pkg.service(tmp_path / "serve", executor=executor, small_slices=1,
                          small_capacity=64, large_capacity=64, terminal_retention=512).start()
    try:
        accepted = []
        kinds = [(TINY_FLAGS, "pca"), (TINY_FLAGS_B, "pca"), (TINY_FLAGS, "similarity"),
                 (LARGE_FLAGS, "pca")]
        errors = []

        def submitter(seed):
            for i in range(6):
                flags, kind = kinds[(seed + i) % len(kinds)]
                status, doc = service.submit(pkg.doc(flags, kind=kind))
                with lock:
                    (accepted.append(doc["job"]["id"]) if status == 202
                     else errors.append(doc))

        threads = [threading.Thread(target=submitter, args=(s,)) for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and len(accepted) == len(set(accepted)) == 24
        for job_id in accepted:
            wait_status(service, job_id, {"done"}, timeout=60)
        assert sorted(executed) == sorted(accepted)
    finally:
        assert service.stop(timeout=60)


def test_daemon_restart_replays_queued_job_and_fails_began_job(pkg, tmp_path):
    run_dir = tmp_path / "serve"
    gate = GateExecutor(pkg, block_classes=("large",))
    first = pkg.service(run_dir, executor=gate, small_slices=0).start()
    second = None
    try:
        _, done_doc = first.submit(pkg.doc(TINY_FLAGS))
        wait_status(first, done_doc["job"]["id"], {"done"})
        _, running = first.submit(pkg.doc(LARGE_FLAGS))
        wait_status(first, running["job"]["id"], {"running"})
        _, queued = first.submit(pkg.doc(LARGE_FLAGS))
        # The first daemon "dies": abandoned without a drain.
        second = pkg.service(run_dir, executor=GateExecutor(pkg, block_classes=()),
                             small_slices=0).start()
        assert second.healthz()["warm_state"]["journal_replayed"] == 2
        crashed = wait_status(second, running["job"]["id"], {"failed"})
        assert "daemon-restarted" in crashed["error"]
        wait_status(second, queued["job"]["id"], {"done"})
        assert second.job_status(done_doc["job"]["id"])[1]["error"]["code"] == "unknown-job"
        status, fresh = second.submit(pkg.doc(TINY_FLAGS))
        assert status == 202 and fresh["job"]["id"] > queued["job"]["id"]
        wait_status(second, fresh["job"]["id"], {"done"})
    finally:
        gate.release.set()
        assert first.stop(timeout=60)
        if second is not None:
            assert second.stop(timeout=60)


def test_replayed_job_rides_no_second_requeue(pkg, tmp_path):
    run_dir = tmp_path / "serve"
    gate = GateExecutor(pkg, block_classes=("large",))
    first = pkg.service(run_dir, executor=gate, small_slices=0).start()
    try:
        _, running = first.submit(pkg.doc(LARGE_FLAGS))
        assert gate.started.wait(timeout=30)
        _, queued = first.submit(pkg.doc(LARGE_FLAGS))
        pkg.faults.configure("crash@serve.worker.claim")
        second = pkg.service(run_dir, executor=GateExecutor(pkg, block_classes=())).start()
        try:
            job = wait_status(second, queued["job"]["id"], {"failed"})
            assert "requeue" in job["error"]
        finally:
            assert second.stop(timeout=60)
    finally:
        pkg.faults.configure(None)
        gate.release.set()
        assert first.stop(timeout=60)


@pytest.mark.parametrize("flags", [
    ["--serve-small-site-limit", "0"], ["--small-slice-devices", "0"],
    ["--batch-max-jobs", "0"], ["--batch-linger-seconds", "-1"],
    ["--serve-age-cap-seconds", "0"], ["--executor-slices", "x"],
    ["--executor-slices", "-1"],
])
def test_serve_main_rejects_nonsense_flags_exit_2(pkg, flags):
    with pytest.raises(SystemExit) as e:
        pkg.http.serve_main(["--port", "0", *flags])
    assert e.value.code == 2


def test_service_ctor_validates_serving_parameters(pkg, tmp_path):
    for kwargs, match in (({"terminal_retention": 0}, "terminal_retention"),
                          ({"small_site_limit": 0}, "small_site_limit"),
                          ({"batch_max_jobs": 0}, "batch_max_jobs"),
                          ({"batch_linger_seconds": -1}, "batch_linger_seconds"),
                          ({"small_slices": -1}, "small_slices"),
                          ({"small_slice_devices": 0}, "small_slice_devices")):
        with pytest.raises(ValueError, match=match):
            pkg.daemon.PcaService(run_dir=str(tmp_path), **kwargs)


def test_stop_on_never_started_service_returns_immediately(pkg, tmp_path):
    assert pkg.daemon.PcaService(run_dir=str(tmp_path)).stop(timeout=5)


def test_service_small_site_limit_reclassifies(pkg, tmp_path):
    service = pkg.service(tmp_path / "serve", small_site_limit=100,
                          executor=GateExecutor(pkg, block_classes=())).start()
    try:
        status, doc = service.submit(pkg.doc(TINY_FLAGS))
        assert status == 202 and doc["job"]["class"] == "large"
        wait_status(service, doc["job"]["id"], {"done"})
    finally:
        assert service.stop(timeout=60)


# ------------------------------------------------------- the port's placement


def test_port_device_argument_is_checked(tmp_path):
    port = pkg_of("port")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        port.daemon.PcaService(run_dir=str(tmp_path), device="tpu")
    with pytest.raises(ValueError, match="mix device types"):
        port.daemon.PcaService(run_dir=str(tmp_path), devices=["cpu", "meta"]).start()


def test_two_slices_on_positions_of_one_device(tmp_path):
    """Two slices may sit on positions of one device: each worker gets its
    positions, every job runs with its slice's device type, and a small
    job finishes beside a running large one."""
    port = pkg_of("port")
    seen = {}
    gate = GateExecutor(port, block_classes=("large",))

    def recording(job, run_dir):
        seen[job.id] = (list(job.slice_devices), job.slice)
        return gate(job, run_dir)

    service = port.service(tmp_path / "serve", devices=["cpu", "cpu"], small_slices=1,
                           executor=recording).start()
    try:
        assert service.device_count == 2 and service.platform == "cpu"
        assert [w.streams for w in service._workers] == [[], []]
        _, large = service.submit(port.doc(LARGE_FLAGS))
        assert gate.started.wait(timeout=30)
        _, small = service.submit(port.doc(TINY_FLAGS))
        wait_status(service, small["job"]["id"], {"done"})
        gate.release.set()
        wait_status(service, large["job"]["id"], {"done"})
        assert seen[small["job"]["id"]] == ([torch.device("cpu")], "small-0")
        assert seen[large["job"]["id"]] == ([torch.device("cpu")], "large")
    finally:
        gate.release.set()
        assert service.stop(timeout=60)


def test_served_conf_takes_the_daemons_device(tmp_path):
    port = pkg_of("port")
    confs = []

    def recording(job, run_dir):
        confs.append(job.conf.device)
        return port.outcome({"ok": True})

    service = port.real_service(tmp_path / "serve", executor=recording).start()
    try:
        _, doc = service.submit(port.doc(TINY_FLAGS))
        wait_status(service, doc["job"]["id"], {"done"})
        assert confs == ["cpu"] and service.device_type == "cpu"
    finally:
        assert service.stop(timeout=60)


# ------------------------------------------------------------ fused groups

FUSE_WINDOWS = ["1:0:50000", "2:0:50000", "3:0:50000", "4:0:50000"]
FUSE_FLAGS = [["--num-samples", "8", "--references", w] for w in FUSE_WINDOWS]


def _serial_results(kind):
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    out = []
    with contextlib.redirect_stdout(io.StringIO()):
        for flags in FUSE_FLAGS:
            r = run_pipeline(PcaConf.parse(flags + ["--device", "cpu"]),
                             similarity_only=kind == "similarity")
            out.append({"similarity": r.similarity_summary} if kind == "similarity"
                       else {"pc_lines": r.lines})
    return out


@pytest.mark.parametrize("kind", ["similarity", "pca"])
def test_four_small_jobs_fuse_into_one_group(tmp_path, kind):
    """Four same-geometry small jobs admitted while the worker is held run
    as ONE stacked group; each lane's result is its serial run's; the
    metrics and the heartbeat carry the reference's names and segments."""
    port = pkg_of("port")
    serial = _serial_results(kind)
    port.cache.reset_compile_cache_stats()
    gate = GateExecutor(port)
    service = port.real_service(tmp_path / "serve", small_slices=0).start()
    try:
        service._executor = gate
        _, blocker = service.submit(port.doc(TINY_FLAGS, kind="grm"))
        assert gate.started.wait(timeout=30)
        service._executor = port.executor.execute_job
        docs = []
        for flags in FUSE_FLAGS:
            status, doc = service.submit(port.doc(flags, kind=kind))
            assert status == 202, doc
            docs.append(doc["job"]["id"])
        gate.release.set()
        wait_status(service, blocker["job"]["id"], {"done"})
        jobs = [wait_status(service, job_id, {"done", "failed"}, timeout=120) for job_id in docs]
        for job, want in zip(jobs, serial):
            assert job["status"] == "done", job["error"]
            assert (job["batch_size"], job["fused_size"]) == (4, 4)
            assert job["result"] == want
            assert os.path.exists(job["manifest_path"])
        text = service.metrics_text()
        assert "serve_fused_groups_total 1" in text and "serve_fused_jobs_total 4" in text
        assert "serve_batches_total 1" in text and "serve_batch_jobs_total 4" in text
        line = port.heartbeat.Heartbeat(60.0, service.registry).line()
        assert "batched 1 groups (4 jobs)" in line
        assert "fused 1 K-job group(s) (K≈4.0)" in line
        assert service.fleet_stats()["dispatch"] == {"fused_groups": 1, "fused_jobs": 4,
                                                     "serial_jobs": 1}
    finally:
        gate.release.set()
        assert service.stop(timeout=120)


def test_ineligible_group_runs_serially(tmp_path):
    """A batch group ``preflight_fused`` refuses (``grm``, a kind with no
    stacked program) runs back to back, each job its own program."""
    port = pkg_of("port")
    gate = GateExecutor(port)
    service = port.real_service(tmp_path / "serve", small_slices=0).start()
    try:
        service._executor = gate
        _, blocker = service.submit(port.doc(TINY_FLAGS))
        assert gate.started.wait(timeout=30)
        service._executor = port.executor.execute_job
        ids = [service.submit(port.doc(flags, kind="grm"))[1]["job"]["id"]
               for flags in FUSE_FLAGS[:2]]
        gate.release.set()
        jobs = [wait_status(service, job_id, {"done", "failed"}, timeout=120) for job_id in ids]
        assert [(j["status"], j["batch_size"], j["fused_size"]) for j in jobs] == [
            ("done", 2, 1), ("done", 2, 1)]
        assert "serve_fused_groups_total 0" in service.metrics_text()
    finally:
        gate.release.set()
        assert service.stop(timeout=120)


# ----------------------------------------------------------------- restart


def test_restart_replays_the_journal_and_serves_warm(tmp_path):
    """Stop one daemon and start a second on the same run directory: the
    journal replays the job the first left queued, the geometry ledger is
    primed (its torn last line skipped), and a repeat job reports warm.
    The process-wide ledger is cleared between the two, as a new process
    would start."""
    port = pkg_of("port")
    run_dir = tmp_path / "serve"
    port.cache.reset_compile_cache_stats()
    gate = GateExecutor(port)
    first = port.real_service(run_dir, small_slices=0, persistent_cache=True).start()
    second = None
    try:
        _, cold = first.submit(port.doc(TINY_FLAGS, kind="similarity"))
        cold = wait_status(first, cold["job"]["id"], {"done", "failed"}, timeout=120)
        assert (cold["status"], cold["compile_cache"]) == ("done", "cold")
        first._executor = gate
        _, held = first.submit(port.doc(LARGE_FLAGS))
        assert gate.started.wait(timeout=30)
        _, queued = first.submit(port.doc(TINY_FLAGS_B, kind="similarity"))
        ledger = run_dir / "geometry.ledger"
        keys = [k for k in ledger.read_text().splitlines() if k]
        assert len(keys) >= 1
        with open(ledger, "a") as f:
            f.write("0123abc")  # a writer killed mid-append
        assert not (run_dir / "jax-cache").exists()
        # A new process: nothing of the first daemon's warm state in memory.
        port.cache.reset_compile_cache_stats()
        second = port.real_service(run_dir, small_slices=0, persistent_cache=True).start()
        health = second.healthz()["warm_state"]
        assert health["primed_geometries"] == len(set(keys))
        assert health["journal_replayed"] == 2
        failed = wait_status(second, held["job"]["id"], {"failed"})
        assert failed["error"].startswith("daemon-restarted")
        replayed = wait_status(second, queued["job"]["id"], {"done", "failed"}, timeout=120)
        assert replayed["status"] == "done", replayed["error"]
        _, again = second.submit(port.doc(TINY_FLAGS, kind="similarity"))
        again = wait_status(second, again["job"]["id"], {"done", "failed"}, timeout=120)
        assert (again["status"], again["compile_cache"]) == ("done", "warm")
        assert again["result"] == cold["result"]
    finally:
        gate.release.set()
        assert first.stop(timeout=120)
        if second is not None:
            assert second.stop(timeout=120)


def test_no_persistent_cache_keeps_no_ledger(tmp_path):
    port = pkg_of("port")
    port.cache.reset_compile_cache_stats()
    service = port.real_service(tmp_path / "serve", persistent_cache=False).start()
    try:
        _, doc = service.submit(port.doc(TINY_FLAGS, kind="similarity"))
        wait_status(service, doc["job"]["id"], {"done"}, timeout=120)
        assert not (tmp_path / "serve" / "geometry.ledger").exists()
        assert service.healthz()["warm_state"]["persistent_cache"] is False
    finally:
        assert service.stop(timeout=120)


def test_attach_geometry_ledger_equals_the_reference(tmp_path):
    """Both packages prime the same keys from one ledger file (a torn last
    line skipped) and append the same first sights to it."""
    path = tmp_path / "geometry.ledger"
    path.write_text("0123456789abcdef\nfedcba9876543210\n0123456789abcdef\nnot-a-key\n0123")
    primed = []
    for name in PKGS:
        cache = pkg_of(name).cache
        cache.reset_compile_cache_stats()
        primed.append(cache.attach_geometry_ledger(str(path)))
        assert cache.geometry_seen("0123456789abcdef")
        assert cache.compile_cache_stats() == (0, 0)
        cache.reset_compile_cache_stats()
    assert primed == [2, 2]
    port = pkg_of("port").cache
    port.attach_geometry_ledger(str(path))
    assert port.record_geometry("aaaaaaaaaaaaaaaa") is False
    assert port.record_geometry("aaaaaaaaaaaaaaaa") is True
    assert path.read_text().endswith("0123aaaaaaaaaaaaaaaa\n")
    port.reset_compile_cache_stats()
    ref = pkg_of("ref").cache
    assert ref.attach_geometry_ledger(str(path)) == port.attach_geometry_ledger(str(path)) == 2


def test_wait_for_fails_with_the_state():
    with pytest.raises(AssertionError, match="state: 7"):
        wait_for(lambda: False, 0.05, lambda: "state: 7")
