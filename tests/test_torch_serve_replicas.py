"""Replica daemons sharing one run directory, in both packages.

The reference's ``tests/test_serve_replicas.py`` runs here once per
package (``pkg``): the run-directory guard, the lease store's claims,
steals, renewals and heartbeats, the fenced journal fold, and in-process
replica daemons that steal a dead peer's unbegun job (and complete it
once), fail a begun one with the structured error, adopt orphans and
their own jobs, carry a deadline across a steal, fence a zombie's
terminal, and fail over in the client. The cross checks: a dead replica's
state written by one package is stolen by the other's daemon. Every dead
replica's lease is written already expired (a clock in the past), so no
test waits on a lease to lapse by sleeping; every wait is bounded.
"""

import json
import os
import threading
import time

import pytest
from torch_serve_helpers import PKGS, TINY_FLAGS, pkg_of, wait_for, wait_status

@pytest.fixture(params=PKGS)
def pkg(request):
    return pkg_of(request.param)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    for name in PKGS:
        pkg_of(name).faults.configure(None)
    yield
    for name in PKGS:
        pkg_of(name).faults.configure(None)


class StubExecutor:
    """Records executed job ids; optionally blocks on ``release``; writes a
    per-job manifest naming the replica that ran the job."""

    def __init__(self, pkg, name, block=False, write_manifest=True):
        self.pkg = pkg
        self.name = name
        self.block = block
        self.write_manifest = write_manifest
        self.calls = []
        self.started = threading.Event()
        self.release = threading.Event()
        self._lock = threading.Lock()  # lock order: test-local leaf

    def __call__(self, job, run_dir):
        with self._lock:
            self.calls.append(job.id)
        self.started.set()
        if self.block:
            assert self.release.wait(timeout=60), "gate never released"
        manifest_path = None
        if self.write_manifest:
            job_dir = os.path.join(run_dir, "jobs", job.id)
            os.makedirs(job_dir, exist_ok=True)
            manifest_path = os.path.join(job_dir, "manifest.json")
            tmp = f"{manifest_path}.{self.name}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"by": self.name, "id": job.id}, f)
            os.replace(tmp, manifest_path)
        return self.pkg.outcome({"by": self.name, "id": job.id}, manifest_path)


def _replica(pkg, run_dir, name, executor, **kw):
    """An in-process replica: a 1.5 s lease renewed every 0.5 s, so only a
    replica whose renewals are stopped on purpose loses its own lease."""
    kw.setdefault("lease_seconds", 1.5)
    kw.setdefault("lease_grace_seconds", 0.25)
    kw.setdefault("steal_interval_seconds", 0.25)
    return pkg.service(run_dir, executor=executor, small_slices=0, replica_id=name, **kw)


def _dead_replica_state(pkg, run_dir, job_id="job-a-000001", began=False, lease=True,
                        live_lease=False, deadline_unix=None):
    """What a SIGKILLed replica ``a`` leaves: a stale heartbeat, an accepted
    (optionally leased, begun) job in the shared journal and its lease
    file — expired a minute ago unless ``live_lease``."""
    run_dir = str(run_dir)
    journal = pkg.journal
    past = lambda: time.time() - 60.0
    journal.LeaseStore(run_dir, "a", lease_seconds=1.0, clock=past).heartbeat()
    j = journal.JobJournal(journal.journal_path(run_dir), replica="a")
    j.accepted(job_id, pkg.doc(TINY_FLAGS), "small", time.time(), deadline_unix)
    if lease:
        store = journal.LeaseStore(run_dir, "a", lease_seconds=30.0 if live_lease else 1.0,
                                   grace_seconds=0.0, clock=time.time if live_lease else past)
        assert store.claim(job_id) == 1
        j.lease(job_id, 1)
    if began:
        j.began(job_id, epoch=1 if lease else None)
    j.close()
    return job_id


def _pending(pkg, run_dir):
    pending, _ = pkg.journal.replay_journal(pkg.journal.journal_path(str(run_dir)))
    return [p.job_id for p in pending]


# ---------------------------------------------------------- run-dir guard


def test_run_dir_guard_solo_is_exclusive(pkg, tmp_path):
    j = pkg.journal
    lock = j.acquire_run_dir_lock(str(tmp_path))
    with pytest.raises(j.RunDirBusy, match="distinct --replica-id"):
        j.acquire_run_dir_lock(str(tmp_path))
    with pytest.raises(j.RunDirBusy, match="without --replica-id"):
        j.acquire_run_dir_lock(str(tmp_path), "a")
    lock.release()
    j.acquire_run_dir_lock(str(tmp_path), "a").release()


def test_serve_main_second_solo_daemon_exits_2(pkg, tmp_path, capsys):
    lock = pkg.journal.acquire_run_dir_lock(str(tmp_path))
    try:
        argv = ["--run-dir", str(tmp_path), "--port", "0"]
        if pkg.name == "port":
            argv += ["--device", "cpu"]
        rc = pkg.http.serve_main(argv)
    finally:
        lock.release()
    assert rc == 2 and "--replica-id" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--lease-seconds", "0"], ["--lease-grace-seconds", "-1"],
                                   ["--steal-interval-seconds", "0"]])
def test_serve_main_rejects_bad_lease_flags(pkg, flags):
    with pytest.raises(SystemExit) as e:
        pkg.http.serve_main(["--port", "0", *flags])
    assert e.value.code == 2


def test_service_validates_replica_parameters(pkg, tmp_path):
    P = pkg.daemon.PcaService
    with pytest.raises(ValueError, match="replica_id"):
        P(run_dir=str(tmp_path), replica_id="a/b")
    with pytest.raises(ValueError, match="lease_seconds"):
        P(run_dir=str(tmp_path), replica_id="a", lease_seconds=0)
    with pytest.raises(ValueError, match="steal_interval_seconds"):
        P(run_dir=str(tmp_path), replica_id="a", steal_interval_seconds=0)


# ------------------------------------------------------------ lease store


def _clocked(pkg, tmp_path, replica, now, lease=1.0, grace=0.5):
    return pkg.journal.LeaseStore(str(tmp_path), replica, lease_seconds=lease,
                                  grace_seconds=grace, clock=lambda: now[0])


def test_lease_claim_is_exclusive(pkg, tmp_path):
    now = [100.0]
    a, b = (_clocked(pkg, tmp_path, r, now) for r in "ab")
    assert a.claim("j1") == 1
    assert b.claim("j1") is None and b.claim("j1", steal=True) is None
    assert a.still_owner("j1") and not b.still_owner("j1")


def test_lease_steal_requires_expiry_plus_grace(pkg, tmp_path):
    now = [100.0]
    a, b = (_clocked(pkg, tmp_path, r, now) for r in "ab")
    assert a.claim("j1") == 1
    now[0] = 101.2
    assert b.claim("j1", steal=True) is None
    now[0] = 101.6
    assert b.claim("j1", steal=True) == 2 and b.still_owner("j1")
    assert a.renew("j1") is False and not a.still_owner("j1")


def test_two_stealers_exactly_one_wins(pkg, tmp_path):
    now = [100.0]
    a, b, c = (_clocked(pkg, tmp_path, r, now) for r in "abc")
    assert a.claim("j1") == 1
    now[0] = 102.0
    assert b.claim("j1", steal=True) == 2
    assert c._try_claim_file("j1", 2) is False
    assert c.claim("j1", steal=True) is None


def test_lease_renewal_extends_expiry(pkg, tmp_path):
    now = [100.0]
    a = _clocked(pkg, tmp_path, "a", now)
    assert a.claim("j1") == 1
    now[0] = 100.9
    assert a.renew("j1") is True
    now[0] = 101.5
    assert a.still_owner("j1")
    now[0] = 102.0
    assert not a.still_owner("j1")


def test_own_expired_lease_reclaims_at_higher_epoch(pkg, tmp_path):
    now = [100.0]
    a = _clocked(pkg, tmp_path, "a", now)
    assert a.claim("j1") == 1
    now[0] = 105.0
    assert a.claim("j1") == 2
    b_now = [100.0]
    assert _clocked(pkg, tmp_path, "b", b_now).claim("j2") == 1
    assert _clocked(pkg, tmp_path, "b", b_now).claim("j2") == 1


def test_release_unlinks_lease_files(pkg, tmp_path):
    a = _clocked(pkg, tmp_path, "a", [100.0])
    assert a.claim("j1") == 1 and a.current("j1") is not None
    a.release("j1")
    assert a.current("j1") is None and a.owned_jobs() == {}


def test_heartbeats_and_peer_liveness(pkg, tmp_path):
    now = [100.0]
    a, b = (_clocked(pkg, tmp_path, r, now) for r in "ab")
    a.heartbeat()
    b.heartbeat()
    assert [(p["id"], p["alive"]) for p in a.peers()] == [("b", True)]
    assert a.alive_count() == 2
    now[0] = 110.0
    a.heartbeat()
    assert not a.peers()[0]["alive"] and a.alive_count() == 1


def test_claim_respects_min_epoch(pkg, tmp_path):
    assert _clocked(pkg, tmp_path, "a", [100.0]).claim("j1", steal=True, min_epoch=5) == 6


def test_fold_ignores_stale_epoch_terminal(pkg, tmp_path):
    J = pkg.journal
    path = J.journal_path(str(tmp_path))
    a, b = J.JobJournal(path, replica="a"), J.JobJournal(path, replica="b")
    a.accepted("job-a-000001", pkg.doc(TINY_FLAGS), "small", 1.0, None)
    a.lease("job-a-000001", 1)
    b.lease("job-a-000001", 2, stolen=True)
    a.terminal("job-a-000001", "done", epoch=1)
    pending, _ = J.replay_journal(path)
    assert [(p.job_id, p.lease_epoch, p.lease_replica) for p in pending] == [
        ("job-a-000001", 2, "b")]
    b.terminal("job-a-000001", "failed", epoch=2)
    assert J.replay_journal(path)[0] == []
    a.close()
    b.close()


# ------------------------------------------------- replica daemons: steals


@pytest.mark.parametrize("writer", PKGS)
def test_survivor_steals_unbegun_job_and_completes_once(pkg, writer, tmp_path):
    """The dead replica's state, written by either package, is stolen by
    ``pkg``'s survivor, run once, and settled."""
    jid = _dead_replica_state(pkg_of(writer), tmp_path)
    stub = StubExecutor(pkg, "b")
    b = _replica(pkg, tmp_path, "b", stub).start()
    try:
        job = wait_status(b, jid, {"done"})
        assert job["result"] == {"by": "b", "id": jid} and stub.calls == [jid]
        assert b.healthz()["replica"]["jobs_stolen"] == 1
        with open(os.path.join(str(tmp_path), "jobs", jid, "manifest.json")) as f:
            assert json.load(f)["by"] == "b"
        assert _pending(pkg, tmp_path) == []
    finally:
        assert b.stop(timeout=60)


def test_survivor_fails_begun_job_structured(pkg, tmp_path):
    jid = _dead_replica_state(pkg, tmp_path, began=True)
    stub = StubExecutor(pkg, "b")
    b = _replica(pkg, tmp_path, "b", stub).start()
    try:
        job = wait_status(b, jid, {"failed"})
        assert job["error"].startswith("replica-failover:") and "replica a died" in job["error"]
        assert stub.calls == []
        assert not os.path.exists(os.path.join(str(tmp_path), "jobs", jid, "manifest.json"))
        assert _pending(pkg, tmp_path) == []
    finally:
        assert b.stop(timeout=60)


def test_running_steal_scan_reclaims_after_owner_death(pkg, tmp_path):
    stub = StubExecutor(pkg, "b")
    b = _replica(pkg, tmp_path, "b", stub).start()
    try:
        jid = _dead_replica_state(pkg, tmp_path)
        assert wait_status(b, jid, {"done"})["result"]["by"] == "b"
        assert b.healthz()["replica"]["jobs_stolen"] == 1
    finally:
        assert b.stop(timeout=60)


def test_orphan_accepted_without_lease_is_reclaimed(pkg, tmp_path):
    stub = StubExecutor(pkg, "b")
    b = _replica(pkg, tmp_path, "b", stub).start()
    try:
        jid = _dead_replica_state(pkg, tmp_path, lease=False)
        assert wait_status(b, jid, {"done"})["result"]["by"] == "b"
    finally:
        assert b.stop(timeout=60)


def test_replica_restart_adopts_own_jobs(pkg, tmp_path):
    jid = _dead_replica_state(pkg, tmp_path, live_lease=True)
    a2 = _replica(pkg, tmp_path, "a", StubExecutor(pkg, "a2")).start()
    try:
        assert wait_status(a2, jid, {"done"})["result"]["by"] == "a2"
        assert a2.healthz()["replica"]["jobs_stolen"] == 0
    finally:
        assert a2.stop(timeout=60)


def test_deadline_budget_survives_steal_within_window(pkg, tmp_path):
    jid = _dead_replica_state(pkg, tmp_path, deadline_unix=time.time() + 60.0)
    b = _replica(pkg, tmp_path, "b", StubExecutor(pkg, "b")).start()
    try:
        assert wait_status(b, jid, {"done"})["result"]["by"] == "b"
    finally:
        assert b.stop(timeout=60)


def test_deadline_expired_across_steal_fails_structured(pkg, tmp_path):
    jid = _dead_replica_state(pkg, tmp_path, deadline_unix=time.time() - 1.0)
    stub = StubExecutor(pkg, "b")
    b = _replica(pkg, tmp_path, "b", stub).start()
    try:
        assert wait_status(b, jid, {"failed"})["error"].startswith("deadline-exceeded")
        assert stub.calls == []
    finally:
        assert b.stop(timeout=60)


def test_unrenewed_lease_is_stolen_and_the_job_completes_once(pkg, tmp_path):
    """Two daemons on one run directory: ``a`` admits a job its busy
    worker has not started, then stops renewing; ``b`` steals and runs the
    job; ``a``'s worker later reaches it and abandons it unrun. One run,
    one valid terminal."""
    gate = StubExecutor(pkg, "a", block=True)
    a = _replica(pkg, tmp_path, "a", gate).start()
    b = None
    try:
        _, blocker = a.submit(pkg.doc(TINY_FLAGS))
        assert gate.started.wait(timeout=30)
        status, doc = a.submit(pkg.doc(TINY_FLAGS))
        assert status == 202, doc
        jid = doc["job"]["id"]
        a._lease_stop.set()  # a's renewals and heartbeat stop
        stub = StubExecutor(pkg, "b")
        b = _replica(pkg, tmp_path, "b", stub).start()
        # The blocker began on a: b fails it structurally; the queued job
        # had not begun: b runs it.
        assert wait_status(b, jid, {"done"})["result"]["by"] == "b"
        assert wait_status(b, blocker["job"]["id"], {"failed"})["error"].startswith(
            "replica-failover:")
        gate.release.set()
        abandoned = wait_status(a, jid, {"failed"})
        assert abandoned["error"].startswith("lease-lost:")
        assert stub.calls == [jid] and gate.calls == [blocker["job"]["id"]]
        path = pkg.journal.journal_path(str(tmp_path))
        terminals = [json.loads(line) for line in open(path) if '"terminal"' in line]
        assert [t["replica"] for t in terminals if t["id"] == jid] == ["b"]
        assert _pending(pkg, tmp_path) == []
    finally:
        gate.release.set()
        if b is not None:
            assert b.stop(timeout=60)
        assert a.stop(timeout=60)


def test_zombie_abandons_unpublished_and_stale_terminal_is_fenced(pkg, tmp_path):
    gate = StubExecutor(pkg, "a", block=True, write_manifest=False)
    a = _replica(pkg, tmp_path, "a", gate).start()
    b = None
    try:
        _, doc = a.submit(pkg.doc(TINY_FLAGS))
        jid = doc["job"]["id"]
        assert gate.started.wait(timeout=30)
        a._lease_stop.set()
        stub = StubExecutor(pkg, "b")
        b = _replica(pkg, tmp_path, "b", stub).start()
        assert wait_status(b, jid, {"failed"})["error"].startswith("replica-failover:")
        assert stub.calls == []
        gate.release.set()
        abandoned = wait_status(a, jid, {"failed"})
        assert abandoned["error"].startswith("lease-lost:")
        assert abandoned["result"] is None and abandoned["manifest_path"] is None
        path = pkg.journal.journal_path(str(tmp_path))
        assert _pending(pkg, tmp_path) == []
        z = pkg.journal.JobJournal(path, replica="a")
        z.terminal(jid, "done", epoch=1)
        z.close()
        assert _pending(pkg, tmp_path) == []
        terminals = [json.loads(line) for line in open(path) if '"terminal"' in line]
        valid = [t for t in terminals if t.get("epoch", 0) >= 2]
        assert len(valid) == 1 and valid[0]["replica"] == "b"
    finally:
        gate.release.set()
        if b is not None:
            assert b.stop(timeout=60)
        assert a.stop(timeout=60)


def test_revalidate_claim_abandons_settled_job(pkg, tmp_path):
    c = _replica(pkg, tmp_path, "c", StubExecutor(pkg, "c"), lease_seconds=30.0,
                 steal_interval_seconds=3600.0).start()
    J = pkg.journal
    path = J.journal_path(str(tmp_path))
    try:
        j = J.JobJournal(path, replica="a")
        j.accepted("job-a-000001", pkg.doc(TINY_FLAGS), "small", time.time(), None)
        j.lease("job-a-000001", 1)
        j.close()
        epoch = c._lease_store.claim("job-a-000001", steal=True, min_epoch=1)
        assert epoch == 2
        z = J.JobJournal(path, replica="a")
        z.terminal("job-a-000001", "done", epoch=1)
        z.close()
        assert c._revalidate_claim("job-a-000001", epoch) is None
        assert c._lease_store.current("job-a-000001") is None
    finally:
        assert c.stop(timeout=60)


def test_clean_stop_withdraws_heartbeat(pkg, tmp_path):
    a = _replica(pkg, tmp_path, "a", StubExecutor(pkg, "a")).start()
    b = _replica(pkg, tmp_path, "b", StubExecutor(pkg, "b")).start()
    try:
        assert {p["id"] for p in a._lease_store.peers()} == {"b"}
        assert b.stop(timeout=60)
        health = a.healthz()
        assert health["status"] == "ok" and health["replica"]["peers"] == []
    finally:
        assert a.stop(timeout=60)


# ------------------------------------------------- kill points in-process


def test_serve_kill_points_registered(pkg):
    assert {"serve.worker.claim", "serve.worker.mid-job", "serve.lease.pre-renew",
            "serve.steal.pre-claim", "serve.submit.post-accept",
            "serve.lease.post-claim"} <= set(pkg.faults.KILL_POINTS)


def test_crash_at_lease_pre_renew_triggers_failover(pkg, tmp_path):
    """``crash@serve.lease.pre-renew`` kills the owner's maintenance
    thread: its lease lapses, and the peer fails the begun job."""
    pkg.faults.configure("crash@serve.lease.pre-renew")
    gate = StubExecutor(pkg, "a", block=True, write_manifest=False)
    a = _replica(pkg, tmp_path, "a", gate).start()
    b = None
    try:
        _, doc = a.submit(pkg.doc(TINY_FLAGS))
        jid = doc["job"]["id"]
        assert gate.started.wait(timeout=30)
        wait_for(lambda: not a._lease_thread.is_alive(), 30,
                 lambda: f"a's maintenance thread still alive: {a.healthz()}")
        pkg.faults.configure(None)
        b = _replica(pkg, tmp_path, "b", StubExecutor(pkg, "b")).start()
        assert wait_status(b, jid, {"failed"})["error"].startswith("replica-failover:")
    finally:
        pkg.faults.configure(None)
        gate.release.set()
        if b is not None:
            assert b.stop(timeout=60)
        assert a.stop(timeout=60)


def test_crash_at_steal_pre_claim_leaves_job_claimable(pkg, tmp_path):
    stub_b = StubExecutor(pkg, "b")
    b = _replica(pkg, tmp_path, "b", stub_b).start()
    c = None
    try:
        pkg.faults.configure("crash@serve.steal.pre-claim")
        jid = _dead_replica_state(pkg, tmp_path)
        wait_for(lambda: not b._lease_thread.is_alive(), 30,
                 lambda: f"b's steal scan never reached the kill point: {b.healthz()}")
        pkg.faults.configure(None)
        assert stub_b.calls == []
        c = _replica(pkg, tmp_path, "c", StubExecutor(pkg, "c")).start()
        assert wait_status(c, jid, {"done"})["result"]["by"] == "c"
        assert b.healthz()["queue"]["worker_alive"]
    finally:
        pkg.faults.configure(None)
        if c is not None:
            assert c.stop(timeout=60)
        assert b.stop(timeout=60)


# ------------------------------------------------------- client failover


def test_client_endpoint_list_parsing(pkg):
    client = pkg.client.ServeClient("http://a:1, http://b:2/")
    assert client.urls == ["http://a:1", "http://b:2"] and client.url == "http://a:1"
    with pytest.raises(ValueError, match="no endpoint"):
        pkg.client.ServeClient(" , ")


def test_client_fails_over_on_connection_refused(pkg, tmp_path):
    service = pkg.service(tmp_path / "serve", executor=StubExecutor(pkg, "solo"),
                          small_slices=0).start()
    server = pkg.http.start_server(service)
    try:
        client = pkg.client.ServeClient(f"http://127.0.0.1:1,{server.url}", max_retries=2)
        doc = client.submit(TINY_FLAGS)
        assert client.url == server.url
        assert client.wait(doc["job"]["id"], timeout=60)["job"]["status"] == "done"
    finally:
        server.shutdown()
        server.server_close()
        assert service.stop(timeout=60)


def test_client_wait_spans_the_failover_404_window(pkg, tmp_path):
    b = _replica(pkg, tmp_path, "b", StubExecutor(pkg, "b")).start()
    server = pkg.http.start_server(b)
    try:
        jid = _dead_replica_state(pkg, tmp_path)
        client = pkg.client.ServeClient(f"http://127.0.0.1:1,{server.url}", max_retries=2)
        doc = client.wait(jid, timeout=60)
        assert doc["job"]["status"] == "done" and doc["job"]["result"]["by"] == "b"
    finally:
        server.shutdown()
        server.server_close()
        assert b.stop(timeout=60)


# ------------------------------------------------------------ telemetry


def test_replica_healthz_and_metrics(pkg, tmp_path):
    a = _replica(pkg, tmp_path, "a", StubExecutor(pkg, "a")).start()
    try:
        _, doc = a.submit(pkg.doc(TINY_FLAGS))
        wait_status(a, doc["job"]["id"], {"done"})
        block = a.healthz()["replica"]
        assert (block["id"], block["alive"], block["degraded"], block["peers"]) == (
            "a", 1, False, [])
        text = a.metrics_text()
        assert "serve_replicas_alive 1" in text and "serve_jobs_stolen_total 0" in text
        line = pkg.heartbeat.Heartbeat(60.0, a.registry).line()
        assert "replicas 1 alive" in line
    finally:
        assert a.stop(timeout=60)


def test_solo_healthz_has_no_replica_block(pkg, tmp_path):
    service = pkg.service(tmp_path / "serve", executor=StubExecutor(pkg, "solo")).start()
    try:
        assert service.healthz()["replica"] is None
    finally:
        assert service.stop(timeout=60)
