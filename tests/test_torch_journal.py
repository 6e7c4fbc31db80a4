"""The serve journal (``serve/journal.py``) of both packages, held against
each other.

The JAX package's fold fuzz (``tests/test_journal_fold_fuzz.py``: the fold
is order-insensitive, compaction keeps its semantics) and its cost
round trip (``tests/test_cost_observatory.py``: a prediction rides the
``accepted`` record through replay and compaction) run here once per
package (``pkg``). The cross checks: seeded random sequences of
accepted, began, lease and terminal records go through one package's
:class:`JobJournal`; both packages' ``replay_journal`` and
``fold_records`` give equal pending sets and fences, before and after a
compaction by either package; a lease claimed by one package's
:class:`LeaseStore` fences the other's; and one package's run-directory
lock refuses the other's daemon.
"""

import importlib
import itertools
import json
import random
from dataclasses import asdict

import pytest

PACKAGES = {"ref": "spark_examples_tpu", "port": "spark_examples_tpu_torch"}
PKGS = sorted(PACKAGES)
REPLICAS = ("rep-a", "rep-b", "rep-c")
STATUSES = ("done", "failed", "cancelled")


def _j(pkg):
    return importlib.import_module(f"{PACKAGES[pkg]}.serve.journal")


def _random_history(j, rng):
    """One protocol-producible history (the reference fuzz's generator):
    per job an accepted record, a strictly increasing lease chain, maybe
    a began, and 0-2 terminals."""
    records = []
    for i in range(rng.randint(1, 3)):
        job = f"job-{i:04d}"
        records.append(j.accepted_record(job, {"n": i}, "pca", 100.0 + i, None,
                                          replica=rng.choice(REPLICAS)))
        epoch = 0
        for _ in range(rng.randint(0, 2)):
            epoch += rng.randint(1, 2)
            records.append(j.lease_record(job, epoch, replica=rng.choice(REPLICAS),
                                          stolen=rng.random() < 0.3))
        if epoch and rng.random() < 0.7:
            records.append(j.began_record(job, replica=rng.choice(REPLICAS),
                                          epoch=rng.randint(1, epoch)))
        for _ in range(rng.randint(0, 2)):
            records.append(j.terminal_record(job, rng.choice(STATUSES),
                                             replica=rng.choice(REPLICAS),
                                             epoch=rng.randint(1, epoch) if epoch else None))
    return records


def _fold_key(j, records):
    pending, max_seq = j.fold_records(records)
    return sorted((asdict(p) for p in pending), key=lambda p: p["job_id"]), max_seq


def _summary_key(j, records):
    summary = j.protocol_summary(records)
    jobs = {}
    for job_id, info in summary["jobs"].items():
        info = dict(info)
        info["terminals"] = sorted(
            (t["status"], -1 if t["epoch"] is None else t["epoch"], t["effective"])
            for t in info["terminals"]
        )
        jobs[job_id] = info
    return {"jobs": jobs, "totals": summary["totals"]}


def _permutations(records, rng, cap=60):
    if len(records) <= 5:
        return list(itertools.permutations(records))
    perms = []
    for _ in range(cap):
        shuffled = list(records)
        rng.shuffle(shuffled)
        perms.append(tuple(shuffled))
    return perms


@pytest.mark.parametrize("pkg", PKGS)
def test_fold_is_permutation_invariant(pkg):
    j = _j(pkg)
    checked = 0
    for seed in range(25):
        rng = random.Random(seed)
        records = _random_history(j, rng)
        base_fold, base_summary = _fold_key(j, records), _summary_key(j, records)
        for perm in _permutations(records, rng):
            assert _fold_key(j, perm) == base_fold, (seed, perm)
            assert _summary_key(j, perm) == base_summary, (seed, perm)
            checked += 1
    assert checked > 500


@pytest.mark.parametrize("pkg", PKGS)
def test_compaction_rewrite_preserves_fold_semantics(pkg):
    j = _j(pkg)
    for seed in range(40):
        records = _random_history(j, random.Random(seed ^ 0xC0FFEE))
        pending, _ = j.fold_records(records)
        refolded, _ = j.fold_records(j.compacted_records(pending))
        assert ({p.job_id: (p.device_began, p.lease_epoch) for p in pending}
                == {p.job_id: (p.device_began, p.lease_epoch) for p in refolded}), seed


@pytest.mark.parametrize("seed", range(6))
def test_record_constructors_and_folds_agree(seed):
    """The same history, built by each package's record constructors, is the
    same records, and each package's fold and protocol summary agree."""
    ref, port = _j("ref"), _j("port")
    records = _random_history(ref, random.Random(seed))
    assert _random_history(port, random.Random(seed)) == records
    assert _fold_key(port, records) == _fold_key(ref, records)
    assert _summary_key(port, records) == _summary_key(ref, records)


COST = {"predicted_seconds": 2.5, "kind": "pca", "compile": "cold",
        "compute_seconds": 0.4, "fingerprint": "fp9"}


@pytest.mark.parametrize("pkg", PKGS)
def test_journal_cost_survives_replay_and_compaction(pkg, tmp_path):
    j = _j(pkg)
    path = j.journal_path(str(tmp_path))
    journal = j.JobJournal(path)
    journal.accepted("job-000001", {"flags": ["--num-samples", "8"]}, "small",
                     submitted_unix=123.0, deadline_unix=None, trace_id="a" * 32, cost=COST)
    journal.accepted("job-000002", {"flags": []}, "small", submitted_unix=124.0,
                     deadline_unix=None)
    journal.close()
    pending, _ = j.replay_journal(path)
    assert [p.job_id for p in pending] == ["job-000001", "job-000002"]
    assert (pending[0].cost, pending[1].cost) == (COST, None)
    j.compact_journal(path, pending)
    pending2, _ = j.replay_journal(path)
    assert pending2[0].cost == COST and pending2[0].trace_id == "a" * 32
    assert pending2[1].cost is None


def _drive(j, path, rng, jobs=6):
    """A seeded run of one package's JobJournal: accepted, leases (some
    stolen), began and terminal records, some fenced, by three replicas."""
    writers = {r: j.JobJournal(path, replica=r) for r in REPLICAS}
    for i in range(jobs):
        job = f"job-{i:06d}"
        owner = rng.choice(REPLICAS)
        writers[owner].accepted(job, {"flags": ["--num-samples", str(8 + i)]},
                                rng.choice(("small", "large")), submitted_unix=100.0 + i,
                                deadline_unix=None if i % 2 else 200.0 + i,
                                trace_id=f"{i:032x}", cost=COST if i % 3 == 0 else None)
        epoch = 0
        for _ in range(rng.randint(0, 3)):
            epoch += 1
            leaser = rng.choice(REPLICAS)
            writers[leaser].lease(job, epoch, stolen=epoch > 1 and rng.random() < 0.5)
            if rng.random() < 0.4:
                writers[leaser].began(job, epoch=epoch, fused_size=rng.choice((None, 4)))
        if rng.random() < 0.6:
            fenced = epoch and rng.random() < 0.3
            writers[rng.choice(REPLICAS)].terminal(
                job, rng.choice(STATUSES), epoch=(epoch - 1 if fenced else epoch) or None)
    for w in writers.values():
        w.close()


def _replayed(j, path):
    pending, seq = j.replay_journal(path)
    return [asdict(p) for p in pending], seq


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("compactor", PKGS)
@pytest.mark.parametrize("writer", PKGS)
def test_journals_fold_identically_across_packages(writer, compactor, seed, tmp_path):
    w, c = _j(writer), _j(compactor)
    path = w.journal_path(str(tmp_path))
    _drive(w, path, random.Random(seed))
    before = {pkg: _replayed(_j(pkg), path) for pkg in PKGS}
    assert before["ref"] == before["port"]
    records = list(w.iter_journal_records(path))
    assert _fold_key(_j("port"), records) == _fold_key(_j("ref"), records)
    pending, _ = c.replay_journal(path)
    c.compact_journal(path, pending)
    after = {pkg: _replayed(_j(pkg), path) for pkg in PKGS}
    assert after["ref"] == after["port"]
    # Compaction keeps every pending job, its began flag and its fence.
    fences = lambda docs: {p["job_id"]: (p["device_began"], p["lease_epoch"]) for p in docs}
    assert fences(after["ref"][0]) == fences(before["ref"][0])


@pytest.mark.parametrize("first", PKGS)
def test_leases_fence_across_packages(first, tmp_path):
    """One package's lease holds the other's replica off; past expiry
    plus grace the other steals at epoch + 1."""
    other = "port" if first == "ref" else "ref"
    now = [1000.0]
    a = _j(first).LeaseStore(str(tmp_path), "rep-a", lease_seconds=5.0, clock=lambda: now[0])
    b = _j(other).LeaseStore(str(tmp_path), "rep-b", lease_seconds=5.0, clock=lambda: now[0])
    assert a.claim("job-1") == 1
    assert b.claim("job-1") is None
    assert b.claim("job-1", steal=True) is None  # live: not stealable
    view = b.current("job-1")
    assert (view.replica, view.epoch) == ("rep-a", 1)
    now[0] += 11.0  # past the lease and its grace window
    assert [v.job_id for v in b.expired_foreign()] == ["job-1"]
    assert b.claim("job-1", steal=True) == 2
    assert a.current("job-1").replica == "rep-b"
    assert not a.still_owner("job-1")


@pytest.mark.parametrize("first", PKGS)
def test_run_dir_lock_excludes_across_packages(first, tmp_path):
    other = "port" if first == "ref" else "ref"
    lock = _j(first).acquire_run_dir_lock(str(tmp_path))
    try:
        with pytest.raises(_j(other).RunDirBusy):
            _j(other).acquire_run_dir_lock(str(tmp_path))
        with pytest.raises(_j(other).RunDirBusy):
            _j(other).acquire_run_dir_lock(str(tmp_path), replica_id="rep-a")
    finally:
        lock.release()
    a = _j(first).acquire_run_dir_lock(str(tmp_path), replica_id="rep-a")
    b = _j(other).acquire_run_dir_lock(str(tmp_path), replica_id="rep-b")
    try:
        with pytest.raises(_j(other).RunDirBusy):
            _j(other).acquire_run_dir_lock(str(tmp_path), replica_id="rep-a")
    finally:
        a.release()
        b.release()


def test_journal_lines_are_the_references():
    """The on-disk record of each constructor is the reference's, key for key."""
    ref, port = _j("ref"), _j("port")
    for build in ("accepted_record", "began_record", "terminal_record", "lease_record"):
        args = {
            "accepted_record": (("job-1", {"f": 1}, "small", 1.0, None),
                                {"replica": "a", "trace_id": "ab" * 16, "cost": COST}),
            "began_record": (("job-1",), {"replica": "a", "epoch": 2, "fused_size": 4}),
            "terminal_record": (("job-1", "done"), {"replica": "a", "epoch": 2}),
            "lease_record": (("job-1", 3), {"replica": "a", "stolen": True}),
        }[build]
        a = getattr(ref, build)(*args[0], **args[1])
        b = getattr(port, build)(*args[0], **args[1])
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True), build
