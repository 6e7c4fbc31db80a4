"""Shared job-table journal + lease substrate: N replicas, one filesystem.

The port's copy of ``spark_examples_tpu/serve/journal.py``, pure file I/O
under ``fcntl``: the on-disk format is the reference's, record for record,
so a run directory written by either package folds identically in the
other. The journal is the coordination substrate for N independent
replica daemons sharing a run directory, so that an accepted job survives
the death of its process or its host. Three cooperating pieces:

- **the journal** (:class:`JobJournal` / :func:`replay_journal`): one
  JSON record per line, ``fsync``'d per record. Every admission decision
  a replica acknowledges to a client is durably recorded BEFORE the 202
  leaves the socket. With concurrent writers, appends take a SHARED
  ``flock`` on a side lock file (``<journal>.lock``) and re-check the
  journal's inode before each write — so a compaction (which holds the
  EXCLUSIVE lock, see below) can atomically replace the file without a
  concurrent appender's record landing in the dead inode and vanishing;
- **leases** (:class:`LeaseStore`): time-bounded, epoch-fenced ownership
  of accepted jobs. A lease is a file ``leases/<job>.e<epoch>`` created
  with ``os.link`` from a fully-written, fsync'd temp file — link fails
  atomically when the name exists, so exactly ONE replica wins each
  (job, epoch) and two replicas can never both own a job. Renewals
  rewrite the owner's own epoch file via ``os.replace`` (atomic content
  swap; owner-exclusive by construction). A replica **steals** a job
  whose lease expired past the grace window — its owner died — by
  link-claiming epoch+1: the same exactly-once primitive, so two
  concurrent stealers race to a single winner. Each successful claim or
  steal also appends a fsync'd ``lease`` record to the journal: the
  fold's fencing input;
- **the fenced fold**: ``terminal`` records written by a replica carry
  its lease epoch. At fold time a terminal whose epoch is below the
  job's highest journaled lease epoch is IGNORED — a deposed zombie
  replica's late write cannot settle (or double-complete) a job the
  stealer now owns; the stolen run's terminal wins. Epoch-less records
  (single-replica mode) fold exactly as before. The journaled
  ``device_began`` flag keeps enforcing requeue-once across replica
  lives: a stolen job that already touched the devices is failed with a
  structured error, never silently re-run.

Compaction under concurrent writers is lease-aware
(:func:`compact_journal_shared`): only the holder of the journal's
exclusive compaction ``flock`` compacts (others skip — a no-op, not an
error), the fold re-reads the journal UNDER the lock so no record
appended between a replica's startup replay and its compaction can be
lost, and the rewrite preserves each pending job's highest lease epoch
so fencing survives the rewrite. A torn final line (kill mid-append) is
skipped at fold and dropped by compaction — by the write protocol it can
only be the last line a crashed appender produced, and the client of
THAT record never received its 202.

The run-dir guard (:func:`acquire_run_dir_lock`) makes the sharing
contract explicit: a daemon WITHOUT ``--replica-id`` holds the run dir's
``serve.lock`` exclusively (a second such daemon exits 2 instead of
silently corrupting the journal); replicas hold it SHARED — they coexist
with each other, conflict with a solo daemon — plus an exclusive
per-replica lock so a duplicated ``--replica-id`` is rejected too.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import (
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Set,
    Tuple,
)

#: Journal filename under the service run directory.
JOURNAL_BASENAME = "jobs.journal.jsonl"

#: Side lock file next to the journal: appenders hold it SHARED per
#: record, compaction holds it EXCLUSIVE across read+rewrite+replace.
#: Never itself replaced, so every process locks the same inode.
JOURNAL_LOCK_SUFFIX = ".lock"

#: Lease files (``<job>.e<epoch>``) live here under the run dir.
LEASE_DIRNAME = "leases"

#: Per-replica heartbeat files (``<replica>.json``) live here.
HEARTBEAT_DIRNAME = "replicas"

#: Run-dir ownership guard (``flock``; see :func:`acquire_run_dir_lock`).
RUN_DIR_LOCK_BASENAME = "serve.lock"

#: Default lease time-to-live. A healthy replica renews every TTL/3, so
#: an expiry means the owner missed three consecutive renewal ticks.
DEFAULT_LEASE_SECONDS = 5.0


def journal_path(run_dir: str) -> str:
    return os.path.join(run_dir, JOURNAL_BASENAME)


@dataclass
class PendingJob:
    """One replayed accepted-but-unfinished job."""

    job_id: str
    request_doc: Dict
    job_class: str
    submitted_unix: float
    deadline_unix: Optional[float]
    device_began: bool = False
    accepted_record: Dict = field(default_factory=dict)
    #: Highest journaled lease epoch (0 = never leased) and the replica
    #: that holds it — the fencing facts a stealer needs to claim
    #: epoch+1 and to name the dead owner in a structured failure.
    lease_epoch: int = 0
    lease_replica: Optional[str] = None
    #: Trace id minted at submit (rides the ``accepted`` record, so one
    #: job stays one span tree across replica steals; ``None`` on
    #: journals written before tracing existed).
    trace_id: Optional[str] = None
    #: Admission-time cost prediction
    #: (``obs/costmodel.py:CostPrediction.to_dict``) — rides the
    #: ``accepted`` record like the trace id, so a stolen or replayed
    #: job keeps the prediction its original admission computed (the
    #: calibration pair must compare against THAT estimate, not a
    #: re-prediction under the adopter's warm state). ``None`` on
    #: journals written before the cost observatory existed.
    cost: Optional[Dict] = None


# -------------------------------------------------------- protocol core
#
# Pure transition functions — the single source of truth for every
# protocol decision. The runtime halves below (JobJournal / LeaseStore /
# serve/daemon.py) delegate here; `graftcheck proto` (check/proto.py)
# runs the SAME functions unchanged against an in-memory filesystem
# model, so what the model checker proves is what the fleet ships.
# Nothing in this section touches the filesystem or a clock: records in,
# decisions out.


def stamped_record(
    record: Dict, replica: Optional[str], epoch: Optional[int]
) -> Dict:
    """Stamp the writing replica and its lease epoch onto a record
    (``None`` replica = single-replica mode: records stay epoch-less and
    the fold applies no fencing)."""
    if replica is not None:
        record["replica"] = replica
    if epoch is not None:
        record["epoch"] = int(epoch)
    return record


def accepted_record(
    job_id: str,
    request_doc: Dict,
    job_class: str,
    submitted_unix: float,
    deadline_unix: Optional[float],
    replica: Optional[str] = None,
    trace_id: Optional[str] = None,
    cost: Optional[Dict] = None,
) -> Dict:
    """The durable admission fact. The replica stamp lets the steal scan
    attribute a job that was accepted but never leased (its owner died
    in the one-record window between this append and the lease claim) to
    a dead peer via the heartbeat file instead of leaving it orphaned.
    The trace id and cost prediction ride the same record so a stolen
    job keeps ONE span tree and ONE admission estimate across replica
    lives (compaction rewrites accepted records verbatim, so both
    survive every rewrite for free)."""
    record: Dict = {
        "event": "accepted",
        "id": job_id,
        "request": request_doc,
        "job_class": job_class,
        "submitted_unix": submitted_unix,
        "deadline_unix": deadline_unix,
    }
    if trace_id is not None:
        record["trace"] = trace_id
    if cost is not None:
        record["cost"] = dict(cost)
    return stamped_record(record, replica, None)


def began_record(
    job_id: str,
    replica: Optional[str] = None,
    epoch: Optional[int] = None,
    fused_size: Optional[int] = None,
) -> Dict:
    """The requeue-once boundary. ``fused_size`` (additive, >1 only for
    stacked-group members) is stamped here rather than on the accepted
    record: group membership is a DISPATCH fact — it does not exist at
    admission time, and a replayed/stolen job may re-run serial."""
    record: Dict = {"event": "began", "id": job_id}
    if fused_size is not None and fused_size > 1:
        record["fused_size"] = int(fused_size)
    return stamped_record(record, replica, epoch)


def terminal_record(
    job_id: str,
    status: str,
    replica: Optional[str] = None,
    epoch: Optional[int] = None,
) -> Dict:
    return stamped_record(
        {"event": "terminal", "id": job_id, "status": status}, replica, epoch
    )


def lease_record(
    job_id: str,
    epoch: int,
    replica: Optional[str] = None,
    stolen: bool = False,
) -> Dict:
    """One successful lease claim/steal — the fold's fencing input."""
    record = stamped_record({"event": "lease", "id": job_id}, replica, epoch)
    if stolen:
        record["stolen"] = True
    return record


def terminal_fsync(status: str) -> bool:
    """The terminal durability policy: done/failed terminals flush
    without fsync — it is the worker's hot path (every batched job pays
    it), and losing one in a crash only downgrades a finished job's
    post-restart status to the ``began``-pinned structured failure
    (never a re-run, never a resurrection; the per-job manifest on disk
    keeps the truth). A lost CANCELLED record would be worse — the job
    would replay and RUN after the user cancelled it — so cancels stay
    fsync'd, as do the admission-path tombstones ("rejected"). The model
    checker reads this SAME predicate to decide which journal suffix a
    crash may drop."""
    return status not in ("done", "failed")


class _FoldTables:
    """The fold's intermediate per-job tables, computed in ONE pass and
    consumed by both readers: :func:`fold_records` (the replay) and
    :func:`protocol_summary` (the post-mortem / model-checker view).
    Keeping one accumulator guarantees the proof and the report can
    never disagree about what a journal means."""

    def __init__(self, records: Iterable[Dict]):
        self.pending: Dict[str, PendingJob] = {}
        self.began: Set[str] = set()
        #: Per job: every terminal as ``(status, epoch)`` in file order.
        self.terminals: Dict[str, List[Tuple[Optional[str], Optional[int]]]]
        self.terminals = {}
        self.lease_epoch: Dict[str, int] = {}
        self.lease_replica: Dict[str, str] = {}
        self.steals: Dict[str, int] = {}
        self.lease_records: Dict[str, int] = {}
        self.max_seq = 0
        for record in records:
            job_id = record.get("id")
            if not isinstance(job_id, str):
                continue
            if job_id.startswith("job-"):
                # Both id grammars: solo `job-000042` and replica-stamped
                # `job-<replica>-000042` — the sequence is the last
                # segment.
                try:
                    self.max_seq = max(
                        self.max_seq, int(job_id.rsplit("-", 1)[-1])
                    )
                except ValueError:
                    pass
            event = record["event"]
            if event == "accepted":
                request = record.get("request")
                job_class = record.get("job_class")
                if not isinstance(request, dict) or not isinstance(
                    job_class, str
                ):
                    continue
                trace = record.get("trace")
                cost = record.get("cost")
                self.pending[job_id] = PendingJob(
                    job_id=job_id,
                    request_doc=request,
                    job_class=job_class,
                    submitted_unix=float(
                        record.get("submitted_unix") or 0.0
                    ),
                    deadline_unix=(
                        float(record["deadline_unix"])
                        if record.get("deadline_unix") is not None
                        else None
                    ),
                    accepted_record=record,
                    trace_id=trace if isinstance(trace, str) else None,
                    cost=cost if isinstance(cost, dict) else None,
                )
            elif event == "began":
                self.began.add(job_id)
            elif event == "terminal":
                epoch = record.get("epoch")
                status = record.get("status")
                self.terminals.setdefault(job_id, []).append(
                    (
                        status if isinstance(status, str) else None,
                        int(epoch) if isinstance(epoch, int) else None,
                    )
                )
            elif event == "lease":
                epoch = record.get("epoch")
                if not isinstance(epoch, int):
                    continue
                self.lease_records[job_id] = (
                    self.lease_records.get(job_id, 0) + 1
                )
                if record.get("stolen"):
                    self.steals[job_id] = self.steals.get(job_id, 0) + 1
                if epoch > self.lease_epoch.get(job_id, 0):
                    self.lease_epoch[job_id] = epoch
                    replica = record.get("replica")
                    if isinstance(replica, str):
                        self.lease_replica[job_id] = replica

    def effective(self, job_id: str, epoch: Optional[int]) -> bool:
        """Does a terminal at ``epoch`` survive fencing? Valid iff
        epoch-less (no fencing in play) or at/above the job's highest
        journaled lease epoch — decided after the full read, so a
        steal's lease record fences a terminal that landed earlier in
        the file."""
        fence = self.lease_epoch.get(job_id, 0)
        return epoch is None or epoch >= fence

    def settled(self) -> Set[str]:
        return {
            job_id
            for job_id, terms in self.terminals.items()
            if any(self.effective(job_id, e) for _status, e in terms)
        }


def fold_records(records: Iterable[Dict]) -> Tuple[List[PendingJob], int]:
    """Fold raw journal records into ``(pending_jobs, max_seq)`` — the
    pure core of :func:`replay_journal` (same contract; see there). The
    model checker calls THIS directly on its in-memory journal."""
    tables = _FoldTables(records)
    settled = tables.settled()
    survivors = []
    for job in tables.pending.values():
        if job.job_id in settled:
            continue
        job.device_began = job.job_id in tables.began
        job.lease_epoch = tables.lease_epoch.get(job.job_id, 0)
        job.lease_replica = tables.lease_replica.get(job.job_id)
        survivors.append(job)
    return survivors, tables.max_seq


def protocol_summary(records: Iterable[Dict]) -> Dict:
    """Per-run protocol facts from the SAME one-pass fold tables the
    replay uses: per job its fence epoch, every terminal with its
    fencing verdict, began/steal counts; plus run totals. ``obs report``
    renders this for post-mortems and ``graftcheck proto`` asserts
    invariants over it (GP001's "two effective terminals" is literally a
    filter over ``jobs[*].terminals[*].effective``) — one code path for
    the proof and the report."""
    tables = _FoldTables(records)
    settled = tables.settled()
    job_ids = sorted(
        set(tables.pending)
        | set(tables.terminals)
        | set(tables.lease_epoch)
        | tables.began
    )
    jobs: Dict[str, Dict] = {}
    effective_total = 0
    fenced_total = 0
    for job_id in job_ids:
        terminals = [
            {
                "status": status,
                "epoch": epoch,
                "effective": tables.effective(job_id, epoch),
            }
            for status, epoch in tables.terminals.get(job_id, [])
        ]
        effective = sum(1 for t in terminals if t["effective"])
        effective_total += effective
        fenced_total += len(terminals) - effective
        jobs[job_id] = {
            "fence": tables.lease_epoch.get(job_id, 0),
            "owner": tables.lease_replica.get(job_id),
            "began": job_id in tables.began,
            "settled": job_id in settled,
            "steals": tables.steals.get(job_id, 0),
            "leases": tables.lease_records.get(job_id, 0),
            "terminals": terminals,
        }
    return {
        "jobs": jobs,
        "totals": {
            "accepted": len(tables.pending),
            "settled": len(settled),
            "pending": len(tables.pending) - len(tables.pending.keys() & settled),
            "began": len(tables.began),
            "terminals": sum(len(t) for t in tables.terminals.values()),
            "effective_terminals": effective_total,
            "fenced_terminals": fenced_total,
            "steals": sum(tables.steals.values()),
            "max_lease_epoch": max(tables.lease_epoch.values(), default=0),
        },
    }


def arbitrate_claim(
    view: Optional["LeaseView"],
    replica: str,
    now: float,
    grace_seconds: float,
    steal: bool = False,
    min_epoch: int = 0,
    min_replica: Optional[str] = None,
) -> Tuple[str, int]:
    """Pure lease-claim arbitration: given the job's current on-disk
    lease view (highest epoch, or ``None``), decide what ``replica`` may
    do. Returns one of:

    - ``("deny", 0)`` — the job is someone else's (live foreign lease,
      or expired-past-grace without ``steal``);
    - ``("adopt", epoch)`` — our own UNEXPIRED lease (a fast restart of
      THIS replica id): adopt it at its epoch and renew, no new link;
    - ``("claim", epoch)`` — link-claim this epoch: fresh job (epoch 1),
      our own expired lease (epoch+1), or a foreign lease expired past
      the grace window with ``steal=True`` (epoch+1; exactly one
      concurrent stealer wins the link race).

    ``min_epoch`` is the job's highest JOURNALED lease epoch as the
    caller folded it, and ``min_replica`` the replica that journaled it:
    a granted claim always exceeds ``min_epoch``, so a claim made from a
    stale fold (the previous owner settled and unlinked its lease files
    meanwhile) can never re-issue a fenced epoch. Adopting our own
    unexpired lease keeps its epoch — but ONLY while the journaled fence
    is consistent with it (below our epoch, or at our epoch and
    journaled by US). An own live link at an epoch some OTHER replica
    already journaled is the debris of a stale-fold claim that never got
    revalidated (the claimant crashed in the post-claim window): its
    epoch is fenced, so it is re-claimed above the fence instead of
    adopted — found by `graftcheck proto` (GP004 witness: accepter
    stalls across a peer's adopt-and-settle, links the settled epoch,
    host-crash drops the terminal, restart adopts the leftover link)."""
    if view is None:
        epoch = 1
    elif view.replica == replica:
        if now <= view.expires_unix and (
            view.epoch > int(min_epoch)
            or (view.epoch == int(min_epoch) and min_replica == replica)
        ):
            return ("adopt", view.epoch)
        epoch = view.epoch + 1
    elif now > view.expires_unix + grace_seconds:
        if not steal:
            return ("deny", 0)
        epoch = view.epoch + 1
    else:
        return ("deny", 0)
    return ("claim", max(epoch, int(min_epoch) + 1))


def owner_valid(
    view: Optional["LeaseView"], replica: str, epoch: int, now: float
) -> bool:
    """The ownership fence: does ``replica`` hold the job's HIGHEST
    epoch, unexpired, right now? Checked before every renewal, every
    terminal write and every result publication — a deposed or expired
    owner abandons."""
    return (
        view is not None
        and view.epoch == epoch
        and view.replica == replica
        and now <= view.expires_unix
    )


def foreign_expired(
    view: "LeaseView", replica: str, now: float, grace_seconds: float
) -> bool:
    """Steal-candidate predicate: the lease belongs to another replica
    and expired past the grace window (its owner died — a healthy owner
    renews at TTL/3 and abandons at expiry, so the asymmetric window
    keeps an owner's last-moment publish and a stealer's claim from
    overlapping under skewed clocks)."""
    return (
        view.replica != replica
        and now > view.expires_unix + grace_seconds
    )


def revalidate_pending(
    pending: List[PendingJob], job_id: str, epoch: int
) -> Optional[PendingJob]:
    """Post-claim fence against a STALE FOLD: between the fold a steal
    decision was made from and the claim itself, the job's previous
    holder may have settled it and released its lease — which is exactly
    what would have made the claim succeed at a fresh epoch. The
    settle's terminal write strictly precedes the lease unlink, so a
    re-fold AFTER a successful claim necessarily sees it. Given the
    RE-FOLDED pending set, returns the record to adopt, or ``None`` —
    settled (absent) or fenced above our epoch — in which case the
    caller must release the claim before any work is adopted."""
    for record in pending:
        if record.job_id == job_id:
            if record.lease_epoch <= epoch:
                return record
            break
    return None


def adoption_action(device_began: bool) -> str:
    """What adopting a replayed/stolen pending job does: ``"requeue"``
    (re-enter the queue with the one free retry consumed) — unless the
    journal says device work began, in which case ``"fail"`` with a
    structured error: the requeue-once boundary holds ACROSS replica
    lives, and device state under a crashed update cannot be trusted
    for a silent retry."""
    return "fail" if device_began else "requeue"


def steal_candidates(
    pending: List[PendingJob],
    expired: Set[str],
    replica: str,
    alive_peers: Set[str],
    lease_present: Callable[[str], bool],
) -> List[PendingJob]:
    """Which pending jobs may ``replica`` try to steal? The journal fold
    (NOT the lease file) decides live-ness of the job itself: a lease
    left behind by a settled job never appears in ``pending``. Two
    flavors, in file order:

    - ``expired`` — jobs whose highest lease is foreign and expired past
      grace (:func:`foreign_expired`): the normal steal;
    - orphans — accepted but never leased (``lease_epoch == 0``), whose
      accepting replica is not us, not heartbeating, and left no lease
      file: the owner died in the one-record window between the
      accepted append and its lease claim (or a solo daemon's journal
      was adopted by replicas)."""
    candidates = []
    for record in pending:
        if record.job_id in expired:
            candidates.append(record)
            continue
        owner = record.accepted_record.get("replica")
        if (
            record.lease_epoch == 0
            and owner != replica
            and owner not in alive_peers
            and not lease_present(record.job_id)
        ):
            candidates.append(record)
    return candidates


def compacted_records(pending: List[PendingJob]) -> List[Dict]:
    """The rewrite set for compaction: each still-pending job's accepted
    record VERBATIM (trace + cost ride along), its began flag, and (when
    the job was ever leased) ONE lease record at the highest epoch —
    fencing must survive the rewrite or a zombie's late terminal would
    settle a compacted job."""
    records: List[Dict] = []
    for job in pending:
        records.append(job.accepted_record)
        if job.device_began:
            records.append(began_record(job.job_id))
        if job.lease_epoch > 0:
            records.append(
                lease_record(
                    job.job_id,
                    job.lease_epoch,
                    replica=job.lease_replica,
                )
            )
    return records


class JobJournal:
    """Appender half: one replica's durable admission log. ``replica``
    stamps every ``began``/``terminal``/``lease`` record this appender
    writes (``None`` = single-replica mode: records stay epoch-less and
    the fold applies no fencing)."""

    def __init__(self, path: str, replica: Optional[str] = None):
        self.path = path
        self.replica = replica
        # Serializes this process's appends so records never interleave
        # mid-line; cross-process serialization is the shared flock.
        # lock order: journal lock is a leaf — nothing else is acquired
        # while holding it (machine-checked by `graftcheck lockgraph`).
        self._lock = threading.Lock()
        self._file = None
        self._lock_fd: Optional[int] = None

    def _ensure_open_locked(self) -> None:
        """(Re)open the journal if unopened or if compaction swapped the
        file out from under our handle (inode changed): an append into a
        replaced inode would vanish."""
        if self._file is not None:
            try:
                if (
                    os.stat(self.path).st_ino
                    == os.fstat(self._file.fileno()).st_ino
                ):
                    return
            except OSError:
                pass
            self._file.close()
            self._file = None
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._file = open(self.path, "a", encoding="utf-8")

    def _append(self, record: Dict, fsync: bool = True) -> None:
        line = json.dumps(record, sort_keys=True) + "\n"
        with self._lock:
            if self._lock_fd is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._lock_fd = os.open(
                    self.path + JOURNAL_LOCK_SUFFIX,
                    os.O_CREAT | os.O_RDWR,
                    0o644,
                )
            # Shared vs a compactor's exclusive hold: an append either
            # completes before the rewrite reads the journal (the record
            # survives into the compacted file) or starts after the
            # os.replace (the inode re-check opens the new file). Held
            # only for this one buffered write+flush — bounded.
            fcntl.flock(self._lock_fd, fcntl.LOCK_SH)
            try:
                self._ensure_open_locked()
                self._file.write(line)
                self._file.flush()
                if fsync:
                    os.fsync(self._file.fileno())
            finally:
                fcntl.flock(self._lock_fd, fcntl.LOCK_UN)

    # ------------------------------------------------------------- records

    def accepted(
        self,
        job_id: str,
        request_doc: Dict,
        job_class: str,
        submitted_unix: float,
        deadline_unix: Optional[float],
        trace_id: Optional[str] = None,
        cost: Optional[Dict] = None,
    ) -> None:
        self._append(
            accepted_record(
                job_id,
                request_doc,
                job_class,
                submitted_unix,
                deadline_unix,
                replica=self.replica,
                trace_id=trace_id,
                cost=cost,
            )
        )

    def began(
        self,
        job_id: str,
        epoch: Optional[int] = None,
        fused_size: Optional[int] = None,
    ) -> None:
        self._append(
            began_record(
                job_id,
                replica=self.replica,
                epoch=epoch,
                fused_size=fused_size,
            )
        )

    def terminal(
        self, job_id: str, status: str, epoch: Optional[int] = None
    ) -> None:
        # Durability policy (and its rationale): :func:`terminal_fsync`.
        self._append(
            terminal_record(
                job_id, status, replica=self.replica, epoch=epoch
            ),
            fsync=terminal_fsync(status),
        )

    def lease(
        self, job_id: str, epoch: int, stolen: bool = False
    ) -> None:
        """One successful lease claim/steal — the fold's fencing input,
        always fsync'd (a stale-epoch zombie write is only provably
        stale if the higher lease record is durable)."""
        self._append(
            lease_record(
                job_id, epoch, replica=self.replica, stolen=stolen
            )
        )

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            if self._lock_fd is not None:
                os.close(self._lock_fd)
                self._lock_fd = None


# ---------------------------------------------------------------- replay


def _iter_records(path: str) -> Iterator[Dict]:
    """Yield parsed journal records; a torn/corrupt line (mid-write kill)
    is skipped — by the write protocol it can only be the LAST line a
    crashed appender produced, and its client never got the 202."""
    try:
        f = open(path, "r", encoding="utf-8")
    except FileNotFoundError:
        return
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(record, dict) and "event" in record:
                yield record


def iter_journal_records(path: str) -> Iterator[Dict]:
    """Public raw-record iterator (the ``trace export`` verb correlates the
    journal's admission/lease/terminal facts with flight-recorder events;
    the fold below stays the replay semantics)."""
    return _iter_records(path)


def replay_journal(path: str) -> Tuple[List[PendingJob], int]:
    """Fold the journal into ``(pending_jobs, max_seq)``: every accepted
    job without a VALID terminal record, in admission order, with its
    ``device_began`` flag and highest lease epoch; and the highest
    numeric job-id sequence seen (a restarted replica's id sequence must
    continue past it — replayed ids stay stable for clients polling
    across the restart).

    The fold is ORDER-INSENSITIVE across events of one job: ``began``/
    ``terminal``/``lease`` count even when they precede the ``accepted``
    record in the file (appenders are concurrent threads AND concurrent
    replica processes serialized only per record). **Epoch fencing**: a
    terminal record carrying a lease epoch below the job's highest
    journaled lease epoch is a deposed replica's late write — ignored,
    so the job it failed to settle is settled (or re-run) by its current
    owner instead, and never double-completed. Epoch-less terminals
    (single-replica mode) always count. A ``began`` record pins the
    no-silent-re-run policy regardless of which replica's life wrote it.

    The fold itself is the pure :func:`fold_records`; this wrapper only
    binds it to a file."""
    return fold_records(_iter_records(path))


# ----------------------------------------------------------- compaction


def _rewrite_journal(path: str, pending: List[PendingJob]) -> None:
    """Atomic rewrite holding only still-pending jobs' records: the
    accepted record, the began flag, and (when the job was ever leased)
    one lease record at the highest epoch — fencing must survive the
    rewrite or a zombie's late terminal would settle a compacted job.
    The record set is the pure :func:`compacted_records`."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        for record in compacted_records(pending):
            f.write(json.dumps(record, sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def compact_journal(path: str, pending: List[PendingJob]) -> None:
    """Single-writer compaction (the solo daemon's startup path, and
    tests): rewrite the journal to hold only ``pending``. Takes the
    exclusive compaction flock for symmetry with the shared-append
    protocol — in solo mode it is uncontended."""
    lock_fd = os.open(
        path + JOURNAL_LOCK_SUFFIX, os.O_CREAT | os.O_RDWR, 0o644
    )
    try:
        fcntl.flock(lock_fd, fcntl.LOCK_EX)
        _rewrite_journal(path, pending)
    finally:
        os.close(lock_fd)


def compact_journal_shared(
    path: str, lease_dir: Optional[str] = None
) -> bool:
    """Lease-aware compaction for concurrent writers: only the holder of
    the journal's exclusive compaction flock compacts — a replica that
    loses the race (or arrives while another replica is mid-compaction)
    SKIPS, returning ``False``, instead of rewriting a journal it does
    not own. The winner re-folds the journal UNDER the lock (no appender
    can race the read: appends hold the lock shared), rewrites it to the
    pending set, and — when ``lease_dir`` is given — sweeps settled
    jobs' lease files so the lease directory stays O(pending) too."""
    lock_fd = os.open(
        path + JOURNAL_LOCK_SUFFIX, os.O_CREAT | os.O_RDWR, 0o644
    )
    try:
        try:
            fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            return False
        pending, _max_seq = replay_journal(path)
        _rewrite_journal(path, pending)
        if lease_dir is not None:
            _sweep_lease_files(
                lease_dir, keep={job.job_id for job in pending}
            )
        return True
    finally:
        os.close(lock_fd)


def _sweep_lease_files(lease_dir: str, keep: set) -> None:
    try:
        names = os.listdir(lease_dir)
    except FileNotFoundError:
        return
    for name in names:
        job_id, _sep, _epoch = name.rpartition(".e")
        if job_id and job_id not in keep:
            try:
                os.unlink(os.path.join(lease_dir, name))
            except OSError:
                pass  # a concurrent sweep won the unlink — same outcome


# -------------------------------------------------------------- leases


@dataclass(frozen=True)
class LeaseView:
    """One job's current lease as read from disk (its highest epoch)."""

    job_id: str
    replica: str
    epoch: int
    expires_unix: float


class LeaseStore:
    """One replica's half of the lease protocol; see the module
    docstring for the claim/renew/steal file semantics."""

    def __init__(
        self,
        run_dir: str,
        replica: str,
        lease_seconds: float = DEFAULT_LEASE_SECONDS,
        grace_seconds: Optional[float] = None,
        clock: Callable[[], float] = time.time,
    ):
        if not replica:
            raise ValueError("LeaseStore needs a non-empty replica id")
        if lease_seconds <= 0:
            raise ValueError(
                f"lease_seconds must be > 0, got {lease_seconds}"
            )
        self.run_dir = run_dir
        self.replica = replica
        self.lease_seconds = float(lease_seconds)
        #: Clock-skew allowance: a foreign lease is stealable only past
        #: expiry PLUS this window, while the owner abandons at expiry —
        #: the asymmetry that keeps an owner's last-moment publish and a
        #: stealer's claim from overlapping under skewed clocks.
        self.grace_seconds = (
            float(grace_seconds)
            if grace_seconds is not None
            else float(lease_seconds)
        )
        self.lease_dir = os.path.join(run_dir, LEASE_DIRNAME)
        self.heartbeat_dir = os.path.join(run_dir, HEARTBEAT_DIRNAME)
        self._clock = clock
        # lock order: lease-store lock is a leaf — it guards only the
        # owned-epoch dict; every file operation happens outside it.
        self._lock = threading.Lock()
        self._owned: Dict[str, int] = {}
        os.makedirs(self.lease_dir, exist_ok=True)
        os.makedirs(self.heartbeat_dir, exist_ok=True)

    # ------------------------------------------------------------- files

    def _path(self, job_id: str, epoch: int) -> str:
        return os.path.join(self.lease_dir, f"{job_id}.e{epoch}")

    def _write_tmp(self, doc: Dict) -> str:
        tmp = os.path.join(
            self.lease_dir,
            f".tmp.{self.replica}.{os.getpid()}.{threading.get_ident()}",
        )
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        return tmp

    def _lease_doc(self, job_id: str, epoch: int) -> Dict:
        return {
            "job": job_id,
            "replica": self.replica,
            "epoch": epoch,
            "expires_unix": self._clock() + self.lease_seconds,
        }

    def _try_claim_file(self, job_id: str, epoch: int) -> bool:
        """The exactly-once primitive: link a fully-written temp file to
        the (job, epoch) name — atomic in existence AND content; the
        loser of a race gets ``FileExistsError``, never a torn read."""
        tmp = self._write_tmp(self._lease_doc(job_id, epoch))
        try:
            os.link(tmp, self._path(job_id, epoch))
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    def current(self, job_id: str) -> Optional[LeaseView]:
        """The job's highest-epoch lease on disk, or ``None``."""
        views = self._scan(prefix=f"{job_id}.e")
        return views.get(job_id)

    def _scan(self, prefix: Optional[str] = None) -> Dict[str, LeaseView]:
        """Highest-epoch lease view per job (optionally one job only)."""
        try:
            names = os.listdir(self.lease_dir)
        except FileNotFoundError:
            return {}
        best: Dict[str, Tuple[int, str]] = {}
        for name in names:
            if name.startswith(".tmp."):
                continue
            if prefix is not None and not name.startswith(prefix):
                continue
            job_id, sep, epoch_text = name.rpartition(".e")
            if not sep or not job_id:
                continue
            try:
                epoch = int(epoch_text)
            except ValueError:
                continue
            if epoch > best.get(job_id, (0, ""))[0]:
                best[job_id] = (epoch, name)
        views: Dict[str, LeaseView] = {}
        for job_id, (epoch, name) in best.items():
            try:
                with open(
                    os.path.join(self.lease_dir, name), encoding="utf-8"
                ) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # swept concurrently; claims are atomic-content
            replica = doc.get("replica")
            expires = doc.get("expires_unix")
            if not isinstance(replica, str) or not isinstance(
                expires, (int, float)
            ):
                continue
            views[job_id] = LeaseView(
                job_id=job_id,
                replica=replica,
                epoch=epoch,
                expires_unix=float(expires),
            )
        return views

    # ------------------------------------------------------------ protocol

    def claim(
        self,
        job_id: str,
        steal: bool = False,
        min_epoch: int = 0,
        min_replica: Optional[str] = None,
    ) -> Optional[int]:
        """Acquire the job's lease; returns the held epoch or ``None``.

        - no lease on disk → claim epoch 1 (fresh admission / replay of
          a never-leased journal);
        - our own UNEXPIRED lease (a fast restart of THIS replica id) →
          adopt it at its epoch and renew; our own EXPIRED lease →
          re-claim at epoch+1 (a stealer may already be mid-claim at
          that epoch — the link race decides, never both);
        - a foreign live lease → ``None`` (the job is theirs);
        - a foreign lease expired past the grace window → with
          ``steal=True``, link-claim epoch+1 (exactly one concurrent
          stealer wins); without, ``None`` — admission never steals.

        ``min_epoch``/``min_replica`` are the job's highest JOURNALED
        lease epoch and its journaling replica as the caller folded
        them: the granted epoch always exceeds ``min_epoch``, so a
        claim made from a stale fold (the previous owner settled and
        unlinked its lease files meanwhile) can never re-issue a fenced
        epoch — and an own live link at an epoch journaled by a
        DIFFERENT replica is re-claimed above it, not adopted (see
        :func:`arbitrate_claim`). Stale-fold claims are additionally
        re-validated against the journal by the caller
        (``serve/daemon.py``) before any work is adopted.

        The decision itself is the pure :func:`arbitrate_claim`; this
        method only binds it to the on-disk view and the link file."""
        verdict, epoch = arbitrate_claim(
            self.current(job_id),
            self.replica,
            self._clock(),
            self.grace_seconds,
            steal=steal,
            min_epoch=min_epoch,
            min_replica=min_replica,
        )
        if verdict == "deny":
            return None
        if verdict == "adopt":
            with self._lock:
                self._owned[job_id] = epoch
            self.renew(job_id)
            return epoch
        if not self._try_claim_file(job_id, epoch):
            return None
        with self._lock:
            self._owned[job_id] = epoch
        return epoch

    def renew(self, job_id: str) -> bool:
        """Extend our lease's expiry (atomic content swap of our own
        epoch file). Returns ``False`` — the lease is LOST, abandon the
        job — when we no longer hold it: a higher epoch exists (stolen),
        the file vanished, or our own expiry already passed (a renewal
        thread stalled past the TTL must not resurrect itself: by then a
        stealer may legitimately be mid-claim inside the grace window).
        Validity is the same :func:`owner_valid` fence the publish path
        checks."""
        with self._lock:
            epoch = self._owned.get(job_id)
        if epoch is None:
            return False
        view = self.current(job_id)
        if not owner_valid(view, self.replica, epoch, self._clock()):
            self.forget(job_id)
            return False
        tmp = self._write_tmp(self._lease_doc(job_id, epoch))
        os.replace(tmp, self._path(job_id, epoch))
        return True

    def still_owner(self, job_id: str) -> bool:
        """The pre-publish fence: do we hold the job's HIGHEST epoch,
        unexpired, right now? Checked before every terminal write and
        result publication — a deposed or expired owner abandons. The
        predicate is the pure :func:`owner_valid`."""
        with self._lock:
            epoch = self._owned.get(job_id)
        if epoch is None:
            return False
        return owner_valid(
            self.current(job_id), self.replica, epoch, self._clock()
        )

    def owned_jobs(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._owned)

    def epoch_of(self, job_id: str) -> Optional[int]:
        with self._lock:
            return self._owned.get(job_id)

    def forget(self, job_id: str) -> None:
        """Drop local ownership bookkeeping (lease lost or released)."""
        with self._lock:
            self._owned.pop(job_id, None)

    def release(self, job_id: str) -> None:
        """Job settled: unlink our lease file(s) up to our epoch and
        forget it. A higher (stolen) epoch file is never touched."""
        with self._lock:
            epoch = self._owned.pop(job_id, None)
        if epoch is None:
            return
        for e in range(1, epoch + 1):
            try:
                os.unlink(self._path(job_id, e))
            except OSError:
                pass

    def expired_foreign(self) -> List[LeaseView]:
        """Steal candidates: every job whose HIGHEST lease belongs to
        another replica and expired past the grace window — the pure
        :func:`foreign_expired` over every on-disk view."""
        now = self._clock()
        return [
            view
            for view in self._scan().values()
            if foreign_expired(view, self.replica, now, self.grace_seconds)
        ]

    # ---------------------------------------------------------- liveness

    def heartbeat(self) -> None:
        """Atomic publish of this replica's liveness (peers read the
        written clock, not mtime — one host, one clock domain)."""
        doc = {
            "replica": self.replica,
            "pid": os.getpid(),
            "unix": self._clock(),
        }
        tmp = os.path.join(
            self.heartbeat_dir, f".tmp.{self.replica}.{os.getpid()}"
        )
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(
            tmp, os.path.join(self.heartbeat_dir, f"{self.replica}.json")
        )

    def retire(self) -> None:
        """Clean shutdown: withdraw this replica's heartbeat file so
        peers see an intentionally departed member (absent) rather than
        a dead one (stale) — a drained replica must not leave the pool
        reporting ``degraded`` forever."""
        try:
            os.unlink(
                os.path.join(self.heartbeat_dir, f"{self.replica}.json")
            )
        except OSError:
            pass

    def peers(self, stale_after: Optional[float] = None) -> List[Dict]:
        """Every OTHER replica's last heartbeat: ``{id, age_seconds,
        alive}`` (alive = age within ``stale_after``, default 3×TTL)."""
        horizon = (
            float(stale_after)
            if stale_after is not None
            else 3.0 * self.lease_seconds
        )
        now = self._clock()
        try:
            names = os.listdir(self.heartbeat_dir)
        except FileNotFoundError:
            return []
        # Keyed by replica id: the accumulation is bounded by how many
        # daemons share the run dir, never by any input's size.
        ages: Dict[str, float] = {}
        for name in sorted(names):
            if not name.endswith(".json") or name.startswith(".tmp."):
                continue
            replica = name[: -len(".json")]
            if replica == self.replica:
                continue
            try:
                with open(
                    os.path.join(self.heartbeat_dir, name), encoding="utf-8"
                ) as f:
                    doc = json.load(f)
                ages[replica] = now - float(doc["unix"])
            except (OSError, json.JSONDecodeError, KeyError, TypeError,
                    ValueError):
                continue
        return [
            {
                "id": replica,
                "age_seconds": age,
                "alive": age <= horizon,
            }
            for replica, age in sorted(ages.items())
        ]

    def alive_count(self, stale_after: Optional[float] = None) -> int:
        """Replicas currently heartbeating, self included."""
        return 1 + sum(
            1 for p in self.peers(stale_after=stale_after) if p["alive"]
        )


# ------------------------------------------------------- run-dir guard


class RunDirBusy(RuntimeError):
    """Another daemon owns (part of) this run directory; see
    :func:`acquire_run_dir_lock`. The CLI maps this to exit 2."""


class RunDirLock:
    """Held ``flock`` descriptors for one daemon's run-dir claim."""

    def __init__(self, fds: List[int]):
        self._fds = fds

    def release(self) -> None:
        fds, self._fds = self._fds, []
        for fd in fds:
            try:
                os.close(fd)  # closing drops the flock
            except OSError:
                pass


def acquire_run_dir_lock(
    run_dir: str, replica_id: Optional[str] = None
) -> RunDirLock:
    """Claim a service run dir, or raise :class:`RunDirBusy`.

    A solo daemon (no replica id) holds ``serve.lock`` EXCLUSIVELY: a
    second daemon pointed at the same ``--run-dir`` without
    ``--replica-id`` is refused instead of silently corrupting the
    journal. Replicas hold ``serve.lock`` SHARED (they coexist by
    design, but conflict with a solo daemon in either order) plus an
    exclusive per-replica ``serve.<id>.lock`` so a duplicated replica id
    — two daemons claiming the same identity, epochs and heartbeats
    colliding — is refused too."""
    os.makedirs(run_dir, exist_ok=True)
    fds: List[int] = []

    def _locked(basename: str, operation: int, message: str) -> None:
        fd = os.open(
            os.path.join(run_dir, basename), os.O_CREAT | os.O_RDWR, 0o644
        )
        try:
            fcntl.flock(fd, operation | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            for held in fds:
                os.close(held)
            raise RunDirBusy(message) from None
        fds.append(fd)

    if replica_id is None:
        _locked(
            RUN_DIR_LOCK_BASENAME,
            fcntl.LOCK_EX,
            f"run dir {run_dir!r} is already owned by another daemon; a "
            "second daemon on the same --run-dir would corrupt the job "
            "journal — to run multiple replicas against one run dir, "
            "give each a distinct --replica-id",
        )
    else:
        _locked(
            RUN_DIR_LOCK_BASENAME,
            fcntl.LOCK_SH,
            f"run dir {run_dir!r} is owned exclusively by a daemon "
            "running without --replica-id; stop it (or move it to a "
            "replica id) before attaching replicas",
        )
        _locked(
            f"serve.{replica_id}.lock",
            fcntl.LOCK_EX,
            f"replica id {replica_id!r} is already running against run "
            f"dir {run_dir!r}; every replica needs a distinct "
            "--replica-id",
        )
    return RunDirLock(fds)


__all__ = [
    "DEFAULT_LEASE_SECONDS",
    "HEARTBEAT_DIRNAME",
    "JOURNAL_BASENAME",
    "JOURNAL_LOCK_SUFFIX",
    "LEASE_DIRNAME",
    "RUN_DIR_LOCK_BASENAME",
    "JobJournal",
    "LeaseStore",
    "LeaseView",
    "PendingJob",
    "RunDirBusy",
    "RunDirLock",
    "accepted_record",
    "acquire_run_dir_lock",
    "adoption_action",
    "arbitrate_claim",
    "began_record",
    "compact_journal",
    "compact_journal_shared",
    "compacted_records",
    "fold_records",
    "foreign_expired",
    "iter_journal_records",
    "journal_path",
    "lease_record",
    "owner_valid",
    "protocol_summary",
    "replay_journal",
    "revalidate_pending",
    "stamped_record",
    "steal_candidates",
    "terminal_fsync",
    "terminal_record",
]
