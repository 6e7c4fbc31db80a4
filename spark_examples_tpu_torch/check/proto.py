"""graftcheck proto — exhaustive model checking of the replica
coordination protocol, with the shipped fold as the oracle.

The port's copy of ``spark_examples_tpu/check/proto.py``: the same model,
bounds, mutations and report, with the port's ``serve/journal.py`` (a copy
of the reference's, record for record) as the oracle and the port's
``utils/faults.py`` kill points as GP006's ground truth. So at the same
bounds both packages explore the same states and report the same verdicts.

An explicit-state model checker over the N-replica, crash-anywhere
state space of the serve-tier coordination protocol (shared fsync'd
journal + epoch-fenced lease files, ``serve/journal.py``). The crucial
property: every protocol DECISION in the model is made by the SHIPPED
code — :func:`~spark_examples_tpu_torch.serve.journal.fold_records`,
:func:`~spark_examples_tpu_torch.serve.journal.arbitrate_claim`,
:func:`~spark_examples_tpu_torch.serve.journal.owner_valid`,
:func:`~spark_examples_tpu_torch.serve.journal.revalidate_pending`,
:func:`~spark_examples_tpu_torch.serve.journal.adoption_action`,
:func:`~spark_examples_tpu_torch.serve.journal.steal_candidates`,
:func:`~spark_examples_tpu_torch.serve.journal.compacted_records` — run
unchanged against an in-memory journal/lease model. Only the file
primitives (append, fsync, link, unlink, crash) are modeled, so what
the checker proves is what the fleet ships.

The model, in brief:

- **Journal** — an append-ordered tuple of compact records, expanded
  through the shipped record constructors before every oracle call. An
  fsync'd append makes EVERY earlier record durable (page-cache
  semantics); the non-durable tail is exactly the records
  :func:`~spark_examples_tpu_torch.serve.journal.terminal_fsync` says may
  skip fsync. Crashes come in two flavors: a PROCESS crash erases one
  replica's memory and loses nothing (a dead process's page cache is
  still the OS's to flush), while a HOST crash kills every replica at
  once and branches over every prefix of the non-durable tail
  surviving — the only record-dropping transition, because a live peer
  observing a page-cache rollback is not physically realizable.
- **Leases** — one view per job: ``(replica, epoch, age)`` with a
  three-point abstract clock: ``live`` (unexpired), ``lapsed``
  (expired, within the grace window) and ``stale`` (expired past
  grace). Ages are concretized to ``expires_unix`` values just before
  each oracle call, so the shipped arbitration sees real numbers.
  Aging steps consume the ``stalls`` budget.
- **Replicas** — each holds in-memory jobs as ``(phase, epoch)``:
  ``accepted → claimed → queued → running → published`` (submit path),
  or ``adopting``/``stealing`` on the recovery paths. A crash erases
  memory; the journal and lease files survive.

Timing assumption (documented, load-bearing): the ownership fence and
the action it guards (begin dispatch, result publication) are atomic —
a replica cannot stall between checking :func:`owner_valid` and acting.
The one window deliberately left OPEN is publish → terminal-append: the
terminal write is unguarded, which is precisely the zombie window the
fold's epoch fencing exists to absorb. Clean runs therefore DO reach
fenced terminals — the fencing is exercised, not assumed.

Invariants (rule catalogue in ``check/rules.py:PROTO_RULES``):

- **GP001** double-effective-terminal (or two replicas publishing one
  job's result);
- **GP002** device-began re-execution (requeue-once violated);
- **GP003** accepted-and-acked job lost (no record, no memory, nobody
  will ever settle it);
- **GP004** a journaled lease record re-issues the highest journaled
  epoch under a different replica (fencing ambiguous);
- **GP005** successful steal of a live / within-grace lease;
- **GP006** reachable crash window with no registered
  ``utils/faults.py`` kill-point (the chaos matrix could never
  rehearse it).

Symmetry reduction canonicalizes each state as the minimum over all
replica and job renamings, so the declared bounds (replicas <= 3,
jobs <= 2, crash budget <= 2) stay explorable on CPU.

The mutation harness (:data:`MUTATIONS`) re-runs the exploration with
single-decision bugs planted in the model's use of the oracles —
fencing skipped, fold epoch-blind, steals graceless, the min-epoch
guard dropped — and requires each to trip its matching GP rule: the
checker is itself checked. Mutation runs stop at the first expected
finding (a witness is a witness); only the clean run must drain the
frontier.

The submit path's ``revalidate_pending`` fence (``serve/daemon.py:
submit``) closes a race this checker finds without it (the
``skip-submit-revalidate`` mutation): an accepter that stalls after its
lease claim while a restarting peer adopts and settles the job would
re-enqueue and re-run it.
"""

from __future__ import annotations

import itertools
import json
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

from spark_examples_tpu_torch.check.rules import Finding
from spark_examples_tpu_torch.serve.journal import (
    LeaseView,
    PendingJob,
    accepted_record,
    adoption_action,
    arbitrate_claim,
    began_record,
    compacted_records,
    fold_records,
    foreign_expired,
    lease_record,
    owner_valid,
    protocol_summary,
    revalidate_pending,
    steal_candidates,
    terminal_fsync,
    terminal_record,
)
from spark_examples_tpu_torch.utils.faults import registered_kill_points

__all__ = [
    "MODEL_PATH",
    "Mutations",
    "Mutation",
    "MutationOutcome",
    "MUTATIONS",
    "ProtoReport",
    "check_protocol",
    "run_mutation_harness",
]


#: Finding anchor: GP findings attach to a witness trace, not a source
#: line, so their path names the model and their line is 0.
MODEL_PATH = "proto:replica-coordination"

#: The abstract clock, concretized at every oracle call. NOW never
#: advances — lease AGE carries all timing truth.
_NOW = 0.0
_GRACE = 10.0
_EXPIRES: Dict[str, float] = {"live": 100.0, "lapsed": -5.0, "stale": -100.0}
_NEXT_AGE: Dict[str, str] = {"live": "lapsed", "lapsed": "stale"}

#: Token-safe names (no name matches the fold's ``job-`` sequence
#: grammar) so symmetry renaming is a per-field substitution.
_REPLICA_NAMES = ("repA", "repB", "repC")
_JOB_NAMES = ("jobA", "jobB")

#: In-memory phase -> the registered kill-point that must cover a crash
#: there (GP006's ground truth).
_PHASE_WINDOW: Dict[str, str] = {
    "accepted": "serve.submit.post-accept",
    "claimed": "serve.lease.post-claim",
    "adopting": "serve.lease.post-claim",
    "stealing": "serve.lease.post-claim",
    "queued": "serve.worker.claim",
    "running": "serve.worker.mid-job",
    "published": "serve.worker.mid-job",
}


@dataclass(frozen=True)
class Mutations:
    """Single-decision bugs planted into the model's USE of the shipped
    oracles — each field corresponds to deleting or lobotomizing one
    line of the real protocol. All ``False`` = the shipped protocol."""

    #: begin/publish skip the :func:`owner_valid` fence.
    skip_owner_fence: bool = False
    #: the fold ignores terminal epochs (fencing lobotomized).
    epoch_blind_fold: bool = False
    #: the fold ignores ``began`` records (requeue-once lobotomized).
    began_blind_fold: bool = False
    #: steals use grace 0 (the asymmetric window deleted).
    graceless_steal: bool = False
    #: claims pass ``min_epoch=0`` (the stale-fold guard deleted).
    skip_min_epoch: bool = False
    #: submit skips the post-claim ``revalidate_pending`` fence (the
    #: race the checker originally FOUND in the shipped submit path).
    skip_submit_revalidate: bool = False
    #: compaction skips the inode re-check: concurrent appenders keep
    #: writing the replaced file and their records vanish.
    skip_inode_recheck: bool = False
    #: ``serve.lease.post-claim`` deleted from the kill-point registry.
    unregistered_crash_site: bool = False


#: Compact journal records — expanded via the shipped constructors at
#: oracle time (see ``_Explorer._to_dict``):
#:   ("accepted", job, replica)
#:   ("began",    job, replica, epoch)
#:   ("lease",    job, replica, epoch, stolen)
#:   ("terminal", job, replica, epoch, status)
_Rec = Tuple[Any, ...]

#: One replica's in-memory jobs: (job, phase, epoch), sorted.
_Jobs = Tuple[Tuple[str, str, int], ...]


@dataclass(frozen=True, slots=True)
class _State:
    """One explored protocol state. Collections are sorted tuples so
    renaming + re-sorting yields a canonical form (the journal alone
    keeps append order — order IS its meaning)."""

    journal: Tuple[_Rec, ...]
    #: Prefix length of ``journal`` known durable.
    durable: int
    #: (job, replica, epoch, age) — at most one lease view per job.
    leases: Tuple[Tuple[str, str, int, str], ...]
    #: (name, alive, jobs) per replica.
    replicas: Tuple[Tuple[str, bool, _Jobs], ...]
    unsubmitted: Tuple[str, ...]
    #: Jobs whose 202 went out (after the accepted fsync).
    acked: Tuple[str, ...]
    #: Jobs compaction dropped as settled (their records are GONE from
    #: the journal by design — GP003 must not count them as lost).
    settled_compacted: Tuple[str, ...]
    #: Jobs whose ``began`` record was ever fsync'd (GP002's raw truth,
    #: immune to fold mutations and compaction).
    began_ever: Tuple[str, ...]
    #: (job, replica) result publications ever made (GP001's raw truth).
    published_by: Tuple[Tuple[str, str], ...]
    #: Replicas holding a stale journal fd (skip_inode_recheck only).
    stale: Tuple[str, ...]
    crashes: int
    stalls: int


def _add(items: Tuple[str, ...], item: str) -> Tuple[str, ...]:
    return items if item in items else tuple(sorted(items + (item,)))


def _drop(items: Tuple[str, ...], item: str) -> Tuple[str, ...]:
    return tuple(i for i in items if i != item)


@dataclass
class ProtoReport:
    """The ``graftcheck proto`` result: declared bounds, exploration
    counts, and every invariant finding with its witness trace."""

    bounds: Dict[str, int]
    states: int
    transitions: int
    elapsed_seconds: float
    #: True iff the frontier drained within ``max_states``.
    exhausted: bool
    findings: List[Finding]
    #: Every crash window the model reached, and the uncovered subset.
    crash_windows: List[str]
    uncovered_windows: List[str]

    @property
    def ok(self) -> bool:
        return self.exhausted and not self.findings

    def to_json(self) -> str:
        return json.dumps(
            {
                "tool": "graftcheck-proto",
                "ok": self.ok,
                "bounds": dict(self.bounds),
                "states": self.states,
                "transitions": self.transitions,
                "elapsed_seconds": round(self.elapsed_seconds, 3),
                "exhausted": self.exhausted,
                "crash_windows": list(self.crash_windows),
                "uncovered_windows": list(self.uncovered_windows),
                "findings": [f.to_json() for f in self.findings],
            },
            indent=2,
        )

    def format(self) -> str:
        bounds = ", ".join(f"{k}={v}" for k, v in sorted(self.bounds.items()))
        lines = [
            f"graftcheck proto: bounds [{bounds}]",
            (
                f"explored {self.states} state(s), {self.transitions} "
                f"transition(s) in {self.elapsed_seconds:.2f}s "
                f"({'exhaustive' if self.exhausted else 'stopped early'})"
            ),
            (
                f"crash windows reached: "
                f"{', '.join(self.crash_windows) or '(none)'}"
            ),
        ]
        for finding in self.findings:
            lines.append(finding.format())
        lines.append(
            "clean: every reachable state satisfies GP001-GP006"
            if self.ok
            else f"{len(self.findings)} protocol finding(s)"
        )
        return "\n".join(lines)


def _journal_sort_key(rec: _Rec) -> str:
    """Canonical journal order groups records by job id only: stable
    sort, so the per-job subsequence (the order the fold can actually
    distinguish) is preserved verbatim."""
    return str(rec[1])


class _Explorer:
    """BFS over the protocol state space with symmetry reduction."""

    def __init__(
        self,
        replicas: int,
        jobs: int,
        crashes: int,
        stalls: int,
        mutations: Mutations,
        max_states: int,
        stop_on_rule: Optional[str] = None,
    ) -> None:
        if not 1 <= replicas <= len(_REPLICA_NAMES):
            raise ValueError(f"replicas must be 1..3, got {replicas}")
        if not 1 <= jobs <= len(_JOB_NAMES):
            raise ValueError(f"jobs must be 1..2, got {jobs}")
        self.replica_names = _REPLICA_NAMES[:replicas]
        self.job_names = _JOB_NAMES[:jobs]
        self.bounds = {
            "replicas": replicas,
            "jobs": jobs,
            "crashes": crashes,
            "stalls": stalls,
        }
        self.mut = mutations
        self.max_states = max_states
        self.stop_on_rule = stop_on_rule
        self._stop = False
        registry = registered_kill_points()
        if mutations.unregistered_crash_site:
            registry.pop("serve.lease.post-claim", None)
        self.registry = registry
        self.crash_windows: Set[str] = set()
        self.uncovered: Set[str] = set()
        self.states = 0
        self.transitions = 0
        self.exhausted = False
        #: identity permutations, precomputed once.
        self._perms = [
            dict(zip(self.replica_names + self.job_names, rperm + jperm))
            for rperm in itertools.permutations(self.replica_names)
            for jperm in itertools.permutations(self.job_names)
        ]
        #: canonical key -> (parent key, transition label)
        self._parent: Dict[Any, Tuple[Any, str]] = {}
        self._findings: Dict[Tuple[str, str], Finding] = {}
        self._dict_cache: Dict[_Rec, Dict[str, Any]] = {}
        self._fold_cache: Dict[
            Tuple[_Rec, ...], Tuple[List[PendingJob], int]
        ] = {}
        self._summary_cache: Dict[Tuple[_Rec, ...], Dict[str, Any]] = {}
        self._canon_cache: Dict[_State, Any] = {}

    # ---------------------------------------------------- oracle plumbing

    def _to_dict(self, rec: _Rec) -> Dict[str, Any]:
        """Expand a compact record through the SHIPPED constructor —
        the oracles only ever see real journal records."""
        cached = self._dict_cache.get(rec)
        if cached is not None:
            return cached
        kind = rec[0]
        if kind == "accepted":
            record = accepted_record(
                rec[1], {"payload": rec[1]}, "default", 0.0, None,
                replica=rec[2],
            )
        elif kind == "began":
            record = began_record(rec[1], replica=rec[2], epoch=rec[3])
        elif kind == "lease":
            record = lease_record(
                rec[1], rec[3], replica=rec[2], stolen=bool(rec[4])
            )
        else:
            record = terminal_record(
                rec[1], rec[4], replica=rec[2], epoch=rec[3]
            )
        self._dict_cache[rec] = record
        return record

    @staticmethod
    def _from_dict(record: Dict[str, Any]) -> _Rec:
        """Re-compact a record emitted by the shipped
        :func:`compacted_records` rewrite."""
        event = record["event"]
        job = record["id"]
        rep = record.get("replica")
        epoch = record.get("epoch")
        if event == "accepted":
            return ("accepted", job, rep)
        if event == "began":
            return ("began", job, rep, epoch)
        if event == "lease":
            return ("lease", job, rep, epoch, bool(record.get("stolen")))
        return ("terminal", job, rep, epoch, record.get("status"))

    def _fold_input(
        self, journal: Tuple[_Rec, ...]
    ) -> List[Dict[str, Any]]:
        """Records as the (possibly mutated) fold sees them. The
        epoch-blind mutation strips terminal epochs — the one-line
        equivalent of ``effective()`` returning True; the began-blind
        mutation drops ``began`` records — ``adoption_action`` never
        sees device work."""
        records = []
        for rec in journal:
            if self.mut.began_blind_fold and rec[0] == "began":
                continue
            if self.mut.epoch_blind_fold and rec[0] == "terminal":
                rec = ("terminal", rec[1], rec[2], None, rec[4])
            records.append(self._to_dict(rec))
        return records

    def _fold(
        self, journal: Tuple[_Rec, ...]
    ) -> Tuple[List[PendingJob], int]:
        cached = self._fold_cache.get(journal)
        if cached is None:
            cached = fold_records(self._fold_input(journal))
            self._fold_cache[journal] = cached
        return cached

    def _summary(self, journal: Tuple[_Rec, ...]) -> Dict[str, Any]:
        cached = self._summary_cache.get(journal)
        if cached is None:
            cached = protocol_summary(self._fold_input(journal))
            self._summary_cache[journal] = cached
        return cached

    def _lease_of(
        self, st: _State, job: str
    ) -> Optional[Tuple[str, str, int, str]]:
        for entry in st.leases:
            if entry[0] == job:
                return entry
        return None

    def _view(self, st: _State, job: str) -> Optional[LeaseView]:
        """Concretize the abstract lease age into the LeaseView the
        shipped arbitration reads."""
        entry = self._lease_of(st, job)
        if entry is None:
            return None
        return LeaseView(
            job_id=job, replica=entry[1], epoch=entry[2],
            expires_unix=_EXPIRES[entry[3]],
        )

    def _min_lease(
        self, pending: List[PendingJob], job: str
    ) -> Tuple[int, Optional[str]]:
        """The folded (min_epoch, min_replica) fencing facts the shipped
        claim paths pass to :func:`arbitrate_claim`."""
        if self.mut.skip_min_epoch:
            return 0, None
        for record in pending:
            if record.job_id == job:
                return record.lease_epoch, record.lease_replica
        return 0, None

    # ------------------------------------------------------ state surgery

    def _set_job(
        self, st: _State, name: str, job: str, phase: str, epoch: int
    ) -> Tuple[Tuple[str, bool, _Jobs], ...]:
        out = []
        for rname, alive, jobs in st.replicas:
            if rname == name:
                kept = tuple(j for j in jobs if j[0] != job)
                jobs = tuple(sorted(kept + ((job, phase, epoch),)))
            out.append((rname, alive, jobs))
        return tuple(out)

    def _drop_job(
        self, st: _State, name: str, job: str
    ) -> Tuple[Tuple[str, bool, _Jobs], ...]:
        return tuple(
            (
                rname,
                alive,
                tuple(j for j in jobs if j[0] != job)
                if rname == name
                else jobs,
            )
            for rname, alive, jobs in st.replicas
        )

    def _set_alive(
        self, st: _State, name: str, alive: bool
    ) -> Tuple[Tuple[str, bool, _Jobs], ...]:
        return tuple(
            (
                rname,
                alive if rname == name else ralive,
                () if rname == name else jobs,
            )
            for rname, ralive, jobs in st.replicas
        )

    def _set_lease(
        self, st: _State, job: str, rep: str, epoch: int, age: str
    ) -> Tuple[Tuple[str, str, int, str], ...]:
        kept = tuple(entry for entry in st.leases if entry[0] != job)
        return tuple(sorted(kept + ((job, rep, epoch, age),)))

    def _release_lease(
        self, st: _State, job: str, rep: str, epoch: int
    ) -> Tuple[Tuple[str, str, int, str], ...]:
        """Unlink our own lease file — a foreign or re-claimed lease is
        left alone (epoch-named files make the unlink self-owned)."""
        return tuple(
            entry
            for entry in st.leases
            if not (entry[0] == job and entry[1] == rep and entry[2] == epoch)
        )

    def _append(
        self,
        journal: Tuple[_Rec, ...],
        durable: int,
        rec: _Rec,
        fsync: bool,
        writer: str,
        stale: Tuple[str, ...],
    ) -> Tuple[Tuple[_Rec, ...], int]:
        """Append a record. A writer holding a stale fd (inode-recheck
        mutation) writes into the void; an fsync'd append makes the
        whole file durable."""
        if writer in stale:
            return journal, durable
        journal = journal + (rec,)
        return journal, len(journal) if fsync else durable

    def _mem(self, st: _State) -> Set[str]:
        return {
            job
            for _name, _alive, jobs in st.replicas
            for job, _phase, _epoch in jobs
        }

    # ------------------------------------------------------- transitions

    _Trans = Tuple[str, "_State", List[Tuple[str, str]]]

    def _transitions(self, st: _State) -> Iterator[_Trans]:
        for name, alive, jobs in st.replicas:
            if not alive:
                yield (
                    f"restart:{name}",
                    replace(st, replicas=self._set_alive(st, name, True)),
                    [],
                )
                continue
            yield from self._submit_transitions(st, name)
            for job, phase, epoch in jobs:
                yield from self._job_transitions(st, name, job, phase, epoch)
            yield from self._recovery_transitions(st, name, jobs)
            yield from self._compact_transition(st, name)
            yield from self._crash_transitions(st, name, jobs)
        yield from self._host_crash_transitions(st)
        if st.stalls > 0:
            for job, rep, epoch, age in st.leases:
                nage = _NEXT_AGE.get(age)
                if nage is None:
                    continue
                yield (
                    f"age:{job}:{nage}",
                    replace(
                        st,
                        stalls=st.stalls - 1,
                        leases=self._set_lease(st, job, rep, epoch, nage),
                    ),
                    [],
                )

    def _submit_transitions(self, st: _State, name: str) -> Iterator[_Trans]:
        for job in st.unsubmitted:
            journal, durable = self._append(
                st.journal, st.durable, ("accepted", job, name), True,
                name, st.stale,
            )
            yield (
                f"submit:{name}:{job}",
                replace(
                    st,
                    journal=journal,
                    durable=durable,
                    unsubmitted=_drop(st.unsubmitted, job),
                    acked=_add(st.acked, job),
                    replicas=self._set_job(st, name, job, "accepted", 0),
                ),
                [],
            )

    def _job_transitions(
        self, st: _State, name: str, job: str, phase: str, epoch: int
    ) -> Iterator[_Trans]:
        if phase == "accepted":
            pending, _seq = self._fold(st.journal)
            min_epoch, min_replica = self._min_lease(pending, job)
            action, e = arbitrate_claim(
                self._view(st, job),
                name,
                _NOW,
                _GRACE,
                steal=False,
                min_epoch=min_epoch,
                min_replica=min_replica,
            )
            if action == "deny":
                # Someone else claimed it meanwhile: the 202 is out and
                # the journal is durable — leave the job to its owner.
                yield (
                    f"claim-deny:{name}:{job}",
                    replace(st, replicas=self._drop_job(st, name, job)),
                    [],
                )
                return
            leases = (
                st.leases
                if action == "adopt"
                else self._set_lease(st, job, name, e, "live")
            )
            yield (
                f"claim:{name}:{job}:e{e}",
                replace(
                    st,
                    leases=leases,
                    replicas=self._set_job(st, name, job, "claimed", e),
                ),
                [],
            )
        elif phase in ("claimed", "adopting", "stealing"):
            yield from self._lease_journal_transition(
                st, name, job, phase, epoch
            )
        elif phase == "queued":
            fenced = self.mut.skip_owner_fence or owner_valid(
                self._view(st, job), name, epoch, _NOW
            )
            if not fenced:
                yield (
                    f"abandon:{name}:{job}",
                    replace(st, replicas=self._drop_job(st, name, job)),
                    [],
                )
                return
            finds: List[Tuple[str, str]] = []
            if job in st.began_ever:
                finds.append(
                    (
                        "GP002",
                        f"{job} begins device work a second time on "
                        f"{name}: its journaled `began` record did not "
                        f"stop re-execution",
                    )
                )
            journal, durable = self._append(
                st.journal, st.durable, ("began", job, name, epoch), True,
                name, st.stale,
            )
            yield (
                f"begin:{name}:{job}",
                replace(
                    st,
                    journal=journal,
                    durable=durable,
                    began_ever=_add(st.began_ever, job),
                    replicas=self._set_job(st, name, job, "running", epoch),
                ),
                finds,
            )
        elif phase == "running":
            fenced = self.mut.skip_owner_fence or owner_valid(
                self._view(st, job), name, epoch, _NOW
            )
            if not fenced:
                yield (
                    f"abandon:{name}:{job}",
                    replace(st, replicas=self._drop_job(st, name, job)),
                    [],
                )
                return
            finds = []
            other = sorted(
                rep for j, rep in st.published_by if j == job and rep != name
            )
            if other:
                finds.append(
                    (
                        "GP001",
                        f"{job} result published by both {other[0]} and "
                        f"{name}",
                    )
                )
            yield (
                f"publish:{name}:{job}",
                replace(
                    st,
                    published_by=tuple(
                        sorted(set(st.published_by) | {(job, name)})
                    ),
                    replicas=self._set_job(st, name, job, "published", epoch),
                ),
                finds,
            )
        elif phase == "published":
            # The zombie window: the terminal append is UNGUARDED —
            # fold fencing, not a fence check, must absorb a deposed
            # owner's late terminal.
            journal, durable = self._append(
                st.journal,
                st.durable,
                ("terminal", job, name, epoch, "done"),
                terminal_fsync("done"),
                name,
                st.stale,
            )
            yield (
                f"settle:{name}:{job}",
                replace(
                    st,
                    journal=journal,
                    durable=durable,
                    leases=self._release_lease(st, job, name, epoch),
                    replicas=self._drop_job(st, name, job),
                ),
                [],
            )

    def _gp004(
        self, st: _State, job: str, epoch: int, name: str
    ) -> List[Tuple[str, str]]:
        """A lease append that RE-ISSUES the highest already-journaled
        epoch under a different replica breaks fencing (the fold cannot
        order same-epoch writers). A lower-than-max append is a stale
        straggler the max-fold absorbs; an equal-epoch re-journal by
        the SAME replica is the legitimate adopt path."""
        max_epoch, max_rep = 0, None
        for rec in st.journal:
            if rec[0] == "lease" and rec[1] == job:
                e = rec[3]
                if isinstance(e, int) and e >= max_epoch:
                    max_epoch, max_rep = e, rec[2]
        if (
            max_epoch > 0
            and epoch == max_epoch
            and max_rep is not None
            and max_rep != name
        ):
            return [
                (
                    "GP004",
                    f"lease record for {job} journaled at epoch {epoch} "
                    f"by {name} re-issues the epoch already journaled by "
                    f"{max_rep}: fencing cannot order their writes",
                )
            ]
        return []

    def _lease_journal_transition(
        self, st: _State, name: str, job: str, phase: str, epoch: int
    ) -> Iterator[_Trans]:
        if phase == "claimed" and not self.mut.skip_submit_revalidate:
            # The submit-path stale-fold fence (shipped in
            # serve/daemon.py:submit; this checker's first clean run is
            # what found it missing): between the accepted append and
            # the lease claim the accepter may have stalled while a
            # restarting peer adopted AND settled the job — re-fold
            # before journaling the lease and enqueueing.
            pending, _seq = self._fold(st.journal)
            if revalidate_pending(pending, job, epoch) is None:
                yield (
                    f"claim-release:{name}:{job}",
                    replace(
                        st,
                        leases=self._release_lease(st, job, name, epoch),
                        replicas=self._drop_job(st, name, job),
                    ),
                    [],
                )
                return
        finds = self._gp004(st, job, epoch, name)
        journal, durable = self._append(
            st.journal,
            st.durable,
            ("lease", job, name, epoch, phase == "stealing"),
            True,
            name,
            st.stale,
        )
        base = replace(st, journal=journal, durable=durable)
        if phase == "claimed":
            yield (
                f"journal-lease:{name}:{job}",
                replace(
                    base,
                    replicas=self._set_job(base, name, job, "queued", epoch),
                ),
                finds,
            )
            return
        # Adopt/steal paths revalidate against a FRESH fold after the
        # claim (the shipped stale-fold fence), then act per
        # adoption_action.
        pending, _seq = self._fold(base.journal)
        record = revalidate_pending(pending, job, epoch)
        if record is None:
            yield (
                f"adopt-release:{name}:{job}",
                replace(
                    base,
                    leases=self._release_lease(base, job, name, epoch),
                    replicas=self._drop_job(base, name, job),
                ),
                finds,
            )
        elif adoption_action(record.device_began) == "fail":
            journal2, durable2 = self._append(
                base.journal,
                base.durable,
                ("terminal", job, name, epoch, "failed"),
                terminal_fsync("failed"),
                name,
                base.stale,
            )
            yield (
                f"adopt-fail:{name}:{job}",
                replace(
                    base,
                    journal=journal2,
                    durable=durable2,
                    leases=self._release_lease(base, job, name, epoch),
                    replicas=self._drop_job(base, name, job),
                ),
                finds,
            )
        else:
            yield (
                f"adopt-requeue:{name}:{job}",
                replace(
                    base,
                    replicas=self._set_job(base, name, job, "queued", epoch),
                ),
                finds,
            )

    def _recovery_transitions(
        self, st: _State, name: str, jobs: _Jobs
    ) -> Iterator[_Trans]:
        mine = {job for job, _phase, _epoch in jobs}
        pending, _seq = self._fold(st.journal)
        # Replay-anytime adoption: a restart may fold the journal at any
        # moment, so adoption is gated only by the shipped arbitration.
        for record in pending:
            job = record.job_id
            if job in mine:
                continue
            min_epoch, min_replica = self._min_lease(pending, job)
            action, e = arbitrate_claim(
                self._view(st, job),
                name,
                _NOW,
                _GRACE,
                steal=False,
                min_epoch=min_epoch,
                min_replica=min_replica,
            )
            if action == "deny":
                continue
            leases = (
                st.leases
                if action == "adopt"
                else self._set_lease(st, job, name, e, "live")
            )
            yield (
                f"adopt:{name}:{job}:e{e}",
                replace(
                    st,
                    leases=leases,
                    replicas=self._set_job(st, name, job, "adopting", e),
                ),
                [],
            )
        # Steal scan: candidates from the SHIPPED selector over the
        # shipped expiry predicate.
        grace = 0.0 if self.mut.graceless_steal else _GRACE
        alive_peers = {
            rname
            for rname, ralive, _jobs in st.replicas
            if ralive and rname != name
        }
        expired = set()
        for job, rep, epoch, age in st.leases:
            view = LeaseView(
                job_id=job, replica=rep, epoch=epoch,
                expires_unix=_EXPIRES[age],
            )
            if foreign_expired(view, name, _NOW, grace):
                expired.add(job)
        lease_jobs = {entry[0] for entry in st.leases}
        present: Callable[[str], bool] = lambda job_id: job_id in lease_jobs
        for record in steal_candidates(
            pending, expired, name, alive_peers, present
        ):
            job = record.job_id
            if job in mine:
                continue
            min_epoch, min_replica = self._min_lease(pending, job)
            action, e = arbitrate_claim(
                self._view(st, job),
                name,
                _NOW,
                grace,
                steal=True,
                min_epoch=min_epoch,
                min_replica=min_replica,
            )
            if action != "claim":
                continue
            finds: List[Tuple[str, str]] = []
            entry = self._lease_of(st, job)
            if entry is not None and entry[3] in ("live", "lapsed"):
                finds.append(
                    (
                        "GP005",
                        f"{name} steals {job} from {entry[1]} whose lease "
                        f"is {entry[3]} (not yet expired past grace): "
                        f"owner and stealer can run concurrently",
                    )
                )
            yield (
                f"steal:{name}:{job}:e{e}",
                replace(
                    st,
                    leases=self._set_lease(st, job, name, e, "live"),
                    replicas=self._set_job(st, name, job, "stealing", e),
                ),
                finds,
            )

    def _compact_transition(self, st: _State, name: str) -> Iterator[_Trans]:
        pending, _seq = self._fold(st.journal)
        compacted = tuple(
            self._from_dict(r) for r in compacted_records(pending)
        )
        if compacted == st.journal:
            return
        summary = self._summary(st.journal)
        settled = st.settled_compacted
        for job, info in summary["jobs"].items():
            if info["settled"]:
                settled = _add(settled, job)
        stale = st.stale
        if self.mut.skip_inode_recheck:
            # The bug: concurrent appenders never learn the file was
            # replaced — their fds now point at the unlinked inode.
            for rname, ralive, _jobs in st.replicas:
                if ralive and rname != name:
                    stale = _add(stale, rname)
        yield (
            f"compact:{name}",
            replace(
                st,
                journal=compacted,
                durable=len(compacted),
                settled_compacted=settled,
                stale=stale,
            ),
            [],
        )

    def _crash_transitions(
        self, st: _State, name: str, jobs: _Jobs
    ) -> Iterator[_Trans]:
        """A PROCESS crash: this replica's memory is gone, but the
        journal is untouched — a dead process loses no page cache; the
        OS still writes it. Suffix loss is a HOST crash
        (:meth:`_host_crash_transitions`), which kills everyone."""
        if st.crashes <= 0:
            return
        finds: List[Tuple[str, str]] = []
        for window in sorted({_PHASE_WINDOW[p] for _job, p, _e in jobs}):
            self.crash_windows.add(window)
            if window not in self.registry:
                self.uncovered.add(window)
                finds.append(
                    (
                        "GP006",
                        f"model-reachable crash in window `{window}` has "
                        f"no registered utils/faults.py kill-point: the "
                        f"chaos matrix cannot rehearse it",
                    )
                )
        yield (
            f"crash:{name}",
            replace(
                st,
                crashes=st.crashes - 1,
                stale=_drop(st.stale, name),
                replicas=self._set_alive(st, name, False),
            ),
            finds,
        )

    def _host_crash_transitions(self, st: _State) -> Iterator[_Trans]:
        """A HOST (power) crash: every replica dies at once AND part of
        the non-durable journal tail may be lost. This is the only
        transition that drops records — a surviving peer observing a
        page-cache rollback is not physically realizable, and modeling
        it would report phantom protocol violations.

        Loss branches over every combination of per-JOB prefixes of
        the tail, not append-order prefixes: page-cache writeback need
        not respect the cross-job append interleaving, and per-job
        prefixes are exactly the granularity the fold can distinguish.
        (This also makes the branch set independent of the
        interleaving, which is what licenses the canonical journal
        ordering in :meth:`_canon`.)"""
        if st.crashes <= 0:
            return
        dead = tuple((name, False, ()) for name, _alive, _jobs in st.replicas)
        tail = st.journal[st.durable :]
        per_job: Dict[str, int] = {}
        for rec in tail:
            per_job[str(rec[1])] = per_job.get(str(rec[1]), 0) + 1
        jobs_in_tail = sorted(per_job)
        for keeps in itertools.product(
            *(range(per_job[j] + 1) for j in jobs_in_tail)
        ):
            budget = dict(zip(jobs_in_tail, keeps))
            kept: List[_Rec] = []
            for rec in tail:
                if budget[str(rec[1])] > 0:
                    budget[str(rec[1])] -= 1
                    kept.append(rec)
            journal = st.journal[: st.durable] + tuple(kept)
            label = "crash:host:keep(%s)" % ",".join(
                f"{j}:{k}" for j, k in zip(jobs_in_tail, keeps)
            )
            yield (
                label,
                replace(
                    st,
                    journal=journal,
                    durable=len(journal),
                    crashes=st.crashes - 1,
                    stale=(),
                    replicas=dead,
                ),
                [],
            )

    # --------------------------------------------------------- detectors

    def _check_state(self, st: _State, key: Any) -> None:
        summary = self._summary(st.journal)
        for job, info in summary["jobs"].items():
            effective = sum(1 for t in info["terminals"] if t["effective"])
            if effective >= 2:
                self._record_finding(
                    "GP001",
                    f"{job} reaches {effective} terminal records that all "
                    f"survive fold fencing",
                    key,
                    None,
                )
        mem = self._mem(st)
        journal_ids = {rec[1] for rec in st.journal}
        for job in st.acked:
            if (
                job in mem
                or job in journal_ids
                or job in st.settled_compacted
            ):
                continue
            self._record_finding(
                "GP003",
                f"{job} was acknowledged (202 after the accepted fsync) "
                f"but no journal record, no replica memory and no settled "
                f"outcome remains: nobody will ever settle it",
                key,
                None,
            )

    def _trace(self, key: Any) -> List[str]:
        labels: List[str] = []
        while True:
            parent, label = self._parent[key]
            if label == "":
                break
            labels.append(label)
            key = parent
        labels.reverse()
        return labels

    def _record_finding(
        self, rule_id: str, detail: str, key: Any, label: Optional[str]
    ) -> None:
        dedupe = (rule_id, detail)
        if dedupe in self._findings:
            return
        witness = self._trace(key)
        if label is not None:
            witness.append(label)
        self._findings[dedupe] = Finding(
            rule_id,
            MODEL_PATH,
            0,
            0,
            f"{detail} [witness: {' -> '.join(witness) or '(initial)'}]",
        )
        if rule_id == self.stop_on_rule:
            self._stop = True

    # ------------------------------------------------------- exploration

    def _canon(self, st: _State) -> Any:
        """Symmetry reduction: the minimum serialization over every
        replica renaming x job renaming.

        The journal is additionally put in a canonical ORDER: the
        durable prefix and the non-durable tail are each stable-sorted
        by renamed job id, preserving every per-job subsequence
        (same-job record order — including cross-replica order — is
        untouched).  Records of different jobs commute — the fold
        keys its state by job id, compaction drops whole jobs, and
        :meth:`_host_crash_transitions` branches over per-job tail
        prefixes rather than append-order prefixes — so cross-job
        append interleavings are bisimilar and collapse to one
        representative.  This is the reduction that tames the 2-job
        bound (interleavings otherwise multiply the space
        combinatorially)."""
        cached = self._canon_cache.get(st)
        if cached is not None:
            return cached
        best: Any = None
        sort_key = _journal_sort_key
        for mapping in self._perms:
            get = mapping.get
            renamed = [
                (rec[0], get(rec[1], rec[1]), get(rec[2], rec[2])) + rec[3:]
                for rec in st.journal
            ]
            serialized = (
                tuple(sorted(renamed[: st.durable], key=sort_key)),
                tuple(sorted(renamed[st.durable :], key=sort_key)),
                tuple(
                    sorted(
                        (mapping[j], mapping[r], e, a)
                        for j, r, e, a in st.leases
                    )
                ),
                tuple(
                    sorted(
                        (
                            mapping[n],
                            alive,
                            tuple(
                                sorted(
                                    (mapping[j], p, e) for j, p, e in jobs
                                )
                            ),
                        )
                        for n, alive, jobs in st.replicas
                    )
                ),
                tuple(sorted(mapping[j] for j in st.unsubmitted)),
                tuple(sorted(mapping[j] for j in st.acked)),
                tuple(sorted(mapping[j] for j in st.settled_compacted)),
                tuple(sorted(mapping[j] for j in st.began_ever)),
                tuple(
                    sorted(
                        (mapping[j], mapping[r]) for j, r in st.published_by
                    )
                ),
                tuple(sorted(mapping[r] for r in st.stale)),
                st.crashes,
                st.stalls,
            )
            if best is None or serialized < best:
                best = serialized
        self._canon_cache[st] = best
        return best

    def explore(self) -> None:
        init = _State(
            journal=(),
            durable=0,
            leases=(),
            replicas=tuple((name, True, ()) for name in self.replica_names),
            unsubmitted=tuple(self.job_names),
            acked=(),
            settled_compacted=(),
            began_ever=(),
            published_by=(),
            stale=(),
            crashes=self.bounds["crashes"],
            stalls=self.bounds["stalls"],
        )
        key = self._canon(init)
        self._parent[key] = (key, "")
        seen = {key}
        queue: deque[Tuple[_State, Any]] = deque([(init, key)])
        while queue:
            if self.states >= self.max_states or self._stop:
                return
            st, key = queue.popleft()
            self.states += 1
            self._check_state(st, key)
            for label, nxt, finds in self._transitions(st):
                self.transitions += 1
                nkey = self._canon(nxt)
                if nkey not in seen:
                    seen.add(nkey)
                    self._parent[nkey] = (key, label)
                    queue.append((nxt, nkey))
                for rule_id, detail in finds:
                    self._record_finding(rule_id, detail, key, label)
                if self._stop:
                    return
        self.exhausted = True

    def findings(self) -> List[Finding]:
        return sorted(
            self._findings.values(), key=lambda f: (f.rule_id, f.detail)
        )


def check_protocol(
    replicas: int = 2,
    jobs: int = 2,
    crashes: int = 2,
    stalls: int = 0,
    mutations: Optional[Mutations] = None,
    max_states: int = 2_000_000,
    stop_on_rule: Optional[str] = None,
) -> ProtoReport:
    """Exhaustively explore the protocol under the declared bounds and
    report every invariant violation with a witness trace.
    ``stop_on_rule`` aborts at the first finding of that rule (the
    mutation harness's fast path).

    The default matrix is the declared 2-replica / 2-job / 2-crash
    bound with ``stalls=0``: the stall dimension (lease-clock aging,
    which unlocks expiry, adoption and steal transitions) multiplies
    the product space past a CI budget when combined with two jobs, so
    the shipped gate covers it with a SECOND exhaustive run at
    ``jobs=1, stalls=2`` — together the two runs reach every
    transition type the model has."""
    explorer = _Explorer(
        replicas,
        jobs,
        crashes,
        stalls,
        mutations or Mutations(),
        max_states,
        stop_on_rule,
    )
    start = time.monotonic()
    explorer.explore()
    return ProtoReport(
        bounds=dict(explorer.bounds),
        states=explorer.states,
        transitions=explorer.transitions,
        elapsed_seconds=time.monotonic() - start,
        exhausted=explorer.exhausted,
        findings=explorer.findings(),
        crash_windows=sorted(explorer.crash_windows),
        uncovered_windows=sorted(explorer.uncovered),
    )


@dataclass(frozen=True)
class Mutation:
    """One planted single-decision bug and the GP rule that must catch
    it.

    ``bounds`` is the smallest ``(replicas, jobs, crashes, stalls)``
    matrix the bug is known to trip in — the harness runs each mutation
    at ITS witness bounds (not one shared matrix) because the bugs need
    different ingredients: a steal bug needs a fully-expired lease (two
    stall notches), the compaction bug needs a second job to append
    concurrently, and neither should pay for the other's state space."""

    name: str
    expected: str
    description: str
    mutations: Mutations
    bounds: Tuple[int, int, int, int] = (2, 1, 2, 2)


#: The checker's own test suite: every entry must trip its expected
#: rule or the harness fails.
MUTATIONS: Tuple[Mutation, ...] = (
    Mutation(
        "skip-owner-fence",
        "GP001",
        "begin/publish skip the owner_valid fence: a deposed owner "
        "publishes alongside its stealer",
        Mutations(skip_owner_fence=True),
    ),
    Mutation(
        "epoch-blind-fold",
        "GP001",
        "the fold ignores terminal epochs: a fenced zombie terminal "
        "becomes effective next to the real one",
        Mutations(epoch_blind_fold=True),
    ),
    Mutation(
        "began-blind-fold",
        "GP002",
        "the fold ignores began records: adoption requeues a job whose "
        "device work already began",
        Mutations(began_blind_fold=True),
    ),
    Mutation(
        "skip-submit-revalidate",
        "GP002",
        "submit skips the post-claim revalidation: an accepter that "
        "stalled across a peer's adopt-and-settle re-runs the job",
        Mutations(skip_submit_revalidate=True),
    ),
    Mutation(
        "stale-compact-handle",
        "GP003",
        "compaction skips the inode re-check: a concurrent accepted "
        "append lands in the unlinked inode and the acked job vanishes",
        Mutations(skip_inode_recheck=True),
        bounds=(2, 2, 1, 0),
    ),
    Mutation(
        "skip-min-epoch-guard",
        "GP004",
        "claims ignore the journaled min-epoch: a crash-dropped "
        "terminal lets a different replica re-issue a journaled epoch",
        Mutations(skip_min_epoch=True),
    ),
    Mutation(
        "graceless-steal",
        "GP005",
        "steals use grace 0: an expired-within-grace lease is stolen "
        "while its owner may still be finishing",
        Mutations(graceless_steal=True),
    ),
    Mutation(
        "unregistered-kill-window",
        "GP006",
        "serve.lease.post-claim deleted from the kill-point registry: "
        "a reachable crash window loses chaos coverage",
        Mutations(unregistered_crash_site=True),
        bounds=(2, 1, 1, 0),
    ),
)


@dataclass
class MutationOutcome:
    """One mutation-harness verdict."""

    name: str
    expected: str
    tripped: List[str]
    caught: bool
    states: int
    bounds: Dict[str, int]

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "expected": self.expected,
            "tripped": list(self.tripped),
            "caught": self.caught,
            "states": self.states,
            "bounds": dict(self.bounds),
        }


def run_mutation_harness(
    replicas: Optional[int] = None,
    jobs: Optional[int] = None,
    crashes: Optional[int] = None,
    stalls: Optional[int] = None,
    max_states: int = 2_000_000,
) -> List[MutationOutcome]:
    """Re-run the exploration once per planted bug; each must trip its
    matching GP rule (other rules tripping too is fine — bugs cascade).
    Each run stops at the first expected finding. ``None`` bounds fall
    back to each mutation's declared witness bounds; an explicit value
    overrides that dimension for EVERY mutation (and may legitimately
    report a miss — e.g. a steal bug cannot trip with ``stalls=0``)."""
    outcomes = []
    for mutation in MUTATIONS:
        w_replicas, w_jobs, w_crashes, w_stalls = mutation.bounds
        report = check_protocol(
            replicas=w_replicas if replicas is None else replicas,
            jobs=w_jobs if jobs is None else jobs,
            crashes=w_crashes if crashes is None else crashes,
            stalls=w_stalls if stalls is None else stalls,
            mutations=mutation.mutations,
            max_states=max_states,
            stop_on_rule=mutation.expected,
        )
        tripped = sorted({f.rule_id for f in report.findings})
        outcomes.append(
            MutationOutcome(
                name=mutation.name,
                expected=mutation.expected,
                tripped=tripped,
                caught=mutation.expected in tripped,
                states=report.states,
                bounds=dict(report.bounds),
            )
        )
    return outcomes
