"""Bounded two-class admission queue of the resident PCA service.

The port's copy of ``spark_examples_tpu/serve/queue.py`` (device-free; the
same classes, lanes, batching, linger and cost order).

Scheduling contract: **small-region queries are never starved by
whole-genome jobs**. Jobs are classified at admission
(:func:`classify_conf`) into ``small`` (statically-bounded synthetic site
count at or under the configured small-site limit, default
:data:`SMALL_JOB_MAX_SITES` — the 0.229 s BRCA1 shape) and ``large``
(everything else: whole-genome ``--all-references``, file and checkpoint
cohorts whose size only the data knows). Each executor slice's worker
pops only the classes its slice serves (``pop``'s ``classes`` filter);
a shared single-slice worker drains every queued small job before the
next large one, and a dedicated small slice never even sees large jobs
— a queued whole-genome run delays cheap queries by at most the job
currently on the SMALL slice's own devices.

**Continuous batching** (:meth:`BoundedJobQueue.pop_batch`): when a
worker frees, every queued small job whose batch fingerprint
(``utils/cache.py:batch_compile_fingerprint`` — region-invariant compile
geometry) matches the head job coalesces into one dispatch group, up to
``max_batch`` jobs, optionally lingering up to ``linger_seconds`` for
more compatible arrivals. The linger clock is anchored at the FIRST
group member's enqueue time, not the pop call: a group that is already
full (or whose head already waited out the window in the queue) is
dispatched immediately — the latency budget is spent once per job, not
once per pop. Both bounds are hard: latency is traded for throughput
only inside the declared window, never unboundedly. A group runs as ONE
stacked device program when eligible (``serve/executor.py:
execute_fused_batch``) and back to back on the built kernels otherwise;
either way every job keeps its individual result/manifest
(byte-identical to serial execution — CI-asserted), so batching is a
scheduling decision, not a semantics change.

**Cost-ordered scheduling** (``ordering="cost"``, the default): within
each class lane the queue serves the job with the smallest calibrated
cost estimate first (shortest-job-first — the admission-time
``CostPrediction`` stamped on ``Job.cost_estimate_seconds``), jobs
carrying a deadline sort ahead by slack (deadline minus now minus
estimate — the job closest to missing its promise runs first), and a
job queued longer than ``age_cap_seconds`` jumps to the front of its
lane outright, so SJF can never starve an expensive job behind an
endless stream of cheap ones. Ties break FIFO on the admission sequence
number, so ordering is deterministic: the same queue state always pops
the same job. ``ordering="fifo"`` keeps the historical arrival order
(the bench harness's control arm).

Both classes are bounded; an admission past capacity raises
:class:`QueueFull`, which the HTTP layer surfaces as 429 backpressure
(the client retries with backoff; the service never buffers unboundedly
— the host-memory discipline of ``graftcheck hostmem`` applied to the
control plane). Queued jobs can be cancelled and carry optional
deadlines: a job still unstarted past its deadline fails at dequeue time
without touching the devices.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

from spark_examples_tpu_torch.serve.protocol import JobRequest

SMALL_CLASS = "small"
LARGE_CLASS = "large"

#: Largest statically-bounded candidate-site count still admitted as a
#: small-region query BY DEFAULT (``--serve-small-site-limit`` overrides,
#: validated at daemon startup). The synthetic grid has one candidate
#: site per ``sources/synthetic.py:DEFAULT_VARIANT_SPACING`` (100) bases,
#: so this is ~25 Mb of reference — two orders of magnitude above the
#: BRCA1 window (~812 sites) and two below a whole genome (~28.9 M sites).
SMALL_JOB_MAX_SITES = 250_000

#: Default class capacities: small queries are cheap to hold (they drain
#: between large jobs), large jobs each pin minutes-to-hours of device
#: time so a short queue IS the honest backpressure.
DEFAULT_SMALL_CAPACITY = 16
DEFAULT_LARGE_CAPACITY = 4

#: Continuous-batching bounds: at most this many small jobs per dispatch
#: group, and by default no linger (a freed worker takes what is queued
#: NOW; a positive ``--batch-linger-seconds`` trades that much latency
#: for larger groups under bursty traffic).
DEFAULT_BATCH_MAX_JOBS = 8
DEFAULT_BATCH_LINGER_SECONDS = 0.0

#: Starvation guard for cost-ordered lanes: a job queued at least this
#: long outranks every estimate-ordered peer in its lane (FIFO among the
#: aged), so shortest-job-first degrades gracefully to FIFO under
#: sustained cheap-job pressure instead of parking expensive jobs
#: forever. ``--serve-age-cap-seconds`` overrides.
DEFAULT_AGE_CAP_SECONDS = 30.0


class QueueFull(Exception):
    """Admission past a class's capacity (HTTP 429)."""

    def __init__(self, job_class: str, capacity: int):
        super().__init__(
            f"{job_class} admission queue is full ({capacity} queued)"
        )
        self.job_class = job_class
        self.capacity = capacity


class QueueClosed(Exception):
    """Admission after drain began (HTTP 503)."""


@dataclass
class Job:
    """One admitted job. Mutable state (status, timestamps, result) is
    guarded by the owning service's table lock (``serve/daemon.py``) —
    the queue only ever holds jobs whose status is ``queued``."""

    id: str
    request: JobRequest
    conf: object
    job_class: str
    submitted_unix: float
    deadline_unix: Optional[float] = None
    plan_geometry: Dict = field(default_factory=dict)
    status: str = "queued"
    started_unix: Optional[float] = None
    finished_unix: Optional[float] = None
    seconds: Optional[float] = None
    error: Optional[str] = None
    result: Optional[Dict] = None
    manifest_path: Optional[str] = None
    compile_cache: Optional[str] = None
    #: Worker-crash recovery bookkeeping (``serve/daemon.py`` watchdog):
    #: once ``device_began`` flips, a crashed job is failed, never
    #: requeued — device state under a crashed update cannot be trusted;
    #: ``requeues`` bounds the one retry a not-yet-begun job may ride.
    device_began: bool = False
    requeues: int = 0
    #: Continuous-batching compatibility key
    #: (``utils/cache.py:batch_compile_fingerprint``), computed once at
    #: admission; ``None`` never coalesces.
    batch_key: Optional[str] = None
    #: Execution attribution, set when a slice worker claims the job:
    #: which executor slice ran it and how many jobs rode its dispatch
    #: group (1 = unbatched).
    slice: Optional[str] = None
    batch_size: int = 1
    #: The claiming slice's ``torch.device`` positions (set by the worker
    #: just before execution; opaque here — this module touches no device). The
    #: executor passes them into ``run_pipeline(devices=...)`` so the job
    #: runs on its slice's sub-mesh only.
    slice_devices: Optional[object] = None
    #: Distributed-tracing id (``obs/trace.py``): minted at client submit
    #: (or at admission when the client sent none), journaled with the
    #: accepted record, stamped on every flight-recorder event — one job
    #: is one span tree across restarts and replica steals.
    trace_id: Optional[str] = None
    #: Admission-time cost prediction
    #: (``obs/costmodel.py:CostPrediction``, opaque here — this module
    #: must stay obs-free): stamped at submit, journaled with the
    #: accepted record, compared against the measured wall clock at the
    #: terminal (the calibration ledger's input pair).
    cost_prediction: Optional[object] = None
    #: The prediction's calibrated best-estimate seconds, copied out by
    #: the daemon at admission so the queue can ORDER on it without
    #: reaching into the opaque prediction object (this module stays
    #: obs-free). ``None`` sorts last within its tier.
    cost_estimate_seconds: Optional[float] = None
    #: Monotonic clock at FIRST admission, stamped by :meth:`put` and
    #: preserved across requeues/steals within a process: the linger
    #: anchor (a group member's latency budget starts when it queued,
    #: not when a worker popped) and the age-cap starvation guard both
    #: read it.
    enqueued_monotonic: Optional[float] = None
    #: Process-wide admission sequence number (stamped with
    #: ``enqueued_monotonic``): the deterministic FIFO tiebreak of the
    #: cost ordering — equal keys pop in admission order, always.
    enqueue_seq: int = -1
    #: How many jobs shared this job's FUSED device program (1 = ran as
    #: its own program, even inside a back-to-back group). Distinct from
    #: ``batch_size`` (the dispatch-group size): a group can be popped
    #: together yet fall back to serial execution.
    fused_size: int = 1
    #: When a worker dequeued the job (the queue-wait measurement's end;
    #: ``submitted_unix`` is its start). Distinct from ``started_unix``
    #: so batched jobs that ride a group but execute back-to-back keep
    #: an honest wait-vs-run split.
    dequeued_unix: Optional[float] = None
    #: Measured queue wait (``dequeued_unix - submitted_unix``), stamped
    #: by the worker so the terminal envelope and the calibration ledger
    #: read one number instead of re-deriving it.
    queue_wait_seconds: Optional[float] = None


def classify_conf(conf, small_site_limit: int = SMALL_JOB_MAX_SITES) -> str:
    """``small`` iff the configuration's candidate-site count is
    statically bounded (synthetic source, explicit ``--references``, no
    checkpoint resume) at or under ``small_site_limit`` (default
    :data:`SMALL_JOB_MAX_SITES`; the daemon's ``--serve-small-site-limit``
    overrides); every cohort whose size only the data knows is ``large``
    — the conservative direction: misclassifying a big job as small
    starves real small jobs, misclassifying a small job as large only
    queues it fairly."""
    if (
        getattr(conf, "source", "synthetic") != "synthetic"
        or getattr(conf, "all_references", False)
        or getattr(conf, "input_path", None)
    ):
        return LARGE_CLASS
    try:
        from spark_examples_tpu_torch.sources.synthetic import DEFAULT_VARIANT_SPACING

        sites = sum(
            (contig.end - contig.start) // DEFAULT_VARIANT_SPACING + 1
            for contigs in conf.get_references()
            for contig in contigs
        )
    except (ValueError, TypeError, AttributeError):
        return LARGE_CLASS
    return SMALL_CLASS if sites <= int(small_site_limit) else LARGE_CLASS


class BoundedJobQueue:
    """Two bounded class lanes + one condition variable. ``pop`` always
    serves the small lane first (the batching contract); within a lane,
    ``ordering="cost"`` (default) serves by calibrated estimate —
    deadline slack first, then shortest-job-first, age-capped, FIFO
    tiebreak — and ``ordering="fifo"`` preserves admission order."""

    def __init__(
        self,
        small_capacity: int = DEFAULT_SMALL_CAPACITY,
        large_capacity: int = DEFAULT_LARGE_CAPACITY,
        ordering: str = "cost",
        age_cap_seconds: float = DEFAULT_AGE_CAP_SECONDS,
    ):
        if small_capacity < 1 or large_capacity < 1:
            raise ValueError(
                f"queue capacities must be >= 1, got small={small_capacity} "
                f"large={large_capacity}"
            )
        if ordering not in ("cost", "fifo"):
            raise ValueError(
                f"queue ordering must be 'cost' or 'fifo', got {ordering!r}"
            )
        if age_cap_seconds <= 0:
            raise ValueError(
                f"age cap must be > 0 seconds, got {age_cap_seconds}"
            )
        self.ordering = ordering
        self.age_cap_seconds = float(age_cap_seconds)
        self.small_capacity = int(small_capacity)
        self.large_capacity = int(large_capacity)
        self._enqueue_seq = 0
        # lock order: queue lock is a leaf — nothing else is acquired
        # while holding it (machine-checked by `graftcheck lockgraph`).
        self._lock = threading.Lock()
        # lock order: the condition shares the queue leaf lock above.
        self._nonempty = threading.Condition(self._lock)
        self._small: Deque[Job] = deque()
        self._large: Deque[Job] = deque()
        self._closed = False
        # Expired-deadline sweep sink (set by the owning daemon): a
        # queued job whose deadline already passed is dead weight — it
        # will fail at dequeue without touching the devices, but until
        # popped it OCCUPIES class capacity, so a full queue of expired
        # jobs 429s live traffic. ``put`` sweeps them out first and
        # hands them to this sink OUTSIDE the queue lock (the sink takes
        # the daemon's table lock; the queue lock stays a leaf). No sink
        # = no sweep: without an owner to settle them, removing queued
        # jobs here would strand them in "queued" forever.
        self._expired_sink = None

    # ------------------------------------------------------------ admission

    def put(self, job: Job, enforce_capacity: bool = True) -> None:
        """Admit one queued job; raises :class:`QueueClosed` after drain
        began and :class:`QueueFull` past the class capacity. Never
        blocks — backpressure is the caller's 429, not a stalled socket.
        ``enforce_capacity=False`` is for jobs that were ALREADY admitted
        once — journal replay and a crashed worker's un-run dispatch-group
        tail: their 202 was acknowledged, so capacity (which bounds NEW
        admissions) must not drop them; the transient overshoot is bounded
        by the previous incarnation's capacity + one dispatch group.

        Before the capacity check, queued jobs whose deadline has already
        expired are swept out (they would fail at dequeue anyway, but
        until popped they occupy capacity — a full queue of expired jobs
        must not 429 live traffic) and handed to the daemon's expired
        sink AFTER the lock is released."""
        swept: List[Job] = []
        try:
            with self._nonempty:
                if self._closed:
                    raise QueueClosed("service is draining; no new jobs")
                swept = self._sweep_expired_locked(time.time())
                lane, capacity = (
                    (self._small, self.small_capacity)
                    if job.job_class == SMALL_CLASS
                    else (self._large, self.large_capacity)
                )
                if enforce_capacity and len(lane) >= capacity:
                    raise QueueFull(job.job_class, capacity)
                # First-admission stamps only: a requeued (crashed-worker)
                # or stolen job keeps its original linger anchor, age
                # clock, and FIFO position — its latency budget was spent
                # from the moment the CLIENT's job first queued, and the
                # tiebreak must not reward a requeue with a newer slot.
                if job.enqueued_monotonic is None:
                    job.enqueued_monotonic = time.monotonic()
                if job.enqueue_seq < 0:
                    job.enqueue_seq = self._enqueue_seq
                    self._enqueue_seq += 1
                lane.append(job)
                # notify_all, not notify: per-slice workers wait for
                # DIFFERENT classes on this one condition, and waking only
                # one could wake a worker whose classes stay empty while
                # the right one sleeps.
                self._nonempty.notify_all()
        finally:
            # Outside the queue lock (leaf-lock discipline) and on BOTH
            # exits: a put that still 429s must not re-strand the expired
            # jobs it already removed from the lanes.
            sink = self._expired_sink
            if sink is not None:
                for expired in swept:
                    sink(expired)

    def set_expired_sink(self, sink) -> None:
        """Install the owning daemon's expired-deadline settler (called
        with each swept :class:`Job`, outside the queue lock)."""
        with self._lock:
            self._expired_sink = sink

    def _sweep_expired_locked(self, now: float) -> List[Job]:
        """Remove every queued job whose deadline already passed (both
        lanes — capacity relief for the class being admitted, honest
        accounting for the other). Caller holds the queue lock and owns
        delivering the swept jobs to the sink after releasing it."""
        if self._expired_sink is None:
            return []
        swept: List[Job] = []
        for lane in (self._small, self._large):
            expired = [
                queued
                for queued in lane
                if queued.deadline_unix is not None
                and now >= queued.deadline_unix
            ]
            for queued in expired:
                lane.remove(queued)
                swept.append(queued)
        return swept

    def inject_reclaimed(self, job: Job) -> None:
        """Admit a RECLAIMED job: one replayed from the journal by a
        restarted daemon, or stolen from a dead peer replica's expired
        lease (``serve/daemon.py`` replay + steal scan). Capacity-exempt
        by contract: the job's 202 was acknowledged by its original
        owner, so this daemon's admission capacity — which bounds NEW
        traffic — must not drop it; the transient overshoot is bounded
        by the previous owner's capacity. Raises :class:`QueueClosed`
        while draining (a draining replica must not adopt work it will
        never run)."""
        self.put(job, enforce_capacity=False)

    # -------------------------------------------------------------- worker

    def _lanes(self, classes: Optional[Sequence[str]]) -> List[Deque[Job]]:
        """Lanes in pop priority order (small first) for a class filter;
        ``None`` = both (the shared-slice worker)."""
        if classes is None:
            return [self._small, self._large]
        lanes = []
        if SMALL_CLASS in classes:
            lanes.append(self._small)
        if LARGE_CLASS in classes:
            lanes.append(self._large)
        if not lanes:
            raise ValueError(f"no known job class in {classes!r}")
        return lanes

    def _priority_key(self, job: Job, now_mono: float, now_unix: float):
        """The cost ordering's total order within one lane. Three tiers:

        - **0 — aged**: queued at least ``age_cap_seconds`` — FIFO among
          themselves (the starvation guard: an expensive job cannot wait
          forever behind a stream of cheap arrivals);
        - **1 — deadline**: sorted by slack (``deadline - now -
          estimate``): the job closest to breaking its promise first;
        - **2 — everything else**: shortest calibrated estimate first
          (``None`` — no prediction stamped — sorts last).

        Every tier tiebreaks on the admission sequence number, so equal
        keys pop in admission order — the ordering is a deterministic
        function of queue state, test- and CI-assertable."""
        seq = job.enqueue_seq
        queued_for = (
            now_mono - job.enqueued_monotonic
            if job.enqueued_monotonic is not None
            else 0.0
        )
        if queued_for >= self.age_cap_seconds:
            return (0, float(seq), seq)
        estimate = job.cost_estimate_seconds
        if job.deadline_unix is not None:
            slack = job.deadline_unix - now_unix - (estimate or 0.0)
            return (1, slack, seq)
        return (2, estimate if estimate is not None else float("inf"), seq)

    def _take_locked(self, lane: Deque[Job]) -> Job:
        """Remove and return the next job of one (non-empty) lane under
        the configured ordering. Caller holds the queue lock."""
        if self.ordering == "fifo":
            return lane.popleft()
        now_mono, now_unix = time.monotonic(), time.time()
        best = min(
            lane, key=lambda job: self._priority_key(job, now_mono, now_unix)
        )
        lane.remove(best)
        return best

    def pop(
        self,
        timeout: Optional[float] = None,
        classes: Optional[Sequence[str]] = None,
    ) -> Optional[Job]:
        """Next job for a worker serving ``classes`` (``None`` = both) —
        every queued small job ahead of any large one; within the lane,
        the configured ordering picks (see :meth:`_priority_key`).
        Returns ``None`` on timeout or when the queue is closed and empty
        of those classes (check :meth:`drained_for` to distinguish)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._nonempty:
            lanes = self._lanes(classes)
            while not any(lanes):
                if self._closed:
                    return None
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return None
                self._nonempty.wait(remaining)
            for lane in lanes:
                if lane:
                    return self._take_locked(lane)
            return None  # unreachable; keeps the type checker honest

    def pop_batch(
        self,
        timeout: Optional[float] = None,
        classes: Optional[Sequence[str]] = None,
        max_batch: int = DEFAULT_BATCH_MAX_JOBS,
        linger_seconds: float = DEFAULT_BATCH_LINGER_SECONDS,
    ) -> List[Job]:
        """One dispatch group: the next job plus, when it is a SMALL job
        with a batch key, every queued small job with the SAME key — up to
        ``max_batch`` jobs, lingering up to ``linger_seconds`` for more
        compatible arrivals when the group is not yet full. Large jobs
        never batch (group of one). Non-matching small jobs keep their
        queue order untouched. Returns ``[]`` on timeout/closed-empty.

        The linger clock anchors at the FIRST group member's enqueue
        time: a head job that already sat in the queue for the whole
        window (or a group already full at pop time) dispatches with ZERO
        added wait — the worker never re-spends a latency budget the job
        already paid queuing. ``pop_batch`` therefore never returns later
        than ``first-member-enqueue + linger_seconds`` (plus lock
        wakeups), regardless of when the worker called it."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        first = self.pop(timeout=timeout, classes=classes)
        if first is None:
            return []
        if (
            first.job_class != SMALL_CLASS
            or first.batch_key is None
            or max_batch == 1
        ):
            return [first]
        batch = [first]
        anchor = (
            first.enqueued_monotonic
            if first.enqueued_monotonic is not None
            else time.monotonic()
        )
        linger_deadline = anchor + max(0.0, float(linger_seconds))
        with self._nonempty:
            while len(batch) < max_batch:
                matched = [
                    job
                    for job in self._small
                    if job.batch_key == first.batch_key
                ]
                for job in matched[: max_batch - len(batch)]:
                    self._small.remove(job)
                    batch.append(job)
                if len(batch) >= max_batch or self._closed:
                    break
                remaining = linger_deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._nonempty.wait(remaining)
        return batch

    # ---------------------------------------------------------- management

    def remove(self, job_id: str) -> Optional[Job]:
        """Pull one still-queued job out (cancellation); ``None`` when the
        worker already claimed it."""
        with self._lock:
            for lane in (self._small, self._large):
                for job in lane:
                    if job.id == job_id:
                        lane.remove(job)
                        return job
        return None

    def close(self) -> None:
        """Stop admission (drain): pending jobs still pop; new puts raise
        :class:`QueueClosed`; blocked pops wake."""
        with self._nonempty:
            self._closed = True
            self._nonempty.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def drained(self) -> bool:
        """Closed AND empty — the worker's exit condition."""
        with self._lock:
            return self._closed and not self._small and not self._large

    def drained_for(self, classes: Optional[Sequence[str]] = None) -> bool:
        """Closed AND empty of the given classes — a per-slice worker's
        exit condition (a small-slice worker must not keep spinning for a
        large backlog it will never pop)."""
        with self._lock:
            return self._closed and not any(self._lanes(classes))

    def depth(self) -> Dict[str, int]:
        with self._lock:
            return {
                SMALL_CLASS: len(self._small),
                LARGE_CLASS: len(self._large),
            }

    def total_depth(self) -> int:
        with self._lock:
            return len(self._small) + len(self._large)


__all__ = [
    "SMALL_CLASS",
    "LARGE_CLASS",
    "SMALL_JOB_MAX_SITES",
    "DEFAULT_SMALL_CAPACITY",
    "DEFAULT_LARGE_CAPACITY",
    "DEFAULT_BATCH_MAX_JOBS",
    "DEFAULT_BATCH_LINGER_SECONDS",
    "DEFAULT_AGE_CAP_SECONDS",
    "QueueFull",
    "QueueClosed",
    "Job",
    "classify_conf",
    "BoundedJobQueue",
]
