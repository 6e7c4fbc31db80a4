"""The resident PCA service: warm process, admission control, executor slices.

The port's counterpart of ``spark_examples_tpu/serve/daemon.py``.
:class:`PcaService` is the daemon's brain, HTTP-free (``serve/http.py``
is a thin dispatch onto it, so every behavior is testable in-process):

- **owns the devices, in slices**: the devices come from ``--device``
  like every verb of the port (``cuda``, the default: every card of
  ``parallel/mesh.py:local_cards``, raising without one; ``cpu``: one CPU
  position) or from the constructor's ``devices=`` (any ``torch.device``
  list, a device may repeat: the CPU tests take eight CPU positions, as
  the reference's tests take eight virtual devices, and two slices may sit
  on positions of ``cuda:0``). :meth:`start` enumerates them once, builds
  every kernel library (a no-op once ``build/torch_kernels/`` holds them)
  and brings up each card's runtime (context, cuBLAS, cuSOLVER) before
  any job, then partitions the positions into **executor slices**
  (``parallel/mesh.py:plan_executor_slices``), each its own worker
  thread. On one card the auto rule gives no small slice: the ``shared``
  topology, as the reference's on one device;
- **streams**: PyTorch's current stream is per thread, so each worker
  runs its jobs under a CUDA stream of its own on each of its cards, and
  synchronises them before a job settles: a job's measured wall includes
  its device work, and two workers on positions of one card never share
  a stream (the kernels' scratch is kept per device and stream,
  ``ops/devicegen.py:_COUNTERS``, ``ops/depth.py:_SCRATCH``);
- **admits device-free, per slice**: every request is validated by the
  ``graftcheck plan`` validator (``check/plan.py``) BEFORE it may queue —
  against the device count of the slice that will RUN it and its first
  device's memory (``ops/gramian.py:per_device_memory_bytes``: the card's,
  or the reference's 16 GiB on the CPU) — and flag-grammar errors,
  geometry contradictions, memory and exactness violations are
  structured 4xx bodies carrying the plan facts. ``--device`` is a
  reserved flag, like the reference's topology flags: placement is the
  daemon's;
- **batches continuously**: a freed worker coalesces every queued small
  job with a compatible batch fingerprint into one dispatch group
  (``serve/queue.py:pop_batch``), run as ONE stacked program when
  ``pipeline/fused.py:preflight_fused`` admits it. A ``FusedIneligible``
  there (raised before any side effect) sends the group to the serial
  loop — the reference's semantics, not a device fallback; any other
  error fails the job or group with a structured error, and nothing is
  ever re-run on the CPU or through the plain versions;
- **survives restarts**: every acknowledged admission is journaled
  (``serve/journal.py``) before its 202 leaves the socket, and the
  warm-geometry ledger is kept under the run directory
  (``utils/cache.py:attach_geometry_ledger``; ``persistent_cache=False``
  turns it off), so a restarted daemon replays accepted-but-unfinished
  jobs and reports its first repeat-geometry job warm. Warm means the
  kernels are loaded from ``build/torch_kernels/``, not built again; the
  reference's XLA compile cache has no counterpart and no ``jax-cache``
  directory is made. A restarted daemon still pays the CUDA context and
  cuSOLVER set-up once, in :meth:`start`;
- **drains gracefully**: :meth:`begin_drain` stops admission (503),
  lets every slice worker finish every admitted job, then the workers
  exit — the SIGTERM path of the ``serve`` CLI verb.

Replicas (``replica_id``) share one run directory through the journal's
leases: renewals, steal scans, revalidation and zombie abandonment, the
reference's protocol over ``serve/journal.py:LeaseStore``. The six
``serve.*`` kill points of ``utils/faults.py`` fire at the reference's
places. Telemetry: one service :class:`~spark_examples_tpu_torch.obs.metrics.MetricsRegistry`
(``GET /metrics``), per-request spans, and the
:class:`~spark_examples_tpu_torch.obs.heartbeat.Heartbeat` on stderr.
"""

from __future__ import annotations

import os
import re
import sys
import tempfile
import threading
import time
from collections import deque
from contextlib import ExitStack
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from spark_examples_tpu_torch.serve.executor import (
    ExecutionOutcome,
    execute_fused_batch,
    execute_job,
)
from spark_examples_tpu_torch.serve.journal import (
    DEFAULT_LEASE_SECONDS,
    JobJournal,
    LeaseStore,
    RunDirLock,
    acquire_run_dir_lock,
    adoption_action,
    compact_journal,
    compact_journal_shared,
    journal_path,
    replay_journal,
    revalidate_pending,
    steal_candidates,
)
from spark_examples_tpu_torch.serve.protocol import (
    ProtocolError,
    error_doc,
    job_doc,
    parse_request,
    request_doc,
)
from spark_examples_tpu_torch.obs.trace import mint_trace_id, normalize_trace_id
from spark_examples_tpu_torch.serve.queue import (
    DEFAULT_AGE_CAP_SECONDS,
    DEFAULT_BATCH_LINGER_SECONDS,
    DEFAULT_BATCH_MAX_JOBS,
    DEFAULT_LARGE_CAPACITY,
    DEFAULT_SMALL_CAPACITY,
    SMALL_JOB_MAX_SITES,
    BoundedJobQueue,
    Job,
    QueueClosed,
    QueueFull,
    classify_conf,
)
from spark_examples_tpu_torch.utils import faults

#: How often the watchdog checks each worker thread's pulse. A dead
#: worker is replaced within ~this bound, so one crashed job never looks
#: like a wedged daemon to pollers.
WATCHDOG_INTERVAL_SECONDS = 0.05

#: A replica renews its leases this many times per TTL — two missed
#: ticks still leave one renewal before expiry, so only a genuinely
#: stalled (or dead) replica ever lets a lease lapse.
LEASE_RENEWALS_PER_TTL = 3

#: Replica-id grammar: filesystem-safe (it names lease/heartbeat/lock
#: files and is embedded in job ids), bounded, and never empty.
_REPLICA_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

#: Shared-journal size past which a replica's scan triggers runtime
#: compaction (startup-only compaction would let settled records — and
#: the cost of every steal-scan fold — grow until the next restart).
JOURNAL_COMPACT_BYTES = 4 << 20

#: Plan-rejection codes that are RESOURCE bounds (the request is
#: well-formed but too big for the declared budgets) — surfaced as HTTP
#: 413 rather than 400, so clients can distinguish "fix the flags" from
#: "shrink the request or find a bigger service".
MEM_LIMIT_CODES = frozenset(
    {
        # "host-mem-unprovable" is retired: conf_host_peak_bytes is
        # TOTAL now, so every job kind proves a finite bound and the
        # only host-memory rejection left is a bound over budget.
        "host-mem-over-budget",
        "dense-exceeds-hbm",
        "sharded-exceeds-hbm",
        "fused-group-exceeds-hbm",
    }
)

#: Terminal jobs kept queryable after completion (per-job manifests stay
#: on disk forever; only the in-memory record — result payload included —
#: is bounded). Without a cap the job table of a long-lived daemon grows
#: monotonically: the control plane must obey the same bounded-memory
#: discipline ``graftcheck hostmem`` enforces on ingest.
DEFAULT_TERMINAL_RETENTION = 256

#: Flags a served job may not carry: multi-controller topology belongs to
#: the daemon's own launch, and every daemon-host write path belongs to
#: the service (one canonical per-job directory; see ``serve/executor.py``)
#: — a client-chosen ``--output-path``/``--profile-dir``/``--save-variants``
#: would be an arbitrary-path write primitive on the service host.
_RESERVED_FLAG_FIELDS = (
    ("coordinator_address", "--coordinator-address"),
    ("num_processes", "--num-processes"),
    ("process_id", "--process-id"),
    ("metrics_json", "--metrics-json"),
    ("output_path", "--output-path"),
    ("profile_dir", "--profile-dir"),
    ("save_variants", "--save-variants"),
    # Daemon-host write paths AND process-wide kill switches: a served
    # job carrying a fault plan could SIGKILL the daemon (kill@... fires
    # os.kill on the whole process), and checkpoint/resume directories
    # are arbitrary-path read/write primitives on the service host.
    ("fault_plan", "--fault-plan"),
    ("gramian_checkpoint_dir", "--gramian-checkpoint-dir"),
    ("resume_from", "--resume-from"),
    # The analyses' per-site output paths are daemon-host write primitives
    # too; a served grm job returns the kinship SUMMARY, never a
    # client-placed matrix file.
    ("grm_out", "--grm-out"),
    # The port's one added flag: placement belongs to the daemon (its
    # --device and slices), so a served job never picks its own device.
    ("device", "--device"),
)
# NOT reserved: --fused-jobs. It is a pure plan directive — admission
# validates the K-lane stacked geometry (an over-HBM group is a
# structured 413 via MEM_LIMIT_CODES) but group MEMBERSHIP stays the
# daemon's dispatch decision: the flag is fingerprint-invariant
# (utils/cache.py:_NON_GEOMETRY_FIELDS) and nothing in the execution
# path reads it, so a declared K can neither force nor split a group.


def _parse_job_flags(flags, kind: str = "pca"):
    """Parse a request's flag list through the REAL parser of the job's
    kind (``check/plan.py:ANALYSIS_SURFACES`` — never a drifted copy;
    ``pca``/``similarity`` share the PCA surface, ``grm`` parses the grm
    verb's); argparse errors raise ``ValueError``."""
    from spark_examples_tpu_torch.check.plan import ANALYSIS_SURFACES, _RaisingParser

    build_parser, conf_cls = ANALYSIS_SURFACES[
        kind if kind in ANALYSIS_SURFACES else "pca"
    ]
    parser = build_parser(_RaisingParser(prog="serve-job", add_help=False))
    # ``device`` stays None unless the request names --device, so the
    # reserved-flag check sees it; the daemon then sets its own.
    parser.set_defaults(device=None)
    ns = parser.parse_args(list(flags))
    return conf_cls._from_namespace(ns)


class _SliceWorker:
    """One executor slice's runtime state: its device subset, its worker
    thread, and what it is running right now. Mutable fields
    (``thread``/``done``/``running_job_id``/``pending_batch``) are
    guarded by the owning service's table lock except where noted."""

    def __init__(self, spec, devices):
        self.spec = spec
        self.devices = list(devices)
        #: One CUDA stream of this worker's own on each of its cards (none
        #: on the CPU), made at start-up on the main thread.
        self.streams = [
            torch.cuda.Stream(device=d)
            for d in dict.fromkeys(d for d in self.devices if d.type == "cuda")
        ]
        self.thread: Optional[threading.Thread] = None
        #: Clean contract exit observed (drain finished for this slice's
        #: classes); the watchdog stops monitoring a done worker.
        self.done = False
        self.running_job_id: Optional[str] = None
        #: Jobs popped into the current dispatch group but not yet
        #: started — a crashed worker's untouched batch tail is requeued
        #: (those jobs were never claimed, so the retry is free).
        self.pending_batch: List[Job] = []

    def on_streams(self) -> ExitStack:
        """Make this worker's streams current on the calling thread."""
        stack = ExitStack()
        for stream in self.streams:
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def synchronize(self) -> None:
        """Wait for every launch on this worker's streams."""
        for stream in self.streams:
            stream.synchronize()


class PcaService:
    """The resident service; see the module docstring for the contract."""

    def __init__(
        self,
        run_dir: Optional[str] = None,
        small_capacity: int = DEFAULT_SMALL_CAPACITY,
        large_capacity: int = DEFAULT_LARGE_CAPACITY,
        host_mem_budget: Optional[int] = None,
        heartbeat_seconds: float = 0.0,
        executor: Optional[Callable[[Job, str], ExecutionOutcome]] = None,
        terminal_retention: int = DEFAULT_TERMINAL_RETENTION,
        small_slices: Optional[int] = 0,
        small_slice_devices: int = 1,
        small_site_limit: int = SMALL_JOB_MAX_SITES,
        batch_max_jobs: int = DEFAULT_BATCH_MAX_JOBS,
        batch_linger_seconds: float = DEFAULT_BATCH_LINGER_SECONDS,
        batch_fuse: bool = True,
        ordering: str = "cost",
        age_cap_seconds: float = DEFAULT_AGE_CAP_SECONDS,
        persistent_cache: bool = False,
        replica_id: Optional[str] = None,
        lease_seconds: float = DEFAULT_LEASE_SECONDS,
        lease_grace_seconds: Optional[float] = None,
        steal_interval_seconds: Optional[float] = None,
        guard_run_dir: bool = False,
        deadline_feasibility: bool = True,
        device: str = "cuda",
        devices: Optional[Sequence] = None,
    ):
        if terminal_retention < 1:
            raise ValueError(
                f"terminal_retention must be >= 1, got {terminal_retention}"
            )
        if small_site_limit < 1:
            raise ValueError(
                f"small_site_limit must be >= 1 site, got {small_site_limit}"
            )
        if batch_max_jobs < 1:
            raise ValueError(
                f"batch_max_jobs must be >= 1, got {batch_max_jobs}"
            )
        if batch_linger_seconds < 0:
            raise ValueError(
                f"batch_linger_seconds must be >= 0, got "
                f"{batch_linger_seconds}"
            )
        if small_slices is not None and small_slices < 0:
            raise ValueError(
                f"small_slices must be >= 0 (or None = auto), got "
                f"{small_slices}"
            )
        if small_slice_devices < 1:
            raise ValueError(
                f"small_slice_devices must be >= 1, got "
                f"{small_slice_devices}"
            )
        if replica_id is not None and not _REPLICA_ID_RE.match(replica_id):
            raise ValueError(
                f"replica_id must match {_REPLICA_ID_RE.pattern} (it names "
                f"lease and lock files), got {replica_id!r}"
            )
        if lease_seconds <= 0:
            raise ValueError(
                f"lease_seconds must be > 0, got {lease_seconds}"
            )
        if lease_grace_seconds is not None and lease_grace_seconds < 0:
            raise ValueError(
                f"lease_grace_seconds must be >= 0, got "
                f"{lease_grace_seconds}"
            )
        if steal_interval_seconds is not None and steal_interval_seconds <= 0:
            raise ValueError(
                f"steal_interval_seconds must be > 0, got "
                f"{steal_interval_seconds}"
            )
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        #: ``--device``: where :meth:`start` takes the positions when
        #: ``devices`` does not name them.
        self.device = device
        self._devices_arg = list(devices) if devices is not None else None
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="spark-serve-")
        self.host_mem_budget = host_mem_budget
        self.heartbeat_seconds = float(heartbeat_seconds)
        self.terminal_retention = int(terminal_retention)
        #: None = auto (one small slice when a device can be spared);
        #: resolved against the real device count at :meth:`start`.
        self.small_slices = small_slices
        self.small_slice_devices = int(small_slice_devices)
        self.small_site_limit = int(small_site_limit)
        self.batch_max_jobs = int(batch_max_jobs)
        self.batch_linger_seconds = float(batch_linger_seconds)
        #: Run multi-job batch groups as ONE stacked device program when
        #: the group is eligible (pipeline/fused.py preflight); ``False``
        #: restores the serial per-job dispatch loop unconditionally.
        self.batch_fuse = bool(batch_fuse)
        self.persistent_cache = bool(persistent_cache)
        self._executor = executor if executor is not None else execute_job
        self._queue = BoundedJobQueue(
            small_capacity,
            large_capacity,
            ordering=ordering,
            age_cap_seconds=age_cap_seconds,
        )
        # (job-state flips and table reads only; the queue's and
        # journal's own leaf locks are never taken while holding it:
        # admission puts and journal appends happen outside.)
        # lock order: service table lock before nothing — it is a leaf.
        self._lock = threading.Lock()
        self._table: Dict[str, Job] = {}
        self._terminal_order: Deque[str] = deque()
        self._seq = 0
        self._inflight = 0
        self._terminal = 0
        self._draining = threading.Event()
        self._workers: List[_SliceWorker] = []
        self._watchdog: Optional[threading.Thread] = None
        self._heartbeat = None
        self._journal: Optional[JobJournal] = None
        #: Multi-replica identity (None = solo mode: no leases, no
        #: stealing, journal records stay epoch-less — byte-for-byte the
        #: single-daemon behavior).
        self.replica_id = replica_id
        self.lease_seconds = float(lease_seconds)
        self.lease_grace_seconds = (
            float(lease_grace_seconds)
            if lease_grace_seconds is not None
            else float(lease_seconds)
        )
        self.steal_interval_seconds = (
            float(steal_interval_seconds)
            if steal_interval_seconds is not None
            else float(lease_seconds)
        )
        self._guard_run_dir = bool(guard_run_dir)
        self._run_dir_lock: Optional[RunDirLock] = None
        #: Flight recorder (obs/recorder.py): every lifecycle transition
        #: of every job this replica touches, crash-durably flushed — the
        #: per-replica half of the fleet's merged trace.
        self._recorder = None
        self._lease_store: Optional[LeaseStore] = None
        self._lease_thread: Optional[threading.Thread] = None
        self._lease_stop = threading.Event()
        self._started_unix: Optional[float] = None
        self._replayed_jobs = 0
        self._primed_geometries = 0
        self.device_count: Optional[int] = None
        self.platform: Optional[str] = None
        #: The positions' device type once started (a job's ``device``).
        self.device_type: str = (
            torch.device(self._devices_arg[0]).type if self._devices_arg else device
        )
        #: Reject jobs whose deadline is below the calibrated cost
        #: estimate at admission (413 ``deadline-infeasible``) instead of
        #: queueing work that is guaranteed to expire. ``False`` restores
        #: the optimistic pre-cost-observatory admission.
        self.deadline_feasibility = bool(deadline_feasibility)
        #: Fleet-shared predicted-vs-measured ledger (obs/calibration.py):
        #: every replica appends to the one file under the run dir, so
        #: the fold — and calibrated admission — sees the whole fleet.
        from spark_examples_tpu_torch.obs.calibration import CalibrationLedger

        self._calibration = CalibrationLedger(self.run_dir)
        # Expired queued jobs are swept at admission time (capacity must
        # not be held by jobs that can never run); the sink routes them
        # to the same terminal path a dequeued-too-late job takes.
        self._queue.set_expired_sink(self._expire_queued_job)

        from spark_examples_tpu_torch.obs import MetricsRegistry, SpanRecorder

        self.registry = MetricsRegistry()
        self.spans = SpanRecorder()
        self._register_metrics()

    # ------------------------------------------------------------ telemetry

    def _register_metrics(self) -> None:
        from spark_examples_tpu_torch.obs.metrics import (
            COMPILE_CACHE_GEOMETRY_HITS,
            COMPILE_CACHE_GEOMETRY_MISSES,
            HOST_PEAK_RSS_BYTES,
            SERVE_BATCH_JOBS,
            SERVE_BATCHES,
            SERVE_JOBS_DONE,
            SERVE_JOBS_INFLIGHT,
            SERVE_JOURNAL_REPLAYED,
            SERVE_QUEUE_DEPTH,
            SERVE_SLICES,
            SERVE_SLICES_BUSY,
            SERVE_WORKER_RESTARTS,
            read_host_peak_rss_bytes,
            well_known_counter,
            well_known_gauge,
        )
        from spark_examples_tpu_torch.utils.cache import compile_cache_stats

        well_known_gauge(self.registry, SERVE_QUEUE_DEPTH).set_function(
            lambda: float(self._queue.total_depth())
        )
        well_known_gauge(self.registry, SERVE_JOBS_INFLIGHT).set_function(
            lambda: float(self._inflight)
        )
        well_known_gauge(self.registry, SERVE_JOBS_DONE).set_function(
            lambda: float(self._terminal)
        )
        well_known_gauge(self.registry, SERVE_SLICES).set_function(
            lambda: float(len(self._workers))
        )
        well_known_gauge(self.registry, SERVE_SLICES_BUSY).set_function(
            lambda: float(
                sum(
                    1
                    for w in self._workers
                    if w.running_job_id is not None
                )
            )
        )
        well_known_gauge(
            self.registry, COMPILE_CACHE_GEOMETRY_HITS
        ).set_function(lambda: float(compile_cache_stats()[0]))
        well_known_gauge(
            self.registry, COMPILE_CACHE_GEOMETRY_MISSES
        ).set_function(lambda: float(compile_cache_stats()[1]))
        if read_host_peak_rss_bytes() is not None:
            well_known_gauge(self.registry, HOST_PEAK_RSS_BYTES).set_function(
                lambda: float(read_host_peak_rss_bytes() or 0)
            )
        self._submitted = self.registry.counter(
            "serve_jobs_submitted_total",
            "Jobs admitted to the queue, by admission class.",
            labelnames=("job_class",),
        )
        self._rejected = self.registry.counter(
            "serve_jobs_rejected_total",
            "Requests rejected at admission, by rejection code.",
            labelnames=("code",),
        )
        self._completed = self.registry.counter(
            "serve_jobs_completed_total",
            "Jobs that reached a terminal state, by status.",
            labelnames=("status",),
        )
        self._job_seconds = self.registry.histogram(
            "serve_job_seconds",
            "Wall-clock of completed jobs, by admission class.",
            labelnames=("job_class",),
        )
        from spark_examples_tpu_torch.obs.metrics import (
            COST_CALIBRATION_SAMPLES,
            COST_MEASURED_MEAN_SECONDS,
            COST_PREDICTED_MEAN_SECONDS,
            COST_PREDICTION_RATIO,
            SERVE_JOB_WALL_SECONDS,
            SERVE_QUEUE_WAIT_SECONDS,
            WIDE_SECONDS_BUCKETS,
        )

        self._queue_wait_seconds = self.registry.histogram(
            SERVE_QUEUE_WAIT_SECONDS,
            "Admission-to-dequeue wait of jobs, by admission class.",
            labelnames=("job_class",),
            buckets=WIDE_SECONDS_BUCKETS,
        )
        self._job_wall_seconds = self.registry.histogram(
            SERVE_JOB_WALL_SECONDS,
            "Executor wall-clock of completed jobs, by kind, admission "
            "class, and compile cache disposition.",
            labelnames=("kind", "job_class", "compile"),
            buckets=WIDE_SECONDS_BUCKETS,
        )
        self._prediction_ratio = self.registry.gauge(
            COST_PREDICTION_RATIO,
            "measured/predicted wall-clock ratio of the most recently "
            "completed job, by kind.",
            labelnames=("kind",),
        )
        # Fleet calibration aggregates (this replica's fold of the shared
        # ledger): NaN while no completed job has been recorded — the
        # heartbeat's cost segment keys off the NaN guard.
        well_known_gauge(
            self.registry, COST_CALIBRATION_SAMPLES
        ).set_function(lambda: float(self._calibration.fold.overall.n))
        well_known_gauge(
            self.registry, COST_PREDICTED_MEAN_SECONDS
        ).set_function(
            lambda: (
                self._calibration.fold.overall.predicted_sum
                / self._calibration.fold.overall.n
                if self._calibration.fold.overall.n
                else float("nan")
            )
        )
        well_known_gauge(
            self.registry, COST_MEASURED_MEAN_SECONDS
        ).set_function(
            lambda: (
                self._calibration.fold.overall.measured_sum
                / self._calibration.fold.overall.n
                if self._calibration.fold.overall.n
                else float("nan")
            )
        )
        self._slice_inflight = self.registry.gauge(
            "serve_slice_inflight",
            "Jobs currently executing on each executor slice (0 or 1 — "
            "a slice runs its dispatch group serially).",
            labelnames=("slice",),
        )
        self._worker_restarts = well_known_counter(
            self.registry, SERVE_WORKER_RESTARTS
        )
        self._batches = well_known_counter(self.registry, SERVE_BATCHES)
        self._batch_jobs = well_known_counter(
            self.registry, SERVE_BATCH_JOBS
        )
        from spark_examples_tpu_torch.obs.metrics import (
            SERVE_FUSED_GROUPS,
            SERVE_FUSED_JOBS,
        )

        self._fused_groups = well_known_counter(
            self.registry, SERVE_FUSED_GROUPS
        )
        self._fused_jobs = well_known_counter(
            self.registry, SERVE_FUSED_JOBS
        )
        self._serial_jobs = self.registry.counter(
            "serve_serial_jobs_total",
            "Jobs dispatched as their own device program (the non-fused "
            "path; fused vs serial partitions every executed job).",
        )
        self._journal_replayed = well_known_counter(
            self.registry, SERVE_JOURNAL_REPLAYED
        )
        from spark_examples_tpu_torch.obs.metrics import (
            SERVE_JOBS_STOLEN,
            SERVE_LEASE_RENEWALS,
            SERVE_REPLICAS_ALIVE,
        )

        self._lease_renewals = well_known_counter(
            self.registry, SERVE_LEASE_RENEWALS
        )
        self._jobs_stolen = well_known_counter(
            self.registry, SERVE_JOBS_STOLEN
        )
        # Solo mode exports 0 honestly: nothing is heartbeating the run
        # dir's replica directory, so no replica failover is available.
        well_known_gauge(self.registry, SERVE_REPLICAS_ALIVE).set_function(
            lambda: float(
                self._lease_store.alive_count()
                if self._lease_store is not None
                else 0
            )
        )

    # ------------------------------------------------------------- tracing

    def _flush_recorder(self) -> None:
        """The fault-hook target (``utils/faults.add_flush_hook``): make
        the ring durable before an injected fault fires. fsync'd — this
        may be the last Python the process executes."""
        if self._recorder is not None:
            self._recorder.flush(fsync=True)

    def _trace_event(
        self,
        name: str,
        ph: str = "i",
        job: Optional[Job] = None,
        job_id: Optional[str] = None,
        trace: Optional[str] = None,
        tid: str = "control",
        flush: bool = False,
        **args,
    ) -> None:
        """Record one flight-recorder event (no-op before :meth:`start`).
        ``flush=True`` drains the ring with a buffered write (no fsync:
        a ``kill -9`` keeps OS page-cache writes, and the fault hook
        fsyncs before injected kills) — cheap enough for every terminal
        transition."""
        recorder = self._recorder
        if recorder is None:
            return
        if job is not None:
            job_id = job.id
            trace = trace if trace is not None else job.trace_id
        recorder.record(name, ph=ph, trace=trace, job=job_id, tid=tid, **args)
        if flush:
            recorder.flush(fsync=False)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "PcaService":
        """Enumerate the devices, build the kernels and warm each card's
        runtime (the once-per-process cost; raises before anything else
        when ``cuda`` has no card), carve the executor slices, prime the
        persistent warm state, replay the job journal, then start the
        per-slice workers and the optional service heartbeat."""
        if self._workers:
            return self
        # Force the lazy env-var fault plan to parse NOW (the batch path
        # does the same in run_pipeline): a typo'd site name must fail the
        # daemon at startup, not surface as a crash/restart loop where
        # every job rides its one requeue and then fails with a
        # misleading "worker-crashed:" error.
        faults.active()
        # The warm-mesh moment: positions enumerate here, once, and every
        # card's runtime comes up before any job (the once-per-process
        # cost every batch run pays at driver set-up).
        devices = self._resolve_devices()
        os.makedirs(self.run_dir, exist_ok=True)
        if self._guard_run_dir:
            # Raises RunDirBusy (CLI exit 2): a second unreplicated
            # daemon on this run dir would corrupt the journal; replicas
            # with distinct ids coexist by design.
            self._run_dir_lock = acquire_run_dir_lock(
                self.run_dir, self.replica_id
            )
        # The flight recorder comes up BEFORE journal replay so replayed
        # adoptions and startup steals are on the record; its ring is
        # flushed at every registered fault kill-point (the hook below
        # runs as the last Python before an injected SIGKILL), at every
        # terminal transition, and at drain — the chaos harness's
        # `kill -9` always lands on a segment holding the events that
        # led up to it.
        from spark_examples_tpu_torch.obs.recorder import FlightRecorder

        self._recorder = FlightRecorder(
            self.run_dir, name=self.replica_id or "solo"
        )
        faults.add_flush_hook(self._flush_recorder)
        if self.replica_id is not None:
            self._lease_store = LeaseStore(
                self.run_dir,
                self.replica_id,
                lease_seconds=self.lease_seconds,
                grace_seconds=self.lease_grace_seconds,
            )
            self._lease_store.heartbeat()
        from spark_examples_tpu_torch.utils.cache import attach_geometry_ledger

        self.device_count = len(devices)
        self.device_type = devices[0].type
        self.platform = "gpu" if self.device_type == "cuda" else "cpu"
        from spark_examples_tpu_torch.parallel.mesh import (
            plan_executor_slices,
            resolve_small_slices,
        )

        small = resolve_small_slices(self.small_slices, len(devices))
        specs = plan_executor_slices(
            len(devices), small, self.small_slice_devices
        )
        self._workers = [
            _SliceWorker(
                spec,
                devices[
                    spec.device_start : spec.device_start + spec.device_count
                ],
            )
            for spec in specs
        ]
        if any(worker.spec.device_count >= 2 for worker in self._workers):
            # A slice of two or more positions admits sharded jobs, whose
            # plan audits the ring on meta tensors: the process's first
            # meta audit is paid here, with the other once-per-process costs.
            from spark_examples_tpu_torch.check.plan import warm_ring_audit

            warm_ring_audit()
        if self.persistent_cache:
            # The warm-geometry ledger primes from (and persists to) the
            # run dir, so warm-vs-cold attribution survives the process. A
            # primed "warm" is honest: a restarted daemon loads the built
            # kernel libraries and builds nothing (``--no-persistent-cache``
            # turns the ledger off, and every first geometry reports cold).
            self._primed_geometries = attach_geometry_ledger(
                os.path.join(self.run_dir, "geometry.ledger")
            )
        self._journal = JobJournal(
            journal_path(self.run_dir), replica=self.replica_id
        )
        self._replay_journal()
        self._started_unix = time.time()
        for worker in self._workers:
            thread = threading.Thread(
                target=self._worker_loop,
                args=(worker,),
                name=f"serve-worker-{worker.spec.name}",
                daemon=True,
            )
            worker.thread = thread
            thread.start()
        # The self-healing half: a watchdog that replaces a dead worker
        # thread instead of letting one crashed job wedge its slice.
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="serve-watchdog", daemon=True
        )
        self._watchdog.start()
        if self._lease_store is not None:
            self._lease_thread = threading.Thread(
                target=self._lease_loop,
                name=f"serve-lease-{self.replica_id}",
                daemon=True,
            )
            self._lease_thread.start()
        if self.heartbeat_seconds > 0:
            from spark_examples_tpu_torch.obs.heartbeat import Heartbeat

            self._heartbeat = Heartbeat(
                self.heartbeat_seconds, self.registry
            ).start()
        return self

    def _resolve_devices(self) -> List[torch.device]:
        """The daemon's positions: ``devices=`` as given, or every card
        (``cuda``; raises without one) or one CPU position (``cpu``). On
        the card every kernel library is built (loaded, once built) and
        each card's runtime warmed here, on the main thread, so no worker
        ever builds or initialises concurrently."""
        if self._devices_arg is not None:
            devices = [torch.device(d) for d in self._devices_arg]
            if not devices:
                raise ValueError("devices must name at least one device")
            if len({d.type for d in devices}) != 1:
                raise ValueError(f"devices mix device types: {devices}")
        elif self.device == "cuda":
            from spark_examples_tpu_torch.parallel.mesh import local_cards

            devices = local_cards()
        else:
            devices = [torch.device("cpu")]
        if devices[0].type == "cuda":
            from spark_examples_tpu_torch.check.hostmem import runtime_baseline_bytes
            from spark_examples_tpu_torch.ops._kernels import build_all

            build_all()
            for card in dict.fromkeys(devices):
                runtime_baseline_bytes(card)
        return devices

    def _replay_journal(self) -> None:
        """Reload accepted-but-unfinished jobs from the journal (prior
        admissions against this run dir). Jobs that never began device
        work requeue with their one retry consumed; jobs journaled
        ``began`` fail with a structured error — the exact policy the
        in-process watchdog applies to a crashed worker, extended to a
        crashed process. In multi-replica mode the replay only ADOPTS
        jobs it can lease: this replica's previous life's jobs re-claim
        their lease, a dead peer's expired jobs steal (epoch+1), and a
        live peer's jobs are skipped — they stay in the shared journal,
        owned by their replica."""
        assert self._journal is not None
        pending, max_seq = replay_journal(self._journal.path)
        with self._lock:
            self._seq = max(self._seq, max_seq)
        requeued = []
        for record in pending:
            stolen = False
            if self._lease_store is not None:
                foreign = (
                    record.lease_replica is not None
                    and record.lease_replica != self.replica_id
                )
                if foreign:
                    # Startup-replay steals pass the same registered
                    # kill-point as the running steal scan: a kill here
                    # must leave the job claimable by any other replica.
                    faults.kill_point("serve.steal.pre-claim")
                epoch = self._lease_store.claim(
                    record.job_id,
                    steal=True,
                    min_epoch=record.lease_epoch,
                    min_replica=record.lease_replica,
                )
                if epoch is None:
                    continue  # a live peer's job (or we lost the race)
                fresh = self._revalidate_claim(record.job_id, epoch)
                if fresh is None:
                    continue  # settled between our fold and our claim
                record = fresh
                stolen = foreign
                # Registered kill-point: claimed on disk, lease record
                # not yet journaled (same window as the submit path).
                faults.kill_point("serve.lease.post-claim")
                self._journal.lease(record.job_id, epoch, stolen=stolen)
                if stolen:
                    self._jobs_stolen.inc(1)
                    # The merged trace's steal edge: a flow arrow from
                    # the dead owner's last recorded event to this claim.
                    self._trace_event(
                        "steal",
                        job_id=record.job_id,
                        trace=record.trace_id,
                        flush=True,
                        epoch=epoch,
                        **{"from": record.lease_replica},
                    )
            if self._adopt_pending(record, stolen=stolen):
                requeued.append(record)
        if self._lease_store is not None:
            # Lease-aware compaction: only the holder of the journal's
            # exclusive compaction lock compacts (a replica starting
            # while a peer is mid-compaction skips — never two
            # rewriters); the winner re-folds UNDER the lock so peers'
            # concurrent records survive the rewrite.
            compact_journal_shared(
                self._journal.path, lease_dir=self._lease_store.lease_dir
            )
        else:
            # Solo mode: exclusive ownership (enforced by the run-dir
            # guard), so the replay's own pending list is the truth.
            # Began and unparseable records leave the journal (their
            # table entries — when any — are terminal, and replaying
            # them again would be wrong).
            compact_journal(self._journal.path, requeued)

    def _adopt_pending(
        self, record, stolen: bool, count_replayed: bool = True
    ) -> bool:
        """Adopt one replayed/stolen pending job into this replica's
        table and queue; returns ``True`` iff the job was requeued.
        ``stolen`` selects the structured-error wording for jobs whose
        device work had begun under the dead owner."""
        try:
            request = parse_request(record.request_doc)
            conf = _parse_job_flags(request.flags, kind=request.kind)
            conf.device = self.device_type
        except (ProtocolError, ValueError) as e:
            print(
                f"serve: journal record {record.job_id} no longer "
                f"parses ({e}); dropping it",
                file=sys.stderr,
            )
            # A shared journal re-folds at compaction, so a silently
            # skipped record would replay forever: tombstone it.
            if self._journal is not None:
                self._journal.terminal(
                    record.job_id,
                    "rejected",
                    epoch=self._lease_epoch(record.job_id),
                )
            if self._lease_store is not None:
                self._lease_store.release(record.job_id)
            return False
        job = Job(
            id=record.job_id,
            request=request,
            conf=conf,
            job_class=classify_conf(
                conf, small_site_limit=self.small_site_limit
            ),
            submitted_unix=record.submitted_unix,
            deadline_unix=record.deadline_unix,
            batch_key=self._batch_key(conf, request.kind),
            # The restart/steal consumed the job's one free retry: a
            # worker crash on the adopted copy must fail it, not loop
            # it through a third life.
            requeues=1,
            # The journaled trace id keeps the stolen/replayed job in the
            # SAME span tree its submit opened; pre-tracing journals get
            # a fresh id so every adopted job is still traceable.
            trace_id=record.trace_id or mint_trace_id(),
            # The ORIGINAL admission prediction rides the steal/replay
            # (like the trace id): the calibration pair must compare
            # against what admission promised, not a re-prediction under
            # the adopter's warm state.
            cost_prediction=self._cost_from_record(record),
        )
        job.cost_estimate_seconds = (
            job.cost_prediction.best_estimate_seconds
            if job.cost_prediction is not None
            else None
        )
        if count_replayed:
            self._journal_replayed.inc(1)
            self._replayed_jobs += 1
        self._trace_event(
            "adopt",
            job=job,
            flush=True,
            stolen=stolen,
            device_began=record.device_began,
            from_replica=record.lease_replica,
        )
        if adoption_action(record.device_began) == "fail":
            # The requeue-once boundary holds ACROSS replica lives: the
            # journaled began flag was written by whichever life started
            # the device work, and no later life may silently re-run it
            # (the policy itself is journal.adoption_action — shared
            # with the model checker).
            with self._lock:
                self._table[job.id] = job
                self._fail_crashed_locked(
                    job,
                    (
                        f"replica-failover: replica "
                        f"{record.lease_replica or 'unknown'} died after "
                        "this job's device work began; not re-run "
                        "(device state under a crashed update cannot be "
                        "trusted for a silent retry)"
                    )
                    if stolen
                    else (
                        "daemon-restarted: the daemon died after this "
                        "job's device work began; not re-run (device "
                        "state under a crashed update cannot be trusted "
                        "for a silent retry)"
                    ),
                )
            self._journal_terminal(job)
            self._completed.labels(status="failed").inc()
            self._record_failed_cost(job)
            return False
        with self._lock:
            self._table[job.id] = job
        try:
            # Replayed and stolen jobs alike re-enter capacity-exempt
            # (the contract is on inject_reclaimed): their 202 was
            # acknowledged by the previous owner.
            self._queue.inject_reclaimed(job)
        except (QueueFull, QueueClosed) as e:
            with self._lock:
                self._fail_crashed_locked(
                    job,
                    f"{'replica-failover' if stolen else 'daemon-restarted'}"
                    f": could not requeue ({e})",
                )
            self._journal_terminal(job)
            self._completed.labels(status="failed").inc()
            self._record_failed_cost(job)
            return False
        return True

    def begin_drain(self) -> None:
        """Stop admission (new submissions get 503); already-admitted jobs
        still run to completion."""
        self._draining.set()
        self._queue.close()
        # SIGTERM rides through here (serve/http.py's signal handler):
        # the drain decision itself becomes durable immediately.
        self._trace_event("drain-begin", flush=True)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until every slice worker finished every admitted job and
        exited (call :meth:`begin_drain` first). Returns ``False`` on
        timeout. Polls rather than joins: the watchdog may replace a
        crashed worker mid-drain (publish-before-start), and the drain
        only completes when every CURRENT worker exited cleanly with
        nothing left in flight and the job table settled."""
        deadline = (
            None if timeout is None else time.monotonic() + float(timeout)
        )
        while True:
            workers = list(self._workers)
            with self._lock:
                inflight = self._inflight
                # A crash mid-drain leaves the watchdog a beat of
                # settlement work AFTER it started the replacement: the
                # crashed job may still read ``running`` (or transiently
                # ``queued``) while the new worker already drained the
                # queue. The drain contract is "every admitted job
                # reached a terminal state", so wait for the table too.
                unsettled = any(
                    job.status in ("queued", "running")
                    for job in self._table.values()
                )
            if (
                workers
                and all(w.done for w in workers)
                and self._queue.drained
                and inflight == 0
                and not unsettled
            ):
                break
            if not workers:
                # Never started: no worker will ever drain anything —
                # return immediately (queued jobs, if any, are simply
                # abandoned with the service, exactly as before slices).
                break
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.02)
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        self._lease_stop.set()
        if self._lease_thread is not None:
            self._lease_thread.join(timeout=5.0)
            self._lease_thread = None
        if self._lease_store is not None:
            # An intentional departure, not a death: withdraw the
            # heartbeat so surviving peers do not report the pool
            # degraded over a clean scale-down.
            self._lease_store.retire()
        if self._recorder is not None:
            self._trace_event("drained")
            faults.remove_flush_hook(self._flush_recorder)
            self._recorder.close()
        self._calibration.close()
        if self._run_dir_lock is not None:
            self._run_dir_lock.release()
            self._run_dir_lock = None
        return True

    def stop(self, timeout: float = 30.0) -> bool:
        """Drain and join (tests and the CLI's shutdown path)."""
        self.begin_drain()
        return self.wait_drained(timeout=timeout)

    # ------------------------------------------------------------ admission

    def _batch_key(self, conf, kind: str) -> Optional[str]:
        from spark_examples_tpu_torch.utils.cache import batch_compile_fingerprint

        try:
            return batch_compile_fingerprint(conf, kind=kind)
        except Exception:
            return None  # an unkeyable conf simply never coalesces

    def admission_device_bytes(self, job_class: str) -> Optional[int]:
        """The memory budget admission validates ``job_class`` against: the
        first device of the slice that will RUN the job (the card's total
        memory, or the reference's 16 GiB on the CPU); ``None`` before
        :meth:`start` (the validator's device-free default, 16 GiB)."""
        from spark_examples_tpu_torch.ops.gramian import per_device_memory_bytes

        for worker in self._workers:
            if job_class in worker.spec.job_classes:
                return per_device_memory_bytes(worker.devices[0])
        return None

    def admission_devices(self, job_class: str) -> Optional[int]:
        """The device count admission validates ``job_class`` against: the
        count of the slice that will RUN the job (``None`` before
        :meth:`start` — the validator then skips device-bound checks,
        exactly like ``graftcheck plan`` without ``--plan-devices``)."""
        for worker in self._workers:
            if job_class in worker.spec.job_classes:
                return worker.spec.device_count
        return self.device_count

    def submit(self, doc, trace_id: Optional[str] = None) -> Tuple[int, Dict]:
        """One ``POST /v1/jobs`` body → ``(http_status, response_doc)``.
        ``trace_id`` is the client's ``X-Trace-Id`` header (malformed or
        absent → a server-minted id): the job's whole fleet-side life is
        recorded under it."""
        if self.draining:
            self._rejected.labels(code="draining").inc()
            return 503, error_doc(
                "draining",
                "service is draining; submit to another replica",
                retry_after_seconds=30.0,
            )
        try:
            request = parse_request(doc)
        except ProtocolError as e:
            self._rejected.labels(code=e.code).inc()
            return 400, error_doc(e.code, e.message)
        try:
            conf = _parse_job_flags(request.flags, kind=request.kind)
        except ValueError as e:
            self._rejected.labels(code="flag-grammar").inc()
            return 400, error_doc("flag-grammar", str(e))
        for field, flag in _RESERVED_FLAG_FIELDS:
            # `is not None`, not truthiness: --process-id 0 is the
            # canonical coordinator id and must be rejected like any other.
            if getattr(conf, field, None) is not None:
                self._rejected.labels(code="reserved-flag").inc()
                return 400, error_doc(
                    "reserved-flag",
                    f"{flag} is owned by the service and may not ride a "
                    "served job (manifests land at the per-job path; "
                    "multi-controller topology belongs to the daemon "
                    "launch)",
                )
        conf.device = self.device_type

        job_class = classify_conf(
            conf, small_site_limit=self.small_site_limit
        )
        # Device-free admission validation: the graftcheck plan validator
        # over the REAL device count of the slice this class runs on (a
        # small job must fit its small slice, not every device) and the
        # host-memory budget. An exit-2 plan becomes a structured 4xx
        # carrying the plan facts.
        from spark_examples_tpu_torch.check.plan import validate_plan

        report = validate_plan(
            conf,
            plan_devices=self.admission_devices(job_class),
            host_mem_budget=self.host_mem_budget,
            device_bytes=self.admission_device_bytes(job_class),
            # The grm kind admits through the analysis's own plan entry
            # (the analyses admission gate + Gramian proofs); pca and
            # similarity keep the default PCA surface.
            analysis="grm" if request.kind == "grm" else "pca",
        )
        plan_block = {
            "ok": report.ok,
            "issues": [
                {"code": i.code, "severity": i.severity, "message": i.message}
                for i in report.issues
            ],
            "geometry": report.geometry,
            "shape_checks": report.shape_checks,
        }
        if not report.ok:
            error_codes = [
                i.code for i in report.issues if i.severity == "error"
            ]
            status = (
                413 if any(c in MEM_LIMIT_CODES for c in error_codes) else 400
            )
            self._rejected.labels(code="plan-rejected").inc()
            return status, error_doc(
                "plan-rejected",
                "admission plan validation rejected this configuration: "
                + "; ".join(error_codes),
                plan=plan_block,
            )

        # Admission-time cost prediction: the ONE estimator (check/
        # plan.py:predict_job_cost, shared with the plan CLI and bench)
        # over the geometry the validator above just computed — no second
        # validation — then calibrated against the fleet's measured
        # history. Prediction is telemetry plus a feasibility gate; a
        # cost-model failure must never take admission down with it.
        prediction = None
        try:
            from spark_examples_tpu_torch.check.plan import predict_job_cost

            prediction = predict_job_cost(
                conf,
                kind=request.kind,
                plan_devices=self.admission_devices(job_class),
                geometry=report.geometry,
            )
            prediction = self._calibration.calibrated_estimate(prediction)
        except Exception as e:  # noqa: BLE001 — telemetry, not a gate
            print(f"serve: cost prediction failed: {e}", file=sys.stderr)
        if (
            self.deadline_feasibility
            and prediction is not None
            and request.deadline_seconds is not None
            and request.deadline_seconds < prediction.best_estimate_seconds
        ):
            estimate = prediction.best_estimate_seconds
            self._rejected.labels(code="deadline-infeasible").inc()
            doc = error_doc(
                "deadline-infeasible",
                f"deadline_seconds={request.deadline_seconds:.4g} is below "
                f"the calibrated estimate of {estimate:.4g}s for this "
                f"geometry (model predicted "
                f"{prediction.predicted_seconds:.4g}s, "
                f"{prediction.compile} compile, "
                f"{prediction.calibration_samples} calibration samples); "
                "raise the deadline, or start the service with "
                "--no-deadline-feasibility to queue it anyway",
                plan=plan_block,
            )
            doc["cost"] = prediction.to_dict()
            doc["cost"]["requested_deadline_seconds"] = float(
                request.deadline_seconds
            )
            return 413, doc

        now = time.time()
        with self._lock:
            self._seq += 1
            # Replica-stamped ids keep N concurrent admitters collision-
            # free on one shared journal (each replica's sequence only
            # ever continues past what the fold has seen).
            job_id = (
                f"job-{self.replica_id}-{self._seq:06d}"
                if self.replica_id is not None
                else f"job-{self._seq:06d}"
            )
        job = Job(
            id=job_id,
            request=request,
            conf=conf,
            job_class=job_class,
            submitted_unix=now,
            deadline_unix=(
                now + request.deadline_seconds
                if request.deadline_seconds is not None
                else None
            ),
            plan_geometry=dict(report.geometry),
            batch_key=self._batch_key(conf, request.kind),
            trace_id=normalize_trace_id(trace_id) or mint_trace_id(),
            cost_prediction=prediction,
        )
        # The queue orders each class lane by this calibrated estimate
        # (SJF; serve/queue.py) — stamped here so the queue itself stays
        # free of cost-model imports.
        job.cost_estimate_seconds = (
            prediction.best_estimate_seconds
            if prediction is not None
            else None
        )
        with self._lock:
            self._table[job.id] = job
        # Durable admission: journaled BEFORE the queue can hand the job
        # to a worker — a worker's own `began`/`terminal` records must
        # never race ahead of the `accepted` record they refer to (the
        # replay fold is order-insensitive as defense in depth, but the
        # happy path keeps the file causally ordered). A crash between
        # here and the 202 leaves at most one phantom replayed run whose
        # client never got an id — wasted compute, never double-trusted
        # device work; a rejected put below appends a terminal tombstone
        # so the record cannot resurrect.
        self._journal_accepted(job)
        self._trace_event(
            "accepted",
            job=job,
            flush=True,
            job_class=job.job_class,
            kind=job.request.kind,
        )
        # Registered kill-point: accepted record durable, lease NOT yet
        # claimed — the one-record orphan window. A kill here strands a
        # journaled job with no lease file; the steal scan's orphan
        # branch must reclaim it off the dead owner's stale heartbeat.
        faults.kill_point("serve.submit.post-accept")
        if self._lease_store is not None:
            # Lease the job the moment it is durably accepted: from here
            # on a dead replica's work is visibly expired, stealable
            # state rather than invisible in-memory state. The id is
            # fresh, so the epoch-1 claim can only fail if this replica
            # was deposed as a zombie and a peer's orphan sweep already
            # took the job — refuse the admission rather than run a job
            # another replica owns.
            epoch = self._lease_store.claim(job.id)
            if epoch is None:
                # No tombstone: the lease holder (or its stealer) owns
                # the journal's last word on this id. The client never
                # gets this 202, so a later phantom run is wasted
                # compute, never double-trusted device work.
                with self._lock:
                    del self._table[job.id]
                self._rejected.labels(code="lease-unavailable").inc()
                return 503, error_doc(
                    "lease-unavailable",
                    f"could not lease {job.id} (a peer replica claimed "
                    "it — this replica may be recovering from a stall); "
                    "resubmit",
                    retry_after_seconds=5.0,
                )
            # Post-claim stale-fold fence — found by the reference's model checker:
            # if this replica stalled between the accepted append and
            # the claim, a restarting peer may have adopted AND settled
            # the job; enqueueing it now would re-run finished device
            # work. Same revalidation the replay/steal paths use.
            if self._journal is not None:
                if self._revalidate_claim(job.id, epoch) is None:
                    with self._lock:
                        del self._table[job.id]
                    self._rejected.labels(code="lease-unavailable").inc()
                    return 503, error_doc(
                        "lease-unavailable",
                        f"lost the lease race for {job.id} (a peer "
                        "replica adopted it between our accept and our "
                        "claim); resubmit",
                        retry_after_seconds=5.0,
                    )
            # Registered kill-point: lease file linked, its journal
            # record not yet appended (the fold's fence lags the disk).
            faults.kill_point("serve.lease.post-claim")
            if self._journal is not None:
                self._journal.lease(job.id, epoch)
            self._trace_event("lease", job=job, epoch=epoch)
        try:
            self._queue.put(job)
        except QueueFull as e:
            with self._lock:
                del self._table[job.id]
            self._journal_tombstone(job)
            self._rejected.labels(code="queue-full").inc()
            return 429, error_doc(
                "queue-full", str(e), retry_after_seconds=5.0
            )
        except QueueClosed as e:
            with self._lock:
                del self._table[job.id]
            self._journal_tombstone(job)
            self._rejected.labels(code="draining").inc()
            return 503, error_doc(
                "draining", str(e), retry_after_seconds=30.0
            )
        self._submitted.labels(job_class=job.job_class).inc()
        return 202, self._job_doc(job)

    def _journal_accepted(self, job: Job) -> None:
        if self._journal is None:
            return
        self._journal.accepted(
            job_id=job.id,
            request_doc=request_doc(
                job.request.flags,
                kind=job.request.kind,
                deadline_seconds=job.request.deadline_seconds,
                tag=job.request.tag,
            ),
            job_class=job.job_class,
            submitted_unix=job.submitted_unix,
            deadline_unix=job.deadline_unix,
            trace_id=job.trace_id,
            cost=(
                job.cost_prediction.to_dict()
                if job.cost_prediction is not None
                else None
            ),
        )

    def _cost_from_record(self, record):
        """Rehydrate a journaled cost prediction (None on pre-cost
        journals and junk blocks — replay must never die on one)."""
        if not getattr(record, "cost", None):
            return None
        from spark_examples_tpu_torch.obs.costmodel import CostPrediction

        return CostPrediction.from_dict(record.cost)

    def _expire_queued_job(self, job: Job) -> None:
        """The queue's expired-sink target: a job swept out of the queue
        because its deadline passed before any worker reached it. Called
        OUTSIDE the queue lock (see ``BoundedJobQueue.put``); routes to
        the same terminal path a dequeued-too-late job takes."""
        now = time.time()
        with self._lock:
            if job.status != "queued":
                return
            job.status = "failed"
            job.error = (
                f"deadline-exceeded: queued {now - job.submitted_unix:.1f}s,"
                f" deadline was "
                f"{(job.deadline_unix or now) - job.submitted_unix:.1f}s "
                "(swept at admission — expired before any worker freed up)"
            )
            job.finished_unix = now
            self._mark_terminal_locked(job)
        self._journal_terminal(job)
        self._completed.labels(status="failed").inc()

    def _lease_epoch(self, job_id: str) -> Optional[int]:
        return (
            self._lease_store.epoch_of(job_id)
            if self._lease_store is not None
            else None
        )

    def _journal_terminal(self, job: Job) -> None:
        if self._journal is not None:
            self._journal.terminal(
                job.id, job.status, epoch=self._lease_epoch(job.id)
            )
        if self._lease_store is not None:
            self._lease_store.release(job.id)
        self._trace_event(
            "terminal",
            job=job,
            flush=True,
            status=job.status,
            **({"error": job.error} if job.error else {}),
        )

    def _journal_tombstone(self, job: Job) -> None:
        """Admission-path tombstone: the accepted record may not replay."""
        if self._journal is not None:
            self._journal.terminal(
                job.id, "rejected", epoch=self._lease_epoch(job.id)
            )
        if self._lease_store is not None:
            self._lease_store.release(job.id)
        self._trace_event("terminal", job=job, flush=True, status="rejected")

    # --------------------------------------------------------------- lookup

    def job_status(self, job_id: str) -> Tuple[int, Dict]:
        with self._lock:
            job = self._table.get(job_id)
            if job is None:
                return 404, error_doc(
                    "unknown-job", f"no job {job_id!r} on this service"
                )
            return 200, self._job_doc_locked(job)

    def cancel(self, job_id: str) -> Tuple[int, Dict]:
        """Cancel one still-queued job; running and finished jobs conflict
        (a slice worker cannot abandon a dispatched pipeline without
        poisoning the device state every other job on its slice shares)."""
        with self._lock:
            job = self._table.get(job_id)
        if job is None:
            return 404, error_doc(
                "unknown-job", f"no job {job_id!r} on this service"
            )
        removed = self._queue.remove(job_id)
        with self._lock:
            if removed is not None and job.status == "queued":
                job.status = "cancelled"
                job.finished_unix = time.time()
                self._mark_terminal_locked(job)
                doc = self._job_doc_locked(job)
            elif job.status in ("running", "queued"):
                # status 'queued' with removed=None is the pop window:
                # the worker claimed the job but has not flipped it to
                # running yet — it IS about to run, report it as such.
                return 409, error_doc(
                    "job-running",
                    f"job {job_id} is already on the devices; a running "
                    "job cannot be cancelled",
                )
            else:
                return 409, error_doc(
                    "job-finished",
                    f"job {job_id} already reached status {job.status!r}",
                )
        self._journal_terminal(job)
        self._completed.labels(status="cancelled").inc()
        return 200, doc

    # ---------------------------------------------------------------- state

    def healthz(self) -> Dict:
        """Mesh/queue/slice liveness (``GET /healthz``)."""
        uptime = (
            time.time() - self._started_unix
            if self._started_unix is not None
            else None
        )
        workers = list(self._workers)
        with self._lock:
            inflight = self._inflight
            terminal = self._terminal
            total = len(self._table)
            slices = [
                {
                    "name": w.spec.name,
                    "classes": list(w.spec.job_classes),
                    "devices": w.spec.device_count,
                    "busy": w.running_job_id is not None,
                    "worker_alive": (
                        w.thread is not None and w.thread.is_alive()
                    ),
                }
                for w in workers
            ]
        replica_block = None
        degraded = False
        if self._lease_store is not None:
            peers = self._lease_store.peers()
            degraded = any(not p["alive"] for p in peers)
            replica_block = {
                "id": self.replica_id,
                "lease_seconds": self.lease_seconds,
                "grace_seconds": self.lease_grace_seconds,
                "leases_held": len(self._lease_store.owned_jobs()),
                "alive": self._lease_store.alive_count(),
                "peers": peers,
                # Degraded = admitting WITHOUT live failover cover: some
                # known peer stopped heartbeating (its jobs are being
                # stolen). Admission continues — that is the point of
                # replication — but a balancer can see the thinner pool.
                "degraded": degraded,
                "jobs_stolen": int(self._jobs_stolen.value),
                "lease_renewals": int(self._lease_renewals.value),
            }
        doc_status = (
            "draining"
            if self.draining
            else ("degraded" if degraded else "ok")
        )
        return {
            "status": doc_status,
            "replica": replica_block,
            "mesh": {
                "devices": self.device_count,
                "platform": self.platform,
            },
            "slices": slices,
            "queue": {
                "depth": self._queue.depth(),
                "capacity": {
                    "small": self._queue.small_capacity,
                    "large": self._queue.large_capacity,
                },
                "worker_alive": any(s["worker_alive"] for s in slices),
                "worker_restarts": int(self._worker_restarts.value),
            },
            "jobs": {
                "tracked": total,
                "inflight": inflight,
                "terminal": terminal,
            },
            "warm_state": {
                "journal_replayed": self._replayed_jobs,
                "primed_geometries": self._primed_geometries,
                "persistent_cache": self.persistent_cache,
            },
            "uptime_seconds": uptime,
            "run_dir": self.run_dir,
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition (``GET /metrics``) — the registry's
        existing export, unchanged."""
        return self.registry.prometheus_text()

    @staticmethod
    def _merged_quantiles(snapshots) -> Optional[Dict]:
        """Merge same-bucket histogram snapshots (children of one family
        share bucket bounds by construction) and report the standard
        quantile trio — the fleet-stats shape for one latency surface."""
        from spark_examples_tpu_torch.obs.metrics import histogram_quantile

        merged: Dict[str, int] = {}
        total = 0.0
        count = 0
        for snap in snapshots:
            for bound, cumulative in snap["buckets"].items():
                merged[bound] = merged.get(bound, 0) + int(cumulative)
            total += float(snap["sum"])
            count += int(snap["count"])
        if count == 0:
            return None
        snapshot = {"buckets": merged, "sum": total, "count": count}
        return {
            "count": count,
            "mean": total / count,
            "p50": histogram_quantile(snapshot, 0.50),
            "p95": histogram_quantile(snapshot, 0.95),
            "p99": histogram_quantile(snapshot, 0.99),
        }

    def _histogram_by_label(self, name: str, label: str) -> Dict[str, Dict]:
        """Group one histogram family's children by a single label value
        and merge each group's snapshots into quantiles."""
        family = self.registry.get(name)
        if family is None:
            return {}
        groups: Dict[str, List] = {}
        for child in family.children():
            key = child.labels_dict.get(label, "")
            groups.setdefault(key, []).append(child.snapshot())
        out: Dict[str, Dict] = {}
        for key, snaps in sorted(groups.items()):
            merged = self._merged_quantiles(snaps)
            if merged is not None:
                out[key] = merged
        return out

    def fleet_stats(self) -> Dict:
        """``GET /v1/fleet/stats``: per-class latency quantiles, the
        fleet calibration fold, and recovery counters in one JSON
        document. Quantiles and counters are THIS replica's (each
        replica's registry sees its own executions); the calibration
        block is fleet-wide — every replica appends to the one shared
        ledger, and this call re-folds it from disk so peers' completed
        jobs are merged in."""
        from spark_examples_tpu_torch.obs.metrics import (
            SERVE_JOB_WALL_SECONDS,
            SERVE_QUEUE_WAIT_SECONDS,
        )
        from spark_examples_tpu_torch.serve.protocol import protocol_block

        fold = self._calibration.refresh()
        uptime = (
            time.time() - self._started_unix
            if self._started_unix is not None
            else None
        )
        with self._lock:
            tracked = len(self._table)
            inflight = self._inflight
            terminal = self._terminal
        classes: Dict[str, Dict] = {}
        for job_class, wall in self._histogram_by_label(
            SERVE_JOB_WALL_SECONDS, "job_class"
        ).items():
            classes.setdefault(job_class, {})["wall_seconds"] = wall
        for job_class, wait in self._histogram_by_label(
            SERVE_QUEUE_WAIT_SECONDS, "job_class"
        ).items():
            classes.setdefault(job_class, {})["queue_wait_seconds"] = wait
        return {
            "protocol": protocol_block(),
            "replica": self.replica_id,
            "uptime_seconds": uptime,
            "jobs": {
                "tracked": tracked,
                "inflight": inflight,
                "terminal": terminal,
                "queue_depth": self._queue.total_depth(),
            },
            "classes": classes,
            "kinds": self._histogram_by_label(
                SERVE_JOB_WALL_SECONDS, "kind"
            ),
            "compile": self._histogram_by_label(
                SERVE_JOB_WALL_SECONDS, "compile"
            ),
            "calibration": fold.summary(),
            # Fused vs serial partitions every executed job: the fleet's
            # live answer to "is batch fusion actually engaging?".
            "dispatch": {
                "fused_groups": int(self._fused_groups.value),
                "fused_jobs": int(self._fused_jobs.value),
                "serial_jobs": int(self._serial_jobs.value),
            },
            "counters": {
                "jobs_stolen": int(self._jobs_stolen.value),
                "worker_restarts": int(self._worker_restarts.value),
                "journal_replayed": int(self._journal_replayed.value),
                "lease_renewals": int(self._lease_renewals.value),
                "replicas_alive": (
                    self._lease_store.alive_count()
                    if self._lease_store is not None
                    else 0
                ),
            },
            "run_dir": self.run_dir,
        }

    def _mark_terminal_locked(self, job: Job) -> None:
        """Lifetime counter + bounded retention: the oldest terminal
        records past ``terminal_retention`` leave the table (their
        manifests stay on disk; a later status query is 404 by design —
        the in-memory control plane must stay O(retention), not O(jobs
        ever served)."""
        self._terminal += 1
        self._terminal_order.append(job.id)
        while len(self._terminal_order) > self.terminal_retention:
            evicted = self._terminal_order.popleft()
            self._table.pop(evicted, None)

    def _job_doc(self, job: Job) -> Dict:
        with self._lock:
            return self._job_doc_locked(job)

    def _job_doc_locked(self, job: Job) -> Dict:
        return job_doc(
            job_id=job.id,
            kind=job.request.kind,
            job_class=job.job_class,
            status=job.status,
            tag=job.request.tag,
            submitted_unix=job.submitted_unix,
            started_unix=job.started_unix,
            finished_unix=job.finished_unix,
            seconds=job.seconds,
            error=job.error,
            result=job.result,
            manifest_path=job.manifest_path,
            compile_cache=job.compile_cache,
            plan_geometry=job.plan_geometry,
            slice_name=job.slice,
            batch_size=job.batch_size,
            fused_size=job.fused_size,
            trace=job.trace_id,
            cost=self._job_cost_doc_locked(job),
        )

    def _job_cost_doc_locked(self, job: Job) -> Optional[Dict]:
        """The job envelope's ``cost`` block: the admission prediction
        with measured fields merged in once they exist."""
        prediction = job.cost_prediction
        if prediction is None:
            return None
        doc = prediction.to_dict()
        if job.queue_wait_seconds is not None:
            doc["queue_wait_seconds"] = job.queue_wait_seconds
        if job.seconds is not None:
            doc["measured_seconds"] = job.seconds
        if job.compile_cache:
            doc["compile"] = job.compile_cache
        return doc

    # --------------------------------------------------------------- worker

    def _worker_loop(self, worker: _SliceWorker) -> None:
        classes = worker.spec.job_classes
        while True:
            batch = self._queue.pop_batch(
                timeout=0.2,
                classes=classes,
                max_batch=self.batch_max_jobs,
                linger_seconds=self.batch_linger_seconds,
            )
            if not batch:
                if self._queue.drained_for(classes):
                    return
                continue
            self._run_batch(worker, batch)

    def _run_batch(self, worker: _SliceWorker, batch: List[Job]) -> None:
        """One dispatch group: the batch's jobs on this slice's warm
        caches. When fusion is on and the group preflights eligible, the
        whole group runs as ONE stacked device program
        (:meth:`_run_fused`); otherwise the jobs run back to back.
        Results are identical either way — batching and fusion only
        remove inter-job queue latency, re-pops, and per-job dispatch."""
        if len(batch) > 1:
            self._batches.inc(1)
            self._batch_jobs.inc(len(batch))
        if (
            self.batch_fuse
            and len(batch) > 1
            # Custom executors (embedders, test stubs) know nothing of
            # fused groups — fusion exists only for the real executor.
            and self._executor is execute_job
        ):
            from spark_examples_tpu_torch.pipeline.fused import (
                FusedIneligible,
                preflight_fused,
            )

            try:
                # Device-free eligibility check BEFORE any lifecycle
                # mutation: an ineligible group falls through to the
                # serial loop with zero observable difference.
                preflight_fused(
                    [job.conf for job in batch],
                    [job.request.kind for job in batch],
                )
            except FusedIneligible as e:
                self._trace_event(
                    "fuse-ineligible",
                    job=batch[0],
                    tid=worker.spec.name,
                    reason=str(e),
                    group=len(batch),
                )
            else:
                self._run_fused(worker, batch)
                return
        with self._lock:
            worker.pending_batch = list(batch)
        for job in batch:
            job.batch_size = len(batch)
            with self._lock:
                if job in worker.pending_batch:
                    worker.pending_batch.remove(job)
            self._run_job(worker, job)
        with self._lock:
            worker.pending_batch = []

    def _run_fused(self, worker: _SliceWorker, batch: List[Job]) -> None:
        """One ELIGIBLE dispatch group as one stacked device program:
        predispatch every member (the same fences and journal boundary
        the serial path crosses), hand the survivors to
        ``executor.execute_fused_batch`` as one call, then settle each
        member with its own outcome. A member that expires or loses its
        lease at predispatch drops out of the group — the stacked
        program runs over the survivors only."""
        with self._lock:
            worker.pending_batch = list(batch)
        dispatched: List[Job] = []
        for job in batch:
            job.batch_size = len(batch)
            job.fused_size = len(batch)
            with self._lock:
                if job in worker.pending_batch:
                    worker.pending_batch.remove(job)
            if self._predispatch_job(worker, job):
                dispatched.append(job)
        with self._lock:
            worker.pending_batch = []
        if not dispatched:
            return
        # The journaled began records carry the PLANNED group size; the
        # envelope reports what actually dispatched.
        for job in dispatched:
            job.fused_size = len(dispatched)
        started = time.perf_counter()
        outcomes: Optional[List[ExecutionOutcome]] = None
        error: Optional[str] = None
        try:
            with self.spans.span(
                f"fused group x{len(dispatched)} "
                f"[{dispatched[0].request.kind}/{worker.spec.name}]"
            ), worker.on_streams():
                outcomes = execute_fused_batch(dispatched, self.run_dir)
                worker.synchronize()
        except Exception as e:  # noqa: BLE001 — the group FAILS, the service lives
            # Past predispatch every member's device_began is journaled:
            # a failure fails the WHOLE group (no silent serial retry —
            # the requeue-once boundary holds for fused members too).
            error = f"{type(e).__name__}: {e}"
        wall = time.perf_counter() - started
        # Amortized marginal cost: the group shared one device program,
        # so each member's measured wall — the quantity the calibration
        # ledger learns per geometry — is its share of the group's.
        seconds = wall / len(dispatched)
        if error is None:
            self._fused_groups.inc(1)
            self._fused_jobs.inc(len(dispatched))
        for idx, job in enumerate(dispatched):
            outcome = outcomes[idx] if outcomes is not None else None
            self._settle_job(worker, job, outcome, error, seconds)

    def _predispatch_job(self, worker: _SliceWorker, job: Job) -> bool:
        """Everything between dequeue and the executor call: queue-wait
        stamping, the deadline and lease fences, the running flip, the
        durable requeue-once boundary. Returns False when the job
        terminated (expired or abandoned) before device work — the
        caller must not execute it. Shared verbatim by the serial path
        (:meth:`_run_job`) and the fused group path (:meth:`_run_fused`),
        so a fused member's lifecycle records are indistinguishable from
        a serial member's up to the executor call."""
        now = time.time()
        # Queue wait is a fact the moment the worker holds the job,
        # whatever happens next (run, expire, lease-lost abandon).
        job.dequeued_unix = now
        job.queue_wait_seconds = max(0.0, now - job.submitted_unix)
        self._queue_wait_seconds.labels(job_class=job.job_class).observe(
            job.queue_wait_seconds
        )
        if job.deadline_unix is not None and now > job.deadline_unix:
            with self._lock:
                job.status = "failed"
                job.error = (
                    f"deadline-exceeded: queued "
                    f"{now - job.submitted_unix:.1f}s, deadline was "
                    f"{job.deadline_unix - job.submitted_unix:.1f}s"
                )
                job.finished_unix = now
                self._mark_terminal_locked(job)
            self._journal_terminal(job)
            self._completed.labels(status="failed").inc()
            return False
        if (
            self._lease_store is not None
            and not self._lease_store.still_owner(job.id)
        ):
            # Deposed while queued (stalled renewals, clock skew): the
            # job belongs to whichever replica stole the lease. Abandon
            # BEFORE any device work and publish nothing — no terminal
            # record (the stealer owns the journal's last word), only a
            # local status for this replica's pollers.
            self._lease_store.forget(job.id)
            with self._lock:
                self._fail_crashed_locked(
                    job,
                    "lease-lost: this replica's lease on the job expired "
                    "before dispatch; a peer replica owns it now and its "
                    "run decides the outcome",
                )
            self._completed.labels(status="failed").inc()
            self._trace_event(
                "abandoned", job=job, flush=True, reason="lease-lost"
            )
            return False
        with self._lock:
            job.status = "running"
            job.started_unix = now
            job.slice = worker.spec.name
            worker.running_job_id = job.id
            self._inflight += 1
        self._slice_inflight.labels(slice=worker.spec.name).set(1)
        # The job span opens on the slice's thread lane; flushed so an
        # arbitrary-time kill still leaves the B durable (the exporter
        # closes a B whose E died with the process as a truncated span).
        self._trace_event(
            "job",
            ph="B",
            job=job,
            tid=worker.spec.name,
            flush=True,
            job_class=job.job_class,
            kind=job.request.kind,
            batch_size=job.batch_size,
            **({"fused_size": job.fused_size} if job.fused_size > 1 else {}),
            # Durable on THIS replica's segment before any kill-point:
            # the post-mortem report's queue-wait source for a job whose
            # owner (and its histograms) died mid-run.
            queue_wait=job.queue_wait_seconds,
            **(
                {"epoch": self._lease_epoch(job.id)}
                if self._lease_store is not None
                else {}
            ),
        )
        # Registered kill-point: job claimed and flipped to running, BEFORE
        # any device work — the requeue-eligible window (a crash here is
        # side-effect-free; the watchdog re-puts the job once).
        faults.kill_point("serve.worker.claim")
        with self._lock:
            job.device_began = True
        # Durable requeue-once boundary: the journal must know device work
        # began BEFORE it begins — a process death after this line must
        # not silently re-run the job on restart, whichever replica
        # replays or steals it.
        if self._journal is not None:
            self._journal.began(
                job.id,
                epoch=self._lease_epoch(job.id),
                fused_size=job.fused_size,
            )
        self._trace_event(
            "device-began",
            job=job,
            tid=worker.spec.name,
            flush=True,
            **(
                {"epoch": self._lease_epoch(job.id)}
                if self._lease_store is not None
                else {}
            ),
        )
        # Registered kill-point: device work marked begun, executor about
        # to run — a crash from here on must NOT be requeued (device state
        # under a crashed update cannot be trusted for a silent retry).
        faults.kill_point("serve.worker.mid-job")
        # The slice's devices ride the job record down to the executor
        # (the executor's callable signature stays (job, run_dir) for
        # embedders and test stubs).
        job.slice_devices = worker.devices
        return True

    def _run_job(self, worker: _SliceWorker, job: Job) -> None:
        if not self._predispatch_job(worker, job):
            return
        self._serial_jobs.inc(1)
        started = time.perf_counter()
        outcome: Optional[ExecutionOutcome] = None
        error: Optional[str] = None
        try:
            with self.spans.span(
                f"job {job.id} [{job.request.kind}/{worker.spec.name}]"
            ), worker.on_streams():
                outcome = self._executor(job, self.run_dir)
                worker.synchronize()
        except Exception as e:  # noqa: BLE001 — the job FAILS, the service lives
            error = f"{type(e).__name__}: {e}"
        seconds = time.perf_counter() - started
        self._settle_job(worker, job, outcome, error, seconds)

    def _settle_job(
        self,
        worker: _SliceWorker,
        job: Job,
        outcome: Optional[ExecutionOutcome],
        error: Optional[str],
        seconds: float,
    ) -> None:
        """Everything after the executor returns: the pre-publish lease
        fence, the terminal flip, tracing, journaling, counters, and the
        calibration pair. For a fused group member ``seconds`` is the
        group wall divided by the group size — the amortized marginal
        cost, which is exactly what the calibration ledger should learn
        for a job that rode a shared device program."""
        if (
            self._lease_store is not None
            and not self._lease_store.still_owner(job.id)
        ):
            # The pre-publish fence: a zombie replica (paused past its
            # lease, deposed by a stealer's higher epoch) must detect the
            # loss and abandon BEFORE publishing — no terminal record, no
            # result; the stolen run's terminal is the journal's only
            # valid word on this job (and fold-time epoch fencing ignores
            # this replica's write even if a pause landed it anyway).
            self._lease_store.forget(job.id)
            with self._lock:
                job.finished_unix = time.time()
                job.seconds = seconds
                self._inflight -= 1
                worker.running_job_id = None
                self._fail_crashed_locked(
                    job,
                    "lease-lost: this replica was deposed while the job "
                    "ran (lease expired past the grace window); result "
                    "abandoned unpublished — the stealing replica's run "
                    "decides the outcome",
                )
            self._slice_inflight.labels(slice=worker.spec.name).set(0)
            self._completed.labels(status="failed").inc()
            self._trace_event(
                "job",
                ph="E",
                job=job,
                tid=worker.spec.name,
                flush=True,
                status="failed",
                abandoned="lease-lost",
            )
            return
        with self._lock:
            job.finished_unix = time.time()
            job.seconds = seconds
            self._inflight -= 1
            worker.running_job_id = None
            self._mark_terminal_locked(job)
            if error is not None:
                job.status = "failed"
                job.error = error
            else:
                job.status = "done"
                job.result = outcome.result
                job.manifest_path = outcome.manifest_path
                job.compile_cache = outcome.compile_cache
        self._slice_inflight.labels(slice=worker.spec.name).set(0)
        self._trace_event(
            "job",
            ph="E",
            job=job,
            tid=worker.spec.name,
            status=job.status,
            compile_cache=job.compile_cache,
            **({"error": error} if error else {}),
        )
        if outcome is not None and outcome.conformance:
            self._mirror_conformance(outcome.conformance)
        self._journal_terminal(job)
        self._completed.labels(status=job.status).inc()
        self._job_seconds.labels(job_class=job.job_class).observe(seconds)
        self._job_wall_seconds.labels(
            kind=job.request.kind,
            job_class=job.job_class,
            compile=job.compile_cache
            or (
                job.cost_prediction.compile
                if job.cost_prediction is not None
                else "cold"
            ),
        ).observe(seconds)
        if job.status == "done":
            self._record_job_cost(job, seconds)
            self._stamp_manifest_cost(job)
        else:
            self._record_failed_cost(job)

    def _record_job_cost(self, job: Job, seconds: float) -> None:
        """Feed one COMPLETED job's (predicted, measured) pair into the
        fleet calibration ledger and the ratio gauge. Done-only: a failed
        job's wall clock measures the failure path, not the geometry's
        cost, and would poison the learned ratios. Best-effort — the
        ledger is telemetry, never a reason to fail a finished job."""
        prediction = job.cost_prediction
        if prediction is None:
            return
        try:
            if prediction.predicted_seconds > 0:
                self._prediction_ratio.labels(kind=job.request.kind).set(
                    seconds / prediction.predicted_seconds
                )
            self._calibration.record(
                fingerprint=prediction.fingerprint,
                kind=job.request.kind,
                job_class=job.job_class,
                predicted_seconds=prediction.predicted_seconds,
                measured_seconds=seconds,
                queue_wait_seconds=job.queue_wait_seconds or 0.0,
                compile=job.compile_cache or prediction.compile,
                job_id=job.id,
                trace_id=job.trace_id,
                unix=job.finished_unix,
            )
        except Exception as e:  # noqa: BLE001 — telemetry, not the job
            print(
                f"serve: calibration record failed for {job.id}: {e}",
                file=sys.stderr,
            )

    def _record_failed_cost(self, job: Job) -> None:
        """A failed job (crashed executor, fenced-off steal) still gets a
        ledger row — ``status: failed``, which the ratio fold skips — so
        the post-mortem report can put its fleet-side wall (submission
        to fenced terminal) next to what admission predicted. The
        queue wait is omitted when this replica never dequeued the job
        (the owner that did may be dead; its flight-recorder segment
        holds the wait). Best-effort, like every ledger write."""
        prediction = job.cost_prediction
        if prediction is None:
            return
        try:
            settled = job.finished_unix or time.time()
            self._calibration.record(
                fingerprint=prediction.fingerprint,
                kind=job.request.kind,
                job_class=job.job_class,
                predicted_seconds=prediction.predicted_seconds,
                measured_seconds=max(0.0, settled - job.submitted_unix),
                queue_wait_seconds=job.queue_wait_seconds,
                compile=job.compile_cache or prediction.compile,
                job_id=job.id,
                trace_id=job.trace_id,
                unix=settled,
                status="failed",
            )
        except Exception as e:  # noqa: BLE001 — telemetry, not the job
            print(
                f"serve: calibration record failed for {job.id}: {e}",
                file=sys.stderr,
            )

    def _stamp_manifest_cost(self, job: Job) -> None:
        """Rewrite the finished job's manifest with its ``cost`` block
        (predicted vs measured vs queue wait) — the per-job half of the
        ledger, queryable post-mortem without the service. Atomic
        (``obs/manifest.py:write_manifest``) and best-effort."""
        prediction = job.cost_prediction
        if prediction is None or not job.manifest_path:
            return
        try:
            from spark_examples_tpu_torch.obs.manifest import (
                read_manifest,
                write_manifest,
            )

            doc = read_manifest(job.manifest_path)
            cost = prediction.to_dict()
            cost["measured_seconds"] = job.seconds
            cost["queue_wait_seconds"] = job.queue_wait_seconds or 0.0
            cost["compile"] = job.compile_cache or prediction.compile
            doc["cost"] = cost
            write_manifest(job.manifest_path, doc)
        except Exception as e:  # noqa: BLE001 — telemetry, not the job
            print(
                f"serve: manifest cost stamp failed for {job.id}: {e}",
                file=sys.stderr,
            )

    def _mirror_conformance(self, block: Dict) -> None:
        """Mirror a completed job's manifest ``conformance`` block into
        the SERVICE registry (last-write-wins per prover), so ``GET
        /metrics`` exports the fleet's latest measured-vs-proven pair —
        a scrape sees prover conformance without chasing per-job
        manifests. Best-effort: a malformed block is dropped, never a
        job failure."""
        from spark_examples_tpu_torch.obs.metrics import record_prover_conformance

        for prover, pair in block.items():
            if not isinstance(pair, dict):
                continue
            measured = pair.get("measured")
            if not isinstance(measured, (int, float)):
                continue
            proven = pair.get("proven")
            try:
                record_prover_conformance(
                    self.registry,
                    prover,
                    measured,
                    proven if isinstance(proven, (int, float)) else None,
                )
            except Exception:
                continue

    # ------------------------------------------------------------- watchdog

    def _watchdog_loop(self) -> None:
        """Monitor every slice worker's pulse; replace any that dies.

        A worker loop only returns by contract when the queue is closed
        AND drained of its classes — any other exit is a crash (an
        escaped ``BaseException``; the deterministic stand-in is
        ``utils/faults.InjectedWorkerCrash``, which by design escapes the
        job-failure ``except Exception``). The watchdog applies the
        recovery policy (:meth:`_recover_worker`) per slice — a crashing
        whole-genome job can never take a small-slice worker with it —
        and exits only when every slice drained cleanly."""
        while True:
            workers = self._workers
            if not workers or all(w.done for w in workers):
                return
            for worker in workers:
                if worker.done:
                    continue
                thread = worker.thread
                if thread is None:
                    worker.done = True
                    continue
                thread.join(timeout=WATCHDOG_INTERVAL_SECONDS)
                if thread.is_alive():
                    continue
                with self._lock:
                    running = worker.running_job_id
                    settled = not worker.pending_batch
                if (
                    running is None
                    and settled
                    and self._queue.drained_for(worker.spec.job_classes)
                ):
                    # Contract exit: this slice drained every job it owed.
                    worker.done = True
                    continue
                self._recover_worker(worker)

    def _recover_worker(self, worker: _SliceWorker) -> None:
        """One dead slice worker: settle its in-flight job, requeue its
        untouched batch tail, start a replacement on the same slice.

        Policy (the acceptance contract of the chaos tests):
        - an in-flight job that had NOT begun device work is requeued
          once — its claim was side-effect-free, so one silent retry is
          safe and invisible to the client;
        - an in-flight job that touched the devices (or already rode its
          one requeue) is marked ``failed`` with a structured
          ``worker-crashed:`` error — the slice stays healthy, the
          client gets a terminal status instead of a forever-running job;
        - jobs popped into the dispatch group but never started are
          requeued unconditionally (they were never claimed);
        - a fresh worker thread takes over the slice either way.
        """
        with self._lock:
            crashed: Optional[Job] = None
            if worker.running_job_id is not None:
                crashed = self._table.get(worker.running_job_id)
                worker.running_job_id = None
                # The crashed worker never reached its decrement; the new
                # worker owns the gauge the moment it claims a job.
                self._inflight = max(0, self._inflight - 1)
            untouched = list(worker.pending_batch)
            worker.pending_batch = []
        self._slice_inflight.labels(slice=worker.spec.name).set(0)
        if crashed is not None:
            # Close the dead worker's open job span (the B was recorded
            # on the worker thread; pairing is by (replica, job, name),
            # so this E from the watchdog thread closes it cleanly).
            self._trace_event(
                "job",
                ph="E",
                job=crashed,
                tid=worker.spec.name,
                flush=True,
                status="worker-crashed",
            )
        # Replacement FIRST, job settlement second: a client that observes
        # the crashed job's terminal status (or its requeue) must never
        # then find healthz reporting a dead worker — the failure and the
        # recovery must be visible in that order, not the reverse.
        self._worker_restarts.inc(1)
        replacement = threading.Thread(
            target=self._worker_loop,
            args=(worker,),
            name=f"serve-worker-{worker.spec.name}",
            daemon=True,
        )
        worker.thread = replacement
        replacement.start()
        for job in untouched:
            # Never claimed: re-admission is free (does not consume the
            # one requeue), preserves class ordering, and is
            # capacity-exempt — these jobs already held queue slots.
            try:
                self._queue.put(job, enforce_capacity=False)
            except (QueueFull, QueueClosed) as e:
                with self._lock:
                    self._fail_crashed_locked(
                        job,
                        f"worker-crashed: dispatch-group requeue rejected "
                        f"({e})",
                    )
                self._journal_terminal(job)
                self._completed.labels(status="failed").inc()
        if crashed is None:
            return
        with self._lock:
            requeue = not crashed.device_began and crashed.requeues < 1
            if requeue:
                crashed.requeues += 1
                crashed.status = "queued"
                crashed.started_unix = None
            else:
                self._fail_crashed_locked(
                    crashed,
                    "worker-crashed: the worker thread died mid-job "
                    "after device work began; not requeued (device "
                    "state under a crashed update cannot be trusted)"
                    if crashed.device_began
                    else "worker-crashed: the worker thread died "
                    "mid-claim and the job already rode its one "
                    "requeue",
                )
        if requeue:
            try:
                # Outside the table lock (the admission path's lock
                # order); capacity-exempt like the batch tail above.
                self._queue.put(crashed, enforce_capacity=False)
            except (QueueFull, QueueClosed) as e:
                with self._lock:
                    self._fail_crashed_locked(
                        crashed,
                        f"worker-crashed: requeue rejected ({e}); the "
                        "claim was side-effect-free but the queue would "
                        "not take the job back",
                    )
                self._journal_terminal(crashed)
                self._completed.labels(status="failed").inc()
        else:
            self._journal_terminal(crashed)
            self._completed.labels(status="failed").inc()

    # ----------------------------------------------------- lease protocol

    def _lease_loop(self) -> None:
        """The replica's lease-maintenance thread: heartbeat + renewals
        every TTL/``LEASE_RENEWALS_PER_TTL``, and a steal scan every
        ``steal_interval_seconds``. Maintenance errors are logged, never
        fatal — a replica that cannot renew simply loses its leases to a
        peer, which is the designed degradation, not a crash."""
        interval = self.lease_seconds / LEASE_RENEWALS_PER_TTL
        last_steal = time.monotonic()
        while not self._lease_stop.wait(timeout=interval):
            try:
                self._lease_tick()
                now = time.monotonic()
                if now - last_steal >= self.steal_interval_seconds:
                    last_steal = now
                    self._steal_expired()
                    self._maybe_compact()
            except Exception as e:  # noqa: BLE001 — maintenance survives
                print(
                    f"serve[{self.replica_id}]: lease maintenance error: "
                    f"{type(e).__name__}: {e}",
                    file=sys.stderr,
                )

    def _lease_tick(self) -> None:
        """One maintenance beat: publish liveness, renew every owned
        lease, abandon any we lost (stolen by a peer, or expired under a
        stall — renewing a lapsed lease would race its stealer)."""
        store = self._lease_store
        assert store is not None
        store.heartbeat()
        owned = store.owned_jobs()
        if not owned:
            return
        # Registered kill-point: this replica owns leases and is about to
        # renew them — a kill here is the canonical host loss (every
        # lease lapses unrenewed; peers steal the jobs). `crash` kills
        # just this maintenance thread: the in-process stand-in.
        faults.kill_point("serve.lease.pre-renew")
        for job_id in owned:
            if store.renew(job_id):
                self._lease_renewals.inc(1)
            else:
                self._abandon_lease_lost(job_id)

    def _abandon_lease_lost(self, job_id: str) -> None:
        """A lease this replica held is gone. A still-QUEUED job is
        pulled from the queue and failed locally WITHOUT a terminal
        record — the journal's last word belongs to the job's new owner.
        A running (or mid-claim) job is left to ``_run_job``'s
        pre-publish fence, which performs the same abandonment at the
        moment publication would have happened."""
        assert self._lease_store is not None
        self._lease_store.forget(job_id)
        removed = self._queue.remove(job_id)
        if removed is None:
            return  # running / popped: the pre-publish fence decides
        with self._lock:
            job = self._table.get(job_id)
            if job is None or job.status != "queued":
                return
            self._fail_crashed_locked(
                job,
                "lease-lost: this replica's lease expired before "
                "dispatch; a peer replica owns the job now and its run "
                "decides the outcome",
            )
        self._completed.labels(status="failed").inc()
        self._trace_event(
            "abandoned", job=job, flush=True, reason="lease-lost"
        )

    def _steal_expired(self) -> None:
        """Scan for jobs whose lease expired because their owner died,
        and reclaim them under a fencing epoch. The journal fold (NOT
        the lease file) decides live-ness of the job itself: a lease
        left behind by a settled job is skipped, and compaction sweeps
        it. Stolen jobs keep their original deadline budget — an
        expired one fails with the structured ``deadline-exceeded`` code
        at re-dispatch instead of running late.

        Candidates are claimed in descending calibrated-cost order (cost
        unknown sorts last): when several replicas race over a dead
        owner's orphans, each claim is one lease link and loses work to
        contention — spending the first, least-contended claims on the
        most expensive stranded jobs recovers the most stranded seconds
        per scan. File order breaks ties, so the scan stays
        deterministic for a given journal."""
        store = self._lease_store
        assert store is not None
        if self.draining or self._journal is None:
            return  # a draining replica must not adopt work it won't run
        expired = {view.job_id for view in store.expired_foreign()}
        peers = store.peers()
        if not expired and all(p["alive"] for p in peers):
            # Steady state: nothing expired and every known peer is
            # heartbeating — orphans need a dead owner, and an owner
            # always heartbeats before its first admission. Skip the
            # journal fold entirely (the scan stays O(listdir)).
            return
        pending, _max_seq = replay_journal(self._journal.path)
        alive_peers = {p["id"] for p in peers if p["alive"]}
        # Candidate selection (expired foreign leases + accepted-but-
        # never-leased orphans of dead owners) is the pure
        # journal.steal_candidates — shared with the model checker.
        candidates = steal_candidates(
            pending,
            expired,
            self.replica_id,
            alive_peers,
            lambda job_id: store.current(job_id) is not None,
        )
        for record in sorted(
            enumerate(candidates),
            key=lambda pair: (-self._record_steal_cost(pair[1]), pair[0]),
        ):
            self._steal_one(record[1])

    def _record_steal_cost(self, record) -> float:
        """The journaled admission estimate of one steal candidate, for
        highest-cost-first claim ordering; ``-inf`` when the record
        predates cost predictions (those sort last, in file order)."""
        prediction = self._cost_from_record(record)
        if prediction is None:
            return float("-inf")
        return float(prediction.best_estimate_seconds)

    def _steal_one(self, record) -> None:
        store = self._lease_store
        assert store is not None and self._journal is not None
        # Registered kill-point: steal target identified, fencing epoch
        # about to be link-claimed — a kill here must leave the job
        # claimable by any other replica.
        faults.kill_point("serve.steal.pre-claim")
        epoch = store.claim(
            record.job_id,
            steal=True,
            min_epoch=record.lease_epoch,
            min_replica=record.lease_replica,
        )
        if epoch is None:
            return  # another stealer won the link race (or owner woke)
        fresh = self._revalidate_claim(record.job_id, epoch)
        if fresh is None:
            return  # settled between our fold and our claim
        # Registered kill-point: claimed on disk, lease record not yet
        # journaled (same window as the submit path).
        faults.kill_point("serve.lease.post-claim")
        self._journal.lease(record.job_id, epoch, stolen=True)
        self._jobs_stolen.inc(1)
        self._trace_event(
            "steal",
            job_id=record.job_id,
            trace=fresh.trace_id,
            flush=True,
            epoch=epoch,
            **{"from": record.lease_replica},
        )
        self._adopt_pending(fresh, stolen=True, count_replayed=False)

    def _maybe_compact(self) -> None:
        """Bound the shared journal — and every fold over it — across a
        long-lived replica's life: startup compaction alone would let
        settled-job records accumulate until the next restart. When the
        file outgrows the threshold, the compaction-lock holder rewrites
        it to O(pending); losers skip and retry at a later scan."""
        if self._journal is None or self._lease_store is None:
            return
        try:
            size = os.path.getsize(self._journal.path)
        except OSError:
            return
        if size >= JOURNAL_COMPACT_BYTES:
            compact_journal_shared(
                self._journal.path, lease_dir=self._lease_store.lease_dir
            )

    def _revalidate_claim(self, job_id: str, epoch: int):
        """Post-claim fence against a STALE FOLD: between the fold a
        steal decision was made from and the claim itself, the job's
        previous holder may have settled it and released its lease —
        which is exactly what would have made our claim succeed at a
        fresh epoch. The settle's terminal write strictly precedes the
        lease unlink, so a re-fold AFTER a successful claim necessarily
        sees it: a settled (or higher-fenced) job abandons the claim
        before any lease record is journaled or any work adopted.
        Returns the re-folded pending record to adopt, or ``None``. The
        fence itself is the pure journal.revalidate_pending — shared
        with the model checker."""
        assert self._journal is not None and self._lease_store is not None
        pending, _max_seq = replay_journal(self._journal.path)
        record = revalidate_pending(pending, job_id, epoch)
        if record is not None:
            # Re-folded, not the caller's snapshot: the record's
            # began/deadline facts are as fresh as the fence.
            return record
        self._lease_store.release(job_id)
        return None

    def _fail_crashed_locked(self, job: Job, error: str) -> None:
        job.status = "failed"
        job.error = error
        job.finished_unix = time.time()
        self._mark_terminal_locked(job)


__all__ = [
    "LEASE_RENEWALS_PER_TTL",
    "MEM_LIMIT_CODES",
    "PcaService",
    "WATCHDOG_INTERVAL_SECONDS",
]
