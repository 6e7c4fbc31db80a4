"""Thin stdlib HTTP front-end of the resident PCA service.

The port's copy of ``spark_examples_tpu/serve/http.py``: the same routes,
bodies and flags, plus ``--device`` (``cuda``, the default: every card,
exiting 1 before it binds when there is none; ``cpu`` for tests).

No new dependencies: ``http.server.ThreadingHTTPServer`` carries the
JSON protocol (``serve/protocol.py``) onto :class:`PcaService`
(``serve/daemon.py``). Routes:

- ``POST /v1/jobs``            — submit (202 admitted; 400/413 plan
  rejection with the plan facts in the body; 429 backpressure; 503
  draining)
- ``GET  /v1/jobs/<id>``       — job status/result
- ``POST /v1/jobs/<id>/cancel``— cancel a queued job (409 once running)
- ``GET  /metrics``            — Prometheus text export of the service
  registry (``obs/metrics.py``)
- ``GET  /v1/fleet/stats``     — per-class latency quantiles + the fleet
  calibration fold (``serve/daemon.py:fleet_stats``)
- ``GET  /healthz``            — mesh/queue liveness JSON

``serve_main`` is the ``python -m spark_examples_tpu_torch serve`` entry
point: it brings up the devices once, binds the server (``--port 0``
picks an ephemeral port; ``--endpoint-file`` publishes the bound URL for
scripts), and installs the graceful-drain signal handlers — SIGTERM (or
SIGINT) stops admission with 503, lets the worker finish every admitted
job, then exits 0.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

from spark_examples_tpu_torch.serve.daemon import (
    DEFAULT_TERMINAL_RETENTION,
    PcaService,
)
from spark_examples_tpu_torch.serve.journal import (
    DEFAULT_LEASE_SECONDS,
    RunDirBusy,
)
from spark_examples_tpu_torch.serve.protocol import error_doc
from spark_examples_tpu_torch.serve.queue import (
    DEFAULT_AGE_CAP_SECONDS,
    DEFAULT_BATCH_LINGER_SECONDS,
    DEFAULT_BATCH_MAX_JOBS,
    DEFAULT_LARGE_CAPACITY,
    DEFAULT_SMALL_CAPACITY,
    SMALL_JOB_MAX_SITES,
)

#: Largest accepted request body: a flag list is hundreds of bytes; one
#: MiB of headroom keeps admission O(1) in host memory no matter what a
#: client posts (oversized bodies are 413 without being read further).
MAX_BODY_BYTES = 1 << 20

#: ``Retry-After`` hint on non-terminal job-status responses: the poll
#: cadence the server ASKS for (a small-job completion is sub-second
#: warm; half a second keeps the client snappy without hammering a
#: daemon mid-whole-genome-job).
POLL_RETRY_AFTER_SECONDS = 0.5


class ServeHandler(BaseHTTPRequestHandler):
    """One request; ``self.server.service`` is the :class:`PcaService`."""

    server_version = "spark-examples-tpu-serve/1"
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------- plumbing

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        if getattr(self.server, "verbose", False):
            sys.stderr.write(
                f"serve[{self.address_string()}]: {format % args}\n"
            )

    def _send_json(
        self, status: int, doc, retry_after: Optional[float] = None
    ) -> None:
        body = (json.dumps(doc, indent=2) + "\n").encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", f"{retry_after:g}")
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, status: int, text: str, content_type: str) -> None:
        body = text.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json_body(self):
        """The request body as parsed JSON, or ``None`` after an error
        response was already sent."""
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = -1
        if length < 0 or length > MAX_BODY_BYTES:
            # The oversized body stays unread; the connection cannot be
            # reused (leftover bytes would parse as the next request).
            self.close_connection = True
            self._send_json(
                413,
                error_doc(
                    "body-too-large",
                    f"request body must be <= {MAX_BODY_BYTES} bytes",
                ),
            )
            return None
        raw = self.rfile.read(length)
        try:
            return json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            self._send_json(
                400, error_doc("bad-json", f"request body is not JSON: {e}")
            )
            return None

    # --------------------------------------------------------------- routes

    def do_GET(self) -> None:  # noqa: N802 — http.server's spelling
        service: PcaService = self.server.service
        if self.path == "/healthz":
            self._send_json(200, service.healthz())
            return
        if self.path == "/metrics":
            self._send_text(
                200,
                service.metrics_text(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
            return
        if self.path == "/v1/fleet/stats":
            self._send_json(200, service.fleet_stats())
            return
        if self.path.startswith("/v1/jobs/"):
            job_id = self.path[len("/v1/jobs/"):]
            if job_id and "/" not in job_id:
                status, doc = service.job_status(job_id)
                # A non-terminal job tells the poller WHEN to come back
                # (the shared utils/retry.py client arithmetic honors it)
                # — server-paced polling instead of client guesswork.
                job_state = (doc.get("job") or {}).get("status")
                self._send_json(
                    status,
                    doc,
                    retry_after=(
                        POLL_RETRY_AFTER_SECONDS
                        if status == 200
                        and job_state in ("queued", "running")
                        else None
                    ),
                )
                return
        self._send_json(
            404, error_doc("not-found", f"no route GET {self.path}")
        )

    def _drain_body(self) -> None:
        """Consume a request body this route ignores: on a keep-alive
        connection unread bytes would parse as the NEXT request line.
        Oversized bodies close the connection instead of being read."""
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = -1
        if length < 0 or length > MAX_BODY_BYTES:
            self.close_connection = True
            return
        if length:
            self.rfile.read(length)

    def do_POST(self) -> None:  # noqa: N802
        service: PcaService = self.server.service
        if self.path == "/v1/jobs":
            doc = self._read_json_body()
            if doc is None:
                return
            # Trace-context propagation (obs/trace.py): the client's
            # X-Trace-Id header rides into the admission, the journal,
            # and every flight-recorder event of the job's life — a
            # malformed or absent id gets a server-minted replacement
            # inside submit(), never a rejection.
            from spark_examples_tpu_torch.obs.trace import TRACE_HEADER

            status, body = service.submit(
                doc, trace_id=self.headers.get(TRACE_HEADER)
            )
            self._send_json(status, body)
            return
        self._drain_body()
        if self.path.startswith("/v1/jobs/") and self.path.endswith("/cancel"):
            job_id = self.path[len("/v1/jobs/"):-len("/cancel")]
            if job_id and "/" not in job_id:
                status, body = service.cancel(job_id)
                self._send_json(status, body)
                return
        self._send_json(
            404, error_doc("not-found", f"no route POST {self.path}")
        )


class ServeServer(ThreadingHTTPServer):
    """Bound server carrying the service; request threads are daemons so
    a drain never waits on an idle keep-alive connection."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, address, service: PcaService, verbose: bool = False):
        super().__init__(address, ServeHandler)
        self.service = service
        self.verbose = verbose

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"


def start_server(
    service: PcaService,
    host: str = "127.0.0.1",
    port: int = 0,
    verbose: bool = False,
) -> ServeServer:
    """Bind (port 0 = ephemeral) and serve in a background thread; the
    in-process form tests and embedders use. The caller owns shutdown:
    ``server.shutdown()`` then ``service.stop()``."""
    server = ServeServer((host, port), service, verbose=verbose)
    thread = threading.Thread(
        target=server.serve_forever, name="serve-http", daemon=True
    )
    thread.start()
    return server


def _write_endpoint_file(path: str, url: str) -> None:
    """Atomic publish of the bound URL (scripts poll for this file)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(url + "\n")
    os.replace(tmp, path)


def serve_main(argv: Optional[Sequence[str]] = None) -> int:
    """The ``serve`` CLI verb (``python -m spark_examples_tpu_torch serve``)."""
    parser = argparse.ArgumentParser(prog="spark_examples_tpu_torch serve")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help=(
            "Where served jobs run: every card (cuda, the default; the "
            "daemon exits without one) or the CPU. A job may not name "
            "its own --device."
        ),
    )
    parser.add_argument(
        "--port",
        type=int,
        default=8765,
        help="Listen port (0 = ephemeral; see --endpoint-file).",
    )
    parser.add_argument(
        "--run-dir",
        default=None,
        help=(
            "Service run directory: per-job manifests and captured stdout "
            "land under <run-dir>/jobs/<job-id>/. Default: a fresh "
            "temporary directory (path printed at startup)."
        ),
    )
    parser.add_argument(
        "--queue-small",
        type=int,
        default=DEFAULT_SMALL_CAPACITY,
        help="Small-class admission queue capacity (default %(default)s).",
    )
    parser.add_argument(
        "--queue-large",
        type=int,
        default=DEFAULT_LARGE_CAPACITY,
        help="Large-class admission queue capacity (default %(default)s).",
    )
    parser.add_argument(
        "--host-mem-budget",
        type=int,
        default=None,
        metavar="BYTES",
        help=(
            "Admission host-RAM budget: every job kind (wire/JSONL/SAM "
            "included) resolves a finite static bound "
            "(parallel/mesh.py:host_peak_bytes); jobs whose bound "
            "exceeds the budget are rejected 413 at admission."
        ),
    )
    parser.add_argument(
        "--heartbeat-seconds",
        type=float,
        default=0.0,
        help="Service heartbeat interval on stderr (0 = off).",
    )
    parser.add_argument(
        "--terminal-retention",
        type=int,
        default=DEFAULT_TERMINAL_RETENTION,
        metavar="N",
        help=(
            "Completed jobs kept queryable in memory (default "
            "%(default)s); older terminal records are evicted — their "
            "per-job manifests stay on disk under --run-dir."
        ),
    )
    parser.add_argument(
        "--executor-slices",
        default="auto",
        metavar="N|auto",
        help=(
            "Small executor slices to carve off the device set (each its "
            "own mesh + worker, so small jobs run concurrently beside one "
            "large job). 'auto' (default) = 1 when a device can be "
            "spared, 0 on a single device; 0 = the shared serial worker."
        ),
    )
    parser.add_argument(
        "--small-slice-devices",
        type=int,
        default=1,
        metavar="D",
        help="Devices per small executor slice (default %(default)s).",
    )
    parser.add_argument(
        "--serve-small-site-limit",
        type=int,
        default=SMALL_JOB_MAX_SITES,
        metavar="SITES",
        help=(
            "Largest statically-bounded candidate-site count classified "
            "as a small job (default %(default)s); larger or unbounded "
            "configurations queue as large."
        ),
    )
    parser.add_argument(
        "--batch-max-jobs",
        type=int,
        default=DEFAULT_BATCH_MAX_JOBS,
        metavar="N",
        help=(
            "Continuous batching: at most this many compatible small "
            "jobs per dispatch group (default %(default)s; 1 disables "
            "coalescing)."
        ),
    )
    parser.add_argument(
        "--batch-linger-seconds",
        type=float,
        default=DEFAULT_BATCH_LINGER_SECONDS,
        metavar="S",
        help=(
            "Continuous batching: wait up to this long for more "
            "compatible small jobs before dispatching a non-full group "
            "(default %(default)s — dispatch what is queued now)."
        ),
    )
    parser.add_argument(
        "--no-batch-fuse",
        action="store_true",
        help=(
            "Run every batch group's jobs back to back as separate "
            "device programs instead of fusing an eligible group into "
            "ONE stacked program (fusion is on by default; results are "
            "byte-identical either way)."
        ),
    )
    parser.add_argument(
        "--serve-ordering",
        choices=("cost", "fifo"),
        default="cost",
        metavar="POLICY",
        help=(
            "Queue ordering within each class lane: 'cost' (default) "
            "serves by calibrated estimate — shortest-job-first, "
            "deadline jobs by slack, starvation-capped by "
            "--serve-age-cap-seconds; 'fifo' preserves admission order."
        ),
    )
    parser.add_argument(
        "--serve-age-cap-seconds",
        type=float,
        default=DEFAULT_AGE_CAP_SECONDS,
        metavar="S",
        help=(
            "Starvation bound for --serve-ordering=cost: a job queued "
            "this long jumps ahead of cost ordering (FIFO among aged "
            "jobs; default %(default)s)."
        ),
    )
    parser.add_argument(
        "--replica-id",
        default=None,
        metavar="ID",
        help=(
            "Join --run-dir as one of N replica daemons sharing its job "
            "journal: jobs are leased (time-bounded, epoch-fenced), "
            "liveness is heartbeated, and a job whose owning replica "
            "died is stolen by a survivor. Replicas need distinct ids; "
            "without this flag the daemon owns the run dir exclusively."
        ),
    )
    parser.add_argument(
        "--lease-seconds",
        type=float,
        default=DEFAULT_LEASE_SECONDS,
        metavar="S",
        help=(
            "Job-lease time-to-live with --replica-id (default "
            "%(default)s): a healthy replica renews 3x per TTL; a lease "
            "this stale marks its owner dead."
        ),
    )
    parser.add_argument(
        "--lease-grace-seconds",
        type=float,
        default=None,
        metavar="S",
        help=(
            "Clock-skew grace: peers steal only past expiry PLUS this "
            "window, while the owner abandons at expiry (default: the "
            "lease TTL)."
        ),
    )
    parser.add_argument(
        "--steal-interval-seconds",
        type=float,
        default=None,
        metavar="S",
        help=(
            "How often a replica scans for dead peers' expired leases "
            "(default: the lease TTL)."
        ),
    )
    parser.add_argument(
        "--no-deadline-feasibility",
        action="store_true",
        help=(
            "Queue jobs whose deadline_seconds is below the calibrated "
            "cost estimate instead of rejecting them 413 "
            "deadline-infeasible at admission."
        ),
    )
    parser.add_argument(
        "--no-persistent-cache",
        action="store_true",
        help=(
            "Do not persist the warm-geometry ledger under --run-dir: a "
            "restarted daemon then honestly reports every first geometry "
            "cold (the kernels stay built under build/torch_kernels/ "
            "either way)."
        ),
    )
    parser.add_argument(
        "--endpoint-file",
        default=None,
        metavar="PATH",
        help="Write the bound URL here once listening (atomic).",
    )
    parser.add_argument(
        "--verbose", action="store_true", help="Log every HTTP request."
    )
    ns = parser.parse_args(list(argv) if argv is not None else None)

    # Nonsense serving parameters must fail the daemon AT STARTUP with the
    # argparse contract (exit 2), never surface as a crash-looping worker
    # or a queue that silently misclassifies everything.
    if ns.serve_small_site_limit < 1:
        parser.error(
            f"--serve-small-site-limit must be >= 1 site, got "
            f"{ns.serve_small_site_limit}"
        )
    if ns.small_slice_devices < 1:
        parser.error(
            f"--small-slice-devices must be >= 1, got "
            f"{ns.small_slice_devices}"
        )
    if ns.batch_max_jobs < 1:
        parser.error(
            f"--batch-max-jobs must be >= 1, got {ns.batch_max_jobs}"
        )
    if ns.batch_linger_seconds < 0:
        parser.error(
            f"--batch-linger-seconds must be >= 0, got "
            f"{ns.batch_linger_seconds}"
        )
    if ns.serve_age_cap_seconds <= 0:
        parser.error(
            f"--serve-age-cap-seconds must be > 0, got "
            f"{ns.serve_age_cap_seconds}"
        )
    if ns.lease_seconds <= 0:
        parser.error(
            f"--lease-seconds must be > 0, got {ns.lease_seconds}"
        )
    if ns.lease_grace_seconds is not None and ns.lease_grace_seconds < 0:
        parser.error(
            f"--lease-grace-seconds must be >= 0, got "
            f"{ns.lease_grace_seconds}"
        )
    if ns.steal_interval_seconds is not None and ns.steal_interval_seconds <= 0:
        parser.error(
            f"--steal-interval-seconds must be > 0, got "
            f"{ns.steal_interval_seconds}"
        )
    if ns.executor_slices != "auto":
        try:
            slices_spec: Optional[int] = int(ns.executor_slices)
        except ValueError:
            parser.error(
                f"--executor-slices must be an integer or 'auto', got "
                f"{ns.executor_slices!r}"
            )
        if slices_spec < 0:
            parser.error(
                f"--executor-slices must be >= 0, got {slices_spec}"
            )
    else:
        slices_spec = None

    service = PcaService(
        run_dir=ns.run_dir,
        small_capacity=ns.queue_small,
        large_capacity=ns.queue_large,
        terminal_retention=ns.terminal_retention,
        host_mem_budget=ns.host_mem_budget,
        heartbeat_seconds=ns.heartbeat_seconds,
        small_slices=slices_spec,
        small_slice_devices=ns.small_slice_devices,
        small_site_limit=ns.serve_small_site_limit,
        batch_max_jobs=ns.batch_max_jobs,
        batch_linger_seconds=ns.batch_linger_seconds,
        batch_fuse=not ns.no_batch_fuse,
        ordering=ns.serve_ordering,
        age_cap_seconds=ns.serve_age_cap_seconds,
        persistent_cache=not ns.no_persistent_cache,
        replica_id=ns.replica_id,
        lease_seconds=ns.lease_seconds,
        lease_grace_seconds=ns.lease_grace_seconds,
        steal_interval_seconds=ns.steal_interval_seconds,
        deadline_feasibility=not ns.no_deadline_feasibility,
        # The CLI daemon always guards its run dir: a second daemon on
        # the same --run-dir without --replica-id exits 2 below instead
        # of silently corrupting the shared journal.
        guard_run_dir=True,
        device=ns.device,
    )
    try:
        service.start()
    except RunDirBusy as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        # A slice topology the device set cannot satisfy (e.g. every
        # device reserved for small slices) is a configuration error —
        # the same exit-2 contract as the flag checks above.
        print(f"serve: invalid configuration: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:
        # No card behind --device cuda (or a kernel build that failed):
        # the daemon never binds, and nothing runs elsewhere instead.
        print(f"serve: cannot start on --device {ns.device}: {e}", file=sys.stderr)
        return 1
    server = ServeServer((ns.host, ns.port), service, verbose=ns.verbose)
    if ns.endpoint_file:
        _write_endpoint_file(ns.endpoint_file, server.url)

    def _drain_then_shutdown() -> None:
        service.wait_drained()
        server.shutdown()

    def _on_signal(signum, _frame) -> None:
        print(
            f"serve: received signal {signum}; draining "
            "(new jobs get 503, admitted jobs finish)",
            file=sys.stderr,
            flush=True,
        )
        service.begin_drain()
        threading.Thread(
            target=_drain_then_shutdown, name="serve-drain", daemon=True
        ).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    slices = ",".join(
        f"{w.spec.name}:{w.spec.device_count}" for w in service._workers
    )
    replica = (
        f" replica={service.replica_id}" if service.replica_id else ""
    )
    print(
        f"serve: listening on {server.url} "
        f"(devices={service.device_count} platform={service.platform} "
        f"slices=[{slices}]{replica} run_dir={service.run_dir})",
        file=sys.stderr,
        flush=True,
    )
    try:
        server.serve_forever()
    finally:
        server.server_close()
    drained = service.wait_drained(timeout=60.0)
    # The drain verdict is decided; a late duplicate SIGTERM (an impatient
    # supervisor re-signaling) must not flip the exit code to 143 during
    # interpreter teardown — the OS-level disposition outlives Python's
    # handler machinery.
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    print(
        "serve: drained cleanly"
        if drained
        else "serve: worker did not drain within 60s",
        file=sys.stderr,
        flush=True,
    )
    return 0 if drained else 1


__all__ = [
    "MAX_BODY_BYTES",
    "POLL_RETRY_AFTER_SECONDS",
    "ServeHandler",
    "ServeServer",
    "start_server",
    "serve_main",
]
