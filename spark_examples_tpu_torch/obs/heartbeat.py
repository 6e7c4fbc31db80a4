"""Background heartbeat: a periodic progress line for long runs.

The port's copy of ``spark_examples_tpu/obs/heartbeat.py``: a daemon thread
samples the run's :class:`~spark_examples_tpu_torch.obs.metrics.MetricsRegistry`
every ``interval_seconds`` and writes one line to stderr (stdout stays
reserved for the result rows and the epilogue), in the reference's format::

    heartbeat[12s]: 1,203,200 sites scanned (98.3k sites/s); \
partitions 34/220 (ETA 67s); prefetch queue 2/2; dispatch in-flight 1; \
host rss peak 1.2 GiB/4.0 GiB bound; device mem 0.2/79.1 GiB

Segments appear only when their metric exists, so every ingest arm
(device generation, packed, streamed, wire) gets an honest subset. Enabled
by ``--heartbeat-seconds N`` (0 = off, the default). The port samples the
reference's segments in its order: ingest, prefetch, dispatch, analysis
(the LD prune's ``analysis kept K/T sites``), the ring's traffic
(``gramian_ring_bytes``), the serve daemon's queue, slices, replicas,
batched and fused groups, the cost observatory's predicted against
measured wall (``serve/daemon.py`` registers those gauges), the
warm-geometry ledger's warm/cold pair, and host memory. Device memory is
``torch.cuda.memory_allocated`` against the card's total memory.

``stop()`` is idempotent and joins the thread: the driver stops it in a
``finally``, so a run that fails emits its last heartbeat and then goes
quiet instead of interleaving with the traceback.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional

from spark_examples_tpu_torch.obs.metrics import (
    ANALYSIS_SITES_KEPT,
    ANALYSIS_SITES_TESTED,
    COMPILE_CACHE_GEOMETRY_HITS,
    COMPILE_CACHE_GEOMETRY_MISSES,
    COST_CALIBRATION_SAMPLES,
    COST_MEASURED_MEAN_SECONDS,
    COST_PREDICTED_MEAN_SECONDS,
    GRAMIAN_INFLIGHT_DISPATCHES,
    GRAMIAN_RING_BYTES,
    HOST_PEAK_RSS_BYTES,
    HOST_RUNTIME_BASELINE_BYTES,
    HOST_STATIC_BOUND_BYTES,
    INGEST_PARTITIONS_DONE,
    INGEST_PARTITIONS_PLANNED,
    INGEST_SITES_SCANNED,
    IO_PARTITIONS_TOTAL,
    MetricsRegistry,
    PREFETCH_QUEUE_DEPTH,
    PREFETCH_QUEUE_OCCUPANCY,
    SERVE_BATCH_JOBS,
    SERVE_BATCHES,
    SERVE_FUSED_GROUPS,
    SERVE_FUSED_JOBS,
    SERVE_JOBS_DONE,
    SERVE_JOBS_INFLIGHT,
    SERVE_JOBS_STOLEN,
    SERVE_LEASE_RENEWALS,
    SERVE_QUEUE_DEPTH,
    SERVE_REPLICAS_ALIVE,
    SERVE_SLICES,
    SERVE_SLICES_BUSY,
)


def _bytes_text(count: float) -> str:
    for bound, unit in ((1 << 30, "GiB"), (1 << 20, "MiB"), (1 << 10, "KiB")):
        if count >= bound:
            return f"{count / bound:.1f} {unit}"
    return f"{int(count)} B"


def _device_memory_line() -> Optional[str]:
    """``used/total GiB`` of the current CUDA card, or ``None`` without a
    card (the CPU reports no device memory)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        used = torch.cuda.memory_allocated()
        total = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    except (ImportError, RuntimeError):
        return None
    gib = 1024.0**3
    return f"device mem {used / gib:.1f}/{total / gib:.1f} GiB"


def _rate_text(per_second: float) -> str:
    if per_second >= 1e6:
        return f"{per_second / 1e6:.1f}M"
    if per_second >= 1e3:
        return f"{per_second / 1e3:.1f}k"
    return f"{per_second:.1f}"


class Heartbeat:
    """Periodic registry sampler; start()/stop() or use as a context
    manager. ``emit`` is injectable for tests (default: stderr print)."""

    def __init__(
        self,
        interval_seconds: float,
        registry: MetricsRegistry,
        emit: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if interval_seconds <= 0:
            raise ValueError(
                f"heartbeat interval must be > 0 (0 disables the heartbeat "
                f"at the flag level), got {interval_seconds}"
            )
        self.interval_seconds = float(interval_seconds)
        self.registry = registry
        self._emit = emit if emit is not None else self._print_stderr
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None
        self._last_tick: Optional[float] = None
        self._last_sites: Optional[float] = None
        self.emitted = 0

    @staticmethod
    def _print_stderr(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._started_at = self._clock()
        self._thread = threading.Thread(
            target=self._run, name="obs-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Idempotent; joins the thread so no line is emitted after this
        returns."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=timeout)

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ----------------------------------------------------------------- tick

    def _run(self) -> None:
        while not self._stop.wait(self.interval_seconds):
            try:
                self._emit(self.line())
                self.emitted += 1
            except Exception:
                # A reporting bug must never take down the run; stop
                # rather than repeat the same failure every interval.
                return

    def line(self) -> str:
        """One progress line from the current registry state."""
        now = self._clock()
        elapsed = now - (self._started_at if self._started_at is not None else now)
        parts = []

        sites = self.registry.value(INGEST_SITES_SCANNED)
        if sites is not None:
            segment = f"{int(sites):,} sites scanned"
            ref_tick = self._last_tick
            ref_sites = self._last_sites
            if ref_tick is not None and now > ref_tick and ref_sites is not None:
                rate = (sites - ref_sites) / (now - ref_tick)
                if rate >= 0:
                    segment += f" ({_rate_text(rate)} sites/s)"
            self._last_tick, self._last_sites = now, sites
            parts.append(segment)

        # Partition progress: the live streaming-pass gauge when one exists
        # (the streamed arm flushes its I/O stats only after the whole
        # pass), else the registry-backed stats counter the per-shard arms
        # advance as they go.
        done = self.registry.value(INGEST_PARTITIONS_DONE)
        if done is None:
            done = self.registry.value(IO_PARTITIONS_TOTAL)
        planned = self.registry.value(INGEST_PARTITIONS_PLANNED)
        if done is not None and planned:
            segment = f"partitions {int(done)}/{int(planned)}"
            if 0 < done < planned and elapsed > 0:
                eta = elapsed * (planned - done) / done
                segment += f" (ETA {eta:.0f}s)"
            parts.append(segment)

        occupancy = self.registry.value(PREFETCH_QUEUE_OCCUPANCY)
        depth = self.registry.value(PREFETCH_QUEUE_DEPTH)
        if occupancy is not None and occupancy == occupancy:  # not NaN
            segment = f"prefetch queue {int(occupancy)}"
            if depth:
                segment += f"/{int(depth)}"
            parts.append(segment)

        in_flight = self.registry.value(GRAMIAN_INFLIGHT_DISPATCHES)
        if in_flight is not None:
            parts.append(f"dispatch in-flight {int(in_flight)}")

        # Per-site analysis progress (the LD prune): kept vs tested,
        # advanced per flushed window. The tested count alone would repeat
        # the sites-scanned segment, so the pair appears only once a
        # pruning analysis registers its kept gauge.
        kept = self.registry.value(ANALYSIS_SITES_KEPT)
        if kept is not None and kept == kept:
            tested = self.registry.value(ANALYSIS_SITES_TESTED)
            if tested is not None and tested == tested:
                parts.append(f"analysis kept {int(kept):,}/{int(tested):,} sites")

        ring_bytes = self.registry.value(GRAMIAN_RING_BYTES)
        if ring_bytes:
            parts.append(f"ring traffic {_bytes_text(ring_bytes)}")

        # The serve daemon's service registry: admission state where a
        # batch run's heartbeat shows ingest progress.
        queued = self.registry.value(SERVE_QUEUE_DEPTH)
        if queued is not None and queued == queued:
            segment = f"serve queue {int(queued)}"
            inflight = self.registry.value(SERVE_JOBS_INFLIGHT)
            if inflight is not None and inflight == inflight:
                segment += f" (in-flight {int(inflight)}"
                settled = self.registry.value(SERVE_JOBS_DONE)
                if settled is not None and settled == settled:
                    segment += f", done {int(settled)}"
                segment += ")"
            parts.append(segment)

        # Executor slices busy of all (busy == total reads as saturation).
        slices = self.registry.value(SERVE_SLICES)
        if slices is not None and slices == slices and slices > 0:
            busy = self.registry.value(SERVE_SLICES_BUSY)
            if busy is not None and busy == busy:
                parts.append(f"slices {int(busy)}/{int(slices)} busy")

        # Replicas heartbeating against the run directory (self included;
        # a solo daemon exports 0 and the segment stays silent), with this
        # replica's steals and lease renewals.
        replicas = self.registry.value(SERVE_REPLICAS_ALIVE)
        if replicas is not None and replicas == replicas and replicas > 0:
            segment = f"replicas {int(replicas)} alive"
            extras = []
            stolen = self.registry.value(SERVE_JOBS_STOLEN)
            if stolen:
                extras.append(f"stolen {int(stolen)}")
            renewals = self.registry.value(SERVE_LEASE_RENEWALS)
            if renewals:
                extras.append(f"lease renewals {int(renewals)}")
            if extras:
                segment += " (" + ", ".join(extras) + ")"
            parts.append(segment)

        batches = self.registry.value(SERVE_BATCHES)
        if batches:
            batch_jobs = self.registry.value(SERVE_BATCH_JOBS)
            segment = f"batched {int(batches)} groups"
            if batch_jobs:
                segment += f" ({int(batch_jobs)} jobs)"
            parts.append(segment)

        # Groups run as one stacked program, with their mean size.
        fused = self.registry.value(SERVE_FUSED_GROUPS)
        if fused:
            fused_jobs = self.registry.value(SERVE_FUSED_JOBS)
            segment = f"fused {int(fused)} K-job group(s)"
            if fused_jobs:
                segment += f" (K≈{fused_jobs / fused:.1f})"
            parts.append(segment)

        # The calibration fold's mean predicted and measured wall, silent
        # until the first completed job lands (the gauges read NaN).
        cost_n = self.registry.value(COST_CALIBRATION_SAMPLES)
        if cost_n is not None and cost_n == cost_n and cost_n > 0:
            predicted = self.registry.value(COST_PREDICTED_MEAN_SECONDS)
            measured = self.registry.value(COST_MEASURED_MEAN_SECONDS)
            if (
                predicted is not None
                and predicted == predicted
                and measured is not None
                and measured == measured
            ):
                segment = f"cost pred {predicted:.1f}s / meas {measured:.1f}s"
                if predicted > 0:
                    segment += f" (ratio {measured / predicted:.2f}, n={int(cost_n)})"
                else:
                    segment += f" (n={int(cost_n)})"
                parts.append(segment)

        # The warm-geometry ledger (utils/cache.py): warm against cold runs.
        hits = self.registry.value(COMPILE_CACHE_GEOMETRY_HITS)
        misses = self.registry.value(COMPILE_CACHE_GEOMETRY_MISSES)
        if hits is not None and hits == hits and misses is not None and misses == misses:
            parts.append(f"compile cache {int(hits)} warm/{int(misses)} cold")

        # Host memory: each tick samples the function-backed peak-RSS
        # gauge, shown against the registered bound (the runtime baseline
        # when none is registered).
        peak_rss = self.registry.value(HOST_PEAK_RSS_BYTES)
        if peak_rss is not None and peak_rss == peak_rss and peak_rss > 0:
            bound = self.registry.value(HOST_STATIC_BOUND_BYTES)
            if bound is None or bound != bound or bound <= 0:
                bound = HOST_RUNTIME_BASELINE_BYTES
            parts.append(
                f"host rss peak {_bytes_text(peak_rss)}"
                f"/{_bytes_text(bound)} bound"
            )

        memory = _device_memory_line()
        if memory is not None:
            parts.append(memory)

        if not parts:
            parts.append("no progress metrics registered yet")
        return f"heartbeat[{elapsed:.0f}s]: " + "; ".join(parts)


__all__ = ["Heartbeat"]
