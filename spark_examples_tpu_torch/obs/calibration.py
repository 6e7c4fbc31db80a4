"""Crash-durable calibration ledger: predicted-vs-measured, per geometry.

The port's copy of ``spark_examples_tpu/obs/calibration.py``; a ledger
written by either package folds identically in the other. The cost model (``obs/costmodel.py``) is deliberately coarse; this
ledger is what makes it honest. Every completed serve job appends ONE
JSON line — its compile fingerprint, predicted seconds, measured wall
seconds, queue wait, warm/cold — to ``<run_dir>/calibration.jsonl``,
and the fold learns the measured/predicted ratio PER GEOMETRY (keyed by
``utils/cache.py:compile_fingerprint``, the same key the warm ledger
uses), so ``calibrated_estimate`` multiplies a fresh prediction by what
this exact compiled program actually cost last time.

Durability contract (the journal's, reused):

- **appends** are ``O_APPEND`` + ``fsync`` per record — a ``kill -9``
  loses at most the line being written;
- **the fold is torn-tail-tolerant**: an unparseable line is skipped
  (by the append protocol it can only be a crashed writer's last line);
- **mergeable across replicas**: N replica daemons append to the ONE
  file in the shared run dir (``O_APPEND`` writes of a single short
  line are atomic enough on POSIX for line-grained interleave; the
  fold is order-insensitive), so any replica's fold — and the offline
  ``obs report`` — sees the whole fleet's samples.

Quantile summaries come from a DETERMINISTIC bounded reservoir
(:class:`_Reservoir`): when full it drops every other element and
doubles its sampling stride — no randomness (repo-wide determinism
rule), bounded memory, and the kept elements remain an evenly-spaced
thinning of the observation stream.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from spark_examples_tpu_torch.obs.costmodel import COMPILE_COLD, COMPILE_WARM

#: Ledger filename under the (shared) service run directory.
CALIBRATION_BASENAME = "calibration.jsonl"

#: Max kept samples per reservoir before stride-doubling.
RESERVOIR_CAPACITY = 256

#: Calibration ratios are only trusted once a geometry has this many
#: samples; below it ``calibrated_estimate`` returns the raw prediction
#: (ratio 1.0) — one outlier job must not poison admission decisions.
MIN_CALIBRATION_SAMPLES = 1


def calibration_path(run_dir: str) -> str:
    return os.path.join(run_dir, CALIBRATION_BASENAME)


class _Reservoir:
    """Deterministic stride-thinning reservoir: keeps every ``stride``-th
    observation, halving the kept set and doubling the stride when full.
    The kept samples are an evenly-spaced subsample of the stream —
    biased only by phase, never by value, and fully reproducible."""

    def __init__(self, capacity: int = RESERVOIR_CAPACITY):
        self.capacity = max(2, int(capacity))
        self.stride = 1
        self.seen = 0
        self.samples: List[float] = []

    def add(self, value: float) -> None:
        if self.seen % self.stride == 0:
            if len(self.samples) >= self.capacity:
                self.samples = self.samples[::2]
                self.stride *= 2
                if self.seen % self.stride != 0:
                    self.seen += 1
                    return
            self.samples.append(float(value))
        self.seen += 1

    def quantile(self, q: float) -> Optional[float]:
        if not self.samples:
            return None
        ordered = sorted(self.samples)
        rank = min(max(float(q), 0.0), 1.0) * (len(ordered) - 1)
        low = int(rank)
        high = min(low + 1, len(ordered) - 1)
        fraction = rank - low
        return ordered[low] * (1.0 - fraction) + ordered[high] * fraction


@dataclass
class GeometryCalibration:
    """The fold of one compile fingerprint's completed jobs."""

    fingerprint: str
    kind: Optional[str] = None
    n: int = 0
    predicted_sum: float = 0.0
    measured_sum: float = 0.0
    queue_wait_sum: float = 0.0
    cold_n: int = 0
    measured: _Reservoir = field(default_factory=_Reservoir)

    def add(self, record: Dict) -> None:
        predicted = float(record["predicted_seconds"])
        measured = float(record["measured_seconds"])
        self.n += 1
        self.predicted_sum += predicted
        self.measured_sum += measured
        self.queue_wait_sum += float(record.get("queue_wait_seconds") or 0.0)
        if record.get("compile") == COMPILE_COLD:
            self.cold_n += 1
        if self.kind is None and record.get("kind"):
            self.kind = str(record["kind"])
        self.measured.add(measured)

    @property
    def ratio(self) -> Optional[float]:
        """Aggregate measured/predicted — sums, not a mean of per-job
        ratios, so one mispredicted quick job cannot dominate."""
        if self.n < MIN_CALIBRATION_SAMPLES or self.predicted_sum <= 0:
            return None
        return self.measured_sum / self.predicted_sum

    def summary(self) -> Dict[str, object]:
        """JSON summary (fleet stats + the post-mortem report)."""
        return {
            "fingerprint": self.fingerprint,
            "kind": self.kind,
            "n": self.n,
            "cold_n": self.cold_n,
            "ratio": self.ratio,
            "predicted_mean_seconds": (
                self.predicted_sum / self.n if self.n else None
            ),
            "measured_mean_seconds": (
                self.measured_sum / self.n if self.n else None
            ),
            "queue_wait_mean_seconds": (
                self.queue_wait_sum / self.n if self.n else None
            ),
            "measured_seconds": {
                "p50": self.measured.quantile(0.50),
                "p95": self.measured.quantile(0.95),
                "p99": self.measured.quantile(0.99),
            },
        }


class CalibrationFold:
    """Order-insensitive in-memory fold of ledger records: per-geometry
    stats plus one overall aggregate (the fallback ratio for a geometry
    the fleet has never completed)."""

    def __init__(self) -> None:
        self.per_geometry: Dict[str, GeometryCalibration] = {}
        self.overall = GeometryCalibration(fingerprint="*")

    def add(self, record: Dict) -> bool:
        """Fold one parsed record; ``False`` (skipped) on junk — the
        torn-tail contract, shared with the disk reader."""
        if not isinstance(record, dict):
            return False
        # Non-done rows (a stolen job the survivor failed structurally,
        # a crashed run) exist for the post-mortem report's per-job
        # join; their wall clock measures the failure path, not the
        # geometry's cost, so the ratio fold skips them.
        if record.get("status") not in (None, "done"):
            return False
        try:
            predicted = float(record["predicted_seconds"])
            measured = float(record["measured_seconds"])
        except (KeyError, TypeError, ValueError):
            return False
        if not (predicted == predicted and measured == measured):
            return False
        if predicted < 0 or measured < 0:
            return False
        fingerprint = record.get("fingerprint")
        if not isinstance(fingerprint, str) or not fingerprint:
            fingerprint = "unknown"
        stats = self.per_geometry.get(fingerprint)
        if stats is None:
            stats = GeometryCalibration(fingerprint=fingerprint)
            self.per_geometry[fingerprint] = stats
        stats.add(record)
        self.overall.add(record)
        return True

    def ratio_for(self, fingerprint: Optional[str]) -> Optional[float]:
        """The learned ratio for one geometry; falls back to the overall
        fleet ratio, then ``None`` (caller treats as 1.0)."""
        if fingerprint is not None:
            stats = self.per_geometry.get(fingerprint)
            if stats is not None and stats.ratio is not None:
                return stats.ratio
        return self.overall.ratio

    def calibrated_estimate(self, prediction):
        """Stamp the calibration onto a fresh
        :class:`~spark_examples_tpu_torch.obs.costmodel.CostPrediction`
        (mutates and returns it): ``calibrated_seconds`` = predicted ×
        the learned ratio for its geometry. No applicable ratio leaves
        the prediction unstamped — ``best_estimate_seconds`` then reads
        the raw model."""
        ratio = self.ratio_for(prediction.fingerprint)
        if ratio is not None and ratio > 0:
            stats = self.per_geometry.get(prediction.fingerprint or "")
            source = (
                stats
                if stats is not None and stats.ratio is not None
                else self.overall
            )
            prediction.calibration_ratio = ratio
            prediction.calibration_samples = source.n
            prediction.calibrated_seconds = (
                prediction.predicted_seconds * ratio
            )
        return prediction

    def summary(self) -> Dict[str, object]:
        return {
            "samples": self.overall.n,
            "ratio": self.overall.ratio,
            "predicted_mean_seconds": (
                self.overall.predicted_sum / self.overall.n
                if self.overall.n
                else None
            ),
            "measured_mean_seconds": (
                self.overall.measured_sum / self.overall.n
                if self.overall.n
                else None
            ),
            "geometries": {
                fp: stats.summary()
                for fp, stats in sorted(self.per_geometry.items())
            },
        }


def fold_calibration(path: str) -> CalibrationFold:
    """Fold the on-disk ledger (possibly written by N replicas, possibly
    torn at the tail, possibly absent) — the offline reader ``obs
    report`` and daemon startup/refresh share."""
    fold = CalibrationFold()
    try:
        f = open(path, "r", encoding="utf-8")
    except FileNotFoundError:
        return fold
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            fold.add(record)
    return fold


class CalibrationLedger:
    """The appender half plus a live fold. One per daemon; N replicas
    hold one each against the same file. ``record`` appends durably AND
    folds in-process (this replica's samples are visible immediately);
    ``refresh`` re-folds the file to merge peers' appends."""

    def __init__(self, run_dir: str):
        self.path = calibration_path(run_dir)
        # lock order: ledger lock is a leaf — nothing else is acquired
        # while holding it; the fsync'd append happens under it, exactly
        # like the geometry ledger's (utils/cache.py) append discipline.
        self._lock = threading.Lock()
        self._fd: Optional[int] = None
        self._fold = fold_calibration(self.path)

    def record(
        self,
        *,
        fingerprint: Optional[str],
        kind: str,
        job_class: str,
        predicted_seconds: float,
        measured_seconds: float,
        queue_wait_seconds: Optional[float],
        compile: str,
        job_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        unix: Optional[float] = None,
        status: str = "done",
    ) -> Dict[str, object]:
        """Durably append one settled job's (predicted, measured) pair;
        returns the record as written. ``status`` other than ``"done"``
        (e.g. ``"failed"`` for a stolen job the survivor fenced off)
        keeps the row out of the ratio fold but in the post-mortem
        report; ``queue_wait_seconds=None`` omits the key (the recorder
        of the wait may have died with a peer replica)."""
        doc: Dict[str, object] = {
            "fingerprint": fingerprint or "unknown",
            "kind": kind,
            "job_class": job_class,
            "predicted_seconds": float(predicted_seconds),
            "measured_seconds": float(measured_seconds),
            "compile": (
                COMPILE_WARM if compile == COMPILE_WARM else COMPILE_COLD
            ),
        }
        if queue_wait_seconds is not None:
            doc["queue_wait_seconds"] = float(queue_wait_seconds)
        if status != "done":
            doc["status"] = str(status)
        if job_id is not None:
            doc["id"] = job_id
        if trace_id is not None:
            doc["trace"] = trace_id
        if unix is not None:
            doc["unix"] = float(unix)
        line = (json.dumps(doc, sort_keys=True) + "\n").encode("utf-8")
        with self._lock:
            if self._fd is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._fd = os.open(
                    self.path,
                    os.O_CREAT | os.O_WRONLY | os.O_APPEND,
                    0o644,
                )
            os.write(self._fd, line)
            os.fsync(self._fd)
            self._fold.add(doc)
        return doc

    def refresh(self) -> "CalibrationFold":
        """Re-fold the file from disk (merging peer replicas' appends)
        and swap it in; returns the fresh fold."""
        fold = fold_calibration(self.path)
        with self._lock:
            self._fold = fold
        return fold

    @property
    def fold(self) -> CalibrationFold:
        with self._lock:
            return self._fold

    def calibrated_estimate(self, prediction):
        return self.fold.calibrated_estimate(prediction)

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


__all__ = [
    "CALIBRATION_BASENAME",
    "CalibrationFold",
    "CalibrationLedger",
    "GeometryCalibration",
    "MIN_CALIBRATION_SAMPLES",
    "RESERVOIR_CAPACITY",
    "calibration_path",
    "fold_calibration",
]
