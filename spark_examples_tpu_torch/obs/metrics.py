"""Thread-safe metrics registry: named counters and gauges.

The subset of ``spark_examples_tpu/obs/metrics.py`` the port's driver uses:
one :class:`MetricsRegistry` per run, the well-known gauge names the
device-generation arm publishes, and the I/O counters behind
``pipeline/stats.py``. Registration is idempotent: asking for an existing
name with the same type returns the existing metric; a mismatch raises.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional, Union

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class MetricError(ValueError):
    """Invalid metric registration or use (name or type mismatch)."""


INGEST_SITES_SCANNED = "ingest_sites_scanned"
INGEST_PARTITIONS_PLANNED = "ingest_partitions_planned"
DEVICEGEN_DISPATCHES = "devicegen_dispatches"
DEVICEGEN_SITES_CAPACITY = "devicegen_sites_capacity"
IO_PARTITIONS_TOTAL = "io_partitions_total"

_WELL_KNOWN_GAUGE_HELP = {
    INGEST_SITES_SCANNED: "Candidate sites scanned so far.",
    INGEST_PARTITIONS_PLANNED: "Shard windows this run will process.",
    DEVICEGEN_DISPATCHES: "Fused generate+accumulate dispatch groups issued.",
    DEVICEGEN_SITES_CAPACITY: (
        "Site-grid capacity of every dispatch group issued (padding "
        "included) — the denominator of the padding-waste fraction against "
        "ingest_sites_scanned."
    ),
}


def well_known_gauge(registry: "MetricsRegistry", name: str) -> "Gauge":
    """Register (idempotently) a well-known gauge with its canonical help
    text."""
    return registry.gauge(name, _WELL_KNOWN_GAUGE_HELP[name])


class _Metric:
    def __init__(self, name: str, help_text: str):
        if not _NAME_RE.match(name or ""):
            raise MetricError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help_text
        # lock order: leaf lock; nothing else is acquired while holding it.
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Metric):
    """Monotonic counter."""

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount


class Gauge(_Metric):
    """Settable value."""

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class MetricsRegistry:
    """The registry: one per run."""

    def __init__(self) -> None:
        # lock order: registry lock before a metric's lock; never the reverse.
        self._lock = threading.Lock()
        self._metrics: Dict[str, Union[Counter, Gauge]] = {}

    def _register(self, kind, name: str, help_text: str):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = kind(name, help_text)
            elif type(metric) is not kind:
                raise MetricError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}; requested {kind.__name__}"
                )
            return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(Gauge, name, help_text)

    def value(self, name: str) -> Optional[float]:
        """The metric's value, or ``None`` when it is not registered."""
        with self._lock:
            metric = self._metrics.get(name)
        return None if metric is None else metric.value


__all__ = [
    "DEVICEGEN_DISPATCHES",
    "DEVICEGEN_SITES_CAPACITY",
    "INGEST_PARTITIONS_PLANNED",
    "INGEST_SITES_SCANNED",
    "IO_PARTITIONS_TOTAL",
    "MetricError",
    "MetricsRegistry",
    "well_known_gauge",
]
