"""I/O statistics — a thin view over the metrics registry.

The reference tracks ingest health with six Spark accumulators flushed from
executors (``rdd/VariantsRDD.scala:152-172``) and pretty-prints them at the
end of a run (``VariantsPca.scala:321-326``). The counters live in a
:class:`~spark_examples_tpu_torch.obs.metrics.MetricsRegistry`
(``io_*_total``); this class keeps the reference's accessor surface and the
line-for-line report format of ``spark_examples_tpu/pipeline/stats.py``.

Mutation goes through the ``add_*`` methods only: the stat names are
read-only properties, and a direct ``stats.requests += n`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional

from spark_examples_tpu_torch.obs.metrics import IO_PARTITIONS_TOTAL, MetricsRegistry
from spark_examples_tpu_torch.sources.base import ClientCounters

#: stat name → (metric name, help) — the registry series backing each field.
_STAT_METRICS = {
    "partitions": (IO_PARTITIONS_TOTAL, "Shards (partitions) processed."),
    "reference_bases": (
        "io_reference_bases_total",
        "Reference bases covered by processed partitions.",
    ),
    "requests": ("io_requests_total", "API/page requests issued."),
    "unsuccessful_responses": (
        "io_unsuccessful_responses_total",
        "Unsuccessful (non-2xx) responses.",
    ),
    "io_exceptions": ("io_io_exceptions_total", "I/O exceptions raised."),
    "variants": ("io_variants_total", "Variant records read (pre-drop)."),
    # Not in the six-line report; the manifest's io_stats block carries it.
    "retries": (
        "io_retries_total",
        "Transient-failure retries (bounded-backoff) issued by clients.",
    ),
}


def _read_only(name: str):
    def getter(self) -> int:
        return int(self._counters[name].value)

    def setter(self, value) -> None:
        raise AttributeError(
            f"direct writes to VariantsDatasetStats.{name} bypass the "
            f"registry accounting; use an add_*() method instead"
        )

    return property(getter, setter)


class VariantsDatasetStats:
    """Mirror of ``VariantsRddStats`` (``rdd/VariantsRDD.scala:152-172``),
    registry-backed."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self._counters = {
            stat: self.registry.counter(metric, help_text)
            for stat, (metric, help_text) in _STAT_METRICS.items()
        }

    partitions = _read_only("partitions")
    reference_bases = _read_only("reference_bases")
    requests = _read_only("requests")
    unsuccessful_responses = _read_only("unsuccessful_responses")
    io_exceptions = _read_only("io_exceptions")
    variants = _read_only("variants")
    retries = _read_only("retries")

    def add_partition(self, reference_bases: int) -> None:
        self._counters["partitions"].inc(1)
        self._counters["reference_bases"].inc(int(reference_bases))

    def add_variants(self, n: int) -> None:
        self._counters["variants"].inc(int(n))

    def add_requests(self, n: int) -> None:
        """Page requests accounted outside a client session: the
        device-generation and packed arms compute them arithmetically
        (``SyntheticGenomicsSource.page_requests``)."""
        self._counters["requests"].inc(int(n))

    def add_client(self, counters: ClientCounters) -> None:
        """Flush a per-partition client's counters (the wire arm,
        ``rdd/VariantsRDD.scala:192-196``)."""
        self._counters["requests"].inc(counters.initialized_requests)
        self._counters["unsuccessful_responses"].inc(counters.unsuccessful_responses)
        self._counters["io_exceptions"].inc(counters.io_exceptions)
        self._counters["retries"].inc(counters.retries)

    def as_dict(self) -> Dict[str, int]:
        """The manifest's ``io_stats`` block (``obs/manifest.py``): the
        numbers ``__str__`` prints, and the retries."""
        return {
            "partitions": self.partitions,
            "reference_bases": self.reference_bases,
            "variants": self.variants,
            "requests": self.requests,
            "unsuccessful_responses": self.unsuccessful_responses,
            "io_exceptions": self.io_exceptions,
            "io_retries": self.retries,
        }

    def __str__(self) -> str:
        return (
            "Variants API stats:\n"
            "-------------------------------\n"
            f"# of partitions: {self.partitions}\n"
            f"# of bases requested: {self.reference_bases}\n"
            f"# of variants read: {self.variants}\n"
            f"# of API requests: {self.requests}\n"
            f"# of unsuccessful responses: {self.unsuccessful_responses}\n"
            f"# of IO exceptions: {self.io_exceptions}\n"
        )


__all__ = ["VariantsDatasetStats"]
