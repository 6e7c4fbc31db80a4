"""Thread-safe metrics registry: named, labeled counters, gauges and
histograms.

The port's copy of ``spark_examples_tpu/obs/metrics.py``: one
:class:`MetricsRegistry` per run (the driver owns it), with the same data
model and the same two exports —

- :meth:`MetricsRegistry.as_dict`, the JSON form embedded in the run
  manifest (``obs/manifest.py``);
- :meth:`MetricsRegistry.prometheus_text`, the Prometheus text exposition
  format (v0.0.4).

Registration is idempotent: asking for an existing name with the same type
and label names returns the existing family; a mismatch raises. The
well-known names below are the ones the port's producers register and the
heartbeat (``obs/heartbeat.py``) samples; the reference's serving, ring
and cost names wait for those layers.
"""

from __future__ import annotations

import math
import re
import sys
import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from spark_examples_tpu_torch.parallel.mesh import HOST_RUNTIME_BASELINE_BYTES

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: Default histogram bucket upper bounds (seconds-oriented; +Inf implied).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
)


class MetricError(ValueError):
    """Invalid metric registration or use (name/type/label mismatch)."""


#: Well-known gauge names: one spelling and help string, shared by every
#: producer and the heartbeat.
INGEST_SITES_SCANNED = "ingest_sites_scanned"
INGEST_PARTITIONS_PLANNED = "ingest_partitions_planned"
INGEST_PARTITIONS_DONE = "ingest_partitions_done"
PREFETCH_QUEUE_DEPTH = "prefetch_queue_depth"
PREFETCH_QUEUE_OCCUPANCY = "prefetch_queue_occupancy"
GRAMIAN_INFLIGHT_DISPATCHES = "gramian_inflight_dispatches"
DEVICEGEN_DISPATCHES = "devicegen_dispatches"
DEVICEGEN_SITES_CAPACITY = "devicegen_sites_capacity"
#: Registry-backed stats counter the heartbeat's per-shard progress reads
#: (registered by ``pipeline/stats.py``).
IO_PARTITIONS_TOTAL = "io_partitions_total"
#: The measured peak process RSS (function-backed: every read samples the
#: OS) and the static bound it is shown against.
HOST_PEAK_RSS_BYTES = "host_peak_rss_bytes"
HOST_STATIC_BOUND_BYTES = "host_static_bound_bytes"
#: Labeled conformance gauges: a static prover's measured subject and its
#: proven bound, by prover (the manifest's ``conformance`` block).
PROVER_CONFORMANCE_MEASURED = "prover_conformance_measured"
PROVER_CONFORMANCE_PROVEN = "prover_conformance_proven"
CONFORMANCE_PROVERS = ("hostmem", "sched", "ranges")
#: Which parser decoded the last packed or streamed VCF pass: 1 for the
#: native parser (``native/vcfparse.cpp``), 0 for the Python one.
VCF_NATIVE_PARSE = "vcf_native_parse"
#: The process's peak RSS when the driver took its runtime baseline (after
#: the CUDA libraries' set-up on the card): the constant term of the
#: host-memory bound (``utils/device.py:runtime_baseline_bytes``).
HOST_BASELINE_RSS_BYTES = "host_baseline_rss_bytes"
#: Gramian checkpointing (``pipeline/checkpoint.py:GramianFeeder``): the
#: cursor of the newest published snapshot, and the saves counter.
GRAMIAN_CHECKPOINT_SITES = "gramian_checkpoint_sites"
GRAMIAN_CHECKPOINT_SAVES = "gramian_checkpoint_saves_total"
#: Per-site analyses (``analyses/``): sites tested and kept.
ANALYSIS_SITES_TESTED = "analysis_sites_tested"
ANALYSIS_SITES_KEPT = "analysis_sites_kept"

_WELL_KNOWN_GAUGE_HELP = {
    INGEST_SITES_SCANNED: "Candidate sites scanned so far (heartbeat progress).",
    INGEST_PARTITIONS_PLANNED: (
        "Shard windows this run will process (heartbeat ETA base)."
    ),
    INGEST_PARTITIONS_DONE: "Shard windows the run has reached so far.",
    PREFETCH_QUEUE_DEPTH: "Bound of the prefetch queue.",
    PREFETCH_QUEUE_OCCUPANCY: "Parsed blocks currently waiting in the prefetch queue.",
    GRAMIAN_INFLIGHT_DISPATCHES: (
        "Flushed device updates currently left in flight "
        "(the double-buffered feed depth)."
    ),
    DEVICEGEN_DISPATCHES: "Fused generate+accumulate dispatch groups issued.",
    DEVICEGEN_SITES_CAPACITY: (
        "Site-grid capacity of every dispatch group issued (padding "
        "included) — the denominator of the padding-waste fraction against "
        "ingest_sites_scanned."
    ),
    HOST_PEAK_RSS_BYTES: (
        "Peak resident set size of this process so far (OS-reported "
        "high-water mark, sampled at read time)."
    ),
    HOST_STATIC_BOUND_BYTES: (
        "Static host-memory bound of this configuration; measured peak RSS "
        "must stay under it on bounded ingest paths."
    ),
    VCF_NATIVE_PARSE: (
        "1 when the last packed or streamed VCF pass decoded with the "
        "native parser (native/vcfparse.cpp), 0 for the Python parser."
    ),
    HOST_BASELINE_RSS_BYTES: (
        "Runtime baseline of the host-memory bound: the process's peak RSS "
        "at driver set-up, after the CUDA context and libraries (the "
        "reference's constant on the CPU)."
    ),
    GRAMIAN_CHECKPOINT_SITES: (
        "Ingest cursor (rows of the deterministic stream) covered by the "
        "newest published Gramian checkpoint — what a preemption would "
        "resume from."
    ),
    ANALYSIS_SITES_TESTED: (
        "Sites this per-site analysis (analyses/: GRM, LD prune, assoc "
        "scan) has tested so far."
    ),
    ANALYSIS_SITES_KEPT: (
        "Sites the pruning analysis has kept so far (LD kept-mask "
        "cardinality; equals tested for non-pruning analyses)."
    ),
}

_WELL_KNOWN_COUNTER_HELP = {
    GRAMIAN_CHECKPOINT_SAVES: (
        "Atomic Gramian accumulator snapshots published by this run "
        "(--gramian-checkpoint-dir)."
    ),
}


def well_known_gauge(registry: "MetricsRegistry", name: str):
    """Register (idempotently) a well-known gauge with its canonical help
    text."""
    return registry.gauge(name, _WELL_KNOWN_GAUGE_HELP[name])


def well_known_counter(registry: "MetricsRegistry", name: str):
    """Register (idempotently) a well-known counter with its canonical help
    text."""
    return registry.counter(name, _WELL_KNOWN_COUNTER_HELP[name])


def read_host_peak_rss_bytes() -> Optional[int]:
    """OS-reported peak RSS of this process in BYTES, or ``None`` when the
    platform exposes neither ``getrusage`` nor ``/proc/self/status``.

    ``ru_maxrss`` is kibibytes on Linux and bytes on macOS (the one
    platform quirk this helper owns, so no caller re-derives it);
    ``VmHWM`` is the fallback for environments whose libc stubs rusage.
    """
    try:
        import resource

        rss = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        if rss > 0:
            return rss if sys.platform == "darwin" else rss * 1024
    except Exception:
        pass
    try:
        with open("/proc/self/status", "r", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except Exception:
        pass
    return None


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise MetricError(f"invalid metric name {name!r}")
    return name


class _Child:
    """One (labels → value) series of a family."""

    def __init__(self, labels: Tuple[Tuple[str, str], ...]):
        self._labels = labels
        # lock order: leaf lock, taken last; no other lock is acquired
        # while holding it (mutations are single-value updates).
        self._lock = threading.Lock()

    @property
    def labels_dict(self) -> Dict[str, str]:
        return dict(self._labels)


class Counter(_Child):
    """Monotonic counter."""

    def __init__(self, labels):
        super().__init__(labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    """Settable value; optionally backed by a callable sampled at read
    time (queue occupancy, in-flight depth — state that lives elsewhere).

    The two modes are exclusive: ``set()`` detaches any function (the
    owner freezing a live gauge at teardown), while ``inc``/``dec`` on a
    function-backed gauge raise — the delta would be silently shadowed by
    the callable on every read, which is exactly the kind of quiet
    accounting loss this registry exists to prevent.
    """

    def __init__(self, labels):
        super().__init__(labels)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            if self._fn is not None:
                raise MetricError(
                    "gauge is function-backed; inc/dec would be shadowed "
                    "by the sampler (set() detaches it first)"
                )
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Sample ``fn`` on every read — the gauge tracks live state
        without the owner having to push updates."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return float("nan")


class Histogram(_Child):
    """Fixed-bucket histogram (cumulative counts, Prometheus-style)."""

    def __init__(self, labels, buckets: Sequence[float]):
        super().__init__(labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise MetricError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> Dict[str, object]:
        """Cumulative bucket counts keyed by upper bound, plus sum/count."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
        cumulative: Dict[str, int] = {}
        running = 0
        for bound, c in zip(self.buckets, counts[:-1]):
            running += c
            cumulative[_format_bound(bound)] = running
        cumulative["+Inf"] = running + counts[-1]
        return {"buckets": cumulative, "sum": total, "count": n}

    @property
    def value(self) -> Dict[str, object]:
        return self.snapshot()


_CONFORMANCE_HELP = {
    PROVER_CONFORMANCE_MEASURED: (
        "Measured value of a static prover's runtime subject, by prover "
        "(hostmem: peak RSS bytes; sched: accounted ring bytes; ranges: "
        "max |Gramian entry|). Must stay <= prover_conformance_proven."
    ),
    PROVER_CONFORMANCE_PROVEN: (
        "Statically-proven bound of the same subject, by prover "
        "(hostmem: host_peak_bytes; sched: the schedule's ring-byte "
        "projection; ranges: the GR005-proven entry projection)."
    ),
}


def record_prover_conformance(
    registry: "MetricsRegistry",
    prover: str,
    measured: float,
    proven: Optional[float],
) -> None:
    """Register one prover's measured/proven pair as the labeled
    conformance gauges (idempotent; re-recording overwrites — the pair is
    a run-level snapshot, not an accumulator). ``proven=None`` records the
    measured side only — kept for provers whose bound is conditional
    (hostmem's never is: ``conf_host_peak_bytes`` is total, so its
    callers always pass a real bound)."""
    if prover not in CONFORMANCE_PROVERS:
        raise MetricError(
            f"unknown conformance prover {prover!r} "
            f"(one of {CONFORMANCE_PROVERS})"
        )
    registry.gauge(
        PROVER_CONFORMANCE_MEASURED,
        _CONFORMANCE_HELP[PROVER_CONFORMANCE_MEASURED],
        labelnames=("prover",),
    ).labels(prover=prover).set(float(measured))
    # proven=None SETS NaN rather than skipping: re-recording over an
    # earlier pair must never leave a stale proven bound behind (the
    # serve mirror is last-write-wins per prover — pairing one job's
    # measured with another job's proven would fabricate verdicts).
    registry.gauge(
        PROVER_CONFORMANCE_PROVEN,
        _CONFORMANCE_HELP[PROVER_CONFORMANCE_PROVEN],
        labelnames=("prover",),
    ).labels(prover=prover).set(
        float(proven) if proven is not None else float("nan")
    )


def conformance_block(registry: "MetricsRegistry") -> Optional[Dict]:
    """The run manifest's ``conformance`` block, read back from the
    labeled gauges: ``{prover: {measured, proven, ok} | null}`` per
    registered prover (``ok`` is null when no bound was provable), or
    ``None`` when no prover recorded a pair — manifests of runs without
    conformance telemetry are unchanged."""
    out: Dict[str, Optional[Dict]] = {}
    any_present = False
    for prover in CONFORMANCE_PROVERS:
        measured = registry.value(
            PROVER_CONFORMANCE_MEASURED, labels={"prover": prover}
        )
        if measured is None or measured != measured:
            out[prover] = None
            continue
        any_present = True
        proven = registry.value(
            PROVER_CONFORMANCE_PROVEN, labels={"prover": prover}
        )
        has_bound = proven is not None and proven == proven
        if has_bound:
            # The verdict compares the RAW floats; the displayed ints
            # (the validator's int contract) then round in the verdict's
            # direction — floor/ceil chosen so `measured <= proven` over
            # the INTS holds iff `ok` does. Consumers re-deriving the
            # comparison from the block (or from a re-recorded mirror of
            # it, serve/daemon.py:_mirror_conformance) can never see a
            # violated bound read as a pass, or the reverse.
            ok = bool(measured <= proven)
            if ok:
                measured_int = int(math.floor(measured))
                proven_int: Optional[int] = int(math.ceil(proven))
            else:
                measured_int = int(math.ceil(measured))
                proven_int = int(math.floor(proven))
        else:
            ok = None
            measured_int = int(round(measured))
            proven_int = None
        out[prover] = {
            "measured": measured_int,
            "proven": proven_int,
            "ok": ok,
        }
    return out if any_present else None


def _format_bound(bound: float) -> str:
    if math.isinf(bound):
        return "+Inf"
    text = repr(bound)
    return text[:-2] if text.endswith(".0") else text


def _parse_bound(text: str) -> float:
    return float("inf") if text == "+Inf" else float(text)


def histogram_quantile(snapshot: Mapping, q: float) -> Optional[float]:
    """Estimate the q-quantile of a :meth:`Histogram.snapshot` (or any
    dict shaped like one: cumulative ``buckets`` keyed by upper-bound
    string, plus ``count``) by linear interpolation inside the target
    bucket — the Prometheus ``histogram_quantile`` estimator, applied to
    one snapshot instead of a rate.

    Contract (the edges tests pin):

    - empty histogram (``count == 0``) → ``None`` — "no data" must be
      distinguishable from "0 seconds";
    - ``q <= 0`` → the lower edge of the first populated bucket (0.0
      when that is the first bucket — observations have no recorded
      lower bound below their bucket floor);
    - ``q >= 1`` → the upper bound of the highest populated bucket;
    - mass landing in ``+Inf`` reports the highest FINITE bound — the
      estimator cannot see above the top bucket, and returning a finite
      floor ("at least this") beats returning infinity.
    """
    buckets = snapshot.get("buckets") or {}
    count = int(snapshot.get("count") or 0)
    if count <= 0 or not buckets:
        return None
    pairs = sorted(
        ((_parse_bound(k), int(v)) for k, v in buckets.items()),
        key=lambda kv: kv[0],
    )
    top_finite = max(
        (b for b, _ in pairs if not math.isinf(b)), default=0.0
    )
    rank = min(max(float(q), 0.0), 1.0) * count
    prev_bound = 0.0
    prev_cumulative = 0
    for bound, cumulative in pairs:
        if cumulative > prev_cumulative and rank <= cumulative:
            if rank <= prev_cumulative:
                return prev_bound
            if math.isinf(bound):
                return top_finite
            fraction = (rank - prev_cumulative) / (
                cumulative - prev_cumulative
            )
            return prev_bound + (bound - prev_bound) * fraction
        prev_cumulative = cumulative
        prev_bound = top_finite if math.isinf(bound) else bound
    return top_finite


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A named metric with a fixed label-name set; children per label set."""

    def __init__(
        self,
        name: str,
        kind: str,
        help_text: str,
        labelnames: Tuple[str, ...],
        buckets: Optional[Sequence[float]] = None,
    ):
        self.name = _check_name(name)
        self.kind = kind
        self.help = help_text
        self.labelnames = labelnames
        self._buckets = buckets
        # lock order: family lock before any child lock (child creation);
        # never the reverse.
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], _Child] = {}
        if not labelnames:
            self._default = self.labels()

    def labels(self, **labels: str) -> _Child:
        if set(labels) != set(self.labelnames):
            raise MetricError(
                f"{self.name}: expected labels {sorted(self.labelnames)}, "
                f"got {sorted(labels)}"
            )
        key = tuple((k, str(labels[k])) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.kind == "histogram":
                    child = Histogram(key, self._buckets or DEFAULT_BUCKETS)
                else:
                    child = _KINDS[self.kind](key)
                self._children[key] = child
            return child

    # Label-free convenience: the family IS its single child.
    def inc(self, amount: float = 1.0) -> None:
        self._require_default().inc(amount)  # type: ignore[union-attr]

    def dec(self, amount: float = 1.0) -> None:
        self._require_default().dec(amount)  # type: ignore[union-attr]

    def set(self, value: float) -> None:
        self._require_default().set(value)  # type: ignore[union-attr]

    def set_function(self, fn: Callable[[], float]) -> None:
        self._require_default().set_function(fn)  # type: ignore[union-attr]

    def observe(self, value: float) -> None:
        self._require_default().observe(value)  # type: ignore[union-attr]

    @property
    def value(self):
        return self._require_default().value

    def _require_default(self) -> _Child:
        if self.labelnames:
            raise MetricError(
                f"{self.name} is labeled {self.labelnames}; use .labels(...)"
            )
        return self._default

    def children(self) -> List[_Child]:
        with self._lock:
            return list(self._children.values())


class MetricsRegistry:
    """The registry: one per run (or per standalone component)."""

    def __init__(self) -> None:
        # lock order: registry lock before family lock; never the reverse.
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # --------------------------------------------------------- registration

    def _register(
        self,
        name: str,
        kind: str,
        help_text: str,
        labelnames: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
    ) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            family = self._families.get(name)
            if family is not None:
                if family.kind != kind or family.labelnames != labelnames:
                    raise MetricError(
                        f"metric {name!r} already registered as "
                        f"{family.kind}{family.labelnames}; requested "
                        f"{kind}{labelnames}"
                    )
                return family
            family = _Family(name, kind, help_text, labelnames, buckets)
            self._families[name] = family
            return family

    def counter(
        self, name: str, help_text: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._register(name, "counter", help_text, labelnames)

    def gauge(
        self, name: str, help_text: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._register(name, "gauge", help_text, labelnames)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> _Family:
        return self._register(name, "histogram", help_text, labelnames, buckets)

    # --------------------------------------------------------------- access

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def value(
        self, name: str, labels: Optional[Mapping[str, str]] = None, default=None
    ):
        """Convenience read (manifest/heartbeat/tests): the value of one
        series, or ``default`` when the metric or label set is absent."""
        family = self.get(name)
        if family is None:
            return default
        if not family.labelnames:
            return family.value
        want = {k: str(v) for k, v in (labels or {}).items()}
        for child in family.children():
            if child.labels_dict == want:
                return child.value
        return default

    # -------------------------------------------------------------- exports

    def as_dict(self) -> Dict[str, Dict]:
        """JSON-safe snapshot: ``{name: {type, help, values: [...]}}`` with
        one entry per label set (``value`` for counters/gauges; cumulative
        ``buckets``/``sum``/``count`` for histograms)."""
        out: Dict[str, Dict] = {}
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        for family in families:
            values = []
            for child in family.children():
                entry: Dict[str, object] = {"labels": child.labels_dict}
                if family.kind == "histogram":
                    entry.update(child.snapshot())  # type: ignore[union-attr]
                else:
                    value = child.value  # type: ignore[union-attr]
                    entry["value"] = None if _is_nan(value) else value
                values.append(entry)
            out[family.name] = {
                "type": family.kind,
                "help": family.help,
                "values": values,
            }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        for family in families:
            if family.help:
                lines.append(
                    f"# HELP {family.name} {escape_help_text(family.help)}"
                )
            lines.append(f"# TYPE {family.name} {family.kind}")
            for child in family.children():
                label_text = _label_text(child.labels_dict)
                if family.kind == "histogram":
                    snap = child.snapshot()  # type: ignore[union-attr]
                    for bound, count in snap["buckets"].items():
                        le = _label_text({**child.labels_dict, "le": bound})
                        lines.append(f"{family.name}_bucket{le} {count}")
                    lines.append(
                        f"{family.name}_sum{label_text} {_num(snap['sum'])}"
                    )
                    lines.append(
                        f"{family.name}_count{label_text} {snap['count']}"
                    )
                else:
                    value = child.value  # type: ignore[union-attr]
                    lines.append(f"{family.name}{label_text} {_num(value)}")
        return "\n".join(lines) + "\n"


def _is_nan(value) -> bool:
    return isinstance(value, float) and math.isnan(value)


def _num(value: float) -> str:
    if _is_nan(value):
        return "NaN"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value)


def _label_text(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + body + "}"


def escape_label_value(value: str) -> str:
    """Label-value escaping per the text exposition format (v0.0.4):
    backslash FIRST (the escape character itself, so the later
    replacements cannot double-escape their own output), then the
    double-quote delimiter, then newline — the three characters the
    format names."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help_text(value: str) -> str:
    """HELP-line escaping per the exposition format: backslash and
    newline only (a ``#`` or quote is legal inside help text, but a raw
    newline would terminate the comment mid-help and turn the remainder
    into an unparseable exposition line)."""
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


__all__ = [
    "ANALYSIS_SITES_KEPT",
    "ANALYSIS_SITES_TESTED",
    "CONFORMANCE_PROVERS",
    "Counter",
    "DEFAULT_BUCKETS",
    "DEVICEGEN_DISPATCHES",
    "DEVICEGEN_SITES_CAPACITY",
    "GRAMIAN_CHECKPOINT_SAVES",
    "GRAMIAN_CHECKPOINT_SITES",
    "GRAMIAN_INFLIGHT_DISPATCHES",
    "Gauge",
    "HOST_BASELINE_RSS_BYTES",
    "HOST_PEAK_RSS_BYTES",
    "HOST_RUNTIME_BASELINE_BYTES",
    "HOST_STATIC_BOUND_BYTES",
    "Histogram",
    "INGEST_PARTITIONS_DONE",
    "INGEST_PARTITIONS_PLANNED",
    "INGEST_SITES_SCANNED",
    "IO_PARTITIONS_TOTAL",
    "MetricError",
    "MetricsRegistry",
    "PREFETCH_QUEUE_DEPTH",
    "PREFETCH_QUEUE_OCCUPANCY",
    "PROVER_CONFORMANCE_MEASURED",
    "PROVER_CONFORMANCE_PROVEN",
    "VCF_NATIVE_PARSE",
    "conformance_block",
    "escape_help_text",
    "escape_label_value",
    "histogram_quantile",
    "read_host_peak_rss_bytes",
    "record_prover_conformance",
    "well_known_counter",
    "well_known_gauge",
]
