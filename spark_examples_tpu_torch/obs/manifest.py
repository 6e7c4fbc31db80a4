"""Machine-readable run manifest (``--metrics-json PATH``).

The port's copy of ``spark_examples_tpu/obs/manifest.py``: one
schema-versioned JSON document with the config echo, the hierarchical span
tree, every registry metric, the I/O stats block (numerically identical to
the printed report — both read the same registry), the ingest-overlap
accounting and the host-memory block. It keeps the reference's schema
(``{"id": "spark-examples-tpu/run-manifest", "version": 2}``) and its
validator, so a manifest from either package passes both packages'
:func:`validate_manifest`.

The blocks whose subject the port does not have yet are absent exactly as
the reference writes them when absent: ``gramian_exactness`` is null, and
so is ``cost`` unless a caller passes one (a served job's prediction,
``obs/costmodel.py:CostPrediction.to_dict``, beside its
``measured_seconds``, ``queue_wait_seconds`` and ``compile``; the
reference's validator rules). ``compile_cache`` carries the warm-geometry ledger's
``geometry_hits`` and ``geometry_misses`` (``utils/cache.py``) as the
reference's does; its ``dir`` is null and its ``entries`` 0, the port
having no XLA compile cache. ``process`` is this
process's ``{index, count}`` and, beside the reference's two fields, the
``backend`` its run chose (``gloo``/``nccl``, null in a run of one
process); in a run of several processes ``multihost`` holds the I/O totals
summed across them (``parallel/multihost.py:aggregate_host_counts``, a
collective every process's manifest build joins), null otherwise.
``schedule`` is the sharded ring's block.
``resume`` is the checkpointed run's ``{checkpoint_sites, sites_skipped,
faults_injected}``, ``analysis`` an analysis verb's ``{kind, sites_kept,
sites_tested}``, both null otherwise. ``host_memory`` holds the OS's peak
RSS of this process, the bound the run registered
(``check/hostmem.py:conf_host_peak_bytes``) and, beside the reference's
two fields, the runtime baseline inside that bound
(``runtime_baseline_bytes``: measured at set-up on the card, the
reference's constant on the CPU). ``conformance`` holds the pairs the
driver's epilogue records: ``hostmem`` (peak RSS against that bound),
``sched`` when the sharded ring ran, and ``ranges`` under
``--check-ranges``. ``gramian_exactness`` is the ``--check-ranges``
block, ``{entry_max, static_entry_bound}`` from the host-fed
accumulators' sampled gauges, null without the flag.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Mapping, Optional

from spark_examples_tpu_torch.obs.metrics import (
    GRAMIAN_ENTRY_MAX,
    GRAMIAN_STATIC_ENTRY_BOUND,
    HOST_BASELINE_RSS_BYTES,
    HOST_RUNTIME_BASELINE_BYTES,
    HOST_STATIC_BOUND_BYTES,
    conformance_block,
    read_host_peak_rss_bytes,
)

MANIFEST_ID = "spark-examples-tpu/run-manifest"
MANIFEST_VERSION = 2

#: The I/O stats fields, in report order (``pipeline/stats.py.__str__``).
IO_STAT_FIELDS = (
    "partitions",
    "reference_bases",
    "variants",
    "requests",
    "unsuccessful_responses",
    "io_exceptions",
    "io_retries",
)

#: IO-stat fields added after schema v2 shipped: optional to the validator,
#: so archived v2 manifests stay valid.
OPTIONAL_IO_STAT_FIELDS = frozenset({"io_retries"})


def _json_safe(value):
    """Config echo must serialize whatever a conf dataclass carries."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, Mapping):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if dataclasses.is_dataclass(value):
        return _json_safe(dataclasses.asdict(value))
    return repr(value)


def _host_memory_block(registry=None) -> Dict:
    """The v2 ``host_memory`` block: measured peak RSS (read directly from
    the OS) next to the registered static bound and the runtime baseline
    inside it, each the reference's constant when none is registered (the
    bound is never null in schema v2)."""
    def registered(name):
        value = registry.value(name) if registry is not None else None
        if value is not None and value == value and value > 0:
            return int(value)
        return HOST_RUNTIME_BASELINE_BYTES

    peak = read_host_peak_rss_bytes()
    return {
        "peak_rss_bytes": int(peak) if peak is not None else None,
        "static_bound_bytes": registered(HOST_STATIC_BOUND_BYTES),
        "runtime_baseline_bytes": registered(HOST_BASELINE_RSS_BYTES),
    }


def _gramian_exactness_block(registry) -> Optional[Dict]:
    """The ``gramian_exactness`` block (``--check-ranges``): the measured
    max |accumulator entry| beside the statically projected bound — present
    only when the sampling ran (the gauges exist), so manifests of other
    runs are unchanged."""
    if registry is None:
        return None
    entry_max = registry.value(GRAMIAN_ENTRY_MAX)
    if entry_max is None or entry_max != entry_max:
        return None
    bound = registry.value(GRAMIAN_STATIC_ENTRY_BOUND)
    return {
        "entry_max": int(entry_max),
        "static_entry_bound": int(bound) if bound is not None and bound == bound else None,
    }


def build_manifest(
    config: Optional[Mapping] = None,
    spans: Optional[List[Dict]] = None,
    metrics: Optional[Dict] = None,
    io_stats: Optional[Dict] = None,
    overlap: Optional[Dict] = None,
    host_memory: Optional[Dict] = None,
    gramian_exactness: Optional[Dict] = None,
    conformance: Optional[Dict] = None,
    resume: Optional[Dict] = None,
    analysis: Optional[Dict] = None,
    schedule: Optional[Dict] = None,
    multihost: Optional[Dict] = None,
    cost: Optional[Dict] = None,
) -> Dict:
    """Assemble a manifest from already-snapshotted parts (the low-level
    form; :func:`build_run_manifest` snapshots a live driver). ``cost`` is
    a served job's block (module docstring)."""
    return {
        "schema": {"id": MANIFEST_ID, "version": MANIFEST_VERSION},
        "created_unix": time.time(),
        "config": _json_safe(dict(config) if config else {}),
        "spans": spans or [],
        "metrics": metrics or {},
        "io_stats": io_stats,
        "overlap": overlap,
        "host_memory": (
            host_memory if host_memory is not None else _host_memory_block()
        ),
        "gramian_exactness": gramian_exactness,
        "resume": resume,
        "analysis": analysis,
        "schedule": schedule,
        "conformance": conformance,
        "cost": cost,
        "compile_cache": _compile_cache_block(),
        "process": _process_block(),
        "multihost": multihost,
    }


def _compile_cache_block() -> Dict:
    """The reference's ``compile_cache`` block: the process's warm-geometry
    counts beside the XLA cache's directory and entries, which the port
    does not have (null and 0)."""
    from spark_examples_tpu_torch.utils.cache import compile_cache_stats

    hits, misses = compile_cache_stats()
    return {"dir": None, "entries": 0, "geometry_hits": hits, "geometry_misses": misses}


def _process_block() -> Dict:
    from spark_examples_tpu_torch.parallel.mesh import (
        process_backend,
        process_count,
        process_index,
    )

    return {"index": process_index(), "count": process_count(), "backend": process_backend()}


def build_run_manifest(conf=None, spans=None, registry=None, io_stats=None,
                       overlap=None, resume=None, analysis=None, schedule=None) -> Dict:
    """Snapshot a live run: ``conf`` (dataclass or mapping), the run's
    :class:`~spark_examples_tpu_torch.obs.spans.SpanRecorder` and
    :class:`~spark_examples_tpu_torch.obs.metrics.MetricsRegistry`, the
    driver's ``VariantsDatasetStats`` (or ``None`` when stats are disabled,
    as under ``--input-path``) and the structured overlap dict of
    ``PrefetchIterator.overlap_stats()``; ``resume`` and ``analysis`` are
    the blocks of a checkpointed run and of an analysis verb; ``schedule``
    the sharded strategy's ring block (``schedule_block()`` of its
    accumulator)."""
    config = (
        dataclasses.asdict(conf)
        if dataclasses.is_dataclass(conf)
        else dict(conf or {})
    )
    stats_block = io_stats.as_dict() if io_stats is not None else None
    multihost = None
    process = _process_block()
    if stats_block is not None and process["count"] > 1:
        from spark_examples_tpu_torch.parallel.multihost import aggregate_host_counts

        totals = aggregate_host_counts([stats_block[f] for f in IO_STAT_FIELDS])
        multihost = {
            "process_count": process["count"],
            "io_stats_global": dict(zip(IO_STAT_FIELDS, totals)),
        }
    return build_manifest(
        config=config,
        spans=spans.as_list() if spans is not None else [],
        metrics=registry.as_dict() if registry is not None else {},
        io_stats=stats_block,
        multihost=multihost,
        overlap=overlap,
        host_memory=_host_memory_block(registry),
        gramian_exactness=_gramian_exactness_block(registry),
        conformance=conformance_block(registry) if registry is not None else None,
        resume=resume,
        analysis=analysis,
        schedule=schedule,
    )


# ------------------------------------------------------------------ validate


def validate_manifest(doc) -> List[str]:
    """Structural validation; returns the list of problems (empty = valid).

    Checks schema identity/version, required top-level keys, the span tree
    shape (recursively), the metrics export shape, and the I/O stats block
    fields — the contract a manifest's readers rely on."""
    errors: List[str] = []
    if not isinstance(doc, Mapping):
        return ["manifest is not a JSON object"]

    schema = doc.get("schema")
    if not isinstance(schema, Mapping):
        errors.append("missing 'schema' object")
    else:
        if schema.get("id") != MANIFEST_ID:
            errors.append(f"schema.id {schema.get('id')!r} != {MANIFEST_ID!r}")
        if schema.get("version") != MANIFEST_VERSION:
            errors.append(
                f"schema.version {schema.get('version')!r} != {MANIFEST_VERSION}"
            )

    for key, kind in (
        ("created_unix", (int, float)),
        ("config", Mapping),
        ("spans", list),
        ("metrics", Mapping),
        ("process", Mapping),
    ):
        if key not in doc:
            errors.append(f"missing {key!r}")
        elif not isinstance(doc[key], kind):
            errors.append(f"{key!r} has wrong type {type(doc[key]).__name__}")

    def check_span(span, path: str) -> None:
        if not isinstance(span, Mapping):
            errors.append(f"span at {path} is not an object")
            return
        if not isinstance(span.get("name"), str):
            errors.append(f"span at {path} missing string 'name'")
        seconds = span.get("seconds")
        if seconds is not None and (
            not isinstance(seconds, (int, float)) or seconds < 0
        ):
            errors.append(f"span {span.get('name')!r} has bad seconds {seconds!r}")
        if not isinstance(span.get("synced"), bool):
            errors.append(f"span {span.get('name')!r} missing bool 'synced'")
        children = span.get("children")
        if not isinstance(children, list):
            errors.append(f"span {span.get('name')!r} missing list 'children'")
        else:
            for i, child in enumerate(children):
                check_span(child, f"{path}/{span.get('name')}[{i}]")

    for i, span in enumerate(doc.get("spans") or []):
        check_span(span, f"spans[{i}]")

    metrics = doc.get("metrics")
    if isinstance(metrics, Mapping):
        for name, family in metrics.items():
            if not isinstance(family, Mapping):
                errors.append(f"metric {name!r} is not an object")
                continue
            if family.get("type") not in ("counter", "gauge", "histogram"):
                errors.append(f"metric {name!r} has bad type {family.get('type')!r}")
            if not isinstance(family.get("values"), list):
                errors.append(f"metric {name!r} missing list 'values'")

    io_stats = doc.get("io_stats")
    if io_stats is not None:
        if not isinstance(io_stats, Mapping):
            errors.append("'io_stats' is neither null nor an object")
        else:
            for field in IO_STAT_FIELDS:
                if field in OPTIONAL_IO_STAT_FIELDS and field not in io_stats:
                    continue
                if not isinstance(io_stats.get(field), int):
                    errors.append(f"io_stats.{field} missing or not an int")

    overlap = doc.get("overlap")
    if overlap is not None and not isinstance(overlap, Mapping):
        errors.append("'overlap' is neither null nor an object")

    exactness = doc.get("gramian_exactness")
    if exactness is not None:
        if not isinstance(exactness, Mapping):
            errors.append("'gramian_exactness' is neither null nor an object")
        else:
            for field in ("entry_max", "static_entry_bound"):
                value = exactness.get(field, "absent")
                if value == "absent":
                    errors.append(f"gramian_exactness.{field} missing")
                elif value is not None and (
                    not isinstance(value, int)
                    or isinstance(value, bool)
                    or value < 0
                ):
                    errors.append(
                        f"gramian_exactness.{field} is neither null nor a "
                        f"non-negative int: {value!r}"
                    )

    resume = doc.get("resume")
    if resume is not None:
        if not isinstance(resume, Mapping):
            errors.append("'resume' is neither null nor an object")
        else:
            for field in (
                "checkpoint_sites",
                "sites_skipped",
                "faults_injected",
            ):
                value = resume.get(field, "absent")
                if (
                    value == "absent"
                    or not isinstance(value, int)
                    or isinstance(value, bool)
                    or value < 0
                ):
                    errors.append(
                        f"resume.{field} missing or not a non-negative "
                        f"int: {value!r}"
                    )

    analysis = doc.get("analysis")
    if analysis is not None:
        if not isinstance(analysis, Mapping):
            errors.append("'analysis' is neither null nor an object")
        else:
            kind = analysis.get("kind")
            if not isinstance(kind, str) or not kind:
                errors.append(
                    f"analysis.kind missing or not a non-empty string: "
                    f"{kind!r}"
                )
            for field in ("sites_kept", "sites_tested"):
                value = analysis.get(field, "absent")
                if value == "absent":
                    errors.append(f"analysis.{field} missing")
                elif value is not None and (
                    not isinstance(value, int)
                    or isinstance(value, bool)
                    or value < 0
                ):
                    errors.append(
                        f"analysis.{field} is neither null nor a "
                        f"non-negative int: {value!r}"
                    )

    conformance = doc.get("conformance")
    if conformance is not None:
        if not isinstance(conformance, Mapping):
            errors.append("'conformance' is neither null nor an object")
        else:
            for prover, pair in conformance.items():
                if prover not in ("hostmem", "sched", "ranges"):
                    errors.append(
                        f"conformance names unknown prover {prover!r}"
                    )
                    continue
                if pair is None:
                    continue
                if not isinstance(pair, Mapping):
                    errors.append(
                        f"conformance.{prover} is neither null nor an object"
                    )
                    continue
                measured = pair.get("measured", "absent")
                if (
                    measured == "absent"
                    or not isinstance(measured, int)
                    or isinstance(measured, bool)
                    or measured < 0
                ):
                    errors.append(
                        f"conformance.{prover}.measured missing or not a "
                        f"non-negative int: {measured!r}"
                    )
                proven = pair.get("proven", "absent")
                if proven == "absent" or (
                    proven is not None
                    and (
                        not isinstance(proven, int)
                        or isinstance(proven, bool)
                        or proven < 0
                    )
                ):
                    errors.append(
                        f"conformance.{prover}.proven is neither null nor "
                        f"a non-negative int: {proven!r}"
                    )
                ok = pair.get("ok", "absent")
                if ok == "absent" or (
                    ok is not None and not isinstance(ok, bool)
                ):
                    errors.append(
                        f"conformance.{prover}.ok is neither null nor a "
                        f"bool: {ok!r}"
                    )

    cost = doc.get("cost")
    if cost is not None:
        if not isinstance(cost, Mapping):
            errors.append("'cost' is neither null nor an object")
        else:
            for field in (
                "predicted_seconds",
                "measured_seconds",
                "queue_wait_seconds",
            ):
                value = cost.get(field, "absent")
                if (
                    value == "absent"
                    or isinstance(value, bool)
                    or not isinstance(value, (int, float))
                    or value != value
                    or value < 0
                ):
                    errors.append(
                        f"cost.{field} missing or not a non-negative "
                        f"number: {value!r}"
                    )
            compile_disposition = cost.get("compile")
            if compile_disposition not in ("warm", "cold"):
                errors.append(
                    f"cost.compile is neither 'warm' nor 'cold': "
                    f"{compile_disposition!r}"
                )

    schedule = doc.get("schedule")
    if schedule is not None:
        if not isinstance(schedule, Mapping):
            errors.append("'schedule' is neither null nor an object")
        else:
            kind = schedule.get("kind")
            if kind not in ("flat", "hier"):
                errors.append(
                    f"schedule.kind is neither 'flat' nor 'hier': {kind!r}"
                )
            for field in (
                "hosts",
                "devices_per_host",
                "predicted_ring_bytes",
                "measured_ring_bytes",
                "predicted_ici_bytes",
                "predicted_dcn_bytes",
            ):
                value = schedule.get(field, "absent")
                if (
                    value == "absent"
                    or not isinstance(value, int)
                    or isinstance(value, bool)
                    or value < 0
                ):
                    errors.append(
                        f"schedule.{field} missing or not a non-negative "
                        f"int: {value!r}"
                    )

    host_memory = doc.get("host_memory")
    if not isinstance(host_memory, Mapping):
        errors.append("missing 'host_memory' object (schema v2)")
    else:
        value = host_memory.get("peak_rss_bytes", "absent")
        if value == "absent":
            errors.append("host_memory.peak_rss_bytes missing")
        elif value is not None and (
            not isinstance(value, int) or isinstance(value, bool) or value < 0
        ):
            errors.append(
                f"host_memory.peak_rss_bytes is neither null nor a "
                f"non-negative int: {value!r}"
            )
        # static_bound_bytes is NOT nullable: the bound resolver is
        # total, so a manifest claiming "no bound" is a schema error.
        bound = host_memory.get("static_bound_bytes", "absent")
        if (
            bound == "absent"
            or not isinstance(bound, int)
            or isinstance(bound, bool)
            or bound <= 0
        ):
            errors.append(
                f"host_memory.static_bound_bytes missing or not a "
                f"positive int: {bound!r}"
            )
    return errors


# ----------------------------------------------------------------------- I/O


def write_manifest(path: str, doc: Mapping) -> None:
    """Write atomically (rename) so a crashed run never leaves a truncated
    manifest for a scheduler to half-parse. The temp name is per-process:
    multi-host processes pointed at one shared path must not interleave
    writes into a common ``.tmp`` — last rename wins cleanly instead."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)


def read_manifest(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def manifest_metric_value(
    doc: Mapping, name: str, labels: Optional[Mapping[str, str]] = None, default=None
):
    """Read one metric series out of a manifest (the consumer-side mirror
    of ``MetricsRegistry.value``)."""
    family = (doc.get("metrics") or {}).get(name)
    if not family:
        return default
    want = {k: str(v) for k, v in (labels or {}).items()}
    for entry in family.get("values", []):
        if entry.get("labels", {}) == want:
            if "value" in entry:
                return entry["value"]
            # Histogram series: the snapshot (buckets/sum/count), labels
            # stripped — a well-defined shape rather than the raw entry.
            return {k: v for k, v in entry.items() if k != "labels"}
    return default


__all__ = [
    "IO_STAT_FIELDS",
    "MANIFEST_ID",
    "MANIFEST_VERSION",
    "OPTIONAL_IO_STAT_FIELDS",
    "build_manifest",
    "build_run_manifest",
    "manifest_metric_value",
    "read_manifest",
    "validate_manifest",
    "write_manifest",
]
