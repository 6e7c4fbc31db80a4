"""Configuration fingerprints and the warm-geometry ledger.

The port's copy of ``spark_examples_tpu/utils/cache.py`` less its XLA
compile cache (the port builds its kernels once per source into
``build/torch_kernels/``, ``ops/_kernels.py``):

- the fingerprints, digests of the conf fields that shape an analysis,
  computed over the reference's field set and backend name (the port's
  ``device`` flag left out, ``gpu`` digested as ``tpu``), so each equals
  the reference's digest of the same argv: :func:`compile_fingerprint`
  (one analysis; it also keys the Gramian checkpoint,
  ``pipeline/checkpoint.py``), :func:`batch_compile_fingerprint` (the same
  made region-invariant: the batch-group key) and
  :func:`fused_group_fingerprint` (a stacked group of K jobs,
  ``pipeline/fused.py``);
- the warm-geometry ledger: a process-wide record of every geometry this
  process has run, :func:`record_geometry` counting a hit (seen before) or
  a miss (first sight), exported as the ``compile_cache_geometry_*``
  gauges and the manifest's ``compile_cache`` block. In the port a hit
  means the process has built and run every kernel that geometry launches.

The serve daemon makes the ledger outlive its process
(:func:`attach_geometry_ledger`, one fingerprint a line under its run
directory): a restarted daemon primes the ledger from the file and reports
a repeat geometry ``warm``. That is honest in the port because its kernels
are built once into ``build/torch_kernels/`` and loaded, never compiled
again, by a later process; the reference's other half, an XLA compile
cache, has no counterpart here.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
from typing import Optional, Set, Tuple

#: Conf fields that do NOT shape an analysis: output/telemetry placement,
#: credentials, and the robustness flags (checkpoint placement, resume
#: source, fault plans change WHEN work runs, never what it computes — and
#: the Gramian-checkpoint fingerprint requires the saving and the resuming
#: run to digest identically despite differing in exactly these flags).
#: Everything else (cohort, block size, mesh, strategy, dtype flags,
#: ingest path, references, input files) is part of the geometry. The
#: reference's set, name for name.
_NON_GEOMETRY_FIELDS = frozenset(
    {
        "output_path",
        "metrics_json",
        "heartbeat_seconds",
        "profile_dir",
        "client_secrets",
        "spark_master",
        "gramian_checkpoint_dir",
        "checkpoint_every_sites",
        "resume_from",
        "fault_plan",
        # The analyses' output placements: pure artifact paths.
        "grm_out",
        "ld_out",
        "assoc_out",
        # A plan-time knob of the reference's validator; a job's geometry
        # is the same in a fused group or alone (the group's own is
        # fused_group_fingerprint).
        "fused_jobs",
    }
)

#: Conf fields that pick WHICH contig windows stream through the kernels
#: without changing them: left out of :func:`batch_compile_fingerprint` on
#: top of the non-geometry fields.
_REGION_FIELDS = frozenset({"references", "all_references"})

#: Fields of the port's confs that the reference's do not have, and the
#: reference's name of the port's device backend.
_PORT_ONLY_FIELDS = frozenset({"device"})
_REFERENCE_BACKEND = {"gpu": "tpu"}

# lock order: a leaf lock — nothing else is acquired while holding it.
_geometry_lock = threading.Lock()
_seen_geometries: Set[str] = set()
_geometry_hits = 0
_geometry_misses = 0
#: The file every first-sight geometry is appended to, once attached.
_ledger_path: Optional[str] = None


def _reference_fields(conf) -> dict:
    """``{name: value}`` of a conf (a dataclass, or a mapping) in the
    reference's field set and backend name."""
    fields = getattr(conf, "__dataclass_fields__", None)
    if fields is not None:
        doc = {name: getattr(conf, name) for name in fields}
    else:
        doc = dict(conf)
    for name in _PORT_ONLY_FIELDS:
        doc.pop(name, None)
    if "pca_backend" in doc:
        doc["pca_backend"] = _REFERENCE_BACKEND.get(doc["pca_backend"], doc["pca_backend"])
    return doc


def _fingerprint_doc(conf, kind: str, exclude: frozenset) -> str:
    doc = {k: v for k, v in sorted(_reference_fields(conf).items()) if k not in exclude}
    doc["__kind__"] = kind
    blob = json.dumps(doc, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def compile_fingerprint(conf, kind: str = "pca") -> str:
    """Stable digest of one analysis geometry, the reference's
    ``compile_fingerprint``: every field of ``conf`` (a conf, or its
    ``{name: value}``) but the placement, telemetry and robustness flags,
    canonically serialized, with ``kind`` part of the key (a
    similarity-only run never runs the centring and the eigensolve)."""
    return _fingerprint_doc(conf, kind, _NON_GEOMETRY_FIELDS)


def batch_compile_fingerprint(conf, kind: str = "pca") -> str:
    """:func:`compile_fingerprint` made region-invariant, the reference's
    batch-group key: two jobs with equal batch fingerprints differ at most
    in which contig windows they scan (same cohort width, block size,
    mesh, strategy, ingest path), so they launch the same kernels at the
    same shapes and may ride one stacked group."""
    return _fingerprint_doc(conf, kind, _NON_GEOMETRY_FIELDS | _REGION_FIELDS)


def fused_group_fingerprint(batch_fingerprint: str, num_jobs: int) -> str:
    """A stacked group's own geometry: its (K, N, N) launches are shapes no
    serial member runs, so it is keyed by (the members' batch fingerprint,
    K)."""
    blob = f"fused:{batch_fingerprint}:{int(num_jobs)}"
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def geometry_seen(key: str) -> bool:
    """Has this process already run ``key``? Moves no counter."""
    with _geometry_lock:
        return key in _seen_geometries


def record_geometry(key: str) -> bool:
    """Record one run of geometry ``key``: ``True`` (a hit) when this
    process ran it before, ``False`` (a miss) on first sight. The counters
    move once per call. With a ledger file attached, a first-sight key is
    appended to it (fsync'd, outside the lock) so the next process primes
    it back."""
    global _geometry_hits, _geometry_misses
    with _geometry_lock:
        if key in _seen_geometries:
            _geometry_hits += 1
            return True
        _seen_geometries.add(key)
        _geometry_misses += 1
        ledger = _ledger_path
    if ledger is not None:
        try:
            with open(ledger, "a", encoding="utf-8") as f:
                f.write(key + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            print(
                f"warning: geometry ledger append failed ({e}); the next "
                "daemon incarnation will see this geometry cold",
                file=sys.stderr,
            )
    return False


def attach_geometry_ledger(path: str) -> int:
    """Prime the ledger from ``path`` (one 16-hex-digit fingerprint a line;
    anything else, such as a torn last line of a killed writer, is skipped)
    and append every later first-sight geometry there. Returns how many
    geometries were primed. Priming moves no counter: the hit and miss
    counts stay this process's own."""
    global _ledger_path
    keys = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                key = line.strip()
                if len(key) == 16 and all(c in "0123456789abcdef" for c in key):
                    keys.append(key)
    except FileNotFoundError:
        pass
    primed = 0
    with _geometry_lock:
        for key in keys:
            if key not in _seen_geometries:
                _seen_geometries.add(key)
                primed += 1
        _ledger_path = path
    return primed


def compile_cache_stats() -> Tuple[int, int]:
    """Process-wide ``(hits, misses)`` of the warm-geometry ledger."""
    with _geometry_lock:
        return _geometry_hits, _geometry_misses


def reset_compile_cache_stats() -> None:
    """Clear the ledger and its counters and detach any ledger file (tests
    only)."""
    global _geometry_hits, _geometry_misses, _ledger_path
    with _geometry_lock:
        _seen_geometries.clear()
        _geometry_hits = 0
        _geometry_misses = 0
        _ledger_path = None


__all__ = [
    "attach_geometry_ledger",
    "batch_compile_fingerprint",
    "compile_cache_stats",
    "compile_fingerprint",
    "fused_group_fingerprint",
    "geometry_seen",
    "record_geometry",
    "reset_compile_cache_stats",
]
