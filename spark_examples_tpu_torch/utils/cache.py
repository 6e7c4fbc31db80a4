"""Configuration fingerprints.

The port's copy of the fingerprint half of
``spark_examples_tpu/utils/cache.py``: a stable digest of every conf field
that shapes an analysis, which keys the Gramian checkpoint
(``pipeline/checkpoint.py:gramian_checkpoint_fingerprint``). The
reference's warm-geometry ledger, the serve executor's cache key, waits
for serving.
"""

from __future__ import annotations

import hashlib
import json
from typing import Mapping

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
        # A plan-time knob of the reference's validator; a batch run
        # ignores it.
        "fused_jobs",
    }
)


def compile_fingerprint(fields: Mapping, kind: str = "pca") -> str:
    """Stable digest of one analysis geometry, as the reference's
    ``compile_fingerprint`` computes it over a conf: every field of
    ``fields`` (a conf's ``{name: value}``) except the output/telemetry
    placement and robustness flags, canonically serialized, with ``kind``
    part of the key."""
    doc = {k: v for k, v in sorted(fields.items()) if k not in _NON_GEOMETRY_FIELDS}
    doc["__kind__"] = kind
    blob = json.dumps(doc, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


__all__ = ["compile_fingerprint"]
