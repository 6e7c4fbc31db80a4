"""Versioned JSON wire schema of the resident PCA service.

The port's copy of ``spark_examples_tpu/serve/protocol.py``: the same
protocol id, version, kinds and documents, so either package's client
speaks to either daemon and the two daemons' bodies compare key for key.

One request shape, one response envelope, one error envelope — all
carrying ``{"protocol": {"id": ..., "version": ...}}`` so clients and
servers from different trees fail loudly instead of half-parsing each
other. Analysis requests are expressed as the EXISTING flag namespace
(``config.build_pca_parser``'s argv form): the service adds no second
configuration grammar, and anything expressible as a batch CLI invocation
is expressible as a served job.

Request document (``POST /v1/jobs``)::

    {
      "protocol": {"id": "spark-examples-tpu/serve", "version": 1},
      "kind": "pca" | "similarity",
      "flags": ["--num-samples", "64", "--references", "17:0:20000"],
      "deadline_seconds": 30.0,      # optional: fail unstarted past this
      "tag": "nightly-brca1"         # optional client label
    }

``kind`` selects the result surface: ``pca`` returns the emitted PC rows,
``similarity`` stops after the ingest+similarity stage and returns a
host-side summary of the Gramian (shape, nonzero rows, trace). Both ride
the identical pipeline (``pipeline.pca_driver.run_pipeline``). ``grm``
runs the GRM/kinship analysis (``analyses/grm.py:run_grm_pipeline`` —
the identical analysis the batch ``grm`` verb runs) and returns the
kinship summary (shape, sites, trace, diagonal/off-diagonal means; the
N×N matrix itself never rides a response). The other per-site analyses
(``ld``, ``assoc``) are RESERVED kinds: recognized, rejected with
``reserved-kind`` — batch-only until their M-sized output spill gets a
served placement story — so a future server that serves them is a
protocol version bump, not a silent behavior change.

Versioning contract: a request whose ``protocol.version`` differs from
:data:`PROTOCOL_VERSION` is rejected with ``unsupported-protocol-version``
(HTTP 400) — never best-effort parsed. Unknown top-level fields are
rejected too (``unknown-field``): silently ignoring them would let a
future client believe a new knob was honored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

PROTOCOL_ID = "spark-examples-tpu/serve"
PROTOCOL_VERSION = 1

#: Request kinds and the result surface each returns. ``grm`` joined when
#: the analyses subsystem landed (its flags parse through the REAL
#: ``config.build_grm_parser``, its admission plan runs with
#: ``analysis="grm"``, and its warm-ledger fingerprint is kind-keyed so a
#: GRM run never pre-warms the PCA geometry).
JOB_KINDS = ("pca", "similarity", "grm")

#: Analysis kinds that exist as batch CLI verbs but are NOT served yet:
#: their outputs are per-site (M-sized) files, and a served job has no
#: client-visible placement for an O(M) artifact until the result-surface
#: story lands. Requests naming them get ``reserved-kind`` (HTTP 400) —
#: a deliberate, tested rejection distinct from an unknown kind.
RESERVED_KINDS = ("ld", "assoc")

#: Terminal job states (``GET /v1/jobs/<id>`` polling stops here).
TERMINAL_STATUSES = ("done", "failed", "cancelled")

_REQUEST_FIELDS = frozenset(
    {"protocol", "kind", "flags", "deadline_seconds", "tag"}
)


class ProtocolError(ValueError):
    """A request document that violates the wire schema; ``code`` is the
    machine-readable error code the HTTP layer returns in the 400 body."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


@dataclass(frozen=True)
class JobRequest:
    """One validated analysis request."""

    kind: str
    flags: Tuple[str, ...]
    deadline_seconds: Optional[float] = None
    tag: Optional[str] = None


def protocol_block() -> Dict:
    return {"id": PROTOCOL_ID, "version": PROTOCOL_VERSION}


def request_doc(
    flags: Sequence[str],
    kind: str = "pca",
    deadline_seconds: Optional[float] = None,
    tag: Optional[str] = None,
) -> Dict:
    """The wire form of one request (what ``serve/client.py`` posts)."""
    doc: Dict = {
        "protocol": protocol_block(),
        "kind": kind,
        "flags": list(flags),
    }
    if deadline_seconds is not None:
        doc["deadline_seconds"] = float(deadline_seconds)
    if tag is not None:
        doc["tag"] = str(tag)
    return doc


def parse_request(doc) -> JobRequest:
    """Validate one request document; raises :class:`ProtocolError` with a
    machine-readable code on every schema violation."""
    if not isinstance(doc, Mapping):
        raise ProtocolError("bad-request", "request body is not a JSON object")
    unknown = set(doc) - _REQUEST_FIELDS
    if unknown:
        raise ProtocolError(
            "unknown-field",
            f"unknown request field(s) {sorted(unknown)}; this server "
            f"speaks {PROTOCOL_ID} v{PROTOCOL_VERSION}",
        )
    protocol = doc.get("protocol")
    if not isinstance(protocol, Mapping):
        raise ProtocolError(
            "protocol-missing",
            "request carries no 'protocol' object; expected "
            f"{{'id': {PROTOCOL_ID!r}, 'version': {PROTOCOL_VERSION}}}",
        )
    if protocol.get("id") != PROTOCOL_ID:
        raise ProtocolError(
            "protocol-id",
            f"protocol.id {protocol.get('id')!r} != {PROTOCOL_ID!r}",
        )
    if protocol.get("version") != PROTOCOL_VERSION:
        raise ProtocolError(
            "unsupported-protocol-version",
            f"protocol.version {protocol.get('version')!r} is not supported "
            f"(this server speaks version {PROTOCOL_VERSION})",
        )
    kind = doc.get("kind")
    if kind in RESERVED_KINDS:
        raise ProtocolError(
            "reserved-kind",
            f"kind {kind!r} is a batch-only analysis for now (run the "
            f"CLI verb); served kinds are {list(JOB_KINDS)}",
        )
    if kind not in JOB_KINDS:
        raise ProtocolError(
            "unknown-kind",
            f"kind {kind!r} is not one of {list(JOB_KINDS)}",
        )
    flags = doc.get("flags")
    if not isinstance(flags, (list, tuple)) or not all(
        isinstance(f, str) for f in flags
    ):
        raise ProtocolError(
            "bad-flags",
            "'flags' must be a list of strings (the PCA CLI argv form)",
        )
    deadline = doc.get("deadline_seconds")
    if deadline is not None:
        if (
            isinstance(deadline, bool)
            or not isinstance(deadline, (int, float))
            or deadline <= 0
        ):
            raise ProtocolError(
                "bad-deadline",
                f"'deadline_seconds' must be a positive number, got "
                f"{deadline!r}",
            )
        deadline = float(deadline)
    tag = doc.get("tag")
    if tag is not None and not isinstance(tag, str):
        raise ProtocolError("bad-tag", f"'tag' must be a string, got {tag!r}")
    return JobRequest(
        kind=kind,
        flags=tuple(flags),
        deadline_seconds=deadline,
        tag=tag,
    )


def error_doc(
    code: str,
    message: str,
    plan: Optional[Mapping] = None,
    retry_after_seconds: Optional[float] = None,
) -> Dict:
    """The error envelope every non-2xx response carries. ``plan`` is the
    admission validator's structured report (issues + geometry facts) on
    plan rejections, so a 4xx tells the client exactly which contract its
    configuration broke — not just that it broke one."""
    doc: Dict = {
        "protocol": protocol_block(),
        "error": {"code": code, "message": message},
    }
    if plan is not None:
        doc["plan"] = dict(plan)
    if retry_after_seconds is not None:
        doc["error"]["retry_after_seconds"] = float(retry_after_seconds)
    return doc


def job_doc(
    job_id: str,
    kind: str,
    job_class: str,
    status: str,
    submitted_unix: float,
    tag: Optional[str] = None,
    started_unix: Optional[float] = None,
    finished_unix: Optional[float] = None,
    seconds: Optional[float] = None,
    error: Optional[str] = None,
    result: Optional[Mapping] = None,
    manifest_path: Optional[str] = None,
    compile_cache: Optional[str] = None,
    plan_geometry: Optional[Mapping] = None,
    slice_name: Optional[str] = None,
    batch_size: Optional[int] = None,
    fused_size: Optional[int] = None,
    trace: Optional[str] = None,
    cost: Optional[Mapping] = None,
) -> Dict:
    """The job envelope (submit response and ``GET /v1/jobs/<id>``).
    ``slice``/``batch_size`` are execution attribution (which executor
    slice ran the job, how many jobs rode its dispatch group);
    ``fused_size`` (additive) is the stacked-program group size when the
    job rode fused batch execution — 1 means a serial dispatch, even
    inside a multi-job batch group;
    ``trace`` echoes the job's distributed-tracing id (the client-sent
    ``X-Trace-Id`` when one rode the submit, a server-minted id
    otherwise); ``cost`` is the admission-time cost prediction
    (``obs/costmodel.py:CostPrediction.to_dict``, with measured fields
    merged once the job completes) — additive response fields;
    request-side strictness is unchanged."""
    return {
        "protocol": protocol_block(),
        "job": {
            "id": job_id,
            "trace": trace,
            "kind": kind,
            "class": job_class,
            "status": status,
            "tag": tag,
            "submitted_unix": submitted_unix,
            "started_unix": started_unix,
            "finished_unix": finished_unix,
            "seconds": seconds,
            "error": error,
            "result": dict(result) if result is not None else None,
            "manifest_path": manifest_path,
            "compile_cache": compile_cache,
            "plan_geometry": (
                dict(plan_geometry) if plan_geometry is not None else None
            ),
            "slice": slice_name,
            "batch_size": batch_size,
            "fused_size": fused_size,
            "cost": dict(cost) if cost is not None else None,
        },
    }


__all__ = [
    "PROTOCOL_ID",
    "PROTOCOL_VERSION",
    "JOB_KINDS",
    "RESERVED_KINDS",
    "TERMINAL_STATUSES",
    "ProtocolError",
    "JobRequest",
    "protocol_block",
    "request_doc",
    "parse_request",
    "error_doc",
    "job_doc",
]
