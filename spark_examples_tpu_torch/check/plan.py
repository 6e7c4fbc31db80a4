"""Device-free pipeline plan validation (``graftcheck plan``).

The port's counterpart of ``spark_examples_tpu/check/plan.py``, the
admission half: a whole-genome run is hours of wall clock, and a
partition/mesh/dtype error that only surfaces at the finalize reduce (or
at the first sharded flush) wastes all of it. This module dry-runs a full
flag configuration *statically*, and the serve daemon's admission runs
the same validator on every request:

- flag grammar and cross-flag contracts are parsed through the REAL parser
  (``config.build_pca_parser`` / ``PcaConf._from_namespace`` — never a
  drifted copy);
- mesh/partition geometry is checked arithmetically against a *declared*
  device count (``--plan-devices``), so the validator runs on a machine
  with no card;
- the kernels' plain versions run on ``torch.device("meta")`` tensors —
  shapes and dtypes, no storage — at the configured geometry, so ingest
  block → Xᵀ → accumulator agreement is checked by the code the CPU runs
  and at the shapes the card's wrappers take, without touching a device
  or allocating a byte;
- the sharded ring is audited through ``graftcheck ir`` (``check/
  ir.py``): one flush of the runtime's ring recorded on ``meta``
  positions at the configured geometry, its findings plan rejections
  (``ir-GIxxx``), its recorded bytes beside ``parallel/mesh.py:
  ring_traffic_bytes`` (the formula the ring's byte counter is held to on
  the card); its peak bytes are those of the port's ring buffers;
- exactness is proven by ``graftcheck ranges`` (``check/ranges.py``) over
  the schedules the dense and ring checks record (the configured kernels,
  as the reference audits them): its findings are plan rejections
  (``ranges-GRxxx``).

The HBM budget is a parameter (``device_bytes``, the plan CLI's
``--device-memory-bytes``); its default is the reference's device-free
``_DEFAULT_DEVICE_BYTES``, so a plan here rejects what the reference's
rejects, and a caller on the card passes
``ops/gramian.py:per_device_memory_bytes("cuda")``.

The population-genetics analyses (``analyses/``: GRM/kinship, windowed LD
pruning, association scan) validate through the same machinery —
``graftcheck plan --analysis grm|ld|assoc <flags>`` parses the REAL
per-verb parser (``config.build_grm_parser`` etc.), mirrors the runtime
admission gate (``analyses/base.py:analysis_conf_violations`` — one
catalogue, zero drift), and runs the per-site kernels' plain versions
(``ops/ld.py``) on ``meta`` tensors, so a doomed GRM/LD/assoc
configuration is an exit-2 reject before any ingest, exactly like a
doomed PCA one.

A declared ``--topology hosts,devices_per_host`` is proven by ``graftcheck
sched`` (``check/sched.py``): the ring the run would build on that fleet
is recorded at the configured geometry (``meta`` positions for the
host-fed ring, CPU ones for the device-generation ring, each kernel body
once a launch layout), each hop placed on its link class, and its
findings are plan rejections (``sched-GSxxx``, ``sched-GIxxx``);
``--sched-budget-seconds`` holds the predicted critical path over the
statically known site count to a budget (GS005).

Exit contract (``check/cli.py``): 0 = plan OK (warnings allowed),
2 = plan rejected with at least one error.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_examples_tpu_torch.config import (
    AssocConf,
    GrmConf,
    LdConf,
    PcaConf,
    build_assoc_parser,
    build_grm_parser,
    build_ld_parser,
    build_pca_parser,
)

#: The validated flag surfaces: one entry per CLI verb, each the REAL
#: parser/conf pair the verb itself parses — never a drifted copy.
ANALYSIS_SURFACES = {
    "pca": (build_pca_parser, PcaConf),
    "grm": (build_grm_parser, GrmConf),
    "ld": (build_ld_parser, LdConf),
    "assoc": (build_assoc_parser, AssocConf),
}


@dataclass
class PlanIssue:
    """One validation result: ``severity`` is 'error' (plan rejected) or
    'warning' (plan runs, but something is off-contract or wasteful)."""

    code: str
    severity: str
    message: str

    def format(self) -> str:
        return f"{self.severity.upper()} [{self.code}] {self.message}"


@dataclass
class PlanReport:
    issues: List[PlanIssue] = field(default_factory=list)
    #: Resolved geometry facts (mesh shape, shard count, padded cohort, ...).
    geometry: Dict[str, object] = field(default_factory=dict)
    #: Kernel signatures checked on meta tensors, for the human report.
    shape_checks: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not any(i.severity == "error" for i in self.issues)

    def error(self, code: str, message: str) -> None:
        self.issues.append(PlanIssue(code, "error", message))

    def warn(self, code: str, message: str) -> None:
        self.issues.append(PlanIssue(code, "warning", message))

    def to_json(self) -> str:
        return json.dumps(
            {
                "tool": "graftcheck-plan",
                "ok": self.ok,
                "issues": [
                    {"code": i.code, "severity": i.severity, "message": i.message}
                    for i in self.issues
                ],
                "geometry": self.geometry,
                "shape_checks": self.shape_checks,
            },
            indent=2,
        )

    def format(self) -> str:
        lines = []
        for key, value in self.geometry.items():
            lines.append(f"  {key}: {value}")
        for check in self.shape_checks:
            lines.append(f"  verified: {check}")
        for issue in self.issues:
            lines.append(f"  {issue.format()}")
        verdict = "plan OK" if self.ok else "plan REJECTED"
        lines.append(verdict)
        return "\n".join(lines)


class _RaisingParser(argparse.ArgumentParser):
    """argparse whose flag errors raise ``ValueError`` instead of
    ``SystemExit``-with-usage-text: the plan CLI reports them as
    machine-readable plan rejections, and in-process callers of
    ``check.cli.main(['plan', ...])`` get the documented int return.
    ``-h`` keeps argparse's normal exit."""

    def error(self, message):
        raise ValueError(message)


def parse_plan_args(argv: Sequence[str]):
    """Parse ``graftcheck plan`` argv: the analysis's full flag surface
    (``--analysis pca|grm|ld|assoc``, default pca — pre-scanned so the
    remaining flags parse through that verb's REAL parser) plus the
    plan-only ``--plan-devices`` and ``--host-mem-budget``. Returns the
    reference's tuple ``(conf, plan_devices, json_out, host_mem_budget,
    analysis, topology, sched_budget_seconds)``, ``topology`` a parsed
    :class:`~spark_examples_tpu_torch.parallel.mesh.Topology` or ``None``.
    Flag errors raise ``ValueError`` (argparse's SystemExit is converted
    so the caller reports them as plan rejections, not a CLI crash)."""
    argv = list(argv)
    analysis = "pca"
    for index, arg in enumerate(argv):
        if arg == "--analysis":
            if index + 1 >= len(argv):
                raise ValueError(
                    "--analysis needs a value: one of "
                    + "|".join(sorted(ANALYSIS_SURFACES))
                )
            analysis = argv[index + 1]
            del argv[index : index + 2]
            break
        if arg.startswith("--analysis="):
            analysis = arg.split("=", 1)[1]
            del argv[index]
            break
    if analysis not in ANALYSIS_SURFACES:
        raise ValueError(
            f"--analysis {analysis!r} is not one of "
            + "|".join(sorted(ANALYSIS_SURFACES))
        )
    build_parser, conf_cls = ANALYSIS_SURFACES[analysis]
    parser = build_parser(
        _RaisingParser(prog=f"graftcheck plan [{analysis}]", add_help=True)
    )
    parser.add_argument(
        "--analysis",
        choices=sorted(ANALYSIS_SURFACES),
        default=analysis,
        help=(
            "Which analysis surface to validate (default pca). Consumed "
            "by a pre-scan so the remaining flags parse through that "
            "verb's real parser; registered here so --help documents it."
        ),
    )
    parser.add_argument(
        "--plan-devices",
        type=int,
        default=None,
        help=(
            "Declared device count to validate the mesh against (the "
            "validator never queries real devices). Unset: device-count "
            "checks are skipped, geometry/shape checks still run."
        ),
    )
    parser.add_argument(
        "--host-mem-budget",
        type=int,
        default=None,
        metavar="BYTES",
        help=(
            "Host-RAM budget in bytes to enforce against the static bound "
            "parallel/mesh.py:host_peak_bytes (bounded ingest paths only — "
            "a configuration whose ingest is O(file) cannot be proven and "
            "is rejected under a budget). Over-budget configs exit 2."
        ),
    )
    parser.add_argument(
        "--topology",
        default=None,
        metavar="H,D",
        help=(
            "Declared fleet topology (hosts,devices_per_host — e.g. 32,8) "
            "to prove the reduction schedule against: the ring the run "
            "would build is recorded and simulated per link class "
            "(check/sched.py) — per-level traffic, overlap, liveness, and "
            "the GS rules, for a fleet that need not exist. The samples "
            "axis it implies is hosts x devices_per_host; an explicit "
            "--mesh-shape must agree."
        ),
    )
    parser.add_argument(
        "--sched-budget-seconds",
        type=float,
        default=None,
        metavar="S",
        help=(
            "Declared schedule-limited wall-clock budget for the whole "
            "run's statically-known site count: a topology whose "
            "predicted critical path exceeds it is a GS005 rejection "
            "(exit 2). Needs --topology."
        ),
    )
    parser.add_argument(
        "--json", action="store_true", help="Emit the machine-readable report."
    )
    ns = parser.parse_args(argv)
    conf = conf_cls._from_namespace(ns)
    topology = None
    if ns.topology is not None:
        from spark_examples_tpu_torch.parallel.mesh import parse_topology

        topology = parse_topology(ns.topology)  # ValueError -> rejection
    return (
        conf,
        ns.plan_devices,
        ns.json,
        ns.host_mem_budget,
        analysis,
        topology,
        ns.sched_budget_seconds,
    )


def _resolve_mesh_axes(
    conf: PcaConf, plan_devices: Optional[int], report: PlanReport
):
    """(data, samples) the run would build, mirroring
    ``pca_driver._make_mesh`` / ``parallel.mesh.default_mesh`` — or None
    when the mesh is unresolvable (errors recorded)."""
    from spark_examples_tpu_torch.parallel.mesh import parse_mesh_shape

    if conf.mesh_shape:
        try:
            shape = parse_mesh_shape(conf.mesh_shape)
        except ValueError as e:
            report.error("mesh-grammar", str(e))
            return None
        data, samples = shape["data"], shape["samples"]
        if data < 1 or samples < 1:
            report.error(
                "mesh-axis-size",
                f"--mesh-shape {conf.mesh_shape}: every axis must be >= 1",
            )
            return None
        if plan_devices is not None and data * samples > plan_devices:
            report.error(
                "mesh-exceeds-devices",
                f"--mesh-shape {conf.mesh_shape} needs {data * samples} "
                f"devices; --plan-devices declares {plan_devices} "
                "(make_mesh would raise at run start, after flags parsed "
                "but potentially after ingest warm-up)",
            )
        if data > conf.num_reduce_partitions:
            # The reference contract (GenomicsConf.scala:35-38 via
            # BASELINE.json): --num-reduce-partitions BOUNDS the data-axis
            # parallelism. default_mesh enforces the cap; an explicit mesh
            # that exceeds it contradicts the flag surface.
            report.error(
                "data-axis-exceeds-reduce-partitions",
                f"--mesh-shape data axis {data} exceeds "
                f"--num-reduce-partitions {conf.num_reduce_partitions}; "
                "the reduce-partition flag bounds data parallelism "
                "(raise it, or shrink the mesh)",
            )
        return data, samples
    # Default mesh: all declared devices data-major, samples axis 1,
    # data capped by --num-reduce-partitions (parallel/mesh.py:default_mesh).
    devices = plan_devices if plan_devices is not None else 1
    data = max(1, min(devices, conf.num_reduce_partitions))
    return data, 1


def _meta(shape, dtype):
    """An abstract operand: shape and dtype, no storage on any device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _eval_dense_update(report: PlanReport, data: int, conf: PcaConf):
    """Record the dense update of one data slice on ``meta`` tensors
    through the kernel wrappers (``check/ir.py``'s dense and counts
    updates at this geometry, the schedule alone; every slice runs the
    same update into its own partial): ingest block (B, ceil(N/8)) uint8
    → int8 Xᵀ → G (N, N) int32, and the count-valued block (B, N) uint8
    of a same-set join; then the data axis's sum. On the card the
    wrappers (``unpack_rows_t``, ``gram_accumulate``) take the same
    shapes. Returns the two recorded schedules, which the range audit
    reads, or ``None`` after a failure."""
    from spark_examples_tpu_torch.check.ir import (
        counts_kernel_spec,
        dense_kernel_spec,
        trace_kernel,
    )
    from spark_examples_tpu_torch.ops.gramian import data_axis_sum

    N = int(conf.num_samples)
    B = int(conf.block_size)
    try:
        traces = tuple(trace_kernel(spec(1, N, B, device="meta"), watch=False)
                       for spec in (dense_kernel_spec, counts_kernel_spec))
        final = data_axis_sum([_meta((N, N), torch.int32) for _ in range(data)])
    except Exception as e:  # noqa: BLE001 — the evaluation failure is the finding
        report.error(
            "dense-update-shape",
            f"dense Gramian update fails on ({B}, {N}) blocks: "
            f"{type(e).__name__}: {e}",
        )
        return None
    xt, xt_c = (next(op for op in trace.ops if op.role == "unpack").results[0]
                for trace in traces)
    if xt.shape[0] < N or xt.shape[1] < B or xt_c.shape != xt.shape:
        report.error(
            "counts-update-shape",
            f"the unpack maps ({B}, {N}) blocks to Xᵀ {tuple(xt.shape)} / "
            f"{tuple(xt_c.shape)}, which cannot hold {N} columns x {B} sites",
        )
    else:
        report.shape_checks.append(
            f"dense update: ({B}, {N}) uint8 blocks -> Xᵀ {tuple(xt.shape)} "
            f"int8 -> G {(N, N)} int32, on {data} data slice(s)"
        )
    if tuple(final.shape) != (N, N):
        report.error(
            "finalize-shape",
            f"finalize reduce yields {tuple(final.shape)}, expected {(N, N)}",
        )
    else:
        report.shape_checks.append(
            f"finalize sum over data axis: {data} x {(N, N)} -> "
            f"{tuple(final.shape)} {str(final.dtype).replace('torch.', '')}"
        )
    return traces


def _eval_stacked_update(
    report: PlanReport, fused_jobs: int, conf: PcaConf
) -> None:
    """Run the stacked-jobs step's plain versions on ``meta`` tensors
    (``--fused-jobs K``): packed blocks (K, B, ceil(N/8)) → the stacked Xᵀ
    (K·n_pad rows) → G (K, N, N) int32, and one job's slice of it, which
    is what the fused runner hands each job's epilogue. The wrappers
    (``ops/batched.py``) take the same shapes."""
    from spark_examples_tpu_torch.ops.batched import (
        stacked_gram_accumulate_plain,
        stacked_unpack_rows_t_plain,
    )

    K = int(fused_jobs)
    N = int(conf.num_samples)
    B = int(conf.block_size)
    G = _meta((K, N, N), torch.int32)
    try:
        xt = stacked_unpack_rows_t_plain(_meta((K, B, -(-N // 8)), torch.uint8), N)
        stacked_gram_accumulate_plain(G, xt)
    except Exception as e:  # noqa: BLE001 — the evaluation failure is the finding
        report.error(
            "stacked-update-shape",
            f"stacked {K}-job Gramian update fails on ({K}, {B}, {N}) "
            f"blocks: {type(e).__name__}: {e} — per-job accumulator lanes "
            "would diverge",
        )
        return
    lane = G[0]
    if tuple(lane.shape) != (N, N):
        report.error(
            "stacked-slice-shape",
            f"per-job slice of the stacked accumulator yields "
            f"{tuple(lane.shape)}, expected {(N, N)}",
        )
        return
    report.shape_checks.append(
        f"stacked update: jobs={K}, ({K}, {B}, {N}) uint8 blocks -> Xᵀ "
        f"{tuple(xt.shape)} int8 -> G {tuple(G.shape)} int32; per-job slice "
        f"-> {tuple(lane.shape)}"
    )


#: Simultaneous per-device buffers of the sharded strategy at peak: the
#: local G row-tile, its non-donated update output, and the (smaller)
#: column-block operands rounded up to one more tile (the reference's
#: rule, kept so both packages reject the same geometries).
_SHARDED_BUFFERS = 3


def _eval_sharded_update(
    report: PlanReport,
    data: int,
    samples: int,
    conf: PcaConf,
    device_bytes: int,
) -> None:
    """The sharded ring's geometry facts: the pack-width-padded cohort
    (rounded exactly as the accumulators round it), per-device ring tile
    bytes, per-flush ring traffic (``parallel/mesh.py:ring_traffic_bytes``,
    the formula the ring's byte counter is held to on the card), the peak
    bytes of the port's ring buffers (``ops/gramian.py:
    sharded_peak_bytes``) and the HBM feasibility check against
    ``device_bytes``; then, under ``--similarity-strategy sharded``, the
    ring's audit (:func:`_audit_sharded_ring`: its shifts a flush and its
    recorded bytes), else one ring step on ``meta`` tensors. Returns the
    sharded ring's recorded schedule (``None`` where none was recorded),
    which the range audit reads."""
    from spark_examples_tpu_torch.ops.devicegen import (
        COL_TILE,
        cross_accumulate_plain,
    )
    from spark_examples_tpu_torch.ops.gramian import (
        DENSE_HBM_FRACTION,
        resolve_ring_pack,
        sharded_peak_bytes,
        unpack_rows_t_plain,
    )
    from spark_examples_tpu_torch.parallel.mesh import (
        RING_PACK_MULTIPLE,
        padded_cohort,
        ring_traffic_bytes,
    )

    N = int(conf.num_samples)
    B = int(conf.block_size)
    pack = resolve_ring_pack(getattr(conf, "ring_pack_bits", "auto"))
    padded = padded_cohort(N, samples, pack=pack)
    n_local = padded // samples
    if pack and n_local % RING_PACK_MULTIPLE:
        # Unreachable through padded_cohort — a defensive contract check so
        # a future geometry change cannot silently ship a ragged packed
        # tile (the ring would shard mid-byte and corrupt columns).
        report.error(
            "ring-pack-width",
            f"packed ring needs a per-device column width divisible by "
            f"{RING_PACK_MULTIPLE}, got {n_local} "
            f"(padded cohort {padded} over samples={samples})",
        )
        return
    if padded != N:
        rule = (
            f"{RING_PACK_MULTIPLE}x the samples axis (packed-ring "
            "pack-width invariant)"
            if pack
            else f"the samples axis ({samples})"
        )
        report.warn(
            "cohort-padding",
            f"--num-samples {N} is not a multiple of {rule}; the sharded "
            f"accumulator auto-rounds the cohort to {padded} "
            f"(+{(padded - N) * 100.0 / N:.1f}% all-zero pad columns, "
            "trimmed at finalize)",
        )
    width = n_local // RING_PACK_MULTIPLE if pack else n_local
    report.geometry["ring_pack_bits"] = "packed" if pack else "unpacked"
    report.geometry["ring_local_columns"] = n_local
    report.geometry["ring_tile_bytes_per_device"] = B * width
    report.geometry["ring_bytes_per_flush"] = ring_traffic_bytes(
        data * B, samples, n_local, pack
    )
    accum_bytes = 4
    tile_bytes = n_local * padded * accum_bytes
    report.geometry["sharded_tile_bytes_per_device"] = tile_bytes
    if (
        conf.similarity_strategy == "sharded"
        and _SHARDED_BUFFERS * tile_bytes > DENSE_HBM_FRACTION * device_bytes
    ):
        report.error(
            "sharded-exceeds-hbm",
            f"--similarity-strategy sharded with N={N} over samples="
            f"{samples} needs ~"
            f"{_SHARDED_BUFFERS * tile_bytes / (1 << 30):.1f} GiB of "
            f"ring working buffers per device, past "
            f"{DENSE_HBM_FRACTION:.0%} of the "
            f"{device_bytes / (1 << 30):.1f} GiB budget; widen the "
            "samples axis",
        )

    if conf.similarity_strategy == "sharded":
        trace = _audit_sharded_ring(report, data, samples, N, B, pack, padded)
        report.geometry["ring_peak_live_bytes_per_device"] = sharded_peak_bytes(
            n_local, padded, B, pack
        )
        return trace
    # No ring runs on a dense strategy's samples axis: one ring step of one
    # position, its row tile's owner columns taking Xᵀ_mine · X_owner
    # (``ops/gramian.py:ring_pass``), the received tile unpacked first.
    try:
        G_tile = _meta((n_local, padded), torch.int32)
        if pack:
            mine = unpack_rows_t_plain(_meta((B, width), torch.uint8), n_local)
        else:
            mine = unpack_rows_t_plain(
                _meta((B, n_local), torch.uint8), n_local, counts=True
            )
        cross_accumulate_plain(G_tile[:, :n_local], mine, mine)
    except Exception as e:  # noqa: BLE001 — the evaluation failure is the finding
        report.error(
            "sharded-update-trace",
            f"sharded ring step fails on a {data}x{samples} mesh: "
            f"{type(e).__name__}: {e}",
        )
        return None
    n_pad = -(-n_local // COL_TILE) * COL_TILE
    if tuple(mine.shape[:1]) != (n_pad,) or tuple(G_tile.shape) != (n_local, padded):
        report.error(
            "sharded-update-shape",
            f"sharded update maps a ({B}, {width}) tile to Xᵀ "
            f"{tuple(mine.shape)} and G tile {tuple(G_tile.shape)}",
        )
        return None
    wire = "bit-packed" if pack else "unpacked"
    report.shape_checks.append(
        f"sharded ring step over a {data}x{samples} mesh: ({B}, {width}) "
        f"{wire} uint8 tiles -> Xᵀ {tuple(mine.shape)} int8 -> G tile "
        f"{(n_local, padded)} int32 a position"
    )
    # A flat ring shifts each tile samples - 1 times a flush.
    report.geometry["ring_permute_steps"] = samples - 1
    report.geometry["ring_peak_live_bytes_per_device"] = sharded_peak_bytes(
        n_local, padded, B, pack
    )
    return None


def _audit_sharded_ring(
    report: PlanReport, data: int, samples: int, N: int, B: int, pack: bool, padded: int
):
    """The configured ring through ``graftcheck ir`` (``check/ir.py``):
    one flush of the runtime's ``RingLayout.flush`` recorded over
    ``data x samples`` positions of ``meta`` tensors at this geometry, the
    schedule alone (``audit_kernel(watch=False)``: the rules of dispatched
    operations do not depend on the geometry, and ``graftcheck ir`` holds
    them over its matrix). Any
    finding is an ``ir-GIxxx`` plan rejection — the configured ring would
    ship without its contracts; the schedule's shift count and bytes land
    in the report (``ring_permute_steps``, ``ring_bytes_per_flush_jaxpr``:
    the reference's key, here the recorded schedule's bytes, which must
    equal ``ring_bytes_per_flush``). Returns the recorded schedule (the
    range audit reads it: one recording an admission), or ``None`` when
    the update did not run."""
    from spark_examples_tpu_torch.check.ir import audit_kernel, ring_kernel_spec, trace_kernel
    from spark_examples_tpu_torch.parallel.mesh import RING_PACK_MULTIPLE

    spec = ring_kernel_spec(data, samples, N, B, pack, device="meta")
    try:
        trace = trace_kernel(spec, watch=False)
    except Exception as e:  # noqa: BLE001 — any failure to run is the finding (GI000)
        report.error(
            "sharded-update-trace",
            f"sharded ring update fails on a {data}x{samples} mesh: update failed to run "
            f"under the schedule recorder: {type(e).__name__}: {e}",
        )
        return None
    audit = audit_kernel(spec, traced=trace)
    g_shape = (data, padded, padded)
    out_shape = tuple(audit.facts["out_shapes"][0])
    out_dtype = audit.facts["out_dtypes"][0]
    if out_shape != g_shape or out_dtype != "int32":
        report.error(
            "sharded-update-shape",
            f"sharded update maps {g_shape} to {out_shape} {out_dtype}",
        )
    else:
        wire = "bit-packed" if pack else "unpacked"
        x_width = padded // RING_PACK_MULTIPLE if pack else padded
        report.shape_checks.append(
            f"sharded ring update over a {data}x{samples} mesh: "
            f"({data}, {B}, {x_width}) {wire} uint8 blocks -> G {out_shape} {out_dtype}"
        )
    for finding in audit.findings:
        report.error(f"ir-{finding.rule_id}", finding.detail)
    report.geometry["ring_bytes_per_flush_jaxpr"] = audit.facts["ring_bytes_jaxpr"]
    report.geometry["ring_permute_steps"] = audit.facts["permute_executions"]
    if audit.ok:
        report.shape_checks.append(
            f"ring schedule audit over a {data}x{samples} mesh: "
            f"{audit.facts['permute_executions']} independent shift(s), accumulator "
            "written in place, recorded ring bytes == ring_traffic_bytes"
        )
    return trace


def warm_ring_audit() -> None:
    """Pay a process's first ``meta`` ring audit now: the first ``meta``
    operations import PyTorch's reference and shape modules, seconds that
    would otherwise land on the first sharded plan (a served admission)."""
    from spark_examples_tpu_torch.check.ir import audit_kernel, ring_kernel_spec

    audit_kernel(ring_kernel_spec(1, 2, 64, 8, True, device="meta"), watch=False)


def _check_exactness(report: PlanReport, data: int, samples: int, conf: PcaConf,
                     dense_traces=None, ring_trace=None) -> None:
    """Range/exactness proof of the CONFIGURED kernels (``graftcheck
    ranges``, ``check/ranges.py``, over exactly the geometry the run
    would build), as the reference's plan audits them: the dense update,
    and the count-valued one when set ids repeat; on a samples axis the
    ring, and the count-valued (unpacked) ring when set ids repeat. The
    audits read the schedules this plan already recorded
    (``dense_traces`` of :func:`_eval_dense_update`, one data slice's,
    ``ring_trace`` of
    :func:`_audit_sharded_ring`; the count-valued ring shares the unpacked
    ring's schedule), recording only what no check recorded. Each finding
    is a ``ranges-GRxxx`` rejection. Then the geometry-level facts:
    ``gramian_entry_bound`` (the declared static site count ×
    max_count², when the synthetic grid makes the site count statically
    known), which past int32's window rejects the plan, and
    ``exactness_headroom_sites``, the largest site count provable exact on
    each dtype."""
    from spark_examples_tpu_torch.check.ranges import (
        audit_range_kernel,
        counts_range_spec,
        dense_range_spec,
        ring_range_spec,
    )
    from spark_examples_tpu_torch.ops.contracts import (
        exact_int_window,
        exactness_headroom_sites,
        flush_entry_increment,
    )
    from spark_examples_tpu_torch.ops.gramian import resolve_ring_pack

    N, B = int(conf.num_samples), int(conf.block_size)
    exact = bool(getattr(conf, "exact_similarity", False))
    pack = resolve_ring_pack(getattr(conf, "ring_pack_bits", "auto"))
    ids = list(conf.variant_set_id)
    max_count = max((ids.count(i) for i in set(ids)), default=1)
    dense_trace, counts_trace = dense_traces or (None, None)

    audits = []
    if conf.similarity_strategy != "sharded":
        audits.append(audit_range_kernel(dense_range_spec(data, N, B, device="meta"),
                                         traced=dense_trace, watch=False))
        if max_count > 1:
            # Duplicate set ids take the count-valued (same-set-join) update.
            audits.append(audit_range_kernel(counts_range_spec(data, N, B, device="meta"),
                                             traced=counts_trace, watch=False))
    if samples >= 2:
        audits.append(audit_range_kernel(
            ring_range_spec(data, samples, N, B, pack, exact, device="meta"),
            traced=ring_trace, watch=False))
        if max_count > 1:
            # Count-valued flushes ride the unpacked ring whatever
            # --ring-pack-bits says: prove that path under the count contract.
            audits.append(audit_range_kernel(
                ring_range_spec(data, samples, N, B, False, exact, counts=True, device="meta"),
                traced=ring_trace if not pack else None, watch=False))
    partial = 0.0
    for audit in audits:
        for finding in audit.findings:
            report.error(f"ranges-{finding.rule_id}", finding.detail)
        partial = max(partial, float(audit.facts.get("dot_partial_bound", 0)))
    if audits and all(a.ok for a in audits):
        increment = max(float(a.facts["entry_increment"]) for a in audits)
        report.shape_checks.append(
            f"range audit ({len(audits)} kernel(s)): per-dispatch partial <= {partial:g} "
            f"exact, entry increment <= {increment:g}/flush, flush projection proven "
            "conservative (GR005)"
        )
    report.geometry["exactness_headroom_sites"] = {
        "float32": exactness_headroom_sites(np.float32, max_count),
        "int32": exactness_headroom_sites(np.int32, max_count),
    }

    static_rows = _static_site_rows(conf)
    if static_rows is None:
        report.geometry["gramian_entry_bound"] = None
        return
    entry_bound = flush_entry_increment(static_rows, max_count)
    report.geometry["gramian_entry_bound"] = entry_bound
    int32_window = exact_int_window(np.int32) or 0
    if entry_bound > int32_window:
        report.error(
            "exactness-window",
            f"the declared geometry bounds a Gramian entry at "
            f"{entry_bound} ({static_rows} candidate sites x max_count "
            f"{max_count}²), past int32's exact-integer window "
            f"({int32_window}) — no dtype-ladder rung can hold the count "
            "exactly; shrink --references or split the cohort",
        )


def _static_site_rows(conf: PcaConf) -> Optional[int]:
    """Statically-known total variant rows, or None: the synthetic grid
    has one candidate site per DEFAULT_VARIANT_SPACING bases, so explicit
    ``--references`` windows bound the total statically (variant sets
    share the site grid; file/REST cohorts carry their counts in the
    data, so no static bound exists for them). Shared by the exactness
    facts (``gramian_entry_bound``) and the cost model's compute term."""
    if (
        getattr(conf, "source", "synthetic") != "synthetic"
        or conf.all_references
        or conf.input_path
    ):
        return None
    try:
        from spark_examples_tpu_torch.sources.synthetic import (
            DEFAULT_VARIANT_SPACING,
        )

        return sum(
            (contig.end - contig.start) // DEFAULT_VARIANT_SPACING + 1
            for contigs in conf.get_references()
            for contig in contigs
        )
    except (ValueError, TypeError):
        return None


def _check_schedule(
    report: PlanReport,
    conf: PcaConf,
    topology,
    data: int,
    samples: int,
    sched_budget_seconds: Optional[float],
    plan_devices: Optional[int] = None,
) -> None:
    """The collective-schedule proof for a DECLARED topology
    (``check/sched.py`` over the configured ring's geometry): resolve the
    schedule ``--reduce-schedule`` would build on that topology, record
    and simulate it, and turn GS/GI findings into plan rejections — a
    multi-host run is schedule-proven before the fleet exists.
    ``--sched-budget-seconds`` projects the critical path over the
    statically-known site count (GS005); a budget over an unknowable site
    count is itself a rejection (the flag asks for a proof the
    configuration cannot give — the ``--host-mem-budget`` rule)."""
    from spark_examples_tpu_torch.check.sched import audit_schedule
    from spark_examples_tpu_torch.ops.gramian import resolve_ring_pack
    from spark_examples_tpu_torch.parallel.mesh import resolve_reduce_schedule

    if conf.mesh_shape and samples != topology.devices:
        # An explicit mesh must span the declared fleet's samples axis —
        # including the data-only (samples=1) spelling, which pins a run
        # that dispatches no ring at all; only the default-mesh case
        # (no --mesh-shape) lets the topology imply the schedule mesh.
        report.error(
            "topology-mesh-mismatch",
            f"--topology {topology.describe()} implies a samples axis of "
            f"{topology.devices} but --mesh-shape {conf.mesh_shape} "
            f"declares {samples}; the schedule would not span the "
            "declared pod",
        )
        return
    if plan_devices is not None and plan_devices != topology.devices:
        # One report must describe ONE fleet: the mesh/HBM/host-mem facts
        # are computed against --plan-devices while the schedule proof
        # spans the topology — a disagreement proves a plan no single
        # run can execute.
        report.error(
            "topology-devices-mismatch",
            f"--topology {topology.describe()} declares "
            f"{topology.devices} devices but --plan-devices declares "
            f"{plan_devices}; the geometry facts and the schedule proof "
            "would describe different pods",
        )
        return
    schedule = resolve_reduce_schedule(
        getattr(conf, "reduce_schedule", "auto"), topology.hosts
    )
    static_rows = _static_site_rows(conf)
    if sched_budget_seconds is not None and sched_budget_seconds <= 0:
        report.error(
            "sched-budget-seconds",
            f"--sched-budget-seconds must be positive, got "
            f"{sched_budget_seconds}",
        )
        return
    if sched_budget_seconds is not None and static_rows is None:
        report.error(
            "sched-budget-unprovable",
            "--sched-budget-seconds needs a statically-known site count "
            "to project the schedule over (synthetic source with explicit "
            "--references); this configuration's total rows are only "
            "known at run time, so no critical-path proof exists",
        )
        return
    # Prove the ring the run would actually dispatch: device ingest rides
    # the fused generation ring, not the host-fed Gramian ring.
    kernel = "devicegen" if conf.ingest == "device" else "gramian"
    audit = audit_schedule(
        topology,
        schedule,
        num_samples=int(conf.num_samples),
        block_size=int(conf.block_size),
        data=data if conf.mesh_shape and samples == topology.devices else 1,
        pack=resolve_ring_pack(getattr(conf, "ring_pack_bits", "auto")),
        rows=static_rows,
        budget_seconds=sched_budget_seconds,
        selected=True,
        kernel=kernel,
        device="meta" if kernel == "gramian" else "cpu",
    )
    for finding in audit.findings:
        report.error(f"sched-{finding.rule_id}", finding.detail)
    report.geometry["sched_topology"] = topology.describe()
    report.geometry["sched_schedule"] = schedule
    report.geometry["sched_kernel"] = audit.facts.get("kernel")
    report.geometry["sched_ici_bytes"] = audit.facts.get("ici_bytes")
    report.geometry["sched_dcn_bytes"] = audit.facts.get("dcn_bytes")
    report.geometry["sched_rows"] = audit.facts.get("sim_rows")
    report.geometry["sched_critical_path_seconds"] = audit.facts.get(
        "critical_path_seconds"
    )
    if audit.ok:
        report.shape_checks.append(
            f"schedule audit on {topology.describe()}: {schedule} "
            f"schedule, ici {audit.facts.get('ici_bytes')} B / dcn "
            f"{audit.facts.get('dcn_bytes')} B per flush == formula, "
            "overlap clean, predicted critical path "
            f"{audit.facts.get('critical_path_seconds'):.3g} s over "
            f"{audit.facts.get('sim_rows')} rows"
        )


def _check_artifact_parent(
    report: PlanReport, code: str, flag: str, path: Optional[str]
) -> None:
    """An output artifact whose parent directory is missing/unwritable only
    fails AFTER the analysis streamed every site — the exact class of
    late-surfacing error the validator exists to catch (the
    ``--metrics-json`` rule, shared by the analyses' out flags)."""
    if not path:
        return
    import os

    parent = os.path.dirname(os.path.abspath(path)) or "."
    if not os.path.isdir(parent):
        report.error(
            code,
            f"{flag} {path}: parent directory {parent} does not exist; "
            "the output publish would fail AFTER the analysis completed",
        )
    elif not os.access(parent, os.W_OK):
        report.error(
            code,
            f"{flag} {path}: parent directory {parent} is not writable; "
            "the output publish would fail AFTER the analysis completed",
        )
    elif os.path.isdir(path):
        report.error(
            code,
            f"{flag} {path} is a directory; the output needs a file path",
        )


def _check_analysis(
    report: PlanReport,
    conf: PcaConf,
    analysis: str,
    samples: int,
    device_bytes: int,
) -> None:
    """The device-free mirror of the analyses' runtime admission gate
    (``analyses/base.py:analysis_conf_violations`` — the ONE catalogue)
    plus per-analysis flag contracts: LD window/threshold grammar and the
    samples-axis divisibility the window's split over positions needs, the assoc
    phenotype TSV (parsed HERE, device-free, including synthetic-cohort
    coverage), and every per-site output path's parent."""
    from spark_examples_tpu_torch.analyses.base import analysis_conf_violations

    for code, message in analysis_conf_violations(conf, analysis):
        report.error(code, message)

    if analysis == "grm":
        _check_artifact_parent(
            report, "grm-out", "--grm-out", getattr(conf, "grm_out", None)
        )
        return

    if analysis == "ld":
        threshold = getattr(conf, "ld_r2_threshold", 0.2)
        if not 0.0 <= threshold <= 1.0:
            report.error(
                "ld-r2-threshold",
                f"--ld-r2-threshold must be in [0, 1], got {threshold} "
                "(outside the range every site, or no site, is pruned)",
            )
        window = int(getattr(conf, "ld_window_sites", 256))
        if window < 2:
            report.error(
                "ld-window-sites",
                f"--ld-window-sites must be >= 2, got {window} (a "
                "one-site window has nothing to correlate)",
            )
        else:
            N = int(conf.num_samples)
            report.geometry["ld_window_sites"] = window
            # The per-window device statistics: C (W, W) int32 + k (W,)
            # int32 — the whole M-sized analysis only ever materializes
            # this much at once (plus the (W, N) uint8 window buffer).
            stats_bytes = window * window * 4 + window * 4
            report.geometry["ld_window_stats_bytes"] = stats_bytes
            report.geometry["ld_window_buffer_bytes"] = window * N
            from spark_examples_tpu_torch.ops.gramian import DENSE_HBM_FRACTION

            if stats_bytes > DENSE_HBM_FRACTION * device_bytes:
                report.error(
                    "ld-window-exceeds-hbm",
                    f"--ld-window-sites {window} needs a ~"
                    f"{stats_bytes / (1 << 30):.1f} GiB W×W statistics "
                    f"matrix per flush, past {DENSE_HBM_FRACTION:.0%} of "
                    f"the {device_bytes / (1 << 30):.1f} GiB HBM "
                    "budget; shrink the window (host memory scales with "
                    "W² too — see host_peak_bytes)",
                )
        if (
            samples >= 2
            and conf.pca_backend != "host"
            and int(conf.num_samples) % samples
        ):
            # --pca-backend host runs the NumPy window oracle: no mesh,
            # no sharding constraint (mirrors analyses/ld.py).
            report.error(
                "ld-cohort-not-divisible",
                f"--num-samples {conf.num_samples} does not divide over "
                f"the mesh samples axis ({samples}); the LD window kernel "
                "shards sample columns without padding (choose a mesh "
                "whose samples axis divides the cohort)",
            )
        _check_artifact_parent(
            report, "ld-out", "--ld-out", getattr(conf, "ld_out", None)
        )
        return

    # assoc
    top = int(getattr(conf, "assoc_top", 10))
    if top < 1:
        report.error(
            "assoc-top", f"--assoc-top must be >= 1, got {top}"
        )
    phenotypes = getattr(conf, "phenotypes", None)
    if not phenotypes:
        report.error(
            "assoc-phenotypes",
            "the assoc analysis requires --phenotypes TSV "
            "(name<TAB>status per line, status 0=control/1=case)",
        )
    else:
        from spark_examples_tpu_torch.analyses.assoc import load_phenotypes

        try:
            statuses = load_phenotypes(phenotypes)
        except (OSError, ValueError) as e:
            report.error("assoc-phenotypes", f"--phenotypes: {e}")
        else:
            cases = sum(statuses.values())
            report.geometry["assoc_cases"] = cases
            report.geometry["assoc_controls"] = len(statuses) - cases
            if getattr(conf, "source", "synthetic") == "synthetic":
                # The synthetic cohort's callset names are derivable
                # device-free, so the strict both-ways coverage check the
                # runtime applies (``analyses/assoc.py:case_vector``) runs
                # at plan time too; file cohorts carry their names in the
                # data, so only the runtime can check them.
                from spark_examples_tpu_torch.analyses.assoc import case_vector
                from spark_examples_tpu_torch.pipeline.pca_driver import (
                    make_source,
                )

                try:
                    callsets = make_source(conf).search_callsets(
                        conf.variant_set_id
                    )
                    case_vector(
                        statuses, [cs["name"] for cs in callsets]
                    )
                except ValueError as e:
                    report.error("assoc-cohort-mismatch", str(e))
    _check_artifact_parent(
        report, "assoc-out", "--assoc-out", getattr(conf, "assoc_out", None)
    )


def _eval_analysis_kernels(
    report: PlanReport, conf: PcaConf, analysis: str, data: int, samples: int
) -> None:
    """The per-site kernels the analysis will dispatch, their plain
    versions run on ``meta`` tensors — zero devices, zero bytes: the LD
    window's transposed packing (N, ceil(W/8)) uint8 → Xᵀ → C (W, W)
    int32 and k = diag(C) (``ops/ld.py:window_counts``; over a samples
    axis each position takes N / samples of the packing's rows), and the
    association counts of a (B, ceil(N/8)) block against the case mask
    (``ops/ld.py:case_counts``)."""
    N = int(conf.num_samples)
    if analysis == "ld":
        from spark_examples_tpu_torch.ops.devicegen import gram_accumulate_plain
        from spark_examples_tpu_torch.ops.gramian import unpack_rows_t_plain

        window = int(conf.ld_window_sites)
        positions = samples if samples >= 2 else 1
        mesh_note = (
            f"a {data}x{samples} mesh" if samples >= 2 else "single-device"
        )
        try:
            C = _meta((window, window), torch.int32)
            packed = _meta((N // positions, -(-window // 8)), torch.uint8)
            for _ in range(positions):
                gram_accumulate_plain(C, unpack_rows_t_plain(packed, window))
            k = torch.diagonal(C)
        except Exception as e:  # noqa: BLE001 — the evaluation failure is the finding
            report.error(
                "ld-window-stats-trace",
                f"LD window-statistics kernel fails over {mesh_note}: "
                f"{type(e).__name__}: {e}",
            )
            return
        if (
            tuple(C.shape) != (window, window)
            or C.dtype != torch.int32
            or tuple(k.shape) != (window,)
        ):
            report.error(
                "ld-window-stats-shape",
                f"LD window statistics map ({window}, {N}) uint8 to "
                f"C {tuple(C.shape)} {C.dtype}, k {tuple(k.shape)} — "
                f"expected (({window}, {window}) int32, ({window},) int32)",
            )
        else:
            report.shape_checks.append(
                f"LD window stats over {mesh_note}: ({window}, {N}) uint8 "
                f"window -> C ({window}, {window}) int32, k ({window},) "
                "int32"
            )
        return

    if analysis == "assoc":
        from spark_examples_tpu_torch.ops.ld import case_counts_plain

        B = int(conf.block_size)
        width = -(-N // 8)
        try:
            a, t = case_counts_plain(
                _meta((B, width), torch.uint8), _meta((width,), torch.uint8), N
            )
        except Exception as e:  # noqa: BLE001 — the evaluation failure is the finding
            report.error(
                "assoc-counts-trace",
                f"association counts kernel fails: {type(e).__name__}: {e}",
            )
            return
        if (
            tuple(a.shape) != (B,)
            or tuple(t.shape) != (B,)
            or a.dtype != torch.int32
        ):
            report.error(
                "assoc-counts-shape",
                f"association counts map ({B}, {N}) uint8 blocks to "
                f"a {tuple(a.shape)} {a.dtype}, t {tuple(t.shape)} — "
                f"expected (({B},) int32, ({B},) int32)",
            )
        else:
            report.shape_checks.append(
                f"association counts: ({B}, {N}) uint8 blocks x ({N},) "
                f"case mask -> a ({B},) int32, t ({B},) int32"
            )


def _check_host_memory(
    conf: PcaConf,
    plan_devices: Optional[int],
    host_mem_budget: Optional[int],
    report: PlanReport,
) -> None:
    """Host-memory facts + budget enforcement: the static bound from the
    ONE formula (``parallel/mesh.py:host_peak_bytes``, resolved through
    ``check/hostmem.py:conf_host_peak_bytes`` — the same resolver the
    driver's ``host_static_bound_bytes`` gauge uses). The resolver is
    TOTAL: every configuration — wire ingest, JSONL/SAM, REST, multi-set
    joins, checkpoint resume — gets a finite bound as a geometry fact,
    so ``--host-mem-budget`` is enforceable against ANY workload; the
    only failure mode left is a bound genuinely over budget."""
    from spark_examples_tpu_torch.check.hostmem import conf_host_peak_bytes

    bound = conf_host_peak_bytes(conf, device_count=plan_devices)
    report.geometry["host_peak_bytes"] = bound
    if host_mem_budget is not None and bound > host_mem_budget:
        report.error(
            "host-mem-over-budget",
            f"static host-memory bound ~{bound / (1 << 30):.2f} GiB "
            f"(parallel/mesh.py:host_peak_bytes) exceeds "
            f"--host-mem-budget {host_mem_budget} "
            f"({host_mem_budget / (1 << 30):.2f} GiB); shrink the "
            "ingest window (--stream-chunk-bytes, --ingest-workers, "
            "--block-size) or raise the budget",
        )


def validate_plan(
    conf: PcaConf,
    plan_devices: Optional[int] = None,
    host_mem_budget: Optional[int] = None,
    analysis: str = "pca",
    topology=None,
    sched_budget_seconds: Optional[float] = None,
    device_bytes: Optional[int] = None,
) -> PlanReport:
    """Statically validate one pipeline configuration. Pure flag/geometry
    arithmetic plus the kernels' plain versions on ``meta`` tensors — no
    device is queried. ``device_bytes`` is the HBM budget every memory
    rule applies (default the reference's device-free 16 GiB,
    ``ops/gramian.py:_DEFAULT_DEVICE_BYTES``); ``topology`` (a
    :class:`~spark_examples_tpu_torch.parallel.mesh.Topology`) adds the
    schedule proof, ``sched_budget_seconds`` its critical-path budget.
    ``analysis`` selects the validated workload: ``pca`` (the default —
    also the ``similarity`` served kind) keeps every Gramian proof;
    ``grm`` adds the analyses' shared admission gate on top of them (its
    device work IS the Gramian); ``ld``/``assoc`` swap the Gramian
    shape/exactness/HBM proofs for their own per-site kernel proofs —
    they never allocate an N×N accumulator, so rejecting an LD plan for a
    Gramian-only bound would be a false contract."""
    if analysis not in ANALYSIS_SURFACES:
        raise ValueError(
            f"analysis {analysis!r} is not one of "
            + "|".join(sorted(ANALYSIS_SURFACES))
        )
    from spark_examples_tpu_torch.ops.gramian import _DEFAULT_DEVICE_BYTES

    if device_bytes is None:
        device_bytes = _DEFAULT_DEVICE_BYTES
    report = PlanReport()
    if analysis != "pca":
        report.geometry["analysis"] = analysis
    if plan_devices is not None:
        # The device count every device-bound check below ran against —
        # with executor slices (serve/daemon.py) this is the TARGET
        # SLICE's count, not the whole pod's, so a rejection body says
        # which budget the job actually failed.
        report.geometry["plan_devices"] = int(plan_devices)
    if host_mem_budget is not None and host_mem_budget <= 0:
        report.error(
            "host-mem-budget",
            f"--host-mem-budget must be a positive byte count, got "
            f"{host_mem_budget}",
        )
        host_mem_budget = None

    # ---------------------------------------------------------- flag sanity
    if conf.num_reduce_partitions < 1:
        report.error(
            "reduce-partitions",
            f"--num-reduce-partitions must be >= 1, got "
            f"{conf.num_reduce_partitions}",
        )
    if conf.bases_per_partition <= 0:
        report.error(
            "bases-per-partition",
            f"--bases-per-partition must be positive, got "
            f"{conf.bases_per_partition} (shard enumeration would reject it)",
        )
    if conf.block_size < 1:
        report.error(
            "block-size", f"--block-size must be >= 1, got {conf.block_size}"
        )
    if conf.num_pc < 1:
        report.error("num-pc", f"--num-pc must be >= 1, got {conf.num_pc}")
    elif conf.num_pc > conf.num_samples and analysis == "pca":
        # Only the PCA pipeline eigensolves; the analyses ride the PCA
        # flag surface but never call compute_pca, so a defaulted --num-pc
        # must not reject a 1-sample GRM/LD/assoc run.
        report.error(
            "num-pc-exceeds-cohort",
            f"--num-pc {conf.num_pc} exceeds the cohort size "
            f"{conf.num_samples}: the eigensolve cannot produce more "
            "components than samples",
        )
    if conf.ingest == "device" and conf.source != "synthetic":
        report.error(
            "device-ingest-source",
            f"--ingest device requires --source synthetic "
            f"(got --source {conf.source}); the fused on-device generator "
            "has no data plane for file/REST inputs",
        )
    if conf.ingest == "device" and conf.pca_backend != "gpu":
        report.error(
            "device-ingest-backend",
            "--ingest device requires --pca-backend gpu",
        )
    try:
        # Programmatic PcaConf construction bypasses argparse's choices;
        # validate through the ONE runtime resolver, never a copied set.
        from spark_examples_tpu_torch.ops.gramian import resolve_ring_pack

        resolve_ring_pack(getattr(conf, "ring_pack_bits", "auto"))
    except ValueError as e:
        report.error("ring-pack-bits", str(e))
    try:
        from spark_examples_tpu_torch.parallel.mesh import resolve_reduce_schedule

        resolve_reduce_schedule(getattr(conf, "reduce_schedule", "auto"), 1)
    except ValueError as e:
        report.error("reduce-schedule", str(e))
    if sched_budget_seconds is not None and topology is None:
        report.error(
            "sched-budget-seconds",
            "--sched-budget-seconds needs --topology: a critical-path "
            "budget is a claim about a specific pod's link bandwidths",
        )

    # Robustness flags (pipeline/checkpoint.py + utils/faults.py): a
    # checkpointed whole-genome run that only discovers its resume flags
    # are incoherent AFTER the preemption is the worst possible time.
    checkpointing = bool(
        getattr(conf, "gramian_checkpoint_dir", None)
        or getattr(conf, "resume_from", None)
    )
    if checkpointing and conf.pca_backend != "gpu":
        report.error(
            "checkpoint-backend",
            "--gramian-checkpoint-dir/--resume-from snapshot the DEVICE "
            "accumulator; they need --pca-backend gpu",
        )
    if checkpointing and conf.ingest == "device":
        report.error(
            "checkpoint-device-ingest",
            "--ingest device has no host-fed row cursor to checkpoint or "
            "resume; use --ingest packed or wire (auto falls back for "
            "checkpointed runs)",
        )
    every = getattr(conf, "checkpoint_every_sites", None)
    if every is not None and every < 1:
        report.error(
            "checkpoint-every-sites",
            f"--checkpoint-every-sites must be >= 1, got {every}",
        )
    elif every is not None and not getattr(
        conf, "gramian_checkpoint_dir", None
    ):
        report.warn(
            "checkpoint-every-sites",
            "--checkpoint-every-sites without --gramian-checkpoint-dir "
            "has nothing to snapshot; the cadence is ignored",
        )
    fault_plan = getattr(conf, "fault_plan", None)
    if fault_plan is not None:
        try:
            from spark_examples_tpu_torch.utils.faults import parse_plan

            parse_plan(fault_plan)
        except ValueError as e:
            report.error("fault-plan", str(e))

    # Observability flags: nonsense here only surfaces at the END of an
    # hours-long run (the heartbeat thread refusing to start, or the
    # manifest write failing after the epilogue) — exactly the class of
    # error the plan validator exists to catch up front. The parse path
    # rejects a negative heartbeat too; this validates programmatic
    # PcaConf construction, which bypasses _from_namespace.
    if conf.heartbeat_seconds < 0:
        report.error(
            "heartbeat-seconds",
            f"--heartbeat-seconds must be >= 0 (0 = off), got "
            f"{conf.heartbeat_seconds}",
        )
    if conf.metrics_json:
        import os

        parent = os.path.dirname(os.path.abspath(conf.metrics_json)) or "."
        if not os.path.isdir(parent):
            report.error(
                "metrics-json-parent",
                f"--metrics-json {conf.metrics_json}: parent directory "
                f"{parent} does not exist; the run manifest write would "
                "fail AFTER the run completed",
            )
        elif not os.access(parent, os.W_OK):
            report.error(
                "metrics-json-parent",
                f"--metrics-json {conf.metrics_json}: parent directory "
                f"{parent} is not writable; the run manifest write would "
                "fail AFTER the run completed",
            )
        elif os.path.isdir(conf.metrics_json):
            report.error(
                "metrics-json-parent",
                f"--metrics-json {conf.metrics_json} is a directory; the "
                "manifest needs a file path",
            )

    # -------------------------------------------------------- shard windows
    n_shards: Optional[int] = None
    if not conf.all_references and conf.bases_per_partition > 0:
        try:
            contig_lists = conf.get_references()
        except (ValueError, TypeError) as e:
            report.error("references-grammar", f"--references: {e}")
        else:
            n_shards = sum(
                len(contig.get_shards(conf.bases_per_partition))
                for contigs in contig_lists
                for contig in contigs
            )
            report.geometry["shard_windows"] = n_shards
            if n_shards == 0:
                report.error(
                    "no-shards",
                    "--references yields zero shard windows: nothing to "
                    "ingest",
                )

    # ------------------------------------------------------------- the mesh
    axes = _resolve_mesh_axes(conf, plan_devices, report)
    if axes is None:
        return report
    data, samples = axes
    report.geometry["mesh"] = f"data={data}, samples={samples}"
    report.geometry["devices_needed"] = data * samples

    sharded = conf.similarity_strategy == "sharded"
    if sharded and samples < 2:
        report.error(
            "sharded-needs-samples-axis",
            "--similarity-strategy sharded needs a mesh samples axis of at "
            f"least 2, resolved mesh has samples={samples} "
            "(use --mesh-shape data,samples)",
        )
    if getattr(conf, "reduce_schedule", "auto") == "hier" and conf.mesh_shape:
        # hier serves BOTH ingest families — the host-fed accumulators and
        # the fused generation ring (``ops/devicegen.py:_ring_update`` runs
        # the two-level tile exchange when its mesh carries a host axis) —
        # so device ingest no longer rejects it. What IS statically
        # checkable is the factorization invariant: the host factor must
        # divide the DECLARED samples axis (without --mesh-shape the
        # topology implies the mesh and divides by construction). Offline,
        # the factor is the declared topology's host count, else the
        # rehearsal env override; absent both it is a runtime fact (the
        # process count) that ``resolve_hier_hosts`` enforces loudly at
        # accumulator construction.
        import os

        from spark_examples_tpu_torch.parallel.mesh import HIER_HOSTS_ENV

        hier_hosts = None
        if topology is not None:
            hier_hosts = int(topology.hosts)
        else:
            env = os.environ.get(HIER_HOSTS_ENV, "")
            if env.isdigit():
                hier_hosts = int(env)
        if hier_hosts is not None and hier_hosts > 1 and samples % hier_hosts:
            report.error(
                "hier-hosts-samples-axis",
                f"--reduce-schedule hier needs the host factor "
                f"({hier_hosts}) to divide the mesh samples axis "
                f"({samples}); choose a mesh whose samples axis is a "
                "multiple of the host count",
            )
    if n_shards is not None and n_shards < data:
        report.warn(
            "data-axis-starvation",
            f"only {n_shards} shard window(s) feed a data axis of {data}; "
            "blocks stripe across the staging buffer so devices still "
            "receive work, but the data-parallel speedup is bounded by "
            "the window count",
        )

    # -------------------------------------- analyses admission gate (if any)
    if analysis != "pca":
        _check_analysis(report, conf, analysis, samples, device_bytes)

    # --------------------------------------- the kernels on meta tensors
    # GRM's device work IS the Gramian accumulation (analyses/grm.py rides
    # the full driver), so pca and grm check the Gramian kernels; ld and
    # assoc never allocate an N×N accumulator — they check their own
    # per-site kernels instead.
    gramian_like = analysis in ("pca", "grm")
    if conf.pca_backend == "gpu" and gramian_like:
        dense_traces = ring_trace = None
        if report.ok:
            dense_traces = _eval_dense_update(report, data, conf)
        if report.ok and conf.fused_jobs is not None:
            if conf.fused_jobs < 1:
                report.error(
                    "fused-jobs-invalid",
                    f"--fused-jobs must be >= 1, got {conf.fused_jobs}",
                )
            else:
                _eval_stacked_update(report, conf.fused_jobs, conf)
        if report.ok and (sharded or samples >= 2):
            ring_trace = _eval_sharded_update(report, data, samples, conf, device_bytes)
        # ---------------------------------------- range/exactness proof
        if report.ok:
            _check_exactness(report, data, samples, conf, dense_traces, ring_trace)
    if conf.pca_backend == "gpu" and not gramian_like and report.ok:
        _eval_analysis_kernels(report, conf, analysis, data, samples)

    # ----------------------------------------- schedule proof (if declared)
    if topology is not None and report.ok:
        if (
            conf.pca_backend == "gpu"
            and gramian_like
            and conf.similarity_strategy != "dense"
        ):
            _check_schedule(
                report,
                conf,
                topology,
                data,
                samples,
                sched_budget_seconds,
                plan_devices,
            )
        else:
            # No collective reduction exists to prove: the host backend
            # and the per-site analyses dispatch no ring, and an EXPLICIT
            # dense strategy pins the replicated accumulator even across
            # hosts (auto would resolve sharded there, so auto still
            # proves).
            why = (
                "--pca-backend host"
                if conf.pca_backend != "gpu"
                else (
                    f"--analysis {analysis}"
                    if not gramian_like
                    else "--similarity-strategy dense"
                )
            )
            if sched_budget_seconds is not None:
                # A declared budget the configuration cannot prove is a
                # rejection, never a silent pass (the --host-mem-budget
                # rule).
                report.error(
                    "sched-budget-unprovable",
                    "--sched-budget-seconds declares a schedule-limited "
                    "budget, but this configuration dispatches no "
                    f"collective reduction to prove ({why} has no ring "
                    "schedule); drop the budget or validate a ring-"
                    "bearing gpu configuration",
                )
            else:
                report.warn(
                    "sched-not-applicable",
                    f"--topology {topology.describe()} declared, but "
                    f"this configuration dispatches no collective "
                    f"reduction ({why}) — no schedule facts to prove",
                )

    # --------------------------------------------------- memory feasibility
    from spark_examples_tpu_torch.ops.gramian import (
        _DENSE_BUFFERS,
        DENSE_HBM_FRACTION,
    )

    N = int(conf.num_samples)
    accum_bytes = 4
    dense_need = _DENSE_BUFFERS * N * N * accum_bytes
    if gramian_like:
        report.geometry["dense_accumulator_bytes_per_device"] = (
            N * N * accum_bytes
        )
    staging = data * conf.block_size * N
    report.geometry["host_staging_bytes"] = staging
    _check_host_memory(conf, plan_devices, host_mem_budget, report)
    if not gramian_like:
        # LD/assoc never build the Gramian: no dense-HBM rule to apply.
        return report
    if not sharded and conf.similarity_strategy == "dense":
        # Explicit dense: validate against the budget (the validator must
        # not query real devices; the run's auto rule reads the card's
        # memory). Auto configs fall back to sharded at run time, so only
        # the EXPLICIT flag can be infeasible.
        if dense_need > DENSE_HBM_FRACTION * device_bytes:
            report.error(
                "dense-exceeds-hbm",
                f"--similarity-strategy dense with N={N} needs ~"
                f"{dense_need / (1 << 30):.1f} GiB of working buffers per "
                f"device, past {DENSE_HBM_FRACTION:.0%} of the "
                f"{device_bytes / (1 << 30):.1f} GiB budget; use "
                "the sharded strategy (and a samples axis)",
            )
    if conf.fused_jobs is not None and conf.fused_jobs >= 1:
        # The stacked program's HBM liveness is K× the per-job dense
        # liveness (K accumulator lanes resident at once, same working
        # buffers per lane) — the rejection that caps a batch group's
        # size BEFORE devices are touched. The group ceiling rides the
        # geometry either way, so serve admission and graftcheck plan
        # agree on the largest K a cohort admits.
        from spark_examples_tpu_torch.ops.batched import max_fused_jobs

        K = int(conf.fused_jobs)
        fused_need = K * dense_need
        ceiling = max_fused_jobs(
            N, accum_bytes=accum_bytes, device_bytes=device_bytes
        )
        report.geometry["fused_jobs"] = K
        report.geometry["max_fused_jobs"] = ceiling
        report.geometry["fused_group_hbm_bytes"] = fused_need
        if fused_need > DENSE_HBM_FRACTION * device_bytes:
            report.error(
                "fused-group-exceeds-hbm",
                f"a fused group of {K} jobs with N={N} needs ~"
                f"{fused_need / (1 << 30):.1f} GiB of stacked working "
                f"buffers per device, past {DENSE_HBM_FRACTION:.0%} of "
                f"the {device_bytes / (1 << 30):.1f} GiB budget "
                f"(this cohort admits at most {ceiling} fused job(s)); "
                "shrink the group or serve the jobs serially",
            )
    return report


def predict_job_cost(
    conf: PcaConf,
    topology=None,
    *,
    kind: str = "pca",
    plan_devices: Optional[int] = None,
    geometry: Optional[Dict] = None,
    device_bytes: Optional[int] = None,
):
    """One job's admission-time :class:`~spark_examples_tpu_torch.obs.costmodel.
    CostPrediction`, assembled from the SAME geometry facts the plan
    validator proves — plan, serve admission, and bench share this ONE
    estimator, so a prediction printed by ``graftcheck plan`` and one
    stamped on a served job can never disagree.

    ``geometry`` short-circuits re-validation: serve admission already
    ran :func:`validate_plan` and passes ``report.geometry`` straight in
    (one validation per job, not two). Without it, this validates the
    plan itself (``topology`` adds the schedule simulator's critical-path
    term). The prediction is always produced, even
    for a plan with findings — a cost estimate is telemetry, not a gate;
    admission rejects on the findings separately. The rates are
    ``obs/costmodel.py``'s, measured on the card."""
    from spark_examples_tpu_torch.obs.costmodel import (
        COMPILE_COLD,
        COMPILE_WARM,
        CostPrediction,
        estimate_seconds,
    )
    from spark_examples_tpu_torch.utils.cache import (
        compile_fingerprint,
        geometry_seen,
    )

    if geometry is None:
        analysis = kind if kind in ANALYSIS_SURFACES else "pca"
        report = validate_plan(
            conf,
            plan_devices=plan_devices,
            analysis=analysis,
            topology=topology,
            device_bytes=device_bytes,
        )
        geometry = report.geometry

    fingerprint = compile_fingerprint(conf, kind=kind)
    warm = geometry_seen(fingerprint)
    sites = _static_site_rows(conf)
    host_peak = geometry.get("host_peak_bytes")
    if host_peak is None:
        from spark_examples_tpu_torch.check.hostmem import conf_host_peak_bytes

        try:
            host_peak = conf_host_peak_bytes(conf, device_count=plan_devices)
        except Exception:
            host_peak = None
    sched_seconds = geometry.get("sched_critical_path_seconds")
    ring_bytes = geometry.get("ring_bytes_per_flush")
    model = estimate_seconds(
        sites=sites,
        host_peak_bytes=None if host_peak is None else int(host_peak),
        sched_seconds=(
            None if sched_seconds is None else float(sched_seconds)
        ),
        cold=not warm,
    )
    return CostPrediction(
        predicted_seconds=model["predicted_seconds"],
        kind=str(kind),
        fingerprint=fingerprint,
        compile=COMPILE_WARM if warm else COMPILE_COLD,
        compute_seconds=model["compute_seconds"],
        sched_seconds=(
            None if sched_seconds is None else float(sched_seconds)
        ),
        sites=sites,
        host_peak_bytes=None if host_peak is None else int(host_peak),
        ring_bytes_per_flush=(
            None if ring_bytes is None else int(ring_bytes)
        ),
    )


__all__ = [
    "ANALYSIS_SURFACES",
    "PlanIssue",
    "PlanReport",
    "parse_plan_args",
    "predict_job_cost",
    "validate_plan",
    "warm_ring_audit",
]
