"""Device-free collective-schedule proving (``graftcheck sched``).

The port of ``spark_examples_tpu/check/sched.py``. ``graftcheck ir`` proves
the ring's contracts (overlap, wire, bytes, shift count) and ``graftcheck
ranges`` its exactness — both blind to WHERE the bytes ride. Across hosts
that is the whole question: a fleet has two link classes (the intra-host
link, ``ici``, and the inter-host one, ``dcn``, slower and shared by a
host's devices), and each step of a ring is gated on the slowest edge of
its shift. This module is the schedule-level layer on top:

- **topology** — :class:`~spark_examples_tpu_torch.parallel.mesh.Topology`
  declares a fleet (``hosts x devices_per_host`` + per-link rates) that
  need not exist: like ``--plan-devices``, it is validated against, never
  queried.
- **schedule extraction** — the reference reads its schedule off the
  kernels' jaxprs; the port's is the recorded schedule (``obs/
  schedule.py``) of the runtime's own rings, recorded by ``check/ir.py``'s
  specs: ``ops/gramian.py:RingLayout.flush`` (``ring_pass``, flat or
  two-level) and ``ops/devicegen.py:DeviceGenRingGramianAccumulator``. A
  **step** is one shift call; its hops share the call.
- **link classes** — each hop notes its sender (``Op.source``) and its
  receiver (``Op.position``). Mapped host-major onto the topology (host =
  index within the samples axis // ``devices_per_host``, the axis read off
  the hop's ring, so a data axis does not shift it), a call is DCN when any
  of its hops crosses a host and ICI otherwise: a flat ring on one host is
  all ICI, a flat ring across hosts all DCN (``parallel/mesh.py:
  flat_traffic_split``), and the two-level ring's inner shifts ICI and its
  outer shifts DCN (the ``hosts`` axis: every hop crosses and keeps its
  place within the host) — the reference's attribution, read off where
  each hop goes rather than off the schedule's name.
- **per-level simulation** — per-level traffic (the mesh bytes are the
  sum of the hops' bytes), step counts (shift calls of one ring), per-
  position peak liveness (``check/ir.py:peak_live_bytes``) and the
  critical path (overlapped levels run concurrently; an overlap hole
  serializes them).

Rules (``check/rules.py:SCHED_RULES``): GS001 a flat ring SELECTED on a
multi-host topology (its DCN bytes exceed the hierarchical bound); GS002
simulated traffic diverging from the closed forms (``ring_traffic_bytes``
/ ``hierarchical_traffic_bytes``); GS003 a link step with no concurrent
compute (a hop issued after a product that reads the tile it sends, or
sending a buffer a product wrote, or a flush without products: the
per-call form of GI001); GS004 per-position peak liveness past
``DENSE_HBM_FRACTION`` of the default device memory; GS005 a predicted
critical path past a declared ``--sched-budget-seconds``.

Each subject's schedule is recorded alone (``watch=False``: no dispatch
watch, each kernel body once a launch layout), and the GI rules that
depend on the geometry run over the same trace — GI001, GI003, GI005 and
GI006. GI002 (the accumulator written in place) and GI004 (no float64)
read the dispatched operations, which do not change with the topology:
``graftcheck ir`` holds them over its matrix (the kept divergence of
ROADMAP.md §3). The default link rates are an H100 fleet's datasheet
figures (``parallel/mesh.py:DEFAULT_ICI_BYTES_PER_S``), not a TPU pod's.

Everything is device-free: the whole topology matrix — including the 32x8
fleet, 256 positions — is recorded in one process on CPU positions
(``meta`` ones in the plan) and no CUDA context is made (test-asserted).
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from spark_examples_tpu_torch.check.ir import (
    GEOMETRY_RULES,
    KernelSpec,
    Trace,
    audit_kernel,
    devicegen_hier_spec,
    devicegen_ring_spec,
    hier_kernel_spec,
    ring_kernel_spec,
    trace_kernel,
)
from spark_examples_tpu_torch.check.rules import Finding
from spark_examples_tpu_torch.obs.schedule import collector_paused
from spark_examples_tpu_torch.parallel.mesh import (
    HOST_AXIS,
    SAMPLES_AXIS,
    Topology,
    flat_traffic_split,
    hierarchical_traffic_bytes,
    resolve_reduce_schedule,
)

#: The shipped topology matrix: single-host shapes (where flat is the
#: right schedule), small multi-host shapes, and the 32 hosts x 8 devices
#: fleet the hierarchical reduction targets — proven on every build.
DEFAULT_TOPOLOGIES: Tuple[Tuple[int, int], ...] = (
    (1, 2),
    (1, 4),
    (2, 4),
    (4, 8),
    (32, 8),
)

@dataclass(frozen=True)
class ScheduleStep:
    """Shift calls of the recorded schedule that ride one link class over
    one axis with one per-device payload (the bytes of the call's largest
    hop: the edge that gates the step), how many of them one ring issues
    per flush, and whether each is issued free of the products around it."""

    level: str  # "ici" | "dcn"
    axis: str
    bytes_per_execution: int
    executions: int
    overlapped: bool


@dataclass
class CollectiveSchedule:
    """The communication schedule of one kernel x topology: the steps, the
    bytes the hops carry at each level (the whole mesh), and the geometry
    needed to scale and price them."""

    schedule: str  # "flat" | "hier"
    topology: Topology
    steps: List[ScheduleStep]
    rows_per_call: int
    n_local: int
    packed: bool
    total_devices: int
    hop_bytes: Dict[str, int] = field(default_factory=lambda: {"ici": 0, "dcn": 0})

    def per_device_bytes(self) -> Dict[str, int]:
        out = {"ici": 0, "dcn": 0}
        for step in self.steps:
            out[step.level] += step.bytes_per_execution * step.executions
        return out

    def mesh_bytes(self) -> Dict[str, int]:
        return dict(self.hop_bytes)

    def step_counts(self) -> Dict[str, int]:
        out = {"ici": 0, "dcn": 0}
        for step in self.steps:
            out[step.level] += step.executions
        return out

    def overlap_holes(self) -> List[ScheduleStep]:
        return [s for s in self.steps if not s.overlapped]

    def link_seconds(self, rows: Optional[int] = None) -> Dict[str, float]:
        """Per-link-class serialized transfer time for ``rows`` variant
        rows (default: one flush). The intra-host link is per device; the
        inter-host link is shared by the host's devices, so its level
        serializes the host's ``devices_per_host`` tile streams."""
        scale = (
            float(rows) / self.rows_per_call
            if rows is not None and self.rows_per_call
            else 1.0
        )
        per_device = self.per_device_bytes()
        topo = self.topology
        return {
            "ici": per_device["ici"] * scale / topo.ici_bytes_per_s,
            "dcn": (
                per_device["dcn"] * topo.devices_per_host * scale
                / topo.dcn_bytes_per_s
            ),
        }

    def critical_path_seconds(self, rows: Optional[int] = None) -> float:
        """Predicted schedule-limited time: with every step issued free of
        the products (GS003 clean), the two link classes also overlap each
        other (the outer hop hides behind a whole inner ring), so the
        critical path is the slower level; an overlap hole serializes the
        levels instead."""
        seconds = self.link_seconds(rows)
        if self.overlap_holes():
            return seconds["ici"] + seconds["dcn"]
        return max(seconds.values())


def _placement(hops, slots: Dict[int, int], per_host: int) -> Tuple[str, str]:
    """``(level, axis)`` of one shift call: DCN when a hop crosses a host
    (or its sender is not known), ICI otherwise; the ``hosts`` axis when
    every hop crosses and keeps its place within the host."""
    crossing = keeping = 0
    for hop in hops:
        if hop.source is None:
            return "dcn", SAMPLES_AXIS
        sent, received = slots[hop.source], slots[hop.position]
        if sent // per_host != received // per_host:
            crossing += 1
            keeping += sent % per_host == received % per_host
    if not crossing:
        return "ici", SAMPLES_AXIS
    if per_host > 1 and crossing == keeping == len(hops):
        return "dcn", HOST_AXIS
    return "dcn", SAMPLES_AXIS


def extract_schedule(
    traced: Trace,
    spec: KernelSpec,
    topology: Topology,
    schedule: str,
) -> CollectiveSchedule:
    """Read the communication schedule off one recorded flush: each shift
    call placed on its link class by where its hops go (``Op.source`` to
    ``Op.position``, host-major on ``topology``), overlapped when no hop
    of it is serialized behind a product (``check/ir.py:serialized_hops``)
    and the flush has products."""
    late, written = traced.serialized_hops()
    computes = any(op.role == "product" for op in traced.ops)
    calls: Dict[int, list] = {}
    for op in traced.ops:
        if op.role == "shift":
            calls.setdefault(op.call, []).append(op)
    per_host = topology.devices_per_host
    slots_of: Dict[Tuple[int, ...], Dict[int, int]] = {}
    keys: Dict[Tuple[str, str, int, bool], None] = {}  # in the order first issued
    per_ring: Counter = Counter()
    hop_bytes = {"ici": 0, "dcn": 0}
    for hops in calls.values():
        ring = hops[0].ring
        slots = slots_of.get(ring)
        if slots is None:
            slots = slots_of[ring] = {index: slot for slot, index in enumerate(ring)}
        level, axis = _placement(hops, slots, per_host)
        sizes = [hop.results[0].nbytes for hop in hops]
        hop_bytes[level] += sum(sizes)
        overlapped = computes and not any(
            hop.index in late or hop.index in written for hop in hops)
        key = (level, axis, max(sizes), overlapped)
        keys.setdefault(key)
        per_ring[ring, key] += 1
    steps = []
    for key in keys:
        executions = max(n for (_, issued), n in per_ring.items() if issued == key)
        level, axis, nbytes, overlapped = key
        steps.append(ScheduleStep(level, axis, nbytes, executions, overlapped))
    return CollectiveSchedule(
        schedule=schedule,
        topology=topology,
        steps=steps,
        rows_per_call=spec.rows_per_call,
        n_local=spec.n_local,
        packed=spec.packed,
        total_devices=max(1, len(slots_of)) * spec.samples_axis,
        hop_bytes=hop_bytes,
    )


@dataclass
class ScheduleAudit:
    """One schedule x topology audit: findings + machine-readable facts."""

    name: str
    findings: List[Finding] = field(default_factory=list)
    facts: Dict[str, object] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> Dict[str, object]:
        return {
            "subject": self.name,
            "ok": self.ok,
            "facts": self.facts,
            "findings": [f.to_json() for f in self.findings],
        }


def _emit(audit: ScheduleAudit, rule_id: str, detail: str) -> None:
    audit.findings.append(Finding(rule_id, audit.name, 0, 0, detail))


def schedule_kernel_spec(
    topology: Topology,
    schedule: str,
    num_samples: int,
    block_size: int,
    data: int = 1,
    pack: bool = True,
    kernel: str = "gramian",
    blocks_per_dispatch: int = 2,
    device: str = "cpu",
) -> KernelSpec:
    """The ``check/ir.py`` spec for one schedule on one topology — the flat
    ring over ``data x S`` positions, or the two-level ring over the
    host-major ``data x hosts·devices_per_host`` factorization. ``kernel``
    selects the subject: the host-fed Gramian ring (``ops/gramian.py``,
    on ``device`` positions: ``cpu``, or ``meta`` at a plan's geometry) or
    the fused device-generation ring (``ops/devicegen.py``,
    ``blocks_per_dispatch`` ring passes per call, on CPU positions)."""
    if kernel == "devicegen":
        if schedule == "hier":
            return devicegen_hier_spec(
                data, topology.hosts, topology.devices_per_host, num_samples,
                block_size, blocks_per_dispatch, pack,
            )
        return devicegen_ring_spec(
            data, topology.devices, num_samples, block_size, blocks_per_dispatch, pack,
        )
    if kernel != "gramian":
        raise ValueError(
            f"kernel must be 'gramian' or 'devicegen', got {kernel!r}"
        )
    if schedule == "hier":
        return hier_kernel_spec(
            data, topology.hosts, topology.devices_per_host, num_samples, block_size,
            pack, device=device,
        )
    return ring_kernel_spec(
        data, topology.devices, num_samples, block_size, pack, device=device,
    )


def audit_schedule(
    topology: Topology,
    schedule: str,
    num_samples: int = 64,
    block_size: int = 8,
    data: int = 1,
    pack: bool = True,
    rows: Optional[int] = None,
    budget_seconds: Optional[float] = None,
    selected: bool = True,
    traced: Optional[Trace] = None,
    hbm_budget_bytes: Optional[int] = None,
    kernel: str = "gramian",
    device: str = "cpu",
) -> ScheduleAudit:
    """Record (or reuse ``traced``), IR-audit, extract, and simulate one
    schedule on one topology; enforce the GS rules.

    ``selected`` marks the schedule the run would actually build (the
    ``--reduce-schedule``/auto resolution): GS001 is a SELECTION rule —
    a flat ring is a fine reference subject on any topology, but choosing
    it for a multi-host run puts the whole circulation on the slow link.
    ``rows`` scales the critical-path prediction (default: one flush);
    ``budget_seconds`` arms GS005."""
    from spark_examples_tpu_torch.ops.gramian import (
        _DEFAULT_DEVICE_BYTES,
        DENSE_HBM_FRACTION,
    )

    spec = schedule_kernel_spec(
        topology, schedule, num_samples, block_size, data, pack, kernel=kernel,
        device=device,
    )
    audit = ScheduleAudit(
        f"sched[{topology.describe()},{schedule},{spec.name}]"
    )
    audit.facts["topology"] = topology.describe()
    audit.facts["schedule"] = schedule
    audit.facts["kernel"] = kernel
    audit.facts["selected"] = bool(selected)
    with collector_paused():
        if traced is None:
            try:
                traced = trace_kernel(spec, watch=False)
            except Exception as e:  # noqa: BLE001 — the failure to run is the finding
                _emit(
                    audit,
                    "GS002",
                    f"kernel failed to trace on topology "
                    f"{topology.describe()}: {type(e).__name__}: {e} — no "
                    "schedule can be extracted, so no traffic/overlap claim "
                    "holds",
                )
                return audit
        # The geometry's IR contracts over the same trace (overlap, wire,
        # GI005/GI006 traffic and shift counts) hold under BOTH schedules:
        # any of their findings is a sched finding too.
        ir_audit = audit_kernel(spec, traced=traced, geometry_only=True)
        sched = extract_schedule(traced, spec, topology, schedule)
    audit.findings.extend(f for f in ir_audit.findings if f.rule_id in GEOMETRY_RULES)
    peak_live = int(ir_audit.facts.get("peak_live_bytes", 0))
    audit.facts["peak_live_bytes_per_device"] = peak_live

    mesh_bytes = sched.mesh_bytes()
    counts = sched.step_counts()
    audit.facts["ici_bytes"] = mesh_bytes["ici"]
    audit.facts["dcn_bytes"] = mesh_bytes["dcn"]
    audit.facts["ici_steps"] = counts["ici"]
    audit.facts["dcn_steps"] = counts["dcn"]
    audit.facts["rows_per_call"] = sched.rows_per_call

    # ---- GS002: simulated schedule vs the closed-form formulas --------
    if schedule == "hier":
        formula = hierarchical_traffic_bytes(
            sched.rows_per_call,
            topology.hosts,
            topology.devices_per_host,
            spec.n_local,
            spec.packed,
        )
        expect = {"ici": formula.ici_bytes, "dcn": formula.dcn_bytes}
    else:
        split = flat_traffic_split(
            sched.rows_per_call, topology, spec.n_local, spec.packed
        )
        expect = {"ici": split.ici_bytes, "dcn": split.dcn_bytes}
    audit.facts["formula_ici_bytes"] = expect["ici"]
    audit.facts["formula_dcn_bytes"] = expect["dcn"]
    for level in ("ici", "dcn"):
        if mesh_bytes[level] != expect[level]:
            _emit(
                audit,
                "GS002",
                f"simulated {level.upper()} traffic is "
                f"{mesh_bytes[level]} bytes/call but the audited formula "
                f"({'hierarchical_traffic_bytes' if schedule == 'hier' else 'ring_traffic_bytes'}) "
                f"says {expect[level]} — the schedule the kernel executes "
                "no longer matches the one telemetry and the plan "
                "validator describe",
            )

    # ---- GS003: overlap holes -----------------------------------------
    for hole in sched.overlap_holes():
        _emit(
            audit,
            "GS003",
            f"a {hole.level.upper()} step over axis {hole.axis!r} "
            f"({hole.bytes_per_execution} B x {hole.executions} "
            "execution(s)) has no concurrent compute proven "
            "dependency-free of it — the link time adds to the critical "
            "path instead of hiding behind the tensor cores",
        )

    # ---- GS004: per-device liveness -----------------------------------
    hbm_budget = (
        hbm_budget_bytes
        if hbm_budget_bytes is not None
        else int(DENSE_HBM_FRACTION * _DEFAULT_DEVICE_BYTES)
    )
    audit.facts["hbm_budget_bytes"] = hbm_budget
    if peak_live > hbm_budget:
        _emit(
            audit,
            "GS004",
            f"static per-device peak liveness {peak_live} B exceeds the "
            f"HBM budget {hbm_budget} B "
            f"({DENSE_HBM_FRACTION:.0%} of the default device memory) — "
            "the schedule cannot run at this geometry; widen the samples "
            "axis or shrink the block",
        )

    # ---- GS001: flat ring selected on a multi-host topology -----------
    if selected and schedule == "flat" and topology.hosts > 1:
        hier_bound = hierarchical_traffic_bytes(
            sched.rows_per_call,
            topology.hosts,
            topology.devices_per_host,
            spec.n_local,
            spec.packed,
        ).dcn_bytes
        audit.facts["hier_dcn_bound_bytes"] = hier_bound
        if mesh_bytes["dcn"] > hier_bound:
            _emit(
                audit,
                "GS001",
                f"the flat ring on {topology.describe()} puts "
                f"{mesh_bytes['dcn']} bytes/call on the inter-host link "
                f"(every step has a hop across hosts), "
                f"{mesh_bytes['dcn'] / max(1, hier_bound):.1f}x the "
                f"hierarchical schedule's proven {hier_bound} B DCN bound "
                "— use --reduce-schedule hier (or auto) for multi-host "
                "topologies",
            )

    # ---- GS005: declared critical-path budget -------------------------
    sim_rows = rows if rows is not None else sched.rows_per_call
    seconds = sched.link_seconds(sim_rows)
    critical = sched.critical_path_seconds(sim_rows)
    audit.facts["sim_rows"] = int(sim_rows)
    audit.facts["ici_seconds"] = seconds["ici"]
    audit.facts["dcn_seconds"] = seconds["dcn"]
    audit.facts["critical_path_seconds"] = critical
    if budget_seconds is not None and critical > budget_seconds:
        _emit(
            audit,
            "GS005",
            f"predicted schedule-limited critical path "
            f"{critical:.3f} s for {sim_rows} rows on "
            f"{topology.describe()} (ICI {seconds['ici']:.3f} s, DCN "
            f"{seconds['dcn']:.3f} s) exceeds the declared "
            f"--sched-budget-seconds {budget_seconds:g} — the schedule "
            "cannot be proven to fit the budget on this topology",
        )
    return audit


@dataclass
class SchedReport:
    """Every schedule audit of one ``graftcheck sched`` run, grouped per
    topology, with the flat-vs-hier DCN comparison the hierarchical
    schedule exists for."""

    audits: List[ScheduleAudit] = field(default_factory=list)
    comparisons: List[Dict[str, object]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(a.ok for a in self.audits)

    @property
    def findings(self) -> List[Finding]:
        return [f for a in self.audits for f in a.findings]

    def to_json(self) -> str:
        return json.dumps(
            {
                "tool": "graftcheck-sched",
                "ok": self.ok,
                "subject_count": len(self.audits),
                "finding_count": len(self.findings),
                "subjects": [a.to_json() for a in self.audits],
                "comparisons": self.comparisons,
            },
            indent=2,
        )

    def format(self) -> str:
        lines = []
        for a in self.audits:
            if a.ok:
                bits = [
                    f"ici {a.facts.get('ici_bytes', 0)} B/"
                    f"{a.facts.get('ici_steps', 0)} steps",
                    f"dcn {a.facts.get('dcn_bytes', 0)} B/"
                    f"{a.facts.get('dcn_steps', 0)} steps",
                    "== formula",
                    f"critical path {a.facts.get('critical_path_seconds', 0):.2e} s",
                    f"peak live {a.facts.get('peak_live_bytes_per_device', 0)} B",
                ]
                if a.facts.get("selected"):
                    bits.append("selected")
                lines.append(f"  proved: {a.name}: " + ", ".join(bits))
            else:
                for f in a.findings:
                    lines.append(f"  {f.format()}")
        for comp in self.comparisons:
            lines.append(
                f"  compared: {comp['topology']} "
                f"{comp.get('kernel', 'gramian')}: hier DCN "
                f"{comp['hier_dcn_bytes']} B < flat DCN "
                f"{comp['flat_dcn_bytes']} B "
                f"({comp['dcn_reduction']:.1f}x less on the slow link)"
            )
        verdict = "clean" if self.ok else f"{len(self.findings)} finding(s)"
        lines.append(
            f"graftcheck sched: {len(self.audits)} schedule(s), {verdict}"
        )
        return "\n".join(lines)


def run_audit(
    topologies: Optional[Sequence[Tuple[int, int]]] = None,
    num_samples: int = 64,
    block_size: int = 8,
    reduce_schedule: str = "auto",
    budget_seconds: Optional[float] = None,
) -> SchedReport:
    """Prove the schedule matrix: for every topology and BOTH ring kernels
    (the host-fed Gramian ring and the fused device-generation ring), audit
    the schedule the ``--reduce-schedule`` resolution would build (GS001
    armed) AND, on multi-host topologies, the flat ring as the reference
    subject (facts + GS002/GS003 — its contracts must hold even where it is
    the wrong choice), then record the flat-vs-hier DCN comparison. CPU
    positions only: no CUDA context is made (test-asserted)."""
    jobs = []
    pairs = tuple(topologies) if topologies is not None else DEFAULT_TOPOLOGIES
    for hosts, per_host in pairs:
        topo = Topology(hosts, per_host)
        if topo.devices < 2:
            continue
        chosen = resolve_reduce_schedule(reduce_schedule, topo.hosts)
        for kernel in ("gramian", "devicegen"):
            jobs.append((topo, chosen, kernel, True, budget_seconds))
            if topo.hosts > 1 and chosen == "hier":
                jobs.append((topo, "flat", kernel, False, None))
    report = SchedReport([
        audit_schedule(topo, schedule, num_samples=num_samples, block_size=block_size,
                       budget_seconds=budget, selected=selected, kernel=kernel)
        for topo, schedule, kernel, selected, budget in jobs
    ])
    for index, (topo, schedule, kernel, selected, _) in enumerate(jobs):
        if selected:
            continue
        # The flat reference subject follows the chosen hierarchical one.
        flat_dcn = int(report.audits[index].facts.get("dcn_bytes", 0))
        hier_dcn = int(report.audits[index - 1].facts.get("dcn_bytes", 0))
        report.comparisons.append(
            {
                "topology": topo.describe(),
                "kernel": kernel,
                "flat_dcn_bytes": flat_dcn,
                "hier_dcn_bytes": hier_dcn,
                "dcn_reduction": (
                    flat_dcn / hier_dcn if hier_dcn else float("inf")
                ),
                "hier_strictly_below": hier_dcn < flat_dcn,
            }
        )
    return report


__all__ = [
    "DEFAULT_TOPOLOGIES",
    "CollectiveSchedule",
    "ScheduleAudit",
    "ScheduleStep",
    "SchedReport",
    "audit_schedule",
    "extract_schedule",
    "run_audit",
    "schedule_kernel_spec",
]
