"""Recorded-schedule kernel auditing (``graftcheck ir``).

The port of ``spark_examples_tpu/check/ir.py``. The reference traces each
Gramian update to a jaxpr and walks its equations; the port has no jaxpr.
Its device program is eager Python that launches hand-written kernels and
moves tiles between positions on streams, so what the card executes is the
sequence of those calls — the **recorded schedule** (``obs/schedule.py``):
each kernel wrapper, ring shift and stream wait notes one op (name, role,
the dtype, shape and storage of each operand and result, the position),
and a ``TorchDispatchMode`` watches every PyTorch operation of the same run
(the host program's own, and the plain versions' inside a wrapper on the
CPU). The update runs on small CPU positions, or on ``meta`` tensors at a
run's full geometry (``graftcheck plan``); no audit touches CUDA. The
audited constructors are the runtime's own, never re-implementations:
``ops/gramian.py:dense_update``/``dense_update_counts``,
``ops/batched.py:StackedJobsAccumulator`` (its ``_drain``),
``ops/gramian.py:RingLayout.flush`` (the flush ``ShardedGramianAccumulator``
runs: ``ring_pass``, flat or two-level) and ``ops/devicegen.py:
DeviceGenRingGramianAccumulator`` (its ``_blocks``).

The reference's contracts, read over the schedule:

- **overlap** (GI001): each ring step's next shift is issued before the
  products that read the tile it sends (through its unpack), and no shift
  sends a buffer a product wrote — on the card the transfer stream then
  runs under the product (``ring_pass``).
- **accumulator contract** (GI002): the port updates accumulators in
  place — every product writes the accumulator's own storage and no
  accumulator-sized copy is made outside a kernel — where the reference
  justified non-donation with GC005 disables. ``accumulator_donated`` means
  "in place" here; it is cross-checked against the port's own
  ``# graftcheck: disable=GC005`` comments (:func:`gc005_justified_functions`):
  an out-of-place update needs one, and one on an in-place update is drift.
- **packed wire** (GI003): a bit-packed uint8 tile keeps its dtype and
  width through every shift (``n_local / 8`` bytes on a ring) and nothing
  but the designated unpack (``unpack_rows_t``, ``stacked_unpack_rows_t``)
  reads it; moving and viewing it is allowed.
- **dtypes** (GI004): no float64 tensor in any recorded or dispatched op.
- **traffic** (GI005): the bytes the recorded shifts move, summed over the
  receiving positions this process drives, equal
  ``parallel/mesh.py:ring_traffic_bytes`` — what ``gramian_ring_bytes``
  counts. Where GI006 already found the shift count wrong, the bytes of
  each shift are held against the formula's share instead, so each rule
  names one defect.
- **shift count** (GI006): a ring pass makes exactly ``S - 1`` shifts;
  ``(H - 1) + H·(D - 1) = S - 1`` on the two-level ring.

Facts keep the reference's keys: ``permute_executions`` (shift calls of a
ring), ``ring_bytes_jaxpr`` (the recorded schedule's bytes), ``peak_live_
bytes`` (a sweep over storage lifetimes in the schedule: kernels are opaque
ops, as they are on the card). The port's accumulators are int32 where the
reference's CPU audit reports float32 (``out_dtypes``), the kept divergence
of ROADMAP.md §3.
"""

from __future__ import annotations

import ast
import functools
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import (
    Callable,
    Dict,
    Iterator,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Set,
    Tuple,
)

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from spark_examples_tpu_torch.check.rules import Finding, parse_disables
from spark_examples_tpu_torch.obs import schedule as _schedule
from spark_examples_tpu_torch.obs.schedule import Op, Schedule, storage_key

#: Seed of the audit's operand bits (the verdicts depend on shapes alone).
SEED = 0x1C0DE

#: Operations that move or view a packed wire tile's bytes without reading
#: them as values: their uint8 results stay the wire (GI003).
_WIRE_MOVES = {
    "_pin_memory", "_to_copy", "_unsafe_view", "alias", "as_strided", "cat",
    "chunk", "clone", "contiguous", "copy_", "detach", "expand", "lift_fresh",
    "narrow", "permute", "reshape", "select", "slice", "split", "squeeze",
    "stack", "t", "transpose", "unbind", "unsqueeze", "view",
}
#: Operations that read a tensor's shape and dtype only.
_METADATA_ONLY = {"empty_like", "new_empty", "new_zeros", "ones_like", "zeros_like"}


# --------------------------------------------------------------------------
# The recording: the schedule, and every dispatched operation beside it.
# --------------------------------------------------------------------------


class Stored(NamedTuple):
    """A tensor operand or result of a dispatched operation."""

    storage: int
    storage_nbytes: int
    dtype: str
    shape: Tuple[int, ...]


@dataclass(frozen=True)
class Event:
    """One PyTorch operation dispatched while an update was recorded."""

    index: int
    name: str  #: the operation's name without its overload (``add_``)
    inside: bool  #: inside a kernel wrapper's own body
    position: Optional[int]
    reads: Tuple[Stored, ...]
    results: Tuple[Stored, ...]


def _stored(tensor: torch.Tensor) -> Optional[Stored]:
    try:
        key, size = storage_key(tensor)
    except (RuntimeError, NotImplementedError):  # a tensor without a storage
        return None
    return Stored(key, size, str(tensor.dtype).replace("torch.", ""), tuple(tensor.shape))


class _Watch(TorchDispatchMode):
    """Notes every dispatched operation of a recorded update as an
    :class:`Event`, holding the tensors of those outside a kernel so no
    storage identity is reused while the update runs."""

    def __init__(self, schedule: Schedule):
        super().__init__()
        self.schedule = schedule
        self.events: List[Event] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        schedule = self.schedule
        inside = schedule.inside > 0
        if not inside:
            schedule.hold(ins + outs)
        self.events.append(Event(
            len(self.events), func.overloadpacket.__name__, inside, schedule.position,
            tuple(s for s in map(_stored, ins) if s is not None),
            tuple(s for s in map(_stored, outs) if s is not None),
        ))
        schedule.events = len(self.events)
        return out


class Update(NamedTuple):
    """What a spec's ``build`` returns: the update to record, the
    accumulators it must write in place, the bit-packed operands it is
    handed (the wire's seeds besides what the schedule names), and the
    ``(shape, dtype)`` of each of its logical outputs, read after the run
    (default: the accumulators')."""

    run: Callable[[], object]
    accumulators: Sequence[torch.Tensor]
    packed: Sequence[torch.Tensor] = ()
    outputs: Optional[Callable[[], List[Tuple[Tuple[int, ...], torch.dtype]]]] = None


@dataclass
class Trace:
    """One recorded update: its schedule and its dispatched operations."""

    ops: List[Op]
    events: List[Event]
    accumulators: Set[int]
    accumulator_shapes: Set[Tuple[Tuple[int, ...], str]]
    packed: Set[int]
    outputs: List[Tuple[Tuple[int, ...], str]]
    _serialized: Optional[Tuple[Set[int], Set[int]]] = field(default=None, repr=False)

    def steps(self) -> Iterator[object]:
        """The host program in issue order: each recorded :class:`Op` (a
        kernel is one opaque step, as on the card) and each :class:`Event`
        dispatched outside a kernel."""
        if not self.events:
            yield from self.ops
            return
        ops = iter(self.ops)
        pending = next(ops, None)
        for event in self.events:
            while pending is not None and pending.events_before <= event.index:
                yield pending
                pending = next(ops, None)
            if not event.inside:
                yield event
        while pending is not None:
            yield pending
            pending = next(ops, None)

    def serialized_hops(self) -> Tuple[Set[int], Set[int]]:
        """:func:`serialized_hops` of the ops, computed once (the ring
        audit and the schedule prover both read it)."""
        if self._serialized is None:
            self._serialized = serialized_hops(self.ops)
        return self._serialized


def record_update(update: Update, watch: bool = True) -> Trace:
    """Run ``update`` under the schedule recorder and (``watch``) the
    dispatch watch. Without it the trace has no events and the schedule
    is recorded alone (``obs/schedule.py:recording(shapes_only=True)``:
    each kernel body on CPU or ``meta`` positions runs once a launch
    layout; the ops noted are a full recording's)."""
    with _schedule.recording(shapes_only=not watch) as schedule:
        if watch:
            with _Watch(schedule) as watching:
                update.run()
            events = list(watching.events)
        else:
            update.run()
            events = []
    outputs = (update.outputs() if update.outputs is not None
               else [(tuple(t.shape), t.dtype) for t in update.accumulators])
    return Trace(
        ops=list(schedule.ops),
        events=events,
        accumulators={storage_key(t)[0] for t in update.accumulators},
        accumulator_shapes={(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                            for t in update.accumulators},
        packed={storage_key(t)[0] for t in update.packed},
        outputs=[(tuple(int(s) for s in shape), str(dtype).replace("torch.", ""))
                 for shape, dtype in outputs],
    )


# --------------------------------------------------------------------------
# Static liveness (peak live bytes from storage lifetimes).
# --------------------------------------------------------------------------


def peak_live_bytes(trace: Trace, per_position: bool = False) -> int:
    """Peak of simultaneously live storage bytes over the update's host
    program (:meth:`Trace.steps`). A storage is live from the step that
    makes it (from the start, for one the update was handed) to its last
    use; the accumulators to the end. ``per_position`` takes the peak of
    each position's storages (a storage belongs to the position of the
    first step at a position that touches it) and returns the largest. Deterministic
    arithmetic over shapes, comparable across kernels and runs."""
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    size: Dict[int, int] = {}
    where: Dict[int, Optional[int]] = {}
    unplaced: Set[int] = set()  # storages touched so far at no position
    steps = 0
    for t, step in enumerate(trace.steps()):
        steps = t + 1
        position = step.position
        # An op's in-place writes count as reads.
        reads = step.reads + step.writes if isinstance(step, Op) else step.reads
        for born, stored in ((-1, reads), (t, step.results)):
            for x in stored:
                key = x.storage
                last[key] = t
                if key not in size:
                    size[key] = x.storage_nbytes
                    first[key] = born
                    where[key] = position
                    if position is None:
                        unplaced.add(key)
                elif position is not None and key in unplaced:
                    where[key] = position
                    unplaced.discard(key)
    for key in trace.accumulators:
        if key in last:
            last[key] = steps
    groups: Dict[Optional[int], List[int]] = defaultdict(list)
    for key in size:
        groups[where[key] if per_position else None].append(key)
    peak = 0
    for position, keys in groups.items():
        if per_position and position is None:
            continue
        delta: Dict[int, int] = defaultdict(int)
        for key in keys:
            delta[first[key]] += size[key]
            delta[last[key] + 1] -= size[key]
        live = 0
        for t in sorted(delta):
            live += delta[t]
            if live > peak:
                peak = live
    return peak


# --------------------------------------------------------------------------
# AST cross-check: which functions carry a justified GC005 disable.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def gc005_justified_functions(module_file: str) -> Set[str]:
    """Names of functions in ``module_file`` whose span contains a
    ``# graftcheck: disable=GC005`` escape hatch — the AST layer's
    justified out-of-place updates, which GI002 holds the recorded
    schedule against. A whole-file disable returns ``{"*"}``."""
    with open(module_file, "r", encoding="utf-8") as f:
        source = f.read()
    per_line, whole_file = parse_disables(source)
    if "GC005" in whole_file or "all" in whole_file:
        return {"*"}
    lines = {ln for ln, ids in per_line.items() if "GC005" in ids or "all" in ids}
    if not lines:
        return set()
    spans: List[Tuple[int, int, str]] = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            start = min([node.lineno] + [d.lineno for d in node.decorator_list])
            spans.append((start, node.end_lineno or node.lineno, node.name))
    out: Set[str] = set()
    for ln in lines:
        containing = [s for s in spans if s[0] <= ln <= s[1]]
        if containing:
            containing.sort(key=lambda s: s[1] - s[0])  # innermost
            out.add(containing[0][2])
    return out


# --------------------------------------------------------------------------
# Kernel specs and the audit itself.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DonationSite:
    """Where the GC005 justification of an out-of-place update must live."""

    module_file: str
    function: str
    relpath: str


@dataclass
class KernelSpec:
    """One update × geometry to record and audit.

    ``build`` returns an :class:`Update` (it runs before the recording,
    so making operands is not part of the schedule). The ring expectations
    (``samples_axis``, ``ring_passes``, ``rows_per_call``, ``n_local``) are
    the audit's ground truth, from the geometry helpers the runtime uses
    (``parallel/mesh.py:padded_cohort``)."""

    name: str
    build: Callable[[], Update]
    samples_axis: int = 1
    packed: bool = False
    ring: bool = False
    ring_passes: int = 1
    rows_per_call: int = 0
    n_local: int = 0
    donation: Optional[DonationSite] = None
    liveness_scope: str = "global"


@dataclass
class KernelAudit:
    """The audit result for one kernel: findings + machine-readable facts."""

    name: str
    findings: List[Finding] = field(default_factory=list)
    facts: Dict[str, object] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> Dict[str, object]:
        return {
            "kernel": self.name,
            "ok": self.ok,
            "facts": self.facts,
            "findings": [f.to_json() for f in self.findings],
        }


def _emit(audit: KernelAudit, rule_id: str, detail: str) -> None:
    audit.findings.append(Finding(rule_id, audit.name, 0, 0, detail))


def _audit_donation(spec: KernelSpec, trace: Trace, audit: KernelAudit) -> None:
    if spec.donation is None:
        return
    products = [op for op in trace.ops if op.role == "product"]
    stray = [op for op in products
             if not all(w.storage in trace.accumulators for w in op.writes)]
    shapes = set(trace.accumulator_shapes) | {
        (w.shape, w.dtype) for op in products for w in op.writes
        if w.storage in trace.accumulators
    }
    copies = sorted({
        event.name for event in trace.events if not event.inside
        for s in event.results
        if s.storage not in trace.accumulators and (s.shape, s.dtype) in shapes
    })
    in_place = bool(products) and not stray and not copies
    audit.facts["accumulator_donated"] = in_place
    names = gc005_justified_functions(spec.donation.module_file)
    justified = "*" in names or spec.donation.function in names
    audit.facts["gc005_disable_present"] = justified
    where = f"{spec.donation.relpath}:{spec.donation.function}"
    if not in_place and not justified:
        reasons = []
        if not products:
            reasons.append("no product writes an accumulator")
        if stray:
            reasons.append(f"{len(stray)} product(s) write another buffer")
        if copies:
            reasons.append("accumulator-sized copies by " + ", ".join(copies))
        _emit(
            audit,
            "GI002",
            f"the accumulator update is NOT in place ({'; '.join(reasons)}) and {where} "
            "carries no justified `# graftcheck: disable=GC005` — write the "
            "accumulator in place or document the measured reason at the AST layer",
        )
    elif in_place and justified:
        _emit(
            audit,
            "GI002",
            f"stale justification: {where} carries a GC005 out-of-place disable but "
            "the recorded update writes its accumulator in place — the AST and "
            "schedule layers have drifted; drop the disable",
        )


def _roots(ops: Sequence[Op]) -> Dict[int, int]:
    """Each unpack result's storage → the storage of the tile it unpacked
    (transitively), so a product reading an unpacked tile reads its tile."""
    root: Dict[int, int] = {}
    for op in ops:
        if op.role == "unpack" and op.reads:
            source = op.reads[0].storage
            for result in op.results:
                root[result.storage] = root.get(source, source)
    return root


def serialized_hops(ops: Sequence[Op]) -> Tuple[Set[int], Set[int]]:
    """The shift hops (their op indices) issued after a product that reads
    the tile they send, and those that send a buffer an earlier product
    wrote: one pass in issue order, keeping the roots every product so far
    read and the storages it wrote."""
    root = _roots(ops)
    read: Set[int] = set()
    wrote: Set[int] = set()
    late: Set[int] = set()
    written: Set[int] = set()
    for op in ops:
        if op.role == "product":
            for t in op.reads:
                read.add(root.get(t.storage, t.storage))
            for t in op.writes:
                wrote.add(t.storage)
        elif op.role == "shift" and op.reads:
            sent = op.reads[0].storage
            if root.get(sent, sent) in read:
                late.add(op.index)
            if sent in wrote:
                written.add(op.index)
    return late, written


def overlap_findings(ops: Sequence[Op],
                     hops: Optional[Tuple[Set[int], Set[int]]] = None) -> List[str]:
    """The GI001 messages of a schedule: shifts issued after a product that
    reads the tile they send, and shifts that send a buffer an earlier
    product wrote (each kind once, with its count; ``hops``: the ops'
    :func:`serialized_hops`, where the caller has them)."""
    late, written = map(len, serialized_hops(ops) if hops is None else hops)
    messages = []
    if late:
        messages.append(
            f"{late} shift hop(s) issued after a product that reads the tile they send — "
            "the transfer waits for the product every step (serialized ring: each "
            "shift must move the NEXT step's tile before this step's products)"
        )
    if written:
        messages.append(
            f"{written} shift hop(s) send a buffer an earlier product wrote — the "
            "transfer stream waits for the tensor cores every step (no overlap)"
        )
    return messages


def _audit_ring(spec: KernelSpec, trace: Trace, packed: Set[int], audit: KernelAudit) -> None:
    from spark_examples_tpu_torch.parallel.mesh import RING_PACK_MULTIPLE, ring_traffic_bytes

    shifts = [op for op in trace.ops if op.role == "shift"]
    calls: Dict[Tuple[int, ...], Set[int]] = defaultdict(set)
    for op in shifts:
        calls[op.ring].add(op.call)
    counts = [len(c) for c in calls.values()]
    executions = max(counts, default=0)
    expected = spec.ring_passes * (spec.samples_axis - 1)
    audit.facts["permute_executions"] = executions
    audit.facts["permute_executions_expected"] = expected
    count_ok = bool(counts) and all(n == expected for n in counts)
    if not count_ok:
        _emit(
            audit,
            "GI006",
            f"{executions} shift(s) per call on a ring; the double-buffered ring "
            f"contract is ring_passes x (samples-1) = {spec.ring_passes} x "
            f"{spec.samples_axis - 1} = {expected}",
        )

    recorded = sum(op.results[0].nbytes for op in shifts)
    formula = ring_traffic_bytes(spec.rows_per_call, spec.samples_axis, spec.n_local, spec.packed)
    audit.facts["ring_bytes_jaxpr"] = recorded
    audit.facts["ring_bytes_formula"] = formula
    if count_ok:
        mismatch = recorded != formula
    else:  # GI006 owns the count: hold each shift's bytes against its share
        mismatch = recorded * expected * max(1, len(calls)) != formula * sum(counts)
    if mismatch:
        _emit(
            audit,
            "GI005",
            f"the recorded ring moves {recorded} bytes/call but "
            f"parallel/mesh.py:ring_traffic_bytes says {formula} — the "
            "gramian_ring_bytes counter and the plan no longer describe this ring",
        )

    if spec.packed:
        width = spec.n_local // RING_PACK_MULTIPLE
        wide = sorted({op.reads[0].shape[-1] for op in shifts
                       if op.reads and op.reads[0].storage in packed
                       and op.reads[0].shape and op.reads[0].shape[-1] != width})
        for got in wide:
            _emit(
                audit,
                "GI003",
                f"a packed ring tile's trailing dim is {got} bytes; the pack-width "
                f"invariant says n_local/{RING_PACK_MULTIPLE} = {width}",
            )

    serialized = overlap_findings(trace.ops, trace.serialized_hops())
    for message in serialized:
        _emit(audit, "GI001", message)
    audit.facts["ring_overlap_independent"] = bool(shifts) and not serialized


def _packed_storages(trace: Trace) -> Set[int]:
    """The wire's storages: the bit-packed operands, each bit-unpack's
    input and each pack's result, closed over shifts (both ends) and over
    moves and views (:data:`_WIRE_MOVES`) outside a kernel."""
    packed = set(trace.packed)
    for op in trace.ops:
        if op.role == "unpack" and op.packed and op.reads:
            packed.add(op.reads[0].storage)
        if op.role == "pack" and op.packed:
            packed.update(t.storage for t in op.results)
    shifts = [(op.reads[0].storage, op.results[0].storage)
              for op in trace.ops if op.role == "shift" and op.reads]
    moves = [e for e in trace.events if not e.inside and e.name in _WIRE_MOVES]
    changed = True
    while changed:
        changed = False
        for sent, received in shifts:
            if (sent in packed) != (received in packed):
                packed.update((sent, received))
                changed = True
        for event in moves:
            if any(s.storage in packed for s in event.reads):
                new = {s.storage for s in event.results if s.dtype == "uint8"} - packed
                if new:
                    packed |= new
                    changed = True
    return packed


def _audit_dtypes(trace: Trace, packed: Set[int], audit: KernelAudit, f64: bool = True) -> None:
    """GI003 over the packed wire and (``f64``) GI004."""
    if f64:
        wide = {e.name for e in trace.events for s in e.results if s.dtype == "float64"}
        for op in trace.ops:
            for tiles in (op.reads, op.writes, op.results):
                for t in tiles:
                    if t.dtype == "float64":
                        wide.add(op.name)
        audit.facts["f64_free"] = not wide
        if wide:
            _emit(audit, "GI004", "float64 values produced by: " + ", ".join(sorted(wide)))

    violations: Set[str] = set()
    for op in trace.ops:
        reads = [t for t in op.reads if t.storage in packed]
        if not reads:
            continue
        if op.role == "shift":
            sent, received = op.reads[0], op.results[0]
            if received.dtype != "uint8" or received.shape != sent.shape:
                violations.add(f"a shift turns a packed {sent.dtype} {list(sent.shape)} tile "
                               f"into {received.dtype} {list(received.shape)}")
        elif op.role == "unpack" and not op.packed:
            violations.add(f"packed wire tile read as count-valued rows by {op.name}")
        elif op.role not in ("unpack", "consume"):
            violations.add(f"packed wire tile consumed by {op.name} before the "
                           "designated unpack (unpack_rows_t)")
    for event in trace.events:
        if event.inside or event.name in _METADATA_ONLY:
            continue
        if not any(s.storage in packed for s in event.reads):
            continue
        if event.name not in _WIRE_MOVES:
            violations.add(f"packed wire tile consumed by {event.name} before the "
                           "designated unpack (unpack_rows_t)")
        else:
            for s in event.results:
                if s.dtype != "uint8":
                    violations.add(f"packed wire tile widened by {event.name} to {s.dtype} "
                                   "before the designated unpack")
    for message in sorted(violations):
        _emit(audit, "GI003", message)


def trace_kernel(spec: KernelSpec, watch: bool = True) -> Trace:
    """Build one spec's update and record it — shared by the audit and the
    plan validator, so one geometry pays one recording."""
    return record_update(spec.build(), watch)


#: The rules whose verdicts depend on the geometry (``geometry_only``).
GEOMETRY_RULES = ("GI001", "GI003", "GI005", "GI006")


def audit_kernel(spec: KernelSpec, traced: Optional[Trace] = None,
                 watch: bool = True, geometry_only: bool = False) -> KernelAudit:
    """Record one spec's update (or take a caller's ``traced``
    :class:`Trace`) and run every audit over its schedule. Without
    ``watch`` the schedule is recorded alone, so what reads dispatched
    operations (GI004, GI002's accumulator-sized copies, GI003's moves
    outside a kernel, and their share of ``peak_live_bytes``) sees none:
    those do not depend on the geometry and ``graftcheck ir`` watches
    them over the shipped matrix; the plan, which audits the configured
    geometry on every admission, records the schedule alone.
    ``geometry_only`` runs :data:`GEOMETRY_RULES` alone (the schedule
    prover's topologies), leaving out GI002 and GI004."""
    audit = KernelAudit(spec.name)
    if traced is None:
        try:
            traced = trace_kernel(spec, watch)
        except Exception as e:  # noqa: BLE001 — any failure to run is the finding
            _emit(audit, "GI000",
                  f"update failed to run under the schedule recorder: {type(e).__name__}: {e}")
            return audit
    audit.facts["out_shapes"] = [list(shape) for shape, _ in traced.outputs]
    audit.facts["out_dtypes"] = [dtype for _, dtype in traced.outputs]
    packed = _packed_storages(traced)
    if not geometry_only:
        _audit_donation(spec, traced, audit)
    _audit_dtypes(traced, packed, audit, f64=not geometry_only)
    if spec.ring:
        _audit_ring(spec, traced, packed, audit)
    audit.facts["peak_live_bytes"] = peak_live_bytes(
        traced, per_position=spec.liveness_scope == "per-device")
    audit.facts["liveness_scope"] = spec.liveness_scope
    return audit


# --------------------------------------------------------------------------
# The shipped audit matrix: the REAL updates across mesh shapes and flags.
# --------------------------------------------------------------------------


def _module_file(name: str) -> str:
    import importlib

    return os.path.abspath(importlib.import_module(f"spark_examples_tpu_torch.ops.{name}").__file__)


def _bits(shape: Tuple[int, ...]) -> np.ndarray:
    """Seeded has-variation bits."""
    return (np.random.default_rng(SEED).random(shape) < 0.3).astype(np.uint8)


def _mesh(data: int, samples: int, device: str = "cpu"):
    from spark_examples_tpu_torch.parallel.mesh import DATA_AXIS, SAMPLES_AXIS, make_mesh

    return make_mesh({DATA_AXIS: data, SAMPLES_AXIS: samples},
                     [torch.device(device)] * (data * samples), local=True)


def _tiles_output(layout) -> Callable[[], List[Tuple[Tuple[int, ...], torch.dtype]]]:
    """The ring's Gramian as the reference's ``(data, padded, padded)``:
    each data slice's row tiles stacked (shapes only, no copy)."""
    tiles = layout.G_local

    def outputs():
        rows = sum(int(t.shape[0]) for t in tiles[0])
        return [((len(tiles), rows, int(tiles[0][0].shape[1])), tiles[0][0].dtype)]

    return outputs


def _operand(shape: Tuple[int, ...], device: str, values: Callable[[], np.ndarray]) -> torch.Tensor:
    """A uint8 operand: ``values()`` on the CPU, or a ``meta`` tensor of
    ``shape``."""
    if device == "meta":
        return torch.empty(shape, dtype=torch.uint8, device="meta")
    return torch.from_numpy(values())


def dense_kernel_spec(data: int, num_samples: int, block_size: int,
                      device: str = "cpu") -> KernelSpec:
    """The dense packed update, ``ops/gramian.py:dense_update`` on each data
    slice's ``(N, N)`` int32 Gramian — host blocks arrive bit-packed — on
    ``device`` (``cpu``, or ``meta`` at a plan's geometry)."""

    def build() -> Update:
        from spark_examples_tpu_torch.ops.gramian import dense_update

        G = torch.zeros((data, num_samples, num_samples), dtype=torch.int32, device=device)
        X = _operand((data, block_size, -(-num_samples // 8)), device,
                     lambda: np.packbits(_bits((data, block_size, num_samples)), axis=-1))

        def run():
            for d in range(data):
                dense_update(G[d], X[d], num_samples)

        return Update(run, (G,), (X,))

    return KernelSpec(
        name=f"dense[data={data},N={num_samples},B={block_size}]",
        build=build,
        packed=True,
        donation=DonationSite(_module_file("gramian"), "dense_update", "ops/gramian.py"),
        liveness_scope="global",
    )


def stacked_kernel_spec(jobs: int, num_samples: int, block_size: int) -> KernelSpec:
    """The fused batch executor's stacked-jobs step (``ops/batched.py:
    StackedJobsAccumulator._drain``): ``jobs - 1`` lanes staged, the last
    lane's block drains one step of both stacked kernels into the
    ``(jobs, N, N)`` int32 accumulator — the serving daemon's fused
    dispatch at group geometry."""

    def build() -> Update:
        from spark_examples_tpu_torch.ops.batched import StackedJobsAccumulator

        acc = StackedJobsAccumulator(jobs, num_samples, device="cpu", block_size=block_size,
                                     exact_int=True)
        rows = _bits((jobs, block_size, num_samples))
        for lane in range(jobs - 1):
            acc.add_rows(lane, rows[lane])
        return Update(lambda: acc.add_rows(jobs - 1, rows[jobs - 1]), (acc.G,))

    return KernelSpec(
        name=f"stacked[jobs={jobs},N={num_samples},B={block_size}]",
        build=build,
        packed=True,
        donation=DonationSite(_module_file("batched"), "_drain", "ops/batched.py"),
        liveness_scope="global",
    )


#: The largest count of the audit's count-valued rows (twice a bit).
_COUNTS_MAX = 2


def counts_kernel_spec(data: int, num_samples: int, block_size: int,
                       device: str = "cpu") -> KernelSpec:
    """The count-valued (same-set-join) dense update, ``ops/gramian.py:
    dense_update_counts`` — unpacked by necessity, audited for the
    accumulator contract and dtype hygiene — on ``device``."""

    def build() -> Update:
        from spark_examples_tpu_torch.ops.gramian import dense_update_counts

        G = torch.zeros((data, num_samples, num_samples), dtype=torch.int32, device=device)
        X = _operand((data, block_size, num_samples), device,
                     lambda: _COUNTS_MAX * _bits((data, block_size, num_samples)))

        def run():
            for d in range(data):
                dense_update_counts(G[d], X[d], max_count=_COUNTS_MAX)

        return Update(run, (G,))

    return KernelSpec(
        name=f"dense-counts[data={data},N={num_samples},B={block_size}]",
        build=build,
        donation=DonationSite(_module_file("gramian"), "dense_update_counts", "ops/gramian.py"),
        liveness_scope="global",
    )


def _ring_build(data: int, hosts: int, per_host: int, num_samples: int, block_size: int,
                pack: bool, device: str, counts: bool = False) -> Callable[[], Update]:
    """One flush of the host-fed ring (``ops/gramian.py:RingLayout.flush``,
    which ``ShardedGramianAccumulator`` runs) over ``data × hosts·per_host``
    positions on ``device``: seeded shards cut by ``ring_shards`` on the
    CPU, or ``meta`` shards of their shapes. ``counts`` ships count-valued
    rows on the unpacked wire (a same-set join's flush)."""

    def build() -> Update:
        from spark_examples_tpu_torch.ops.gramian import RingLayout, ring_shards

        samples = hosts * per_host
        layout = RingLayout(_mesh(data, samples, device), num_samples,
                            "on" if pack else "off", "hier" if hosts > 1 else "flat", hosts)
        if device == "meta":
            width = layout.n_local // 8 if pack else layout.n_local
            shards = [[torch.empty((block_size, width), dtype=torch.uint8, device="meta")
                       for _ in ring] for ring in layout.rings]
        else:
            rows = np.zeros((data * block_size, layout.padded), dtype=np.uint8)
            rows[:, :num_samples] = _bits((data * block_size, num_samples))
            if counts:
                rows *= _COUNTS_MAX
            shards = ring_shards(layout, rows, block_size, pack)
        return Update(
            lambda: layout.flush(shards, pack, max_count=_COUNTS_MAX if counts else 1),
            [t for tiles in layout.G_local for t in tiles],
            [t for ring in shards for t in ring] if pack else (),
            _tiles_output(layout),
        )

    return build


def _ring_spec(name: str, build, data: int, samples: int, num_samples: int, rows: int,
               pack: bool, passes: int, donation: DonationSite) -> KernelSpec:
    from spark_examples_tpu_torch.parallel.mesh import padded_cohort

    return KernelSpec(
        name=name,
        build=build,
        samples_axis=samples,
        packed=pack,
        ring=True,
        ring_passes=passes,
        rows_per_call=rows,
        n_local=padded_cohort(num_samples, samples, pack=pack) // samples,
        donation=donation,
        liveness_scope="per-device",
    )


def ring_kernel_spec(
    data: int,
    samples: int,
    num_samples: int,
    block_size: int,
    pack: bool,
    device: str = "cpu",
    counts: bool = False,
) -> KernelSpec:
    """The sharded ring-exchange update over a ``data x samples`` mesh of
    ``device`` positions — ``RingLayout.flush``, the flush the runtime's
    ``ShardedGramianAccumulator`` runs (``ring_pass``, flat). ``counts``
    flushes count-valued rows, which ride the unpacked wire."""
    pack = pack and not counts
    wire = "on" if pack else "off"
    return _ring_spec(
        f"ring[data={data},samples={samples},N={num_samples},B={block_size},pack={wire}]",
        _ring_build(data, 1, samples, num_samples, block_size, pack, device, counts),
        data, samples, num_samples, data * block_size, pack, 1,
        DonationSite(_module_file("gramian"), "ring_pass", "ops/gramian.py"),
    )


def hier_kernel_spec(
    data: int,
    hosts: int,
    devices_per_host: int,
    num_samples: int,
    block_size: int,
    pack: bool,
    device: str = "cpu",
) -> KernelSpec:
    """The two-level ring update (``ring_pass`` with ``hosts``) over a
    ``data x hosts·devices_per_host`` mesh. The ring contracts hold
    unchanged with ``samples_axis = hosts x devices_per_host``: ``(H-1) +
    H x (D-1) = S - 1`` shifts (GI006) and the flat ring's bytes (GI005)."""
    wire = "on" if pack else "off"
    samples = hosts * devices_per_host
    return _ring_spec(
        f"hier[data={data},hosts={hosts},devices={devices_per_host},"
        f"N={num_samples},B={block_size},pack={wire}]",
        _ring_build(data, hosts, devices_per_host, num_samples, block_size, pack, device),
        data, samples, num_samples, data * block_size, pack, 1,
        DonationSite(_module_file("gramian"), "ring_pass", "ops/gramian.py"),
    )


def _devicegen_build(data: int, hosts: int, per_host: int, num_samples: int,
                     block_size: int, blocks_per_dispatch: int, pack: bool):
    """One dispatch of the device-generation ring (``ops/devicegen.py:
    DeviceGenRingGramianAccumulator.add_grid`` → ``_blocks``): each data
    slice generates, packs and circulates ``blocks_per_dispatch`` blocks,
    with the reference's audit keys and an all-zero population table."""

    def build() -> Update:
        from spark_examples_tpu_torch.ops.devicegen import DeviceGenRingGramianAccumulator

        acc = DeviceGenRingGramianAccumulator(
            num_samples, (0x5EED,), np.zeros(num_samples, dtype=np.int32), 0xFACADE, 100, 0.1,
            _mesh(data, hosts * per_host), block_size=block_size,
            blocks_per_dispatch=blocks_per_dispatch, pack_bits="on" if pack else "off",
            reduce_schedule="hier" if hosts > 1 else "flat", hier_hosts=hosts,
        )
        span = data * blocks_per_dispatch * block_size
        return Update(lambda: acc.add_grid(0, span),
                      [t for tiles in acc.layout.G_local for t in tiles],
                      outputs=_tiles_output(acc.layout))

    return build


def devicegen_ring_spec(
    data: int,
    samples: int,
    num_samples: int,
    block_size: int,
    blocks_per_dispatch: int,
    pack: bool = True,
) -> KernelSpec:
    """The fused generate-and-ring-accumulate dispatch over a ``data x
    samples`` mesh: ``blocks_per_dispatch`` ring passes a data slice."""
    return _ring_spec(
        f"devicegen-ring[data={data},samples={samples},N={num_samples},"
        f"B={block_size},K={blocks_per_dispatch},pack={'on' if pack else 'off'}]",
        _devicegen_build(data, 1, samples, num_samples, block_size, blocks_per_dispatch, pack),
        data, samples, num_samples, data * blocks_per_dispatch * block_size, pack,
        blocks_per_dispatch,
        DonationSite(_module_file("devicegen"), "_ring_block", "ops/devicegen.py"),
    )


def devicegen_hier_spec(
    data: int,
    hosts: int,
    devices_per_host: int,
    num_samples: int,
    block_size: int,
    blocks_per_dispatch: int,
    pack: bool = True,
) -> KernelSpec:
    """The device-generation ring under the two-level schedule; the ring
    contracts hold unchanged with ``samples_axis = hosts x
    devices_per_host``."""
    samples = hosts * devices_per_host
    return _ring_spec(
        f"devicegen-hier[data={data},hosts={hosts},devices={devices_per_host},"
        f"N={num_samples},B={block_size},K={blocks_per_dispatch},"
        f"pack={'on' if pack else 'off'}]",
        _devicegen_build(data, hosts, devices_per_host, num_samples, block_size,
                         blocks_per_dispatch, pack),
        data, samples, num_samples, data * blocks_per_dispatch * block_size, pack,
        blocks_per_dispatch,
        DonationSite(_module_file("devicegen"), "_ring_block", "ops/devicegen.py"),
    )


#: The default mesh matrix: enough shapes that an axis-size-dependent
#: regression (a hardcoded D, a ragged-width assumption) cannot hide.
DEFAULT_MESHES: Tuple[Tuple[int, int], ...] = ((1, 2), (1, 4), (2, 2))


def default_specs(
    num_samples: int = 64,
    ragged_samples: int = 100,
    block_size: int = 8,
    meshes: Sequence[Tuple[int, int]] = DEFAULT_MESHES,
    topologies: Sequence[Tuple[int, int]] = (),
) -> List[KernelSpec]:
    """The shipped audit matrix, the reference's in its order: dense and
    counts updates per data-axis size, the stacked step at 2 and 4 jobs,
    the ring over every mesh × {packed, unpacked} (and packed at the ragged
    cohort), the device-generation ring per mesh, and per ``topologies``
    pair the two-level ring packed and unpacked and its device-generation
    counterpart."""
    specs: List[KernelSpec] = []
    for data in sorted({d for d, _ in meshes}):
        specs.append(dense_kernel_spec(data, num_samples, block_size))
        specs.append(counts_kernel_spec(data, num_samples, block_size))
    for jobs in (2, 4):
        specs.append(stacked_kernel_spec(jobs, num_samples, block_size))
    for data, samples in meshes:
        if samples < 2:
            continue
        for pack in (True, False):
            specs.append(ring_kernel_spec(data, samples, num_samples, block_size, pack))
        specs.append(ring_kernel_spec(data, samples, ragged_samples, block_size, True))
    for data, samples in meshes:
        if samples < 2:
            continue
        specs.append(devicegen_ring_spec(data, samples, num_samples, block_size, 2))
    for hosts, per_host in topologies:
        if hosts * per_host < 2:
            continue
        for pack in (True, False):
            specs.append(hier_kernel_spec(1, hosts, per_host, num_samples, block_size, pack))
        specs.append(devicegen_hier_spec(1, hosts, per_host, num_samples, block_size, 2))
    return specs


@dataclass
class IrReport:
    """Every kernel audit of one ``graftcheck ir`` run."""

    audits: List[KernelAudit] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(a.ok for a in self.audits)

    @property
    def findings(self) -> List[Finding]:
        return [f for a in self.audits for f in a.findings]

    def to_json(self) -> str:
        return json.dumps(
            {
                "tool": "graftcheck-ir",
                "ok": self.ok,
                "kernel_count": len(self.audits),
                "finding_count": len(self.findings),
                "kernels": [a.to_json() for a in self.audits],
            },
            indent=2,
        )

    def format(self) -> str:
        lines = []
        for a in self.audits:
            if a.ok:
                bits = []
                if "permute_executions" in a.facts:
                    bits.append(f"shifts {a.facts['permute_executions']}"
                                f"/{a.facts['permute_executions_expected']}")
                if a.facts.get("ring_overlap_independent"):
                    bits.append("overlap independent")
                if "ring_bytes_jaxpr" in a.facts:
                    bits.append(f"ring bytes {a.facts['ring_bytes_jaxpr']} == formula")
                if "accumulator_donated" in a.facts:
                    bits.append("in place" if a.facts["accumulator_donated"]
                                else "out of place, justified")
                bits.append(f"peak live {a.facts.get('peak_live_bytes', 0)} B "
                            f"({a.facts.get('liveness_scope')})")
                lines.append(f"  audited: {a.name}: " + ", ".join(bits))
            else:
                for f in a.findings:
                    lines.append(f"  {f.format()}")
        verdict = "clean" if self.ok else f"{len(self.findings)} finding(s)"
        lines.append(f"graftcheck ir: {len(self.audits)} kernel(s), {verdict}")
        return "\n".join(lines)


def run_audit(specs: Optional[Sequence[KernelSpec]] = None) -> IrReport:
    """Audit ``specs`` (default: the shipped matrix). CPU and ``meta``
    tensors only: no CUDA context is made (test-asserted)."""
    report = IrReport()
    for spec in specs if specs is not None else default_specs():
        report.audits.append(audit_kernel(spec))
    return report


__all__ = [
    "DEFAULT_MESHES",
    "DonationSite",
    "Event",
    "GEOMETRY_RULES",
    "IrReport",
    "KernelAudit",
    "KernelSpec",
    "Trace",
    "Update",
    "audit_kernel",
    "counts_kernel_spec",
    "default_specs",
    "dense_kernel_spec",
    "devicegen_hier_spec",
    "devicegen_ring_spec",
    "gc005_justified_functions",
    "hier_kernel_spec",
    "overlap_findings",
    "peak_live_bytes",
    "record_update",
    "ring_kernel_spec",
    "run_audit",
    "serialized_hops",
    "stacked_kernel_spec",
    "trace_kernel",
]
