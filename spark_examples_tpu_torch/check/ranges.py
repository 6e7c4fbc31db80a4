"""Range and exactness proving over the recorded schedule (``graftcheck ranges``).

The port of ``spark_examples_tpu/check/ranges.py``. The reference walks a
traced jaxpr primitive by primitive; the port's device program is the
recorded schedule of ``check/ir.py`` (``obs/schedule.py``): each kernel is
one opaque op, and a ``TorchDispatchMode`` watches the PyTorch operations
between kernels. This module walks that record with the reference's
lattice, an **interval × integrality × contracted** value kept per
storage:

- every storage the update is handed is seeded from its spec's declared
  contract (``ops/contracts.py``); the accumulators start at 0, and what
  the audit proves about them is relative: the increment one update adds;
- each kernel op has a transfer function (:data:`_TRANSFERS`, keyed by the
  wrapper's name). A generation block is ``[0, 1]``, contracted when its
  site-grid scalars carry ``SITE_INDEX``; a bit unpack takes ``[0, 255]``
  bytes to ``[0, 1]``, a count-valued unpack passes its counts; a pack
  gives ``[0, 255]``; transposes, shifts and consumes pass values on; a
  product adds a partial of ``support × hi_a × hi_b`` to the region of the
  accumulator it writes. An op the table lacks gives TOP and is listed
  (``unhandled_primitives``);
- each storage also carries its **support**: the sites of an Xᵀ that may
  be nonzero — the rows an unpack was handed, the sites a generation block
  was handed. The tiling pads Xᵀ to 128 sites with exact zeros, so the
  contraction of a product is its operands' support, not their width;
- between kernels, views, moves and copies that keep the dtype pass the
  range on, a cast is checked (GR003), and any other operation gives TOP.

The **disjoint-slice proof** is the products' written regions: each
recorded write carries its view's offset and strides, so the largest sum
of partials any one entry receives (``entry_increment``) is computed
exactly over the regions' compressed row and column boundaries. A ring
pass writes each owner's columns of a row tile once, so a ring flush adds
one partial an entry a pass. ``entry_increment_conservative`` drops only
the column-disjointness of writes that share rows (the reference's
refinement), keeping data slices, lanes and positions apart.

Rules (``check/rules.py:RANGES_RULES``): GR000 the update fails to run;
GR001 an int32 overflow (an operand past the int8 window, a partial past
int32's, or the declared geometry past int32); GR002 a float32 partial past
2^24; GR003 a lossy narrowing cast between kernels; GR004 an uncontracted
operand reaching a product; GR005 the flush projection
(``ops/contracts.py:flush_entry_increment``, which the accumulators check
before every flush) below the proven increment.

The audit runs on CPU and ``meta`` tensors only; ``graftcheck plan`` audits
the configured kernels over the schedules it records anyway.
"""

from __future__ import annotations

import bisect
import json
import math
from collections import defaultdict
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from spark_examples_tpu_torch.check.ir import (
    Event,
    Trace,
    Update,
    counts_kernel_spec,
    dense_kernel_spec,
    devicegen_hier_spec,
    devicegen_ring_spec,
    hier_kernel_spec,
    record_update,
    ring_kernel_spec,
    stacked_kernel_spec,
)
from spark_examples_tpu_torch.check.rules import Finding
from spark_examples_tpu_torch.obs.schedule import Op, Tile
from spark_examples_tpu_torch.ops.contracts import (
    COUNT_ROW,
    DECLARED_MAX_SITES,
    HAS_VARIATION,
    PACKED_BYTE,
    SITE_INDEX,
    RangeContract,
    exact_int_window,
    exactness_headroom_sites,
    flush_entry_increment,
)

_INF = float("inf")


# --------------------------------------------------------------------------
# The lattice: interval × integrality × contracted.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AbsVal:
    """One abstract value: every element of the storage lies in ``[lo,
    hi]``; ``integer`` asserts all are integers; ``contracted`` is
    provenance — False taints everything derived from an input with no
    declared contract (GR004)."""

    lo: float
    hi: float
    integer: bool = True
    contracted: bool = True

    @property
    def bounded(self) -> bool:
        return math.isfinite(self.lo) and math.isfinite(self.hi)

    @property
    def magnitude(self) -> float:
        return max(abs(self.lo), abs(self.hi))


TOP = AbsVal(-_INF, _INF, integer=False, contracted=False)
_ZERO = AbsVal(0.0, 0.0)


def _hull(a: AbsVal, b: AbsVal) -> AbsVal:
    return AbsVal(min(a.lo, b.lo), max(a.hi, b.hi), a.integer and b.integer,
                  a.contracted and b.contracted)


def _mul_bound(a: float, b: float) -> float:
    # Concrete values are finite, so 0 × anything is 0 even against ±inf.
    if a == 0.0 or b == 0.0:
        return 0.0
    return a * b


def _mul(a: AbsVal, b: AbsVal) -> AbsVal:
    combos = [_mul_bound(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return AbsVal(min(combos), max(combos), a.integer and b.integer,
                  a.contracted and b.contracted)


def contract_val(contract: Optional[RangeContract]) -> AbsVal:
    if contract is None:
        return TOP
    return AbsVal(float(contract.lo), float(contract.hi), contract.integral)


def _int_info(dtype: str):
    try:
        kind = np.dtype(dtype).kind
    except TypeError:  # bfloat16 and other names numpy lacks
        return None
    return np.iinfo(np.dtype(dtype)) if kind in ("i", "u") else None


def _cast(val: AbsVal, dtype: str) -> AbsVal:
    """``val`` converted to ``dtype``: integer in an int dtype, and the
    whole dtype range where it could wrap."""
    info = _int_info(dtype)
    if info is None:
        return val
    out = replace(val, integer=True)
    if out.bounded and (out.lo < info.min or out.hi > info.max):
        return replace(out, lo=float(info.min), hi=float(info.max))
    return out


# --------------------------------------------------------------------------
# What the walk records, checked after it.
# --------------------------------------------------------------------------


@dataclass
class DotSite:
    """One product op: its partial, operands and contraction (support)."""

    out: AbsVal
    operands: Tuple[AbsVal, AbsVal]
    contraction: int
    uncontracted: bool  # an operand is unbounded or uncontracted


@dataclass
class ConvertSite:
    """One cast between kernels."""

    src: AbsVal
    src_dtype: str
    dst_dtype: str


def _box(tile: Tile) -> Optional[Tuple[int, int, int, int, int]]:
    """``(pitch, row0, row1, col0, col1)`` of a row-major view of its
    storage seen as rows of ``pitch`` elements, or ``None`` for any other
    view."""
    shape, strides = tile.shape, tile.strides
    if len(shape) < 2 or len(strides) != len(shape) or strides[-1] != 1:
        return None
    pitch = strides[-2]
    if pitch < 1 or any(strides[i] != strides[i + 1] * shape[i + 1]
                        for i in range(len(shape) - 2)):
        return None
    row0, col0 = divmod(tile.offset, pitch)
    if col0 + shape[-1] > pitch:
        return None
    return pitch, row0, row0 + math.prod(shape[:-1]), col0, col0 + shape[-1]


def _entry_maxima(writes: Sequence[Tuple[Tile, float]]) -> Tuple[float, float]:
    """The largest sum of write increments any one entry of a storage
    receives, and the same with writes that share rows taken to share
    columns too. Exact over the regions' compressed boundaries; a view
    that is not a row-major box of the storage's one pitch counts against
    every entry."""
    boxes = [_box(tile) for tile, _ in writes]
    if any(b is None for b in boxes) or len({b[0] for b in boxes}) > 1:
        total = float(sum(v for _, v in writes))
        return total, total
    rows = sorted({e for b in boxes for e in (b[1], b[2])})
    cols = sorted({e for b in boxes for e in (b[3], b[4])})
    grid = np.zeros((len(rows) - 1, len(cols) - 1))
    band = np.zeros(len(rows) - 1)
    for (_, r0, r1, c0, c1), (_, value) in zip(boxes, writes):
        i0, i1 = bisect.bisect_left(rows, r0), bisect.bisect_left(rows, r1)
        j0, j1 = bisect.bisect_left(cols, c0), bisect.bisect_left(cols, c1)
        grid[i0:i1, j0:j1] += value
        band[i0:i1] += value
    return float(grid.max(initial=0.0)), float(band.max(initial=0.0))


# --------------------------------------------------------------------------
# The walk over the recorded schedule.
# --------------------------------------------------------------------------

#: Operations between kernels whose results alias their operand's storage.
_VIEWS = {
    "_reshape_alias", "_unsafe_view", "alias", "as_strided", "chunk", "detach", "expand",
    "lift_fresh", "narrow", "permute", "reshape", "select", "slice", "split", "squeeze", "t",
    "transpose", "unbind", "unsqueeze", "view",
}
#: Operations between kernels that copy values (a dtype change is a cast).
_MOVES = {"_pin_memory", "_to_copy", "cat", "clone", "contiguous", "copy_", "stack"}
#: Operations that make a new storage of zeros.
_ZEROS = {"new_zeros", "zeros", "zeros_like"}


class Prover:
    """Walks one :class:`~spark_examples_tpu_torch.check.ir.Trace` once,
    keeping an :class:`AbsVal` and a support a storage, and recording the
    product, cast and write sites the GR rules inspect.

    ``input_contracts`` are the spec's: the second is the contract of
    every storage the update is handed (its first is the accumulator's,
    ``None``), and the generation's scalars carry all but the first."""

    def __init__(self, trace: Trace, input_contracts: Sequence[Optional[RangeContract]]):
        self.trace = trace
        self.accumulators = set(trace.accumulators)
        contracts = tuple(input_contracts)
        self.handed = contract_val(contracts[1]) if len(contracts) > 1 else TOP
        self.scalars_contracted = len(contracts) > 1 and all(c is not None for c in contracts[1:])
        self.values: Dict[int, AbsVal] = {}
        self.support: Dict[int, Optional[int]] = {}
        self.dots: List[DotSite] = []
        self.converts: List[ConvertSite] = []
        self.writes: Dict[int, List[Tuple[Tile, AbsVal]]] = defaultdict(list)
        #: Accumulators written outside a product (their increment is unprovable).
        self.clobbered: Set[int] = set()
        self.unhandled: Set[str] = set()

    # ------------------------------------------------------------ storages

    def value(self, storage: int) -> AbsVal:
        """A storage's value: its accumulated entries for an accumulator
        (relative to the update's start), its contract when first read."""
        if storage in self.accumulators:
            if storage in self.clobbered:
                return TOP
            writes = self.writes.get(storage, ())
            hi, _ = _entry_maxima([(t, v.hi) for t, v in writes]) if writes else (0.0, 0.0)
            lo = min(0.0, sum(v.lo for _, v in writes if v.lo < 0))
            return AbsVal(lo, hi, all(v.integer for _, v in writes),
                          all(v.contracted for _, v in writes))
        if storage not in self.values:
            self.values[storage] = self.handed
        return self.values[storage]

    def set(self, storage: int, val: AbsVal, support: Optional[int] = None) -> None:
        if storage in self.accumulators:
            self.clobbered.add(storage)
            return
        self.values[storage] = val
        self.support[storage] = support

    def width(self, tile: Tile) -> int:
        """The sites of an Xᵀ operand that may be nonzero."""
        support = self.support.get(tile.storage)
        sites = tile.shape[-1] if tile.shape else 1
        return sites if support is None else min(support, sites)

    # -------------------------------------------------------------- the walk

    def run(self) -> "Prover":
        for step in self.trace.steps():
            if isinstance(step, Op):
                transfer = _TRANSFERS.get(step.name)
                if transfer is None:
                    self.unhandled.add(step.name)
                    for tile in (*step.writes, *step.results):
                        self.set(tile.storage, TOP)
                else:
                    transfer(self, step)
            else:
                self._event(step)
        return self

    def _event(self, event: Event) -> None:
        name = event.name
        if name in _VIEWS:
            aliased = {s.storage for s in event.reads}
            for s in event.results:
                if s.storage not in aliased:
                    self.set(s.storage, _hull_all([self.value(r.storage) for r in event.reads]))
            return
        if name in _MOVES:
            sources = event.reads[1:] if name == "copy_" else event.reads
            values = [self.value(s.storage) for s in sources]
            moved = _hull_all(values)
            for result in event.results:
                for source, val in zip(sources, values):
                    if source.dtype != result.dtype:
                        self.converts.append(ConvertSite(val, source.dtype, result.dtype))
                out = _cast(moved, result.dtype)
                if name == "copy_":  # a copy into part of a storage keeps the rest
                    out = _hull(self.value(result.storage), out)
                self.set(result.storage, out, self._moved_support(sources, values, result))
            return
        for s in event.results:
            if name in _ZEROS:
                self.set(s.storage, _ZERO, 0)
            else:
                self.set(s.storage, TOP)

    def _moved_support(self, sources, values, result) -> Optional[int]:
        """A copy's support: its sources' largest, when every source and
        the result keep the same sites axis (a last slice's Xᵀ padded
        with zero columns); a zero source adds none."""
        supports = []
        for source, val in zip(sources, values):
            if val.lo == val.hi == 0.0:
                continue
            if len(source.shape) != 2 or len(result.shape) != 2 or source.shape[1] != result.shape[1]:
                return None
            supports.append(self.support.get(source.storage))
        if any(s is None for s in supports):
            return None
        return max(supports, default=0)


def _hull_all(values: Sequence[AbsVal]) -> AbsVal:
    if not values:
        return TOP
    out = values[0]
    for val in values[1:]:
        out = _hull(out, val)
    return out


# ------------------------------------------------------ transfer functions


def _generate(prover: Prover, op: Op) -> None:
    """``gen_genotypes``: a block of has-variation bits (``[0, 1]``) over
    ``op.support`` sites, contracted when the site-grid scalars carry a
    contract; its in-place counters count sites."""
    contracted = prover.scalars_contracted
    for tile in op.writes:
        prover.set(tile.storage, replace(contract_val(SITE_INDEX), contracted=contracted))
    prover.set(op.results[0].storage, AbsVal(0.0, 1.0, True, contracted), op.support)


def _unpack(prover: Prover, op: Op) -> None:
    """``unpack_rows_t``, ``stacked_unpack_rows_t``: bit-packed bytes to
    ``[0, 1]``, count-valued rows as they are, over the rows handed."""
    src = prover.value(op.reads[0].storage)
    out = AbsVal(0.0, 1.0, True, src.contracted) if op.packed else src
    prover.set(op.results[0].storage, out, op.support)


def _pack(prover: Prover, op: Op) -> None:
    """``pack_rows_t``: eight bits a byte, ``[0, 255]``."""
    src = prover.value(op.reads[0].storage)
    prover.set(op.results[0].storage, AbsVal(0.0, 255.0, True, src.contracted))


def _transpose(prover: Prover, op: Op) -> None:
    """``transpose_rows_t``: the int8 entries as uint8 wire rows."""
    prover.set(op.results[0].storage, _cast(prover.value(op.reads[0].storage), "uint8"))


def _shift(prover: Prover, op: Op) -> None:
    """``ring_shift``: the received tile holds the sent one's values."""
    sent = op.reads[0].storage
    prover.set(op.results[0].storage, prover.value(sent), prover.support.get(sent))


def _consume(prover: Prover, op: Op) -> None:
    """``consume``: a stream takes a tile; nothing changes."""
    for tile in op.reads:
        prover.value(tile.storage)


def _product(prover: Prover, op: Op) -> None:
    """``gram_accumulate``, ``cross_accumulate``, ``stacked_gram_accumulate``:
    each entry of the written region gains one partial of ``support ×
    hi_a × hi_b`` (a stacked launch's lanes are separate entries)."""
    a_tile, b_tile = op.reads[0], op.reads[-1]
    a, b = prover.value(a_tile.storage), prover.value(b_tile.storage)
    k = min(prover.width(a_tile), prover.width(b_tile))
    prod = _mul(a, b)
    out = AbsVal(_mul_bound(float(k), prod.lo), _mul_bound(float(k), prod.hi), prod.integer,
                 prod.contracted)
    prover.dots.append(DotSite(
        out, (a, b), k,
        uncontracted=not (a.bounded and b.bounded and a.contracted and b.contracted),
    ))
    for tile in op.writes:
        prover.writes[tile.storage].append((tile, out))


#: The kernel ops the prover reads, by wrapper name.
_TRANSFERS: Dict[str, Callable[[Prover, Op], None]] = {
    "gen_genotypes": _generate,
    "unpack_rows_t": _unpack,
    "stacked_unpack_rows_t": _unpack,
    "pack_rows_t": _pack,
    "transpose_rows_t": _transpose,
    "ring_shift": _shift,
    "consume": _consume,
    "gram_accumulate": _product,
    "cross_accumulate": _product,
    "stacked_gram_accumulate": _product,
}


# --------------------------------------------------------------------------
# Kernel specs, the audit, and the report.
# --------------------------------------------------------------------------


@dataclass
class RangeKernelSpec:
    """One update × geometry × contract assignment to prove.

    ``build`` is a ``check/ir.py`` spec's (the runtime's own constructors).
    ``input_contracts`` keep the reference's assignment: the accumulator's
    (``None``), then the contract of what the update is handed (a
    generation's site-grid scalars). ``rows_per_flush``/``max_count``
    mirror what the runtime's ``_flush`` feeds the projection;
    ``declared_rows`` is the geometry the GR001 overflow proof covers. The
    port's products take int8 operands into int32 accumulators; the flush
    projection is ``ops/contracts.py:flush_entry_increment``, the one the
    accumulators check."""

    name: str
    build: Callable[[], Update]
    input_contracts: Tuple[Optional[RangeContract], ...]
    rows_per_flush: int = 0
    max_count: int = 1
    operand_window_dtype: str = "int8"
    accum_dtype: str = "int32"
    declared_rows: int = DECLARED_MAX_SITES


@dataclass
class RangeAudit:
    """One kernel's range/exactness audit: findings + machine facts."""

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


def _emit(audit: RangeAudit, rule_id: str, detail: str) -> None:
    audit.findings.append(Finding(rule_id, audit.name, 0, 0, detail))


def _is_int_dtype(name: str) -> bool:
    try:
        return np.dtype(name).kind in ("i", "u", "b")
    except TypeError:
        return False


def _increments(prover: Prover) -> Tuple[Optional[float], Optional[float]]:
    """``(entry_increment, entry_increment_conservative)`` over the
    accumulators the products wrote; ``None`` where a partial is unbounded
    or an accumulator was written outside a product."""
    refined = conservative = 0.0
    for storage in prover.accumulators:
        if storage in prover.clobbered:
            return None, None
        writes = prover.writes.get(storage)
        if writes:
            r, c = _entry_maxima([(tile, val.hi) for tile, val in writes])
            refined, conservative = max(refined, r), max(conservative, c)
    if not (math.isfinite(refined) and math.isfinite(conservative)):
        return None, None
    return refined, conservative


def audit_range_kernel(spec: RangeKernelSpec, traced: Optional[Trace] = None,
                       watch: bool = True) -> RangeAudit:
    """Record one spec's update (or take a caller's ``traced`` schedule of
    the same build: how the plan shares its recordings) and prove its
    range and exactness contracts. Without ``watch`` no operation between
    kernels is seen, so GR003 sees no cast: the GR003 rules do not depend
    on the geometry, and ``graftcheck ranges`` holds them over its
    matrix."""
    audit = RangeAudit(spec.name)
    if traced is None:
        try:
            traced = record_update(spec.build(), watch)
        except Exception as e:  # noqa: BLE001 — any failure to run is the finding
            _emit(audit, "GR000",
                  f"update failed to run under the schedule recorder: {type(e).__name__}: {e}")
            return audit
    prover = Prover(traced, spec.input_contracts).run()

    audit.facts["input_contracts"] = [c.name if c is not None else None
                                      for c in spec.input_contracts]
    audit.facts["accum_dtype"] = spec.accum_dtype

    # ---- GR004: uncontracted inputs reaching a product -------------------
    for dot in prover.dots:
        if dot.uncontracted:
            _emit(
                audit,
                "GR004",
                "a product consumes an operand with no declared range contract "
                "(ops/contracts.py) — interval "
                f"[{dot.operands[0].lo}, {dot.operands[0].hi}] × "
                f"[{dot.operands[1].lo}, {dot.operands[1].hi}]; no exactness claim "
                "about this kernel can be made",
            )

    # ---- GR001 / GR002: per-dispatch partial windows --------------------
    accum_window = exact_int_window(spec.accum_dtype) or 0
    operand_window = exact_int_window(spec.operand_window_dtype) or 0
    accum_is_float = not _is_int_dtype(spec.accum_dtype)
    window_rule = "GR002" if accum_is_float else "GR001"
    partial_hi = 0.0
    for dot in prover.dots:
        if dot.uncontracted:
            continue
        partial_hi = max(partial_hi, dot.out.magnitude)
        for op in dot.operands:
            if op.integer and op.magnitude > operand_window:
                _emit(
                    audit,
                    window_rule,
                    f"product operand interval [{op.lo:g}, {op.hi:g}] exceeds the "
                    f"{spec.operand_window_dtype} exact-integer window ({operand_window}) — "
                    "operands would round or wrap before the multiply",
                )
        if dot.out.integer and dot.out.magnitude > accum_window:
            _emit(
                audit,
                window_rule,
                f"per-dispatch partial can reach {dot.out.magnitude:g} (contraction "
                f"{dot.contraction} × operand bounds), past the {spec.accum_dtype} exact "
                f"window ({accum_window}) — exactness is lost before the flush "
                "projection can see it",
            )
    audit.facts["dot_partial_bound"] = partial_hi

    # ---- GR003: lossy narrowing casts ---------------------------------
    for conv in prover.converts:
        if not conv.src.integer:
            continue
        info = _int_info(conv.src_dtype)
        if info is not None and conv.src.lo <= info.min and conv.src.hi >= info.max:
            # A full-dtype-range source is bit entropy (hash mixing): the
            # int→int truncation is its modular semantics, not a lost count.
            continue
        effective = conv.src.magnitude
        src_window = exact_int_window(conv.src_dtype)
        if src_window is not None:
            effective = min(effective, float(src_window))
        dst_window = exact_int_window(conv.dst_dtype)
        if dst_window is not None and effective > dst_window:
            _emit(
                audit,
                "GR003",
                f"cast {conv.src_dtype}→{conv.dst_dtype} between kernels with inferred "
                f"operand magnitude {effective:g} past the destination's exact window "
                f"({dst_window}) — integer values would round or wrap",
            )

    # ---- the per-flush entry increment + GR005 -------------------------
    if prover.accumulators:
        increment, conservative = _increments(prover)
        audit.facts["entry_increment"] = increment
        audit.facts["entry_increment_conservative"] = conservative
        projection = flush_entry_increment(spec.rows_per_flush, spec.max_count)
        audit.facts["flush_projection"] = projection
        if increment is None:
            _emit(
                audit,
                "GR005",
                "the per-flush accumulator entry increment is unprovable from the "
                "recorded schedule (a partial is unbounded, or an accumulator is "
                "written outside a product) — the flush projection cannot be verified "
                "conservative",
            )
        elif projection < increment:
            _emit(
                audit,
                "GR005",
                f"the runtime flush projection is {projection} per flush "
                f"(ops/contracts.py:flush_entry_increment with rows={spec.rows_per_flush}, "
                f"max_count={spec.max_count}) but the recorded update can add "
                f"{increment:g} to one entry per flush — the int32 overflow guard "
                "could fire late",
            )

    # ---- GR001: declared-geometry accumulation ------------------------
    int32_window = exact_int_window(np.int32) or 0
    entry_bound = flush_entry_increment(spec.declared_rows, spec.max_count)
    audit.facts["gramian_entry_bound"] = entry_bound
    audit.facts["declared_rows"] = spec.declared_rows
    audit.facts["exactness_headroom_sites"] = {
        "float32": exactness_headroom_sites(np.float32, spec.max_count),
        "int32": exactness_headroom_sites(np.int32, spec.max_count),
    }
    if entry_bound > int32_window:
        _emit(
            audit,
            "GR001",
            f"declared geometry ({spec.declared_rows} rows × max_count "
            f"{spec.max_count}²) bounds an entry at {entry_bound}, past int32's exact "
            f"window ({int32_window}) — the int32 accumulator can overflow; shrink the "
            "geometry contract",
        )
    if prover.unhandled:
        audit.facts["unhandled_primitives"] = sorted(prover.unhandled)
    return audit


# --------------------------------------------------------------------------
# The shipped audit matrix (the runtime's updates, via check/ir.py's specs).
# --------------------------------------------------------------------------

#: Mirrors check/ir.py's mesh matrix.
DEFAULT_MESHES: Tuple[Tuple[int, int], ...] = ((1, 2), (1, 4), (2, 2))


def dense_range_spec(data: int, num_samples: int, block_size: int,
                     device: str = "cpu") -> RangeKernelSpec:
    """The dense packed update under the packed-byte contract; a flush of
    ``data × block_size`` rows gives each data slice its own partial."""
    ir_spec = dense_kernel_spec(data, num_samples, block_size, device)
    return RangeKernelSpec(
        name=f"ranges:{ir_spec.name}",
        build=ir_spec.build,
        input_contracts=(None, PACKED_BYTE),
        rows_per_flush=data * block_size,
        max_count=HAS_VARIATION.hi,
    )


def stacked_range_spec(jobs: int, num_samples: int, block_size: int) -> RangeKernelSpec:
    """The fused batch groups' stacked-jobs step under the packed-byte
    contract. Its lanes are independent accumulators, so one step grows an
    entry by at most ``block_size`` rows, not ``jobs × block_size``."""
    ir_spec = stacked_kernel_spec(jobs, num_samples, block_size)
    return RangeKernelSpec(
        name=f"ranges:{ir_spec.name}",
        build=ir_spec.build,
        input_contracts=(None, PACKED_BYTE),
        rows_per_flush=block_size,
        max_count=HAS_VARIATION.hi,
    )


def counts_range_spec(data: int, num_samples: int, block_size: int,
                      device: str = "cpu") -> RangeKernelSpec:
    """The count-valued (same-set-join) dense update under ``COUNT_ROW``."""
    ir_spec = counts_kernel_spec(data, num_samples, block_size, device)
    return RangeKernelSpec(
        name=f"ranges:{ir_spec.name}",
        build=ir_spec.build,
        input_contracts=(None, COUNT_ROW),
        rows_per_flush=data * block_size,
        max_count=COUNT_ROW.hi,
    )


def _flavor(exact_int: bool) -> str:
    """The reference's accumulation flavor; both record the port's one
    int8 → int32 update (ROADMAP.md §3)."""
    return "int8" if exact_int else "bf16"


def ring_range_spec(
    data: int,
    samples: int,
    num_samples: int,
    block_size: int,
    pack: bool,
    exact_int: bool,
    counts: bool = False,
    device: str = "cpu",
) -> RangeKernelSpec:
    """One flush of the host-fed ring. ``counts=True`` audits the unpacked
    ring under the count-valued contract: same-set-join flushes ride the
    unpacked wire whatever ``--ring-pack-bits`` says
    (``ShardedGramianAccumulator._flush``), so their exactness needs its
    own proof."""
    ir_spec = ring_kernel_spec(data, samples, num_samples, block_size, pack, device, counts)
    contract = COUNT_ROW if counts else (PACKED_BYTE if pack else HAS_VARIATION)
    return RangeKernelSpec(
        name=f"ranges:{ir_spec.name}[{_flavor(exact_int)}{',counts' if counts else ''}]",
        build=ir_spec.build,
        input_contracts=(None, contract),
        rows_per_flush=data * block_size,
        max_count=contract.hi if counts else HAS_VARIATION.hi,
    )


def hier_range_spec(
    hosts: int,
    devices_per_host: int,
    num_samples: int,
    block_size: int,
    pack: bool,
    exact_int: bool,
    data: int = 1,
) -> RangeKernelSpec:
    """The two-level ring (``graftcheck ranges --topology H,D``) under the
    flat ring's contracts: its owner index ``((h + k) mod H)·D + (d + j)
    mod D`` takes each owner's columns once a pass, so an entry still takes
    one partial a pass."""
    ir_spec = hier_kernel_spec(data, hosts, devices_per_host, num_samples, block_size, pack)
    return RangeKernelSpec(
        name=f"ranges:{ir_spec.name}[{_flavor(exact_int)}]",
        build=ir_spec.build,
        input_contracts=(None, PACKED_BYTE if pack else HAS_VARIATION),
        rows_per_flush=data * block_size,
        max_count=HAS_VARIATION.hi,
    )


def devicegen_range_spec(
    data: int,
    samples: int,
    num_samples: int,
    block_size: int,
    blocks_per_dispatch: int = 2,
    pack: bool = True,
) -> RangeKernelSpec:
    """One dispatch of the fused generate-and-ring-accumulate path. Its
    genotypes are generated on the card: their ``[0, 1]`` is the
    generation's transfer function, contracted because the site-grid
    scalars (row counters, kept-site counts, dispatch offsets, valid-site
    counts) carry ``SITE_INDEX``; each block is one ring pass."""
    ir_spec = devicegen_ring_spec(data, samples, num_samples, block_size, blocks_per_dispatch,
                                  pack)
    return RangeKernelSpec(
        name=f"ranges:{ir_spec.name}",
        build=ir_spec.build,
        input_contracts=(None, SITE_INDEX, SITE_INDEX, SITE_INDEX, SITE_INDEX),
        rows_per_flush=data * blocks_per_dispatch * block_size,
        max_count=HAS_VARIATION.hi,
    )


def devicegen_hier_range_spec(
    hosts: int,
    devices_per_host: int,
    num_samples: int,
    block_size: int,
    blocks_per_dispatch: int = 2,
    pack: bool = True,
    data: int = 1,
) -> RangeKernelSpec:
    """The generation ring under the two-level schedule (``--topology
    H,D``)."""
    ir_spec = devicegen_hier_spec(data, hosts, devices_per_host, num_samples, block_size,
                                  blocks_per_dispatch, pack)
    return RangeKernelSpec(
        name=f"ranges:{ir_spec.name}",
        build=ir_spec.build,
        input_contracts=(None, SITE_INDEX, SITE_INDEX, SITE_INDEX, SITE_INDEX),
        rows_per_flush=data * blocks_per_dispatch * block_size,
        max_count=HAS_VARIATION.hi,
    )


def default_specs(
    num_samples: int = 64,
    block_size: int = 8,
    meshes: Sequence[Tuple[int, int]] = DEFAULT_MESHES,
    topologies: Sequence[Tuple[int, int]] = (),
) -> List[RangeKernelSpec]:
    """The shipped matrix, the reference's in its order: dense and counts
    per data-axis size, the stacked step at 2 and 4 jobs, the ring over
    every mesh × {packed, unpacked} × {int8, bf16}, the count-valued
    unpacked ring and the device-generation ring per mesh; per
    ``topologies`` pair the two-level ring packed × {int8, bf16} and its
    device-generation counterpart."""
    specs: List[RangeKernelSpec] = []
    for data in sorted({d for d, _ in meshes}):
        specs.append(dense_range_spec(data, num_samples, block_size))
        specs.append(counts_range_spec(data, num_samples, block_size))
    for jobs in (2, 4):
        specs.append(stacked_range_spec(jobs, num_samples, block_size))
    for data, samples in meshes:
        if samples < 2:
            continue
        for pack in (True, False):
            for exact_int in (True, False):
                specs.append(ring_range_spec(data, samples, num_samples, block_size, pack,
                                             exact_int))
        specs.append(ring_range_spec(data, samples, num_samples, block_size, False, False,
                                     counts=True))
        specs.append(devicegen_range_spec(data, samples, num_samples, block_size))
    for hosts, per_host in topologies:
        if hosts * per_host < 2:
            continue
        for exact_int in (True, False):
            specs.append(hier_range_spec(hosts, per_host, num_samples, block_size, True,
                                         exact_int))
        specs.append(devicegen_hier_range_spec(hosts, per_host, num_samples, block_size))
    return specs


@dataclass
class RangesReport:
    """Every kernel audit of one ``graftcheck ranges`` run."""

    audits: List[RangeAudit] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(a.ok for a in self.audits)

    @property
    def findings(self) -> List[Finding]:
        return [f for a in self.audits for f in a.findings]

    def to_json(self) -> str:
        return json.dumps(
            {
                "tool": "graftcheck-ranges",
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
                head = a.facts.get("exactness_headroom_sites", {})
                lines.append(
                    f"  proved: {a.name}: partial ≤ "
                    f"{a.facts.get('dot_partial_bound', 0):g}, entry "
                    f"increment ≤ {a.facts.get('entry_increment', 0):g}"
                    f"/flush (projection "
                    f"{a.facts.get('flush_projection', 0)}), headroom "
                    f"f32 {head.get('float32', 0)} / int32 "
                    f"{head.get('int32', 0)} sites"
                )
            else:
                for f in a.findings:
                    lines.append(f"  {f.format()}")
        verdict = "clean" if self.ok else f"{len(self.findings)} finding(s)"
        lines.append(f"graftcheck ranges: {len(self.audits)} kernel(s), {verdict}")
        return "\n".join(lines)


def run_audit(specs: Optional[Sequence[RangeKernelSpec]] = None) -> RangesReport:
    """Audit ``specs`` (default: the shipped matrix). CPU and ``meta``
    tensors only: no CUDA context is made (test-asserted)."""
    report = RangesReport()
    for spec in specs if specs is not None else default_specs():
        report.audits.append(audit_range_kernel(spec))
    return report


__all__ = [
    "AbsVal",
    "DEFAULT_MESHES",
    "Prover",
    "RangeAudit",
    "RangeKernelSpec",
    "RangesReport",
    "TOP",
    "audit_range_kernel",
    "contract_val",
    "counts_range_spec",
    "default_specs",
    "dense_range_spec",
    "devicegen_hier_range_spec",
    "devicegen_range_spec",
    "hier_range_spec",
    "ring_range_spec",
    "run_audit",
    "stacked_range_spec",
]
