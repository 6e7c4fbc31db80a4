"""Dense similarity-matrix (Gramian) accumulation of host-fed rows, on one
CUDA card.

The port of the dense half of ``spark_examples_tpu/ops/gramian.py``: the
accumulator behind the packed and wire ingest arms of ``variants-pca`` and
behind ``api.py``. The reference computes the pair-counting similarity of
``VariantsPca.scala:222-231`` as

    G = Xᵀ X,   X ∈ {0,1}^(V×N),  X[v, s] = sample s has variation at v

so the host stages variant rows into fixed blocks, ships each block to the
card bit-packed (``np.packbits``: 8 genotypes a byte, ⅛ the bytes of
uint8), and the card unpacks it and adds its ``XᵀX`` to the resident G.
Count-valued rows (a variant set joined with itself, where a column holds
its multiplicity) cannot be bit-packed and ship as uint8.

One hand-written CUDA kernel is new here (``csrc/gramian.cu``), behind a
wrapper with a launch counter and a plain PyTorch version beside it:

- :func:`unpack_rows_t` — a shipped block (bit-packed or count-valued) into
  the zero-padded int8 Xᵀ that ``ops/devicegen.py:gram_accumulate`` takes;

and the product is PR 1's tensor-core kernel, ``gram_accumulate``.
:func:`dense_update` and :func:`dense_update_counts` are the counterparts
of the reference's ``_dense_update`` and ``_dense_update_counts``; they
update G in place (the reference returns a new G).

The accumulator is int32 from its first flush, on the card and on the CPU:
int8 × int8 → int32 is the reference's own exact path
(``_operand_dtypes(True)``), so every entry equals the reference's and only
the dtype differs from its default float32. Its f32 → int32 switch
(``_maybe_switch_accumulator``) therefore has nothing to switch; the
accumulator instead raises before a flush could carry an entry past int32.

On a mesh (``parallel/mesh.py``) two more strategies run here, the port of
the reference's mesh half:

- the dense accumulator with a ``data`` axis: each data slice takes its
  share of every flush into its own partial Gramian, summed at finalize by
  :func:`data_axis_sum` (int64 past one slice, as the reference promotes);
- :class:`ShardedGramianAccumulator`: the Gramian as row tiles over the
  ``samples`` axis. Each flush's column tiles circulate around the ring
  (:func:`ring_pass`), bit-packed by default, and every position adds its
  ``X_mineᵀ·X_owner`` into its row tile with ``cross_accumulate``
  (``ops/devicegen.py``). The device-generation ring
  (``ops/devicegen.py:DeviceGenRingGramianAccumulator``) packs its
  generated columns with the second kernel of this module,
  :func:`pack_rows_t`, the exact inverse of :func:`unpack_rows_t`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import time
from collections import deque
from typing import Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_examples_tpu_torch.obs import schedule as _schedule
from spark_examples_tpu_torch.obs.metrics import (
    GRAMIAN_ENTRY_MAX,
    GRAMIAN_INFLIGHT_DISPATCHES,
    GRAMIAN_RING_BYTES,
    GRAMIAN_RING_FLUSH_SECONDS,
    GRAMIAN_STATIC_ENTRY_BOUND,
    well_known_counter,
    well_known_gauge,
)
from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.ops.contracts import flush_entry_increment
from spark_examples_tpu_torch.ops.devicegen import (
    COL_TILE,
    SITE_TILE,
    _require,
    _round_up,
    cross_accumulate,
    gram_accumulate,
)
from spark_examples_tpu_torch.parallel.collectives import (
    consume,
    rank_group,
    rank_reduce,
    record,
    ring_shift,
)
from spark_examples_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SAMPLES_AXIS,
    Mesh,
    Position,
    RowSharded,
    Topology,
    flat_traffic_split,
    hierarchical_traffic_bytes,
    home_device,
    host_value,
    padded_cohort,
    resolve_hier_hosts,
    resolve_reduce_schedule,
    ring_traffic_bytes,
    run_on,
    spans_processes,
)
from spark_examples_tpu_torch.utils.device import DeviceLike, resolve_device, synchronizer

#: Largest count the int8 Xᵀ holds.
MAX_INT8_COUNT = 127
_INT32_MAX = (1 << 31) - 1

# Dense strategy memory rule (``spark_examples_tpu/ops/gramian.py:141-164``):
# about _DENSE_BUFFERS N×N accumulator-dtype buffers at peak (G, the
# centered copy, eigensolve temporaries) must fit DENSE_HBM_FRACTION of the
# device's memory.
DENSE_HBM_FRACTION = 0.8
_DENSE_BUFFERS = 4
#: The reference's default when a device reports no memory (a v5e's 16
#: GiB); the port's CPU runs use it too, so the strategy decision of a test
#: on the CPU is the reference's.
_DEFAULT_DEVICE_BYTES = 16 << 30


def per_device_memory_bytes(device: DeviceLike = "cpu") -> int:
    """The device's memory budget: ``torch.cuda.mem_get_info``'s total on
    the card, the reference's 16 GiB default on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return _DEFAULT_DEVICE_BYTES


def dense_strategy_fits(
    n_columns: int, accum_bytes: int = 4, device: DeviceLike = "cpu"
) -> bool:
    """Whether an ``n_columns``² accumulator, with its working copies, fits
    the device's memory — the reference's dense/sharded predicate."""
    need = _DENSE_BUFFERS * int(n_columns) ** 2 * accum_bytes
    return need <= DENSE_HBM_FRACTION * per_device_memory_bytes(device)


# ----------------------------------------------------------------- kernel


def _packed_width(num_columns: int) -> int:
    return -(-int(num_columns) // 8)


def unpack_bits(packed: torch.Tensor, num_columns: int) -> torch.Tensor:
    """Bit-packed bytes (np.packbits' big-endian order, as
    ``_unpack_bits``) along the last axis as int32 {0,1} columns, the bits
    past ``num_columns`` dropped."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1  # range: packed bytes are uint8 (0..255), exact in int32
    return bits.reshape(*packed.shape[:-1], -1)[..., :num_columns]


def unpack_rows_t_plain(
    block: torch.Tensor, num_columns: int, counts: bool = False
) -> torch.Tensor:
    """Plain version of :func:`unpack_rows_t`: shifts and masks in PyTorch
    (:func:`unpack_bits`), transposed into a zero-padded int8 Xᵀ."""
    rows = block.shape[0]
    X = block[:, :num_columns] if counts else unpack_bits(block, num_columns)
    xt = torch.zeros(
        (_round_up(num_columns, COL_TILE), _round_up(max(rows, 1), SITE_TILE)),
        dtype=torch.int8,
        device=block.device,
    )
    xt[:num_columns, :rows] = X.T.to(torch.int8)  # range: {0,1} bits, or counts <= MAX_INT8_COUNT (unpack_rows_t refuses more), exact in int8
    return xt


@functools.lru_cache(maxsize=None)
def _library():
    """The unpack kernel's library, its site tiling checked against the
    padding of this module."""
    lib = _kernels.library("gramian.cu")
    if SITE_TILE % lib.gramian_tile_sites():
        raise RuntimeError("csrc/gramian.cu tiling does not divide SITE_TILE")
    return lib


def unpack_rows_t(
    block: torch.Tensor,
    num_columns: int,
    counts: bool = False,
    max_count: Optional[int] = None,
) -> torch.Tensor:
    """One shipped block of B variant rows as the int8 Xᵀ of
    ``gram_accumulate``: ``(round_up(N, 128), round_up(B, 128))``, columns ×
    sites, zero past N columns and B sites.

    ``block`` is ``(B, ceil(N/8))`` uint8 bit-packed rows (np.packbits,
    big-endian: bit 7 of byte j is column 8j; the last byte's unused low
    bits are ignored), or with ``counts`` ``(B, N)`` uint8 count-valued
    rows. A count above 127 raises (int8 cannot hold it); ``max_count``
    passes a maximum the caller has measured, saving the device read.

    Replaces the unpack of ``spark_examples_tpu/ops/gramian.py:
    _dense_update`` (``_unpack_bits``) and the cast of
    ``_dense_update_counts``. CPU tensors take :func:`unpack_rows_t_plain`;
    CUDA tensors launch ``unpack_rows_t_kernel`` (``csrc/gramian.cu``)."""
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        return recording.launch(unpack_rows_t, "unpack", (block,), (), block, num_columns,
                                counts, max_count, packed=not counts,
                                support=int(block.shape[0]))
    width = int(num_columns) if counts else _packed_width(num_columns)
    _require(block, "block", torch.uint8)
    if block.ndim != 2 or block.shape[1] != width:
        raise ValueError(
            f"block must be (B, {width}) uint8 for {num_columns} columns "
            f"({'counts' if counts else 'bit-packed'}), got {tuple(block.shape)}"
        )
    if counts and block.numel():
        top = int(block.max()) if max_count is None else int(max_count)
        if top > MAX_INT8_COUNT:
            raise ValueError(
                f"count {top} does not fit the int8 Xᵀ (at most {MAX_INT8_COUNT})"
            )
    if block.device.type in _kernels.PLAIN_DEVICES:
        return unpack_rows_t_plain(block, num_columns, counts)
    rows = int(block.shape[0])
    n_pad = _round_up(num_columns, COL_TILE)
    ld = _round_up(max(rows, 1), SITE_TILE)
    xt = torch.empty((n_pad, ld), dtype=torch.int8, device=block.device)
    lib = _library()
    with torch.cuda.device(block.device):
        status = lib.unpack_rows_t_launch(
            block.data_ptr(),
            rows,
            width,
            int(num_columns),
            int(not counts),
            xt.data_ptr(),
            n_pad,
            ld,
            torch.cuda.current_stream(block.device).cuda_stream,
        )
    _kernels.check(status, "unpack_rows_t")
    unpack_rows_t.launches += 1
    return xt


unpack_rows_t.launches = 0  # type: ignore[attr-defined]


def pack_rows_t_plain(
    xt: torch.Tensor, num_columns: int, rows: Optional[int] = None
) -> torch.Tensor:
    """Plain version of :func:`pack_rows_t`: the bits of the transposed
    columns shifted into place and summed, in PyTorch."""
    rows = int(xt.shape[1]) if rows is None else int(rows)
    bits = (xt[:num_columns, :rows] != 0).T.to(torch.int32)  # range: a comparison's {0,1}, exact in int32
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=xt.device)
    grouped = bits.reshape(rows, num_columns // 8, 8) << shifts
    return grouped.sum(dim=-1).to(torch.uint8)  # range: the disjoint shifted bits of one byte sum to at most 255, exact in uint8


#: Sites a ``pack_rows_t`` block takes, the most bytes of an output row it
#: stages, its warps, and the groups of 32 columns a warp takes from which
#: it keeps ``PACK_DEEP`` groups' loads in flight, not one
#: (``csrc/gramian.cu``).
PACK_SITES = 32
PACK_MAX_BYTES = 1536
PACK_WARPS = 8
PACK_DEEP_GROUPS = 4
PACK_DEEP = 2


class PackSchedule(NamedTuple):
    """One ``pack_rows_t`` launch (``csrc/gramian.cu:pack_rows_t_shape``)."""

    site_blocks: int  #: blocks along the sites, ``PACK_SITES`` each
    row_blocks: int  #: blocks along an output row: 1 up to ``PACK_MAX_BYTES``
    share: int  #: bytes of an output row a block takes
    sites: int  #: sites a block takes
    depth: int  #: groups of 32 columns whose loads a warp keeps in flight


def pack_schedule(rows: int, num_columns: int) -> PackSchedule:
    """The launch of a :func:`pack_rows_t` of ``rows`` sites and
    ``num_columns`` columns: a block takes ``PACK_SITES`` sites × every byte
    of their output rows (so its output is one contiguous range), or
    ``PACK_MAX_BYTES`` of each where the rows are wider; a warp whose
    groups of 32 columns number ``PACK_DEEP_GROUPS`` or more keeps
    ``PACK_DEEP`` groups' loads in flight (6,256 columns: 25 groups a
    warp), else one (632 columns: 3)."""
    width = int(num_columns) // 8
    share = min(width, PACK_MAX_BYTES)
    per_warp = -(-(-(-share // 4)) // PACK_WARPS)
    return PackSchedule(-(-int(rows) // PACK_SITES), -(-width // share) if share else 0, share,
                        PACK_SITES, PACK_DEEP if per_warp >= PACK_DEEP_GROUPS else 1)


def pack_rows_t_grid(rows: int, num_columns: int) -> PackSchedule:
    """``pack_rows_t_kernel``'s launch from the C library; raises unless it
    is :func:`pack_schedule`'s."""
    grid = (ctypes.c_int * 5)()
    _kernels.check(_library().pack_rows_t_grid(int(rows), int(num_columns), grid), "pack_rows_t_grid")
    got = PackSchedule(*grid)
    if got != pack_schedule(rows, num_columns):
        raise RuntimeError(f"csrc/gramian.cu packs {rows} x {num_columns} as {got}, "
                           f"ops/gramian.py:pack_schedule as {pack_schedule(rows, num_columns)}")
    return got


def pack_rows_t(xt: torch.Tensor, num_columns: int, rows: Optional[int] = None) -> torch.Tensor:
    """The first ``num_columns`` columns of an int8 {0,1} Xᵀ (``(n_pad,
    ld)``, columns × sites) as bit-packed rows: ``(rows, num_columns / 8)``
    uint8 in np.packbits' big-endian order, a nonzero entry a 1, for the
    first ``rows`` sites (default all ``ld``). ``num_columns`` is a
    multiple of 8 (a position's column width on the packed ring wire):
    :func:`unpack_rows_t` of the result gives the Xᵀ back.

    Replaces ``spark_examples_tpu/ops/gramian.py:_pack_bits_device``. CPU
    tensors take :func:`pack_rows_t_plain`; CUDA tensors launch
    ``pack_rows_t_kernel`` (``csrc/gramian.cu``)."""
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        return recording.launch(pack_rows_t, "pack", (xt,), (), xt, num_columns, rows,
                                packed=True)
    _require(xt, "xt", torch.int8)
    num_columns = int(num_columns)
    rows = int(xt.shape[1]) if rows is None else int(rows)
    if num_columns % 8 or xt.ndim != 2 or xt.shape[0] < num_columns or not 0 <= rows <= xt.shape[1]:
        raise ValueError(
            f"pack_rows_t takes a multiple of 8 columns of an Xᵀ that holds them "
            f"and at most its sites: {num_columns} columns, {rows} rows of {tuple(xt.shape)}"
        )
    if xt.device.type in _kernels.PLAIN_DEVICES:
        return pack_rows_t_plain(xt, num_columns, rows)
    n_pad, ld = xt.shape
    if n_pad % COL_TILE or ld % SITE_TILE or xt.data_ptr() % 16:
        raise ValueError(
            f"xt must be ({COL_TILE}k, {SITE_TILE}j) on a 16-byte boundary, got {tuple(xt.shape)}"
        )
    out = torch.empty((rows, num_columns // 8), dtype=torch.uint8, device=xt.device)
    with torch.cuda.device(xt.device):
        status = _library().pack_rows_t_launch(
            xt.data_ptr(), n_pad, ld, num_columns, rows, out.data_ptr(),
            torch.cuda.current_stream(xt.device).cuda_stream,
        )
    _kernels.check(status, "pack_rows_t")
    pack_rows_t.launches += 1
    return out


def transpose_rows_t_plain(
    xt: torch.Tensor, num_columns: int, rows: Optional[int] = None
) -> torch.Tensor:
    """Plain version of :func:`transpose_rows_t`: the transposed slice
    copied, in PyTorch."""
    rows = int(xt.shape[1]) if rows is None else int(rows)
    return xt[:num_columns, :rows].T.contiguous().view(torch.uint8)


def transpose_rows_t(xt: torch.Tensor, num_columns: int, rows: Optional[int] = None) -> torch.Tensor:
    """The first ``num_columns`` columns of an int8 Xᵀ (``(n_pad, ld)``,
    columns × sites) as the unpacked ring wire's rows: ``(rows,
    num_columns)`` uint8, row s holding site s's entries as they are, for
    the first ``rows`` sites (default all ``ld``). :func:`unpack_rows_t`
    with ``counts`` gives the Xᵀ back.

    Replaces the cast the reference's device-generation ring ships on its
    unpacked wire (``spark_examples_tpu/ops/devicegen.py:1082``). CPU and
    ``meta`` tensors take :func:`transpose_rows_t_plain`; CUDA tensors
    launch ``transpose_rows_t_kernel`` (``csrc/gramian.cu``)."""
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        return recording.launch(transpose_rows_t, "pack", (xt,), (), xt, num_columns, rows)
    _require(xt, "xt", torch.int8)
    num_columns = int(num_columns)
    rows = int(xt.shape[1]) if rows is None else int(rows)
    if xt.ndim != 2 or not 0 <= num_columns <= xt.shape[0] or not 0 <= rows <= xt.shape[1]:
        raise ValueError(
            f"transpose_rows_t takes at most the columns and sites of its Xᵀ: "
            f"{num_columns} columns, {rows} rows of {tuple(xt.shape)}"
        )
    if xt.device.type in _kernels.PLAIN_DEVICES:
        return transpose_rows_t_plain(xt, num_columns, rows)
    n_pad, ld = xt.shape
    if n_pad % COL_TILE or ld % SITE_TILE or xt.stride() != (ld, 1) or xt.data_ptr() % 4:
        raise ValueError(
            f"xt must be a contiguous ({COL_TILE}k, {SITE_TILE}j) int8 on a 4-byte boundary, "
            f"got {tuple(xt.shape)}"
        )
    out = torch.empty((rows, num_columns), dtype=torch.uint8, device=xt.device)
    with torch.cuda.device(xt.device):
        status = _library().transpose_rows_t_launch(
            xt.data_ptr(), n_pad, ld, num_columns, rows, out.data_ptr(),
            torch.cuda.current_stream(xt.device).cuda_stream,
        )
    _kernels.check(status, "transpose_rows_t")
    transpose_rows_t.launches += 1
    return out


pack_rows_t.launches = 0  # type: ignore[attr-defined]
transpose_rows_t.launches = 0  # type: ignore[attr-defined]

#: Every kernel wrapper of this module, for launch accounting.
KERNELS = (unpack_rows_t, pack_rows_t, transpose_rows_t)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0  # type: ignore[attr-defined]


def dense_update(G: torch.Tensor, X_packed: torch.Tensor, num_samples: int) -> None:
    """``G += XᵀX`` in place for one bit-packed block — the counterpart of
    ``spark_examples_tpu/ops/gramian.py:_dense_update``."""
    gram_accumulate(G, unpack_rows_t(X_packed, num_samples))


def dense_update_counts(
    G: torch.Tensor, X: torch.Tensor, max_count: Optional[int] = None
) -> None:
    """``G += XᵀX`` in place for one count-valued uint8 block (a same-set
    join adds k² for a column present k times) — the counterpart of
    ``_dense_update_counts``."""
    gram_accumulate(
        G, unpack_rows_t(X, G.shape[0], counts=True, max_count=max_count)
    )


def resolve_ring_pack(pack_bits: str) -> bool:
    """``--ring-pack-bits`` → whether the ring circulates bit-packed tiles:
    ``off`` keeps the int8 tiles (the unpacked wire), ``on`` and ``auto``
    pack."""
    if pack_bits not in ("auto", "on", "off"):
        raise ValueError(f"--ring-pack-bits must be one of auto/on/off, got {pack_bits!r}")
    return pack_bits != "off"


def data_axis_sum(
    parts: Sequence[Optional[torch.Tensor]],
    like=None,
    shared: bool = False,
) -> torch.Tensor:
    """The sum of a data axis's partial accumulators, on the first held
    one's device. Past one slice an integer sum is int64: each slice's
    int32 is bounded by its own sites, the total is not (the reference's
    rule). One slice is returned as it is.

    On a ``shared`` mesh (the partials of other processes' slices
    ``None`` here) this process's sum joins a sum over every process, so
    each ends with the whole; ``like`` (shape, dtype of a partial) shapes
    the zero share of a process that holds none."""
    parts = list(parts)
    if len(parts) == 1 and not shared:
        return parts[0]
    held = [p for p in parts if p is not None]
    base = held[0].dtype if held else like[1]
    dtype = base if base.is_floating_point or len(parts) == 1 else torch.int64
    if held:
        total = held[0].to(dtype=dtype, copy=True)
        for part in held[1:]:
            total += part.to(device=total.device, dtype=dtype)
    else:
        total = torch.zeros(like[0], dtype=dtype, device=home_device())
    return rank_reduce(total) if shared else total


class _InFlight:
    """Bounds the work a host loop leaves queued on a mesh's streams: after
    each unit (a flush, a block) it records an event on every position and
    waits for the events of the unit ``depth`` units back, so tiles and
    transient buffers cannot pile up on the card."""

    def __init__(self, positions: Sequence[Position], depth: int = 2):
        self.positions = [p for p in positions if p.cuda]
        self.depth = int(depth)
        self._events: deque = deque()

    def mark(self) -> None:
        if not self.positions:
            return
        self._events.append([record(p) for p in self.positions])
        while len(self._events) > self.depth:
            for event in self._events.popleft():
                event.synchronize()  # graftcheck: disable=GC007 -- this IS the bounded in-flight window the rule recommends: waits only for the step marked depth steps ago (one event a mesh position), never the step just launched

    def drain(self) -> None:
        for events in self._events:
            for event in events:
                event.synchronize()  # graftcheck: disable=GC007 -- the drain at a join point (snapshot, finalize): every position's pending events once, not per block
        self._events.clear()


# ------------------------------------------------------------ accumulator


class _AccumulatorTelemetry:
    """Flush instrumentation: unlabeled ``gramian_flushes_total`` /
    ``gramian_rows_total`` counters (a run has one strategy, so the
    reference's ``strategy`` label is left out), the
    ``gramian_flush_seconds`` histogram of host time per flush and the
    in-flight gauge the heartbeat reads; with ``ring``, the
    ``gramian_ring_bytes`` counter and ``gramian_ring_flush_seconds``
    histogram. At finalize the accumulated host-side flush time attaches to
    the open span tree as one ``dispatch`` span, and the drain of the card
    runs under ``reduce-flush``. Under ``--check-ranges``,
    :meth:`record_entry_sample` keeps ``entry_max_seen``."""

    def __init__(self, registry, spans, ring: bool = False):
        self.spans = spans
        self.flush_seconds_total = 0.0
        self.entry_max_seen = 0
        self._registry = registry
        self._flushes = self._rows = self._seconds = self._inflight = None
        self._ring_bytes = self._ring_seconds = None
        if registry is not None and ring:
            self._ring_bytes = well_known_counter(registry, GRAMIAN_RING_BYTES)
            self._ring_seconds = registry.histogram(
                GRAMIAN_RING_FLUSH_SECONDS,
                "Host-side seconds per ring-exchange flush (pack + copies to "
                "the card + ring launches).",
            )
        if registry is not None:
            self._flushes = registry.counter(
                "gramian_flushes_total",
                "Device flushes (one unpack and one G += XᵀX update each).",
            )
            self._rows = registry.counter(
                "gramian_rows_total", "Variant rows accumulated into the Gramian."
            )
            self._seconds = registry.histogram(
                "gramian_flush_seconds",
                "Host-side time per flush (pack + copy to the card + launches).",
            )
            self._inflight = well_known_gauge(registry, GRAMIAN_INFLIGHT_DISPATCHES)

    def record_flush(self, rows: int, seconds: float, in_flight: int) -> None:
        self.flush_seconds_total += seconds
        if self._flushes is not None:
            self._flushes.inc(1)
            self._rows.inc(rows)
            self._seconds.observe(seconds)
            self._inflight.set(in_flight)

    def record_ring(self, nbytes: int, seconds: float) -> None:
        if self._ring_bytes is not None:
            self._ring_bytes.inc(nbytes)
            self._ring_seconds.observe(seconds)

    def record_entry_sample(self, tiles: Sequence[Optional[torch.Tensor]],
                            entry_bound: int) -> None:
        """``--check-ranges``: the max |entry| of the live accumulator
        (``tiles``: the partials or row tiles this process holds, ``None``
        for another's, each device's current stream ordered after their
        work) beside the static bound the flushes projected
        (``ops/contracts.py:flush_entry_increment`` summed) — the runtime
        half of ``graftcheck ranges``. The pair lands in the
        ``gramian_entry_max`` / ``gramian_static_entry_bound`` gauges and
        from there in the run manifest."""
        held = [t for t in tiles if t is not None]
        if held:
            home = held[0].device
            peak = torch.stack([t.abs().amax().to(home) for t in held]).amax()
            sample = int(peak)  # graftcheck: disable=GC001 -- deliberate per-flush device read: --check-ranges is an opt-in DEBUG mode whose whole point is sampling the live accumulator (off by default, documented in the flag help)
            self.entry_max_seen = max(self.entry_max_seen, sample)
        if self._registry is not None:
            well_known_gauge(self._registry, GRAMIAN_ENTRY_MAX).set(self.entry_max_seen)
            well_known_gauge(self._registry, GRAMIAN_STATIC_ENTRY_BOUND).set(entry_bound)

    def finalize_span(self, sync):
        if self.spans is None:
            return contextlib.nullcontext()
        self.spans.add("dispatch", self.flush_seconds_total)
        return self.spans.span("reduce-flush", sync=sync)


class _Staging:
    """Host staging shared by the host-fed accumulators: rows land in a
    reused ``(data × block_size, width)`` uint8 buffer (``width`` at least
    ``num_samples``: the sharded cohort is padded) and a full buffer
    flushes."""

    def add_rows(self, rows: np.ndarray) -> None:
        """Stage host rows; flush full blocks to the device."""
        rows = np.asarray(rows, dtype=np.uint8)
        if rows.ndim != 2 or rows.shape[1] != self.num_samples:
            raise ValueError(
                f"expected (b, {self.num_samples}) rows, got {rows.shape}"
            )
        self.rows_seen += rows.shape[0]
        offset = 0
        capacity = self._staging.shape[0]
        while offset < rows.shape[0]:
            take = min(capacity - self._fill, rows.shape[0] - offset)
            self._staging[self._fill : self._fill + take, : self.num_samples] = rows[
                offset : offset + take
            ]
            self._fill += take
            offset += take
            if self._fill == capacity:
                self._flush()


class GramianAccumulator(_Staging):
    """Dense strategy: the resident int32 N×N Gramian, one per data slice.

    Feed host ``(b, N)`` uint8 rows with :meth:`add_rows`; full blocks of
    ``block_size`` rows a data slice flush to the device, bit-packed when
    every entry is 0/1 and count-valued otherwise. :meth:`finalize_device`
    flushes the ragged tail and returns G on the device.

    ``mesh`` adds the reference's ``data`` axis: a flush stages
    ``data × block_size`` rows and slice d takes rows ``[d·B, (d+1)·B)``
    into its own partial on its position (the first of each data slice; a
    samples axis holds replicas in the reference, so only one of them works
    here), summed by :func:`data_axis_sum` at finalize. Without a mesh the
    work runs on ``device``'s current stream. On a mesh that spans
    processes every process stages the same rows and flushes only its own
    slices; the finalize sum runs across processes.

    ``pipeline_depth`` bounds the flushes in flight: ``None`` waits for
    each flush's work before the next (the reference's default
    ``sync_every=1``); ``d`` waits only for the flush issued ``d`` flushes
    ago, so host packing of block k+1 overlaps the card's work on block k.
    On the card every shipped block is first copied into fresh pinned
    memory and then sent asynchronously, so the reused staging buffer is
    never the source of a copy in flight. ``check_ranges`` samples the max
    |entry| after every flush (``--check-ranges``: one device read a
    flush).
    """

    def __init__(
        self,
        num_samples: int,
        device: DeviceLike = None,
        block_size: int = 1024,
        pipeline_depth: Optional[int] = None,
        registry=None,
        spans=None,
        mesh: Optional[Mesh] = None,
        check_ranges: bool = False,
    ):
        self.mesh = mesh
        self.check_ranges = bool(check_ranges)
        self._slices: List[Optional[Position]] = (
            [ring[0] for ring in mesh.data_slices()] if mesh is not None else [None]
        )
        self.device = mesh.home if mesh is not None else resolve_device(device)
        self.data_parallel = len(self._slices)
        self.telemetry = _AccumulatorTelemetry(registry, spans)
        self.num_samples = int(num_samples)
        self.block_size = int(block_size)
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.pipeline_depth = (
            None if pipeline_depth is None else max(1, int(pipeline_depth))
        )
        self._in_flight: List[List[torch.cuda.Event]] = []
        self._entry_bound = 0
        self._staging = np.zeros(
            (self.data_parallel * self.block_size, self.num_samples), dtype=np.uint8
        )
        self._fill = 0
        self._flushes = 0
        self.rows_seen = 0
        #: One partial a data slice (``None`` for another process's).
        self._parts: List[Optional[torch.Tensor]] = []
        for position in self._slices:
            if position is not None and not position.local:
                self._parts.append(None)
                continue
            with run_on(position):
                self._parts.append(torch.zeros(
                    (self.num_samples, self.num_samples), dtype=torch.int32,
                    device=self.device if position is None else position.device,
                ))

    @property
    def G(self) -> torch.Tensor:
        """The Gramian so far: the one slice's, or the data axis's sum."""
        if self.mesh is None:
            return self._parts[0]
        self._join()
        n = self.num_samples
        return data_axis_sum(self._parts, like=((n, n), torch.int32), shared=self.mesh.shared)

    def _ship(self, host: np.ndarray, device: torch.device) -> torch.Tensor:
        """``host`` on ``device``. On the card through a fresh pinned copy
        and an asynchronous transfer on the current stream; on the CPU the
        plain versions consume it before the staging buffer is written
        again."""
        tensor = torch.from_numpy(host)
        if device.type == "cpu":
            return tensor
        return tensor.pin_memory().to(device, non_blocking=True)

    def _flush(self) -> None:
        if self._fill == 0:
            return
        flush_rows, flush_start = self._fill, time.perf_counter()
        # Only the filled rows ship: zero rows add nothing to XᵀX, and the
        # unpack pads Xᵀ to the product's tiling itself.
        block = self._staging[: self._fill]
        max_count = int(block.max(initial=0))
        increment = flush_entry_increment(self._fill, max_count)
        if self._entry_bound + increment > _INT32_MAX:
            raise OverflowError(
                f"a Gramian entry could pass int32 after this flush (bound "
                f"{self._entry_bound + increment})"
            )
        self._entry_bound += increment
        B = self.block_size
        for d, position in enumerate(self._slices):
            rows = block[d * B : (d + 1) * B]
            if rows.shape[0] == 0:
                break
            if position is not None and not position.local:
                continue
            device = self.device if position is None else position.device
            with run_on(position):
                if max_count > 1:
                    # Count-valued rows (same-set joins) cannot be bit-packed.
                    dense_update_counts(self._parts[d], self._ship(rows, device), max_count=max_count)
                else:
                    dense_update(
                        self._parts[d], self._ship(np.packbits(rows, axis=-1), device),
                        self.num_samples,
                    )
        self._fill = 0
        self._flushes += 1
        if self.device.type == "cuda":
            done = self._record()
            if self.pipeline_depth is None:
                for event in done:
                    event.synchronize()  # graftcheck: disable=GC007 -- pipeline_depth None asks for the reference's synchronous flush (its block_until_ready(self.G)): one event a mesh position of the flush just launched
            else:
                self._in_flight.append(done)
                if len(self._in_flight) > self.pipeline_depth:
                    for event in self._in_flight.pop(0):
                        event.synchronize()  # graftcheck: disable=GC007 -- this IS the bounded in-flight window the rule recommends: waits only for the flush issued pipeline_depth flushes ago (one event a mesh position), never the flush just launched
        if self.check_ranges:
            self._join()
            self.telemetry.record_entry_sample(self._parts, self._entry_bound)
        self.telemetry.record_flush(
            flush_rows, time.perf_counter() - flush_start, len(self._in_flight)
        )

    def _record(self) -> List[torch.cuda.Event]:
        """An event after the work queued so far on each slice's stream."""
        if self.mesh is None:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return [done]
        return [record(position) for position in self._slices if position.local]

    def _join(self) -> None:
        if self.mesh is not None:
            self.mesh.join(self._parts)

    def snapshot_state(self) -> dict:
        """Crash-consistent checkpoint state: flush the staged tail, drain
        the card (every in-flight update finished) and fetch the partial
        Gramian with the accumulator's bookkeeping — what
        :meth:`restore_state` needs to rebuild it mid-stream in a fresh
        process. G is saved as the reference's ``(data_parallel, N, N)``
        stack, int32 (the reference climbs to int32 on resume). The fetch
        is periodic (``--checkpoint-every-sites``), not a hot-path sync."""
        self._flush()
        self._join()
        if self.device.type == "cuda":
            for part in self._parts:
                torch.cuda.synchronize(part.device)  # graftcheck: disable=GC007 -- deliberate checkpoint barrier: the snapshot must capture a quiesced accumulator (no in-flight updates), at --checkpoint-every-sites cadence, not per flush; one sync a device part
        self._in_flight.clear()
        return {
            "strategy": "dense",
            "G": np.stack([part.cpu().numpy() for part in self._parts]),  # graftcheck: disable=GC001 -- deliberate periodic checkpoint fetch of the partial Gramian (the artifact payload); cadence is --checkpoint-every-sites, not the dispatch loop
            "accum_dtype": "int32",
            "exact_int": True,
            "entry_bound": self._entry_bound,
            "rows_seen": self.rows_seen,
            "flushes": self._flushes,
            "num_samples": self.num_samples,
            "data_parallel": self.data_parallel,
            "padded": self.num_samples,
        }

    def restore_state(self, checkpoint: dict) -> None:
        """Merge a persisted partial into this (fresh, empty) accumulator:
        load the saved G and restore the cursor bookkeeping. An artifact may
        hold one partial per data-parallel slice of the run that wrote it
        (summed here into the first slice: G is additive over any split of
        the rows) and float32 entries (exact integers below 2^24, cast to
        int32 without loss). Geometry mismatches fail loudly — the conf
        fingerprint should have caught them already; this is the shape
        check behind it."""
        meta, G = checkpoint["meta"], np.asarray(checkpoint["G"])
        if meta["strategy"] != "dense":
            raise ValueError(
                f"checkpoint was written by the {meta['strategy']!r} "
                "strategy; this run resolved dense — the similarity "
                "strategy is part of the checkpoint geometry"
            )
        n = self.num_samples
        if G.ndim != 3 or G.shape[1:] != (n, n):
            raise ValueError(
                f"checkpoint Gramian shape {tuple(G.shape)} != this run's "
                f"(data_parallel, {n}, {n}) (the cohort width changed)"
            )
        total = _exact_int32_sum(G)
        for position, part, values in zip(
            self._slices, self._parts, [total] + [np.zeros_like(total)] * (len(self._parts) - 1)
        ):
            with run_on(position):
                part.copy_(torch.from_numpy(values))
        self._entry_bound = int(meta["entry_bound"])
        self.rows_seen = int(meta["rows_seen"])
        self._flushes = int(meta["flushes"])

    def finalize_device(self) -> torch.Tensor:
        """Flush the ragged tail and return the Gramian, still on the
        device: int32 on one slice, int64 summed over a data axis. Under the
        ``reduce-flush`` span the card drains its queue."""
        self._flush()
        self._in_flight.clear()
        with self.telemetry.finalize_span(synchronizer(self.device)):
            return self.G

    def finalize(self) -> np.ndarray:
        """Host float64 copy of :meth:`finalize_device` (tests, host use)."""
        return self.finalize_device().cpu().numpy().astype(np.float64)  # graftcheck: disable=GC001 -- one host copy of the finished Gramian (tests, host use), not a per-block sync


def _exact_int32_sum(G: np.ndarray) -> np.ndarray:
    """A checkpoint's stack of partial Gramians summed exactly into one
    int32 matrix (float partials must hold exact integers)."""
    if G.dtype.kind == "f" and not np.array_equal(G, np.trunc(G)):
        raise ValueError("checkpoint Gramian entries are not exact integers")
    total = G.astype(np.int64).sum(axis=0)
    if np.abs(total).max(initial=0) > _INT32_MAX:
        raise ValueError("checkpoint Gramian entries do not fit int32")
    return total.astype(np.int32)  # range: the summed entries are checked against _INT32_MAX just above


# ------------------------------------------------------------------- ring


def ring_pass(
    positions: Sequence[Position],
    own: Sequence[torch.Tensor],
    ready: Sequence,
    mine: Sequence[torch.Tensor],
    G_local: Sequence[torch.Tensor],
    n_local: int,
    packed: bool,
    hosts: int = 1,
    max_count: Optional[int] = None,
) -> None:
    """One block's ring over one data slice's samples positions: the
    counterpart of ``spark_examples_tpu/ops/gramian.py:_ring_tiles``
    (``hosts`` 1) and ``_hier_ring_tiles``.

    Position p holds ``mine[p]``, its own columns' int8 Xᵀ (the product's A
    operand), and ``own[p]``, the tile it sends (``ready[p]``: the event
    after which it is whole): its block's rows, ``(B, n_local / 8)``
    bit-packed under ``packed`` or ``(B, n_local)`` count-valued uint8
    (counts at most ``max_count``), which a receiver unpacks
    (``unpack_rows_t``), so the wire moves the bytes of
    ``parallel/mesh.py:ring_traffic_bytes``. At every step each position
    adds ``Xᵀ_mine · X_owner`` into its row tile's owner columns
    (``cross_accumulate``); its own step uses ``mine[p]`` as both operands.

    The samples axis is factored host-major into ``hosts × D``: an outer
    ring over hosts (``hosts - 1`` shifts of the tile a position started
    the outer step with) around inner rings over the ``D`` positions of a
    host (``D - 1`` shifts an outer step). At outer step k and inner step j
    position (h, d) holds the tile of ``((h + k) mod H)·D + (d + j) mod
    D``. ``hosts`` 1 is the flat ring. Each shift is issued before the
    products of the step before it, so on a card the transfer runs behind
    them.

    On a ring that spans processes each process passes its own positions'
    operands (``None`` for the others') and runs their products; the hops
    between processes are ``ring_shift``'s paired sends and receives.
    With ``hosts`` the process count, the inner rings stay inside one
    process and only the outer ring crosses."""
    S = len(positions)
    H = int(hosts)
    D = S // H

    def step(tiles, events, k, j):
        for p, pos in enumerate(positions):
            if not pos.local:
                continue
            h, d = divmod(p, D)
            owner = ((h + k) % H) * D + (d + j) % D
            cols = G_local[p][:, owner * n_local : (owner + 1) * n_local]
            with pos.run():
                if owner == p:
                    cross_accumulate(cols, mine[p], mine[p])
                    continue
                consume(pos, tiles[p], events[p])
                b = unpack_rows_t(tiles[p], n_local, counts=not packed, max_count=max_count)
                cross_accumulate(cols, mine[p], b)

    outer, outer_ready = list(own), list(ready)
    for k in range(H):
        if k < H - 1:
            nxt_outer = ring_shift(
                outer, outer_ready, positions,
                [((p // D + 1) % H) * D + p % D for p in range(S)],
            )
        cur, cur_ready = outer, outer_ready
        for j in range(D):
            if j < D - 1:
                nxt = ring_shift(
                    cur, cur_ready, positions,
                    [(p // D) * D + (p % D + 1) % D for p in range(S)],
                )
            step(cur, cur_ready, k, j)
            if j < D - 1:
                cur, cur_ready = nxt
        if k < H - 1:
            outer, outer_ready = nxt_outer


class RingLayout:
    """What the two ring accumulators share (this one and
    ``ops/devicegen.py:DeviceGenRingGramianAccumulator``): the
    ``--reduce-schedule`` resolution, the cohort padding, the row tiles
    (one ``(n_local, padded)`` int32 a position, made on its stream), the
    manifest's ``schedule`` block and the finalize. ``auto`` is ``hier``
    when the samples axis spans more than one host — the processes that
    drive the mesh, or the hosts the rehearsal override names; an explicit
    ``hier`` whose host factor does not divide the samples axis raises,
    ``auto``/``flat`` then run the flat ring. On a mesh that spans
    processes a process holds the row tiles of its own positions
    (``None`` for the others') and each ring that spans processes has its
    process group (made here, by every process in the same order)."""

    def __init__(self, mesh: Mesh, columns: int, pack_bits: str, reduce_schedule: str,
                 hier_hosts: Optional[int]):
        if SAMPLES_AXIS not in mesh.shape:
            raise ValueError(f"mesh must have a {SAMPLES_AXIS!r} axis")
        self.mesh = mesh
        self.columns = int(columns)
        self.pack = resolve_ring_pack(pack_bits)
        self.samples_parallel = mesh.shape[SAMPLES_AXIS]
        self.data_parallel = mesh.shape.get(DATA_AXIS, 1)
        resolve_reduce_schedule(reduce_schedule, 1)  # validate the spelling
        try:
            self.hier_hosts = resolve_hier_hosts(
                self.samples_parallel, hier_hosts, hosts=len(mesh.ranks)
            )
        except ValueError:
            if reduce_schedule == "hier":
                raise
            self.hier_hosts = 1
        self.reduce_schedule = resolve_reduce_schedule(reduce_schedule, self.hier_hosts)
        self.ring_hosts = self.hier_hosts if self.reduce_schedule == "hier" else 1
        self.padded = padded_cohort(columns, self.samples_parallel, pack=self.pack)
        self.n_local = self.padded // self.samples_parallel
        self.rings = mesh.data_slices()
        self.groups = [
            rank_group(tuple(sorted({p.rank for p in ring}))) if spans_processes(ring) else None
            for ring in self.rings
        ]
        self.G_local: List[List[Optional[torch.Tensor]]] = []
        for ring in self.rings:
            tiles = []
            for position in ring:
                if not position.local:
                    tiles.append(None)
                    continue
                with position.run():
                    tiles.append(torch.zeros(
                        (self.n_local, self.padded), dtype=torch.int32, device=position.device
                    ))
            self.G_local.append(tiles)
        self.device = mesh.home
        self.in_flight = _InFlight(mesh.local)

    def flush(self, shards: Sequence[Optional[Sequence[Optional[torch.Tensor]]]], packed: bool,
              max_count: Optional[int] = None) -> None:
        """One flush of the host-fed ring: ring d's positions each ship
        their shard of ``shards[d]`` (from :func:`ring_shards`; ``None``
        for a ring with no rows or no position here, and for another
        process's position), unpack it as their Xᵀ and send it as it is,
        and :func:`ring_pass` circulates the shards."""
        for d, ring in enumerate(self.rings):
            if shards[d] is None:
                continue
            own, ready, mine = [], [], []
            for position, shard in zip(ring, shards[d]):
                if shard is None:
                    own.append(None)
                    ready.append(None)
                    mine.append(None)
                    continue
                with position.run():
                    if position.cuda:
                        shard = shard.pin_memory().to(position.device, non_blocking=True)
                    mine.append(unpack_rows_t(shard, self.n_local, counts=not packed,
                                              max_count=max_count))
                    own.append(shard)
                    ready.append(record(position))
            ring_pass(ring, own, ready, mine, self.G_local[d], self.n_local, packed,
                      self.ring_hosts, max_count)

    def schedule(self, rows: int, measured: Optional[int] = None) -> dict:
        """The ``schedule`` block of a ring that circulated ``rows`` rows
        (capacity, padding included): the projected bytes, split by link
        class (the two-level schedule's, or the flat ring's, which a
        multi-host ring cannot prove intra-host), beside ``measured``
        (default: the projection)."""
        per_host = self.samples_parallel // self.hier_hosts
        predicted = ring_traffic_bytes(rows, self.samples_parallel, self.n_local, self.pack)
        if self.reduce_schedule == "hier":
            level = hierarchical_traffic_bytes(rows, self.hier_hosts, per_host, self.n_local, self.pack)
        else:
            level = flat_traffic_split(rows, Topology(self.hier_hosts, per_host), self.n_local, self.pack)
        return {
            "kind": self.reduce_schedule,
            "hosts": int(self.hier_hosts),
            "devices_per_host": int(per_host),
            "predicted_ring_bytes": int(predicted),
            "measured_ring_bytes": int(predicted if measured is None else measured),
            "predicted_ici_bytes": int(level.ici_bytes),
            "predicted_dcn_bytes": int(level.dcn_bytes),
        }

    def host_stack(self) -> np.ndarray:
        """The row tiles on the host as the reference's ``(data_parallel,
        padded, padded)`` stack, after every position's work."""
        self.in_flight.drain()
        self.mesh.join([t for tiles in self.G_local for t in tiles])
        return np.stack([np.concatenate([t.cpu().numpy() for t in tiles]) for tiles in self.G_local])  # graftcheck: disable=GC001 -- deliberate periodic checkpoint fetch of the row tiles (the artifact payload), after the drain; cadence is --checkpoint-every-sites, not the dispatch loop

    def load(self, total: np.ndarray) -> None:
        """Set the first data slice's row tiles to the (padded, padded)
        ``total`` and the other slices' to zero, on the positions' streams."""
        for d, (ring, tiles) in enumerate(zip(self.rings, self.G_local)):
            for s, (position, tile) in enumerate(zip(ring, tiles)):
                with position.run():
                    if d:
                        tile.zero_()
                    else:
                        rows = total[s * self.n_local : (s + 1) * self.n_local]
                        tile.copy_(torch.from_numpy(np.ascontiguousarray(rows)))

    def finalize_tiles(self) -> RowSharded:
        """The row tiles summed over the data axis (int64 past one slice),
        on the first data slice's positions, after every position's work
        (across processes where the slices' positions are driven by
        several)."""
        self.in_flight.drain()
        self.mesh.join([t for tiles in self.G_local for t in tiles])
        data = len(self.rings)
        like = ((self.n_local, self.padded), torch.int32)
        tiles = []
        for s, position in enumerate(self.rings[0]):
            if data == 1:
                tiles.append(self.G_local[0][s])
                continue
            total = data_axis_sum(
                [self.G_local[d][s] for d in range(data)], like=like, shared=self.mesh.shared
            )
            tiles.append(total if position.local else None)
        dtype = torch.int32 if data == 1 else torch.int64
        return RowSharded(tiles, self.rings[0], self.columns, self.padded, dtype, self.mesh.shared)


def ring_shards(layout: RingLayout, block: np.ndarray, block_size: int,
                packed: bool) -> List[Optional[List[Optional[torch.Tensor]]]]:
    """A flush's staged ``(rows, padded)`` uint8 rows as each ring
    position's host shard: ring d takes rows ``[d·B, (d+1)·B)``, and its
    position s the columns ``[s·n_local, (s+1)·n_local)``, bit-packed
    (``np.packbits``, whose byte boundaries fall on the position
    boundaries) under ``packed``. ``None`` for a ring past the rows or
    with no position here, and for another process's position."""
    n_local, B = layout.n_local, int(block_size)
    width = n_local // 8 if packed else n_local
    shards: List[Optional[List[Optional[torch.Tensor]]]] = []
    for d, ring in enumerate(layout.rings):
        rows = block[d * B : (d + 1) * B]
        if rows.shape[0] == 0 or not any(p.local for p in ring):
            shards.append(None)
            continue
        host = np.packbits(rows, axis=-1) if packed else rows
        shards.append([
            torch.from_numpy(np.ascontiguousarray(host[:, s * width : (s + 1) * width]))
            if position.local else None
            for s, position in enumerate(ring)
        ])
    return shards


def sharded_peak_bytes(n_local: int, padded: int, block_size: int, pack: bool) -> int:
    """Device bytes one position of :class:`ShardedGramianAccumulator`
    holds at peak: its int32 row tile ``(n_local, padded)``, and for each of
    the ``_InFlight`` depth's 2 queued flushes its own tile as shipped
    (``block_size`` rows, ``n_local / 8`` bytes packed or ``n_local``
    unpacked), its int8 Xᵀ (``round_up(n_local, COL_TILE) ×
    round_up(block_size, SITE_TILE)``), the received tile and the next one
    in flight, and the received tile's unpacked Xᵀ (:meth:`RingLayout.flush`
    sends shipped rows on either wire). ``graftcheck plan`` reports it as
    ``ring_peak_live_bytes_per_device``."""
    rows = int(block_size)
    wire = rows * (int(n_local) // 8 if pack else int(n_local))
    xt = _round_up(int(n_local), COL_TILE) * _round_up(max(rows, 1), SITE_TILE)
    per_flush = wire + xt + 2 * wire + xt
    return int(n_local) * int(padded) * 4 + 2 * per_flush


class ShardedGramianAccumulator(_Staging):
    """Sharded strategy on host-fed rows: the Gramian as row tiles over the
    ``samples`` axis, a ring per block, an optional ``data`` axis on top
    (the port of ``spark_examples_tpu/ops/gramian.py:
    ShardedGramianAccumulator``).

    A flush of ``data × block_size`` staged rows gives data slice d rows
    ``[d·B, (d+1)·B)``; each position ships its own columns (bit-packed
    under ``pack_bits``, ``np.packbits`` of the padded block, whose byte
    boundaries fall on the position boundaries) and unpacks them as its
    Xᵀ, then :func:`ring_pass` circulates the tiles. Count-valued rows
    (same-set joins) cannot pack and ride the unpacked wire for that flush.
    Ring bytes are counted per flush with the reference's formula over the
    staged capacity (``ring_traffic_bytes``), the wire format of that
    flush: the whole mesh's, hops between processes included. Entries are
    exact int32, as the dense accumulator's. On a mesh that spans
    processes every process stages the same rows and works its own
    positions. ``check_ranges`` samples the max |entry| of this process's
    row tiles after every flush (``--check-ranges``).
    """

    def __init__(
        self,
        num_samples: int,
        mesh: Mesh,
        block_size: int = 1024,
        registry=None,
        spans=None,
        pack_bits: str = "auto",
        reduce_schedule: str = "auto",
        hier_hosts: Optional[int] = None,
        check_ranges: bool = False,
    ):
        self.check_ranges = bool(check_ranges)
        self.num_samples = int(num_samples)
        self.layout = layout = RingLayout(mesh, self.num_samples, pack_bits, reduce_schedule, hier_hosts)
        self.mesh, self.pack, self.padded, self.n_local = mesh, layout.pack, layout.padded, layout.n_local
        self.samples_parallel, self.data_parallel = layout.samples_parallel, layout.data_parallel
        self.reduce_schedule, self.hier_hosts = layout.reduce_schedule, layout.hier_hosts
        self.device = layout.device
        self.telemetry = _AccumulatorTelemetry(registry, spans, ring=True)
        self.block_size = int(block_size)
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self._entry_bound = 0
        self.ring_bytes_total = 0
        self._staging = np.zeros(
            (self.data_parallel * self.block_size, self.padded), dtype=np.uint8
        )
        self._fill = 0
        self._flushes = 0
        self.rows_seen = 0

    def schedule_block(self) -> dict:
        """The manifest's ``schedule`` block: the schedule that ran, its
        host factorisation, the static projection of ring bytes over the
        flushes next to the per-flush accounted total (a counts flush on
        the packed ring moves ``measured`` away from ``predicted``)."""
        return self.layout.schedule(
            self.data_parallel * self.block_size * self._flushes, self.ring_bytes_total
        )

    def _flush(self) -> None:
        if self._fill == 0:
            return
        flush_rows, flush_start = self._fill, time.perf_counter()
        block = self._staging[: self._fill]
        max_count = int(block.max(initial=0))
        increment = flush_entry_increment(self._fill, max_count)
        if self._entry_bound + increment > _INT32_MAX:
            raise OverflowError(
                f"a Gramian entry could pass int32 after this flush (bound "
                f"{self._entry_bound + increment})"
            )
        self._entry_bound += increment
        use_packed = self.pack and max_count <= 1
        layout = self.layout
        layout.flush(ring_shards(layout, block, self.block_size, use_packed), use_packed, max_count)
        self._fill = 0
        self._flushes += 1
        layout.in_flight.mark()
        if self.check_ranges:
            tiles = [t for row in layout.G_local for t in row]
            layout.mesh.join(tiles)
            self.telemetry.record_entry_sample(tiles, self._entry_bound)
        seconds = time.perf_counter() - flush_start
        nbytes = ring_traffic_bytes(
            self.data_parallel * self.block_size, self.samples_parallel, self.n_local, use_packed
        )
        self.ring_bytes_total += nbytes
        self.telemetry.record_ring(nbytes, seconds)
        self.telemetry.record_flush(flush_rows, seconds, 0)

    def snapshot_state(self) -> dict:
        """Checkpoint state of the sharded strategy: the padded row tiles
        fetched whole as the reference's ``(data_parallel, padded,
        padded)`` int32 stack, with the bookkeeping and the ring accounting
        (so a resumed run's ``schedule`` block keeps predicted ==
        measured)."""
        self._flush()
        return {
            "strategy": "sharded",
            "G": self.layout.host_stack(),
            "accum_dtype": "int32",
            "exact_int": True,
            "entry_bound": self._entry_bound,
            "rows_seen": self.rows_seen,
            "flushes": self._flushes,
            "num_samples": self.num_samples,
            "data_parallel": self.data_parallel,
            "padded": self.padded,
            "ring_bytes_total": self.ring_bytes_total,
        }

    def restore_state(self, checkpoint: dict) -> None:
        """Load a persisted sharded partial (either package's): its stack of
        data-slice partials is summed exactly into this run's first data
        slice and cut into its row tiles. The padded width must match."""
        meta, G = checkpoint["meta"], np.asarray(checkpoint["G"])
        if meta["strategy"] != "sharded":
            raise ValueError(
                f"checkpoint was written by the {meta['strategy']!r} "
                "strategy; this run resolved sharded — the similarity "
                "strategy is part of the checkpoint geometry"
            )
        if G.ndim != 3 or G.shape[1:] != (self.padded, self.padded):
            raise ValueError(
                f"checkpoint Gramian shape {tuple(G.shape)} != this run's "
                f"(data_parallel, {self.padded}, {self.padded}) (cohort width, "
                "padding or the samples-axis tile count changed)"
            )
        self.layout.load(_exact_int32_sum(G))
        self._entry_bound = int(meta["entry_bound"])
        self.rows_seen = int(meta["rows_seen"])
        self._flushes = int(meta["flushes"])
        self.ring_bytes_total = int(meta.get("ring_bytes_total", 0))

    def finalize_sharded(self) -> RowSharded:
        """The (padded, padded) Gramian as row tiles over ``samples``, still
        on the positions (int64 past one data slice)."""
        self._flush()
        with self.telemetry.finalize_span(synchronizer(self.device)):
            return self.layout.finalize_tiles()

    def finalize(self) -> np.ndarray:
        """Host float64 copy of the true (N, N) Gramian."""
        full = host_value(self.finalize_sharded()).astype(np.float64)
        return full[: self.num_samples, : self.num_samples]


def accumulate_index_rows(
    acc,
    call_rows: Iterable,
    num_columns: int,
    block_size: int,
    accumulate_duplicates: bool = False,
) -> None:
    """Stage per-variant column-index rows into dense uint8 blocks and feed
    an accumulator — the one shared row-staging loop (driver and public API).

    ``accumulate_duplicates`` counts a column appearing k times as k, so it
    contributes k² per entry (the reference's pair-loop multiplicity,
    ``VariantsPca.scala:224-229`` — needed when a variant set is joined with
    itself); the default sets membership bits."""
    staging: list = []

    def flush():
        if not staging:
            return
        rows = np.zeros((len(staging), num_columns), dtype=np.uint8)
        for i, row in enumerate(staging):
            if accumulate_duplicates:
                np.add.at(rows[i], np.asarray(list(row), dtype=np.int64), 1)
            else:
                rows[i, list(row)] = 1
        acc.add_rows(rows)
        staging.clear()

    for row in call_rows:
        staging.append(row)
        if len(staging) >= block_size:
            flush()
    flush()


def gramian_reference(rows: np.ndarray) -> np.ndarray:
    """Host NumPy oracle: the pair-counting semantics of
    ``VariantsPca.scala:224-229`` (for each variant, +1 for every ordered
    pair of varying samples), vectorized."""
    X = np.asarray(rows, dtype=np.int64)
    return X.T @ X


__all__ = [
    "DENSE_HBM_FRACTION",
    "GramianAccumulator",
    "KERNELS",
    "MAX_INT8_COUNT",
    "PACK_MAX_BYTES",
    "PACK_SITES",
    "PackSchedule",
    "RingLayout",
    "ShardedGramianAccumulator",
    "accumulate_index_rows",
    "data_axis_sum",
    "dense_strategy_fits",
    "dense_update",
    "dense_update_counts",
    "gramian_reference",
    "pack_rows_t",
    "pack_rows_t_grid",
    "pack_rows_t_plain",
    "pack_schedule",
    "per_device_memory_bytes",
    "reset_launch_counts",
    "resolve_ring_pack",
    "ring_pass",
    "ring_shards",
    "transpose_rows_t",
    "transpose_rows_t_plain",
    "unpack_rows_t",
    "unpack_rows_t_plain",
]
