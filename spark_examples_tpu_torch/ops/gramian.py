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
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from spark_examples_tpu_torch.obs.metrics import GRAMIAN_INFLIGHT_DISPATCHES, well_known_gauge
from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.ops.contracts import flush_entry_increment
from spark_examples_tpu_torch.ops.devicegen import (
    COL_TILE,
    SITE_TILE,
    _require,
    _round_up,
    gram_accumulate,
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
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
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
    xt[:num_columns, :rows] = X.T.to(torch.int8)
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
    if block.device.type == "cpu":
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

#: Every kernel wrapper of this module, for launch accounting.
KERNELS = (unpack_rows_t,)


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


# ------------------------------------------------------------ accumulator


class _AccumulatorTelemetry:
    """Flush instrumentation: unlabeled ``gramian_flushes_total`` /
    ``gramian_rows_total`` counters (one strategy, so the reference's
    ``strategy`` label is left out), the ``gramian_flush_seconds``
    histogram of host time per flush and the in-flight gauge the heartbeat
    reads; at finalize the accumulated host-side flush time attaches to the
    open span tree as one ``dispatch`` span, and the drain of the card runs
    under ``reduce-flush``."""

    def __init__(self, registry, spans):
        self.spans = spans
        self.flush_seconds_total = 0.0
        self._flushes = self._rows = self._seconds = self._inflight = None
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

    def finalize_span(self, sync):
        if self.spans is None:
            return contextlib.nullcontext()
        self.spans.add("dispatch", self.flush_seconds_total)
        return self.spans.span("reduce-flush", sync=sync)


class GramianAccumulator:
    """Dense strategy on one device: the resident int32 N×N Gramian.

    Feed host ``(b, N)`` uint8 rows with :meth:`add_rows`; full blocks of
    ``block_size`` rows flush to the device, bit-packed when every entry is
    0/1 and count-valued otherwise. :meth:`finalize_device` flushes the
    ragged tail and returns G on the device.

    ``pipeline_depth`` bounds the flushes in flight: ``None`` waits for
    each flush's work before the next (the reference's default
    ``sync_every=1``); ``d`` waits only for the flush issued ``d`` flushes
    ago, so host packing of block k+1 overlaps the card's work on block k.
    On the card every shipped block is first copied into fresh pinned
    memory and then sent asynchronously, so the reused staging buffer is
    never the source of a copy in flight.
    """

    def __init__(
        self,
        num_samples: int,
        device: DeviceLike = None,
        block_size: int = 1024,
        pipeline_depth: Optional[int] = None,
        registry=None,
        spans=None,
    ):
        self.device = resolve_device(device)
        self.telemetry = _AccumulatorTelemetry(registry, spans)
        self.num_samples = int(num_samples)
        self.block_size = int(block_size)
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.pipeline_depth = (
            None if pipeline_depth is None else max(1, int(pipeline_depth))
        )
        self._in_flight: List[torch.cuda.Event] = []
        self._entry_bound = 0
        self._staging = np.zeros((self.block_size, self.num_samples), dtype=np.uint8)
        self._fill = 0
        self._flushes = 0
        self.rows_seen = 0
        self.G = torch.zeros(
            (self.num_samples, self.num_samples), dtype=torch.int32, device=self.device
        )

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
            self._staging[self._fill : self._fill + take] = rows[offset : offset + take]
            self._fill += take
            offset += take
            if self._fill == capacity:
                self._flush()

    def _ship(self, host: np.ndarray) -> torch.Tensor:
        """``host`` on the device. On the card through a fresh pinned copy
        and an asynchronous transfer; on the CPU the plain versions consume
        it before the staging buffer is written again."""
        tensor = torch.from_numpy(host)
        if self.device.type == "cpu":
            return tensor
        return tensor.pin_memory().to(self.device, non_blocking=True)

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
        if max_count > 1:
            # Count-valued rows (same-set joins) cannot be bit-packed.
            dense_update_counts(self.G, self._ship(block), max_count=max_count)
        else:
            dense_update(
                self.G, self._ship(np.packbits(block, axis=-1)), self.num_samples
            )
        self._fill = 0
        self._flushes += 1
        if self.device.type == "cuda":
            if self.pipeline_depth is None:
                torch.cuda.current_stream(self.device).synchronize()
            else:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                self._in_flight.append(done)
                if len(self._in_flight) > self.pipeline_depth:
                    self._in_flight.pop(0).synchronize()
        self.telemetry.record_flush(
            flush_rows, time.perf_counter() - flush_start, len(self._in_flight)
        )

    def snapshot_state(self) -> dict:
        """Crash-consistent checkpoint state: flush the staged tail, drain
        the card (every in-flight update finished) and fetch the partial
        Gramian with the accumulator's bookkeeping — what
        :meth:`restore_state` needs to rebuild it mid-stream in a fresh
        process. G is saved as the reference's ``(data_parallel, N, N)``
        stack of one slice, int32 (the reference climbs to int32 on resume).
        The fetch is periodic (``--checkpoint-every-sites``), not a hot-path
        sync."""
        self._flush()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._in_flight.clear()
        return {
            "strategy": "dense",
            "G": self.G.cpu().numpy()[None],
            "accum_dtype": "int32",
            "exact_int": True,
            "entry_bound": self._entry_bound,
            "rows_seen": self.rows_seen,
            "flushes": self._flushes,
            "num_samples": self.num_samples,
            "data_parallel": 1,
            "padded": self.num_samples,
        }

    def restore_state(self, checkpoint: dict) -> None:
        """Merge a persisted partial into this (fresh, empty) accumulator:
        load the saved G and restore the cursor bookkeeping. A reference
        artifact may hold one partial per data-parallel device (summed here:
        G is additive over any split of the rows) and float32 entries
        (exact integers below 2^24, cast to int32 without loss). Geometry
        mismatches fail loudly — the conf fingerprint should have caught
        them already; this is the shape check behind it."""
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
        if G.dtype.kind == "f" and not np.array_equal(G, np.trunc(G)):
            raise ValueError("checkpoint Gramian entries are not exact integers")
        total = G.astype(np.int64).sum(axis=0)
        if np.abs(total).max(initial=0) > _INT32_MAX:
            raise ValueError("checkpoint Gramian entries do not fit int32")
        self.G = torch.from_numpy(total.astype(np.int32)).to(self.device)
        self._entry_bound = int(meta["entry_bound"])
        self.rows_seen = int(meta["rows_seen"])
        self._flushes = int(meta["flushes"])

    def finalize_device(self) -> torch.Tensor:
        """Flush the ragged tail and return the int32 Gramian, still on the
        device. Under the ``reduce-flush`` span the card drains its queue."""
        self._flush()
        self._in_flight.clear()
        with self.telemetry.finalize_span(synchronizer(self.device)):
            return self.G

    def finalize(self) -> np.ndarray:
        """Host float64 copy of :meth:`finalize_device` (tests, host use)."""
        return self.finalize_device().cpu().numpy().astype(np.float64)


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
    "accumulate_index_rows",
    "dense_strategy_fits",
    "dense_update",
    "dense_update_counts",
    "gramian_reference",
    "per_device_memory_bytes",
    "reset_launch_counts",
    "unpack_rows_t",
    "unpack_rows_t_plain",
]
