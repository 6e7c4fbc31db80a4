"""Device ops of the reads examples: per-base read depth and base counts.

The port's copy of ``spark_examples_tpu/ops/depth.py``. The reference
computes per-base depth and base frequencies with flatMap +
``reduceByKey``/``groupByKey`` shuffles over (position, x) pairs
(``SearchReadsExample.scala:140-167, 219-244``); the JAX package turns them
into scatter-adds into a dense coordinate window, vectorized over all reads
of a shard. Here each is hand-written CUDA (``csrc/depth.cu``): read depth
is a difference array (+1 where a read's clipped interval starts, -1
where it ends) and its prefix sum, tile by tile; the base counts a warp
a read, adding its bases with atomics into a window the previous launch
zeroed. Integer sums, so the counts are exactly the reference's in any
order.

As for every kernel wrapper of the port: a CPU tensor takes the plain
PyTorch version beside it (the reference's scatter-add with
``index_add_``), a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.ops.devicegen import _require

#: Fixed base vocabulary for frequency analyses.
BASES = "ACGT"
_BASE_CODE = {c: i for i, c in enumerate(BASES)}


def encode_bases(sequence: str) -> list:
    """Base chars → codes (unknown bases → -1, excluded from counts)."""
    return [_BASE_CODE.get(c, -1) for c in sequence]


@functools.lru_cache(maxsize=None)
def _library():
    return _kernels.library("depth.cu")


class _DepthScratch:
    """``depth_counts``' buffers on one (device, stream), zeroed once:
    the difference buffer, which every launch leaves zeroed, and two tile
    totals buffers, which launches take in turns, each clearing the other
    for the next. Launches on one stream run in order, so none overlaps
    another's use."""

    def __init__(self, device: torch.device, window_size: int, tile: int):
        self.diff = torch.zeros(window_size, dtype=torch.int32, device=device)
        self.totals = torch.zeros((2, -(-window_size // tile)), dtype=torch.int32, device=device)
        self.turn = 0

    def buffers(self):
        """(difference buffer, this launch's totals, the next launch's)."""
        return self.diff, self.totals[self.turn], self.totals[1 - self.turn]


_SCRATCH: dict = {}


def _depth_scratch(device: torch.device, stream: int, window_size: int, tile: int):
    key = (device.index, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None or scratch.diff.numel() < window_size:
        scratch = _SCRATCH[key] = _DepthScratch(device, window_size, tile)
    return scratch


def _check_window(window_size: int) -> None:
    if int(window_size) < 1:
        raise ValueError(f"window_size must be >= 1, got {window_size}")


def _check_positions(positions: torch.Tensor) -> None:
    if positions.ndim != 1:
        raise ValueError(f"positions must be (R,), got {tuple(positions.shape)}")
    _require(positions, "positions", torch.int32)


def depth_counts_plain(
    positions: torch.Tensor,
    lengths: torch.Tensor,
    window_start: int,
    window_size: int,
    max_read_length: int = 256,
) -> torch.Tensor:
    """Plain version of :func:`depth_counts`: the reference's (R,
    max_read_length) index grid and mask, then ``index_add_`` of ones."""
    rel = positions.long() - int(window_start)
    offsets = torch.arange(int(max_read_length), dtype=torch.int64, device=positions.device)
    idx = rel[:, None] + offsets[None, :]
    valid = (offsets[None, :] < lengths.long()[:, None]) & (idx >= 0) & (idx < window_size)
    hits = idx[valid]
    out = torch.zeros(int(window_size), dtype=torch.int32, device=positions.device)
    return out.index_add_(0, hits, torch.ones_like(hits, dtype=torch.int32))


def depth_counts(
    positions: torch.Tensor,
    lengths: torch.Tensor,
    window_start: int,
    window_size: int,
    max_read_length: int = 256,
) -> torch.Tensor:
    """Per-base read depth over a window (``SearchReadsExample.scala:153-162``):
    each read covers ``[position, position + length)``, its offsets cut at
    ``max_read_length`` as the reference's static grid cuts them; counts
    land in a dense ``(window_size,)`` int32 vector whose index 0 is
    reference position ``window_start``. ``positions`` and ``lengths`` are
    ``(R,)`` int32 on one device.

    Replaces ``spark_examples_tpu/ops/depth.py:depth_counts``. CPU tensors
    take :func:`depth_counts_plain`; CUDA tensors launch
    ``depth_adds_kernel`` then ``depth_scan_kernel`` (``csrc/depth.cu``):
    a difference array and its prefix sum, over buffers kept per device and
    stream."""
    _check_positions(positions)
    _require(lengths, "lengths", torch.int32, positions.shape, positions.device)
    _check_window(window_size)
    if int(max_read_length) < 0:
        raise ValueError(f"max_read_length must be >= 0, got {max_read_length}")
    if positions.device.type == "cpu":
        return depth_counts_plain(positions, lengths, window_start, window_size, max_read_length)
    rows = int(positions.shape[0])
    if rows == 0:
        return torch.zeros(int(window_size), dtype=torch.int32, device=positions.device)
    out = torch.empty(int(window_size), dtype=torch.int32, device=positions.device)
    lib = _library()
    with torch.cuda.device(positions.device):
        stream = torch.cuda.current_stream(positions.device).cuda_stream
        scratch = _depth_scratch(positions.device, stream, int(window_size),
                                 lib.depth_scan_tile())
        diff, totals, next_totals = scratch.buffers()
        status = lib.depth_counts_launch(
            positions.data_ptr(), lengths.data_ptr(), rows, int(window_start),
            int(window_size), int(max_read_length), out.data_ptr(), diff.data_ptr(),
            totals.data_ptr(), next_totals.data_ptr(), totals.numel(), stream,
        )
    if status:  # the buffers' state is unknown: the next call starts from zeroed ones
        _SCRATCH.pop((positions.device.index, stream), None)
    _kernels.check(status, "depth_counts")
    scratch.turn = 1 - scratch.turn
    depth_counts.launches += 1
    return out


depth_counts.launches = 0  # type: ignore[attr-defined]


def base_counts_plain(
    positions: torch.Tensor,
    base_codes: torch.Tensor,
    quality_ok: torch.Tensor,
    window_start: int,
    window_size: int,
) -> torch.Tensor:
    """Plain version of :func:`base_counts`: the reference's index grid,
    mask and clipped codes, then an accumulating ``index_put_``."""
    L = base_codes.shape[1]
    rel = positions.long() - int(window_start)
    offsets = torch.arange(L, dtype=torch.int64, device=positions.device)
    idx = rel[:, None] + offsets[None, :]
    valid = quality_ok.bool() & (base_codes >= 0) & (idx >= 0) & (idx < window_size)
    codes = base_codes.long().clamp(0, len(BASES) - 1)
    out = torch.zeros((int(window_size), len(BASES)), dtype=torch.int32, device=positions.device)
    rows, cols = idx[valid], codes[valid]
    return out.index_put_((rows, cols), torch.ones_like(rows, dtype=torch.int32), accumulate=True)


class _ZeroedSpares:
    """One zeroed ``(rows, 4)`` int32 buffer per key (a device and a
    stream): ``base_counts``' next result. :meth:`take` hands the key's
    buffer out (a zeroed one from ``zeros`` when there is none or it has
    fewer than ``rows`` rows) with an empty ``rows``-row buffer, which the
    launch zeroes and :meth:`put` keeps for the next call: a window like
    this call's, as a shard's next is. A launch that fails puts nothing
    back, so the next call starts from ``zeros``."""

    def __init__(self):
        self._spares: dict = {}

    def take(self, key, rows: int, zeros, empty):
        spare = self._spares.pop(key, None)
        if spare is None or spare.shape[0] < rows:
            spare = zeros(rows)
        return spare, empty(rows)

    def put(self, key, spare: torch.Tensor) -> None:
        self._spares[key] = spare


_BASE_SPARE = _ZeroedSpares()


def base_counts(
    positions: torch.Tensor,
    base_codes: torch.Tensor,
    quality_ok: torch.Tensor,
    window_start: int,
    window_size: int,
) -> torch.Tensor:
    """Per-position per-base counts (``SearchReadsExample.scala:223-243``):
    ``(window_size, 4)`` int32, from ``(R,)`` int32 start positions,
    ``(R, L)`` int8 base codes (-1 = unknown or past the read; a code
    above 3 counts as 3, as the reference clips it) and the ``(R, L)``
    base-quality mask (bool, or uint8 as it ships to the kernel). Callers
    derive frequencies by dividing by the per-position total.

    Replaces ``spark_examples_tpu/ops/depth.py:base_counts``. CPU tensors
    take :func:`base_counts_plain`; CUDA tensors launch
    ``base_counts_kernel`` (``csrc/depth.cu``) once, into the buffer the
    previous launch on this device and stream zeroed at that launch's
    window size (the first call there, or one with a wider window than the
    last, zero-fills a buffer first). The result may be a view of a buffer
    with more rows, when the last call's window was wider."""
    _check_positions(positions)
    if base_codes.ndim != 2 or base_codes.shape[0] != positions.shape[0]:
        raise ValueError(
            f"base_codes must be (R, L) with R = {positions.shape[0]}, got "
            f"{tuple(base_codes.shape)}"
        )
    _require(base_codes, "base_codes", torch.int8, None, positions.device)
    if quality_ok.dtype == torch.bool:
        quality_ok = quality_ok.view(torch.uint8)
    _require(quality_ok, "quality_ok", torch.uint8, base_codes.shape, positions.device)
    _check_window(window_size)
    if positions.device.type == "cpu":
        return base_counts_plain(positions, base_codes, quality_ok, window_start, window_size)
    rows, read_len, dev = int(positions.shape[0]), int(base_codes.shape[1]), positions.device
    if rows == 0:
        return torch.zeros((int(window_size), len(BASES)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out, spare = _BASE_SPARE.take(
            (dev.index, stream), int(window_size),
            lambda n: torch.zeros((n, len(BASES)), dtype=torch.int32, device=dev),
            lambda n: torch.empty((n, len(BASES)), dtype=torch.int32, device=dev),
        )
        status = _library().base_counts_launch(
            positions.data_ptr(), base_codes.data_ptr(), quality_ok.data_ptr(), rows, read_len,
            int(window_start), int(window_size), out.data_ptr(), spare.data_ptr(),
            spare.shape[0], stream,
        )
    _kernels.check(status, "base_counts")
    _BASE_SPARE.put((dev.index, stream), spare)
    base_counts.launches += 1
    return out[: int(window_size)]


base_counts.launches = 0  # type: ignore[attr-defined]

#: Every kernel wrapper of this module, for launch accounting.
KERNELS = (depth_counts, base_counts)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0  # type: ignore[attr-defined]


def frequent_bases(counts: torch.Tensor, min_freq: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position base sets with frequency ≥ ``min_freq``
    (``SearchReadsExample.scala:282-291``): ``(mask (W, 4) bool, covered
    (W,) bool)`` from ``(W, 4)`` counts, float32 frequencies as the JAX
    package divides them. Plain torch: no path of either package calls it
    (example 4 renders its frequencies on the host)."""
    totals = counts.sum(dim=1, keepdim=True)
    freq = counts / totals.clamp(min=1)
    return (freq >= min_freq) & (totals > 0), totals[:, 0] > 0


__all__ = [
    "BASES",
    "KERNELS",
    "base_counts",
    "base_counts_plain",
    "depth_counts",
    "depth_counts_plain",
    "encode_bases",
    "frequent_bases",
    "reset_launch_counts",
]
