"""Stacked jobs: K independent dense Gramians, one step for all of them, on
one CUDA card.

The port of ``spark_examples_tpu/ops/batched.py``. A batch group of jobs
that share a cohort geometry runs through one ``(K, N, N)`` int32
accumulator fed ``(K, B, ceil(N/8))`` bit-packed operands: each step
launches each of two hand-written CUDA kernels once for the whole group,

- :func:`stacked_unpack_rows_t` (``csrc/gramian.cu``): the K lanes'
  packed blocks into one stacked int8 Xᵀ, lane k's rows from
  ``k · n_pad``;
- :func:`stacked_gram_accumulate` (``csrc/devicegen.cu``):
  ``G[k] += X_kᵀ·X_k`` for every lane, one tensor map over the stack,

which replace the reference's ``_dense_update`` run with the jobs axis in
the leading slot (``StackedJobsAccumulator._drain``). Each has a plain
PyTorch version beside it that loops over the lanes with the single
product's plain versions; a CPU tensor takes it, a CUDA tensor launches
the kernel or raises.

Byte identity with a serial run, lane by lane:

- each lane stages its rows exactly as the reference's lane does (the
  zero-padded tail, ``np.packbits`` along the samples), so step t of lane
  k carries the operand bytes the serial job's flush t carries (the
  serial port ships only the filled rows; zero rows add nothing);
- a lane past its last block gets zero operands in the shipped tensor; the
  kernels skip it (``lanes``: the lanes with a block this step), the plain
  versions add its zero product, as the reference does. Either way int32
  entries are unchanged;
- the accumulator is int32 from the first step, as the port's serial
  accumulator is, so ``G[k]`` is the serial job's Gramian entry for entry
  and dtype for dtype.

The reference's lane staging refuses, and so does this one, with the
reference's messages: count-valued rows (the stacked program takes {0,1}
rows only), and a lane whose projected per-entry count passes float32's
exact window (``EXACT_F32_LIMIT``), where the reference's serial
accumulator would change dtype mid-stream. The port accumulates in int32
throughout, but keeps the refusal so that both packages fuse the same
groups.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_examples_tpu_torch.obs import schedule as _schedule
from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.ops.contracts import EXACT_F32_LIMIT, flush_entry_increment
from spark_examples_tpu_torch.ops.devicegen import (
    COL_TILE,
    SITE_TILE,
    _require,
    _round_up,
    _sms,
    _split,
    gram_accumulate_grid,
    gram_accumulate_plain,
    gram_units,
)
from spark_examples_tpu_torch.ops.devicegen import _library as _product_library
from spark_examples_tpu_torch.ops.gramian import (
    _DEFAULT_DEVICE_BYTES,
    _DENSE_BUFFERS,
    _INT32_MAX,
    DENSE_HBM_FRACTION,
    _packed_width,
    unpack_rows_t_plain,
)
from spark_examples_tpu_torch.ops.gramian import _library as _unpack_library
from spark_examples_tpu_torch.utils.device import DeviceLike, resolve_device

#: The most lanes a launch lists (``csrc/stacked.cuh``); a step with more
#: lanes holding a block launches every lane.
STACK_LIST = 512
#: The most lanes a stack holds: the kernels' lanes lie along gridDim.z
#: (the launchers refuse more).
MAX_LANES = 65535


class FusedIneligible(RuntimeError):
    """This group (or one member) cannot ride the stacked program: a
    scheduling signal, not an error surface — the caller runs the jobs one
    after another instead, which is always valid."""


def max_fused_jobs(
    num_samples: int,
    accum_bytes: int = 4,
    device_bytes: Optional[int] = None,
) -> int:
    """Largest jobs axis whose stacked working set fits the dense memory
    rule (the reference's rule, over the port's ``_DENSE_BUFFERS`` and
    ``DENSE_HBM_FRACTION``): K × ``_DENSE_BUFFERS`` N×N buffers within
    ``DENSE_HBM_FRACTION`` of ``device_bytes``. ``None`` is the reference's
    device-free 16 GiB default; a caller may pass
    ``ops/gramian.py:per_device_memory_bytes(device)``. At least 1."""
    budget = _DEFAULT_DEVICE_BYTES if device_bytes is None else device_bytes
    per_job = _DENSE_BUFFERS * int(num_samples) ** 2 * int(accum_bytes)
    return max(1, int((DENSE_HBM_FRACTION * budget) // per_job))


# ----------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _libraries():
    """The unpack's and the product's libraries, their lane lists checked
    against :data:`STACK_LIST`."""
    unpack, product = _unpack_library(), _product_library()
    got = (unpack.gramian_stack_list(), product.devicegen_stack_list())
    if got != (STACK_LIST, STACK_LIST):
        raise RuntimeError(f"csrc/stacked.cuh lists {got} lanes, ops/batched.py {STACK_LIST}")
    return unpack, product


def _lane_list(lanes: Optional[Sequence[int]], total: int):
    """The launchers' ``(listed lanes, count)`` for ``lanes`` of a stack of
    ``total``: ``(None, 0)`` (every lane) for ``None``, for every lane, and
    for more than :data:`STACK_LIST` lanes."""
    if lanes is None:
        return None, 0
    listed = sorted({int(k) for k in lanes})
    if not listed:
        raise ValueError("a stacked launch needs at least one lane")
    if listed[0] < 0 or listed[-1] >= total:
        raise ValueError(f"lanes {listed} out of range for a stack of {total}")
    if len(listed) == total or len(listed) > STACK_LIST:
        return None, 0
    return (ctypes.c_int * len(listed))(*listed), len(listed)


def stacked_unpack_rows_t_plain(packed: torch.Tensor, num_columns: int) -> torch.Tensor:
    """Plain version of :func:`stacked_unpack_rows_t`: every lane through
    ``unpack_rows_t_plain`` into its rows of a zeroed stacked Xᵀ."""
    total, rows, _ = packed.shape
    n_pad = _round_up(num_columns, COL_TILE)
    ld = _round_up(max(rows, 1), SITE_TILE)
    xt = torch.zeros((total * n_pad, ld), dtype=torch.int8, device=packed.device)
    for k in range(total):
        xt[k * n_pad : (k + 1) * n_pad] = unpack_rows_t_plain(packed[k], num_columns)
    return xt


def stacked_unpack_rows_t(
    packed: torch.Tensor, num_columns: int, lanes: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """The K lanes' bit-packed blocks, ``(K, B, ceil(N/8))`` uint8 in
    np.packbits' order, as one stacked int8 Xᵀ of ``(K · n_pad, ld)``
    (``n_pad = round_up(N, 128)``, ``ld = round_up(B, 128)``): lane k's Xᵀ
    in rows ``[k · n_pad, (k + 1) · n_pad)``, zero past N columns and B
    sites.

    ``lanes`` names the lanes that hold a block this step (default every
    lane); the kernel leaves the other lanes' rows of Xᵀ unwritten, so only
    :func:`stacked_gram_accumulate` with the same ``lanes`` may read the
    result. The plain version unpacks every lane.

    Replaces the unpack of ``spark_examples_tpu/ops/batched.py:
    StackedJobsAccumulator._drain`` (``ops/gramian.py:_dense_update``'s
    ``_unpack_bits`` over the jobs axis). CPU tensors take
    :func:`stacked_unpack_rows_t_plain`; CUDA tensors launch
    ``stacked_unpack_rows_t_kernel`` (``csrc/gramian.cu``), one launch for
    every lane."""
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        return recording.launch(stacked_unpack_rows_t, "unpack", (packed,), (), packed,
                                num_columns, lanes, packed=True,
                                support=int(packed.shape[1]))
    width = _packed_width(num_columns)
    _require(packed, "packed", torch.uint8)
    if packed.ndim != 3 or packed.shape[2] != width or packed.shape[0] < 1:
        raise ValueError(
            f"packed must be (K, B, {width}) uint8 for {num_columns} columns, "
            f"got {tuple(packed.shape)}"
        )
    total, rows, _ = packed.shape
    listed, count = _lane_list(lanes, total)
    if packed.device.type in _kernels.PLAIN_DEVICES:
        return stacked_unpack_rows_t_plain(packed, num_columns)
    n_pad = _round_up(num_columns, COL_TILE)
    ld = _round_up(max(rows, 1), SITE_TILE)
    xt = torch.empty((total * n_pad, ld), dtype=torch.int8, device=packed.device)
    unpack, _ = _libraries()
    with torch.cuda.device(packed.device):
        status = unpack.stacked_unpack_rows_t_launch(
            packed.data_ptr(), total, rows, width, int(num_columns), xt.data_ptr(), n_pad, ld,
            listed, count, torch.cuda.current_stream(packed.device).cuda_stream,
        )
    _kernels.check(status, "stacked_unpack_rows_t")
    stacked_unpack_rows_t.launches += 1
    return xt


stacked_unpack_rows_t.launches = 0  # type: ignore[attr-defined]


def stacked_gram_accumulate_plain(G: torch.Tensor, xt: torch.Tensor) -> None:
    """Plain version of :func:`stacked_gram_accumulate`: every lane through
    ``gram_accumulate_plain`` on its rows of the stacked Xᵀ (a lane with no
    block adds its zero product, as the reference does)."""
    total = G.shape[0]
    n_pad = xt.shape[0] // total
    for k in range(total):
        gram_accumulate_plain(G[k], xt[k * n_pad : (k + 1) * n_pad])


def stacked_gram_split(rows: int, ld: int, sms: int, lanes: int) -> int:
    """``ops/devicegen.py:gram_split`` for a stacked launch: the launch's
    ``lanes`` × :func:`gram_units` against the card's ``sms`` (the split
    of the contracted axis each unit's blocks take; 1 wherever the units
    fill half the card, as every stack at 2,504 samples does)."""
    return _split(int(lanes) * gram_units(rows), ld, sms)


def stacked_gram_accumulate_grid(rows: int, ld: int, lanes: int, device) -> tuple:
    """A stacked launch on ``device`` over lanes of ``rows`` Xᵀ rows ×
    ``ld`` sites: (blocks, blocks resident at once, split, the card's SMs)."""
    _, resident, _, sms = gram_accumulate_grid(rows, ld, torch.device(device))
    split = stacked_gram_split(rows, ld, sms, lanes)
    return int(lanes) * gram_units(rows) * split * (2 if split > 1 else 1), resident, split, sms


def stacked_gram_accumulate(
    G: torch.Tensor,
    xt: torch.Tensor,
    lanes: Optional[Sequence[int]] = None,
    split: Optional[int] = None,
) -> None:
    """``G[k] += (X_kᵀ·X_k)[:n, :n]`` in place for every lane k of the
    ``(K, n, n)`` int32 ``G``, from the ``(K · n_pad, ld)`` int8 stacked Xᵀ
    of :func:`stacked_unpack_rows_t`. ``lanes`` names the lanes with a
    block this step (default every lane; the kernel leaves the others'
    G as it is, where the plain version adds their zero product).
    ``split`` defaults to :func:`stacked_gram_split`; any split gives the
    same G.

    Replaces the einsum of ``spark_examples_tpu/ops/batched.py:
    StackedJobsAccumulator._drain`` (``ops/gramian.py:_dense_update`` over
    the jobs axis). CPU tensors take :func:`stacked_gram_accumulate_plain`;
    CUDA tensors launch ``stacked_gram_accumulate_kernel``
    (``csrc/devicegen.cu``), one launch for every lane."""
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        return recording.launch(stacked_gram_accumulate, "product", (xt,), (G,), G, xt,
                                lanes, split)
    if G.ndim != 3 or G.shape[1] != G.shape[2] or G.shape[0] < 1:
        raise ValueError(f"G must be (K, n, n), got {tuple(G.shape)}")
    total, n, _ = G.shape
    listed, count = _lane_list(lanes, total)
    if G.device.type in _kernels.PLAIN_DEVICES:
        stacked_gram_accumulate_plain(G, xt)
        return
    _require(G, "G", torch.int32)
    _require(xt, "xt", torch.int8, None, G.device)
    rows, ld = xt.shape
    n_pad = rows // total
    if rows % total or n_pad < n or n_pad % COL_TILE or ld % SITE_TILE:
        raise ValueError(
            f"xt must be ({total} × {COL_TILE}k ≥ {n}, {SITE_TILE}m), got {tuple(xt.shape)}"
        )
    if xt.data_ptr() % 16:
        raise ValueError("xt must start on a 16-byte boundary (its tensor map needs it)")
    if split is None:
        split = stacked_gram_split(n_pad, ld, _sms(G.device.index), count or total)
    if not 1 <= split <= max(1, ld // SITE_TILE):
        raise ValueError(f"split must be in [1, {max(1, ld // SITE_TILE)}], got {split}")
    _, product = _libraries()
    with torch.cuda.device(G.device):
        status = product.stacked_gram_accumulate_launch(
            G.data_ptr(), n, xt.data_ptr(), total, n_pad, ld, split, listed, count,
            torch.cuda.current_stream(G.device).cuda_stream,
        )
    _kernels.check(status, "stacked_gram_accumulate")
    stacked_gram_accumulate.launches += 1


stacked_gram_accumulate.launches = 0  # type: ignore[attr-defined]

#: Every kernel wrapper of this module, for launch accounting.
KERNELS = (stacked_unpack_rows_t, stacked_gram_accumulate)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0  # type: ignore[attr-defined]


# ------------------------------------------------------------- accumulator


class StackedJobsAccumulator:
    """K independent dense Gramian lanes, one step of both kernels for all
    of them (the reference's class, name for name).

    Feed lane ``k`` host ``(b, N)`` uint8 has-variation rows with
    :meth:`add_rows`; each lane stages into its own ``(block_size, N)``
    buffer, and a full block is bit-packed and queued. A step runs as soon
    as every lane can contribute (a pending block, or zeros once
    finished) and at least one has a block: the K operands ship as one
    ``(K, B, ceil(N/8))`` uint8 tensor (through a fresh pinned copy on the
    card) and each stacked kernel launches once. ``pipeline_depth`` bounds
    the steps in flight: a step waits on the CUDA event of the step
    ``pipeline_depth`` back. :meth:`finalize` drains every lane and
    returns the ``(K, N, N)`` int32 accumulator on its device;
    :meth:`job_slice` is one job's Gramian, byte-identical to its serial
    run. ``device`` defaults to the card."""

    def __init__(
        self,
        num_jobs: int,
        num_samples: int,
        device: DeviceLike = None,
        block_size: int = 1024,
        exact_int: bool = False,
        pipeline_depth: int = 2,
    ):
        if num_jobs < 1:
            raise ValueError(f"num_jobs must be >= 1, got {num_jobs}")
        if num_jobs > MAX_LANES:
            raise ValueError(f"num_jobs must be at most {MAX_LANES}, got {num_jobs}")
        self.device = resolve_device(device)
        self.num_jobs = int(num_jobs)
        self.num_samples = int(num_samples)
        self.block_size = int(block_size)
        self.exact_int = bool(exact_int)
        k, b, n = self.num_jobs, self.block_size, self.num_samples
        self._staging = [np.zeros((b, n), dtype=np.uint8) for _ in range(k)]
        self._fill = [0] * k
        self._pending: List[List[np.ndarray]] = [[] for _ in range(k)]
        self._finished = [False] * k
        self._entry_bound = [0] * k
        self.rows_seen = [0] * k
        self.steps = 0
        # XᵀX of a zero block is exactly zero (the ragged lane's operand).
        self._zero_op = np.zeros((1, b, _packed_width(n)), dtype=np.uint8)
        self.G = torch.zeros((k, n, n), dtype=torch.int32, device=self.device)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._in_flight: List[torch.cuda.Event] = []

    # -------------------------------------------------------------- feeding

    def add_rows(self, lane: int, rows: np.ndarray) -> None:
        """Stage host rows into one lane; pack full blocks and run any
        stacked step the group can now take."""
        if self._finished[lane]:
            raise RuntimeError(f"lane {lane} already finished")
        rows = np.asarray(rows, dtype=np.uint8)
        if rows.ndim != 2 or rows.shape[1] != self.num_samples:
            raise ValueError(f"expected (b, {self.num_samples}) rows, got {rows.shape}")
        self.rows_seen[lane] += rows.shape[0]
        staging, offset = self._staging[lane], 0
        capacity = staging.shape[0]
        while offset < rows.shape[0]:
            take = min(capacity - self._fill[lane], rows.shape[0] - offset)
            staging[self._fill[lane] : self._fill[lane] + take] = rows[offset : offset + take]
            self._fill[lane] += take
            offset += take
            if self._fill[lane] == capacity:
                self._pack_lane(lane)
        self._drain()

    def finish_lane(self, lane: int) -> None:
        """One lane's stream is complete: pack its zero-padded partial
        tail (the serial accumulator's finalize flush) and let shorter
        lanes ride zero operands from here on."""
        if self._finished[lane]:
            return
        if self._fill[lane]:
            self._pack_lane(lane)
        self._finished[lane] = True
        self._drain()

    def _pack_lane(self, lane: int) -> None:
        """The reference's lane staging: pad the tail with zero rows, refuse
        count-valued rows and a lane past the f32 exact window, bit-pack
        along the samples."""
        fill = self._fill[lane]
        block = self._staging[lane]
        if fill < block.shape[0]:
            block = block.copy()
            block[fill:] = 0
        max_count = int(block.max(initial=0))
        if max_count > 1:
            raise FusedIneligible(
                f"lane {lane} staged count-valued rows (max {max_count}); "
                "stacked dispatch covers has-variation {0,1} rows only"
            )
        increment = flush_entry_increment(fill, max_count)
        next_bound = self._entry_bound[lane] + increment
        if not self.exact_int and next_bound > EXACT_F32_LIMIT:
            raise FusedIneligible(
                f"lane {lane} projects {next_bound} per-entry counts, past "
                f"the f32 exact window ({EXACT_F32_LIMIT}); the serial "
                "path would switch accumulator dtype mid-stream"
            )
        if next_bound > _INT32_MAX:
            raise OverflowError(
                f"lane {lane}: a Gramian entry could pass int32 after this block "
                f"(bound {next_bound})"
            )
        self._entry_bound[lane] = next_bound
        shaped = block.reshape(1, self.block_size, self.num_samples)
        self._pending[lane].append(np.packbits(shaped, axis=-1))
        self._fill[lane] = 0

    # --------------------------------------------------------------- stepping

    def _step_ready(self) -> bool:
        """A step runs iff every lane can contribute an operand — a pending
        block, or zeros once finished — and at least one contributes a
        block."""
        any_real = False
        for lane in range(self.num_jobs):
            if self._pending[lane]:
                any_real = True
            elif not self._finished[lane]:
                return False
        return any_real

    def _ship(self, host: np.ndarray) -> torch.Tensor:
        """``host`` on the accumulator's device: on the card through a fresh
        pinned copy and an asynchronous transfer on the current stream."""
        tensor = torch.from_numpy(host)
        if self.device.type == "cpu":
            return tensor
        return tensor.pin_memory().to(self.device, non_blocking=True)

    def _drain(self) -> None:
        while self._step_ready():
            lanes = [lane for lane in range(self.num_jobs) if self._pending[lane]]
            ops = [
                self._pending[lane].pop(0) if self._pending[lane] else self._zero_op
                for lane in range(self.num_jobs)
            ]
            X = self._ship(np.concatenate(ops, axis=0))
            xt = stacked_unpack_rows_t(X, self.num_samples, lanes)
            stacked_gram_accumulate(self.G, xt, lanes)
            self.steps += 1
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                self._in_flight.append(done)
                if len(self._in_flight) > self.pipeline_depth:
                    self._in_flight.pop(0).synchronize()  # graftcheck: disable=GC007 -- this IS the bounded in-flight window the rule recommends: waits only for the stacked step issued pipeline_depth iterations ago (same double-buffered feed as GramianAccumulator._flush), never the step just dispatched

    # -------------------------------------------------------------- results

    def finalize(self) -> torch.Tensor:
        """Drain every lane (each must have been :meth:`finish_lane`'d)
        and return the stacked ``(K, N, N)`` int32 accumulator, on its
        device."""
        for lane in range(self.num_jobs):
            if not self._finished[lane]:
                raise RuntimeError(
                    f"finalize before finish_lane({lane}) — lane streams must be complete"
                )
        self._drain()
        self._in_flight.clear()
        return self.G

    def job_slice(self, lane: int) -> torch.Tensor:
        """Lane ``lane``'s Gramian, on the device: the serial job's
        ``finalize_device()`` entry for entry, int32 as the serial port's."""
        return self.G[lane]


def load_reference_state(
    acc: StackedJobsAccumulator,
    G: np.ndarray,
    entry_bound: Sequence[int],
    rows_seen: Optional[Sequence[int]] = None,
    steps: int = 0,
    fill: Optional[Sequence[int]] = None,
    staging: Optional[Sequence[np.ndarray]] = None,
    pending: Optional[Sequence[Sequence[np.ndarray]]] = None,
    finished: Optional[Sequence[bool]] = None,
) -> None:
    """Seed a fresh ``acc`` with the state of the reference package's
    ``StackedJobsAccumulator`` (numpy arrays and its lists), so a group
    started there finishes here with the same lanes: the ``(K, N, N)`` G
    (float32 entries must be exact integers), each lane's ``_entry_bound``,
    and optionally ``rows_seen``, ``steps``, each lane's staged rows
    (``_fill``, ``_staging``), its packed blocks awaiting a step
    (``_pending``) and its ``_finished`` flag."""
    G = np.asarray(G)
    k, n = acc.num_jobs, acc.num_samples
    if G.shape != (k, n, n):
        raise ValueError(f"G must be ({k}, {n}, {n}), got {G.shape}")
    if G.dtype.kind == "f" and not np.array_equal(G, np.trunc(G)):
        raise ValueError("reference G entries are not exact integers")
    if np.abs(G).max(initial=0) > _INT32_MAX:
        raise ValueError("G entries exceed the int32 accumulator")
    if len(entry_bound) != k:
        raise ValueError(f"expected {k} entry bounds, got {len(entry_bound)}")
    acc.G.copy_(torch.from_numpy(G.astype(np.int32)))  # range: |G| <= _INT32_MAX is checked just above, so int32 holds every entry exactly
    acc._entry_bound = [int(b) for b in entry_bound]
    if rows_seen is not None:
        acc.rows_seen = [int(r) for r in rows_seen]
    acc.steps = int(steps)
    if fill is not None:
        acc._fill = [int(f) for f in fill]
    if staging is not None:
        for lane, rows in enumerate(staging):
            acc._staging[lane][...] = np.asarray(rows, dtype=np.uint8)
    if pending is not None:
        acc._pending = [[np.asarray(op, dtype=np.uint8).copy() for op in ops] for ops in pending]
    if finished is not None:
        acc._finished = [bool(f) for f in finished]


__all__ = [
    "FusedIneligible",
    "KERNELS",
    "MAX_LANES",
    "STACK_LIST",
    "StackedJobsAccumulator",
    "load_reference_state",
    "max_fused_jobs",
    "reset_launch_counts",
    "stacked_gram_accumulate",
    "stacked_gram_accumulate_grid",
    "stacked_gram_accumulate_plain",
    "stacked_gram_split",
    "stacked_unpack_rows_t",
    "stacked_unpack_rows_t_plain",
]
