"""Per-site device work of the population-genetics analyses: windowed LD
statistics and association carrier counts.

The port's copy of ``spark_examples_tpu/ops/ld.py``. The PCA and GRM
reduction emits per-sample outputs (the N×N Gramian); the LD prune and the
association scan emit per-site statistics, and this module is their device
half. Both programs are stateless per call (a window or a block in, small
statistics out); the host consumes the statistics at once (the greedy
prune and the chi-square are host-sequential, scalar work in float64).

**Windowed LD** (:func:`ld_window_stats`): for a contig-ordered window
``X ∈ {0,1}^(W×N)`` of has-variation rows, the pairwise r² between sites
i, j needs only the co-carrier counts ``C = X Xᵀ`` and the per-site
carrier counts ``k`` (for binary x, ``Σx² = Σx``, so ``k = diag(C)``):

    r²_ij = (n·C_ij − k_i·k_j)² / ((n·k_i − k_i²) · (n·k_j − k_j²))

``C`` is the Gramian of ``Xᵀ``, so the port runs the two kernels of the
packed Gramian arm on it, no new CUDA: the host packs the window's
transpose (``np.packbits(X.T, axis=1)``: N rows of ⌈W/8⌉ bytes),
``ops/gramian.py:unpack_rows_t`` turns it into the int8 operand (W_pad
rows of sites, N_pad samples along the contracted axis) and
``ops/devicegen.py:gram_accumulate`` adds its product into a zeroed int32
``(W, W)``. Everything is exact integer arithmetic; the r² quotient is host
float64 (:func:`r2_from_counts`), shared with the NumPy oracle, so parity
is exact. A tail window runs on its rows only (the reference pads it to W
for one XLA compile; its padding rows are inert, so the kept mask over the
real rows is the same).

On a mesh with a ``samples`` axis (:func:`ld_window_stats` with ``mesh``,
the reference's ``build_ld_window_stats(mesh)``) the window's packing is
cut by rows — its rows are the samples, so position p of the first data
slice takes rows ``[p·N/S, (p+1)·N/S)`` — and each position runs the same
two kernels on its rows into its own zeroed ``C`` on its stream; one sum
over the positions (across processes too, ``rank_reduce``) completes
``C``, and ``k = diag(C)``. The window is replicated over the data axis, which carries no
per-site work here, so the first data slice's positions do it.

**Association counts** (:func:`case_counts`): per site, the carriers
among the cases ``a = X·case`` and in all ``t = X·1``, the two numbers the
allelic 2×2 chi-square needs (``analyses/assoc.py:chi2_from_counts``).
The block ships bit-packed (:func:`pack_rows`) and one hand-written
kernel, ``case_counts_kernel`` (``csrc/ld.cu``), counts with ``popc``
over 16-byte vectors, a few lanes a row.

As for every kernel wrapper of the port: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.ops.devicegen import _require, _round_up, _sms, gram_accumulate
from spark_examples_tpu_torch.ops.gramian import _packed_width, unpack_bits, unpack_rows_t
from spark_examples_tpu_torch.parallel.collectives import rank_reduce
from spark_examples_tpu_torch.parallel.mesh import SAMPLES_AXIS, host_value
from spark_examples_tpu_torch.utils.af import variance_counts
from spark_examples_tpu_torch.utils.device import DeviceLike

#: Row pitch of the shipped packed blocks: rows start on 16-byte
#: boundaries, so the kernel's lanes load whole aligned vectors.
ROW_PITCH = 16
#: Bytes of one load of ``case_counts_kernel``.
VECTOR_BYTES = 16
#: The most 16-byte vectors of a row one lane of ``case_counts_kernel``
#: loads: a lane's loads issue together, one trip to memory.
MAX_VECTORS_PER_LANE = 4
#: Threads of ``case_counts_kernel`` an SM holds (16 blocks of 128).
CASE_THREADS_PER_SM = 2048


# ------------------------------------------------------------ windowed LD


def pack_window(rows: np.ndarray) -> np.ndarray:
    """The window's transposed bit-packing, ``(N, ⌈W/8⌉)`` uint8: row j
    holds sample j's bits over the W sites (np.packbits' big-endian order,
    the unused low bits of the last byte zero) — the operand
    :func:`unpack_rows_t` turns into the LD product's int8 ``X``."""
    # packbits(X, axis=0)ᵀ is packbits(Xᵀ, axis=1), packed along the rows'
    # contiguous axis and then an eighth of the bytes transposed.
    return np.ascontiguousarray(np.packbits(np.asarray(rows, dtype=np.uint8), axis=0).T)


def window_counts(packed: torch.Tensor, num_sites: int) -> torch.Tensor:
    """``C = X Xᵀ`` (int32 ``(W, W)``, on ``packed``'s device) from a
    window's transposed packing: ``unpack_rows_t`` with the sites as its
    columns, then ``gram_accumulate`` into a zeroed ``C``, contracting over
    the samples."""
    xt = unpack_rows_t(packed, num_sites)
    C = torch.zeros((num_sites, num_sites), dtype=torch.int32, device=packed.device)
    gram_accumulate(C, xt)
    return C


def ld_window_stats(
    rows: np.ndarray, device: DeviceLike = "cpu", mesh=None
) -> Tuple[np.ndarray, np.ndarray]:
    """The window-statistics program: ``(W, N)`` {0,1} rows → ``(C (W, W)
    int32, k (W,) int32)``, on ``device`` (the card's kernels, or their
    plain versions on the CPU), or over ``mesh``'s samples axis (the
    cohort must divide over it). ``k = diag(C)``, exact because
    has-variation bits are {0,1}. Replaces ``spark_examples_tpu/ops/ld.py:
    build_ld_window_stats`` (its ``_window_counts_body``)."""
    rows = np.asarray(rows)
    packed = pack_window(rows)
    W = rows.shape[0]
    if mesh is None or mesh.shape.get(SAMPLES_AXIS, 1) < 2:
        C = window_counts(torch.from_numpy(packed).to(device), W).cpu().numpy()  # graftcheck: disable=GC001 -- deliberate per-window fetch: the greedy prune is host-sequential by design, and the window (not the block) is the bounded unit of device work
        return C, np.diagonal(C).copy()
    positions = mesh.data_slices()[0]
    per = packed.shape[0] // len(positions)
    parts = []
    for s, position in enumerate(positions):
        if not position.local:
            parts.append(None)
            continue
        with position.run():
            shard = torch.from_numpy(packed[s * per : (s + 1) * per]).to(position.device)
            parts.append(window_counts(shard, W))
    mesh.join(parts)
    total = torch.zeros((W, W), dtype=torch.int32, device=mesh.home)
    for part in parts:
        if part is not None:
            total += part.to(total.device)
    if mesh.shared:
        total = rank_reduce(total)
    C = host_value(total)
    return C, np.diagonal(C).copy()


def ld_window_stats_reference(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host NumPy oracle of the window-statistics program."""
    X = np.asarray(rows, dtype=np.int64)
    return (X @ X.T).astype(np.int64), X.sum(axis=1).astype(np.int64)


def r2_from_counts(C: np.ndarray, k: np.ndarray, num_samples: int) -> np.ndarray:
    """Pairwise r² from integer window statistics, float64, with the
    zero-variance guard: pairs involving a monomorphic site (variance
    numerator ``k·(n−k) == 0``) get r² = 0 — no correlation evidence,
    never NaN. The numerator/denominator are exact int64 products of the
    device-counted integers, so the oracle and the device path compute
    the IDENTICAL float64 quotient."""
    n = int(num_samples)
    C = np.asarray(C, dtype=np.int64)
    k = np.asarray(k, dtype=np.int64)
    cov = n * C - k[:, None] * k[None, :]
    var = variance_counts(k, n)  # k·(n−k), exactly 0 for monomorphic
    denom = (var[:, None] * var[None, :]).astype(np.float64)
    num = cov.astype(np.float64) ** 2
    out = np.zeros_like(num)
    np.divide(num, denom, out=out, where=denom > 0)
    return out


def greedy_prune(
    C: np.ndarray,
    k: np.ndarray,
    num_samples: int,
    r2_threshold: float,
    valid: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Greedy windowed LD prune: walk sites in window (position) order,
    keep site i iff its r² against EVERY previously-kept site in the
    window is <= ``r2_threshold`` (prune strictly above, mirroring the
    ``--min-allele-frequency`` strictly-greater convention). Deterministic
    by construction — the walk order is the contig order. ``valid`` masks
    out tail-padding rows (never kept, never pruned against). Returns the
    kept bool mask over the window."""
    r2 = r2_from_counts(C, k, num_samples)
    W = r2.shape[0]
    kept = np.zeros(W, dtype=bool)
    kept_idx: list = []  # bounded by W, the window size — not O(M)
    for i in range(W):
        if valid is not None and not valid[i]:
            continue
        if kept_idx and float(r2[i, kept_idx].max()) > r2_threshold:
            continue
        kept[i] = True
        kept_idx.append(i)
    return kept


# ------------------------------------------------------- association counts


def pack_rows(rows: np.ndarray, device: DeviceLike = "cpu") -> torch.Tensor:
    """A block of ``(B, N)`` {0,1} rows bit-packed on the host
    (np.packbits, big-endian) and shipped to ``device``: the ``(B,
    ⌈N/8⌉)`` view of a zero-padded ``(B, pitch)`` buffer whose rows start
    every :data:`ROW_PITCH` bytes."""
    rows = np.asarray(rows, dtype=np.uint8)
    width = _packed_width(rows.shape[1])
    host = np.zeros((rows.shape[0], _round_up(width, ROW_PITCH)), dtype=np.uint8)
    host[:, :width] = np.packbits(rows, axis=1)
    return torch.from_numpy(host).to(device)[:, :width]


def pack_case(case: np.ndarray, device: DeviceLike = "cpu") -> torch.Tensor:
    """The ``(N,)`` {0,1} case mask bit-packed the same way, ``(⌈N/8⌉,)``
    uint8 on ``device``: the view of a zero-padded buffer of
    :data:`ROW_PITCH`-rounded bytes, so the kernel reads it in whole
    16-byte vectors as it reads the rows."""
    packed = np.packbits(np.asarray(case, dtype=np.uint8))
    host = np.zeros(_round_up(packed.size, ROW_PITCH), dtype=np.uint8)
    host[: packed.size] = packed
    return torch.from_numpy(host).to(device)[: packed.size]


def case_counts_lanes(width: int, rows: int, sms: int) -> int:
    """Lanes of ``case_counts_kernel`` a row of ``width`` packed bytes, in
    a launch of ``rows`` rows on a card of ``sms`` SMs: a power of two,
    as many as give the launch half the threads the card holds
    (:data:`CASE_THREADS_PER_SM` an SM), at least as many as leave a lane
    at most :data:`MAX_VECTORS_PER_LANE` of the row's 16-byte vectors, at
    most a warp and at most the row's vectors. At 2,504 samples (20
    vectors) on 132 SMs: 32 at the CLI's 1,024 rows, 8 at 16,384."""
    vectors = -(-int(width) // VECTOR_BYTES)
    most = min(32, _pow2_at_least(vectors))
    least = min(most, _pow2_at_least(-(-vectors // MAX_VECTORS_PER_LANE)))
    fill = max(1, int(sms) * CASE_THREADS_PER_SM // 2 // max(int(rows), 1))
    return max(least, min(most, 1 << (fill.bit_length() - 1)))


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def case_counts_vector_path(
    pitch: int, rows: int, width: int, block_ptr: int, block_bytes: int,
    case_ptr: int, case_bytes: int,
) -> bool:
    """Whether ``case_counts`` takes 16-byte loads (``case_counts_kernel``)
    or assembles its vectors from bytes (``case_counts_bytes_kernel``):
    vectors where the pitch and both pointers are multiples of 16 and every
    row's and the case mask's ``width`` bytes, rounded up to 16, lie inside
    their storages (``*_bytes``: what the storage holds from the pointer
    on). :func:`pack_rows` and :func:`pack_case` ship such buffers."""
    span = _round_up(width, VECTOR_BYTES)
    return (
        pitch % VECTOR_BYTES == 0
        and block_ptr % VECTOR_BYTES == 0
        and case_ptr % VECTOR_BYTES == 0
        and (rows - 1) * pitch + span <= block_bytes
        and span <= case_bytes
    )


def case_counts_vectors(block: torch.Tensor, case: torch.Tensor) -> bool:
    """:func:`case_counts_vector_path` for these tensors (a ``(B, W)``
    block, its rows ``block.stride(0)`` bytes apart, and a ``(W,)`` case
    mask)."""
    rows, width = block.shape
    return case_counts_vector_path(
        int(block.stride(0)), int(rows), int(width),
        block.data_ptr(), block.untyped_storage().nbytes() - block.storage_offset(),
        case.data_ptr(), case.untyped_storage().nbytes() - case.storage_offset(),
    )


def case_counts_plain(
    block: torch.Tensor, case: torch.Tensor, num_columns: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`case_counts`: unpack the bits (columns past
    ``num_columns`` dropped), int64 sums, int32 out."""
    X = unpack_bits(block, num_columns)
    c = unpack_bits(case, num_columns)
    return (
        (X * c).sum(dim=1, dtype=torch.int64).to(torch.int32),  # range: HAS_VARIATION bits times a {0,1} case mask sum to at most N < 2^31 per site
        X.sum(dim=1, dtype=torch.int64).to(torch.int32),  # range: HAS_VARIATION bits sum to at most N < 2^31 per site
    )


@functools.lru_cache(maxsize=None)
def _library():
    return _kernels.library("ld.cu")


def case_counts(
    block: torch.Tensor, case: torch.Tensor, num_columns: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-site ``(a, t)``, int32 ``(B,)`` each: the carriers among the
    cases and in all, from a bit-packed block ``(B, ⌈N/8⌉)`` uint8 (its
    rows any pitch apart: ``block.stride(0)``, as :func:`pack_rows` ships
    them) and the packed case mask ``(⌈N/8⌉,)``; bits of columns past
    ``num_columns`` count nothing.

    Replaces ``spark_examples_tpu/ops/ld.py:build_case_counts``. CPU
    tensors take :func:`case_counts_plain`; CUDA tensors launch
    ``case_counts_kernel`` (``csrc/ld.cu``: 16-byte loads, where
    :func:`case_counts_vector_path` allows them) or
    ``case_counts_bytes_kernel`` (byte loads), with
    :func:`case_counts_lanes` lanes a row."""
    width = _packed_width(num_columns)
    if block.dtype != torch.uint8:
        raise TypeError(f"block: expected {torch.uint8}, got {block.dtype}")
    if block.ndim != 2 or block.shape[1] != width or block.stride(1) != 1:
        raise ValueError(
            f"block must be (B, {width}) uint8 rows of packed bytes for "
            f"{num_columns} columns, got {tuple(block.shape)} with strides {block.stride()}"
        )
    _require(case, "case", torch.uint8, (width,), block.device)
    if block.device.type == "cpu":
        return case_counts_plain(block, case, num_columns)
    rows = int(block.shape[0])
    a = torch.empty(rows, dtype=torch.int32, device=block.device)
    t = torch.empty(rows, dtype=torch.int32, device=block.device)
    if rows == 0:
        return a, t
    with torch.cuda.device(block.device):
        status = _library().case_counts_launch(
            block.data_ptr(), rows, width, int(block.stride(0)),
            int(case_counts_vectors(block, case)), case.data_ptr(),
            int(num_columns), case_counts_lanes(width, rows, _sms(block.device.index)),
            a.data_ptr(), t.data_ptr(),
            torch.cuda.current_stream(block.device).cuda_stream,
        )
    _kernels.check(status, "case_counts")
    case_counts.launches += 1
    return a, t


case_counts.launches = 0  # type: ignore[attr-defined]

#: Every kernel wrapper of this module, for launch accounting.
KERNELS = (case_counts,)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0  # type: ignore[attr-defined]


def block_case_counts(
    rows: np.ndarray, case: torch.Tensor, device: DeviceLike = "cpu"
) -> Tuple[np.ndarray, np.ndarray]:
    """One block's ``(a, t)`` as host int32 arrays: the rows packed and
    shipped (:func:`pack_rows`), :func:`case_counts` against the packed
    case mask ``case`` already on ``device``, then one fetch."""
    rows = np.asarray(rows)
    a, t = case_counts(pack_rows(rows, device), case, rows.shape[1])
    return a.cpu().numpy(), t.cpu().numpy()  # graftcheck: disable=GC001 -- deliberate per-block fetch: the chi-square close-out and the bounded ranking are host-side scalar work on two B-length vectors


def case_counts_reference(rows: np.ndarray, case: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host NumPy oracle of the association-counts program."""
    X = np.asarray(rows, dtype=np.int64)
    c = np.asarray(case, dtype=np.int64)
    return X @ c, X.sum(axis=1)


__all__ = [
    "KERNELS",
    "block_case_counts",
    "case_counts",
    "case_counts_lanes",
    "case_counts_plain",
    "case_counts_reference",
    "case_counts_vector_path",
    "case_counts_vectors",
    "greedy_prune",
    "ld_window_stats",
    "ld_window_stats_reference",
    "pack_case",
    "pack_rows",
    "pack_window",
    "r2_from_counts",
    "reset_launch_counts",
    "window_counts",
]
