"""On-device synthetic ingest: site metadata and genotype generation fused
with Gramian accumulation, on one CUDA card.

The port of ``spark_examples_tpu/ops/devicegen.py``'s single-device dense
path. Per block of sites the host sends two scalars (a site-grid offset and
a valid count); the card rebuilds positions (``index · spacing``), the
per-site metadata (ref-block drops, Q32 allele frequencies, per-population
genotype thresholds, the ``--min-allele-frequency`` filter) bit-identically
to the host source, draws the {0,1} genotype matrix with the same
splitmix64/fmix32 streams, and accumulates ``G += XᵀX`` exactly in int32.

Two hand-written CUDA kernels carry it (``csrc/devicegen.cu``), each behind
a wrapper with a launch counter and a plain PyTorch version beside it:

- :func:`gen_genotypes` — the block's Xᵀ (columns × sites, int8) plus the
  kept-site and per-set variant-row counters;
- :func:`gram_accumulate` — ``G += Xᵀ·X`` into the resident int32 G.

A wrapper runs its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises. The plain versions emulate u64/u32 arithmetic
in int64 (wrap-around multiply, logical right shift as ``(x >> s) & mask``,
unsigned compare with the sign bit flipped): PyTorch on the CPU has no
``>>`` or ``<`` for ``uint32``/``uint64``. Tensors of "u64" values below
hold the same bits as int64.

Multi-set cohorts are column concatenations of per-set genotype matrices
(synthetic variant sets share the site grid): every column carries its set,
set-local sample index and population, so one kernel covers them.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_examples_tpu_torch.obs import schedule as _schedule
from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.parallel.mesh import run_on, spans_processes
from spark_examples_tpu_torch.sources.synthetic import (
    _AF_BASE_Q32,
    _AF_SPAN_Q16,
    _POP_BASE_Q16,
    _POP_HI_Q32,
    _POP_LO_Q32,
    _POP_SPAN_Q17,
)
from spark_examples_tpu_torch.utils.device import DeviceLike, resolve_device

# splitmix64 constants — must match sources/synthetic.py exactly.
_P1 = 0x9E3779B97F4A7C15
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0xD6E8FEB86659FD93
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1
_SIGN = -(1 << 63)
# Draw-stream tags (sources/synthetic.py).
_S_REF_BLOCK = 1
_S_AF = 2
_S_POP_BASE = 3
_S_GENOTYPE = 100

#: Tiling of csrc/devicegen.cu (checked against the library at load): Xᵀ is
#: padded to SITE_TILE sites per row and COL_TILE rows, the product's
#: 128-wide TMA box; the generation's own 64-site tiles divide both.
SITE_TILE = 128
COL_TILE = 128
#: Where ``gen_genotypes_kernel`` keeps a block's tables, by the code
#: ``gen_genotypes_grid`` reports (``csrc/devicegen.cu:GenPath``): shared
#: memory with the set flags gathered in registers (up to 8 sets), shared
#: memory with the flags ORed into bit rows of 32 sets, or a device buffer
#: for tables past shared memory.
TABLE_PATHS = ("few-set", "many-set", "global tables")

U64 = Union[torch.Tensor, int]


def _i64(value: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    value &= _MASK64
    return value - (1 << 64) if value >> 63 else value


def _srl(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Logical right shift of int64-held u64 values."""
    return (x >> shift) & ((1 << (64 - shift)) - 1)


def _ult(a: U64, b: U64) -> torch.Tensor:
    """Unsigned ``a < b`` of int64-held u64 values (one may be an int)."""

    def flip(v: U64) -> U64:
        return v ^ _SIGN if isinstance(v, torch.Tensor) else _i64(v) ^ _SIGN

    return flip(a) < flip(b)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64-held u64 values — bitwise-identical to
    ``sources/synthetic.py:_mix`` (tested)."""
    x = x + _i64(_P1)
    x = (x ^ _srl(x, 30)) * _i64(_M1)
    x = (x ^ _srl(x, 27)) * _i64(_M2)
    return x ^ _srl(x, 31)


def _u64_stream(key: U64, pos_term: torch.Tensor, stream: int) -> torch.Tensor:
    """``sources/synthetic.py:_u64(key, pos, stream)`` with default
    sample/allele — four chained mixes (the zero terms still mix)."""
    key = key if isinstance(key, torch.Tensor) else _i64(key)
    h = mix64(pos_term ^ key)
    h = mix64(h ^ _i64(stream * _P3))
    return mix64(mix64(h))


def site_thresholds_on_device(
    site_key: U64,
    positions: torch.Tensor,  # (B,) int64
    valid: torch.Tensor,  # (B,) bool
    n_pops: int,
    ref_block_fraction: float,
    min_af_micro: Optional[int],
) -> torch.Tensor:
    """(B, P) int64 Q32 genotype thresholds, zeroed for ref-block sites,
    AF-filtered sites and invalid (padding) rows — bit-identical to the
    host's ``site_threshold_plan`` values (``sources/synthetic.py``)."""
    pos_term = positions * _i64(_P2)
    ref_thresh = math.ceil(ref_block_fraction * 2.0**53)
    is_ref = _ult(_srl(_u64_stream(site_key, pos_term, _S_REF_BLOCK), 11), ref_thresh)
    u_af = _srl(_u64_stream(site_key, pos_term, _S_AF), 48)  # Q16
    af_q32 = _AF_BASE_Q32 + ((u_af * u_af * _AF_SPAN_Q16) >> 16)
    keep = valid & ~is_ref
    if min_af_micro is not None:
        # round-half-even(af_q32 · 1e6 / 2^32) > floor(threshold · 1e6):
        # the canonical micro-unit AF rule (utils/af.py:af_passes).
        x = af_q32 * 1_000_000
        q = x >> 32
        frac = x & _MASK32
        half = 1 << 31
        r = q + ((frac > half) | ((frac == half) & ((q & 1) == 1))).long()
        keep = keep & _ult(min_af_micro, r)
    pops = []
    for p in range(n_pops):
        u_p = _srl(_u64_stream(site_key, pos_term, _S_POP_BASE + p), 48)
        factor = _POP_BASE_Q16 + ((u_p * _POP_SPAN_Q17) >> 16)
        pops.append(((af_q32 * factor) >> 16).clamp(_POP_LO_Q32, _POP_HI_Q32))
    T = torch.stack(pops, dim=1)
    return torch.where(keep[:, None], T, torch.zeros_like(T))


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64-held u32 values — bitwise-identical to
    ``sources/synthetic.py:_fmix32`` (tested)."""
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _MASK32
    return x ^ (x >> 16)


def _fold32(x64: torch.Tensor) -> torch.Tensor:
    """The deliberate 64→32-bit fold (high xor low) of the genotype draw."""
    return (_srl(x64, 32) ^ x64) & _MASK32


def _allele_pair(
    h2_col: torch.Tensor, samples_u64: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two u32 allele draws from the per-site genotype state — the
    device half of ``sources/synthetic.py:_genotype_draw_pair``."""
    d1 = fmix32(_fold32(h2_col ^ samples_u64))
    d2 = ((d1 * 0x9E3779B9) & _MASK32) ^ 0x85EBCA6B
    return d1, d2


def generate_has_variation(
    positions: torch.Tensor,  # (B,) int64
    thresholds: torch.Tensor,  # (B, P) int64 Q32 thresholds, 0 = dropped
    vs_keys: Union[Sequence[int], torch.Tensor],  # per-set genotype stream keys
    pops: torch.Tensor,  # (N_total,) per-set cohorts' sample → population
    set_sizes: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """(B, ΣNₛ) bool has-variation rows, bitwise-equal to the host packed
    path (``sources/synthetic.py:genotype_blocks``) for kept sites; rows whose
    thresholds are zeroed come out all-zero. ``pops`` concatenates each set's
    population vector when ``set_sizes`` is given; otherwise every set shares
    the one cohort ``pops`` describes."""
    n_sets = len(vs_keys)
    sizes = (
        (len(pops),) * n_sets
        if set_sizes is None
        else tuple(int(s) for s in set_sizes)
    )
    offsets = [0] * n_sets if set_sizes is None else np.cumsum((0,) + sizes[:-1])
    pos_term = positions * _i64(_P2)
    parts = []
    for s in range(n_sets):
        key = vs_keys[s] if isinstance(vs_keys[s], torch.Tensor) else _i64(vs_keys[s])
        h2 = mix64(mix64(pos_term ^ key) ^ _i64(_S_GENOTYPE * _P3))[:, None]
        samples = torch.arange(sizes[s], device=positions.device) * _i64(_P4)
        d1, d2 = _allele_pair(h2, samples[None, :])
        tf = thresholds[:, pops[int(offsets[s]) : int(offsets[s]) + sizes[s]].long()]
        parts.append((d1 < tf) | (d2 < tf))
    return torch.cat(parts, dim=1)


# Measured sweet spot of the reference device program: constant device work
# per dispatch group across cohort sizes. The port keeps the rule so both
# packages walk the site grid in the same dispatch groups.
_TARGET_COLUMN_SITES = 524_288 * 2504


def auto_blocks_per_dispatch(total_columns: int, block_size: int) -> int:
    """Dispatch-group length in blocks: constant work per dispatch across
    cohort sizes, clamped to [32, 512] and rounded to a multiple of 8 (the
    tail group is K/8 blocks)."""
    k = _TARGET_COLUMN_SITES // max(int(total_columns), 1)
    k //= max(int(block_size), 1)
    return int(min(512, max(32, (k // 8) * 8)))


def _round_up(value: int, multiple: int) -> int:
    return -(-int(value) // multiple) * multiple


@dataclass(frozen=True)
class GenPlan:
    """What the generation kernel needs besides a block's two scalars: the
    site streams' parameters, the per-set cohort sizes, and one entry per
    cohort column (its variant set, population and ``fold(set-local sample
    index · P4)``)."""

    site_key: int
    spacing: int
    ref_block_fraction: float
    min_af_micro: Optional[int]
    n_pops: int
    vs_keys: torch.Tensor  # (S,) int64: u64 genotype stream keys
    set_sizes: Tuple[int, ...]
    col_set: torch.Tensor  # (C,) int32
    col_pop: torch.Tensor  # (C,) int32
    col_fsamp: torch.Tensor  # (C,) int32 holding u32 bits
    #: The cohort column of the plan's first column: 0, or a samples
    #: position's first column in a plan cut by :func:`slice_gen_plan`.
    col_start: int = 0

    @property
    def n_sets(self) -> int:
        return int(self.vs_keys.shape[0])

    @property
    def n_cols(self) -> int:
        return int(self.col_set.shape[0])

    @property
    def n_cols_pad(self) -> int:
        return _round_up(self.n_cols, COL_TILE)

    @property
    def ref_thresh(self) -> int:
        return math.ceil(self.ref_block_fraction * 2.0**53)


def make_gen_plan(
    vs_keys: Sequence[int],
    pops_per_set: Sequence[np.ndarray],
    site_key: int,
    spacing: int,
    ref_block_fraction: float,
    min_af_micro: Optional[int],
    n_pops: int,
    device: torch.device,
) -> GenPlan:
    """The column arrays of a (possibly multi-set) cohort, on ``device``."""
    if len(vs_keys) != len(pops_per_set):
        raise ValueError("one population vector per variant set")
    col_set = np.concatenate(
        [np.full(len(p), s, dtype=np.int32) for s, p in enumerate(pops_per_set)]
    )
    col_pop = np.concatenate([np.asarray(p, dtype=np.int32) for p in pops_per_set])
    local = np.concatenate(
        [np.arange(len(p), dtype=np.uint64) for p in pops_per_set]
    )
    with np.errstate(over="ignore"):
        s_u64 = local * np.uint64(_P4)
    fsamp = ((s_u64 >> np.uint64(32)) ^ s_u64).astype(np.uint32).view(np.int32)  # range: deliberate 64→32 bit FOLD (high xor low); the draw is defined on u32, so truncation is the hash, not a lost value
    if col_pop.size and (col_pop.min() < 0 or col_pop.max() >= n_pops):
        raise ValueError(f"populations must lie in [0, {n_pops})")
    keys = np.array([_i64(int(k)) for k in vs_keys], dtype=np.int64)
    return GenPlan(
        site_key=int(site_key) & _MASK64,
        spacing=int(spacing),
        ref_block_fraction=float(ref_block_fraction),
        min_af_micro=None if min_af_micro is None else int(min_af_micro),
        n_pops=int(n_pops),
        vs_keys=torch.from_numpy(keys).to(device),
        set_sizes=tuple(len(p) for p in pops_per_set),
        col_set=torch.from_numpy(col_set).to(device),
        col_pop=torch.from_numpy(col_pop).to(device),
        col_fsamp=torch.from_numpy(fsamp.copy()).to(device),
    )


def slice_gen_plan(plan: GenPlan, lo: int, hi: int) -> GenPlan:
    """``plan`` cut to its cohort columns ``[lo, hi)``: the column tables of
    one samples position, which ``gen_genotypes`` draws exactly as it draws
    those columns of the whole cohort (a column's draw is keyed by its set
    and set-local sample index, which the tables carry)."""
    if not 0 <= lo <= hi <= plan.n_cols:
        raise ValueError(f"columns [{lo}, {hi}) outside the plan's {plan.n_cols}")
    return dataclasses.replace(
        plan,
        col_set=plan.col_set[lo:hi].contiguous(),
        col_pop=plan.col_pop[lo:hi].contiguous(),
        col_fsamp=plan.col_fsamp[lo:hi].contiguous(),
        col_start=plan.col_start + lo,
    )


def generate_column_block(
    positions: torch.Tensor,  # (B,) int64
    thresholds: torch.Tensor,  # (B, P) int64 Q32 thresholds, 0 = dropped
    vs_keys: Union[Sequence[int], torch.Tensor],  # per-set genotype stream keys
    pops_local: torch.Tensor,  # (N_local,) the slice's column populations
    col_start: int,  # the slice's first cohort column
    num_samples: int,  # cohort columns (the sum of the per-set sizes)
    set_sizes: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """(B, N_local) bool has-variation of one column slice of the cohort,
    bitwise-equal to those columns of :func:`generate_has_variation`
    (a draw is keyed by the set-local sample index); columns past
    ``num_samples`` come out zero. ``pops_local`` slices the concatenated
    per-set population vector; ``set_sizes`` ``None`` is one set. The
    counterpart of ``spark_examples_tpu/ops/devicegen.py:
    generate_column_block``, each set's draws computed only over its own
    columns of the slice."""
    n_local = int(pops_local.shape[0])
    sizes = (int(num_samples),) if set_sizes is None else tuple(int(v) for v in set_sizes)
    pos_term = positions * _i64(_P2)
    t_full = thresholds[:, pops_local.long()]
    hv = torch.zeros((positions.shape[0], n_local), dtype=torch.bool, device=positions.device)
    offset = 0
    for s, size in enumerate(sizes):
        lo = max(offset, int(col_start))
        hi = min(offset + size, int(col_start) + n_local, int(num_samples))
        if lo < hi:
            key = vs_keys[s] if isinstance(vs_keys[s], torch.Tensor) else _i64(int(vs_keys[s]))
            h2 = mix64(mix64(pos_term ^ key) ^ _i64(_S_GENOTYPE * _P3))[:, None]
            samples = torch.arange(lo - offset, hi - offset, device=positions.device) * _i64(_P4)
            d1, d2 = _allele_pair(h2, samples[None, :])
            tf = t_full[:, lo - col_start : hi - col_start]
            hv[:, lo - col_start : hi - col_start] = (d1 < tf) | (d2 < tf)
        offset += size
    return hv


def gen_genotypes_plain(
    plan: GenPlan,
    grid_offset: int,
    n_valid: int,
    block_sites: int,
    kept: torch.Tensor,
    rows: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`gen_genotypes`: the same Xᵀ, and the same
    in-place counter increments, through :func:`generate_column_block`
    (the draws without the kernel's per-column fold tables)."""
    device = kept.device
    ld = _round_up(block_sites, SITE_TILE)
    idx = torch.arange(ld, dtype=torch.int64, device=device)
    positions = (int(grid_offset) + idx) * int(plan.spacing)
    T = site_thresholds_on_device(
        plan.site_key,
        positions,
        idx < int(n_valid),
        plan.n_pops,
        plan.ref_block_fraction,
        plan.min_af_micro,
    )
    hv = generate_column_block(
        positions, T, plan.vs_keys, plan.col_pop, plan.col_start,
        sum(plan.set_sizes), plan.set_sizes,
    )
    xt = torch.zeros((plan.n_cols_pad, ld), dtype=torch.int8, device=device)
    xt[: plan.n_cols] = hv.T.to(torch.int8)  # range: hv is {0,1} (ops/contracts.py:HAS_VARIATION), exact in int8
    kept += (T > 0).any(dim=1).sum()
    for s in range(plan.n_sets):
        rows[s] += hv[:, plan.col_set == s].any(dim=1).sum()
    return xt


@functools.lru_cache(maxsize=None)
def _library():
    """The kernels' library, its tiling checked against this module's."""
    lib = _kernels.library("devicegen.cu")
    got = (lib.devicegen_site_tile(), lib.devicegen_col_tile())
    if got != (SITE_TILE, COL_TILE):
        raise RuntimeError(f"csrc/devicegen.cu tiling {got} does not match ops/devicegen.py")
    return lib


def _require(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def gen_genotypes(
    plan: GenPlan,
    grid_offset: int,
    n_valid: int,
    block_sites: int,
    kept: torch.Tensor,
    rows: torch.Tensor,
) -> torch.Tensor:
    """Xᵀ (``n_cols_pad`` × ``round_up(block_sites, SITE_TILE)``, int8) of
    the sites at grid indices ``grid_offset + [0, block_sites)``, of which
    the first ``n_valid`` are real; adds the block's kept sites to ``kept``
    (0-dim int64) and its per-set variant rows to ``rows`` ((S,) int64).

    Replaces the generation half of ``experiments/pallas_fused_gramian.py:
    pallas_gram`` (``tile_hv``) and of ``spark_examples_tpu/ops/devicegen.py:
    _fused_update``. CPU tensors take :func:`gen_genotypes_plain`; CUDA
    tensors launch ``gen_genotypes_kernel`` (``csrc/devicegen.cu``)."""
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        return recording.launch(gen_genotypes, "generate", (), (kept, rows), plan,
                                grid_offset, n_valid, block_sites, kept, rows,
                                support=int(block_sites))
    if not 0 <= int(n_valid) <= int(block_sites):
        raise ValueError(f"n_valid must be in [0, {block_sites}], got {n_valid}")
    if int(grid_offset) < 0:
        raise ValueError("grid_offset must be non-negative")
    if kept.device.type == "cpu":
        return gen_genotypes_plain(plan, grid_offset, n_valid, block_sites, kept, rows)
    device = kept.device
    _require(kept, "kept", torch.int64, (), device)
    _require(rows, "rows", torch.int64, (plan.n_sets,), device)
    _require(plan.vs_keys, "vs_keys", torch.int64, (plan.n_sets,), device)
    for name in ("col_set", "col_pop", "col_fsamp"):
        _require(getattr(plan, name), name, torch.int32, (plan.n_cols,), device)
    ld = _round_up(block_sites, SITE_TILE)
    xt = torch.empty((plan.n_cols_pad, ld), dtype=torch.int8, device=device)
    lib = _library()
    with torch.cuda.device(device):
        words = _table_words(device.index, ld, plan.n_cols_pad, plan.n_pops, plan.n_sets)
        tables = torch.empty((words,), dtype=torch.int32, device=device) if words else None
        status = lib.gen_genotypes_launch(
            xt.data_ptr(),
            kept.data_ptr(),
            rows.data_ptr(),
            plan.vs_keys.data_ptr(),
            plan.col_fsamp.data_ptr(),
            plan.col_set.data_ptr(),
            plan.col_pop.data_ptr(),
            None if tables is None else tables.data_ptr(),
            words,
            int(grid_offset),
            int(n_valid),
            plan.spacing,
            plan.site_key,
            plan.ref_thresh,
            int(plan.min_af_micro is not None),
            (plan.min_af_micro or 0) & _MASK64,
            plan.n_pops,
            plan.n_sets,
            plan.n_cols,
            plan.n_cols_pad,
            ld,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _kernels.check(status, "gen_genotypes")
    gen_genotypes.launches += 1
    return xt


gen_genotypes.launches = 0  # type: ignore[attr-defined]


@functools.lru_cache(maxsize=None)
def _table_words(device_index: int, ld: int, n_cols_pad: int, n_pops: int, n_sets: int) -> int:
    """The device buffer (int32 words) ``gen_genotypes_kernel`` needs for
    its tables at these shapes on the current card: 0 where they fit shared
    memory. Depends on the card alone besides the shapes, so it is asked
    once."""
    words = (ctypes.c_int64 * 1)()
    _kernels.check(
        _library().gen_genotypes_table_words(ld, n_cols_pad, n_pops, n_sets, words),
        "gen_genotypes_table_words",
    )
    return words[0]


def gen_genotypes_grid(
    plan: GenPlan, block_sites: int, device: torch.device
) -> tuple[int, int, int, int, str]:
    """``gen_genotypes_kernel``'s launch on ``device`` for ``plan``'s
    columns and a block of ``block_sites`` sites: (blocks, blocks resident
    at once, the card's SMs, blocks a cluster, where the tables live: one of
    :data:`TABLE_PATHS`). One cluster per 64 sites, or per walk of tiles
    when the tables live in device memory."""
    grid = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        _kernels.check(
            _library().gen_genotypes_grid(
                _round_up(block_sites, SITE_TILE), plan.n_cols_pad, plan.n_pops, plan.n_sets, grid
            ),
            "gen_genotypes_grid",
        )
    return grid[0], grid[1], grid[2], grid[3], TABLE_PATHS[grid[4]]


def gram_accumulate_plain(G: torch.Tensor, xt: torch.Tensor) -> None:
    """Plain version of :func:`gram_accumulate`: an int64 matmul on the CPU
    (and ``meta`` tensors), a float64 matmul on the card (exact below 2^53;
    PyTorch has no CUDA integer matmul for these shapes)."""
    n = G.shape[0]
    X = xt[:n]
    wide = torch.float64 if G.is_cuda else torch.int64
    Xw = X.to(wide)
    G += (Xw @ Xw.T).to(G.dtype)


#: Output tiles of G a ``gram_accumulate`` block computes: one tile row of
#: this many 128 × 128 tiles (``csrc/devicegen.cu:G_BOXES``).
GRAM_UNIT_TILES = 2
#: The fewest steps of ``SITE_TILE`` along the contracted axis that a block
#: of a split product walks (measured on the card: PERF.md).
GRAM_SPLIT_MIN_STEPS = 2


def gram_units(rows: int) -> int:
    """Work units of a product over an Xᵀ of ``rows`` rows (a multiple of
    ``COL_TILE``): tile row ``bi`` of the upper triangle takes the column
    groups of ``GRAM_UNIT_TILES`` tiles from the one holding its diagonal
    tile on (``csrc/devicegen.cu:gram_units``)."""
    tiles = rows // COL_TILE
    groups = -(-tiles // GRAM_UNIT_TILES)
    return sum(groups - bi // GRAM_UNIT_TILES for bi in range(tiles))


def gram_split(rows: int, ld: int, sms: int) -> int:
    """Blocks a unit of the product splits its contracted axis (``ld``
    columns of Xᵀ, ``ld / SITE_TILE`` steps) over, on a card of ``sms``
    SMs: 1 where the units alone fill half the card (every Gramian at the
    1000 Genomes width and above: 110 units at 2,504 samples), else the
    most that keeps one wave and ``GRAM_SPLIT_MIN_STEPS`` steps a block.
    A split launch also gives each half of a unit's 128 rows a block of its
    own, so one wave is ``2 · units · split ≤ sms`` blocks (the LD window,
    2 units of 20 steps: 10 splits, 40 blocks). Each block adds its
    partial sums into G."""
    return _split(gram_units(rows), ld, sms)


def _split(units: int, ld: int, sms: int) -> int:
    """Blocks a unit of ``units`` splits ``ld`` sites over on ``sms`` SMs:
    1 where the units fill half the card, else the most that keeps one
    wave of half units and ``GRAM_SPLIT_MIN_STEPS`` steps a block."""
    if 2 * units >= sms:
        return 1
    return max(1, min(sms // (2 * units), (ld // SITE_TILE) // GRAM_SPLIT_MIN_STEPS))


def cross_units(m_pad: int, n_pad: int) -> int:
    """Units of 128 × 256 of C in a :func:`cross_accumulate` over A of
    ``m_pad`` rows and B of ``n_pad`` (multiples of ``COL_TILE``): every
    tile row of A against every group of ``GRAM_UNIT_TILES`` tiles of B."""
    return (m_pad // COL_TILE) * -(-(n_pad // COL_TILE) // GRAM_UNIT_TILES)


#: The fewest steps of ``SITE_TILE`` sites a part of a split
#: :func:`cross_accumulate` walks (measured on the card: PERF.md).
CROSS_SPLIT_MIN_STEPS = 4


def cross_split(m_pad: int, n_pad: int, ld: int, sms: int) -> int:
    """Parts of the sites a :func:`cross_accumulate` splits into: 1 where
    its units fill half the card (6,256 × 6,256: 1,225 units), else the
    most that keep one wave of 64-row blocks (two a unit a part) and
    ``CROSS_SPLIT_MIN_STEPS`` steps a part. At 632 × 632 (2,504 samples
    over 4 positions) 15 units: 4 parts at 16,384 sites (120 blocks on 132
    SMs), 2 at the CLI's 1,024 (60 blocks), where each part's partial tile
    costs more to add into C than its MMAs save."""
    units = cross_units(m_pad, n_pad)
    if 2 * units >= sms:
        return 1
    return max(1, min(sms // (2 * units), (ld // SITE_TILE) // CROSS_SPLIT_MIN_STEPS))


#: Blocks of an unsplit ``cross_accumulate``'s cluster, which share B's
#: column group (``csrc/devicegen.cu:CrossFull``; a split launch's blocks
#: run alone).
CROSS_CLUSTER = 2
#: Steps of ``SITE_TILE`` sites from which an unsplit item takes the deep
#: shape (``csrc/devicegen.cu:X_DEEP_STEPS``), and the stages of each shape.
CROSS_DEEP_STEPS = 32
CROSS_STAGES = {"full": 3, "deep": 4, "half": 4}


class CrossSchedule(NamedTuple):
    """One ``cross_accumulate`` launch (``csrc/devicegen.cu:cross_plan``)."""

    blocks: int  #: persistent blocks: clusters × ``cluster``
    cluster: int  #: blocks a cluster
    split: int  #: parts of the sites
    units: int  #: 128 × 256 units of C (:func:`cross_units`)
    items: int  #: (cluster row, column group, part) items the clusters walk
    rows: int  #: rows of C a block owns: 128 unsplit, 64 split
    stages: int  #: TMA stages a block keeps
    walk: bool  #: persistent clusters walk the items (unsplit); else a block an item


def cross_schedule(
    m_pad: int, n_pad: int, ld: int, sms: int, split: Optional[int] = None
) -> CrossSchedule:
    """The launch of a :func:`cross_accumulate` over A (``m_pad``, ``ld``)
    and B (``n_pad``, ``ld``) on a card of ``sms`` SMs, at ``split``
    (default :func:`cross_split`). An item is a cluster's rows against one
    column group of B over 1/split of the sites. Unsplit, a block owns 128
    rows and a cluster two row tiles, its blocks taking the same column
    group (each loads one of its boxes into both); the launch holds as
    many clusters as items, at most one an SM pair, and they take the
    items from a device counter. Split (one wave), a block owns 64 rows
    of one item, the items part by part."""
    split = cross_split(m_pad, n_pad, ld, sms) if split is None else int(split)
    walk = split == 1
    if walk:
        rows, cluster = COL_TILE, CROSS_CLUSTER
        shape = "deep" if ld // SITE_TILE >= CROSS_DEEP_STEPS else "full"
    else:
        rows, cluster, shape = COL_TILE // 2, 1, "half"
    cluster_rows = -(-m_pad // (cluster * rows))
    groups = -(-(n_pad // COL_TILE) // GRAM_UNIT_TILES)
    items = cluster_rows * groups * split
    blocks = (max(1, min(items, sms // cluster)) if walk else items) * cluster
    return CrossSchedule(blocks, cluster, split, cross_units(m_pad, n_pad), items, rows,
                         CROSS_STAGES[shape], walk)


class CrossWork(NamedTuple):
    """One block's share of one item (``csrc/devicegen.cu:cross_item``)."""

    item: int
    rank: int  #: the block's rank in its cluster
    row0: int  #: its first row of C (and of A)
    col0: int  #: the column group's first column (and row of B)
    boxes: int  #: B's 128-row boxes in the group: 1 takes the narrow MMA
    first: int  #: the first step of ``SITE_TILE`` sites
    steps: int

    @property
    def mma_n(self) -> int:
        """Columns of the block's MMA: m64n256k32, or m64n128k32 for a
        group of one box."""
        return self.boxes * COL_TILE


def cross_work(schedule: CrossSchedule, m_pad: int, n_pad: int, ld: int) -> Iterator[CrossWork]:
    """Every block's share of every item of ``schedule``, as the kernel
    decodes an item and a rank: split part ``item // (cluster_rows ·
    groups)`` of cluster row ``t % cluster_rows`` against column group ``t
    // cluster_rows``, ``t`` the item's place in its part (a split
    launch's block ``item`` takes item ``item``). A block whose rows lie
    past ``m_pad`` (the second of an odd row-tile count's last cluster)
    stores nothing and is left out."""
    steps = ld // SITE_TILE
    n_tiles = n_pad // COL_TILE
    span = schedule.cluster
    cluster_rows = -(-m_pad // (span * schedule.rows))
    per_part = cluster_rows * -(-n_tiles // GRAM_UNIT_TILES)
    for item in range(schedule.items):
        y, t = item // per_part, item % per_part
        cr, g = t % cluster_rows, t // cluster_rows
        first = y * steps // schedule.split
        last = (y + 1) * steps // schedule.split
        boxes = min(GRAM_UNIT_TILES, n_tiles - g * GRAM_UNIT_TILES)
        for rank in range(span):
            row0 = (cr * span + rank) * schedule.rows
            if row0 < m_pad:
                yield CrossWork(item, rank, row0, g * GRAM_UNIT_TILES * COL_TILE, boxes, first,
                                last - first)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def gram_accumulate(G: torch.Tensor, xt: torch.Tensor, split: Optional[int] = None) -> None:
    """``G += (Xᵀ·X)[:n, :n]`` in place, for the int32 (n, n) Gramian and a
    block's int8 Xᵀ from :func:`gen_genotypes`. ``split`` (blocks a unit
    splits the contracted axis over) defaults to :func:`gram_split` on
    this card; any split gives the same G.

    Replaces the product half of ``experiments/pallas_fused_gramian.py:
    pallas_gram`` (the ``dot_general`` into the resident G) and the einsum of
    ``spark_examples_tpu/ops/devicegen.py:_fused_update``. CPU tensors take
    :func:`gram_accumulate_plain`; CUDA tensors launch
    ``gram_accumulate_kernel`` (``csrc/devicegen.cu``)."""
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        return recording.launch(gram_accumulate, "product", (xt,), (G,), G, xt, split)
    if G.device.type in _kernels.PLAIN_DEVICES:
        gram_accumulate_plain(G, xt)
        return
    n = G.shape[0]
    _require(G, "G", torch.int32, (n, n))
    _require(xt, "xt", torch.int8, None, G.device)
    rows, ld = xt.shape
    if rows < n or rows % COL_TILE or ld % SITE_TILE:
        raise ValueError(
            f"xt must be ({COL_TILE}k ≥ {n}, {SITE_TILE}m), got {tuple(xt.shape)}"
        )
    if xt.data_ptr() % 16:
        raise ValueError("xt must start on a 16-byte boundary (its tensor map needs it)")
    if split is None:
        split = gram_split(rows, ld, _sms(G.device.index))
    if not 1 <= split <= max(1, ld // SITE_TILE):
        raise ValueError(f"split must be in [1, {max(1, ld // SITE_TILE)}], got {split}")
    lib = _library()
    with torch.cuda.device(G.device):
        status = lib.gram_accumulate_launch(
            G.data_ptr(),
            n,
            xt.data_ptr(),
            rows,
            ld,
            split,
            torch.cuda.current_stream(G.device).cuda_stream,
        )
    _kernels.check(status, "gram_accumulate")
    gram_accumulate.launches += 1


def gram_accumulate_grid(rows: int, ld: int, device: torch.device) -> tuple[int, int, int, int]:
    """``gram_accumulate_kernel``'s launch on ``device`` for an Xᵀ of
    ``rows`` × ``ld``: (blocks, blocks resident at once, the split, the
    card's SMs). A block computes 128 × 256 of G on or above the diagonal
    (64 × 256 where split) over ``ld / split`` of the columns."""
    grid = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        _kernels.check(_library().gram_accumulate_grid(rows, grid), "gram_accumulate_grid")
    if grid[0] != gram_units(rows):
        raise RuntimeError(f"csrc/devicegen.cu has {grid[0]} units at {rows} rows, "
                           f"ops/devicegen.py:gram_units {gram_units(rows)}")
    split = gram_split(rows, ld, grid[2])
    return grid[0] * split * (2 if split > 1 else 1), grid[1], split, grid[2]


gram_accumulate.launches = 0  # type: ignore[attr-defined]


def cross_accumulate_plain(C: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """Plain version of :func:`cross_accumulate`: an int64 product on the
    CPU (and ``meta`` tensors), float64 on the card (exact below 2^53)."""
    m, n = C.shape
    wide = torch.float64 if C.is_cuda else torch.int64
    C += (a[:m].to(wide) @ b[:n].to(wide).T).to(C.dtype)


#: The item counter of each (device, stream) that ``cross_accumulate``
#: launches on: zeroed once, and every launch leaves it zero.
_COUNTERS: dict = {}


def _cross_counter(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    counter = _COUNTERS.get(key)
    if counter is None:
        counter = _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return counter


def cross_accumulate_grid(
    m_pad: int, n_pad: int, ld: int, device: torch.device, split: Optional[int] = None
) -> Tuple[CrossSchedule, int]:
    """``cross_accumulate_kernel``'s launch on ``device``: the
    :func:`cross_schedule` (which must agree with the C launcher's, or this
    raises) and the clusters the card holds at once."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    grid = (ctypes.c_int * 7)()
    schedule = cross_schedule(m_pad, n_pad, ld, _sms(index), split)
    with torch.cuda.device(index):
        _kernels.check(_library().cross_accumulate_grid(m_pad, n_pad, ld, schedule.split, grid),
                       "cross_accumulate_grid")
    got = (grid[0], grid[1], grid[2], grid[3], grid[4], grid[6])
    want = (schedule.blocks, schedule.cluster, schedule.rows, schedule.items, _sms(index),
            schedule.stages)
    if got != want:
        raise RuntimeError(f"csrc/devicegen.cu launches (blocks, cluster, rows, items, SMs, "
                           f"stages) {got} at {m_pad} x {n_pad} x {ld}, "
                           f"ops/devicegen.py:cross_schedule {want}")
    return schedule, grid[5]


@functools.lru_cache(maxsize=None)
def _checked_schedule(index: int, m_pad: int, n_pad: int, ld: int, split: int) -> None:
    """:func:`cross_accumulate_grid` once for each launch shape."""
    cross_accumulate_grid(m_pad, n_pad, ld, torch.device("cuda", index), split)


def cross_accumulate(
    C: torch.Tensor, a: torch.Tensor, b: torch.Tensor, split: Optional[int] = None
) -> None:
    """``C += (A·Bᵀ)[:m, :n]`` in place, for an int32 (m, n) ``C`` whose
    rows may be strided (a column slice of a position's row tile) and two
    int8 operands in Xᵀ layout, ``a`` (m_pad, ld) and ``b`` (n_pad, ld):
    one ring step's product ``G_local[:, owner] += X_mineᵀ·X_owner``.
    ``a`` may be ``b``. ``split`` defaults to :func:`cross_split`; any
    split gives the same C.

    Replaces the ``jnp.matmul`` of ``spark_examples_tpu/ops/gramian.py:
    _ring_tiles`` and ``_hier_ring_tiles``. CPU tensors take
    :func:`cross_accumulate_plain`; CUDA tensors launch
    ``cross_accumulate_kernel`` (``csrc/devicegen.cu``) as
    :func:`cross_schedule` lays it out, its items taken from a counter kept
    for the (device, stream)."""
    if (sink := _schedule.SINK) is not None and (recording := sink()) is not None:
        return recording.launch(cross_accumulate, "product", (a, b), (C,), C, a, b, split)
    if C.ndim != 2:
        raise ValueError(f"C must be 2-D, got {tuple(C.shape)}")
    if C.device.type in _kernels.PLAIN_DEVICES:
        cross_accumulate_plain(C, a, b)
        return
    m, n = C.shape
    if C.dtype != torch.int32 or C.stride(1) != 1 or (m > 1 and C.stride(0) < n):
        raise ValueError("C must be int32 with unit column stride and rows of at least n")
    for name, t, need in (("a", a, m), ("b", b, n)):
        _require(t, name, torch.int8, None, C.device)
        if t.ndim != 2 or t.shape[0] < need or t.shape[0] % COL_TILE or t.shape[1] % SITE_TILE:
            raise ValueError(
                f"{name} must be ({COL_TILE}k ≥ {need}, {SITE_TILE}j), got {tuple(t.shape)}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (its tensor map needs it)")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"a and b must hold the same sites, got {a.shape[1]} and {b.shape[1]}")
    if m == 0 or n == 0:
        return
    ld = int(a.shape[1])
    # Rows of the operands past C's are never read.
    m_pad, n_pad = _round_up(m, COL_TILE), _round_up(n, COL_TILE)
    index = C.device.index
    if split is None:
        split = cross_split(m_pad, n_pad, ld, _sms(index))
    if not 1 <= split <= max(1, ld // SITE_TILE):
        raise ValueError(f"split must be in [1, {max(1, ld // SITE_TILE)}], got {split}")
    _checked_schedule(index, m_pad, n_pad, ld, split)
    lib = _library()
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        counter = _cross_counter(C.device, stream)
        status = lib.cross_accumulate_launch(
            C.data_ptr(),
            C.stride(0),
            m,
            n,
            a.data_ptr(),
            m_pad,
            b.data_ptr(),
            n_pad,
            ld,
            split,
            counter.data_ptr(),
            stream,
        )
    if status:  # the counter's state is unknown: the next launch starts from a zeroed one
        _COUNTERS.pop((index, stream), None)
    _kernels.check(status, "cross_accumulate")
    cross_accumulate.launches += 1


cross_accumulate.launches = 0  # type: ignore[attr-defined]

#: Every kernel wrapper of this module, for launch accounting.
KERNELS = (gen_genotypes, gram_accumulate, cross_accumulate)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0  # type: ignore[attr-defined]


def _no_span(name: str):
    return contextlib.nullcontext()


class _GridWalk:
    """The site-grid walk both device-generation accumulators share: groups
    of ``blocks_per_dispatch`` blocks, then the remainder in tail groups of
    ``blocks_per_dispatch // 8``, dealt round-robin over the ``data``
    slices, ``data`` groups a round (one slice: a round a group). A round
    counts as one dispatch of ``data`` groups' capacity, idle slices
    included — the reference's ``_GridDispatchAccumulator`` accounting.
    Subclasses give ``_blocks(d, grid_offset, n_valid, blocks)``: slice
    d's work for one group. With ``spans`` (a
    :class:`~spark_examples_tpu_torch.obs.spans.SpanRecorder`) each round
    is a ``dispatch`` span, so a profiler trace names the launch gaps by
    round."""

    data_parallel = 1

    def _init_walk(self, block_size: int, blocks_per_dispatch: int, spans=None) -> None:
        self.spans = spans
        self.block_size = int(block_size)
        self.blocks_per_dispatch = int(blocks_per_dispatch)
        self.sites_per_dispatch = self.block_size * self.blocks_per_dispatch
        self._tail_blocks = max(1, self.blocks_per_dispatch // 8)
        self.dispatches = 0
        #: dispatched site-grid capacity (padding included) vs the valid
        #: sites inside it — the dispatch padding waste.
        self.sites_capacity = 0
        self.sites_valid = 0

    def _blocks(self, d: int, grid_offset: int, n_valid: int, blocks: int) -> None:
        raise NotImplementedError

    def _round_robin(self, starts: Sequence[int], last_index: int, blocks: int) -> None:
        cap = blocks * self.block_size
        D = self.data_parallel
        span = self.spans.span if self.spans is not None else _no_span
        for i in range(0, len(starts), D):
            valid = 0
            with span("dispatch"):
                for d, start in enumerate(starts[i : i + D]):
                    n_valid = min(cap, last_index - start)
                    self._blocks(d, start, n_valid, blocks)
                    valid += n_valid
            self.dispatches += 1
            self.sites_capacity += cap * D
            self.sites_valid += valid

    def add_range(self, grid_offset: int, n_valid: int) -> None:
        """Dispatch one group covering grid indices
        ``[grid_offset, grid_offset + n_valid)`` (positions ``index ·
        spacing``); indices past ``n_valid`` are padding. With a data axis
        the group is a round of its own, on the first slice."""
        if not 0 < n_valid <= self.sites_per_dispatch:
            raise ValueError(
                f"n_valid must be in (0, {self.sites_per_dispatch}], got {n_valid}"
            )
        if grid_offset < 0:
            raise ValueError("grid_offset must be non-negative")
        self._round_robin([grid_offset], grid_offset + n_valid, self.blocks_per_dispatch)

    def add_grid(self, first_index: int, last_index: int) -> None:
        """Dispatch every group of the grid range ``[first_index,
        last_index)``: full groups, then the remainder in tail groups."""
        main = self.sites_per_dispatch
        n_main = max(0, last_index - first_index) // main
        rem = first_index + n_main * main
        self._round_robin(
            [first_index + i * main for i in range(n_main)], last_index, self.blocks_per_dispatch
        )
        tail = self.block_size * self._tail_blocks
        self._round_robin(list(range(rem, last_index, tail)), last_index, self._tail_blocks)


def _counter_totals(mesh, rows, kept, n_sets: int) -> Tuple[np.ndarray, int]:
    """The device-generation counters — per-set variant rows and kept
    sites, one tensor each a data slice (``None`` for another process's) —
    summed on the device, across processes when ``mesh`` spans them, and
    fetched in one host copy."""
    from spark_examples_tpu_torch.parallel.collectives import rank_reduce

    held = [torch.cat([r, k.reshape(1)]) for r, k in zip(rows, kept) if r is not None]
    device = held[0].device if held else mesh.home
    total = torch.zeros((n_sets + 1,), dtype=torch.int64, device=device)
    for part in held:
        total += part.to(device)
    if mesh is not None and mesh.shared:
        total = rank_reduce(total)
    flat = total.cpu().numpy()  # graftcheck: disable=GC001 -- the run's counters, summed on the device and fetched in one host copy when the ingest stage ends, not per block
    return flat[:n_sets], int(flat[n_sets])


class DeviceGenGramianAccumulator(_GridWalk):
    """Fused on-device ingest and similarity for the synthetic source: the
    host walks the site grid in dispatch groups of ``blocks_per_dispatch``
    blocks of ``block_size`` sites and sends only ``(grid_offset,
    n_valid)``; the card generates each block's genotypes and accumulates
    the int32 Gramian (exact: int8×int8→int32), a kept-site counter and
    per-set variant-row counters. Nothing is fetched until
    :meth:`ingest_counters` / :meth:`finalize`.

    Blocks past a group's valid count are skipped rather than computed as
    padding (they add nothing); ``sites_capacity`` still counts the whole
    group, as the reference accumulator's does.

    ``mesh`` adds the reference's ``data`` axis (``_fused_update_mesh``):
    groups go round-robin over the data slices (:class:`_GridWalk`), each
    generating and accumulating a different span of the grid into its own
    Gramian and counters on its position (the first of the slice) and
    stream. :meth:`finalize_device` sums the slices
    (:func:`~spark_examples_tpu_torch.ops.gramian.data_axis_sum`, int64
    past one). On a mesh that spans processes every process walks the same
    grid and generates its own slices' spans; the sums run across
    processes. ``spans`` records each dispatch round as a ``dispatch`` span
    (:class:`_GridWalk`).
    """

    def __init__(
        self,
        num_samples: int,
        vs_keys: Sequence[int],
        pops: np.ndarray,
        site_key: int,
        spacing: int,
        ref_block_fraction: float,
        min_af_micro: Optional[int] = None,
        block_size: int = 2048,
        blocks_per_dispatch: int = 32,
        n_pops: Optional[int] = None,
        set_sizes: Optional[Sequence[int]] = None,
        pops_per_set: Optional[Sequence[np.ndarray]] = None,
        device: DeviceLike = None,
        mesh=None,
        spans=None,
    ):
        self.mesh = mesh
        self._slices = [ring[0] for ring in mesh.data_slices()] if mesh is not None else [None]
        self.device = mesh.home if mesh is not None else resolve_device(device)
        self.data_parallel = len(self._slices)
        self.num_samples = int(num_samples)
        self.n_sets = len(vs_keys)
        if set_sizes is not None:
            self.set_sizes: Optional[Tuple[int, ...]] = tuple(int(s) for s in set_sizes)
            if len(self.set_sizes) != self.n_sets:
                raise ValueError(
                    f"set_sizes has {len(self.set_sizes)} entries for "
                    f"{self.n_sets} variant sets"
                )
            if pops_per_set is None or len(pops_per_set) != self.n_sets:
                raise ValueError("set_sizes needs matching pops_per_set")
            if any(len(p) != s for p, s in zip(pops_per_set, self.set_sizes)):
                raise ValueError("pops_per_set lengths must match set_sizes")
            per_set = [np.asarray(p) for p in pops_per_set]
        else:
            self.set_sizes = None
            per_set = [np.asarray(pops)] * self.n_sets
        self.total_columns = sum(len(p) for p in per_set)
        self._init_walk(block_size, blocks_per_dispatch, spans)
        n_pops = int(n_pops) if n_pops is not None else int(np.max(pops)) + 1
        C = self.total_columns
        # One plan, Gramian and counters a data slice (``None`` for another
        # process's).
        self._plans, self._G, self._rows, self._kept = [], [], [], []
        for position in self._slices:
            if position is not None and not position.local:
                for state in (self._plans, self._G, self._rows, self._kept):
                    state.append(None)
                continue
            device = self.device if position is None else position.device
            with run_on(position):
                self._plans.append(make_gen_plan(
                    vs_keys, per_set, site_key, spacing, ref_block_fraction,
                    min_af_micro, n_pops, device,
                ))
                self._G.append(torch.zeros((C, C), dtype=torch.int32, device=device))
                self._rows.append(torch.zeros((self.n_sets,), dtype=torch.int64, device=device))
                self._kept.append(torch.zeros((), dtype=torch.int64, device=device))
        self.plan = self._plans[0]

    def _sum(self, parts, like) -> torch.Tensor:
        from spark_examples_tpu_torch.ops.gramian import data_axis_sum

        self._join()
        if self.mesh is None:
            return parts[0]
        return data_axis_sum(parts, like=like, shared=self.mesh.shared)

    @property
    def G(self) -> torch.Tensor:
        """The Gramian so far: the one slice's, or the data axis's sum."""
        C = self.total_columns
        return self._sum(self._G, ((C, C), torch.int32))

    @property
    def variant_rows(self) -> torch.Tensor:
        """(n_sets,) int64 per-set variant rows, summed over data slices."""
        return self._sum(self._rows, ((self.n_sets,), torch.int64))

    @property
    def kept_sites(self) -> torch.Tensor:
        """0-dim int64 kept sites, summed over data slices."""
        return self._sum(self._kept, ((), torch.int64))

    def _join(self) -> None:
        if self.mesh is not None:
            self.mesh.join(self._G + self._rows + self._kept)

    def _blocks(self, d: int, grid_offset: int, n_valid: int, blocks: int) -> None:
        """Slice ``d``'s share of one dispatch: its valid blocks (another
        process's slice: nothing here)."""
        if self._G[d] is None:
            return
        B = self.block_size
        with run_on(self._slices[d]):
            for k in range(blocks):
                valid = min(B, n_valid - k * B)
                if valid <= 0:
                    break
                xt = gen_genotypes(
                    self._plans[d], grid_offset + k * B, valid, B, self._kept[d], self._rows[d],
                )
                gram_accumulate(self._G[d], xt)

    def ingest_counters(self) -> Tuple[np.ndarray, int]:
        """``(per-set variant-row totals, kept-site total)``, fetched
        synchronously in one copy (so an ingest stage's wall-clock ends
        with its work); data slices hold disjoint spans, so they sum."""
        self._join()
        return _counter_totals(self.mesh, self._rows, self._kept, self.n_sets)

    def finalize_device(self) -> torch.Tensor:
        """The accumulated Gramian, still on the device: int32 on one
        slice, int64 summed over a data axis."""
        return self.G

    def finalize(self) -> np.ndarray:
        return self.G.cpu().numpy().astype(np.float64)  # graftcheck: disable=GC001 -- one host copy of the finished Gramian (tests, host use), not a per-block sync


class DeviceGenRingGramianAccumulator(_GridWalk):
    """Sharded device ingest: on-device generation composed with the ring
    Gramian (the port of ``spark_examples_tpu/ops/devicegen.py:
    DeviceGenRingGramianAccumulator`` and its ``_ring_update``).

    Each samples position generates only its own columns of the cohort —
    ``gen_genotypes`` on its cut column tables (:func:`slice_gen_plan`),
    padded to the ring's tile — packs them (``ops/gramian.py:
    pack_rows_t``, under the packed wire; ``transpose_rows_t`` into uint8
    rows under the unpacked one) and ``ops/gramian.py:ring_pass``
    accumulates its row tile, so no position holds the N×N Gramian and no
    host→device data moves. A ``data`` axis adds grid parallelism on top:
    each slice runs its own ring over its own spans (:class:`_GridWalk`).

    Counters: a site is kept by its metadata alone, so the first position
    of a slice counts kept sites; a site counts for set s when any column
    of set s on any position varies, so each position takes its slice's
    per-set flags from its Xᵀ (one ``amax`` over a set's rows) and the
    first position ORs them and counts (the reference sums the flags over
    the samples axis, ``psum``, and counts ``> 0``); the kernel's own
    per-set counts cover one slice and are not summed.

    Multi-set cohorts (``set_sizes`` with ``pops_per_set``, or several
    ``vs_key`` sharing one cohort) concatenate per-set columns, as the
    dense accumulator does; a position's slice may span sets.

    On a mesh that spans processes every process walks the same grid and
    generates its own positions' columns; a ring's tiles cross processes
    in ``ring_pass``, and its per-set flags are ORed first over the
    ring's positions in each process, then over the ring's processes (a
    max over the ring's group) before the ring's first position counts.
    ``spans`` records each dispatch round as a ``dispatch`` span
    (:class:`_GridWalk`).
    """

    def __init__(
        self,
        num_samples: int,
        vs_key,
        pops: np.ndarray,
        site_key: int,
        spacing: int,
        ref_block_fraction: float,
        mesh,
        min_af_micro: Optional[int] = None,
        block_size: int = 1024,
        blocks_per_dispatch: int = 8,
        n_pops: Optional[int] = None,
        set_sizes: Optional[Sequence[int]] = None,
        pops_per_set: Optional[Sequence[np.ndarray]] = None,
        pack_bits: str = "auto",
        reduce_schedule: str = "auto",
        hier_hosts: Optional[int] = None,
        spans=None,
    ):
        from spark_examples_tpu_torch.ops.gramian import RingLayout
        from spark_examples_tpu_torch.parallel.mesh import SAMPLES_AXIS

        if mesh.shape.get(SAMPLES_AXIS, 1) < 2:
            raise ValueError("ring device ingest needs a samples axis >= 2")
        self.num_samples = int(num_samples)
        vs_keys = tuple(int(k) for k in vs_key) if isinstance(vs_key, (list, tuple)) else (int(vs_key),)
        self.n_sets = len(vs_keys)
        if set_sizes is not None:
            self.set_sizes: Optional[Tuple[int, ...]] = tuple(int(v) for v in set_sizes)
            if len(self.set_sizes) != self.n_sets:
                raise ValueError(
                    f"set_sizes has {len(self.set_sizes)} entries for {self.n_sets} variant sets"
                )
            if pops_per_set is None or len(pops_per_set) != self.n_sets:
                raise ValueError("set_sizes needs matching pops_per_set")
            if any(len(p) != v for p, v in zip(pops_per_set, self.set_sizes)):
                raise ValueError("pops_per_set lengths must match set_sizes")
            per_set = [np.asarray(p) for p in pops_per_set]
        else:
            per_set = [np.asarray(pops)] * self.n_sets
            self.set_sizes = (self.num_samples,) * self.n_sets if self.n_sets > 1 else None
        self.total_columns = sum(len(p) for p in per_set)
        self.layout = layout = RingLayout(
            mesh, self.total_columns, pack_bits, reduce_schedule, hier_hosts
        )
        self.mesh, self.pack, self.padded, self.n_local = mesh, layout.pack, layout.padded, layout.n_local
        self.samples_parallel, self.data_parallel = layout.samples_parallel, layout.data_parallel
        self.reduce_schedule, self.hier_hosts = layout.reduce_schedule, layout.hier_hosts
        self.device = layout.device
        self._init_walk(block_size, blocks_per_dispatch, spans)
        n_pops = int(n_pops) if n_pops is not None else int(np.concatenate(per_set).max()) + 1
        col_set = np.concatenate([np.full(len(p), s) for s, p in enumerate(per_set)])
        self._plans, self._ranges, self._kept, self._rows, self._scratch = [], [], [], [], []
        for ring in layout.rings:
            plans, ranges, scratch = [], [], []
            for s, position in enumerate(ring):
                lo = s * self.n_local
                hi = min(lo + self.n_local, self.total_columns)
                if not position.local:
                    plans.append(None)
                    ranges.append([])
                    scratch.append(None)
                    continue
                with position.run():
                    plan = None
                    if lo < hi:
                        plan = slice_gen_plan(make_gen_plan(
                            vs_keys, per_set, site_key, spacing, ref_block_fraction,
                            min_af_micro, n_pops, position.device,
                        ), lo, hi)
                    scratch.append((
                        torch.zeros((), dtype=torch.int64, device=position.device),
                        torch.zeros((self.n_sets,), dtype=torch.int64, device=position.device),
                    ))
                plans.append(plan)
                # Each set's rows of this position's Xᵀ.
                sets = col_set[lo:hi]
                ranges.append([
                    (int(v), int(np.argmax(sets == v)), int(len(sets) - np.argmax(sets[::-1] == v)))
                    for v in np.unique(sets)
                ])
            lead = ring[0]
            if lead.local:
                with lead.run():
                    self._kept.append(torch.zeros((), dtype=torch.int64, device=lead.device))
                    self._rows.append(torch.zeros((self.n_sets,), dtype=torch.int64, device=lead.device))
            else:
                self._kept.append(None)
                self._rows.append(None)
            self._plans.append(plans)
            self._ranges.append(ranges)
            self._scratch.append(scratch)

    @property
    def ring_bytes_total(self) -> int:
        """Bytes the ring moved so far by the reference's formula: every
        dispatched site (padding included) costs one circulation of its
        row's column tiles (``parallel/mesh.py:ring_traffic_bytes``)."""
        from spark_examples_tpu_torch.parallel.mesh import ring_traffic_bytes

        return ring_traffic_bytes(self.sites_capacity, self.samples_parallel, self.n_local, self.pack)

    def schedule_block(self) -> dict:
        """The manifest's ``schedule`` block; this path has no per-flush
        accounting, so measured is the projection (as in the reference)."""
        return self.layout.schedule(self.sites_capacity)

    def _blocks(self, d: int, grid_offset: int, n_valid: int, blocks: int) -> None:
        B = self.block_size
        for k in range(blocks):
            valid = min(B, n_valid - k * B)
            if valid <= 0:
                break
            self._ring_block(d, grid_offset + k * B, valid)
            self.layout.in_flight.mark()

    def _ring_block(self, d: int, grid_offset: int, valid: int) -> None:
        from spark_examples_tpu_torch.ops.gramian import pack_rows_t, ring_pass, transpose_rows_t
        from spark_examples_tpu_torch.parallel.collectives import fetch, rank_reduce, record

        B, n_local = self.block_size, self.n_local
        ring = self.layout.rings[d]
        if not any(p.local for p in ring):
            return
        ld, rows_pad = _round_up(B, SITE_TILE), _round_up(n_local, COL_TILE)
        own, ready, mine, flags = [], [], [], []
        for s, position in enumerate(ring):
            if not position.local:
                for held in (own, ready, mine, flags):
                    held.append(None)
                continue
            plan = self._plans[d][s]
            with position.run():
                if plan is None:
                    xt = torch.zeros((rows_pad, ld), dtype=torch.int8, device=position.device)
                else:
                    kept, rows = self._scratch[d][s]
                    xt = gen_genotypes(
                        plan, grid_offset, valid, B, self._kept[d] if s == 0 else kept, rows
                    )
                    if xt.shape[0] < rows_pad:  # a last slice of fewer tiles
                        xt = torch.cat([xt, xt.new_zeros((rows_pad - xt.shape[0], ld))])
                f = torch.zeros((self.n_sets, ld), dtype=torch.int8, device=position.device)
                for v, lo, hi in self._ranges[d][s]:
                    f[v] = xt[lo:hi].amax(dim=0)
                flags.append(f)
                mine.append(xt)
                # The wire carries the block's rows, (B, n_local / 8) packed or
                # (B, n_local) uint8: the bytes ``ring_traffic_bytes`` counts.
                own.append(pack_rows_t(xt, n_local, rows=B) if self.pack
                           else transpose_rows_t(xt, n_local, rows=B))
                ready.append(record(position))
        # OR the flags on this process's first position of the ring, then
        # over the ring's processes; the ring's first position counts.
        home = next(p for p in ring if p.local)
        gathered = [fetch(home, f, e) for f, e in zip(flags, ready) if f is not None]
        with home.run():
            union = torch.stack(gathered).amax(dim=0)
            if spans_processes(ring):
                union = rank_reduce(union, "max", group=self.layout.groups[d])
            if ring[0].local:
                self._rows[d] += (union != 0).sum(dim=1)
        ring_pass(ring, own, ready, mine, self.layout.G_local[d], n_local, self.pack,
                  self.layout.ring_hosts, max_count=1)

    def ingest_counters(self) -> Tuple[np.ndarray, int]:
        """``(per-set variant-row totals, kept-site total)`` in one host
        copy; data slices hold disjoint spans, so they sum."""
        self.layout.in_flight.drain()
        self.mesh.join(self._rows + self._kept)
        return _counter_totals(self.mesh, self._rows, self._kept, self.n_sets)

    def finalize_sharded(self):
        """The (padded, padded) Gramian as row tiles over ``samples``
        (``parallel/mesh.py:RowSharded``), int64 past one data slice."""
        return self.layout.finalize_tiles()

    def finalize(self) -> np.ndarray:
        from spark_examples_tpu_torch.parallel.mesh import host_value

        full = host_value(self.finalize_sharded())
        return full[: self.total_columns, : self.total_columns].astype(np.float64)


def load_reference_state(
    acc: DeviceGenGramianAccumulator,
    G: np.ndarray,
    variant_rows: np.ndarray,
    kept_sites,
    dispatches: int,
    sites_capacity: int,
    sites_valid: int,
) -> None:
    """Seed ``acc`` with state fetched from the reference package's
    ``DeviceGenGramianAccumulator`` (numpy arrays and counters), so a grid
    walk started there finishes here with the same result."""
    G = np.asarray(G)
    C = acc.total_columns
    if G.shape != (C, C):
        raise ValueError(f"G must be ({C}, {C}), got {G.shape}")
    if np.abs(G).max(initial=0) >= 2**31:
        raise ValueError("G entries exceed the int32 accumulator")
    rows = np.asarray(variant_rows, dtype=np.int64).reshape(acc.n_sets)
    if acc.data_parallel != 1:
        raise ValueError("reference state seeds a one-slice accumulator")
    acc._G[0].copy_(torch.from_numpy(G.astype(np.int32)))  # range: |G| < 2**31 is checked just above, so int32 holds every entry exactly
    acc._rows[0].copy_(torch.from_numpy(rows))
    acc._kept[0].fill_(int(np.asarray(kept_sites)))
    acc.dispatches = int(dispatches)
    acc.sites_capacity = int(sites_capacity)
    acc.sites_valid = int(sites_valid)


__all__ = [
    "COL_TILE",
    "CROSS_CLUSTER",
    "CrossSchedule",
    "CrossWork",
    "DeviceGenGramianAccumulator",
    "DeviceGenRingGramianAccumulator",
    "GenPlan",
    "KERNELS",
    "SITE_TILE",
    "TABLE_PATHS",
    "auto_blocks_per_dispatch",
    "cross_accumulate",
    "cross_accumulate_grid",
    "cross_accumulate_plain",
    "cross_schedule",
    "cross_split",
    "cross_units",
    "cross_work",
    "fmix32",
    "gen_genotypes",
    "gen_genotypes_grid",
    "gen_genotypes_plain",
    "generate_has_variation",
    "gram_accumulate",
    "gram_accumulate_grid",
    "gram_accumulate_plain",
    "gram_split",
    "gram_units",
    "load_reference_state",
    "make_gen_plan",
    "mix64",
    "reset_launch_counts",
    "site_thresholds_on_device",
]
