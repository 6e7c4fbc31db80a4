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

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_examples_tpu_torch.ops import _kernels
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
    fsamp = ((s_u64 >> np.uint64(32)) ^ s_u64).astype(np.uint32).view(np.int32)
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


def gen_genotypes_plain(
    plan: GenPlan,
    grid_offset: int,
    n_valid: int,
    block_sites: int,
    kept: torch.Tensor,
    rows: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`gen_genotypes`: the same Xᵀ, and the same
    in-place counter increments, through :func:`generate_has_variation`
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
    hv = generate_has_variation(positions, T, plan.vs_keys, plan.col_pop, plan.set_sizes)
    xt = torch.zeros((plan.n_cols_pad, ld), dtype=torch.int8, device=device)
    xt[: plan.n_cols] = hv.T.to(torch.int8)
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
    """Plain version of :func:`gram_accumulate`: an int64 matmul on the CPU,
    a float64 matmul on the card (exact below 2^53; PyTorch has no CUDA
    integer matmul for these shapes)."""
    n = G.shape[0]
    X = xt[:n]
    wide = torch.int64 if G.device.type == "cpu" else torch.float64
    Xw = X.to(wide)
    G += (Xw @ Xw.T).to(G.dtype)


def gram_accumulate(G: torch.Tensor, xt: torch.Tensor) -> None:
    """``G += (Xᵀ·X)[:n, :n]`` in place, for the int32 (n, n) Gramian and a
    block's int8 Xᵀ from :func:`gen_genotypes`.

    Replaces the product half of ``experiments/pallas_fused_gramian.py:
    pallas_gram`` (the ``dot_general`` into the resident G) and the einsum of
    ``spark_examples_tpu/ops/devicegen.py:_fused_update``. CPU tensors take
    :func:`gram_accumulate_plain`; CUDA tensors launch
    ``gram_accumulate_kernel`` (``csrc/devicegen.cu``)."""
    if G.device.type == "cpu":
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
    lib = _library()
    with torch.cuda.device(G.device):
        status = lib.gram_accumulate_launch(
            G.data_ptr(),
            n,
            xt.data_ptr(),
            rows,
            ld,
            torch.cuda.current_stream(G.device).cuda_stream,
        )
    _kernels.check(status, "gram_accumulate")
    gram_accumulate.launches += 1


def gram_accumulate_grid(rows: int, device: torch.device) -> tuple[int, int]:
    """``gram_accumulate_kernel``'s launch on ``device`` for an Xᵀ of
    ``rows`` rows: (blocks, blocks resident at once). One block computes
    128 × 256 of G on or above the diagonal, over every site."""
    grid = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        _kernels.check(_library().gram_accumulate_grid(rows, grid), "gram_accumulate_grid")
    return grid[0], grid[1]


gram_accumulate.launches = 0  # type: ignore[attr-defined]

#: Every kernel wrapper of this module, for launch accounting.
KERNELS = (gen_genotypes, gram_accumulate)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0  # type: ignore[attr-defined]


class DeviceGenGramianAccumulator:
    """Fused on-device ingest and similarity for the synthetic source, on
    one device: the host walks the site grid in dispatch groups of
    ``blocks_per_dispatch`` blocks of ``block_size`` sites and sends only
    ``(grid_offset, n_valid)``; the card generates each block's genotypes
    and accumulates the int32 Gramian (exact: int8×int8→int32), a kept-site
    counter and per-set variant-row counters. Nothing is fetched until
    :meth:`ingest_counters` / :meth:`finalize`.

    Blocks past a group's valid count are skipped rather than computed as
    padding (they add nothing); ``sites_capacity`` still counts the whole
    group, as the reference accumulator's does.
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
    ):
        self.device = resolve_device(device)
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
        self.block_size = int(block_size)
        self.blocks_per_dispatch = int(blocks_per_dispatch)
        self.sites_per_dispatch = self.block_size * self.blocks_per_dispatch
        self._tail_blocks = max(1, self.blocks_per_dispatch // 8)
        self.plan = make_gen_plan(
            vs_keys,
            per_set,
            site_key,
            spacing,
            ref_block_fraction,
            min_af_micro,
            int(n_pops) if n_pops is not None else int(np.max(pops)) + 1,
            self.device,
        )
        C = self.total_columns
        self.G = torch.zeros((C, C), dtype=torch.int32, device=self.device)
        self.variant_rows = torch.zeros(
            (self.n_sets,), dtype=torch.int64, device=self.device
        )
        self.kept_sites = torch.zeros((), dtype=torch.int64, device=self.device)
        self.dispatches = 0
        #: dispatched site-grid capacity (padding included) vs the valid
        #: sites inside it — the dispatch padding waste.
        self.sites_capacity = 0
        self.sites_valid = 0

    def _dispatch(self, grid_offset: int, n_valid: int, blocks: int) -> None:
        B = self.block_size
        for k in range(blocks):
            valid = min(B, n_valid - k * B)
            if valid <= 0:
                break
            xt = gen_genotypes(
                self.plan, grid_offset + k * B, valid, B,
                self.kept_sites, self.variant_rows,
            )
            gram_accumulate(self.G, xt)
        self.dispatches += 1
        self.sites_capacity += blocks * B
        self.sites_valid += int(n_valid)

    def add_range(self, grid_offset: int, n_valid: int) -> None:
        """Dispatch one group covering grid indices
        ``[grid_offset, grid_offset + n_valid)`` (positions ``index ·
        spacing``); indices past ``n_valid`` are padding."""
        if not 0 < n_valid <= self.sites_per_dispatch:
            raise ValueError(
                f"n_valid must be in (0, {self.sites_per_dispatch}], got {n_valid}"
            )
        if grid_offset < 0:
            raise ValueError("grid_offset must be non-negative")
        self._dispatch(grid_offset, n_valid, self.blocks_per_dispatch)

    def add_grid(self, first_index: int, last_index: int) -> None:
        """Dispatch every group of the grid range ``[first_index,
        last_index)``: full groups, then the remainder in tail groups of
        ``blocks_per_dispatch // 8`` blocks."""
        main = self.sites_per_dispatch
        off = first_index
        while last_index - off >= main:
            self.add_range(off, main)
            off += main
        tail = self.block_size * self._tail_blocks
        while off < last_index:
            self._dispatch(off, min(tail, last_index - off), self._tail_blocks)
            off += tail

    def ingest_counters(self) -> Tuple[np.ndarray, int]:
        """``(per-set variant-row totals, kept-site total)``, fetched
        synchronously (so an ingest stage's wall-clock ends with its work)."""
        counters = torch.cat([self.variant_rows, self.kept_sites[None]]).cpu()
        return counters[:-1].numpy(), int(counters[-1])

    def finalize_device(self) -> torch.Tensor:
        """The accumulated int32 Gramian, still on the device."""
        return self.G

    def finalize(self) -> np.ndarray:
        return self.G.cpu().numpy().astype(np.float64)


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
    acc.G.copy_(torch.from_numpy(G.astype(np.int32)))
    acc.variant_rows.copy_(torch.from_numpy(rows))
    acc.kept_sites.fill_(int(np.asarray(kept_sites)))
    acc.dispatches = int(dispatches)
    acc.sites_capacity = int(sites_capacity)
    acc.sites_valid = int(sites_valid)


__all__ = [
    "COL_TILE",
    "DeviceGenGramianAccumulator",
    "GenPlan",
    "KERNELS",
    "SITE_TILE",
    "TABLE_PATHS",
    "auto_blocks_per_dispatch",
    "fmix32",
    "gen_genotypes",
    "gen_genotypes_grid",
    "gen_genotypes_plain",
    "generate_has_variation",
    "gram_accumulate",
    "gram_accumulate_grid",
    "gram_accumulate_plain",
    "load_reference_state",
    "make_gen_plan",
    "mix64",
    "reset_launch_counts",
    "site_thresholds_on_device",
]
