"""Deterministic synthetic genomics backend.

This is the fake-backend test seam the reference authors wished for
(``SearchVariantsExample.scala:74-76``) promoted to a first-class component,
and it doubles as the benchmark data plane.

Design rules:

- **Partition invariance.** Every random draw is counter-based hashing
  (splitmix64 finalizer) keyed by ``(seed, variant_set_id, contig, absolute
  position, stream, sample, allele)``. Any shard of any window therefore
  generates byte-identical records — the synthetic analog of
  ``ShardBoundary.STRICT`` exactness, and the property that makes
  determinism tests across device counts meaningful.
- **Population structure.** Samples are assigned to ``n_pops`` blocks with
  per-population allele-frequency shifts, so the flagship PCoA pipeline
  produces separable clusters (a meaningful end-to-end signal, not noise).
- **Two paths, one implementation.** The wire path yields the same JSON
  record shapes the reference's Java client deserializes; the packed path
  (:meth:`SyntheticGenomicsSource.genotype_blocks`) yields dense
  ``{0,1}`` has-variation blocks ready for the MXU Gramian. Both call the
  same ``_u01`` hash streams, and a test asserts they agree.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from spark_examples_tpu_torch.constants import Examples
from spark_examples_tpu_torch.sharding.contig import Contig, SexChromosomeFilter, filter_sex_chromosomes
from spark_examples_tpu_torch.sources.base import (
    GenomicsClient,
    GenomicsSource,
    ShardBoundary,
)
from spark_examples_tpu_torch.utils.murmur3 import murmur3_x64_128

_U64 = np.uint64
_P1 = _U64(0x9E3779B97F4A7C15)
_P2 = _U64(0xC2B2AE3D27D4EB4F)
_P3 = _U64(0x165667B19E3779F9)
_P4 = _U64(0xD6E8FEB86659FD93)

# Draw-stream tags.
_S_REF_BLOCK = 1
_S_AF = 2
_S_POP_BASE = 3  # stream 3+p for population p
_S_REF_BASE = 20
_S_ALT_BASE = 21
_S_GENOTYPE = 100
_S_READ_MAPQ = 200
_S_READ_BASEQ = 201
_S_READ_ALLELE = 202
_S_SOMATIC = 203
_S_GERMLINE_BASE = 204

_BASES = "ACGT"

#: SearchVariants page size of the synthetic wire path — request accounting
#: in the packed/device ingest paths mirrors it (one request per page per
#: shard, at least one per shard).
VARIANTS_PAGE_SIZE = 1024


def _af6(af: np.ndarray) -> np.ndarray:
    """Canonical 6-decimal AF, shared by every path.

    The wire format serializes AF as ``f"{af6:.6f}"`` and the reference's
    filter parses it back (``VariantsPca.scala:136-148``); rounding BEFORE
    serializing makes ``float(f"{_af6(af):.6f}") == _af6(af)`` an exact
    round-trip, so the packed/device paths (which compare ``_af6(af)``
    directly) and the wire path (which compares the parsed string) apply
    ``--min-allele-frequency`` identically on threshold-adjacent sites.
    (For Q32 allele frequencies ``k·2⁻³²``, ``af·1e6 = k·1e6·2⁻³² < 2⁵²`` is
    exact in float64, so NumPy's round-half-even here equals the integer
    rounding the device kernel uses.)
    """
    return np.round(np.asarray(af) * 1e6) / 1e6


# Fixed-point site-field constants (Q16/Q32). All site metadata is
# derived with u64-only arithmetic so the device ingest kernel
# (``ops/devicegen.py``) can recompute it bit-identically from positions
# alone — no per-site host→device traffic. The float forms used by the wire
# path are exact dyadic rationals (k·2⁻³²); the genotype draws compare
# against the Q32 integers directly (``_genotype_draw_pair``), identically
# on host and device.
_AF_BASE_Q32 = round(0.01 * 2**32)  # af = 0.01 + u²·0.49
_AF_SPAN_Q16 = round(0.49 * 2**16)
_POP_BASE_Q16 = round(0.25 * 2**16)  # af_pop = af·(0.25 + 1.5·u_p), clipped
_POP_SPAN_Q17 = round(1.5 * 2**16)
_POP_LO_Q32 = round(0.002 * 2**32)
_POP_HI_Q32 = round(0.95 * 2**32)


# Canonical AF-filter rule shared with the driver and device kernel.
from spark_examples_tpu_torch.utils.af import af_filter_micro, af_passes  # noqa: E402


def _site_fields_q(site_key: np.uint64, positions: np.ndarray, ref_block_fraction: float, n_pops: int):
    """Integer site metadata: (is_ref_block, af_q32 (B,), af_pop_q32 (B, P)).

    Every operation is a u64 shift/multiply/add with no intermediate over
    2⁶⁴, mirrored exactly by the jitted kernel in ``ops/devicegen.py``.
    """
    ref_thresh = _U64(math.ceil(ref_block_fraction * 2.0**53))
    is_ref_block = (_u64(site_key, positions, _S_REF_BLOCK) >> _U64(11)) < ref_thresh
    u_af = _u64(site_key, positions, _S_AF) >> _U64(48)  # Q16
    u2 = u_af * u_af  # Q32, fits 32 bits
    af_q32 = _U64(_AF_BASE_Q32) + ((u2 * _U64(_AF_SPAN_Q16)) >> _U64(16))
    pops = []
    for p in range(n_pops):
        u_p = _u64(site_key, positions, _S_POP_BASE + p) >> _U64(48)  # Q16
        factor_q16 = _U64(_POP_BASE_Q16) + ((u_p * _U64(_POP_SPAN_Q17)) >> _U64(16))
        af_pop = (af_q32 * factor_q16) >> _U64(16)
        pops.append(np.clip(af_pop, _U64(_POP_LO_Q32), _U64(_POP_HI_Q32)))
    return is_ref_block, af_q32, np.stack(pops, axis=1)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 arrays (wrapping mod 2^64)."""
    with np.errstate(over="ignore"):
        x = (x + _P1).astype(_U64)
        x = ((x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)).astype(_U64)
        x = ((x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)).astype(_U64)
        return (x ^ (x >> _U64(31))).astype(_U64)


def _string_key(s: str) -> np.uint64:
    return _U64(int.from_bytes(murmur3_x64_128(s.encode("utf-8"))[:8], "little"))


def _u01(key: np.uint64, pos, stream: int, sample=0, allele=0) -> np.ndarray:
    """Deterministic uniform [0,1) draws keyed by all arguments.

    ``pos`` / ``sample`` / ``allele`` may be scalars or broadcastable arrays.
    """
    with np.errstate(over="ignore"):
        h = _mix(key ^ (np.asarray(pos, dtype=np.int64).astype(_U64) * _P2))
        h = _mix(h ^ (_U64(stream) * _P3))
        h = _mix(h ^ (np.asarray(sample, dtype=np.int64).astype(_U64) * _P4))
        h = _mix(h ^ (np.asarray(allele, dtype=np.int64).astype(_U64) * _P1))
    return (h >> _U64(11)).astype(np.float64) * (2.0**-53)


def _u64(key: np.uint64, pos, stream: int, sample=0, allele=0) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = _mix(key ^ (np.asarray(pos, dtype=np.int64).astype(_U64) * _P2))
        h = _mix(h ^ (_U64(stream) * _P3))
        h = _mix(h ^ (np.asarray(sample, dtype=np.int64).astype(_U64) * _P4))
        h = _mix(h ^ (np.asarray(allele, dtype=np.int64).astype(_U64) * _P1))
    return h


# ---- the genotype draw stream (the hot path) -------------------------------
#
# The genotype data plane is the only stream drawn per (site, sample) — at
# whole-genome scale that is ~10¹¹ draws, and its hash cost bounds ingest
# throughput (see DESIGN.md "single-chip ingest roofline"). It therefore uses
# a cheaper construction than the general-purpose ``_u64`` stream: the 64-bit
# per-site state ``h₂`` (same splitmix64 prefix as ``_u64`` with
# ``stream=_S_GENOTYPE``) is xor-combined with the sample term and FOLDED to
# 32 bits, then finalized with ONE murmur3 fmix32 — 1 u64 xor + 2 u32
# multiplies per (site, sample) instead of three full splitmix64 rounds
# (6 u64 multiplies, each ~3 u32 multiplies once XLA emulates u64 on TPU).
# The second allele's draw is a multiplicative re-mix of the first (one more
# u32 multiply). Folding AFTER the sample xor keeps the pre-fold state
# unique per (site, sample): fold collisions are isolated scalar
# coincidences (~2⁻³² per pair), never whole shared genotype rows.
# Allele draws compare directly against the Q32 integer thresholds
# (``draw32 < af_pop_q32`` ⟺ ``draw32·2⁻³² < af_pop``) — the device kernel
# (``ops/devicegen.py``) reproduces this bit for bit.

_GOLD32 = np.uint32(0x9E3779B9)
_FMIX_C1 = np.uint32(0x85EBCA6B)
_FMIX_C2 = np.uint32(0xC2B2AE35)


def _fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 finalizer, vectorized over uint32 (wrapping mod 2^32)."""
    with np.errstate(over="ignore"):
        x = ((x ^ (x >> np.uint32(16))) * _FMIX_C1).astype(np.uint32)
        x = ((x ^ (x >> np.uint32(13))) * _FMIX_C2).astype(np.uint32)
        return (x ^ (x >> np.uint32(16))).astype(np.uint32)


def _genotype_draw_pair(
    vs_key: np.uint64, positions: np.ndarray, num_samples: int
) -> "tuple[np.ndarray, np.ndarray]":
    """The two (B, N) uint32 allele draws of the genotype stream."""
    with np.errstate(over="ignore"):
        h1 = _mix(
            vs_key ^ (np.asarray(positions, dtype=np.int64).astype(_U64) * _P2)
        )
        h2 = _mix(h1 ^ (_U64(_S_GENOTYPE) * _P3))
        samples = np.arange(num_samples, dtype=np.int64).astype(_U64) * _P4
        x64 = h2[:, None] ^ samples[None, :]
        x32 = ((x64 >> _U64(32)) ^ x64).astype(np.uint32)
        d1 = _fmix32(x32)
        d2 = ((d1 * _GOLD32) ^ _FMIX_C1).astype(np.uint32)
    return d1, d2


#: Default candidate-site grid density: one site every N bases (~1/100
#: approximates 1KG phase 1's ~39M sites over ~2.9 Gb). ONE constant shared
#: by the source default below and the device-free plan validator's static
#: site-count bound (``check/plan.py``'s exactness-window facts).
DEFAULT_VARIANT_SPACING = 100


class SyntheticGenomicsSource(GenomicsSource):
    """A deterministic cohort with population structure.

    Args:
        num_samples: cohort size per variant set (1KG phase 1: 2,504).
        seed: base seed; all draws derive from it.
        variant_spacing: one candidate variant site every N bases (~1/100
            approximates 1KG phase 1's ~39M sites over ~2.9 Gb).
        ref_block_fraction: fraction of sites that are reference-matching
            blocks (``referenceBases == "N"``, no alternates — the record
            class the Klotho/BRCA1 examples count).
        n_pops: number of synthetic populations.
        read_length / read_depth: synthetic read geometry for the reads API.
        cohort_sizes: optional per-variant-set cohort sizes (variant set id →
            sample count); sets not listed use ``num_samples``. This is how
            the reference's ACTUAL joint-cohort scenario is modeled — e.g.
            1000 Genomes (2,504 samples) joined with Platinum Genomes (~17
            deep genomes) (``VariantsPca.scala:155-168``;
            ``SearchVariantsExample.scala:28``).
    """

    def __init__(
        self,
        num_samples: int = 2504,
        seed: int = 42,
        variant_spacing: int = DEFAULT_VARIANT_SPACING,
        ref_block_fraction: float = 0.1,
        n_pops: int = 4,
        read_length: int = 100,
        read_depth: int = 8,
        somatic_rate: float = 0.002,
        cohort_sizes: Optional[Mapping[str, int]] = None,
    ):
        self.num_samples = int(num_samples)
        self.seed = int(seed)
        self.variant_spacing = int(variant_spacing)
        self.ref_block_fraction = float(ref_block_fraction)
        self.n_pops = int(n_pops)
        self.read_length = int(read_length)
        self.read_depth = int(read_depth)
        self.somatic_rate = float(somatic_rate)
        self.cohort_sizes = {
            k: int(v) for k, v in (cohort_sizes or {}).items()
        }
        # Contiguous population blocks: sample s → pop s*n_pops//N.
        self._pops = self._pops_for_size(self.num_samples)
        # Variant set id → its key: a Python murmur3 a set, not a sample.
        self._vs_keys: Dict[str, np.uint64] = {}

    def _pops_for_size(self, n: int) -> np.ndarray:
        return (np.arange(n, dtype=np.int64) * self.n_pops) // max(1, n)

    def num_samples_for(self, variant_set_id: str) -> int:
        """This variant set's cohort size (``cohort_sizes`` override or the
        default ``num_samples``)."""
        return self.cohort_sizes.get(variant_set_id, self.num_samples)

    def populations_for(self, variant_set_id: str) -> np.ndarray:
        """Sample → population for this variant set's cohort."""
        n = self.num_samples_for(variant_set_id)
        return self._pops if n == self.num_samples else self._pops_for_size(n)

    # ------------------------------------------------------------------ keys

    def _vs_key(self, variant_set_id: str) -> np.uint64:
        key = self._vs_keys.get(variant_set_id)
        if key is None:
            with np.errstate(over="ignore"):
                key = _mix(_U64(self.seed) ^ _string_key(variant_set_id))
            self._vs_keys[variant_set_id] = key
        return key

    def _rgs_key(self, read_group_set_id: str) -> np.uint64:
        with np.errstate(over="ignore"):
            return _mix(_U64(self.seed) ^ _string_key(read_group_set_id))

    # ------------------------------------------------------- driver metadata

    def callset_id(self, variant_set_id: str, i: int) -> str:
        """Callset ids follow the public-data convention ``<variantset>-<i>``;
        ``emitResult`` splits on '-' to recover the dataset id
        (``VariantsPca.scala:275``)."""
        return f"{variant_set_id}-{i}"

    def _name_tag(self, variant_set_id: str) -> int:
        """The two digits every callset name of the set carries."""
        return int(self._vs_key(variant_set_id) % _U64(90))

    def callset_name(self, variant_set_id: str, i: int) -> str:
        return f"S{self._name_tag(variant_set_id):02d}N{i:05d}"

    def search_callsets(self, variant_set_ids: Sequence[str]) -> List[Dict]:
        """Callsets across the requested variant sets. Duplicate variant-set
        ids contribute their callsets once, as the real SearchCallSets API
        (a search over a *set* of variant sets) would
        (``VariantsPca.scala:97-105``). Ids and names are spelt as
        :meth:`callset_id` and :meth:`callset_name` spell them, with the
        name's tag taken once a set."""
        out: List[Dict] = []
        seen = set()
        for vsid in variant_set_ids:
            if vsid in seen:
                continue
            seen.add(vsid)
            tag = self._name_tag(vsid)
            out += [
                {"id": f"{vsid}-{i}", "name": f"S{tag:02d}N{i:05d}"}
                for i in range(self.num_samples_for(vsid))
            ]
        return out

    def get_contigs(
        self,
        variant_set_id: str,
        sex_filter: SexChromosomeFilter = SexChromosomeFilter.INCLUDE_XY,
    ) -> List[Contig]:
        contigs = [
            Contig(name, 0, length)
            for name, length in Examples.HUMAN_CHROMOSOMES.items()
        ]
        return filter_sex_chromosomes(contigs, sex_filter)

    def client(self) -> "SyntheticClient":
        return SyntheticClient(self)

    # ------------------------------------------------------- variant payloads

    def _site_positions(self, start: int, end: int) -> np.ndarray:
        """Candidate variant sites on the global grid inside [start, end)."""
        spacing = self.variant_spacing
        first = ((max(start, 0) + spacing - 1) // spacing) * spacing
        if first >= end:
            return np.empty(0, dtype=np.int64)
        return np.arange(first, end, spacing, dtype=np.int64)

    def _site_fields(
        self, variant_set_id: str, positions: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Per-site draws shared by both paths.

        Returns (is_ref_block, af, af_pop[B,P], ref_base_idx, alt_base_idx).
        Site identity (existence, ref/alt, base AF) is keyed by position only,
        NOT by variant set — so distinct variant sets share sites and their
        murmur3 variant keys match across datasets, exercising the
        join/merge paths the way 1KG + Platinum would
        (``VariantsPca.scala:155-188``).
        """
        site_key = _mix(_U64(self.seed))
        is_ref_block, af_q32, af_pop_q32 = _site_fields_q(
            site_key, positions, self.ref_block_fraction, self.n_pops
        )
        # Exact dyadic floats (k·2⁻³²): float comparisons downstream equal
        # the device kernel's integer compares bit for bit.
        af = af_q32.astype(np.float64) * 2.0**-32
        af_pop = af_pop_q32.astype(np.float64) * 2.0**-32
        ref_idx = (_u64(site_key, positions, _S_REF_BASE) % _U64(4)).astype(np.int64)
        alt_off = (_u64(site_key, positions, _S_ALT_BASE) % _U64(3)).astype(np.int64)
        alt_idx = (ref_idx + 1 + alt_off) % 4
        return is_ref_block, af, af_pop, ref_idx, alt_idx

    @property
    def site_key(self) -> int:
        """The uint64 key of the variant-set-independent site-metadata
        streams (``_site_fields``) — with :meth:`genotype_stream_key` and
        the grid, everything the device ingest kernel needs."""
        return int(_mix(_U64(self.seed)))

    def genotype_stream_key(self, variant_set_id: str) -> int:
        """The per-variant-set uint64 key of the genotype draw stream — the
        device generation path (``ops/devicegen.py``) reproduces
        :meth:`_genotype_alleles` bitwise from this key."""
        return int(self._vs_key(variant_set_id))

    @property
    def populations(self) -> np.ndarray:
        """Sample → population index (``(N,)`` int64)."""
        return self._pops

    def page_requests(self, contig: Contig, bases_per_partition: int) -> int:
        """Wire-equivalent request count for scanning ``contig`` in
        ``bases_per_partition`` windows: one request per
        ``VARIANTS_PAGE_SIZE``-site page per shard, at least one per shard —
        the same accounting ``SyntheticClient.search_variants`` performs."""
        total = 0
        for shard in contig.get_shards(bases_per_partition):
            k0, k1 = self.site_grid_range(shard)
            total += max(1, -(-(k1 - k0) // VARIANTS_PAGE_SIZE))
        return total

    def declared_sites(self, contig: Contig) -> int:
        """Exact candidate-site weight of ``contig`` for the host →
        contig-partition split: the site-grid span itself — the synthetic
        grid is declared geometry, so the split balances on the TRUE site
        counts (base sources fall back to the base-range prior)."""
        k0, k1 = self.site_grid_range(contig)
        return k1 - k0

    def site_grid_range(self, contig: Contig) -> Tuple[int, int]:
        """The contig's candidate-site grid as index range ``[k0, k1)`` with
        position ``k · variant_spacing`` — the only ingest metadata the
        device generation path needs (``ops/devicegen.py`` recomputes
        everything else on device)."""
        spacing = self.variant_spacing
        k0 = -(-max(contig.start, 0) // spacing)
        k1 = -(-contig.end // spacing)
        return k0, max(k0, k1)

    def site_threshold_plan(
        self,
        contig: Contig,
        min_allele_frequency: Optional[float] = None,
        chunk_sites: int = 1 << 20,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Host half of the device-generation path: per-site integer
        comparison thresholds for kept sites.

        Yields dense ``(positions (B,), thresholds (B, n_pops) uint64)``
        batches where ``thresholds[:, p] = af_pop_q32[:, p]`` — the Q32
        integer thresholds the genotype draws compare against
        (``draw32 < af_pop_q32``, see ``_genotype_draw_pair`` and
        ``ops/devicegen.py``). Ref-block sites and AF-filtered sites are
        compacted out, mirroring :meth:`genotype_blocks`' drop semantics.
        """
        all_positions = self._site_positions(contig.start, contig.end)
        self.plan_sites_scanned = getattr(self, "plan_sites_scanned", 0)
        for off in range(0, len(all_positions), chunk_sites):
            positions = all_positions[off : off + chunk_sites]
            is_ref_block, af, af_pop, _, _ = self._site_fields("", positions)
            keep = ~is_ref_block
            if min_allele_frequency is not None:
                keep &= af_passes(af, min_allele_frequency)
            self.plan_sites_scanned += len(positions)
            positions = positions[keep]
            if len(positions) == 0:
                continue
            # af_pop is the exact dyadic k·2⁻³², so ·2³² recovers k exactly.
            thresholds = np.round(af_pop[keep] * (2.0**32)).astype(np.uint64)
            yield positions, thresholds

    def _genotype_alleles(
        self, variant_set_id: str, positions: np.ndarray
    ) -> np.ndarray:
        """(B, N, 2) {0,1} allele draws; genotypes are per variant set
        (different datasets = different individuals at shared sites), with
        N this set's cohort size (``cohort_sizes``). Integer Q32 compares of
        the genotype draw stream (``_genotype_draw_pair``) against the
        per-population thresholds — bit-identical to the device kernel."""
        vs_key = self._vs_key(variant_set_id)
        site_key = _mix(_U64(self.seed))
        _, _, af_pop_q32 = _site_fields_q(
            site_key, positions, self.ref_block_fraction, self.n_pops
        )
        n = self.num_samples_for(variant_set_id)
        pops = self.populations_for(variant_set_id)
        # Q32 thresholds are < 2^32 by construction (clipped at _POP_HI_Q32).
        k = af_pop_q32[:, pops].astype(np.uint32)  # (B, N)
        d1, d2 = _genotype_draw_pair(vs_key, positions, n)
        return np.stack([d1 < k, d2 < k], axis=2).astype(np.int8)

    def genotype_blocks(
        self,
        variant_set_id: str,
        contig: Contig,
        block_size: int = 1024,
        min_allele_frequency: Optional[float] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Packed fast path: dense has-variation blocks for the Gramian.

        Yields dicts with ``positions`` (B,), ``has_variation`` uint8 (B, N),
        ``af`` (B,). Reference-block sites are all-zero rows (no call has
        variation) and are dropped, matching the ``filter(_.size > 0)`` stage
        (``VariantsPca.scala:206``). ``min_allele_frequency`` applies the
        ``--min-allele-frequency`` filter (``VariantsPca.scala:136-148``,
        strictly greater, on the site's AF info value).
        """
        all_positions = self._site_positions(contig.start, contig.end)
        for off in range(0, len(all_positions), block_size):
            positions = all_positions[off : off + block_size]
            is_ref_block, af, _, _, _ = self._site_fields(variant_set_id, positions)
            keep = ~is_ref_block
            if min_allele_frequency is not None:
                keep &= af_passes(af, min_allele_frequency)
            positions = positions[keep]
            af = af[keep]
            if len(positions) == 0:
                continue
            alleles = self._genotype_alleles(variant_set_id, positions)
            has_variation = (alleles.max(axis=2) > 0).astype(np.uint8)
            nonzero = has_variation.any(axis=1)
            yield {
                "positions": positions[nonzero],
                "has_variation": has_variation[nonzero],
                "af": af[nonzero],
            }

    def variant_json(self, variant_set_id: str, contig_name: str, pos: int) -> Dict:
        """One wire-format variant record (the JSON the reference's Java
        client would deserialize, ``rdd/VariantsRDD.scala:98-149``)."""
        positions = np.array([pos], dtype=np.int64)
        is_ref_block, af, _, ref_idx, alt_idx = self._site_fields(
            variant_set_id, positions
        )
        record: Dict = {
            "id": f"{variant_set_id}:{contig_name}:{pos}",
            "variantSetId": variant_set_id,
            "referenceName": contig_name,
            "start": int(pos),
            "created": 0,
        }
        if bool(is_ref_block[0]):
            record["end"] = int(pos) + self.variant_spacing
            record["referenceBases"] = "N"
            genotypes = np.zeros(
                (1, self.num_samples_for(variant_set_id), 2), dtype=np.int8
            )
        else:
            record["end"] = int(pos) + 1
            record["referenceBases"] = _BASES[int(ref_idx[0])]
            record["alternateBases"] = [_BASES[int(alt_idx[0])]]
            record["info"] = {"AF": [f"{float(_af6(af)[0]):.6f}"]}
            genotypes = self._genotype_alleles(variant_set_id, positions)
        record["calls"] = [
            {
                "callSetId": self.callset_id(variant_set_id, s),
                "callSetName": self.callset_name(variant_set_id, s),
                "genotype": [int(genotypes[0, s, 0]), int(genotypes[0, s, 1])],
                "phaseset": "*",
            }
            for s in range(self.num_samples_for(variant_set_id))
        ]
        return record

    # --------------------------------------------------------- read payloads

    def _germline_base(self, contig_name: str, positions: np.ndarray) -> np.ndarray:
        key = _mix(_U64(self.seed) ^ _string_key(contig_name))
        return (_u64(key, positions, _S_GERMLINE_BASE) % _U64(4)).astype(np.int64)

    def _is_somatic_site(self, contig_name: str, positions: np.ndarray) -> np.ndarray:
        key = _mix(_U64(self.seed) ^ _string_key(contig_name))
        return _u01(key, positions, _S_SOMATIC) < self.somatic_rate

    def read_json(
        self, read_group_set_id: str, contig_name: str, start: int, tile: int
    ) -> Dict:
        """One wire-format read.

        The read's bases follow the deterministic germline reference of
        ``contig_name``; read group sets whose id contains ``"Tumor"`` (or the
        DREAM tumor id) additionally carry somatic alternates at hash-selected
        sites with ~50% variant allele fraction — giving SearchReadsExample4's
        tumor/normal comparison a real signal.
        """
        rgs_key = self._rgs_key(read_group_set_id)
        L = self.read_length
        positions = np.arange(start, start + L, dtype=np.int64)
        base_idx = self._germline_base(contig_name, positions)
        is_tumor = (
            "Tumor" in read_group_set_id
            or read_group_set_id == Examples.GOOGLE_DREAM_SET3_TUMOR
        )
        if is_tumor:
            somatic = self._is_somatic_site(contig_name, positions)
            carries_alt = (
                _u01(rgs_key, positions, _S_READ_ALLELE, sample=start, allele=tile)
                < 0.5
            )
            flip = somatic & carries_alt
            base_idx = np.where(flip, (base_idx + 1) % 4, base_idx)
        sequence = "".join(_BASES[i] for i in base_idx)
        qual = (
            20
            + (
                _u64(rgs_key, positions, _S_READ_BASEQ, sample=start, allele=tile)
                % _U64(21)
            ).astype(np.int64)
        )
        mapq = int(
            20
            + int(
                _u64(rgs_key, np.int64(start), _S_READ_MAPQ, allele=tile) % _U64(41)
            )
        )
        return {
            "id": f"{read_group_set_id}:{contig_name}:{start}:{tile}",
            "fragmentName": f"frag-{contig_name}-{start}-{tile}",
            "readGroupSetId": read_group_set_id,
            "alignedSequence": sequence,
            "alignedQuality": [int(q) for q in qual],
            "fragmentLength": 300,
            "alignment": {
                "position": {"referenceName": contig_name, "position": int(start)},
                "mappingQuality": mapq,
                "cigar": [
                    {"operationLength": L, "operation": "ALIGNMENT_MATCH"}
                ],
            },
        }

    def read_starts(self, start: int, end: int) -> Iterator[Tuple[int, int]]:
        """(position, tile) pairs of reads starting in [start, end).

        Reads are laid out as ``read_depth`` staggered full tilings of length
        ``read_length``: tile j starts at offsets ≡ j*(L//depth) (mod L), so
        per-base depth is uniformly ``read_depth``.
        """
        L = self.read_length
        step = max(1, L // self.read_depth)
        for tile in range(self.read_depth):
            offset = tile * step
            first = ((max(start - offset, 0) + L - 1) // L) * L + offset
            for pos in range(first, end, L):
                if pos >= start:
                    yield pos, tile


class SyntheticClient(GenomicsClient):
    """A per-partition session over the synthetic source, with the page
    accounting of the reference's ``Paginator`` (one initialized request per
    page, ``rdd/VariantsRDD.scala:212-224``).

    Stream contract (``sources/stream.py``): records are GENERATED one at
    a time from the site grid — no file handle, no decoded payload larger
    than one record ever stages on host — so the synthetic arm of the
    hostmem totality proof carries no wire-table term at all; its page
    windows exist only for request accounting parity with the REST arm."""

    def __init__(self, source: SyntheticGenomicsSource):
        super().__init__()
        self.source = source

    def search_variants(
        self,
        request: Mapping,
        boundary: ShardBoundary = ShardBoundary.STRICT,
        page_size: int = VARIANTS_PAGE_SIZE,
    ) -> Iterator[Dict]:
        src = self.source
        variant_set_id = request["variantSetIds"][0]
        contig_name = request["referenceName"]
        start, end = int(request["start"]), int(request["end"])
        # Candidate sites, including one spacing of lookback for records that
        # overlap the range start (reference-matching blocks have extent).
        candidates = src._site_positions(start - src.variant_spacing, end)
        emitted = 0
        for pos in candidates:
            pos = int(pos)
            if boundary is ShardBoundary.STRICT:
                if not (start <= pos < end):
                    continue
            else:  # OVERLAPS
                site_end = pos + src.variant_spacing  # max extent (ref blocks)
                if site_end <= start or pos >= end:
                    continue
            if emitted % page_size == 0:
                self.counters.add_request()
            emitted += 1
            yield src.variant_json(variant_set_id, contig_name, pos)
        if emitted == 0:
            # Even an empty shard costs one request.
            self.counters.add_request()

    def search_reads(
        self,
        request: Mapping,
        boundary: ShardBoundary = ShardBoundary.STRICT,
        page_size: int = 256,
    ) -> Iterator[Dict]:
        src = self.source
        contig_name = request["referenceName"]
        start, end = int(request["start"]), int(request["end"])
        emitted = 0
        # STRICT: only reads STARTING in [start, end) — each read belongs to
        # exactly one shard. OVERLAPS: also reads starting before the range
        # whose alignment extends into it (the API's overlap semantics).
        scan_start = (
            start
            if boundary is ShardBoundary.STRICT
            else max(0, start - src.read_length)
        )
        for read_group_set_id in request["readGroupSetIds"]:
            for pos, tile in src.read_starts(scan_start, end):
                if boundary is ShardBoundary.OVERLAPS and pos + src.read_length <= start:
                    continue
                if emitted % page_size == 0:
                    self.counters.add_request()
                emitted += 1
                yield src.read_json(read_group_set_id, contig_name, pos, tile)
        if emitted == 0:
            self.counters.add_request()


__all__ = [
    "DEFAULT_VARIANT_SPACING",
    "SyntheticGenomicsSource",
    "SyntheticClient",
]
