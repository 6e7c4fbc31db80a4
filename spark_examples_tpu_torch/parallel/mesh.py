"""Host-memory arithmetic of the device mesh, without a mesh.

The port's copy of the JAX-free arithmetic of
``spark_examples_tpu/parallel/mesh.py`` that one device needs: the peak
host-memory bound :func:`host_peak_bytes` (the formula behind the driver's
``host_static_bound_bytes`` gauge and the manifest's ``host_memory``
block), its runtime baseline, and the ``--mesh-shape`` parser the bound's
geometry resolves through. The mesh itself, its process groups and the ring
schedules come with multi-GPU.
"""

from __future__ import annotations

from typing import Dict

DATA_AXIS = "data"
SAMPLES_AXIS = "samples"


#: Fixed host-RSS overhead of the process itself (interpreter, runtime,
#: parser library): the constant term of :func:`host_peak_bytes`, the
#: reference's value, deliberately generous. The formula's job is to bound
#: the data-dependent staging terms.
HOST_RUNTIME_BASELINE_BYTES = 4 << 30


def host_peak_bytes(
    num_samples: int,
    block_size: int,
    data_axis: int = 1,
    ingest_workers: int = 0,
    chunk_bytes: int = 0,
    prefetch_depth: int = 0,
    pipeline_depth: int = 0,
    host_accumulator: bool = False,
    grm_finalize: bool = False,
    ld_window_sites: int = 0,
    num_hosts: int = 1,
    wire_table_bytes: int = 0,
    merge_join_bytes: int = 0,
    baseline_bytes: int = HOST_RUNTIME_BASELINE_BYTES,
) -> int:
    """Closed-form peak host-memory bound of one bounded-ingest run — the
    host-RAM sibling of :func:`ring_traffic_bytes`, and the ONE formula
    behind ``graftcheck plan --host-mem-budget``, the driver's
    ``host_static_bound_bytes`` gauge, and the manifest's ``host_memory``
    block (``check/hostmem.py:conf_host_peak_bytes`` resolves a parsed
    configuration into these arguments, so no caller re-derives them).

    Term by term (derivation in DESIGN.md §8.6):

    - **parse window** — ``(ingest_workers + 2) * 2 * chunk_bytes``: the
      order-preserving pool (``sources/files.py:_ordered_pool_map``) holds
      at most ``workers + 2`` chunks in flight, each present as raw text
      AND as its parsed arrays (has-variation bytes <= text bytes: one
      int8 per genotype vs >= 2 text chars per GT column, plus
      positions/ends/AF at ~20 bytes/row against ~60+ text bytes/row).
    - **prefetch queue** — ``prefetch_depth`` parsed blocks of
      ``block_size * num_samples`` uint8 waiting for the device feeder
      (``pipeline/datasets.py:PrefetchIterator``).
    - **accumulator staging** — the ``(data_axis * block_size,
      num_samples)`` uint8 staging buffer plus one flush copy (packed
      ``ceil(N/8)`` or the full-width counts copy — bound with the full
      width so count-valued joins stay inside the bound).
    - **flush in-flight** — ``pipeline_depth`` flush copies pinned on host
      while their transfers overlap compute (``ops/gramian.py``).
    - **host accumulator** — the ``--pca-backend host`` oracle's int64
      N x N matrix (+ its f64 centering copy), zero on the device path.
    - **GRM finalize** — ``21 * N * N``: the kinship close-out
      (``analyses/grm.py:grm_finalize`` + its summary) holds the fetched
      f32 Gramian (4 N²), EITHER the int64 working copy OR the summary's
      off-diagonal float64 extraction (8 N² — they never overlap), the
      float64 kinship itself (8 N²), and the off-diagonal bool mask
      (1 N²) simultaneously on host; zero for every other analysis.
    - **LD window** — ``56 * W² + W * N``: each flush fetches the W×W
      int32 co-carrier matrix and closes r² on host
      (``ops/ld.py:r2_from_counts`` holds up to seven 8-byte W×W working
      matrices — the int64 copy, cov, the variance outer product, the
      squared numerator and its cast temp, the r² result — next to the
      fetched int32 stats; 56 W² bounds the lot) plus the (W, N) uint8
      window buffer; zero when the run has no LD window.
    - **pod merge** — ``(num_hosts + 1) * 8 * N²`` when ``num_hosts > 1``:
      host-sharded ingest closes out by all-gathering every process's
      dense N×N partial Gramian onto each host and summing them exactly
      (``pipeline/pca_driver.py:_merge_host_partials``) — the gathered
      stack (``num_hosts`` partials) plus the 8-byte exact-sum working
      copy sit on host simultaneously. This is a PER-HOST bound: each
      process pays it locally, so the pod-wide peak is ``num_hosts``
      times this formula while each host stays within it. Zero for
      single-process runs.
    - **wire table** — ``wire_table_bytes``: the resolved residency of
      wire-mode ingest tables (spool index + decoded records + stream
      windows) or the packed columns' build/hand-off co-residency; the
      caller (``check/hostmem.py:conf_host_peak_bytes``) derives it from
      the bytes on disk via ``sources/stream.py:wire_rows_bound`` so the
      formula stays TOTAL across JSONL/SAM/REST/checkpoint-resume inputs.
    - **merge join** — ``merge_join_bytes``: the k-way streaming join's
      tracked-group working set, ``n_sets x 64 x record_bytes``
      (``sources/stream.py:merge_join`` holds at most the records of the
      current group key per stream; 64 is the accounted per-stream group
      ceiling its ``MergeJoinStats.peak_tracked`` gauge is asserted
      against). Zero for single-set runs.
    - **baseline** — :data:`HOST_RUNTIME_BASELINE_BYTES`.
    """
    n = int(num_samples)
    block_bytes = int(block_size) * n
    staging = int(data_axis) * block_bytes
    parse_window = (int(ingest_workers) + 2) * 2 * int(chunk_bytes)
    prefetch = int(prefetch_depth) * block_bytes
    flush_copies = (1 + int(pipeline_depth)) * staging
    host_matrix = 2 * n * n * 8 if host_accumulator else 0
    grm_term = 21 * n * n if grm_finalize else 0
    w = int(ld_window_sites)
    ld_term = 56 * w * w + w * n if w > 0 else 0
    hosts = int(num_hosts)
    merge_term = (hosts + 1) * 8 * n * n if hosts > 1 else 0
    return int(
        baseline_bytes
        + parse_window
        + prefetch
        + staging
        + flush_copies
        + host_matrix
        + grm_term
        + ld_term
        + merge_term
        + int(wire_table_bytes)
        + int(merge_join_bytes)
    )


def parse_mesh_shape(spec: str) -> Dict[str, int]:
    """Parse the ``--mesh-shape`` flag: ``'data,samples'`` e.g. ``'4,2'``."""
    parts = [int(p) for p in spec.split(",")]
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2:
        raise ValueError(f"--mesh-shape expects 'data,samples', got {spec!r}")
    return {DATA_AXIS: parts[0], SAMPLES_AXIS: parts[1]}


__all__ = [
    "DATA_AXIS",
    "HOST_RUNTIME_BASELINE_BYTES",
    "SAMPLES_AXIS",
    "host_peak_bytes",
    "parse_mesh_shape",
]
