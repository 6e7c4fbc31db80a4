"""The configuration-level host-memory bound.

The port's copy of ``spark_examples_tpu/check/hostmem.py:
conf_host_peak_bytes`` and its private helpers: a parsed configuration
resolved into the arguments of ``parallel/mesh.py:host_peak_bytes`` (the
bound the driver registers as ``host_static_bound_bytes`` and the manifest
records beside the measured peak RSS). Reference names and arithmetic are
kept, so both packages give the same bound for the same argv at the same
device count and runtime baseline; the static prover over the source tree
is not ported.

The runtime baseline is the one term that differs by device
(:func:`runtime_baseline_bytes`): the reference's constant, set for a TPU
host, on the CPU; on the card, the process's peak RSS measured at the
driver's set-up once the CUDA runtime and libraries are up (``import
torch`` alone holds more than the constant there), so the bound's data
terms are what a run is held to.
"""

from __future__ import annotations

import functools
import os
from typing import Any, List, Optional, Tuple


def conf_mesh_axes(conf: Any, device_count: Optional[int]) -> Tuple[int, int]:
    """(data, samples) a run of ``conf`` would build — the same resolution
    ``check/plan.py`` and ``pca_driver._make_mesh`` apply, shared here so
    the budget formula's geometry inputs cannot drift from either."""
    from spark_examples_tpu_torch.parallel.mesh import parse_mesh_shape

    mesh_shape = getattr(conf, "mesh_shape", None)
    if mesh_shape:
        shape = parse_mesh_shape(mesh_shape)
        return shape["data"], shape["samples"]
    devices = device_count if device_count is not None else 1
    data = max(1, min(devices, int(conf.num_reduce_partitions)))
    return data, 1


def _streamable_vcf_input(conf: Any) -> bool:
    """Whether the configured file ingest is the packed-streaming shape
    (``FileGenomicsSource.wants_streaming``'s static mirror): a single
    variant set whose selected input is a ``.vcf[.gz]`` file. Everything
    else (JSONL/SAM, checkpoint directories, multi-set configs) takes the
    wire-table path, which is bounded by its own closed-form term now —
    this predicate picks the FORMULA, it no longer gates provability."""
    input_files = list(getattr(conf, "input_files", None) or [])
    set_ids = list(getattr(conf, "variant_set_id", None) or [])
    if not input_files or len(set_ids) != 1:
        return False
    from spark_examples_tpu_torch.sources.files import file_set_ids

    by_id = dict(zip(file_set_ids(input_files), input_files))
    path = by_id.get(set_ids[0])
    if path is None or os.path.isdir(path):
        return False
    lowered = path[:-3] if path.endswith(".gz") else path
    return lowered.endswith(".vcf")


def _selected_paths(conf: Any) -> List[str]:
    """The input paths a file-source run of ``conf`` would actually read:
    ``--input-files`` filtered to the selected ``--variant-set-id``s (the
    same id derivation ``sources/files.py:file_set_ids`` applies), all of
    them when no set filter is configured or an id fails to resolve."""
    input_files = [str(p) for p in (getattr(conf, "input_files", None) or [])]
    set_ids = list(getattr(conf, "variant_set_id", None) or [])
    if not input_files:
        return []
    if not set_ids:
        return input_files
    from spark_examples_tpu_torch.sources.files import file_set_ids

    by_id = dict(zip(file_set_ids(input_files), input_files))
    selected = [by_id[s] for s in set_ids if s in by_id]
    return selected if selected else input_files


def _wire_record_bytes(num_samples: int) -> int:
    """Conservative host bytes of ONE wire/JSONL/SAM record object: a
    fixed per-record envelope (dict + key strings + position/id scalars)
    plus the per-sample call payload (one small int/str cell per sample
    after decode). 128 bytes/sample dominates any decoded call cell
    CPython allocates; 256 dominates the envelope."""
    return 256 + 128 * int(num_samples)


def _rows_bound_or_contract(path: str) -> int:
    """Total candidate rows one input path can yield, from the bytes on
    disk (``stream.wire_rows_bound``: min-line-width over the decompressed
    size bound), falling back to the DECLARED production geometry ceiling
    (``ops/contracts.py:DECLARED_MAX_SITES``) for paths that cannot be
    statted (plan-time validation of a path that does not exist yet) or
    directories with nothing listable. Always finite, never raises."""
    from spark_examples_tpu_torch.ops.contracts import DECLARED_MAX_SITES
    from spark_examples_tpu_torch.sources.stream import wire_rows_bound

    try:
        if os.path.isdir(path):
            rows = 0
            for name in sorted(os.listdir(path)):
                full = os.path.join(path, name)
                if os.path.isfile(full):
                    rows += wire_rows_bound(full)
            return rows if rows > 0 else DECLARED_MAX_SITES
        if os.path.isfile(path):
            rows = wire_rows_bound(path)
            return rows if rows > 0 else DECLARED_MAX_SITES
    except OSError:
        pass
    return DECLARED_MAX_SITES


def _wire_table_term(rows: int, num_samples: int) -> int:
    """Host-resident bytes of one wire-ingest table of ``rows`` records:
    the spool index (``SPOOL_INDEX_BYTES_PER_ROW`` per row) plus — taken
    conservatively as fully co-resident — every decoded record, plus four
    stream windows (reader carry + decode + spool write-behind)."""
    from spark_examples_tpu_torch.sources.stream import (
        DEFAULT_WINDOW_BYTES,
        SPOOL_INDEX_BYTES_PER_ROW,
    )

    per_row = SPOOL_INDEX_BYTES_PER_ROW + _wire_record_bytes(num_samples)
    return int(rows) * per_row + 4 * DEFAULT_WINDOW_BYTES


#: Width of the warm-up Gramian :func:`runtime_baseline_bytes` centers and
#: eigensolves on the card: a few tiles, enough to take the run's cuBLAS
#: and cuSOLVER paths, small enough to stage no data.
_WARMUP_SAMPLES = 256


@functools.lru_cache(maxsize=None)
def _warm_cuda_runtime(device_index: int) -> None:
    """Bring up, once per process and card, what every run on the card
    loads before its first result: the context, the kernels' libraries,
    and cuBLAS and cuSOLVER through one centering and one step of the
    subspace eigensolve on a small random Gramian."""
    import torch

    from spark_examples_tpu_torch.ops import devicegen, gramian
    from spark_examples_tpu_torch.ops.centering import gower_center
    from spark_examples_tpu_torch.ops.pca import principal_components_subspace

    dev = torch.device("cuda", device_index)
    devicegen._library()
    gramian._library()
    generator = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((_WARMUP_SAMPLES, _WARMUP_SAMPLES), generator=generator, device=dev)
    components, _ = principal_components_subspace(gower_center(x @ x.T), 2, iterations=1)
    components.cpu()


def runtime_baseline_bytes(device) -> int:
    """The runtime baseline of the host-memory bound of a run on
    ``device``. On the CPU the reference's constant
    (``parallel/mesh.py:HOST_RUNTIME_BASELINE_BYTES``), so the bound equals
    the reference's integer for integer. On the card the process's peak RSS
    once the CUDA runtime is up (:func:`_warm_cuda_runtime`), taken before
    the run stages any data: what the run adds past it is held to the data
    terms. The constant when the OS reports no peak RSS."""
    import torch

    from spark_examples_tpu_torch.obs.metrics import read_host_peak_rss_bytes
    from spark_examples_tpu_torch.parallel.mesh import HOST_RUNTIME_BASELINE_BYTES

    dev = torch.device(device)
    if dev.type != "cuda":
        return HOST_RUNTIME_BASELINE_BYTES
    _warm_cuda_runtime(dev.index if dev.index is not None else torch.cuda.current_device())
    peak = read_host_peak_rss_bytes()
    return int(peak) if peak is not None else HOST_RUNTIME_BASELINE_BYTES


def conf_host_peak_bytes(
    conf: Any,
    device_count: Optional[int] = None,
    num_samples: Optional[int] = None,
    num_hosts: int = 1,
    baseline_bytes: Optional[int] = None,
) -> int:
    """``host_peak_bytes`` for one parsed configuration. TOTAL: every
    (source kind x ingest mode x analysis x serve job kind) resolves to a
    finite closed-form bound — there is no ``None`` arm left, because
    every ingest path now runs through the windowed stream abstraction
    (``sources/stream.py``) whose residency is a formula, not the file.

    ``num_samples`` overrides the flag value with the DISCOVERED cohort
    width (file sources carry their cohort in the data; the driver passes
    its resolved matrix size, the static plan validator the declared flag).
    ``num_hosts > 1`` charges the host-sharded ingest merge term — a
    PER-HOST bound (the port's driver runs one process and passes 1).
    ``baseline_bytes`` is the runtime baseline (default: the reference's
    constant; the driver passes :func:`runtime_baseline_bytes`).

    Per-path terms, all monotone in the cohort width:

    - synthetic: the device-generation path stages nothing whole-file;
      only the runtime baseline and analysis terms apply.
    - file, single ``.vcf[.gz]`` set, packed/auto ingest: one streamed
      pass (O(workers x chunk) parse staging at the explicit
      ``--stream-chunk-bytes`` or the ``sources/files.py`` default) plus
      the packed columns' build/hand-off co-residency,
      ``2 x rows x (N + 48)`` (int8 genotype row + per-site metadata,
      builder AND final array alive across the final copy).
    - file wire / JSONL / SAM / multi-set: the wire-table term per
      selected input (spool index + conservatively co-resident decoded
      records + stream windows), plus a merge-join term
      ``n_sets x 64 x record_bytes`` when joining (64 = the per-stream
      tracked-group ceiling ``stream.merge_join`` accounts against).
    - REST: one wire table at the declared geometry ceiling
      (``DECLARED_MAX_SITES`` rows — the pagination protocol carries no
      size upfront, so the production contract is the bound).
    - checkpoint resume (``--input-path``): the wire-table term over the
      journal directory's parts (sizes from disk when statable, the
      geometry ceiling otherwise).
    """
    from spark_examples_tpu_torch.config import AssocConf, GrmConf, LdConf
    from spark_examples_tpu_torch.parallel.mesh import (
        HOST_RUNTIME_BASELINE_BYTES,
        host_peak_bytes,
    )
    from spark_examples_tpu_torch.sources.files import _resolve_ingest_workers

    if num_samples is None:
        num_samples = int(conf.num_samples)
    n = int(num_samples)
    source = getattr(conf, "source", "synthetic")
    stream_chunk = getattr(conf, "stream_chunk_bytes", None)
    ingest = getattr(conf, "ingest", "auto")
    chunk_bytes = 0
    wire_table_bytes = 0
    merge_join_bytes = 0
    input_path = getattr(conf, "input_path", None)
    if input_path:
        # Checkpoint resume replays journal parts through the windowed
        # JSONL reader into one wire table; charge it like any wire input.
        wire_table_bytes = _wire_table_term(
            _rows_bound_or_contract(str(input_path)), n
        )
    elif source == "file":
        if ingest != "wire" and _streamable_vcf_input(conf):
            from spark_examples_tpu_torch.sources.files import STREAM_CHUNK_BYTES

            chunk_bytes = (
                int(stream_chunk)
                if stream_chunk and stream_chunk > 0
                else STREAM_CHUNK_BYTES
            )
            rows = _rows_bound_or_contract(_selected_paths(conf)[0])
            wire_table_bytes = 2 * rows * (n + 48)
        else:
            paths = _selected_paths(conf)
            wire_table_bytes = sum(
                _wire_table_term(_rows_bound_or_contract(p), n)
                for p in paths
            )
            if len(paths) > 1:
                merge_join_bytes = (
                    len(paths) * 64 * _wire_record_bytes(n)
                )
    elif source == "rest":
        from spark_examples_tpu_torch.ops.contracts import DECLARED_MAX_SITES

        set_ids = list(getattr(conf, "variant_set_id", None) or [None])
        wire_table_bytes = len(set_ids) * _wire_table_term(
            DECLARED_MAX_SITES, n
        )
        if len(set_ids) > 1:
            merge_join_bytes = len(set_ids) * 64 * _wire_record_bytes(n)
    workers = _resolve_ingest_workers(getattr(conf, "ingest_workers", None))
    data, _samples = conf_mesh_axes(conf, device_count)
    # Mirrors pipeline/pca_driver._similarity_stage: a depth-2
    # PrefetchIterator and the double-buffered device feed exist whenever
    # parse workers do (any packed-path source). The pure device-generation
    # path has neither, so for it these terms only make the bound more
    # conservative — never smaller than reality.
    prefetch_depth = 2 if workers > 0 else 0
    pipeline_depth = 2 if workers > 0 else 0
    host_backend = getattr(conf, "pca_backend", "gpu") == "host"
    return host_peak_bytes(
        num_samples=n,
        block_size=int(conf.block_size),
        data_axis=data,
        ingest_workers=workers,
        chunk_bytes=chunk_bytes,
        prefetch_depth=prefetch_depth,
        pipeline_depth=pipeline_depth,
        # The host-oracle N×N accumulator exists only where the run builds
        # a Gramian (PCA, and GRM whose device work is the Gramian); LD and
        # assoc under --pca-backend host run O(window) NumPy oracles. The
        # GRM finalize's N×N host matrices belong to the grm verb, the W×W
        # per-window working set to ld-prune.
        host_accumulator=host_backend and not isinstance(conf, (LdConf, AssocConf)),
        grm_finalize=isinstance(conf, GrmConf),
        ld_window_sites=(
            int(getattr(conf, "ld_window_sites", 0) or 0) if isinstance(conf, LdConf) else 0
        ),
        num_hosts=int(num_hosts),
        wire_table_bytes=wire_table_bytes,
        merge_join_bytes=merge_join_bytes,
        baseline_bytes=(
            HOST_RUNTIME_BASELINE_BYTES if baseline_bytes is None else int(baseline_bytes)
        ),
    )


__all__ = ["conf_host_peak_bytes", "conf_mesh_axes", "runtime_baseline_bytes"]
