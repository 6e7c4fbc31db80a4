"""Fused batch execution: one stacked device program for a whole group of
jobs.

The port of ``spark_examples_tpu/pipeline/fused.py``. A group of jobs that
share a cohort geometry (equal ``batch_compile_fingerprint``s) runs as
lanes of one :class:`~spark_examples_tpu_torch.ops.batched.
StackedJobsAccumulator`: every step of the group launches the two stacked
kernels once for all K jobs, and each job's Gramian is its lane of the
``(K, N, N)`` accumulator, byte-identical to its serial run
(``ops/batched.py`` says why). Everything after the accumulation is the
serial epilogue, job by job: ``compute_pca`` or the similarity summary, the
warm-geometry records, the printed rows, the I/O stats, the manifest.

Two phases, as in the reference:

- :func:`preflight_fused` has no side effect (no prints, no device work,
  no files). It raises :class:`FusedIneligible` for a group the stacked
  program cannot carry — mixed kinds, a source other than the synthetic
  one, the sharded strategy, mismatched cohort geometry, per-job
  checkpoints or fault plans, a lane that could leave float32's exact
  window, a group past the memory cap — so the caller runs the jobs one
  after another with nothing to undo.
- :func:`run_fused_pipeline` then runs an eligible group to its end. Each
  job's prints go through the caller's ``stdout_factory``; the
  interleaved accumulation prints nothing.

The batch CLI ignores ``--fused-jobs``, as the reference's does: this is
the library entry point the serve executor runs a group through.
"""

from __future__ import annotations

import contextlib
import io
import sys
from typing import Callable, ContextManager, List, Optional, Sequence

import numpy as np

from spark_examples_tpu_torch.config import PcaConf
from spark_examples_tpu_torch.obs.manifest import build_run_manifest, write_manifest
from spark_examples_tpu_torch.ops.batched import (
    FusedIneligible,
    StackedJobsAccumulator,
    max_fused_jobs,
)
from spark_examples_tpu_torch.ops.contracts import EXACT_F32_LIMIT
from spark_examples_tpu_torch.ops.gramian import dense_strategy_fits
from spark_examples_tpu_torch.pipeline.pca_driver import (
    PipelineResult,
    VariantsPcaDriver,
    _export_compile_cache_gauges,
    _packed_partitions,
    _register_prover_conformance,
    _summarize_similarity,
    _sync_scalar,
    _window_blocks,
    make_source,
)
from spark_examples_tpu_torch.utils.cache import (
    batch_compile_fingerprint,
    compile_fingerprint,
    fused_group_fingerprint,
    record_geometry,
)
from spark_examples_tpu_torch.utils.device import DeviceLike, synchronizer
from spark_examples_tpu_torch.utils.tracing import StageTimes

#: The only request kinds with a stacked device program. ``grm`` finalizes
#: through its own host moments and stays serial.
FUSABLE_KINDS = ("pca", "similarity")


def _check(condition: bool, reason: str) -> None:
    if not condition:
        raise FusedIneligible(reason)


def preflight_fused(
    confs: Sequence[PcaConf],
    kinds: Sequence[str],
    device_bytes: Optional[int] = None,
) -> int:
    """Prove a group can ride one stacked program, or raise
    :class:`FusedIneligible` before any side effect. Returns the group
    size K.

    The reference's checks, one for one, with the port's flag names
    (``--pca-backend gpu`` where the reference has ``tpu``): one fusable
    kind; for every lane the synthetic source's packed stream (no
    ``--input-path``, one variant set, one cohort size, ``--ingest auto``
    or ``packed``), the dense strategy, no ``--save-variants``,
    ``--check-ranges``, Gramian checkpoint or fault plan; one cohort width,
    block size and ``--exact-similarity``; a cohort that fits the dense
    memory rule; without ``--exact-similarity`` at most
    ``EXACT_F32_LIMIT`` declared sites a lane; and K within
    ``max_fused_jobs`` of ``device_bytes`` (the device-free default when
    ``None``)."""
    k = len(confs)
    _check(k >= 1, "empty group")
    _check(len(kinds) == k, f"{k} confs but {len(kinds)} kinds")
    distinct = sorted(set(kinds))
    _check(
        len(distinct) == 1,
        f"mixed-kind group {distinct}: one stacked program serves one kind",
    )
    _check(distinct[0] in FUSABLE_KINDS, f"kind {distinct[0]!r} has no stacked device program")
    base = confs[0]
    for conf in confs:
        _check(
            conf.source == "synthetic",
            f"source {conf.source!r}: only the synthetic packed stream is a pure "
            "function of the conf",
        )
        _check(not conf.input_path, "--input-path resumes are serial")
        _check(
            conf.pca_backend == "gpu",
            f"--pca-backend {conf.pca_backend!r} has no device program",
        )
        _check(len(conf.variant_set_id) == 1, "packed lanes need a single variant set")
        _check(conf.num_samples_per_set is None, "per-set cohort sizes change the lane width")
        _check(
            conf.ingest in ("auto", "packed"),
            f"--ingest {conf.ingest!r} is not the packed lane stream",
        )
        _check(
            conf.similarity_strategy != "sharded",
            "sharded lanes have no dense N×N slice to stack",
        )
        _check(not conf.save_variants, "--save-variants needs the wire ingest")
        _check(not conf.check_ranges, "--check-ranges telemetry is per-accumulator")
        _check(
            not conf.gramian_checkpoint_dir and not conf.resume_from,
            "Gramian checkpointing cursors are per-accumulator",
        )
        _check(conf.fault_plan is None, "a fault plan must fire inside its own job only")
        _check(
            conf.num_samples == base.num_samples,
            f"cohort width {conf.num_samples} != {base.num_samples}: the stacked "
            "buffer has one sample axis",
        )
        _check(conf.block_size == base.block_size, "lane staging needs one block size")
        _check(
            bool(conf.exact_similarity) == bool(base.exact_similarity),
            "mixed dtype ladders cannot share the stacked buffer",
        )
    _check(
        dense_strategy_fits(base.num_samples),
        f"cohort {base.num_samples} is past the dense HBM rule (sharded lanes cannot stack)",
    )
    if not base.exact_similarity:
        # Each lane's rows bounded from the declared synthetic site grid,
        # silently: preflight prints nothing.
        for conf in confs:
            source = make_source(conf)
            with contextlib.redirect_stdout(io.StringIO()):
                contigs = conf.get_contigs(source, conf.variant_set_id)
            total_sites = sum(source.declared_sites(c) for c in contigs)
            _check(
                total_sites <= EXACT_F32_LIMIT,
                f"{total_sites} projected sites could climb the dtype ladder "
                f"mid-stream (f32 exact window {EXACT_F32_LIMIT})",
            )
    cap = max_fused_jobs(base.num_samples, device_bytes=device_bytes)
    _check(
        k <= cap,
        f"group of {k} exceeds max_fused_jobs={cap} for N={base.num_samples} "
        "(stacked HBM charge is K× per-job)",
    )
    return k


def _lane_stream(conf: PcaConf, driver: VariantsPcaDriver):
    """One job's packed block stream: the serial packed arm's window
    stream (``pca_driver._window_blocks``), the same partitions in the
    same order, the same I/O stats and progress gauges."""
    return _window_blocks(conf, driver, *_packed_partitions(conf, driver))


def run_fused_pipeline(
    confs: Sequence[PcaConf],
    kinds: Sequence[str],
    devices: Optional[Sequence[DeviceLike]] = None,
    stdout_factory: Optional[Callable[[int], ContextManager]] = None,
) -> List[PipelineResult]:
    """Run an eligible group (:func:`preflight_fused`) as one stacked
    program: one :class:`PipelineResult` per job, in group order, each
    equal to the serial ``run_pipeline`` result of its conf (the same
    Gramian byte for byte, hence the same PC rows).

    The group runs on ``devices[0]`` (each lane's driver resolves its mesh
    over ``devices``, as ``run_pipeline`` does), by default on the device
    of the first conf's ``--device``: the card unless the CPU is named;
    a card asked for where none is present raises. The lanes are fed in
    lockstep, a block of each live lane a round; every job's
    ``ingest+similarity`` span covers the shared accumulation. Each job's
    driver holds the group's accumulator (``driver.accumulator``; job j's
    Gramian is its ``job_slice(j)``). ``stdout_factory(j)`` returns a
    context manager routing job j's prints (its driver's banner, rows,
    epilogue and manifest notice)."""
    k = preflight_fused(confs, kinds)
    job_stdout = stdout_factory or (lambda j: contextlib.nullcontext())
    kind = kinds[0]
    similarity_only = kind == "similarity"
    drivers: List[VariantsPcaDriver] = []
    times: List[StageTimes] = []
    for j, conf in enumerate(confs):
        with job_stdout(j):
            driver = VariantsPcaDriver(conf, device=conf.device, devices=devices)
            _export_compile_cache_gauges(driver.registry)
            drivers.append(driver)
            times.append(StageTimes(recorder=driver.spans))
    n = len(drivers[0].indexes)
    for driver in drivers:
        if len(driver.indexes) != n:
            raise FusedIneligible(f"lane cohort width {len(driver.indexes)} != {n}")
    device = drivers[0].device
    sync = synchronizer(device)
    acc = StackedJobsAccumulator(
        k, n, device=device, block_size=confs[0].block_size,
        exact_int=bool(confs[0].exact_similarity), pipeline_depth=2,
    )
    for driver in drivers:
        driver.accumulator = acc
    with contextlib.ExitStack() as stack:
        for j in range(k):
            stack.enter_context(times[j].stage("ingest+similarity", sync=sync))
        streams = [_lane_stream(confs[j], drivers[j]) for j in range(k)]
        # Lockstep round-robin: a block of each live lane a round keeps
        # every lane's pending queue O(1), host memory O(K × block).
        live = list(range(k))
        while live:
            for j in list(live):
                block = next(streams[j], None)
                if block is None:
                    acc.finish_lane(j)
                    live.remove(j)
                else:
                    acc.add_rows(j, np.asarray(block, dtype=np.uint8))
        acc.finalize()
    # The K-lane group is its own geometry, keyed by the shared batch
    # fingerprint and K.
    record_geometry(fused_group_fingerprint(batch_compile_fingerprint(confs[0], kind=kind), k))
    results: List[PipelineResult] = []
    for j, (conf, driver) in enumerate(zip(confs, drivers)):
        with job_stdout(j):
            similarity = acc.job_slice(j)
            _sync_scalar(similarity)
            summary = result = None
            if similarity_only:
                summary = _summarize_similarity(similarity, n)
            else:
                with times[j].stage("center+pca", sync=sync):
                    result = driver.compute_pca(similarity)
            # The serial epilogue (run_pipeline's tail), in its order.
            record_geometry(compile_fingerprint(conf, kind=kind))
            _register_prover_conformance(driver)
            lines = driver.emit_result(result) if result is not None else []
            driver.report_io_stats()
            manifest = manifest_path = None
            if conf.metrics_json:
                manifest = build_run_manifest(
                    conf=conf, spans=driver.spans, registry=driver.registry,
                    io_stats=driver.io_stats, overlap=driver.overlap,
                )
                try:
                    write_manifest(conf.metrics_json, manifest)
                except OSError as e:
                    print(f"Run manifest NOT written to {conf.metrics_json}: {e}", file=sys.stderr)
                else:
                    manifest_path = conf.metrics_json
                    print(f"Run manifest written to {conf.metrics_json}.")
            driver.stop()
            results.append(PipelineResult(lines, driver, manifest, manifest_path, summary))
    return results


__all__ = [
    "FUSABLE_KINDS",
    "FusedIneligible",
    "preflight_fused",
    "run_fused_pipeline",
]
