"""Per-job execution: one admitted job through the reusable pipeline core.

The port's counterpart of ``spark_examples_tpu/serve/executor.py``.
``pipeline.pca_driver.run_pipeline`` is the library entry point the
batch CLI and this executor share — a served job executes the IDENTICAL
pipeline a batch invocation would, and produces the identical schema-v2
run manifest. The ``grm`` kind dispatches the same way to the analysis
core (``analyses/grm.py:run_grm_pipeline``); a batch group runs as one
stacked program through ``pipeline/fused.py:run_fused_pipeline``. The
executor's additions are service concerns only:

- **placement**: a job runs on the positions of the slice that claimed it
  (``job.slice_devices``, ``torch.device`` values the daemon sets just
  before execution), and its conf's ``device`` is made their type, so a
  served job never picks its own device (``--device`` is a reserved flag)
  and never lands on the CPU behind the daemon's back. The daemon runs the
  call under its worker's own CUDA stream and synchronises before the job
  settles (``serve/daemon.py``); no error here is retried elsewhere;
- **per-job manifest placement**: every job's manifest is written to
  ``<run_dir>/jobs/<job_id>/manifest.json`` (atomic rename, validated
  after the run), so batch and served runs produce the same artifact;
- **warm-vs-cold attribution**: the job's geometry fingerprint is checked
  against the process-wide warm-geometry ledger (``utils/cache.py``)
  BEFORE the run, so the job record says whether this process (or, with
  the ledger file, an earlier daemon on the run directory) had already
  built and run every kernel the geometry launches;
- **stdout capture**: the pipeline prints its result rows and epilogue;
  each job's prints land in ``jobs/<job_id>/stdout.log``. The capture is
  THREAD-ROUTED (:class:`_ThreadStdoutRouter`), not a process-global
  ``redirect_stdout``: only the worker thread's writes divert to the job
  log, so HTTP threads (and an embedding test harness) keep their own
  stdout while a job is mid-flight.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from spark_examples_tpu_torch.serve.queue import Job


class _ThreadStdoutRouter(io.TextIOBase):
    """``sys.stdout`` stand-in for the job window: writes from the worker
    thread land in the job's log, every other thread passes through to
    the previous stdout untouched."""

    def __init__(self, fallback, thread_id: int, sink):
        self._fallback = fallback
        self._thread_id = thread_id
        self._sink = sink

    def _target(self):
        return (
            self._sink
            if threading.get_ident() == self._thread_id
            else self._fallback
        )

    def writable(self) -> bool:
        return True

    def write(self, text: str) -> int:
        return self._target().write(text)

    def flush(self) -> None:
        self._target().flush()


class _SwitchableSink(io.TextIOBase):
    """The fused group's per-phase stdout target: one worker thread runs
    K jobs' phases interleaved, so thread routing alone cannot separate
    their output — this sink stacks the CURRENT target, and the fused
    runner's per-job phases push each job's log for their duration. The
    default (bottom-of-stack) target catches group-phase output that
    belongs to no single job."""

    def __init__(self, default):
        self._stack = [default]

    def writable(self) -> bool:
        return True

    def write(self, text: str) -> int:
        return self._stack[-1].write(text)

    def flush(self) -> None:
        self._stack[-1].flush()

    @contextlib.contextmanager
    def routed(self, sink):
        self._stack.append(sink)
        try:
            yield
        finally:
            self._stack.pop()


@dataclass
class ExecutionOutcome:
    """What one completed job hands back to the daemon's job table."""

    result: Dict
    manifest_path: Optional[str]
    compile_cache: str  # "warm" | "cold"
    #: The run manifest's prover-conformance block (measured-vs-proven
    #: per prover; ``obs/metrics.py:conformance_block``) — the daemon
    #: mirrors it into the service registry so ``GET /metrics`` exports
    #: the fleet's latest pair per prover.
    conformance: Optional[Dict] = None


def job_directory(run_dir: str, job_id: str) -> str:
    return os.path.join(run_dir, "jobs", job_id)


def _place(job: Job):
    """The claiming slice's positions (``None`` for an embedder calling the
    executor without a daemon: the conf's own device); the conf's
    ``device`` is made their type."""
    devices = getattr(job, "slice_devices", None)
    if devices:
        job.conf.device = torch.device(devices[0]).type
    return devices


def execute_job(job: Job, run_dir: str) -> ExecutionOutcome:
    """Run one admitted job to completion on its slice's positions (a
    slice's worker calls this serially; slices never share a position)."""
    from spark_examples_tpu_torch.obs.manifest import validate_manifest
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline
    from spark_examples_tpu_torch.utils.cache import (
        compile_fingerprint,
        geometry_seen,
    )

    job_dir = job_directory(run_dir, job.id)
    os.makedirs(job_dir, exist_ok=True)
    conf = job.conf
    # The service owns manifest placement (admission rejects an explicit
    # --metrics-json): one canonical per-job path, same schema as batch.
    conf.metrics_json = os.path.join(job_dir, "manifest.json")
    warm = geometry_seen(compile_fingerprint(conf, kind=job.request.kind))

    devices = _place(job)
    similarity_only = job.request.kind == "similarity"
    with open(
        os.path.join(job_dir, "stdout.log"), "w", encoding="utf-8"
    ) as captured:
        previous = sys.stdout
        sys.stdout = _ThreadStdoutRouter(
            previous, threading.get_ident(), captured
        )
        try:
            if job.request.kind == "grm":
                # The analyses dispatch: the IDENTICAL analysis core the
                # batch `grm` verb runs (its finish_analysis_run writes
                # the same schema-v2 manifest to the per-job path and
                # records the kind-keyed warm-ledger geometry).
                from spark_examples_tpu_torch.analyses.grm import run_grm_pipeline

                grm = run_grm_pipeline(conf, devices=devices)
                result: Dict = {"grm": grm.summary}
                manifest_doc = grm.manifest
                manifest_path = grm.manifest_path
            else:
                pipeline = run_pipeline(
                    conf, similarity_only=similarity_only, devices=devices
                )
                if similarity_only:
                    result = {"similarity": pipeline.similarity_summary}
                else:
                    result = {"pc_lines": pipeline.lines}
                manifest_doc = pipeline.manifest
                manifest_path = pipeline.manifest_path
        finally:
            sys.stdout = previous

    if manifest_path is None:
        raise RuntimeError(
            f"job {job.id} completed but its manifest was not written "
            f"(expected {conf.metrics_json})"
        )
    errors = validate_manifest(manifest_doc)
    if errors:
        raise RuntimeError(
            f"job {job.id} produced an invalid run manifest: "
            + "; ".join(errors)
        )

    return ExecutionOutcome(
        result=result,
        manifest_path=manifest_path,
        compile_cache="warm" if warm else "cold",
        conformance=(
            manifest_doc.get("conformance")
            if isinstance(manifest_doc, dict)
            else None
        ),
    )


def execute_fused_batch(
    jobs: Sequence[Job], run_dir: str
) -> List[ExecutionOutcome]:
    """Run a batch group as ONE stacked device program
    (``pipeline/fused.py``), one outcome per job in group order.

    Raises ``FusedIneligible`` BEFORE any side effect (no job directory,
    no log, no device work) when the group cannot ride the stacked
    program — the daemon catches it and falls back to the serial
    per-job loop, which is always valid. Any exception past preflight
    fails the whole group, exactly as a serial executor exception fails
    its one job."""
    from spark_examples_tpu_torch.obs.manifest import validate_manifest
    from spark_examples_tpu_torch.pipeline.fused import (
        preflight_fused,
        run_fused_pipeline,
    )
    from spark_examples_tpu_torch.utils.cache import (
        batch_compile_fingerprint,
        compile_fingerprint,
        fused_group_fingerprint,
        geometry_seen,
    )

    kinds = [job.request.kind for job in jobs]
    devices = [_place(job) for job in jobs][0]
    confs = [job.conf for job in jobs]
    preflight_fused(confs, kinds)

    warm: List[bool] = []
    files: List = []
    group_warm = geometry_seen(
        fused_group_fingerprint(
            batch_compile_fingerprint(confs[0], kind=kinds[0]), len(jobs)
        )
    )
    with contextlib.ExitStack() as stack:
        for job in jobs:
            job_dir = job_directory(run_dir, job.id)
            os.makedirs(job_dir, exist_ok=True)
            job.conf.metrics_json = os.path.join(job_dir, "manifest.json")
            # Warm-vs-cold per member: the member geometry AND the
            # group's stacked geometry must both be warm — a known job
            # shape still runs a stacked geometry this process has not
            # run the first time its group size appears.
            warm.append(
                group_warm
                and geometry_seen(
                    compile_fingerprint(job.conf, kind=job.request.kind)
                )
            )
            files.append(
                stack.enter_context(
                    open(
                        os.path.join(job_dir, "stdout.log"),
                        "w",
                        encoding="utf-8",
                    )
                )
            )
        previous = sys.stdout
        # Group-phase prints (nothing per-job by the runner's contract)
        # land in the FIRST member's log rather than the daemon's stdout.
        switch = _SwitchableSink(files[0])
        sys.stdout = _ThreadStdoutRouter(
            previous, threading.get_ident(), switch
        )
        try:
            pipelines = run_fused_pipeline(
                confs,
                kinds,
                devices=devices,
                stdout_factory=lambda j: switch.routed(files[j]),
            )
        finally:
            sys.stdout = previous

    outcomes: List[ExecutionOutcome] = []
    for job, pipeline, was_warm in zip(jobs, pipelines, warm):
        if pipeline.manifest_path is None:
            raise RuntimeError(
                f"fused job {job.id} completed but its manifest was not "
                f"written (expected {job.conf.metrics_json})"
            )
        errors = validate_manifest(pipeline.manifest)
        if errors:
            raise RuntimeError(
                f"fused job {job.id} produced an invalid run manifest: "
                + "; ".join(errors)
            )
        result: Dict = (
            {"similarity": pipeline.similarity_summary}
            if job.request.kind == "similarity"
            else {"pc_lines": pipeline.lines}
        )
        outcomes.append(
            ExecutionOutcome(
                result=result,
                manifest_path=pipeline.manifest_path,
                compile_cache="warm" if was_warm else "cold",
                conformance=(
                    pipeline.manifest.get("conformance")
                    if isinstance(pipeline.manifest, dict)
                    else None
                ),
            )
        )
    return outcomes


__all__ = [
    "ExecutionOutcome",
    "execute_fused_batch",
    "execute_job",
    "job_directory",
]
