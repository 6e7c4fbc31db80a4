"""Windowed LD r² pruning: the ``ld-prune`` verb.

The port's copy of ``spark_examples_tpu/analyses/ld.py``. A streaming pass
over contig-ordered site windows: sites fill a ``(W, N)`` window buffer as
blocks stream; each full window runs one device program
(``ops/ld.py:ld_window_stats``: on the card ``unpack_rows_t`` and
``gram_accumulate`` over the window's transposed packing — on a mesh with
a samples axis, each position on its cut of the cohort, summed), the host
greedy-prunes the W×W r² matrix in contig order (``ops/ld.py:greedy_prune``,
strictly above ``--ld-r2-threshold``), and the window's kept-mask rows
spill straight to the windowed writer (``pipeline/sitewriter.py``).
Windows never cross a contig boundary. A tail window runs on its rows
alone: the reference pads it to W with monomorphic rows (r² 0, never
pruned against, masked out by ``valid``), so both keep the same sites.

Host memory is O(window), device memory O(W² + W·N), and the O(M) result
exists only on disk. The stage ``ingest+ld-prune`` carries two children
summed over the windows: ``ld-window-stats`` (the transposed packing, the
copy to the device, the kernels and the fetch of C) and ``ld-greedy-prune``
(the host's float64 r² and walk).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_examples_tpu_torch.analyses.base import AnalysisContext, finish_analysis_run
from spark_examples_tpu_torch.config import LdConf
from spark_examples_tpu_torch.obs.heartbeat import Heartbeat
from spark_examples_tpu_torch.obs.metrics import (
    ANALYSIS_SITES_KEPT,
    ANALYSIS_SITES_TESTED,
    well_known_gauge,
)
from spark_examples_tpu_torch.ops.ld import (
    greedy_prune,
    ld_window_stats,
    ld_window_stats_reference,
)
from spark_examples_tpu_torch.parallel.mesh import SAMPLES_AXIS
from spark_examples_tpu_torch.pipeline.sitewriter import SiteOutputWriter
from spark_examples_tpu_torch.utils.device import DeviceLike, synchronizer
from spark_examples_tpu_torch.utils.tracing import StageTimes


@dataclass
class LdResult:
    """One completed LD prune: tested/kept counts, the output path (when
    written), and the manifest bookkeeping."""

    sites_tested: int
    sites_kept: int
    out_path: Optional[str] = None
    manifest: Optional[Dict] = None
    manifest_path: Optional[str] = None


class _WindowedPruner:
    """The bounded window engine: a pre-allocated ``(W, N)`` buffer fills
    from the block stream; each flush is one device program + one host
    greedy prune + one writer append. State is O(W·N), independent of M.
    ``stats_fn`` maps a window's rows to ``(C, k)``; ``stats_seconds`` and
    ``prune_seconds`` sum the two halves of the flushes."""

    def __init__(
        self,
        conf: LdConf,
        num_samples: int,
        stats_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
        writer,
        registry=None,
    ):
        self.conf = conf
        self.n = int(num_samples)
        self.W = int(conf.ld_window_sites)
        self.stats_fn = stats_fn
        self.writer = writer
        self.rows = np.zeros((self.W, self.n), dtype=np.uint8)
        self.positions = np.zeros(self.W, dtype=np.int64)
        self.fill = 0
        self.contig: Optional[str] = None
        self.sites_tested = 0
        self.sites_kept = 0
        self.stats_seconds = 0.0
        self.prune_seconds = 0.0
        # Live progress gauges (the heartbeat's "analysis kept K/T"
        # segment), advanced per window. None-tolerant so oracle tests can
        # run bare.
        self._tested_gauge = self._kept_gauge = None
        if registry is not None:
            self._tested_gauge = well_known_gauge(registry, ANALYSIS_SITES_TESTED)
            self._kept_gauge = well_known_gauge(registry, ANALYSIS_SITES_KEPT)

    def add_block(self, contig: str, block: Dict[str, np.ndarray]) -> None:
        if contig != self.contig:
            # Contig boundary: the prune is contig-ordered by contract —
            # flush the tail window before the next contig's sites enter.
            self.flush()
            self.contig = contig
        hv = np.asarray(block["has_variation"], dtype=np.uint8)
        positions = np.asarray(block["positions"], dtype=np.int64)
        offset = 0
        while offset < hv.shape[0]:
            take = min(self.W - self.fill, hv.shape[0] - offset)
            self.rows[self.fill : self.fill + take] = hv[offset : offset + take]
            self.positions[self.fill : self.fill + take] = positions[offset : offset + take]
            self.fill += take
            offset += take
            if self.fill == self.W:
                self.flush()

    def flush(self) -> None:
        """Process the current (possibly partial) window: its ``fill``
        rows alone."""
        if self.fill == 0:
            return
        fill = self.fill
        t0 = time.perf_counter()
        C, k = self.stats_fn(self.rows[:fill])
        t1 = time.perf_counter()
        kept = greedy_prune(C, k, self.n, self.conf.ld_r2_threshold)
        self.prune_seconds += time.perf_counter() - t1
        self.stats_seconds += t1 - t0
        if self.writer is not None:
            contig = self.contig
            self.writer.write_rows(
                (contig, int(self.positions[i]), int(kept[i])) for i in range(fill)
            )
        self.sites_tested += fill
        self.sites_kept += int(kept.sum())
        if self._tested_gauge is not None:
            self._tested_gauge.set(self.sites_tested)
            self._kept_gauge.set(self.sites_kept)
        self.fill = 0


def ld_prune_reference(
    windows: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_samples: int,
    r2_threshold: float,
) -> List[Tuple[int, bool]]:
    """Host NumPy oracle of the windowed prune: ``windows`` is the
    contig-partitioned, window-chunked site stream as ``(positions,
    rows)`` pairs; returns ``(position, kept)`` in stream order."""
    out: List[Tuple[int, bool]] = []
    for positions, rows in windows:
        C, k = ld_window_stats_reference(rows)
        kept = greedy_prune(C, k, num_samples, r2_threshold)
        out.extend((int(p), bool(m)) for p, m in zip(positions, kept))
    return out


def run_ld_pipeline(conf: LdConf, device: DeviceLike = None, devices=None) -> LdResult:
    """The LD-prune core, CLI-free: conf in, kept-mask + manifest out, on
    ``device`` (default ``conf.device``), or over the run's mesh (resolved
    over ``devices``, as the PCA driver's: a device may repeat) whose
    samples axis splits each window's cohort."""
    ctx = AnalysisContext(conf, "ld", device=device, devices=devices)
    times = StageTimes(recorder=ctx.spans)
    # --pca-backend host runs the window statistics as the NumPy oracle —
    # no mesh — the same host escape hatch GRM and assoc honor.
    host_oracle = conf.pca_backend == "host"
    mesh = None if host_oracle else ctx.make_mesh()
    if mesh is not None:
        samples_axis = mesh.shape.get(SAMPLES_AXIS, 1)
        if samples_axis >= 2 and ctx.num_samples % samples_axis:
            # ld-cohort-not-divisible: the window's cohort is cut into
            # equal row ranges, without padding.
            raise ValueError(
                f"--num-samples {ctx.num_samples} does not divide over "
                f"the mesh samples axis ({samples_axis}); choose a mesh "
                "whose samples axis divides the cohort"
            )
    if host_oracle:
        stats_fn = ld_window_stats_reference
    else:
        def stats_fn(rows):
            return ld_window_stats(rows, ctx.device, mesh=mesh)
    writer = None
    if conf.ld_out:
        writer = SiteOutputWriter(conf.ld_out, header=("contig", "pos", "kept"))
    heartbeat = None
    if conf.heartbeat_seconds > 0:
        heartbeat = Heartbeat(conf.heartbeat_seconds, ctx.registry).start()
    pruner = _WindowedPruner(conf, ctx.num_samples, stats_fn, writer, registry=ctx.registry)
    try:
        with times.stage("ingest+ld-prune", sync=synchronizer(ctx.device)):
            for contig, block in ctx.blocks():
                pruner.add_block(contig, block)
            pruner.flush()
            ctx.spans.add("ld-window-stats", pruner.stats_seconds, synced=True)
            ctx.spans.add("ld-greedy-prune", pruner.prune_seconds)
    except BaseException:
        if writer is not None:
            writer.abort()
        raise
    finally:
        if heartbeat is not None:
            heartbeat.stop()
    if writer is not None:
        writer.close()
        print(f"Kept-site mask written to {conf.ld_out}.")
    print(
        f"LD prune (r² > {conf.ld_r2_threshold} pruned, window "
        f"{conf.ld_window_sites}): kept {pruner.sites_kept} / "
        f"{pruner.sites_tested} sites."
    )
    print(str(ctx.io_stats))
    if conf.profile_dir:
        print(str(times))
    manifest, manifest_path, _ = finish_analysis_run(
        conf,
        "ld",
        ctx.spans,
        ctx.registry,
        ctx.io_stats,
        sites_tested=pruner.sites_tested,
        sites_kept=pruner.sites_kept,
    )
    return LdResult(
        sites_tested=pruner.sites_tested,
        sites_kept=pruner.sites_kept,
        out_path=conf.ld_out,
        manifest=manifest,
        manifest_path=manifest_path,
    )


def run(argv: Sequence[str], device: DeviceLike = None) -> LdResult:
    """The ``ld-prune`` CLI verb: joins the run's processes when the
    cluster flags name them. ``device`` overrides ``--device``."""
    conf = LdConf.parse(argv)
    conf.init_distributed()
    return run_ld_pipeline(conf, device=device)


__all__ = ["LdResult", "ld_prune_reference", "run", "run_ld_pipeline"]
