"""One run of one cell: set-up, the measured window, the traced stretch of a
``--trace 1`` run, the verdict, and the result line.

The program under test is the PyTorch port, driven through its public
entry ``spark_examples_tpu_torch.pipeline.pca_driver.run_pipeline``: one
whole PCoA job a call (device-generated ingest into the Gramian, Gower
centring, the top components, the emitted rows), in a closed loop. Its
standard output goes to an in-memory sink; the last line of this process's
standard output is the result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, TextIO, Tuple

import torch

from gpubench.catalog import Benchmark, Metric
from gpubench.devtrace import JOB_RANGE, DeviceTrace, read_trace
from gpubench.reference import Cohort, JobOutput, control_job, kept_sites
from gpubench.traffic import Reservoir, Traffic
from gpubench.verdict import checks, judge, passes, worst

#: Top-level module names no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_examples_tpu")

#: A job: its data seed in, its output and its spans' seconds out.
JobFn = Callable[[int], Tuple[JobOutput, Dict[str, float]]]


class Sink:
    """Where the program's standard output goes: counted, not kept."""

    def __init__(self) -> None:
        self.chars = 0

    def write(self, text: str) -> int:
        self.chars += len(text)
        return len(text)

    def flush(self) -> None:
        pass


def pca_argv(config: Dict, device: str) -> List[str]:
    """The ``variants-pca`` flags of a configuration."""
    argv = [
        "--device", device,
        "--num-samples", str(config["num_samples"]),
        "--variant-set-id", str(config["variant_set_id"]),
        "--ingest", str(config["ingest"]),
        "--block-size", str(config["block_size"]),
        "--num-pc", str(config["num_pc"]),
    ]
    if config.get("all_references"):
        return argv + ["--all-references"]
    return argv + ["--references", ",".join(f"{c}:{s}:{e}" for c, s, e in config["contigs"])]


class PortJobs:
    """The program under test: ``run_pipeline`` on a synthetic cohort of the
    configuration's sizes, seeded per job."""

    def __init__(self, config: Dict, device: str):
        from spark_examples_tpu_torch.config import PcaConf
        from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline
        from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

        self.config = config
        self.conf = PcaConf.parse(pca_argv(config, device))
        self._run = run_pipeline
        self._source = SyntheticGenomicsSource

    def __call__(self, seed: int) -> Tuple[JobOutput, Dict[str, float]]:
        c = self.config
        source = self._source(
            num_samples=int(c["num_samples"]),
            seed=seed,
            variant_spacing=int(c["variant_spacing"]),
            ref_block_fraction=float(c["ref_block_fraction"]),
            n_pops=int(c["n_pops"]),
        )
        result = self._run(self.conf, source=source)
        spans = {s.name: s.seconds for s in result.driver.spans.roots if s.seconds is not None}
        return JobOutput(result.lines, result.driver.accumulator.G), spans


class ControlJobs:
    """The reference one precision step down, in the program's place."""

    def __init__(self, config: Dict, device: torch.device):
        self.config = config
        self.device = device

    def __call__(self, seed: int) -> Tuple[JobOutput, Dict[str, float]]:
        cohort = Cohort.from_config(self.config, seed)
        return control_job(cohort, int(self.config["num_pc"]), self.device), {}


@dataclass
class Job:
    seed: int
    wall_s: float
    sites: int
    spans: Dict[str, float]
    peak_bytes: int


@dataclass
class Context:
    """What the metric readers read."""

    num_samples: int
    setup_s: float
    window_s: float
    jobs: List[Job]
    peak_bytes: int
    trace: Optional[DeviceTrace] = None
    traced_jobs: List[Job] = field(default_factory=list)
    traced_kept_sites: List[int] = field(default_factory=list)


@dataclass
class Loop:
    """The closed loop's jobs, with the reservoir of outputs to judge."""

    jobs: JobFn
    traffic: Traffic
    seed: int
    sites: int
    num_samples: int
    device: torch.device
    err: TextIO
    reservoir: Reservoir
    attempted: int = 0
    failed: int = 0
    next_index: int = 0

    def _held_bytes(self) -> int:
        held = 0
        for _, (_, output) in self.reservoir.items:
            g = output.gramian
            if g.device.type == "cuda":
                held += -(-g.untyped_storage().nbytes() // 512) * 512
        return held

    def one(self) -> Optional[Job]:
        """Run the next job; ``None`` when it raised."""
        index = self.next_index
        self.next_index += 1
        self.attempted += 1
        seed = self.traffic.job_seed(self.seed, index)
        held = self._held_bytes()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        start = time.perf_counter()
        try:
            output, spans = self.jobs(seed)
        except Exception:  # a failed job is counted and the loop goes on
            self.failed += 1
            if self.failed == 1:
                traceback.print_exc(file=self.err)
            return None
        wall = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        if len(output.lines) != self.num_samples:
            self.failed += 1
        self.reservoir.offer(index, (seed, output))
        return Job(seed, wall, self.sites, spans, peak - held)

    def window(self, seconds: float) -> Tuple[List[Job], float]:
        """Jobs one after another until ``seconds`` have passed: the jobs
        that completed and the window's length, to the end of its last."""
        done: List[Job] = []
        start = time.perf_counter()
        while True:
            job = self.one()
            if job is not None:
                done.append(job)
            now = time.perf_counter()
            if now - start >= seconds:
                return done, now - start

    def traced(self) -> Tuple[List[Job], Optional[DeviceTrace]]:
        """``trace_jobs`` jobs under the profiler, each a ``gpubench.job``
        range; the trace goes to a file under the temporary directory,
        is read, and is deleted."""
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        done: List[Job] = []
        with profile(activities=activities) as prof:
            for _ in range(self.traffic.trace_jobs):
                with record_function(JOB_RANGE):
                    job = self.one()
                if job is not None:
                    done.append(job)
        path = os.path.join(tempfile.gettempdir(), f"gpubench-trace-{os.getpid()}.json")
        try:
            prof.export_chrome_trace(path)
            trace = read_trace(path)
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
        return done, trace


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="gpubench/run.py", description=__doc__)
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(list(argv))
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


def read_metrics(metrics: Sequence[Metric], ctx: Context) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = m.read(ctx)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out


def main(
    argv: Sequence[str],
    started: Optional[float] = None,
    bench: Optional[Benchmark] = None,
    jobs: Optional[JobFn] = None,
    need_card: bool = True,
    out: Optional[TextIO] = None,
    err: Optional[TextIO] = None,
) -> int:
    """Run one cell and print its result line. ``jobs`` replaces the
    program (a control or a planted fault); ``need_card=False`` runs on the
    CPU, for tests."""
    started = time.perf_counter() if started is None else started
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    args = parse_args(argv)
    bench = Benchmark() if bench is None else bench
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = Traffic.from_doc(cell["traffic"], bench.traffic(cell["traffic"]))
    metrics = bench.metrics(cell["name"], traced=bool(args.trace))
    chips = int(cell["chips"])
    if need_card:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            print(f"gpubench: {args.workload} needs {chips} CUDA card(s), found {found}", file=err)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    num_samples = int(config["num_samples"])
    sites = Cohort.from_config(config, 0).grid_sites()
    sink = Sink()
    marks = [("harness imported", time.perf_counter() - started)]
    with contextlib.redirect_stdout(sink):
        if jobs is None:
            jobs = PortJobs(config, device.type)
        marks.append(("program imported", time.perf_counter() - started))
        loop = Loop(jobs, traffic, args.seed, sites, num_samples, device, err,
                    Reservoir(traffic.checked_jobs, traffic.job_seed(args.seed, -1)))
        for _ in range(traffic.warm_jobs):
            output, _ = jobs(traffic.job_seed(args.seed, loop.next_index))
            loop.next_index += 1
            del output
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - started
    marks.append(("warm jobs done", setup_s))
    print("gpubench: set-up " + ", ".join(f"{name} at {t:.3f} s" for name, t in marks), file=err)
    with contextlib.redirect_stdout(sink):
        setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        window_jobs, window_s = loop.window(args.seconds)
        traced_jobs, trace = loop.traced() if args.trace else ([], None)
    if not window_jobs:
        print("gpubench: no job completed in the window", file=err)
        return 1
    if args.trace and trace is None and device.type == "cuda":
        print("gpubench: the trace holds no device operation inside the traced jobs", file=err)
        return 1
    all_jobs = window_jobs + traced_jobs
    ctx = Context(
        num_samples=num_samples,
        setup_s=setup_s,
        window_s=window_s,
        jobs=window_jobs,
        peak_bytes=max(j.peak_bytes for j in window_jobs),
        trace=trace,
        traced_jobs=traced_jobs,
        traced_kept_sites=[kept_sites(Cohort.from_config(config, j.seed), device)
                           for j in traced_jobs] if args.trace else [],
    )
    peak_raw = max([setup_peak] + [j.peak_bytes for j in all_jobs])
    device_doc: Dict[str, object] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": chips,
        "memory_peak_bytes": int(peak_raw),
    }
    if trace is not None:
        device_doc["busy_s"] = trace.busy_s
        device_doc["window_s"] = trace.window_s
    if device.type == "cuda":
        limit = power_limit()
        if limit is not None:
            device_doc["power_limit"] = limit
    values = read_metrics(metrics, ctx)

    # The verdict: the reservoir's jobs against the reference, once the
    # window has closed and the program's state is freed.
    sampled, attempted, failed = list(loop.reservoir.items), loop.attempted, loop.failed
    del loop, jobs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = []
    for index, (seed, output) in sampled:
        readings.append(judge(Cohort.from_config(config, seed), output,
                              int(config["num_pc"]), device))
        print(f"gpubench: judged job {index} (data seed {seed}): {json.dumps(readings[-1])}",
              file=err)
    del sampled
    reading = worst(readings)
    reading["failed_jobs"] = failed
    print(f"gpubench: window job walls (s): {[round(j.wall_s, 6) for j in window_jobs]}",
          file=err)
    print(f"gpubench: {len(window_jobs)} jobs in {window_s:.6f} s, {attempted} attempted, "
          f"{failed} failed; program output {sink.chars} characters; the reference took "
          f"{time.perf_counter() - t0:.3f} s", file=err)

    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}; no result", file=err)
        return 3
    table = checks(reading, config["limits"])
    result: Dict[str, object] = {
        "correct": passes(table),
        "attempted": attempted,
        "failed": failed,
        "metrics": values,
        "device": device_doc,
    }
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = table
    for name, row in table.items():
        print(f"gpubench check {name}: {row['value']} (limit {row['limit']})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


__all__ = ["ControlJobs", "FORBIDDEN", "PortJobs", "forbidden_modules", "main", "pca_argv"]
