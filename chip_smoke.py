#!/usr/bin/env python3
"""Drive the PyTorch port (``spark_examples_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. card: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel built from ``spark_examples_tpu_torch/csrc`` with
   nvcc (``-Xptxas -v`` report printed);
3. kernels: each kernel against its plain PyTorch version at the main path's
   width (2,504 samples, one block of 16,384 sites), exactly equal; then
   CUDA-event times of the kernel, its plain version and, where one exists,
   the PyTorch library call computing the same function;
4. main path: ``variants-pca`` over chr17 at 2,504 samples (a cold run,
   then a warm one), then over the default BRCA1 region, through
   ``run_pipeline``; launch counts, wall-clock, stage spans,
   peak device memory, and the PCs checked against a full ``eigh`` of the
   same run's centered Gramian;
5. the ``kernels`` JSON line, the card line, and last the result line.

Imports nothing of JAX or of the JAX package. Exits non-zero without a
result when no CUDA card is present or the port is not beside this file.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time

import numpy as np

#: chr17 at the CLI's synthetic grid (one site every 100 bases: 811,953
#: sites), the 1000 Genomes cohort width.
CHR17_ARGV = ["--references", "17:0:81195210", "--num-samples", "2504",
              "--ingest", "device", "--block-size", "16384"]
BRCA1_ARGV = ["--num-samples", "2504", "--ingest", "device"]
N_SAMPLES = 2504
BLOCK = 16384
#: Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
#: sm_90 issues 64 32-bit integer operations (add, logic, shift, compare,
#: IMAD) per SM per clock; the rate is this times the SMs and the max clock.
INT32_OPS_PER_SM_PER_CLOCK = 64
#: u32 operations per drawn genotype: fold xor (1), fmix32 (3 shift-xors,
#: 2 multiplies: 8), the second allele's multiply and xor (2), two
#: compares (2), one or (1).
GEN_OPS_PER_GENOTYPE = 14
#: |PC entry| tolerance between the subspace iteration and a full eigh of the
#: same centered matrix: both in float32 on unit-norm components, with
#: different starts; see PERF.md for the measured gap.
PC_TOLERANCE = 1e-4


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def int32_ops_per_s(torch) -> float:
    """The card's 32-bit integer rate: SMs × max SM clock × 64."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_PER_SM_PER_CLOCK * sms * float(mhz) * 1e6


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_rate: float):
    """(least time in ms, what bounds it) for the work on this card."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, devicegen):
    """Each kernel against its plain version at the main path's width."""
    from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

    dev = torch.device("cuda")
    source = SyntheticGenomicsSource(num_samples=N_SAMPLES)
    plan = devicegen.make_gen_plan(
        [source.genotype_stream_key("chip-smoke")], [source.populations],
        source.site_key, source.variant_spacing, source.ref_block_fraction,
        None, source.n_pops, dev,
    )
    zeros = lambda: (torch.zeros((), dtype=torch.int64, device=dev),
                     torch.zeros((1,), dtype=torch.int64, device=dev))
    rows = {}
    # A full block in chr17's grid and a ragged tail block.
    xt = None
    for offset, n_valid in ((400_000, BLOCK), (811_000, 5_000)):
        kept_k, rows_k = zeros()
        kept_p, rows_p = zeros()
        got = devicegen.gen_genotypes(plan, offset, n_valid, BLOCK, kept_k, rows_k)
        want = devicegen.gen_genotypes_plain(plan, offset, n_valid, BLOCK, kept_p, rows_p)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if err or not (torch.equal(kept_k, kept_p) and torch.equal(rows_k, rows_p)):
            raise AssertionError(
                f"gen_genotypes != plain at offset {offset}: max err {err}, "
                f"kept {int(kept_k)} vs {int(kept_p)}, rows {rows_k.tolist()} vs {rows_p.tolist()}"
            )
        log(f"kernels: gen_genotypes == plain at offset {offset}, n_valid {n_valid}: "
            f"kept {int(kept_k)}, variant rows {rows_k.tolist()}")
        if xt is None:  # the full block: the one timed below
            xt, kept_sites = got, int(kept_k)
    rows["gen_genotypes"] = {"max_abs_err": 0}

    n = plan.n_cols
    g_k = torch.zeros((n, n), dtype=torch.int32, device=dev)
    g_p = torch.zeros((n, n), dtype=torch.int32, device=dev)
    for _ in range(2):  # twice: the second adds onto a nonzero G
        devicegen.gram_accumulate(g_k, xt)
        devicegen.gram_accumulate_plain(g_p, xt)
    torch.cuda.synchronize()
    err = int((g_k.long() - g_p.long()).abs().max())
    if err:
        raise AssertionError(f"gram_accumulate != plain: max err {err}")
    log(f"kernels: gram_accumulate == plain at N={n}, {BLOCK} sites, twice: "
        f"trace {int(g_k.diagonal().long().sum())}")
    rows["gram_accumulate"] = {"max_abs_err": err}

    # Times at the main path's shapes.
    kept, vrows = zeros()
    gen_ms = cuda_ms(lambda: devicegen.gen_genotypes(plan, 400_000, BLOCK, BLOCK, kept, vrows), 50)
    gen_plain_ms = cuda_ms(lambda: devicegen.gen_genotypes_plain(plan, 400_000, BLOCK, BLOCK, kept, vrows), 5, 1)
    gram_ms = cuda_ms(lambda: devicegen.gram_accumulate(g_k, xt), 20)
    gram_plain_ms = cuda_ms(lambda: devicegen.gram_accumulate_plain(g_p, xt), 5, 1)
    xt_n = xt[:n] if n % 8 == 0 else xt  # _int_mm wants widths that are multiples of 8
    int_mm_ms = cuda_ms(lambda: torch._int_mm(xt_n, xt_n.t()), 20)
    # Bounds of what the functions need: generation writes N × B int8 and
    # draws the genotypes of the kept sites only (a dropped site's threshold
    # is 0, so its genotypes are 0 without a draw); the product is symmetric,
    # N·(N+1)/2 distinct entries of 2·B operations, reading Xᵀ once and G
    # (int32) once each way.
    int32_rate = int32_ops_per_s(torch)
    log(f"kernels: int32 rate {int32_rate:.4e} ops/s, int8 {PEAK_INT8_OPS_PER_S:.4e} ops/s, "
        f"{PEAK_BYTES_PER_S:.4e} B/s; timed block: {kept_sites} kept of {BLOCK} sites")
    rows["gen_genotypes"].update(
        ms=gen_ms, plain_ms=gen_plain_ms, library_ms=None,
        bound=bound(n * BLOCK, n * kept_sites * GEN_OPS_PER_GENOTYPE, int32_rate),
    )
    rows["gram_accumulate"].update(
        ms=gram_ms, plain_ms=gram_plain_ms, library_ms=int_mm_ms,
        bound=bound(n * BLOCK + 2 * 4 * n * n, float(n) * (n + 1) * BLOCK, PEAK_INT8_OPS_PER_S),
    )
    for name, r in rows.items():
        log(f"kernels: {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']}, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, "
            f"{100 * r['bound'][0] / r['ms']:.1f} % of it)")
    return rows


def run_main_path(torch, devicegen, argv, label):
    """One ``variants-pca`` run through the port's entry point, launches
    counted from zero; the PCs checked against a full eigh of its Gramian."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.obs.metrics import (
        DEVICEGEN_DISPATCHES,
        DEVICEGEN_SITES_CAPACITY,
        INGEST_SITES_SCANNED,
    )
    from spark_examples_tpu_torch.ops.centering import gower_center
    from spark_examples_tpu_torch.ops.pca import principal_components
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    conf = PcaConf.parse(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    devicegen.reset_launch_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        result = run_pipeline(conf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for line in printed.getvalue().splitlines():
        if line.strip() and "\t" not in line:
            log(f"main path {label} | {line}")
    log(f"main path {label} | {len(result.lines)} rows, the first: {result.lines[0]!r}")
    launches = {k.__name__: k.launches for k in devicegen.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    driver = result.driver
    acc = driver.accumulator
    stages = {s["path"]: s["seconds"] for s in driver.spans.flat()}
    gauges = {name: driver.registry.value(name) for name in (
        INGEST_SITES_SCANNED, DEVICEGEN_DISPATCHES, DEVICEGEN_SITES_CAPACITY)}
    log(f"main path {label}: wall {wall:.4f} s, stages {json.dumps(stages)}, "
        f"launches {json.dumps(launches)}, peak device memory {peak / 2**20:.1f} MiB, "
        f"gauges {json.dumps(gauges)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path {label} never launched {missing}")

    n = len(driver.indexes)
    if len(result.lines) != n:
        raise AssertionError(f"{label}: {len(result.lines)} rows for {n} samples")
    got = np.array([[float(v) for v in line.split("\t")[2:]] for line in result.lines])
    if got.shape != (n, conf.num_pc) or not np.isfinite(got).all():
        raise AssertionError(f"{label}: PCs of shape {got.shape} or not finite")
    full, evals = principal_components(gower_center(acc.G), conf.num_pc)
    full = full.cpu().numpy()
    by_name = {driver.names[cs]: full[i] for cs, i in driver.indexes.items()}
    want = np.array([by_name[name] for name in sorted(by_name)])
    gap = float(np.abs(got - want).max())
    log(f"main path {label}: max |PC - eigh PC| {gap:.3e} (tolerance {PC_TOLERANCE}), "
        f"top |eigenvalues| {[round(float(e), 3) for e in evals.cpu()]}")
    if gap > PC_TOLERANCE:
        raise AssertionError(f"{label}: PCs differ from the full eigh by {gap}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from spark_examples_tpu_torch.ops import _kernels, devicegen
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 1

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = _kernels.build_all()
    log(f"build: {len(libs)} library(ies) in {time.perf_counter() - t0:.1f} s")
    for source in libs:
        for line in _kernels.build_log(source).splitlines():
            if any(key in line for key in ("Compiling entry", "Used", "spill")):
                log(f"build: {source}: {line.strip()}")

    rows = phase_kernels(torch, devicegen)
    # The first run in a process also pays the CUDA libraries' lazy set-up
    # (the eigensolve's first cuSOLVER call); the second is the warm time.
    run_main_path(torch, devicegen, CHR17_ARGV, "chr17 cold")
    launches = run_main_path(torch, devicegen, CHR17_ARGV, "chr17")
    run_main_path(torch, devicegen, BRCA1_ARGV, "brca1")

    for name in ("jax", "spark_examples_tpu"):
        if name in sys.modules:
            raise AssertionError(f"{name} was imported")
    kernels = []
    for name, source in (("gen_genotypes", "spark_examples_tpu_torch/csrc/devicegen.cu"),
                         ("gram_accumulate", "spark_examples_tpu_torch/csrc/devicegen.cu")):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "experiments/pallas_fused_gramian.py:151",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    if any(not math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("a kernel time is not finite")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
