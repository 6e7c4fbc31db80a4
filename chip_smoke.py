#!/usr/bin/env python3
"""Drive the PyTorch port (``spark_examples_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. card: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel built from ``spark_examples_tpu_torch/csrc`` with
   nvcc, one process per source, all started together (``-Xptxas -v``
   report printed);
3. kernels: each kernel against its plain PyTorch version at the shapes its
   path gives it, exactly equal: the device-generation pair at 2,504
   samples × 16,384 sites; the unpack of host-fed blocks, bit-packed and
   count-valued, at 2,504 samples × 1,024 and 16,384 rows, each followed by
   the product; the six u32 op chains at (1024, 2560) after 21 chained
   calls; the shared-memory scratch copy at the card's limit. Then
   CUDA-event times of each kernel, its plain version and, where one
   exists, the PyTorch library call computing the same function;
4. main path: ``variants-pca`` through ``run_pipeline`` — device generation
   over chr17 at 2,504 samples (a cold run, then a warm one) and over the
   default BRCA1 region; then the host-fed arms at 2,504 samples: packed
   over 2 Mb of chr17, wire over 10 kb, and the same-set join (a duplicated
   variant-set id: count-valued rows) over 5 kb. For each: launch counts,
   wall-clock, stage spans, peak device memory, and the PCs checked
   against a full ``eigh`` of the same run's centered Gramian;
5. probes: the entry points of the two probes, ``probe_ops.run`` for every
   op and ``vmem_capacity.find_limit``, whose bisected limit must equal
   the driver's ``cudaDevAttrMaxSharedMemoryPerBlockOptin``;
6. the ``kernels`` JSON line, the card line, and last the result line.

Imports nothing of JAX or of the JAX package. Exits non-zero without a
result when no CUDA card is present or the port is not beside this file.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time

import numpy as np

#: chr17 at the CLI's synthetic grid (one site every 100 bases: 811,953
#: sites), the 1000 Genomes cohort width.
CHR17_ARGV = ["--references", "17:0:81195210", "--num-samples", "2504",
              "--ingest", "device", "--block-size", "16384"]
BRCA1_ARGV = ["--num-samples", "2504", "--ingest", "device"]
#: Host-fed arms at full width: packed over 2 Mb around BRCA1 (17,983
#: variant rows, 18 flushes of 1,024), wire over 10 kb, and the same-set
#: join (a duplicated id: count-valued rows) over 5 kb. Wire records cost
#: tens of milliseconds each to build at 2,504 samples, so its windows are
#: short.
PACKED_ARGV = ["--references", "17:41196311:43196311", "--num-samples", "2504",
               "--ingest", "packed"]
WIRE_ARGV = ["--references", "17:41196311:41206311", "--num-samples", "2504",
             "--ingest", "wire"]
SAME_SET_WINDOW = "17:41196311:41201311"
#: Rows of the unpack phase: the CLI's default block and the device path's.
UNPACK_ROWS = (1024, 16384)
N_SAMPLES = 2504
BLOCK = 16384
#: Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
#: The most 32-bit instructions an SM can issue per clock: four
#: schedulers, one warp instruction (32 lanes) each. Logic and shifts run
#: on a 64-lane pipe, but adds and multiplies also issue as IMAD on the FMA
#: pipe beside it, so 64 is no bound (the u32 op-chain probe ran faster).
#: The rate is this times the SMs and the max clock.
INT32_OPS_PER_SM_PER_CLOCK = 128
#: u32 operations per drawn genotype: fold xor (1), fmix32 (3 shift-xors,
#: 2 multiplies: 8), the second allele's multiply and xor (2), two
#: compares (2), one or (1).
GEN_OPS_PER_GENOTYPE = 14
#: u32 operations each probe op needs per element per iteration: xor an add
#: and a xor; shiftxor a shift, a xor and an add; cmp a compare and an add
#: (0x7FFFFFFF + i is the same for every element); mul and mul_i32 one
#: multiply-add; fmix32 three shift-xors (6), two multiplies and the add.
#: What the compiled kernel issues besides (loop, addresses, loads and
#: stores, the uniform datapath) is the kernel's cost, not the function's;
#: its SASS count is printed beside the bound.
PROBE_OPS_PER_ITERATION = {"xor": 2, "shiftxor": 3, "cmp": 2, "mul": 1, "mul_i32": 1,
                           "fmix32": 9}
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
    """The card's 32-bit integer rate: SMs × max SM clock × 128."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_PER_SM_PER_CLOCK * sms * float(mhz) * 1e6


def bound(bytes_moved: float, ops: float, ops_rate: float):
    """(least time in ms, what bounds it) for the work on this card."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, devicegen):
    """Each kernel against its plain version at the main path's width."""
    from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
    from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms

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


def reset_counts(kernels) -> None:
    for kernel in kernels:
        kernel.launches = 0


def phase_unpack(torch, devicegen, gramian, int32_rate):
    """``unpack_rows_t`` against its plain version in both modes, each
    followed by ``gram_accumulate`` against its plain version, at 2,504
    samples and the rows of ``UNPACK_ROWS``; exactly equal. Times at each
    shape; the JSON row is the packed mode at the CLI's 1,024 rows."""
    from spark_examples_tpu_torch.ops.contracts import COUNT_ROW
    from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    n = N_SAMPLES
    n_pad = -(-n // 128) * 128
    times = {}
    for rows in UNPACK_ROWS:
        for counts in (False, True):
            mode = "counts" if counts else "packed"
            # Has-variation bits at the synthetic cohort's density, or
            # same-set join counts in their declared range.
            values = (rng.random((rows, n)) < 0.3).astype(np.uint8)
            if counts:
                values *= rng.integers(1, COUNT_ROW.hi + 1, (rows, n), dtype=np.uint8)
            host = values if counts else np.packbits(values, axis=-1)
            block = torch.from_numpy(host).to(dev)
            got = gramian.unpack_rows_t(block, n, counts=counts)
            want = gramian.unpack_rows_t_plain(block, n, counts=counts)
            g_k = torch.zeros((n, n), dtype=torch.int32, device=dev)
            g_p = torch.zeros((n, n), dtype=torch.int32, device=dev)
            devicegen.gram_accumulate(g_k, got)
            devicegen.gram_accumulate_plain(g_p, want)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"unpack_rows_t != plain ({mode}, {rows} rows)")
            err = int((g_k.long() - g_p.long()).abs().max())
            if err:
                raise AssertionError(f"G after unpack_rows_t != plain ({mode}, {rows} rows): {err}")
            ms = cuda_ms(lambda: gramian.unpack_rows_t(
                block, n, counts=counts, max_count=COUNT_ROW.hi), 50)
            plain_ms = cuda_ms(lambda: gramian.unpack_rows_t_plain(block, n, counts=counts), 5, 1)
            # Reads the block once, writes the padded int8 Xᵀ once.
            moved = block.numel() + n_pad * (-(-rows // 128) * 128)
            times[(mode, rows)] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=None, bound=bound(moved, 0, int32_rate)
            )
            log(f"kernels: unpack_rows_t == plain ({mode}, N={n}, {rows} rows), then "
                f"gram_accumulate == plain: trace {int(g_k.diagonal().long().sum())}; "
                f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {times[(mode, rows)]['bound'][0]:.4f} "
                f"ms by bytes, {100 * times[(mode, rows)]['bound'][0] / ms:.1f} % of it)")
    row = dict(times[("packed", UNPACK_ROWS[0])], max_abs_err=0)
    return row, times


def sass_instructions_per_element(probe_ops, library) -> dict:
    """op → SASS instructions ``probe_op_chain_kernel<op>`` issues per
    element per iteration, from ``cuobjdump -sass`` of this run's build:
    every instruction but NOP, BRA and EXIT, over the R iterations (one
    thread per element runs the whole function once). A diagnostic printed
    beside the bound, which counts what the function needs instead."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts = {}
    for function in sass.split("Function : ")[1:]:
        found = re.search(r"probe_op_chain_kernelILi(\d+)E", function.split("\n", 1)[0])
        if found is None:
            continue
        opcodes = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", function)
        issued = sum(1 for op in opcodes if op not in ("NOP", "BRA", "EXIT"))
        counts[probe_ops.OPS[int(found.group(1))]] = issued / probe_ops.R
    if sorted(counts) != sorted(probe_ops.OPS):
        raise AssertionError(f"SASS of {library} lacks some probe ops: {sorted(counts)}")
    return counts


def phase_probe_kernels(torch, probe_ops, vmem_capacity, int32_rate, library):
    """The six u32 op chains bit-equal to the plain chain after 21 chained
    calls at (1024, 2560), and the scratch copy at the card's limit exact;
    plain and library times for the JSON rows (the kernels' own times come
    from the probes' entry points, phase 5)."""
    from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms

    dev = torch.device("cuda")
    x = torch.from_numpy(probe_ops.random_tile(0)).to(dev)
    elements = x.numel()
    sass = sass_instructions_per_element(probe_ops, library)
    per_op = {}
    for op in probe_ops.OPS:
        got, want = x, x
        for _ in range(probe_ops.REPS + 1):
            got = probe_ops.probe_op_chain(got, op)
            want = probe_ops.probe_op_chain_plain(want, op)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe_op_chain[{op}] != plain after {probe_ops.REPS + 1} calls")
        plain_ms = cuda_ms(lambda: probe_ops.probe_op_chain_plain(x, op), 3, 1)
        ops = probe_ops.R * PROBE_OPS_PER_ITERATION[op] * elements
        per_op[op] = dict(plain_ms=plain_ms, bytes=8 * elements, ops=ops,
                          bound=bound(8 * elements, ops, int32_rate))
        log(f"kernels: probe_op_chain[{op}] == plain, bit for bit, after "
            f"{probe_ops.REPS + 1} chained calls at {tuple(x.shape)}; bound "
            f"{per_op[op]['bound'][0]:.4f} ms by {per_op[op]['bound'][1]} "
            f"({PROBE_OPS_PER_ITERATION[op]} operations per element per iteration; "
            f"the kernel's SASS issues {sass[op]:.4f})")

    limit = vmem_capacity.max_shared_memory_optin()
    tile = torch.randn(vmem_capacity.TILE, device=dev)
    got = vmem_capacity.scratch_copy(tile, limit)
    want = vmem_capacity.scratch_copy_plain(tile, limit)
    refused = vmem_capacity.scratch_copy(tile, limit + 1)
    torch.cuda.synchronize()
    if got is None or not (torch.equal(got, tile) and torch.equal(want, tile)):
        raise AssertionError(f"scratch_copy at {limit} bytes is not the exact copy")
    if refused is not None:
        raise AssertionError(f"scratch_copy launched with {limit + 1} bytes, past the attribute")
    out = torch.empty_like(tile)
    scratch = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: vmem_capacity.scratch_copy(tile, limit), 50),
        plain_ms=cuda_ms(lambda: vmem_capacity.scratch_copy_plain(tile, limit), 20),
        library_ms=cuda_ms(lambda: out.copy_(tile), 50),
        bound=bound(2 * tile.numel() * 4, 0, int32_rate),
    )
    log(f"kernels: scratch_copy == plain at {limit} bytes; {limit + 1} refused; "
        f"{scratch['ms']:.4f} ms (plain {scratch['plain_ms']:.4f}, library copy_ "
        f"{scratch['library_ms']:.4f}, bound {scratch['bound'][0]:.6f} ms by bytes)")
    return per_op, scratch


def phase_probe_entry_points(torch, probe_ops, vmem_capacity, per_op):
    """The probes' own entry points, launches counted from zero: every op
    of ``probe_ops.run`` (CUDA-event ms), then ``vmem_capacity.find_limit``."""
    reset_counts([probe_ops.probe_op_chain])
    elements = probe_ops.SHAPE[0] * probe_ops.SHAPE[1]
    for op in probe_ops.OPS:
        out, ms = probe_ops.run(op)
        if out.shape != probe_ops.SHAPE or ms is None or not math.isfinite(ms):
            raise AssertionError(f"probe_ops.run({op!r}) gave {tuple(out.shape)}, {ms}")
        per_op[op]["ms"] = ms
        per_elem_op = ms * 1e-3 / (probe_ops.R * elements)
        log(f"probes: {op:10s}: {ms:7.4f} ms  {per_elem_op * 1e12:7.3f} ps/elem/iter "
            f"({1 / per_elem_op / 1e9:6.1f} Gelem-iter/s); plain {per_op[op]['plain_ms']:.4f} ms, "
            f"bound {per_op[op]['bound'][0]:.4f} ms ({100 * per_op[op]['bound'][0] / ms:.1f} %)")
    chain_launches = probe_ops.probe_op_chain.launches
    reset_counts([vmem_capacity.scratch_copy])
    limit, tried = vmem_capacity.find_limit()
    attribute = vmem_capacity.max_shared_memory_optin()
    for nbytes, ok in tried:
        log(f"probes: shared-memory scratch {nbytes} B: {'OK' if ok else 'FAIL'}")
    log(f"probes: limit {limit} B; cudaDevAttrMaxSharedMemoryPerBlockOptin {attribute} B")
    if limit != attribute:
        raise AssertionError(f"bisected limit {limit} != attribute {attribute}")
    launches = {"probe_op_chain": chain_launches, "scratch_copy": vmem_capacity.scratch_copy.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a probe's entry point launched nothing: {launches}")
    return launches


def run_main_path(torch, kernels, argv, label, expect):
    """One ``variants-pca`` run through the port's entry point, every
    launch count set to zero just before; fails unless each kernel named in
    ``expect`` launched. The PCs are checked against a full eigh of the
    run's Gramian. Returns the launch counts."""
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
    reset_counts(kernels)
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
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    driver = result.driver
    acc = driver.accumulator
    stages = {s["path"]: s["seconds"] for s in driver.spans.flat()}
    gauges = {name: driver.registry.value(name) for name in (
        INGEST_SITES_SCANNED, DEVICEGEN_DISPATCHES, DEVICEGEN_SITES_CAPACITY,
        "gramian_flushes_total", "gramian_rows_total")}
    log(f"main path {label}: wall {wall:.4f} s, stages {json.dumps(stages)}, "
        f"launches {json.dumps(launches)}, peak device memory {peak / 2**20:.1f} MiB, "
        f"gauges {json.dumps(gauges)}")
    missing = [k for k in expect if launches[k] <= 0]
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
        from spark_examples_tpu_torch.constants import GoogleGenomicsPublicData
        from spark_examples_tpu_torch.experiments import probe_ops, vmem_capacity
        from spark_examples_tpu_torch.ops import _kernels, devicegen, gramian
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 1

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = _kernels.build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for source in libs:
        for line in _kernels.build_log(source).splitlines():
            if any(key in line for key in ("Compiling entry", "Used", "spill")):
                log(f"build: {source}: {line.strip()}")

    int32_rate = int32_ops_per_s(torch)
    rows = phase_kernels(torch, devicegen)
    rows["unpack_rows_t"], _ = phase_unpack(torch, devicegen, gramian, int32_rate)
    per_op, rows["scratch_copy"] = phase_probe_kernels(
        torch, probe_ops, vmem_capacity, int32_rate, libs["probes.cu"])

    path_kernels = devicegen.KERNELS + gramian.KERNELS
    # The first run in a process also pays the CUDA libraries' lazy set-up
    # (the eigensolve's first cuSOLVER call); the second is the warm time.
    device_path = ("gen_genotypes", "gram_accumulate")
    host_fed = ("unpack_rows_t", "gram_accumulate")
    run_main_path(torch, path_kernels, CHR17_ARGV, "chr17 cold", device_path)
    launches = run_main_path(torch, path_kernels, CHR17_ARGV, "chr17", device_path)
    run_main_path(torch, path_kernels, BRCA1_ARGV, "brca1", device_path)
    packed = run_main_path(torch, path_kernels, PACKED_ARGV, "packed", host_fed)
    run_main_path(torch, path_kernels, WIRE_ARGV, "wire", host_fed)
    set_id = GoogleGenomicsPublicData.THOUSAND_GENOMES_PHASE_1
    same_set_argv = ["--references", SAME_SET_WINDOW, "--num-samples", str(N_SAMPLES),
                     "--variant-set-id", f"{set_id},{set_id}"]
    run_main_path(torch, path_kernels, same_set_argv, "same-set wire", host_fed)
    launches["unpack_rows_t"] = packed["unpack_rows_t"]
    launches.update(phase_probe_entry_points(torch, probe_ops, vmem_capacity, per_op))
    # probe_op_chain's row is the six-op suite, one call of each op: times
    # summed over the ops, the bound from the suite's bytes and operations.
    rows["probe_op_chain"] = {
        "max_abs_err": 0, "library_ms": None,
        "ms": sum(r["ms"] for r in per_op.values()),
        "plain_ms": sum(r["plain_ms"] for r in per_op.values()),
        "bound": bound(sum(r["bytes"] for r in per_op.values()),
                       sum(r["ops"] for r in per_op.values()), int32_rate),
    }

    for name in ("jax", "spark_examples_tpu"):
        if name in sys.modules:
            raise AssertionError(f"{name} was imported")
    kernels = []
    for name, source, replaces in (
        ("gen_genotypes", "spark_examples_tpu_torch/csrc/devicegen.cu",
         "experiments/pallas_fused_gramian.py:151"),
        ("gram_accumulate", "spark_examples_tpu_torch/csrc/devicegen.cu",
         "experiments/pallas_fused_gramian.py:151"),
        ("unpack_rows_t", "spark_examples_tpu_torch/csrc/gramian.cu",
         "spark_examples_tpu/ops/gramian.py:200"),
        ("probe_op_chain", "spark_examples_tpu_torch/csrc/probes.cu",
         "experiments/probe_ops.py:37"),
        ("scratch_copy", "spark_examples_tpu_torch/csrc/probes.cu",
         "experiments/vmem_capacity.py:5"),
    ):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
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
