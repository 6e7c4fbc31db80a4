#!/usr/bin/env python3
"""Drive the PyTorch port (``spark_examples_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. card: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel built from ``spark_examples_tpu_torch/csrc`` with
   nvcc, one process per source, all started together (``-Xptxas -v``
   report printed), and the native VCF parser (``native/vcfparse.cpp``)
   with g++; the build's SASS (``cuobjdump``) must show TMA stores
   in the generation kernel, int8 warpgroup MMAs and TMA loads in the
   product's kernel and bulk copies in the scratch copy's;
3. kernels: each kernel against its plain PyTorch version at the shapes its
   path gives it, exactly equal: the generation at 2,504 samples × 16,384
   sites (a full block and chr17's ragged tail) and × 1,024 (the CLI's
   block, and a two-set cohort of 2,504 + 45 columns), with both
   counters; the product at both depths, on
   count-valued rows and at 130 and 13 samples; the unpack of host-fed
   blocks, bit-packed and count-valued, at 2,504 samples × 1,024 and
   16,384 rows, each followed by the product; the six u32 op chains at
   (1024, 2560) after 21 chained calls; the shared-memory scratch copy at
   the card's limit. Then CUDA-event times of each kernel, its plain
   version and, where one exists, the PyTorch library call computing the
   same function (the generation and the product at both depths, with
   their launches' blocks and waves);
4. main path: ``variants-pca`` through ``run_pipeline`` — device generation
   over chr17 at 2,504 samples (a cold run, then a warm one, both with
   blocks of 16,384 sites, then one at the CLI's default 1,024) and over
   the default BRCA1 region; then the host-fed arms at 2,504 samples: packed
   over 2 Mb of chr17, wire over 10 kb, and the same-set join (a duplicated
   variant-set id: count-valued rows) over 5 kb. For each: launch counts,
   wall-clock, stage spans, peak device memory, and the PCs checked
   against a full ``eigh`` of the same run's centered Gramian;
5. files: the packed window's synthetic cohort written as a VCF (GT from
   ``has_variation``, AF in INFO; about 180 MB) and a gzip copy, the wire
   window's as a small VCF, under ``chip_smoke_data/``; then the file
   source's arms at 2,504 samples — packed (the native parser over the
   whole file), streamed (one bounded pass over the ``.gz``), wire, and
   ``--save-variants`` followed by ``--input-path`` — each checked as
   above, with its Gramian exactly equal to the synthetic run's over the
   same records, the native parser's gauge set (packed and streamed), and
   the resumed run's rows equal to the saving run's;
6. telemetry: chr17 and the file packed arm once more with
   ``--profile-dir`` and ``--metrics-json``: the manifest must pass the
   port's validator, and the card's busy share of the ``ingest+similarity``
   range is read from the trace's CUDA kernel events (traced wall-clock is
   reported apart from the untraced runs');
7. probes: the entry points of the two probes, ``probe_ops.run`` for every
   op and ``vmem_capacity.find_limit``, whose bisected limit must equal
   the driver's ``cudaDevAttrMaxSharedMemoryPerBlockOptin``;
8. the ``kernels`` JSON line, the card line, and last the result line.

Imports nothing of JAX or of the JAX package. Exits non-zero without a
result when no CUDA card is present or the port is not beside this file.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: chr17 at the CLI's synthetic grid (one site every 100 bases: 811,953
#: sites), the 1000 Genomes cohort width.
CHR17_ARGV = ["--references", "17:0:81195210", "--num-samples", "2504",
              "--ingest", "device", "--block-size", "16384"]
#: The same at the CLI's default --block-size (1,024): 793 launches of each
#: device-path kernel, the launch pattern of a run with default flags.
CHR17_CLI_ARGV = CHR17_ARGV[:-2]
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
#: Where the file phase writes its VCF inputs (git-ignored).
DATA_DIR = Path(__file__).resolve().parent / "chip_smoke_data"
#: The streamed arm's decompressed chunk: several chunks for the parse pool.
STREAM_CHUNK = 8 << 20
N_SAMPLES = 2504
BLOCK = 16384
#: The CLI's default --block-size, and the packed arm's flush.
CLI_BLOCK = 1024
#: Rows of the unpack phase: the CLI's default block and the device path's.
UNPACK_ROWS = (CLI_BLOCK, BLOCK)
#: SASS opcodes each redesigned kernel must contain, in this run's build:
#: 16-byte stores (the generation's staged Xᵀ chunks and the unpack's
#: rows); int8 warpgroup MMAs and TMA tensor loads; bulk copies. IMMA is
#: mma.sync.
HOPPER_SASS = {
    "gen_genotypes_kernel": ("devicegen.cu", ("STG.E.128",), ()),
    "unpack_rows_t_kernel": ("gramian.cu", ("STG.E.128",), ()),
    "gram_accumulate_kernel": ("devicegen.cu", ("IGMMA", "UTMALDG"), ("IMMA",)),
    "scratch_copy_kernel": ("probes.cu", ("UBLKCP",), ()),
}
#: Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
#: The most 32-bit instructions an SM can issue per clock: four
#: schedulers, one warp instruction (32 lanes) each. Logic and shifts run
#: on a 64-lane pipe, but adds and multiplies also issue as IMAD on the FMA
#: pipe beside it, so 64 is no bound (the u32 op-chain probe ran faster).
#: The rate is this times the SMs and the max clock.
INT32_OPS_PER_SM_PER_CLOCK = 128
#: u32 operations per drawn genotype: fold xor (1), fmix32 without its
#: first shift-xor (2 shift-xors, 2 multiplies: 6), the second allele's
#: multiply and xor (2), two compares (2), one or (1). fmix32's first
#: shift-xor distributes over the fold's xor, so it is done once per site
#: and once per column, not per genotype.
GEN_OPS_PER_GENOTYPE = 12
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
    # A full block in chr17's grid, its ragged tail, the CLI's 1,024-site
    # block, and the same block for a two-set cohort (2,504 + 45 columns:
    # the first set spans every 64-column chunk, so every block of a
    # cluster adds to its variant rows).
    two_sets = devicegen.make_gen_plan(
        [source.genotype_stream_key("chip-smoke"), source.genotype_stream_key("chip-smoke-b")],
        [source.populations, source.populations[:45]],
        source.site_key, source.variant_spacing, source.ref_block_fraction,
        None, source.n_pops, dev,
    )
    blocks = {}
    for label, gplan, offset, n_valid, sites in (
        ("full block", plan, 400_000, BLOCK, BLOCK),
        ("ragged tail", plan, 811_000, 5_000, BLOCK),
        ("CLI block", plan, 400_000, CLI_BLOCK, CLI_BLOCK),
        ("two sets, 2504 + 45 columns", two_sets, 400_000, CLI_BLOCK, CLI_BLOCK),
    ):
        kept_k, kept_p = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2))
        rows_k, rows_p = (torch.zeros((gplan.n_sets,), dtype=torch.int64, device=dev)
                          for _ in range(2))
        got = devicegen.gen_genotypes(gplan, offset, n_valid, sites, kept_k, rows_k)
        want = devicegen.gen_genotypes_plain(gplan, offset, n_valid, sites, kept_p, rows_p)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if err or not (torch.equal(kept_k, kept_p) and torch.equal(rows_k, rows_p)):
            raise AssertionError(
                f"gen_genotypes != plain ({label}): max err {err}, "
                f"kept {int(kept_k)} vs {int(kept_p)}, rows {rows_k.tolist()} vs {rows_p.tolist()}"
            )
        log(f"kernels: gen_genotypes == plain ({label}: offset {offset}, {n_valid} of {sites} "
            f"sites, {gplan.n_cols} columns): kept {int(kept_k)}, variant rows {rows_k.tolist()}")
        blocks[label] = (got, int(kept_k))
    rows["gen_genotypes"] = {"max_abs_err": 0}
    xt, kept_sites = blocks["full block"]
    xt_cli, kept_cli = blocks["CLI block"]

    n = plan.n_cols
    kept, vrows = zeros()
    rng = np.random.default_rng(5)
    rows["gram_accumulate"] = {"max_abs_err": check_gram(torch, devicegen, rng, xt, xt_cli)}

    # Times at the main path's shapes. Bounds of what the functions need:
    # generation writes N × B int8 and draws the genotypes of the kept
    # sites only (a dropped site's threshold is 0, so its genotypes are 0
    # without a draw); the product is symmetric, N·(N+1)/2 distinct entries
    # of 2·B operations, reading Xᵀ once and G (int32) once each way.
    int32_rate = int32_ops_per_s(torch)
    log(f"kernels: int32 rate {int32_rate:.4e} ops/s, int8 {PEAK_INT8_OPS_PER_S:.4e} ops/s, "
        f"{PEAK_BYTES_PER_S:.4e} B/s; timed blocks: {kept_sites} kept of {BLOCK} sites, "
        f"{kept_cli} of {CLI_BLOCK}")
    gen = {}
    for sites, kept_n in ((BLOCK, kept_sites), (CLI_BLOCK, kept_cli)):
        launch, resident, sms, cluster = devicegen.gen_genotypes_grid(plan, sites, dev)
        r = gen[sites] = dict(
            ms=cuda_ms(lambda: devicegen.gen_genotypes(plan, 400_000, sites, sites, kept, vrows), 50),
            plain_ms=cuda_ms(lambda: devicegen.gen_genotypes_plain(plan, 400_000, sites, sites, kept, vrows), 5, 1),
            library_ms=None,
            bound=bound(n * sites, n * kept_n * GEN_OPS_PER_GENOTYPE, int32_rate),
        )
        log(f"kernels: gen_genotypes at {sites} sites: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} "
            f"% of it); launch: {launch} blocks in clusters of {cluster}, {resident} resident "
            f"({resident / sms:.2f} an SM), {launch / resident:.2f} waves")
    rows["gen_genotypes"].update(gen[BLOCK])
    g_k = torch.zeros((n, n), dtype=torch.int32, device=dev)
    depths = {}
    for sites, block in ((BLOCK, xt), (CLI_BLOCK, xt_cli)):
        xt_n = block[:n] if n % 8 == 0 else block  # _int_mm wants widths that are multiples of 8
        blocks, resident = devicegen.gram_accumulate_grid(block.shape[0], dev)
        depths[sites] = dict(
            ms=cuda_ms(lambda: devicegen.gram_accumulate(g_k, block), 20),
            plain_ms=cuda_ms(lambda: devicegen.gram_accumulate_plain(g_k, block), 5, 1),
            library_ms=cuda_ms(lambda: torch._int_mm(xt_n, xt_n.t()), 20),
            bound=bound(n * sites + 2 * 4 * n * n, float(n) * (n + 1) * sites, PEAK_INT8_OPS_PER_S),
        )
        r = depths[sites]
        log(f"kernels: gram_accumulate at {sites} sites: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms, torch._int_mm {r['library_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} % of "
            f"it); launch: {blocks} blocks over every site, {resident} resident, "
            f"{blocks / resident:.2f} waves")
    rows["gram_accumulate"].update(depths[BLOCK])
    for name, r in rows.items():
        log(f"kernels: {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']}, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, "
            f"{100 * r['bound'][0] / r['ms']:.1f} % of it)")
    return rows


def check_gram(torch, devicegen, rng, xt, xt_cli) -> int:
    """``gram_accumulate`` exactly equal to its plain version: the
    generated 16,384-site block twice onto a nonzero G, the CLI's 1,024-site
    block, ragged one-tile cohorts (130 and 13 samples) and count-valued
    rows up to the same-set join's maximum. Returns the largest error (0)."""
    from spark_examples_tpu_torch.ops.contracts import COUNT_ROW

    dev = xt.device
    n = N_SAMPLES
    counts = rng.integers(0, COUNT_ROW.hi + 1, (xt_cli.shape[0], CLI_BLOCK), dtype=np.int8)
    cases = [
        (f"N={n}, {BLOCK} sites, twice onto a nonzero G", n, xt, 2),
        (f"N={n}, {CLI_BLOCK} sites", n, xt_cli, 1),
        (f"N={n}, {CLI_BLOCK} sites of counts up to {COUNT_ROW.hi}", n,
         torch.from_numpy(counts).to(dev), 1),
    ]
    for small in (130, 13):
        rows = -(-small // 128) * 128
        bits = rng.integers(0, 2, (rows, 128), dtype=np.int8)
        cases.append((f"N={small}, 128 sites", small, torch.from_numpy(bits).to(dev), 1))
    for label, size, block, times in cases:
        start = torch.from_numpy(rng.integers(-1000, 1000, (size, size), dtype=np.int32)).to(dev)
        g_k, g_p = start.clone(), start.clone()
        for _ in range(times):
            devicegen.gram_accumulate(g_k, block)
            devicegen.gram_accumulate_plain(g_p, block)
        torch.cuda.synchronize()
        err = int((g_k.long() - g_p.long()).abs().max())
        if err:
            raise AssertionError(f"gram_accumulate != plain at {label}: max err {err}")
        log(f"kernels: gram_accumulate == plain at {label}: trace "
            f"{int((g_k - start).diagonal().long().sum())}")
    return 0


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


def sass_opcodes(library) -> dict:
    """Mangled function name → the opcodes of its SASS with their
    modifiers (``STG.E.128``), in order, from ``cuobjdump -sass`` of this
    run's build."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    functions = {}
    for function in sass.split("Function : ")[1:]:
        name, body = function.split("\n", 1)
        functions[name.strip()] = re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body)
    return functions


def sass_instructions_per_element(probe_ops, library) -> dict:
    """op → SASS instructions ``probe_op_chain_kernel<op>`` issues per
    element per iteration, from ``cuobjdump -sass`` of this run's build:
    every instruction but NOP, BRA and EXIT, over the R iterations (one
    thread per element runs the whole function once). A diagnostic printed
    beside the bound, which counts what the function needs instead."""
    counts = {}
    for name, opcodes in sass_opcodes(library).items():
        found = re.search(r"probe_op_chain_kernelILi(\d+)E", name)
        if found is None:
            continue
        issued = sum(1 for op in opcodes if op.split(".")[0] not in ("NOP", "BRA", "EXIT"))
        counts[probe_ops.OPS[int(found.group(1))]] = issued / probe_ops.R
    if sorted(counts) != sorted(probe_ops.OPS):
        raise AssertionError(f"SASS of {library} lacks some probe ops: {sorted(counts)}")
    return counts


def check_hopper_sass(libs) -> None:
    """Each kernel of ``HOPPER_SASS`` (every function of that name) holds
    the opcodes it must and none it must not (an opcode names itself with
    any modifiers: ``IMMA`` is ``IMMA.16832.S8.S8`` too), in this run's
    build; prints the tensor-core, TMA, bulk-copy and 16-byte store
    opcodes found in each."""
    def has(opcodes, op):
        return any(o == op or o.startswith(op + ".") for o in opcodes)

    for kernel, (source, wanted, banned) in HOPPER_SASS.items():
        functions = {name: ops for name, ops in sass_opcodes(libs[source]).items()
                     if kernel in name}
        if not functions:
            raise AssertionError(f"SASS of {source} has no function named {kernel}")
        for name, opcodes in functions.items():
            found = sorted({op.split(".")[0] if "MMA" in op else op for op in opcodes
                            if re.search(r"MMA|UTMA|UBLK|STG.*\.128", op)})
            log(f"sass: {name}: {', '.join(found) or 'no MMA, TMA, bulk-copy or 16-byte store opcode'}")
            missing = [op for op in wanted if not has(opcodes, op)]
            present = [op for op in banned if has(opcodes, op)]
            if missing or present:
                raise AssertionError(f"{name}'s SASS lacks {missing} or has {present}")


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
    run's Gramian. Returns the launch counts and the run's result."""
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
    return launches, result


def write_cohort_vcf(window: str, path: Path, gz_path=None) -> int:
    """The CLI's synthetic cohort (2,504 samples, seed 42, the default
    variant set) over ``window`` as a VCF: one line per variant row of the
    synthetic packed arm's blocks, partition by partition (``GT`` 0|1 where
    the sample varies, else 0|0; ``AF`` in INFO), the samples in the
    synthetic callset order so the two Gramians index alike. With
    ``gz_path`` also a gzip copy. Returns the rows written."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.pipeline.pca_driver import make_source
    from spark_examples_tpu_torch.sharding.contig import parse_contigs
    from spark_examples_tpu_torch.sharding.partitioners import VariantsPartitioner

    conf = PcaConf.parse(["--references", window, "--num-samples", str(N_SAMPLES)])
    source = make_source(conf)
    set_id = conf.variant_set_id[0]
    names = [cs["name"] for cs in source.search_callsets([set_id])]
    partitions = VariantsPartitioner(parse_contigs(window), conf.bases_per_partition)
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = 0
    with open(path, "wb") as f:
        f.write(b"##fileformat=VCFv4.2\n")
        f.write(("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(names) + "\n").encode())
        for part in partitions.get_partitions(set_id):
            for block in source.genotype_blocks(set_id, part.contig, block_size=CLI_BLOCK):
                hv = block["has_variation"]
                text = np.empty((hv.shape[0], hv.shape[1], 4), dtype=np.uint8)
                text[:] = np.frombuffer(b"0|0\t", dtype=np.uint8)
                text[:, :, 2] += hv
                text[:, -1, 3] = ord("\n")
                for pos, af, line in zip(block["positions"], block["af"], text):
                    f.write(f"17\t{int(pos) + 1}\t.\tA\tG\t.\t.\tAF={af:.6f}\tGT\t".encode())
                    f.write(line.tobytes())
                rows += hv.shape[0]
    if gz_path is not None:
        with open(path, "rb") as src, gzip.open(gz_path, "wb", compresslevel=1) as dst:
            shutil.copyfileobj(src, dst, 16 << 20)
    return rows


def phase_files(torch, kernels, expect, packed_g, wire_g):
    """The file source's arms over VCFs of the synthetic cohort: packed
    (the native parser over the whole plain file), streamed (one bounded
    pass over the gzip copy), wire over the wire window, and
    ``--save-variants`` then ``--input-path``. Each run's Gramian must equal
    the synthetic run's over the same records exactly (``packed_g``: the
    packed window, ``wire_g``: the wire window)."""
    from spark_examples_tpu_torch.obs.metrics import VCF_NATIVE_PARSE

    big, big_gz, small = (DATA_DIR / "packed_window.vcf", DATA_DIR / "packed_window.vcf.gz",
                          DATA_DIR / "wire_window.vcf")
    t0 = time.perf_counter()
    rows = write_cohort_vcf(PACKED_ARGV[1], big, big_gz)
    wire_rows = write_cohort_vcf(WIRE_ARGV[1], small)
    log(f"files: wrote {rows} rows to {big.name} ({big.stat().st_size} bytes; gzip "
        f"{big_gz.stat().st_size} bytes) and {wire_rows} to {small.name} "
        f"({small.stat().st_size} bytes) in {time.perf_counter() - t0:.1f} s")
    save_dir = DATA_DIR / "saved_variants"
    shutil.rmtree(save_dir, ignore_errors=True)
    packed_window, wire_window = PACKED_ARGV[1], WIRE_ARGV[1]
    runs = (
        ("file packed", [str(big)], packed_window,
         ["--ingest", "packed", "--stream-chunk-bytes", "0"], packed_g, True),
        ("file streamed", [str(big_gz)], packed_window,
         ["--ingest", "packed", "--stream-chunk-bytes", str(STREAM_CHUNK)], packed_g, True),
        ("file wire", [str(small)], wire_window, ["--ingest", "wire"], wire_g, False),
        ("file save", [str(small)], wire_window, ["--save-variants", str(save_dir)], wire_g,
         False),
        ("file resume", [str(small)], wire_window, ["--input-path", str(save_dir)], wire_g,
         False),
    )
    results = {}
    for label, files, window, extra, want_g, native in runs:
        argv = ["--source", "file", "--input-files", ",".join(files),
                "--references", window] + extra
        _, result = run_main_path(torch, kernels, argv, label, expect)
        got_g = result.driver.accumulator.G
        if not torch.equal(got_g, want_g):
            err = int((got_g.long() - want_g.long()).abs().max())
            raise AssertionError(f"{label}: Gramian differs from the synthetic run's by {err}")
        parser = result.driver.registry.value(VCF_NATIVE_PARSE)
        if native and parser != 1.0:
            raise AssertionError(f"{label}: the native VCF parser did not run ({parser})")
        log(f"files: {label}: Gramian == the synthetic run's over the same records "
            f"(trace {int(got_g.diagonal().long().sum())}); native parser gauge {parser}")
        results[label] = result
    if results["file resume"].lines != results["file save"].lines:
        raise AssertionError("the resumed run's rows differ from the saving run's")
    log(f"files: the resumed run printed the saving run's {len(results['file save'].lines)} "
        "rows exactly")


def busy_share(trace_path: str, span: str = "ingest+similarity"):
    """(kernel-busy share, kernel + copy busy share, window ms, kernel
    count) of the ``span`` range in a ``torch.profiler`` Chrome trace: the
    union of the CUDA kernel (and memcpy/memset) intervals inside the range
    over its length. ``None`` when the trace has no such range or no
    kernel event."""
    events = json.load(open(trace_path))["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X" and e.get("name") == span
              and e.get("cat") == "user_annotation"]
    if not ranges:
        return None
    lo = ranges[0]["ts"]
    hi = lo + ranges[0]["dur"]

    def union(cats):
        spans = sorted((max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])) for e in events
                       if e.get("ph") == "X" and e.get("cat") in cats
                       and e["ts"] < hi and e["ts"] + e["dur"] > lo)
        total, end = 0.0, lo
        for a, b in spans:
            if b > end:
                total += b - max(a, end)
                end = b
        return total, len(spans)

    kernels, count = union(("kernel",))
    if count == 0:
        return None
    with_copies, _ = union(("kernel", "gpu_memcpy", "gpu_memset"))
    return kernels / (hi - lo), with_copies / (hi - lo), (hi - lo) / 1e3, count


def phase_telemetry(torch, kernels):
    """chr17 (16,384-site blocks) and the file packed arm once more, traced
    (``--profile-dir``) with a manifest (``--metrics-json``): the manifest
    must pass the port's validator; the card's busy share of the
    ``ingest+similarity`` range comes from the trace's kernel events."""
    from spark_examples_tpu_torch.obs.manifest import read_manifest, validate_manifest

    shares = {}
    for label, argv, expect in (
        ("chr17 traced", CHR17_ARGV, ("gen_genotypes", "gram_accumulate")),
        ("file packed traced", ["--source", "file", "--input-files",
                                str(DATA_DIR / "packed_window.vcf"), "--references",
                                PACKED_ARGV[1], "--ingest", "packed",
                                "--stream-chunk-bytes", "0"],
         ("unpack_rows_t", "gram_accumulate")),
    ):
        tag = label.split()[0] + ("_file" if "file" in label else "")
        profile, metrics_json = DATA_DIR / f"trace_{tag}", DATA_DIR / f"manifest_{tag}.json"
        shutil.rmtree(profile, ignore_errors=True)
        run_main_path(torch, kernels, argv + ["--profile-dir", str(profile),
                                              "--metrics-json", str(metrics_json)], label, expect)
        problems = validate_manifest(read_manifest(str(metrics_json)))
        if problems:
            raise AssertionError(f"{label}: the manifest is invalid: {problems}")
        traces = glob.glob(str(profile / "torch_trace_*.json"))
        if len(traces) != 1:
            raise AssertionError(f"{label}: expected one trace in {profile}, found {traces}")
        share = busy_share(traces[0])
        if share is None:
            log(f"telemetry {label}: manifest valid; busy share not measured (the trace "
                f"holds no CUDA kernel event in the ingest+similarity range)")
        else:
            log(f"telemetry {label}: manifest valid; trace {os.path.getsize(traces[0])} bytes; "
                f"card busy {100 * share[0]:.2f} % of ingest+similarity ({share[1] * 100:.2f} % "
                f"with copies) over {share[2]:.3f} ms, {share[3]} kernel events")
        shares[label] = share
    return shares


def main() -> int:
    started = time.perf_counter()
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
        from spark_examples_tpu_torch.utils import native
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 1

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = _kernels.build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parser = native.vcf_library()
    if parser is None:
        raise AssertionError(f"the native VCF parser did not build: "
                             f"{native.native_unavailable_reason()}")
    log(f"build: native VCF parser {parser._name} in {time.perf_counter() - t0:.1f} s")
    for source in libs:
        for line in _kernels.build_log(source).splitlines():
            if any(key in line for key in ("Compiling entry", "Used", "spill", "arning")):
                log(f"build: {source}: {line.strip()}")
    check_hopper_sass(libs)

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
    launches, _ = run_main_path(torch, path_kernels, CHR17_ARGV, "chr17", device_path)
    run_main_path(torch, path_kernels, CHR17_CLI_ARGV, "chr17 default block", device_path)
    run_main_path(torch, path_kernels, BRCA1_ARGV, "brca1", device_path)
    packed, packed_run = run_main_path(torch, path_kernels, PACKED_ARGV, "packed", host_fed)
    _, wire_run = run_main_path(torch, path_kernels, WIRE_ARGV, "wire", host_fed)
    set_id = GoogleGenomicsPublicData.THOUSAND_GENOMES_PHASE_1
    same_set_argv = ["--references", SAME_SET_WINDOW, "--num-samples", str(N_SAMPLES),
                     "--variant-set-id", f"{set_id},{set_id}"]
    run_main_path(torch, path_kernels, same_set_argv, "same-set wire", host_fed)
    launches["unpack_rows_t"] = packed["unpack_rows_t"]
    phase_files(torch, path_kernels, host_fed, packed_run.driver.accumulator.G,
                wire_run.driver.accumulator.G)
    phase_telemetry(torch, path_kernels)
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
    log(f"chip_smoke: every phase passed in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
