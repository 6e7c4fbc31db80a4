#!/usr/bin/env python3
"""Drive the PyTorch port (``spark_examples_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. card: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel built from ``spark_examples_tpu_torch/csrc`` with
   nvcc, one process per source, all started together (``-Xptxas -v``
   report printed), and the native VCF parser (``native/vcfparse.cpp``)
   with g++; the build's SASS (``cuobjdump``) must show 16-byte stores
   in the generation and unpack kernels, int8 warpgroup MMAs and TMA loads
   in the product's kernel, bulk copies in the scratch copy's and 16-byte
   loads and stores in the op chains'; then chr17 through the CLI in a
   process of its own (started here, while this one is small), whose
   manifest's ``hostmem`` pair must hold: that process's peak RSS within
   the configuration's host-memory bound over the runtime baseline its
   driver measured at set-up;
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
   their launches' blocks and waves); the op chains also at ragged
   lengths and off a 16-byte boundary, with their SASS split by pipe;
4. main path: ``variants-pca`` through ``run_pipeline`` — device generation
   over chr17 at 2,504 samples (a cold run, then a warm one, both with
   blocks of 16,384 sites, then one at the CLI's default 1,024) and over
   the default BRCA1 region; nine variant sets of 280 samples through the
   CLI, their Gramian exactly the wire arm's on the same argv (and the
   clusters of 682- and 800-set plans, which the card must place); then the
   host-fed arms at 2,504 samples: packed over 2 Mb of chr17, wire over
   10 kb, and the same-set join (a duplicated variant-set id: count-valued
   rows) over 5 kb. For each: launch counts, wall-clock, stage spans, peak
   device memory (its own: earlier runs' results are dropped first), and
   the PCs checked against a full ``eigh`` of the same run's centered
   Gramian;
5. files: the packed window's synthetic cohort written as a VCF (GT from
   ``has_variation``, AF in INFO; about 180 MB) and a gzip copy, the wire
   window's as a small VCF, under ``chip_smoke_data/``; then the file
   source's arms at 2,504 samples — packed (the native parser over the
   whole file), streamed (one bounded pass over the ``.gz``), wire, and
   ``--save-variants`` followed by ``--input-path`` — each checked as
   above, with its Gramian exactly equal to the synthetic run's over the
   same records, the native parser's gauge set (packed and streamed), and
   the resumed run's rows equal to the saving run's;
6. grm: the ``grm`` verb through the CLI's entry point over the packed
   window, synthetic and from its VCF, each kinship TSV byte-identical to
   the int64 oracle on the same rows, each manifest with its ``analysis``
   block;
7. checkpoints: the packed window with a snapshot every 4,096 sites, plain
   and checkpointed (the seconds per save), then CLI processes killed by
   SIGKILL at ``driver.post-flush#2`` and ``checkpoint.mid-write#2``, each
   resumed with ``--resume-from`` to the uninterrupted run's Gramian
   exactly;
8. REST: ``--source rest`` over the wire window through an in-process
   transport serving the synthetic cohort, one injected IO fault retried,
   its Gramian exactly the wire run's;
9. telemetry: chr17 and the file packed arm once more with
   ``--profile-dir`` and ``--metrics-json``: the manifest must pass the
   port's validator and carry the configuration's host-memory bound with
   its ``hostmem`` conformance pair, which must hold, and the card's busy
   share of the
   ``ingest+similarity``
   range is read from the trace's CUDA kernel events (traced wall-clock is
   reported apart from the untraced runs');
10. probes: the entry points of the two probes, ``probe_ops.run`` for every
   op and ``vmem_capacity.find_limit``, whose bisected limit must equal
   the driver's ``cudaDevAttrMaxSharedMemoryPerBlockOptin``;
11. the ``kernels`` JSON line, the card line, and last the result line.

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
#: Device generation over more sets than a byte of set flags holds, through
#: the CLI: nine variant sets of 280 samples (2,520 columns, the 1000
#: Genomes width) over the wire arm's 10 kb. Its oracle is the same argv
#: through the host-fed wire arm (the nine sets' records joined on the
#: host), short because wire records are built in Python.
MANY_SETS = 9
MANY_SETS_ARGV = ["--references", "17:41196311:41206311", "--num-samples", "280",
                  "--variant-set-id", ",".join(f"chip-smoke-{i}" for i in range(MANY_SETS))]
#: Gramian checkpoints on the packed cell: a snapshot every 4,096 sites
#: (five saves over its 17,983 rows); the kill-and-resume runs die at these
#: points of the second save.
CHECKPOINT_EVERY = 4096
KILL_AT = ("driver.post-flush#2", "checkpoint.mid-write#2")
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
#: rows); int8 warpgroup MMAs and TMA tensor loads; bulk copies; 16-byte
#: loads and stores (the op chains' vectors). IMMA is mma.sync.
HOPPER_SASS = {
    "gen_genotypes_kernel": ("devicegen.cu", ("STG.E.128",), ()),
    "unpack_rows_t_kernel": ("gramian.cu", ("STG.E.128",), ()),
    "gram_accumulate_kernel": ("devicegen.cu", ("IGMMA", "UTMALDG"), ("IMMA",)),
    "scratch_copy_kernel": ("probes.cu", ("UBLKCP",), ()),
    "probe_op_chain_kernel": ("probes.cu", ("LDG.E.128", "STG.E.128"), ()),
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
        launch, resident, sms, cluster, tables = devicegen.gen_genotypes_grid(plan, sites, dev)
        r = gen[sites] = dict(
            ms=cuda_ms(lambda: devicegen.gen_genotypes(plan, 400_000, sites, sites, kept, vrows), 50),
            plain_ms=cuda_ms(lambda: devicegen.gen_genotypes_plain(plan, 400_000, sites, sites, kept, vrows), 5, 1),
            library_ms=None,
            bound=bound(n * sites, n * kept_n * GEN_OPS_PER_GENOTYPE, int32_rate),
        )
        log(f"kernels: gen_genotypes at {sites} sites: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} "
            f"% of it); launch: {launch} blocks in clusters of {cluster}, {resident} resident "
            f"({resident / sms:.2f} an SM), {launch / resident:.2f} waves, {tables} tables")
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


#: Chains of R steps compiled into each ``probe_op_chain_kernel``: the four
#: of the vector loop and one scalar chain the ragged head and tail share.
PROBE_CHAINS = 5


def check_hopper_sass(libs) -> None:
    """Each kernel of ``HOPPER_SASS`` (every function of that name) holds
    the opcodes it must and none it must not (an opcode names itself with
    any modifiers: ``IMMA`` is ``IMMA.16832.S8.S8`` too), in this run's
    build; prints the tensor-core, TMA, bulk-copy and 16-byte store
    opcodes found in each."""
    from spark_examples_tpu_torch.utils.sass import sass_opcodes

    def has(opcodes, op):
        return any(o == op or o.startswith(op + ".") for o in opcodes)

    for kernel, (source, wanted, banned) in HOPPER_SASS.items():
        functions = {name: ops for name, ops in sass_opcodes(libs[source]).items()
                     if kernel in name}
        if not functions:
            raise AssertionError(f"SASS of {source} has no function named {kernel}")
        for name, opcodes in functions.items():
            found = sorted({op.split(".")[0] if "MMA" in op else op for op in opcodes
                            if re.search(r"MMA|UTMA|UBLK|(LDG|STG).*\.128", op)})
            log(f"sass: {name}: {', '.join(found) or 'no MMA, TMA, bulk-copy or 16-byte store opcode'}")
            missing = [op for op in wanted if not has(opcodes, op)]
            present = [op for op in banned if has(opcodes, op)]
            if missing or present:
                raise AssertionError(f"{name}'s SASS lacks {missing} or has {present}")


def phase_probe_kernels(torch, probe_ops, vmem_capacity, int32_rate, library):
    """The six u32 op chains bit-equal to the plain chain after 21 chained
    calls at (1024, 2560), and after two at ragged lengths (1, 3, 4,097)
    and on views off a 16-byte boundary; the scratch copy at the card's
    limit exact; plain and library times for the JSON rows (the kernels'
    own times come from the probes' entry points, phase 7). Prints each
    op's SASS instructions per element per iteration, split by pipe."""
    from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms
    from spark_examples_tpu_torch.utils.sass import pipe_split

    dev = torch.device("cuda")
    x = torch.from_numpy(probe_ops.random_tile(0)).to(dev)
    base = torch.from_numpy(probe_ops.random_tile(3, (1, 4100))).to(dev).view(-1)
    ragged = {"1": base[:1], "3": base[:3], "4097": base[:4097], "x[1:]": base[1:],
              "x[3:4002]": base[3:4002]}
    elements = x.numel()
    sass = pipe_split(library, "probe_op_chain_kernel", probe_ops.OPS,
                      PROBE_CHAINS * probe_ops.R)
    per_op = {}
    for op in probe_ops.OPS:
        got, want = x, x
        for _ in range(probe_ops.REPS + 1):
            got = probe_ops.probe_op_chain(got, op)
            want = probe_ops.probe_op_chain_plain(want, op)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe_op_chain[{op}] != plain after {probe_ops.REPS + 1} calls")
        for label, view in ragged.items():
            got = probe_ops.probe_op_chain(probe_ops.probe_op_chain(view, op), op)
            want = probe_ops.probe_op_chain_plain(probe_ops.probe_op_chain_plain(view, op), op)
            if not torch.equal(got, want):
                raise AssertionError(f"probe_op_chain[{op}] != plain at {label}")
        plain_ms = cuda_ms(lambda: probe_ops.probe_op_chain_plain(x, op), 3, 1)
        ops = probe_ops.R * PROBE_OPS_PER_ITERATION[op] * elements
        per_op[op] = dict(plain_ms=plain_ms, bytes=8 * elements, ops=ops,
                          bound=bound(8 * elements, ops, int32_rate))
        split = sass[op]
        log(f"kernels: probe_op_chain[{op}] == plain, bit for bit, after "
            f"{probe_ops.REPS + 1} chained calls at {tuple(x.shape)} and two at "
            f"{', '.join(ragged)}; bound {per_op[op]['bound'][0]:.4f} ms by "
            f"{per_op[op]['bound'][1]} ({PROBE_OPS_PER_ITERATION[op]} operations per element per "
            f"iteration; the kernel's SASS issues {split['alu']:.4f} on the ALU pipe, "
            f"{split['fma']:.4f} on the FMA pipe, {split['other']:.4f} other)")

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


def run_main_path(torch, kernels, argv, label, expect, source=None):
    """One ``variants-pca`` run through the port's entry point, every
    launch count set to zero just before; fails unless each kernel named in
    ``expect`` launched. The PCs are checked against a full eigh of the
    run's Gramian. ``source`` replaces the one the flags name. Returns the
    launch counts and the run's result."""
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
    held = torch.cuda.memory_allocated()
    reset_counts(kernels)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        result = run_pipeline(conf, source=source)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    result.wall = wall
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
        f"launches {json.dumps(launches)}, peak device memory {peak / 2**20:.1f} MiB "
        f"({held / 2**20:.1f} MiB held before the run), gauges {json.dumps(gauges)}")
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


def phase_many_sets(torch, devicegen, kernels):
    """Device generation over MANY_SETS variant sets through the CLI (the
    kernel's bit rows of set flags, past the 8 sets a byte holds),
    against the same argv through the host-fed wire arm: the Gramian
    exactly equal; the set count, the launches and the per-set variant
    rows printed. Then the launch shape of two plans whose tables leave an
    SM one block (682 and 800 sets, which the gpu tests hold exact): the
    card must hold a cluster of it."""
    from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

    launches, result = run_main_path(torch, kernels, MANY_SETS_ARGV + ["--ingest", "device"],
                                     f"{MANY_SETS} sets", ("gen_genotypes", "gram_accumulate"))
    acc = result.driver.accumulator
    got_g = acc.G.cpu()
    rows, kept = acc.ingest_counters()
    grid = devicegen.gen_genotypes_grid(acc.plan, acc.block_size, acc.G.device)
    block = acc.block_size
    acc_device = acc.G.device
    del result, acc
    _, oracle = run_main_path(torch, kernels, MANY_SETS_ARGV + ["--ingest", "wire"],
                              f"{MANY_SETS} sets wire oracle", ("unpack_rows_t", "gram_accumulate"))
    want_g = oracle.driver.accumulator.G.cpu()
    del oracle
    if got_g.shape != (MANY_SETS * 280, MANY_SETS * 280) or not torch.equal(got_g, want_g):
        raise AssertionError(f"{MANY_SETS} sets: the device Gramian differs from the wire arm's")
    if len(rows) != MANY_SETS or min(rows) <= 0:
        raise AssertionError(f"{MANY_SETS} sets: variant rows {rows.tolist()}")
    log(f"many sets: {MANY_SETS} variant sets, {got_g.shape[0]} columns: device Gramian == the "
        f"wire arm's exactly (trace {int(got_g.diagonal().long().sum())}); gen_genotypes "
        f"launches {launches['gen_genotypes']} at {block} sites ({grid[0]} blocks in clusters of "
        f"{grid[3]}, {grid[4]} tables); kept {kept}, variant rows {rows.tolist()}")
    for sets, samples in ((682, 3), (800, 2)):
        source = SyntheticGenomicsSource(num_samples=samples)
        wide = devicegen.make_gen_plan(
            [source.genotype_stream_key(f"vs{i}") for i in range(sets)],
            [source.populations] * sets, source.site_key, source.variant_spacing,
            source.ref_block_fraction, None, source.n_pops, acc_device)
        blocks, resident, sms, cluster, path = devicegen.gen_genotypes_grid(wide, 1024, acc_device)
        if resident < cluster:
            raise AssertionError(f"{sets} sets: the card holds no cluster of {cluster}")
        log(f"many sets: {sets} sets of {samples} samples at 1024 sites: {blocks} blocks in "
            f"clusters of {cluster}, {resident} resident on {sms} SMs, {path} tables")
    return launches["gen_genotypes"]


def window_blocks(window: str):
    """(callset names, blocks) of the CLI's synthetic cohort (2,504
    samples, seed 42, the default variant set) over ``window``: the packed
    arm's blocks of the CLI's 1,024 sites, partition by partition."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.pipeline.pca_driver import make_source
    from spark_examples_tpu_torch.sharding.contig import parse_contigs
    from spark_examples_tpu_torch.sharding.partitioners import VariantsPartitioner

    conf = PcaConf.parse(["--references", window, "--num-samples", str(N_SAMPLES)])
    source = make_source(conf)
    set_id = conf.variant_set_id[0]
    names = [cs["name"] for cs in source.search_callsets([set_id])]
    partitions = VariantsPartitioner(parse_contigs(window), conf.bases_per_partition)
    blocks = (block for part in partitions.get_partitions(set_id)
              for block in source.genotype_blocks(set_id, part.contig, block_size=CLI_BLOCK))
    return names, blocks


def write_cohort_vcf(window: str, path: Path, gz_path=None) -> int:
    """The CLI's synthetic cohort over ``window`` as a VCF: one line per
    variant row of the synthetic packed arm's blocks (``GT`` 0|1 where the
    sample varies, else 0|0; ``AF`` in INFO), the samples in the synthetic
    callset order so the two Gramians index alike. With ``gz_path`` also a
    gzip copy. Returns the rows written."""
    names, blocks = window_blocks(window)
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = 0
    with open(path, "wb") as f:
        f.write(b"##fileformat=VCFv4.2\n")
        f.write(("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(names) + "\n").encode())
        for block in blocks:
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
        got_g = result.driver.accumulator.G.cpu()
        if not torch.equal(got_g, want_g):
            err = int((got_g.long() - want_g.long()).abs().max())
            raise AssertionError(f"{label}: Gramian differs from the synthetic run's by {err}")
        parser = result.driver.registry.value(VCF_NATIVE_PARSE)
        if native and parser != 1.0:
            raise AssertionError(f"{label}: the native VCF parser did not run ({parser})")
        log(f"files: {label}: Gramian == the synthetic run's over the same records "
            f"(trace {int(got_g.diagonal().long().sum())}); native parser gauge {parser}")
        results[label] = result.lines
        del result
    if results["file resume"] != results["file save"]:
        raise AssertionError("the resumed run's rows differ from the saving run's")
    log(f"files: the resumed run printed the saving run's {len(results['file save'])} "
        "rows exactly")


def phase_grm(torch, kernels):
    """The ``grm`` verb through the CLI's entry point over the packed cell,
    synthetic and from the file phase's VCF (the same rows), with
    ``--grm-out`` and ``--metrics-json``: each kinship TSV byte-identical to
    the port's int64 oracle (``grm_reference``) on the same rows, so the
    two runs' to each other; each manifest valid, with its ``analysis``
    block; wall-clock, stage spans and launches printed."""
    from spark_examples_tpu_torch import cli
    from spark_examples_tpu_torch.analyses.grm import format_grm_rows, grm_reference
    from spark_examples_tpu_torch.obs.manifest import read_manifest, validate_manifest

    t0 = time.perf_counter()
    names, blocks = window_blocks(PACKED_ARGV[1])
    rows = np.concatenate([block["has_variation"] for block in blocks])
    oracle = "".join("\t".join(map(str, row)) + "\n" for row in
                     [("name", *names), *format_grm_rows(names, grm_reference(rows, N_SAMPLES))])
    log(f"grm: oracle over {rows.shape[0]} rows x {rows.shape[1]} samples in "
        f"{time.perf_counter() - t0:.1f} s")
    for label, argv in (
        ("synthetic", PACKED_ARGV[:4]),
        ("file", ["--source", "file", "--input-files", str(DATA_DIR / "packed_window.vcf"),
                  "--references", PACKED_ARGV[1]]),
    ):
        out, manifest = DATA_DIR / f"kinship_{label}.tsv", DATA_DIR / f"manifest_grm_{label}.json"
        reset_counts(kernels)
        printed = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["grm", *argv, "--grm-out", str(out), "--metrics-json", str(manifest)])
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        for line in printed.getvalue().splitlines():
            if line.strip():
                log(f"grm {label} | {line}")
        doc = read_manifest(str(manifest))
        spans = {s["name"]: s["seconds"] for s in doc["spans"]}
        log(f"grm {label}: wall {wall:.4f} s, ingest+gramian {spans['ingest+gramian']:.4f} s, "
            f"grm-finalize {spans['grm-finalize']:.4f} s, launches {json.dumps(launches)}")
        problems = validate_manifest(doc)
        want_block = {"kind": "grm", "sites_tested": int(rows.shape[0]), "sites_kept": None}
        if rc or problems or doc["analysis"] != want_block:
            raise AssertionError(f"grm {label}: rc {rc}, manifest problems {problems}, "
                                 f"analysis {doc['analysis']} (want {want_block})")
        if min(launches["unpack_rows_t"], launches["gram_accumulate"]) <= 0:
            raise AssertionError(f"grm {label} launched {launches}")
        if out.read_text() != oracle:
            raise AssertionError(f"grm {label}: the kinship differs from the int64 oracle's")
        log(f"grm {label}: kinship TSV ({out.stat().st_size} bytes) byte-identical to the "
            f"oracle's; analysis block {doc['analysis']}")


def phase_checkpoint(torch, kernels):
    """Gramian checkpoints on the packed cell (``--checkpoint-every-sites
    4096``): the plain run and a checkpointed one in this process, then a
    CLI process killed at each point of ``KILL_AT`` (started together after
    the timed runs; each must die by SIGKILL), each resumed here with ``--resume-from``: every
    resumed Gramian byte-identical to the uninterrupted one, its manifest's
    ``resume.sites_skipped == checkpoint_sites > 0``. Prints the seconds per
    save (flush, drain and 25 MB fetch; npz write, fsync and publish) and
    the checkpointed run's wall-clock beside the plain run's."""
    import signal

    from spark_examples_tpu_torch.obs.manifest import read_manifest, validate_manifest

    host_fed = ("unpack_rows_t", "gram_accumulate")
    ckpt_argv = PACKED_ARGV + ["--checkpoint-every-sites", str(CHECKPOINT_EVERY)]
    dirs = {point: DATA_DIR / f"ckpt_{point.split('#')[0]}" for point in KILL_AT}
    for directory in [DATA_DIR / "ckpt_uninterrupted", *dirs.values()]:
        shutil.rmtree(directory, ignore_errors=True)
    _, plain = run_main_path(torch, kernels, PACKED_ARGV, "checkpoint plain", host_fed)
    plain_wall = plain.wall
    del plain
    _, full = run_main_path(torch, kernels, ckpt_argv + [
        "--gramian-checkpoint-dir", str(DATA_DIR / "ckpt_uninterrupted")],
        "checkpointed", host_fed)
    want_g = full.driver.accumulator.G.cpu()
    feeder = full.driver.feeder
    log(f"checkpoint: {feeder.saves} saves of {want_g.numel() * 4} bytes: "
        f"{feeder.snapshot_seconds / feeder.saves:.4f} s each to flush, drain and fetch, "
        f"{feeder.write_seconds / feeder.saves:.4f} s to write, fsync and publish; run wall "
        f"{full.wall:.4f} s against {plain_wall:.4f} s without checkpoints")
    del full
    killed = {
        point: subprocess.Popen(
            [sys.executable, "-m", "spark_examples_tpu_torch", "variants-pca", *ckpt_argv,
             "--gramian-checkpoint-dir", str(directory)],
            env=dict(os.environ, SPARK_EXAMPLES_TPU_FAULTS=f"kill@{point}"),
            cwd=Path(__file__).resolve().parent,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for point, directory in dirs.items()
    }
    for point, proc in killed.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != -signal.SIGKILL:
            raise AssertionError(f"kill@{point}: rc {proc.returncode}: {err[-2000:]}")
        directory = dirs[point]
        manifest = DATA_DIR / f"manifest_resumed_{directory.name}.json"
        _, resumed = run_main_path(torch, kernels, ckpt_argv + [
            "--gramian-checkpoint-dir", str(directory), "--resume-from", str(directory),
            "--metrics-json", str(manifest)], f"resumed after kill@{point}", host_fed)
        got_g = resumed.driver.accumulator.G.cpu()
        del resumed
        doc = read_manifest(str(manifest))
        resume = doc["resume"]
        if validate_manifest(doc) or not torch.equal(got_g, want_g):
            raise AssertionError(f"kill@{point}: the resumed Gramian or manifest differs")
        if not resume["sites_skipped"] == resume["checkpoint_sites"] > 0:
            raise AssertionError(f"kill@{point}: resume block {resume}")
        log(f"checkpoint: killed at {point} (SIGKILL), resumed: Gramian == the uninterrupted "
            f"run's exactly; resume block {resume}")


def phase_rest(torch, kernels, wire_g):
    """``variants-pca`` over ``--source rest`` on the wire cell, its
    transport serving the synthetic cohort's wire JSON in this process (no
    sockets), the second POST (the first variant page) failing once by the
    plan ``ioerror@rest.post#2`` and retried after a zero-second sleep:
    the Gramian equals the synthetic wire run's exactly and the run's
    stats count one retry."""
    from spark_examples_tpu_torch.sources.base import ShardBoundary
    from spark_examples_tpu_torch.sources.rest import RestGenomicsSource
    from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
    from spark_examples_tpu_torch.utils import faults

    synthetic = SyntheticGenomicsSource(num_samples=N_SAMPLES)

    def transport(url, payload, headers):
        if url.endswith("/callsets/search"):
            return {"callSets": synthetic.search_callsets(payload["variantSetIds"])}
        if url.endswith("/variants/search"):
            items = list(synthetic.client().search_variants(payload, ShardBoundary.STRICT))
            return {"variants": json.loads(json.dumps(items))}
        raise AssertionError(f"unexpected url {url}")

    source = RestGenomicsSource(base_url="http://in-process", transport=transport,
                                sleep=lambda seconds: None)
    argv = WIRE_ARGV[:4] + ["--source", "rest", "--fault-plan", "ioerror@rest.post#2"]
    _, result = run_main_path(torch, kernels, argv, "rest", ("unpack_rows_t", "gram_accumulate"),
                              source=source)
    stats = result.driver.io_stats.as_dict()
    got_g = result.driver.accumulator.G.cpu()
    injected = faults.injected_count()
    del result
    faults.configure(None)
    if not torch.equal(got_g, wire_g) or stats["io_retries"] != 1 or injected != 1:
        raise AssertionError(f"rest: Gramian equal {torch.equal(got_g, wire_g)}, stats {stats}, "
                             f"faults injected {injected}")
    log(f"rest: Gramian == the synthetic wire run's exactly; one injected IO fault retried; "
        f"stats {json.dumps(stats)}")


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


def check_host_bound(doc, label) -> dict:
    """The manifest carries the configuration's host-memory bound over the
    runtime baseline the run's driver measured (the process's peak RSS at
    set-up, once the CUDA runtime and libraries were up), and the
    ``hostmem`` conformance pair against it; raises unless the pair holds:
    the run's peak RSS within the bound."""
    memory, hostmem = doc["host_memory"], doc["conformance"]["hostmem"]
    bound, baseline = memory["static_bound_bytes"], memory["runtime_baseline_bytes"]
    if bound <= baseline or hostmem is None or hostmem["proven"] != bound:
        raise AssertionError(f"{label}: host-memory bound {bound} over baseline {baseline}, "
                             f"conformance {hostmem}")
    growth = hostmem["measured"] - baseline
    log(f"telemetry {label}: runtime baseline {baseline} bytes, bound {bound} bytes (data terms "
        f"{bound - baseline}), peak RSS {memory['peak_rss_bytes']} bytes (growth {growth}), "
        f"hostmem conformance {hostmem}")
    if hostmem["ok"] is not True:
        raise AssertionError(f"{label}: peak RSS {hostmem['measured']} bytes is past the "
                             f"host-memory bound {bound} by {hostmem['measured'] - bound}")
    return hostmem


def phase_standalone_run():
    """chr17 (16,384-site blocks) through the CLI in a process of its own,
    as a user runs it, with ``--metrics-json``: the manifest must pass the
    port's validator; its ``hostmem`` pair compares that process's peak
    RSS with the bound (this script's own RSS holds every phase before the
    telemetry's). Run while this script is still small: on Linux a child's
    ``ru_maxrss`` starts from the parent's RSS at the fork."""
    from spark_examples_tpu_torch.obs.manifest import read_manifest, validate_manifest
    from spark_examples_tpu_torch.obs.metrics import read_host_peak_rss_bytes

    DATA_DIR.mkdir(parents=True, exist_ok=True)
    floor = read_host_peak_rss_bytes()
    path = DATA_DIR / "manifest_standalone.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch", "variants-pca", *CHR17_ARGV,
         "--metrics-json", str(path)],
        capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent,
    )
    if proc.returncode:
        raise AssertionError(f"the standalone run failed: {proc.stderr[-2000:]}")
    doc = read_manifest(str(path))
    problems = validate_manifest(doc)
    if problems:
        raise AssertionError(f"the standalone run's manifest is invalid: {problems}")
    log(f"telemetry standalone chr17: {time.perf_counter() - t0:.1f} s with the process's start; "
        f"this script's peak RSS at the fork {floor} bytes (the child's floor)")
    return check_host_bound(doc, "standalone chr17")


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
        doc = read_manifest(str(metrics_json))
        problems = validate_manifest(doc)
        if problems:
            raise AssertionError(f"{label}: the manifest is invalid: {problems}")
        check_host_bound(doc, label)
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
    # Before this process grows: a child's ru_maxrss starts from its
    # parent's RSS at the fork (Linux keeps the pre-exec mark).
    phase_standalone_run()

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
    launches = run_main_path(torch, path_kernels, CHR17_ARGV, "chr17", device_path)[0]
    run_main_path(torch, path_kernels, CHR17_CLI_ARGV, "chr17 default block", device_path)
    run_main_path(torch, path_kernels, BRCA1_ARGV, "brca1", device_path)
    phase_many_sets(torch, devicegen, path_kernels)
    # Each run's results are dropped (the Gramians the file phase compares
    # with are kept on the host), so its peak device memory is its own.
    packed, packed_run = run_main_path(torch, path_kernels, PACKED_ARGV, "packed", host_fed)
    packed_g = packed_run.driver.accumulator.G.cpu()
    del packed_run
    _, wire_run = run_main_path(torch, path_kernels, WIRE_ARGV, "wire", host_fed)
    wire_g = wire_run.driver.accumulator.G.cpu()
    del wire_run
    set_id = GoogleGenomicsPublicData.THOUSAND_GENOMES_PHASE_1
    same_set_argv = ["--references", SAME_SET_WINDOW, "--num-samples", str(N_SAMPLES),
                     "--variant-set-id", f"{set_id},{set_id}"]
    run_main_path(torch, path_kernels, same_set_argv, "same-set wire", host_fed)
    launches["unpack_rows_t"] = packed["unpack_rows_t"]
    phase_files(torch, path_kernels, host_fed, packed_g, wire_g)
    phase_grm(torch, path_kernels)
    phase_checkpoint(torch, path_kernels)
    phase_rest(torch, path_kernels, wire_g)
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
