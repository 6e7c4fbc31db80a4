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
   in the product's kernel, bulk copies in the scratch copy's, 16-byte
   loads and stores in the op chains', 16-byte loads and POPC in the
   association counts', atomic adds and 16-byte stores in the base
   counts';
   then chr17 through the CLI in a
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
   16,384 rows, each followed by the product; the association counts
   (``case_counts``) at 2,504 samples × 1,024 and 16,384 rows, 13 and 130
   samples, a ragged block and a block one byte past a 16-byte boundary
   (byte loads), and the LD window product at 256 sites ×
   2,504 samples and on a 37-site tail window, at its split of the
   samples and at splits 1, 2, 4, 5 and 10; the six u32 op chains at
   (1024, 2560) after 21 chained calls; the shared-memory scratch copy at
   the card's limit; the read depth (``depth_counts``) at a whole-chr21
   shard of example 3 (26,194 reads, W = 327,414 + 128) and the base counts
   (``base_counts``) at an example-4 shard (4,210 reads × 128, W = 52,631
   + 128), both also at edge shapes (reads before and past the window,
   zero, negative and over-long lengths, unknown codes, an all-false mask,
   one read, none, a window of 1, max_read_length 0, reads over the whole
   window, a window of 586 scan tiles, reads in position order, rows of
   99 bytes), ``base_counts`` called twice at each. Then the launch
   floor (``torch.cuda._sleep(0)`` in the same harness) and CUDA-event
   times of each kernel, its plain version and, where one exists, the
   PyTorch library call computing the same function (the generation and
   the product at both depths, with their launches' blocks, split and
   waves; the LD window product at each split, in turns;
   ``torch.bincount`` for the depth kernels, and the designs
   ``depth_counts`` was chosen over, from
   ``experiments/depth_variants.py``; those ``case_counts`` and
   ``base_counts`` were chosen over, from
   ``experiments/count_variants.py``, each == plain); the op chains also
   at ragged lengths and off a 16-byte boundary, with their SASS split by
   pipe; the ring's two kernels: ``cross_accumulate`` (one ring step's
   product into a strided column slice of a row tile) at 632 × 632 and
   6,250 × 6,250 × 1,024 and 16,384 sites, with ``torch._int_mm`` plus the
   slice add as the library call and each launch's clusters, split and
   items, and ``pack_rows_t`` on a generated 632-column slice and on a
   6,256-column Xᵀ (also against ``np.packbits``) with ``unpack_rows_t``
   of each packed tile back, ``transpose_rows_t`` (the unpacked wire's
   rows) on 626 columns of the generated slice, with the counts unpack
   back and ``.T.contiguous()`` as the library call, and
   ``gen_genotypes`` on one position's cut tables; the stacked jobs' kernels, ``stacked_unpack_rows_t`` then
   ``stacked_gram_accumulate`` at 1, 2 and 8 lanes × 2,504 samples × 1,024
   and 16,384 rows, at 17, 130 and 2,504 samples × 3 lanes, and in a step
   where 5 of 8 lanes have finished, timed at 4 lanes beside the K-launch
   loop and K calls of ``torch._int_mm`` plus the add;
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
   Gramian; then the mesh over four positions of one card
   (``devices=[cuda:0] * 4``): the device-generation ring over chr17 at
   ``--mesh-shape 1,4`` (flat, hierarchical with 2 hosts, and on the
   unpacked wire) and ``2,2``,
   the dense data axis at ``4,1``, and the host-fed ring on the packed
   cell, packed and ``--ring-pack-bits off`` — each Gramian byte-equal to
   the one-device run's, the ring's measured bytes equal to its
   projection, the PCs checked as above, with the launch counts, spans and
   peak device memory; then one block of the host-fed ring at chr17's
   geometry (2,504 samples, 16,384 rows, 1,4, packed wire) recorded
   (``obs/schedule.py``) on the card: its ops (names, positions, dtypes,
   shapes; 3 shifts) must be ``graftcheck ir``'s device-free schedule at
   the same geometry on ``meta`` tensors, its shifted bytes the
   ``gramian_ring_bytes`` increment and ``ring_traffic_bytes``, its row
   tiles the block's Gramian, with the block's wall recorded and not;
   then two processes sharing cuda:0 over gloo
   (``parallel/multihost.py``'s harness, two positions each, chr17 at
   2,504 samples): the data axis over the four positions, the ring at
   1,4 flat and hierarchical (2 hosts) whose hops cross the processes
   through host memory, each Gramian byte-equal to the one-device
   Gramian in both processes, ring bytes measured == predicted, every
   ring kernel launched in both; and the ``variants-pca`` CLI alone and
   as a two-process fleet with host-sharded ingest over four 2 Mb
   windows of chr17-20 (PC lines identical, per-process reference bases
   summing to the solo run's), with wall-clock, spans, backend and the
   bytes staged through host memory; and ``bench.py``'s
   large-cohort-sharded cell, 25,000 samples over chr17 through the ring
   at 1,4, its Gramian byte-equal to the one-device dense run's; and
   ``run_fused_pipeline``: a ``pca`` and a ``similarity`` group of 4 jobs
   over the four 2 Mb windows of chr17-20, each lane's Gramian byte-equal
   to its serial ``run_pipeline`` (``--ingest packed``), its PC rows or
   summary equal, the group's wall-clock beside the serial runs' sum, and
   ``max_fused_jobs`` on the card;
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
   block; ``grm --similarity-strategy sharded --mesh-shape 1,4`` and
   ``ld-prune --mesh-shape 1,4`` on four positions of the card, each
   output byte-identical to the one-device run's; then ``ld-prune``
   (windows of 256 sites, r² thresholds 0.2 and, synthetic only, 0.002) and
   ``assoc-scan`` (callset i a case when i is odd) the same way, each
   ``--ld-out``/``--assoc-out`` TSV (and the printed top 10) byte-identical
   to the oracle's walk over the same rows, the LD window product
   (``unpack_rows_t`` then ``gram_accumulate``) launched once per window
   and ``case_counts`` once per block;
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
10. trace and plan: chr17 with ``--trace-dir``, its segment's stage pairs,
   ``trace export`` through the CLI to a document the validator passes,
   each exported span beside the manifest's stage seconds; the recorder's
   cost (chr17 with and without ``--trace-dir``, median of three each);
   ``graftcheck plan --json`` over ``bench.py``'s configurations at the
   reference's 16 GiB budget and at the card's memory, and over its chr17
   configuration on a declared 2x4 fleet with a generous
   ``--sched-budget-seconds`` (proven, exit 0) and a tiny one (a
   ``sched-GS005`` rejection); the cost model's
   rates (``experiments/cost_rates.py`` in a process of its own: a
   never-built geometry's first-run penalty and, apart, a fresh process's
   first-run cost) and chr17's prediction beside its measured wall,
   through the calibration ledger; then the serve daemon (``PcaService``
   over HTTP on port 0, ``ServeClient``): first a geometry the daemon has
   never built (chr17 at 2,000 samples) under ``deadline_seconds=0.5``,
   which must be admitted and settle within it, then a chr17 ``pca`` job
   (cold, then warm) whose logged
   rows equal ``run_pipeline``'s, four 200 kb ``similarity`` jobs run as
   one fused group (the stacked kernels once a step, the single product
   never), each summary its serial run's, a ``grm`` job equal to
   ``run_grm_pipeline``'s, a 413 past the card's memory, a restarted
   daemon serving warm from its geometry ledger, the median admission
   over 20 requests, and ``serve`` as a process with one ``submit`` and a
   SIGTERM that drains to exit 0; at the end of each daemon's life,
   ``obs report --json`` over the phase's run directory as a process: one
   journaled job for each that life settled (a starting daemon compacts
   earlier lives' settled jobs out of the journal), each under its
   submit's trace id, and one calibration sample for each done job of the
   phase so far; then the checkers, all started together as processes
   that must exit 0: ``hostmem``, ``lockgraph``, ``proto`` (2 replicas,
   1 job, 1 crash, 1 stall), ``typecheck`` and ``sanitize`` over the
   port's tree; ``ir --json``, which must audit the 18 kernels of its
   default matrix with 0 findings; ``ranges --json`` (24 kernels);
   ``sched --json``, which must prove its default matrix's 16 subjects,
   the 32x8 fleet among them, with 0 findings; ``sanitize`` must read OK over the 40 corpus documents
   (or SKIP where the machine's g++ has no runtime for the mode) in asan,
   ubsan and tsan, each mode's harness first built and replayed in this
   process with its uncached walls logged; ``lint --json`` must name 0
   findings over every file of the package;
11. probes: the entry points of the two probes, ``probe_ops.run`` for every
   op and ``vmem_capacity.find_limit``, whose bisected limit must equal
   the driver's ``cudaDevAttrMaxSharedMemoryPerBlockOptin``;
12. variants examples: ``search-variants-klotho`` (defaults) and
   ``search-variants-brca1 --num-samples 17`` through the CLI, and Klotho
   over 2 kb around its SNP, each printed line list equal to an oracle
   counting the same source's records;
13. reads examples on the synthetic source through
   ``reads_examples.run_example*`` on the card, every read kept as served:
   example 1 at the CLI's default SNP (where the JAX package raises; the
   pileup must be the half-open oracle's), example 2 over 200 kb of chr21
   (coverage = Σ lengths / chr21 length), example 3 over 500 kb (two
   shards; the part file byte-identical to a naive numpy depth), example 4
   over 200 kb of chr1 (four shards, normal and tumor; the diff lines equal
   a numpy oracle and are not empty); each with its wall-clock, depth
   launches, derived kernel time and peak device memory;
14. reads from SAM: example 3's reads and example 4's normal and tumor
   reads written as SAM files under ``chip_smoke_data/``; examples 3 and 4
   through the CLI with ``--source file`` at their defaults (all of chr21;
   1 Mb of chr1), each output byte-identical to the synthetic run's;
15. the ``kernels`` JSON line, the card line, and last the result line.

Imports nothing of JAX or of the JAX package. Exits non-zero without a
result when no CUDA card is present or the port is not beside this file.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import gzip
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
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
#: rows); int8 warpgroup MMAs and TMA tensor loads (and the ring product's
#: bulk reductions into C); bulk copies; 16-byte
#: loads and stores (the op chains' vectors); 16-byte loads of the packed
#: rows (the association counts); atomic adds into device memory and the
#: next buffer's 16-byte zeroing stores (the base counts); 16-byte loads
#: of the column rows that ask L2 for 128-byte lines, warp votes and
#: 16-byte stores of the packed rows (the ring's pack). IMMA is mma.sync.
HOPPER_SASS = {
    "gen_genotypes_kernel": ("devicegen.cu", ("STG.E.128",), ()),
    "unpack_rows_t_kernel": ("gramian.cu", ("STG.E.128",), ()),
    "gram_accumulate_kernel": ("devicegen.cu", ("IGMMA", "UTMALDG"), ("IMMA",)),
    "scratch_copy_kernel": ("probes.cu", ("UBLKCP",), ()),
    "probe_op_chain_kernel": ("probes.cu", ("LDG.E.128", "STG.E.128"), ()),
    "case_counts_kernel": ("ld.cu", ("LDG.E.128", "POPC"), ()),
    "base_counts_kernel": ("depth.cu", ("REDG", "STG.E.128"), ()),
    "cross_accumulate_kernel": ("devicegen.cu", ("IGMMA", "UTMALDG", "UBLKRED"), ("IMMA",)),
    # The length prefix of the mangled name keeps unpack_rows_t_kernel out.
    "18pack_rows_t_kernel": ("gramian.cu", ("LDG.E.LTC128B.128", "VOTE", "STG.E.128"), ()),
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
#: The ring kernels' shapes: (rows of A, rows of B, sites) of one ring step
#: at 2,504 samples over 4 positions (632 columns each) at the CLI's block
#: and chr17's, and at 25,000 over 4 (6,250) at both.
CROSS_SHAPES = ((632, 632, CLI_BLOCK), (632, 632, BLOCK), (6250, 6250, CLI_BLOCK),
                (6250, 6250, BLOCK))
#: Columns of a position's packed ring tile at 2,504 and 25,000 samples
#: over 4 positions (the bit-packed wire pads 25,000 to 25,024).
RING_TILE_COLUMNS = (632, 6256)
#: The sharded runs: the samples-sharded ring over positions of one card
#: (``devices=[cuda:0] * 4``), each Gramian byte-equal to the one-device
#: run's on the same sites. (label, base argv, extra flags, hosts of the
#: hierarchical schedule, the one-device Gramian it equals).
MESH_FLAGS = ["--mesh-shape", "1,4", "--similarity-strategy", "sharded"]
SHARDED_RUNS = (
    ("ring 1,4", "chr17", MESH_FLAGS, None),
    ("ring 1,4 hier 2 hosts", "chr17", MESH_FLAGS + ["--reduce-schedule", "hier"], 2),
    ("ring 1,4 unpacked wire", "chr17", MESH_FLAGS + ["--ring-pack-bits", "off"], None),
    ("ring 2,2", "chr17", ["--mesh-shape", "2,2", "--similarity-strategy", "sharded"], None),
    ("data axis 4,1", "chr17", ["--mesh-shape", "4,1"], None),
    ("packed ring 1,4", "packed", MESH_FLAGS, None),
    ("packed ring 1,4 unpacked wire", "packed", MESH_FLAGS + ["--ring-pack-bits", "off"], None),
)
#: ``bench.py``'s large-cohort-sharded cell: 25,000 samples over the ring at
#: 1,4, on the whole of chr17 (bench.py's references, 50 blocks of 16,384
#: sites), against the one-device Gramian of the same sites.
LARGE_COHORT = 25_000
LARGE_WINDOW = "17:0:81195210"
#: The multiprocess phase: two processes on cuda:0 (gloo: NCCL refuses two
#: ranks on one card), two positions each, chr17 at 2,504 samples in
#: blocks of 16,384 sites, each child bounded by its timeout; the fleet
#: over four 2 Mb windows of chr17-20.
MP_PROCESSES = 2
MP_POSITIONS = 2
MP_TIMEOUT = 240
FLEET_WINDOWS = ",".join(f"{ref}:41196311:43196311" for ref in ("17", "18", "19", "20"))
#: The LD prune's defaults (--ld-window-sites, --ld-r2-threshold).
LD_WINDOW = 256
LD_THRESHOLD = 0.2
#: A threshold that prunes on the synthetic cohort, whose sites are drawn
#: independently (r² about 1/N between two sites, so none passes 0.2).
LD_LOW_THRESHOLD = 0.002
#: Sites of the LD tail window the kernels phase checks.
LD_TAIL = 37
#: Splits of the LD window product's 20 steps of 128 samples that the
#: kernels phase checks and times (1 is the unsplit launch).
LD_SPLITS = (1, 2, 4, 5, 10)
#: u32 operations of the association counts per 32-bit word of a row: an
#: and and two popc.
CASE_COUNT_OPS_PER_WORD = 3
#: The reads examples at the synthetic read geometry (length 100, depth 8).
#: Each shard holds what a user's run holds; only the number of shards is
#: cut (PERF.md §4). Example 2: one shard of 200 kb of chr21 (16,000
#: reads); example 3: two shards of 250,000 bases (20,000 reads each) with
#: the carry between them (whole chr21 is 147 shards of 327,414 bases);
#: example 4: four shards of 50,000 bases of chr1, normal and tumor (its
#: default 1 Mb is 19 shards of 52,631).
EX2_REGION = (1_000_000, 1_200_000)
EX3_REGION = (1_000_000, 1_500_000)
EX4_REGION = (100_000_000, 100_200_000)
#: Example 4's defaults (``reads_examples.run_example4``), which its SAM
#: run takes: 19 shards of 52,631 bases.
EX4_DEFAULT_REGION = (100_000_000, 101_000_000)
EX4_DEFAULT_SHARDS = 19
#: The kernels phase's shapes: a whole-chr21 shard of example 3 (26,194
#: reads) and a default example-4 shard (4,210 reads of one readset), the
#: window a shard's span plus the 128-base read pad.
CHR21_SHARD_SPAN = 327_414
EX4_SHARD_SPAN = 52_631
EX4_SHARD_READS = 4_210
READ_PAD = 128
DEPTH_WINDOW_START = 1_000_000
#: The synthetic base qualities are uniform on 20..40: 11 of 21 pass the
#: example's 30.
QUALITY_PASS_SHARE = 11 / 21
#: Edge shapes of the depth kernels: (reads, read length, window,
#: max_read_length, mode of ``depth_inputs``); the four before the sorted
#: shard are edges of ``depth_counts``' difference array and scan (its
#: tiles are 1,024 positions); the last two are ``base_counts``' (reads in
#: position order; rows of 99 bytes, no whole number of words). The codes
#: are max_read_length wide, and the windows grow and shrink from case to
#: case, so ``base_counts``' kept zeroed buffer is taken at its size,
#: wider and narrower.
DEPTH_EDGE_CASES = {
    "edges": (997, 192, 5000, 256, "edges"),
    "all-unknown codes": (300, 100, 2000, 128, "unknown"),
    "all-false mask": (300, 100, 2000, 128, "masked"),
    "one read": (1, 100, 64, 128, "random"),
    "no reads": (0, 100, 64, 128, "random"),
    "a window of 1": (200, 100, 1, 128, "random"),
    "max_read_length 0": (300, 100, 2000, 0, "long"),
    "reads over the whole window": (64, 3000, 2000, 4096, "random"),
    "a window of 586 scan tiles": (3000, 100, 600_000, 128, "random"),
    "position-sorted reads": (EX4_SHARD_READS, 100, EX4_SHARD_SPAN + READ_PAD, 100, "sorted"),
    "read length 99": (300, 90, 2000, 99, "random"),
}
#: The Klotho example's second, wider run: 2 kb around the SNP.
KLOTHO_WIDE = 2_000
#: |PC entry| tolerance between the subspace iteration and a full eigh of the
#: same centered matrix: both in float32 on unit-norm components, with
#: different starts; see PERF.md for the measured gap.
PC_TOLERANCE = 1e-4


#: The script's start on the host clock; :func:`log` prefixes each line
#: with the seconds since, so a run's log shows where its time went.
STARTED = time.perf_counter()


def log(*parts) -> None:
    print(f"[{time.perf_counter() - STARTED:7.1f} s]", *parts, flush=True)


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


def launch_floor_ms(torch) -> float:
    """The time of a near-empty launch in the kernels' timing harness
    (``torch.cuda._sleep(0)``, 50 calls queued behind a device sleep): what
    no kernel of a single launch can go under."""
    from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms

    floor = cuda_ms(lambda: torch.cuda._sleep(0), 50)
    log(f"kernels: launch floor (torch.cuda._sleep(0), 50 calls): {floor:.4f} ms")
    return floor


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
        blocks, resident, split, sms = devicegen.gram_accumulate_grid(*block.shape, dev)
        if split != 1:
            raise AssertionError(f"gram_accumulate at {n} samples x {sites} sites splits its "
                                 f"sites over {split} blocks: the Gramian's launch must not")
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
            f"it); launch: {blocks} blocks (split {split}: each over every site), {resident} "
            f"resident on {sms} SMs, {blocks / resident:.2f} waves")
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


def phase_ld_kernels(torch, devicegen, gramian, ld, int32_rate, floor_ms):
    """The two device programs of ``ld-prune`` and ``assoc-scan`` against
    their plain versions, exactly: ``case_counts`` on blocks shipped as the
    scan ships them (16-byte pitch) at 2,504 samples × 1,024 and 16,384
    rows, at 13 and 130 samples, and on a ragged block; the LD window
    product on the packed cell's first 256 sites and a 37-site tail.
    Times with CUDA events beside the plain versions, the library calls and
    the bounds; returns the JSON rows (``case_counts`` at the CLI's 1,024
    rows, ``gram_accumulate`` at the LD window's shape)."""
    from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(11)
    for n, rows, shifted in ((N_SAMPLES, CLI_BLOCK, False), (N_SAMPLES, BLOCK, False),
                             (130, CLI_BLOCK, False), (13, CLI_BLOCK, False),
                             (N_SAMPLES, 937, False), (N_SAMPLES, CLI_BLOCK, True)):
        values = (rng.random((rows, n)) < 0.3).astype(np.uint8)
        case = (np.arange(n) % 2).astype(np.uint8)
        block, case_t = ld.pack_rows(values, dev), ld.pack_case(case, dev)
        if shifted:  # the same rows one byte past a 16-byte boundary: byte loads
            pitch = block.stride(0)
            flat = torch.zeros(rows * pitch + 1, dtype=torch.uint8, device=dev)
            flat[1:].view(rows, pitch)[:, :block.shape[1]] = block
            block = flat[1:].view(rows, pitch)[:, :block.shape[1]]
        if ld.case_counts_vectors(block, case_t) == shifted:
            raise AssertionError(f"case_counts takes the wrong loads at N={n}, {rows} rows")
        a, t = ld.case_counts(block, case_t, n)
        a_p, t_p = ld.case_counts_plain(block, case_t, n)
        torch.cuda.synchronize()
        if not (torch.equal(a, a_p) and torch.equal(t, t_p)):
            raise AssertionError(f"case_counts != plain at N={n}, {rows} rows")
        log(f"kernels: case_counts == plain (N={n}, {rows} rows, pitch {block.stride(0)}, "
            f"{'byte' if shifted else '16-byte'} loads from byte {block.data_ptr() % 16} of a "
            f"16-byte vector, {ld.case_counts_lanes(block.shape[1], rows, sms)} lanes a row): "
            f"{int(a.long().sum())} case carriers of {int(t.long().sum())}")

    # The packed cell's first window (real cohort rows) and a tail window.
    _, blocks = window_blocks(PACKED_ARGV[1])
    first = next(blocks)["has_variation"]
    for sites in (LD_WINDOW, LD_TAIL):
        window = first[:sites]
        packed = torch.from_numpy(ld.pack_window(window)).to(dev)
        C = ld.window_counts(packed, sites)
        C_p = torch.zeros_like(C)
        xt = gramian.unpack_rows_t_plain(packed, sites)
        devicegen.gram_accumulate_plain(C_p, xt)
        torch.cuda.synchronize()
        if not torch.equal(C, C_p):
            raise AssertionError(f"LD window product != plain at {sites} sites")
        X = window.astype(np.float64)
        if not np.array_equal(C.cpu().numpy(), (X @ X.T).astype(np.int64)):
            raise AssertionError(f"LD window product != float64 BLAS at {sites} sites")
        for split in LD_SPLITS:
            C_s = torch.zeros_like(C)
            devicegen.gram_accumulate(C_s, xt, split)
            torch.cuda.synchronize()
            if not torch.equal(C_s, C_p):
                raise AssertionError(f"LD window product != plain at {sites} sites, split {split}")
        _, _, split, sms = devicegen.gram_accumulate_grid(*xt.shape, dev)
        log(f"kernels: LD window product (unpack_rows_t, gram_accumulate) == plain and float64 "
            f"BLAS at {sites} sites x {N_SAMPLES} samples (split {split} on {sms} SMs, and at "
            f"splits {LD_SPLITS}): trace {int(C.diagonal().long().sum())}")

    # Times at the main paths' shapes: the CLI's 1,024-row block at 2,504
    # samples (and the device path's 16,384), and one full window of 256
    # sites.
    n, width = N_SAMPLES, -(-N_SAMPLES // 8)
    values = (rng.random((CLI_BLOCK, n)) < 0.3).astype(np.uint8)
    case = (np.arange(n) % 2).astype(np.uint8)
    block, case_t = ld.pack_rows(values, dev), ld.pack_case(case, dev)
    Xf = torch.from_numpy(values).to(dev).float()
    M = torch.stack([torch.from_numpy(case).to(dev).float(), torch.ones(n, device=dev)], dim=1)
    words = CLI_BLOCK * -(-width // 4)
    big = ld.pack_rows((rng.random((BLOCK, n)) < 0.3).astype(np.uint8), dev)
    big_ms = cuda_ms(lambda: ld.case_counts(big, case_t, n), 50)
    big_bound = bound(BLOCK * width + width + 8 * BLOCK, 0, int32_rate)[0]
    counts_row = dict(
        max_abs_err=0, floor_ms=floor_ms,
        ms=cuda_ms(lambda: ld.case_counts(block, case_t, n), 50),
        plain_ms=cuda_ms(lambda: ld.case_counts_plain(block, case_t, n), 5, 1),
        library_ms=cuda_ms(lambda: torch.matmul(Xf, M), 50),
        # Reads the packed block and the case mask once, writes a and t.
        bound=bound(CLI_BLOCK * width + width + 8 * CLI_BLOCK,
                    words * CASE_COUNT_OPS_PER_WORD, int32_rate),
    )
    r = counts_row
    log(f"kernels: case_counts at {CLI_BLOCK} rows x {n} samples "
        f"({ld.case_counts_lanes(width, CLI_BLOCK, sms)} lanes a row, 16-byte loads): "
        f"{r['ms']:.4f} ms (launch floor {floor_ms:.4f} ms; plain {r['plain_ms']:.4f} ms, "
        f"torch.matmul of the unpacked float32 block by [case, 1] {r['library_ms']:.4f} ms, "
        f"reading 8x the bytes; bound {r['bound'][0]:.6f} ms by {r['bound'][1]}, "
        f"{100 * r['bound'][0] / r['ms']:.2f} % of it); at {BLOCK} rows {big_ms:.4f} ms "
        f"({ld.case_counts_lanes(width, BLOCK, sms)} lanes a row; bound {big_bound:.6f} ms by "
        f"bytes, {100 * big_bound / big_ms:.2f} % of it)")
    window = first[:LD_WINDOW]
    t0 = time.perf_counter()
    for _ in range(20):
        ld.pack_window(window)
    pack_ms = (time.perf_counter() - t0) / 20 * 1e3
    packed = torch.from_numpy(ld.pack_window(window)).to(dev)
    xt = gramian.unpack_rows_t(packed, LD_WINDOW)
    C = torch.zeros((LD_WINDOW, LD_WINDOW), dtype=torch.int32, device=dev)
    blocks_, resident, split, sms = devicegen.gram_accumulate_grid(*xt.shape, dev)
    if split == 1:
        raise AssertionError(f"the LD window's product ({tuple(xt.shape)}) does not split")
    operand = xt.numel()
    # Each split in turns (s1 s2 ... s2 s1), the rule's own among them.
    split_ms = {s: [] for s in LD_SPLITS}
    for order in (LD_SPLITS, LD_SPLITS[::-1]):
        for s in order:
            split_ms[s].append(cuda_ms(lambda: devicegen.gram_accumulate(C, xt, s), 50))
    split_ms = {s: sum(t) / len(t) for s, t in split_ms.items()}
    window_row = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: devicegen.gram_accumulate(C, xt), 50),
        plain_ms=cuda_ms(lambda: devicegen.gram_accumulate_plain(C, xt), 5, 1),
        library_ms=cuda_ms(lambda: torch._int_mm(xt, xt.t()), 50),
        # Reads the int8 operand once and writes C; W·(W+1)·N operations
        # of the symmetric product over the real samples.
        bound=bound(operand + 4 * LD_WINDOW * LD_WINDOW,
                    float(LD_WINDOW) * (LD_WINDOW + 1) * n, PEAK_INT8_OPS_PER_S),
    )
    unpack_ms = cuda_ms(lambda: gramian.unpack_rows_t(packed, LD_WINDOW), 50)
    program_ms = cuda_ms(lambda: ld.window_counts(packed, LD_WINDOW), 50)
    r = window_row
    log(f"kernels: gram_accumulate at the LD window ({LD_WINDOW} sites x {n} samples, operand "
        f"{tuple(xt.shape)}): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, torch._int_mm "
        f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms by {r['bound'][1]}, "
        f"{100 * r['bound'][0] / r['ms']:.2f} % of it); launch: {blocks_} blocks (split "
        f"{split}), {resident} resident, on {sms} SMs; by split: "
        + ", ".join(f"{s} {t:.4f} ms" for s, t in split_ms.items())
        + f"; unpack_rows_t of the transposed packing {unpack_ms:.4f} ms; the program (unpack, "
        f"zeroed C, product) {program_ms:.4f} ms; the host's transposed packing "
        f"{pack_ms:.4f} ms")
    return counts_row, window_row


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
                            if re.search(r"MMA|UTMA|UBLK|POPC|REDG|(LDG|STG).*\.128", op)})
            log(f"sass: {name}: "
                f"{', '.join(found) or 'no MMA, TMA, bulk-copy, POPC or 16-byte store opcode'}")
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


@functools.lru_cache(maxsize=None)
def packed_cell():
    """(callset names, positions, has-variation rows, block count) of the
    packed cell's synthetic stream, generated once for the oracles of the
    ``grm``, ``ld`` and ``assoc`` phases."""
    names, blocks = window_blocks(PACKED_ARGV[1])
    blocks = list(blocks)
    return (names, np.concatenate([block["positions"] for block in blocks]),
            np.concatenate([block["has_variation"] for block in blocks]), len(blocks))


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
    names, _, rows, _ = packed_cell()
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


def run_cli(torch, kernels, argv, label):
    """``cli.main(argv)`` with every launch count set to 0 just before:
    (wall seconds, launches, printed lines); every printed line is logged."""
    from spark_examples_tpu_torch import cli

    reset_counts(kernels)
    printed = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc:
        raise AssertionError(f"{label}: exit code {rc}")
    lines = printed.getvalue().splitlines()
    for line in lines:
        if line.strip():
            log(f"{label} | {line}")
    return wall, {k.__name__: k.launches for k in kernels}, lines


def analysis_sources(label):
    """The packed cell's argv from the synthetic source or from the file
    phase's VCF of the same rows."""
    if label == "synthetic":
        return PACKED_ARGV[:4]
    return ["--source", "file", "--input-files", str(DATA_DIR / "packed_window.vcf"),
            "--references", PACKED_ARGV[1]]


def check_analysis_manifest(path, want_block, label) -> dict:
    """The manifest valid with ``want_block`` as its ``analysis`` block;
    returns its spans by path."""
    from spark_examples_tpu_torch.obs.manifest import read_manifest, validate_manifest

    doc = read_manifest(str(path))
    problems = validate_manifest(doc)
    if problems or doc["analysis"] != want_block:
        raise AssertionError(f"{label}: manifest problems {problems}, analysis "
                             f"{doc['analysis']} (want {want_block})")

    def walk(spans, prefix):
        for span in spans:
            name = f"{prefix}/{span['name']}" if prefix else span["name"]
            yield name, span["seconds"]
            yield from walk(span["children"], name)

    return dict(walk(doc["spans"], ""))


def count_blocks(argv) -> int:
    """The blocks an analysis streams for ``argv`` (its source's
    ``genotype_blocks`` over its partitions)."""
    from spark_examples_tpu_torch.analyses.base import AnalysisContext
    from spark_examples_tpu_torch.config import PcaConf

    with contextlib.redirect_stdout(io.StringIO()):
        return sum(1 for _ in AnalysisContext(PcaConf.parse(argv), "assoc").blocks())


def phase_ld(torch, kernels):
    """``ld-prune`` through the CLI's entry point over the packed cell at
    its defaults (windows of 256 sites, r² > 0.2 pruned), synthetic and
    from the file phase's VCF, then synthetic at r² > 0.002 (the synthetic
    sites are drawn independently, so 0.2 prunes none of them and 0.002
    prunes most): each ``--ld-out`` TSV byte-identical to the
    oracle, ``ld_prune_reference``'s walk with its counts from float64 BLAS
    (exact below 2^53; NumPy's int64 product has no BLAS path); each
    manifest valid with its ``analysis`` block; ``unpack_rows_t`` and
    ``gram_accumulate`` launched once per window, ``case_counts`` never.
    Returns the synthetic run's launches."""
    from spark_examples_tpu_torch.ops.ld import greedy_prune

    t0 = time.perf_counter()
    _, positions, rows, _ = packed_cell()
    counts = []
    for lo in range(0, len(rows), LD_WINDOW):
        X = rows[lo:lo + LD_WINDOW]
        Xf = X.astype(np.float64)
        counts.append(((Xf @ Xf.T).astype(np.int64), X.sum(axis=1)))
    windows = len(counts)
    oracles = {}
    for threshold in (LD_THRESHOLD, LD_LOW_THRESHOLD):
        kept = np.concatenate([greedy_prune(C, k, N_SAMPLES, threshold) for C, k in counts])
        text = "".join(f"17\t{int(p)}\t{int(m)}\n" for p, m in zip(positions, kept))
        oracles[threshold] = ("contig\tpos\tkept\n" + text, int(kept.sum()))
    log(f"ld: oracle over {rows.shape[0]} rows x {rows.shape[1]} samples, {windows} windows, "
        f"{oracles[LD_THRESHOLD][1]} kept at r² > {LD_THRESHOLD} pruned, "
        f"{oracles[LD_LOW_THRESHOLD][1]} at > {LD_LOW_THRESHOLD}, in "
        f"{time.perf_counter() - t0:.1f} s")
    result = None
    for label, threshold in (("synthetic", LD_THRESHOLD), ("file", LD_THRESHOLD),
                             ("synthetic", LD_LOW_THRESHOLD)):
        oracle, kept_total = oracles[threshold]
        want_block = {"kind": "ld", "sites_kept": kept_total, "sites_tested": int(rows.shape[0])}
        tag = f"{label}_{threshold}"
        out, manifest = DATA_DIR / f"ld_kept_{tag}.tsv", DATA_DIR / f"manifest_ld_{tag}.json"
        flags = [] if threshold == LD_THRESHOLD else ["--ld-r2-threshold", str(threshold)]
        wall, launches, _ = run_cli(torch, kernels, ["ld-prune", *analysis_sources(label), *flags,
                                                     "--ld-out", str(out), "--metrics-json",
                                                     str(manifest)], f"ld {label}")
        label = f"{label} at r² > {threshold}"
        spans = check_analysis_manifest(manifest, want_block, f"ld {label}")
        log(f"ld {label}: wall {wall:.4f} s, spans {json.dumps(spans)}, launches "
            f"{json.dumps(launches)}")
        if (launches["unpack_rows_t"], launches["gram_accumulate"], launches["case_counts"]) != (
                windows, windows, 0):
            raise AssertionError(f"ld {label}: launches {launches}, {windows} windows")
        if out.read_text() != oracle:
            raise AssertionError(f"ld {label}: the kept mask differs from the oracle's")
        log(f"ld {label}: kept-mask TSV ({out.stat().st_size} bytes) byte-identical to the "
            f"oracle's; analysis block {want_block}")
        result = result or launches
    return result


def phase_assoc(torch, kernels):
    """``assoc-scan`` through the CLI's entry point over the packed cell,
    synthetic and from the file phase's VCF, the phenotypes written as
    ``bench.py`` writes them (callset i has status i % 2): each
    ``--assoc-out`` TSV and the printed top 10 byte-identical to the
    oracle's (``case_counts_reference`` and ``chi2_from_counts`` over the
    same rows, ranked by χ² then stream order); each manifest valid;
    ``case_counts`` launched once per block. Returns the synthetic run's
    launches."""
    from spark_examples_tpu_torch.analyses.assoc import chi2_from_counts
    from spark_examples_tpu_torch.ops.ld import case_counts_reference

    t0 = time.perf_counter()
    names, positions, rows, n_blocks = packed_cell()
    phenotypes = DATA_DIR / "phenotypes.tsv"
    phenotypes.write_text("".join(f"{name}\t{i % 2}\n" for i, name in enumerate(names)))
    case = (np.arange(len(names)) % 2).astype(np.uint8)
    n_cases = int(case.sum())
    a, t = case_counts_reference(rows, case)
    chi2 = chi2_from_counts(a, t, n_cases, len(names) - n_cases)
    lines, ranked = ["contig\tpos\tcase_carriers\tcarriers\tchi2"], []
    for p, a_i, t_i, c in zip(positions, a, t, chi2):
        lines.append(f"17\t{int(p)}\t{int(a_i)}\t{int(t_i)}\t{float(c)!r}")
        ranked.append((float(c), -len(ranked), int(p), int(a_i), int(t_i)))
    oracle = "\n".join(lines) + "\n"
    top = [f"17\t{p}\t{a_i}\t{t_i}\t{c:.6g}" for c, _, p, a_i, t_i in sorted(ranked)[::-1][:10]]
    log(f"assoc: oracle over {len(ranked)} rows, {n_blocks} blocks, {n_cases} cases, in "
        f"{time.perf_counter() - t0:.1f} s; top chi2 {top[0]!r}")
    want_block = {"kind": "assoc", "sites_kept": None, "sites_tested": len(ranked)}
    result = None
    for label in ("synthetic", "file"):
        out = DATA_DIR / f"assoc_scan_{label}.tsv"
        manifest = DATA_DIR / f"manifest_assoc_{label}.json"
        wall, launches, printed = run_cli(
            torch, kernels, ["assoc-scan", *analysis_sources(label), "--phenotypes",
                             str(phenotypes), "--assoc-out", str(out), "--metrics-json",
                             str(manifest)], f"assoc {label}")
        spans = check_analysis_manifest(manifest, want_block, f"assoc {label}")
        log(f"assoc {label}: wall {wall:.4f} s, spans {json.dumps(spans)}, launches "
            f"{json.dumps(launches)}")
        blocks_run = launches["case_counts"]
        blocks_streamed = count_blocks(analysis_sources(label))
        if blocks_run != blocks_streamed or (label == "synthetic" and blocks_run != n_blocks):
            raise AssertionError(f"assoc {label}: case_counts launches {launches}, "
                                 f"{blocks_streamed} blocks streamed")
        start = printed.index(f"Association scan: {len(ranked)} sites tested.") + 1
        if printed[start:start + 10] != top:
            raise AssertionError(f"assoc {label}: top 10 {printed[start:start + 10]} != {top}")
        if out.read_text() != oracle:
            raise AssertionError(f"assoc {label}: the scan differs from the oracle's")
        log(f"assoc {label}: scan TSV ({out.stat().st_size} bytes) and top 10 byte-identical "
            f"to the oracle's; case_counts launched {blocks_run} times over its blocks")
        result = result or launches
    return result


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


# ------------------------------------------------------------ trace + plan


def bench_plan_argv(name: str):
    """``bench.py``'s configurations (``CONFIGS``, ``bench.py:58-128``, its
    base flags at ``:958-971``) as ``graftcheck plan`` flags: device
    generation at 16,384-site blocks, two PCs, the sharded cell over four
    declared devices."""
    from spark_examples_tpu_torch.constants import Examples

    base = ["--ingest", "device", "--block-size", str(BLOCK), "--num-pc", "2"]
    autosomes = ",".join(f"{name}:0:{length}" for name, length in
                         Examples.HUMAN_CHROMOSOMES.items() if name not in ("X", "Y"))
    chr17 = ["--references", "17:0:81195210"]
    return base + {
        "whole-genome": ["--variant-set-id", "bench-1kg", "--num-samples", "2504",
                         "--all-references"],
        "brca1": ["--variant-set-id", "bench-1kg", "--num-samples", "2504",
                  "--references", "17:41196311:41277499"],
        "chr17": ["--variant-set-id", "bench-1kg", "--num-samples", "2504", *chr17],
        "platinum": ["--variant-set-id", "bench-platinum", "--num-samples", "17",
                     "--all-references"],
        "large-cohort": ["--variant-set-id", "bench-1kg", "--num-samples", "25000", *chr17],
        "large-cohort-sharded": ["--variant-set-id", "bench-1kg", "--num-samples", "25000",
                                 *chr17, "--mesh-shape", "1,4", "--similarity-strategy",
                                 "sharded", "--plan-devices", "4"],
        "merged": ["--variant-set-id", "bench-1kg,bench-platinum", "--num-samples", "2504,17",
                   "--references", autosomes],
    }[name]


BENCH_CONFIGS = ("whole-genome", "brca1", "chr17", "platinum", "large-cohort",
                 "large-cohort-sharded", "merged")
#: The stage pairs a traced variants-pca run's segment holds.
TRACE_SPANS = ("run", "ingest+similarity", "center+pca")
#: Rounds of the recorder's cost: chr17 with and without --trace-dir, in
#: turns.
TRACE_ROUNDS = 3


def phase_trace(torch, kernels):
    """The flight recorder, the trace export and the plan on the card: chr17
    (16,384-site blocks) with ``--trace-dir`` and ``--metrics-json``, its
    segment's ``run``/``ingest+similarity``/``center+pca`` pairs, ``trace
    export`` through the CLI to a document the validator passes, each
    exported span beside the manifest's stage seconds; the recorder's cost
    (chr17 with and without ``--trace-dir``, median of three each, in
    turns); ``graftcheck plan --json`` over ``bench.py``'s configurations at
    the default budget and at the card's memory; then the cost model: the
    rates ``experiments/cost_rates.py`` measures in a process of its own,
    chr17's prediction beside its measured wall, and the calibration
    ledger's fold of that pair."""
    import tempfile

    from spark_examples_tpu_torch import cli
    from spark_examples_tpu_torch.check.plan import predict_job_cost
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.obs import costmodel
    from spark_examples_tpu_torch.obs.calibration import CalibrationLedger
    from spark_examples_tpu_torch.obs.manifest import read_manifest, validate_manifest
    from spark_examples_tpu_torch.obs.recorder import read_segments
    from spark_examples_tpu_torch.obs.trace import validate_chrome_trace
    from spark_examples_tpu_torch.ops.gramian import per_device_memory_bytes
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    run_dir = DATA_DIR / "trace_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    metrics_json = DATA_DIR / "manifest_trace.json"
    launches, _ = run_main_path(
        torch, kernels, CHR17_ARGV + ["--trace-dir", str(run_dir),
                                      "--metrics-json", str(metrics_json)],
        "chr17 --trace-dir", ("gen_genotypes", "gram_accumulate"))
    events = read_segments(str(run_dir))
    pairs = [(e["name"], e["ph"]) for e in events]
    for name in TRACE_SPANS:
        if pairs.count((name, "B")) != 1 or pairs.count((name, "E")) != 1:
            raise AssertionError(f"trace: the segment lacks a {name} B/E pair: {pairs}")
    out = DATA_DIR / "trace_merged.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["trace", "export", "--run-dir", str(run_dir), "--out", str(out)])
    doc = json.loads(out.read_text())
    problems = validate_chrome_trace(doc)
    if rc or problems:
        raise AssertionError(f"trace export: rc {rc}, {problems}")
    manifest = read_manifest(str(metrics_json))
    if validate_manifest(manifest):
        raise AssertionError(f"trace: the manifest is invalid: {validate_manifest(manifest)}")
    stages = {s["name"]: s["seconds"] for s in manifest["spans"]}
    spans = {e["name"]: e["dur"] / 1e6 for e in doc["traceEvents"] if e["ph"] == "X"}
    for name in TRACE_SPANS:
        stage = f"{stages[name]:.6f} s" if name in stages else "none (the whole run)"
        log(f"trace chr17: exported {name} {spans[name]:.6f} s, manifest stage {stage}")
    segments = glob.glob(str(run_dir / "trace" / "*.jsonl"))
    log(f"trace chr17: {len(events)} events in {len(segments)} segment(s); export "
        f"{os.path.getsize(out)} bytes, validator clean")

    # The recorder's cost: chr17 with and without --trace-dir, in turns.
    walls = {"without": [], "with": []}
    for _ in range(TRACE_ROUNDS):
        for label in ("without", "with"):
            argv = list(CHR17_ARGV)
            if label == "with":
                shutil.rmtree(run_dir, ignore_errors=True)
                argv += ["--trace-dir", str(run_dir)]
            conf = PcaConf.parse(argv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                run_pipeline(conf)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
    median = {k: float(np.median(v)) for k, v in walls.items()}
    log(f"trace recorder cost on chr17: median wall {median['with']:.4f} s with --trace-dir, "
        f"{median['without']:.4f} s without ({median['with'] - median['without']:+.4f} s); "
        f"walls {json.dumps(walls)}")

    # graftcheck plan over bench.py's configurations, at the reference's
    # device-free budget and at the card's memory.
    card_bytes = per_device_memory_bytes("cuda")
    for name in BENCH_CONFIGS:
        for budget in (None, card_bytes):
            argv = ["graftcheck", "plan", *bench_plan_argv(name), "--json"]
            if budget is not None:
                argv += ["--device-memory-bytes", str(budget)]
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = cli.main(argv)
            report = json.loads(printed.getvalue())
            geometry = report["geometry"]
            keys = ("mesh", "shard_windows", "gramian_entry_bound", "host_peak_bytes",
                    "ring_bytes_per_flush", "ring_peak_live_bytes_per_device")
            log(f"plan {name} at {'16 GiB' if budget is None else f'{budget} bytes'}: rc {rc}, "
                f"ok {report['ok']}, issues "
                f"{[(i['code'], i['severity']) for i in report['issues']]}, "
                f"{json.dumps({k: geometry[k] for k in keys if k in geometry})}")
            if rc != (0 if report["ok"] else 2):
                raise AssertionError(f"plan {name}: rc {rc} for ok {report['ok']}")
    # The schedule proof: chr17 on a declared 2x4 fleet (its device ring,
    # two-level, recorded device-free at the configuration's width) within a
    # generous budget, then past a tiny one.
    for budget, want in (("3600", []), ("1e-9", ["sched-GS005"])):
        argv = ["graftcheck", "plan", *bench_plan_argv("chr17"), "--topology", "2,4",
                "--sched-budget-seconds", budget, "--json"]
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        report = json.loads(printed.getvalue())
        errors = [i["code"] for i in report["issues"] if i["severity"] == "error"]
        geometry = {k: v for k, v in report["geometry"].items() if k.startswith("sched_")}
        if rc != (2 if want else 0) or errors != want or geometry.get("sched_kernel") != "devicegen":
            raise AssertionError(f"plan chr17 --topology 2,4 --sched-budget-seconds {budget}: "
                                 f"rc {rc}, {printed.getvalue()[-2000:]}")
        log(f"plan chr17 --topology 2,4 --sched-budget-seconds {budget}: rc {rc}, errors "
            f"{errors}, {json.dumps(geometry)}, {wall:.3f} s")
    # The plan takes --check-ranges and proves the configured kernels' ranges.
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["graftcheck", "plan", *bench_plan_argv("large-cohort-sharded"),
                       "--check-ranges"])
    audit_line = next((line.strip() for line in printed.getvalue().splitlines()
                       if "range audit (" in line), None)
    if rc != 0 or audit_line is None:
        raise AssertionError(f"plan large-cohort-sharded --check-ranges: rc {rc}, "
                             f"{printed.getvalue()[-2000:]}")
    log(f"plan large-cohort-sharded --check-ranges: rc 0, {audit_line}")

    # The cost model: the measured rates, then chr17's prediction.
    proc = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch.experiments.cost_rates"],
        capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent,
    )
    if proc.returncode:
        raise AssertionError(f"cost rates failed: {proc.stderr[-2000:]}")
    rates = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"cost rates (a fresh process): {json.dumps(rates)}")
    if not all(math.isfinite(rates[k]) for k in ("cold_seconds", "process_cold_seconds")):
        raise AssertionError(f"cost rates: {rates}")
    log(f"cost rates: a never-built geometry's first run pays {rates['cold_seconds']:.4f} s "
        f"(median of {[round(p, 4) for p in rates['new_geometry_penalties_seconds']]} s; warm "
        f"spread {rates['warm_spread_seconds']:.4f} s); a fresh process's first run pays "
        f"{rates['process_cold_seconds']:.4f} s, not charged by the model ({card_line()})")
    log(f"cost model constants: SITES_PER_SECOND {costmodel.SITES_PER_SECOND}, "
        f"HOST_BYTES_PER_SECOND {costmodel.HOST_BYTES_PER_SECOND}, "
        f"DISPATCH_OVERHEAD_SECONDS {costmodel.DISPATCH_OVERHEAD_SECONDS}, "
        f"COLD_COMPILE_SECONDS {costmodel.COLD_COMPILE_SECONDS}")
    prediction = predict_job_cost(PcaConf.parse(CHR17_ARGV))
    measured = median["without"]
    with tempfile.TemporaryDirectory() as ledger_dir:
        ledger = CalibrationLedger(ledger_dir)
        ledger.record(fingerprint=prediction.fingerprint, kind="pca", job_class="small",
                      predicted_seconds=prediction.predicted_seconds,
                      measured_seconds=measured, queue_wait_seconds=0.0,
                      compile=prediction.compile)
        ratio = ledger.fold.ratio_for(prediction.fingerprint)
        ledger.close()
    log(f"cost chr17: predicted {prediction.predicted_seconds:.4f} s ({prediction.compile}, "
        f"{prediction.sites} sites, compute {prediction.compute_seconds:.4f} s), measured "
        f"{measured:.4f} s; the calibration ledger's measured/predicted ratio {ratio}")
    if ratio is None or not (prediction.predicted_seconds > 0 and math.isfinite(ratio)):
        raise AssertionError(f"cost chr17: prediction {prediction.to_dict()}")
    return launches


# ------------------------------------------------------------ reads examples


def sync(torch, dev) -> None:
    """Wait for ``dev``'s queued work (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def depth_inputs(rng, rows, length, window, max_len, mode="random"):
    """(starts, lengths, codes, quality mask) of ``rows`` synthetic-geometry
    reads around a window at ``DEPTH_WINDOW_START``: starts from a read
    length before the window to past its end. ``mode`` "edges" adds zero,
    negative and over-``max_len`` lengths and codes up to 5; "long" keeps
    lengths past ``max_len`` (cut there); "unknown" makes every code -1,
    "masked" every mask bit false; "sorted" puts the reads in position
    order."""
    starts = rng.integers(DEPTH_WINDOW_START - length, DEPTH_WINDOW_START + window + 50,
                          rows).astype(np.int32)
    lengths = np.full(rows, length if mode == "long" else min(length, max_len), dtype=np.int32)
    codes = rng.integers(0, 4, (rows, max_len)).astype(np.int8)
    codes[:, length:] = -1
    ok = rng.random((rows, max_len)) < QUALITY_PASS_SHARE
    if mode == "edges":
        lengths = rng.integers(-3, 2 * max_len, rows).astype(np.int32)
        codes = rng.integers(-1, 6, (rows, max_len)).astype(np.int8)
    if mode == "unknown":
        codes[:] = -1
    if mode == "masked":
        ok[:] = False
    if mode == "sorted":
        starts.sort()
    return starts, lengths, codes, ok


def chr21_shard_reads():
    """Starts of the reads of one whole-chr21 shard of example 3 at the
    synthetic read geometry (length 100, depth 8): 26,194 reads."""
    from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

    source = SyntheticGenomicsSource(num_samples=1)
    lo = DEPTH_WINDOW_START
    return np.array(sorted(p for p, _ in source.read_starts(lo, lo + CHR21_SHARD_SPAN)),
                    dtype=np.int32)


def phase_depth_kernels(torch, depth, int32_rate, floor_ms, dev="cuda"):
    """``depth_counts`` at a whole-chr21 shard (26,194 reads, W = 327,414 +
    128) and ``base_counts`` at an example-4 shard (4,210 reads x 128, W =
    52,631 + 128), and both at edge shapes, each exactly equal to its
    plain version; then CUDA-event times of each, its plain version and
    ``torch.bincount`` over the valid flattened indices (weighted per base
    for ``base_counts``: its index is position x 4 + base), with the
    bounds: the bytes read and written against one 32-bit atomic per
    counted (read, offset) pair. Returns the two JSON rows."""
    from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms

    rng = np.random.default_rng(21)
    starts = chr21_shard_reads()
    ex4_starts, _, ex4_codes, ex4_ok = depth_inputs(
        rng, EX4_SHARD_READS, 100, EX4_SHARD_SPAN + READ_PAD, READ_PAD)
    rows = {}
    cases = [("chr21 shard", starts, np.full(len(starts), 100, np.int32), None, None,
              CHR21_SHARD_SPAN + READ_PAD, READ_PAD)]
    for label, (n, length, window, max_len, mode) in DEPTH_EDGE_CASES.items():
        s, lengths, codes, ok = depth_inputs(rng, n, length, window, max_len, mode)
        cases.append((label, s, lengths, codes, ok, window, max_len))
    cases.append(("example-4 shard", ex4_starts, None, ex4_codes, ex4_ok,
                  EX4_SHARD_SPAN + READ_PAD, READ_PAD))
    for label, s, lengths, codes, ok, window, max_len in cases:
        pos = torch.from_numpy(s).to(dev)
        if lengths is not None:
            lens = torch.from_numpy(lengths).to(dev)
            got = depth.depth_counts(pos, lens, DEPTH_WINDOW_START, window, max_len)
            want = depth.depth_counts_plain(pos, lens, DEPTH_WINDOW_START, window, max_len)
            sync(torch, dev)
            if not torch.equal(got, want):
                raise AssertionError(f"depth_counts != plain at {label}")
            log(f"kernels: depth_counts == plain ({label}: {len(s)} reads, W {window}, "
                f"max_read_length {max_len}): {int(got.long().sum())} pairs counted")
        if codes is not None:
            codes_t, ok_t = torch.from_numpy(codes).to(dev), torch.from_numpy(ok).to(dev)
            want = depth.base_counts_plain(pos, codes_t, ok_t, DEPTH_WINDOW_START, window)
            # Twice: the second call adds into the buffer the first zeroed.
            for call in (1, 2):
                got = depth.base_counts(pos, codes_t, ok_t, DEPTH_WINDOW_START, window)
                sync(torch, dev)
                if not torch.equal(got, want):
                    raise AssertionError(f"base_counts != plain at {label}, call {call}")
            log(f"kernels: base_counts == plain ({label}: {codes.shape[0]} reads x "
                f"{codes.shape[1]}, W {window}, twice): {int(want.long().sum())} bases counted")
    if torch.device(dev).type != "cuda":
        return rows

    # Times at the examples' shapes: the chr21 shard and the example-4 shard.
    R, W = len(starts), CHR21_SHARD_SPAN + READ_PAD
    pos = torch.from_numpy(starts).to(dev)
    lens = torch.full((R,), 100, dtype=torch.int32, device=dev)
    rel = pos.long() - DEPTH_WINDOW_START
    idx = rel[:, None] + torch.arange(READ_PAD, device=dev)[None, :]
    flat = idx[(torch.arange(READ_PAD, device=dev)[None, :] < lens.long()[:, None])
               & (idx >= 0) & (idx < W)]
    pairs = int(flat.numel())
    rows["depth_counts"] = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: depth.depth_counts(pos, lens, DEPTH_WINDOW_START, W, READ_PAD), 50),
        plain_ms=cuda_ms(lambda: depth.depth_counts_plain(
            pos, lens, DEPTH_WINDOW_START, W, READ_PAD), 10, 1),
        library_ms=cuda_ms(lambda: torch.bincount(flat, minlength=W), 50),
        # Reads positions and lengths once, writes the window; one atomic
        # per counted pair.
        bound=bound(8 * R + 4 * W, pairs, int32_rate),
    )
    r = rows["depth_counts"]
    log(f"kernels: depth_counts at a chr21 shard ({R} reads, W {W}, {pairs} pairs): "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, torch.bincount of the valid "
        f"flattened indices {r['library_ms']:.4f} ms; bound {r['bound'][0]:.6f} ms by "
        f"{r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.2f} % of it)")
    # The designs depth_counts was chosen over, on the same shard.
    from spark_examples_tpu_torch.experiments import depth_variants

    designs = depth_variants.designs(depth_variants.build())
    want = depth.depth_counts_plain(pos, lens, DEPTH_WINDOW_START, W, READ_PAD)
    design_ms = {}
    for name, fn in designs.items():
        if not torch.equal(fn(pos, lens, W, READ_PAD), want):
            raise AssertionError(f"depth design {name!r} != plain at the chr21 shard")
        design_ms[name] = cuda_ms(lambda: fn(pos, lens, W, READ_PAD), 50)
    log("kernels: depth_counts designs at the chr21 shard, each == plain: "
        + ", ".join(f"{name} {t:.4f} ms" for name, t in design_ms.items()))
    R, W = EX4_SHARD_READS, EX4_SHARD_SPAN + READ_PAD
    pos = torch.from_numpy(ex4_starts).to(dev)
    codes_t, ok_t = torch.from_numpy(ex4_codes).to(dev), torch.from_numpy(ex4_ok).to(dev)
    ok_u8 = ok_t.to(torch.uint8)
    idx = pos.long()[:, None] - DEPTH_WINDOW_START + torch.arange(READ_PAD, device=dev)[None, :]
    valid = ok_t & (codes_t >= 0) & (idx >= 0) & (idx < W)
    flat = (idx * 4 + codes_t.long().clamp(0, 3))[valid]
    pairs = int(flat.numel())
    rows["base_counts"] = dict(
        max_abs_err=0, floor_ms=floor_ms,
        ms=cuda_ms(lambda: depth.base_counts(pos, codes_t, ok_u8, DEPTH_WINDOW_START, W), 50),
        plain_ms=cuda_ms(lambda: depth.base_counts_plain(
            pos, codes_t, ok_u8, DEPTH_WINDOW_START, W), 10, 1),
        library_ms=cuda_ms(lambda: torch.bincount(flat, minlength=4 * W), 50),
        # Reads positions, codes and the mask once, writes the (W, 4)
        # counts; one atomic per counted base.
        bound=bound(4 * R + 2 * R * READ_PAD + 16 * W, pairs, int32_rate),
    )
    r = rows["base_counts"]
    log(f"kernels: base_counts at an example-4 shard ({R} reads x {READ_PAD}, W {W}, "
        f"{pairs} bases): {r['ms']:.4f} ms, one launch into the zeroed buffer the last one "
        f"left (launch floor {floor_ms:.4f} ms; plain {r['plain_ms']:.4f} ms, torch.bincount "
        f"of position x 4 + base over the valid bases {r['library_ms']:.4f} ms; bound "
        f"{r['bound'][0]:.6f} ms by {r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.2f} % of "
        f"it)")
    return rows


def phase_count_variants(floor_ms) -> dict:
    """The designs ``case_counts`` and ``base_counts`` were chosen over
    (``experiments/count_variants.py``), each held exactly against the
    plain version at its timed shapes, then timed in turns: one line a
    design, and the first port's ``base_counts`` apart (its zero-fill
    alone, its kernel alone). Returns the measurements."""
    from spark_examples_tpu_torch.experiments import count_variants

    found = count_variants.measure(count_variants.build())
    for rows, designs in found["case_counts"].items():
        for name, ms in designs.items():
            log(f"kernels: case_counts design {name!r} at {rows} rows x "
                f"{count_variants.N_SAMPLES} samples, == plain: {ms:.4f} ms "
                f"(launch floor {floor_ms:.4f} ms)")
    for width, designs in found["base_counts"].items():
        for name, ms in designs.items():
            log(f"kernels: base_counts design {name!r} at an example-4 shard "
                f"({count_variants.EX4_READS} reads x {width}, W {count_variants.EX4_WINDOW}), "
                f"== plain: {ms:.4f} ms (launch floor {floor_ms:.4f} ms)")
    log("kernels: base_counts apart (the zero-fills, the first port's kernel and this one's, "
        "each alone): " + ", ".join(f"{name} {ms:.4f} ms"
                                    for name, ms in found["pieces"].items()))
    return found


class RecordingSource:
    """A source whose clients keep every read they serve, compactly:
    (read group set, reference, position, sequence, quality string as SAM
    writes it, mapping quality, fragment name). The oracles and the SAM
    files are built from exactly the reads an example's run saw."""

    def __init__(self, source):
        self.source = source
        self.reads = []

    def client(self):
        inner, reads = self.source.client(), self.reads

        class Client:
            def search_reads(self, request, boundary):
                for wire in inner.search_reads(request, boundary):
                    alignment = wire["alignment"]
                    reads.append((
                        wire["readGroupSetId"], alignment["position"]["referenceName"],
                        int(alignment["position"]["position"]), wire["alignedSequence"],
                        "".join(chr(q + 33) for q in wire["alignedQuality"]),
                        int(alignment["mappingQuality"]), wire["fragmentName"]))
                    yield wire

        return Client()

    def take(self, in_order=False):
        """The reads served so far, sorted by position (or in the order
        served: one shard's order is the source's); forgets them."""
        got, self.reads[:] = list(self.reads), []
        return got if in_order else sorted(got, key=lambda r: (r[2], r[6]))


def run_example(torch, kernels, label, fn, dev="cuda"):
    """One example run with every launch count set to 0 just before:
    (result, printed lines, wall seconds, launches, peak device memory)."""
    sync(torch, dev)
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        result = fn()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return result, printed.getvalue().splitlines(), wall, launches, peak


def report_example(label, wall, launches, peak, kernel_ms, want):
    """Log a run's wall-clock, depth launches, derived kernel time and peak
    device memory; fail unless each depth kernel launched as ``want``."""
    got = {name: launches[name] for name in want}
    derived = sum(launches[name] * kernel_ms.get(name, 0.0) for name in want)
    log(f"reads {label}: wall {wall:.4f} s, depth launches {json.dumps(got)}, kernels "
        f"{derived:.4f} ms (launches x CUDA-event ms, derived), peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if got != want:
        raise AssertionError(f"reads {label}: launches {got}, want {want}")


def write_sam(path: Path, reads) -> int:
    """SAM text of the recorded reads: FLAG 0, ``<len>M``, MAPQ and QUAL
    (``chr(q + 33)``) as served, no mate."""
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:coordinate\n")
        for _, ref, pos, seq, qual, mapq, name in reads:
            f.write(f"{name}\t0\t{ref}\t{pos + 1}\t{mapq}\t{len(seq)}M\t*\t0\t0\t{seq}\t{qual}\n")
    return len(reads)


def naive_depth_lines(reads) -> str:
    """The part file a naive per-read depth gives: ``(pos,depth)`` for every
    covered position, ascending (``_naive_depth`` of the reference's
    tests, in numpy)."""
    starts = np.array([r[2] for r in reads], dtype=np.int64)
    lengths = np.array([len(r[3]) for r in reads], dtype=np.int64)
    lo = int(starts.min())
    counts = np.zeros(int((starts + lengths).max()) - lo, dtype=np.int64)
    for length in np.unique(lengths):
        sel = starts[lengths == length] - lo
        for off in range(int(length)):
            np.add.at(counts, sel + off, 1)
    covered = np.nonzero(counts)[0]
    return "".join(f"({lo + int(i)},{int(counts[i])})\n" for i in covered)


def naive_diff_lines(normal, tumor, min_mapq=30, min_baseq=30, min_freq=0.25):
    """Example 4's ``(pos,(normalBases,tumorBases))`` lines from the reads in
    numpy: per position base counts of the reads at or above ``min_mapq``,
    bases at or above ``min_baseq``; the sets of bases at or above
    ``min_freq`` of a position's count, joined on the positions both
    readsets cover, where they differ."""
    def counts(reads):
        kept = [r for r in reads if r[5] >= min_mapq]
        lo = min(r[2] for r in kept)
        hi = max(r[2] + len(r[3]) for r in kept)
        table = np.zeros((hi - lo, 4), dtype=np.int64)
        for r in kept:
            seq = np.frombuffer(r[3].encode(), dtype=np.uint8)
            qual = np.frombuffer(r[4].encode(), dtype=np.uint8).astype(np.int64) - 33
            code = np.full(len(seq), -1)
            for i, base in enumerate(b"ACGT"):
                code[seq == base] = i
            sel = (code >= 0) & (qual[:len(seq)] >= min_baseq)
            np.add.at(table, (r[2] - lo + np.nonzero(sel)[0], code[sel]), 1)
        return lo, table

    def frequent(row):
        total = row.sum()
        return "".join("ACGT"[i] for i in range(4) if row[i] / total >= min_freq)

    (lo_n, n), (lo_t, t) = counts(normal), counts(tumor)
    lines = []
    for pos in range(max(lo_n, lo_t), min(lo_n + len(n), lo_t + len(t))):
        a, b = n[pos - lo_n], t[pos - lo_t]
        if a.sum() and b.sum() and frequent(a) != frequent(b):
            lines.append(f"({pos},({frequent(a)},{frequent(b)}))")
    return lines


def phase_variants_examples(torch, kernels):
    """``search-variants-klotho`` at its defaults and ``search-variants-brca1
    --num-samples 17`` through the CLI, and the Klotho example over 10 kb
    around the SNP through ``run_klotho``: each printed line list equal to
    an oracle counting the same source's records in plain Python (one
    STRICT request over the contig), the counts adding up."""
    from spark_examples_tpu_torch.analyses import variants_examples
    from spark_examples_tpu_torch.config import GenomicsConf
    from spark_examples_tpu_torch.constants import GoogleGenomicsPublicData
    from spark_examples_tpu_torch.pipeline.pca_driver import make_source
    from spark_examples_tpu_torch.sharding.contig import Contig

    def oracle(conf, contig, name, klotho):
        set_id = (conf.variant_set_id[0] if conf.variant_set_id
                  else GoogleGenomicsPublicData.PLATINUM_GENOMES)
        records = [r for r in make_source(conf).client().search_variants(
            {"variantSetIds": [set_id], "referenceName": contig.reference_name,
             "start": contig.start, "end": contig.end})
            if re.fullmatch(r"([a-z]*)?([0-9]*)", r["referenceName"])]
        if klotho:
            n_var = sum(1 for r in records if "alternateBases" in r)
        else:
            n_var = sum(1 for r in records if r["referenceBases"] != "N")
        lines = [f"We have {len(records)} records that overlap {name}.",
                 f"But only {n_var} records are of a variant.",
                 f"The other {len(records) - n_var} records are reference-matching blocks."]
        if klotho:
            contig_name = re.fullmatch(r"([a-z]*)?([0-9]*)", contig.reference_name).group(2)
            lines += [f"Reference: {contig_name} @ {r['start']}" for r in records
                      if r["referenceBases"] != "N"]
        return lines, len(records), n_var

    wide = Contig("chr13", variants_examples.KLOTHO_CONTIG.start - KLOTHO_WIDE // 2,
                  variants_examples.KLOTHO_CONTIG.start + KLOTHO_WIDE // 2)
    for label, argv, contig, name, klotho in (
        ("klotho", [], variants_examples.KLOTHO_CONTIG, "Klotho", True),
        ("klotho 2 kb", None, wide, "Klotho", True),
        ("brca1", ["--num-samples", "17"], variants_examples.BRCA1_CONTIG, "BRCA1", False),
    ):
        if argv is None:
            conf = GenomicsConf.parse([])
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                printed = variants_examples.run_klotho(conf, make_source(conf), wide)
            wall = time.perf_counter() - t0
        else:
            verb = "search-variants-klotho" if klotho else "search-variants-brca1"
            wall, _, printed = run_cli(torch, kernels, [verb, *argv], f"variants {label}")
            conf = GenomicsConf.parse(argv)
        want, total, n_var = oracle(conf, contig, name, klotho)
        if printed != want:
            raise AssertionError(f"variants {label}: printed {printed[:4]} != oracle {want[:4]}")
        numbers = [int(printed[i].split()[j]) for i, j in ((0, 2), (1, 2), (2, 2))]
        if numbers != [total, n_var, total - n_var]:
            raise AssertionError(f"variants {label}: counts {numbers} do not add up")
        log(f"variants {label}: {len(printed)} lines equal the oracle's ({total} records = "
            f"{n_var} variant + {total - n_var} reference blocks), wall {wall:.4f} s")


def phase_reads_examples(torch, depth, kernels, kernel_ms, dev="cuda"):
    """The four reads examples through ``reads_examples.run_example*`` on
    the synthetic source (the CLI's seed; length 100, depth 8), each read
    kept as served for its oracle: example 1 at the default SNP (the JAX
    package raises there), example 2 over ``EX2_REGION``, example 3 over
    ``EX3_REGION`` (two shards, the carry between them), example 4 over
    ``EX4_REGION`` (four shards, normal and tumor). Returns the reads of
    examples 3 and 4, the synthetic outputs and the launches for the
    ``kernels`` line."""
    from spark_examples_tpu_torch.analyses import reads_examples
    from spark_examples_tpu_torch.config import GenomicsConf
    from spark_examples_tpu_torch.constants import Examples
    from spark_examples_tpu_torch.pipeline.pca_driver import make_source

    out_dir = DATA_DIR / "reads_synthetic"
    conf = GenomicsConf.parse(["--device", str(dev), "--output-path", str(out_dir)])
    source = RecordingSource(make_source(conf))
    none = {"depth_counts": 0, "base_counts": 0}

    snp = Examples.CILANTRO
    lines, _, wall, launches, peak = run_example(
        torch, kernels, "example 1", lambda: reads_examples.run_example1(conf, source), dev)
    reads = source.take(in_order=True)  # one shard: the pileup's order
    covering = [r for r in reads if r[2] <= snp < r[2] + len(r[3])]
    first = min(r[2] for r in covering)
    want = [" " * (snp - first) + "v"]
    for _, _, pos, seq, qual, _, _ in covering:
        i = snp - pos
        want.append(" " * (pos - first) + seq[: i + 1] + f"({ord(qual[i]) - 33:02d}) "
                    + seq[i + 1:])
    want.append(" " * (snp - first) + "^")
    marker = len(lines[0]) - 1
    if lines != want or any(line.index("(") - 1 != marker for line in lines[1:-1]):
        raise AssertionError("example 1: the pileup differs from the half-open oracle")
    ending_before = sum(1 for r in reads if r[2] + len(r[3]) == snp)
    log(f"reads example 1: {len(covering)} reads cover {snp} (half-open), each quality "
        f"under the 'v'; {ending_before} read(s) end at snp - 1, where the JAX package "
        f"indexes past the read")
    report_example("example 1", wall, launches, peak, kernel_ms, none)

    coverage, _, wall, launches, peak = run_example(
        torch, kernels, "example 2",
        lambda: reads_examples.run_example2(conf, source, region=EX2_REGION), dev)
    reads = source.take()
    starts = [p for p, _ in make_source(conf).read_starts(*EX2_REGION)]
    want = sum(len(r[3]) for r in reads) / float(Examples.HUMAN_CHROMOSOMES["21"])
    if coverage != want or sorted(starts) != [r[2] for r in reads]:
        raise AssertionError(f"example 2: coverage {coverage} != {want} over {len(reads)} reads")
    log(f"reads example 2: coverage {coverage!r} = Σ lengths / chr21 length over "
        f"{len(reads)} reads")
    report_example("example 2", wall, launches, peak, kernel_ms, none)

    part, _, wall, launches, peak = run_example(
        torch, kernels, "example 3",
        lambda: reads_examples.run_example3(conf, source, region=EX3_REGION), dev)
    ex3_reads = source.take()
    ex3_text = Path(part).read_text()
    if ex3_text != naive_depth_lines(ex3_reads):
        raise AssertionError("example 3: the part file differs from the naive depth")
    log(f"reads example 3: part file ({len(ex3_text)} bytes, {ex3_text.count(chr(10))} "
        f"positions) byte-identical to the naive depth over {len(ex3_reads)} reads")
    report_example("example 3", wall, launches, peak, kernel_ms,
                   {"depth_counts": 2, "base_counts": 0})
    ex3_launches = launches

    diff, _, wall, launches, peak = run_example(
        torch, kernels, "example 4",
        lambda: reads_examples.run_example4(conf, source, region=EX4_REGION), dev)
    ex4_reads = source.take()
    normal = [r for r in ex4_reads if r[0] == Examples.GOOGLE_DREAM_SET3_NORMAL]
    tumor = [r for r in ex4_reads if r[0] == Examples.GOOGLE_DREAM_SET3_TUMOR]
    if not diff or diff != naive_diff_lines(normal, tumor):
        raise AssertionError(f"example 4: {len(diff)} diff lines differ from the numpy oracle")
    log(f"reads example 4: {len(diff)} diff lines equal the numpy oracle's over "
        f"{len(normal)} normal and {len(tumor)} tumor reads; the first {diff[0]}")
    report_example("example 4", wall, launches, peak, kernel_ms,
                   {"depth_counts": 0, "base_counts": 8})
    ex4_text = (out_dir / "diff_1" / "part-00000").read_text()
    return (ex3_reads, ex3_text, normal, tumor, ex4_text,
            {"depth_counts": ex3_launches["depth_counts"],
             "base_counts": launches["base_counts"]})


def shards_with_reads(readsets, region, shards) -> int:
    """(readset, shard) pairs holding a read of mapping quality >= 30, over
    ``shards`` equal spans of ``region``: example 4's launches."""
    span = (region[1] - region[0]) // shards
    return sum(len({(r[2] - region[0]) // span for r in reads if r[5] >= 30})
               for reads in readsets)


def phase_reads_sam(torch, kernels, kernel_ms, ex3_reads, ex3_text, normal, tumor, ex4_text,
                    dev="cuda"):
    """Examples 3 and 4 through the CLI with ``--source file`` at their
    defaults (all of chr21: 147 shards; 1 Mb of chr1: 19 shards) on SAM
    files of the synthetic runs' reads: each output byte-identical to the
    synthetic run's."""
    DATA_DIR.mkdir(exist_ok=True)
    sams = {name: DATA_DIR / f"{name}.sam" for name in ("ex3_reads", "ex4_normal", "ex4_tumor")}
    t0 = time.perf_counter()
    for name, reads in (("ex3_reads", ex3_reads), ("ex4_normal", normal), ("ex4_tumor", tumor)):
        write_sam(sams[name], reads)
    log(f"reads sam: {len(ex3_reads)} + {len(normal)} + {len(tumor)} reads written in "
        f"{time.perf_counter() - t0:.1f} s, {sum(p.stat().st_size for p in sams.values())} bytes")
    for label, argv, got_path, want, expect in (
        ("example 3", ["search-reads-example-3", "--input-files", str(sams["ex3_reads"])],
         "coverage_21", ex3_text, {"depth_counts": 2, "base_counts": 0}),
        ("example 4", ["search-reads-example-4", "--input-files",
                       f"{sams['ex4_normal']},{sams['ex4_tumor']}"],
         "diff_1", ex4_text, {"depth_counts": 0, "base_counts": shards_with_reads(
             (normal, tumor), EX4_DEFAULT_REGION, EX4_DEFAULT_SHARDS)}),
    ):
        out = DATA_DIR / f"reads_sam_{label.split()[-1]}"
        device = [] if dev == "cuda" else ["--device", str(dev)]
        torch.cuda.reset_peak_memory_stats()
        wall, launches, _ = run_cli(torch, kernels, [*argv[:1], "--source", "file", *argv[1:],
                                                     "--output-path", str(out), *device],
                                    f"sam {label}")
        peak = torch.cuda.max_memory_allocated()
        report_example(f"sam {label}", wall, launches, peak, kernel_ms, expect)
        text = (out / got_path / "part-00000").read_text()
        if text != want:
            raise AssertionError(f"sam {label}: the output differs from the synthetic run's")
        log(f"reads sam {label}: part file ({len(text)} bytes) byte-identical to the "
            f"synthetic run's")


def phase_ring_kernels(torch, devicegen, gramian):
    """The ring's two kernels against their plain versions, exactly:
    ``cross_accumulate`` at ``CROSS_SHAPES`` into a column slice of a row
    tile of 4 positions' width (so C's rows are strided), ``pack_rows_t``
    on a generated slice's Xᵀ and on a 6,256-column one (also against
    ``np.packbits``), and ``unpack_rows_t`` of each packed tile back (the
    receiver's); then their times beside the bound, the plain version and,
    for the product, ``torch._int_mm`` on the same (row-padded) operands
    plus the slice add, with each launch's shape. Also times
    ``gen_genotypes`` on one position's cut tables (632 columns of 2,504).
    Returns the JSON rows (the product at chr17's 16,384 sites, the pack at
    632 columns × 16,384) and the times by shape."""
    from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
    from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    rows, times = {}, {}
    for m, n, sites in CROSS_SHAPES:
        m_pad, n_pad = -(-m // 128) * 128, -(-n // 128) * 128
        a = (torch.rand((m_pad, sites), device=dev, generator=gen) < 0.3).to(torch.int8)
        b = (torch.rand((n_pad, sites), device=dev, generator=gen) < 0.3).to(torch.int8)
        tile = torch.randint(-9, 9, (m, 4 * n), device=dev, generator=gen, dtype=torch.int32)
        want = tile.clone()
        devicegen.cross_accumulate(tile[:, n : 2 * n], a, b)
        devicegen.cross_accumulate_plain(want[:, n : 2 * n], a, b)
        torch.cuda.synchronize()
        err = int((tile.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"cross_accumulate != plain at {m} x {n} x {sites}: max err {err}")
        del want
        schedule, resident = devicegen.cross_accumulate_grid(m_pad, n_pad, sites, dev)
        C = tile[:, n : 2 * n]
        big = m * sites > 10**8
        r = times[(m, n, sites)] = dict(
            max_abs_err=0,
            ms=cuda_ms(lambda: devicegen.cross_accumulate(C, a, b), 20),
            # The float64 product of the largest shape is timed once.
            plain_ms=cuda_ms(lambda: devicegen.cross_accumulate_plain(C, a, b), *((1, 0) if big else (3, 1))),
            library_ms=cuda_ms(lambda: C.add_(torch._int_mm(a, b.t())[:m, :n]), 20),
            bound=bound(m * sites + n * sites + 2 * 4 * m * n, 2.0 * m * n * sites,
                        PEAK_INT8_OPS_PER_S),
        )
        log(f"kernels: cross_accumulate == plain at {m} x {n} x {sites} sites (C a column slice "
            f"of a {m} x {4 * n} row tile): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"torch._int_mm + add {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} % of it); launch: "
            f"{schedule.blocks} blocks in clusters of {schedule.cluster} ({resident} clusters "
            f"resident), {schedule.rows}-row blocks, split {schedule.split}, {schedule.units} "
            f"units, {schedule.items} items")
        del tile, C, a, b
    rows["cross_accumulate"] = times[(632, 632, BLOCK)]

    source = SyntheticGenomicsSource(num_samples=N_SAMPLES)
    plan = devicegen.make_gen_plan(
        [source.genotype_stream_key("chip-smoke")], [source.populations],
        source.site_key, source.variant_spacing, source.ref_block_fraction,
        None, source.n_pops, dev,
    )
    cut = devicegen.slice_gen_plan(plan, 632, 1264)
    kept, vrows = (torch.zeros(s, dtype=torch.int64, device=dev) for s in ((), (1,)))
    xt = devicegen.gen_genotypes(cut, 400_000, BLOCK, BLOCK, kept, vrows)
    kept_p, vrows_p = torch.zeros_like(kept), torch.zeros_like(vrows)
    if not torch.equal(xt, devicegen.gen_genotypes_plain(cut, 400_000, BLOCK, BLOCK, kept_p, vrows_p)):
        raise AssertionError("gen_genotypes on a samples slice != plain")
    kept_n = int(kept)
    r = dict(
        ms=cuda_ms(lambda: devicegen.gen_genotypes(cut, 400_000, BLOCK, BLOCK, kept, vrows), 50),
        plain_ms=cuda_ms(lambda: devicegen.gen_genotypes_plain(cut, 400_000, BLOCK, BLOCK, kept, vrows), 3, 1),
        library_ms=None,
        bound=bound(632 * BLOCK, 632 * kept_n * GEN_OPS_PER_GENOTYPE, int32_ops_per_s(torch)),
    )
    log(f"kernels: gen_genotypes == plain on a samples slice (columns 632..1263 of 2,504, "
        f"{BLOCK} sites, {kept_n} kept): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound'][0]:.4f} ms by {r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} % of it)")
    times["gen_genotypes slice"] = r

    xts = {632: xt[:640]}
    wide = RING_TILE_COLUMNS[1]
    xts[wide] = (torch.rand((-(-wide // 128) * 128, BLOCK), device=dev, generator=gen)
                 < 0.3).to(torch.int8)
    for cols, x in xts.items():
        got = gramian.pack_rows_t(x, cols, BLOCK)
        torch.cuda.synchronize()
        if not (torch.equal(got, gramian.pack_rows_t_plain(x, cols, BLOCK)) and np.array_equal(
                got.cpu().numpy(), np.packbits(x[:cols].cpu().numpy().T, axis=-1))):
            raise AssertionError(f"pack_rows_t != plain or np.packbits at {cols} columns")
        schedule = gramian.pack_rows_t_grid(BLOCK, cols)
        r = times[f"pack_rows_t {cols}"] = dict(
            max_abs_err=0,
            ms=cuda_ms(lambda: gramian.pack_rows_t(x, cols, BLOCK), 50),
            plain_ms=cuda_ms(lambda: gramian.pack_rows_t_plain(x, cols, BLOCK), 5, 1),
            library_ms=None,
            bound=bound(cols * BLOCK + BLOCK * cols // 8, 0, int32_ops_per_s(torch)),
        )
        log(f"kernels: pack_rows_t == plain == np.packbits ({cols} columns x {BLOCK} sites"
            f"{' of a generated slice' if cols == 632 else ''}): {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by bytes, "
            f"{100 * r['bound'][0] / r['ms']:.1f} % of it); launch: {schedule.site_blocks} x "
            f"{schedule.row_blocks} blocks of {schedule.sites} sites x {schedule.share} bytes")
        # The receiver's unpack of the same packed tile (the ring's).
        back = gramian.unpack_rows_t(got, cols)
        torch.cuda.synchronize()
        if not torch.equal(back[:cols, :BLOCK], x[:cols, :BLOCK]) or back[cols:].any():
            raise AssertionError(f"unpack_rows_t of a packed ring tile != its Xᵀ at {cols} columns")
        r = times[f"unpack_rows_t ring {cols}"] = dict(
            max_abs_err=0,
            ms=cuda_ms(lambda: gramian.unpack_rows_t(got, cols), 50),
            plain_ms=cuda_ms(lambda: gramian.unpack_rows_t_plain(got, cols), 5, 1),
            library_ms=None,
            bound=bound(BLOCK * cols // 8 + -(-cols // 128) * 128 * BLOCK, 0, int32_ops_per_s(torch)),
        )
        log(f"kernels: unpack_rows_t of a packed ring tile == its Xᵀ ({cols} columns x {BLOCK} "
            f"sites): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} "
            f"ms by bytes, {100 * r['bound'][0] / r['ms']:.1f} % of it)")
    rows["pack_rows_t"] = times["pack_rows_t 632"]

    # The unpacked wire's rows of the same generated slice: 626 columns,
    # a position's share of 2,504 over 4 on that wire.
    cols, x = N_SAMPLES // 4, xts[632]
    got = gramian.transpose_rows_t(x, cols, BLOCK)
    torch.cuda.synchronize()
    if not (torch.equal(got, gramian.transpose_rows_t_plain(x, cols, BLOCK)) and np.array_equal(
            got.cpu().numpy(), x[:cols, :BLOCK].cpu().numpy().T.view(np.uint8))):
        raise AssertionError(f"transpose_rows_t != plain or numpy at {cols} columns")
    back = gramian.unpack_rows_t(got, cols, counts=True, max_count=1)
    torch.cuda.synchronize()
    if not torch.equal(back[:cols, :BLOCK], x[:cols, :BLOCK]) or back[cols:].any():
        raise AssertionError(f"unpack_rows_t of an unpacked ring tile != its Xᵀ at {cols} columns")
    r = rows["transpose_rows_t"] = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: gramian.transpose_rows_t(x, cols, BLOCK), 50),
        plain_ms=cuda_ms(lambda: gramian.transpose_rows_t_plain(x, cols, BLOCK), 5, 1),
        library_ms=cuda_ms(lambda: x[:cols, :BLOCK].T.contiguous(), 50),
        bound=bound(2 * cols * BLOCK, 0, int32_ops_per_s(torch)),
    )
    log(f"kernels: transpose_rows_t == plain == numpy ({cols} columns x {BLOCK} sites of a "
        f"generated slice): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, .T.contiguous() "
        f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by bytes, "
        f"{100 * r['bound'][0] / r['ms']:.1f} % of it)")
    return rows, times


def run_sharded(torch, kernels, argv, label, devices, expect, want_g, check_pcs=True):
    """One ``variants-pca`` run through ``run_pipeline`` over ``devices``
    (positions of one card), every launch count set to zero just before;
    fails unless each kernel of ``expect`` launched, the Gramian (the row
    tiles gathered, or the data axis's sum) equals ``want_g`` (a CUDA
    tensor of the one-device run) byte for byte, the ring's measured bytes
    equal its projection, and (``check_pcs``) the PCs agree with a full
    ``eigh`` of the centred Gramian. Returns the launch counts."""
    from spark_examples_tpu_torch.config import PcaConf
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
        result = run_pipeline(conf, devices=devices)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    driver = result.driver
    stages = {s["path"]: s["seconds"] for s in driver.spans.flat()}
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        raise AssertionError(f"sharded {label} never launched {missing}")
    acc = driver.accumulator
    n = len(driver.indexes)
    if hasattr(acc, "layout"):
        equal, start = True, 0
        for tile in acc.layout.finalize_tiles().tiles:
            rows = max(0, min(tile.shape[0], n - start))
            equal = equal and torch.equal(tile[:rows, :n].to(want_g.dtype), want_g[start : start + rows])
            equal = equal and not tile[rows:].any() and not tile[:, n:].any()
            start += tile.shape[0]
    else:
        equal = torch.equal(acc.G.to(want_g.dtype), want_g)
    if not equal:
        raise AssertionError(f"sharded {label}: Gramian != the one-device run's")
    sched = driver.sched_block
    if sched is not None and sched["measured_ring_bytes"] != sched["predicted_ring_bytes"]:
        raise AssertionError(f"sharded {label}: measured ring bytes != predicted: {sched}")
    gap = float("nan")
    if check_pcs:
        got = np.array([[float(v) for v in line.split("\t")[2:]] for line in result.lines])
        if got.shape != (n, conf.num_pc) or not np.isfinite(got).all():
            raise AssertionError(f"sharded {label}: PCs of shape {got.shape} or not finite")
        full, _ = principal_components(gower_center(want_g), conf.num_pc)
        full = full.cpu().numpy()
        by_name = {driver.names[cs]: full[i] for cs, i in driver.indexes.items()}
        gap = float(np.abs(got - np.array([by_name[k] for k in sorted(by_name)])).max())
        if gap > PC_TOLERANCE:
            raise AssertionError(f"sharded {label}: PCs differ from the full eigh by {gap}")
    log(f"sharded {label}: wall {wall:.4f} s, stages {json.dumps(stages)}, launches "
        f"{json.dumps(launches)}, peak device memory {peak / 2**20:.1f} MiB ({held / 2**20:.1f} "
        f"MiB held before), Gramian == one-device run's, schedule {json.dumps(sched)}, "
        f"max |PC - eigh PC| {gap:.3e}")
    return launches


def phase_sharded(torch, kernels, one_device):
    """``SHARDED_RUNS`` over four positions of cuda:0 against the one-device
    Gramians (``one_device``: chr17's and the packed cell's). Returns the
    launch counts of the first device-generation ring and of the one on
    the unpacked wire."""
    from spark_examples_tpu_torch.parallel.mesh import HIER_HOSTS_ENV

    dev = torch.device("cuda", 0)
    argvs = {"chr17": CHR17_ARGV, "packed": PACKED_ARGV}
    expects = {
        "chr17": ("gen_genotypes", "pack_rows_t", "unpack_rows_t", "cross_accumulate"),
        "packed": ("unpack_rows_t", "cross_accumulate"),
    }
    first = unpacked = None
    for label, base, flags, hosts in SHARDED_RUNS:
        expect = expects[base]
        if "off" in flags:
            expect = (("gen_genotypes", "transpose_rows_t") if base == "chr17" else ()) + (
                "unpack_rows_t", "cross_accumulate")
        if "--similarity-strategy" not in flags:
            expect = ("gen_genotypes", "gram_accumulate")
        if hosts:
            os.environ[HIER_HOSTS_ENV] = str(hosts)
        try:
            launches = run_sharded(torch, kernels, argvs[base] + flags, label, [dev] * 4, expect,
                                   one_device[base])
        finally:
            os.environ.pop(HIER_HOSTS_ENV, None)
        first = first or launches
        if base == "chr17" and "off" in flags:
            unpacked = launches
    return first, unpacked


def phase_ring_schedule(torch):
    """One block of the host-fed ring at chr17's geometry (2,504 samples,
    16,384 rows, ``1,4``, packed wire) through ``ShardedGramianAccumulator``
    on four positions of cuda:0, three times: unrecorded, recorded and
    unrecorded again
    (``obs/schedule.py``): the recorded ops must be the device-free audit's
    (``check/ir.py:ring_kernel_spec`` on ``meta`` tensors, as ``graftcheck
    plan`` runs it) op for op — name, role, position, each tile's dtype and
    shape — with 3 shifts a position, the shifted bytes equal to the
    ``gramian_ring_bytes`` increment and to ``ring_traffic_bytes``, the
    audit clean, and each block's row tiles equal to the block's Gramian
    (a float32 product on the card, exact below 2^24). ``graftcheck
    ranges`` over the card's recorded block must prove one partial an
    entry (``BLOCK``), as over the meta audit's."""
    from spark_examples_tpu_torch.check.ir import Trace, audit_kernel, ring_kernel_spec, trace_kernel
    from spark_examples_tpu_torch.check.ranges import audit_range_kernel, ring_range_spec
    from spark_examples_tpu_torch.obs import schedule
    from spark_examples_tpu_torch.obs.metrics import GRAMIAN_RING_BYTES, MetricsRegistry
    from spark_examples_tpu_torch.ops.gramian import ShardedGramianAccumulator, sharded_peak_bytes
    from spark_examples_tpu_torch.parallel.mesh import make_mesh, ring_traffic_bytes

    dev = torch.device("cuda", 0)
    rows = (np.random.default_rng(17).random((BLOCK, N_SAMPLES)) < 0.05).astype(np.uint8)
    x = torch.from_numpy(rows).to(dev, torch.float32)
    want = (x.T @ x).to(torch.int32)
    del x
    walls, results = {}, {}
    # The first block also makes the positions' streams and checks the
    # product's launch shapes: it is timed apart.
    for label in ("first", "recorded", "unrecorded"):
        registry = MetricsRegistry()
        acc = ShardedGramianAccumulator(N_SAMPLES, make_mesh({"data": 1, "samples": 4}, [dev] * 4),
                                        block_size=BLOCK, registry=registry, pack_bits="on",
                                        reduce_schedule="flat")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with schedule.recording() if label == "recorded" else contextlib.nullcontext() as sched:
            acc.add_rows(rows)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        tiles = acc.layout.finalize_tiles().tiles
        got = torch.cat([t.to(dev) for t in tiles])[:N_SAMPLES, :N_SAMPLES]
        if not torch.equal(got, want):
            raise AssertionError(f"ring schedule: the {label} block's Gramian != XᵀX")
        keys = {schedule.storage_key(t)[0] for row in acc.layout.G_local for t in row}
        results[label] = (sched, registry.value(GRAMIAN_RING_BYTES), keys)
        del acc, tiles, got
    sched, counted, keys = results["recorded"]
    spec = ring_kernel_spec(1, 4, N_SAMPLES, BLOCK, True, device="meta")
    t0 = time.perf_counter()
    meta = trace_kernel(spec)
    audit = audit_kernel(spec, traced=meta)
    audit_wall = time.perf_counter() - t0
    card_ops = [op.signature() for op in sched.ops]
    meta_ops = [op.signature() for op in meta.ops]
    if card_ops != meta_ops:
        at = next((i for i, (a, b) in enumerate(zip(card_ops, meta_ops)) if a != b),
                  min(len(card_ops), len(meta_ops)))
        raise AssertionError(f"ring schedule: op {at} is {card_ops[at:at + 1]} on the card, "
                             f"{meta_ops[at:at + 1]} in the audit ({len(card_ops)} ops against "
                             f"{len(meta_ops)})")
    shifts = [op for op in sched.ops if op.role == "shift"]
    calls = len({op.call for op in shifts})
    recorded = sum(op.results[0].nbytes for op in shifts)
    formula = ring_traffic_bytes(BLOCK, 4, spec.n_local, True)
    if (calls, recorded, counted) != (3, formula, formula) or not audit.ok:
        raise AssertionError(f"ring schedule: {calls} shifts, {recorded} bytes recorded, "
                             f"{counted} counted, formula {formula}; audit "
                             f"{[f.format() for f in audit.findings]}")
    card = Trace(list(sched.ops), [], keys, set(), set(), [])
    proved = {name: audit_range_kernel(ring_range_spec(1, 4, N_SAMPLES, BLOCK, True, True),
                                       traced=trace)
              for name, trace in (("card", card), ("meta", meta))}
    increments = {name: a.facts.get("entry_increment") for name, a in proved.items()}
    if any(not a.ok for a in proved.values()) or set(increments.values()) != {BLOCK}:
        raise AssertionError(f"ring schedule: the range audit proves {increments}: "
                             f"{[f.format() for a in proved.values() for f in a.findings]}")
    roles = {}
    for op in sched.ops:
        roles[op.role] = roles.get(op.role, 0) + 1
    log(f"ring schedule: one block of the chr17 ring at 1,4 ({N_SAMPLES} samples x {BLOCK} "
        f"rows, packed) recorded on the card: {len(card_ops)} ops {json.dumps(roles)} == the "
        f"device-free audit's on meta, {calls} shifts, {recorded} bytes == gramian_ring_bytes == "
        f"ring_traffic_bytes; block wall {walls['recorded']:.4f} s recorded, "
        f"{walls['unrecorded']:.4f} s unrecorded after it ({walls['first']:.4f} s the "
        f"first block, unrecorded); the meta audit {audit_wall:.3f} s, peak live "
        f"{audit.facts['peak_live_bytes']} B a position against sharded_peak_bytes "
        f"{sharded_peak_bytes(spec.n_local, 4 * spec.n_local, BLOCK, True)} B; Gramian == XᵀX; "
        f"graftcheck ranges over the card's block and the meta audit's: entry increment "
        f"{increments['card']:g} == {increments['meta']:g} ({card_line()})")
    ring_schedule_hier(torch)


#: The blocks of the device-generation ring's one recorded dispatch.
HIER_DISPATCH_BLOCKS = 2


def ring_schedule_hier(torch, dev=None):
    """The two-level rings at chr17's width on four positions of cuda:0
    (``1,4``, ``SPARK_EXAMPLES_TPU_HIER_HOSTS=2``: a declared 2x2 fleet,
    packed wire), recorded: one block of the host-fed ring (its Gramian
    == XᵀX) and one dispatch of the device-generation ring
    (``HIER_DISPATCH_BLOCKS`` blocks of 16,384 sites; its row tiles byte-
    equal to the flat ring's over the same dispatch, unrecorded). Each
    recording's shift calls, placed on their link class by their hops'
    senders (``check/sched.py:extract_schedule``), must split ICI and DCN
    bytes and steps exactly as ``graftcheck sched``'s device-free
    recording of the same subject (``audit_schedule(Topology(2, 2),
    "hier", ...)``: ``meta`` positions for the host-fed ring, CPU ones for
    the generation ring), which must be clean; the host-fed ring's ops
    must be the device-free ones op for op."""
    from spark_examples_tpu_torch.check.ir import Trace, trace_kernel
    from spark_examples_tpu_torch.check.sched import (
        audit_schedule,
        extract_schedule,
        schedule_kernel_spec,
    )
    from spark_examples_tpu_torch.obs import schedule
    from spark_examples_tpu_torch.ops.devicegen import DeviceGenRingGramianAccumulator
    from spark_examples_tpu_torch.ops.gramian import ShardedGramianAccumulator
    from spark_examples_tpu_torch.parallel.mesh import HIER_HOSTS_ENV, Topology, make_mesh
    from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

    dev = torch.device("cuda", 0) if dev is None else dev
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    topo = Topology(2, 2)
    rows = (np.random.default_rng(27).random((BLOCK, N_SAMPLES)) < 0.05).astype(np.uint8)
    x = torch.from_numpy(rows).to(dev, torch.float32)
    want = (x.T @ x).to(torch.int32)
    del x
    source = SyntheticGenomicsSource(num_samples=N_SAMPLES)

    def device_ring(reduce_schedule):
        return DeviceGenRingGramianAccumulator(
            N_SAMPLES, (source.genotype_stream_key("chip-smoke"),), source.populations,
            source.site_key, source.variant_spacing, source.ref_block_fraction,
            make_mesh({"data": 1, "samples": 4}, [dev] * 4), block_size=BLOCK,
            blocks_per_dispatch=HIER_DISPATCH_BLOCKS, n_pops=source.n_pops, pack_bits="on",
            reduce_schedule=reduce_schedule)

    span = HIER_DISPATCH_BLOCKS * BLOCK
    os.environ[HIER_HOSTS_ENV] = "2"
    try:
        acc = ShardedGramianAccumulator(N_SAMPLES, make_mesh({"data": 1, "samples": 4}, [dev] * 4),
                                        block_size=BLOCK, pack_bits="on", reduce_schedule="hier")
        with schedule.recording() as host_fed:
            acc.add_rows(rows)
        sync()
        got = torch.cat([t.to(dev) for t in acc.layout.finalize_tiles().tiles])
        if acc.layout.ring_hosts != 2 or not torch.equal(got[:N_SAMPLES, :N_SAMPLES], want):
            raise AssertionError("ring schedule (hier): the block's Gramian != XᵀX")
        host_keys = {schedule.storage_key(t)[0] for row in acc.layout.G_local for t in row}
        del acc, got
        hier = device_ring("hier")
        with schedule.recording() as generated:
            hier.add_grid(0, span)
        sync()
        gen_keys = {schedule.storage_key(t)[0] for row in hier.layout.G_local for t in row}
        hier_tiles = hier.layout.finalize_tiles().tiles
    finally:
        os.environ.pop(HIER_HOSTS_ENV, None)
    flat = device_ring("flat")
    flat.add_grid(0, span)
    sync()
    flat_tiles = flat.layout.finalize_tiles().tiles
    if hier.layout.ring_hosts != 2 or not all(
            torch.equal(a.to(dev), b.to(dev)) for a, b in zip(hier_tiles, flat_tiles)):
        raise AssertionError("ring schedule (hier): the generation ring's tiles != the flat ring's")
    del hier, flat, hier_tiles, flat_tiles
    for label, sched, keys, kernel, blocks, device in (
        ("host-fed", host_fed, host_keys, "gramian", 1, "meta"),
        ("device-generation", generated, gen_keys, "devicegen", HIER_DISPATCH_BLOCKS, "cpu"),
    ):
        spec = schedule_kernel_spec(topo, "hier", N_SAMPLES, BLOCK, kernel=kernel,
                                    blocks_per_dispatch=blocks, device=device)
        card = extract_schedule(Trace(list(sched.ops), [], keys, set(), set(), []), spec, topo,
                                "hier")
        t0 = time.perf_counter()
        if kernel == "gramian":
            free = trace_kernel(spec, watch=False)
            audit = audit_schedule(topo, "hier", N_SAMPLES, BLOCK, device=device, traced=free)
            card_ops = [op.signature() for op in sched.ops]
            if card_ops != [op.signature() for op in free.ops]:
                raise AssertionError(f"ring schedule (hier): the card's {len(card_ops)} ops are "
                                     f"not the device-free recording's {len(free.ops)}")
        else:
            audit = audit_schedule(topo, "hier", N_SAMPLES, BLOCK, kernel=kernel)
        wall = time.perf_counter() - t0
        on_card = {"ici_bytes": card.mesh_bytes()["ici"], "dcn_bytes": card.mesh_bytes()["dcn"],
                   "ici_steps": card.step_counts()["ici"], "dcn_steps": card.step_counts()["dcn"]}
        free_facts = {k: audit.facts[k] for k in on_card}
        if on_card != free_facts or not audit.ok or card.overlap_holes():
            raise AssertionError(f"ring schedule (hier, {label}): the card's split {on_card}, "
                                 f"the device-free audit's {free_facts}; "
                                 f"{[f.format() for f in audit.findings]}")
        log(f"ring schedule (hier 2x2, {label}, {N_SAMPLES} samples x {blocks} x {BLOCK} rows, "
            f"packed): recorded on the card, {len(sched.ops)} ops, each shift call placed by "
            f"its hops' senders: {json.dumps(on_card)} == graftcheck sched's device-free "
            f"recording ({audit.facts['formula_ici_bytes']} / "
            f"{audit.facts['formula_dcn_bytes']} B by the formula), every step overlapped; the "
            f"device-free audit {wall:.3f} s, clean ({card_line()})")


#: ``--check-ranges`` on the host-fed arms, each run with and without the
#: flag: (label, argv, positions of cuda:0 or ``None`` for the CLI's one
#: device).
CHECK_RANGES_RUNS = (
    ("packed", PACKED_ARGV, None),
    ("packed ring 1,4", PACKED_ARGV + MESH_FLAGS, 4),
)


def phase_check_ranges(torch, kernels):
    """``--check-ranges`` on the packed cell and the host-fed packed ring at
    1,4 (positions of cuda:0), each without and with the flag, every
    launch count set to zero before each run: the Gramians must be
    byte-equal; with the flag the manifest's ``gramian_exactness`` must
    hold ``entry_max`` = the Gramian's largest entry ≤
    ``static_entry_bound`` and its ``conformance.ranges`` pair must be ok,
    without it the block is null. Logs the two walls (the flag's cost: one
    device read a flush) and the products' launches."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.obs.manifest import read_manifest, validate_manifest
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    dev = torch.device("cuda", 0)
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    for label, argv, positions in CHECK_RANGES_RUNS:
        walls, grams, launches, blocks = {}, {}, {}, {}
        for flag in ("", "--check-ranges"):
            path = DATA_DIR / f"manifest_check_ranges{flag.replace('-', '_')}.json"
            conf = PcaConf.parse(argv + ([flag] if flag else []) + ["--metrics-json", str(path)])
            torch.cuda.synchronize()
            reset_counts(kernels)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                result = run_pipeline(conf, devices=[dev] * positions if positions else None)
            torch.cuda.synchronize()
            walls[flag] = time.perf_counter() - t0
            launches[flag] = {k.__name__: k.launches for k in kernels if k.launches}
            acc = result.driver.accumulator
            grams[flag] = (torch.cat(list(acc.layout.finalize_tiles().tiles))
                           if positions else acc.G.clone())
            doc = read_manifest(str(path))
            if validate_manifest(doc):
                raise AssertionError(f"check-ranges {label}: {validate_manifest(doc)}")
            blocks[flag] = (doc["gramian_exactness"], (doc["conformance"] or {}).get("ranges"))
            del result, acc
        exactness, pair = blocks["--check-ranges"]
        top = int(grams[""].max())
        if not torch.equal(grams[""], grams["--check-ranges"]):
            raise AssertionError(f"check-ranges {label}: the Gramian differs with the flag")
        if (blocks[""] != (None, None) or exactness is None
                or not exactness["entry_max"] == top <= exactness["static_entry_bound"]
                or pair is None or pair["ok"] is not True):
            raise AssertionError(f"check-ranges {label}: {blocks} (largest entry {top})")
        products = {k: v for k, v in launches["--check-ranges"].items()
                    if k in ("gram_accumulate", "cross_accumulate", "unpack_rows_t")}
        log(f"check-ranges {label}: Gramian byte-equal with and without the flag; "
            f"gramian_exactness {json.dumps(exactness)}, conformance.ranges {json.dumps(pair)}; "
            f"wall {walls['--check-ranges']:.4f} s with the flag, {walls['']:.4f} s without "
            f"({walls['--check-ranges'] - walls['']:+.4f} s); launches {json.dumps(products)} "
            f"(without: {json.dumps(launches[''])}) ({card_line()})")


def phase_large_cohort(torch, kernels):
    """``bench.py``'s large-cohort-sharded cell on one card: 25,000 samples
    over ``LARGE_WINDOW``, the ring at 1,4 on four positions against the
    one-device dense run of the same window (its Gramian kept on the card
    for the comparison)."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    argv = ["--references", LARGE_WINDOW, "--num-samples", str(LARGE_COHORT),
            "--ingest", "device", "--block-size", str(BLOCK)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        dense = run_pipeline(PcaConf.parse(argv))
    torch.cuda.synchronize()
    log(f"large cohort: dense one-device run of {LARGE_WINDOW} at {LARGE_COHORT} samples: "
        f"wall {time.perf_counter() - t0:.4f} s")
    want = dense.driver.accumulator.G
    del dense
    run_sharded(torch, kernels, argv + MESH_FLAGS, f"large cohort {LARGE_COHORT} 1,4",
                [torch.device("cuda", 0)] * 4,
                ("gen_genotypes", "pack_rows_t", "unpack_rows_t", "cross_accumulate"), want,
                check_pcs=False)


def phase_multiprocess():
    """Two processes on cuda:0 through ``parallel/multihost.py``'s harness
    (the port's ``verify_multihost``, ``--device cuda``): in each, the
    data axis over the global 2 × 2 positions, the ring at 1,4 flat and
    hierarchical (host factor 2) whose hops cross processes through host
    memory, each Gramian byte-equal to the one-device Gramian the process
    computes itself, the rings' measured bytes equal to their projection,
    every ring kernel launched; then the ``variants-pca`` CLI alone and
    across the two processes with host-sharded ingest over
    ``FLEET_WINDOWS``: PC lines identical, per-process reference bases
    summing to the solo run's, each strictly below it, and the two
    processes' ``--trace-dir`` segments merged into one trace that
    validates with a replica a process (``fleet_trace_ok``)."""
    from spark_examples_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    report = multihost.verify_multihost(
        num_processes=MP_PROCESSES, local_devices=MP_POSITIONS, timeout=MP_TIMEOUT,
        device="cuda", num_samples=N_SAMPLES, region=CHR17_ARGV[1], block_size=BLOCK,
        blocks_per_dispatch=1, oracle="device", fleet_regions=FLEET_WINDOWS,
    )
    wall = time.perf_counter() - t0
    for child in report["children"]:
        if "error" in child:
            raise AssertionError(f"multiprocess: a child failed (rc {child.get('returncode')}): "
                                 f"{child['error']}")
        launches = child["launches"]
        log(f"multiprocess child {child['process_id']}: {child['device']}, backend "
            f"{child['backend']}, data axis {child['mesh_shape']} spans processes "
            f"{child['result_spans_processes']}, ring {child['ring_mesh_shape']}; seconds "
            f"{json.dumps(child['seconds'])}; traffic {json.dumps(child['traffic'])}; "
            f"launches {json.dumps(launches)}")
        log(f"multiprocess child {child['process_id']}: ring schedule "
            f"{json.dumps(child['ring_schedule'])}, hier schedule "
            f"{json.dumps(child['hier_schedule'])}")
        missing = [k for k in ("gen_genotypes", "gram_accumulate", "cross_accumulate",
                               "pack_rows_t", "unpack_rows_t") if launches.get(k, 0) <= 0]
        if missing or child["backend"] != "gloo":
            raise AssertionError(f"multiprocess child {child['process_id']}: never launched "
                                 f"{missing}, backend {child['backend']}")
    bases = report.get("fleet_io_reference_bases", {})
    log(f"multiprocess: checks in {report['check_wall_seconds']:.4f} s; fleet wall "
        f"{json.dumps(report.get('fleet_wall_seconds'))}, ingest+similarity "
        f"{json.dumps(report.get('fleet_stage_seconds'))}, backends "
        f"{report.get('fleet_backend')}, reference bases {json.dumps(bases)}, "
        f"{report.get('cli_pc_lines')} PC lines identical {report.get('cli_outputs_identical')}; "
        f"fleet_trace_ok: {json.dumps(report.get('fleet_trace_ok'))} "
        f"{json.dumps(report.get('fleet_trace_errors', []))}")
    if not report["ok"] or not all(0 < b < bases["solo"] for b in bases["per_process"]):
        brief = {k: v for k, v in report.items() if k != "children"}
        raise AssertionError(f"multiprocess: {json.dumps(brief)}")
    log(f"multiprocess: every Gramian == the one-device Gramian in both processes, ring bytes "
        f"measured == predicted, fleet PC lines == solo; phase wall {wall:.1f} s")


def phase_mesh_analyses(torch, kernels):
    """The analyses on four positions of cuda:0: ``grm --similarity-strategy
    sharded --mesh-shape 1,4`` on the packed cell, its kinship TSV
    byte-equal to the dense one-device run's, and ``ld-prune --mesh-shape
    1,4`` (each window's cohort cut over the four positions), its kept
    mask equal to the one-device run's; every launch count set to 0 just
    before each run."""
    from spark_examples_tpu_torch.analyses import grm, ld
    from spark_examples_tpu_torch.config import GrmConf, LdConf

    four = [torch.device("cuda", 0)] * 4
    argv = PACKED_ARGV[:4]
    for label, run, conf_class, out_flag, mesh_flags, expect in (
        ("grm", grm.run_grm_pipeline, GrmConf, "--grm-out", MESH_FLAGS,
         ("unpack_rows_t", "cross_accumulate")),
        ("ld-prune", ld.run_ld_pipeline, LdConf, "--ld-out", ["--mesh-shape", "1,4"],
         ("unpack_rows_t", "gram_accumulate")),
    ):
        texts = {}
        for arm, flags, devices in (("one device", [], None), ("mesh 1,4", mesh_flags, four)):
            out = DATA_DIR / f"mesh_{label}_{arm.replace(' ', '_')}.tsv"
            reset_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            manifest = DATA_DIR / f"manifest_mesh_{label}.json"
            with contextlib.redirect_stdout(io.StringIO()):
                result = run(conf_class.parse(argv + flags + [out_flag, str(out), "--metrics-json",
                                                              str(manifest)]), devices=devices)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in kernels}
            spans = {span["name"]: span["seconds"] for span in result.manifest["spans"]}
            missing = [k for k in expect if launches[k] <= 0] if devices else []
            if missing:
                raise AssertionError(f"mesh {label} {arm} never launched {missing}")
            texts[arm] = out.read_text()
            log(f"mesh {label} {arm}: wall {wall:.4f} s, spans {json.dumps(spans)}, launches "
                f"{json.dumps(launches)}, output {len(texts[arm])} bytes")
        if texts["mesh 1,4"] != texts["one device"]:
            raise AssertionError(f"mesh {label}: the 1,4 output differs from the one-device run's")
        log(f"mesh {label}: the 1,4 output is byte-identical to the one-device run's")


#: The stacked kernels' checks (``phase_fused_kernels``): lanes K at 2,504
#: samples × the CLI's and chr17's blocks; cohort widths at K = 3 (odd, n %
#: 4 == 2, the cohort); the lanes that hold a block in a step where the
#: others of 8 have finished.
FUSED_LANES = (1, 2, 8)
FUSED_WIDTHS = (17, 130, N_SAMPLES)
FUSED_ACTIVE = (1, 4, 6)
#: The fused pipeline phase: groups of this many jobs over ``FLEET_WINDOWS``,
#: one window a job, packed ingest at the CLI's block; the timed stacked
#: step is at this K.
FUSED_GROUP = 4
FUSED_TIMED_ROWS = (CLI_BLOCK, BLOCK)


def stacked_inputs(torch, rng, k, n, rows, active=None):
    """K lanes of bit-packed has-variation rows at the synthetic density on
    the card, the lanes outside ``active`` zero (as the stacked accumulator
    ships a finished lane)."""
    bits = (rng.random((k, rows, n)) < 0.3).astype(np.uint8)
    if active is not None:
        bits[[j for j in range(k) if j not in active]] = 0
    return torch.from_numpy(np.packbits(bits, axis=-1)).to("cuda")


def phase_fused_kernels(torch, batched, devicegen, gramian):
    """The stacked jobs' two kernels against their plain versions, exactly:
    ``stacked_unpack_rows_t`` (every listed lane's rows of the stacked Xᵀ)
    then ``stacked_gram_accumulate`` onto a nonzero (K, N, N) G, at K in
    ``FUSED_LANES`` × 2,504 samples × 1,024 and 16,384 rows, at N in
    ``FUSED_WIDTHS`` with K = 3, and in a step of 8 lanes where only
    ``FUSED_ACTIVE`` hold a block. Then CUDA-event times at K =
    ``FUSED_GROUP`` (and 1 and 8 at the CLI's block) beside the K-launch
    loop (``unpack_rows_t`` + ``gram_accumulate`` a lane), K calls of
    ``torch._int_mm`` plus the add, the plain versions, the bounds and each
    product launch's blocks and waves. Returns the JSON rows (K =
    ``FUSED_GROUP`` × 1,024 rows, the fused phase's step)."""
    from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    cases = [(k, N_SAMPLES, rows, None) for k in FUSED_LANES for rows in (CLI_BLOCK, BLOCK)]
    cases += [(3, n, CLI_BLOCK, None) for n in FUSED_WIDTHS]
    cases.append((8, N_SAMPLES, CLI_BLOCK, FUSED_ACTIVE))
    for k, n, rows, active in cases:
        packed = stacked_inputs(torch, rng, k, n, rows, active)
        lanes = list(active) if active is not None else None
        n_pad = -(-n // 128) * 128
        got = batched.stacked_unpack_rows_t(packed, n, lanes)
        want = batched.stacked_unpack_rows_t_plain(packed, n)
        start = torch.from_numpy(rng.integers(-1000, 1000, (k, n, n), dtype=np.int32)).to(dev)
        g_k, g_p = start.clone(), start.clone()
        batched.stacked_gram_accumulate(g_k, got, lanes)
        batched.stacked_gram_accumulate_plain(g_p, want)
        torch.cuda.synchronize()
        for lane in (lanes if lanes is not None else range(k)):
            if not torch.equal(got[lane * n_pad:(lane + 1) * n_pad],
                               want[lane * n_pad:(lane + 1) * n_pad]):
                raise AssertionError(f"stacked_unpack_rows_t != plain (K={k}, N={n}, {rows} "
                                     f"rows, lane {lane})")
        err = int((g_k.long() - g_p.long()).abs().max())
        if err:
            raise AssertionError(f"stacked_gram_accumulate != plain (K={k}, N={n}, {rows} rows, "
                                 f"lanes {lanes}): max err {err}")
        blocks, resident, split, sms = batched.stacked_gram_accumulate_grid(
            n_pad, -(-rows // 128) * 128, len(lanes or range(k)), dev)
        log(f"kernels: stacked_unpack_rows_t and stacked_gram_accumulate == plain (K={k}, N={n}, "
            f"{rows} rows, lanes {lanes or 'all'}): trace {int((g_k - start).diagonal(0, 1, 2).long().sum())}; "
            f"product launch {blocks} blocks (split {split}), {resident} resident on {sms} SMs, "
            f"{blocks / resident:.2f} waves")
        del packed, got, want, start, g_k, g_p
    int32_rate = int32_ops_per_s(torch)
    times = {}
    n = N_SAMPLES
    n_pad = -(-n // 128) * 128
    for k, rows in [(FUSED_GROUP, r) for r in FUSED_TIMED_ROWS] + [(1, CLI_BLOCK), (8, CLI_BLOCK)]:
        packed = stacked_inputs(torch, rng, k, n, rows)
        ld = -(-rows // 128) * 128
        G = torch.zeros((k, n, n), dtype=torch.int32, device=dev)
        xt = batched.stacked_unpack_rows_t(packed, n)
        singles = [gramian.unpack_rows_t(packed[j], n) for j in range(k)]
        iters = 20 if rows > CLI_BLOCK else 50

        def loop():
            for j in range(k):
                devicegen.gram_accumulate(G[j], gramian.unpack_rows_t(packed[j], n))

        def int_mm():
            for j in range(k):
                G[j].add_(torch._int_mm(singles[j][:n], singles[j][:n].t()))

        unpack_bound = bound(packed.numel() + k * n_pad * ld, 0, int32_rate)
        # The product reads the stacked Xᵀ once and each lane's G once each
        # way; N·(N+1)·B operations a lane (the symmetric half).
        gram_bound = bound(k * (n_pad * ld + 8 * n * n), float(k) * n * (n + 1) * rows,
                           PEAK_INT8_OPS_PER_S)
        r = times[(k, rows)] = dict(
            unpack_ms=cuda_ms(lambda: batched.stacked_unpack_rows_t(packed, n), iters),
            gram_ms=cuda_ms(lambda: batched.stacked_gram_accumulate(G, xt), iters),
            step_ms=cuda_ms(lambda: batched.stacked_gram_accumulate(
                G, batched.stacked_unpack_rows_t(packed, n)), iters),
            loop_ms=cuda_ms(loop, iters),
            int_mm_ms=cuda_ms(int_mm, iters),
            unpack_plain_ms=cuda_ms(lambda: batched.stacked_unpack_rows_t_plain(packed, n), 3, 1),
            gram_plain_ms=cuda_ms(lambda: batched.stacked_gram_accumulate_plain(G, xt), 3, 1),
            unpack_bound=unpack_bound, gram_bound=gram_bound,
        )
        blocks, resident, split, sms = batched.stacked_gram_accumulate_grid(n_pad, ld, k, dev)
        log(f"kernels: stacked step at K={k} x N={n} x {rows} rows: {r['step_ms']:.4f} ms "
            f"(stacked_unpack_rows_t {r['unpack_ms']:.4f} ms, bound {unpack_bound[0]:.4f} ms by "
            f"bytes, {100 * unpack_bound[0] / r['unpack_ms']:.1f} % of it; stacked_gram_accumulate "
            f"{r['gram_ms']:.4f} ms, bound {gram_bound[0]:.4f} ms by {gram_bound[1]}, "
            f"{100 * gram_bound[0] / r['gram_ms']:.1f} % of it); the K-launch loop "
            f"{r['loop_ms']:.4f} ms, {k} x torch._int_mm + add {r['int_mm_ms']:.4f} ms; plain "
            f"{r['unpack_plain_ms']:.4f} + {r['gram_plain_ms']:.4f} ms; product launch {blocks} "
            f"blocks (split {split}), {resident} resident on {sms} SMs, {blocks / resident:.2f} "
            f"waves ({card_line()})")
        del packed, G, xt, singles
    torch.cuda.empty_cache()
    r = times[(FUSED_GROUP, CLI_BLOCK)]
    rows = {
        "stacked_unpack_rows_t": dict(max_abs_err=0, ms=r["unpack_ms"],
                                      plain_ms=r["unpack_plain_ms"], library_ms=None,
                                      bound=r["unpack_bound"]),
        "stacked_gram_accumulate": dict(max_abs_err=0, ms=r["gram_ms"],
                                        plain_ms=r["gram_plain_ms"], library_ms=r["int_mm_ms"],
                                        bound=r["gram_bound"]),
    }
    return rows, times


def phase_fused(torch, kernels):
    """``run_fused_pipeline`` end to end: a ``pca`` and a ``similarity``
    group of ``FUSED_GROUP`` jobs, one 2 Mb window of ``FLEET_WINDOWS`` a
    job, 2,504 samples, packed ingest at the CLI's block, every launch
    count set to 0 just before each group. Each lane's Gramian must equal
    its serial ``run_pipeline`` (``--ingest packed``) byte for byte, its
    PC rows that run's rows, its summary the summary of that Gramian; the
    stacked kernels must have launched and the single product not. Prints
    each group's wall-clock beside the sum of the serial runs', the
    launches, the peak device memory and ``max_fused_jobs`` on this card.
    Returns the ``pca`` group's launches."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.ops.batched import max_fused_jobs
    from spark_examples_tpu_torch.ops.gramian import per_device_memory_bytes
    from spark_examples_tpu_torch.pipeline.fused import run_fused_pipeline
    from spark_examples_tpu_torch.pipeline.pca_driver import _summarize_similarity, run_pipeline

    t_phase = time.perf_counter()
    argvs = [["--references", window, "--num-samples", str(N_SAMPLES), "--ingest", "packed"]
             for window in FLEET_WINDOWS.split(",")][:FUSED_GROUP]
    serial, serial_wall = [], 0.0
    for argv in argvs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            result = run_pipeline(PcaConf.parse(argv))
        torch.cuda.synchronize()
        serial_wall += time.perf_counter() - t0
        serial.append((result.driver.accumulator.G.cpu(), result.lines))
        del result
    torch.cuda.empty_cache()
    launches = {}
    for kind in ("pca", "similarity"):
        confs = [PcaConf.parse(argv) for argv in argvs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            results = run_fused_pipeline(confs, [kind] * len(confs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated()
        acc = results[0].driver.accumulator
        for j, (result, (want_g, want_lines)) in enumerate(zip(results, serial)):
            got = acc.job_slice(j).cpu()
            if got.dtype != want_g.dtype or not torch.equal(got, want_g):
                raise AssertionError(f"fused {kind} lane {j}: Gramian != its serial run's")
            if kind == "pca" and result.lines != want_lines:
                raise AssertionError(f"fused pca lane {j}: PC rows != its serial run's")
            if kind == "similarity" and result.similarity_summary != _summarize_similarity(
                    want_g, N_SAMPLES):
                raise AssertionError(f"fused similarity lane {j}: summary "
                                     f"{result.similarity_summary}")
        missing = [k for k in ("stacked_unpack_rows_t", "stacked_gram_accumulate")
                   if counts[k] != acc.steps]
        if missing or counts["gram_accumulate"] or counts["unpack_rows_t"]:
            raise AssertionError(f"fused {kind}: launches {json.dumps(counts)} for "
                                 f"{acc.steps} steps")
        spans = {s["path"]: s["seconds"] for s in results[0].driver.spans.flat()}
        log(f"fused {kind}: {len(results)} jobs, {acc.steps} steps, wall {wall:.4f} s against "
            f"{serial_wall:.4f} s for the serial runs; spans of job 0 {json.dumps(spans)}; "
            f"launches {json.dumps(counts)}; peak device memory {peak / 2**20:.1f} MiB; every "
            f"lane's Gramian == its serial run's" + (", PC rows equal" if kind == "pca" else
                                                       ", summaries equal") + f" ({card_line()})")
        if kind == "pca":
            launches = counts
        del results, acc
        torch.cuda.empty_cache()
    cap = max_fused_jobs(N_SAMPLES, device_bytes=per_device_memory_bytes("cuda"))
    log(f"fused: max_fused_jobs({N_SAMPLES}) on this card's "
        f"{per_device_memory_bytes('cuda')} bytes: {cap}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


#: The serve phase's fused group: four ``similarity`` jobs of one geometry,
#: 200 kb of chr17-20 each (2,001 sites, packed), small under the phase's
#: site limit; the grm job over the packed cell is large under it (no
#: linger), and chr17 is large by the reference's own limit.
SERVE_SIMILARITY_WINDOWS = [f"{ref}:41196311:41396311" for ref in ("17", "18", "19", "20")]
SERVE_SMALL_SITE_LIMIT = 10_000
#: How long the worker holds a small group open for compatible jobs: the
#: four similarity jobs are submitted back to back and the group dispatches
#: the moment it is full.
SERVE_LINGER_SECONDS = 20.0
#: Admission latency: submit -> 202 over this many requests, each a
#: similarity job over 10 kb of chr17 (the jobs run too, so they are short).
SERVE_ADMISSIONS = 20
SERVE_ADMISSION_ARGV = ["--references", "17:41196311:41206311", "--num-samples", str(N_SAMPLES),
                        "--ingest", "packed"]
#: The grm job: 1 Mb of chr17 (10,001 sites, large under the phase's limit).
SERVE_GRM_ARGV = ["--references", "17:41196311:42196311", "--num-samples", str(N_SAMPLES)]
#: A Gramian no 80 GB card holds: 200,000 samples, dense.
#: A geometry the serve phase never builds before it is submitted (chr17
#: at 2,000 samples), and its deadline: feasible once the cold penalty is
#: a geometry's (tens of milliseconds at most), not a process's.
SERVE_NEW_GEOMETRY_ARGV = ["--references", "17:0:81195210", "--num-samples", "2000",
                           "--ingest", "device", "--block-size", "16384"]
SERVE_DEADLINE_SECONDS = 0.5
SERVE_OVER_MEMORY_ARGV = ["--similarity-strategy", "dense", "--num-samples", "200000"]


def _served_rows(job) -> list:
    """The PC rows a served job printed into its ``stdout.log``."""
    log_path = Path(job["manifest_path"]).parent / "stdout.log"
    return [line for line in log_path.read_text().splitlines() if "\t" in line]


def phase_serve(torch, kernels):
    """The serve daemon on the card: ``PcaService`` with its HTTP server on
    port 0, driven by ``ServeClient``, at 2,504 samples. A ``pca`` job over
    chr17 (device generation) whose rows in ``jobs/<id>/stdout.log`` equal
    ``run_pipeline``'s, twice (cold, then warm); four ``similarity`` jobs of
    one geometry admitted back to back and run as exactly one fused group
    (the stacked kernels once a step, the single product and unpack never),
    each summary its serial run's; a ``grm`` job whose summary equals
    ``run_grm_pipeline``'s; a 413 for a Gramian past the card's memory; a
    second daemon on the same run directory, its ledger primed, serving
    chr17 warm, and taking 20 admissions (median submit -> 202); then
    ``python -m spark_examples_tpu_torch serve`` as a process on the same
    run directory, one ``submit`` against it (warm), and SIGTERM, which
    must drain to exit 0. Every launch count is set to 0 just before each
    served job or group and read after it. Logs each served wall beside the
    batch run's, the queue waits, the fused group beside its serial runs,
    and the restarted daemons' jobs beside the warm one."""
    from spark_examples_tpu_torch.analyses.grm import run_grm_pipeline
    from spark_examples_tpu_torch.config import GrmConf, PcaConf
    from spark_examples_tpu_torch.obs.heartbeat import Heartbeat
    from spark_examples_tpu_torch.obs.trace import mint_trace_id
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline
    from spark_examples_tpu_torch.serve.client import ServeClient, ServeError
    from spark_examples_tpu_torch.serve.daemon import PcaService
    from spark_examples_tpu_torch.serve.http import start_server
    from spark_examples_tpu_torch.utils.cache import reset_compile_cache_stats

    t_phase = time.perf_counter()
    run_dir = DATA_DIR / "serve"
    shutil.rmtree(run_dir, ignore_errors=True)
    similarity_argvs = [["--references", w, "--num-samples", str(N_SAMPLES), "--ingest",
                         "packed"] for w in SERVE_SIMILARITY_WINDOWS]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # The batch runs every served job is held to, in this phase (chr17
    # twice: the second is the warm wall).
    for _ in range(2):
        batch_pca, batch_pca_wall = timed(lambda: run_pipeline(PcaConf.parse(CHR17_ARGV)))
    batch_rows = batch_pca.lines
    del batch_pca
    batch_grm, batch_grm_wall = timed(lambda: run_grm_pipeline(GrmConf.parse(SERVE_GRM_ARGV)))
    batch_grm_summary = batch_grm.summary
    del batch_grm
    serial, serial_wall, serial_blocks = [], 0.0, 0
    for argv in similarity_argvs:
        reset_counts(kernels)
        result, wall = timed(lambda: run_pipeline(PcaConf.parse(argv), similarity_only=True))
        serial.append(result.similarity_summary)
        serial_wall += wall
        serial_blocks = max(serial_blocks, next(k.launches for k in kernels
                                                if k.__name__ == "unpack_rows_t"))
        del result
    torch.cuda.empty_cache()

    # The jobs of the current daemon's life, by id: the trace id its
    # submit carried. A daemon compacts the settled jobs of earlier lives
    # out of the journal at start-up (the reference's semantics), so the
    # fleet report is read at the end of each life; the calibration ledger
    # is append-only and holds every done job of the phase.
    life, settled_jobs = {}, [0]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))

    def submit(client, argv, **kw):
        trace = mint_trace_id()
        job_id = client.submit(argv, trace_id=trace, **kw)["job"]["id"]
        life[job_id] = trace
        return job_id

    def report(label):
        settled_jobs[0] += len(life)
        check_fleet_report(run_dir, life, settled_jobs[0], label, env)
        life.clear()

    def run_job(client, argv, kind="pca", expect=()):
        reset_counts(kernels)
        job = client.wait(submit(client, argv, kind=kind), timeout=300)["job"]
        counts = {k.__name__: k.launches for k in kernels}
        if job["status"] != "done":
            raise AssertionError(f"serve: {kind} job failed: {job['error']}")
        missing = [k for k in expect if counts[k] <= 0]
        if missing:
            raise AssertionError(f"serve: {kind} job never launched {missing}: {counts}")
        return job, counts

    def serve(**kw):
        service = PcaService(run_dir=str(run_dir), persistent_cache=True,
                             small_site_limit=SERVE_SMALL_SITE_LIMIT, **kw).start()
        return service, start_server(service)

    def stop(service, server):
        server.shutdown()
        server.server_close()
        if not service.stop(timeout=120):
            raise AssertionError(f"serve: the daemon did not drain: {service.healthz()}")

    reset_compile_cache_stats()
    service, server = serve(batch_max_jobs=len(similarity_argvs),
                            batch_linger_seconds=SERVE_LINGER_SECONDS)
    try:
        client = ServeClient(server.url)
        health = client.healthz()
        log(f"serve: daemon on {health['mesh']}, slices {json.dumps(health['slices'])} "
            f"({card_line()})")
        if [s["name"] for s in health["slices"]] != ["shared"]:
            raise AssertionError(f"serve: one card must give the shared topology: {health}")
        # First, with the calibration ledger empty (the raw model decides):
        # a geometry this daemon has never built, under a deadline its
        # per-geometry cold penalty leaves room for, is admitted (202) and
        # settles within the deadline.
        device_path = ("gen_genotypes", "gram_accumulate")
        reset_counts(kernels)
        job_id = submit(client, SERVE_NEW_GEOMETRY_ARGV, deadline_seconds=SERVE_DEADLINE_SECONDS)
        job = client.wait(job_id, timeout=300)["job"]
        counts = {k.__name__: k.launches for k in kernels}
        if any(counts[k] <= 0 for k in device_path):
            raise AssertionError(f"serve: the new geometry never launched {device_path}: {counts}")
        settled = job["finished_unix"] - job["submitted_unix"]
        cost = job["cost"]
        if job["status"] != "done" or job["compile_cache"] != "cold" \
                or cost["compile"] != "cold" or settled > SERVE_DEADLINE_SECONDS:
            raise AssertionError(f"serve: the new geometry under a {SERVE_DEADLINE_SECONDS} s "
                                 f"deadline: {job['status']} {job['compile_cache']}, admission "
                                 f"to settlement {settled:.4f} s, cost {cost}")
        log(f"serve: a never-built geometry ({SERVE_NEW_GEOMETRY_ARGV[3]} samples over chr17) "
            f"under deadline_seconds={SERVE_DEADLINE_SECONDS}: 202, predicted "
            f"{cost['predicted_seconds']:.4f} s ({cost['compile']}; calibrated "
            f"{cost.get('calibrated_seconds')}), served wall {job['seconds']:.4f} s, admission "
            f"to settlement {settled:.4f} s; launches {json.dumps(counts)} ({card_line()})")

        walls = {}
        for label in ("cold", "warm"):
            job, counts = run_job(client, CHR17_ARGV, expect=device_path)
            if job["compile_cache"] != label:
                raise AssertionError(f"serve: chr17 job {label} reported {job['compile_cache']}")
            if job["result"]["pc_lines"] != batch_rows or _served_rows(job) != batch_rows:
                raise AssertionError(f"serve: chr17 {label} job's rows != run_pipeline's")
            walls[label] = job["seconds"]
            log(f"serve: chr17 pca {label}: served wall {job['seconds']:.4f} s against batch "
                f"{batch_pca_wall:.4f} s; queue wait {job['cost']['queue_wait_seconds']:.4f} s; "
                f"launches {json.dumps(counts)}; {len(batch_rows)} rows == run_pipeline's "
                f"({card_line()})")

        reset_counts(kernels)
        t0 = time.perf_counter()
        ids = [submit(client, argv, kind="similarity") for argv in similarity_argvs]
        jobs = [client.wait(job_id, timeout=300)["job"] for job_id in ids]
        group_wall = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in kernels}
        for job, want in zip(jobs, serial):
            if job["status"] != "done" or job["fused_size"] != len(jobs):
                raise AssertionError(f"serve: similarity job not in one fused group: {job}")
            if job["result"]["similarity"] != want:
                raise AssertionError(f"serve: fused lane {job['result']} != serial {want}")
        stats = service.fleet_stats()["dispatch"]
        steps = counts["stacked_unpack_rows_t"]
        if (stats["fused_groups"], stats["fused_jobs"]) != (1, len(jobs)) or steps != serial_blocks \
                or counts["stacked_gram_accumulate"] != steps or counts["gram_accumulate"] \
                or counts["unpack_rows_t"]:
            raise AssertionError(f"serve: fused group dispatch {stats}, launches {counts}, "
                                 f"{serial_blocks} blocks a lane")
        line = Heartbeat(60.0, service.registry).line()
        if f"fused 1 K-job group(s) (K≈{len(jobs)}.0)" not in line:
            raise AssertionError(f"serve: heartbeat {line!r}")
        waits = [round(j["cost"]["queue_wait_seconds"], 4) for j in jobs]
        log(f"serve: fused similarity group of {len(jobs)}: wall {group_wall:.4f} s (submit to "
            f"last result; each job's share {jobs[0]['seconds']:.4f} s) against {serial_wall:.4f} s "
            f"for the serial runs; queue waits {waits} s; {steps} steps, launches "
            f"{json.dumps(counts)}; summaries == the serial runs' ({card_line()})")
        log(f"serve: heartbeat {line}")

        job, counts = run_job(client, SERVE_GRM_ARGV, kind="grm",
                              expect=("unpack_rows_t", "gram_accumulate"))
        if job["result"]["grm"] != batch_grm_summary:
            raise AssertionError(f"serve: grm {job['result']} != run_grm_pipeline's "
                                 f"{batch_grm_summary}")
        log(f"serve: grm over 1 Mb of chr17: served wall {job['seconds']:.4f} s against batch "
            f"{batch_grm_wall:.4f} s; summary == run_grm_pipeline's; launches "
            f"{json.dumps(counts)} ({card_line()})")

        try:
            client.submit(SERVE_OVER_MEMORY_ARGV)
            raise AssertionError("serve: a Gramian past the card's memory was admitted")
        except ServeError as e:
            codes = [i["code"] for i in e.body["plan"]["issues"]]
            if e.status != 413 or "dense-exceeds-hbm" not in codes:
                raise AssertionError(f"serve: over-memory job got {e.status} {codes}")
            log(f"serve: {SERVE_OVER_MEMORY_ARGV} -> {e.status} {e.code} {codes} on the card's "
                f"{service.admission_device_bytes('large')} bytes")
    finally:
        stop(service, server)
    report("the first daemon")

    # A second daemon on the run directory, the process's ledger cleared as
    # a new process starts: the ledger file primes it.
    reset_compile_cache_stats()
    t0 = time.perf_counter()
    service, server = serve(small_capacity=2 * SERVE_ADMISSIONS)
    start_wall = time.perf_counter() - t0
    try:
        client = ServeClient(server.url)
        warm_state = client.healthz()["warm_state"]
        job, _ = run_job(client, CHR17_ARGV, expect=("gen_genotypes", "gram_accumulate"))
        if job["compile_cache"] != "warm" or job["result"]["pc_lines"] != batch_rows:
            raise AssertionError(f"serve: restarted chr17 job {job['compile_cache']}")
        log(f"serve: restarted daemon (in-process; start {start_wall:.4f} s, warm state "
            f"{json.dumps(warm_state)}): chr17 warm, wall {job['seconds']:.4f} s against "
            f"{walls['warm']:.4f} s warm before the restart ({card_line()})")
        latencies, ids = [], []
        for i in range(SERVE_ADMISSIONS):
            t0 = time.perf_counter()
            ids.append(submit(client, SERVE_ADMISSION_ARGV, kind="similarity"))
            latencies.append(time.perf_counter() - t0)
        done = [client.wait(job_id, timeout=300)["job"]["status"] for job_id in ids]
        if done != ["done"] * len(ids):
            raise AssertionError(f"serve: admitted jobs ended {done}")
        log(f"serve: admission latency (submit -> 202) over {len(latencies)} requests: median "
            f"{float(np.median(latencies)) * 1e3:.3f} ms, max {max(latencies) * 1e3:.3f} ms "
            f"({card_line()})")
    finally:
        stop(service, server)
    report("the restarted daemon")

    # The entry point as a process on the same run directory.
    endpoint = run_dir / "endpoint"
    t0 = time.perf_counter()
    daemon = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch", "serve", "--port", "0",
         "--run-dir", str(run_dir), "--endpoint-file", str(endpoint),
         "--serve-small-site-limit", str(SERVE_SMALL_SITE_LIMIT)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=env)
    try:
        while not endpoint.exists():
            if daemon.poll() is not None or time.perf_counter() - t0 > 180:
                raise AssertionError(f"serve: the daemon process never listened: "
                                     f"{daemon.stderr.read() if daemon.poll() is not None else ''}")
            time.sleep(0.05)
        listen_wall = time.perf_counter() - t0
        url = endpoint.read_text().strip()
        t1 = time.perf_counter()
        submitted = subprocess.run(
            [sys.executable, "-m", "spark_examples_tpu_torch", "submit", "--url", url, "--json",
             "--", *CHR17_ARGV], capture_output=True, text=True, env=env, timeout=300)
        submit_wall = time.perf_counter() - t1
        if submitted.returncode != 0:
            raise AssertionError(f"serve: submit exited {submitted.returncode}: "
                                 f"{submitted.stdout[-2000:]} {submitted.stderr[-2000:]}")
        job = json.loads(submitted.stdout)["job"]
        life[job["id"]] = job["trace"]
        if job["compile_cache"] != "warm" or job["result"]["pc_lines"] != batch_rows:
            raise AssertionError(f"serve: the process's chr17 job {job['compile_cache']}")
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=120)
        err = daemon.stderr.read()
        if rc != 0 or "drained cleanly" not in err:
            raise AssertionError(f"serve: the daemon process exited {rc}: {err[-2000:]}")
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait(timeout=30)
    log(f"serve: `serve` as a process: listening after {listen_wall:.3f} s; its first job "
        f"(chr17, warm from the ledger) served wall {job['seconds']:.4f} s against "
        f"{walls['warm']:.4f} s warm in this process, queue wait "
        f"{job['cost']['queue_wait_seconds']:.4f} s, admission to settlement "
        f"{job['finished_unix'] - job['submitted_unix']:.4f} s; the `submit --json` process "
        f"{submit_wall:.3f} s; SIGTERM drained to exit 0 ({card_line()})")
    report("`serve` as a process")
    log(f"serve: phase wall {time.perf_counter() - t_phase:.1f} s")


def check_fleet_report(run_dir, traces, done, label, env):
    """``obs report --run-dir --json`` over the serve phase's run directory,
    as a process, at the end of a daemon's life: one journaled job for each
    that life settled (``traces``: id -> the trace id its submit carried),
    each under that id, all done; and one calibration sample for each of
    the phase's ``done`` jobs so far."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch", "obs", "report", "--run-dir",
         str(run_dir), "--json"], capture_output=True, text=True, env=env, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"obs report exited {proc.returncode}: {proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    totals = report["totals"]
    got = {job_id: job["trace"] for job_id, job in report["jobs"].items()}
    if totals["journaled"] != len(traces) or got != traces:
        raise AssertionError(f"obs report after {label}: {totals['journaled']} journaled jobs "
                             f"against {len(traces)} settled; traces differ for "
                             f"{sorted(k for k in set(got) | set(traces) if got.get(k) != traces.get(k))}")
    if totals["statuses"] != {"done": len(traces)} or report["calibration"]["samples"] != done:
        raise AssertionError(f"obs report after {label}: statuses {totals['statuses']}, "
                             f"calibration samples {report['calibration']['samples']} for "
                             f"{done} done jobs")
    p50 = {job_class: round(block["wall_seconds"]["p50"], 4)
           for job_class, block in report["classes"].items()}
    log(f"obs report after {label} ({wall:.3f} s as a process): {totals['journaled']} journaled "
        f"jobs, each under its submit's trace id; per-class p50 walls {json.dumps(p50)} s; "
        f"calibration fold n={report['calibration']['samples']}, ratio "
        f"{report['calibration']['ratio']:.4f}; protocol "
        f"{json.dumps(report['protocol']['totals'])} ({card_line()})")


#: The checkers phase: each ``graftcheck`` subcommand the port runs over
#: its own tree, as a process that must exit 0 (``lint`` runs as ``lint
#: --json``, which checks more: its files and findings).
CHECKERS = (
    ("hostmem",),
    ("lockgraph",),
    ("proto", "--replicas", "2", "--jobs", "1", "--crashes", "1", "--stalls", "1"),
    ("typecheck",),
    ("sanitize",),
)

#: The sanitizer modes ``graftcheck sanitize`` must read OK or SKIP in.
SANITIZER_MODES = ("asan", "ubsan", "tsan")


def start_checker(argv, env):
    """One ``graftcheck`` subcommand started as a process, its output read
    by a thread of its own (which notes when the process ended);
    :func:`finish_checker` waits for it."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch", "graftcheck", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    done: dict = {}

    def read():
        done["out"], done["err"] = proc.communicate()
        done["ended"] = time.perf_counter()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, argv, time.perf_counter(), reader, done


def finish_checker(started):
    """The process of :func:`start_checker`, which must exit 0 within 300 s
    of its start; returns its standard output and wall (start to exit)."""
    proc, argv, t0, reader, done = started
    reader.join(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
    if reader.is_alive():
        proc.kill()
        reader.join()
        raise AssertionError(f"graftcheck {' '.join(argv)} did not exit within 300 s")
    if proc.returncode != 0:
        raise AssertionError(f"graftcheck {' '.join(argv)} exited {proc.returncode}: "
                             f"{done['out'][-2000:]} {done['err'][-2000:]}")
    return done["out"], done["ended"] - t0


def run_checker(argv, env):
    """One ``graftcheck`` subcommand as a process that must exit 0; returns
    its standard output and wall."""
    return finish_checker(start_checker(argv, env))


def sanitize_first_walls():
    """Build and replay each sanitizer mode once in this process, before
    any ``graftcheck sanitize`` process, so the builds timed are the
    checkout's uncached ones; returns {mode: "OK" or "SKIP"}."""
    from spark_examples_tpu_torch.check.corpus import corpus_documents
    from spark_examples_tpu_torch.check.sanitize import replay_corpus
    from spark_examples_tpu_torch.ops._kernels import BUILD_DIR
    from spark_examples_tpu_torch.utils.native import build_sanitizer_harness

    n_docs = len(corpus_documents())
    verdicts = {}
    for mode in SANITIZER_MODES:
        before = set(os.listdir(BUILD_DIR)) if BUILD_DIR.is_dir() else set()
        t0 = time.perf_counter()
        try:
            harness = build_sanitizer_harness(mode)
        except RuntimeError as e:
            verdicts[mode] = "SKIP"
            log(f"checkers: sanitize[{mode}]: no build in {time.perf_counter() - t0:.3f} s: "
                f"{str(e)[-300:]} ({card_line()})")
            continue
        built = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = replay_corpus(mode)
        replayed = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"sanitize[{mode}]: the harness exited {proc.returncode}: "
                                 f"{(proc.stderr or proc.stdout)[-2000:]}")
        verdicts[mode] = "OK"
        name = os.path.basename(harness)
        log(f"checkers: sanitize[{mode}]: {name} built in {built:.3f} s "
            f"({'cached' if name in before else 'uncached'}), {n_docs} corpus documents "
            f"replayed clean in {replayed:.3f} s ({card_line()})")
    return verdicts


def check_sanitize_lines(out, wall, verdicts):
    """Every mode's line of the ``graftcheck sanitize`` process must read
    OK over the whole corpus, or SKIP with its reason where this process's
    own build found no runtime for the mode."""
    from spark_examples_tpu_torch.check.corpus import corpus_documents

    ok = f"OK — {len(corpus_documents())} corpus documents replayed clean"
    lines = dict(re.findall(r"^graftcheck sanitize\[(\w+)\]: (.*)$", out, re.MULTILINE))
    for mode in SANITIZER_MODES:
        said = lines.get(mode, "(no line)")
        if not (said == ok and verdicts[mode] == "OK"
                or said.startswith("SKIP (") and verdicts[mode] == "SKIP"):
            raise AssertionError(f"graftcheck sanitize[{mode}]: {said!r} (this process: "
                                 f"{verdicts[mode]}); output: {out[-2000:]}")
        log(f"checkers: graftcheck sanitize[{mode}]: {said} ({wall:.3f} s for the process, "
            f"cached builds; {card_line()})")


def phase_checkers():
    """Every ``graftcheck`` checker over the port's tree as a process that
    must exit 0, all started at the phase's start (``sanitize`` after its
    modes' in-process builds), so each logged wall is a concurrent one:
    ``hostmem``, ``lockgraph``, ``proto``, ``typecheck`` (it skips there:
    the card's machine has no ``mypy``) and ``sanitize``, each with its
    last line, and each sanitizer mode's line, which must read OK over the
    40 corpus documents (or SKIP where the machine's compiler has no
    runtime for the mode), beside the mode's uncached build and replay
    walls; ``sched --json``, which must prove its 16 subjects with no
    finding and every multi-host comparison below the flat ring; ``ranges
    --json``, which must prove its default matrix's 24 kernels with no
    finding; ``ir --json``, which must audit its default matrix's 18
    kernels with no finding; and ``lint --json``, whose report must name
    no finding over every ``.py`` file of the package (the linter under
    this machine's own ``ast``)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    reports = (("sched", "--json"), ("ranges", "--json"), ("ir", "--json"), ("lint", "--json"))
    running = {argv: start_checker(argv, env)
               for argv in (*reports, *(a for a in CHECKERS if a != ("sanitize",)))}
    results = {}
    try:
        verdicts = sanitize_first_walls()
        running[("sanitize",)] = start_checker(("sanitize",), env)
        for argv in list(running):
            results[argv] = finish_checker(running.pop(argv))
    finally:
        for proc, *_ in running.values():  # a checker failed: stop the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for argv in CHECKERS:
        out, wall = results[argv]
        if argv == ("sanitize",):
            check_sanitize_lines(out, wall, verdicts)
            continue
        last = (out.strip().splitlines() or [""])[-1]
        log(f"checkers: graftcheck {' '.join(argv)}: exit 0 in {wall:.3f} s as a process (beside "
            f"the other checkers); {last} ({card_line()})")
    out, wall = results[("sched", "--json")]
    report = json.loads(out)
    if (report["tool"], report["ok"], report["subject_count"], report["finding_count"]) != (
            "graftcheck-sched", True, 16, 0) or not all(
            c["hier_strictly_below"] for c in report["comparisons"]):
        raise AssertionError(f"graftcheck sched --json: {out[-2000:]}")
    split = {s["subject"]: [s["facts"][k] for k in ("ici_bytes", "ici_steps", "dcn_bytes",
                                                     "dcn_steps")]
             for s in report["subjects"] if s["facts"]["topology"] == "32x8"}
    log(f"checkers: graftcheck sched --json: exit 0 in {wall:.3f} s as a process (beside the "
        f"other checkers); {report['subject_count']} subjects, {report['finding_count']} "
        f"findings, 32x8 [ici B, ici steps, dcn B, dcn steps] {json.dumps(split)} ({card_line()})")
    out, wall = results[("ranges", "--json")]
    report = json.loads(out)
    if (report["tool"], report["ok"], report["kernel_count"], report["finding_count"]) != (
            "graftcheck-ranges", True, 24, 0):
        raise AssertionError(f"graftcheck ranges --json: {out[-2000:]}")
    increments = {k["kernel"]: k["facts"]["entry_increment"] for k in report["kernels"]}
    log(f"checkers: graftcheck ranges --json: exit 0 in {wall:.3f} s as a process (beside the "
        f"other checkers); {report['kernel_count']} kernels, {report['finding_count']} "
        f"findings, entry increments {json.dumps(increments)} ({card_line()})")
    out, wall = results[("ir", "--json")]
    report = json.loads(out)
    if (report["tool"], report["ok"], report["kernel_count"], report["finding_count"]) != (
            "graftcheck-ir", True, 18, 0):
        raise AssertionError(f"graftcheck ir --json: {out[-2000:]}")
    peaks = {k["kernel"]: k["facts"]["peak_live_bytes"] for k in report["kernels"]}
    log(f"checkers: graftcheck ir --json: exit 0 in {wall:.3f} s as a process (beside the "
        f"other checkers); {report['kernel_count']} kernels, {report['finding_count']} "
        f"findings, peak live bytes {json.dumps(peaks)} ({card_line()})")
    out, wall = results[("lint", "--json")]
    report = json.loads(out)
    files = sum(1 for path in (root / "spark_examples_tpu_torch").rglob("*.py")
                if "__pycache__" not in path.parts)
    if (report["tool"], report["finding_count"], report["checked_files"]) != (
            "graftcheck", 0, files):
        raise AssertionError(f"graftcheck lint --json: {out[-2000:]} (package files: {files})")
    log(f"checkers: graftcheck lint --json: exit 0 in {wall:.3f} s as a process (beside the "
        f"other checkers); {report['checked_files']} files, {report['finding_count']} findings "
        f"({card_line()})")


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
        from spark_examples_tpu_torch.ops import _kernels, batched, depth, devicegen, gramian, ld
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
    floor_ms = launch_floor_ms(torch)
    rows = phase_kernels(torch, devicegen)
    rows["unpack_rows_t"], _ = phase_unpack(torch, devicegen, gramian, int32_rate)
    rows["case_counts"], rows["gram_accumulate_ld_window"] = phase_ld_kernels(
        torch, devicegen, gramian, ld, int32_rate, floor_ms)
    per_op, rows["scratch_copy"] = phase_probe_kernels(
        torch, probe_ops, vmem_capacity, int32_rate, libs["probes.cu"])
    rows.update(phase_depth_kernels(torch, depth, int32_rate, floor_ms))
    ring_rows, _ = phase_ring_kernels(torch, devicegen, gramian)
    rows.update(ring_rows)
    fused_rows, _ = phase_fused_kernels(torch, batched, devicegen, gramian)
    rows.update(fused_rows)
    phase_count_variants(floor_ms)

    path_kernels = devicegen.KERNELS + gramian.KERNELS + ld.KERNELS + batched.KERNELS
    # The first run in a process also pays the CUDA libraries' lazy set-up
    # (the eigensolve's first cuSOLVER call); the second is the warm time.
    device_path = ("gen_genotypes", "gram_accumulate")
    host_fed = ("unpack_rows_t", "gram_accumulate")
    run_main_path(torch, path_kernels, CHR17_ARGV, "chr17 cold", device_path)
    launches, chr17_run = run_main_path(torch, path_kernels, CHR17_ARGV, "chr17", device_path)
    chr17_g = chr17_run.driver.accumulator.G.clone()
    del chr17_run
    run_main_path(torch, path_kernels, CHR17_CLI_ARGV, "chr17 default block", device_path)
    run_main_path(torch, path_kernels, BRCA1_ARGV, "brca1", device_path)
    phase_many_sets(torch, devicegen, path_kernels)
    # Each run's results are dropped (the Gramians the file phase compares
    # with are kept on the host), so its peak device memory is its own.
    packed, packed_run = run_main_path(torch, path_kernels, PACKED_ARGV, "packed", host_fed)
    packed_g = packed_run.driver.accumulator.G.cpu()
    packed_g_dev = packed_run.driver.accumulator.G.clone()
    del packed_run
    _, wire_run = run_main_path(torch, path_kernels, WIRE_ARGV, "wire", host_fed)
    wire_g = wire_run.driver.accumulator.G.cpu()
    del wire_run
    set_id = GoogleGenomicsPublicData.THOUSAND_GENOMES_PHASE_1
    same_set_argv = ["--references", SAME_SET_WINDOW, "--num-samples", str(N_SAMPLES),
                     "--variant-set-id", f"{set_id},{set_id}"]
    run_main_path(torch, path_kernels, same_set_argv, "same-set wire", host_fed)
    launches["unpack_rows_t"] = packed["unpack_rows_t"]
    ring, unpacked_ring = phase_sharded(torch, path_kernels, {"chr17": chr17_g, "packed": packed_g_dev})
    launches["cross_accumulate"], launches["pack_rows_t"] = ring["cross_accumulate"], ring["pack_rows_t"]
    launches["transpose_rows_t"] = unpacked_ring["transpose_rows_t"]
    del chr17_g, packed_g_dev
    torch.cuda.empty_cache()
    phase_ring_schedule(torch)
    torch.cuda.empty_cache()
    phase_check_ranges(torch, path_kernels)
    torch.cuda.empty_cache()
    phase_multiprocess()
    phase_large_cohort(torch, path_kernels)
    phase_files(torch, path_kernels, host_fed, packed_g, wire_g)
    phase_grm(torch, path_kernels)
    phase_mesh_analyses(torch, path_kernels)
    fused = phase_fused(torch, path_kernels)
    for name in ("stacked_unpack_rows_t", "stacked_gram_accumulate"):
        launches[name] = fused[name]
    launches["gram_accumulate_ld_window"] = phase_ld(torch, path_kernels)["gram_accumulate"]
    launches["case_counts"] = phase_assoc(torch, path_kernels)["case_counts"]
    phase_checkpoint(torch, path_kernels)
    phase_rest(torch, path_kernels, wire_g)
    phase_telemetry(torch, path_kernels)
    phase_trace(torch, path_kernels)
    phase_serve(torch, path_kernels)
    phase_checkers()
    launches.update(phase_probe_entry_points(torch, probe_ops, vmem_capacity, per_op))
    t0 = time.perf_counter()
    examples_kernels = path_kernels + depth.KERNELS
    kernel_ms = {name: rows[name]["ms"] for name in ("depth_counts", "base_counts")}
    phase_variants_examples(torch, examples_kernels)
    *synthetic, reads_launches = phase_reads_examples(torch, depth, examples_kernels, kernel_ms)
    launches.update(reads_launches)
    phase_reads_sam(torch, examples_kernels, kernel_ms, *synthetic)
    log(f"examples: the variants, reads and SAM phases in {time.perf_counter() - t0:.1f} s")
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
        ("case_counts", "spark_examples_tpu_torch/csrc/ld.cu",
         "spark_examples_tpu/ops/ld.py:161"),
        ("gram_accumulate_ld_window", "spark_examples_tpu_torch/csrc/devicegen.cu",
         "spark_examples_tpu/ops/ld.py:48"),
        ("depth_counts", "spark_examples_tpu_torch/csrc/depth.cu",
         "spark_examples_tpu/ops/depth.py:30"),
        ("base_counts", "spark_examples_tpu_torch/csrc/depth.cu",
         "spark_examples_tpu/ops/depth.py:61"),
        ("cross_accumulate", "spark_examples_tpu_torch/csrc/devicegen.cu",
         "spark_examples_tpu/ops/gramian.py:651"),
        ("pack_rows_t", "spark_examples_tpu_torch/csrc/gramian.cu",
         "spark_examples_tpu/ops/gramian.py:377"),
        ("transpose_rows_t", "spark_examples_tpu_torch/csrc/gramian.cu",
         "spark_examples_tpu/ops/devicegen.py:1082"),
        ("stacked_unpack_rows_t", "spark_examples_tpu_torch/csrc/gramian.cu",
         "spark_examples_tpu/ops/batched.py:242"),
        ("stacked_gram_accumulate", "spark_examples_tpu_torch/csrc/devicegen.cu",
         "spark_examples_tpu/ops/batched.py:242"),
    ):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **({"floor_ms": r["floor_ms"]} if "floor_ms" in r else {}),
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
