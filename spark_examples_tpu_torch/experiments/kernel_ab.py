"""Kernel times of two or more source trees in turns on one card.

    python -m spark_examples_tpu_torch.experiments.kernel_ab \\
        --tree build/parent --tree . --rounds 2

Each tree is a checkout of the repository (a parent unpacked with ``git
archive``, say). For every tree, in turns (A B B A each round, after one
untimed run per tree that builds its kernels), a fresh process imports
that tree's ``spark_examples_tpu_torch`` and times, with CUDA events, the
same inputs made from fixed seeds:

- ``gram_accumulate`` at the Gramian's shapes: 2,504 samples × 16,384 and
  1,024 sites (the device path's and the CLI's blocks), and 17 samples
  (the platinum cohort) × the same;
- the LD window product: ``gram_accumulate`` into a (256, 256) C from the
  unpacked 256-site × 2,504-sample window, and the program
  (``ld.window_counts``: unpack, zeroed C, product);
- ``case_counts`` at 1,024 and 16,384 rows × 2,504 samples, shipped by
  ``ld.pack_rows`` and ``ld.pack_case`` as the scan ships them;
- ``depth_counts`` at a whole-chr21 shard of example 3 (26,194 reads,
  W = 327,542) and ``base_counts`` at an example-4 shard (4,210 reads ×
  128, W = 52,759);
- the ring's kernels (trees that have them): ``cross_accumulate`` into a
  column slice of a row tile 4 positions wide at 632 × 632 and 6,250 ×
  6,250 × 1,024 and 16,384 sites (2,504 and 25,000 samples over 4
  positions), beside ``torch._int_mm`` on the same operands plus the
  slice add; ``pack_rows_t`` of a 632- and a 6,256-column Xᵀ × 16,384
  sites (a position's packed tile at 2,504 and 25,000 samples) and
  ``unpack_rows_t`` of the packed tile back;
- ``unpack_rows_t`` of a host-fed bit-packed block at 2,504 samples ×
  1,024 and 16,384 rows (the packed arm's flush);
- the stacked jobs' kernels (trees that have ``ops/batched.py``) at
  2,504 samples, K = 2, 4 and 6 lanes × 1,024 and 16,384 rows:
  ``stacked_unpack_rows_t``, ``stacked_gram_accumulate`` and the step
  (both), beside the K-launch loop (``unpack_rows_t`` then
  ``gram_accumulate`` a lane) and K calls of ``torch._int_mm`` plus the
  add into the lane's G;
- the launch floor: ``torch.cuda._sleep(0)`` in the same harness;
- in every process, ``torch._int_mm`` on the LD window's operand and
  ``torch.bincount`` of the chr21 shard's covered positions, the same
  calls in every tree (a gauge of the card between processes).

Prints the card line, one JSON line per run and one with each tree's
medians. The worker calls each wrapper as a tree without the product's
``split`` argument calls it, so an older tree runs the same code. Runs on
a CUDA card only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

#: Run in each tree's own process; prints one JSON object of milliseconds.
WORKER = r'''
import json
import numpy as np
import torch
from spark_examples_tpu_torch.ops import depth, devicegen, gramian, ld
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.utils.device import cuda_event_ms as cuda_ms

dev = torch.device("cuda")
rng = np.random.default_rng(2504)
out = {}
for n in (2504, 17):
    rows = -(-n // 128) * 128
    G = torch.zeros((n, n), dtype=torch.int32, device=dev)
    for sites in (16384, 1024):
        bits = (rng.random((rows, sites)) < 0.3).astype(np.int8)
        xt = torch.from_numpy(bits).to(dev)
        out[f"gram_accumulate {n}x{sites}"] = cuda_ms(lambda: devicegen.gram_accumulate(G, xt), 50)
window = (rng.random((256, 2504)) < 0.3).astype(np.uint8)
packed = torch.from_numpy(ld.pack_window(window)).to(dev)
xt = gramian.unpack_rows_t(packed, 256)
C = torch.zeros((256, 256), dtype=torch.int32, device=dev)
out["ld window product"] = cuda_ms(lambda: devicegen.gram_accumulate(C, xt), 50)
out["ld window program"] = cuda_ms(lambda: ld.window_counts(packed, 256), 50)
out["torch._int_mm ld window"] = cuda_ms(lambda: torch._int_mm(xt, xt.t()), 50)
crng = np.random.default_rng(313)
case_t = ld.pack_case((np.arange(2504) % 2).astype(np.uint8), dev)
for rows in (1024, 16384):
    block = ld.pack_rows((crng.random((rows, 2504)) < 0.3).astype(np.uint8), dev)
    out[f"case_counts {rows}x2504"] = cuda_ms(lambda: ld.case_counts(block, case_t, 2504), 50)
start, span = 1_000_000, 327_414
starts = np.array(sorted(p for p, _ in SyntheticGenomicsSource(num_samples=1).read_starts(
    start, start + span)), dtype=np.int32)
W = span + 128
pos = torch.from_numpy(starts).to(dev)
lens = torch.full((len(starts),), 100, dtype=torch.int32, device=dev)
out["depth_counts chr21 shard"] = cuda_ms(
    lambda: depth.depth_counts(pos, lens, start, W, 128), 50)
idx = (pos.long() - start)[:, None] + torch.arange(100, device=dev)[None, :]
flat = idx[(idx >= 0) & (idx < W)]
out["torch.bincount chr21 shard"] = cuda_ms(lambda: torch.bincount(flat, minlength=W), 50)
R, W4 = 4210, 52_631 + 128
pos4 = torch.from_numpy(rng.integers(start - 100, start + W4 + 50, R).astype(np.int32)).to(dev)
codes = torch.from_numpy(rng.integers(-1, 4, (R, 128)).astype(np.int8)).to(dev)
ok = torch.from_numpy((rng.random((R, 128)) < 11 / 21).astype(np.uint8)).to(dev)
out["base_counts example-4 shard"] = cuda_ms(
    lambda: depth.base_counts(pos4, codes, ok, start, W4), 50)
if hasattr(devicegen, "cross_accumulate"):
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)

    def bits(rows, sites):
        return (torch.rand((rows, sites), device=dev, generator=gen) < 0.3).to(torch.int8)

    for m in (632, 6250):
        pad = -(-m // 128) * 128
        tile = torch.zeros((m, 4 * m), dtype=torch.int32, device=dev)
        C = tile[:, m : 2 * m]
        for sites in (1024, 16384):
            a, b = bits(pad, sites), bits(pad, sites)
            iters = 20 if m * sites > 10**7 else 50
            out[f"cross_accumulate {m}x{m}x{sites}"] = cuda_ms(
                lambda: devicegen.cross_accumulate(C, a, b), iters)
            out[f"torch._int_mm + add {m}x{m}x{sites}"] = cuda_ms(
                lambda: C.add_(torch._int_mm(a, b.t())[:m, :m]), iters)
            del a, b
        del tile, C
    for cols in (632, 6256):
        xt = bits(-(-cols // 128) * 128, 16384)
        out[f"pack_rows_t {cols}x16384"] = cuda_ms(lambda: gramian.pack_rows_t(xt, cols), 50)
        packed = gramian.pack_rows_t(xt, cols)
        out[f"unpack_rows_t ring {cols}x16384"] = cuda_ms(
            lambda: gramian.unpack_rows_t(packed, cols), 50)
for rows in (1024, 16384):
    block = torch.from_numpy(
        np.packbits((rng.random((rows, 2504)) < 0.3).astype(np.uint8), axis=-1)).to(dev)
    out[f"unpack_rows_t 2504x{rows}"] = cuda_ms(lambda: gramian.unpack_rows_t(block, 2504), 50)
try:
    from spark_examples_tpu_torch.ops import batched
except ImportError:
    batched = None
if batched is not None:
    n = 2504
    for k in (2, 4, 6):
        G = torch.zeros((k, n, n), dtype=torch.int32, device=dev)
        for rows in (1024, 16384):
            packed = torch.from_numpy(np.packbits(
                (rng.random((k, rows, n)) < 0.3).astype(np.uint8), axis=-1)).to(dev)
            xt = batched.stacked_unpack_rows_t(packed, n)
            singles = [gramian.unpack_rows_t(packed[j], n) for j in range(k)]
            iters = 20 if rows > 1024 else 50
            shape = f"{k}x{n}x{rows}"

            def loop():
                for j in range(k):
                    devicegen.gram_accumulate(G[j], gramian.unpack_rows_t(packed[j], n))

            def int_mm():
                for j in range(k):
                    G[j].add_(torch._int_mm(singles[j][:n], singles[j][:n].t()))

            out[f"stacked_unpack_rows_t {shape}"] = cuda_ms(
                lambda: batched.stacked_unpack_rows_t(packed, n), iters)
            out[f"stacked_gram_accumulate {shape}"] = cuda_ms(
                lambda: batched.stacked_gram_accumulate(G, xt), iters)
            out[f"stacked step {shape}"] = cuda_ms(
                lambda: batched.stacked_gram_accumulate(G, batched.stacked_unpack_rows_t(packed, n)),
                iters)
            out[f"K-launch loop {shape}"] = cuda_ms(loop, iters)
            out[f"torch._int_mm loop {shape}"] = cuda_ms(int_mm, iters)
            del packed, xt, singles
        del G
out["launch floor"] = cuda_ms(lambda: torch.cuda._sleep(0), 50)
print(json.dumps(out))
'''


def run_once(tree: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", WORKER], cwd=tree, env=dict(os.environ, PYTHONPATH=str(tree)),
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode:
        raise RuntimeError(f"{tree}: rc {proc.returncode}: {proc.stderr[-3000:]}")
    return {"tree": str(tree), "ms": json.loads(proc.stdout.strip().splitlines()[-1])}


def main(args=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", required=True, type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    ns = parser.parse_args(args)
    trees = [t.resolve() for t in ns.tree]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for tree in trees:
        run_once(tree)
    runs = {str(t): [] for t in trees}
    for _ in range(ns.rounds):
        for tree in trees + trees[::-1]:
            result = run_once(tree)
            runs[str(tree)].append(result["ms"])
            print(json.dumps(result), flush=True)
    print(json.dumps({tree: {name: statistics.median(r[name] for r in rs) for name in rs[0]}
                      for tree, rs in runs.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
