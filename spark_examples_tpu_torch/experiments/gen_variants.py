"""Measure ``gen_genotypes_kernel`` against the designs it was chosen over.

    python -m spark_examples_tpu_torch.experiments.gen_variants [--parent FILE]

Builds ``csrc/devicegen.cu`` as it is ("kept") and two variants of it,
each one design decision of the kernel turned the other way:

- "shared-metadata": every block of a cluster computes the site metadata of
  its own share of the 64-site tile only, and the blocks gather the rest
  from their peers' shared memory after a cluster barrier;
- "tma-store": each staged chunk of Xᵀ leaves by one TMA tensor store (a
  tensor map encoded per launch) instead of 16-byte stores, with a second
  barrier a chunk before a staging buffer is written again.

``--parent FILE`` adds another ``devicegen.cu`` whose launcher reads the
stream keys from device memory, as the kernel before the clusters did
(``git show <commit>:spark_examples_tpu_torch/csrc/devicegen.cu``). Each
build is held exactly against ``gen_genotypes_plain`` (a full block, the
CLI's 1,024-site block and a ragged tail at 2,504 samples), then timed with
CUDA events at 16,384 and 1,024 sites, the builds in turns, forward and
backward, twice. Prints the card line and one JSON object of the times.
Runs on a CUDA card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from spark_examples_tpu_torch.ops import _kernels, devicegen
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.utils.device import cuda_event_ms

SITES = (16_384, 1_024)
CHECKS = ((400_000, 16_384, 16_384), (400_000, 1_024, 1_024), (811_000, 5_000, 16_384))
ROUNDS = 2
BUILD_DIR = _kernels.BUILD_DIR / "gen_variants"


def _patch(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/devicegen.cu no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def shared_metadata(text: str) -> str:
    """Each block computes its share of the tile's sites; a cluster barrier;
    the rest is gathered from the owners' shared memory."""
    return _patch(text, [
        ("  cluster_arrive();\n", ""),
        ("  cluster_wait();\n", ""),
        ("  for (int i = tid; i < GEN_SITES * (p.n_pops + p.n_sets); i += GEN_THREADS) {\n"
         "    const int site = i % GEN_SITES, item = i / GEN_SITES;\n",
         "  const int lo = (rank * GEN_SITES + blocks - 1) / blocks;\n"
         "  const int share = ((rank + 1) * GEN_SITES + blocks - 1) / blocks - lo;\n"
         "  for (int i = tid; i < share * (p.n_pops + p.n_sets); i += GEN_THREADS) {\n"
         "    const int site = lo + i % share, item = i / share;\n"),
        ("  if (tid < GEN_COLS) s_col[0][tid] = next;\n  __syncthreads();\n",
         "  cluster.sync();\n"
         "  for (int i = tid; i < GEN_SITES * (p.n_pops + p.n_sets + 1); i += GEN_THREADS) {\n"
         "    const int site = i % GEN_SITES, field = i / GEN_SITES;\n"
         "    const int owner = site * blocks / GEN_SITES;\n"
         "    if (owner == rank) continue;\n"
         "    uint32_t* row = field < p.n_pops ? s_thr[field]\n"
         "                    : field < p.n_pops + p.n_sets ? s_fsite[field - p.n_pops] : s_kept;\n"
         "    row[site] = *cluster.map_shared_rank(row + site, owner);\n"
         "  }\n"
         "  if (tid < GEN_COLS) s_col[0][tid] = next;\n  __syncthreads();\n"),
    ])


def tma_store(text: str) -> str:
    """Each staged chunk leaves by one TMA tensor store."""
    return _patch(text, [
        ("gen_genotypes_kernel(GenParams p,",
         "gen_genotypes_kernel(const __grid_constant__ CUtensorMap xt_map, GenParams p,"),
        ("  __shared__ __align__(16) uint32_t s_out[2]", "  __shared__ __align__(128) uint32_t s_out[2]"),
        ("    // The next chunk's columns load while this one is drawn.\n",
         "    if (tid == 0) asm volatile(\"cp.async.bulk.wait_group.read 1;\" ::: \"memory\");\n"
         "    __syncthreads();\n"),
        ("    if (tid < GEN_COLS) s_col[buf ^ 1][tid] = next;\n    __syncthreads();\n",
         "    if (tid < GEN_COLS) s_col[buf ^ 1][tid] = next;\n"
         "    asm volatile(\"fence.proxy.async.shared::cta;\" ::: \"memory\");\n"
         "    __syncthreads();\n"),
        ("    const int row = tid / (GEN_QUADS / 4), seg = tid % (GEN_QUADS / 4);\n"
         "    *reinterpret_cast<uint4*>(xt + static_cast<int64_t>(chunk * GEN_COLS + row) * p.ld + tile0 +\n"
         "                              16 * seg) = *reinterpret_cast<const uint4*>(out + row * GEN_QUADS + 4 * seg);\n",
         "    if (tid == 0) {\n"
         "      asm volatile(\"cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\"\n"
         "                   ::\"l\"(reinterpret_cast<uint64_t>(&xt_map)), \"r\"(smem_u32(out)),\n"
         "                   \"r\"(static_cast<int>(tile0)), \"r\"(chunk * GEN_COLS) : \"memory\");\n"
         "      asm volatile(\"cp.async.bulk.commit_group;\" ::: \"memory\");\n"
         "    }\n"),
        ("  // Lanes l and l ^ 16 hold the same sites",
         "  if (tid == 0) asm volatile(\"cp.async.bulk.wait_group.read 0;\" ::: \"memory\");\n"
         "  // Lanes l and l ^ 16 hold the same sites"),
        ("    status = cudaLaunchKernelEx(&config, gen_genotypes_kernel, p,",
         "    status = encoder(&encode);\n"
         "  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(n_cols_pad)};\n"
         "  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};\n"
         "  const cuuint32_t box[2] = {GEN_SITES, GEN_COLS};\n"
         "  const cuuint32_t unit[2] = {1, 1};\n"
         "  if (status == cudaSuccess &&\n"
         "      encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xt, dims, strides, box, unit,\n"
         "             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,\n"
         "             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)\n"
         "    return -1;\n"
         "  if (status == cudaSuccess)\n"
         "    status = cudaLaunchKernelEx(&config, gen_genotypes_kernel, map, p,"),
        ("  cudaLaunchConfig_t config;\n  cudaLaunchAttribute cluster;\n  int sms = 0;\n",
         "  cudaLaunchConfig_t config;\n  cudaLaunchAttribute cluster;\n  int sms = 0;\n"
         "  EncodeTiled encode = nullptr;\n  CUtensorMap map;\n"),
    ])


def build(name: str, text: str) -> ctypes.CDLL:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, out = BUILD_DIR / f"{name}.cu", BUILD_DIR / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC_DIR), "-o", str(out), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _kernels._SIGNATURES["devicegen.cu"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def parent_launch(lib, plan, offset, n_valid, sites, kept, rows):
    """The launcher of a kernel that reads the stream keys from device memory."""
    ld = -(-sites // devicegen.SITE_TILE) * devicegen.SITE_TILE
    xt = torch.empty((plan.n_cols_pad, ld), dtype=torch.int8, device=kept.device)
    status = lib.gen_genotypes_launch(
        xt.data_ptr(), kept.data_ptr(), rows.data_ptr(), plan.vs_keys.data_ptr(),
        plan.col_fsamp.data_ptr(), plan.col_set.data_ptr(), plan.col_pop.data_ptr(),
        offset, n_valid, plan.spacing, plan.site_key, plan.ref_thresh, 0, 0, plan.n_pops,
        plan.n_sets, plan.n_cols, plan.n_cols_pad, ld, torch.cuda.current_stream().cuda_stream,
    )
    _kernels.check(status, "gen_genotypes (parent)")
    return xt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="a devicegen.cu whose keys live on the device")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gen_variants: no CUDA device is available", file=sys.stderr)
        return 1
    kept_text = (_kernels.CSRC_DIR / "devicegen.cu").read_text()
    sources = {"kept": kept_text, "shared-metadata": shared_metadata(kept_text),
               "tma-store": tma_store(kept_text)}
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    libs = {name: build(name, text) for name, text in sources.items()}

    dev = torch.device("cuda")
    source = SyntheticGenomicsSource(num_samples=2504)
    plan = devicegen.make_gen_plan(
        [source.genotype_stream_key("chip-smoke")], [source.populations], source.site_key,
        source.variant_spacing, source.ref_block_fraction, None, source.n_pops, dev,
    )
    counters = lambda: (torch.zeros((), dtype=torch.int64, device=dev),  # noqa: E731
                        torch.zeros((1,), dtype=torch.int64, device=dev))
    launch = devicegen.gen_genotypes

    def use(name):
        """gen_genotypes through the build `name`."""
        lib = libs[name]
        if name == "parent":
            return lambda *a: parent_launch(lib, plan, *a)
        devicegen._library = lambda: lib
        return lambda *a: launch(plan, *a)

    for name in libs:
        gen = use(name)
        for offset, n_valid, sites in CHECKS:
            (k1, r1), (k2, r2) = counters(), counters()
            got = gen(offset, n_valid, sites, k1, r1)
            want = devicegen.gen_genotypes_plain(plan, offset, n_valid, sites, k2, r2)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(k1, k2) and torch.equal(r1, r2)):
                raise AssertionError(f"{name} != plain at offset {offset}, {n_valid} of {sites} sites")
        print(f"gen_variants: {name} == plain at {len(CHECKS)} blocks", flush=True)

    times = {name: {sites: [] for sites in SITES} for name in libs}
    order = list(libs) + list(libs)[::-1]
    for _ in range(ROUNDS):
        for name in order:
            gen = use(name)
            kept, rows = counters()
            for sites in SITES:
                times[name][sites].append(
                    cuda_event_ms(lambda: gen(400_000, sites, sites, kept, rows), 50))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps({name: {str(s): {"mean_ms": sum(v) / len(v), "min_ms": min(v), "max_ms": max(v)}
                             for s, v in per.items()} for name, per in times.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
