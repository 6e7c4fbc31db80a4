"""Time ``gen_genotypes_kernel`` against other ``devicegen.cu`` sources.

    python -m spark_examples_tpu_torch.experiments.gen_variants --parent FILE [--variant FILE ...]

Builds ``csrc/devicegen.cu`` as it is ("kept"), ``--parent``'s file
("parent"), a ``devicegen.cu`` whose launcher takes the stream keys as a
host array of eight, as the kernel of the 8-set cap did (``git show
<commit>:spark_examples_tpu_torch/csrc/devicegen.cu > build/parent.cu``),
and each ``--variant`` file (named by its stem), a ``devicegen.cu`` with
the kept launcher's C interface. Each build is held exactly against
``gen_genotypes_plain`` (a full block, the CLI's 1,024-site block and a
ragged tail at 2,504 samples, one variant set), then timed with CUDA events
at 16,384 and 1,024 sites, the builds in turns, forward and backward,
twice. Prints the card line and one JSON object of the times. Runs on a
CUDA card only.

Design alternatives measured against the kept kernel before (PERF.md):
site metadata shared through distributed shared memory, and TMA tensor
stores of the staged chunks; both were slower at the CLI's block size.
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


#: The parent launcher's C signature: xt, kept, rows, the keys (a host
#: array), fsamp, set, pop; grid_offset, n_valid, spacing; site_key,
#: ref_thresh, has_min_af, min_af; n_pops, n_sets, n_cols, n_cols_pad, ld;
#: the stream.
PARENT_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [
    ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def parent_launch(lib, plan, keys, offset, n_valid, sites, kept, rows):
    """The launcher of a kernel that takes the stream keys as a host array
    (``keys``, made once: reading them from the card here would
    synchronise every timed call)."""
    ld = -(-sites // devicegen.SITE_TILE) * devicegen.SITE_TILE
    xt = torch.empty((plan.n_cols_pad, ld), dtype=torch.int8, device=kept.device)
    status = lib.gen_genotypes_launch(
        xt.data_ptr(), kept.data_ptr(), rows.data_ptr(), keys,
        plan.col_fsamp.data_ptr(), plan.col_set.data_ptr(), plan.col_pop.data_ptr(),
        offset, n_valid, plan.spacing, plan.site_key, plan.ref_thresh, 0, 0, plan.n_pops,
        plan.n_sets, plan.n_cols, plan.n_cols_pad, ld, torch.cuda.current_stream().cuda_stream,
    )
    _kernels.check(status, "gen_genotypes (parent)")
    return xt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="a devicegen.cu whose launcher takes the keys as a host array")
    parser.add_argument("--variant", type=Path, action="append", default=[],
                        help="a devicegen.cu with the kept launcher's interface (repeatable)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gen_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sources = {"kept": (_kernels.CSRC_DIR / "devicegen.cu").read_text(),
               "parent": args.parent.read_text(),
               **{path.stem: path.read_text() for path in args.variant}}
    libs = {name: build(name, text) for name, text in sources.items()}
    libs["parent"].gen_genotypes_launch.argtypes = PARENT_ARGTYPES

    dev = torch.device("cuda")
    source = SyntheticGenomicsSource(num_samples=2504)
    plan = devicegen.make_gen_plan(
        [source.genotype_stream_key("chip-smoke")], [source.populations], source.site_key,
        source.variant_spacing, source.ref_block_fraction, None, source.n_pops, dev,
    )
    keys = (ctypes.c_uint64 * 8)(*[int(k) & (2**64 - 1) for k in plan.vs_keys.tolist()])
    counters = lambda: (torch.zeros((), dtype=torch.int64, device=dev),  # noqa: E731
                        torch.zeros((1,), dtype=torch.int64, device=dev))
    launch = devicegen.gen_genotypes

    def use(name):
        """gen_genotypes through the build `name`."""
        lib = libs[name]
        if name == "parent":
            return lambda *a: parent_launch(lib, plan, keys, *a)
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
