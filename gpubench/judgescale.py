#!/usr/bin/env python3
"""The judge's own cost at a cohort size, on the card.

    python3 gpubench/judgescale.py --config gnomad-v2.1-genomes-chr17 --num-samples 76156 --control

Builds the reference's own output for one cohort of a configuration's
sizes (``--num-samples`` overrides its sample count): its int32 Gramian
and its components as ``format_rows`` emits them. Then judges that output
with ``verdict.judge`` while holding it, as the harness holds a window
job's, and prints one JSON line: the readings, the judge's wall and the
device peak over the judge (``max_memory_allocated`` after
``reset_peak_memory_stats``, the held output included). ``--control``
judges ``control_job``'s output the same way.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from gpubench.catalog import Benchmark  # noqa: E402
from gpubench.harness import power_limit  # noqa: E402
from gpubench.reference import (  # noqa: E402
    Centred,
    Cohort,
    JobOutput,
    control_job,
    format_rows,
    reference_gramian,
    top_components,
)
from gpubench.verdict import judge  # noqa: E402


def reference_output(cohort: Cohort, num_pc: int, device) -> JobOutput:
    G = reference_gramian(cohort, device)
    V, _ = top_components(Centred(G), num_pc)
    return JobOutput(format_rows(cohort, V), G)


def judged(kind: str, make, cohort: Cohort, num_pc: int, device) -> dict:
    start = time.perf_counter()
    output = make(cohort, num_pc, device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - start
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    reading = judge(cohort, output, num_pc, device)
    torch.cuda.synchronize(device)
    judge_s = time.perf_counter() - start
    return {"kind": kind, "num_samples": cohort.num_samples, "seed": cohort.seed,
            "build_s": build_s, "judge_s": judge_s,
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "gramian_bytes": 4 * cohort.num_samples**2, **reading}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True, help="a configuration's name in BENCHMARK.json")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("judgescale: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    config = Benchmark().config(args.config)
    if args.num_samples is not None:
        config["num_samples"] = args.num_samples
    cohort = Cohort.from_config(config, args.seed)
    num_pc = int(config["num_pc"])
    print(json.dumps({"card": torch.cuda.get_device_name(device), "power_limit": power_limit(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    print(json.dumps(judged("reference", reference_output, cohort, num_pc, device)), flush=True)
    if args.control:
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(judged("control", control_job, cohort, num_pc, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
