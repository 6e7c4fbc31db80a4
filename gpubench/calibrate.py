#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 gpubench/calibrate.py --workload pcoa-1kg-wgs --seeds 12 --control-seeds 3

In one process: the program's readings on ``--seeds`` run seeds (the
first window job of each, at the cell's own size) and the control's on
``--control-seeds`` (``reference.control_job``: the reference one
precision step down, in the program's place). Each reading prints as a
JSON line; the last line gives, for each number, the largest program
reading (the lower reading) and the smallest control reading (the upper
one).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from gpubench.catalog import Benchmark  # noqa: E402
from gpubench.harness import ControlJobs, PortJobs, Sink, power_limit  # noqa: E402
from gpubench.reference import Cohort  # noqa: E402
from gpubench.traffic import Traffic  # noqa: E402
from gpubench.verdict import NUMBERS, judge  # noqa: E402


def readings(jobs, config, traffic, seed, device):
    job_seed = traffic.job_seed(seed, traffic.warm_jobs)
    start = time.perf_counter()
    with contextlib.redirect_stdout(Sink()):
        output, _ = jobs(job_seed)
    job_s = time.perf_counter() - start
    start = time.perf_counter()
    reading = judge(Cohort.from_config(config, job_seed), output, int(config["num_pc"]), device)
    return reading, job_s, time.perf_counter() - start


def main(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2_000_000_000)
    args = p.parse_args(argv)
    bench = Benchmark()
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = Traffic.from_doc(cell["traffic"], bench.traffic(cell["traffic"]))
    device = torch.device("cuda", 0)
    print(json.dumps({"card": torch.cuda.get_device_name(device), "power_limit": power_limit(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    with contextlib.redirect_stdout(Sink()):
        port = PortJobs(config, "cuda")
        port(traffic.job_seed(args.first_seed, 0))
    lower = {}
    for i in range(args.seeds):
        seed = args.first_seed + i
        reading, job_s, judge_s = readings(port, config, traffic, seed, device)
        print(json.dumps({"kind": "program", "seed": seed, "job_s": job_s, "judge_s": judge_s,
                          **reading}), flush=True)
        for name in NUMBERS[1:]:
            lower[name] = max(lower.get(name, reading[name]), reading[name])
    del port
    upper = {}
    control = ControlJobs(config, device)
    for i in range(args.control_seeds):
        seed = args.first_seed + 1000 + i
        reading, job_s, judge_s = readings(control, config, traffic, seed, device)
        print(json.dumps({"kind": "control", "seed": seed, "job_s": job_s, "judge_s": judge_s,
                          **reading}), flush=True)
        for name in NUMBERS[1:]:
            upper[name] = min(upper.get(name, reading[name]), reading[name])
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
