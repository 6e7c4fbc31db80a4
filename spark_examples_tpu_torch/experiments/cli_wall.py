"""Wall-clock of one CLI run of the port, for two or more source trees in
turns on one card.

    python -m spark_examples_tpu_torch.experiments.cli_wall \\
        --tree build/parent --tree . --rounds 3 -- \\
        variants-pca --num-samples 2504 --ingest device

Each tree is a checkout of the repository (a parent unpacked with ``git
archive``, say). Every run is a fresh ``python -m spark_examples_tpu_torch``
process in its tree, as a user starts it, with ``--metrics-json``: the
process's wall-clock (host clock around the process, its start and
``import torch`` included) and the manifest's top-level spans. One untimed
run per tree first builds its kernels; then each round runs the trees in
order and in reverse (A B B A). Prints the card line, one JSON line per
run and one with each tree's medians. Runs on a CUDA card only, except
a ``graftcheck`` argv: the checkers are device-free, so it runs on any
host (the card line then reads ``no card``), without a manifest — the
process's wall alone, which must exit 0::

    python -m spark_examples_tpu_torch.experiments.cli_wall \
        --tree . --rounds 2 -- graftcheck sched --json

With ``--positions N`` the argv (flags, no verb) runs through
``run_pipeline(conf, devices=[cuda:0] * N)`` instead, a mesh of N
positions of one card (the CLI resolves a mesh over N cards), once untimed
and once timed in each process: the wall-clock of the timed run (host
clock around it, ending in a synchronise) and its spans::

    python -m spark_examples_tpu_torch.experiments.cli_wall \
        --tree build/parent --tree . --rounds 1 --positions 4 -- \
        --references 17:0:81195210 --num-samples 25000 --ingest device \
        --block-size 16384 --mesh-shape 1,4 --similarity-strategy sharded

With ``--admissions N`` the argv (flags, no verb) is a served
``similarity`` job instead: each process starts a ``PcaService`` with its
HTTP server on port 0 (over ``--positions`` positions of cuda:0, default
one), submits the job once and waits for it, then submits it ``N`` times
back to back through ``ServeClient``, each submit timed to its 202 on the
host clock, waits for every job to settle done and stops the daemon. A
run's ``wall_s`` is then its median admission, ``spans_s`` holds the
process's first admission and its largest::

    python -m spark_examples_tpu_torch.experiments.cli_wall \
        --tree build/parent --tree . --rounds 3 --admissions 20 -- \
        --references 17:41196311:41206311 --num-samples 2504 --ingest packed
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


#: Run in each tree's own process for ``--positions``: the pipeline over
#: positions of cuda:0, untimed then timed; prints one JSON object.
WORKER = r'''
import contextlib, io, json, sys, time
import torch
from spark_examples_tpu_torch.config import PcaConf
from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

argv, positions = json.loads(sys.argv[1]), int(sys.argv[2])
devices = [torch.device("cuda", 0)] * positions
for timed in (False, True):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = run_pipeline(PcaConf.parse(argv), devices=devices)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = {s["path"]: s["seconds"] for s in result.driver.spans.flat()}
    del result
print(json.dumps({"wall_s": wall, "spans_s": spans}))
'''

#: Run in each tree's own process for ``--admissions``: a daemon that
#: admits the job ``requests`` times after a first one; prints one JSON
#: object.
ADMISSIONS_WORKER = r'''
import json, statistics, sys, tempfile, time
from spark_examples_tpu_torch.serve.client import ServeClient
from spark_examples_tpu_torch.serve.daemon import PcaService
from spark_examples_tpu_torch.serve.http import start_server

argv, positions, requests = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
with tempfile.TemporaryDirectory() as run_dir:
    service = PcaService(run_dir=run_dir, small_capacity=2 * requests + 2,
                         devices=["cuda:0"] * positions).start()
    server = start_server(service)
    try:
        client = ServeClient(server.url)
        t0 = time.perf_counter()
        first = client.submit(argv, kind="similarity")["job"]["id"]
        first_s = time.perf_counter() - t0
        client.wait(first, timeout=300)
        latencies, ids = [], []
        for _ in range(requests):
            t0 = time.perf_counter()
            ids.append(client.submit(argv, kind="similarity")["job"]["id"])
            latencies.append(time.perf_counter() - t0)
        done = [client.wait(i, timeout=300)["job"]["status"] for i in ids]
    finally:
        server.shutdown()
        server.server_close()
        service.stop(timeout=120)
if done.count("done") != requests:
    sys.exit(f"{done.count('done')} of {requests} admitted jobs settled done")
print(json.dumps({"wall_s": statistics.median(latencies),
                  "spans_s": {"first_admission": first_s, "max_admission": max(latencies)}}))
'''


def run_worker(tree: Path, worker: str, *args) -> dict:
    """``worker`` (:data:`WORKER` or :data:`ADMISSIONS_WORKER`) on ``args``
    in ``tree``'s own process: its JSON object."""
    proc = subprocess.run(
        [sys.executable, "-c", worker, *(str(a) for a in args)],
        cwd=tree, env=dict(os.environ, PYTHONPATH=str(tree)),
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode:
        raise RuntimeError(f"{tree}: rc {proc.returncode}: {proc.stderr[-2000:]}")
    return {"tree": str(tree), **json.loads(proc.stdout.strip().splitlines()[-1])}


def run_once(tree: Path, argv, workdir: Path) -> dict:
    """One CLI process in ``tree``: its wall-clock and top-level spans
    (none for ``graftcheck``, which writes no manifest)."""
    manifest = None if argv[:1] == ["graftcheck"] else workdir / f"m-{time.monotonic_ns()}.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch", *argv,
         *(() if manifest is None else ("--metrics-json", str(manifest)))],
        cwd=tree, env=dict(os.environ, PYTHONPATH=str(tree)),
        capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"{tree}: rc {proc.returncode}: {proc.stderr[-2000:]}")
    spans = ({} if manifest is None else
             {s["name"]: s["seconds"] for s in json.loads(manifest.read_text())["spans"]})
    return {"tree": str(tree), "wall_s": wall, "spans_s": spans}


def main(args=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", required=True, type=Path)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--positions", type=int, default=0,
                        help="run the flags through run_pipeline on this many positions of cuda:0")
    parser.add_argument("--admissions", type=int, default=0,
                        help="time this many served admissions of the flags a process")
    parser.add_argument("argv", nargs=argparse.REMAINDER)
    ns = parser.parse_args(args)
    argv = ns.argv[1:] if ns.argv[:1] == ["--"] else ns.argv
    trees = [t.resolve() for t in ns.tree]
    if argv[:1] == ["graftcheck"] and shutil.which("nvidia-smi") is None:
        card = "no card"
    else:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = {str(t): [] for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)

        def run(tree):
            if ns.admissions:
                return run_worker(tree, ADMISSIONS_WORKER, json.dumps(argv),
                                  max(ns.positions, 1), ns.admissions)
            if ns.positions:
                return run_worker(tree, WORKER, json.dumps(argv), ns.positions)
            return run_once(tree, argv, workdir)

        for tree in trees:
            run(tree)
        for _ in range(ns.rounds):
            for tree in trees + trees[::-1]:
                result = run(tree)
                runs[str(tree)].append(result)
                print(json.dumps(result), flush=True)
    print(json.dumps({tree: {
        "runs": len(rs),
        "median_wall_s": statistics.median(r["wall_s"] for r in rs),
        "median_spans_s": {name: statistics.median(r["spans_s"][name] for r in rs)
                           for name in rs[0]["spans_s"]},
    } for tree, rs in runs.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
