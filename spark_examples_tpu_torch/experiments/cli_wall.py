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
run and one with each tree's medians. Runs on a CUDA card only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def run_once(tree: Path, argv, workdir: Path) -> dict:
    """One CLI process in ``tree``: its wall-clock and top-level spans."""
    manifest = workdir / f"m-{time.monotonic_ns()}.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch", *argv, "--metrics-json", str(manifest)],
        cwd=tree, env=dict(os.environ, PYTHONPATH=str(tree)),
        capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"{tree}: rc {proc.returncode}: {proc.stderr[-2000:]}")
    spans = {s["name"]: s["seconds"] for s in json.loads(manifest.read_text())["spans"]}
    return {"tree": str(tree), "wall_s": wall, "spans_s": spans}


def main(args=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", required=True, type=Path)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("argv", nargs=argparse.REMAINDER)
    ns = parser.parse_args(args)
    argv = ns.argv[1:] if ns.argv[:1] == ["--"] else ns.argv
    trees = [t.resolve() for t in ns.tree]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = {str(t): [] for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        for tree in trees:
            run_once(tree, argv, workdir)
        for _ in range(ns.rounds):
            for tree in trees + trees[::-1]:
                result = run_once(tree, argv, workdir)
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
