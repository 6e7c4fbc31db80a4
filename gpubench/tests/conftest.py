"""Fixtures of the benchmark's CPU tests: a tiny benchmark root, built in a
temporary directory from the real traffic mixes and metric readers."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench.catalog import Benchmark  # noqa: E402

BENCH_DIR = ROOT / "gpubench"
TINY_CELL = "tiny-cell"

#: A cohort small enough for the CPU: 24 samples, two contigs that share
#: grid indices (the reference's weights), 5,000 candidate sites.
TINY_CONFIG = {
    "name": "tiny",
    "num_samples": 24,
    "variant_set_id": "tinyset",
    "all_references": False,
    "contigs": [["17", 0, 300000], ["18", 0, 200000]],
    "variant_spacing": 100,
    "n_pops": 4,
    "ref_block_fraction": 0.1,
    "min_allele_frequency": None,
    "ingest": "device",
    "block_size": 1024,
    "num_pc": 2,
}


def make_root(tmp: Path, config: dict = TINY_CONFIG) -> Path:
    """A benchmark root holding ``BENCHMARK.json`` with one tiny cell on
    the first real cell's traffic mix and metrics, and the real limits of
    the 1000 Genomes configuration."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    real = json.loads((BENCH_DIR / "configs" / "1kg-2504-autosomes.json").read_text())
    (tmp / "gpubench" / "configs").mkdir(parents=True)
    shutil.copytree(BENCH_DIR / "traffic", tmp / "gpubench" / "traffic")
    shutil.copytree(BENCH_DIR / "metrics", tmp / "gpubench" / "metrics")
    doc = dict(config, limits=real["limits"])
    (tmp / "gpubench" / "configs" / "tiny.json").write_text(json.dumps(doc))
    bench["configs"] = [{"name": "tiny", "source": "https://example.org/tiny",
                         "file": "gpubench/configs/tiny.json", "reduced": [],
                         "why": "a tiny cohort for the CPU"}]
    first = bench["workloads"][0]
    bench["workloads"] = [{"name": TINY_CELL, "config": "tiny", "traffic": first["traffic"],
                           "chips": 1, "why": "a tiny cell for the CPU"}]
    for group in ("end_to_end", "per_layer"):
        bench[group] = [m for m in bench[group] if first["name"] in m.pop("workloads", [first["name"]])]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def strict_json(line: str):
    """The result line as JSON without NaN or Infinity."""

    def refuse(constant):
        raise ValueError(f"not strict JSON: {constant}")

    return json.loads(line, parse_constant=refuse)


@pytest.fixture
def tiny_bench(tmp_path) -> Benchmark:
    return Benchmark(root=make_root(tmp_path))


@pytest.fixture
def run_tiny(tiny_bench):
    """Run the tiny cell on the CPU: ``(exit code, result or None,
    standard error)``."""
    import io

    from gpubench.harness import main

    def run(*, seed=7, seconds=0.3, trace=0, jobs=None):
        out, err = io.StringIO(), io.StringIO()
        rc = main(["--workload", TINY_CELL, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], bench=tiny_bench, jobs=jobs, need_card=False,
                  out=out, err=err)
        lines = out.getvalue().splitlines()
        return rc, (strict_json(lines[-1]) if lines else None), err.getvalue()

    return run
