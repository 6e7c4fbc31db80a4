"""Discovery by name: a configuration, a traffic mix and a metric added as
files and ``BENCHMARK.json`` entries, with no harness file edited, run."""

import io
import json

from gpubench.catalog import Benchmark
from gpubench.harness import main

from conftest import TINY_CONFIG, make_root

EXTRA_METRIC = '''
def read(ctx):
    return float(len(ctx.jobs))
'''


def test_added_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    bench_dir = root / "gpubench"
    config = dict(TINY_CONFIG, name="tiny-two", num_samples=17, limits=json.loads(
        (bench_dir / "configs" / "tiny.json").read_text())["limits"])
    (bench_dir / "configs" / "tiny-two.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "traffic" / "closed-fresh-cohorts.json").read_text())
    (bench_dir / "traffic" / "closed-three-checked.json").write_text(
        json.dumps(dict(mix, checked_jobs=3)))
    (bench_dir / "metrics" / "tiny.jobs_in_window.py").write_text(EXTRA_METRIC)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-two", "source": "https://example.org/tiny-two",
                           "file": "gpubench/configs/tiny-two.json", "reduced": [],
                           "why": "a second tiny cohort"})
    doc["workloads"].append({"name": "tiny-two-cell", "config": "tiny-two",
                             "traffic": "closed-three-checked", "chips": 1,
                             "why": "a second tiny cell"})
    doc["end_to_end"].append({"name": "tiny.jobs_in_window", "unit": "jobs", "better": "higher",
                              "bound": 0.25, "source": "host_clock",
                              "workloads": ["tiny-two-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    bench = Benchmark(root=root)
    out, err = io.StringIO(), io.StringIO()
    rc = main(["--workload", "tiny-two-cell", "--seed", "5", "--seconds", "0.3"],
              bench=bench, need_card=False, out=out, err=err)
    result = json.loads(out.getvalue().splitlines()[-1])
    assert rc == 0 and result["correct"] is True
    assert result["metrics"]["tiny.jobs_in_window"] == {
        "value": float(result["attempted"]), "unit": "jobs"}
    assert err.getvalue().count("judged job") == min(3, result["attempted"])
    # The first cell does not list the new metric, and is unchanged.
    names = [m.name for m in bench.metrics("tiny-cell", traced=False)]
    assert "tiny.jobs_in_window" not in names
