"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units, bounds, files and time budget, and the runner's refusals."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from gpubench.catalog import Benchmark

from conftest import BENCH_DIR, ROOT

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
E2E = {m["name"] for m in DOC["end_to_end"]}
CELLS = {c["name"] for c in DOC["workloads"]}


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "gpubench/run.py"]
    assert DOC["paths"] == ["gpubench"]
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)
    assert len(json.dumps(DOC)) < 64 * 1024


def test_every_run_of_a_full_check_fits_its_budget():
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_have_files_under_paths_and_are_used():
    used = {c["config"] for c in DOC["workloads"]}
    for entry in DOC["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(entry["name"]) and entry["name"] in used
        assert entry["file"].startswith("gpubench/") and (ROOT / entry["file"]).is_file()
        assert TEXT.match(entry["source"]) and TEXT.match(entry["why"])
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["reduced"] == entry["reduced"] and config["name"] == entry["name"]
        assert all(NAME.match(k) and k in config for k in entry["reduced"])
        assert set(config["limits"]) == {"failed_jobs", "rows_wrong", "gramian_mismatch",
                                         "pc_error"}


def test_cells_name_a_config_a_traffic_file_and_one_chip():
    pairs = set()
    for cell in DOC["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        assert (BENCH_DIR / "traffic" / f"{cell['traffic']}.json").is_file()
        assert cell["chips"] == 1 and TEXT.match(cell["why"])
        pairs.add((cell["config"], cell["traffic"]))
    assert len(pairs) == len(DOC["workloads"]) == len(CELLS)


def test_metrics_have_readers_and_valid_fields():
    names = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(set(names)) == len(names) and "setup_s" in E2E
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E and TEXT.match(m["layer"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= CELLS
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = Benchmark()
    for cell in CELLS:
        e2e = {m.name for m in bench.metrics(cell, traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = bench.metrics(cell, traced=True)
        assert layers
        for m in DOC["per_layer"]:
            if cell in m.get("workloads", [cell]):
                assert m["moves"] in e2e


def test_no_card_no_result(tmp_path):
    """Without a card (this machine), or with nothing but the benchmark's
    files, the runner exits non-zero and prints nothing on stdout."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "pcoa-1kg-wgs",
                              "--seed", "1", "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, cwd=str(cwd), timeout=300)
        if out.returncode == 0:
            pytest.fail(f"exit 0 from {cwd}: {out.stdout[-500:]}")
        assert out.stdout == ""
