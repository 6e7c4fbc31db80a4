"""On the card: a short run of each cell comes out correct. Skips where no
CUDA card is present."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["busy_s"] > 0
