"""No run holds JAX or the JAX package: module names compare by their whole
top-level name, and a run that finds one prints no result."""

import subprocess
import sys
import types

from gpubench.harness import FORBIDDEN, forbidden_modules

from conftest import ROOT

PROBE = """
import contextlib, io, sys
sys.path.insert(0, {root!r})
from gpubench.harness import PortJobs, forbidden_modules
from gpubench import calibrate, catalog, devtrace, reference, roofline, stats, traffic, verdict
from conftest import TINY_CONFIG
with contextlib.redirect_stdout(io.StringIO()):
    PortJobs(TINY_CONFIG, "cpu")(11)
print(sorted(forbidden_modules()), "spark_examples_tpu_torch" in sys.modules)
"""


def test_harness_and_port_load_no_jax():
    probe = PROBE.format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=str(ROOT / "gpubench" / "tests"), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_names_compare_whole(monkeypatch):
    for name in ("jaxtyping", "spark_examples_tpu_torch.ops", "flaxen", "jax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "spark_examples_tpu", types.ModuleType("spark_examples_tpu"))
    assert forbidden_modules() == ["jax", "spark_examples_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "spark_examples_tpu"}


def test_a_run_that_loaded_jax_prints_no_result(run_tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    rc, result, err = run_tiny()
    assert rc != 0 and result is None
    assert "jaxlib" in err.splitlines()[-1]
