"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU on their own."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import spark_examples_tpu_torch

PACKAGE = pathlib.Path(spark_examples_tpu_torch.__file__).resolve().parent
REPO = PACKAGE.parent


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        if rel.name != "__main__":
            yield ".".join(parts)


def test_importing_every_module_leaves_jax_out():
    """In a fresh interpreter (this test process already holds jax)."""
    code = (
        "import importlib, sys\n"
        f"for name in {list(_modules())!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spark_examples_tpu' or m.startswith('spark_examples_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_source_has_no_jax_or_reference_imports():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+spark_examples_tpu\b(?!_torch)"
        r"|from\s+spark_examples_tpu(\.|\s)(?!.*_torch))",
        re.MULTILINE,
    )
    offenders = [
        str(path.relative_to(REPO))
        for path in PACKAGE.rglob("*.py")
        if pattern.search(path.read_text())
    ]
    assert offenders == []


def test_default_entry_point_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spark_examples_tpu_torch.run(["--num-samples", "8", "--references", "17:0:2000"])


def test_cli_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from spark_examples_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["variants-pca", "--num-samples", "8", "--references", "17:0:2000"])


def test_cli_runs_on_the_cpu_when_asked(capsys):
    from spark_examples_tpu_torch.cli import main

    assert main(["variants-pca", "--num-samples", "8", "--references", "17:0:3000",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Matrix size: 8." in out and "Variants API stats:" in out


@pytest.mark.parametrize("verb", ["grm", "serve", "search-variants-brca1"])
def test_cli_unported_verbs_exit_2(verb, capsys):
    from spark_examples_tpu_torch.cli import main

    assert main([verb]) == 2
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize(
    "flags, named",
    [
        (["--metrics-json", "m.json"], "--metrics-json"),
        (["--heartbeat-seconds", "5"], "--heartbeat-seconds"),
        (["--profile-dir", "p"], "--profile-dir"),
        (["--resume-from", "ck"], "--resume-from"),
        (["--gramian-checkpoint-dir", "ck"], "--gramian-checkpoint-dir"),
        (["--coordinator-address", "h:1"], "--coordinator-address"),
        (["--similarity-strategy", "sharded"], "--similarity-strategy sharded"),
        (["--mesh-shape", "1,2"], "--mesh-shape"),
        (["--ingest", "packed"], "--ingest packed"),
        (["--ingest", "wire"], "--ingest wire"),
        (["--source", "rest"], "--source"),
    ],
)
def test_unported_flags_raise_naming_the_flag(flags, named):
    from spark_examples_tpu_torch.config import PcaConf

    with pytest.raises(NotImplementedError, match=re.escape(named)):
        PcaConf.parse(flags + ["--device", "cpu"])
