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


#: Modules this test must cover, one per layer the slices added.
EXPECTED_MODULES = (
    "spark_examples_tpu_torch.analyses.base",
    "spark_examples_tpu_torch.analyses.grm",
    "spark_examples_tpu_torch.api",
    "spark_examples_tpu_torch.check.hostmem",
    "spark_examples_tpu_torch.experiments.cli_wall",
    "spark_examples_tpu_torch.experiments.probe_ops",
    "spark_examples_tpu_torch.experiments.vmem_capacity",
    "spark_examples_tpu_torch.models.variant",
    "spark_examples_tpu_torch.obs.heartbeat",
    "spark_examples_tpu_torch.obs.manifest",
    "spark_examples_tpu_torch.obs.metrics",
    "spark_examples_tpu_torch.ops.contracts",
    "spark_examples_tpu_torch.ops.devicegen",
    "spark_examples_tpu_torch.ops.gramian",
    "spark_examples_tpu_torch.parallel.mesh",
    "spark_examples_tpu_torch.pipeline.checkpoint",
    "spark_examples_tpu_torch.pipeline.datasets",
    "spark_examples_tpu_torch.pipeline.pca_driver",
    "spark_examples_tpu_torch.pipeline.sitewriter",
    "spark_examples_tpu_torch.sources.files",
    "spark_examples_tpu_torch.sources.rest",
    "spark_examples_tpu_torch.sources.stream",
    "spark_examples_tpu_torch.utils.cache",
    "spark_examples_tpu_torch.utils.faults",
    "spark_examples_tpu_torch.utils.native",
    "spark_examples_tpu_torch.utils.retry",
    "spark_examples_tpu_torch.utils.sass",
    "spark_examples_tpu_torch.utils.tracing",
)


@pytest.mark.parametrize("module", EXPECTED_MODULES)
def test_every_layer_is_in_the_import_check(module):
    assert module in set(_modules())


def test_chip_smoke_has_no_jax_or_reference_imports():
    text = (REPO / "chip_smoke.py").read_text()
    assert not re.search(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+spark_examples_tpu\b(?!_torch)"
        r"|from\s+spark_examples_tpu(\.|\s)(?!.*_torch))",
        text,
        re.MULTILINE,
    )


@pytest.mark.parametrize(
    "argv",
    [
        ["--ingest", "packed"],
        ["--ingest", "wire", "--ingest-workers", "3"],
        ["--variant-set-id", "a,a"],
    ],
)
def test_host_fed_flags_parse(argv):
    from spark_examples_tpu_torch.config import PcaConf

    conf = PcaConf.parse(argv + ["--device", "cpu"])
    assert conf.ingest in ("auto", "packed", "wire")


def test_negative_ingest_workers_raise():
    from spark_examples_tpu_torch.config import PcaConf

    with pytest.raises(ValueError, match="--ingest-workers"):
        PcaConf.parse(["--ingest-workers", "-1"])


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


@pytest.mark.parametrize("verb", ["ld-prune", "serve", "search-variants-brca1"])
def test_cli_unported_verbs_exit_2(verb, capsys):
    from spark_examples_tpu_torch.cli import main

    assert main([verb]) == 2
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize(
    "flags, named",
    [
        (["--num-processes", "2"], "--num-processes"),
        (["--coordinator-address", "h:1"], "--coordinator-address"),
        (["--similarity-strategy", "sharded"], "--similarity-strategy sharded"),
        (["--mesh-shape", "1,2"], "--mesh-shape"),
        (["--trace-dir", "t"], "--trace-dir"),
        (["--reduce-schedule", "flat"], "--reduce-schedule"),
    ],
)
def test_unported_flags_raise_naming_the_flag(flags, named):
    from spark_examples_tpu_torch.config import PcaConf

    with pytest.raises(NotImplementedError, match=re.escape(named)):
        PcaConf.parse(flags + ["--device", "cpu"])


@pytest.mark.parametrize(
    "flags",
    [
        ["--metrics-json", "m.json"],
        ["--heartbeat-seconds", "5"],
        ["--profile-dir", "p"],
        ["--save-variants", "v"],
        ["--input-path", "ck"],
        ["--source", "file", "--input-files", "a.vcf.gz,b.jsonl"],
        ["--source", "file", "--input-files", "a.vcf", "--stream-chunk-bytes", "4096"],
        ["--checkpoint-every-sites", "10"],
        ["--resume-from", "ck"],
        ["--gramian-checkpoint-dir", "ck"],
        ["--fault-plan", "ioerror@files.read#2"],
        ["--source", "rest"],
    ],
)
def test_ported_flags_parse(flags):
    """The file and REST sources, variant and Gramian checkpoints, fault
    plans and run telemetry flags parse with the reference's validation
    instead of raising."""
    from spark_examples_tpu_torch.config import PcaConf

    conf = PcaConf.parse(flags + ["--device", "cpu"])
    if "--input-files" in flags:
        assert conf.variant_set_id == [p.split("/")[-1].split(".")[0]
                                       for p in conf.input_files]


@pytest.mark.parametrize(
    "flags, message",
    [
        (["--source", "file"], "--input-files"),
        (["--heartbeat-seconds", "-1"], "--heartbeat-seconds"),
        (["--source", "file", "--input-files", "a.vcf", "--num-samples", "3,4"],
         "synthetic-source-only"),
        (["--fault-plan", "files.read:fail"], "is not action@site"),
        (["--checkpoint-every-sites", "0"], "--checkpoint-every-sites"),
    ],
)
def test_ported_flags_validate_like_the_reference(flags, message):
    from spark_examples_tpu.config import PcaConf as RefConf
    from spark_examples_tpu_torch.config import PcaConf

    with pytest.raises(ValueError):
        RefConf.parse(flags)
    with pytest.raises(ValueError, match=message):
        PcaConf.parse(flags)
