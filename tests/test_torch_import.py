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
    "spark_examples_tpu_torch.analyses.assoc",
    "spark_examples_tpu_torch.analyses.base",
    "spark_examples_tpu_torch.analyses.grm",
    "spark_examples_tpu_torch.analyses.ld",
    "spark_examples_tpu_torch.analyses.reads_examples",
    "spark_examples_tpu_torch.analyses.variants_examples",
    "spark_examples_tpu_torch.api",
    "spark_examples_tpu_torch.check.cli",
    "spark_examples_tpu_torch.check.corpus",
    "spark_examples_tpu_torch.check.hostmem",
    "spark_examples_tpu_torch.check.ir",
    "spark_examples_tpu_torch.check.linter",
    "spark_examples_tpu_torch.check.lockgraph",
    "spark_examples_tpu_torch.check.plan",
    "spark_examples_tpu_torch.check.proto",
    "spark_examples_tpu_torch.check.ranges",
    "spark_examples_tpu_torch.check.rules",
    "spark_examples_tpu_torch.check.sanitize",
    "spark_examples_tpu_torch.check.sched",
    "spark_examples_tpu_torch.check.typecheck",
    "spark_examples_tpu_torch.experiments.cli_wall",
    "spark_examples_tpu_torch.experiments.cost_rates",
    "spark_examples_tpu_torch.experiments.count_variants",
    "spark_examples_tpu_torch.experiments.probe_ops",
    "spark_examples_tpu_torch.experiments.vmem_capacity",
    "spark_examples_tpu_torch.models.read",
    "spark_examples_tpu_torch.models.variant",
    "spark_examples_tpu_torch.obs.calibration",
    "spark_examples_tpu_torch.obs.costmodel",
    "spark_examples_tpu_torch.obs.heartbeat",
    "spark_examples_tpu_torch.obs.manifest",
    "spark_examples_tpu_torch.obs.metrics",
    "spark_examples_tpu_torch.obs.recorder",
    "spark_examples_tpu_torch.obs.report",
    "spark_examples_tpu_torch.obs.schedule",
    "spark_examples_tpu_torch.obs.trace",
    "spark_examples_tpu_torch.ops.contracts",
    "spark_examples_tpu_torch.ops.depth",
    "spark_examples_tpu_torch.ops.devicegen",
    "spark_examples_tpu_torch.ops.gramian",
    "spark_examples_tpu_torch.ops.ld",
    "spark_examples_tpu_torch.parallel.collectives",
    "spark_examples_tpu_torch.parallel.mesh",
    "spark_examples_tpu_torch.parallel.multihost",
    "spark_examples_tpu_torch.pipeline.checkpoint",
    "spark_examples_tpu_torch.pipeline.datasets",
    "spark_examples_tpu_torch.pipeline.pca_driver",
    "spark_examples_tpu_torch.pipeline.sitewriter",
    "spark_examples_tpu_torch.serve.client",
    "spark_examples_tpu_torch.serve.daemon",
    "spark_examples_tpu_torch.serve.executor",
    "spark_examples_tpu_torch.serve.http",
    "spark_examples_tpu_torch.serve.journal",
    "spark_examples_tpu_torch.serve.protocol",
    "spark_examples_tpu_torch.serve.queue",
    "spark_examples_tpu_torch.sharding.contig",
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


@pytest.mark.parametrize("verb", ["obs"])
def test_cli_unported_verbs_exit_2(verb, capsys):
    """``obs`` is ported: with no subcommand it runs ``report_main([])``
    and exits 2 with the reference's usage line, as the reference does."""
    from spark_examples_tpu_torch.cli import NOT_PORTED, main

    assert verb not in NOT_PORTED
    assert main([verb]) == 2
    err = capsys.readouterr().err
    assert "usage: python -m spark_examples_tpu_torch obs report" in err
    assert "not yet ported" not in err


@pytest.mark.parametrize(
    "flags, named",
    [
        (["--num-processes", "2", "--resume-from", "ck"], "--resume-from"),
        (["--coordinator-address", "h:1", "--check-ranges"], None),
        (["--num-processes", "2", "--gramian-checkpoint-dir", "ck"], "--gramian-checkpoint-dir"),
        (["--check-ranges"], None),
        (["--trace-dir", "t", "--check-ranges"], None),
        (["--mesh-shape", "1,2", "--check-ranges"], None),
    ],
)
def test_unported_flags_raise_naming_the_flag(flags, named):
    """Gramian checkpoints across processes raise naming the flag; the
    ``--check-ranges`` cases parse, the flag being ported (``named``
    ``None``)."""
    from spark_examples_tpu_torch.config import PcaConf

    if named is None:
        assert PcaConf.parse(flags + ["--device", "cpu"]).check_ranges is True
        return
    with pytest.raises(NotImplementedError, match=re.escape(named)):
        PcaConf.parse(flags + ["--device", "cpu"])


@pytest.mark.parametrize(
    "flags",
    [
        ["--coordinator-address", "127.0.0.1:29500", "--num-processes", "2", "--process-id", "1"],
        ["--num-processes", "2"],
        ["--mesh-shape", "1,4", "--similarity-strategy", "sharded"],
    ],
)
@pytest.mark.parametrize("conf_class", ["PcaConf", "GrmConf", "LdConf", "AssocConf"])
def test_process_and_mesh_flags_parse_in_every_verb(flags, conf_class):
    """The cluster flags and the mesh's, refused before they were ported,
    parse in the PCA verb and the analyses; joining happens at run time
    (``init_distributed``), where partly given flags raise."""
    from spark_examples_tpu_torch import config

    conf = getattr(config, conf_class).parse(flags + ["--device", "cpu"])
    assert conf.num_processes in (None, 2)


def test_multihost_child_imports_no_jax():
    """A harness child (here a run of one process) drives its checks
    without importing JAX or the JAX package."""
    from spark_examples_tpu_torch.parallel.multihost import _child_env, _free_port

    code = (
        "import sys\n"
        "from spark_examples_tpu_torch.parallel import multihost\n"
        f"v = multihost.child_check('127.0.0.1:{_free_port()}', 1, 0, local_devices=2, timeout=60)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spark_examples_tpu' or m.startswith('spark_examples_tpu.'))\n"
        "print(bad, v['gramian_ok'], v['ring_gramian_ok'], v['hier_gramian_ok'])\n"
        "sys.exit(1 if bad or not v['ring_gramian_ok'] else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_child_env(60),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("[] True True True")


@pytest.mark.parametrize(
    "flags, shape",
    [
        (["--similarity-strategy", "sharded"], None),
        (["--mesh-shape", "1,2"], {"data": 1, "samples": 2}),
        (["--reduce-schedule", "flat"], None),
    ],
)
def test_mesh_flags_parse_and_resolve_a_mesh_of_cpu_positions(flags, shape):
    """The mesh's flags, refused before the mesh was ported, now parse; the
    run's mesh resolves over CPU positions (none on one position)."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.parallel.mesh import resolve_run_mesh, run_devices

    conf = PcaConf.parse(flags + ["--device", "cpu"])
    mesh = resolve_run_mesh(conf.mesh_shape, conf.num_reduce_partitions, run_devices(conf.device))
    if shape is None:
        assert mesh is None
    else:
        assert mesh.shape == shape
        assert all(p.device.type == "cpu" for p in mesh.flat())


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
