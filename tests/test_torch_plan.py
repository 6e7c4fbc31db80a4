"""``graftcheck plan`` (``check/plan.py``, ``check/cli.py``) of both
packages, held against each other on one matrix of configurations.

The matrix covers what the JAX package's ``tests/test_graftcheck.py``
plan cases check (dense, stacked, sharded and data-axis meshes, the
analyses, flag-contract errors, memory and exactness limits) and more.
For every configuration both packages' CLIs give the same exit code,
the same ``ok``, the same issue codes and severities, and the same
geometry values, except the keys in :data:`JAXPR_ONLY`, whose reference
values come from its jaxprs.

The reference's ring audit is written for an older JAX than this
image's: its ``AbstractMesh`` took ``((name, size), ...)`` and its jitted
programs traced as ``pjit``. The ``reference_jax_shims`` fixture adapts
both, in this process only, so the reference's plan runs as written.
"""

import contextlib
import importlib
import io
import json

import pytest
import torch

PACKAGES = {"ref": "spark_examples_tpu", "port": "spark_examples_tpu_torch"}
PKGS = sorted(PACKAGES)

#: Geometry keys whose reference value is read off its traced jaxpr. The
#: port has no jaxpr: it gives the peak bytes of its own ring buffers
#: (``ops/gramian.py:sharded_peak_bytes``), and no jaxpr ring bytes (its
#: ``ring_bytes_per_flush`` is the formula the card's ring counter is held
#: to, which the reference reports too).
JAXPR_ONLY = {
    "ring_peak_live_bytes_per_device": "the reference's jaxpr liveness; the port's ring buffers",
    "ring_bytes_per_flush_jaxpr": "the reference's jaxpr ppermute bytes; absent in the port",
}


@pytest.fixture
def reference_jax_shims(monkeypatch):
    import jax.sharding

    from spark_examples_tpu.check import ir

    base = jax.sharding.AbstractMesh

    class AbstractMesh(base):
        def __init__(self, shape, axis_names=None, *args, **kwargs):
            if axis_names is None:
                sizes = tuple(size for _, size in shape)
                axis_names = tuple(name for name, _ in shape)
                shape = sizes
            super().__init__(shape, axis_names, *args, **kwargs)

    monkeypatch.setattr(jax.sharding, "AbstractMesh", AbstractMesh)
    monkeypatch.setattr(
        ir, "_find_top_pjit",
        lambda jaxpr: next((e for e in jaxpr.eqns if e.primitive.name in ("pjit", "jit")), None),
    )


def _phenotypes(path, num_samples, cover=True):
    """A phenotype TSV over the synthetic cohort's callset names (callset
    i a case when i is odd); ``cover=False`` leaves one callset out."""
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.pipeline.pca_driver import make_source

    conf = PcaConf.parse(["--num-samples", str(num_samples), "--device", "cpu"])
    names = [cs["name"] for cs in make_source(conf).search_callsets(conf.variant_set_id)]
    if not cover:
        names = names[:-1]
    path.write_text("".join(f"{n}\t{i % 2}\n" for i, n in enumerate(names)))
    return str(path)


BIG = ["--num-samples", "2504", "--references", "17:0:81195210"]
MATRIX = {
    "default": [],
    "chr17": BIG,
    "chr17-device-16k": BIG + ["--ingest", "device", "--block-size", "16384"],
    "whole-genome": ["--all-references", "--num-samples", "2504"],
    "two-sets": ["--references", "1:0:248956422;2:0:242193529", "--variant-set-id", "a,b"],
    "same-set-join": ["--variant-set-id", "a,a", "--num-samples", "20"],
    "stacked-4": ["--num-samples", "2504", "--fused-jobs", "4"],
    "stacked-past-hbm": ["--num-samples", "2504", "--fused-jobs", "700"],
    "stacked-zero": ["--fused-jobs", "0"],
    "data-axis-4": ["--mesh-shape", "4,1", "--num-reduce-partitions", "4",
                    "--plan-devices", "4"],
    "default-mesh-8": ["--plan-devices", "8"],
    "mesh-past-devices": ["--mesh-shape", "4,2", "--plan-devices", "4"],
    "data-past-partitions": ["--mesh-shape", "8,1", "--num-reduce-partitions", "4",
                             "--plan-devices", "8"],
    "sharded-no-samples-axis": ["--similarity-strategy", "sharded", "--mesh-shape", "4,1",
                                "--plan-devices", "4"],
    "sharded-4x2": ["--mesh-shape", "4,2", "--similarity-strategy", "sharded",
                    "--plan-devices", "8"],
    "sharded-padding-2x3": ["--similarity-strategy", "sharded", "--mesh-shape", "2,3",
                            "--num-samples", "100", "--plan-devices", "6"],
    "sharded-1x4-device": BIG + ["--mesh-shape", "1,4", "--similarity-strategy", "sharded",
                                 "--ingest", "device", "--block-size", "16384"],
    "sharded-unpacked": ["--ring-pack-bits", "off", "--mesh-shape", "1,4",
                         "--similarity-strategy", "sharded", "--num-samples", "21"],
    "sharded-hier": ["--reduce-schedule", "hier", "--mesh-shape", "1,3",
                     "--similarity-strategy", "sharded"],
    "sharded-join": ["--variant-set-id", "a,a", "--num-samples", "20", "--mesh-shape", "1,2",
                     "--plan-devices", "2"],
    "sharded-past-hbm": ["--similarity-strategy", "sharded", "--mesh-shape", "1,2",
                         "--num-samples", "100000", "--plan-devices", "2"],
    "data-and-samples-2x2": BIG + ["--mesh-shape", "2,2", "--ingest", "device"],
    "dense-past-hbm": ["--similarity-strategy", "dense", "--num-samples", "40000"],
    "past-exactness": ["--references", "1:0:300000000000"],
    "past-exactness-join": ["--references", "1:0:20000000000", "--variant-set-id", "a,a,a,a",
                            "--num-samples", "10"],
    "num-pc-past-cohort": ["--num-pc", "500", "--num-samples", "100"],
    "device-ingest-file": ["--ingest", "device", "--source", "file", "--input-files", "x.vcf"],
    "device-ingest-host-backend": ["--pca-backend", "host", "--ingest", "device"],
    "host-backend": ["--pca-backend", "host", "--num-samples", "64"],
    "checkpoint-device-ingest": ["--gramian-checkpoint-dir", "ck", "--ingest", "device"],
    "checkpoint-cadence-alone": ["--checkpoint-every-sites", "10"],
    "fault-plan": ["--fault-plan", "kill@driver.post-flush#2", "--ingest", "packed"],
    "metrics-json-no-parent": ["--metrics-json", "/nonexistent-dir/m.json"],
    "host-mem-over-budget": ["--host-mem-budget", "1000"],
    "host-mem-within-budget": ["--host-mem-budget", str(1 << 40)],
    "block-size-zero": ["--block-size", "0"],
    "bases-per-partition-zero": ["--bases-per-partition", "0"],
    "no-shards": ["--references", "1:10:5"],
    "flag-blocks-per-dispatch": ["--blocks-per-dispatch", "0"],
    "flag-bogus-ingest": ["--ingest", "bogus"],
    "flag-unknown": ["--no-such-flag"],
    "flag-heartbeat": ["--heartbeat-seconds", "-5"],
    "grm": ["--analysis", "grm", "--num-samples", "64", "--references", "1:0:400000"],
    "grm-sharded": ["--analysis", "grm", "--num-samples", "64", "--mesh-shape", "1,2",
                    "--similarity-strategy", "sharded", "--plan-devices", "2"],
    "grm-two-sets": ["--analysis", "grm", "--variant-set-id", "a,b"],
    "grm-rest": ["--analysis", "grm", "--source", "rest"],
    "grm-out-no-parent": ["--analysis", "grm", "--grm-out", "/nonexistent-dir/k.tsv"],
    "ld": ["--analysis", "ld", "--num-samples", "64", "--references", "1:0:400000",
           "--ld-window-sites", "256"],
    "ld-mesh-1x2": ["--analysis", "ld", "--num-samples", "64", "--mesh-shape", "1,2",
                    "--plan-devices", "2"],
    "ld-not-divisible": ["--analysis", "ld", "--num-samples", "63", "--mesh-shape", "1,2",
                         "--plan-devices", "2"],
    "ld-past-hbm": ["--analysis", "ld", "--ld-window-sites", "60000"],
    "flag-ld-window": ["--analysis", "ld", "--ld-window-sites", "1"],
    "flag-ld-r2": ["--analysis", "ld", "--ld-r2-threshold", "1.5"],
    "flag-bad-analysis": ["--analysis", "pcoa"],
    "assoc-no-phenotypes": ["--analysis", "assoc", "--num-samples", "12"],
    "assoc": ["--analysis", "assoc", "--num-samples", "12", "--phenotypes", "@PHENO"],
    "assoc-cohort-mismatch": ["--analysis", "assoc", "--num-samples", "12",
                              "--phenotypes", "@PHENO_SHORT"],
    "assoc-top-zero": ["--analysis", "assoc", "--num-samples", "12", "--assoc-top", "0",
                       "--phenotypes", "@PHENO"],
}


def _plan_cli(pkg, argv):
    cli = importlib.import_module(f"{PACKAGES[pkg]}.check.cli")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["plan", *argv, "--json"])
    text = out.getvalue()
    try:
        report = json.loads(text)
    except ValueError:
        report = None  # a flag-contract rejection prints its text form
    return rc, report, text


def _argv(name, tmp_path):
    argv = []
    for arg in MATRIX[name]:
        if arg == "@PHENO":
            arg = _phenotypes(tmp_path / "p.tsv", 12)
        elif arg == "@PHENO_SHORT":
            arg = _phenotypes(tmp_path / "short.tsv", 12, cover=False)
        argv.append(arg)
    return argv


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_plan_matches_the_reference(name, tmp_path, reference_jax_shims):
    argv = _argv(name, tmp_path)
    (ref_rc, ref, ref_text), (port_rc, port, port_text) = (
        _plan_cli(pkg, argv) for pkg in PKGS
    )
    assert ref_rc == port_rc, (ref_text, port_text)
    if ref is None or port is None:
        assert ref is None and port is None and ref_rc == 2
        assert "ERROR [flag-contract]" in ref_text and "ERROR [flag-contract]" in port_text
        return
    assert ref["ok"] == port["ok"] and ref_rc == (0 if ref["ok"] else 2)
    codes = lambda r: sorted((i["code"], i["severity"]) for i in r["issues"])
    assert codes(ref) == codes(port)
    keys = set(ref["geometry"]) | set(port["geometry"])
    for key in sorted(keys - set(JAXPR_ONLY)):
        assert ref["geometry"].get(key, "absent") == port["geometry"].get(key, "absent"), key


def test_matrix_covers_every_kind():
    kinds = {name.split("-")[0] for name in MATRIX}
    assert {"default", "stacked", "sharded", "data", "grm", "ld", "assoc", "flag",
            "past", "dense"} <= kinds
    assert len(MATRIX) >= 30


def test_plan_geometry_names_the_port_buffers(tmp_path):
    """The port's own values of the jaxpr-only keys: its ring buffers'
    peak, and no jaxpr ring bytes."""
    from spark_examples_tpu_torch.ops.gramian import sharded_peak_bytes

    rc, report, _ = _plan_cli("port", _argv("sharded-1x4-device", tmp_path))
    geometry = report["geometry"]
    assert rc == 0 and "ring_bytes_per_flush_jaxpr" not in geometry
    assert geometry["ring_peak_live_bytes_per_device"] == sharded_peak_bytes(
        geometry["ring_local_columns"], 4 * geometry["ring_local_columns"], 16384, True)
    assert geometry["ring_permute_steps"] == 3


class _DeviceWatch(torch.overrides.TorchFunctionMode):
    """Records the device of every tensor a torch call returns."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


@pytest.mark.parametrize("name", ["chr17", "stacked-4", "sharded-4x2", "ld-mesh-1x2", "assoc",
                                  "same-set-join"])
def test_plan_touches_no_device(name, tmp_path, monkeypatch):
    """The plan allocates tensors on the meta device only and never asks
    CUDA anything."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plan queried CUDA")

    for fn in ("is_available", "device_count", "mem_get_info", "get_device_properties",
               "synchronize", "current_device"):
        monkeypatch.setattr(torch.cuda, fn, refuse)
    argv = _argv(name, tmp_path)
    with _DeviceWatch() as watch:
        rc, report, _ = _plan_cli("port", argv)
    assert rc == 0, report
    assert watch.devices == {"meta"}


@pytest.mark.parametrize("flags", [["--topology", "2,4"], ["--sched-budget-seconds", "5"]])
def test_schedule_proof_flags_are_refused(flags):
    from spark_examples_tpu_torch.check.plan import parse_plan_args, validate_plan
    from spark_examples_tpu_torch.config import PcaConf

    with pytest.raises(NotImplementedError, match=flags[0]):
        parse_plan_args(flags)
    rc, _, _ = _plan_cli("port", flags)
    assert rc == 2
    with pytest.raises(NotImplementedError):
        validate_plan(PcaConf(), topology=object())


#: The subcommands ported since, each with runs whose exit codes the
#: reference's gives on the same argv ({tmp}: a tree of one clean module;
#: ``sanitize`` and ``typecheck`` run with no compiler and no mypy, so
#: they build and type-check nothing).
PORTED_SUBCOMMAND_RUNS = {
    "lint": [(["{tmp}"], 0)],
    "lockgraph": [(["{tmp}"], 0)],
    "hostmem": [(["{tmp}"], 0)],
    "proto": [(["--replicas", "2", "--jobs", "1", "--crashes", "1", "--stalls", "0"], 0)],
    "sanitize": [([], 0), (["--strict"], 2)],
    "typecheck": [(["--strict"], 2)],
}


@pytest.mark.parametrize("sub", ["lint", "ir", "ranges", "sched", "lockgraph", "hostmem",
                                 "proto", "sanitize", "typecheck"])
def test_other_graftcheck_subcommands_name_their_roadmap_step(sub, capsys, tmp_path,
                                                              monkeypatch):
    """The three subcommands still refused exit 2 naming their ROADMAP step;
    each ported one runs and exits as the reference's does."""
    from spark_examples_tpu.check import typecheck as ref_typecheck
    from spark_examples_tpu.check.cli import main as ref_main
    from spark_examples_tpu.utils import native as ref_native
    from spark_examples_tpu_torch.check import typecheck as port_typecheck
    from spark_examples_tpu_torch.cli import main
    from spark_examples_tpu_torch.utils import native as port_native

    if sub not in PORTED_SUBCOMMAND_RUNS:
        assert main(["graftcheck", sub]) == 2
        err = capsys.readouterr().err
        assert "not yet ported" in err and "ROADMAP" in err
        return
    (tmp_path / "clean.py").write_text("import threading\n\nLOCK = threading.Lock()\n")
    for module in (ref_typecheck, port_typecheck):  # the no-mypy case, as on every image
        monkeypatch.setattr(module, "_run_mypy", lambda: None)
    for module in (ref_native, port_native):  # the no-compiler case: nothing is built
        monkeypatch.setattr(module, "_compiler", lambda: None)
    for argv, want in PORTED_SUBCOMMAND_RUNS[sub]:
        argv = [sub, *(a.format(tmp=tmp_path) for a in argv)]
        assert main(["graftcheck", *argv]) == ref_main(argv) == want
        assert "not yet ported" not in capsys.readouterr().err


def test_graftcheck_verb_is_device_free(capsys):
    from spark_examples_tpu_torch.cli import main

    assert main(["graftcheck"]) == 0
    assert "graftcheck plan" in capsys.readouterr().out
    assert main(["graftcheck", "plan", "--num-samples", "12", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    assert main(["graftcheck", "nonsense"]) == 2


def test_device_memory_budget_changes_the_memory_rules(capsys):
    """``--device-memory-bytes`` sets the HBM budget: an H100's 80 GB
    admits the dense 40,000-sample Gramian the default 16 GiB refuses, and
    raises the fused-jobs ceiling."""
    from spark_examples_tpu_torch.check.plan import validate_plan
    from spark_examples_tpu_torch.config import PcaConf

    argv = ["--similarity-strategy", "dense", "--num-samples", "40000"]
    assert _plan_cli("port", argv)[0] == 2
    assert _plan_cli("port", argv + ["--device-memory-bytes", str(80 << 30)])[0] == 0
    assert _plan_cli("port", argv + ["--device-memory-bytes", "-1"])[0] == 2
    conf = PcaConf.parse(["--num-samples", "2504", "--fused-jobs", "4", "--device", "cpu"])
    small = validate_plan(conf).geometry["max_fused_jobs"]
    large = validate_plan(conf, device_bytes=80 << 30).geometry["max_fused_jobs"]
    assert large == 5 * small or large == 5 * small + 1


def test_check_ranges_is_still_refused():
    rc, _, _ = _plan_cli("port", ["--check-ranges"])
    assert rc == 2


# ------------------------------------------------------------ cost model

REFERENCE_CONSTANTS = ("SITES_PER_SECOND", "HOST_BYTES_PER_SECOND",
                       "DISPATCH_OVERHEAD_SECONDS", "COLD_COMPILE_SECONDS",
                       "MIN_PREDICTED_SECONDS")


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's cost model with the reference's constants (measured for
    its TPU; the port's are measured on an H100)."""
    from spark_examples_tpu.obs import costmodel as ref
    from spark_examples_tpu_torch.obs import costmodel as port

    for name in REFERENCE_CONSTANTS:
        monkeypatch.setattr(port, name, getattr(ref, name))


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("name", ["chr17", "whole-genome", "same-set-join", "sharded-4x2",
                                  "grm", "file-source"])
def test_predict_job_cost_equals_the_reference(name, warm, reference_constants,
                                               reference_jax_shims, monkeypatch, tmp_path):
    argv = (["--source", "file", "--input-files", str(tmp_path / "x.vcf")]
            if name == "file-source" else MATRIX[name])
    kind = "grm" if name == "grm" else "pca"
    if name == "grm":
        argv = argv[2:]
    devices = None
    if "--plan-devices" in argv:
        at = argv.index("--plan-devices")
        devices = int(argv[at + 1])
        argv = argv[:at] + argv[at + 2:]
    predictions = []
    for pkg in PKGS:
        base = PACKAGES[pkg]
        monkeypatch.setattr(importlib.import_module(f"{base}.utils.cache"), "geometry_seen",
                            lambda key: warm)
        plan = importlib.import_module(f"{base}.check.plan")
        conf_cls = plan.ANALYSIS_SURFACES["grm" if kind == "grm" else "pca"][1]
        conf = conf_cls.parse(argv)
        predictions.append(plan.predict_job_cost(conf, kind=kind, plan_devices=devices).to_dict())
    assert predictions[0] == predictions[1]
    assert predictions[0]["compile"] == ("warm" if warm else "cold")


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("facts", [
    dict(sites=1_000_000, host_peak_bytes=None, sched_seconds=None),
    dict(sites=None, host_peak_bytes=5 << 30, sched_seconds=None),
    dict(sites=10, host_peak_bytes=None, sched_seconds=9.0),
    dict(sites=None, host_peak_bytes=None, sched_seconds=None),
])
def test_estimate_seconds_equals_the_reference(facts, cold, reference_constants):
    from spark_examples_tpu.obs.costmodel import estimate_seconds as ref
    from spark_examples_tpu_torch.obs.costmodel import estimate_seconds as port

    assert port(cold=cold, **facts) == ref(cold=cold, **facts)


def test_the_port_constants_are_its_own():
    """The port's rates are measured on the card, not the reference's."""
    from spark_examples_tpu.obs import costmodel as ref
    from spark_examples_tpu_torch.obs import costmodel as port

    for name in ("SITES_PER_SECOND", "HOST_BYTES_PER_SECOND", "DISPATCH_OVERHEAD_SECONDS",
                 "COLD_COMPILE_SECONDS"):
        assert getattr(port, name) > 0 and getattr(port, name) != getattr(ref, name), name
