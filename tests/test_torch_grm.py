"""The ``grm`` verb: the port's ``analyses/grm.py`` and ``analyses/base.py``
against the JAX package's.

The kinship is one float64 formula over exact int64 numerators, so the
port's matrix equals the reference's byte for byte (no tolerance), and so
do the ``--grm-out`` file, the printed summary and the manifest's
``analysis`` block, on the synthetic and the file source. A run killed at
``analysis.pre-manifest`` leaves the kinship file complete and no
manifest."""

import contextlib
import io
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest

from spark_examples_tpu.analyses import base as ref_base
from spark_examples_tpu.analyses import grm as ref_grm
from spark_examples_tpu.config import GrmConf as RefGrmConf
from spark_examples_tpu.utils import faults as ref_faults
from spark_examples_tpu_torch.analyses import base, grm
from spark_examples_tpu_torch.config import GrmConf
from spark_examples_tpu_torch.obs.manifest import validate_manifest
from spark_examples_tpu_torch.utils import faults

REPO = pathlib.Path(__file__).resolve().parents[1]
N_SAMPLES = 12
#: Two small regions on two contigs: several partitions, ragged blocks.
SYNTHETIC = ["--num-samples", str(N_SAMPLES), "--references", "1:0:200000,2:0:100000",
             "--block-size", "256"]


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.configure(None)
    ref_faults.configure(None)
    yield
    faults.configure(None)
    ref_faults.configure(None)


def _vcf(path, rows=70, monomorphic=False):
    rng = np.random.default_rng(9)
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"S{i}" for i in range(N_SAMPLES))]
    for contig in ("1", "2"):
        for k in range(rows):
            if monomorphic:
                gts = "\t".join(["0|1"] * N_SAMPLES)
            else:
                gts = "\t".join(rng.choice(["0|0", "0|1", "1|1", "0|0"], N_SAMPLES))
            lines.append(f"{contig}\t{100 + 37 * k}\t.\tA\tG\t.\t.\tAF=0.3\tGT\t{gts}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _run_both(argv, out, manifest):
    """The port's then the reference's ``run_grm_pipeline`` on one argv
    (each writing ``out`` and ``manifest``): (result, printed, file bytes,
    manifest) per package."""
    argv = argv + ["--grm-out", str(out), "--metrics-json", str(manifest)]
    runs = []
    for run in (lambda: grm.run_grm_pipeline(GrmConf.parse(argv + ["--device", "cpu"])),
                lambda: ref_grm.run_grm_pipeline(RefGrmConf.parse(argv))):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            result = run()
        runs.append((result, printed.getvalue(), out.read_bytes(),
                     json.loads(manifest.read_text())))
        os.remove(out)
    return runs


@pytest.mark.parametrize("source", ["synthetic", "file"])
def test_kinship_is_byte_identical_to_the_reference(tmp_path, source):
    if source == "synthetic":
        argv = list(SYNTHETIC)
    else:
        argv = ["--source", "file", "--input-files", _vcf(tmp_path / "cohort.vcf"),
                "--references", "1:0:2000,2:0:1500", "--bases-per-partition", "1000"]
    (got, printed, tsv, doc), (want, ref_printed, ref_tsv, ref_doc) = _run_both(
        argv, tmp_path / "kinship.tsv", tmp_path / "m.json")
    assert got.matrix.dtype == np.float64 and got.matrix.shape == (N_SAMPLES, N_SAMPLES)
    assert got.matrix.tobytes() == want.matrix.tobytes()
    assert got.sample_names == want.sample_names
    assert tsv == ref_tsv
    assert printed == ref_printed
    assert got.summary == want.summary
    assert doc["analysis"] == ref_doc["analysis"] == {
        "kind": "grm", "sites_kept": None, "sites_tested": got.summary["sites"]}
    assert got.summary["sites"] > 0
    assert validate_manifest(doc) == []
    # The bound charges the GRM finalize as the reference's does (at one
    # device: the reference's test mesh has eight).
    from spark_examples_tpu.check.hostmem import conf_host_peak_bytes

    assert doc["host_memory"]["static_bound_bytes"] == conf_host_peak_bytes(
        RefGrmConf.parse(argv), device_count=1, num_samples=N_SAMPLES)
    # The streamed two-pass result is the one-shot oracle's, exactly.
    rows = np.concatenate([
        block["has_variation"]
        for _, block in base.iter_site_blocks(
            got.driver.conf, got.driver.source,
            base.analysis_partitions(got.driver.conf, got.driver.source), None,
            got.driver.registry)
    ])
    assert grm.grm_reference(rows, N_SAMPLES).tobytes() == got.matrix.tobytes()


def test_host_backend_equals_the_device_path():
    with contextlib.redirect_stdout(io.StringIO()):
        device = grm.run_grm_pipeline(GrmConf.parse(SYNTHETIC + ["--device", "cpu"]))
        host = grm.run_grm_pipeline(GrmConf.parse(SYNTHETIC + ["--pca-backend", "host",
                                                              "--device", "cpu"]))
    assert device.matrix.tobytes() == host.matrix.tobytes()


def test_all_monomorphic_input_raises_as_the_reference(tmp_path):
    argv = ["--source", "file", "--input-files", _vcf(tmp_path / "mono.vcf", monomorphic=True),
            "--references", "1:0:3000,2:0:3000"]
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(ValueError, match="monomorphic") as ref_error:
            ref_grm.run_grm_pipeline(RefGrmConf.parse(argv))
        with pytest.raises(ValueError, match="monomorphic") as error:
            grm.run_grm_pipeline(GrmConf.parse(argv + ["--device", "cpu"]))
    assert str(error.value) == str(ref_error.value)


def test_finalize_and_moments_equal_the_reference():
    rng = np.random.default_rng(4)
    X = (rng.random((300, 9)) < 0.35).astype(np.uint8)
    moments, ref_moments = grm.GrmMoments(9), ref_grm.GrmMoments(9)
    for lo in range(0, 300, 64):
        moments.add_block(X[lo:lo + 64])
        ref_moments.add_block(X[lo:lo + 64])
    assert (moments.S2, moments.C, moments.sites) == (ref_moments.S2, ref_moments.C, 300)
    np.testing.assert_array_equal(moments.U, ref_moments.U)
    G = X.T.astype(np.int32) @ X.astype(np.int32)
    assert grm.grm_finalize(G, moments).tobytes() == ref_grm.grm_finalize(G, ref_moments).tobytes()
    assert grm.grm_reference(X, 9).tobytes() == ref_grm.grm_reference(X, 9).tobytes()


def test_kill_before_the_manifest_leaves_the_kinship_complete(tmp_path):
    """SIGKILL at ``analysis.pre-manifest``: the atomically published
    kinship file is whole (the uninterrupted run's bytes) and no manifest
    and no temp file exist."""
    out, manifest = tmp_path / "kinship.tsv", tmp_path / "m.json"
    argv = SYNTHETIC + ["--grm-out", str(out), "--metrics-json", str(manifest)]
    env = dict(os.environ, PYTHONPATH=str(REPO),
               SPARK_EXAMPLES_TPU_FAULTS="kill@analysis.pre-manifest")
    proc = subprocess.run([sys.executable, "-m", "spark_examples_tpu_torch", "grm", *argv,
                           "--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    killed = out.read_bytes()
    assert not manifest.exists()
    assert sorted(os.listdir(tmp_path)) == ["kinship.tsv"]
    with contextlib.redirect_stdout(io.StringIO()):
        result = grm.run_grm_pipeline(GrmConf.parse(argv + ["--device", "cpu"]))
    assert out.read_bytes() == killed
    assert killed.count(b"\n") == N_SAMPLES + 1
    assert result.manifest_path == str(manifest)


@pytest.mark.parametrize(
    "extra",
    [
        ["--num-samples", "8,8", "--variant-set-id", "a,b"],
        ["--save-variants", "x"],
        ["--input-path", "x"],
        ["--gramian-checkpoint-dir", "x"],
        ["--resume-from", "x", "--ingest", "wire"],
        ["--ingest", "device"],
        ["--stream-chunk-bytes", "1024"],
        ["--source", "rest"],
    ],
)
def test_conf_violations_are_the_reference_codes(extra):
    argv = ["--num-samples", "8", "--references", "1:0:50000", *extra]
    codes = [c for c, _ in base.analysis_conf_violations(GrmConf.parse(argv), "grm")]
    ref_codes = [c for c, _ in ref_base.analysis_conf_violations(RefGrmConf.parse(argv), "grm")]
    assert codes == ref_codes and codes
    with pytest.raises(ValueError):
        grm.run_grm_pipeline(GrmConf.parse(argv + ["--device", "cpu"]))


def test_cli_runs_grm(tmp_path, capsys):
    from spark_examples_tpu_torch.cli import main

    out = tmp_path / "k.tsv"
    assert main(["grm", *SYNTHETIC, "--grm-out", str(out), "--device", "cpu"]) == 0
    assert "Kinship matrix written to" in capsys.readouterr().out
    assert out.read_bytes().count(b"\n") == N_SAMPLES + 1
