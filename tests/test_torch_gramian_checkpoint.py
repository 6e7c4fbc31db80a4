"""Gramian checkpoints, kill and resume: the port's
``pipeline/checkpoint.py`` (Gramian half), ``GramianAccumulator.
snapshot_state``/``restore_state`` and the driver's checkpointing against
the JAX package's.

A killed run resumed with ``--resume-from`` must give the uninterrupted
run's Gramian byte for byte (every entry is an exact integer at every
point), at every driver/checkpoint kill point, and the two packages resume
each other's artifacts: the conf fingerprint is the reference's digest of
the same argv, and the artifact the reference's format. Kills are real
SIGKILLs of CLI subprocesses, started together; every resume runs in this
process."""

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
import torch

from spark_examples_tpu.config import PcaConf as RefConf
from spark_examples_tpu.pipeline import checkpoint as ref_cp
from spark_examples_tpu.pipeline import pca_driver as ref_driver
from spark_examples_tpu.utils import faults as ref_faults
from spark_examples_tpu_torch.config import PcaConf
from spark_examples_tpu_torch.obs.manifest import validate_manifest
from spark_examples_tpu_torch.ops.gramian import GramianAccumulator, gramian_reference
from spark_examples_tpu_torch.pipeline import checkpoint as cp
from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline
from spark_examples_tpu_torch.utils import faults

REPO = pathlib.Path(__file__).resolve().parents[1]
#: The chaos configuration (the reference's): 8 samples over 150 kb, packed,
#: a snapshot every 40 sites — two saves, so the 2nd hit of the save-path
#: points leaves one complete artifact behind.
CHAOS_FLAGS = ["--num-samples", "8", "--references", "1:0:150000", "--ingest", "packed",
               "--checkpoint-every-sites", "40"]
#: Kill point → occurrence: post-flush, mid-write and post-save at the 2nd
#: save, pre-finalize once after the final snapshot.
CHAOS_MATRIX = {
    "driver.post-flush": 2,
    "checkpoint.mid-write": 2,
    "checkpoint.post-save": 2,
    "driver.pre-finalize": 1,
}
#: The cross-package configuration: one data-parallel slice in both
#: packages (the reference's test mesh has eight CPU devices).
CROSS_FLAGS = CHAOS_FLAGS + ["--num-reduce-partitions", "1"]


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.configure(None)
    ref_faults.configure(None)
    yield
    faults.configure(None)
    ref_faults.configure(None)


def _spawn(package, args, plan):
    """One CLI run of ``package`` in a subprocess under fault ``plan``; the
    reference's on one CPU device."""
    env = dict(os.environ, PYTHONPATH=str(REPO), SPARK_EXAMPLES_TPU_FAULTS=plan)
    if package == "spark_examples_tpu":
        env.update(JAX_PLATFORMS="cpu", SPARK_EXAMPLES_TPU_PLATFORM="cpu",
                   SPARK_EXAMPLES_TPU_NO_CACHE="1",
                   XLA_FLAGS="--xla_force_host_platform_device_count=1")
    else:
        args = list(args) + ["--device", "cpu"]
    return subprocess.Popen(
        [sys.executable, "-m", package, "variants-pca", *[str(a) for a in args]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _assert_killed(proc, label):
    _, err = proc.communicate(timeout=240)
    assert proc.returncode == -signal.SIGKILL, f"{label}: rc {proc.returncode}\n{err[-2000:]}"


def _run(args):
    """One port run in this process: (result, the Gramian as int64)."""
    with contextlib.redirect_stdout(io.StringIO()):
        result = run_pipeline(PcaConf.parse([str(a) for a in args] + ["--device", "cpu"]))
    return result, result.driver.accumulator.G.numpy().astype(np.int64)


def _artifact_gramian(directory):
    """The summed Gramian of a directory's complete artifact."""
    return ref_cp.load_gramian_checkpoint(str(directory))["G"].astype(np.int64).sum(axis=0)


# ------------------------------------------------------------ fingerprint


@pytest.mark.parametrize(
    "argv",
    [
        CHAOS_FLAGS,
        ["--num-samples", "12", "--references", "17:0:5000;17:0:9000",
         "--variant-set-id", "a,b", "--ingest", "wire"],
        ["--all-references", "--min-allele-frequency", "0.05", "--block-size", "256"],
        ["--pca-backend", "host", "--num-pc", "3", "--exact-similarity"],
        ["--source", "file", "--input-files", "x.vcf.gz,y.jsonl",
         "--stream-chunk-bytes", "4096", "--references", "1:0:100"],
    ],
)
def test_fingerprint_equals_the_reference(argv):
    """The two ``PcaConf``s differ in ``device`` and the backend's name;
    the port digests the reference's fields with the reference's values."""
    ref_argv = ["tpu" if a == "gpu" else a for a in argv]
    assert cp.gramian_checkpoint_fingerprint(PcaConf.parse(argv + ["--device", "cpu"])) == (
        ref_cp.gramian_checkpoint_fingerprint(RefConf.parse(ref_argv))
    )


def test_fingerprint_ignores_the_robustness_flags():
    saver = PcaConf.parse(CHAOS_FLAGS + ["--gramian-checkpoint-dir", "/tmp/a"])
    resumer = PcaConf.parse(CHAOS_FLAGS + [
        "--gramian-checkpoint-dir", "/tmp/b", "--resume-from", "/tmp/a",
        "--checkpoint-every-sites", "17", "--fault-plan", "slow@rest.post=0",
        "--metrics-json", "m.json", "--device", "cpu",
    ])
    other = PcaConf.parse(["--num-samples", "9"] + CHAOS_FLAGS[2:])
    fingerprint = cp.gramian_checkpoint_fingerprint
    assert fingerprint(saver) == fingerprint(resumer) != fingerprint(other)


# -------------------------------------------------------------- artifacts


def _state(n=4, G=None):
    return {
        "strategy": "dense",
        "G": np.arange(n * n, dtype=np.int32).reshape(1, n, n) if G is None else G,
        "accum_dtype": "int32", "exact_int": True, "entry_bound": 7, "rows_seen": 12,
        "flushes": 3, "num_samples": n, "data_parallel": 1, "padded": n,
    }


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_round_trip_reads_in_both_packages(tmp_path, writer):
    directory = str(tmp_path / "ck")
    (cp if writer == "port" else ref_cp).save_gramian_checkpoint(directory, _state(), "fp-1", 12)
    for module in (cp, ref_cp):
        loaded = module.load_gramian_checkpoint(directory, "fp-1")
        assert loaded["meta"]["sites"] == 12 and loaded["meta"]["accum_dtype"] == "int32"
        np.testing.assert_array_equal(loaded["G"], _state()["G"])
    with pytest.raises(cp.CheckpointMismatchError, match="fingerprint"):
        cp.load_gramian_checkpoint(directory, "fp-2")


@pytest.mark.parametrize("damage", [b"not an npz", b"PK\x03\x04" + b"\x00" * 64],
                         ids=["not-a-zip", "bad-zip-tail"])
def test_absent_and_corrupt_artifacts(tmp_path, damage):
    assert cp.load_gramian_checkpoint(str(tmp_path / "nope")) is None
    directory = str(tmp_path / "ck")
    cp.save_gramian_checkpoint(directory, _state(), "fp", 1)
    with open(os.path.join(directory, cp.GRAMIAN_CKPT), "wb") as f:
        f.write(damage)
    with pytest.raises(cp.CheckpointCorruptError, match="delete"):
        cp.load_gramian_checkpoint(directory)


def test_save_sweeps_orphaned_tmps(tmp_path):
    directory = tmp_path / "ck"
    directory.mkdir()
    (directory / f"{cp.GRAMIAN_CKPT}.99999.tmp").write_bytes(b"x" * 128)
    cp.save_gramian_checkpoint(str(directory), _state(), "fp", 1)
    assert [n for n in os.listdir(directory) if n.endswith(".tmp")] == []
    assert cp.load_gramian_checkpoint(str(directory), "fp")["meta"]["sites"] == 1


# ----------------------------------------------------------------- feeder


class _StubAcc:
    def __init__(self):
        self.fed, self.restored = [], None

    def add_rows(self, rows):
        self.fed.append(np.asarray(rows))

    def restore_state(self, ckpt):
        self.restored = ckpt

    def snapshot_state(self):
        return _state()


def test_feeder_resume_skips_the_cursor_and_splits_blocks():
    acc = _StubAcc()
    resume = {"meta": {**_state(), "sites": 5}, "G": None}
    feeder = cp.GramianFeeder(acc, resume=resume)
    assert acc.restored is resume
    blocks = [np.arange(12).reshape(3, 4) + 10 * i for i in range(3)]
    for block in blocks:
        feeder.add_rows(block)
    assert (feeder.sites_skipped, feeder.checkpoint_sites, feeder.sites_done) == (5, 5, 9)
    np.testing.assert_array_equal(np.concatenate(acc.fed), np.concatenate(blocks)[5:])


def test_feeder_finish_rejects_a_truncated_input_stream():
    acc = _StubAcc()
    feeder = cp.GramianFeeder(acc, resume={"meta": {**_state(), "sites": 5}, "G": None})
    feeder.add_rows(np.arange(12).reshape(3, 4))
    with pytest.raises(cp.CheckpointMismatchError, match="shrank"):
        feeder.finish()
    assert acc.fed == []


def test_feeder_saves_on_cadence_and_at_finish(tmp_path):
    from spark_examples_tpu_torch.obs import MetricsRegistry

    directory = str(tmp_path / "ck")
    registry = MetricsRegistry()
    feeder = cp.GramianFeeder(_StubAcc(), directory=directory, every_sites=4,
                              fingerprint="fp", registry=registry)
    feeder.add_rows(np.zeros((3, 4), dtype=np.uint8))
    assert feeder.saves == 0
    feeder.add_rows(np.zeros((3, 4), dtype=np.uint8))
    assert feeder.saves == 1
    assert cp.load_gramian_checkpoint(directory, "fp")["meta"]["sites"] == 6
    feeder.add_rows(np.zeros((1, 4), dtype=np.uint8))
    feeder.finish()
    assert feeder.saves == 2
    assert cp.load_gramian_checkpoint(directory, "fp")["meta"]["sites"] == 7
    assert registry.value("gramian_checkpoint_saves_total") == 2
    assert registry.value("gramian_checkpoint_sites") == 7
    with pytest.raises(ValueError, match="cadence"):
        cp.GramianFeeder(_StubAcc(), directory=directory, every_sites=0)


# ----------------------------------------------------- snapshot / restore


def test_snapshot_and_restore_leave_the_gramian_exact():
    rng = np.random.default_rng(11)
    n = 13
    rows = (rng.random((300, n)) < 0.4).astype(np.uint8)
    first = GramianAccumulator(n, device="cpu", block_size=64)
    first.add_rows(rows[:170])
    state = first.snapshot_state()
    assert state["G"].shape == (1, n, n) and state["G"].dtype == np.int32
    np.testing.assert_array_equal(state["G"][0], gramian_reference(rows[:170]))
    assert first._fill == 0 and first._in_flight == []
    resumed = GramianAccumulator(n, device="cpu", block_size=64)
    resumed.restore_state({"meta": {**state, "sites": 170}, "G": state["G"]})
    assert (resumed.rows_seen, resumed._flushes) == (170, state["flushes"])
    resumed.add_rows(rows[170:])
    first.add_rows(rows[170:])
    want = gramian_reference(rows)
    np.testing.assert_array_equal(resumed.finalize(), want)
    np.testing.assert_array_equal(first.finalize(), want)


def test_restore_adopts_a_reference_float32_multi_slice_partial():
    """The reference's dense accumulator may save float32 entries and one
    partial per data-parallel device: exact integers, summed into int32."""
    rng = np.random.default_rng(2)
    parts = rng.integers(0, 1000, (3, 5, 5)).astype(np.float32)
    acc = GramianAccumulator(5, device="cpu")
    acc.restore_state({"meta": {**_state(5), "accum_dtype": "float32"}, "G": parts})
    assert acc.G.dtype == torch.int32
    np.testing.assert_array_equal(acc.G.numpy(), parts.astype(np.int64).sum(axis=0))
    with pytest.raises(ValueError, match="shape"):
        acc.restore_state({"meta": _state(4), "G": _state(4)["G"]})
    with pytest.raises(ValueError, match="exact integers"):
        acc.restore_state({"meta": _state(5), "G": parts + 0.5})


# ------------------------------------------------------------- the driver


@pytest.mark.parametrize(
    "extra, message",
    [
        (["--ingest", "device"], "--ingest device has no host-fed row cursor"),
        (["--pca-backend", "host"], "need --pca-backend"),
    ],
)
def test_checkpoint_flags_refuse_what_the_reference_refuses(tmp_path, extra, message):
    argv = ["--num-samples", "8", "--references", "1:0:20000",
            "--gramian-checkpoint-dir", str(tmp_path / "ck")] + extra
    with pytest.raises(ValueError):
        ref_driver.run_pipeline(RefConf.parse(["tpu" if a == "gpu" else a for a in argv]))
    with pytest.raises(ValueError, match=message):
        run_pipeline(PcaConf.parse(argv + ["--device", "cpu"]))


def test_chaos_matrix_kill_and_resume(tmp_path):
    """SIGKILL a CLI run at every driver/checkpoint kill point; each
    resume's Gramian and eigenvector TSV are byte-identical to the
    uninterrupted run's, and its manifest accounts the fast-forward."""
    assert set(CHAOS_MATRIX) == {
        site for site in faults.KILL_POINTS if site.startswith(("driver.", "checkpoint."))
    }
    killed = {
        site: _spawn("spark_examples_tpu_torch",
                     CHAOS_FLAGS + ["--gramian-checkpoint-dir", tmp_path / site],
                     f"kill@{site}#{nth}")
        for site, nth in CHAOS_MATRIX.items()
    }
    oracle, oracle_g = _run(CHAOS_FLAGS + ["--gramian-checkpoint-dir", tmp_path / "ck-oracle",
                                           "--output-path", tmp_path / "oracle"])
    oracle_tsv = (tmp_path / "oracle-pca.tsv" / "part-00000").read_bytes()
    assert oracle.driver.feeder.saves == 2
    np.testing.assert_array_equal(_artifact_gramian(tmp_path / "ck-oracle"), oracle_g)
    for site, proc in killed.items():
        _assert_killed(proc, site)
        ck = tmp_path / site
        assert not [n for n in os.listdir(ck) if n.endswith(".tmp")] or site == "checkpoint.mid-write"
        result, got_g = _run(CHAOS_FLAGS + [
            "--gramian-checkpoint-dir", ck, "--resume-from", ck,
            "--output-path", tmp_path / f"resumed-{site}",
            "--metrics-json", tmp_path / f"resumed-{site}.json",
        ])
        np.testing.assert_array_equal(got_g, oracle_g, err_msg=site)
        assert (tmp_path / f"resumed-{site}-pca.tsv" / "part-00000").read_bytes() == oracle_tsv
        doc = json.loads((tmp_path / f"resumed-{site}.json").read_text())
        assert validate_manifest(doc) == []
        resume = doc["resume"]
        assert resume["faults_injected"] == 0
        assert resume["sites_skipped"] == resume["checkpoint_sites"] > 0, site


def test_resume_from_a_torn_first_write_starts_from_zero(tmp_path):
    ck = tmp_path / "ck"
    _assert_killed(_spawn("spark_examples_tpu_torch",
                          CHAOS_FLAGS + ["--gramian-checkpoint-dir", ck],
                          "kill@checkpoint.mid-write#1"), "torn first write")
    names = os.listdir(ck)
    assert cp.GRAMIAN_CKPT not in names and any(n.endswith(".tmp") for n in names)
    result, got_g = _run(CHAOS_FLAGS + ["--resume-from", ck,
                                        "--metrics-json", tmp_path / "m.json"])
    _, oracle_g = _run(CHAOS_FLAGS)
    np.testing.assert_array_equal(got_g, oracle_g)
    assert json.loads((tmp_path / "m.json").read_text())["resume"]["sites_skipped"] == 0


def test_resume_rejects_fingerprint_drift_before_ingest(tmp_path):
    ck = tmp_path / "ck"
    _run(["--num-samples", "8", "--references", "1:0:50000", "--ingest", "packed",
          "--gramian-checkpoint-dir", ck])
    with pytest.raises(cp.CheckpointMismatchError, match="fingerprint"):
        run_pipeline(PcaConf.parse(["--num-samples", "12", "--references", "1:0:50000",
                                    "--ingest", "packed", "--resume-from", str(ck),
                                    "--device", "cpu"]))


def test_checkpoints_resume_across_the_two_packages(tmp_path):
    """A reference run killed at ``driver.post-flush#2`` resumes in the
    port, and a port run killed there resumes in the reference; both give
    the reference's uninterrupted Gramian exactly."""
    from_ref, from_port = tmp_path / "from-ref", tmp_path / "from-port"
    procs = {
        "reference": _spawn("spark_examples_tpu", CROSS_FLAGS + ["--gramian-checkpoint-dir", from_ref],
                            "kill@driver.post-flush#2"),
        "port": _spawn("spark_examples_tpu_torch",
                       CROSS_FLAGS + ["--gramian-checkpoint-dir", from_port],
                       "kill@driver.post-flush#2"),
    }
    with contextlib.redirect_stdout(io.StringIO()):
        ref_driver.run_pipeline(RefConf.parse(
            CROSS_FLAGS + ["--gramian-checkpoint-dir", str(tmp_path / "ref-oracle")]))
    want = _artifact_gramian(tmp_path / "ref-oracle")
    for label, proc in procs.items():
        _assert_killed(proc, label)
    # The reference's artifact, resumed by the port.
    assert ref_cp.load_gramian_checkpoint(str(from_ref))["meta"]["sites"] > 0
    result, got_g = _run(CROSS_FLAGS + ["--resume-from", from_ref])
    assert result.driver.feeder.sites_skipped > 0
    np.testing.assert_array_equal(got_g, want)
    # The port's artifact, resumed by the reference (its final snapshot is
    # the whole Gramian).
    assert cp.load_gramian_checkpoint(str(from_port))["meta"]["accum_dtype"] == "int32"
    with contextlib.redirect_stdout(io.StringIO()):
        ref_driver.run_pipeline(RefConf.parse(CROSS_FLAGS + [
            "--resume-from", str(from_port),
            "--gramian-checkpoint-dir", str(tmp_path / "ref-resumed")]))
    np.testing.assert_array_equal(_artifact_gramian(tmp_path / "ref-resumed"), want)
