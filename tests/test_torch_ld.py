"""The ``ld-prune`` verb: the port's ``ops/ld.py`` window statistics and
``analyses/ld.py`` against the JAX package's.

Every comparison is exact (zero tolerance): the window statistics are
integers, and r² is one float64 formula over them in both packages, so
the kept masks, the ``--ld-out`` bytes, the printed lines and the
manifest's ``analysis`` block are the reference's on the same argv, on the
synthetic and the file source and on ``--pca-backend host``. A run killed
at ``analysis.pre-manifest`` leaves the mask file complete and no
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

from spark_examples_tpu.analyses import ld as ref_ld
from spark_examples_tpu.config import LdConf as RefLdConf
from spark_examples_tpu.ops import ld as ref_ops
from spark_examples_tpu.utils import faults as ref_faults
from spark_examples_tpu_torch.analyses import ld
from spark_examples_tpu_torch.config import LdConf
from spark_examples_tpu_torch.obs.manifest import manifest_metric_value, validate_manifest
from spark_examples_tpu_torch.obs.metrics import ANALYSIS_SITES_KEPT, ANALYSIS_SITES_TESTED
from spark_examples_tpu_torch.ops import ld as ops
from spark_examples_tpu_torch.utils import faults

REPO = pathlib.Path(__file__).resolve().parents[1]
N_SAMPLES = 12
#: Two contigs, window 32, blocks of 50 sites that the synthetic source's
#: reference-block drops leave ragged.
SYNTHETIC = ["--num-samples", str(N_SAMPLES), "--references", "1:0:200000,2:0:100000",
             "--block-size", "50", "--ld-window-sites", "32"]


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.configure(None)
    ref_faults.configure(None)
    yield
    faults.configure(None)
    ref_faults.configure(None)


def _window(W, N, seed):
    """Seeded {0,1} rows with an all-zero and an all-one row."""
    rows = (np.random.default_rng(seed).random((W, N)) < 0.4).astype(np.uint8)
    rows[0] = 0
    rows[-1] = 1
    return rows


@pytest.mark.parametrize("N", [8, 13, 130])
@pytest.mark.parametrize("W", [2, 24, 256])
def test_window_stats_equal_the_reference(W, N):
    """C and k of the port's program (the kernels' plain versions on the
    CPU) equal the reference's jitted ``build_ld_window_stats(None)``."""
    rows = _window(W, N, W * 1000 + N)
    C, k = ops.ld_window_stats(rows, device="cpu")
    C_ref, k_ref = ref_ops.build_ld_window_stats(None)(rows)
    assert C.dtype == np.int32 and k.dtype == np.int32
    np.testing.assert_array_equal(C, np.asarray(C_ref))
    np.testing.assert_array_equal(k, np.asarray(k_ref))
    # k is diag(C) only because the rows are {0,1}; the reference counts
    # it apart.
    np.testing.assert_array_equal(k, rows.sum(axis=1))
    C_oracle, k_oracle = ops.ld_window_stats_reference(rows)
    np.testing.assert_array_equal(C_oracle, ref_ops.ld_window_stats_reference(rows)[0])
    np.testing.assert_array_equal(k_oracle, ref_ops.ld_window_stats_reference(rows)[1])


def test_window_packing_is_the_transposed_packbits():
    rows = _window(37, 13, 5)
    packed = ops.pack_window(rows)
    assert packed.flags.c_contiguous and packed.shape == (13, 5)
    np.testing.assert_array_equal(packed, np.packbits(rows.T, axis=1))


@pytest.mark.parametrize("threshold", [0.0, 0.2, 0.5, 1.0])
@pytest.mark.parametrize("masked", [False, True])
def test_r2_and_greedy_prune_equal_the_reference(threshold, masked):
    rows = _window(48, 13, 11)
    rows[5] = rows[4]  # a duplicate: r² 1
    rows[7] = 1 - rows[6]  # a complement: r² 1
    C, k = ops.ld_window_stats_reference(rows)
    r2 = ops.r2_from_counts(C, k, 13)
    assert r2.tobytes() == ref_ops.r2_from_counts(C, k, 13).tobytes()
    valid = (np.arange(48) % 5 != 3) if masked else None
    kept = ops.greedy_prune(C, k, 13, threshold, valid=valid)
    np.testing.assert_array_equal(kept, ref_ops.greedy_prune(C, k, 13, threshold, valid=valid))
    if masked:
        assert not kept[~valid].any()


def test_tail_window_on_its_rows_keeps_what_the_padded_window_keeps():
    """The port runs a tail window on its ``fill`` rows; the reference pads
    it to W with zero rows and masks them with ``valid``."""
    rows = _window(37, 13, 17)[:-1]
    padded = np.zeros((64, 13), dtype=np.uint8)
    padded[:36] = rows
    valid = np.arange(64) < 36
    C, k = ops.ld_window_stats(rows, device="cpu")
    C_pad, k_pad = ref_ops.build_ld_window_stats(None)(padded)
    want = ref_ops.greedy_prune(np.asarray(C_pad), np.asarray(k_pad), 13, 0.2, valid=valid)
    np.testing.assert_array_equal(ops.greedy_prune(C, k, 13, 0.2), want[:36])


def _vcf(path, rows=70):
    rng = np.random.default_rng(9)
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"S{i}" for i in range(N_SAMPLES))]
    for contig in ("1", "2"):
        for k in range(rows):
            gts = "\t".join(rng.choice(["0|0", "0|1", "1|1", "0|0"], N_SAMPLES))
            lines.append(f"{contig}\t{100 + 37 * k}\t.\tA\tG\t.\t.\tAF=0.3\tGT\t{gts}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _argv(tmp_path, case):
    if case == "file":
        return ["--source", "file", "--input-files", _vcf(tmp_path / "cohort.vcf"),
                "--references", "1:0:2000,2:0:1500", "--bases-per-partition", "1000",
                "--block-size", "16", "--ld-window-sites", "32"]
    if case == "host backend":
        return SYNTHETIC + ["--pca-backend", "host"]
    return list(SYNTHETIC)


def _run_both(argv, out, manifest):
    """The port's then the reference's ``run_ld_pipeline`` on one argv
    (each writing ``out`` and ``manifest``): (result, printed, file bytes,
    manifest) per package."""
    argv = argv + ["--ld-out", str(out), "--metrics-json", str(manifest)]
    runs = []
    for run in (lambda: ld.run_ld_pipeline(LdConf.parse(argv + ["--device", "cpu"])),
                lambda: ref_ld.run_ld_pipeline(RefLdConf.parse(argv))):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            result = run()
        runs.append((result, printed.getvalue(), out.read_bytes(),
                     json.loads(manifest.read_text())))
        os.remove(out)
    return runs


@pytest.mark.parametrize("case", ["synthetic", "file", "host backend"])
def test_ld_prune_is_byte_identical_to_the_reference(tmp_path, case):
    argv = _argv(tmp_path, case)
    (got, printed, tsv, doc), (want, ref_printed, ref_tsv, ref_doc) = _run_both(
        argv, tmp_path / "kept.tsv", tmp_path / "m.json")
    assert tsv == ref_tsv
    assert printed == ref_printed
    assert (got.sites_tested, got.sites_kept) == (want.sites_tested, want.sites_kept)
    assert doc["analysis"] == ref_doc["analysis"] == {
        "kind": "ld", "sites_kept": got.sites_kept, "sites_tested": got.sites_tested}
    assert 0 < got.sites_kept < got.sites_tested
    assert tsv.count(b"\n") == got.sites_tested + 1
    assert tsv.startswith(b"contig\tpos\tkept\n")
    assert validate_manifest(doc) == []
    for name, value in ((ANALYSIS_SITES_TESTED, got.sites_tested),
                        (ANALYSIS_SITES_KEPT, got.sites_kept)):
        assert manifest_metric_value(doc, name) == manifest_metric_value(ref_doc, name) == value
    stage = [s for s in doc["spans"] if s["name"] == "ingest+ld-prune"]
    assert [c["name"] for c in stage[0]["children"]] == ["ld-window-stats", "ld-greedy-prune"]


def test_ld_prune_matches_the_windowed_oracle(tmp_path):
    """The streamed run against ``ld_prune_reference`` over the contig's
    rows cut into windows, as the reference's own test builds it."""
    from spark_examples_tpu_torch.analyses.base import AnalysisContext

    out = tmp_path / "kept.tsv"
    conf = LdConf.parse(SYNTHETIC + ["--ld-out", str(out), "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        result = ld.run_ld_pipeline(conf)
        ctx = AnalysisContext(conf, "ld")
        by_contig = {}
        for contig, block in ctx.blocks():
            by_contig.setdefault(contig, []).append((block["positions"], block["has_variation"]))
    expected, kept_total = ["contig\tpos\tkept"], 0
    W = conf.ld_window_sites
    for contig, blocks in by_contig.items():
        positions = np.concatenate([p for p, _ in blocks])
        hv = np.concatenate([h for _, h in blocks])
        windows = [(positions[i:i + W], hv[i:i + W]) for i in range(0, len(positions), W)]
        oracle = ld.ld_prune_reference(windows, N_SAMPLES, conf.ld_r2_threshold)
        assert oracle == ref_ld.ld_prune_reference(windows, N_SAMPLES, conf.ld_r2_threshold)
        for pos, kept in oracle:
            expected.append(f"{contig}\t{pos}\t{int(kept)}")
            kept_total += int(kept)
    assert out.read_text().splitlines() == expected
    assert (result.sites_kept, result.sites_tested) == (kept_total, len(expected) - 1)
    assert len(by_contig) == 2


@pytest.mark.parametrize("threshold", ["0", "1"])
def test_threshold_extremes_equal_the_reference(tmp_path, threshold):
    argv = SYNTHETIC + ["--ld-r2-threshold", threshold]
    (got, _, tsv, _), (want, _, ref_tsv, _) = _run_both(
        argv, tmp_path / "kept.tsv", tmp_path / "m.json")
    assert tsv == ref_tsv and got.sites_kept == want.sites_kept


def test_live_gauges_and_heartbeat(tmp_path, capsys):
    """The pruner advances the analysis gauges per window; the heartbeat
    reports them."""
    from spark_examples_tpu_torch.obs import MetricsRegistry
    from spark_examples_tpu_torch.obs.heartbeat import Heartbeat

    registry = MetricsRegistry()
    conf = LdConf.parse(SYNTHETIC + ["--device", "cpu"])
    pruner = ld._WindowedPruner(conf, N_SAMPLES, ops.ld_window_stats_reference, None, registry)
    rows = _window(40, N_SAMPLES, 3)
    pruner.add_block("1", {"has_variation": rows, "positions": np.arange(40) * 100})
    assert registry.value(ANALYSIS_SITES_TESTED) == 32  # one full window so far
    pruner.flush()
    assert registry.value(ANALYSIS_SITES_TESTED) == 40 == pruner.sites_tested
    assert registry.value(ANALYSIS_SITES_KEPT) == pruner.sites_kept
    line = Heartbeat(60.0, registry, emit=lambda _: None).line()
    assert f"analysis kept {pruner.sites_kept}/40 sites" in line
    ld.run_ld_pipeline(LdConf.parse(SYNTHETIC + ["--heartbeat-seconds", "0.001", "--device",
                                                 "cpu"]))
    assert "heartbeat[" in capsys.readouterr().err


@pytest.mark.parametrize(
    "extra",
    [["--ld-r2-threshold", "1.5"], ["--ld-r2-threshold", "-0.1"], ["--ld-window-sites", "1"],
     ["--ld-window-sites", "0"]],
)
def test_ld_conf_rejects_as_the_reference(extra):
    argv = ["--num-samples", "8", "--references", "1:0:30000", *extra]
    with pytest.raises(ValueError) as ref_error:
        RefLdConf.parse(argv)
    with pytest.raises(ValueError) as error:
        LdConf.parse(argv)
    assert str(error.value) == str(ref_error.value)


def test_ld_conf_defaults_and_device():
    conf, ref = LdConf.parse([]), RefLdConf.parse([])
    assert (conf.ld_r2_threshold, conf.ld_window_sites, conf.ld_out) == (
        ref.ld_r2_threshold, ref.ld_window_sites, ref.ld_out) == (0.2, 256, None)
    assert conf.device == "cuda" and LdConf.parse(["--device", "cpu"]).device == "cpu"


def test_kill_before_the_manifest_leaves_the_mask_complete(tmp_path):
    """SIGKILL at ``analysis.pre-manifest``: the atomically published mask
    file is whole (the uninterrupted run's bytes) and no manifest and no
    temp file exist."""
    out, manifest = tmp_path / "kept.tsv", tmp_path / "m.json"
    argv = SYNTHETIC + ["--ld-out", str(out), "--metrics-json", str(manifest)]
    env = dict(os.environ, PYTHONPATH=str(REPO),
               SPARK_EXAMPLES_TPU_FAULTS="kill@analysis.pre-manifest")
    proc = subprocess.run([sys.executable, "-m", "spark_examples_tpu_torch", "ld-prune", *argv,
                           "--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    killed = out.read_bytes()
    assert not manifest.exists()
    assert sorted(os.listdir(tmp_path)) == ["kept.tsv"]
    with contextlib.redirect_stdout(io.StringIO()):
        result = ld.run_ld_pipeline(LdConf.parse(argv + ["--device", "cpu"]))
    assert out.read_bytes() == killed
    assert killed.count(b"\n") == result.sites_tested + 1
    assert result.manifest_path == str(manifest)


def test_cli_runs_ld_prune(tmp_path, capsys):
    from spark_examples_tpu_torch.cli import NOT_PORTED, main

    assert "ld-prune" not in NOT_PORTED
    out = tmp_path / "kept.tsv"
    assert main(["ld-prune", *SYNTHETIC, "--ld-out", str(out), "--device", "cpu"]) == 0
    assert "LD prune (r² > 0.2 pruned, window 32): kept" in capsys.readouterr().out
    assert out.read_bytes().startswith(b"contig\tpos\tkept\n")


def test_the_default_device_is_the_card():
    """Without ``--device cpu`` the verb runs on the card, and raises where
    there is none: it never drops to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ld.run_ld_pipeline(LdConf.parse(SYNTHETIC))
