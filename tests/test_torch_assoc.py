"""The ``assoc-scan`` verb: the port's ``case_counts`` and
``analyses/assoc.py`` against the JAX package's.

Every comparison is exact (zero tolerance): the counts are integers and
the chi-square one float64 formula over them in both packages, so the
``--assoc-out`` bytes (``repr`` of each float64), the top list, the
printed lines and the manifest's ``analysis`` block are the reference's on
the same argv, on the synthetic and the file source and on
``--pca-backend host``."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from spark_examples_tpu.analyses import assoc as ref_assoc
from spark_examples_tpu.config import AssocConf as RefAssocConf
from spark_examples_tpu.ops import ld as ref_ops
from spark_examples_tpu.utils import faults as ref_faults
from spark_examples_tpu_torch.analyses import assoc
from spark_examples_tpu_torch.analyses.base import AnalysisContext
from spark_examples_tpu_torch.config import AssocConf
from spark_examples_tpu_torch.obs.manifest import validate_manifest
from spark_examples_tpu_torch.ops import ld as ops
from spark_examples_tpu_torch.utils import faults

N_SAMPLES = 12
SYNTHETIC = ["--num-samples", str(N_SAMPLES), "--references", "1:0:200000,2:0:100000",
             "--block-size", "50"]


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.configure(None)
    ref_faults.configure(None)
    yield
    faults.configure(None)
    ref_faults.configure(None)


def _rows(B, N, seed):
    rng = np.random.default_rng(seed)
    rows = (rng.random((B, N)) < 0.4).astype(np.uint8)
    rows[rows.sum(axis=1) == 0, 0] = 1  # the sources drop all-zero rows
    rows[-1] = 1
    case = (rng.random(N) < 0.5).astype(np.uint8)
    case[0], case[-1] = 1, 0
    return rows, case


@pytest.mark.parametrize("N", [8, 13, 130])
@pytest.mark.parametrize("B", [1, 37, 1024])
def test_case_counts_equal_the_reference(B, N):
    """The port's counts (the packed block through the wrapper's plain
    version on the CPU) equal the reference's jitted ``build_case_counts``."""
    rows, case = _rows(B, N, B + N)
    a_ref, t_ref = ref_ops.build_case_counts()(rows, case)
    a, t = ops.block_case_counts(rows, ops.pack_case(case), device="cpu")
    assert a.dtype == np.int32 and t.dtype == np.int32
    np.testing.assert_array_equal(a, np.asarray(a_ref))
    np.testing.assert_array_equal(t, np.asarray(t_ref))
    a_oracle, t_oracle = ops.case_counts_reference(rows, case)
    want = ref_ops.case_counts_reference(rows, case)
    np.testing.assert_array_equal(a_oracle, want[0])
    np.testing.assert_array_equal(t_oracle, want[1])


def test_case_counts_ignore_the_padding_and_take_any_pitch():
    """Bits past N in the last byte count nothing; rows may be any pitch
    apart (the shipped 16-byte pitch, an odd pitch, contiguous)."""
    rows, case = _rows(37, 13, 2)
    packed = np.packbits(rows, axis=1)
    packed[:, -1] |= 0x07  # junk in the three unused bits
    case_packed = np.packbits(case)
    case_packed[-1] |= 0x07
    want = ops.case_counts_reference(rows, case)
    for pitch in (2, 3, 16):
        host = np.full((37, pitch), 0xFF, dtype=np.uint8)
        host[:, :2] = packed
        a, t = ops.case_counts(torch.from_numpy(host)[:, :2], torch.from_numpy(case_packed), 13)
        np.testing.assert_array_equal(a.numpy(), want[0])
        np.testing.assert_array_equal(t.numpy(), want[1])
    shipped = ops.pack_rows(rows)
    assert shipped.shape == (37, 2) and shipped.stride() == (16, 1)


def test_case_counts_rejects_what_the_kernel_does_not_take():
    block = torch.zeros((4, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="block must be"):
        ops.case_counts(block, torch.zeros(2, dtype=torch.uint8), 17)
    with pytest.raises(TypeError, match="block"):
        ops.case_counts(block.int(), torch.zeros(2, dtype=torch.uint8), 13)
    with pytest.raises(ValueError, match="case"):
        ops.case_counts(block, torch.zeros(3, dtype=torch.uint8), 13)


@pytest.mark.parametrize(
    "text",
    ["A\t2\n", "A\t1\nA\t0\n", "A 1\n", "", "A\t1\nB\t1\n", "A\t0\nB\t0\n", "# only\n\n"],
)
def test_load_phenotypes_errors_are_the_reference(tmp_path, text):
    path = tmp_path / "p.tsv"
    path.write_text(text)
    with pytest.raises(ValueError) as ref_error:
        ref_assoc.load_phenotypes(str(path))
    with pytest.raises(ValueError) as error:
        assoc.load_phenotypes(str(path))
    assert str(error.value) == str(ref_error.value)


def test_load_phenotypes_and_case_vector(tmp_path):
    path = tmp_path / "p.tsv"
    path.write_text("# comment\nA\t1\n\nB\t0\nC\t1\n")
    statuses = assoc.load_phenotypes(str(path))
    assert statuses == ref_assoc.load_phenotypes(str(path)) == {"A": 1, "B": 0, "C": 1}
    np.testing.assert_array_equal(assoc.case_vector(statuses, ["C", "B", "A"]), [1, 0, 1])
    for names in (["A", "B", "C", "D"], ["A", "B"]):
        mapping = statuses if len(names) == 4 else {**statuses, "Z": 1}
        with pytest.raises(ValueError) as ref_error:
            ref_assoc.case_vector(mapping, names)
        with pytest.raises(ValueError) as error:
            assoc.case_vector(mapping, names)
        assert str(error.value) == str(ref_error.value)


def test_chi2_from_counts_equals_the_reference():
    rng = np.random.default_rng(5)
    n_cases, n_controls = 611, 1893
    t = rng.integers(0, n_cases + n_controls + 1, size=5000)
    a = np.clip(rng.integers(0, n_cases + 1, size=5000), t - n_controls, t)
    got = assoc.chi2_from_counts(a, t, n_cases, n_controls)
    assert got.tobytes() == ref_assoc.chi2_from_counts(a, t, n_cases, n_controls).tobytes()
    assert (got[(t == 0) | (t == n_cases + n_controls)] == 0).all()


def _vcf(path, rows=70):
    rng = np.random.default_rng(9)
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"S{i}" for i in (5, 0, 3, 1, 9, 2, 4, 6, 11, 7, 8, 10))]
    for contig in ("1", "2"):
        for k in range(rows):
            gts = "\t".join(rng.choice(["0|0", "0|1", "1|1", "0|0"], N_SAMPLES))
            lines.append(f"{contig}\t{100 + 37 * k}\t.\tA\tG\t.\t.\tAF=0.3\tGT\t{gts}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _phenotypes(tmp_path, argv):
    """Callset i of the cohort (its column order) gets status i % 2."""
    conf = AssocConf.parse(argv + ["--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        names = AnalysisContext(conf, "assoc").sample_names()
    path = tmp_path / "pheno.tsv"
    path.write_text("".join(f"{name}\t{i % 2}\n" for i, name in enumerate(names)))
    return str(path)


def _argv(tmp_path, case):
    if case == "file":
        # The header's sample order is not sorted: the case mask follows it.
        argv = ["--source", "file", "--input-files", _vcf(tmp_path / "cohort.vcf"),
                "--references", "1:0:2000,2:0:1500", "--bases-per-partition", "1000",
                "--block-size", "16"]
    elif case == "host backend":
        argv = SYNTHETIC + ["--pca-backend", "host"]
    else:
        argv = list(SYNTHETIC)
    return argv + ["--phenotypes", _phenotypes(tmp_path, argv), "--assoc-top", "7"]


def test_the_case_mask_follows_the_cohort_order(tmp_path):
    """``sample_names`` is the VCF header's order (the PCA emit sorts by
    name; the case mask must not)."""
    argv = _argv(tmp_path, "file")
    with contextlib.redirect_stdout(io.StringIO()):
        names = AnalysisContext(AssocConf.parse(argv + ["--device", "cpu"]), "assoc").sample_names()
    assert names == [f"S{i}" for i in (5, 0, 3, 1, 9, 2, 4, 6, 11, 7, 8, 10)]
    statuses = assoc.load_phenotypes(argv[argv.index("--phenotypes") + 1])
    np.testing.assert_array_equal(assoc.case_vector(statuses, names), np.arange(12) % 2)


def _run_both(argv, out, manifest):
    argv = argv + ["--assoc-out", str(out), "--metrics-json", str(manifest)]
    runs = []
    for run in (lambda: assoc.run_assoc_pipeline(AssocConf.parse(argv + ["--device", "cpu"])),
                lambda: ref_assoc.run_assoc_pipeline(RefAssocConf.parse(argv))):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            result = run()
        runs.append((result, printed.getvalue(), out.read_bytes(),
                     json.loads(manifest.read_text())))
        os.remove(out)
    return runs


@pytest.mark.parametrize("case", ["synthetic", "file", "host backend"])
def test_assoc_scan_is_byte_identical_to_the_reference(tmp_path, case):
    argv = _argv(tmp_path, case)
    (got, printed, tsv, doc), (want, ref_printed, ref_tsv, ref_doc) = _run_both(
        argv, tmp_path / "scan.tsv", tmp_path / "m.json")
    assert tsv == ref_tsv
    assert printed == ref_printed
    assert got.top == want.top and len(got.top) == 7
    assert (got.n_cases, got.n_controls) == (want.n_cases, want.n_controls) == (6, 6)
    assert got.sites_tested == want.sites_tested > 0
    assert doc["analysis"] == ref_doc["analysis"] == {
        "kind": "assoc", "sites_kept": None, "sites_tested": got.sites_tested}
    assert validate_manifest(doc) == []
    assert tsv.startswith(b"contig\tpos\tcase_carriers\tcarriers\tchi2\n")
    assert tsv.count(b"\n") == got.sites_tested + 1
    stage = [s for s in doc["spans"] if s["name"] == "ingest+assoc-scan"]
    assert [c["name"] for c in stage[0]["children"]] == ["assoc-case-counts"]


def test_the_scan_equals_the_oracle_over_the_cohort_rows(tmp_path):
    """The TSV rebuilt from ``case_counts_reference`` + ``chi2_from_counts``
    over the streamed rows, and the top list as the heap's order."""
    argv = _argv(tmp_path, "synthetic")
    out = tmp_path / "scan.tsv"
    conf = AssocConf.parse(argv + ["--assoc-out", str(out), "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        result = assoc.run_assoc_pipeline(conf)
        ctx = AnalysisContext(conf, "assoc")
        blocks = list(ctx.blocks())
        case = assoc.case_vector(assoc.load_phenotypes(conf.phenotypes), ctx.sample_names())
    lines, entries = ["contig\tpos\tcase_carriers\tcarriers\tchi2"], []
    for contig, block in blocks:
        a, t = ops.case_counts_reference(block["has_variation"], case)
        chi2 = assoc.chi2_from_counts(a, t, 6, 6)
        for p, ai, ti, c in zip(block["positions"], a, t, chi2):
            lines.append(f"{contig}\t{int(p)}\t{int(ai)}\t{int(ti)}\t{float(c)!r}")
            entries.append((float(c), -len(entries), contig, int(p), int(ai), int(ti)))
    assert out.read_text() == "\n".join(lines) + "\n"
    top = [(c, contig, p, ai, ti) for c, _, contig, p, ai, ti in sorted(entries, reverse=True)[:7]]
    assert result.top == top


def test_requires_phenotypes_as_the_reference():
    with pytest.raises(ValueError, match="phenotypes") as error:
        assoc.run_assoc_pipeline(AssocConf.parse(SYNTHETIC + ["--device", "cpu"]))
    with pytest.raises(ValueError) as ref_error:
        ref_assoc.run_assoc_pipeline(RefAssocConf.parse(SYNTHETIC))
    assert str(error.value) == str(ref_error.value)


@pytest.mark.parametrize("top", ["0", "-3"])
def test_assoc_conf_rejects_as_the_reference(top):
    argv = SYNTHETIC + ["--phenotypes", "x", "--assoc-top", top]
    with pytest.raises(ValueError) as ref_error:
        RefAssocConf.parse(argv)
    with pytest.raises(ValueError) as error:
        AssocConf.parse(argv)
    assert str(error.value) == str(ref_error.value)


def test_assoc_conf_defaults():
    conf, ref = AssocConf.parse([]), RefAssocConf.parse([])
    assert (conf.phenotypes, conf.assoc_out, conf.assoc_top) == (
        ref.phenotypes, ref.assoc_out, ref.assoc_top) == (None, None, 10)
    assert conf.device == "cuda"


def test_cli_runs_assoc_scan(tmp_path, capsys):
    from spark_examples_tpu_torch.cli import NOT_PORTED, main

    assert "assoc-scan" not in NOT_PORTED
    argv = _argv(tmp_path, "synthetic")
    out = tmp_path / "scan.tsv"
    assert main(["assoc-scan", *argv, "--assoc-out", str(out), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "Phenotypes: 6 cases / 6 controls." in printed
    assert "Association scan:" in printed and out.exists()
