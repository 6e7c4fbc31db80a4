"""The slice as a whole: ``variants-pca`` of the JAX package against the
port's ``run(argv, device="cpu")`` on the same argv.

Every printed line is identical ("Matrix size", "Running PCA", "Variantset",
"Non zero rows", the sorted names and dataset columns, the "Variants API
stats" block) except the PC values, which agree within 1e-4 per entry (the
eigensolves start from different random iterates; see test_torch_pca.py).
With ``--pca-backend host`` both packages run the same NumPy oracle on the
same Gramian, so the PC values are identical too."""

import numpy as np
import pytest

from spark_examples_tpu.pipeline import pca_driver as ref_driver
from spark_examples_tpu_torch import run

TOLERANCE = 1e-4
BASE = [
    "--references", "17:0:20000",
    "--variant-set-id", "vs-a",
    "--num-samples", "12",
    "--seed", "5",
    "--bases-per-partition", "5000",
]


def _runs(capsys, argv, ref_argv=None):
    ref_lines = ref_driver.run(ref_argv or argv)
    ref_out = capsys.readouterr().out.splitlines()
    lines = run(argv, device="cpu")
    out = capsys.readouterr().out.splitlines()
    return ref_lines, ref_out, lines, out


def _assert_same_output(ref_out, out, atol):
    assert len(out) == len(ref_out)
    rows = 0
    for got, want in zip(out, ref_out):
        g, w = got.split("\t"), want.split("\t")
        if len(w) < 3:
            assert got == want
            continue
        rows += 1
        assert g[:2] == w[:2]
        np.testing.assert_allclose(
            np.array(g[2:], dtype=float), np.array(w[2:], dtype=float), rtol=0, atol=atol
        )
    assert rows > 0
    assert any(line.startswith("Non zero rows in matrix:") for line in out)
    assert "Variants API stats:" in out


@pytest.mark.parametrize(
    "extra",
    [
        ["--ingest", "device"],
        [],
        ["--min-allele-frequency", "0.2"],
        ["--num-pc", "3", "--block-size", "64", "--blocks-per-dispatch", "2"],
    ],
)
def test_device_path_matches_jax(capsys, extra):
    _, ref_out, _, out = _runs(capsys, BASE + extra)
    _assert_same_output(ref_out, out, TOLERANCE)


def test_multi_set_asymmetric_cohort_matches_jax(capsys):
    argv = [
        "--references", "17:0:20000",
        "--variant-set-id", "vs-a,vs-b",
        "--num-samples", "30,7",
        "--seed", "5",
        "--bases-per-partition", "5000",
    ]
    ref_lines, ref_out, lines, out = _runs(capsys, argv)
    _assert_same_output(ref_out, out, TOLERANCE)
    assert len(lines) == len(ref_lines) == 37


def test_host_backend_matches_jax_exactly(capsys):
    """The NumPy oracle on the port's device-generated Gramian gives the
    JAX package's host-backend rows to the last digit. The reference's host
    backend ingests through the wire path, whose stats count every record
    read, so the rest of the output is held against its device path."""
    argv = BASE + ["--pca-backend", "host"]
    ref_lines, _, lines, out = _runs(capsys, argv)
    assert lines == ref_lines
    ref_driver.run(BASE)
    ref_device_out = capsys.readouterr().out.splitlines()
    rows = set(lines)
    assert [l for l in out if l not in rows] == [
        l for l in ref_device_out if len(l.split("\t")) < 3
    ]


def test_output_path_matches_jax(tmp_path, capsys):
    _runs(
        capsys,
        BASE + ["--output-path", str(tmp_path / "port")],
        BASE + ["--output-path", str(tmp_path / "ref")],
    )
    got = (tmp_path / "port-pca.tsv" / "part-00000").read_text().splitlines()
    want = (tmp_path / "ref-pca.tsv" / "part-00000").read_text().splitlines()
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        g, w = g.split("\t"), w.split("\t")
        assert (g[0], g[-1]) == (w[0], w[-1])
        np.testing.assert_allclose(
            np.array(g[1:-1], dtype=float), np.array(w[1:-1], dtype=float),
            rtol=0, atol=TOLERANCE,
        )
