"""The slice as a whole: ``variants-pca`` of the JAX package against the
port's ``run(argv, device="cpu")`` on the same argv.

Every printed line is identical ("Matrix size", "Running PCA", "Variantset",
"Non zero rows", the sorted names and dataset columns, the "Variants API
stats" block) except the PC values, which agree within 1e-4 per entry (the
eigensolves start from different random iterates; see test_torch_pca.py),
for each ingest arm: device generation, packed, and wire with its
same-set, two-set and three-set joins. With ``--pca-backend host`` both
packages take the wire arm and run the same NumPy oracle on the same
Gramian, so the PC values are identical too."""

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


def _assert_same_output(ref_out, out, atol, stats=True):
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
    assert ("Variants API stats:" in out) == stats


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


@pytest.mark.parametrize("n_sets", [9, 33])
def test_device_path_many_sets_matches_jax(capsys, n_sets):
    """``--ingest device`` over 9 and 33 variant sets: the printed lines as
    the JAX package prints them, and the run's Gramian, per-set variant rows
    and kept sites exactly the JAX accumulator's over the same grid."""
    from spark_examples_tpu.ops.devicegen import DeviceGenGramianAccumulator as RefAccumulator
    from spark_examples_tpu.sharding.contig import Contig
    from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource
    from spark_examples_tpu_torch.config import PcaConf
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline

    sets = [f"vs-{i}" for i in range(n_sets)]
    argv = [
        "--references", "17:0:12000",
        "--variant-set-id", ",".join(sets),
        "--num-samples", "3",
        "--seed", "5",
        "--bases-per-partition", "5000",
        "--ingest", "device",
    ]
    ref_driver.run(argv)
    ref_out = capsys.readouterr().out.splitlines()
    result = run_pipeline(PcaConf.parse(argv), device="cpu")
    out = capsys.readouterr().out.splitlines()
    _assert_same_output(ref_out, out, TOLERANCE)
    assert len(result.lines) == 3 * n_sets

    source = SyntheticGenomicsSource(num_samples=3, seed=5)
    ref_acc = RefAccumulator(
        num_samples=3, vs_keys=[source.genotype_stream_key(v) for v in sets],
        pops=source.populations, site_key=source.site_key, spacing=source.variant_spacing,
        ref_block_fraction=source.ref_block_fraction, block_size=1024, blocks_per_dispatch=32,
        n_pops=source.n_pops,
    )
    ref_acc.add_grid(*source.site_grid_range(Contig("17", 0, 12000)))
    acc = result.driver.accumulator
    np.testing.assert_array_equal(acc.finalize(), ref_acc.finalize())
    rows, kept = acc.ingest_counters()
    want_rows, want_kept = ref_acc.ingest_counters()
    assert rows.tolist() == np.asarray(want_rows).tolist() and kept == int(want_kept)
    assert min(rows) > 0


def test_host_backend_matches_jax_exactly(capsys):
    """With ``--pca-backend host`` both packages ingest through the wire arm
    and run the same NumPy oracle on the same Gramian: every printed line is
    identical, the PC values and the "Variants API stats" block included."""
    argv = BASE + ["--pca-backend", "host"]
    ref_lines, ref_out, lines, out = _runs(capsys, argv)
    assert lines == ref_lines
    assert out == ref_out
    assert "Variants API stats:" in out


@pytest.mark.parametrize(
    "extra",
    [
        ["--ingest", "packed"],
        ["--ingest", "packed", "--ingest-workers", "0"],
        ["--ingest", "packed", "--ingest-workers", "2", "--block-size", "16"],
        ["--ingest", "packed", "--min-allele-frequency", "0.2", "--block-size", "100"],
        ["--ingest", "wire"],
        ["--ingest", "wire", "--num-workers", "1", "--block-size", "16"],
        ["--ingest", "wire", "--min-allele-frequency", "0.2"],
        ["--variant-set-id", "vs-a,vs-a"],
        ["--variant-set-id", "vs-a,vs-a", "--ingest", "wire", "--block-size", "16"],
        ["--variant-set-id", "vs-a,vs-b", "--ingest", "wire"],
        ["--variant-set-id", "vs-a,vs-b,vs-c", "--ingest", "wire"],
        ["--variant-set-id", "vs-a,vs-b,vs-c", "--pca-backend", "host"],
    ],
)
def test_host_fed_arms_match_jax(capsys, extra):
    """The packed and wire arms, the same-set join (duplicate ids: counts
    mode), and the two- and three-set wire joins print the reference's
    lines; the PC values agree within the tolerance."""
    ref_lines, ref_out, lines, out = _runs(capsys, BASE + extra)
    _assert_same_output(ref_out, out, TOLERANCE)
    assert len(lines) == len(ref_lines)


def test_packed_arm_telemetry_on_the_cpu(capsys):
    """The packed arm's accumulator flushed every block and its spans nest
    under the ingest stage; on the CPU the wrappers ran their plain
    versions, so no launch is counted."""
    from spark_examples_tpu_torch.ops import gramian
    from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline
    from spark_examples_tpu_torch.config import PcaConf

    gramian.reset_launch_counts()
    result = run_pipeline(PcaConf.parse(BASE + ["--ingest", "packed", "--block-size", "16"]), "cpu")
    capsys.readouterr()
    driver = result.driver
    flushes = driver.registry.value("gramian_flushes_total")
    assert flushes == -(-driver.registry.value("gramian_rows_total") // 16)
    assert gramian.unpack_rows_t.launches == 0
    paths = [s["path"] for s in driver.spans.flat()]
    assert "ingest+similarity/reduce-flush" in paths
    assert "ingest+similarity/chunk-parse" in paths


@pytest.mark.parametrize(
    "extra, message",
    [
        (["--ingest", "packed", "--pca-backend", "host"], "--ingest packed requires"),
        (["--ingest", "packed", "--variant-set-id", "vs-a,vs-b"], "single variant set"),
        (["--ingest", "device", "--variant-set-id", "vs-a,vs-a"], "--ingest device requires"),
        (["--ingest", "device", "--pca-backend", "host"], "--ingest device requires"),
    ],
)
def test_ingest_resolution_errors_match_jax(extra, message):
    argv = BASE + extra
    with pytest.raises(ValueError):
        ref_driver.run(argv)
    with pytest.raises(ValueError, match=message):
        run(argv, device="cpu")


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


# ------------------------------------------------------------- file source


def _write_vcf(tmp_path, name, seed, n_samples=9, rows=150, compress=False):
    """A seeded coordinate-sorted VCF over two contigs: missing and
    multi-allelic calls, AF-less lines."""
    rng = np.random.default_rng(seed)
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"NA{i:03d}" for i in range(n_samples))]
    for contig in ("1", "17"):
        for k in range(rows):
            info = f"AF={rng.random():.3f}" if k % 4 else "NS=3"
            gts = "\t".join(rng.choice(["0|0", "0|1", "1|1", "./.", "1/2"],
                                       p=[0.5, 0.2, 0.1, 0.1, 0.1]) for _ in range(n_samples))
            lines.append(f"{contig}\t{100 + 37 * k}\t.\tA\tG,T\t.\t.\t{info}\tGT\t{gts}")
    text = "\n".join(lines) + "\n"
    path = tmp_path / (name + (".gz" if compress else ""))
    if compress:
        import gzip

        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


def _file_argv(paths, extra):
    return ["--source", "file", "--input-files", ",".join(paths),
            "--references", "1:0:6000,17:0:6000", "--bases-per-partition", "1500"] + extra


@pytest.mark.parametrize(
    "extra, compress",
    [
        (["--ingest", "packed"], False),
        (["--ingest", "packed", "--ingest-workers", "0"], False),
        (["--ingest", "packed", "--min-allele-frequency", "0.3", "--block-size", "8"], True),
        (["--ingest", "packed", "--stream-chunk-bytes", "200"], False),
        (["--ingest", "packed", "--stream-chunk-bytes", "777", "--ingest-workers", "3"], True),
        (["--stream-chunk-bytes", "300", "--min-allele-frequency", "0.2"], True),
        (["--ingest", "wire"], False),
        ([], True),
        (["--ingest", "wire", "--min-allele-frequency", "0.3", "--num-workers", "1"], False),
    ],
)
def test_file_arms_match_jax(tmp_path, capsys, extra, compress):
    """The file source's packed arm (the native parser), its streamed pass
    (explicit, or auto past a small ``--stream-chunk-bytes``; chunks cut
    lines mid-record) and its wire arm print the reference's lines; the PC
    values agree within the tolerance."""
    path = _write_vcf(tmp_path, "cohort.vcf", seed=1, compress=compress)
    ref_lines, ref_out, lines, out = _runs(capsys, _file_argv([path], extra))
    _assert_same_output(ref_out, out, TOLERANCE)
    assert len(lines) == len(ref_lines) == 9


def test_file_two_set_join_and_host_backend_match_jax(tmp_path, capsys):
    a = _write_vcf(tmp_path, "a.vcf", seed=2)
    b = _write_vcf(tmp_path, "b.vcf", seed=3, n_samples=4)
    ref_lines, ref_out, lines, out = _runs(capsys, _file_argv([a, b], []))
    _assert_same_output(ref_out, out, TOLERANCE)
    assert len(lines) == 13
    ref_lines, ref_out, lines, out = _runs(capsys, _file_argv([a], ["--pca-backend", "host"]))
    assert out == ref_out and lines == ref_lines


def test_save_variants_then_input_path_match_jax(tmp_path, capsys):
    """``--save-variants`` (wire ingest, the records written as they stream)
    and then ``--input-path`` over the saved checkpoint: each prints the
    reference's lines on the same argv, and the resumed run prints the
    saving run's rows."""
    path = _write_vcf(tmp_path, "cohort.vcf", seed=4)
    save = lambda tag: _file_argv([path], ["--save-variants", str(tmp_path / tag)])
    ref_lines, ref_out, lines, out = _runs(capsys, save("port"), save("ref"))
    ref_out = [line.replace(str(tmp_path / "ref"), str(tmp_path / "port")) for line in ref_out]
    _assert_same_output(ref_out, out, TOLERANCE)
    assert f"Saved 300 variants to {tmp_path / 'port'}." in out
    resume = lambda tag: _file_argv([path], ["--input-path", str(tmp_path / tag)])
    ref_resumed, ref_out, resumed, out = _runs(capsys, resume("port"), resume("ref"))
    # Stats are off when resuming (``VariantsPca.scala:332-335``).
    _assert_same_output(ref_out, out, TOLERANCE, stats=False)
    assert [l.split("\t")[:2] for l in resumed] == [l.split("\t")[:2] for l in lines]
    np.testing.assert_allclose(
        np.array([l.split("\t")[2:] for l in resumed], dtype=float),
        np.array([l.split("\t")[2:] for l in lines], dtype=float), rtol=0, atol=TOLERANCE)


@pytest.mark.parametrize(
    "extra, message",
    [
        (["--ingest", "packed", "--save-variants", "{tmp}/s"], "--save-variants materializes"),
        (["--input-path", "{tmp}/s", "--save-variants", "{tmp}/t"], "--save-variants with"),
        (["--stream-chunk-bytes", "100", "--save-variants", "{tmp}/s"], "streaming-scale"),
        (["--ingest", "packed", "--pca-backend", "host"], "--ingest packed requires"),
        (["--ingest", "device"], "--ingest device requires"),
    ],
)
def test_file_ingest_resolution_errors_match_jax(tmp_path, extra, message):
    path = _write_vcf(tmp_path, "cohort.vcf", seed=5, rows=20)
    argv = _file_argv([path], [e.replace("{tmp}", str(tmp_path)) for e in extra])
    with pytest.raises(ValueError):
        ref_driver.run(argv)
    with pytest.raises(ValueError, match=message):
        run(argv, device="cpu")


def test_file_packed_needs_a_vcf_and_one_set(tmp_path):
    jsonl = tmp_path / "w.jsonl"
    jsonl.write_text("")
    for argv, message in (
        (_file_argv([str(jsonl)], ["--ingest", "packed"]), "needs a .vcf"),
        (_file_argv([_write_vcf(tmp_path, "a.vcf", 6, rows=5),
                     _write_vcf(tmp_path, "b.vcf", 7, rows=5)], ["--ingest", "packed"]),
         "single variant set"),
        (_file_argv([str(jsonl)], ["--variant-set-id", "nope"]), "not among"),
    ):
        with pytest.raises(ValueError):
            ref_driver.run(argv)
        with pytest.raises(ValueError, match=message):
            run(argv, device="cpu")
