"""Variant checkpoints (``--save-variants`` / ``--input-path``): the port's
``pipeline/checkpoint.py`` against the JAX package's.

Both packages keep one on-disk format (gzip JSON-lines parts and an
atomically published manifest), so a checkpoint written by either one
resumes in the other to identical records, and the same damage — a
truncated or extra part, a missing or unparseable manifest — raises
``CheckpointCorruptError`` in both."""

import gzip
import json
import os

import numpy as np
import pytest

from spark_examples_tpu.pipeline import checkpoint as ref_checkpoint
from spark_examples_tpu.pipeline import pca_driver as ref_driver
from spark_examples_tpu_torch import run
from spark_examples_tpu_torch.pipeline import checkpoint

TOLERANCE = 1e-4
N_SAMPLES = 6


def _vcf(tmp_path, name="cohort.vcf", seed=3, rows=60):
    rng = np.random.default_rng(seed)
    lines = ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"S{i}" for i in range(N_SAMPLES))]
    for contig in ("1", "17"):
        for k in range(rows):
            gts = "\t".join(rng.choice(["0|0", "0|1", "1|1", "./."]) for _ in range(N_SAMPLES))
            lines.append(f"{contig}\t{100 + 40 * k}\trs{k}\tA\tG\t.\t.\tAF={rng.random():.3f}"
                         f"\tGT\t{gts}")
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _args(path):
    return ["--source", "file", "--input-files", path,
            "--references", "1:0:3000,17:0:3000", "--bases-per-partition", "1000"]


def _records(dataset):
    """(key, variant json) of every record, in checkpoint order."""
    return [((k.contig, k.position), v.to_json()) for k, v in dataset]


def _save(writer, tmp_path, vcf, name):
    """Save the file source's records through ``writer``'s (``"port"`` or
    ``"reference"``) ``--save-variants``: each shard window is one part."""
    path = str(tmp_path / name)
    argv = _args(vcf) + ["--save-variants", path, "--ingest", "wire"]
    if writer == "port":
        run(argv, device="cpu")
    else:
        ref_driver.run(argv)
    return path


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_loads_identically_in_both_packages(tmp_path, capsys, writer):
    vcf = _vcf(tmp_path)
    path = _save(writer, tmp_path, vcf, "ck")
    out = capsys.readouterr().out
    assert f"Saved 120 variants to {path}." in out
    got = checkpoint.load_variants(path)
    want = ref_checkpoint.load_variants(path)
    assert got.manifest == want.manifest == {"parts": 6, "records": 120, "format": "jsonl.gz/v1"}
    assert _records(got) == _records(want)
    assert len(_records(got)) == 120


def _pcs(lines):
    return np.array([[float(v) for v in line.split("\t")[2:]] for line in lines])


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("backend", ["device", "host"])
def test_resume_in_the_other_package_gives_the_same_rows(tmp_path, capsys, writer, backend):
    """``--save-variants`` in one package, ``--input-path`` in the other:
    the resumed run prints the saving run's rows — identical on the host
    backend (both packages run the same NumPy oracle), PC values within the
    tolerance on the device backend."""
    vcf = _vcf(tmp_path)
    path = str(tmp_path / "ck")
    save_argv = _args(vcf) + ["--ingest", "wire", "--save-variants", path]
    resume_argv = _args(vcf) + ["--input-path", path]

    def port(argv):
        return run(argv + ["--pca-backend", "gpu" if backend == "device" else "host"],
                   device="cpu")

    def ref(argv):
        return ref_driver.run(argv + ["--pca-backend", "tpu" if backend == "device" else "host"])

    saver, resumer = (port, ref) if writer == "port" else (ref, port)
    saved = saver(save_argv)
    resumed = resumer(resume_argv)
    assert len(saved) == N_SAMPLES
    assert [line.split("\t")[:2] for line in resumed] == [line.split("\t")[:2] for line in saved]
    if backend == "host":
        assert resumed == saved
    else:
        np.testing.assert_allclose(_pcs(resumed), _pcs(saved), rtol=0, atol=TOLERANCE)
    out = capsys.readouterr().out
    assert f"Saved 120 variants to {path}." in out


def test_saved_rows_equal_the_unsaved_run(tmp_path, capsys):
    """Saving changes nothing of the analysis: the rows of a saving run
    equal those of the same run without the flag, and resuming with the same
    flags reproduces them."""
    vcf = _vcf(tmp_path)
    path = str(tmp_path / "ck")
    plain = run(_args(vcf) + ["--ingest", "wire", "--pca-backend", "host"], device="cpu")
    saved = run(_args(vcf) + ["--ingest", "wire", "--pca-backend", "host",
                              "--save-variants", path], device="cpu")
    assert saved == plain
    resumed = run(["--source", "file", "--input-files", vcf, "--input-path", path,
                   "--references", "1:0:3000,17:0:3000", "--pca-backend", "host"],
                  device="cpu")
    assert resumed == plain
    out = capsys.readouterr().out
    # Stats are disabled when resuming (``VariantsPca.scala:332-335``).
    assert out.count("Variants API stats:") == 2


def _damage(path, how):
    parts = sorted(n for n in os.listdir(path) if n.startswith("part-"))
    if how == "truncated part":
        part = os.path.join(path, parts[1])
        data = open(part, "rb").read()
        open(part, "wb").write(data[: len(data) // 2])
    elif how == "dropped records":
        part = os.path.join(path, parts[0])
        with gzip.open(part, "rt") as f:
            lines = f.readlines()
        with gzip.open(part, "wt") as f:
            f.writelines(lines[:-3])
    elif how == "extra part":
        with gzip.open(os.path.join(path, "part-99999.jsonl.gz"), "wt") as f:
            f.write("")
    elif how == "no manifest":
        os.remove(os.path.join(path, "_manifest.json"))
    elif how == "bad manifest":
        open(os.path.join(path, "_manifest.json"), "w").write('{"parts": 3')
    elif how == "manifest fields":
        json.dump({"parts": "3"}, open(os.path.join(path, "_manifest.json"), "w"))


@pytest.mark.parametrize("how", ["truncated part", "dropped records", "extra part",
                                 "no manifest", "bad manifest", "manifest fields"])
def test_damaged_checkpoint_raises_corrupt_in_both_packages(tmp_path, capsys, how):
    vcf = _vcf(tmp_path)
    path = _save("port", tmp_path, vcf, "ck")
    _damage(path, how)
    for module in (checkpoint, ref_checkpoint):
        with pytest.raises(module.CheckpointCorruptError):
            list(module.load_variants(path))


def test_truncated_part_fails_the_resumed_run(tmp_path, capsys):
    vcf = _vcf(tmp_path)
    path = _save("port", tmp_path, vcf, "ck")
    _damage(path, "truncated part")
    with pytest.raises(checkpoint.CheckpointCorruptError, match="truncated"):
        run(["--input-path", path, "--variant-set-id", "cohort"], device="cpu")


def test_rewrite_replaces_a_larger_checkpoint(tmp_path):
    """Saving into a directory that held a larger checkpoint drops its stale
    parts, and the reference loads the smaller checkpoint."""
    from spark_examples_tpu_torch.models.variant import VariantsBuilder

    record = {"referenceName": "1", "start": 5, "end": 6, "referenceBases": "A",
              "alternateBases": ["G"], "calls": []}
    key, variant = VariantsBuilder.build(record)
    path = str(tmp_path / "ck")
    assert checkpoint.save_variants(path, [[(key, variant)]] * 4) == 4
    assert checkpoint.save_variants(path, [[(key, variant)]]) == 1
    assert sorted(os.listdir(path)) == ["_manifest.json", "part-00000.jsonl.gz"]
    assert len(list(ref_checkpoint.load_variants(path))) == 1
