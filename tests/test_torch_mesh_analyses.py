"""The analyses on the mesh: ``grm --similarity-strategy sharded`` and
``ld-prune`` over CPU positions (``--mesh-shape 1,4`` and ``2,2``) against
the JAX package's runs with the same flags, byte for byte; the LD
window's cohort split and its divisibility error; ``assoc-scan`` taking
the mesh flags and running on one device, as the reference does."""

import contextlib
import io
import os

import pytest

from spark_examples_tpu.analyses import assoc as ref_assoc
from spark_examples_tpu.analyses import grm as ref_grm
from spark_examples_tpu.analyses import ld as ref_ld
from spark_examples_tpu.config import AssocConf as RefAssocConf
from spark_examples_tpu.config import GrmConf as RefGrmConf
from spark_examples_tpu.config import LdConf as RefLdConf
from spark_examples_tpu_torch.analyses import assoc, grm, ld
from spark_examples_tpu_torch.analyses.base import AnalysisContext
from spark_examples_tpu_torch.config import AssocConf, GrmConf, LdConf
from spark_examples_tpu_torch.ops.gramian import ShardedGramianAccumulator

N_SAMPLES = 12
SYNTHETIC = ["--num-samples", str(N_SAMPLES), "--references", "1:0:200000,2:0:100000",
             "--block-size", "256"]
MESHES = ["1,4", "2,2"]


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _tsv(run, path):
    _quiet(run)
    data = path.read_bytes()
    os.remove(path)
    return data


@pytest.mark.parametrize("mesh", MESHES)
def test_grm_sharded_tsv_equals_the_reference_and_the_dense_run(tmp_path, mesh):
    out = tmp_path / "kinship.tsv"
    argv = SYNTHETIC + ["--grm-out", str(out)]
    sharded = argv + ["--mesh-shape", mesh, "--similarity-strategy", "sharded"]
    result = _quiet(lambda: grm.run_grm_pipeline(GrmConf.parse(sharded + ["--device", "cpu"])))
    assert isinstance(result.driver.accumulator, ShardedGramianAccumulator)
    got = out.read_bytes()
    os.remove(out)
    want = _tsv(lambda: ref_grm.run_grm_pipeline(RefGrmConf.parse(sharded)), out)
    dense = _tsv(lambda: grm.run_grm_pipeline(GrmConf.parse(argv + ["--device", "cpu"])), out)
    assert got == want == dense
    assert got.count(b"\n") == N_SAMPLES + 1


@pytest.mark.parametrize("mesh", MESHES)
def test_ld_prune_kept_tsv_equals_the_reference(tmp_path, mesh):
    out = tmp_path / "kept.tsv"
    argv = SYNTHETIC + ["--ld-window-sites", "32", "--ld-out", str(out), "--mesh-shape", mesh]
    got = _tsv(lambda: ld.run_ld_pipeline(LdConf.parse(argv + ["--device", "cpu"])), out)
    want = _tsv(lambda: ref_ld.run_ld_pipeline(RefLdConf.parse(argv)), out)
    one_device = _tsv(lambda: ld.run_ld_pipeline(
        LdConf.parse(argv[:-2] + ["--device", "cpu"])), out)
    assert got == want == one_device
    assert got.count(b"\t1\n") > 0 and got.count(b"\t0\n") > 0


def test_ld_window_stats_over_the_samples_axis_equal_the_oracle():
    import numpy as np

    from spark_examples_tpu_torch.ops.ld import ld_window_stats, ld_window_stats_reference
    from spark_examples_tpu_torch.parallel.mesh import resolve_run_mesh

    rows = (np.random.default_rng(3).random((37, 24)) < 0.3).astype(np.uint8)
    want_C, want_k = ld_window_stats_reference(rows)
    for shape in ("1,4", "2,3", "1,8"):
        C, k = ld_window_stats(rows, "cpu", mesh=resolve_run_mesh(shape, None, ["cpu"]))
        np.testing.assert_array_equal(C, want_C)
        np.testing.assert_array_equal(k, want_k)


def test_ld_cohort_not_divisible_raises_as_the_reference():
    argv = ["--num-samples", "13", "--references", "1:0:200000", "--mesh-shape", "1,4"]
    message = r"--num-samples 13 does not divide over the mesh samples axis \(4\)"
    with pytest.raises(ValueError, match=message):
        _quiet(lambda: ld.run_ld_pipeline(LdConf.parse(argv + ["--device", "cpu"])))
    with pytest.raises(ValueError, match=message):
        _quiet(lambda: ref_ld.run_ld_pipeline(RefLdConf.parse(argv)))


def test_ld_host_backend_runs_without_a_mesh(tmp_path):
    out = tmp_path / "kept.tsv"
    argv = SYNTHETIC + ["--ld-window-sites", "32", "--ld-out", str(out), "--mesh-shape", "1,5"]
    # 12 samples do not divide over 5, but the host oracle takes no mesh.
    got = _tsv(lambda: ld.run_ld_pipeline(
        LdConf.parse(argv + ["--pca-backend", "host", "--device", "cpu"])), out)
    want = _tsv(lambda: ref_ld.run_ld_pipeline(RefLdConf.parse(argv + ["--pca-backend", "host"])), out)
    assert got == want


def test_assoc_scan_takes_the_mesh_flags_and_equals_the_one_device_run(tmp_path):
    conf = AssocConf.parse(SYNTHETIC + ["--device", "cpu"])
    names = _quiet(lambda: AnalysisContext(conf, "assoc").sample_names())
    pheno = tmp_path / "pheno.tsv"
    pheno.write_text("".join(f"{name}\t{i % 2}\n" for i, name in enumerate(names)))
    out = tmp_path / "scan.tsv"
    argv = SYNTHETIC + ["--phenotypes", str(pheno), "--assoc-out", str(out)]
    mesh = argv + ["--mesh-shape", "1,4"]
    got = _tsv(lambda: assoc.run_assoc_pipeline(AssocConf.parse(mesh + ["--device", "cpu"])), out)
    one_device = _tsv(lambda: assoc.run_assoc_pipeline(AssocConf.parse(argv + ["--device", "cpu"])), out)
    want = _tsv(lambda: ref_assoc.run_assoc_pipeline(RefAssocConf.parse(mesh)), out)
    assert got == one_device == want
