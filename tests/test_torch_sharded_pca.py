"""The sharded strategy after the ring, and the slice as a whole: the
port's ``gower_center_sharded`` and sharded subspace eigensolve against the
JAX package's, the CLI on a mesh of CPU positions against the JAX CLI on
the same argv, and each package resuming the other's sharded checkpoint.

Tolerances, each with its reason:

- centring: none. Both centre in float64 in the same order of operations,
  and every sum is of integers below 2^53, exact in any order; the float32
  tiles are bit-equal.
- components: 1e-4 per entry, the dense pipeline's tolerance
  (``tests/test_torch_pipeline.py``): the two packages start the subspace
  iteration from different random iterates, so their components agree to
  the iteration's convergence, not bit for bit. The port's sharded solve
  starts from its dense solve's iterate and agrees with it to float32
  rounding (1e-5)."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_examples_tpu.config import PcaConf as RefConf
from spark_examples_tpu.ops import centering as ref_centering
from spark_examples_tpu.ops import pca as ref_pca
from spark_examples_tpu.parallel import mesh as ref_mesh
from spark_examples_tpu.pipeline import pca_driver as ref_driver
from spark_examples_tpu.utils import faults as ref_faults
from spark_examples_tpu_torch.config import PcaConf
from spark_examples_tpu_torch.obs.manifest import validate_manifest
from spark_examples_tpu_torch.ops import centering, pca
from spark_examples_tpu_torch.parallel import mesh as port_mesh
from spark_examples_tpu_torch.pipeline import checkpoint as cp
from spark_examples_tpu_torch.pipeline.pca_driver import run_pipeline
from spark_examples_tpu_torch.utils import faults

CPU = torch.device("cpu")
TOLERANCE = 1e-4
BASE = ["--references", "17:0:20000", "--variant-set-id", "vs-a", "--num-samples", "21",
        "--seed", "5", "--bases-per-partition", "5000"]


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.configure(None)
    ref_faults.configure(None)
    yield
    faults.configure(None)
    ref_faults.configure(None)


def _gramian(n, padded, seed):
    rng = np.random.default_rng(seed)
    X = (rng.random((400, n)) < 0.3).astype(np.int64)
    G = np.zeros((padded, padded), dtype=np.int32)
    G[:n, :n] = X.T @ X
    return G


def _row_sharded(G, samples):
    positions = port_mesh.make_mesh({"samples": samples}, [CPU] * samples).flat()
    n_local = G.shape[0] // samples
    tiles = [torch.from_numpy(G[s * n_local : (s + 1) * n_local].copy()) for s in range(samples)]
    return positions, tiles


@pytest.mark.parametrize("n,samples", [(21, 2), (21, 4), (37, 8), (40, 4)])
def test_sharded_centering_equals_the_reference(n, samples):
    padded = port_mesh.padded_cohort(n, samples)
    G = _gramian(n, padded, n + samples)
    rmesh = ref_mesh.make_mesh({"samples": samples}, jax.devices())
    with jax.enable_x64(True):
        S = jax.device_put(jnp.asarray(G), NamedSharding(rmesh, P("samples", None)))
        want = np.asarray(ref_centering.gower_center_sharded(S, rmesh, n_true=n))
    positions, tiles = _row_sharded(G, samples)
    got = centering.gower_center_sharded(port_mesh.RowSharded(tiles, positions, n))
    assert all(t.dtype == torch.float32 for t in got.tiles)
    assert np.array_equal(got.to_host(), want)
    # The dense centring embedded in a zero block.
    dense = centering.gower_center(torch.from_numpy(G[:n, :n]))
    assert np.array_equal(got.to_host()[:n, :n], dense.numpy())


@pytest.mark.parametrize("n,samples", [(21, 4), (37, 8)])
def test_sharded_eigensolve_agrees_with_the_dense_solve_and_the_reference(n, samples):
    padded = port_mesh.padded_cohort(n, samples)
    G = _gramian(n, padded, 3 * n)
    positions, tiles = _row_sharded(G, samples)
    centred = centering.gower_center_sharded(port_mesh.RowSharded(tiles, positions, n))
    comps, evals = pca.principal_components_subspace_sharded(centred, num_pc=2)
    assert comps.shape == (padded, 2) and not comps[n:].any()
    dense, dense_evals = pca.principal_components_subspace(
        centering.gower_center(torch.from_numpy(G[:n, :n])), num_pc=2)
    np.testing.assert_allclose(comps[:n].numpy(), dense.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(evals.numpy(), dense_evals.numpy(), rtol=1e-5)
    rmesh = ref_mesh.make_mesh({"samples": samples}, jax.devices())
    B = jax.device_put(jnp.asarray(centred.to_host()), NamedSharding(rmesh, P("samples", None)))
    want, _ = ref_pca.principal_components_subspace_sharded(B, rmesh, 2, n_true=n)
    np.testing.assert_allclose(comps.numpy(), np.asarray(want), rtol=0, atol=TOLERANCE)


def _both(argv):
    """The reference's and the port's runs of ``argv`` (the port on CPU
    positions), each with its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref = ref_driver.run_pipeline(RefConf.parse(argv))
    ref_out = out.getvalue().splitlines()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = run_pipeline(PcaConf.parse(argv + ["--device", "cpu"]))
    return ref, ref_out, got, out.getvalue().splitlines()


@pytest.mark.parametrize(
    "extra",
    [
        ["--mesh-shape", "1,4", "--similarity-strategy", "sharded"],
        ["--mesh-shape", "2,2", "--similarity-strategy", "sharded"],
        ["--mesh-shape", "4,1"],
        ["--mesh-shape", "1,4", "--similarity-strategy", "sharded", "--reduce-schedule", "hier"],
        ["--mesh-shape", "1,4", "--similarity-strategy", "sharded", "--ingest", "packed",
         "--block-size", "64"],
        ["--mesh-shape", "1,2", "--similarity-strategy", "sharded", "--ingest", "packed",
         "--ring-pack-bits", "off", "--block-size", "64"],
        ["--mesh-shape", "2,1", "--ingest", "packed", "--block-size", "64"],
    ],
    ids=["ring-1x4", "ring-2x2", "data-4x1", "ring-hier", "packed-ring", "unpacked-ring", "packed-data"],
)
def test_cli_on_a_mesh_equals_the_jax_cli(extra, tmp_path, monkeypatch):
    """Every printed line but the PC values identical (sample keys and
    datasets, the "Non zero rows" count, the stats), the PCs within 1e-4,
    and equal ``schedule`` blocks, whose measured ring bytes the port's
    ``sched`` conformance pair carries."""
    if "hier" in extra:
        monkeypatch.setenv(ref_mesh.HIER_HOSTS_ENV, "2")
    argv = BASE + extra + ["--metrics-json", str(tmp_path / "m.json")]
    ref, ref_out, got, out = _both(argv)
    assert len(out) == len(ref_out)
    for g, w in zip(out, ref_out):
        gs, ws = g.split("\t"), w.split("\t")
        if len(ws) < 3:
            if not w.startswith("Run manifest"):
                assert g == w
            continue
        assert gs[:2] == ws[:2]
        np.testing.assert_allclose(np.array(gs[2:], float), np.array(ws[2:], float),
                                   rtol=0, atol=TOLERANCE)
    assert got.manifest["schedule"] == ref.manifest["schedule"]
    assert validate_manifest(got.manifest) == []
    sharded = "sharded" in extra
    assert (got.manifest["schedule"] is not None) == sharded
    if sharded:
        assert got.manifest["schedule"]["kind"] == ("hier" if "hier" in extra else "flat")
        pairs = got.manifest["conformance"]
        assert pairs["sched"]["measured"] == got.manifest["schedule"]["measured_ring_bytes"]


def test_sharded_strategy_needs_a_samples_axis():
    with pytest.raises(ValueError, match=r"--similarity-strategy sharded needs a mesh with a samples axis of at least 2 \(use --mesh-shape data,samples\)"):
        with contextlib.redirect_stdout(io.StringIO()):
            run_pipeline(PcaConf.parse(BASE + ["--similarity-strategy", "sharded", "--device", "cpu"]))


#: A sharded packed run with a snapshot every 40 sites.
CKPT_FLAGS = ["--num-samples", "8", "--references", "1:0:150000", "--ingest", "packed",
              "--checkpoint-every-sites", "40", "--mesh-shape", "1,4",
              "--similarity-strategy", "sharded", "--block-size", "16"]


def _run_quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def test_each_package_resumes_the_others_sharded_checkpoint(tmp_path):
    """A reference run that fails at ``driver.post-flush#2`` leaves a
    partial sharded artifact the port resumes, and a port run failing there
    leaves one the reference resumes; each finishes with the uninterrupted
    run's Gramian exactly."""
    def artifact(directory):
        return cp.load_gramian_checkpoint(str(directory))

    oracle = tmp_path / "oracle"
    _run_quiet(lambda: ref_driver.run_pipeline(RefConf.parse(CKPT_FLAGS + ["--gramian-checkpoint-dir", str(oracle)])))
    want = artifact(oracle)["G"].astype(np.int64).sum(axis=0)

    from_ref, from_port = tmp_path / "from-ref", tmp_path / "from-port"
    ref_faults.configure("raise@driver.post-flush#2")
    with pytest.raises(ref_faults.InjectedFault):
        _run_quiet(lambda: ref_driver.run_pipeline(RefConf.parse(CKPT_FLAGS + ["--gramian-checkpoint-dir", str(from_ref)])))
    ref_faults.configure(None)
    with pytest.raises(faults.InjectedFault):
        _run_quiet(lambda: run_pipeline(PcaConf.parse(
            CKPT_FLAGS + ["--gramian-checkpoint-dir", str(from_port), "--device", "cpu",
                          "--fault-plan", "raise@driver.post-flush#2"])))
    faults.configure(None)
    for directory in (from_ref, from_port):
        meta = artifact(directory)["meta"]
        assert meta["strategy"] == "sharded" and 0 < meta["sites"]
        assert meta["padded"] == port_mesh.padded_cohort(8, 4)

    resumed = _run_quiet(lambda: run_pipeline(PcaConf.parse(
        CKPT_FLAGS + ["--resume-from", str(from_ref), "--gramian-checkpoint-dir", str(tmp_path / "p"),
                      "--device", "cpu"])))
    assert resumed.driver.feeder.sites_skipped > 0
    assert np.array_equal(artifact(tmp_path / "p")["G"].astype(np.int64).sum(axis=0), want)
    _run_quiet(lambda: ref_driver.run_pipeline(RefConf.parse(
        CKPT_FLAGS + ["--resume-from", str(from_port), "--gramian-checkpoint-dir", str(tmp_path / "r")])))
    assert np.array_equal(artifact(tmp_path / "r")["G"].astype(np.int64).sum(axis=0), want)


def test_api_pca_takes_the_mesh_positions():
    """``api.pca`` passes ``devices`` through to the driver: explicit CPU
    positions give the CLI's lines, and four positions cannot hold a 1,8
    mesh (nothing falls back)."""
    from spark_examples_tpu_torch import api

    argv = BASE + ["--mesh-shape", "1,4", "--similarity-strategy", "sharded", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        want = run_pipeline(PcaConf.parse(argv)).lines
        got = api.pca(argv, devices=[CPU] * 4)
    assert got == want
    with pytest.raises(ValueError, match=r"mesh shape \{'data': 1, 'samples': 8\} needs 8 devices, have 4"):
        with contextlib.redirect_stdout(io.StringIO()):
            api.pca(BASE + ["--mesh-shape", "1,8", "--device", "cpu"], devices=[CPU] * 4)
