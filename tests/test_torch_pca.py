"""The port's centering and eigensolve against the JAX package's, on the
centered Gramians of structured synthetic cohorts.

Centering runs in float64 with float32 out in both packages and agrees to
the last bit (asserted within 1 ulp). The eigensolves start from different
random iterates (``torch.Generator`` vs ``jax.random``), so components agree
within a tolerance, after the shared sign convention: 1e-4 per entry of the
unit-norm components. The measured gap on these cohorts is below 2e-6 for
port subspace vs JAX subspace, port subspace vs full eigh, and port eigh vs
JAX eigh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.ops import centering as ref_centering
from spark_examples_tpu.ops import pca as ref_pca
from spark_examples_tpu.sharding.contig import Contig
from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.ops import centering, pca

TOLERANCE = 1e-4
COHORTS = [(3, 64, 400_000), (8, 48, 300_000), (1, 32, 200_000)]


def _gramian(seed, n, end):
    source = SyntheticGenomicsSource(num_samples=n, seed=seed)
    blocks = source.genotype_blocks("vs", Contig("1", 0, end), 4096)
    rows = np.concatenate([b["has_variation"] for b in blocks]).astype(np.int64)
    return rows.T @ rows


def _jax_center(S):
    with jax.enable_x64(True):
        return np.array(ref_centering.gower_center(jnp.asarray(S)))


@pytest.mark.parametrize("seed, n, end", COHORTS)
def test_gower_center_matches_jax(seed, n, end):
    G = _gramian(seed, n, end)
    want = _jax_center(G)
    for S in (G, G.astype(np.int32)):
        got = centering.gower_center(torch.from_numpy(S)).numpy()
        assert got.dtype == np.float32 == want.dtype
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_gower_center_float64_counts_past_2_24():
    """Whole-genome counts pass 2^24, where float32 centering would round
    the counts themselves: the port centers in float64 like the reference."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 1000, (24, 24))
    S = (base + base.T + (1 << 25)).astype(np.int64)
    got = centering.gower_center(torch.from_numpy(S)).numpy()
    np.testing.assert_array_max_ulp(got, _jax_center(S), maxulp=1)
    exact = S - S.mean(1, keepdims=True) - S.mean(0, keepdims=True) + S.mean()
    np.testing.assert_allclose(got, exact, atol=1e-3)
    S64 = torch.from_numpy(S.astype(np.float64))
    assert centering.gower_center(S64).dtype == torch.float64


@pytest.mark.parametrize("seed, n, end", COHORTS)
def test_subspace_pca_matches_jax_and_full_eigh(seed, n, end):
    B = _jax_center(_gramian(seed, n, end))
    got, got_vals = pca.principal_components_subspace(torch.from_numpy(B), 2)
    want, want_vals = ref_pca.principal_components_subspace(jnp.asarray(B), 2)
    full, full_vals = pca.principal_components(torch.from_numpy(B), 2)
    assert got.shape == (n, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOLERANCE)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=TOLERANCE)
    np.testing.assert_allclose(got_vals.numpy(), np.asarray(want_vals), rtol=1e-4)
    np.testing.assert_allclose(full_vals.numpy(), np.asarray(want_vals), rtol=1e-4)


@pytest.mark.parametrize("seed, n, end", COHORTS[:2])
def test_full_eigh_matches_jax(seed, n, end):
    B = _jax_center(_gramian(seed, n, end))
    got, _ = pca.principal_components(torch.from_numpy(B), 3)
    want, _ = ref_pca.principal_components(jnp.asarray(B), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOLERANCE)


def test_sign_convention_largest_entry_positive():
    B = _jax_center(_gramian(*COHORTS[2]))
    comps, _ = pca.principal_components_subspace(torch.from_numpy(B), 2)
    idx = comps.abs().argmax(dim=0)
    assert (comps[idx, torch.arange(2)] > 0).all()


def test_mllib_oracle_matches_jax():
    B = _jax_center(_gramian(*COHORTS[1]))
    got_vec, got_val = pca.mllib_reference_pca(B, 2)
    want_vec, want_val = ref_pca.mllib_reference_pca(B, 2)
    np.testing.assert_array_equal(got_vec, want_vec)
    np.testing.assert_array_equal(got_val, want_val)


def test_tf32_is_switched_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    B = _jax_center(_gramian(*COHORTS[2]))
    pca.principal_components_subspace(torch.from_numpy(B), 2)
    assert torch.backends.cuda.matmul.allow_tf32 is False
