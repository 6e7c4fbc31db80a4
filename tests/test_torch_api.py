"""The port's public API (``spark_examples_tpu_torch/api.py``) stage by
stage against the JAX package's ``api`` on the cohorts of
``tests/test_api.py``: the Gramian exactly (the port's is int32, the
reference's float32 on the CPU: the same integers), the centered matrix
equal after rounding to float32 (both center in float64), and the PCs
within 1e-4 per entry (the two subspace iterations start from different
random iterates; see test_torch_pca.py)."""

import doctest

import numpy as np
import pytest
import torch

from spark_examples_tpu import api as ref_api
from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource as RefSource
from spark_examples_tpu_torch import api
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

PC_TOLERANCE = 1e-4


def _request(start, end, contig="17"):
    return {"variantSetIds": ["vs"], "referenceName": contig, "start": start, "end": end}


def test_api_doctest_example():
    assert doctest.testmod(api).failed == 0


@pytest.mark.parametrize(
    "num_samples, seed, start, end, block, use_names",
    [
        (15, 9, 0, 30000, 32, False),  # test_api_stages_match_driver
        (12, 5, 41196311, 41216311, 1024, True),  # the doctest cohort
        (10, 3, 0, 20000, 32, True),  # test_api_pca_entrypoint
    ],
)
def test_api_stages_match_reference(num_samples, seed, start, end, block, use_names):
    source = SyntheticGenomicsSource(num_samples=num_samples, seed=seed)
    ref_source = RefSource(num_samples=num_samples, seed=seed)
    callsets = source.search_callsets(["vs"])
    key = "name" if use_names else "id"
    id_to_index = {c[key]: i for i, c in enumerate(callsets)}
    variants = list(source.client().search_variants(_request(start, end)))
    assert variants == list(ref_source.client().search_variants(_request(start, end)))

    calls = list(api.prepare_call_data(iter(variants), id_to_index, use_names=use_names))
    ref_calls = list(ref_api.prepare_call_data(iter(variants), id_to_index, use_names=use_names))
    assert calls == ref_calls and calls

    S = api.calculate_similarity_matrix(iter(calls), num_samples, block_size=block, device="cpu")
    S_ref = ref_api.calculate_similarity_matrix(iter(ref_calls), num_samples, block_size=block)
    assert S.dtype == torch.int32
    np.testing.assert_array_equal(S.numpy(), np.asarray(S_ref))

    B = api.center_matrix(S)
    B_ref = np.asarray(ref_api.center_matrix(S_ref))
    assert B.dtype == torch.float32 and B_ref.dtype == np.float32
    np.testing.assert_array_equal(B.numpy(), B_ref)

    pcs = api.perform_pca(B, num_pc=2)
    ref_pcs = ref_api.perform_pca(B_ref, num_pc=2)
    assert pcs.shape == (num_samples, 2) and pcs.dtype == np.float64
    np.testing.assert_allclose(pcs, ref_pcs, rtol=0, atol=PC_TOLERANCE)


def test_center_matrix_exact_past_f32_range():
    """Counts past 2^24 center in float64, as the reference's do."""
    rng = np.random.default_rng(17)
    base = rng.integers(0, 50, size=(6, 6))
    S = ((base + base.T) * 2 + (1 << 25) + 1).astype(np.int64)
    np.testing.assert_array_equal(
        api.center_matrix(S).numpy(), np.asarray(ref_api.center_matrix(S))
    )


def test_api_pca_entrypoint_matches_reference():
    argv = [
        "--references", "17:0:20000",
        "--variant-set-id", "vs",
        "--num-samples", "10",
        "--seed", "3",
        "--block-size", "32",
    ]
    lines = api.pca(argv, device="cpu")
    ref_lines = ref_api.pca(argv)
    assert len(lines) == len(ref_lines) == 10
    for got, want in zip(lines, ref_lines):
        g, w = got.split("\t"), want.split("\t")
        assert g[:2] == w[:2]
        np.testing.assert_allclose(
            np.array(g[2:], dtype=float), np.array(w[2:], dtype=float), rtol=0, atol=PC_TOLERANCE
        )


def test_api_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.calculate_similarity_matrix(iter([[0, 1]]), 2)
