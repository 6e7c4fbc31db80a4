"""The CUDA kernels against their plain PyTorch versions, on the card.

JAX-free, so it runs on a machine with a card and no JAX. ``tests/conftest.py``
imports JAX, so there run it as::

    python -m pytest --noconftest tests/test_torch_kernels.py

Without a card the test skips with its reason (the kernels have no CPU
mode); ``chip_smoke.py`` holds the kernels against the plain versions at the
main path's full width.
"""

import pytest
import torch

from spark_examples_tpu_torch.ops import devicegen as port
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.utils.af import af_filter_micro


@pytest.mark.gpu
def test_kernels_equal_plain_versions_on_the_card():
    """Both kernels against their plain versions, exactly: two variant sets
    of different sizes, the min-AF filter on, a ragged block, and a G that
    is not zero before the product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    source = SyntheticGenomicsSource(num_samples=300, seed=4, cohort_sizes={"b": 45})
    plan = port.make_gen_plan(
        [source.genotype_stream_key("a"), source.genotype_stream_key("b")],
        [source.populations_for("a"), source.populations_for("b")], source.site_key,
        source.variant_spacing, source.ref_block_fraction, af_filter_micro(0.05),
        source.n_pops, dev,
    )
    counters = [
        (torch.zeros((), dtype=torch.int64, device=dev), torch.zeros(2, dtype=torch.int64, device=dev))
        for _ in range(2)
    ]
    port.reset_launch_counts()
    got = port.gen_genotypes(plan, 12_345, 1000, 1100, *counters[0])
    want = port.gen_genotypes_plain(plan, 12_345, 1000, 1100, *counters[1])
    assert torch.equal(got, want)
    assert torch.equal(counters[0][0], counters[1][0]) and torch.equal(counters[0][1], counters[1][1])
    G = torch.full((plan.n_cols, plan.n_cols), 7, dtype=torch.int32, device=dev)
    G_plain = G.clone()
    port.gram_accumulate(G, got)
    port.gram_accumulate_plain(G_plain, got)
    assert torch.equal(G, G_plain)
    assert [k.launches for k in port.KERNELS] == [1, 1]
