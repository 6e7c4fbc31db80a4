"""The CUDA kernels against their plain PyTorch versions, on the card.

JAX-free, so it runs on a machine with a card and no JAX. ``tests/conftest.py``
imports JAX, so there run it as::

    python -m pytest --noconftest tests/test_torch_kernels.py

Without a card the ``gpu``-marked tests skip with their reason (the kernels
have no CPU mode); ``chip_smoke.py`` holds the kernels against the plain
versions at the main path's full width. How the libraries are built and
bound is tested here on any machine.
"""

import types

import pytest
import torch

from spark_examples_tpu_torch.ops import _kernels
from spark_examples_tpu_torch.ops import devicegen as port
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.utils.af import af_filter_micro


@pytest.mark.parametrize("source", _kernels.SOURCES)
def test_library_builds_only_its_own_source(monkeypatch, source):
    """Loading one library compiles that source alone, and declares the C
    signatures of that source's functions alone."""
    built = []

    def fake_build(sources):
        sources = tuple(sources)
        built.extend(sources)
        return {s: _kernels.BUILD_DIR / f"{s}.so" for s in sources}

    class FakeLibrary:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_kernels, "build", fake_build)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", FakeLibrary)
    lib = _kernels.library(source)
    assert built == [source]
    declared = {name for name in vars(lib) if name != "path"}
    assert declared == set(_kernels._SIGNATURES[source])


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


@pytest.mark.gpu
@pytest.mark.parametrize("counts", [False, True])
def test_unpack_kernel_equals_plain_version_on_the_card(counts):
    """Ragged widths and a block size that is not a multiple of the tiling,
    then the product of PR 1 on the unpacked block, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import gramian

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for n, rows in ((13, 1), (300, 100), (2504, 1024)):
        values = rng.integers(0, 5 if counts else 2, (rows, n), dtype=np.uint8)
        host = values if counts else np.packbits(values, axis=-1)
        if not counts:
            host[:, -1] |= 0xFF >> (8 - (-n % 8)) if n % 8 else 0  # junk in unused bits
        block = torch.from_numpy(host).to(dev)
        gramian.reset_launch_counts()
        got = gramian.unpack_rows_t(block, n, counts=counts)
        want = gramian.unpack_rows_t_plain(block, n, counts=counts)
        assert torch.equal(got, want) and gramian.unpack_rows_t.launches == 1
        G = torch.full((n, n), 3, dtype=torch.int32, device=dev)
        G_plain = G.clone()
        port.gram_accumulate(G, got)
        port.gram_accumulate_plain(G_plain, want)
        X = values.astype(np.int64)
        assert torch.equal(G, G_plain)
        assert np.array_equal(G.cpu().numpy(), X.T @ X + 3)


@pytest.mark.gpu
def test_probe_kernels_equal_plain_versions_on_the_card():
    """Every op of the u32 chain bit for bit, chained twice; the scratch
    copy at the tile's size and at the card's limit, and a refused size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from spark_examples_tpu_torch.experiments import probe_ops, vmem_capacity

    dev = torch.device("cuda")
    x = torch.from_numpy(probe_ops.random_tile(1, (64, 96))).to(dev)
    for op in probe_ops.OPS:
        got = probe_ops.probe_op_chain(probe_ops.probe_op_chain(x, op), op)
        want = probe_ops.probe_op_chain_plain(probe_ops.probe_op_chain_plain(x, op), op)
        assert torch.equal(got, want), op
    tile = torch.randn(vmem_capacity.TILE, device=dev)
    limit = vmem_capacity.max_shared_memory_optin()
    for nbytes in (vmem_capacity.TILE_BYTES, limit - 3, limit):
        assert torch.equal(vmem_capacity.scratch_copy(tile, nbytes), tile)
        assert torch.equal(vmem_capacity.scratch_copy_plain(tile, nbytes), tile)
    assert vmem_capacity.scratch_copy(tile, limit + 1) is None
    assert torch.equal(vmem_capacity.scratch_copy(tile, limit), tile)  # still usable
