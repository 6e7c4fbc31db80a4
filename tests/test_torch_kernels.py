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


def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """A library is named by its source, the ``csrc/*.cuh`` it may include
    and the flags: editing a shared header rebuilds every library."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
    first = _kernels.library_path("k.cu")
    assert _kernels.library_path("k.cu") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _kernels.library_path("k.cu") != first


def test_scratch_copy_smallest_scratch():
    """On every device the scratch holds the kernel's mbarrier and the
    tile: MIN_BYTES is taken, a byte less raises."""
    from spark_examples_tpu_torch.experiments import vmem_capacity

    tile = torch.randn(vmem_capacity.TILE)
    assert torch.equal(vmem_capacity.scratch_copy(tile, vmem_capacity.MIN_BYTES), tile)
    with pytest.raises(ValueError, match="tile"):
        vmem_capacity.scratch_copy(tile, vmem_capacity.MIN_BYTES - 1)


#: (cohort sizes, grid offset, valid sites, block sites, min AF) of the
#: generation cases: the CLI's 1,024-site block and chr17's 16,384 at the
#: 1000 Genomes width, the ragged tail of chr17's grid, the min-AF filter,
#: and two-set cohorts whose second set straddles a 64-column chunk (300 +
#: 45: columns 300..344 cross 320, drawn by two blocks of the cluster) or
#: follows a set that spans every chunk (2,504 + 45).
GEN_CASES = {
    "two-sets-300+45-min-af-ragged": ((300, 45), 12_345, 1000, 1100, 0.05),
    "2504x1024": ((2504,), 400_000, 1024, 1024, None),
    "2504x16384": ((2504,), 400_000, 16384, 16384, None),
    "ragged-tail-5000-of-16384": ((2504,), 811_000, 5000, 16384, None),
    "min-af-2504x1024": ((2504,), 400_000, 1024, 1024, 0.05),
    "two-sets-2504+45": ((2504, 45), 400_000, 1024, 1024, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_kernels_equal_plain_versions_on_the_card(case):
    """Both kernels against their plain versions, exactly, with both
    counters; then the product of the generated block onto a G that is not
    zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sizes, offset, n_valid, block, min_af = GEN_CASES[case]
    dev = torch.device("cuda")
    names = ["a", "b"][: len(sizes)]
    source = SyntheticGenomicsSource(
        num_samples=sizes[0], seed=4, cohort_sizes=dict(zip(names[1:], sizes[1:]))
    )
    plan = port.make_gen_plan(
        [source.genotype_stream_key(v) for v in names],
        [source.populations_for(v) for v in names], source.site_key,
        source.variant_spacing, source.ref_block_fraction, af_filter_micro(min_af),
        source.n_pops, dev,
    )
    counters = [
        (torch.zeros((), dtype=torch.int64, device=dev),
         torch.zeros(len(names), dtype=torch.int64, device=dev))
        for _ in range(2)
    ]
    port.reset_launch_counts()
    got = port.gen_genotypes(plan, offset, n_valid, block, *counters[0])
    want = port.gen_genotypes_plain(plan, offset, n_valid, block, *counters[1])
    assert torch.equal(got, want)
    assert torch.equal(counters[0][0], counters[1][0]) and torch.equal(counters[0][1], counters[1][1])
    assert int(counters[0][1].min()) > 0
    G = torch.full((plan.n_cols, plan.n_cols), 7, dtype=torch.int32, device=dev)
    G_plain = G.clone()
    port.gram_accumulate(G, got)
    port.gram_accumulate_plain(G_plain, got)
    assert torch.equal(G, G_plain)
    assert [k.launches for k in port.KERNELS] == [1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("counts", [False, True], ids=["bits", "counts"])
@pytest.mark.parametrize("n,sites", [(13, 128), (130, 128), (300, 1152), (2504, 1024), (2504, 16384)])
def test_gram_accumulate_equals_plain_and_numpy_on_the_card(n, sites, counts):
    """The product onto a nonzero G, exactly equal to its plain version and
    to numpy's XᵀX: ragged n (masked edges), one tile, three tile rows
    (300 samples: the last 256-column unit holds one tile) over nine
    stages, the depths the main path uses (the CLI's 1,024 sites and
    chr17's 16,384), and count-valued rows up to the same-set join's
    maximum. Xᵀ's padding rows hold junk, which must not
    reach G."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops.contracts import COUNT_ROW

    dev = torch.device("cuda")
    rng = np.random.default_rng(n + sites)
    rows = -(-n // port.COL_TILE) * port.COL_TILE
    hi = COUNT_ROW.hi if counts else 1
    xt = rng.integers(0, hi + 1, (rows, sites), dtype=np.int8)
    xt[n:] = -7  # padding rows: never part of G
    g0 = rng.integers(-1000, 1000, (n, n), dtype=np.int32)
    G = torch.from_numpy(g0).to(dev)
    G_plain = G.clone()
    xt_dev = torch.from_numpy(xt).to(dev)
    port.reset_launch_counts()
    port.gram_accumulate(G, xt_dev)
    port.gram_accumulate_plain(G_plain, xt_dev)
    X = xt[:n].astype(np.float64)  # exact: every sum is below 2^53
    want = (X @ X.T).astype(np.int64) + g0
    assert port.gram_accumulate.launches == 1
    assert torch.equal(G, G_plain)
    assert np.array_equal(G.cpu().numpy().astype(np.int64), want)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 100, 127, 1024, 16384])
@pytest.mark.parametrize("n", [13, 130, 300, 2504])
@pytest.mark.parametrize("counts", [False, True])
def test_unpack_kernel_equals_plain_version_on_the_card(counts, n, rows):
    """Ragged widths and block sizes that are not multiples of the tiling,
    junk in the unused packed bits, then the product on the unpacked block,
    exactly (against numpy where the product is small enough for it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import gramian

    dev = torch.device("cuda")
    rng = np.random.default_rng(3 + n + rows)
    values = rng.integers(0, 5 if counts else 2, (rows, n), dtype=np.uint8)
    host = values if counts else np.packbits(values, axis=-1)
    if not counts and n % 8:
        host[:, -1] |= 0xFF >> (8 - (-n % 8))  # junk in unused bits
    block = torch.from_numpy(host).to(dev)
    gramian.reset_launch_counts()
    got = gramian.unpack_rows_t(block, n, counts=counts)
    want = gramian.unpack_rows_t_plain(block, n, counts=counts)
    assert torch.equal(got, want) and gramian.unpack_rows_t.launches == 1
    G = torch.full((n, n), 3, dtype=torch.int32, device=dev)
    G_plain = G.clone()
    port.gram_accumulate(G, got)
    port.gram_accumulate_plain(G_plain, want)
    assert torch.equal(G, G_plain)
    if rows * n <= 1024 * 2504:
        X = values.astype(np.int64)
        assert np.array_equal(G.cpu().numpy(), X.T @ X + 3)


@pytest.mark.gpu
def test_probe_kernels_equal_plain_versions_on_the_card():
    """Every op of the u32 chain bit for bit, chained twice; the scratch
    copy at its smallest size (the mbarrier and the tile), at an unaligned
    size and at the card's limit; a size below the smallest raises, and
    one past the limit is refused."""
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
    assert vmem_capacity.MIN_BYTES == vmem_capacity.TILE_BYTES + 16
    for nbytes in (vmem_capacity.MIN_BYTES, limit - 3, limit):
        assert torch.equal(vmem_capacity.scratch_copy(tile, nbytes), tile)
        assert torch.equal(vmem_capacity.scratch_copy_plain(tile, nbytes), tile)
    with pytest.raises(ValueError, match="tile"):
        vmem_capacity.scratch_copy(tile, vmem_capacity.MIN_BYTES - 1)
    assert vmem_capacity.scratch_copy(tile, limit + 1) is None
    assert torch.equal(vmem_capacity.scratch_copy(tile, limit), tile)  # still usable
