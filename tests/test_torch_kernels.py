"""The CUDA kernels against their plain PyTorch versions, on the card.

JAX-free, so it runs on a machine with a card and no JAX. ``tests/conftest.py``
imports JAX, so there run it as::

    python -m pytest --noconftest tests/test_torch_kernels.py

Without a card the ``gpu``-marked tests skip with their reason (the kernels
have no CPU mode); ``chip_smoke.py`` holds the kernels against the plain
versions at the main path's full width. How the libraries are built and
bound is tested here on any machine.
"""

import math
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


@pytest.mark.parametrize("name", ["index-table", "early-load", "alu-adds", "imad-hi", "bulk"])
def test_probe_variants_patch_the_current_source(name):
    """Each design alternative that ``experiments/probe_variants.py`` times
    is an edit of ``csrc/probes.cu`` as it stands: the code and comments
    its patch anchors on are still there (a missing anchor raises)."""
    from spark_examples_tpu_torch.experiments import probe_variants

    kept = (_kernels.CSRC_DIR / "probes.cu").read_text()
    text = probe_variants.variants(kept)[name]
    assert text != kept and "probe_op_chain_kernel" in text


#: Two functions of a ``cuobjdump -sass`` listing: the op-chain kernel's
#: instance 1 and another kernel.
SASS_LISTING = """
\t\tFunction : _ZN41_GLOBAL__N__probes_cu21probe_op_chain_kernelILi1EEEvPKjPjllljj
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   SHF.R.U32.HI R5, RZ, 0x10, R4 ;
        /*0030*/                   LOP3.LUT R5, R5, R4, RZ, 0x3c, !PT ;
        /*0040*/                   IMAD R6, R5, R7, R8 ;
        /*0050*/              @!P0 BRA 0x70 ;
        /*0060*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0070*/                   EXIT ;
        /*0080*/                   NOP;
\t\tFunction : _ZN41_GLOBAL__N__probes_cu19scratch_copy_kernelEPKfPfi
        /*0000*/                   UBLKCP.S.G [UR4], [UR6], UR8 ;
"""


def test_sass_listing_splits_by_pipe(monkeypatch):
    """``utils/sass.py`` reads each function's opcodes with their modifiers
    (a predicate is not an opcode) and counts a template instance's
    instructions by pipe, NOP, BRA and EXIT aside."""
    from spark_examples_tpu_torch.utils import sass

    monkeypatch.setattr(sass.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=SASS_LISTING))
    functions = sass.sass_opcodes("lib.so")
    assert list(functions.values()) == [
        ["LDC", "LDG.E.128.CONSTANT", "SHF.R.U32.HI", "LOP3.LUT", "IMAD", "BRA", "STG.E.128",
         "EXIT", "NOP"],
        ["UBLKCP.S.G"],
    ]
    split = sass.pipe_split("lib.so", "probe_op_chain_kernel", ("a", "b"), steps=2)
    assert list(split) == ["b"]
    assert split["b"]["alu"] == 1.0 and split["b"]["fma"] == 0.5 and split["b"]["other"] == 1.5


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


#: (sets, samples a set, populations, grid offset, valid sites, block
#: sites, min AF, where the tables live) of the generation cases past the
#: one-set main path: 9 and 33 sets (33 needs two words of set bits a
#: site); 682 sets of 3 samples (tables of 177 KB: one block an SM, in
#: clusters of up to 16) and 800 of 2 (207 KB, near the most a block may
#: take); 1,000 sets (tables past shared memory, in a device buffer,
#: clusters walking tiles); 17 populations; and a block past 65,535 tiles
#: of 64 sites (4,194,240) on a small cohort.
WIDE_CASES = {
    "9-sets": (9, 40, 4, 400_000, 1000, 1024, None, "many-set"),
    "33-sets-min-af": (33, 20, 4, 12_345, 1100, 1100, 0.05, "many-set"),
    "682-sets": (682, 3, 4, 400_000, 1024, 1024, None, "many-set"),
    "800-sets": (800, 2, 4, 400_000, 1024, 1024, None, "many-set"),
    "1000-sets": (1000, 2, 4, 400_000, 1024, 1024, None, "global tables"),
    "17-populations": (1, 300, 17, 400_000, 1024, 1024, None, "few-set"),
    "block-of-4194432-sites": (1, 8, 4, 0, 4_194_355, 4_194_432, None, "few-set"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_gen_genotypes_takes_any_sets_populations_and_block(case):
    """gen_genotypes against its plain version, exactly, with both counters,
    at wide plans, each on the path where its tables live and in clusters
    the card can place; then the product of the generated block (but for
    the 537 MB block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sets, samples, pops, offset, n_valid, block, min_af, path = WIDE_CASES[case]
    dev = torch.device("cuda")
    source = SyntheticGenomicsSource(num_samples=samples, seed=6, n_pops=pops)
    plan = port.make_gen_plan(
        [source.genotype_stream_key(f"vs{i}") for i in range(sets)], [source.populations] * sets,
        source.site_key, source.variant_spacing, source.ref_block_fraction,
        af_filter_micro(min_af), pops, dev,
    )
    grid = port.gen_genotypes_grid(plan, block, dev)
    assert grid[4] == path and grid[1] >= grid[3] > 0, grid
    counters = [
        (torch.zeros((), dtype=torch.int64, device=dev),
         torch.zeros(sets, dtype=torch.int64, device=dev))
        for _ in range(2)
    ]
    port.reset_launch_counts()
    got = port.gen_genotypes(plan, offset, n_valid, block, *counters[0])
    want = port.gen_genotypes_plain(plan, offset, n_valid, block, *counters[1])
    assert torch.equal(got, want)
    assert torch.equal(counters[0][0], counters[1][0]) and torch.equal(counters[0][1], counters[1][1])
    assert int(counters[0][1].min()) > 0 and port.gen_genotypes.launches == 1
    if block < 1 << 20:
        G = torch.full((plan.n_cols, plan.n_cols), 7, dtype=torch.int32, device=dev)
        G_plain = G.clone()
        port.gram_accumulate(G, got)
        port.gram_accumulate_plain(G_plain, got)
        assert torch.equal(G, G_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1,), (3,), (4097,), (1024, 2560), "x[1:]", "x[3:4000]"])
def test_probe_op_chain_ragged_and_misaligned(shape):
    """Every op bit for bit, chained twice, at lengths that are not
    multiples of the kernel's 16-byte vectors and on views that do not
    start on a 16-byte boundary: the kernel runs the ragged head and tail
    itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from spark_examples_tpu_torch.experiments import probe_ops

    dev = torch.device("cuda")
    if isinstance(shape, str):
        base = torch.from_numpy(probe_ops.random_tile(5, (1, 4097))).to(dev).view(-1)
        x = base[1:] if shape == "x[1:]" else base[3:4000]
        assert x.data_ptr() % 16
    else:
        x = torch.from_numpy(probe_ops.random_tile(5, (1, math.prod(shape)))).to(dev).view(shape)
    probe_ops.probe_op_chain.launches = 0
    for op in probe_ops.OPS:
        got = probe_ops.probe_op_chain(probe_ops.probe_op_chain(x, op), op)
        want = probe_ops.probe_op_chain_plain(probe_ops.probe_op_chain_plain(x, op), op)
        assert got.shape == x.shape and torch.equal(got, want), op
    assert probe_ops.probe_op_chain.launches == 2 * len(probe_ops.OPS)


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
