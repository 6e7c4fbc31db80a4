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
    assert [k.launches for k in port.KERNELS] == [1, 1, 0]


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


@pytest.mark.gpu
@pytest.mark.parametrize("pitch", ["16-byte", "odd", "contiguous", "unaligned view"])
@pytest.mark.parametrize("rows", [1, 37, 1024, 16384])
@pytest.mark.parametrize("n", [13, 130, 2504])
def test_case_counts_kernel_equals_plain_version_on_the_card(n, rows, pitch):
    """The association counts against the plain version and numpy, exactly,
    with junk in the unused bits of the last byte, in the pitch's padding
    and past the case mask: the shipped 16-byte pitch (16-byte loads), a
    pitch that is not a multiple of 4, contiguous rows and the 16-byte
    pitch one byte past a 16-byte boundary (byte loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import ld

    dev = torch.device("cuda")
    rng = np.random.default_rng(n + rows)
    values = (rng.random((rows, n)) < 0.3).astype(np.uint8)
    case = (rng.random(n) < 0.5).astype(np.uint8)
    packed = np.packbits(values, axis=1)
    width = packed.shape[1]
    # The odd pitch: the first length past the width that is not a multiple of 4.
    odd = width + 1 if (width + 1) % 4 else width + 2
    vector_pitch = -(-width // 16) * 16
    stride = {"16-byte": vector_pitch, "odd": odd, "contiguous": width,
              "unaligned view": vector_pitch}[pitch]
    shift = int(pitch == "unaligned view")
    host = np.full(rows * stride + shift, 0xA5, dtype=np.uint8)
    rows_host = host[shift:].reshape(rows, stride)
    rows_host[:, :width] = packed
    case_host = np.full(vector_pitch, 0xA5, dtype=np.uint8)
    case_host[:width] = np.packbits(case)
    if n % 8:
        rows_host[:, width - 1] |= 0xFF >> (8 - (-n % 8))
        case_host[width - 1] |= 0xFF >> (8 - (-n % 8))
    block = torch.from_numpy(host).to(dev)[shift:].view(rows, stride)[:, :width]
    case_t = torch.from_numpy(case_host).to(dev)[:width]
    assert ld.case_counts_vectors(block, case_t) == (pitch == "16-byte")
    ld.reset_launch_counts()
    a, t = ld.case_counts(block, case_t, n)
    a_plain, t_plain = ld.case_counts_plain(block, case_t, n)
    assert ld.case_counts.launches == 1
    assert torch.equal(a, a_plain) and torch.equal(t, t_plain)
    want_a, want_t = ld.case_counts_reference(values, case)
    assert np.array_equal(a.cpu().numpy(), want_a) and np.array_equal(t.cpu().numpy(), want_t)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [13, 2504])
@pytest.mark.parametrize("sites", [2, 37, 256, 1024])
def test_ld_window_product_equals_plain_version_on_the_card(sites, n):
    """The LD window's C = X·Xᵀ: ``unpack_rows_t`` on the transposed
    packing, then ``gram_accumulate`` into a zeroed (W, W), against their
    plain versions and numpy, exactly; k = diag(C)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import gramian, ld

    dev = torch.device("cuda")
    rng = np.random.default_rng(sites + n)
    rows = (rng.random((sites, n)) < 0.3).astype(np.uint8)
    rows[0] = 1
    packed = torch.from_numpy(ld.pack_window(rows)).to(dev)
    port.reset_launch_counts()
    gramian.reset_launch_counts()
    C = ld.window_counts(packed, sites)
    C_plain = torch.zeros_like(C)
    port.gram_accumulate_plain(C_plain, gramian.unpack_rows_t_plain(packed, sites))
    assert (port.gram_accumulate.launches, gramian.unpack_rows_t.launches) == (1, 1)
    assert torch.equal(C, C_plain)
    C_host, k = ld.ld_window_stats(rows, dev)
    X = rows.astype(np.int64)
    assert np.array_equal(C_host, X @ X.T) and np.array_equal(k, X.sum(axis=1))


#: The LD window product's (sites, samples) on the card, and the splits of
#: its samples timed there (``chip_smoke.py:LD_SPLITS``).
LD_SPLIT_SHAPES = [(256, 2504), (37, 2504), (256, 13), (129, 130), (256, 25000)]
LD_SPLITS = (None, 1, 2, 4, 5, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("sites, n", LD_SPLIT_SHAPES)
def test_split_product_equals_plain_and_numpy_on_the_card(sites, n):
    """The LD window's C = X·Xᵀ with its samples split over blocks, at the
    rule's split (``None``) and each measured split the steps allow,
    exactly equal to the plain version and to numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import gramian, ld

    dev = torch.device("cuda")
    rng = np.random.default_rng(sites * n)
    rows = (rng.random((sites, n)) < 0.3).astype(np.uint8)
    rows[0] = 1
    xt = gramian.unpack_rows_t(torch.from_numpy(ld.pack_window(rows)).to(dev), sites)
    steps = xt.shape[1] // port.SITE_TILE
    X = rows.astype(np.float64)  # exact: every sum is below 2^53
    want = (X @ X.T).astype(np.int64)
    C_plain = torch.zeros((sites, sites), dtype=torch.int32, device=dev)
    port.gram_accumulate_plain(C_plain, xt)
    splits = [s for s in LD_SPLITS if s is None or s <= steps]
    port.reset_launch_counts()
    for split in splits:
        C = torch.zeros((sites, sites), dtype=torch.int32, device=dev)
        port.gram_accumulate(C, xt, split)
        assert torch.equal(C, C_plain), split
        assert np.array_equal(C.cpu().numpy().astype(np.int64), want), split
    assert port.gram_accumulate.launches == len(splits)
    _, _, split, sms = port.gram_accumulate_grid(*xt.shape, dev)
    assert split == port.gram_split(*xt.shape, sms)


#: Depth-kernel cases: (reads, read length, window, max_read_length or
#: code/mask mode). The first two are ``chip_smoke.py``'s shapes: a
#: whole-chr21 shard of example 3 and an example-4 shard.
DEPTH_CASES = {
    "chr21-shard": (26194, 100, 327414 + 128, 128),
    "edges": (997, 300, 5000, 256),
    "long-reads": (64, 400, 3000, 128),
    "one-read": (1, 100, 64, 128),
    "no-reads": (0, 100, 64, 128),
    "window-of-1": (200, 100, 1, 128),
    "max-read-length-0": (300, 100, 2000, 0),
    "reads-over-the-whole-window": (64, 3000, 2000, 4096),
    "wide-window": (3000, 100, 600_000, 128),
    "more-tiles-than-resident-blocks": (2000, 100, 10_000_000, 128),
}
BASE_CASES = {
    "example4-shard": (4210, 128, 52631 + 128, "random"),
    "edges": (997, 192, 5000, "random"),
    "all-unknown": (300, 128, 2000, "unknown"),
    "mask-false": (300, 128, 2000, "masked"),
    "one-read": (1, 64, 64, "random"),
    "no-reads": (0, 64, 64, "random"),
    "position-sorted": (4210, 100, 52631 + 128, "sorted"),
    "read-length-99": (300, 99, 2000, "random"),
}


def _read_starts(rng, rows, window, span):
    """Starts spread from ``span`` before the window to past its end, so
    reads begin before it, straddle both edges and lie beyond it."""
    import numpy as np

    return rng.integers(1_000_000 - span, 1_000_000 + window + 50, rows).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(DEPTH_CASES))
def test_depth_counts_kernel_equals_plain_version_on_the_card(case):
    """``depth_counts`` against its plain version, exactly: reads before the
    window start and past its end, zero and negative lengths, lengths above
    ``max_read_length`` (cut there, also at 0), reads over the whole
    window, a window of 1, windows of 586 scan tiles and of 9,766 (more
    blocks than the card holds at once), one read and none; twice, so the
    second call finds the buffers the first left zeroed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import depth

    rows, length, window, max_len = DEPTH_CASES[case]
    rng = np.random.default_rng(rows + window)
    dev = torch.device("cuda")
    starts = _read_starts(rng, rows, window, length)
    lengths = np.full(rows, length, dtype=np.int32)
    if case == "edges":
        lengths = rng.integers(-3, 2 * max_len, rows).astype(np.int32)
    pos_t, len_t = torch.from_numpy(starts).to(dev), torch.from_numpy(lengths).to(dev)
    depth.reset_launch_counts()
    got = depth.depth_counts(pos_t, len_t, 1_000_000, window, max_len)
    again = depth.depth_counts(pos_t, len_t, 1_000_000, window, max_len)
    want = depth.depth_counts_plain(pos_t, len_t, 1_000_000, window, max_len)
    assert depth.depth_counts.launches == (2 if rows else 0)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert int(got.sum()) == int(depth.depth_counts_plain(
        pos_t.cpu(), len_t.cpu(), 1_000_000, window, max_len).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BASE_CASES))
def test_base_counts_kernel_equals_plain_version_on_the_card(case):
    """``base_counts`` against its plain version, exactly: codes -1…5 (a
    code above 3 counts as 3, as the reference clips it), all-unknown codes,
    an all-false mask (bool and uint8), one read and none, reads in
    position order and rows of 99 bytes; three calls, each adding into the
    buffer the call before it zeroed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import depth

    rows, length, window, mode = BASE_CASES[case]
    rng = np.random.default_rng(rows + window + length)
    dev = torch.device("cuda")
    starts = _read_starts(rng, rows, window, length)
    codes = rng.integers(-1, 6 if case == "edges" else 4, (rows, length)).astype(np.int8)
    ok = rng.random((rows, length)) < 0.8
    if mode == "unknown":
        codes[:] = -1
    if mode == "masked":
        ok[:] = False
    if mode == "sorted":
        starts.sort()
    pos_t = torch.from_numpy(starts).to(dev)
    codes_t, ok_t = torch.from_numpy(codes).to(dev), torch.from_numpy(ok).to(dev)
    depth.reset_launch_counts()
    got = depth.base_counts(pos_t, codes_t, ok_t, 1_000_000, window)
    got_u8 = depth.base_counts(pos_t, codes_t, ok_t.to(torch.uint8), 1_000_000, window)
    again = depth.base_counts(pos_t, codes_t, ok_t, 1_000_000, window)
    want = depth.base_counts_plain(pos_t, codes_t, ok_t, 1_000_000, window)
    assert depth.base_counts.launches == (3 if rows else 0)
    assert torch.equal(got, want) and torch.equal(got_u8, want) and torch.equal(again, want)
    if mode in ("unknown", "masked"):
        assert int(got.sum()) == 0


@pytest.mark.gpu
def test_base_counts_windows_that_grow_and_shrink_on_the_card():
    """Calls whose windows grow and shrink in turn, on the default stream
    and on a side stream, each equal to the plain version: a narrower
    window adds into the first rows of the kept buffer, a wider one starts
    from a zero-filled buffer of its size, and every result stays its
    caller's when later calls run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import depth

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    kept = []
    side = torch.cuda.Stream()
    for i, window in enumerate((2000, 64, 52_759, 1, 52_759, 9000, 2000)):
        rows = 300 + 10 * i
        starts = torch.from_numpy(_read_starts(rng, rows, window, 100)).to(dev)
        codes = torch.from_numpy(rng.integers(-1, 4, (rows, 100)).astype(np.int8)).to(dev)
        ok = torch.from_numpy(rng.random((rows, 100)) < 0.6).to(dev)
        with torch.cuda.stream(side if i % 3 == 2 else torch.cuda.current_stream()):
            got = depth.base_counts(starts, codes, ok, 1_000_000, window)
            torch.cuda.synchronize()
        want = depth.base_counts_plain(starts, codes, ok, 1_000_000, window)
        assert got.shape == (window, 4) and torch.equal(got, want)
        kept.append((got, want))
    torch.cuda.synchronize()
    assert all(torch.equal(got, want) for got, want in kept)


@pytest.mark.gpu
@pytest.mark.parametrize("split", [None, 1, 2])
@pytest.mark.parametrize(
    "m,n,sites,ldc,offset",
    [(632, 632, 1024, 2528, 632), (632, 632, 16384, 2528, 1896), (13, 130, 256, 200, 7),
     (130, 13, 256, 150, 3), (600, 517, 384, 1201, 1), (6250, 6250, 1024, 25000, 6250),
     (200, 100, 512, 400, 5), (383, 517, 640, 1204, 2), (1000, 1300, 256, 2600, 1)],
)
def test_cross_accumulate_equals_plain_on_the_card(m, n, sites, ldc, offset, split):
    """The ring step's product into a strided column slice of a row tile,
    at ragged ``m``, ``n`` and ``ldc`` (the bulk epilogue where C's rows
    allow it, single adds elsewhere) and every split, exactly; its rows
    and columns outside the slice untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(m + n + sites)
    a = torch.from_numpy((rng.random((-(-m // 128) * 128, sites)) < 0.3).astype(np.int8)).to(dev)
    b = torch.from_numpy((rng.random((-(-n // 128) * 128, sites)) < 0.3).astype(np.int8)).to(dev)
    tile = torch.from_numpy(rng.integers(-9, 9, (m, ldc), dtype=np.int32)).to(dev)
    want = tile.clone()
    port.reset_launch_counts()
    port.cross_accumulate(tile[:, offset : offset + n], a, b, split=split)
    port.cross_accumulate_plain(want[:, offset : offset + n], a, b)
    assert torch.equal(tile, want) and port.cross_accumulate.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("copies", [1, 2])
def test_cross_accumulate_on_four_streams_of_one_card(copies):
    """Four positions' products launched at once on four streams of one
    card, as the ring launches them, ``copies`` times over (each stream
    keeps its own item counter, which every launch leaves zero): every C
    equals the plain version, and so does a launch on the default stream
    afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(4 + copies)
    shapes = [(632, 632, 16384), (6250, 6250, 1024), (632, 632, 1024), (1000, 1300, 2048)]
    jobs = []
    for m, n, sites in shapes:
        a = torch.from_numpy((rng.random((-(-m // 128) * 128, sites)) < 0.3).astype(np.int8)).to(dev)
        b = torch.from_numpy((rng.random((-(-n // 128) * 128, sites)) < 0.3).astype(np.int8)).to(dev)
        tile = torch.from_numpy(rng.integers(-9, 9, (m, 2 * n), dtype=np.int32)).to(dev)
        want = tile.clone()
        for _ in range(copies):
            port.cross_accumulate_plain(want[:, n:], a, b)
        jobs.append((tile, want, a, b, n))
    streams = [torch.cuda.Stream() for _ in shapes]
    torch.cuda.synchronize()
    port.reset_launch_counts()
    for _ in range(copies):
        for stream, (tile, _, a, b, n) in zip(streams, jobs):
            with torch.cuda.stream(stream):
                port.cross_accumulate(tile[:, n:], a, b)
    torch.cuda.synchronize()
    assert port.cross_accumulate.launches == copies * len(shapes)
    assert all(torch.equal(tile, want) for tile, want, *_ in jobs)
    tile, want, a, b, n = jobs[0]
    port.cross_accumulate(tile[:, n:], a, b)
    port.cross_accumulate_plain(want[:, n:], a, b)
    torch.cuda.synchronize()
    assert torch.equal(tile, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_pad,sites,columns,rows", [(640, 1024, 632, 1024), (640, 16384, 632, 16384),
                                                      (6272, 1024, 6256, 1000), (128, 128, 8, 5),
                                                      (6272, 16384, 6256, 16384), (6272, 1152, 6256, 1101),
                                                      (640, 384, 632, 257), (12800, 256, 12800, 200)])
def test_pack_rows_t_equals_plain_and_packbits_on_the_card(n_pad, sites, columns, rows):
    """The pack of a generated Xᵀ's columns, against the plain version and
    np.packbits; the unpack of the result gives the columns back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import gramian

    dev = torch.device("cuda")
    rng = np.random.default_rng(sites + columns)
    xt = torch.from_numpy((rng.random((n_pad, sites)) < 0.3).astype(np.int8)).to(dev)
    gramian.reset_launch_counts()
    got = gramian.pack_rows_t(xt, columns, rows)
    assert torch.equal(got, gramian.pack_rows_t_plain(xt, columns, rows))
    assert np.array_equal(got.cpu().numpy(), np.packbits(xt[:columns, :rows].cpu().numpy().T, axis=-1))
    assert gramian.pack_rows_t.launches == 1
    back = gramian.unpack_rows_t(got, columns)
    assert torch.equal(back[:columns, :rows], xt[:columns, :rows])


@pytest.mark.gpu
@pytest.mark.parametrize("n_pad,sites,columns,rows", [(640, 1024, 626, 1024), (640, 16384, 626, 16384),
                                                      (128, 128, 13, 5), (6272, 1152, 6250, 1101),
                                                      (640, 384, 632, 257), (128, 256, 128, 200)])
def test_transpose_rows_t_equals_plain_on_the_card(n_pad, sites, columns, rows):
    """The unpacked wire's rows of an Xᵀ (ragged columns and sites), against
    the plain version and numpy; the counts unpack gives the columns back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import gramian

    dev = torch.device("cuda")
    rng = np.random.default_rng(sites + columns)
    xt = torch.from_numpy(rng.integers(0, 3, (n_pad, sites)).astype(np.int8)).to(dev)
    gramian.reset_launch_counts()
    got = gramian.transpose_rows_t(xt, columns, rows)
    assert torch.equal(got, gramian.transpose_rows_t_plain(xt, columns, rows))
    assert np.array_equal(got.cpu().numpy(), xt[:columns, :rows].cpu().numpy().T.view(np.uint8))
    assert gramian.transpose_rows_t.launches == 1
    back = gramian.unpack_rows_t(got, columns, counts=True)
    assert torch.equal(back[:columns, :rows], xt[:columns, :rows])


@pytest.mark.gpu
@pytest.mark.parametrize("pack,schedule,shape", [("on", "flat", (1, 4)), ("off", "flat", (1, 4)),
                                                 ("on", "hier", (1, 4)), ("on", "flat", (2, 2))])
def test_ring_of_four_positions_on_one_card_equals_the_dense_gramian(pack, schedule, shape, monkeypatch):
    """Four positions of one card run the device-generation ring (their own
    streams, device copies for the transfers): its Gramian and counters are
    byte-equal to the one-device run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import gramian
    from spark_examples_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setenv(pmesh.HIER_HOSTS_ENV, "2" if schedule == "hier" else "1")
    dev = torch.device("cuda")
    source = SyntheticGenomicsSource(num_samples=300, seed=6)
    kw = dict(pops=source.populations, site_key=source.site_key, spacing=source.variant_spacing,
              ref_block_fraction=source.ref_block_fraction, n_pops=source.n_pops,
              block_size=1024, blocks_per_dispatch=8)
    key = source.genotype_stream_key("vs")
    dense = port.DeviceGenGramianAccumulator(300, [key], device=dev, **kw)
    dense.add_grid(0, 20_000)
    mesh = pmesh.make_mesh({"data": shape[0], "samples": shape[1]}, [dev] * 4)
    gramian.reset_launch_counts()
    ring = port.DeviceGenRingGramianAccumulator(300, key, mesh=mesh, pack_bits=pack,
                                                reduce_schedule=schedule, **kw)
    ring.add_grid(0, 20_000)
    assert np.array_equal(ring.finalize(), dense.finalize())
    rows, kept = ring.ingest_counters()
    want_rows, want_kept = dense.ingest_counters()
    assert rows.tolist() == want_rows.tolist() and kept == want_kept
    assert (gramian.pack_rows_t.launches > 0) == (pack == "on")


def _stacked_case(k, n, rows, finished, seed):
    """K lanes of bit-packed {0,1} rows, the finished lanes' rows zero (as
    the stacked accumulator ships them), on the card; and the lanes that
    hold a block."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bits = (rng.random((k, rows, n)) < 0.3).astype(np.uint8)
    bits[list(finished)] = 0
    packed = torch.from_numpy(np.packbits(bits, axis=-1)).to("cuda")
    return packed, [lane for lane in range(k) if lane not in finished]


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,rows,finished", [
    (1, 2504, 1024, ()), (3, 17, 1024, ()), (3, 13, 200, ()), (3, 130, 1024, ()),
    (2, 2504, 1024, (0,)), (5, 300, 700, (1, 3)), (8, 256, 384, (0, 1, 2, 3, 4, 5, 6)),
])
def test_stacked_kernels_equal_plain_on_the_card(k, n, rows, finished):
    """The stacked unpack (the listed lanes' rows of Xᵀ) and the stacked
    product (every lane of G, onto a nonzero G) against their plain
    versions: odd N, N % 4 == 2, one lane, lanes that have finished (the
    kernels skip them, the plain version adds their zero block); one
    launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from spark_examples_tpu_torch.ops import batched

    packed, lanes = _stacked_case(k, n, rows, finished, seed=k * n + rows)
    n_pad = -(-n // 128) * 128
    batched.reset_launch_counts()
    got = batched.stacked_unpack_rows_t(packed, n, lanes)
    want = batched.stacked_unpack_rows_t_plain(packed, n)
    for lane in lanes:
        assert torch.equal(got[lane * n_pad:(lane + 1) * n_pad], want[lane * n_pad:(lane + 1) * n_pad])
    start = torch.randint(-1000, 1000, (k, n, n), dtype=torch.int32, device="cuda")
    g_k, g_p = start.clone(), start.clone()
    batched.stacked_gram_accumulate(g_k, got, lanes)
    batched.stacked_gram_accumulate_plain(g_p, want)
    assert torch.equal(g_k, g_p)
    assert batched.stacked_unpack_rows_t.launches == batched.stacked_gram_accumulate.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 132, 2504])
def test_stacked_product_on_a_g_off_16_bytes_and_every_split(n):
    """A stacked G whose first lane starts 4 bytes past a 16-byte boundary
    (the epilogue's single adds, not the bulk reductions) and the product
    at every split equal the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from spark_examples_tpu_torch.ops import batched

    k = 3
    packed, lanes = _stacked_case(k, n, 512, (), seed=n)
    xt = batched.stacked_unpack_rows_t(packed, n)
    buffer = torch.zeros(k * n * n + 1, dtype=torch.int32, device="cuda")
    g_k = buffer[1:].view(k, n, n)
    assert g_k.data_ptr() % 16 == 4
    g_p = torch.zeros((k, n, n), dtype=torch.int32, device="cuda")
    batched.stacked_gram_accumulate(g_k, xt)
    batched.stacked_gram_accumulate_plain(g_p, xt)
    assert torch.equal(g_k, g_p)
    for split in (1, 2, 4):
        g_s = torch.zeros((k, n, n), dtype=torch.int32, device="cuda")
        batched.stacked_gram_accumulate(g_s, xt, split=split)
        assert torch.equal(g_s, g_p)


@pytest.mark.gpu
def test_stacked_accumulator_lanes_equal_their_serial_runs_on_the_card():
    """A ragged group fed in lockstep on the card: every lane equals the
    serial accumulator's Gramian, and each step launched each stacked
    kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from spark_examples_tpu_torch.ops import batched, gramian

    rng = np.random.default_rng(17)
    n, block = 300, 256
    lanes = [(rng.random((size, n)) < 0.3).astype(np.uint8) for size in (1000, 0, 513, 2049)]
    batched.reset_launch_counts()
    acc = batched.StackedJobsAccumulator(len(lanes), n, device="cuda", block_size=block)
    for start in range(0, 2049, 200):
        for j, rows in enumerate(lanes):
            if start < len(rows):
                acc.add_rows(j, rows[start:start + 200])
    for j in range(len(lanes)):
        acc.finish_lane(j)
    G = acc.finalize()
    for j, rows in enumerate(lanes):
        serial = gramian.GramianAccumulator(n, device="cuda", block_size=block)
        serial.add_rows(rows)
        assert torch.equal(G[j], serial.finalize_device())
    assert acc.steps == batched.stacked_gram_accumulate.launches == 9
    assert batched.stacked_unpack_rows_t.launches == acc.steps
