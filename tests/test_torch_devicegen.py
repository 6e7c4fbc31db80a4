"""The port's device-generation module against the JAX package's.

Both packages get the same seeded inputs as numpy arrays. On the CPU every
kernel wrapper runs its plain PyTorch version, which must equal the JAX
functions bit for bit; the CUDA kernels are held against the plain versions
on the card (``test_torch_kernels.py`` and ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.ops import devicegen as ref
from spark_examples_tpu.sharding.contig import Contig
from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource, af_filter_micro
from spark_examples_tpu_torch.ops import devicegen as port

CPU = torch.device("cpu")


def _u64(values: np.ndarray) -> torch.Tensor:
    """uint64 numpy → the port's int64-held u64 tensor."""
    return torch.from_numpy(np.array(values, dtype=np.uint64).view(np.int64))


def _np_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64).view(np.uint64)


def _random_u64(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], dtype=np.uint64)
    return np.concatenate([edge, rng.integers(0, 1 << 64, n, dtype=np.uint64)])


@pytest.mark.parametrize("seed", [0, 1])
def test_mix64_matches_jax(seed):
    xs = _random_u64(seed, 4096)
    with jax.enable_x64(True):
        want = np.asarray(ref.mix64(jnp.asarray(xs)))
    np.testing.assert_array_equal(_np_u64(port.mix64(_u64(xs))), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_fmix32_matches_jax(seed):
    xs = (_random_u64(seed, 4096) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = np.asarray(ref.fmix32(jnp.asarray(xs)))
    got = port.fmix32(torch.from_numpy(xs.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_allele_pair_matches_jax():
    h2 = _random_u64(2, 64)
    samples = _random_u64(3, 40)
    with jax.enable_x64(True):
        w1, w2 = ref._allele_pair(jnp.asarray(h2)[:, None], jnp.asarray(samples)[None, :])
    g1, g2 = port._allele_pair(_u64(h2)[:, None], _u64(samples)[None, :])
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1).astype(np.int64))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(w2).astype(np.int64))


def _grid(source, contig):
    k0, k1 = source.site_grid_range(contig)
    return np.arange(k0, k1, dtype=np.int64) * source.variant_spacing


@pytest.mark.parametrize("min_af", [None, 0.1, 0.3])
def test_site_thresholds_match_jax(min_af):
    source = SyntheticGenomicsSource(num_samples=16, seed=7)
    positions = _grid(source, Contig("17", 41_196_311, 41_277_499))
    valid = np.arange(len(positions)) % 97 != 5
    micro = af_filter_micro(min_af)
    with jax.enable_x64(True):
        want = np.asarray(
            ref.site_thresholds_on_device(
                jnp.asarray(np.uint64(source.site_key)), jnp.asarray(positions),
                jnp.asarray(valid), source.n_pops, source.ref_block_fraction, micro,
            )
        )
    got = port.site_thresholds_on_device(
        source.site_key, torch.from_numpy(positions), torch.from_numpy(valid),
        source.n_pops, source.ref_block_fraction, micro,
    )
    np.testing.assert_array_equal(_np_u64(got), want)
    assert (want > 0).any() and (want == 0).any()


@pytest.mark.parametrize("set_sizes", [None, (13, 5)])
def test_generate_has_variation_matches_jax(set_sizes):
    source = SyntheticGenomicsSource(num_samples=13, seed=3)
    positions = _grid(source, Contig("2", 10_000, 60_000))
    keys = [source.genotype_stream_key(v) for v in ("vs-a", "vs-b")]
    pops = (
        np.concatenate([source.populations, source._pops_for_size(5)])
        if set_sizes
        else source.populations
    ).astype(np.int32)
    with jax.enable_x64(True):
        T = ref.site_thresholds_on_device(
            jnp.asarray(np.uint64(source.site_key)), jnp.asarray(positions),
            jnp.ones(len(positions), bool), source.n_pops, source.ref_block_fraction, None,
        )
        want = np.asarray(
            ref.generate_has_variation(
                jnp.asarray(positions), T, jnp.asarray(np.array(keys, dtype=np.uint64)),
                jnp.asarray(pops), set_sizes,
            )
        )
    got = port.generate_has_variation(
        torch.from_numpy(positions), _u64(np.asarray(T)), keys,
        torch.from_numpy(pops), set_sizes,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("min_af", [None, 0.15])
def test_generated_rows_equal_host_genotype_blocks(min_af):
    """gen_genotypes' Xᵀ, block by block over a contig's grid, holds exactly
    the host packed path's rows (plus all-zero rows for dropped sites)."""
    source = SyntheticGenomicsSource(num_samples=24, seed=11)
    contig = Contig("1", 20_000, 70_000)
    vs = "vs"
    host = list(source.genotype_blocks(vs, contig, 512, min_af))
    host_rows = np.concatenate([b["has_variation"] for b in host])
    host_pos = np.concatenate([b["positions"] for b in host])
    plan = port.make_gen_plan(
        [source.genotype_stream_key(vs)], [source.populations], source.site_key,
        source.variant_spacing, source.ref_block_fraction, af_filter_micro(min_af),
        source.n_pops, CPU,
    )
    k0, k1 = source.site_grid_range(contig)
    B = 96  # not a multiple of the 128-site tile: Xᵀ rows are padded
    rows = []
    kept = torch.zeros((), dtype=torch.int64)
    vrows = torch.zeros(1, dtype=torch.int64)
    for off in range(k0, k1, B):
        n_valid = min(B, k1 - off)
        xt = port.gen_genotypes(plan, off, n_valid, B, kept, vrows)
        assert xt.shape == (port.COL_TILE, 128) and xt.dtype == torch.int8
        assert not xt[24:].any() and not xt[:, n_valid:].any()
        rows.append(xt[:24, :n_valid].T.numpy())
    rows = np.concatenate(rows)
    positions = np.arange(k0, k1) * source.variant_spacing
    keep = np.isin(positions, host_pos)
    np.testing.assert_array_equal(rows[~keep], 0)
    np.testing.assert_array_equal(rows[keep], host_rows)
    assert int(vrows) == len(host_rows)
    assert int(kept) == sum(len(p) for p, _ in source.site_threshold_plan(contig, min_af))


def _make_pair(source, sets, block_size, blocks_per_dispatch, min_af=None, asymmetric=False):
    kw = dict(
        num_samples=source.num_samples,
        vs_keys=[source.genotype_stream_key(v) for v in sets],
        pops=source.populations,
        site_key=source.site_key,
        spacing=source.variant_spacing,
        ref_block_fraction=source.ref_block_fraction,
        min_af_micro=af_filter_micro(min_af),
        block_size=block_size,
        blocks_per_dispatch=blocks_per_dispatch,
        n_pops=source.n_pops,
    )
    if asymmetric:
        kw["set_sizes"] = [source.num_samples_for(v) for v in sets]
        kw["pops_per_set"] = [source.populations_for(v) for v in sets]
    return ref.DeviceGenGramianAccumulator(**kw), port.DeviceGenGramianAccumulator(
        **kw, device="cpu"
    )


def _state(acc):
    if isinstance(acc, ref.DeviceGenGramianAccumulator):
        with jax.enable_x64(True):
            rows = np.asarray(acc.variant_rows).tolist()
            kept = int(np.asarray(acc.kept_sites))
        G = acc.finalize()
    else:
        rows, kept = acc.variant_rows.tolist(), int(acc.kept_sites)
        G = acc.finalize()
    return G, rows, kept, acc.dispatches, acc.sites_capacity, acc.sites_valid


@pytest.mark.parametrize(
    "blocks_per_dispatch, block_size, min_af",
    [(1, 64, None), (4, 64, None), (4, 32, 0.15), (8, 48, None), (1, 1024, None), (2, 1100, 0.15)],
)
def test_accumulator_matches_jax(blocks_per_dispatch, block_size, min_af):
    """G, variant_rows, kept_sites and the dispatch counters, exactly; the
    grid ends in tail groups (n_valid < capacity). The last two cases are
    the CLI's default block of 1,024 sites and a block (1,100) that is not
    a multiple of the kernel's 128-site padding."""
    source = SyntheticGenomicsSource(num_samples=24, seed=11)
    jax_acc, torch_acc = _make_pair(source, ["vs"], block_size, blocks_per_dispatch, min_af)
    for contig in (Contig("1", 0, 60_000), Contig("3", 5_000, 12_345)):
        k0, k1 = source.site_grid_range(contig)
        jax_acc.add_grid(k0, k1)
        torch_acc.add_grid(k0, k1)
    want, got = _state(jax_acc), _state(torch_acc)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert torch_acc.sites_valid < torch_acc.sites_capacity
    assert torch_acc.G.dtype == torch.int32


@pytest.mark.parametrize("first, second", [(20, 7), (130, 45)])
def test_accumulator_multi_set_asymmetric_matches_jax(first, second):
    """Two variant sets of different sizes; at 130 + 45 samples the second
    set's columns cross a 128-column boundary, so its variant rows gather
    bits from two column tiles."""
    source = SyntheticGenomicsSource(num_samples=first, seed=5, cohort_sizes={"vs-b": second})
    jax_acc, torch_acc = _make_pair(source, ["vs-a", "vs-b"], 64, 4, asymmetric=True)
    k0, k1 = source.site_grid_range(Contig("17", 0, 30_000))
    jax_acc.add_grid(k0, k1)
    torch_acc.add_grid(k0, k1)
    want, got = _state(jax_acc), _state(torch_acc)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[0].shape == (first + second, first + second)
    assert min(got[1]) > 0


@pytest.mark.parametrize(
    "n_sets, samples, n_pops",
    [(9, 5, 4), (33, 3, 4), (1, 40, 17), (9, 20, 17)],
    ids=["9-sets", "33-sets", "17-populations", "9-sets-17-populations"],
)
def test_accumulator_many_sets_and_populations_match_jax(n_sets, samples, n_pops):
    """Past the reference's single-set main path: 9 sets (more than a byte
    of set flags), 33 (more than a word of set bits) and 17 populations;
    G, the per-set variant rows and the kept sites, exactly."""
    source = SyntheticGenomicsSource(num_samples=samples, seed=8, n_pops=n_pops)
    sets = [f"vs-{i}" for i in range(n_sets)]
    jax_acc, torch_acc = _make_pair(source, sets, 64, 4)
    for contig in (Contig("2", 0, 25_000), Contig("9", 3_000, 9_000)):
        k0, k1 = source.site_grid_range(contig)
        jax_acc.add_grid(k0, k1)
        torch_acc.add_grid(k0, k1)
    want, got = _state(jax_acc), _state(torch_acc)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert len(got[1]) == n_sets and min(got[1]) > 0
    assert torch_acc.plan.n_pops == n_pops
    assert int(torch_acc.plan.col_pop.max()) == min(samples, n_pops) - 1


def test_accumulator_add_range_validation():
    source = SyntheticGenomicsSource(num_samples=12, seed=1)
    _, acc = _make_pair(source, ["vs"], 32, 2)
    with pytest.raises(ValueError, match="n_valid"):
        acc.add_range(0, 65)
    with pytest.raises(ValueError, match="n_valid"):
        acc.add_range(0, 0)
    with pytest.raises(ValueError, match="non-negative"):
        acc.add_range(-1, 10)


def test_state_carries_over_from_jax():
    """Half a grid in JAX, the state carried across, the rest in the port:
    the full JAX run's G and counters, exactly."""
    source = SyntheticGenomicsSource(num_samples=16, seed=9)
    k0, k1 = source.site_grid_range(Contig("5", 1_000, 70_000))
    full, _ = _make_pair(source, ["vs"], 64, 4)
    full.add_grid(k0, k1)
    first, second = _make_pair(source, ["vs"], 64, 4)
    mid = k0 + 2 * first.sites_per_dispatch  # a dispatch-group boundary
    first.add_grid(k0, mid)
    G, rows, kept, dispatches, capacity, valid = _state(first)
    port.load_reference_state(second, G, np.asarray(rows), kept, dispatches, capacity, valid)
    second.add_grid(mid, k1)
    want, got = _state(full), _state(second)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert (G != want[0]).any()  # the carried half alone is not the answer


@pytest.mark.parametrize("block_sites", [1, 127, 1024, 1100, 16384])
def test_xt_sites_pad_to_the_product_tile(block_sites):
    """Xᵀ's width stays a multiple of 128 (the product's TMA box) for any
    block size, whatever the generation kernel's own site tile; padding
    sites are zero."""
    source = SyntheticGenomicsSource(num_samples=12, seed=2)
    plan = port.make_gen_plan(
        [source.genotype_stream_key("vs")], [source.populations], source.site_key,
        source.variant_spacing, source.ref_block_fraction, None, source.n_pops, CPU,
    )
    kept = torch.zeros((), dtype=torch.int64)
    rows = torch.zeros(1, dtype=torch.int64)
    xt = port.gen_genotypes(plan, 1000, block_sites, block_sites, kept, rows)
    ld = -(-block_sites // 128) * 128
    assert port.SITE_TILE == 128 and xt.shape == (port.COL_TILE, ld)
    assert not xt[:, block_sites:].any() and not xt[12:].any()
    assert 0 < int(kept) <= block_sites


def test_auto_blocks_per_dispatch_matches_jax():
    for cols in (17, 24, 2504, 2521, 25_000, 60_000):
        for block in (1024, 4096, 16384):
            assert port.auto_blocks_per_dispatch(cols, block) == ref.auto_blocks_per_dispatch(
                cols, block
            )


def test_wrappers_take_the_plain_path_for_cpu_tensors():
    source = SyntheticGenomicsSource(num_samples=12, seed=1)
    plan = port.make_gen_plan(
        [source.genotype_stream_key("vs")], [source.populations], source.site_key,
        source.variant_spacing, source.ref_block_fraction, None, source.n_pops, CPU,
    )
    port.reset_launch_counts()
    kept = torch.zeros((), dtype=torch.int64)
    rows = torch.zeros(1, dtype=torch.int64)
    xt = port.gen_genotypes(plan, 100, 200, 256, kept, rows)
    G = torch.zeros((12, 12), dtype=torch.int32)
    port.gram_accumulate(G, xt)
    X = xt[:12].long()
    np.testing.assert_array_equal(G.numpy(), (X @ X.T).numpy())
    assert int(kept) > 0 and int(rows) > 0
    assert [k.launches for k in port.KERNELS] == [0, 0, 0]
