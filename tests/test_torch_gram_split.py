"""How ``gram_accumulate`` splits the contracted axis over blocks.

``ops/devicegen.py:gram_split`` is a pure function of the operand's shape
and the card's SM count, so the launch the card gets is decided here on
the CPU: the Gramian's launches at the 1000 Genomes width and above are
the unsplit ones, and the LD window product (a (W, W) C over 2,504
samples) splits its samples. The LD window statistics at those shapes
equal the JAX package's, exactly.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu.ops import ld as ref_ops
from spark_examples_tpu_torch.ops import devicegen, ld

#: The SMs of an H100 SXM, and of an H100 PCIe.
SMS = (132, 114)


def _units_by_walk(rows):
    """The upper triangle's (tile row, column group) units, enumerated as
    ``csrc/devicegen.cu:gram_accumulate_kernel`` decodes a block's unit."""
    tiles = rows // devicegen.COL_TILE
    width = devicegen.GRAM_UNIT_TILES
    groups = -(-tiles // width)
    return [(bi, g) for bi in range(tiles) for g in range(bi // width, groups)]


@pytest.mark.parametrize("rows", [128, 256, 384, 2560, 2688, 25088])
def test_units_cover_the_upper_triangle_once(rows):
    units = _units_by_walk(rows)
    assert devicegen.gram_units(rows) == len(units)
    tiles = rows // devicegen.COL_TILE
    width = devicegen.GRAM_UNIT_TILES
    covered = sorted((bi, g * width + w) for bi, g in units for w in range(width)
                     if g * width + w < tiles and g * width + w >= bi)
    assert covered == [(i, j) for i in range(tiles) for j in range(i, tiles)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("sites", [1024, 16384])
@pytest.mark.parametrize("n", [2504, 2521, 25000])
def test_the_gramian_launch_is_unsplit(n, sites, sms):
    """Every Gramian the main path launches at 2,504 samples and above keeps
    one block a unit over every site: 110 units at 2,504 samples already
    fill most of the card."""
    rows = -(-n // devicegen.COL_TILE) * devicegen.COL_TILE
    assert 2 * devicegen.gram_units(rows) >= sms
    assert devicegen.gram_split(rows, sites, sms) == 1


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("sites, samples", [(256, 2504), (37, 2504), (256, 25000)])
def test_the_ld_window_splits_its_samples(sites, samples, sms):
    """The LD window (2 units at 256 sites, 1 on the 37-site tail) splits
    its 128-sample steps over blocks, within one wave (a split unit takes a
    block for each half of its rows), no block walking fewer than
    ``GRAM_SPLIT_MIN_STEPS`` steps."""
    rows = -(-sites // devicegen.COL_TILE) * devicegen.COL_TILE
    ld_ = -(-samples // devicegen.SITE_TILE) * devicegen.SITE_TILE
    steps = ld_ // devicegen.SITE_TILE
    split = devicegen.gram_split(rows, ld_, sms)
    units = devicegen.gram_units(rows)
    assert split > 1
    assert 2 * units * split <= sms
    assert steps // split >= devicegen.GRAM_SPLIT_MIN_STEPS
    # The most blocks that keep both: one more would break one of them.
    assert (2 * units * (split + 1) > sms
            or steps // (split + 1) < devicegen.GRAM_SPLIT_MIN_STEPS)


def test_the_ld_window_split_at_2504_samples():
    """20 steps of 128 samples over 2 units (256 sites) or 1 (the tail):
    10 splits a unit on an H100 SXM (40 and 20 blocks)."""
    assert devicegen.gram_units(256) == 2 and devicegen.gram_units(128) == 1
    assert devicegen.gram_split(256, 2560, 132) == 10
    assert devicegen.gram_split(128, 2560, 132) == 10


@pytest.mark.parametrize("n, sites, split", [(17, 16384, 64), (17, 1024, 4), (13, 128, 1),
                                             (130, 16384, 33)])
def test_small_cohorts_split_their_sites(n, sites, split):
    """A cohort of one or two tile rows (the 17-sample platinum cohort) is
    one or three units: the rule splits its sites too, down to two steps a
    block (one step cannot split)."""
    rows = -(-n // devicegen.COL_TILE) * devicegen.COL_TILE
    assert devicegen.gram_split(rows, sites, 132) == split


@pytest.mark.parametrize("sms", [1, 8, 66, 114, 132, 264])
def test_split_rule_invariants(sms):
    """Any shape and card: 1 where the units fill half the card, else one
    wave of blocks that each walk at least the minimum steps (or 1 where
    the steps are too few to split)."""
    for rows in (128, 256, 384, 640, 1280, 2560, 25088):
        for ld_ in (0, 128, 256, 384, 1024, 2560, 16384, 25088):
            split = devicegen.gram_split(rows, ld_, sms)
            units = devicegen.gram_units(rows)
            steps = ld_ // devicegen.SITE_TILE
            assert split >= 1
            if 2 * units >= sms:
                assert split == 1
            if split > 1:
                assert 2 * units * split <= sms
                assert steps // split >= devicegen.GRAM_SPLIT_MIN_STEPS
            # Block b walks steps [b·steps/S, (b+1)·steps/S): none is
            # empty, and together they walk every step once.
            parts = [(b + 1) * steps // split - b * steps // split for b in range(split)]
            assert sum(parts) == steps
            if steps:
                assert min(parts) >= 1


@pytest.mark.parametrize("split", [None, 1, 3])
def test_cpu_product_is_the_plain_version_at_any_split(split):
    """On the CPU the wrapper runs the plain version (no launch, any split)."""
    rng = np.random.default_rng(7)
    xt = torch.from_numpy(rng.integers(0, 2, (256, 384), dtype=np.int8))
    g0 = torch.from_numpy(rng.integers(-50, 50, (200, 200), dtype=np.int32))
    G, G_plain = g0.clone(), g0.clone()
    devicegen.reset_launch_counts()
    devicegen.gram_accumulate(G, xt, split)
    devicegen.gram_accumulate_plain(G_plain, xt)
    X = xt[:200].numpy().astype(np.int64)
    assert devicegen.gram_accumulate.launches == 0
    assert torch.equal(G, G_plain)
    np.testing.assert_array_equal(G.numpy(), X @ X.T + g0.numpy())


@pytest.mark.parametrize("sites", [37, 129, 256])
def test_ld_window_stats_at_the_split_shapes_equal_the_reference(sites):
    """The window statistics at the split product's shapes (2,504 samples;
    a tail window, a window one past a tile, the default window) equal the
    reference's ``build_ld_window_stats``."""
    rows = (np.random.default_rng(sites).random((sites, 2504)) < 0.3).astype(np.uint8)
    rows[0] = 1
    C, k = ld.ld_window_stats(rows, device="cpu")
    C_ref, k_ref = ref_ops.build_ld_window_stats(None)(rows)
    np.testing.assert_array_equal(C, np.asarray(C_ref))
    np.testing.assert_array_equal(k, np.asarray(k_ref))
