"""Read depth as a difference array and its prefix sum, against the JAX
package's ``depth_counts``.

``csrc/depth.cu`` computes depth as +1 where each read's clipped interval
starts and -1 where it ends inside the window, adding the same into the
totals of the tiles those bounds fall in; then each tile's inclusive scan,
offset by the totals of the tiles before it. The kernels run only on a
card; this file holds their algorithm, emulated in torch on the CPU (at the
kernel's tile and at small tiles, so the test windows take many tiles),
against ``spark_examples_tpu/ops/depth.py:depth_counts`` on the same seeded
numpy inputs, exactly (integer counts, no tolerance), at every edge the
kernels clip: lengths past ``max_read_length``, lengths of zero and below,
reads that start before the window or end past it or cover all of it, a
window of 1, ``max_read_length`` 0, and windows that are not a multiple of
a tile.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_examples_tpu.ops import depth as ref
from spark_examples_tpu_torch.ops import depth

WINDOW_START = 5_000
#: ``csrc/depth.cu``'s scan tile, and small ones.
SCAN_TILE = 1024
TILES = {"kernel": SCAN_TILE, "small": 7, "one": 1}


def depth_by_tiles(positions, lengths, window_start, window_size, max_read_length,
                   tile=SCAN_TILE):
    """The kernels' algorithm in torch: each read's interval clipped to
    the window and to ``min(length, max_read_length)``; +1 at its start and
    -1 at its end where that lies inside the window, into the difference
    array and into the totals of the tiles the bounds fall in; then each
    tile's inclusive scan plus the totals of the tiles before it."""
    W = int(window_size)
    rel = positions.long() - int(window_start)
    first = rel.clamp(min=0)
    end = torch.minimum(rel + lengths.long().clamp(max=int(max_read_length)), torch.tensor(W))
    live = first < end
    first, end = first[live], end[live]
    end = end[end < W]
    tiles = -(-W // tile)
    diff = torch.zeros(tiles * tile, dtype=torch.int64)
    totals = torch.zeros(tiles, dtype=torch.int64)
    for bounds, sign in ((first, 1), (end, -1)):
        diff.index_add_(0, bounds, torch.full_like(bounds, sign))
        totals.index_add_(0, bounds // tile, torch.full_like(bounds, sign))
    local = diff.view(tiles, tile).cumsum(1)
    assert torch.equal(totals, local[:, -1])  # a tile's total is its own last sum
    before = torch.cumsum(totals, 0) - totals
    return (local + before[:, None]).flatten()[:W].to(torch.int32)


def _reads(seed, rows, length, window, mode):
    """Starts from ``length`` before the window to past its end; ``mode``
    "edges" draws lengths from -3 to twice ``length``."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(WINDOW_START - length, WINDOW_START + window + 50, rows).astype(np.int32)
    lengths = np.full(rows, length, dtype=np.int32)
    if mode == "edges":
        lengths = rng.integers(-3, 2 * length + 1, rows).astype(np.int32)
    return starts, lengths


#: (reads, read length, window, max_read_length, mode).
CASES = {
    "shard": (600, 100, 5000, 128, "fixed"),
    "edges": (500, 150, 3000, 192, "edges"),
    "cut-at-max-read-length": (200, 300, 2000, 128, "fixed"),
    "max-read-length-0": (100, 100, 800, 0, "fixed"),
    "non-positive-lengths": (100, 0, 800, 128, "edges"),
    "window-of-1": (300, 100, 1, 128, "fixed"),
    "reads-over-the-whole-window": (40, 1500, 1000, 2048, "fixed"),
    "ragged-tiles": (900, 100, 3 * 1024 + 5, 128, "fixed"),
    "one-read": (1, 100, 64, 128, "fixed"),
}


def _case_reads(case):
    rows, length, window, _, mode = CASES[case]
    return _reads(len(case) + rows, rows, length, window, mode)


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_difference_array_scan_equals_the_jax_function(case, tile):
    _, _, window, max_len, _ = CASES[case]
    starts, lengths = _case_reads(case)
    want = np.asarray(ref.depth_counts(jnp.asarray(starts), jnp.asarray(lengths),
                                       jnp.int32(WINDOW_START), window, max_len))
    got = depth_by_tiles(torch.from_numpy(starts), torch.from_numpy(lengths),
                         WINDOW_START, window, max_len, TILES[tile])
    np.testing.assert_array_equal(got.numpy(), want)
    # The port's wrapper (the plain version on the CPU) agrees too.
    plain = depth.depth_counts(torch.from_numpy(starts), torch.from_numpy(lengths),
                               WINDOW_START, window, max_len)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_the_edges_happen():
    """The cases reach what they name: reads clipped at both window edges
    and covering it, lengths cut at max_read_length and counting nothing."""
    starts, _ = _case_reads("reads-over-the-whole-window")
    rel = starts.astype(np.int64) - WINDOW_START
    assert (rel < 0).any() and (rel + 1500 > 1000).any()
    assert ((rel <= 0) & (rel + 1500 >= 1000)).any()
    _, lengths = _case_reads("edges")
    assert (lengths <= 0).any() and (lengths > 192).any()
    _, lengths = _case_reads("non-positive-lengths")
    assert (lengths <= 0).all()


def test_the_kernel_tile_is_the_sources():
    """The emulation's tile is ``csrc/depth.cu``'s."""
    src = (pathlib.Path(depth.__file__).parents[1] / "csrc" / "depth.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert SCAN_TILE == constant("DEPTH_THREADS") * constant("SCAN_ITEMS")
