"""The launch rules the ring's two kernels follow, on the CPU.

``cross_accumulate_kernel`` (``csrc/devicegen.cu``) runs persistent
clusters of two blocks that walk items taken from a device counter;
``ops/devicegen.py:cross_schedule`` and ``cross_work`` state, as the kernel
decodes them, which block of which item takes which rows, columns and
sites. ``pack_rows_t_kernel`` (``csrc/gramian.cu``) takes 32 sites × a
whole output row a block and turns a warp vote into np.packbits' bytes;
``ops/gramian.py:pack_schedule`` states its blocks. The card tests
(``tests/test_torch_kernels.py``) hold the kernels to the same rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from spark_examples_tpu_torch.ops import devicegen, gramian

#: The SMs of an H100 SXM, and of an H100 PCIe.
SMS = (132, 114)
#: (m, n, sites) of the ring's steps (2,504 and 25,000 samples over 4
#: positions: 632 and 6,256 columns; 6,250 as the kernels phase times it)
#: and ragged shapes.
SHAPES = [(632, 632, 1024), (632, 632, 16384), (6250, 6250, 1024), (6256, 6256, 16384),
          (13, 130, 256), (130, 13, 384), (1400, 1300, 256), (383, 517, 640), (200, 100, 512)]


def _pad(x: int) -> int:
    return -(-x // devicegen.COL_TILE) * devicegen.COL_TILE


def _work(m, n, sites, sms, split=None):
    m_pad, n_pad = _pad(m), _pad(n)
    schedule = devicegen.cross_schedule(m_pad, n_pad, sites, sms, split)
    return schedule, list(devicegen.cross_work(schedule, m_pad, n_pad, sites))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("split", [None, 1, 2])
@pytest.mark.parametrize("m,n,sites", SHAPES)
def test_the_items_cover_every_unit_of_c_once(m, n, sites, split, sms):
    """Every 64 rows × 128 columns of C, at every step of 128 sites, is
    taken by exactly one block of one item."""
    schedule, work = _work(m, n, sites, sms, split)
    m_pad, n_pad, steps = _pad(m), _pad(n), sites // devicegen.SITE_TILE
    taken = np.zeros((m_pad // 64, n_pad // devicegen.COL_TILE, steps), dtype=np.int64)
    for w in work:
        rows = slice(w.row0 // 64, (w.row0 + schedule.rows) // 64)
        cols = slice(w.col0 // devicegen.COL_TILE, w.col0 // devicegen.COL_TILE + w.boxes)
        taken[rows, cols, w.first : w.first + w.steps] += 1
    assert (taken == 1).all()
    assert {w.item for w in work} == set(range(schedule.items))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n,sites", SHAPES)
def test_a_cluster_shares_b_and_a_lone_box_takes_the_narrow_mma(m, n, sites, sms):
    """The blocks of an item (unsplit, a cluster) take neighbouring rows
    against one column group of B (each loads one of its boxes into both);
    a split launch's blocks take an item each, part by part. Where B has an
    odd number of tiles the last group holds one box, and only its blocks
    take m64n128k32."""
    schedule, work = _work(m, n, sites, sms)
    n_tiles = _pad(n) // devicegen.COL_TILE
    by_item = {}
    for w in work:
        by_item.setdefault(w.item, []).append(w)
    for blocks in by_item.values():
        assert len({(w.col0, w.boxes, w.first, w.steps) for w in blocks}) == 1
        rows = sorted(w.row0 for w in blocks)
        assert rows == [rows[0] + r * schedule.rows for r in range(len(blocks))]
        assert rows[0] % (schedule.cluster * schedule.rows) == 0
    if not schedule.walk:
        # Part by part: the items of one part are consecutive.
        assert all(a.first <= b.first for a, b in zip(work, work[1:]))
    narrow = {w.col0 for w in work if w.mma_n == devicegen.COL_TILE}
    if n_tiles % 2:
        assert narrow == {(n_tiles - 1) * devicegen.COL_TILE}
    else:
        assert not narrow
    assert all(w.mma_n == devicegen.GRAM_UNIT_TILES * devicegen.COL_TILE
               for w in work if w.col0 not in narrow)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("sites", [1024, 16384])
def test_the_small_ring_step_splits_into_one_wave(sites, sms):
    """632 × 632 (2,504 samples over 4 positions): 15 units of 128 × 256,
    so the sites split and every block takes one item in one wave of
    64-row blocks; 6,256 × 6,256 fills the card unsplit, the clusters
    walking many items each."""
    schedule = devicegen.cross_schedule(640, 640, sites, sms)
    assert schedule.units == 15 and schedule.split > 1 and schedule.rows == 64
    assert schedule.blocks == schedule.items <= sms and not schedule.walk
    assert schedule.cluster == 1
    assert schedule.split == devicegen.cross_split(640, 640, sites, sms)
    if sms == 132:
        assert schedule.split == (4 if sites == 16384 else 2)
    big = devicegen.cross_schedule(6272, 6272, sites, sms)
    assert (big.split, big.rows, big.units) == (1, 128, 1225)
    assert big.items == 25 * 25 and big.blocks == 2 * (sms // 2)
    # 16,384 sites (128 steps an item) take the deep shape's fourth stage.
    assert big.stages == (4 if sites // devicegen.SITE_TILE >= devicegen.CROSS_DEEP_STEPS else 3)


def test_the_kernels_walk_sums_to_the_jax_ring_product():
    """The partial products of every block of every item, added as the
    kernel adds them into a strided C, equal the JAX package's ring-step
    product (``jnp.matmul`` of the operands, ``_ring_tiles``'s), exactly,
    at every split."""
    rng = np.random.default_rng(14)
    m, n, sites = 300, 200, 1024
    a = (rng.random((_pad(m), sites)) < 0.4).astype(np.int8)
    b = (rng.random((_pad(n), sites)) < 0.4).astype(np.int8)
    want = np.asarray(jnp.matmul(jnp.asarray(a[:m], jnp.int32), jnp.asarray(b[:n], jnp.int32).T))
    for split in (1, 2, 3, 4, 8):
        tile = rng.integers(-9, 9, (m, 3 * n), dtype=np.int32)
        before = tile.copy()
        C = tile[:, n : 2 * n]
        schedule, work = _work(m, n, sites, 132, split)
        for w in work:
            cols = slice(w.first * devicegen.SITE_TILE, (w.first + w.steps) * devicegen.SITE_TILE)
            part = (a[w.row0 : w.row0 + schedule.rows, cols].astype(np.int32)
                    @ b[w.col0 : w.col0 + w.mma_n, cols].astype(np.int32).T)
            rows, width = max(0, min(schedule.rows, m - w.row0)), max(0, min(w.mma_n, n - w.col0))
            C[w.row0 : w.row0 + rows, w.col0 : w.col0 + width] += part[:rows, :width]
        assert np.array_equal(C - before[:, n : 2 * n], want)
        assert np.array_equal(tile[:, :n], before[:, :n])
        assert np.array_equal(tile[:, 2 * n :], before[:, 2 * n :])


@pytest.mark.parametrize("rows,columns", [(16384, 632), (16384, 6256), (1024, 632), (1000, 6256),
                                          (5, 8), (257, 632), (200, 12800), (33, 24584)])
def test_a_pack_block_covers_whole_rows_of_its_sites(rows, columns):
    """A block takes ``PACK_SITES`` sites and every byte of their output
    rows (up to ``PACK_MAX_BYTES``), so what it writes is one contiguous
    range starting on a 16-byte boundary; every output byte is written by
    exactly one block."""
    width = columns // 8
    schedule = gramian.pack_schedule(rows, columns)
    assert schedule.sites == gramian.PACK_SITES and (schedule.sites * width) % 16 == 0
    if width <= gramian.PACK_MAX_BYTES:
        assert schedule.row_blocks == 1 and schedule.share == width
    else:
        assert schedule.share == gramian.PACK_MAX_BYTES and schedule.share % 4 == 0
    # A warp of many 32-column groups keeps several groups' loads in flight.
    per_warp = -(-(-(-schedule.share // 4)) // gramian.PACK_WARPS)
    assert schedule.depth == (gramian.PACK_DEEP if per_warp >= gramian.PACK_DEEP_GROUPS else 1)
    assert (columns, schedule.depth) != (632, gramian.PACK_DEEP) and (columns, schedule.depth) != (6256, 1)
    written = np.zeros(rows * width, dtype=np.int64)
    for bx in range(schedule.site_blocks):
        s0 = bx * schedule.sites
        sites = min(schedule.sites, rows - s0)
        assert sites > 0
        for by in range(schedule.row_blocks):
            b0 = by * schedule.share
            share = min(schedule.share, width - b0)
            for i in range(sites):
                written[(s0 + i) * width + b0 : (s0 + i) * width + b0 + share] += 1
            if schedule.row_blocks == 1:
                assert share == width  # the block's bytes: [s0·width, (s0 + sites)·width)
    assert (written == 1).all()


def _byte_perm(x: int, y: int, selector: int) -> int:
    """CUDA's ``__byte_perm(x, y, s)``: byte i of the result is byte
    (nibble i of s) of the eight bytes y:x."""
    pool = (y << 32 | x).to_bytes(8, "little")
    return int.from_bytes(bytes(pool[(selector >> (4 * i)) & 7] for i in range(4)), "little")


def _brev(x: int) -> int:
    """CUDA's ``__brev``: bit i of the result is bit 31 − i of x."""
    return int(f"{x:032b}"[::-1], 2)


@pytest.mark.parametrize("seed", range(4))
def test_the_vote_word_is_packbits_order(seed):
    """A warp vote over 32 columns (bit l: column l nonzero), reversed with
    ``__brev`` and byte-swapped with ``__byte_perm(·, 0, 0x0123)``, stored
    little-endian, is np.packbits of the 32 columns: the kernel's rule."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 3, (64, 32)).astype(np.int8) * (rng.random((64, 32)) < 0.5)
    for row in values:
        vote = sum(1 << lane for lane in range(32) if row[lane] != 0)
        word = _byte_perm(_brev(vote), 0, 0x0123)
        assert word.to_bytes(4, "little") == np.packbits(row != 0).tobytes()
