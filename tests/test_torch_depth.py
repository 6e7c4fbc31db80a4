"""The port's depth ops (``ops/depth.py``) against the JAX package's.

The same numpy inputs (from a seed) go through
``spark_examples_tpu/ops/depth.py`` and the port's plain versions, which
the port's wrappers run for CPU tensors. The outputs are int32 counts and
bool masks: equal element for element, no tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_examples_tpu.ops import depth as ref
from spark_examples_tpu_torch.ops import depth

WINDOW_START = 1_000


def _reads(seed, rows, length, window, max_len, mode):
    """Starts from a read length before the window to past its end, so reads
    begin before it, straddle both edges and lie beyond it; ``mode``
    "edges" adds zero, negative and over-``max_len`` lengths and codes
    -1…5; "unknown" makes every code -1, "masked" every mask bit false."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(WINDOW_START - length, WINDOW_START + window + 50, rows).astype(np.int32)
    lengths = np.full(rows, length, dtype=np.int32)
    codes = rng.integers(0, 4, (rows, max_len)).astype(np.int8)
    codes[:, length:] = -1
    ok = rng.random((rows, max_len)) < 0.6
    if mode == "edges":
        lengths = rng.integers(-3, 2 * max_len, rows).astype(np.int32)
        codes = rng.integers(-1, 6, (rows, max_len)).astype(np.int8)
    if mode == "unknown":
        codes[:] = -1
    if mode == "masked":
        ok[:] = False
    return starts, lengths, codes, ok


#: (reads, read length, window, max_read_length, mode): random shards,
#: the edges, 400-base reads (``tests/test_analyses.py``'s long-read case:
#: the examples pad 400 to 448), one read and none.
CASES = {
    "shard": (500, 100, 3000, 128, "random"),
    "edges": (400, 150, 900, 192, "edges"),
    "short-window": (200, 100, 64, 128, "random"),
    "long-reads": (60, 400, 2500, 448, "random"),
    "long-reads-cut": (60, 400, 2500, 256, "random"),
    "all-unknown": (100, 100, 800, 128, "unknown"),
    "all-masked": (100, 100, 800, 128, "masked"),
    "one-read": (1, 100, 64, 128, "random"),
    "no-reads": (0, 100, 64, 128, "random"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_depth_counts_equals_the_jax_function(case):
    rows, length, window, max_len, mode = CASES[case]
    starts, lengths, _, _ = _reads(len(case), rows, min(length, max_len), window, max_len, mode)
    if case == "long-reads-cut":
        lengths[:] = length  # longer than max_read_length: cut there
    want = np.asarray(ref.depth_counts(jnp.asarray(starts), jnp.asarray(lengths),
                                       jnp.int32(WINDOW_START), window, max_len))
    got = depth.depth_counts(torch.from_numpy(starts), torch.from_numpy(lengths),
                             WINDOW_START, window, max_len)
    assert got.dtype == torch.int32 and got.shape == (window,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        depth.depth_counts_plain(torch.from_numpy(starts), torch.from_numpy(lengths),
                                 WINDOW_START, window, max_len).numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_base_counts_equals_the_jax_function(case):
    rows, length, window, max_len, mode = CASES[case]
    starts, _, codes, ok = _reads(len(case) + 1, rows, min(length, max_len), window, max_len, mode)
    want = np.asarray(ref.base_counts(jnp.asarray(starts), jnp.asarray(codes), jnp.asarray(ok),
                                      jnp.int32(WINDOW_START), window))
    got = depth.base_counts(torch.from_numpy(starts), torch.from_numpy(codes),
                            torch.from_numpy(ok), WINDOW_START, window)
    assert got.dtype == torch.int32 and got.shape == (window, 4)
    assert np.array_equal(got.numpy(), want)
    # The mask as it ships to the kernel (uint8) counts the same.
    got_u8 = depth.base_counts(torch.from_numpy(starts), torch.from_numpy(codes),
                               torch.from_numpy(ok.astype(np.uint8)), WINDOW_START, window)
    assert np.array_equal(got_u8.numpy(), want)
    if mode in ("unknown", "masked"):
        assert want.sum() == 0


@pytest.mark.parametrize("min_freq", [0.0, 0.25, 1 / 3, 0.5, 1.0])
def test_frequent_bases_equals_the_jax_function(min_freq):
    rng = np.random.default_rng(int(min_freq * 100))
    counts = rng.integers(0, 5, (300, 4)).astype(np.int32)
    counts[::7] = 0  # uncovered positions
    counts[3] = (1, 1, 1, 0)  # frequencies of a third
    mask_want, covered_want = ref.frequent_bases(jnp.asarray(counts), min_freq)
    mask, covered = depth.frequent_bases(torch.from_numpy(counts), min_freq)
    assert mask.dtype == torch.bool and covered.dtype == torch.bool
    assert np.array_equal(mask.numpy(), np.asarray(mask_want))
    assert np.array_equal(covered.numpy(), np.asarray(covered_want))


@pytest.mark.parametrize("sequence", ["ACGT", "NNAC", "acgt", "", "GATTACA" * 20])
def test_encode_bases_equals_the_jax_function(sequence):
    assert depth.encode_bases(sequence) == ref.encode_bases(sequence)
    assert depth.BASES == ref.BASES


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    depth.reset_launch_counts()
    starts, lengths, codes, ok = _reads(3, 50, 100, 500, 128, "random")
    depth.depth_counts(torch.from_numpy(starts), torch.from_numpy(lengths), WINDOW_START, 500, 128)
    depth.base_counts(torch.from_numpy(starts), torch.from_numpy(codes), torch.from_numpy(ok),
                      WINDOW_START, 500)
    assert [k.launches for k in depth.KERNELS] == [0, 0]


@pytest.mark.parametrize(
    "call, error",
    [
        (lambda p, l, c, q: depth.depth_counts(p.long(), l, 0, 10), TypeError),
        (lambda p, l, c, q: depth.depth_counts(p, l[:-1], 0, 10), ValueError),
        (lambda p, l, c, q: depth.depth_counts(p, l, 0, 0), ValueError),
        (lambda p, l, c, q: depth.depth_counts(p, l, 0, 10, -1), ValueError),
        (lambda p, l, c, q: depth.depth_counts(p[:, None], l, 0, 10), ValueError),
        (lambda p, l, c, q: depth.base_counts(p, c.int(), q, 0, 10), TypeError),
        (lambda p, l, c, q: depth.base_counts(p, c, q.int(), 0, 10), TypeError),
        (lambda p, l, c, q: depth.base_counts(p, c[:-1], q[:-1], 0, 10), ValueError),
        (lambda p, l, c, q: depth.base_counts(p, c, q[:, :-1], 0, 10), ValueError),
        (lambda p, l, c, q: depth.base_counts(p, c.t(), q.t(), 0, 10), ValueError),
    ],
    ids=["positions-int64", "lengths-shape", "window-0", "max-len-negative",
         "positions-2d", "codes-int32", "mask-int32", "codes-rows", "mask-shape",
         "codes-strided"],
)
def test_wrappers_refuse_what_the_kernels_do_not_take(call, error):
    starts, lengths, codes, ok = _reads(4, 8, 8, 32, 8, "random")
    with pytest.raises(error):
        call(torch.from_numpy(starts), torch.from_numpy(lengths), torch.from_numpy(codes),
             torch.from_numpy(ok))
