"""How ``case_counts`` and ``base_counts`` lay their work out on the card.

The launch geometry the wrappers compute on the host is a pure function
of shapes, strides and pointers, so the launch the card gets is decided
here on the CPU: the lanes a packed row takes and whether its loads are
16-byte vectors (``ops/ld.py``), and ``base_counts``' zeroed buffers
kept per device and stream (``ops/depth.py``). The plain
versions the CPU runs equal the JAX package's on strided and unaligned
views and in any order of reads, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.ops import depth as ref_depth
from spark_examples_tpu.ops import ld as ref_ld
from spark_examples_tpu_torch.ops import depth, ld
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

WINDOW_START = 1_000_000


def _width(n):
    return -(-n // 8)


# ------------------------------------------------------------ case_counts


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows", [1, 37, 937, 1024, 16384, 200_000])
@pytest.mark.parametrize("n", [1, 13, 130, 257, 2504, 25000])
def test_lanes_fill_half_the_card_within_their_limits(n, rows, sms):
    """A power of two up to a warp and up to the row's vectors; as many as
    put half the card's threads to work, unless a lane would then load more
    than ``MAX_VECTORS_PER_LANE`` vectors."""
    width = _width(n)
    vectors = -(-width // ld.VECTOR_BYTES)
    lanes = ld.case_counts_lanes(width, rows, sms)
    assert lanes in (1, 2, 4, 8, 16, 32)
    assert lanes == 1 or lanes < 2 * vectors
    assert -(-vectors // lanes) <= ld.MAX_VECTORS_PER_LANE or lanes == 32
    half_card = sms * ld.CASE_THREADS_PER_SM // 2
    if rows * lanes > half_card:  # more than fill: only to bound a lane's vectors
        assert lanes == 1 or -(-vectors // (lanes // 2)) > ld.MAX_VECTORS_PER_LANE
    elif lanes < min(32, vectors):  # fewer than the most: twice as many would overfill
        assert rows * lanes * 2 > half_card


def test_lanes_at_the_cohort_widths():
    """2,504 samples (313 bytes, 20 vectors) on an H100 SXM: 32 lanes a
    row at the CLI's 1,024 rows, 8 at the device path's 16,384; 13
    samples: a lane a row."""
    assert ld.case_counts_lanes(313, 1024, 132) == 32
    assert ld.case_counts_lanes(313, 937, 132) == 32
    assert ld.case_counts_lanes(313, 16384, 132) == 8
    assert ld.case_counts_lanes(313, 200_000, 132) == 8
    assert ld.case_counts_lanes(2, 1024, 132) == 1
    assert ld.case_counts_lanes(17, 1024, 132) == 2


@pytest.mark.parametrize("n", [13, 130, 2504])
@pytest.mark.parametrize("rows", [1, 37, 1024])
def test_shipped_blocks_take_vectors(rows, n):
    """What ``pack_rows`` and ``pack_case`` ship takes 16-byte loads: the
    pitch, the pointers and the rounded-up storages allow them."""
    rng = np.random.default_rng(rows + n)
    block = ld.pack_rows((rng.random((rows, n)) < 0.3).astype(np.uint8))
    case = ld.pack_case((rng.random(n) < 0.5).astype(np.uint8))
    assert block.stride(0) % ld.VECTOR_BYTES == 0
    assert case.untyped_storage().nbytes() % ld.VECTOR_BYTES == 0
    assert case.shape == (_width(n),) and case.is_contiguous()
    assert ld.case_counts_vectors(block, case)


def test_the_vector_rule_refuses_what_16_byte_loads_would_overrun():
    """Byte loads for an odd pitch, a pointer off a 16-byte boundary (of the
    block or the case mask), a last row or a case mask whose rounded-up
    bytes pass the storage's end."""
    width, rows = 313, 8
    span = 320
    ok = dict(pitch=320, rows=rows, width=width, block_ptr=4096,
              block_bytes=(rows - 1) * 320 + span, case_ptr=8192, case_bytes=span)
    assert ld.case_counts_vector_path(**ok)
    for change in (dict(pitch=313), dict(pitch=324), dict(block_ptr=4097),
                   dict(block_ptr=4100), dict(case_ptr=8200),
                   dict(block_bytes=(rows - 1) * 320 + span - 1), dict(case_bytes=313)):
        assert not ld.case_counts_vector_path(**{**ok, **change}), change


def test_views_take_byte_loads():
    """A view one byte into its buffer, contiguous rows of 313 bytes, and
    an unpadded case mask all take byte loads."""
    rng = np.random.default_rng(5)
    values = (rng.random((37, 2504)) < 0.3).astype(np.uint8)
    block = ld.pack_rows(values)
    case = ld.pack_case((np.arange(2504) % 2).astype(np.uint8))
    flat = torch.zeros(37 * 320 + 1, dtype=torch.uint8)
    flat[1:].view(37, 320)[:, :313] = block
    shifted = flat[1:].view(37, 320)[:, :313]
    assert not ld.case_counts_vectors(shifted, case)
    assert not ld.case_counts_vectors(block.contiguous(), case)
    assert not ld.case_counts_vectors(block, case.clone())


@pytest.mark.parametrize("view", ["shifted", "odd-pitch", "contiguous", "column-slice"])
@pytest.mark.parametrize("n", [13, 130, 2504])
def test_case_counts_on_views_equal_the_jax_function(n, view):
    """The wrapper's plain version (the CPU's) on strided and unaligned
    views, junk in the padding, equals ``build_case_counts`` exactly."""
    rng = np.random.default_rng(n + len(view))
    rows = 61
    values = (rng.random((rows, n)) < 0.35).astype(np.uint8)
    case = (rng.random(n) < 0.5).astype(np.uint8)
    packed, width = np.packbits(values, axis=1), _width(n)
    pitch = {"shifted": -(-width // 16) * 16, "odd-pitch": width + 3, "contiguous": width,
             "column-slice": width + 16}[view]
    shift = 1 if view == "shifted" else 0
    host = np.full(rows * pitch + shift, 0xFF, dtype=np.uint8)
    rows_host = host[shift:].reshape(rows, pitch)
    first = 16 if view == "column-slice" else 0  # the rows start 16 bytes into each stride
    if view == "column-slice":
        rows_host = rows_host[:, first:]
    rows_host[:, :width] = packed
    if n % 8:
        rows_host[:, width - 1] |= 0xFF >> (8 - (-n % 8))
    t = torch.from_numpy(host)[shift:].view(rows, pitch)[:, first:first + width]
    assert t.stride() == (pitch, 1) and t.shape == (rows, width)
    a, tt = ld.case_counts(t, ld.pack_case(case), n)
    a_ref, t_ref = ref_ld.build_case_counts()(values, case)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(t_ref))


# ------------------------------------------------------------ base_counts


def _zeros(n):
    return torch.zeros((n, 4), dtype=torch.int32)


def _empty(n):
    return torch.full((n, 4), -7, dtype=torch.int32)  # as a fresh allocation may hold


def test_the_first_call_on_a_stream_zero_fills():
    spares = depth._ZeroedSpares()
    out, spare = spares.take(("cuda", 1), 5, _zeros, _empty)
    assert out.shape == (5, 4) and not out.any()
    assert spare.shape == (5, 4)  # the launch zeroes it for the next call


def test_the_next_call_takes_the_buffer_the_launch_zeroed():
    spares = depth._ZeroedSpares()
    _, spare = spares.take(("cuda", 1), 5, _zeros, _empty)
    spare.zero_()  # what the launch does
    spares.put(("cuda", 1), spare)
    out, nxt = spares.take(("cuda", 1), 3, _zeros, _empty)
    assert out is spare  # a narrower window: its first rows
    assert nxt.shape == (3, 4)  # the next buffer follows this call's window


@pytest.mark.parametrize("rows", [6, 50])
def test_a_wider_window_zero_fills_a_buffer_of_its_size(rows):
    spares = depth._ZeroedSpares()
    _, spare = spares.take(("cuda", 1), 5, _zeros, _empty)
    spares.put(("cuda", 1), spare.zero_())
    out, nxt = spares.take(("cuda", 1), rows, _zeros, _empty)
    assert out is not spare and out.shape == (rows, 4) and not out.any()
    assert nxt.shape == (rows, 4)


def test_a_wide_window_leaves_no_wide_buffer_behind():
    """After one wide window, a narrower one's launch zeroes a next buffer
    of its own size, not the wide one's."""
    spares = depth._ZeroedSpares()
    _, spare = spares.take(("cuda", 1), 600_000, _zeros, _empty)
    spares.put(("cuda", 1), spare.zero_())
    out, nxt = spares.take(("cuda", 1), 52_759, _zeros, _empty)
    assert out.shape == (600_000, 4) and nxt.shape == (52_759, 4)
    spares.put(("cuda", 1), nxt.zero_())
    out, nxt = spares.take(("cuda", 1), 52_759, _zeros, _empty)
    assert out.shape == (52_759, 4) and nxt.shape == (52_759, 4)


def test_streams_and_devices_keep_their_own_buffers():
    spares = depth._ZeroedSpares()
    for key in (("cuda", 1), ("cuda", 2), ("cuda:1", 1)):
        _, spare = spares.take(key, 4, _zeros, _empty)
        spares.put(key, spare.zero_())
    outs = [spares.take(key, 4, _zeros, _empty)[0]
            for key in (("cuda", 1), ("cuda", 2), ("cuda:1", 1))]
    assert len({id(o) for o in outs}) == 3


def test_a_failed_launch_leaves_no_buffer_behind():
    """A launch that raised puts nothing back: the next call takes a fresh
    zero-filled buffer, whatever the failed launch left."""
    spares = depth._ZeroedSpares()
    first, _ = spares.take(("cuda", 1), 4, _zeros, _empty)  # the launch fails: no put
    out, _ = spares.take(("cuda", 1), 4, _zeros, _empty)
    assert out is not first and not out.any()


def _shard(seed, order, width, lo=WINDOW_START, span=5000):
    """The synthetic source's reads over ``span`` bases (length 100, depth
    8) with codes and a quality mask from ``seed``, in ``order``: as the
    source serves them (8 position-sorted runs, one a tiling), sorted by
    position, or shuffled (each read keeps its codes and mask)."""
    starts = np.array([p for p, _ in SyntheticGenomicsSource(num_samples=1).read_starts(
        lo, lo + span)], dtype=np.int32)
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, 5, (len(starts), width)).astype(np.int8)
    codes[:, 100:] = -1
    ok = rng.random((len(starts), width)) < 11 / 21
    take = {"as-served": np.arange(len(starts)), "sorted": np.argsort(starts, kind="stable"),
            "unsorted": rng.permutation(len(starts))}[order]
    return starts[take], codes[take], ok[take]


def _jax_base_counts(starts, codes, ok, window):
    return np.asarray(ref_depth.base_counts(jnp.asarray(starts), jnp.asarray(codes),
                                            jnp.asarray(ok), jnp.int32(WINDOW_START), window))


@pytest.mark.parametrize("width", [100, 128, 99])
@pytest.mark.parametrize("order", ["as-served", "sorted", "unsorted"])
def test_base_counts_in_any_order_equal_the_jax_function(order, width):
    """The plain version equals ``base_counts`` of the JAX package exactly
    on the source's own interleaved runs, on position-sorted and on
    shuffled reads, and every order gives the served order's counts."""
    window = 5000 + 128
    starts, codes, ok = _shard(width, order, width)
    want = _jax_base_counts(starts, codes, ok, window)
    got = depth.base_counts(torch.from_numpy(starts), torch.from_numpy(codes),
                            torch.from_numpy(ok), WINDOW_START, window)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = depth.base_counts_plain(torch.from_numpy(starts), torch.from_numpy(codes),
                                    torch.from_numpy(ok.astype(np.uint8)), WINDOW_START, window)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(want, _jax_base_counts(*_shard(width, "as-served", width),
                                                         window))
    assert want.sum() > 0


def test_the_synthetic_shard_arrives_in_runs():
    """The source serves a shard as its 8 tilings one after the other, each
    sorted: the kernel must not assume one sorted run."""
    starts = [p for p, _ in SyntheticGenomicsSource(num_samples=1).read_starts(
        WINDOW_START, WINDOW_START + 5000)]
    descents = sum(b < a for a, b in zip(starts, starts[1:]))
    assert descents == 7
