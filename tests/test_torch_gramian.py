"""The port's dense Gramian (``spark_examples_tpu_torch/ops/gramian.py``)
against the JAX package's (``spark_examples_tpu/ops/gramian.py``) on the
same rows, made from a seed with numpy. Everything here is exact: the
unpacked operand, and every Gramian entry (the port accumulates int32, the
reference float32 on the CPU; both hold the same integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_examples_tpu.ops import gramian as ref
from spark_examples_tpu_torch.obs import MetricsRegistry, SpanRecorder
from spark_examples_tpu_torch.ops import gramian as port
from spark_examples_tpu_torch.ops.devicegen import gram_accumulate_plain


def _rows(rng, b, n, top=1, density=0.3):
    values = rng.integers(1, top + 1, (b, n), dtype=np.uint8)
    return (values * (rng.random((b, n)) < density)).astype(np.uint8)


@pytest.mark.parametrize("n", [8, 13, 130])
def test_unpack_matches_reference_unpack_bits(n):
    """Bit-packed rows, including junk in the last byte's unused low bits,
    unpack to the reference's ``_unpack_bits`` columns; the padding is
    zero."""
    rng = np.random.default_rng(n)
    bits = _rows(rng, 37, n, density=0.5)
    packed = np.packbits(bits, axis=-1)
    if n % 8:
        packed[:, -1] |= 0xFF >> (8 - (-n % 8))
    want = np.asarray(ref._unpack_bits(jnp.asarray(packed), n))
    xt = port.unpack_rows_t(torch.from_numpy(packed), n)
    assert xt.dtype == torch.int8
    assert xt.shape == (-(-n // 128) * 128, 128)
    np.testing.assert_array_equal(xt[:n, :37].T.numpy(), want)
    assert not xt[n:].any() and not xt[:, 37:].any()


def test_unpack_counts_mode_and_its_checks():
    rng = np.random.default_rng(1)
    counts = _rows(rng, 5, 13, top=4, density=0.6)
    xt = port.unpack_rows_t(torch.from_numpy(counts), 13, counts=True)
    np.testing.assert_array_equal(xt[:13, :5].T.numpy(), counts)
    too_big = counts.copy()
    too_big[0, 0] = 128
    with pytest.raises(ValueError, match="int8"):
        port.unpack_rows_t(torch.from_numpy(too_big), 13, counts=True)
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        port.unpack_rows_t(torch.from_numpy(counts), 13)


def test_dense_updates_match_reference_kernels():
    """``dense_update`` / ``dense_update_counts`` add what the reference's
    ``_dense_update`` / ``_dense_update_counts`` add, onto a nonzero G."""
    rng = np.random.default_rng(2)
    n = 21
    G0 = rng.integers(0, 50, (n, n)).astype(np.int32)
    bits, counts = _rows(rng, 40, n), _rows(rng, 40, n, top=3)
    want = np.asarray(ref._dense_update(
        jnp.asarray(G0[None]), jnp.asarray(np.packbits(bits, axis=-1)[None]), np.int8, n
    ))[0]
    G = torch.from_numpy(G0.copy())
    port.dense_update(G, torch.from_numpy(np.packbits(bits, axis=-1)), n)
    np.testing.assert_array_equal(G.numpy(), want)
    want = np.asarray(ref._dense_update_counts(
        jnp.asarray(G0[None]), jnp.asarray(counts[None]), np.int8
    ))[0]
    G = torch.from_numpy(G0.copy())
    port.dense_update_counts(G, torch.from_numpy(counts))
    np.testing.assert_array_equal(G.numpy(), want)


@pytest.mark.parametrize(
    "case, block, n_rows, top, depth",
    [
        ("packed", 16, 64, 1, None),
        ("counts", 16, 64, 3, None),
        ("ragged tail", 16, 71, 1, None),
        ("pipeline depth 2", 16, 83, 2, 2),
        ("block not a multiple of the tiling", 100, 250, 1, None),
    ],
)
def test_accumulator_matches_reference(case, block, n_rows, top, depth):
    """The same rows, fed in uneven batches, give the reference's Gramian
    entry for entry."""
    rng = np.random.default_rng(len(case))
    n = 29
    rows = _rows(rng, n_rows, n, top=top)
    ref_acc = ref.GramianAccumulator(n, block_size=block, pipeline_depth=depth)
    acc = port.GramianAccumulator(n, device="cpu", block_size=block, pipeline_depth=depth)
    for lo, hi in ((0, 5), (5, 40), (40, n_rows)):
        ref_acc.add_rows(rows[lo:hi])
        acc.add_rows(rows[lo:hi])
    got = acc.finalize()
    np.testing.assert_array_equal(got, ref_acc.finalize())
    np.testing.assert_array_equal(got, port.gramian_reference(rows))
    assert acc.finalize_device().dtype == torch.int32
    assert acc.rows_seen == ref_acc.rows_seen == n_rows


@pytest.mark.parametrize("duplicates", [False, True])
def test_accumulate_index_rows_matches_reference(duplicates):
    """Index rows with repeated columns: membership bits by default, k²
    per entry with ``accumulate_duplicates`` (a set joined with itself)."""
    rng = np.random.default_rng(7)
    n = 17
    call_rows = [
        list(rng.integers(0, n, rng.integers(1, 6))) * (2 if i % 3 == 0 else 1)
        for i in range(90)
    ]
    ref_acc = ref.GramianAccumulator(n, block_size=32)
    ref.accumulate_index_rows(ref_acc, iter(call_rows), n, 32, accumulate_duplicates=duplicates)
    acc = port.GramianAccumulator(n, device="cpu", block_size=32)
    port.accumulate_index_rows(acc, iter(call_rows), n, 32, accumulate_duplicates=duplicates)
    got = acc.finalize()
    np.testing.assert_array_equal(got, ref_acc.finalize())
    if duplicates:
        pairs = np.zeros((n, n), dtype=np.int64)
        for row in call_rows:
            idx = np.asarray(row)
            np.add.at(pairs, np.ix_(idx, idx), 1)
        np.testing.assert_array_equal(got, pairs)


@pytest.mark.parametrize("n", [2504, 25_000, 40_000])
def test_dense_strategy_rule_matches_reference_on_the_cpu(n):
    assert port.per_device_memory_bytes("cpu") == ref.per_device_memory_bytes()
    assert port.dense_strategy_fits(n) == ref.dense_strategy_fits(n)


def test_accumulator_telemetry_and_int32_guard():
    registry, spans = MetricsRegistry(), SpanRecorder()
    acc = port.GramianAccumulator(9, device="cpu", block_size=4, registry=registry, spans=spans)
    acc.add_rows(np.ones((10, 9), dtype=np.uint8))
    G = acc.finalize_device()
    assert int(G[0, 0]) == 10
    assert registry.value("gramian_flushes_total") == 3
    assert registry.value("gramian_rows_total") == 10
    assert [s["path"] for s in spans.flat()] == ["dispatch", "reduce-flush"]
    acc._entry_bound = (1 << 31) - 1
    acc.add_rows(np.ones((1, 9), dtype=np.uint8))
    with pytest.raises(OverflowError):
        acc.finalize_device()


def test_plain_product_of_an_unpacked_block():
    """The unpacked Xᵀ feeds PR 1's product unchanged: padding adds nothing."""
    rng = np.random.default_rng(4)
    bits = _rows(rng, 50, 130)
    G = torch.zeros((130, 130), dtype=torch.int32)
    gram_accumulate_plain(G, port.unpack_rows_t(torch.from_numpy(np.packbits(bits, axis=-1)), 130))
    np.testing.assert_array_equal(G.numpy(), port.gramian_reference(bits))
