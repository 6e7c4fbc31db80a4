"""The samples-sharded ring and the data axis of the port against the JAX
package, on CPU positions: ``pack_rows_t`` and ``cross_accumulate``'s plain
versions, the host-fed ``ShardedGramianAccumulator`` and the
device-generation ``DeviceGenRingGramianAccumulator`` at 2, 4 and 8
positions in both wire formats and both schedules, the dense accumulators'
data axis, and ``data_axis_sum``'s dtype.

Gramians, counters, ring bytes and ``schedule`` blocks are integers in both
packages, so they must be equal, with no tolerance. The JAX side runs on
the conftest's eight virtual CPU devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.ops import devicegen as ref_dg
from spark_examples_tpu.ops import gramian as ref_gm
from spark_examples_tpu.parallel import mesh as ref_mesh
from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource
from spark_examples_tpu_torch.ops import devicegen as dg
from spark_examples_tpu_torch.ops import gramian as gm
from spark_examples_tpu_torch.parallel import mesh as port_mesh

CPU = torch.device("cpu")


def _meshes(data, samples):
    shape = {"data": data, "samples": samples}
    return (ref_mesh.make_mesh(shape, jax.devices()),
            port_mesh.make_mesh(shape, [CPU] * (data * samples)))


@pytest.mark.parametrize("columns", [8, 16, 632, 6256])
def test_pack_rows_t_plain_equals_pack_bits_device_and_packbits(columns):
    rng = np.random.default_rng(columns)
    rows = 300
    bits = (rng.random((rows, columns)) < 0.4).astype(np.uint8)
    want = np.asarray(ref_gm._pack_bits_device(jnp.asarray(bits)))
    assert np.array_equal(want, np.packbits(bits, axis=-1))
    xt = torch.zeros((-(-columns // 128) * 128, 384), dtype=torch.int8)
    xt[:columns, :rows] = torch.from_numpy(bits.T.astype(np.int8))
    got = gm.pack_rows_t(xt, columns, rows)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # The exact inverse of the unpack.
    assert torch.equal(gm.unpack_rows_t(got, columns)[:columns, :rows], xt[:columns, :rows])
    with pytest.raises(ValueError, match="multiple of 8"):
        gm.pack_rows_t(xt, columns - 1 if columns > 8 else 7, rows)


@pytest.mark.parametrize("m,n,sites", [(13, 130, 128), (632, 632, 256), (130, 13, 384)])
def test_cross_accumulate_plain_equals_a_float64_product(m, n, sites):
    rng = np.random.default_rng(m * n)
    a = (rng.random((-(-m // 128) * 128, sites)) < 0.5).astype(np.int8)
    b = (rng.random((-(-n // 128) * 128, sites)) < 0.5).astype(np.int8)
    tile = rng.integers(-50, 50, (m, 3 * n + 5), dtype=np.int32)
    C = torch.from_numpy(tile.copy())
    dg.cross_accumulate(C[:, n : 2 * n], torch.from_numpy(a), torch.from_numpy(b))
    want = tile.astype(np.float64)
    want[:, n : 2 * n] += a[:m].astype(np.float64) @ b[:n].astype(np.float64).T
    assert np.array_equal(C.numpy(), want.astype(np.int32))
    assert dg.cross_accumulate.launches == 0


def test_data_axis_sum_dtype_equals_the_reference():
    for D in (1, 2, 4):
        for dtype in (np.int32, np.float32):
            stack = np.arange(D * 9, dtype=dtype).reshape(D, 3, 3)
            want = np.asarray(ref_gm.data_axis_sum(jnp.asarray(stack)))
            got = gm.data_axis_sum(list(torch.from_numpy(stack)))
            assert str(got.dtype).split(".")[-1] == want.dtype.name
            assert np.array_equal(got.numpy(), want)


def _host_rows(rng, rows, n, counts_at=None):
    X = (rng.random((rows, n)) < 0.35).astype(np.uint8)
    if counts_at is not None:
        X[counts_at] *= 2  # a same-set join's counts: that flush cannot pack
    return X


SHARDED_CASES = [
    (1, 2, "on", "flat"), (1, 2, "off", "flat"), (1, 4, "on", "flat"), (1, 4, "off", "hier"),
    (1, 4, "on", "hier"), (2, 2, "on", "flat"), (2, 4, "on", "hier"), (1, 8, "on", "flat"),
    (1, 8, "off", "flat"), (4, 2, "off", "flat"),
]


@pytest.mark.parametrize("data,samples,pack,schedule", SHARDED_CASES)
def test_sharded_accumulator_equals_the_reference(data, samples, pack, schedule, monkeypatch):
    """Host-fed rows through the ring, a count-valued flush among packed
    ones (it falls back to the unpacked wire for that flush): the Gramian,
    the accounted ring bytes and the ``schedule`` block equal the
    reference's."""
    monkeypatch.setenv(ref_mesh.HIER_HOSTS_ENV, "2" if schedule == "hier" else "1")
    rng = np.random.default_rng(data * 10 + samples)
    n = 37
    X = _host_rows(rng, 150, n, counts_at=slice(40, 45))
    ref_m, port_m = _meshes(data, samples)
    kw = dict(block_size=16, pack_bits=pack, reduce_schedule=schedule)
    # The reference's exact path (int8 operands, int32 tiles): the port's.
    ref_acc = ref_gm.ShardedGramianAccumulator(n, ref_m, exact_int=True, **kw)
    acc = gm.ShardedGramianAccumulator(n, port_m, **kw)
    for a in (ref_acc, acc):
        a.add_rows(X[:70])
        a.add_rows(X[70:])
    assert acc.reduce_schedule == ref_acc.reduce_schedule == schedule
    assert (acc.padded, acc.n_local) == (ref_acc._padded, ref_acc.n_local)
    got, want = acc.finalize(), ref_acc.finalize()
    assert np.array_equal(got, want) and np.array_equal(got, gm.gramian_reference(X))
    assert acc.ring_bytes_total == ref_acc.ring_bytes_total
    assert acc.schedule_block() == ref_acc.schedule_block()
    tiles = acc.finalize_sharded()
    assert tiles.dtype == (torch.int64 if data > 1 else torch.int32)
    assert str(np.asarray(ref_acc.finalize_sharded()).dtype) == ("int64" if data > 1 else "int32")


def _source():
    return SyntheticGenomicsSource(num_samples=23, seed=9, cohort_sizes={"b": 11})


def _ring_kwargs(source, sets, asymmetric):
    kw = dict(
        pops=source.populations, site_key=source.site_key, spacing=source.variant_spacing,
        ref_block_fraction=source.ref_block_fraction, n_pops=source.n_pops,
        block_size=64, blocks_per_dispatch=8, min_af_micro=None,
    )
    if asymmetric:
        kw.update(set_sizes=[source.num_samples_for(v) for v in sets],
                  pops_per_set=[source.populations_for(v) for v in sets])
    return kw


RING_CASES = [
    ((1, 2), "on", "flat", ("a",)), ((1, 2), "off", "flat", ("a",)),
    ((1, 4), "on", "flat", ("a",)), ((1, 4), "off", "hier", ("a",)),
    ((1, 4), "on", "hier", ("a", "b")), ((2, 2), "on", "flat", ("a", "b")),
    ((1, 8), "on", "flat", ("a",)), ((1, 8), "off", "hier", ("a", "b")),
    ((2, 4), "on", "hier", ("a",)), ((1, 4), "on", "flat", ("a", "c")),
]


@pytest.mark.parametrize("shape,pack,schedule,sets", RING_CASES)
def test_device_gen_ring_equals_the_reference(shape, pack, schedule, sets, monkeypatch):
    """On-device generation through the ring, a sharded cohort of 23
    columns (an asymmetric second set of 11, or a symmetric second set):
    the Gramian, both counters (a site counts for a set once, whichever
    positions its columns vary on), ring bytes, the ``schedule`` block and
    the dispatch accounting equal the reference's, over a grid range with
    full groups and a tail."""
    monkeypatch.setenv(ref_mesh.HIER_HOSTS_ENV, "2" if schedule == "hier" else "1")
    source = _source()
    asymmetric = "b" in sets
    keys = [source.genotype_stream_key(v) for v in sets]
    vs_key = keys if len(sets) > 1 else keys[0]
    ref_m, port_m = _meshes(*shape)
    kw = _ring_kwargs(source, sets, asymmetric)
    ref_acc = ref_dg.DeviceGenRingGramianAccumulator(
        23, vs_key, mesh=ref_m, pack_bits=pack, reduce_schedule=schedule, **kw)
    acc = dg.DeviceGenRingGramianAccumulator(
        23, vs_key, mesh=port_m, pack_bits=pack, reduce_schedule=schedule, **kw)
    for a in (ref_acc, acc):
        a.add_grid(1000, 1000 + 1500)
        a.add_grid(5000, 5300)
    assert np.array_equal(acc.finalize(), ref_acc.finalize())
    (rows, kept), (want_rows, want_kept) = acc.ingest_counters(), ref_acc.ingest_counters()
    assert rows.tolist() == np.asarray(want_rows).tolist() and kept == want_kept
    assert acc.ring_bytes_total == ref_acc.ring_bytes_total
    assert acc.schedule_block() == ref_acc.schedule_block()
    assert (acc.dispatches, acc.sites_capacity, acc.sites_valid) == (
        ref_acc.dispatches, ref_acc.sites_capacity, ref_acc.sites_valid)


def test_ring_refuses_a_mesh_without_a_samples_axis_and_hier_that_does_not_divide(monkeypatch):
    source = _source()
    kw = _ring_kwargs(source, ("a",), False)
    with pytest.raises(ValueError, match="samples axis >= 2"):
        dg.DeviceGenRingGramianAccumulator(23, 1, mesh=port_mesh.make_mesh({"data": 2, "samples": 1}, [CPU] * 2), **kw)
    monkeypatch.setenv(ref_mesh.HIER_HOSTS_ENV, "3")
    mesh = port_mesh.make_mesh({"data": 1, "samples": 4}, [CPU] * 4)
    with pytest.raises(ValueError, match="divide the samples axis"):
        gm.ShardedGramianAccumulator(23, mesh, reduce_schedule="hier")
    assert gm.ShardedGramianAccumulator(23, mesh).reduce_schedule == "flat"


@pytest.mark.parametrize("data", [2, 4])
def test_dense_data_axis_equals_the_reference(data):
    """The dense strategy's data axis: host-fed and device generation,
    each slice a span of its own; the int64 sum and the dispatch
    accounting equal the reference's."""
    rng = np.random.default_rng(data)
    X = _host_rows(rng, 130, 29)
    ref_m, port_m = _meshes(data, 1)
    ref_acc = ref_gm.GramianAccumulator(29, ref_m, block_size=16, exact_int=True)
    acc = gm.GramianAccumulator(29, mesh=port_m, block_size=16)
    for a in (ref_acc, acc):
        a.add_rows(X)
    got = acc.finalize_device()
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(ref_acc.finalize_device()))

    source = _source()
    kw = dict(pops=source.populations, site_key=source.site_key, spacing=source.variant_spacing,
              ref_block_fraction=source.ref_block_fraction, n_pops=source.n_pops,
              block_size=64, blocks_per_dispatch=8)
    keys = [source.genotype_stream_key("a")]
    ref_dense = ref_dg.DeviceGenGramianAccumulator(23, keys, mesh=ref_m, **kw)
    dense = dg.DeviceGenGramianAccumulator(23, keys, mesh=port_m, **kw)
    for a in (ref_dense, dense):
        a.add_grid(0, 3000)
        a.add_range(9000, 100)
    assert np.array_equal(dense.finalize(), ref_dense.finalize())
    assert dense.finalize_device().dtype == torch.int64
    (rows, kept), (want_rows, want_kept) = dense.ingest_counters(), ref_dense.ingest_counters()
    assert rows.tolist() == np.asarray(want_rows).tolist() and kept == want_kept
    assert (dense.dispatches, dense.sites_capacity, dense.sites_valid) == (
        ref_dense.dispatches, ref_dense.sites_capacity, ref_dense.sites_valid)


@pytest.mark.parametrize("lo,hi", [(0, 23), (5, 17), (20, 34), (23, 34)])
def test_generation_on_a_cut_plan_equals_generate_column_block(lo, hi):
    """``gen_genotypes`` (plain) on the tables cut to columns [lo, hi) gives
    the reference's ``generate_column_block`` of those columns of the
    two-set cohort (23 + 11 columns)."""
    source = _source()
    sets = ("a", "b")
    plan = dg.make_gen_plan(
        [source.genotype_stream_key(v) for v in sets], [source.populations_for(v) for v in sets],
        source.site_key, source.variant_spacing, source.ref_block_fraction, None, source.n_pops, CPU,
    )
    cut = dg.slice_gen_plan(plan, lo, hi)
    kept, rows = torch.zeros((), dtype=torch.int64), torch.zeros((2,), dtype=torch.int64)
    xt = dg.gen_genotypes(cut, 700, 200, 256, kept, rows)
    positions = (700 + np.arange(256, dtype=np.int64)) * source.variant_spacing
    with jax.enable_x64(True):
        T = ref_dg.site_thresholds_on_device(
            jnp.asarray(np.uint64(source.site_key)), jnp.asarray(positions),
            jnp.asarray(np.arange(256) < 200), source.n_pops, source.ref_block_fraction, None)
        pops = np.concatenate([source.populations_for(v) for v in sets]).astype(np.int32)
        want = ref_dg.generate_column_block(
            jnp.asarray(positions), T,
            jnp.asarray(np.array([source.genotype_stream_key(v) for v in sets], dtype=np.uint64)),
            jnp.asarray(pops[lo:hi]), jnp.int64(lo), 34, (23, 11))
    assert np.array_equal(xt[: hi - lo, :256].numpy().T, np.asarray(want).astype(np.int8))
    assert int(kept) == int(np.asarray(jnp.any(T > 0, axis=1).sum()))


@pytest.mark.parametrize("strategy", ["dense", "sharded"])
def test_snapshot_and_restore_on_a_mesh_leave_the_gramian_exact(strategy):
    """A data-axis (dense) or ring (sharded) accumulator snapshots as the
    reference's ``(data, padded, padded)`` stack; a fresh accumulator on
    the same mesh restores it, takes the rest of the rows, and finishes
    with the uninterrupted Gramian."""
    rng = np.random.default_rng(11)
    X = _host_rows(rng, 120, 19)
    shape = (2, 1) if strategy == "dense" else (2, 2)
    _, mesh = _meshes(*shape)

    def fresh():
        if strategy == "dense":
            return gm.GramianAccumulator(19, mesh=mesh, block_size=16)
        return gm.ShardedGramianAccumulator(19, mesh, block_size=16)

    first = fresh()
    first.add_rows(X[:70])
    state = first.snapshot_state()
    assert state["G"].shape[0] == 2 and state["strategy"] == strategy
    resumed = fresh()
    resumed.restore_state({"meta": {k: v for k, v in state.items() if k != "G"}, "G": state["G"]})
    resumed.add_rows(X[70:])
    assert np.array_equal(resumed.finalize(), gm.gramian_reference(X))
