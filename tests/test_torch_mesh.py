"""The port's mesh (``spark_examples_tpu_torch/parallel/mesh.py``) against
the JAX package's ``parallel/mesh.py``: the cohort padding, ring traffic,
topology and schedule arithmetic over a grid of cohorts, positions and pack
settings (integers, so equal), the mesh rules and their errors, and the
packed host fetch, which must return each counter once.

The JAX side runs on the conftest's eight virtual CPU devices; the port's
positions are CPU positions."""

import re

import numpy as np
import pytest
import torch

from spark_examples_tpu.parallel import mesh as ref
from spark_examples_tpu_torch.parallel import collectives
from spark_examples_tpu_torch.parallel import mesh as port

CPU = torch.device("cpu")
COHORTS = (1, 7, 8, 13, 100, 2504, 25_000)
SAMPLES = (1, 2, 3, 4, 8)


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("samples", SAMPLES)
def test_padded_cohort_and_ring_bytes_equal_the_reference(samples, pack):
    for n in COHORTS:
        padded = port.padded_cohort(n, samples, pack)
        assert padded == ref.padded_cohort(n, samples, pack)
        n_local = padded // samples
        for rows in (0, 1, 1024, 16_384 * 3):
            assert port.ring_traffic_bytes(rows, samples, n_local, pack) == ref.ring_traffic_bytes(
                rows, samples, n_local, pack
            )


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("hosts,per_host", [(1, 4), (2, 2), (2, 4), (4, 2), (32, 8)])
def test_level_traffic_equals_the_reference(hosts, per_host, pack):
    n_local = port.padded_cohort(2504, hosts * per_host, pack) // (hosts * per_host)
    for rows in (1, 16_384):
        got = port.hierarchical_traffic_bytes(rows, hosts, per_host, n_local, pack)
        want = ref.hierarchical_traffic_bytes(rows, hosts, per_host, n_local, pack)
        assert tuple(got) == tuple(want) and got.total == want.total
        assert got.total == port.ring_traffic_bytes(rows, hosts * per_host, n_local, pack)
        split = port.flat_traffic_split(rows, port.Topology(hosts, per_host), n_local, pack)
        assert tuple(split) == tuple(
            ref.flat_traffic_split(rows, ref.Topology(hosts, per_host), n_local, pack)
        )


def test_topology_and_schedule_rules_equal_the_reference():
    for spec in ("32,8", "1,4", "2, 2"):
        got, want = port.parse_topology(spec), ref.parse_topology(spec)
        assert (got.hosts, got.devices_per_host, got.devices, got.describe()) == (
            want.hosts, want.devices_per_host, want.devices, want.describe())
    for bad in ("8", "a,b", "0,4"):
        with pytest.raises(ValueError):
            ref.parse_topology(bad)
        with pytest.raises(ValueError):
            port.parse_topology(bad)
    for spec in ("auto", "flat", "hier"):
        for hosts in (1, 2):
            assert port.resolve_reduce_schedule(spec, hosts) == ref.resolve_reduce_schedule(spec, hosts)
    with pytest.raises(ValueError, match="auto/flat/hier"):
        port.resolve_reduce_schedule("ring", 1)


def test_hier_hosts_follow_the_override_and_divide_the_axis(monkeypatch):
    monkeypatch.delenv(port.HIER_HOSTS_ENV, raising=False)
    assert port.resolve_hier_hosts(4) == ref.resolve_hier_hosts(4) == 1
    monkeypatch.setenv(port.HIER_HOSTS_ENV, "2")
    assert port.resolve_hier_hosts(4) == ref.resolve_hier_hosts(4) == 2
    assert port.resolve_hier_hosts(8, 4) == ref.resolve_hier_hosts(8, 4) == 4
    for fn in (port.resolve_hier_hosts, ref.resolve_hier_hosts):
        with pytest.raises(ValueError, match=re.escape("host factor (2) to divide the samples axis (3)")):
            fn(3)


@pytest.mark.parametrize("spec", ["1,4", "2,2", "4,1", "4", "8,1"])
def test_mesh_shapes_and_position_order_follow_the_reference(spec):
    shape = port.parse_mesh_shape(spec)
    assert shape == ref.parse_mesh_shape(spec)
    import jax

    want = ref.make_mesh(shape, jax.devices())
    got = port.make_mesh(shape, [torch.device("cpu")] * 8)
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    assert np.array_equal(np.vectorize(lambda p: p.index)(got.positions), ids - ids.min())


def test_mesh_errors_are_the_reference_words():
    import jax

    for fn, devices in ((ref.make_mesh, jax.devices()[:2]), (port.make_mesh, [CPU, CPU])):
        with pytest.raises(ValueError, match=re.escape("mesh shape {'data': 1, 'samples': 4} needs 4 devices, have 2")):
            fn({"data": 1, "samples": 4}, devices)
    with pytest.raises(ValueError, match="--mesh-shape expects 'data,samples'"):
        port.parse_mesh_shape("1,2,3")


def test_run_mesh_rule_equals_the_reference():
    import jax

    devices = jax.devices()
    positions = [CPU] * len(devices)
    for nrp in (1, 3, 10):
        want = ref.resolve_run_mesh(None, nrp, devices)
        got = port.resolve_run_mesh(None, nrp, positions)
        assert got.shape == dict(want.shape)
    assert port.resolve_run_mesh(None, 10, [CPU]) is None
    assert ref.resolve_run_mesh(None, 10, devices[:1]) is None
    # One CPU device stands for as many positions as the shape asks for.
    assert port.resolve_run_mesh("2,2", 10, [CPU]).shape == {"data": 2, "samples": 2}
    mesh = port.default_mesh(2, samples_axis=2, devices=positions)
    assert mesh.shape == dict(ref.default_mesh(2, samples_axis=2, devices=devices).shape)


def test_hierarchical_mesh_keeps_the_positions_in_order():
    import jax

    mesh = port.make_mesh({"data": 2, "samples": 4}, [CPU] * 8)
    hier = port.hierarchical_mesh(mesh, 2)
    want = ref.hierarchical_mesh(ref.make_mesh({"data": 2, "samples": 4}, jax.devices()), 2)
    assert hier.shape == dict(want.shape)
    assert [p.index for p in hier.flat()] == [p.index for p in mesh.flat()]
    assert [[p.index for p in ring] for ring in hier.data_slices()] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="does not divide"):
        port.hierarchical_mesh(mesh, 3)


def test_packed_host_fetch_returns_each_counter_once():
    """Values given as their shards in position order come back
    concatenated once each, in one flat array (the reference's fetch once
    summed a replicated counter over the samples axis)."""
    rows = [torch.tensor([3, 4]), torch.tensor([5, 6])]  # two data slices' (n_sets,)
    kept = [torch.tensor(10), torch.tensor(20)]
    flat = port.packed_host_fetch([rows, kept])
    assert flat.tolist() == [3, 4, 5, 6, 10, 20]
    assert port.packed_host_fetch([torch.tensor([1.5, 2.5]), torch.tensor(3)]).tolist() == [1.5, 2.5, 3.0]


def test_collectives_on_cpu_positions():
    positions = port.make_mesh({"samples": 4}, [CPU] * 4).flat()
    tiles = [torch.full((2,), p) for p in range(4)]
    got, events = collectives.ring_shift(tiles, [None] * 4, positions, [1, 2, 3, 0])
    assert [int(t[0]) for t in got] == [1, 2, 3, 0] and events == [None] * 4
    assert all(g.data_ptr() != t.data_ptr() for g, t in zip(got, tiles[1:] + tiles[:1]))
    assert [int(t.sum()) for t in collectives.all_reduce_sum(tiles)] == [12] * 4
    gathered = collectives.all_gather_rows([torch.full((1, 2), p) for p in range(3)])
    assert gathered[0].tolist() == [[0, 0], [1, 1], [2, 2]]


@pytest.mark.parametrize("mesh_shape", [None, "4,2", "2,1", "1,4"])
def test_host_bound_with_the_data_axis_equals_the_reference(mesh_shape):
    from spark_examples_tpu.check.hostmem import conf_host_peak_bytes as ref_bound
    from spark_examples_tpu.config import PcaConf as RefConf
    from spark_examples_tpu_torch.check.hostmem import conf_host_peak_bytes
    from spark_examples_tpu_torch.config import PcaConf

    argv = ["--num-samples", "2504", "--ingest", "packed", "--block-size", "4096"]
    if mesh_shape:
        argv += ["--mesh-shape", mesh_shape]
    for devices in (1, 8):
        want = ref_bound(RefConf.parse(argv), device_count=devices, num_hosts=1)
        got = conf_host_peak_bytes(PcaConf.parse(argv + ["--device", "cpu"]), device_count=devices,
                                   num_hosts=1, baseline_bytes=port.HOST_RUNTIME_BASELINE_BYTES)
        assert got == want
