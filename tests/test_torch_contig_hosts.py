"""The host → contig split of host-sharded ingest: the port's
``sharding/contig.py:partition_contigs_by_host`` / ``host_partition``
against the JAX package's, partition for partition."""

import pytest

from spark_examples_tpu.sharding import contig as ref
from spark_examples_tpu_torch.sharding import contig as port


def _contigs(lengths, module):
    return [module.Contig(str(i + 1), 1000, 1000 + n) for i, n in enumerate(lengths)]


def _names(parts):
    return [[(c.reference_name, c.start, c.end) for c in part] for part in parts]


CASES = {
    "equal-four-over-two": ([100] * 4, 2, None),
    "equal-four-over-three": ([100] * 4, 3, None),
    "tie-closes-the-earlier-host": ([50, 50, 100], 2, None),
    "uneven": ([10, 300, 20, 70, 5], 3, None),
    "giant-contig-spans-hosts": ([10, 1000, 10], 4, None),
    "hosts-past-contigs": ([100, 100], 5, None),
    "zero-weights-one-a-host": ([100] * 5, 3, "zero"),
    "some-zero-weights": ([0, 100, 0, 100, 0], 2, "odd-zero"),
    "one-host": ([7, 8, 9], 1, None),
}


def _weight(kind):
    if kind == "zero":
        return lambda c: 0
    if kind == "odd-zero":
        return lambda c: 0 if int(c.reference_name) % 2 else c.range
    return None


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_equals_the_reference(case):
    lengths, hosts, kind = CASES[case]
    got = port.partition_contigs_by_host(_contigs(lengths, port), hosts, _weight(kind))
    want = ref.partition_contigs_by_host(_contigs(lengths, ref), hosts, _weight(kind))
    assert _names(got) == _names(want)
    # A partition of the list, in order.
    assert [c for part in _names(got) for c in part] == _names([_contigs(lengths, port)])[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_partition_is_each_process_slice(case):
    lengths, hosts, kind = CASES[case]
    for index in range(hosts):
        got = port.host_partition(_contigs(lengths, port), index, hosts, _weight(kind))
        want = ref.host_partition(_contigs(lengths, ref), index, hosts, _weight(kind))
        assert _names([got]) == _names([want])


@pytest.mark.parametrize("index, count", [(2, 2), (-1, 2), (0, 0)])
def test_bad_process_index_raises_as_the_reference(index, count):
    for module in (port, ref):
        with pytest.raises(ValueError, match="process_index"):
            module.host_partition(_contigs([1, 2], module), index, count)


def test_bad_host_count_and_negative_weight_raise():
    for module in (port, ref):
        with pytest.raises(ValueError, match="num_hosts"):
            module.partition_contigs_by_host(_contigs([1], module), 0)
        with pytest.raises(ValueError, match="negative declared weight"):
            module.partition_contigs_by_host(_contigs([1], module), 2, lambda c: -1)
