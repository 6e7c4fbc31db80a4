"""The port's synthetic source is the JAX package's, value for value: the same
seed gives the same cohort, grid and threshold plans in both packages."""

import numpy as np
import pytest

from spark_examples_tpu.sharding.contig import Contig as RefContig
from spark_examples_tpu.sources.synthetic import SyntheticGenomicsSource as RefSource
from spark_examples_tpu_torch.sharding.contig import Contig
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource

SETS = ["vs-a", "10473108253681171589"]
CONTIGS = [("17", 41_196_311, 41_206_311), ("2", 10_000, 37_000), ("1", 0, 4_321)]


def _pair(seed, **kw):
    return RefSource(seed=seed, **kw), SyntheticGenomicsSource(seed=seed, **kw)


@pytest.mark.parametrize("seed", [5, 42])
def test_callsets_keys_and_populations(seed):
    ref, port = _pair(seed, num_samples=24, cohort_sizes={"vs-a": 7})
    assert port.search_callsets(SETS + SETS[:1]) == ref.search_callsets(SETS + SETS[:1])
    assert port.site_key == ref.site_key
    for vs in SETS:
        assert port.genotype_stream_key(vs) == ref.genotype_stream_key(vs)
        np.testing.assert_array_equal(port.populations_for(vs), ref.populations_for(vs))
    np.testing.assert_array_equal(port.populations, ref.populations)


@pytest.mark.parametrize("seed", [5, 3_000_000_601])
@pytest.mark.parametrize(
    "num_samples, sets, cohort_sizes",
    [
        (1, SETS, None),
        (2_504, SETS, None),
        (15_708, SETS[:1], None),
        (24, SETS + SETS[:1] + SETS, {"vs-a": 7}),
    ],
    ids=["one", "1kg", "gnomad2", "repeated-override"],
)
def test_callset_ids_and_names_in_bulk(seed, num_samples, sets, cohort_sizes):
    """The ids and names built a set at a time are the reference's, built a
    sample at a time: every cohort size, two sets with different name tags,
    a repeated set id (its callsets once) and a cohort-size override; asked
    twice, the port answers the same (its keys are kept per set)."""
    ref, port = _pair(seed, num_samples=num_samples, cohort_sizes=cohort_sizes)
    want = ref.search_callsets(sets)
    assert port.search_callsets(sets) == want
    assert port.search_callsets(sets) == want
    assert len(want) == sum(port.num_samples_for(vs) for vs in dict.fromkeys(sets))
    assert len({cs["name"][:3] for cs in want}) == len(set(sets))
    for vs in dict.fromkeys(sets):
        for i in (0, port.num_samples_for(vs) - 1):
            assert port.callset_id(vs, i) == ref.callset_id(vs, i)
            assert port.callset_name(vs, i) == ref.callset_name(vs, i)


@pytest.mark.parametrize("seed", [5, 3_000_000_601])
def test_variant_json_records(seed):
    """Whole wire records, ``callSetName`` of every call included, at a
    variant site and at a reference block, for two sets (one overridden)."""
    ref, port = _pair(seed, num_samples=40, cohort_sizes={"vs-a": 9})
    positions = port._site_positions(41_196_311, 41_198_311)
    blocks = port._site_fields("vs-a", positions)[0]
    picked = [int(positions[~blocks][0]), int(positions[blocks][0])]
    for vs in SETS:
        for pos in picked:
            got = port.variant_json(vs, "17", pos)
            assert got == ref.variant_json(vs, "17", pos)
            assert [c["callSetName"] for c in got["calls"]] == [
                ref.callset_name(vs, i) for i in range(ref.num_samples_for(vs))
            ]


@pytest.mark.parametrize("seed", [5, 42])
@pytest.mark.parametrize("contig", CONTIGS)
def test_grid_ranges_and_page_accounting(seed, contig):
    ref, port = _pair(seed, num_samples=12)
    assert port.site_grid_range(Contig(*contig)) == ref.site_grid_range(RefContig(*contig))
    assert port.page_requests(Contig(*contig), 5000) == ref.page_requests(RefContig(*contig), 5000)
    assert [c.range for c in Contig(*contig).get_shards(3000)] == [
        c.range for c in RefContig(*contig).get_shards(3000)
    ]


@pytest.mark.parametrize("seed", [5, 42])
@pytest.mark.parametrize("min_af", [None, 0.15])
def test_threshold_plans(seed, min_af):
    ref, port = _pair(seed, num_samples=12)
    for contig in CONTIGS:
        got = list(port.site_threshold_plan(Contig(*contig), min_af, chunk_sites=64))
        want = list(ref.site_threshold_plan(RefContig(*contig), min_af, chunk_sites=64))
        assert len(got) == len(want)
        for (gp, gt), (wp, wt) in zip(got, want):
            np.testing.assert_array_equal(gp, wp)
            np.testing.assert_array_equal(gt, wt)


@pytest.mark.parametrize("seed", [5, 42])
@pytest.mark.parametrize("min_af", [None, 0.15])
def test_genotype_blocks(seed, min_af):
    ref, port = _pair(seed, num_samples=20, cohort_sizes={"vs-a": 9})
    for vs in SETS:
        for contig in CONTIGS:
            got = list(port.genotype_blocks(vs, Contig(*contig), 128, min_af))
            want = list(ref.genotype_blocks(vs, RefContig(*contig), 128, min_af))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for key in g:
                    np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("bases", [1_000, 4_096, 1_000_000])
def test_variants_partitions(bases):
    from spark_examples_tpu.sharding.partitioners import VariantsPartitioner as RefPartitioner
    from spark_examples_tpu_torch.sharding.partitioners import VariantsPartitioner

    got = VariantsPartitioner([Contig(*c) for c in CONTIGS], bases).get_partitions("vs")
    want = RefPartitioner([RefContig(*c) for c in CONTIGS], bases).get_partitions("vs")
    assert [(p.index, p.range, p.get_variants_request()) for p in got] == [
        (p.index, p.range, p.get_variants_request()) for p in want
    ]
