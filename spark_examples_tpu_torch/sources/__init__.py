"""Genomics sources: the synthetic 1000 Genomes cohort (``synthetic.py``)
and local VCF/JSONL files (``files.py``, over the windowed readers of
``stream.py``) behind the client/source interfaces of ``base.py``."""

from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource


def partition_page_requests(
    source, variant_set_id, contig, bases_per_partition: int
) -> int:
    """Wire-equivalent page-request count for ONE shard of one variant set
    (``spark_examples_tpu/sources/__init__.py``). The synthetic source's
    ``page_requests`` takes no set id: one synthetic wire serves every set."""
    if isinstance(source, SyntheticGenomicsSource):
        return source.page_requests(contig, bases_per_partition)
    return source.page_requests(variant_set_id, contig, bases_per_partition)


__all__ = ["SyntheticGenomicsSource", "partition_page_requests"]
