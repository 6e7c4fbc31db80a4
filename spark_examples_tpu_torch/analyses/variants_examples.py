"""Variant-counting example analyses: the port's copy of
``spark_examples_tpu/analyses/variants_examples.py``.

``SearchVariantsExampleKlotho`` (``SearchVariantsExample.scala:39-82``) and
``SearchVariantsExampleBRCA1`` (``SearchVariantsExample.scala:87-112``):
count overlapping records, split variant records from reference-matching
blocks, and (Klotho) exercise the wire-format round trip
(``models/variant.py:Variant.to_json``). Host-only in both packages: the
records are counted as they stream, no device program runs.
"""

from __future__ import annotations

from typing import List

from spark_examples_tpu_torch.config import GenomicsConf
from spark_examples_tpu_torch.constants import GoogleGenomicsPublicData
from spark_examples_tpu_torch.pipeline.datasets import VariantsDataset
from spark_examples_tpu_torch.sharding.contig import Contig
from spark_examples_tpu_torch.sharding.partitioners import VariantsPartitioner
from spark_examples_tpu_torch.sources.base import GenomicsSource

#: rs9536314, Klotho KL F327V (``SearchVariantsExample.scala:34-38,45``).
KLOTHO_CONTIG = Contig("chr13", 33628137, 33628138)
#: BRCA1 gene range (``SearchVariantsExample.scala:93``).
BRCA1_CONTIG = Contig("chr17", 41196311, 41277499)


def _dataset(
    conf: GenomicsConf, source: GenomicsSource, contig: Contig
) -> VariantsDataset:
    partitioner = VariantsPartitioner([contig], conf.bases_per_partition)
    variant_set_id = (
        conf.variant_set_id[0]
        if conf.variant_set_id
        else GoogleGenomicsPublicData.PLATINUM_GENOMES
    )
    return VariantsDataset(source, variant_set_id, partitioner)


def run_klotho(
    conf: GenomicsConf,
    source: GenomicsSource,
    contig: Contig = KLOTHO_CONTIG,
) -> List[str]:
    """``SearchVariantsExampleKlotho.main`` (``SearchVariantsExample.scala:40-81``)."""
    records = list(_dataset(conf, source, contig))
    variants = [v for _, v in records]
    out = []
    out.append(f"We have {len(records)} records that overlap Klotho.")
    n_variant = sum(1 for v in variants if v.alternate_bases is not None)
    out.append(f"But only {n_variant} records are of a variant.")
    n_ref = sum(1 for v in variants if v.alternate_bases is None)
    out.append(f"The other {n_ref} records are reference-matching blocks.")
    for v in variants:
        if v.reference_bases != "N":
            out.append(f"Reference: {v.contig} @ {v.start}")
    # Wire-format round trip (the reference's toJavaVariant smoke check,
    # ``SearchVariantsExample.scala:77-79``).
    for v in variants:
        v.to_json()
    for line in out:
        print(line)
    return out


def run_brca1(
    conf: GenomicsConf,
    source: GenomicsSource,
    contig: Contig = BRCA1_CONTIG,
) -> List[str]:
    """``SearchVariantsExampleBRCA1.main`` (``SearchVariantsExample.scala:88-111``)."""
    records = list(_dataset(conf, source, contig))
    variants = [v for _, v in records]
    out = []
    out.append(f"We have {len(records)} records that overlap BRCA1.")
    n_variant = sum(1 for v in variants if v.reference_bases != "N")
    out.append(f"But only {n_variant} records are of a variant.")
    n_ref = sum(1 for v in variants if v.reference_bases == "N")
    out.append(f"The other {n_ref} records are reference-matching blocks.")
    for line in out:
        print(line)
    return out


__all__ = ["run_klotho", "run_brca1", "KLOTHO_CONTIG", "BRCA1_CONTIG"]
