"""Variant / Call data model and builder.

Parity notes (reference files cited per field):

- ``Call`` and ``Variant`` mirror the serializable case classes at
  ``rdd/VariantsRDD.scala:43-51``. The reference needed its own copies because
  the Java API model is not serializable; we need plain records because the
  wire format (JSON dicts) must be converted once into cheap, immutable,
  hashable objects before they fan out into host pipelines and device batches.
- ``VariantsBuilder.normalize`` reproduces the regex semantics of
  ``rdd/VariantsRDD.scala:89-96``: reference names are matched against
  ``([a-z]*)?([0-9]*)`` as a FULL match, the numeric group is kept (so
  ``chr17`` → ``17``), and any non-matching contig (``X``, ``Y``,
  ``GL000229.1``, …) is DROPPED by returning ``None``.
- ``VariantsBuilder.build`` reproduces ``rdd/VariantsRDD.scala:98-149``: the
  partition key is ``VariantKey(raw_reference_name, start)`` (the *raw* name,
  not the normalized one), while ``Variant.contig`` holds the normalized name.
- ``Variant.variant_key()`` reproduces the murmur3_128 matching key of
  ``VariantsPca.scala:71-86`` (contig, start, end, referenceBases, joined
  alternateBases — UTF-8 strings and little-endian longs, hex digest).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from spark_examples_tpu_torch.utils.murmur3 import murmur3_x64_128_hex


@dataclass(frozen=True)
class VariantKey:
    """Indexes a variant to its partition (``rdd/VariantsRDD.scala:246``)."""

    contig: str
    position: int


@dataclass(frozen=True)
class Call:
    """One sample's call on a variant (``rdd/VariantsRDD.scala:43-45``)."""

    callset_id: str
    callset_name: str
    genotype: Tuple[int, ...]
    genotype_likelihood: Optional[Tuple[float, ...]] = None
    phaseset: Optional[str] = None
    info: Mapping[str, Sequence[str]] = field(default_factory=dict)

    def has_variation(self) -> bool:
        """True iff any genotype allele is non-reference.

        Mirrors ``call.genotype.foldLeft(false)(_ || _ > 0)``
        (``VariantsPca.scala:67``).
        """
        return any(g > 0 for g in self.genotype)


@dataclass(frozen=True)
class Variant:
    """A serializable variant record (``rdd/VariantsRDD.scala:48-51``)."""

    contig: str
    id: str
    names: Optional[Tuple[str, ...]]
    start: int
    end: int
    reference_bases: str
    alternate_bases: Optional[Tuple[str, ...]]
    info: Mapping[str, Sequence[str]]
    created: int
    variant_set_id: str
    calls: Optional[Tuple[Call, ...]]

    def variant_key(self, debug: bool = False) -> str:
        """Cross-dataset matching key (``VariantsPca.scala:71-86``)."""
        alternate = "".join(self.alternate_bases) if self.alternate_bases else ""
        if debug:
            print(
                f"{self.contig}: ({self.start}, {self.end}) "
                f"ref={self.reference_bases} alt={alternate}"
            )
        payload = (
            self.contig.encode("utf-8")
            + int(self.start).to_bytes(8, "little", signed=True)
            + int(self.end).to_bytes(8, "little", signed=True)
            + self.reference_bases.encode("utf-8")
            + alternate.encode("utf-8")
        )
        return murmur3_x64_128_hex(payload)

    def to_json(self) -> Dict:
        """Back-conversion to the wire format.

        The analog of ``Variant.toJavaVariant`` (``rdd/VariantsRDD.scala:53-83``),
        used by the round-trip smoke check in the Klotho example
        (``SearchVariantsExample.scala:77-79``) and by the checkpoint writer.
        """
        out: Dict = {
            "referenceName": self.contig,
            "created": self.created,
            "variantSetId": self.variant_set_id,
            "id": self.id,
            "info": {k: list(v) for k, v in self.info.items()},
            "start": self.start,
            "end": self.end,
            "referenceBases": self.reference_bases,
        }
        if self.alternate_bases is not None:
            out["alternateBases"] = list(self.alternate_bases)
        if self.names is not None:
            out["names"] = list(self.names)
        if self.calls is not None:
            calls = []
            for c in self.calls:
                call: Dict = {
                    "callSetId": c.callset_id,
                    "callSetName": c.callset_name,
                    "genotype": list(c.genotype),
                    "info": {k: list(v) for k, v in c.info.items()},
                    "phaseset": c.phaseset,
                }
                if c.genotype_likelihood is not None:
                    call["genotypeLikelihood"] = list(c.genotype_likelihood)
                calls.append(call)
            out["calls"] = calls
        return out


class VariantsBuilder:
    """Wire-format dict → ``Variant`` (``rdd/VariantsRDD.scala:87-149``)."""

    _REF_NAME_RE = re.compile(r"([a-z]*)?([0-9]*)")

    @classmethod
    def normalize(cls, reference_name: str) -> Optional[str]:
        """Strip a lowercase prefix, keep digits; drop anything else.

        Full-match semantics of the Scala pattern match on
        ``([a-z]*)?([0-9]*)`` (``rdd/VariantsRDD.scala:89-96``): ``chr17`` →
        ``17``, ``17`` → ``17``, but ``X``/``MT``/``GL000229.1`` → ``None``.
        """
        m = cls._REF_NAME_RE.fullmatch(reference_name)
        if m is None:
            return None
        return m.group(2)

    @classmethod
    def build(cls, r: Mapping) -> Optional[Tuple[VariantKey, Variant]]:
        """Build one variant, or ``None`` for non-normalizable contigs."""
        variant_key = VariantKey(r["referenceName"], int(r["start"]))

        calls: Optional[Tuple[Call, ...]]
        if "calls" in r:
            calls = tuple(
                Call(
                    callset_id=c.get("callSetId"),
                    callset_name=c.get("callSetName"),
                    genotype=tuple(int(g) for g in c.get("genotype", [])),
                    genotype_likelihood=(
                        tuple(float(x) for x in c["genotypeLikelihood"])
                        if "genotypeLikelihood" in c
                        else None
                    ),
                    phaseset=c.get("phaseset"),
                    info=c.get("info", {}),
                )
                for c in r["calls"]
            )
        else:
            calls = None

        reference_name = cls.normalize(r["referenceName"])
        if reference_name is None:
            return None

        variant = Variant(
            contig=reference_name,
            id=r.get("id"),
            names=tuple(r["names"]) if "names" in r else None,
            start=int(r["start"]),
            end=int(r["end"]),
            reference_bases=r.get("referenceBases"),
            alternate_bases=(
                tuple(r["alternateBases"]) if "alternateBases" in r else None
            ),
            info=r.get("info", {}),
            created=int(r.get("created", 0)),
            variant_set_id=r.get("variantSetId"),
            calls=calls,
        )
        return (variant_key, variant)


__all__ = ["Call", "Variant", "VariantKey", "VariantsBuilder"]
