"""Read data model and builder: the port's copy of
``spark_examples_tpu/models/read.py``.

Mirrors the serializable ``Read`` case class and ``ReadBuilder`` at
``rdd/ReadsRDD.scala:38-87``: alignment fields are flattened (position,
reference name, mapping quality pulled out of the nested alignment message)
and the structured CIGAR is re-encoded as a SAM-style string via the
operation→letter map at ``rdd/ReadsRDD.scala:46-55``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ReadKey:
    """Indexes a mapped read to its partition (``rdd/ReadsRDD.scala:133-134``)."""

    sequence: str
    position: int


@dataclass(frozen=True)
class Read:
    """A serializable aligned read (``rdd/ReadsRDD.scala:38-42``)."""

    aligned_quality: Tuple[int, ...]
    cigar: str
    id: str
    mapping_quality: int
    mate_position: Optional[int]
    mate_reference_name: Optional[str]
    fragment_name: str
    aligned_sequence: str
    position: int
    read_group_set_id: str
    reference_name: str
    info: Mapping[str, Sequence[str]] = field(default_factory=dict)
    fragment_length: int = 0


class ReadBuilder:
    """Wire-format dict → ``Read`` (``rdd/ReadsRDD.scala:44-87``)."""

    CIGAR_MATCH = {
        "ALIGNMENT_MATCH": "M",
        "CLIP_HARD": "H",
        "CLIP_SOFT": "S",
        "DELETE": "D",
        "INSERT": "I",
        "PAD": "P",
        "SEQUENCE_MATCH": "=",
        "SEQUENCE_MISMATCH": "X",
        "SKIP": "N",
    }

    @classmethod
    def build(cls, r: Mapping) -> Tuple[ReadKey, Read]:
        alignment = r["alignment"]
        position = alignment["position"]
        read_key = ReadKey(position["referenceName"], int(position["position"]))

        cigar = "".join(
            f"{int(unit['operationLength'])}{cls.CIGAR_MATCH[unit['operation']]}"
            for unit in alignment.get("cigar", [])
        )

        mate = r.get("nextMatePosition")
        read = Read(
            aligned_quality=tuple(int(q) for q in r.get("alignedQuality", [])),
            cigar=cigar,
            id=r.get("id"),
            mapping_quality=int(alignment.get("mappingQuality", 0)),
            mate_position=int(mate["position"]) if mate else None,
            mate_reference_name=mate["referenceName"] if mate else None,
            fragment_name=r.get("fragmentName"),
            aligned_sequence=r.get("alignedSequence", ""),
            position=int(position["position"]),
            read_group_set_id=r.get("readGroupSetId"),
            reference_name=position["referenceName"],
            info=r.get("info", {}),
            fragment_length=int(r.get("fragmentLength", 0)),
        )
        return (read_key, read)


__all__ = ["Read", "ReadKey", "ReadBuilder"]
