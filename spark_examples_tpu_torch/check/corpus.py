"""The deterministic VCF fuzz corpus.

The port's copy of ``spark_examples_tpu/check/corpus.py``, byte for byte
the same documents for every ``(n_random, seed)``, so a document has the
same index in both packages. Two consumers in the port:

- ``graftcheck sanitize`` (``check/sanitize.py``) replays the documents
  through the ASAN/UBSAN/TSAN builds of the native parser's harness
  (``utils/native.py:build_sanitizer_harness``), checking memory and race
  safety;
- ``tests/test_torch_sanitize.py`` puts the same documents through the
  port's native serial and chunk-parallel parses and its Python parser,
  pinning their semantics over exactly the grammar the sanitizers replay.

The generator is a seeded ``random.Random`` over the reference's VCF
grammar (the adversarial AF spellings included), plus handwritten edge
documents the random grammar cannot reach (headerless, truncated,
malformed, empty). The corpus is identical on every machine and every
run, so a sanitizer failure is reproducible by index.
"""

from __future__ import annotations

import random
from typing import List

#: Adversarial AF spellings: every strtod↔float() edge the reference's
#: grammar samples.
AF_SPELLINGS = [
    "0.5", "1e-3", ".5", "5.", "+0.25", "-0", "0,0.5", "junk", "",
    "0.2_5", "0.5 ", " 0.5", "0x1A", "inf", "nan", "1e999",
    "0." + "1" * 70, "0.5" + " " * 61,
]

_INFO_CHOICES = [".", "DB", "NS=3;DP=14", "XAF=9"]
_FORMATS = ["GT", "GT:DP", "DP:GT", "DP"]
_CONTIGS = ["1", "17", "chr2", "X"]
_REFS = ["A", "AT", "GCC"]
_ALTS = [".", "G", "G,T"]


def _random_document(rng: random.Random) -> str:
    """One grammar-conforming VCF document."""
    n_samples = rng.randint(0, 5)
    n_records = rng.randint(0, 12)
    crlf = rng.random() < 0.5
    lines = ["##fileformat=VCFv4.2"]
    header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT" + "".join(
        f"\tS{i}" for i in range(n_samples)
    )
    if n_samples == 0:
        header = header[: header.rindex("\tFORMAT")]
    lines.append(header)
    for r in range(n_records):
        info = rng.choice(
            _INFO_CHOICES
            + [f"AF={rng.choice(AF_SPELLINGS)}"]
            + [f"NS=2;AF={rng.choice(AF_SPELLINGS)};DB"]
        )
        fields = [
            rng.choice(_CONTIGS),
            str(rng.randint(1, 10_000)),
            rng.choice([".", f"rs{r}"]),
            rng.choice(_REFS),
            rng.choice(_ALTS),
            ".",
            ".",
            info,
        ]
        if n_samples:
            fmt = rng.choice(_FORMATS)
            fields.append(fmt)
            n_cols = rng.choice([n_samples, max(0, n_samples - 1)])
            for _ in range(n_cols):
                alleles = [
                    rng.choice([".", str(rng.randint(0, 12))])
                    for _ in range(rng.randint(1, 3))
                ]
                gt = rng.choice(["/", "|"]).join(alleles)
                fields.append(
                    {"GT": gt, "GT:DP": f"{gt}:7", "DP:GT": f"7:{gt}", "DP": "7"}[
                        fmt
                    ]
                )
        lines.append("\t".join(fields))
    eol = "\r\n" if crlf else "\n"
    return eol.join(lines) + eol


def _edge_documents() -> List[str]:
    """Handwritten documents outside the random grammar: the boundary and
    malformed shapes where parser memory errors historically live."""
    big_gt = "|".join(["1"] * 64)
    return [
        "",  # empty buffer
        "\n\n\n",  # blank lines only
        "##meta only, no header\n",
        # Headerless (data before #CHROM): empty cohort, still parsed.
        "17\t100\t.\tA\tG\t.\t.\tAF=0.5\n",
        # Single-'#' comment before the header.
        "# a bare comment\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
        "\tFORMAT\tS0\n17\t100\t.\tA\tG\t.\t.\t.\tGT\t0|1\n",
        # Malformed: < 8 fields — the parser must report, not overrun.
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n17\t100\tonly\n",
        # Malformed POS (non-numeric / zero / huge).
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\nX\tNaN\t.\tA\t.\t."
        "\t.\t.\n",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\nX\t0\t.\tA\t.\t.\t."
        "\t.\n",
        # No trailing newline on the final data line.
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\n"
        "1\t5\t.\tA\tG\t.\t.\tAF=1e-3\tGT\t1/1",
        # Truncated mid-field (simulates a torn read).
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\n"
        "1\t5\t.\tA\tG\t.\t.\tAF=0.",
        # More sample columns than the header declared.
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\n"
        "1\t5\t.\tA\tG\t.\t.\t.\tGT\t0|1\t1|1\t1/0\n",
        # FORMAT without GT; GT index past the sample subfields.
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\n"
        "1\t5\t.\tA\tG\t.\t.\t.\tDP:GQ\t7:99\n",
        # Wide genotype (64 alleles) and a >63-char AF value.
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\n"
        f"1\t5\t.\tA\tG\t.\t.\tAF={'9' * 80}\tGT\t{big_gt}\n",
        # AF= at the very end of INFO, and empty AF value.
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        "1\t5\t.\tA\tG\t.\t.\tNS=2;AF=\n1\t6\t.\tA\tG\t.\t.\tAF=\n",
        # Repeated #CHROM header mid-file (cohort re-declaration).
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\n"
        "1\t5\t.\tA\tG\t.\t.\t.\tGT\t0|1\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\tS1\n"
        "1\t6\t.\tA\tG\t.\t.\t.\tGT\t1|1\t0/0\n",
        # CRLF everywhere including the header.
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\r\n"
        "1\t5\t.\tA\tG\t.\t.\tAF=0.25\tGT\t1|0\r\n",
    ]


def corpus_documents(n_random: int = 24, seed: int = 20240803) -> List[bytes]:
    """The full corpus: handwritten edges + ``n_random`` seeded grammar
    documents, as bytes ready for file replay. Deterministic for a given
    ``(n_random, seed)``; the default is the corpus ``graftcheck sanitize``
    replays."""
    rng = random.Random(seed)
    docs = _edge_documents() + [
        _random_document(rng) for _ in range(n_random)
    ]
    return [d.encode("utf-8") for d in docs]


__all__ = ["AF_SPELLINGS", "corpus_documents"]
