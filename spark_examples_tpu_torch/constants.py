"""Public-data constants.

Mirrors ``GoogleGenomicsPublicData`` (``SearchVariantsExample.scala:27-31``)
and ``Examples`` (``SearchReadsExample.scala:30-67``).
"""

from typing import Dict


class GoogleGenomicsPublicData:
    PLATINUM_GENOMES = "3049512673186936334"
    THOUSAND_GENOMES_PHASE_1 = "10473108253681171589"
    THOUSAND_GENOMES_PHASE_3 = "4252737135923902652"


class Examples:
    GOOGLE_1KG_HG00096_READSET = "CMvnhpKTFhCwvIWYw9eikzQ"
    GOOGLE_EXAMPLE_READSET = "CMvnhpKTFhD04eLE-q2yxnU"
    GOOGLE_DREAM_SET3_NORMAL = "CPHG3MzoCRDRkqXzk7b6l_kB"
    GOOGLE_DREAM_SET3_TUMOR = "CPHG3MzoCRCO1rDx8pOY6yo"

    #: SNP @ 6889648 — cilantro/soap variant near OR10A2
    CILANTRO = 6889648

    HUMAN_CHROMOSOMES: Dict[str, int] = {
        "1": 249250621,
        "2": 243199373,
        "3": 198022430,
        "4": 191154276,
        "5": 180915260,
        "6": 171115067,
        "7": 159138663,
        "8": 146364022,
        "9": 141213431,
        "10": 135534747,
        "11": 135006516,
        "12": 133851895,
        "13": 115169878,
        "14": 107349540,
        "15": 102531392,
        "16": 90354753,
        "17": 81195210,
        "18": 78077248,
        "19": 59128983,
        "20": 63025520,
        "21": 48129895,
        "22": 51304566,
        "X": 155270560,
        "Y": 59373566,
    }


__all__ = ["GoogleGenomicsPublicData", "Examples"]
