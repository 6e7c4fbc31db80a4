"""``kernel.gram_accumulate_roofline``, read in the chr17 cell, whose rate has a bound of its own."""

from gpubench.catalog import reader

read = reader("kernel.gram_accumulate_roofline")
