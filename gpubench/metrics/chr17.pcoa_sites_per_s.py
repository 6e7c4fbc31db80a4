"""``pcoa_sites_per_s``, read in the chr17 cell, whose rate has a bound of its own."""

from gpubench.catalog import reader

read = reader("pcoa_sites_per_s")
