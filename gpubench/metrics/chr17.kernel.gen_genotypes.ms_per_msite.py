"""``kernel.gen_genotypes.ms_per_msite``, read in the chr17 cell, whose rate has a bound of its own."""

from gpubench.catalog import reader

read = reader("kernel.gen_genotypes.ms_per_msite")
