"""``pca.center_pca_ms``, read in the chr17 cell, whose rate has a bound of its own."""

from gpubench.catalog import reader

read = reader("pca.center_pca_ms")
