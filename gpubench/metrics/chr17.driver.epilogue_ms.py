"""``driver.epilogue_ms``, read in the chr17 cell, whose rate has a bound of its own."""

from gpubench.catalog import reader

read = reader("driver.epilogue_ms")
