"""``driver.job_overhead_ms``, read in the chr17 cell, whose rate has a bound of its own."""

from gpubench.catalog import reader

read = reader("driver.job_overhead_ms")
