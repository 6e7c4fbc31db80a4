"""``device.idle_unspanned_share``, read in the chr17 cell, whose rate has a bound of its own."""

from gpubench.catalog import reader

read = reader("device.idle_unspanned_share")
