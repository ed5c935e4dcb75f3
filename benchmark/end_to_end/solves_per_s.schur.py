"""`solves_per_s` in the cells whose requests the card paces (the Schur
solves: 0.3-0.4 % spread at 51 s against 2-6 % in the fused cells, whose
requests are half host work), held to a bound of their own."""

from benchmark.end_to_end.solves_per_s import read  # noqa: F401
