"""The general part of the benchmark: finding a cell's files by name, the
seeded weights, the profiler reading, FLOP and byte counts, the peaks and
the comparison that decides ``correct``."""
