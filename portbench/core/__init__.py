"""The benchmark's own code: files found by name, statistics, traces,
the operation count and the judges."""
