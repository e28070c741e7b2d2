"""The general parts of the benchmark: the cell's files found by name,
statistics, the profiler's reduction, the import guard and the result."""
