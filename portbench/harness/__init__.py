"""The general part of the benchmark: the run, the registry of named parts,
the trace reduction and the table of peaks."""
