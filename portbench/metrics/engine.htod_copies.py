"""``engine.htod_copies``: copies of host arrays to the card a traced tick's
engine steps issue, the ``htod_copies`` counter carried by the
``aukit.engine.step`` records."""

from portbench.harness.program_spans import count_per_tick


def read(run, trace, cell, device):
    return count_per_tick(trace, cell, "aukit.engine.step", "htod_copies")
