"""``engine.fifo_ms``: host milliseconds a traced tick spends in the
engine's ``aukit.engine.fifo`` spans, less the copies inside them: the group
FIFOs' push and pop and the window assembly of a heterogeneous engine."""

from portbench.harness.program_spans import ms_per_tick


def read(run, trace, cell, device):
    return ms_per_tick(trace, cell, "aukit.engine.fifo", self_time=True)
