"""``engine.stage_ms``: host milliseconds a traced tick spends in the
engine's ``aukit.engine.stage`` spans, less their child spans: gathering the
lanes' fed bytes into each group step's staged matrix (``_GroupIO.stage``)."""

from portbench.harness.program_spans import ms_per_tick


def read(run, trace, cell, device):
    return ms_per_tick(trace, cell, "aukit.engine.stage", self_time=True)
