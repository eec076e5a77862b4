"""``flac.parse_ms``: host milliseconds a traced tick spends in the FLAC
lanes' ``aukit.flac.parse`` span: the per-lane incremental frame parse."""

from portbench.harness.program_spans import ms_per_tick


def read(run, trace, cell, device):
    return ms_per_tick(trace, cell, "aukit.flac.parse")
