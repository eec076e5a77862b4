"""``flac.restore_ms``: host milliseconds a traced tick spends in the FLAC
lanes' ``aukit.flac.restore`` span: the fleet-wide LPC restore (the native host
route in the radio)."""

from portbench.harness.program_spans import ms_per_tick


def read(run, trace, cell, device):
    return ms_per_tick(trace, cell, "aukit.flac.restore")
