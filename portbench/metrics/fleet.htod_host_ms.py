"""``fleet.htod_host_ms``: host milliseconds a traced tick spends in the
Fleet's ``aukit.fleet.htod`` span: the FLAC windows' copy to the card (float32,
a second a lane) and the station mask's."""

from portbench.harness.program_spans import ms_per_tick


def read(run, trace, cell, device):
    return ms_per_tick(trace, cell, "aukit.fleet.htod")
