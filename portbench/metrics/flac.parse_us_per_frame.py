"""``flac.parse_us_per_frame``: host microseconds of the ``aukit.flac.parse``
span a committed frame, over the ``frames_parsed`` counter its records
carry."""

from portbench.harness.program_spans import count_per_tick, ms_per_tick


def read(run, trace, cell, device):
    ms = ms_per_tick(trace, cell, "aukit.flac.parse")
    frames = count_per_tick(trace, cell, "aukit.flac.parse", "frames_parsed")
    if ms is None or not frames:
        return None
    return 1e3 * ms / frames
