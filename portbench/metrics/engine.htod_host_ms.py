"""``engine.htod_host_ms``: host milliseconds a traced tick spends in the
engine's ``aukit.engine.htod`` spans: its copies of host arrays to the card
(the staged bytes, the masks, the per-lane DSP rows, the FIFO cursors),
including any wait behind device work queued before a pageable copy."""

from portbench.harness.program_spans import ms_per_tick


def read(run, trace, cell, device):
    return ms_per_tick(trace, cell, "aukit.engine.htod")
