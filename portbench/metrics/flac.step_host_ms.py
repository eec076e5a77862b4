"""``flac.step_host_ms``: host milliseconds a traced tick spends in the
harness's span around the wrapped ``fleet.flac.step`` (``FlacFleet.step``:
the per-lane parse, the restore and the host DSP)."""


def read(run, trace, cell, device):
    return trace.host_ms_per_tick("flac.step")
