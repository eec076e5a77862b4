"""``engine.launch_ms``: host milliseconds a traced tick spends in the
engine's ``aukit.engine.launch`` spans, less the copies inside them: issuing
each group step's decode, DSP stages, ``dsp_chain`` and masks."""

from portbench.harness.program_spans import ms_per_tick


def read(run, trace, cell, device):
    return ms_per_tick(trace, cell, "aukit.engine.launch", self_time=True)
