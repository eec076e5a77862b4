"""``flac.dsp_host_ms``: host milliseconds a traced tick spends in the FLAC
lanes' ``aukit.flac.dsp`` span: the per-lane decorrelation, the float64
resample, lowpass, gain and scale, and the lane FIFOs' push."""

from portbench.harness.program_spans import ms_per_tick


def read(run, trace, cell, device):
    return ms_per_tick(trace, cell, "aukit.flac.dsp")
