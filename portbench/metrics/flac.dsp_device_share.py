"""``flac.dsp_device_share``: the share (%) of the FLAC lanes decoded on the
host route whose float64 DSP ran on the card, in the kernel
``aukit_flac_dsp_f64``, per traced tick: the ``dsp_lanes_device`` and
``dsp_lanes_host`` counters carried by the ``aukit.flac.dsp`` records. None
where the program keeps no such counters or decoded no lane."""

from portbench.harness.program_spans import count_per_tick


def read(run, trace, cell, device):
    on_card = count_per_tick(trace, cell, "aukit.flac.dsp", "dsp_lanes_device")
    on_host = count_per_tick(trace, cell, "aukit.flac.dsp", "dsp_lanes_host")
    if on_card is None or not on_card + on_host:
        return None
    return 100.0 * on_card / (on_card + on_host)
