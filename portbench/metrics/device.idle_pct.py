"""``device.idle_pct``: the share of the traced ticks' wall time in which
no operation ran on the device, in percent."""


def read(run, trace, cell, device):
    if not trace.window_us:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
