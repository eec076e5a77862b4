"""``device.htod_ms``: device milliseconds a traced tick spends copying from
the host to the device, as the union of the copies' intervals."""


def read(run, trace, cell, device):
    return trace.device_ms_per_tick("copy", "HtoD")
