"""``realtime_x``: seconds of 48 kHz audio delivered across all lanes (one
second for each lane whose window mask is true) over the wall time of the
window, from the start of its first tick to the end of its last."""


def read(run, trace, cell, device):
    return sum(run["delivered"]) / run["window_s"]
