"""``tick_ms_p90``: the 90th percentile, by linear interpolation between
order statistics, of the wall time of every tick of the window (feed, step,
and the returned window complete on the card), in milliseconds."""

import numpy as np


def read(run, trace, cell, device):
    ms = [(b - a) * 1e3 for a, b in run["ticks"]]
    return float(np.percentile(ms, 90))
