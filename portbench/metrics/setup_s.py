"""``setup_s``: seconds from the start of the run to the start of the
window: imports, the build or load of the port's kernels, the inputs made
from the seed, the program's construction and its warm-up ticks."""


def read(run, trace, cell, device):
    return run["setup_s"]
