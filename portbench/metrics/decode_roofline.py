"""``decode_roofline``: the least time the card's memory needs to
move a tick's decode, over the tick's device compute time (the port's
kernels and the torch operations, as one union), in percent.

The bytes are counted from the cell's shapes, whatever implements the work:
the compressed input bytes, the int8 window, and each lane's carried state
(the DFPWM state, the smoothing carry, the filter carries) read once and
written once. They are divided by the card's published bandwidth
(``harness/peaks.py``). No operations bound is given: no published source
gives the card's integer operation rate."""

from portbench.harness.peaks import peak


def tick_bytes(shape: dict) -> float:
    return shape["in_bytes"] + shape["window_bytes"] + 2 * shape["state_bytes"]


def read(run, trace, cell, device):
    bw = peak(device, "hbm_bytes_per_s")
    shape = getattr(cell, "shape", lambda: None)()
    compute = trace.intervals("kernel") + trace.intervals("op")
    if bw is None or shape is None or not compute or not trace.n_ticks:
        return None
    from portbench.harness.trace import union_us
    busy_s = union_us(compute) / 1e6 / trace.n_ticks
    return 100.0 * tick_bytes(shape) / bw / busy_s
