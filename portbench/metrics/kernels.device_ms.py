"""``kernels.device_ms``: device milliseconds a traced tick spends in the
port's own kernels (the ``__global__`` functions of
``aukit_tpu_torch/csrc``), as the union of their intervals."""


def read(run, trace, cell, device):
    return trace.device_ms_per_tick("kernel")
