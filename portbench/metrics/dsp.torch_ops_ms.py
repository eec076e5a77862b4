"""``dsp.torch_ops_ms``: device milliseconds a traced tick spends in
operations that are neither the port's own CUDA kernels nor copies (the
unfused torch operations of decode, DSP, FIFOs and merge), as the union of
their intervals."""


def read(run, trace, cell, device):
    return trace.device_ms_per_tick("op")
