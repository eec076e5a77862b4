"""``engine.step_host_ms``: host milliseconds a traced tick spends in the
harness's span around ``BatchStreamEngine.step`` (in a Fleet, the wrapped
``fleet.engine.step``)."""


def read(run, trace, cell, device):
    return trace.host_ms_per_tick("engine.step")
