"""``fleet.merge_ms``: host milliseconds of a traced tick's ``Fleet.step``
outside its two engines' steps: the station bookkeeping and the merge of the
windows (the span of ``Fleet.step`` minus its two engine spans)."""


def read(run, trace, cell, device):
    total = trace.host_ms_per_tick("fleet.step")
    if total is None:
        return None
    return total - (trace.host_ms_per_tick("engine.step") or 0.0) \
        - (trace.host_ms_per_tick("flac.step") or 0.0)
