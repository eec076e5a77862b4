"""``engine.feed_ms``: host milliseconds a traced tick spends in the
harness's span around the feed calls (``feed_many``, or each station's
``Fleet.feed``)."""


def read(run, trace, cell, device):
    return trace.host_ms_per_tick("engine.feed")
