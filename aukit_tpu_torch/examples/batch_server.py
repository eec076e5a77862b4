"""Example: a batched decode "server" — many concurrent DFPWM streams through
one kernel launch per tick (kernel (b), the fused decode and DSP), with
per-lane state carried on the device. Counterpart of the repository's
``examples/batch_server.py``.

Simulates N clients whose streams arrive in bursts; the engine masks starved
lanes, recycles finished ones, and reports aggregate metrics. Each client's
stream is a tone encoded on the device by kernel (c), one lane a client.

Run:  python -m aukit_tpu_torch.examples.batch_server [lanes] [seconds]
      [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..config import require_device


def main(lanes: int = 256, duration_s: float = 2.0, device="cuda", *,
         on_window=None) -> dict:
    """Run the server; print the JAX script's lines and return them as a dict
    (``ticks``, ``live`` lanes of each tick that decoded, ``samples_decoded``,
    ``underrun_ticks``, ``wall_seconds``, ``realtime_factor``).
    ``on_window(chunk, mask, positions)``, where given, sees each tick's
    step result; its time counts in the wall time."""
    from ..ops.generate import tone
    from ..stream.batch import BatchDfpwmDecoder

    device = require_device(device, "batch_server")
    rng = np.random.default_rng(0)
    chunk_bytes = 6000  # 1 s of 48 kHz audio per lane per tick

    # synthesize per-client DFPWM content (a tone per client)
    print(f"encoding {lanes} client streams ({duration_s:.1f}s each)...")
    freqs = rng.uniform(100, 2000, lanes)
    streams = []
    for i in range(lanes):
        a = tone(float(freqs[i]), duration_s, 0.6, "sine", sample_rate=48000, device=device)
        streams.append(a.dfpwm(True))

    eng = BatchDfpwmDecoder(lanes, 48000, chunk_bytes=chunk_bytes, device=device)
    cursors = [0] * lanes
    sinks = [0] * lanes  # decoded sample counters
    live_ticks = []
    t0 = time.perf_counter()
    tick = 0
    while not eng.done:
        # bursty ingestion: each tick, a random subset of clients delivers data
        for lane in range(lanes):
            if cursors[lane] >= len(streams[lane]):
                continue
            if rng.random() < 0.8:  # 20% of lanes starve this tick (jitter)
                n = chunk_bytes * int(rng.integers(1, 3))
                eng.feed(lane, streams[lane][cursors[lane]: cursors[lane] + n])
                cursors[lane] += n
                if cursors[lane] >= len(streams[lane]):
                    eng.feed(lane, None)
        r = eng.step()
        tick += 1
        if r is None:
            continue
        chunk, mask, pos = r
        for lane in np.nonzero(mask)[0]:
            sinks[lane] += chunk.shape[1]
        live_ticks.append(int(mask.sum()))
        if on_window is not None:
            on_window(chunk, mask, pos)
    wall = time.perf_counter() - t0
    m = eng.metrics
    factor = m.samples_decoded / wall / 48000
    print(f"ticks={tick} decoded={m.samples_decoded/1e6:.1f}M samples "
          f"underrun_ticks={m.underruns}")
    print(f"aggregate: {factor:.0f}x realtime "
          f"({lanes} concurrent streams, wall {wall:.2f}s)")
    out = {"lanes": lanes, "seconds": duration_s, "ticks": tick, "live": live_ticks,
           "samples_decoded": m.samples_decoded, "underrun_ticks": m.underruns,
           "sink_samples": sum(sinks), "wall_seconds": wall, "realtime_factor": factor}
    return out


def cli(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("lanes", nargs="?", type=int, default=256)
    p.add_argument("seconds", nargs="?", type=float, default=2.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(a.lanes, a.seconds, a.device)


if __name__ == "__main__":
    cli()
