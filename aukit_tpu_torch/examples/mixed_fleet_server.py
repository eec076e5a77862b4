"""Example: a mixed-format radio server on ONE dispatch surface. Counterpart
of the repository's ``examples/mixed_fleet_server.py``.

FLAC stations, raw DFPWM stations and IMA-ADPCM-in-WAV stations drip-feed
bytes at jittery realtime-ish rates through a single ``Fleet``
(stream/fleet.py): one loop, one step() call, one int8 window matrix per
tick. Inside, the facade steps the BatchStreamEngine (DFPWM lanes through
kernel (b), IMA block lanes through kernel (d) and the resample's fused
multiply-adds) and the FlacFleet (one batched LPC restore: the native host
restore, or kernel (g) when ``CONFIG.flac_device_restore_min`` sends it to
the card), then merges their windows on the device.

When a station's source ends, the server ROTATES it: ``Fleet.reset_station``
reuses the finished station's lane slots for a brand-new source of the same
kind, with no fleet rebuild.

Run:  python -m aukit_tpu_torch.examples.mixed_fleet_server [stations] [seconds]
      [rotations] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import struct
import time

import numpy as np

from ..config import require_device
from .flac_radio_fleet import _make_station


def _dfpwm_station(rng, seconds: int) -> bytes:
    # random bytes ARE a decodable DFPWM stream (1 bit/sample delta codec:
    # any bit pattern drives the predictor) — good enough for a synthetic
    # station; real stations would carry encoder output
    return bytes(rng.integers(0, 256, seconds * 6000, dtype=np.uint8))


def _ima_wav_station(rng, seconds: int) -> bytes:
    """A real WAV file wrapping IMA-ADPCM blocks (fmt code 0x11)."""
    rate, ba = 16000, 256
    spb = (ba - 4) * 2
    nblocks = -(-seconds * rate // spb)
    payload = bytearray()
    for _ in range(nblocks):
        payload += struct.pack("<hBx", int(rng.integers(-2000, 2000)),
                               int(rng.integers(0, 89)))
        payload += rng.integers(0, 256, ba - 4, dtype=np.uint8).tobytes()
    fmt = struct.pack("<HHIIHHHH", 0x11, 1, rate, rate * ba // spb, ba, 4,
                      2, spb)
    data = bytes(payload)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data))
            + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)


def main(stations: int = 48, seconds: int = 6, rotations: int = 1, device="cuda", *,
         on_window=None) -> dict:
    """Run the server; print the JAX script's lines and return them as a dict
    (``ticks``, ``live`` stations of each tick, ``lead_positions``,
    ``rotated`` after each tick, ``rotations``, ``samples_decoded``,
    ``poisoned`` stations, ``wall_seconds``, ``realtime_factor``).
    ``on_window(window, mask, positions)``, where given, sees each tick's
    step result; its time counts in the wall time."""
    from ..stream.batch import LaneSpec
    from ..stream.fleet import Fleet

    device = require_device(device, "mixed_fleet_server")
    rng = np.random.default_rng(0)
    print(f"synthesizing {stations} mixed stations ({seconds}s each)...")
    sources, feeds = [], []
    for i in range(stations):
        kind = i % 3
        if kind == 0:
            data = _make_station(rng, seconds)
            src = data[:8192]  # header + first frames up front
        elif kind == 1:
            data = _dfpwm_station(rng, seconds)
            src = (LaneSpec("dfpwm", 48000), data[:6000])
        else:
            data = _ima_wav_station(rng, seconds)
            src = data[:8192]
        sources.append(src)
        feeds.append(data)

    fleet = Fleet(sources, eof=False, device=device)
    offs = [8192 if i % 3 != 1 else 6000 for i in range(stations)]
    bps = [max(1, len(f) // seconds) for f in feeds]
    ended = [False] * stations
    spins = [0] * stations  # rotations performed per station

    def fresh_source(i: int):
        kind = i % 3
        if kind == 0:
            return _make_station(rng, seconds)
        if kind == 1:
            return _dfpwm_station(rng, seconds)
        return _ima_wav_station(rng, seconds)

    live_ticks, leads, rotated_ticks = [], [], []
    t0 = time.time()
    ticks = rotated = 0
    while not fleet.done:
        for i in range(stations):
            if offs[i] < len(feeds[i]):
                burst = int(bps[i] * rng.uniform(0.5, 1.5))
                fleet.feed(i, feeds[i][offs[i]: offs[i] + burst])
                offs[i] += burst
            elif not ended[i]:
                fleet.feed(i, None)
                ended[i] = True
        # rotate finished stations onto brand-new sources, live (no rebuild)
        if rotations:
            act = fleet.active
            for i in range(stations):
                if ended[i] and not act[i] and spins[i] < rotations \
                        and not fleet.station_error(i):
                    spins[i] += 1
                    data = fresh_source(i)
                    src = data if i % 3 != 1 else (
                        LaneSpec("dfpwm", 48000), data)
                    fleet.reset_station(i, src)
                    rotated += 1
                    ended[i] = True  # reset_station(eof=True) ended it
                    feeds[i], offs[i] = data, len(data)
        r = fleet.step()
        if r is not None:
            w, mask, positions = r
            ticks += 1
            live_ticks.append(int(mask.sum()))
            leads.append(float(positions.max()))
            rotated_ticks.append(rotated)
            print(f"tick {ticks:3d}: {int(mask.sum()):3d}/{stations} "
                  f"stations emitted, lead position {positions.max():6.2f}s, "
                  f"{rotated} rotations")
            if on_window is not None:
                on_window(w, mask, positions)
    dt = time.time() - t0
    m = fleet.metrics
    errs = [i for i in range(stations) if fleet.station_error(i)]
    factor = m.samples_decoded / dt / 48000
    print(f"\n{m.samples_decoded} samples from {stations} mixed stations "
          f"in {dt:.2f}s ({factor:.0f}x realtime "
          f"aggregate); {len(errs)} poisoned stations")
    out = {"stations": stations, "seconds": seconds, "ticks": ticks, "live": live_ticks,
           "lead_positions": leads, "rotated": rotated_ticks, "rotations": rotated,
           "samples_decoded": m.samples_decoded, "poisoned": len(errs), "wall_seconds": dt,
           "realtime_factor": factor}
    return out


def cli(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("stations", nargs="?", type=int, default=48)
    p.add_argument("seconds", nargs="?", type=int, default=6)
    p.add_argument("rotations", nargs="?", type=int, default=1)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(a.stations, a.seconds, a.rotations, a.device)


if __name__ == "__main__":
    cli()
