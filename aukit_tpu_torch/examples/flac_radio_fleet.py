"""Example: an internet-radio FLAC fleet — N independent stations drip-feed
FLAC bytes at jittery, realtime-ish rates and ONE FlacFleet decodes them all
with a single batched LPC restore per tick (the reference's network-streaming
case, ``aukit.stream.flac`` aukit.lua:3115-3191, batched across stations).
Counterpart of the repository's ``examples/flac_radio_fleet.py``.

Each tick: every station delivers whatever bytes "arrived" since the last
tick, the fleet emits one-second f32 windows with per-lane masks/positions,
and starved lanes simply skip the window (no silence is spliced in). The
restore takes the fleet's default route: the native host restore, or kernel
(g) on the card when ``CONFIG.flac_device_restore_min`` is at most a tick's
batch (subframes x block size); both give the same samples.

Run:  python -m aukit_tpu_torch.examples.flac_radio_fleet [stations] [seconds]
      [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import struct
import time

import numpy as np

from ..config import require_device

# -- the station writer: numpy and struct only ------------------------------------------


def flac_stream_header(sample_rate: int, channels: int, depth: int, total: int) -> bytes:
    """``fLaC`` and one STREAMINFO block (min/max block 4096, no frame sizes,
    zero MD5), as the repository's test fixtures write it."""
    si = struct.pack(">HH", 4096, 4096) + b"\x00\x00\x00" * 2
    packed = (sample_rate << 44) | ((channels - 1) << 41) | ((depth - 1) << 36) | total
    si += packed.to_bytes(8, "big") + b"\x00" * 16
    return b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big") + si


def _flac_crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _utf8_coded(n: int) -> bytes:
    """FLAC's UTF-8-style frame number coding (1-7 bytes)."""
    if n < 0x80:
        return bytes([n])
    for count in range(1, 7):
        if n.bit_length() <= 6 - count + 6 * count:
            lead = (0xFF << (7 - count)) & 0xFF | (n >> (6 * count))
            cont = [0x80 | ((n >> (6 * (count - 1 - k))) & 0x3F) for k in range(count)]
            return bytes([lead] + cont)
    raise ValueError("frame number too large")


def pack_fields(values: np.ndarray, widths: np.ndarray) -> bytes:
    """Big-endian bit fields, each ``values[i]`` (non-negative, below 2**56)
    in its low ``widths[i]`` bits, written one after another into bytes (the
    fields' bits are disjoint, so each byte is the sum of its parts)."""
    ends = np.cumsum(widths, dtype=np.int64)
    total = int(ends[-1])
    assert total % 8 == 0, "fields end on a byte boundary"
    last = ends - 1
    x = values.astype(np.int64) << (7 - (last & 7))
    byte = last >> 3
    out = np.zeros(total // 8, np.float64)
    for k in range(max(1, (int(x.max()).bit_length() + 7) // 8)):
        # a part that would fall before the first byte is zero
        out += np.bincount(np.maximum(byte - k, 0), weights=(x >> (8 * k)) & 0xFF,
                           minlength=len(out))
    return out.astype(np.uint8).tobytes()


def lpc_frames(sigs: np.ndarray, coefs, precision: int, shift: int, param: int,
               depth: int = 16) -> bytes:
    """Mono FLAC frames numbered from 0, one a row of ``sigs`` (int64[F, n],
    block size n): each one LPC subframe of ``len(coefs)`` taps, Rice
    method 0, partition order 0, parameter ``param``, and the fixtures'
    CRC16 placeholder. The bytes of the repository's fixtures ``flac_frame``
    for the same subframes, with the residual loop in numpy (int64, ``>>``)."""
    F, n = sigs.shape
    order = len(coefs)
    pred = sum(sigs[:, order - 1 - j: n - 1 - j] * c for j, c in enumerate(coefs))
    res = sigs[:, order:] - (pred >> shift)
    u = np.where(res >= 0, 2 * res, -2 * res - 1)
    # a residual is q = u >> param zeros, a one, then u's low param bits: one
    # field of the value (1 << param) | low, q + 1 + param bits wide
    rice_v = (1 << param) | (u & ((1 << param) - 1))
    rice_w = (u >> param) + 1 + param
    mask = (1 << depth) - 1
    pmask = (1 << precision) - 1
    head_v = [0, 31 + order, 0]
    head_w = [1, 6, 1]
    vals, wids = [], []
    for f in range(F):
        hdr = bytearray([0xFF, 0xF8, 0x70, 0x00]) + _utf8_coded(f) + struct.pack(">H", n - 1)
        hdr.append(_flac_crc8(hdr))
        sub_v = (head_v + [int(v) & mask for v in sigs[f, :order]] + [precision - 1, shift]
                 + [c & pmask for c in coefs] + [0, 0, param])
        sub_w = head_w + [depth] * order + [4, 5] + [precision] * order + [2, 4, 4]
        bits = 8 * len(hdr) + sum(sub_w) + int(rice_w[f].sum())
        vals += [np.frombuffer(bytes(hdr), np.uint8).astype(np.int64), np.array(sub_v),
                 rice_v[f], np.array([0, 0xBEEF])]
        wids += [np.full(len(hdr), 8), np.array(sub_w), rice_w[f],
                 np.array([-bits % 8, 16])]
    return pack_fields(np.concatenate(vals), np.concatenate(wids))


def _make_station(rng, seconds: int) -> bytes:
    """Synthesize one station's FLAC stream (LPC-coded drifting tone): the
    bytes of the JAX example's ``_make_station`` for the same RNG."""
    n, rate = 4096, 48000
    frames = -(-seconds * rate // n)
    sigs = np.stack([np.cumsum(rng.integers(-40, 41, n)).astype(np.int64)
                     for _ in range(frames)])
    body = lpc_frames(sigs, [63, -31], precision=7, shift=5, param=6)  # gentle 2-tap predictor
    return flac_stream_header(rate, 1, 16, frames * n) + body


# -- the server -----------------------------------------------------------------------


def main(stations: int = 64, seconds: int = 6, device="cuda", *, on_window=None) -> dict:
    """Run the fleet; print the JAX script's lines and return them as a dict
    (``ticks``, ``live`` lanes of each tick, ``lead_positions``,
    ``samples_decoded``, ``poisoned`` lanes, ``wall_seconds``,
    ``realtime_factor``). ``on_window(window, mask, positions)``, where
    given, sees each tick's step result; its time counts in the wall time."""
    from ..stream.flac_fleet import FlacFleet

    device = require_device(device, "flac_radio_fleet")
    rng = np.random.default_rng(0)
    print(f"synthesizing {stations} FLAC stations ({seconds}s each)...")
    base = [_make_station(rng, seconds) for _ in range(min(stations, 8))]
    feeds = [bytearray(base[i % len(base)]) for i in range(stations)]

    fleet = FlacFleet(stations, device=device)
    # a radio feed delivers ~bytes_per_second with jitter; we tick once per
    # simulated second and deliver 0.5-1.5 s of bytes per station
    bps = [len(f) // seconds for f in feeds]
    offs = [0] * stations
    live_ticks, leads = [], []

    t0 = time.time()
    windows = 0
    while not fleet.done:
        for i in range(stations):
            if offs[i] < len(feeds[i]):
                burst = int(bps[i] * rng.uniform(0.5, 1.5))
                fleet.feed(i, bytes(feeds[i][offs[i]: offs[i] + burst]))
                offs[i] += burst
                if offs[i] >= len(feeds[i]):
                    fleet.feed(i, None)
        r = fleet.step()
        if r is not None:
            window, mask, positions = r
            windows += 1
            live = int(mask.sum())
            live_ticks.append(live)
            leads.append(float(positions.max()))
            print(f"tick {windows:3d}: {live:4d}/{stations} lanes emitted, "
                  f"lead position {positions.max():6.2f}s")
            if on_window is not None:
                on_window(window, mask, positions)
    dt = time.time() - t0
    # metrics count the actual per-lane take (final windows are zero-padded)
    out_samples = fleet.metrics.samples_decoded
    errs = [i for i in range(stations) if fleet.lane_error(i)]
    factor = out_samples / dt / 48000
    print(f"\n{out_samples} samples from {stations} stations in {dt:.2f}s "
          f"({factor:.0f}x realtime aggregate); "
          f"{len(errs)} poisoned lanes")
    out = {"stations": stations, "seconds": seconds, "ticks": windows, "live": live_ticks,
           "lead_positions": leads, "samples_decoded": out_samples, "poisoned": len(errs),
           "wall_seconds": dt, "realtime_factor": factor}
    return out


def cli(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("stations", nargs="?", type=int, default=64)
    p.add_argument("seconds", nargs="?", type=int, default=6)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(a.stations, a.seconds, a.device)


if __name__ == "__main__":
    cli()
