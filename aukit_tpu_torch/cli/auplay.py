"""auplay — preload-then-play CLI (reference auplay.lua), counterpart of
``aukit_tpu.cli.auplay``.

Pipeline identical to the reference: load by extension -> resample(48000) ->
mono -> normalize(0.8) -> lowpass(original_rate / 2) -> chunked stream ->
play. The speaker peripheral becomes a pluggable sink: a raw/WAV output file,
or a paced null sink. The loaders decode onto ``--device`` (the card unless
``--device cpu``), where every stage of the chain runs.
"""

from __future__ import annotations

import argparse
import sys

from . import DEVICES


def load_by_extension(path: str, data: bytes, device="cuda"):
    import aukit_tpu_torch as ak

    p = path.lower()
    if p.endswith(".dfpwm"):
        return ak.dfpwm(data, 1, 48000, device=device)
    if p.endswith(".wav"):
        return ak.wav(data, device=device)
    if p.endswith(".aif") or p.endswith(".aiff"):
        return ak.aiff(data, device=device)
    if p.endswith(".au"):
        return ak.au(data, device=device)
    if p.endswith(".flac"):
        return ak.flac(data, device=device)
    if p.endswith(".qoa"):
        return ak.qoa(data, device=device)
    if p.endswith(".mdfpwm"):
        return ak.mdfpwm(data, device=device)
    raise SystemExit("Unknown file type!")


def make_sink(out: str | None, realtime: bool):
    from ..playback import FileSink, NullSink

    if out:
        return FileSink(open(out, "wb"))
    return NullSink(realtime=realtime)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="auplay", description="Play an audio file (AUKit auplay equivalent)")
    ap.add_argument("file")
    ap.add_argument("-o", "--out", help="write 48kHz signed 8-bit samples to this file instead of a speaker")
    ap.add_argument("--realtime", action="store_true", help="pace the null sink at 48kHz like a real speaker")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="torch device of the decode and the chain (default: cuda)")
    args = ap.parse_args(argv)

    import aukit_tpu_torch as ak

    with open(args.file, "rb") as f:
        data = f.read()
    print("Loading file...")
    audio = load_by_extension(args.file, data, args.device)
    print("Resampling...")
    resamp = audio.resample(48000)
    print("Converting to mono...")
    mono = resamp.mono()
    print("Normalizing...")
    ak.effects.normalize(mono, 0.8)
    print("Applying filter...")
    ak.effects.lowpass(mono, audio.sample_rate / 2)
    print("Playing.")
    it, _length = mono.stream(48000)
    sink = make_sink(args.out, args.realtime)

    def play_iter():
        # Audio.stream yields raw 8-bit-range values; aukit.play consumed them
        # directly (reference auplay.lua:34)
        for vals, pos in it:
            yield vals, pos

    ak.play(play_iter(), sink)
    print("Done.")


if __name__ == "__main__":
    main(sys.argv[1:])
