"""austream_tm — interactive streaming player (reference austream_tm.lua),
counterpart of ``aukit_tpu.cli.austream_tm``.

Same front-end as austream, but drives the async ``Player`` with keyboard
controls (the reference uses a Taskmaster event loop; here a raw-tty reader
thread): space = pause/resume, left/right arrows = seek ±5 s, q = stop.
A 0.25 s progress timer mirrors austream_tm.lua:129-132. ``--device`` as
austream's (the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

from . import DEVICES


def keyboard_loop(player, stop_flag, key_source=None):
    """Reads single keys (raw tty or an injectable iterator for tests).
    Returns when q is pressed or the stream ends."""
    if key_source is None:
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)

        def keys():
            import select

            while not stop_flag.is_set():
                r, _, _ = select.select([sys.stdin], [], [], 0.1)
                if r:
                    ch = sys.stdin.read(1)
                    if ch == "\x1b":  # arrow escape sequence
                        ch += sys.stdin.read(2)
                    yield ch

        source = keys()
    else:
        source = key_source
    try:
        for key in source:
            if stop_flag.is_set():
                break
            if key == " ":
                if player.is_paused:
                    player.play()
                else:
                    player.pause()
            elif key in ("\x1b[D", "left"):  # seek -5 s (austream_tm.lua:118)
                player.seek(max(player.live_position() - 5, 0))
            elif key in ("\x1b[C", "right"):  # seek +5 s
                player.seek(player.live_position() + 5)
            elif key in ("q", "Q"):
                player.stop()
                stop_flag.set()
                break
    finally:
        if key_source is None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, old)


def main(argv=None):
    from ..config import require_device
    from .austream import dispatch, open_source, parse_params, progress_bar
    from .auplay import make_sink
    import aukit_tpu_torch as ak

    ap = argparse.ArgumentParser(prog="austream_tm", description="Interactive streaming player")
    ap.add_argument("path")
    ap.add_argument("params", nargs="?")
    ap.add_argument("-o", "--out")
    ap.add_argument("--realtime", action="store_true", default=True)
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="torch device of the decode (default: cuda)")
    args = ap.parse_args(argv)
    require_device(args.device, "austream_tm")

    v = parse_params(args.params)
    data = open_source(args.path, bool(v.get("streamData", False)))
    it, length = dispatch(args.path, data, v, bool(v.get("mono", True)), args.device)
    sink = make_sink(args.out, args.realtime and not args.out)
    player = ak.player(it, sink, volume=v.get("volume"))
    stop_flag = threading.Event()
    kb = threading.Thread(target=keyboard_loop, args=(player, stop_flag), daemon=True)
    kb.start()
    bar = progress_bar(length or 0)
    print("Playing. [space] pause  [←/→] seek ±5s  [q] quit")
    try:
        while player._player.is_alive():
            bar(player.live_position())
            time.sleep(0.25)
    except KeyboardInterrupt:
        player.stop()
    stop_flag.set()
    print()


if __name__ == "__main__":
    main(sys.argv[1:])
