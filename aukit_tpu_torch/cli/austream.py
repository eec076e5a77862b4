"""austream — streaming player CLI (reference austream.lua), counterpart of
``aukit_tpu.cli.austream``.

Sources: local file, http(s) URL (chunked pull or preload), or '-' for stdin.
The second positional argument is the reference's parameter mini-language:
``key=value,...`` where bare identifiers evaluate to themselves (austream.lua:11
evaluates it with `load` in a restricted environment; here a small literal
parser). Options set: type, bitDepth, dataType, channels, sampleRate,
bigEndian, mono, volume, interpolation, streamData, ignoreHeader. ``--device`` (the card unless
``--device cpu``) is where the iterators that decode blocks run (WAV with
ADPCM, FLAC, QOA; DFPWM without the native library), where ``--fleet``'s
engines run, and what ``--trace`` records.
"""

from __future__ import annotations

import argparse
import sys

from . import DEVICES


def _tcp_listen_source(port: int, proto: str | None):
    """Broadcast fan-in: accept feeders on ``port``, queue their chunks in
    arrival order. Ends once at least one feeder connected and all have
    disconnected. Returns (data_fn, bound_port) — the port is echoed so
    callers binding port 0 can learn the real one."""
    import queue
    import socket
    import threading

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("0.0.0.0", port))
    srv.listen()
    bound = srv.getsockname()[1]
    q: "queue.Queue[bytes | None]" = queue.Queue(maxsize=256)
    state = {"feeders": 0, "ever": False, "closed": False}
    lock = threading.Lock()

    def feeder(conn):
        try:
            if proto is not None:
                line = b""
                while not line.endswith(b"\n") and len(line) < 256:
                    b = conn.recv(1)
                    if not b:
                        return
                    line += b
                if line.strip().decode("latin-1", "replace") != proto:
                    return  # protocol filter: drop the feeder (austream.lua:58)
            while True:
                d = conn.recv(48000)
                if not d:
                    return
                q.put(d)
        finally:
            conn.close()
            with lock:
                state["feeders"] -= 1
                if state["feeders"] == 0 and state["ever"]:
                    q.put(None)

    def acceptor():
        while not state["closed"]:
            try:
                conn, _addr = srv.accept()
            except OSError:
                return
            with lock:
                state["feeders"] += 1
                state["ever"] = True
            threading.Thread(target=feeder, args=(conn,), daemon=True).start()

    threading.Thread(target=acceptor, daemon=True).start()

    def data():
        d = q.get()
        if d is None:
            state["closed"] = True
            srv.close()
        return d

    return data, bound


def parse_params(params: str | None) -> dict:
    """The austream key=value,... mini-language: numbers, true/false, and bare
    identifiers-as-strings (matching the restricted `load` environment)."""
    v: dict = {}
    if not params:
        return v
    import re

    cleaned = re.sub(r'[^\w,="\.]+', "", params)
    for part in cleaned.split(","):
        if not part or "=" not in part:
            continue
        key, val = part.split("=", 1)
        val = val.strip('"')
        if val == "true":
            v[key] = True
        elif val == "false":
            v[key] = False
        else:
            try:
                v[key] = int(val)
            except ValueError:
                try:
                    v[key] = float(val)
                except ValueError:
                    v[key] = val
    return v


def open_source(path: str, stream_data: bool):
    """Returns bytes or a chunk-pull callable (austream.lua:19-81).
    ``tcp://host:port`` is the framework's analog of the reference's rednet
    point-to-point transport, and ``tcp://listen:port[?proto=name]`` of its
    id=-1 broadcast receive with protocol filter (austream.lua:54-64; N6 in
    SURVEY.md §2.3): any number of feeders connect and their chunks fan in;
    with ``proto=`` each feeder must open with the line ``<name>\\n`` or its
    connection is dropped (the rednet protocol filter). ``ws(s)://`` uses the
    websockets package when installed."""
    if path.startswith("tcp://listen:"):
        proto = None
        spec = path[len("tcp://listen:"):]
        if "?" in spec:
            spec, qs = spec.split("?", 1)
            for part in qs.split("&"):
                if part.startswith("proto="):
                    proto = part[6:]
        return _tcp_listen_source(int(spec), proto)[0]
    if path.startswith("tcp://"):
        import socket

        host, port = path[6:].rsplit(":", 1)
        sock = socket.create_connection((host, int(port)))

        def data():
            d = sock.recv(48000)
            if not d:
                sock.close()
                return None
            return d

        return data
    if path.startswith(("ws://", "wss://")):
        try:
            import websockets.sync.client as wsc  # optional dependency
        except ImportError as e:
            raise SystemExit("websocket sources need the 'websockets' package") from e
        conn = wsc.connect(path)

        def data():
            try:
                msg = conn.recv()
            except Exception:
                return None
            if isinstance(msg, str):
                print("Warning: Text message detected! This audio may be corrupt.")
                msg = msg.encode("latin-1")
            return msg

        return data
    if path.startswith(("http://", "https://")):
        import urllib.request

        handle = urllib.request.urlopen(path)
        if handle.status != 200:
            raise SystemExit(f"Could not connect to {path}: HTTP {handle.status}")
        if stream_data:
            def data():
                d = handle.read(48000)
                return d if d else None

            return data
        return handle.read()
    if path == "-":
        f = sys.stdin.buffer
    else:
        f = open(path, "rb")
    if stream_data:
        def data():
            d = f.read(48000)
            return d if d else None

        return data
    return f.read()


def dispatch(path: str, data, v: dict, mono: bool, device="cuda"):
    import aukit_tpu_torch as ak

    t = v.get("type")
    if isinstance(t, str):
        t = t.lower()
    p = path.lower()

    def is_(name, *exts):
        return t == name or any(p.endswith(e) for e in exts)

    if is_("dfpwm", ".dfpwm"):
        return ak.stream.dfpwm(data, v.get("sampleRate", 48000), v.get("channels", 1), mono,
                               device=device)
    if is_("mdfpwm", ".mdfpwm"):
        return ak.stream.mdfpwm(data, mono, device=device)
    if is_("wav", ".wav"):
        return ak.stream.wav(data, mono, v.get("ignoreHeader", False), device=device)
    if is_("aiff", ".aiff", ".aif"):
        return ak.stream.aiff(data, mono, v.get("ignoreHeader", False))
    if is_("au", ".au"):
        return ak.stream.au(data, mono, v.get("ignoreHeader", False))
    if is_("flac", ".flac"):
        return ak.stream.flac(data, mono, device=device)
    if is_("qoa", ".qoa"):
        return ak.stream.qoa(data, mono, device=device)
    if is_("pcm", ".pcm", ".raw"):
        return ak.stream.pcm(
            data, v.get("bitDepth", 8), v.get("dataType", "signed"), v.get("channels", 1),
            v.get("sampleRate", 48000), v.get("bigEndian", False), mono,
        )
    raise SystemExit("Unknown file type. Make sure to add the right file extension to the path/URL.")


def progress_bar(length: float):
    import shutil

    width = shutil.get_terminal_size().columns

    def cb(pos: float):
        pos = min(pos, 5999)
        total = f"{int(length // 60):02d}:{int(length % 60):02d}" if length else "--:--"
        p = pos / length if length else 0.0
        bar_w = max(width - 14, 4)
        filled = min(int(bar_w * p), bar_w)
        bar = "=" * filled + "░" * (bar_w - filled)
        sys.stdout.write(f"\r{int(pos // 60):02d}:{int(pos % 60):02d} {bar} {total}")
        sys.stdout.flush()

    return cb


def _fleet_source(path: str, v: dict):
    """One Fleet station for a path: raw/headerless formats map through the
    params (the dispatch table's extension rules); containers auto-detect."""
    from ..stream.batch import LaneSpec

    data = open_source(path, False)
    if callable(data):
        raise SystemExit("--fleet requires preloadable sources")
    p = path.lower()
    t = v.get("type")
    if t == "dfpwm" or p.endswith(".dfpwm"):
        if v.get("channels", 1) != 1:
            raise SystemExit("dfpwm fleet stations are mono; use one "
                             "station per channel")
        return (LaneSpec("dfpwm", v.get("sampleRate", 48000), 1), data)
    if t == "pcm" or p.endswith((".pcm", ".raw")):
        from ..stream.fleet import _PCM_CODEC

        codec = _PCM_CODEC.get((v.get("dataType", "signed"),
                                v.get("bitDepth", 8)))
        if codec is None:
            raise SystemExit("unsupported pcm params for --fleet")
        if v.get("bigEndian", False) and codec not in ("pcm8", "pcm8u"):
            codec += "be"
        return (LaneSpec(codec, v.get("sampleRate", 48000),
                         v.get("channels", 1)), data)
    return data  # containers (wav/aiff/au/flac/qoa/mdfpwm) auto-detect


def _fleet_main(args, v: dict, mono: bool):
    """--fleet: every path becomes a batched Fleet station; params'
    ``volume=`` drives the per-station DECODE-side gain (the batched analog
    of speaker volume, applied inside the fused kernel epilogue / DSP scale
    stages), and playback fans stations across sinks via play_fleet."""
    from ..playback import play_fleet
    from ..stream.fleet import Fleet

    from .auplay import make_sink

    paths = [args.path] + list(args.fleet)
    fleet = Fleet([_fleet_source(p, v) for p in paths], mono=mono,
                  channels=max(1, args.speakers),
                  interpolation=v.get("interpolation"), device=args.device)
    if "volume" in v:
        for i in range(len(paths)):
            fleet.set_volume(i, float(v["volume"]))
    # --speakers sinks PER STATION (play_fleet fans window channels across
    # the tuple, matching the non-fleet path's speaker fan-out); -o captures
    # station 0 channel 0
    sinks = [tuple(make_sink(args.out if i == 0 and j == 0 else None,
                             args.realtime)
                   for j in range(max(1, args.speakers)))
             for i in range(len(paths))]
    print(f"Streaming {len(paths)} stations...")
    last = {}

    def progress(i, pos):
        last[i] = pos
        sys.stdout.write(f"\rstations at " + " ".join(
            f"{last.get(k, 0.0):5.1f}s" for k in range(len(paths))))
        sys.stdout.flush()

    import contextlib

    from ..utils.trace import trace_session

    ctx = (trace_session(args.trace, device=args.device) if args.trace
           else contextlib.nullcontext())
    with ctx:
        play_fleet(fleet, sinks, progress=progress)
    print()
    errs = [p for i, p in enumerate(paths) if fleet.station_error(i)]
    if errs:
        print("undecodable stations:", ", ".join(errs))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="austream", description="Stream audio (AUKit austream equivalent)")
    ap.add_argument("path", help="file path, http(s) URL, or - for stdin")
    ap.add_argument("params", nargs="?", help="key=value,... parameters (type, sampleRate, channels, ...)")
    ap.add_argument("-o", "--out", help="output file for 48kHz signed 8-bit samples")
    ap.add_argument("--speakers", type=int, default=1, help="number of output sinks (channels fan out)")
    ap.add_argument("--realtime", action="store_true")
    ap.add_argument("--trace", metavar="DIR", help="write a torch.profiler trace to DIR")
    ap.add_argument("--fleet", nargs="+", metavar="PATH", default=None,
                    help="additional sources: decode ALL paths concurrently "
                         "through the batched Fleet (one station per path; "
                         "params' volume= drives the per-station decode-side "
                         "gain; -o captures station 0)")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="torch device of the decode, the fleet and the trace (default: cuda)")
    args = ap.parse_args(argv)

    import aukit_tpu_torch as ak
    from ..config import CONFIG, require_device
    from .auplay import make_sink

    require_device(args.device, "austream")

    v = parse_params(args.params)
    mono = bool(v.get("mono", args.speakers == 1))
    if "interpolation" in v:
        CONFIG.default_interpolation = v["interpolation"]
    if args.fleet is not None:
        return _fleet_main(args, v, mono)
    data = open_source(args.path, bool(v.get("streamData", False)))
    it, length = dispatch(args.path, data, v, mono, args.device)
    length = length or 0
    print("Streaming...")
    sinks = [make_sink(args.out if i == 0 else None, args.realtime) for i in range(args.speakers)]
    import contextlib

    from ..utils.trace import trace_session

    ctx = (trace_session(args.trace, device=args.device) if args.trace
           else contextlib.nullcontext())
    with ctx:
        ak.play(it, *sinks, progress=progress_bar(length), volume=v.get("volume"))
    print()


if __name__ == "__main__":
    main(sys.argv[1:])
