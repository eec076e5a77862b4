"""auconvert — convert/modify audio files (reference auconvert.lua),
counterpart of ``aukit_tpu.cli.auconvert``.

Faithful port of the reference CLI: paired GNU-style arguments with a
short-option map (auconvert.lua:49-65), the channel-map mini-language parsed by
the same shunting-yard state machine into RPN (111-186), map simplification and
output parameter inference (250-328), RPN evaluation over an audio stack using
split/sub/concat/mix/rep (333-392), the effect chain with pseudo-effects
mono/reverse (394-401), and pcm/dfpwm/wav writers (412-419). ``--device
{cuda,cpu}`` (the card unless ``--device cpu``) is where the loaders decode,
the map, effects and writers run, and ``--fleet``'s engines run; the parser
removes it from the arguments as it removes ``--fleet``.
"""

from __future__ import annotations

import sys

from . import DEVICES

HELP = """auconvert - Modify and convert audio files

Usage: auconvert <options...>

Options:
  -i|--input <path>                 Input file (can specify multiple)
  -o|--output <path>                Output file (can specify multiple)
  -f|--input-format <format>        Format of the last input file
  -F|--output-format <format>       Format of the last output file
    For available formats, use `-[f|F] list`
  -b|--input-bit-depth <bits>       Bit depth of the last input file
  -B|--output-bit-depth <bits>      Bit depth of the last output file
  -t|--input-data-type <type>       Data type of the last input file
  -T|--output-data-type <type>      Data type of the last output file
  -c|--input-channels <number>      Channel count of the last input file
  -C|--output-channels <number>     Channel count of the last output file
  -r|--input-sample-rate <rate>     Sample rate of the last input file
  -R|--output-sample-rate <rate>    Sample rate of the last output file

  -e|--effect <name>[,<args...>]    Apply an effect to the last output file before writing
    For available effects, use `-e list`
  -m|--map <map command>            Map one or more input channels to an output channel
     --interpolation <type>         Set the interpolation type for audio scaling (none, linear, cubic, sinc)
     --device <cuda|cpu>            Torch device of the decode, the processing and the encode
                                    (default: cuda)
     --fleet                        Batched transcode: decode ALL inputs concurrently
                                    (one device fleet) and encode input i to output i
                                    device-to-device. Outputs are mono 48 kHz; formats
                                    dfpwm/wav/pcm (PCM depth via -B); maps/effects are
                                    not available in this mode
  -h|--help                         Show this help

Map command format:
  General form: <input>[<operator><param>]...=<output>
  Multiple files can be specified through <file index>:<channel> (defaults to file 1)
  Only one map can be specified per output channel
  Operators:
    <a>+<b>: Concatenate channels
    <a>&<b>: Mix channels
    <a>*<n>: Repeat channel `n` times
    <a>[[start],[end]]: Split channel (start/end in seconds, negative = from end, end 0 = end of file)
  Examples:
    1=1             -> map input channel 1 to output channel 1
    1:2=2:1         -> map input file 1 channel 2 to output file 2 channel 1
    1&2=1           -> mix input channels 1 & 2 to output channel 1
    1[,10]=1        -> map first 10 seconds of input channel 1 to output channel 1
"""

ARG_MAP = {
    "i": "--input", "o": "--output", "f": "--input-format", "F": "--output-format",
    "b": "--input-bit-depth", "B": "--output-bit-depth", "t": "--input-data-type",
    "T": "--output-data-type", "c": "--input-channels", "C": "--output-channels",
    "r": "--input-sample-rate", "R": "--output-sample-rate", "e": "--effect",
    "m": "--map", "h": "--help",
}
DATA_TYPES = ("signed", "unsigned", "float")
INTERP = ("none", "linear", "cubic", "sinc")
OPS = {"[": 1, "*": 1, "+": 2, "&": 3}


class MapError(SystemExit):
    pass


def parse_map(param: str):
    """Shunting-yard state machine -> (out_file, out_channel, RPN list).
    RPN entries: {'file':f|None,'channel':c} operand, {'start':s,'last':e}
    subscript, int repeat operand, or operator string (auconvert.lua:111-186)."""
    import re

    m = re.match(r"^([\d:+*&,\[\]\(\)]+)=(\d+:?\d*)", param)
    if not m:
        raise MapError("Invalid map command")
    inp, out = m.group(1), m.group(2)
    current = None
    outstack, opstack = [], []
    state = 0
    for n, c in enumerate(inp, 1):
        if state in (0, 1):
            if c.isdigit():
                if state == 1:
                    current = current * 10 + int(c)
                elif current is None:
                    current = {"channel": int(c)}
                else:
                    current["channel"] = current["channel"] * 10 + int(c)
            elif c == ":":
                if state == 1 or current is None or "file" in current:
                    raise MapError(f"Syntax error in map command: unexpected `:` at {n}")
                current["file"], current["channel"] = current["channel"], 0
            elif c in ("*", "["):
                if current is not None:
                    outstack.append(current)
                    current = None
                while opstack and opstack[-1] != "(" and OPS[opstack[-1]] >= OPS[c]:
                    outstack.append(opstack.pop())
                opstack.append(c)
                if c == "*":
                    state = 1
                    current = 0
                else:
                    current = {"start": 0, "last": 0}
                    state = 2
            elif c in ("+", "&"):
                if current is not None:
                    outstack.append(current)
                    current = None
                while opstack and opstack[-1] != "(" and OPS[opstack[-1]] >= OPS[c]:
                    outstack.append(opstack.pop())
                opstack.append(c)
                state = 0
            elif c == "(":
                if current is not None:
                    raise MapError(f"Syntax error in map command: unexpected `(` at {n}")
                opstack.append(c)
            elif c == ")":
                # the reference forgets to flush the pending operand here, so
                # parenthesized maps always fail to evaluate (quirk Q25); fixed
                if current is not None:
                    outstack.append(current)
                    current = None
                while opstack and opstack[-1] != "(":
                    outstack.append(opstack.pop())
                if not opstack:
                    raise MapError(f"Syntax error in map command: unexpected `)` at {n}")
                opstack.pop()
                state = 0
            else:
                raise MapError(f"Syntax error in map command: unexpected token `{c}` at {n}")
        else:  # subscript states 2/3
            if c.isdigit():
                if state == 2:
                    current["start"] = current["start"] * 10 + int(c)
                else:
                    current["last"] = current["last"] * 10 + int(c)
            elif c == ",":
                if state == 3:
                    raise MapError(f"Syntax error in map command: unexpected token `,` at {n}")
                state = 3
            elif c == "]":
                if state == 2:
                    raise MapError(f"Syntax error in map command: expected `,` at {n}")
                outstack.append(current)
                current = None
                state = 0
    if current is not None:
        outstack.append(current)
    while opstack:
        if opstack[-1] == "(":
            raise MapError("Syntax error in map command: expected `)` at <eof>")
        outstack.append(opstack.pop())
    if ":" in out:
        f, ch = out.split(":")
        return int(f), int(ch), outstack
    return 1, int(out), outstack


def load_input(path: str, spec: dict, device="cuda"):
    import aukit_tpu_torch as ak

    with open(path, "rb") as f:
        data = f.read()
    print(f"  File: {path}")
    fmt = spec.get("format")
    guessed_depth = guessed_type = None
    if not fmt:
        p = path.lower()
        if p.endswith(".dfpwm"):
            fmt = "dfpwm"
        elif p.endswith(".wav"):
            fmt = "wav"
        elif p.endswith(".aif") or p.endswith(".aiff"):
            fmt = "aiff"
        elif p.endswith(".au"):
            fmt = "au"
        elif p.endswith(".flac"):
            fmt = "flac"
        elif p.endswith(".qoa"):
            fmt = "qoa"
        elif p.endswith(".mdfpwm"):
            fmt = "mdfpwm"
        elif p.endswith(".pcm") or p.endswith(".raw"):
            fmt, guessed_type, guessed_depth = "pcm", "signed", 8
        else:
            fmt, guessed_depth, guessed_type = ak.detect(data)
        if not fmt:
            raise SystemExit("Could not detect file type.")
    if fmt == "pcm":
        audio = ak.pcm(
            data, spec.get("bitDepth") or guessed_depth or 8,
            spec.get("dataType") or guessed_type or "signed",
            spec.get("channels") or 1, spec.get("sampleRate") or 48000, device=device,
        )
        print(f"  Type: PCM, {spec.get('bitDepth') or guessed_depth} bit {spec.get('dataType') or guessed_type}")
    elif fmt in ("adpcm", "dfpwm"):
        audio = getattr(ak, fmt)(data, spec.get("channels") or 1, spec.get("sampleRate") or 48000,
                                 device=device)
        print(f"  Type: {fmt.upper()}")
    else:
        audio = getattr(ak, fmt)(data, device=device)
        print(f"  Type: {fmt.upper()}")
    if audio.info.get("dataType"):
        print(f"  Sample format: {audio.info['dataType']}")
    if audio.info.get("bitDepth"):
        print(f"  Sample depth: {audio.info['bitDepth']}")
    want = spec.get("channels")
    if want and want != audio.channels:
        while want > audio.channels:
            audio = audio.combine(audio, audio)
        if want < audio.channels:
            audio = audio.split(list(range(1, want + 1)))
    print(f"  Channels: {audio.channels}")
    print(f"  Sample rate: {audio.sample_rate}")
    print(f"  Length: {audio.duration:.3f}s")
    if audio.metadata:
        print("  Metadata:")
        for k, v in audio.metadata.items():
            print(f"    {k}: {v}")
    print()
    return audio


def _fleet_transcode(inputs, outputs, maps, device="cuda"):
    """``--fleet``: N inputs -> N outputs in ONE batched pipeline — every
    input decodes as a Fleet station (container auto-detect, the batched
    aukit.lua:2992-2996 dispatch), every output encodes as a
    BatchEncodeEngine lane, with the decode windows feeding the encoder
    device-to-device (VERDICT r4 item 2's cap; the batched form of
    auconvert.lua:333-419's decode->write pipeline). Outputs are mono
    48 kHz and padded to the engines' one-second window grid."""
    from ..containers.wav import pcm_wav_header
    from ..stream.batch_encode import BatchEncodeEngine, EncodeSpec, transcode_fleet
    from ..stream.fleet import Fleet

    if maps:
        raise SystemExit("--map is not available with --fleet")
    if not outputs:
        raise SystemExit("No outputs specified.")
    if len(outputs) != len(inputs):
        raise SystemExit(
            f"--fleet maps input i to output i: got {len(inputs)} inputs "
            f"but {len(outputs)} outputs")
    specs = []
    for n, out in enumerate(outputs, 1):
        if out.get("effects"):
            raise SystemExit("--effect is not available with --fleet")
        fmt = out.get("format")
        if not fmt:
            p = out["path"].lower()
            fmt = ("dfpwm" if p.endswith(".dfpwm") else
                   "wav" if p.endswith(".wav") else
                   "pcm" if p.endswith((".pcm", ".raw")) else None)
            if fmt is None:
                raise SystemExit("Could not detect file type.")
        out["format"] = fmt
        depth = out.get("bitDepth") or (8 if fmt == "dfpwm" else 16)
        if fmt == "dfpwm":
            specs.append(EncodeSpec("dfpwm"))
        else:
            if depth not in (8, 16, 24, 32):
                raise SystemExit(
                    "--fleet PCM/WAV outputs support bit depths 8/16/24/32")
            specs.append(EncodeSpec(f"pcm{depth}"))
        out["bitDepth"] = depth
        print(f"Output {n}: {out['path']} ({fmt}, {depth}-bit, mono 48000 Hz)")
    sources = []
    for spec in inputs:
        with open(spec["path"], "rb") as f:
            sources.append(f.read())
    print(f"Transcoding {len(sources)} files in one batched fleet...")
    fleet = Fleet(sources, device=device)
    enc = BatchEncodeEngine(specs, device=device)
    bodies = transcode_fleet(fleet, enc)
    for out, body in zip(outputs, bodies):
        data = (pcm_wav_header(1, 48000, out["bitDepth"], len(body)) + body
                if out["format"] == "wav" else body)
        with open(out["path"], "wb") as f:
            f.write(data)
        print(f"Wrote {out['path']} ({len(data)} bytes)")


def main(argv=None):
    import aukit_tpu_torch as ak
    from ..config import CONFIG, require_device

    args = list(sys.argv[1:] if argv is None else argv)
    fleet_mode = "--fleet" in args
    while "--fleet" in args:
        args.remove("--fleet")
    device = "cuda"
    while "--device" in args:
        at = args.index("--device")
        if at + 1 >= len(args) or args[at + 1] not in DEVICES:
            raise SystemExit("--device takes one of: " + ", ".join(DEVICES))
        device = args[at + 1]
        del args[at : at + 2]
    inputs, outputs, maps = [], [], {}

    def cur(lst, flag, what):
        # per-file flags bind to the LAST -i/-o (reference positional
        # semantics, auconvert.lua:89-110; it errors on a nil index — we
        # error with a message)
        if not lst:
            raise SystemExit(f"{flag} requires a preceding {what}")
        return lst[-1]

    i = 0
    while i < len(args):
        arg, param = args[i], args[i + 1] if i + 1 < len(args) else None
        i += 2
        if len(arg) == 2 and arg[0] == "-":
            arg = ARG_MAP.get(arg[1], arg)
        if not arg.startswith("--"):
            raise SystemExit(f"Invalid argument at position {i - 1}")
        if arg != "--help" and param is None:
            raise SystemExit(f"Missing parameter to {arg}")
        if arg == "--input":
            inputs.append({"path": param})
        elif arg == "--output":
            outputs.append({"path": param})
        elif arg == "--input-format":
            if param == "list":
                print("List of input formats: adpcm, aiff, au, dfpwm, flac, mdfpwm, pcm, qoa, wav")
                return
            if not hasattr(ak, param):
                raise SystemExit("Invalid input format")
            cur(inputs, arg, "--input")["format"] = param
        elif arg == "--output-format":
            if param == "list":
                print("List of output formats: dfpwm, pcm, wav")
                return
            cur(outputs, arg, "--output")["format"] = param
        elif arg == "--input-bit-depth":
            cur(inputs, arg, "--input")["bitDepth"] = int(param)
        elif arg == "--output-bit-depth":
            cur(outputs, arg, "--output")["bitDepth"] = int(param)
        elif arg == "--input-data-type":
            if param not in DATA_TYPES:
                raise SystemExit("Invalid type")
            cur(inputs, arg, "--input")["dataType"] = param
        elif arg == "--output-data-type":
            if param not in DATA_TYPES:
                raise SystemExit("Invalid type")
            cur(outputs, arg, "--output")["dataType"] = param
        elif arg == "--input-channels":
            cur(inputs, arg, "--input")["channels"] = int(param)
        elif arg == "--output-channels":
            cur(outputs, arg, "--output")["channels"] = int(param)
        elif arg == "--input-sample-rate":
            cur(inputs, arg, "--input")["sampleRate"] = int(param)
        elif arg == "--output-sample-rate":
            cur(outputs, arg, "--output")["sampleRate"] = int(param)
        elif arg == "--effect":
            if param == "list":
                names = sorted(
                    ["mono", "reverse"]
                    + [k for k in dir(ak.effects) if not k.startswith("_") and callable(getattr(ak.effects, k))]
                )
                print("List of effects: " + ", ".join(names))
                return
            e = []
            for s in param.split(","):
                try:
                    e.append(float(s) if "." in s else int(s))
                except ValueError:
                    e.append(s)
            cur(outputs, arg, "--output").setdefault("effects", []).append(e)
        elif arg == "--map":
            f, ch, rpn = parse_map(param)
            maps.setdefault(f, {})
            if ch in maps[f]:
                raise SystemExit(f"Mapping already exists for file {f}, channel {ch}")
            maps[f][ch] = rpn
        elif arg == "--interpolation":
            if param not in INTERP:
                raise SystemExit("Invalid interpolation type")
            CONFIG.default_interpolation = param
        elif arg == "--help":
            print(HELP)
            return
        else:
            print(f"Unknown argument {arg}, use --help for help")

    print(f"auconvert, using aukit-tpu {ak.__version__} (AUKit {ak._REFERENCE_VERSION} semantics)")
    if not inputs:
        raise SystemExit("No inputs specified.")
    require_device(device, "auconvert")
    if fleet_mode:
        return _fleet_transcode(inputs, outputs, maps, device)
    for n, spec in enumerate(inputs, 1):
        print(f"Input {n}:")
        spec["audio"] = load_input(spec["path"], spec, device)

    if not outputs:
        raise SystemExit("No outputs specified.")
    used = set()
    if not maps:
        for n in range(1, len(inputs) + 1):
            if n > len(outputs):
                raise SystemExit(
                    "Not enough outputs for the specified inputs. Add more outputs, or use --map."
                )
            maps[n] = n
    # simplify identity maps (auconvert.lua:260-269)
    for k, v in list(maps.items()):
        if isinstance(v, dict):
            src = None
            ok = True
            for ch, rpn in v.items():
                if (
                    len(rpn) == 1
                    and isinstance(rpn[0], dict)
                    and rpn[0].get("channel") == ch
                    and (src is None or rpn[0].get("file") == src)
                ):
                    src = rpn[0].get("file")
                else:
                    ok = False
                    break
            if ok and src is not None:
                maps[k] = src

    for n, out in enumerate(outputs, 1):
        print(f"Output {n}:")
        m = maps.get(n)
        if m is None:
            raise SystemExit("Missing mappings for file. Please specify --map parameters for this file.")
        if isinstance(m, int):
            if m > len(inputs):
                raise SystemExit(f"Mapped input {m} does not exist.")
            inp = inputs[m - 1]
            used.add(m)
            out.setdefault("bitDepth", inp.get("bitDepth") or inp["audio"].info.get("bitDepth") or 8)
            out.setdefault("dataType", inp.get("dataType") or inp["audio"].info.get("dataType") or "signed")
            out.setdefault("channels", inp.get("channels") or inp["audio"].channels)
            out.setdefault("sampleRate", inp["audio"].sample_rate)
        else:
            bit_depth, data_type, channels, sample_rate = 8, "signed", 1, 1
            for ch, rpn in m.items():
                channels = max(channels, ch)
                for tok in rpn:
                    if isinstance(tok, dict) and "channel" in tok:
                        fidx = tok.get("file") or n
                        if fidx > len(inputs):
                            raise SystemExit(f"Mapped input {fidx} does not exist.")
                        inp = inputs[fidx - 1]
                        used.add(fidx)
                        bit_depth = max(bit_depth, inp.get("bitDepth") or inp["audio"].info.get("bitDepth") or 8)
                        sample_rate = max(sample_rate, inp["audio"].sample_rate)
                        if inp.get("dataType") == "float" or inp["audio"].info.get("dataType") == "float":
                            data_type = "float"
            out.setdefault("bitDepth", bit_depth)
            out.setdefault("dataType", data_type)
            out.setdefault("channels", channels)
            out.setdefault("sampleRate", sample_rate)
            for c in range(1, out["channels"] + 1):
                if c not in m:
                    raise SystemExit(f"Missing mapping for channel {c}.")
        if out.get("format") == "wav":
            if out["bitDepth"] == 1:
                out["dataType"] = "dfpwm"
            elif out["bitDepth"] == 8:
                out["dataType"] = "unsigned"
            else:
                out["dataType"] = "signed"
        if not out.get("format"):
            p = out["path"].lower()
            if p.endswith(".dfpwm"):
                out["format"] = "dfpwm"
            elif p.endswith(".wav"):
                out["format"] = "wav"
            elif p.endswith(".pcm") or p.endswith(".raw"):
                out["format"] = "pcm"
            else:
                raise SystemExit("Could not detect file type.")
        print(f"  File: {out['path']}")
        print(f"  Type: {out['format'].upper()}")
        print(f"  Sample format: {out['dataType']}")
        print(f"  Sample depth: {out['bitDepth']}")
        print(f"  Channels: {out['channels']}")
        print(f"  Sample rate: {out['sampleRate']}")
        print()

    for k in maps:
        if k > len(outputs):
            raise SystemExit(f"Mappings were specified for output {k}, but no path was specified.")
    for n in range(1, len(inputs) + 1):
        if n not in used:
            print(f"Warning: Input {n} was never used. Consider mapping it to an output.")

    for n, out in enumerate(outputs, 1):
        print(f"Processing output {n}...")
        m = maps[n]
        if isinstance(m, dict):
            channels = {}
            for ch, rpn in m.items():
                stack = []
                for tok in rpn:
                    if isinstance(tok, dict) and ("start" in tok or "last" in tok) and "channel" not in tok:
                        if not stack:
                            raise SystemExit("Syntax error in map command: Not enough arguments")
                        stack[-1] = stack[-1].sub(tok["start"], tok["last"])
                    elif isinstance(tok, dict):
                        fidx = tok.get("file") or n
                        stack.append(inputs[fidx - 1]["audio"].split([tok["channel"]]))
                    elif isinstance(tok, (int, float)):
                        stack.append(tok)
                    elif tok == "+":
                        b, a = stack.pop(), stack.pop()
                        stack.append(a.concat(b))
                    elif tok == "&":
                        b, a = stack.pop(), stack.pop()
                        stack.append(a.mix(b))
                    elif tok == "*":
                        b, a = stack.pop(), stack.pop()
                        if isinstance(a, (int, float)):
                            a, b = b, a
                        stack.append(a.rep(int(b)))
                if len(stack) != 1:
                    raise SystemExit("Syntax error in map command: Wrong number of arguments")
                channels[ch] = stack[0]
            ordered = [channels[c] for c in sorted(channels)]
            audio = ordered[0].combine(*ordered[1:]) if len(ordered) > 1 else ordered[0]
        else:
            audio = inputs[m - 1]["audio"]
        for e in out.get("effects", []):
            name, params = e[0], e[1:]
            print(f"> Processing effect ({name})")
            if name in ("mono", "reverse"):
                audio = getattr(audio, name)()
            else:
                fx = getattr(ak.effects, str(name), None)
                if fx is None or not callable(fx) or str(name).startswith("_") or str(name) in ("Audio", "np", "torch"):
                    raise SystemExit(f"Unknown effect {name!r} (use -e list)")
                fx(audio, *params)
        if audio.channels > out["channels"]:
            audio = audio.split(list(range(1, out["channels"] + 1)))
        if audio.sample_rate != out["sampleRate"]:
            print("> Resampling")
            audio = audio.resample(out["sampleRate"])
        print("> Writing file")
        if out["format"] == "pcm":
            data = audio.to_pcm_bytes(out["bitDepth"], out["dataType"], interleaved=True)
        elif out["format"] == "dfpwm":
            data = audio.dfpwm()
        else:
            data = audio.wav(out["bitDepth"])
        with open(out["path"], "wb") as f:
            f.write(data)
        print(f"Completed processing file {n}.")


if __name__ == "__main__":
    main()
