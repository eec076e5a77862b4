"""What the compiler made of the port's CUDA kernels, and how fast they run.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit (imports torch, numpy, aukit_tpu_torch and chip_smoke's helpers; no
JAX):

    python3 tools/cuda_kernel_probe.py sass  [--csrc DIR] [--out DIR] [PATTERN ...]
    python3 tools/cuda_kernel_probe.py check [--csrc DIR]
    python3 tools/cuda_kernel_probe.py bench [--csrc DIR] [--iters N]
    python3 tools/cuda_kernel_probe.py bench --only KERNEL ... [--shape LxT ...]

``sass`` builds the kernel library, prints ``ptxas -v``'s registers, spills
and shared memory of every kernel whose demangled name contains one of the
patterns (default: the DFPWM decode instantiations, the DFPWM encode, the
LPC restore, the zero-state lowpass, the QOA LMS and the MS and IMA ADPCM
decodes), and from ``cuobjdump -sass`` the
instruction count of each of its loops (a loop is a backward branch: the
instructions from its target to the branch), with the opcode histogram of
the largest loop. The DFPWM decode loop holds 16 samples (two bytes), the
encode loop 32 (one word of bits out; the first version's held 8), so the
count over that is the instructions per sample; the LPC loops hold as many
samples as the source unrolls, the lowpass's tile 64; the QOA LMS and the MS
ADPCM and IMA decodes hold four 16-byte groups (32, 64 and 64 samples) in
the loop over a whole tile, and the tile loop around it (the largest: 128
samples with their copies, stores and barriers) holds one more group for a
row's edge tiles. ``--out`` keeps each kernel's SASS in a file.

``check`` holds each kernel against its plain version and times nothing:
(a), (b), (d) and (g) at a small shape, (a) to (h) on every case of
tests/torch_kernel_cases.py. ``bench`` does the same, then times every
kernel alone by CUDA events at the shapes chip_smoke.py times them (random
bytes instead of encoded tones; (c) also at a transcode window's two
launches, (h) at a 48 kHz and a 44.1 kHz fleet step's rows, (d), (e), (f)
at bench.py's 16384 lanes and at the one launch of a block-fleet window),
and a transcode window's three encoders on windows that live on the card, in
sequence and through ``encode_windows_many``.

``bench --only`` times only the kernels named (``dfpwm_decode``,
``dfpwm_decode_dsp``, ``ima``, ``msadpcm``, ``qoa``) at their shapes, or the
block kernels at ``--shape``'s, without the checks.

``--csrc DIR`` builds another directory of sources (an earlier commit's
``aukit_tpu_torch/csrc``) instead, to compare two versions on one card in
one call.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from aukit_tpu_torch.kernels import _build  # noqa: E402
from aukit_tpu_torch.kernels import adpcm_cuda as ka  # noqa: E402
from aukit_tpu_torch.kernels import dfpwm_cuda as kc  # noqa: E402
from aukit_tpu_torch.kernels import flac_cuda as kg  # noqa: E402
from aukit_tpu_torch.kernels import iir_cuda as kh  # noqa: E402
from aukit_tpu_torch.kernels import qoa_cuda as kq  # noqa: E402

BLOCK_KERNEL_NAMES = {"ima": "ima_decode_kernel", "msadpcm": "msadpcm_decode_kernel",
                      "qoa": "qoa_lms_kernel"}
DEFAULT_PATTERNS = ("dfpwm_decode_kernel", "dfpwm_encode_kernel", "lpc_restore_kernel",
                    "iir_zero_kernel", "qoa_lms_kernel", "msadpcm_decode_kernel",
                    "ima_decode_kernel")


def ptxas_report(log: str) -> dict:
    """{kernel<template args>: ptxas -v's lines for it, joined}."""
    out, name = {}, None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            name = cs.demangle(m.group(1))
            out[name] = []
        elif name and ("Used" in ln or "spill" in ln):
            out[name].append(ln.split("ptxas info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def functions(sass: str) -> dict:
    """{mangled name: [(address, predicate, opcode, operands)]} of cuobjdump -sass."""
    out, cur = {}, None
    for ln in sass.splitlines():
        if m := re.search(r"Function : (\S+)", ln):
            cur = out.setdefault(m.group(1), [])
        elif cur is not None and (m := re.match(
                r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\d+\s+)?([A-Z0-9_.]+)\s*([^;]*);", ln)):
            cur.append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3), m.group(4)))
    return out


def loops(instrs: list) -> list:
    """[(target address, branch address, instructions inside)] of each
    backward branch, NOPs not counted."""
    out = []
    for addr, _pred, op, operands in instrs:
        if op.startswith("BRA") and (m := re.search(r"0x([0-9a-f]+)", operands)):
            target = int(m.group(1), 16)
            if target <= addr:
                body = [i for i in instrs if target <= i[0] <= addr and i[2] != "NOP"]
                out.append((target, addr, body))
    return out


def cmd_sass(args) -> None:
    lib = _build.load()
    so = Path(lib._name)
    report = ptxas_report((_build.BUILD_DIR / "build.log").read_text())
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    patterns = args.patterns or DEFAULT_PATTERNS
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
    for sym, instrs in functions(sass).items():
        name = cs.demangle(sym)
        if not any(p in name for p in patterns):
            continue
        real = [i for i in instrs if i[2] != "NOP"]
        print(f"[sass] kernel={name} instructions={len(real)} ptxas=\"{report.get(name, '?')}\"")
        found = loops(instrs)
        for target, addr, body in found:
            print(f"[sass]   loop 0x{target:04x}..0x{addr:04x} instructions={len(body)}")
        if found:
            body = max(found, key=lambda lp: len(lp[2]))[2]
            hist = collections.Counter(op.split(".")[0] for _a, _p, op, _o in body)
            print("[sass]   largest loop: " + " ".join(f"{k}={v}" for k, v in hist.most_common()))
        if args.out:
            text = "\n".join(f"{a:05x} {p:6s} {op} {ops}" for a, p, op, ops in instrs)
            (Path(args.out) / (re.sub(r"\W+", "_", name) + ".sass")).write_text(text + "\n")


def checks(rng) -> None:
    """Each kernel against its plain version, max |error| 0."""
    # right before fast: each kernel against its plain version at a small shape
    lanes, nbytes = 200, 77
    data = torch.tensor(rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8), device="cuda")
    st = cs.random_state(rng, lanes)
    mask = torch.tensor(rng.random(lanes) < 0.8, device="cuda")
    gain = (torch.tensor(rng.uniform(0.2, 1.8, lanes).astype(np.float32), device="cuda"),
            torch.tensor((rng.uniform(-1, 1, lanes) / 600).astype(np.float32), device="cuda"))
    for name, got, want in (
            ("dfpwm_decode", kc.dfpwm_decode_kernel(data, st), kc.dfpwm_decode_ref(data, st)),
            ("dfpwm_decode_dsp", kc.dfpwm_decode_dsp_kernel(data, st, cs.ALPHA_48K, mask),
             kc.dfpwm_decode_dsp_ref(data, st, cs.ALPHA_48K, mask)),
            ("dfpwm_decode_dsp_gain", kc.dfpwm_decode_dsp_kernel(data, st, cs.ALPHA_48K, mask, gain),
             kc.dfpwm_decode_dsp_ref(data, st, cs.ALPHA_48K, mask, gain))):
        ok = cs.same(got[0], want[0])[0] and cs.same(got[1], want[1])[0]
        cs.say("probe_check", kernel=name, equal=ok)
        cs.check(ok, f"{name} kernel == plain")
    for rows, T, order in ((70, 300, 32), (130, 600, 13), (300, 257, 8), (65, 70, 3)):
        a = cs.lpc_args(rng, rows, T, order)
        ok = torch.equal(kg.lpc_restore_kernel(*a), kg.lpc_restore_ref(*a))
        cs.say("probe_check", kernel="lpc_restore", rows=rows, T=T, order=order, equal=ok)
        cs.check(ok, "lpc_restore kernel == plain")

    nibs = torch.tensor(rng.integers(0, 16, (130, 300), dtype=np.uint8), device="cuda")
    st = (cs.cuda_i32(rng.integers(-32768, 32768, 130)), cs.cuda_i32(rng.integers(0, 89, 130)))
    ok = cs.chained_vs_plain(ka.ima_decode_kernel, ka.ima_decode_ref, [nibs, nibs], st)[0]
    cs.say("probe_check", kernel="ima_decode", equal=ok)
    cs.check(ok, "ima_decode kernel == plain")

    cases = cs.load_test_module("torch_kernel_cases")
    for kernel, found in {**cs.decode_kernel_cases(cases),
                          **cs.window_kernel_cases(cases)}.items():
        for name, ok, _err in found:
            cs.say("probe_check", kernel=kernel, case=name, equal=ok)
            cs.check(ok, f"{kernel} kernel == plain on case {name}")
    for name, calls, st in cases.encode_cases("cuda"):
        ref_st = st
        for x in calls:
            (out, st), (ref, ref_st) = kc.dfpwm_encode_kernel(x, st), kc.dfpwm_encode_ref(x, ref_st)
            ok = cs.same(out, ref)[0] and cs.same(st, ref_st)[0]
            cs.say("probe_check", kernel="dfpwm_encode", case=name, equal=ok)
            cs.check(ok, f"dfpwm_encode kernel == plain on case {name}")
    for name, x, alpha in cases.iir_cases("cuda"):
        ok = torch.equal(kh.iir_zero_kernel(x, alpha), kh.iir_zero_ref(x, alpha))
        cs.say("probe_check", kernel="iir_zero", case=name, equal=ok)
        cs.check(ok, f"iir_zero kernel == plain on case {name}")


def kernel_only_ms(call, name: str, iters: int = 5) -> float:
    """Mean device milliseconds of the kernels whose name contains ``name``
    over ``iters`` calls (torch.profiler): the kernel without the wrapper's
    small torch ops around it."""
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return sum(spans) / max(len(spans), 1) / 1e3


def cmd_check(args) -> None:
    smi = cs.phase_device()
    _build.load()
    checks(np.random.default_rng(21))
    print(smi, flush=True)


def bench_block_kernels(rng, best, names, shapes=()) -> None:
    """(d), (e), (f) at bench.py's 16384 lanes, then at a block-fleet
    window's one launch (or at the given shapes): the wrapper's call by CUDA
    events, and the kernel alone by the profiler."""
    for name in names:
        for lanes, T in shapes or (cs.BLOCK_BENCH_SHAPES[name], cs.block_fleet_shape(name)):
            call = cs.block_kernel_call(rng, name, lanes, T)
            cs.say("probe_time", kernel=name, lanes=lanes, samples=T, ms=round(best(call), 4),
                   kernel_only_ms=round(kernel_only_ms(call, BLOCK_KERNEL_NAMES[name]), 4))
            del call
            torch.cuda.empty_cache()


DFPWM_DECODERS = ("dfpwm_decode", "dfpwm_decode_dsp")


def bench_dfpwm_decoders(rng, best, names) -> None:
    """(a) at the headline shape, the mixed fleet's 32 kHz group and 512
    bytes; (b) at an identity step's 6000 bytes and 512, without and with a
    gain ramp: the wrapper's call by CUDA events."""
    full = cs.FULL_LANES
    if "dfpwm_decode" in names:
        for lanes, nbytes in ((full, 24576), (full // 2, 4000), (full, 512)):
            data = torch.randint(0, 256, (lanes, nbytes), dtype=torch.uint8, device="cuda")
            st = cs.random_state(rng, lanes)
            cs.say("probe_time", kernel="dfpwm_decode", lanes=lanes, bytes=nbytes,
                   ms=round(best(lambda: kc.dfpwm_decode_kernel(data, st)), 4))
            del data
    if "dfpwm_decode_dsp" in names:
        for lanes, nbytes in ((full, 6000), (full, 512)):
            data = torch.randint(0, 256, (lanes, nbytes), dtype=torch.uint8, device="cuda")
            st = cs.random_state(rng, lanes)
            live = torch.ones(lanes, dtype=torch.bool, device="cuda")
            gain = (torch.full((lanes,), 0.7, device="cuda"),
                    torch.full((lanes,), 1e-6, device="cuda"))
            cs.say("probe_time", kernel="dfpwm_decode_dsp", lanes=lanes, bytes=nbytes,
                   ms=round(best(lambda: kc.dfpwm_decode_dsp_kernel(data, st, cs.ALPHA_48K, live)),
                            4),
                   gain_ms=round(best(lambda: kc.dfpwm_decode_dsp_kernel(
                       data, st, cs.ALPHA_48K, live, gain)), 4))
            del data
    torch.cuda.empty_cache()


def say_clocks() -> None:
    """The SM clock right after the timed kernels, beside its maximum."""
    got = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cs.say("probe_clocks", sm_and_max=json.dumps(got))


def cmd_bench(args) -> None:
    smi = cs.phase_device()
    _build.load()
    rng = np.random.default_rng(21)

    def best(fn) -> float:
        fn()
        return min(cs.event_ms(fn, args.iters) for _ in range(3))

    if args.only:
        bench_dfpwm_decoders(rng, best, [k for k in DFPWM_DECODERS if k in args.only])
        bench_block_kernels(rng, best, [k for k in args.only if k in BLOCK_KERNEL_NAMES],
                            [tuple(map(int, sh.split("x"))) for sh in args.shape or ()])
        say_clocks()
        print(smi, flush=True)
        return
    checks(rng)
    bench_dfpwm_decoders(rng, best, DFPWM_DECODERS)
    torch.cuda.empty_cache()
    # (c): full width, then a transcode window's two launches (mono rows of
    # one second, interleaved stereo rows of twice the length)
    for lanes, n in ((cs.FULL_LANES, 48000), (cs.TRANSCODE_MONO, 48000), (cs.TRANSCODE_STEREO, 96000)):
        x = torch.randint(-128, 128, (lanes, n), dtype=torch.int8, device="cuda")
        st = cs.DfpwmState.zeros(lanes, "cuda")
        cs.say("probe_time", kernel="dfpwm_encode", lanes=lanes, samples=n,
               ms=round(best(lambda: kc.dfpwm_encode_kernel(x, st)), 4))
        del x
    torch.cuda.empty_cache()
    # (h): full width, then a fleet step's rows on and off the 16-byte grid
    for rows, T in ((cs.LPC_ROWS, cs.FLAC_N), (cs.LPC_FLEET_ROWS, cs.FLAC_N),
                    (cs.IIR_44K_ROWS, cs.IIR_44K_LEN), (cs.LPC_FLEET_ROWS, cs.IIR_44K_LEN),
                    (2048, cs.FLAC_N)):
        x = cs.iir_args(rng, rows, T)
        cs.say("probe_time", kernel="iir_zero", rows=rows, samples=T,
               ms=round(best(lambda: kh.iir_zero_kernel(*x)), 4))
        del x
    torch.cuda.empty_cache()
    bench_block_kernels(rng, best, BLOCK_KERNEL_NAMES)
    for rows in (cs.LPC_ROWS, 7168, 2048):
        a = cs.lpc_bench_args(rng, rows, cs.FLAC_N)
        cs.say("probe_time", kernel="lpc_restore", rows=rows, samples=cs.FLAC_N, K=8,
               ms=round(best(lambda: kg.lpc_restore_kernel(*a, K=8)), 4))
    # one warp a scheduler: the row's own chain, by tap count (taps past 8 are zero)
    a = cs.lpc_bench_args(rng, 2048, cs.FLAC_N)
    for K in (8, 16, 32):
        cs.say("probe_time", kernel="lpc_restore", rows=2048, samples=cs.FLAC_N, K=K,
               ms=round(best(lambda: kg.lpc_restore_kernel(*a, K=K)), 4))
    for K in (4, 16, 32):
        a = cs.lpc_args(rng, 8192, 4096, K)
        cs.say("probe_time", kernel="lpc_restore", rows=8192, samples=4096, K=K,
               ms=round(best(lambda: kg.lpc_restore_kernel(*a, K=K)), 4))
    # a transcode window's three encoders on windows that live on the card:
    # one after the other on one stream, then side by side on streams
    torch.cuda.empty_cache()
    mono, stereo = cs.TRANSCODE_MONO, cs.TRANSCODE_STEREO
    engines = cs.transcode_engines("cuda", mono, stereo)[2:]
    wm = torch.randint(-128, 128, (mono, 48000), dtype=torch.int8, device="cuda")
    ws = torch.randint(-128, 128, (stereo, 2, 48000), dtype=torch.int8, device="cuda")
    jobs = [(engines[0], wm, np.ones(mono, bool)), (engines[1], ws, np.ones(stereo, bool)),
            (engines[2], ws, np.ones(stereo, bool))]
    cs.say("probe_time", case="transcode_window_encoders", mono_lanes=mono, stereo_lanes=stereo,
           in_sequence_ms=round(best(lambda: [e.encode_windows(w, m) for e, w, m in jobs]), 4),
           on_streams_ms=round(best(lambda: cs.encode_windows_many(jobs)), 4))
    say_clocks()
    print(smi, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sass")
    p.add_argument("--out")
    p.add_argument("patterns", nargs="*")
    p.set_defaults(fn=cmd_sass)
    p = sub.add_parser("check")
    p.set_defaults(fn=cmd_check)
    p = sub.add_parser("bench")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--only", nargs="*", metavar="KERNEL",
                   choices=[*DFPWM_DECODERS, *BLOCK_KERNEL_NAMES],
                   help="time only these kernels (and skip the checks)")
    p.add_argument("--shape", nargs="*", metavar="LANESxSAMPLES",
                   help="with --only: these shapes instead of the bench and fleet shapes")
    p.set_defaults(fn=cmd_bench)
    for q in sub.choices.values():
        q.add_argument("--csrc", help="build this directory of sources instead")
    args = ap.parse_args()
    if args.csrc:
        _build.SRC_DIR = Path(args.csrc).resolve()
    args.fn(args)


if __name__ == "__main__":
    main()
