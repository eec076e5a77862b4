"""Smoke test of the PyTorch/CUDA port (aukit_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with the card and the CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from aukit_tpu_torch/csrc and the native FLAC
parser, checks the kernels against golden vectors and against their plain
PyTorch versions on the card (also at the main paths' own shapes and bytes),
checks the CUDA engines and the Fleet facade against the CPU ones, drives
the six main paths at full width (the batched DFPWM -> 48 kHz int8 engine, a
32768-lane block-codec fleet of IMA, MS ADPCM, QOA, PCM16 and µ-law lanes, a
2048-lane drip-fed FLAC fleet, the FLAC host route's float64 DSP kernel at
the radio cell's 1024 lanes against the numpy route, a 24576-lane device-to-device transcode of
mono and stereo PCM16 into DFPWM and PCM16, the auplay DSP chain on 16384
PCM16 lanes, a 3072-station Fleet of FLAC, DFPWM and IMA-in-WAV, auplay's
whole-file preload chain on 3-minute tracks in every container and a
60-minute WAV, bench.py config 5's effects chain on 64 channels of 180 s
with every other effect on a stereo track, and every single-stream iterator
over those 3-minute files with stream.pcm's device twin on the card; and
the four programs and playback: auplay and austream on those files, play
and player over the twin's CUDA chunks, austream --fleet over 3072 stations
and auconvert --fleet of 3072 inputs, auconvert's test cases and play_file;
and the multi-device layer: the 32768-lane DFPWM engine over four lane
shards of one card (and over every card where there are two or more),
sharded_pipeline_step, sharded check-size engines of every kind and
MultiHostEngine in two processes over gloo, each equal to its unsharded card
run; and the three example servers of aukit_tpu_torch.examples at half
their fleet width, the FLAC one on the host restore and on kernel (g), each
equal to its CPU run at a check size, the CPU runs in a process of their
own with no card visible), and times the kernels, each beside its bound on
the card, also at the whole-file loaders' and the iterators' shapes. Each phase prints its lines
(and its seconds on the closing ``[phase_seconds]`` line); any failure
raises, so the exit code is non-zero and the closing result line is not
printed. It exits non-zero at once without a CUDA device.
Imports only torch, numpy, aukit_tpu_torch and tests/fixtures.py (numpy and
struct only), tests/torch_kernel_cases.py and tests/torch_tracks.py (both
numpy, torch and aukit_tpu_torch only), each by path; it runs
tests/torch_dist_worker.py (torch, numpy and aukit_tpu_torch only) in two
processes, and itself, with no card visible, in a process for the example
servers' CPU runs and one for each phase's CPU replays of recorded kernel
calls, each going on alongside the card work.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import hashlib
import importlib.util
import inspect
import io
import json
import os
import re
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

import aukit_tpu_torch as tk
from aukit_tpu_torch import (BatchDfpwmDecoder, BatchEncodeEngine, BatchStreamEngine, EncodeSpec,
                             FlacFleet, Fleet, LaneSpec, encode_windows_many, kernels,
                             transcode_fleet)
from aukit_tpu_torch import effects as tfx
from aukit_tpu_torch.codecs.adpcm import MSADPCM_ADAPTION, MSADPCM_DEFAULT_COEFFS
from aukit_tpu_torch.codecs.dfpwm import DfpwmState
from aukit_tpu_torch.containers.wav import pcm_wav_header
from aukit_tpu_torch.examples import batch_server, flac_radio_fleet, mixed_fleet_server
from aukit_tpu_torch.kernels import _build
from aukit_tpu_torch.kernels import adpcm_cuda as ka
from aukit_tpu_torch.kernels import dfpwm_cuda as kc
from aukit_tpu_torch.kernels import flac_cuda as kg
from aukit_tpu_torch.kernels import flac_dsp_cuda as kd
from aukit_tpu_torch.kernels import fma_cuda as kf
from aukit_tpu_torch.kernels import iir_cuda as kh
from aukit_tpu_torch.kernels import qoa_cuda as kq
from aukit_tpu_torch.native import flacbits
from aukit_tpu_torch.ops import resample as ores
from aukit_tpu_torch.ops import scan as oscan
from aukit_tpu_torch.ops.resample import resample_plan
from aukit_tpu_torch.parallel import pipeline as sp
from aukit_tpu_torch.parallel.pipeline import fir_alpha, make_mesh
from aukit_tpu_torch.stream import batch as sb
from aukit_tpu_torch.stream import batch_codecs as bc
from aukit_tpu_torch.stream import engine as sengine
from aukit_tpu_torch.stream import flac_fleet as ff
from aukit_tpu_torch.stream.batch_encode import ENCODE_CODECS

ROOT = Path(__file__).resolve().parent
FULL_LANES = 32768  # bench.py's headline fleet: 8 groups of 4096 streams
ALPHA_48K = fir_alpha(48000, 48000)

# The card's published peaks (NVIDIA's H100 SXM data sheet): 3.35 TB/s of
# device memory, 67 TFLOP/s float32 outside the tensor cores. That float32
# rate counts a fused multiply-add as two, so it is 33.5e12 operations a
# second, which is taken here as the peak for int32 and float32 operations
# alike (the data sheet gives no int32 rate; the true one is no higher).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
# Arithmetic operations per sample of each kernel, counted from its source
# (compares, selects, adds, shifts, multiplies; loads and stores not counted).
# DFPWM: the shared predictor is 17 (target select, subtract, multiply, add,
# shift, add, two compares and an and for the stall nudge, select, add, the
# strength's compare, two selects, compare, add, max); the decoder adds the
# antijerk (4), the lowpass (5) and the byte pack (2); its fused epilogue adds
# 9 float operations; the encoder adds the bit decision (5) and the pack (2).
# IMA: step lookup, 3 conditional adds of the shifted step (6), sign (2),
# add, clamp (2), index add, lookup, clamp (2). MS ADPCM: 2 multiplies, add,
# shift, multiply, add, clamp (2), adaption lookup, multiply, shift, clamp
# (2). QOA: the 4-tap prediction (7), shift, add, clamp (2), the weight
# update (9), the history shift (3). LPC restore: a 64-bit multiply-add per
# tap (2 each), shift, add, store select. One-pole lowpass: a multiply and a
# fused multiply-add. FMA: one.
OPS_PER_SAMPLE = {"dfpwm_decode": 28, "dfpwm_decode_dsp": 37, "dfpwm_encode": 24, "ima": 16,
                  "msadpcm": 13, "qoa": 23, "iir_zero": 2, "fma": 1}


def lpc_ops_per_sample(order: int) -> int:
    return 2 * order + 3


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes the
    function must move over the memory rate and its operations over the
    peak rate; and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing(name: str, ms: float, plain_ms: float, ops: float, nbytes: float,
           library_ms: float | None = None) -> dict:
    """One kernel's row of numbers for the closing ``kernels`` line."""
    b, by = bound_ms(ops, nbytes)
    say("bound", kernel=name, ms=round(ms, 4), bound_ms=round(b, 4), bound_by=by,
        share_of_bound=round(b / ms, 4), library_ms=library_ms)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": library_ms}


PHASE_SECONDS: dict = {}


def phase(fn):
    """Adds each call's seconds to ``PHASE_SECONDS`` under the function's
    name (the ``[phase_seconds]`` line; a phase's seconds include those of
    a phase it calls: transcode's include transcode_breakdown's)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            name = fn.__name__.removeprefix("phase_")
            PHASE_SECONDS[name] = round(PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0,
                                        1)
    return run


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def sync_time() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def event_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn):
    """(fn(), device milliseconds of that one call), by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def random_state(rng, lanes: int) -> DfpwmState:
    leaves = (rng.integers(-128, 128, lanes), rng.integers(8, 1024, lanes),
              rng.integers(0, 2, lanes), rng.integers(-128, 128, lanes),
              rng.integers(-128, 128, lanes))
    return DfpwmState(*(torch.tensor(a.astype(np.int32), device="cuda") for a in leaves))


def deep_equal(a, b) -> bool:
    """Checkpoint-shaped values (dicts, lists, tuples, numpy arrays, bytes,
    scalars) equal, arrays bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            deep_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(deep_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def same(a, b) -> tuple[bool, int]:
    """(equal, max |a - b|) of two int tensors, two DfpwmStates or two
    kernel-state tuples."""
    if isinstance(a, DfpwmState):
        pairs = zip(a.leaves(), b.leaves())
    elif isinstance(a, tuple):
        pairs = zip(a, b, strict=True)
    else:
        pairs = [(a, b)]
    # differences of narrow ints fit the next width: a full-width tensor
    # stays a few GB wide
    wide = {torch.int8: torch.int16, torch.int16: torch.int32}
    err = max(0 if torch.equal(x, y) else
              int((x.to(wide.get(x.dtype, torch.int64))
                   - y.to(wide.get(y.dtype, torch.int64))).abs().max())
              for x, y in pairs)
    return err == 0, err


@phase
def encoded_tones(lanes: int, seconds: float, seed: int):
    """Realistic DFPWM streams: one tone per lane (110-2000 Hz, 48 kHz),
    encoded on the card by the plain encoder (kernel (c)'s plain version,
    timed). -> (bytes u8[L, B], levels i8[L, 8B], plain milliseconds)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 48000) // 8 * 8
    t = torch.arange(n, device="cuda", dtype=torch.float64) / 48000
    freq = torch.tensor(rng.uniform(110, 2000, lanes), device="cuda")[:, None]
    amp = torch.tensor(rng.uniform(0.3, 0.9, lanes), device="cuda")[:, None]
    levels = torch.trunc(amp * 127 * torch.sin(2 * np.pi * freq * t)).to(torch.int8)
    (enc, _), plain_ms = timed(lambda: kc.dfpwm_encode_ref(levels, DfpwmState.zeros(lanes, "cuda")))
    return enc, levels, plain_ms


def tone_correlation(decoded: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Per-lane correlation of decoded int8 audio with its source levels,
    after a 0.1 s warm-up of the decoder's adaptive strength."""
    x = decoded[:, 4800:].to(torch.float32)
    y = levels[:, 4800: decoded.shape[1]].to(torch.float32)
    x, y = x - x.mean(1, keepdim=True), y - y.mean(1, keepdim=True)
    return (x * y).sum(1) / (x.norm(dim=1) * y.norm(dim=1))


def load_test_module(stem: str):
    """tests/<stem>.py by path: on the card's machine ``tests`` may name
    another installed package."""
    spec = importlib.util.spec_from_file_location(f"aukit_{stem}", ROOT / "tests" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@phase
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=json.dumps(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())
    return smi


def demangle(sym: str) -> str:
    """``name<template values>`` of a mangled kernel symbol (its identifier
    is the one that carries its own length and ends in ``_kernel``)."""
    for m in re.finditer(r"\d+", sym):
        for k in range(len(m.group())):
            n = int(m.group()[k:])
            name = sym[m.end(): m.end() + n]
            if n and name.endswith("_kernel") and re.fullmatch(r"[a-z_]+", name):
                t = re.match(r"I((?:L\w\d+E)+)E", sym[m.end() + n:])
                args = re.findall(r"L\w(\d+)E", t.group(1)) if t else []
                return name + (f"<{','.join(args)}>" if args else "")
    return sym


def kernel_resources(log: str) -> dict:
    """Registers and spill bytes of each kernel, from ptxas -v's report in
    the build log: {kernel<template args>: (registers, spill stores, spill
    loads)}."""
    out, name, spills = {}, None, (0, 0)
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            name = demangle(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            out[name] = (int(m.group(1)), *spills)
    return out


@phase
def phase_build() -> None:
    """The CUDA kernels (one nvcc per source, in parallel) and the native
    FLAC parser (g++), both from the checkout."""
    t0 = time.perf_counter()
    _build.load()
    t1 = time.perf_counter()
    check(flacbits.available(), f"the native FLAC parser builds from {flacbits.SRC}")
    res = kernel_resources((_build.BUILD_DIR / "build.log").read_text())
    spilled = {k: v for k, v in res.items() if v[1] or v[2]}
    check(len(res) >= 10, f"ptxas reported every kernel ({sorted(res)})")
    say("build", seconds=round(t1 - t0, 3), flac_parser_seconds=round(time.perf_counter() - t1, 3),
        kernels=len(res), registers=json.dumps({k: v[0] for k, v in res.items()}),
        spills=json.dumps(spilled))


@phase
def phase_golden() -> None:
    golden = np.load(ROOT / "tests" / "golden" / "golden.npz")
    lanes = 4096
    data = torch.tensor(np.tile(golden["dfpwm_in"], (lanes, 1)), device="cuda")
    out, _ = kc.dfpwm_decode_kernel(data, DfpwmState.zeros(lanes, "cuda"))
    want = torch.tensor(golden["dfpwm_out"], device="cuda").to(torch.int8)
    ok = bool((out == want[None, :]).all())
    say("golden", lanes=lanes, samples=out.shape[1], equal=ok)
    check(ok, "decode kernel == golden.npz dfpwm_out")


@phase
def phase_kernel_vs_plain() -> dict:
    """Both kernels against their plain versions on the same CUDA tensors:
    32768 lanes, 512 bytes, two chained calls, a lane mask, with and without a
    gain ramp, from a non-zero incoming state. Returns max |error| by kernel."""
    rng = np.random.default_rng(4)
    lanes, nbytes = FULL_LANES, 512
    errs = {"dfpwm_decode": 0, "dfpwm_decode_dsp": 0}
    st0 = random_state(rng, lanes)
    st, ref_st = st0, st0
    for call in range(2):
        data = torch.tensor(rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8), device="cuda")
        out, st = kc.dfpwm_decode_kernel(data, st)
        ref, ref_st = kc.dfpwm_decode_ref(data, ref_st)
        (ok_o, e_o), (ok_s, e_s) = same(out, ref), same(st, ref_st)
        errs["dfpwm_decode"] = max(errs["dfpwm_decode"], e_o, e_s)
        say("kernel_vs_plain", kernel="dfpwm_decode", call=call, out_equal=ok_o, state_equal=ok_s)
        check(ok_o and ok_s, "dfpwm_decode kernel == plain")
    for with_gain in (False, True):
        st, ref_st = st0, st0
        for call in range(2):
            data = torch.tensor(rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8),
                                device="cuda")
            mask = torch.tensor(rng.random(lanes) < 0.8, device="cuda")
            gain = None
            if with_gain:
                gain = (torch.tensor(rng.uniform(0.2, 1.8, lanes).astype(np.float32),
                                     device="cuda"),
                        torch.tensor((rng.uniform(-1, 1, lanes) / 4096).astype(np.float32),
                                     device="cuda"))
            out, st = kc.dfpwm_decode_dsp_kernel(data, st, ALPHA_48K, mask, gain)
            ref, ref_st = kc.dfpwm_decode_dsp_ref(data, ref_st, ALPHA_48K, mask, gain)
            (ok_o, e_o), (ok_s, e_s) = same(out, ref), same(st, ref_st)
            errs["dfpwm_decode_dsp"] = max(errs["dfpwm_decode_dsp"], e_o, e_s)
            say("kernel_vs_plain", kernel="dfpwm_decode_dsp", gain=with_gain, call=call,
                out_equal=ok_o, state_equal=ok_s)
            check(ok_o and ok_s, "dfpwm_decode_dsp kernel == plain")
    return errs


def chained_vs_plain(kernel, plain, calls, state, extra=()) -> tuple[bool, int]:
    """A block kernel and its plain version over chained calls from one
    state: (all outputs and states equal, max |error|)."""
    ref_state, err = state, 0
    for x in calls:
        (out, state), (ref, ref_state) = kernel(x, *state, *extra), plain(x, *ref_state, *extra)
        err = max(err, same(out, ref)[1], same(state, ref_state)[1])
    return err == 0, err


def window_kernel_cases(cases) -> dict:
    """Kernels (d), (e) and (f) against their plain versions on every case of
    ``ima_cases``, ``msadpcm_cases`` and ``qoa_cases``
    (tests/torch_kernel_cases.py), all lanes, outputs and final states,
    chained calls from a non-zero state. -> {kernel: [(case, equal, max
    |error|)]}."""
    found = {"ima": [], "msadpcm": [], "qoa": []}
    for name, calls, state in cases.ima_cases("cuda"):
        found["ima"].append((name, *chained_vs_plain(ka.ima_decode_kernel, ka.ima_decode_ref,
                                                     calls, state)))
    for name, calls, state, coefs in cases.msadpcm_cases("cuda"):
        found["msadpcm"].append((name, *chained_vs_plain(
            ka.msadpcm_decode_kernel, ka.msadpcm_decode_ref, calls, state, coefs)))
    for name, calls, state in cases.qoa_cases("cuda"):
        found["qoa"].append((name, *chained_vs_plain(kq.qoa_lms_kernel, kq.qoa_lms_ref, calls,
                                                     state)))
    return found


def decode_kernel_cases(cases) -> dict:
    """Kernels (a) and (b) against their plain versions on every case of
    ``decode_cases`` (tests/torch_kernel_cases.py): states on both sides of
    each bound of the tame test, chained calls whose first leaves wild lanes
    tame, the mixed fleet's 4000-byte rows; outputs and states after every
    call. -> {kernel: [(case, equal, max |error|)]}."""
    found = {"dfpwm_decode": [], "dfpwm_decode_dsp": []}
    for name, calls, state in cases.decode_cases("cuda"):
        for key, extra in (("dfpwm_decode", ()), ("dfpwm_decode_dsp", (ALPHA_48K,))):
            kernel, plain = getattr(kc, f"{key}_kernel"), getattr(kc, f"{key}_ref")
            st = ref_st = state
            err = 0
            for x in calls:
                (out, st), (ref, ref_st) = kernel(x, st, *extra), plain(x, ref_st, *extra)
                err = max(err, same(out, ref)[1], same(st, ref_st)[1])
            found[key].append((name, err == 0, err))
    return found


@phase
def phase_redesigned_kernel_paths() -> dict:
    """Every path of the kernels redesigned for Hopper, (a) to (h), against
    their plain versions on the same CUDA tensors, max |error| 0, on the
    cases of tests/torch_kernel_cases.py: for (a) and (b) states on both
    sides of each bound of the tame test (the short step and the epilogue's
    table, or predict() and the division), chained calls from wild states
    into tame ones, the mixed fleet's 4000-byte rows; for (b), and (a) on
    the same bytes, the table's 256 lowpass words, states outside their
    ranges, odd and short rows, ragged tiles and lanes, a misaligned base,
    gains past the rails and to +-inf and NaN, masked lanes whose state
    advances; for (g) rows on and off the
    16-byte grid, every tap count, wide and negative shifts, ragged blocks;
    for (c) tame and wild states, levels on both rails, every store width,
    ragged tiles, a misaligned base, chained calls; for (h) row lengths from
    one sample to a 44.1 kHz block's 4458, alphas near 0 and 1, denormals;
    for (d), (e) and (f) rows on and off the 16-byte grid (the engine's 504
    and 1010 nibbles), odd lengths, one sample, less than a tile, ragged
    lanes, bases off the grid, chained calls, (d) with indices at 0, 88 and
    out of range and predictors at both rails, (e) with negative, capped and
    floored deltas and every coefficient pair, (f) from states that wrap
    int32.
    Then the ramp's 64-bit time (more than 2^24 samples a lane) against the
    plain epilogue over kernel (a)'s raw samples: the plain decode loop
    would take hours there. Returns max |error| by kernel."""
    cases = load_test_module("torch_kernel_cases")
    errs = {"dfpwm_decode": 0, "dfpwm_decode_dsp": 0, "lpc_restore": 0, "dfpwm_encode": 0,
            "iir_zero": 0}
    for kernel, found in {**decode_kernel_cases(cases), **window_kernel_cases(cases)}.items():
        for name, ok, err in found:
            check(ok, f"{kernel} kernel == plain on case {name} (max |error| {err})")
        errs[kernel] = 0
        say("kernel_vs_plain_paths", kernel=kernel, cases=json.dumps([f[0] for f in found]),
            out_equal=True, state_equal=True)
    names = []
    for name, data, st, mask, gain in cases.dsp_cases("cuda"):
        for key, got, want in (
                ("dfpwm_decode_dsp", kc.dfpwm_decode_dsp_kernel(data, st, ALPHA_48K, mask, gain),
                 kc.dfpwm_decode_dsp_ref(data, st, ALPHA_48K, mask, gain)),
                ("dfpwm_decode", kc.dfpwm_decode_kernel(data, st), kc.dfpwm_decode_ref(data, st))):
            (ok_o, e_o), (ok_s, e_s) = same(got[0], want[0]), same(got[1], want[1])
            errs[key] = max(errs[key], e_o, e_s)
            check(ok_o and ok_s, f"{key} kernel == plain on case {name}")
            if key == "dfpwm_decode" and name.startswith("every_lowpass_word"):
                check(len(torch.unique(got[0])) == 256, "the bytes reach all 256 lowpass words")
        names.append(name)
    say("kernel_vs_plain_paths", kernel="dfpwm_decode_dsp", also="dfpwm_decode",
        cases=json.dumps(names), out_equal=True, state_equal=True)
    names = []
    wrapped_rows = 0
    for name, args, K in cases.lpc_cases("cuda"):
        ok, err = same(kg.lpc_restore_kernel(*args, K), kg.lpc_restore_ref(*args, K))
        # the same rows with the wrapped rows reported (the random predictors
        # of most cases are unstable), and as int64 rows (the wide entry point)
        flags = [torch.full((args[0].shape[0],), 7, dtype=torch.int32, device=CARD)
                 for _ in range(2)]
        ok_w, err_w = same((kg.lpc_restore_kernel(*args, K, wrapped=flags[0]), flags[0]),
                           (kg.lpc_restore_ref(*args, K, wrapped=flags[1]), flags[1]))
        wide = (args[0].to(torch.int64).contiguous(), *args[1:])
        ok_l, err_l = same(kg.lpc_restore_kernel(*wide, K), kg.lpc_restore_ref(*wide, K))
        wrapped_rows += int(flags[0].sum())
        errs["lpc_restore"] = max(errs["lpc_restore"], err, err_w, err_l)
        check(ok and ok_w and ok_l,
              f"lpc_restore kernel == plain on case {name} (rows, wrapped rows, int64 rows)")
        names.append(name)
    say("kernel_vs_plain_paths", kernel="lpc_restore", cases=json.dumps(names), out_equal=True,
        wrapped_equal=True, wide_equal=True, wrapped_rows=wrapped_rows)
    names = []
    for name, calls, st in cases.encode_cases("cuda"):
        ref_st = st
        for call, x in enumerate(calls):
            (out, st), (ref, ref_st) = kc.dfpwm_encode_kernel(x, st), kc.dfpwm_encode_ref(x, ref_st)
            (ok_o, e_o), (ok_s, e_s) = same(out, ref), same(st, ref_st)
            errs["dfpwm_encode"] = max(errs["dfpwm_encode"], e_o, e_s)
            check(ok_o and ok_s, f"dfpwm_encode kernel == plain on case {name}, call {call}")
        names.append(name)
    say("kernel_vs_plain_paths", kernel="dfpwm_encode", cases=json.dumps(names), out_equal=True,
        state_equal=True)
    names = []
    for name, x, alpha in cases.iir_cases("cuda"):
        out, ref = kh.iir_zero_kernel(x, alpha), kh.iir_zero_ref(x, alpha)
        ok = torch.equal(out, ref)
        if not ok:
            errs["iir_zero"] = max(errs["iir_zero"], float((out.double() - ref.double()).abs().max()))
        check(ok, f"iir_zero kernel == plain on case {name}")
        names.append(name)
    say("kernel_vs_plain_paths", kernel="iir_zero", cases=json.dumps(names), out_equal=True)

    # the ramp beyond 2^24 samples a lane
    rng = np.random.default_rng(52)
    lanes, nbytes = 3, (1 << 21) + 8
    data = torch.tensor(rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8), device="cuda")
    st = random_state(rng, lanes)
    gain = (torch.tensor([0.9, 1.2, 0.4], device="cuda"),
            torch.tensor([1.5e-8, -3e-8, 2e-8], device="cuda"))

    def raw_by_kernel(bytes_u8, state):  # decode_samples' contract: ([T, L] int32, state)
        raw, new = kc.dfpwm_decode_kernel(bytes_u8, state)
        return raw.t().to(torch.int32), new

    (out, new), ms = timed(lambda: kc.dfpwm_decode_dsp_kernel(data, st, ALPHA_48K, None, gain))
    plain_loop, kc.decode_samples = kc.decode_samples, raw_by_kernel
    try:
        ref, ref_new = kc.dfpwm_decode_dsp_ref(data, st, ALPHA_48K, None, gain)
    finally:
        kc.decode_samples = plain_loop
    (ok_o, e_o), (ok_s, e_s) = same(out, ref), same(new, ref_new)
    errs["dfpwm_decode_dsp"] = max(errs["dfpwm_decode_dsp"], e_o, e_s)
    say("kernel_vs_plain_paths", kernel="dfpwm_decode_dsp", case="ramp_beyond_2^24_samples",
        lanes=lanes, bytes=nbytes, out_equal=ok_o, state_equal=ok_s, ms=round(ms, 2))
    check(ok_o and ok_s, "dfpwm_decode_dsp kernel == plain epilogue beyond 2^24 samples")
    return errs


@phase
def phase_kernel_vs_plain_main_shapes(tones: torch.Tensor) -> tuple[dict, dict]:
    """Each kernel against its plain version at the shapes the main path
    gives it, on the bytes the main path decodes, every lane compared: the
    fused kernel on a one-second identity-rate chunk (32768 lanes x 6000
    bytes) with a lane mask and a gain ramp, and the decode kernel on a
    one-second chunk of the mixed fleet's 32 kHz half (16384 lanes x 4000
    bytes). Both start from a non-zero state. Then each kernel's time as the
    main path calls it (the fused kernel with every lane live and no gain),
    by CUDA events. Returns (max |error|, timing row) by kernel."""
    rng = np.random.default_rng(7)
    lanes = FULL_LANES
    state = random_state(rng, lanes)
    mask = torch.tensor(rng.random(lanes) < 0.8, device="cuda")
    gain = (torch.tensor(rng.uniform(0.2, 1.8, lanes).astype(np.float32), device="cuda"),
            torch.tensor((rng.uniform(-1, 1, lanes) / 48000).astype(np.float32), device="cuda"))
    live = torch.ones(lanes, dtype=torch.bool, device="cuda")
    cases = {
        "dfpwm_decode_dsp": (
            lambda: kc.dfpwm_decode_dsp_kernel(tones, state, ALPHA_48K, mask, gain),
            lambda: kc.dfpwm_decode_dsp_ref(tones, state, ALPHA_48K, mask, gain),
            lambda: kc.dfpwm_decode_dsp_kernel(tones, state, ALPHA_48K, live)),
    }
    half = tones[1::2, :4000].contiguous()
    half_state = DfpwmState(*(leaf[1::2].contiguous() for leaf in state.leaves()))
    cases["dfpwm_decode"] = (lambda: kc.dfpwm_decode_kernel(half, half_state),
                             lambda: kc.dfpwm_decode_ref(half, half_state),
                             lambda: kc.dfpwm_decode_kernel(half, half_state))
    errs, times = {}, {}
    gained_ms = event_ms(lambda: kc.dfpwm_decode_dsp_kernel(tones, state, ALPHA_48K, live, gain), 5)
    say("time", kernel="dfpwm_decode_dsp_gain", lanes=lanes, bytes=tones.shape[1],
        ms=round(gained_ms, 4))
    for name, (kernel, plain, as_main_path) in cases.items():
        (out, st), ms = timed(kernel)
        (ref, ref_st), plain_ms = timed(plain)
        (ok_o, e_o), (ok_s, e_s) = same(out, ref), same(st, ref_st)
        errs[name] = max(e_o, e_s)
        say("kernel_vs_plain_main_shape", kernel=name, lanes=out.shape[0],
            bytes=out.shape[1] // 8, out_equal=ok_o, state_equal=ok_s,
            ms=round(ms, 4), plain_ms=round(plain_ms, 2))
        check(ok_o and ok_s, f"{name} kernel == plain at the main path's shape")
        samples = out.numel()
        del out, ref, st, ref_st
        torch.cuda.empty_cache()
        # a byte in, eight int8 samples out
        times[name] = timing(name, event_ms(as_main_path, 5), plain_ms,
                             samples * OPS_PER_SAMPLE[name], samples * 9 / 8)
    return errs, times


def drive(eng, feeds, volumes=()):
    """Feed per lane (EOF after each), then step to the end."""
    for lane, vol, ramp in volumes:
        eng.set_volume(lane, vol, ramp=ramp)
    for lane, data in enumerate(feeds):
        eng.feed(lane, data)
        eng.feed(lane, None)
    while (r := eng.step()) is not None:
        yield r


def compare_engines(name: str, cuda_eng, cpu_eng, feeds, subset, volumes) -> None:
    """The CPU engine decodes only the ``subset`` lanes of the CUDA engine's
    fleet: its windows, masks, positions and checkpoints must equal the CUDA
    engine's rows for those lanes. The CUDA engine may step on after the
    subset is done; the subset lanes are then masked out."""
    sub_vols = [(int(np.nonzero(subset == lane)[0][0]), v, r) for lane, v, r in volumes
                if lane in subset]
    cpu_steps = drive(cpu_eng, [feeds[i] for i in subset], sub_vols)
    n = 0
    for chunk, mask, pos in drive(cuda_eng, feeds, volumes):
        got = next(cpu_steps, None)
        if got is None:
            check(not mask[subset].any(), f"{name}: subset lanes masked after the CPU run")
            continue
        ok = (np.array_equal(chunk[torch.tensor(subset, device="cuda")].cpu().numpy(),
                             got[0].numpy())
              and np.array_equal(mask[subset], got[1]) and np.array_equal(pos[subset], got[2]))
        check(ok, f"{name}: step {n} windows/masks/positions equal")
        n += 1
    check(next(cpu_steps, None) is None, f"{name}: CPU engine has no extra steps")
    for i, lane in enumerate(subset):
        a, b = cuda_eng.checkpoint(int(lane)), cpu_eng.checkpoint(i)
        check(a.keys() == b.keys() and all(
            np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a),
            f"{name}: checkpoint of lane {lane} equal")
    say("engine_cuda_vs_cpu", case=name, lanes=cuda_eng.lanes, compared_lanes=len(subset),
        steps=n, equal=True)


@phase
def phase_engines(tones: torch.Tensor) -> None:
    host = np.tile(tones[:4096].cpu().numpy(), (1, 3))  # 3 s per lane
    rng = np.random.default_rng(5)
    subset = np.arange(0, 4096, 64)
    vols = [(0, 0.5, False), (64, 0.3, True), (129, 1.6, True), (193, 0.8, False)]
    # (i) identity rate: fused kernel, ragged EOF tails, a volume ramp
    lengths = rng.integers(750, 3 * 750 + 400, 4096)
    feeds = [host[i, : lengths[i]].tobytes() for i in range(4096)]
    compare_engines("identity_48k",
                    BatchDfpwmDecoder(4096, 48000, chunk_bytes=750, device="cuda"),
                    BatchDfpwmDecoder(len(subset), 48000, chunk_bytes=750, device="cpu"),
                    feeds, subset, vols)
    # (ii) a heterogeneous fleet at 48000 and 32000 Hz: fused kernel on one
    # group, decode kernel + dsp_chain on the other, one-second windows
    launches = kc.dfpwm_decode_kernel.launches
    specs = [LaneSpec("dfpwm", 48000 if i % 2 == 0 else 32000) for i in range(4096)]
    subset = np.sort(np.concatenate([np.arange(0, 4096, 128), np.arange(1, 4096, 128)]))
    lengths = rng.integers(4000, 6000 * 2 + 1000, 4096)
    feeds = [host[i, : lengths[i]].tobytes() for i in range(4096)]
    compare_engines("mixed_48k_32k", BatchStreamEngine(specs, device="cuda"),
                    BatchStreamEngine([specs[i] for i in subset], device="cpu"),
                    feeds, subset, vols)
    check(kc.dfpwm_decode_kernel.launches > launches, "decode kernel ran on the 32 kHz group")


@phase
def phase_main_path(tones: torch.Tensor, levels: torch.Tensor) -> dict:
    """The main path at full width, through the engine's entry points:
    32768 identity-rate lanes, then a 32768-lane fleet at 48000 and 32000 Hz.
    Every launch count is zeroed just before and read just after."""
    seconds = 4
    bulk = np.tile(tones.cpu().numpy(), (1, seconds))  # u8[32768, 24000]
    kernels.reset_counts()
    t0 = sync_time()
    eng = BatchDfpwmDecoder(FULL_LANES, 48000, chunk_bytes=6000, device="cuda")
    eng.feed_array(bulk)
    first = None
    steps = 0
    while (r := eng.step()) is not None:
        check(tuple(r[0].shape) == (FULL_LANES, 48000) and r[0].dtype == torch.int8
              and bool(r[1].all()), "full-width window shape/dtype/mask")
        first = r[0] if first is None else first
        steps += 1
    dt = sync_time() - t0
    rtf = FULL_LANES * 48000 * steps / 48000 / dt
    fused = kc.dfpwm_decode_dsp_kernel.launches
    check(steps == seconds and fused == steps, f"fused kernel launched once per step ({fused})")
    check(kc.dfpwm_decode_kernel.launches == 0, "no raw decode on the identity-rate engine")
    say("main_path", case="identity_48k", lanes=FULL_LANES, steps=steps, seconds=round(dt, 4),
        realtime_factor=round(rtf, 1), fused_launches=fused)

    # a heterogeneous fleet: half the lanes at 32 kHz (decode kernel + dsp_chain)
    specs = [LaneSpec("dfpwm", 48000 if i % 2 == 0 else 32000) for i in range(FULL_LANES)]
    t0 = sync_time()
    mixed = BatchStreamEngine(specs, device="cuda")
    mixed.feed_array(bulk[:, : 6000 * 3])
    windows = 0
    mixed_first = None
    while (r := mixed.step()) is not None:
        check(tuple(r[0].shape) == (FULL_LANES, 48000), "mixed window shape")
        mixed_first = r[0] if mixed_first is None else mixed_first
        windows += 1
    dt_mixed = sync_time() - t0
    launches = {"dfpwm_decode": kc.dfpwm_decode_kernel.launches,
                "dfpwm_decode_dsp": kc.dfpwm_decode_dsp_kernel.launches,
                "fma": kf.fma_kernel.launches}
    check(launches["dfpwm_decode"] > 0 and launches["dfpwm_decode_dsp"] > fused
          and launches["fma"] > 0, "the kernels launched by the mixed fleet")
    check(all(fn.calls == 0 for fn in kernels.PLAIN), "no plain version on the CUDA path")
    say("main_path", case="mixed_48k_32k", lanes=FULL_LANES, windows=windows,
        seconds=round(dt_mixed, 4), samples_decoded=mixed.metrics.samples_decoded,
        realtime_factor=round(mixed.metrics.samples_decoded / 48000 / dt_mixed, 1),
        launches=json.dumps(launches))

    # what came out is right. Every lane of the identity engine's first
    # window equals the fused kernel's plain version on the same bytes; the
    # mixed fleet's 48 kHz lanes equal those rows, and its first 8 lanes (both
    # rates) equal the CPU engine's; every lane follows its source tone.
    ref, _ = kc.dfpwm_decode_dsp_ref(tones, DfpwmState.zeros(FULL_LANES, "cuda"), ALPHA_48K,
                                     torch.ones(FULL_LANES, dtype=torch.bool, device="cuda"))
    check(torch.equal(first, ref), "full-width identity window == plain version, every lane")
    del ref
    torch.cuda.empty_cache()
    check(torch.equal(mixed_first[0::2], first[0::2]),
          "mixed fleet's 48 kHz lanes == identity window, every lane")
    cpu = BatchStreamEngine(specs[:8], device="cpu")
    cpu.feed_array(bulk[:8, : 6000 * 3])
    check(torch.equal(mixed_first[:8].cpu(), cpu.step()[0]),
          "mixed fleet's first window == CPU engine on 8 lanes")
    corr = torch.cat([tone_correlation(first[i: i + 4096], levels[i: i + 4096])
                      for i in range(0, FULL_LANES, 4096)])
    say("main_path_output", identity_lanes_equal_plain=FULL_LANES,
        mixed_48k_lanes_equal=FULL_LANES // 2, mixed_lanes_equal_cpu=8,
        corr_min=round(float(corr.min()), 4), corr_median=round(float(corr.median()), 4))
    check(bool(torch.isfinite(corr).all()) and float(corr.min()) > 0.8,
          "decoded audio follows the source tone")
    return launches


def busy_ms(intervals) -> float:
    """Milliseconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


@phase
def phase_step_breakdown(tones: torch.Tensor) -> None:
    """Where the time of one full-width identity_48k step goes: the step fed
    from host memory (as in main_path) and fed from the card, the host
    staging copy alone (the engine's pageable copy of a column view, and the
    same bytes from pinned memory), and, under torch.profiler over two
    host-fed steps, the device time of the kernels and of the copies and the
    device's busy share of the wall time."""
    host = np.tile(tones.cpu().numpy(), (1, 4))  # 4 s per lane

    def engine(feed):
        eng = BatchDfpwmDecoder(FULL_LANES, 48000, chunk_bytes=6000, device="cuda")
        eng.feed_array(feed)
        eng.step()  # first step: allocations
        return eng

    def step_ms(eng) -> float:
        t0 = sync_time()
        eng.step()
        return (sync_time() - t0) * 1e3

    host_eng, dev_eng = engine(host), engine(torch.tensor(host, device="cuda"))
    host_step = min(step_ms(host_eng), step_ms(host_eng))
    dev_step = min(step_ms(dev_eng), step_ms(dev_eng))
    del dev_eng
    view = host[:, 6000:12000]  # what the engine stages: a column view
    t0 = sync_time()
    torch.tensor(view, device="cuda")
    pageable = (sync_time() - t0) * 1e3
    pinned = torch.empty(view.shape, dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = view
    t0 = sync_time()
    pinned.to("cuda", non_blocking=True)
    pinned_ms = (sync_time() - t0) * 1e3

    host_eng = engine(host)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = sync_time()
        host_eng.step()
        host_eng.step()
        wall = (sync_time() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [(e.time_range.start, e.time_range.end) for e in dev if "Memcpy" in e.name]
    kernels = [(e.time_range.start, e.time_range.end) for e in dev if "Memcpy" not in e.name]
    fused = [(e.time_range.start, e.time_range.end) for e in dev if "dfpwm_decode" in e.name]
    say("step_breakdown", case="identity_48k", lanes=FULL_LANES,
        host_fed_step_ms=round(host_step, 3), device_fed_step_ms=round(dev_step, 3),
        staging_pageable_ms=round(pageable, 3), staging_pinned_ms=round(pinned_ms, 3),
        profiled_steps=2, profiled_wall_ms=round(wall, 3), device_events=len(dev),
        kernel_ms_per_step=round(busy_ms(fused) / 2, 3),
        htod_ms_per_step=round(busy_ms(copies) / 2, 3),
        busy_kernels=round(busy_ms(kernels) / wall, 4),
        busy_with_copies=round(busy_ms(kernels + copies) / wall, 4))


@phase
def phase_mixed_step_breakdown(tones: torch.Tensor) -> None:
    """Where the time of one full-width mixed_48k_32k step goes (half the
    lanes at 32 kHz: kernel (a), then dsp_chain's resample through the FMA
    kernel; half at 48 kHz: kernel (b)): the step fed from host memory (as in
    main_path) and fed from the card, and, under torch.profiler over two
    host-fed steps, the device time of kernels (a) and (b), of the FMA
    kernel, of the host->device copies and of the other torch ops, and the
    device's busy share of the wall time."""
    host = np.tile(tones.cpu().numpy(), (1, 4))  # 4 s per lane
    specs = [LaneSpec("dfpwm", 48000 if i % 2 == 0 else 32000) for i in range(FULL_LANES)]

    def engine(feed):
        eng = BatchStreamEngine(specs, device="cuda")
        eng.feed_array(feed)
        eng.step()  # first step: allocations
        return eng

    def step_ms(eng) -> float:
        t0 = sync_time()
        eng.step()
        return (sync_time() - t0) * 1e3

    host_eng = engine(host)
    host_step = min(step_ms(host_eng), step_ms(host_eng))
    dev_eng = engine(torch.tensor(host, device="cuda"))
    dev_step = min(step_ms(dev_eng), step_ms(dev_eng))
    del dev_eng
    torch.cuda.empty_cache()

    host_eng = engine(host)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = sync_time()
        host_eng.step()
        host_eng.step()
        wall = (sync_time() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {"decode": "dfpwm_decode_kernel<false", "decode_dsp": "dfpwm_decode_kernel<true",
             "fma": "fma_kernel", "htod": "Memcpy HtoD"}
    spans = {k: [(e.time_range.start, e.time_range.end) for e in dev if v in e.name]
             for k, v in names.items()}
    spans["other"] = [(e.time_range.start, e.time_range.end) for e in dev
                      if not any(v in e.name for v in names.values())]
    check(spans["decode"] and spans["decode_dsp"], "the mixed step's profile shows kernels (a), (b)")
    everything = [iv for ivs in spans.values() for iv in ivs]
    kernels_only = [iv for k, ivs in spans.items() if k != "htod" for iv in ivs]
    say("step_breakdown", case="mixed_48k_32k", lanes=FULL_LANES,
        host_fed_step_ms=round(host_step, 3), device_fed_step_ms=round(dev_step, 3),
        profiled_steps=2, profiled_wall_ms=round(wall, 3), device_events=len(dev),
        **{f"{k}_ms_per_step": round(busy_ms(v) / 2, 3) for k, v in spans.items()},
        busy_kernels=round(busy_ms(kernels_only) / wall, 4),
        busy_with_copies=round(busy_ms(everything) / wall, 4))
    del host_eng
    torch.cuda.empty_cache()


@phase
def phase_times() -> None:
    """Kernel (a) at bench.py's headline shape, and both kernels against their
    plain versions at 32768 x 512 bytes (CUDA events; the series kept since
    the first slice: the closing ``kernels`` line takes its (a) and (b) rows
    at the main path's shapes, from phase_kernel_vs_plain_main_shapes)."""
    lanes, nbytes = FULL_LANES, 24576
    data = torch.randint(0, 256, (lanes, nbytes), dtype=torch.uint8, device="cuda")
    st = [DfpwmState.zeros(lanes, "cuda")]

    def headline():
        _, st[0] = kc.dfpwm_decode_kernel(data, st[0])

    headline()
    ms = event_ms(headline, 5)
    say("time", kernel="dfpwm_decode", lanes=lanes, bytes=nbytes, ms=round(ms, 4),
        gsamples_per_s=round(lanes * nbytes * 8 / ms / 1e6, 2),
        realtime_factor=round(lanes * nbytes * 8 / (ms / 1e3) / 48000, 1))
    b, by = bound_ms(lanes * nbytes * 8 * OPS_PER_SAMPLE["dfpwm_decode"], lanes * nbytes * 9)
    say("bound", kernel="dfpwm_decode", lanes=lanes, bytes=nbytes, ms=round(ms, 4),
        bound_ms=round(b, 4), bound_by=by, share_of_bound=round(b / ms, 4))
    del data, st
    torch.cuda.empty_cache()

    rng = np.random.default_rng(6)
    nbytes = 512
    data = torch.tensor(rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8), device="cuda")
    state = random_state(rng, lanes)
    mask = torch.ones(lanes, dtype=torch.bool, device="cuda")
    calls = {
        "dfpwm_decode": (lambda: kc.dfpwm_decode_kernel(data, state),
                         lambda: kc.dfpwm_decode_ref(data, state)),
        "dfpwm_decode_dsp": (lambda: kc.dfpwm_decode_dsp_kernel(data, state, ALPHA_48K, mask),
                             lambda: kc.dfpwm_decode_dsp_ref(data, state, ALPHA_48K, mask)),
    }
    for name, (kernel, plain) in calls.items():
        kernel()
        k1, p1 = event_ms(kernel, 20), event_ms(plain, 1)
        k2, p2 = event_ms(kernel, 20), event_ms(plain, 1)  # kernel, plain, kernel, plain
        say("time", kernel=name, lanes=lanes, bytes=nbytes, ms=round(min(k1, k2), 4),
            plain_ms=round(min(p1, p2), 2))


# -- the block-codec lanes ---------------------------------------------------------------

# the block fleet: bench.py:457-460's mixed-fleet specs at full width, with an
# MS ADPCM and a QOA group beside its IMA group
BLOCK_FLEET = (LaneSpec("ima", 22050, 1, block_align=256),
               LaneSpec("msadpcm", 22050, 1, block_align=512),
               LaneSpec("qoa", 44100, 2),
               LaneSpec("pcm16", 44100),
               LaneSpec("ulaw", 8000))
BLOCK_LANES = (8192, 8192, 8192, 4096, 4096)
CHECK_LANES = 4096  # the block fleet the CUDA and CPU engines both decode
BENCH_LANES = 16384  # bench.py:306/324/343's block-kernel shapes: 4 x 4096 lanes
BLOCK_BENCH_SHAPES = {"ima": (BENCH_LANES, 8192), "msadpcm": (BENCH_LANES, 8192),
                      "qoa": (BENCH_LANES, 5120)}
BLOCK_PLAIN = {"ima": ka.ima_decode_ref, "msadpcm": ka.msadpcm_decode_ref,
               "qoa": kq.qoa_lms_ref}


def block_fleet_shape(name: str) -> tuple[int, int]:
    """(lanes, samples) of the one launch of a block kernel in a window of
    the block fleet: a lane per (stream, block or frame, channel)."""
    i = [spec.codec for spec in BLOCK_FLEET].index(name)
    spec = BLOCK_FLEET[i]
    in_bytes, in_samples = bc.geometry(spec)
    if name == "qoa":
        blocks, T = in_samples // bc.QOA_SAMPLES_PER_FRAME, bc.QOA_SAMPLES_PER_FRAME
    else:  # an MS ADPCM block's first two samples are its header's
        blocks = in_bytes // spec.block_align
        T = in_samples // blocks - (2 if name == "msadpcm" else 0)
    return BLOCK_LANES[i] * blocks * spec.channels, T


def ima_resample_width() -> int:
    """Output samples of one IMA group step: the width of its resample."""
    spec = BLOCK_FLEET[0]
    return bc.geometry(spec)[1] * 48000 // spec.sample_rate


def cuda_i32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.int32), device="cuda")


def block_kernel_cases(rng, lanes: int) -> dict:
    """Random block-kernel arguments at ``lanes`` lanes, ragged-free, with a
    non-zero incoming state: IMA step indices over 0..88, MS ADPCM negative
    header deltas and every coefficient pair, QOA half the lanes in the
    int32-overflowing state of tests/test_pallas_kernels.py:143-146.
    -> {kernel name: (T, make_input, state, extra args)}."""
    pidx = rng.integers(0, 7, lanes)
    qoa_hist = rng.integers(-32768, 32768, (lanes, 4))
    qoa_wts = rng.integers(-30000, 30000, (lanes, 4))
    qoa_hist[::2], qoa_wts[::2] = 32767, 2 * 10**8
    return {
        "ima": (504, lambda: torch.tensor(rng.integers(0, 16, (lanes, 504), dtype=np.uint8),
                                          device="cuda"),
                (cuda_i32(rng.integers(-32768, 32768, lanes)), cuda_i32(rng.integers(0, 89, lanes))),
                ()),
        "msadpcm": (1010, lambda: torch.tensor(rng.integers(-8, 8, (lanes, 1010), dtype=np.int8),
                                               device="cuda"),
                    (cuda_i32(rng.integers(-2000, 2000, lanes)),
                     cuda_i32(rng.integers(-2000, 2000, lanes)),
                     cuda_i32(rng.integers(-400, 400, lanes))),
                    (cuda_i32(MSADPCM_DEFAULT_COEFFS[0][pidx]),
                     cuda_i32(MSADPCM_DEFAULT_COEFFS[1][pidx]))),
        "qoa": (5120, lambda: torch.tensor(
                    rng.integers(-14336, 14337, (lanes, 5120)).astype(np.int16), device="cuda"),
                (cuda_i32(qoa_hist), cuda_i32(qoa_wts)), ()),
    }


def block_kernel_input(name: str, lanes: int, T: int) -> torch.Tensor:
    """Random input rows of a block kernel, made on the card."""
    lo, hi, dtype = {"ima": (0, 16, torch.uint8), "msadpcm": (-8, 8, torch.int8),
                     "qoa": (-14336, 14337, torch.int16)}[name]
    return torch.randint(lo, hi, (lanes, T), dtype=dtype, device="cuda")


def block_kernel_call(rng, name: str, lanes: int, T: int):
    """A call of a block kernel on random rows and ``block_kernel_cases``'
    state, both on the card."""
    _, _, state, extra = block_kernel_cases(rng, lanes)[name]
    x = block_kernel_input(name, lanes, T)
    return lambda: bc.BLOCK_KERNELS[name][1](x, *state, *extra)


@phase
def phase_block_kernel_vs_plain() -> dict:
    """Kernels (d), (e), (f) against their plain versions on the same CUDA
    tensors: 32768 lanes, two chained calls from a non-zero state, outputs
    and final states compared exactly. Returns max |error| by kernel."""
    rng = np.random.default_rng(8)
    errs = {}
    for name, (T, make, state, extra) in block_kernel_cases(rng, FULL_LANES).items():
        st, ref_st = state, state
        errs[name] = 0
        for call in range(2):
            x = make()
            out, st = bc.BLOCK_KERNELS[name][1](x, *st, *extra)
            ref, ref_st = BLOCK_PLAIN[name](x, *ref_st, *extra)
            (ok_o, e_o), (ok_s, e_s) = same(out, ref), same(st, ref_st)
            errs[name] = max(errs[name], e_o, e_s)
            say("kernel_vs_plain", kernel=name, lanes=FULL_LANES, samples=T, call=call,
                out_equal=ok_o, state_equal=ok_s)
            check(ok_o and ok_s, f"{name} kernel == plain")
    return errs


def ms_encode_blocks(x: torch.Tensor, pidx: torch.Tensor) -> torch.Tensor:
    """A real MS ADPCM encoder (tests/fixtures.py ms_encode), vectorised over
    blocks on the card: int32[R, spb] signal blocks, int[R] predictor
    indices -> uint8[R, 7 + (spb - 2) // 2] mono blocks, so each delta
    follows its signal."""
    c1 = cuda_i32(MSADPCM_DEFAULT_COEFFS[0])[pidx]
    c2 = cuda_i32(MSADPCM_DEFAULT_COEFFS[1])[pidx]
    adapt = cuda_i32(MSADPCM_ADAPTION)
    s2, s1 = x[:, 0], x[:, 1]
    d0 = ((x[:, 1:] - x[:, :-1]).abs().double().mean(1) / 4).to(torch.int32).clamp_min(16)
    d = d0
    nibs = []
    for i in range(2, x.shape[1]):
        lin = (s1 * c1 + s2 * c2) >> 8
        nib = torch.round((x[:, i] - lin).double() / d.double()).clamp(-8, 7).to(torch.int32)
        pred = (lin + nib * d).clamp(-32768, 32767)
        d = ((adapt[nib + 8] * d) >> 8).clamp(16, 1 << 20)
        s2, s1 = s1, pred
        nibs.append(nib & 0x0F)
    n = torch.stack(nibs, dim=1)
    body = (n[:, 0::2] << 4) | n[:, 1::2]

    def le16(v):
        return torch.stack([v & 0xFF, (v >> 8) & 0xFF], dim=1)

    hdr = torch.cat([pidx.to(torch.int32)[:, None], le16(d0), le16(x[:, 1]), le16(x[:, 0])], 1)
    return torch.cat([hdr, body], dim=1).to(torch.uint8)


def tone_signals(rng, lanes: int, n: int, rate: int):
    """int32[lanes, n] tones (110-1000 Hz, 30-90% of full scale) on the card,
    and their (freq, amp) per lane."""
    freq = torch.tensor(rng.uniform(110, 1000, lanes), device="cuda")[:, None]
    amp = torch.tensor(rng.uniform(0.3, 0.9, lanes) * 32767, device="cuda")[:, None]
    t = torch.arange(n, device="cuda", dtype=torch.float64) / rate
    return torch.trunc(amp * torch.sin(2 * np.pi * freq * t)).to(torch.int32), freq, amp


def block_fleet_bytes(rng, spec: LaneSpec, lanes: int, seconds: int):
    """uint8[lanes, seconds * in_bytes] of one group, built in the manner of
    tests/fixtures.py: IMA blocks with valid random headers and random
    nibbles (ima_wav_blocks), MS ADPCM tones through the real encoder
    (ms_encode), QOA frames with valid headers, random LMS states and random
    slices (qoa_stream), PCM16 tones, random µ-law bytes. -> (bytes, tone
    (freq, amp) or None)."""
    in_bytes, in_samples = bc.geometry(spec)
    n = seconds * in_bytes
    if spec.codec == "ima":
        blk = rng.integers(0, 256, (lanes, n // 256, 256), dtype=np.uint8)
        pred = rng.integers(-32768, 32768, blk.shape[:2])
        blk[..., 0], blk[..., 1] = pred & 0xFF, (pred >> 8) & 0xFF
        blk[..., 2], blk[..., 3] = rng.integers(0, 89, blk.shape[:2]), 0
        return blk.reshape(lanes, n), None
    if spec.codec == "msadpcm":
        spb = in_samples // (in_bytes // 512)
        x, freq, amp = tone_signals(rng, lanes, seconds * in_samples, spec.sample_rate)
        nblk = n // 512
        pidx = torch.tensor(rng.integers(0, 7, lanes * nblk), device="cuda")
        enc = ms_encode_blocks(x.reshape(lanes * nblk, spb), pidx)
        return enc.reshape(lanes, n).cpu().numpy(), (freq, amp)
    if spec.codec == "qoa":
        ch, rate = spec.channels, spec.sample_rate
        fb = 8 + ch * (16 + 256 * 8)
        blk = rng.integers(0, 256, (lanes, n // fb, fb), dtype=np.uint8)
        blk[..., :8] = [ch, rate >> 16, (rate >> 8) & 0xFF, rate & 0xFF, 5120 >> 8, 5120 & 0xFF,
                        fb >> 8, fb & 0xFF]
        for c in range(ch):
            state = np.concatenate([rng.integers(-200, 200, blk.shape[:2] + (4,)),
                                    rng.integers(-300, 300, blk.shape[:2] + (4,))], axis=-1)
            be = state.astype(">i2").view(np.uint8).reshape(blk.shape[:2] + (16,))
            blk[..., 8 + 16 * c: 24 + 16 * c] = be
        return blk.reshape(lanes, n), None
    if spec.codec == "pcm16":
        x, freq, amp = tone_signals(rng, lanes, n // 2, spec.sample_rate)
        return x.to(torch.int16).cpu().numpy().view(np.uint8), (freq, amp)
    return rng.integers(0, 256, (lanes, n), dtype=np.uint8), None  # ulaw


def window_tone_correlation(window: torch.Tensor, freq, amp, start: int) -> torch.Tensor:
    """Per-lane correlation of 48 kHz int8 windows with the source tones,
    the window starting at output sample ``start``; skips 0.1 s."""
    t = (start + 4800 + torch.arange(window.shape[1] - 4800, device="cuda",
                                     dtype=torch.float64)) / 48000
    y = amp * torch.sin(2 * np.pi * freq * t)
    x = window[:, 4800:].to(torch.float64)
    x, y = x - x.mean(1, keepdim=True), y - y.mean(1, keepdim=True)
    return (x * y).sum(1) / (x.norm(dim=1) * y.norm(dim=1))


def block_fleet_data():
    """The block fleet's specs and per-group bytes (3 s per lane)."""
    rng = np.random.default_rng(9)
    t0 = time.perf_counter()
    groups = [block_fleet_bytes(rng, spec, lanes, 3) for spec, lanes in zip(BLOCK_FLEET, BLOCK_LANES)]
    specs = [spec for spec, lanes in zip(BLOCK_FLEET, BLOCK_LANES) for _ in range(lanes)]
    say("block_fleet_bytes", lanes=len(specs), seconds_per_lane=3,
        bytes=sum(g.nbytes for g, _ in groups), build_seconds=round(time.perf_counter() - t0, 3))
    return specs, groups


def fed_block_engine(specs, groups) -> tuple[BatchStreamEngine, float]:
    """A CUDA engine over the block fleet with every lane's bytes fed (EOF
    after each) -> (engine, host seconds of the feeding)."""
    eng = BatchStreamEngine(specs, device="cuda")
    t0 = time.perf_counter()
    lane = 0
    for data, _ in groups:
        for row in data:
            eng.feed(lane, row.tobytes())
            eng.feed(lane, None)
            lane += 1
    return eng, time.perf_counter() - t0


@phase
def phase_block_fleet(specs, groups) -> tuple[dict, dict]:
    """The block-codec main path at full width, through the engine's entry
    points: one heterogeneous 32768-lane BatchStreamEngine, 3 s per lane,
    host-fed per lane through feed() (feed_array takes one byte matrix for
    every group, so lanes whose codecs differ in byte rate cannot be given
    equal durations through it), one-second windows. Every launch count is
    zeroed just before the run and read just after. Then each block kernel
    against its plain version at the fleet's own shapes, on the fleet's own
    first-step bytes, every lane and final state compared; the first window
    of 8 lanes per group against the CPU engine; MS ADPCM and PCM16 lanes
    against their source tones. Returns (launches, max |error|) by kernel."""
    rng = np.random.default_rng(12)
    seconds = 3
    kernels.reset_counts()
    eng, feed_s = fed_block_engine(specs, groups)
    t0 = sync_time()
    windows = []
    while (r := eng.step()) is not None:
        check(tuple(r[0].shape) == (len(specs), 48000) and r[0].dtype == torch.int8,
              "block fleet window shape/dtype")
        check(len(windows) >= seconds or bool(r[1].all()), "every lane live in its 3 s")
        if len(windows) < 2:
            windows.append(r[0])
        else:
            windows.append(None)
    dt = sync_time() - t0
    launches = {"ima_decode": ka.ima_decode_kernel.launches,
                "msadpcm_decode": ka.msadpcm_decode_kernel.launches,
                "qoa_lms": kq.qoa_lms_kernel.launches, "fma": kf.fma_kernel.launches}
    check(len(windows) >= seconds and all(n >= seconds for n in launches.values()),
          f"each block kernel launched by the fleet ({launches})")
    check(all(fn.calls == 0 for fn in kernels.PLAIN), "no plain version on the CUDA path")
    say("main_path", case="block_fleet", lanes=len(specs), windows=len(windows),
        feed_seconds=round(feed_s, 3), seconds=round(dt, 4),
        samples_decoded=eng.metrics.samples_decoded,
        realtime_factor=round(eng.metrics.samples_decoded / 48000 / dt, 1),
        launches=json.dumps(launches))

    # each kernel against its plain version on the fleet's first-step bytes
    errs = {}
    for spec, (data, _) in zip(BLOCK_FLEET, groups):
        if spec.codec not in bc.BLOCK_KERNELS:
            continue
        b = torch.tensor(data[:, : bc.geometry(spec)[0]], device="cuda")
        make_args, kernel = bc.BLOCK_KERNELS[spec.codec]
        args = make_args(spec, b)
        (out, st), ms = timed(lambda: kernel(*args))
        (ref, ref_st), plain_ms = timed(lambda: BLOCK_PLAIN[spec.codec](*args))
        (ok_o, e_o), (ok_s, e_s) = same(out, ref), same(st, ref_st)
        errs[spec.codec] = max(e_o, e_s)
        say("kernel_vs_plain_main_shape", kernel=spec.codec, lanes=out.shape[0],
            samples=out.shape[1], out_equal=ok_o, state_equal=ok_s, ms=round(ms, 4),
            plain_ms=round(plain_ms, 2))
        check(ok_o and ok_s, f"{spec.codec} kernel == plain at the fleet's shape")
        del b, args, out, ref, st, ref_st
        torch.cuda.empty_cache()
    # the FMA at the shape of the IMA group's resample: [8192, 48272] with a
    # per-column fraction
    n_out = ima_resample_width()
    x = torch.tensor(rng.uniform(-1, 1, (BLOCK_LANES[0], n_out)).astype(np.float32), device="cuda")
    frac = torch.tensor(rng.uniform(0, 1, n_out).astype(np.float32), device="cuda")
    z = x.flip(1).contiguous()
    out, ms = timed(lambda: kf.fma_kernel(x, frac, z))
    ref, plain_ms = timed(lambda: kf.fma_ref(x, frac, z))
    ok = torch.equal(out, ref)
    errs["fma"] = 0 if ok else float((out - ref).abs().max())
    say("kernel_vs_plain_main_shape", kernel="fma", lanes=x.shape[0], samples=n_out,
        out_equal=ok, ms=round(ms, 4), plain_ms=round(plain_ms, 2))
    check(ok, "fma kernel == plain at the fleet's resample shape")
    del x, frac, z, out, ref
    torch.cuda.empty_cache()

    # the first window of 8 lanes per group == the CPU engine on those lanes
    starts = np.concatenate([[0], np.cumsum(BLOCK_LANES)[:-1]])
    sub = np.concatenate([np.arange(s0, s0 + 8) for s0 in starts])
    cpu = BatchStreamEngine([specs[i] for i in sub], device="cpu")
    for i, lane in enumerate(sub):
        g = int(np.searchsorted(starts, lane, side="right")) - 1
        cpu.feed(i, groups[g][0][lane - starts[g]].tobytes())
        cpu.feed(i, None)
    check(torch.equal(windows[0][torch.tensor(sub, device="cuda")].cpu(), cpu.step()[0]),
          "block fleet's first window == CPU engine on 8 lanes per group")
    corr = {}
    for spec, s0, lanes, (_, tone) in zip(BLOCK_FLEET, starts, BLOCK_LANES, groups):
        if tone is not None:
            c = window_tone_correlation(windows[1][s0: s0 + lanes], *tone, start=48000)
            corr[spec.codec] = (round(float(c.min()), 4), round(float(c.median()), 4))
            check(bool(torch.isfinite(c).all()) and float(c.min()) > 0.8,
                  f"{spec.codec} lanes follow their source tones")
    say("block_fleet_output", lanes_equal_cpu=len(sub), tone_corr_min_median=json.dumps(corr))
    return launches, errs


@phase
def phase_block_step_breakdown(specs, groups) -> None:
    """Where the time of one block-fleet window goes: a fresh engine over
    the same bytes steps once (allocations), then one window under
    torch.profiler: its wall time, the host time of the groups' staging
    (``_GroupIO.stage``, timed by wrapping it), the device time of each
    block kernel, of the FMA kernel, of the host->device copies and of the
    other torch ops, and the device's busy share of the wall time."""
    eng, _ = fed_block_engine(specs, groups)
    staged = [0.0]
    for g in eng.groups:
        def stage(orig=g.io.stage):
            t0 = time.perf_counter()
            r = orig()
            staged[0] += time.perf_counter() - t0
            return r
        g.io.stage = stage
    t0 = sync_time()
    eng.step()
    first_ms = (sync_time() - t0) * 1e3
    staged[0] = 0.0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = sync_time()
        eng.step()
        wall = (sync_time() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {"ima": "ima_decode_kernel", "msadpcm": "msadpcm_decode_kernel",
             "qoa": "qoa_lms_kernel", "fma": "fma_kernel", "htod": "Memcpy HtoD"}
    spans = {k: [(e.time_range.start, e.time_range.end) for e in dev if v in e.name]
             for k, v in names.items()}
    spans["other"] = [(e.time_range.start, e.time_range.end) for e in dev
                      if not any(v in e.name for v in names.values())]
    everything = [iv for ivs in spans.values() for iv in ivs]
    kernels_only = [iv for k, ivs in spans.items() if k != "htod" for iv in ivs]
    say("step_breakdown", case="block_fleet", lanes=len(specs), first_step_ms=round(first_ms, 3),
        profiled_window_ms=round(wall, 3), staging_host_ms=round(staged[0] * 1e3, 3),
        **{f"{k}_ms": round(busy_ms(v), 3) for k, v in spans.items()},
        device_events=len(dev), busy_kernels=round(busy_ms(kernels_only) / wall, 4),
        busy_with_copies=round(busy_ms(everything) / wall, 4))
    del eng
    torch.cuda.empty_cache()


def block_feeds(rng, lanes: int):
    """A 4096-lane block fleet's per-lane feeds with ragged EOF tails: 1 to
    2.6 s per lane, cut at any byte; every QOA lane ends in a short frame
    (its header's sample count below 5120, the frame cut after it)."""
    specs, feeds = [], []
    share = (lanes // 4, lanes // 4, lanes // 4, lanes // 8, lanes // 8)
    for spec, n in zip(BLOCK_FLEET, share):
        data, _ = block_fleet_bytes(rng, spec, n, 3)
        in_bytes = bc.geometry(spec)[0]
        for row in data:
            if spec.codec == "qoa":
                fb = 8 + spec.channels * (16 + 256 * 8)
                frames = int(rng.integers(9, 23))
                last = int(rng.integers(100, 5120))
                frame = row[(frames - 1) * fb: frames * fb]
                frame[4:6] = [last >> 8, last & 0xFF]
                cut = (frames - 1) * fb + 8 + spec.channels * (16 + -(-last // 20) * 8)
            else:
                cut = int(rng.integers(in_bytes, int(2.6 * in_bytes)))
            specs.append(spec)
            feeds.append(row[:cut].tobytes())
    return specs, feeds


@phase
def phase_block_engines() -> None:
    """The CUDA engine against the CPU engine on a 4096-lane block fleet
    with ragged EOF tails, QOA short final frames and volume ramps: 64
    evenly spaced lanes' windows, masks, positions and checkpoints."""
    rng = np.random.default_rng(10)
    n = CHECK_LANES
    specs, feeds = block_feeds(rng, n)
    subset = np.arange(0, n, n // 64)
    vols = [(0, 0.5, False), (n // 64, 0.3, True), (n // 4 + n // 64, 1.6, True),
            (n // 2, 0.8, False)]
    compare_engines("block_fleet", BatchStreamEngine(specs, device="cuda"),
                    BatchStreamEngine([specs[i] for i in subset], device="cpu"),
                    feeds, subset, vols)


@phase
def phase_block_times() -> dict:
    """Kernels (d), (e), (f) against their plain versions at bench.py's TPU
    shapes (IMA and MS ADPCM 16384 lanes x 8192 samples, QOA 16384 x 5120),
    by CUDA events, in turns kernel, plain, kernel, plain; the kernels alone
    at the shape of their one launch in a block-fleet window (360,448 x 504,
    180,224 x 1010, 147,456 x 5120), input on the card, each beside its bound
    there; and the FMA at the fleet's resample shape."""
    rng = np.random.default_rng(11)
    lanes = BENCH_LANES
    cases = block_kernel_cases(rng, lanes)
    times = {}
    for name, (_, T) in BLOCK_BENCH_SHAPES.items():
        _, _, state, extra = cases[name]
        x = block_kernel_input(name, lanes, T)

        def kernel(x=x, state=state, extra=extra, name=name):
            bc.BLOCK_KERNELS[name][1](x, *state, *extra)

        def plain(x=x, state=state, extra=extra, name=name):
            BLOCK_PLAIN[name](x, *state, *extra)

        kernel()
        k1, p1 = event_ms(kernel, 10), event_ms(plain, 1)
        k2, p2 = event_ms(kernel, 10), event_ms(plain, 1)
        say("time", kernel=name, lanes=lanes, samples=T, ms=round(min(k1, k2), 4),
            plain_ms=round(min(p1, p2), 2),
            gsamples_per_s=round(lanes * T / min(k1, k2) / 1e6, 2))
        # the input's bytes in, int16 samples out (the per-lane state is noise)
        times[name] = timing(name, min(k1, k2), min(p1, p2), lanes * T * OPS_PER_SAMPLE[name],
                             lanes * T * (x.element_size() + 2))
        del x
    for name in BLOCK_BENCH_SHAPES:
        torch.cuda.empty_cache()  # the QOA launch: 1.5 GB in, 1.5 GB out
        lanes, T = block_fleet_shape(name)
        call = block_kernel_call(rng, name, lanes, T)
        call()
        ms = min(event_ms(call, 10), event_ms(call, 10))
        in_size = 2 if name == "qoa" else 1
        b, by = bound_ms(lanes * T * OPS_PER_SAMPLE[name], lanes * T * (in_size + 2))
        say("time", kernel=name, shape="block_fleet_window", lanes=lanes, samples=T,
            ms=round(ms, 4), gsamples_per_s=round(lanes * T / ms / 1e6, 2))
        say("bound", kernel=name, shape="block_fleet_window", ms=round(ms, 4),
            bound_ms=round(b, 4), bound_by=by, share_of_bound=round(b / ms, 4))
        del call
    torch.cuda.empty_cache()
    rows, cols = BLOCK_LANES[0], ima_resample_width()
    x = torch.rand((rows, cols), device="cuda") * 2 - 1
    frac = torch.rand(cols, device="cuda")
    z = x.flip(1).contiguous()
    k1, p1 = event_ms(lambda: kf.fma_kernel(x, frac, z), 10), event_ms(lambda: kf.fma_ref(x, frac, z), 1)
    k2, p2 = event_ms(lambda: kf.fma_kernel(x, frac, z), 10), event_ms(lambda: kf.fma_ref(x, frac, z), 1)
    # the one PyTorch call that computes z + x * y (it may round twice, so
    # the port does not use it)
    lib = event_ms(lambda: torch.addcmul(z, x, frac), 10)
    # bytes moved: two [rows, cols] float32 reads and one write (frac is a row)
    say("time", kernel="fma", lanes=rows, samples=cols, ms=round(min(k1, k2), 4),
        plain_ms=round(min(p1, p2), 2), addcmul_ms=round(lib, 4),
        gbytes_per_s=round(rows * cols * 12 / min(k1, k2) / 1e6, 1))
    times["fma"] = timing("fma", min(k1, k2), min(p1, p2), rows * cols * OPS_PER_SAMPLE["fma"],
                          rows * cols * 12, library_ms=lib)
    return times

# -- the FLAC fleet ---------------------------------------------------------------------------

FLAC_LANES = 2048  # one fleet: 1024 lanes of bench.py config 7's stream, 1024 stereo lanes
FLAC_SECONDS = 8
FLAC_DRIP = 1 << 17  # bytes per lane per step (bench.py:558)
FLAC_N = 4096  # block size (bench.py:370; flac -5)
FLAC_CHECK_LANES = 32  # each geometry 8 times: the CPU fleets run the plain loops
LPC8 = [120, -60, 30, -15, 8, -4, 2, -1]  # bench.py:371: order 8, shift 9
LPC_ROWS = 32768  # kernel (g)'s profile shape (flac_pallas.py:47-49): 32768 rows x 4096
LPC_FLEET_ROWS = 7168  # the restore batch of one step of the 2048-lane fleet
IIR_44K_LEN = 4458  # a 44.1 kHz lane's 4096-sample block, resampled to 48 kHz: off the 16-byte grid
IIR_44K_ROWS = 28672  # the 44.1 kHz stereo group's lowpass rows in one step of that fleet


def load_fixtures():
    """tests/fixtures.py (numpy and struct only), by path: on the card's
    machine ``tests`` may name another installed package."""
    return load_test_module("fixtures")


def past8(sig: np.ndarray) -> np.ndarray:
    """int64[n - 8, 8]: row i - 8 holds sig[i - 1 - j] in column j."""
    return np.lib.stride_tricks.sliding_window_view(sig, 8)[:-1, ::-1]


def bench_subframe(rng, n: int) -> dict:
    """bench.py:370-382's subframe: the order-8 residual of a random walk,
    Rice parameter 7 in 4 partitions."""
    sig = np.cumsum(rng.integers(-60, 60, n)).astype(np.int64)
    res = sig[8:] - ((past8(sig) @ np.array(LPC8)) >> 9)
    return {"type": "lpc", "order": 8, "warmup": [int(v) for v in sig[:8]], "precision": 8,
            "shift": 9, "coefs": LPC8, "residuals": [int(v) for v in res], "param": 7,
            "partition_order": 2}


def stereo_frame(fx, rng, n: int, rate: int, asgn: int) -> bytes:
    """One stereo frame of two tones and noise: mid/side (10) or left/side
    (8), an encoder-like LPC-8 subframe for each channel
    (tests/torch_tracks.py ``fitted_subframe``)."""
    fitted_subframe = load_test_module("torch_tracks").fitted_subframe
    t = np.arange(n) / rate
    f = rng.uniform(80, 2000, 2)
    left = (6000 * np.sin(2 * np.pi * f[0] * t + rng.uniform(0, 6))
            + 3000 * np.sin(2 * np.pi * f[1] * t) + rng.normal(0, 40, n)).astype(np.int64)
    right = (0.7 * left + 2000 * np.sin(2 * np.pi * f[1] * 1.5 * t)
             + rng.normal(0, 40, n)).astype(np.int64)
    a, b = ((left + right) >> 1, left - right) if asgn == 10 else (left, left - right)
    return fx.flac_frame([fitted_subframe(a), fitted_subframe(b)], n, asgn, 16)


def flac_stream(fx, frames: list, rate: int, channels: int, order) -> bytes:
    """A FLAC stream of the given frames in the given order."""
    # bytes 5-6 of a fixtures.flac_frame header (frame number 0): block size - 1
    n = sum(int.from_bytes(frames[k][5:7], "big") + 1 for k in order)
    return fx.flac_stream_header(rate, channels, 16, n) + b"".join(frames[k] for k in order)


def flac_main_streams(fx, variants: int = 4) -> list:
    """The flac_fleet phase's lanes: the first half bench.py config 7's stream
    (48 kHz mono LPC-8, block 4096), the second half 44.1 kHz mid/side
    stereo LPC-8, block 4096; each ~FLAC_SECONDS long, built from
    ``variants`` distinct frames per group repeated in turn, as bench.py
    repeats ``one``. Lanes share ``variants`` byte strings per group."""
    rng = np.random.default_rng(13)
    mono = [fx.flac_frame([bench_subframe(rng, FLAC_N)], FLAC_N, 0, 16) for _ in range(variants)]
    stereo = [stereo_frame(fx, rng, FLAC_N, 44100, 10) for _ in range(variants)]
    out = []
    for frames, rate, ch in ((mono, 48000, 1), (stereo, 44100, 2)):
        nfr = -(-FLAC_SECONDS * rate // FLAC_N)
        streams = [flac_stream(fx, frames, rate, ch, [(v + k) % variants for k in range(nfr)])
                   for v in range(variants)]
        out += [streams[i % variants] for i in range(FLAC_LANES // 2)]
    return out


def flac_check_streams(fx, lanes: int) -> list:
    """The flac_engines phase's ragged fleet, four geometries in turn: 48 kHz
    mono (bench.py's frames), 44.1 kHz mid/side, 32 kHz left/side at an odd
    block size of 1000, and 48 kHz mono ending in a short frame of 1234
    samples (its last step takes the staged route); 4-10 frames per lane."""
    rng = np.random.default_rng(14)
    mono = [fx.flac_frame([bench_subframe(rng, FLAC_N)], FLAC_N, 0, 16) for _ in range(3)]
    ms = [stereo_frame(fx, rng, FLAC_N, 44100, 10) for _ in range(3)]
    ls = [stereo_frame(fx, rng, 1000, 32000, 8) for _ in range(3)]
    short = [fx.flac_frame([bench_subframe(rng, 1234)], 1234, 0, 16)]
    out = []
    for lane in range(lanes):
        order = [int(k) for k in rng.integers(0, 3, int(rng.integers(4, 11)))]
        g = lane % 4
        if g == 0:
            out.append(flac_stream(fx, mono, 48000, 1, order))
        elif g == 1:
            out.append(flac_stream(fx, ms, 44100, 2, order))
        elif g == 2:
            out.append(flac_stream(fx, ls, 32000, 2, order * 3))
        else:
            out.append(flac_stream(fx, mono + short, 48000, 1, order + [3]))
    return out


def run_flac(fleet, streams, drip: int, volumes=()):
    """Feed ``drip`` bytes per lane per step, then EOF, and step to the end;
    -> (every step's result, every lane's checkpoint)."""
    for lane, vol in volumes:
        fleet.set_volume(lane, vol, ramp=True)
    off = 0
    steps = []
    while not fleet.done:
        for lane, data in enumerate(streams):
            if off < len(data):
                fleet.feed(lane, data[off: off + drip])
            elif off - drip < len(data):
                fleet.feed(lane, None)
        off += drip
        steps.append(fleet.step())
        check(len(steps) < 10_000, "the fleet ends")
    return steps, [fleet.checkpoint(lane) for lane in range(len(streams))]


def flac_steps_diff(a, b) -> float:
    """max |window difference| of two runs; raises if their masks,
    positions or step structure differ."""
    check(len(a) == len(b), f"step counts {len(a)} == {len(b)}")
    err = 0.0
    for x, y in zip(a, b):
        check((x is None) == (y is None), "the same steps emit windows")
        if x is not None:
            check(np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2]),
                  "masks and positions equal")
            check(x[0].shape == y[0].shape and bool(np.isfinite(x[0]).all()), "window shapes")
            err = max(err, float(np.abs(x[0] - y[0]).max()))
    return err


@phase
def phase_flac_kernel_vs_plain() -> dict:
    """Kernels (g) and (h) against their plain versions on the same CUDA
    tensors, max |error| 0: small ragged shapes (every tap bucket K, shifts
    0, 15, 17, 20, 31 and negative, ragged blocks), then (g) at 32768 x 4096
    order 8 and at K = 32 on 4096 x 1024, and (h) at 32768 x 4096."""
    rng = np.random.default_rng(15)
    errs = {"lpc_restore": 0, "iir_zero": 0}
    cases = [(1, 1, 1), (65, 70, 3), (300, 257, 8), (130, 600, 13), (70, 300, 32)]
    for rows, T, order in cases:
        args = lpc_args(rng, rows, T, order)
        ok, err = same(kg.lpc_restore_kernel(*args), kg.lpc_restore_ref(*args))
        errs["lpc_restore"] = max(errs["lpc_restore"], err)
        check(ok, f"lpc_restore kernel == plain at {rows} x {T}, order {order}")
    for rows, T in ((1, 1), (65, 70), (300, 4458)):
        x = torch.tensor((rng.standard_normal((rows, T)) * 0.5).astype(np.float32), device="cuda")
        for alpha in (fir_alpha(44100, 48000), 0.12):
            ok = torch.equal(kh.iir_zero_kernel(x, alpha), kh.iir_zero_ref(x, alpha))
            check(ok, f"iir_zero kernel == plain at {rows} x {T}")
    say("kernel_vs_plain", kernel="lpc_restore", shapes=json.dumps(cases), out_equal=True)
    say("kernel_vs_plain", kernel="iir_zero", shapes="[[1,1],[65,70],[300,4458]]", out_equal=True)
    lpc = (kg.lpc_restore_kernel, kg.lpc_restore_ref)
    for name, key, (kernel, plain), make in (
            ("lpc_restore", "lpc_restore", lpc, lambda: lpc_bench_args(rng, LPC_ROWS, FLAC_N)),
            ("lpc_restore_k32", "lpc_restore", lpc, lambda: lpc_args(rng, 4096, 1024, 32)),
            ("iir_zero", "iir_zero", (kh.iir_zero_kernel, kh.iir_zero_ref),
             lambda: iir_args(rng, LPC_ROWS, FLAC_N))):
        args = make()
        out, ms = timed(lambda: kernel(*args))
        ref, plain_ms = timed(lambda: plain(*args))
        ok = torch.equal(out, ref)
        err = 0 if ok else float((out.double() - ref.double()).abs().max())
        errs[key] = max(errs[key], err)
        say("kernel_vs_plain_main_shape", kernel=name, rows=out.shape[0], samples=out.shape[1],
            out_equal=ok, ms=round(ms, 4), plain_ms=round(plain_ms, 2))
        check(ok, f"{name} kernel == plain at {tuple(out.shape)}")
        del args, out, ref
        torch.cuda.empty_cache()
    return errs


def lpc_args(rng, rows: int, T: int, max_order: int) -> tuple:
    """Kernel (g)'s arguments as test_flac_lpc_pallas_matches_int64 makes
    them: orders up to ``max_order``, every kind of shift, ragged blocks."""
    orders = rng.integers(0, max_order + 1, rows)
    orders[0] = max_order
    shifts = rng.choice([0, 5, 9, 12, 15, 17, 20, 31, -1, -3, 14], rows)
    blocks = rng.integers(max(1, T // 2), T + 1, rows)
    coefs = np.where(np.arange(32)[None, :] < orders[:, None],
                     rng.integers(-(1 << 14), (1 << 14) + 1, (rows, 32)), 0)
    vals = rng.integers(-2000, 2000, (rows, T))
    vals = np.where(np.arange(T)[None, :] < orders[:, None],
                    rng.integers(-30000, 30000, (rows, T)), vals)
    neg = shifts < 0
    coefs[neg] //= 1 << 12
    vals[neg] = np.clip(vals[neg], -3, 3)
    return tuple(cuda_i32(a) for a in (vals, orders, shifts, blocks, coefs))


def cuda_generator(rng) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 31)))


def lpc_bench_args(rng, rows: int, T: int) -> tuple:
    """Kernel (g)'s arguments at bench.py's stream, made on the card: order
    8, shift 9, full blocks, a random walk's residuals."""
    sig = torch.randint(-60, 60, (rows, T), device="cuda", generator=cuda_generator(rng)).cumsum(1)
    pred = torch.zeros_like(sig)
    for j, c in enumerate(LPC8):  # pred[i] = sum_j c_j sig[i - 1 - j]
        pred[:, 8:] += c * sig[:, 7 - j: T - 1 - j]
    vals = torch.where(torch.arange(T, device="cuda") < 8, sig, sig - (pred >> 9))
    coefs = torch.zeros((rows, 32), dtype=torch.int32, device="cuda")
    coefs[:, :8] = torch.tensor(LPC8, dtype=torch.int32, device="cuda")

    def lane(v):
        return torch.full((rows,), v, dtype=torch.int32, device="cuda")

    return vals.to(torch.int32), lane(8), lane(9), lane(T), coefs


def iir_args(rng, rows: int, T: int) -> tuple:
    x = torch.randn((rows, T), device="cuda", generator=cuda_generator(rng)) * 0.3
    return x, fir_alpha(44100, 48000)


@phase
def phase_flac_engines(fx) -> None:
    """The CUDA FLAC fleet against the same fleet on the CPU (the kernels'
    plain versions) on a ragged fleet of FLAC_CHECK_LANES lanes in four geometries, volume
    ramps in flight: windows, masks, positions and checkpoints bit-equal,
    and within the reference's 5e-3 of the host route. The device-resident
    route in all four interpolation modes and with mono=False, and the
    staged route (on a fleet of one geometry, the route's condition)."""
    streams = flac_check_streams(fx, FLAC_CHECK_LANES)
    vols = [(1, 0.5), (6, 1.4), (11, 0.2)]
    cases = [("resident", mode, True, {"device_restore": True}, streams)
             for mode in ("none", "linear", "cubic", "sinc")]
    cases.append(("resident", "linear", False, {"device_restore": True}, streams))
    cases.append(("staged", "cubic", True, {"device_restore": False},
                  [streams[1 + 4 * (i % (FLAC_CHECK_LANES // 4))] for i in range(FLAC_CHECK_LANES)]))
    for route, mode, mono, kw, lanes in cases:
        counts = (kg.lpc_restore_kernel.launches, kh.iir_zero_kernel.launches)
        t0 = time.perf_counter()
        got, ck_got = run_flac(FlacFleet(len(lanes), device_dsp=True, mono=mono,
                                         interpolation=mode, device="cuda", **kw),
                               lanes, 1 << 16, vols)
        t1 = time.perf_counter()
        want, ck_want = run_flac(FlacFleet(len(lanes), device_dsp=True, mono=mono,
                                           interpolation=mode, device="cpu", **kw),
                                 lanes, 1 << 16, vols)
        t2 = time.perf_counter()
        host, _ = run_flac(FlacFleet(len(lanes), mono=mono, interpolation=mode, device="cpu"),
                           lanes, 1 << 16, vols)
        err, err_host = flac_steps_diff(got, want), flac_steps_diff(got, host)
        launched = (kg.lpc_restore_kernel.launches - counts[0],
                    kh.iir_zero_kernel.launches - counts[1])
        say("flac_engine_cuda_vs_cpu", route=route, mode=mode, mono=mono, lanes=len(lanes),
            steps=len(got), max_abs_err=err, checkpoints_equal=deep_equal(ck_got, ck_want),
            max_abs_err_vs_host=err_host, lpc_launches=launched[0], iir_launches=launched[1],
            cuda_seconds=round(t1 - t0, 3), cpu_seconds=round(t2 - t1, 3))
        check(err == 0 and deep_equal(ck_got, ck_want),
              f"{route}/{mode}: CUDA fleet == CPU fleet")
        check(err_host <= 5e-3, f"{route}/{mode}: within 5e-3 of the host route")
        check(launched[1] > 0 and (launched[0] > 0) == kw["device_restore"],
              f"{route}/{mode}: the route's kernels ran")


def feed_step(fleet, streams, off: int, drip: int) -> None:
    """One step's feed of the main fleet: each distinct byte string is cut
    once and handed to every lane that carries it."""
    cut = {}
    for lane, data in enumerate(streams):
        key = id(data)
        if key not in cut:
            cut[key] = data[off: off + drip] if off < len(data) else (
                None if off - drip < len(data) else False)
        if cut[key] is not False:
            fleet.feed(lane, cut[key])


@phase
def phase_flac_fleet(streams) -> dict:
    """The FLAC main path at full width, through the fleet's entry points:
    2048 drip-fed lanes, FLAC_SECONDS each, FLAC_DRIP bytes per lane per
    step, device-resident route (two geometry groups per step: the 48 kHz
    identity rate and 44.1 -> 48 kHz). Launch counts are zeroed just before
    and read just after. Then the first window of 8 lanes against the CPU
    fleet (plain versions: bit-equal) and the host route (5e-3)."""
    kernels.reset_counts()
    t0 = sync_time()
    fleet = FlacFleet(FLAC_LANES, device_restore=True, device_dsp=True, device="cuda")
    sub = [0, 1, 2, 3, FLAC_LANES - 4, FLAC_LANES - 3, FLAC_LANES - 2, FLAC_LANES - 1]
    off, windows, kept, level = 0, 0, [], []
    while not fleet.done:
        feed_step(fleet, streams, off, FLAC_DRIP)
        off += FLAC_DRIP
        r = fleet.step()
        if r is not None:
            w, mask, _pos = r
            check(w.shape == (FLAC_LANES, 48000) and bool(np.isfinite(w).all())
                  and float(np.abs(w).max()) <= 128.0, "flac window shape and range")
            level.append(float(np.abs(w[mask]).mean()))
            windows += 1
        if len(kept) < 3:  # the first steps' rows of the compared lanes
            kept.append(np.zeros((len(sub), 48000), np.float32) if r is None else r[0][sub].copy())
    dt = sync_time() - t0
    launches = {"lpc_restore": kg.lpc_restore_kernel.launches,
                "iir_zero": kh.iir_zero_kernel.launches, "fma": kf.fma_kernel.launches}
    plain = {fn.__name__: fn.calls for fn in kernels.PLAIN}
    audio = fleet.metrics.samples_decoded / 48000
    say("main_path", case="flac_fleet", lanes=FLAC_LANES, seconds_per_lane=FLAC_SECONDS,
        drip=FLAC_DRIP, steps=fleet.metrics.steps, windows=windows, seconds=round(dt, 4),
        audio_seconds=round(audio, 1), realtime_factor=round(audio / dt, 1),
        launches=json.dumps(launches), plain_calls=sum(plain.values()))
    check(launches["lpc_restore"] > 0 and launches["iir_zero"] > 0 and launches["fma"] > 0,
          f"kernels (g), (h) and the FMA launched by the FLAC fleet ({launches})")
    check(all(n == 0 for n in plain.values()), f"no plain version on the CUDA path ({plain})")
    check(audio >= FLAC_LANES * FLAC_SECONDS, "every lane decoded its seconds")

    # the first three steps of 8 lanes (both groups) against the same lanes
    # on the CPU: the kernels' plain versions, and the host route (a step
    # with no window counts as masked silence)
    errs = {}
    for name, kw in (("cpu", {"device_restore": True, "device_dsp": True}), ("host", {})):
        cpu = FlacFleet(len(sub), device="cpu", **kw)
        got = []
        for k in range(len(kept)):
            feed_step(cpu, [streams[i] for i in sub], k * FLAC_DRIP, FLAC_DRIP)
            r = cpu.step()
            got.append(np.zeros((len(sub), 48000), np.float32) if r is None else r[0])
        errs[name] = max(float(np.abs(a - b).max()) for a, b in zip(kept, got))
    check(any(a.any() for a in kept), "the compared steps carry audio")
    say("flac_fleet_output", compared_lanes=len(sub), compared_steps=len(kept),
        max_abs_err_vs_cpu=errs["cpu"], max_abs_err_vs_host=errs["host"],
        mean_abs_level_median=round(float(np.median(level)), 3))
    check(errs["cpu"] == 0, "flac fleet's first windows == CPU fleet on 8 lanes")
    check(errs["host"] <= 5e-3, "flac fleet's first windows within 5e-3 of the host route")
    check(float(np.median(level)) > 1.0, "the windows carry audio")
    return launches


@phase
def phase_flac_step_breakdown(streams) -> dict:
    """Where the time of one FLAC fleet step goes: a fresh fleet steps once
    on one drip (allocations; the arguments of kernels (g) and (h) are kept),
    then one steady step under torch.profiler: its wall time, the host parse
    (``_parse_step``), the staging of the restore batches (host time from
    ``_device_full_step``'s start to the restore's launch, pageable copies
    included), the device time of (g), (h), the FMA kernel, the host<->device
    copies and the other torch ops, and the device's busy share. Then (g)
    and (h) against their plain versions on the kept arguments (one real
    step's restore batch and lowpass rows)."""
    fleet = FlacFleet(FLAC_LANES, device_restore=True, device_dsp=True, device="cuda")
    clock = {"parse": 0.0, "stage": 0.0, "start": None}
    kept = {}

    def timed_parse(orig=fleet._parse_step):
        t0 = time.perf_counter()
        r = orig()
        clock["parse"] += time.perf_counter() - t0
        return r

    def timed_full(parsed, orig=fleet._device_full_step):
        clock["start"] = time.perf_counter()
        return orig(parsed)

    def restore(*a, **k):
        clock["stage"] += time.perf_counter() - clock["start"]
        kept.setdefault("lpc", (a, k))
        return kg.lpc_restore_kernel(*a, **k)

    def lowpass(*a):  # one launch a geometry group: 4096-sample rows, and 44.1 kHz rows
        kept.setdefault(("iir", a[0].shape[1]), a)
        return kh.iir_zero_kernel(*a)

    fleet._parse_step, fleet._device_full_step = timed_parse, timed_full
    ff.lpc_restore_kernel, ff.iir_zero_kernel = restore, lowpass
    try:
        feed_step(fleet, streams, 0, FLAC_DRIP)
        t0 = sync_time()
        fleet.step()
        first_ms = (sync_time() - t0) * 1e3
        ff.iir_zero_kernel = kh.iir_zero_kernel
        clock["parse"] = clock["stage"] = 0.0
        feed_step(fleet, streams, FLAC_DRIP, FLAC_DRIP)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = sync_time()
            fleet.step()
            wall = (sync_time() - t0) * 1e3
    finally:
        ff.lpc_restore_kernel, ff.iir_zero_kernel = kg.lpc_restore_kernel, kh.iir_zero_kernel
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {"lpc_restore": "lpc_restore_kernel", "iir_zero": "iir_zero_kernel",
             "fma": "fma_kernel", "htod": "Memcpy HtoD", "dtoh": "Memcpy DtoH"}
    spans = {k: [(e.time_range.start, e.time_range.end) for e in dev if v in e.name]
             for k, v in names.items()}
    spans["other"] = [(e.time_range.start, e.time_range.end) for e in dev
                      if not any(v in e.name for v in names.values())]
    everything = [iv for ivs in spans.values() for iv in ivs]
    kernels_only = [iv for k, ivs in spans.items() if k not in ("htod", "dtoh") for iv in ivs]
    rows = kept["lpc"][0][0].shape
    say("step_breakdown", case="flac_fleet", lanes=FLAC_LANES, first_step_ms=round(first_ms, 3),
        profiled_step_ms=round(wall, 3), host_parse_ms=round(clock["parse"] * 1e3, 3),
        staging_host_ms=round(clock["stage"] * 1e3, 3), restore_rows=rows[0],
        **{f"{k}_ms": round(busy_ms(v), 3) for k, v in spans.items()},
        device_events=len(dev), busy_kernels=round(busy_ms(kernels_only) / wall, 4),
        busy_with_copies=round(busy_ms(everything) / wall, 4))
    del fleet
    errs = {}
    lowpass_rows = sorted(k[1] for k in kept if k != "lpc")
    check(FLAC_N in lowpass_rows and IIR_44K_LEN in lowpass_rows,
          f"the step filters 48 kHz and 44.1 kHz rows ({lowpass_rows})")
    check(tuple(kept["iir", IIR_44K_LEN][0].shape) == (IIR_44K_ROWS, IIR_44K_LEN),
          "the 44.1 kHz group's rows are the shape kernel (h) is timed at")
    for name, kernel, plain, (args, kw) in (
            ("lpc_restore", kg.lpc_restore_kernel, kg.lpc_restore_ref, kept["lpc"]),
            *(("iir_zero", kh.iir_zero_kernel, kh.iir_zero_ref, (kept["iir", T], {}))
              for T in lowpass_rows)):
        out, ms = timed(lambda: kernel(*args, **kw))
        ref, plain_ms = timed(lambda: plain(*args, **kw))
        ok = torch.equal(out, ref)
        err = 0 if ok else float((out.double() - ref.double()).abs().max())
        errs[name] = max(errs.get(name, 0), err)
        say("kernel_vs_plain_fleet_step", kernel=name, rows=out.shape[0], samples=out.shape[1],
            out_equal=ok, ms=round(ms, 4), plain_ms=round(plain_ms, 2))
        check(ok, f"{name} kernel == plain on one fleet step's arguments")
        del out, ref
    del kept
    torch.cuda.empty_cache()
    return errs


@phase
def phase_flac_times() -> dict:
    """Kernels (g) and (h) against their plain versions at the main shapes
    (32768 x 4096; (g) at order 8), by CUDA events, in turns kernel, plain,
    kernel, plain; then each alone at the shapes one step of the 2048-lane
    fleet launches it, (h) on 48 kHz and on 44.1 kHz rows."""
    rng = np.random.default_rng(16)
    times = {}
    for name, args, kernel, plain in (
            ("lpc_restore", lpc_bench_args(rng, LPC_ROWS, FLAC_N), kg.lpc_restore_kernel,
             kg.lpc_restore_ref),
            ("iir_zero", iir_args(rng, LPC_ROWS, FLAC_N), kh.iir_zero_kernel, kh.iir_zero_ref)):
        kernel(*args)
        k1, p1 = event_ms(lambda: kernel(*args), 10), event_ms(lambda: plain(*args), 1)
        k2, p2 = event_ms(lambda: kernel(*args), 10), event_ms(lambda: plain(*args), 1)
        say("time", kernel=name, rows=LPC_ROWS, samples=FLAC_N, ms=round(min(k1, k2), 4),
            plain_ms=round(min(p1, p2), 2),
            gsamples_per_s=round(LPC_ROWS * FLAC_N / min(k1, k2) / 1e6, 2))
        # 4-byte samples in and out; every row of this input is order 8
        ops = lpc_ops_per_sample(8) if name == "lpc_restore" else OPS_PER_SAMPLE[name]
        times[name] = timing(name, min(k1, k2), min(p1, p2), LPC_ROWS * FLAC_N * ops,
                             LPC_ROWS * FLAC_N * 8)
        del args
        torch.cuda.empty_cache()
    # (g) at the shape one step of the 2048-lane fleet launches it
    args = lpc_bench_args(rng, LPC_FLEET_ROWS, FLAC_N)
    kg.lpc_restore_kernel(*args)
    ms = min(event_ms(lambda: kg.lpc_restore_kernel(*args), 10) for _ in range(2))
    say("time", kernel="lpc_restore_fleet_step", rows=LPC_FLEET_ROWS, samples=FLAC_N,
        ms=round(ms, 4), gsamples_per_s=round(LPC_FLEET_ROWS * FLAC_N / ms / 1e6, 2))
    timing("lpc_restore_fleet_step", ms, float("nan"),
           LPC_FLEET_ROWS * FLAC_N * lpc_ops_per_sample(8), LPC_FLEET_ROWS * FLAC_N * 8)
    del args
    # (h) at the shapes one step of the fleet launches it: a 48 kHz group's
    # rows, and a 44.1 kHz group's (rows off the 16-byte grid)
    for label, rows, T in (("48k", LPC_FLEET_ROWS, FLAC_N), ("44k1", IIR_44K_ROWS, IIR_44K_LEN)):
        args = iir_args(rng, rows, T)
        kh.iir_zero_kernel(*args)
        ms = min(event_ms(lambda: kh.iir_zero_kernel(*args), 10) for _ in range(2))
        say("time", kernel=f"iir_zero_fleet_step_{label}", rows=rows, samples=T,
            ms=round(ms, 4), gsamples_per_s=round(rows * T / ms / 1e6, 2))
        timing(f"iir_zero_fleet_step_{label}", ms, float("nan"),
               rows * T * OPS_PER_SAMPLE["iir_zero"], rows * T * 8)
        del args
    return times


# -- the FLAC host route's float64 DSP on the card --------------------------------------------

FLAC_DSP_LANES = 1024  # the radio cell's FLAC stations (portbench radio_fleet: a third of 3072)
FLAC_DSP_FRAMES = 12  # frames a lane commits a step (the radio's ticks: 11,819 over 1024 lanes)
FLAC_DSP_STEPS = 3  # lane 0 takes steps 0 and 1's bytes at step 0, step 2's at step 1
FLAC_DSP_VOLUMES = ((0, 0.5, False), (1, 0.3, True), (5, 1.6, True))  # (lane, volume, ramp)
# one step of the CD radio (portbench flac_cd.cd_live): its stations, and the
# 4096-sample blocks of 44.1 kHz a station commits a one-second tick
FLAC_CD_LANES, FLAC_CD_BLOCKS = 512, 11
# float64 operations a sample of the 48 kHz identity lanes, counted from
# csrc/flac_dsp.cu: the decode's conversion and its multiply by 2^-depth
# (2), the alpha multiply (1), eight doubling passes of a multiply and an
# add (16), the gain and the scale (2), the clip's two compares and the
# cast (3). The H100 runs float64 at half its float32 rate, so they count
# twice against OPS_PER_S.
FLAC_DSP_OPS = 24


@phase
def phase_flac_f64_dsp() -> tuple[dict, float, dict]:
    """The FLAC host route's float64 DSP on the card, kernel
    ``aukit_flac_dsp_f64``: (1) the kernel against its plain version on the
    CPU on every case of ``tests/torch_kernel_cases.py`` ``flac_dsp_cases``,
    bit for bit; (2) the default route of ``FlacFleet(device="cuda")`` at
    the radio cell's width, FLAC_DSP_LANES lanes of 48 kHz mono LPC-8
    frames of 4096 samples (bench.py config 7's, as ``flac -5`` codes them),
    FLAC_DSP_FRAMES frames a lane a step (lane 0 two steps' frames at once,
    so that its backlog outlives the next step's pop), a constant gain and
    two ramps: every window, mask and position of FLAC_DSP_STEPS steps and
    every lane's checkpoint (lowpass state, resample history, ramp, FIFO)
    equal to ``FlacFleet(device="cpu")``'s numpy route, one launch a step,
    every decoded lane on the kernel, the lane FIFOs viewing one step's
    pinned block of windows at most (the pinned bytes they hold after each
    step, and the caching host allocator's, printed); (3) the last step's
    launch again by CUDA events, beside its bytes bound and the plain
    version's time on the card, their outputs equal; (4) one CD radio step
    the same way, FLAC_CD_LANES stereo 44.1 kHz lanes of FLAC_CD_BLOCKS
    blocks mixed to mono, each block's channel assignment drawn from the
    four of ``flac -m``. -> (the radio step's timing row,
    max |error|, the launches of (2)'s steps: counts zeroed just before
    them and read just after)."""
    for name, restored, lanes, asgn, fin, numel, geo in \
            load_test_module("torch_kernel_cases").flac_dsp_cases("cuda"):
        out, want_out = torch.full((numel,), -999.0, device="cuda"), torch.full((numel,), -999.0)
        state = kd.flac_dsp_kernel(restored, lanes, asgn, fin, out, geo)
        want = kd.flac_dsp_ref(restored.cpu(), lanes, asgn, fin, want_out, geo)
        equal = torch.equal(out.cpu(), want_out) and torch.equal(state.cpu(), want)
        say("flac_f64_dsp_case", case=name, lanes=len(lanes), equal=equal)
        check(equal, f"flac_dsp_f64 kernel == plain version on {name}")

    fx = load_fixtures()
    rng = np.random.default_rng(18)
    frames = [fx.flac_frame([bench_subframe(rng, FLAC_N)], FLAC_N, 0, 16) for _ in range(8)]
    nfr = FLAC_DSP_FRAMES * FLAC_DSP_STEPS
    variants, cuts = [], []
    for v in range(len(frames)):
        order = [(v + k) % len(frames) for k in range(nfr)]
        data = flac_stream(fx, frames, 48000, 1, order)
        ends = np.cumsum([len(frames[k]) for k in order])
        head = len(data) - int(ends[-1])
        variants.append(data)
        cuts.append([0] + [head + int(ends[FLAC_DSP_FRAMES * (s + 1) - 1])
                           for s in range(FLAC_DSP_STEPS)])

    def feed(lane: int, step: int) -> bytes:
        """A step's bytes a step; lane 0's run a step ahead from step 0."""
        c = cuts[lane % len(variants)]
        if lane == 0:
            c = [c[0], c[2], c[3], c[3]]
        return variants[lane % len(variants)][c[step]: c[step + 1]]

    def pinned_blocks(fleet) -> dict:
        """The pinned host blocks that the fleet's lane FIFOs view -> bytes
        by block."""
        return {id(a.base): a.base.nbytes for ln in fleet._lanes for a in ln.fifo
                if a.base is not None and isinstance(a.base.base, torch.Tensor)
                and a.base.base.is_pinned()}

    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    recorded = []
    kernel = ff.flac_dsp_kernel

    def recording(*args):
        recorded[:] = [args]
        return kernel(*args)

    fleets = {dev: FlacFleet(FLAC_DSP_LANES, device=dev) for dev in ("cuda", "cpu")}
    for fleet in fleets.values():
        for lane, vol, ramp in FLAC_DSP_VOLUMES:
            fleet.set_volume(lane, vol, ramp=ramp)
    seconds = {"cuda": 0.0, "cpu": 0.0}
    held, copied = [], 0
    ff.flac_dsp_kernel = recording
    kernels.reset_counts()
    try:
        for step in range(FLAC_DSP_STEPS):
            results = {}
            for dev, fleet in fleets.items():
                for lane in range(FLAC_DSP_LANES):
                    data = feed(lane, step)
                    if data:
                        fleet.feed(lane, data)
                t0 = sync_time()
                results[dev] = fleet.step()
                seconds[dev] += sync_time() - t0
            got, want = results["cuda"], results["cpu"]
            check(got is not None and want is not None
                  and all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"step {step}: windows, masks and positions == the CPU fleet's")
            blocks = pinned_blocks(fleets["cuda"])
            stats = host_stats() if host_stats is not None else {}
            held.append({"blocks": len(blocks), "bytes": sum(blocks.values()),
                         **{k: v for k, v in stats.items()
                            if k in ("allocated_bytes.current", "reserved_bytes.current")}})
            copied += sum(a.base is None or not isinstance(a.base.base, torch.Tensor)
                          for a in fleets["cuda"]._lanes[0].fifo)
    finally:
        ff.flac_dsp_kernel = kernel
    launched, plain = kd.flac_dsp_kernel.launches, plain_calls()
    card, cpu = fleets["cuda"], fleets["cpu"]
    same_state = all(deep_equal(card.checkpoint(lane), cpu.checkpoint(lane))
                     for lane in range(FLAC_DSP_LANES))
    decoded = FLAC_DSP_LANES * FLAC_DSP_STEPS - 1  # lane 0 decodes nothing at step 2
    say("flac_f64_dsp_fleet", lanes=FLAC_DSP_LANES, frames_per_step=FLAC_DSP_FRAMES,
        steps=FLAC_DSP_STEPS, frames_parsed=card.metrics.frames_parsed,
        checkpoints_equal=same_state, launches=launched, plain_calls=plain,
        dsp_lanes_device=card.metrics.dsp_lanes_device,
        dsp_lanes_host=card.metrics.dsp_lanes_host,
        card_step_seconds=round(seconds["cuda"] / FLAC_DSP_STEPS, 4),
        cpu_step_seconds=round(seconds["cpu"] / FLAC_DSP_STEPS, 4),
        fifo_pinned_after_steps=json.dumps(held), lane0_fifo_copies=copied)
    check(same_state, "every lane's checkpoint == the CPU fleet's")
    check(launched == FLAC_DSP_STEPS and plain == 0,
          f"one flac_dsp_f64 launch a step and no plain version ({launched}, {plain})")
    check(card.metrics.dsp_lanes_device == decoded and card.metrics.dsp_lanes_host == 0,
          f"every decoded lane's DSP ran in the kernel ({decoded})")
    check(card.metrics.frames_parsed == FLAC_DSP_LANES * nfr, "every frame committed")
    check(all(h["blocks"] <= 1 for h in held) and copied > 0,
          f"the FIFOs view one step's pinned block at most, lane 0's backlog copied ({held})")

    def timed_step(name: str, args: tuple) -> tuple[float, float, float, int, int]:
        """One launch again: (the kernel's ms by CUDA events, the plain
        version's ms on the card, max |kernel - plain|, bytes, samples in),
        printed."""
        restored, lanes, asgn, fin, out, geo = args
        kernel(*args)
        ms = min(event_ms(lambda: kernel(*args), 10) for _ in range(2))
        plain_out = torch.full_like(out, -999.0)
        plain_ms = event_ms(lambda: kd.flac_dsp_ref(restored, lanes, asgn, fin, plain_out, geo),
                            1)
        err = float((out - plain_out).abs().max())
        blocks = int(lanes[:, 1].sum())
        samples_in = blocks * geo.block * geo.channels
        samples_out = blocks * geo.out_len * (geo.channels if geo.out_mode == "multi" else 1)
        nbytes = (samples_in * 8 + samples_out * 4 + lanes.numel() * 8 + asgn.numel() * 4
                  + fin.numel() * 8)
        say("time", kernel=name, lanes=len(lanes), blocks=blocks, samples=samples_in,
            ms=round(ms, 4), plain_ms=round(plain_ms, 2), max_abs_err_vs_plain=err,
            gsamples_per_s=round(samples_in / ms / 1e6, 2))
        check(err == 0, f"{name}: the launch == the plain version on the card")
        return ms, plain_ms, err, nbytes, samples_in

    ms, plain_ms, err, nbytes, samples_in = timed_step("flac_dsp_f64", recorded[0])
    row = timing("flac_dsp_f64", ms, plain_ms, samples_in * FLAC_DSP_OPS * 2, nbytes)

    L, m, n = FLAC_CD_LANES, FLAC_CD_BLOCKS, FLAC_N
    rng = np.random.default_rng(21)
    asgn = rng.choice([1, 8, 9, 10], L * m).astype(np.int32)
    geo = kd.geometry(44100, 2, 16, n, asgn, 48000, "linear", "mix", fir_alpha(44100, 48000))
    lanes = np.stack([np.arange(L) * m * 2 * n, np.full(L, m), np.arange(L) * m * geo.out_len,
                      np.zeros(L), np.zeros(L), np.arange(L) * m], axis=1).astype(np.int64)
    fin = np.concatenate([np.ones((L, 2)), rng.standard_normal((L, 2)) * 0.3], axis=1)
    cd = (torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, L * m * 2 * n)).cuda(),
          torch.from_numpy(lanes), torch.from_numpy(asgn), torch.from_numpy(fin),
          torch.empty(L * m * geo.out_len, dtype=torch.float32, device="cuda"), geo)
    cd_ms, _p, cd_err, cd_bytes, _s = timed_step("flac_dsp_f64_cd", cd)
    cd_bound, by = bound_ms(0, cd_bytes)
    say("bound", kernel="flac_dsp_f64_cd", ms=round(cd_ms, 4), bound_ms=round(cd_bound, 4),
        bound_by=by, share_of_bound=round(cd_bound / cd_ms, 4))
    return row, max(err, cd_err), {"flac_dsp_f64": launched}


# -- the write path: kernel (c) and the transcode ---------------------------------------------

TRANSCODE_MONO = 16384  # 48 kHz mono PCM16 lanes (bench.py:670-688's stream at fleet width)
TRANSCODE_STEREO = 8192  # 44.1 kHz stereo PCM16 lanes
TRANSCODE_SECONDS = 3
# windows of the picked lanes the CPU engines transcode too: the first two of
# TRANSCODE_SECONDS, the encoders' state carried across one window (cut from
# all three to fit [multi_gpu]'s replays; the CPU encode costs ~15 s a window)
TRANSCODE_CPU_WINDOWS = 2
TRANSCODE_CHECK = 2  # lanes of each kind that the CPU engines transcode too: the first and last
ENCODE_CHECK_LANES = 512  # lanes of the 48000-sample kernel-vs-plain case from a random state


def rail_levels(rng, lanes: int, n: int) -> torch.Tensor:
    """Random int8 levels with rows pinned at 127 and -128: the charge
    reaches both rails, where ``level == charge == 127`` decides bits."""
    levels = rng.integers(-128, 128, (lanes, n)).astype(np.int8)
    levels[::7] = 127
    levels[3::7] = -128
    return torch.tensor(levels, device="cuda")


@phase
def phase_encode_kernel_vs_plain(tones: torch.Tensor, levels: torch.Tensor) -> int:
    """Kernel (c) against its plain version on the same CUDA tensors, bytes
    and state, max |error| 0: small ragged shapes from a random state with
    rows at the rails, two chained calls; every lane at 4096 samples and
    ENCODE_CHECK_LANES lanes at 48000 samples from a random state; and every
    lane at the main path's own shape (32768 x 48000 levels from a zero
    state) against the bytes the plain encoder made of the same levels. Then
    the round trip on the card: kernel (a) decodes kernel (c)'s bytes and
    the audio follows its source tone. Returns max |error|."""
    rng = np.random.default_rng(17)
    worst = 0
    for lanes, n in ((1, 8), (65, 264), (300, 776)):
        st = ref_st = random_state(rng, lanes)
        for call in range(2):
            x = rail_levels(rng, lanes, n)
            out, st = kc.dfpwm_encode_kernel(x, st)
            ref, ref_st = kc.dfpwm_encode_ref(x, ref_st)
            (ok_o, e_o), (ok_s, e_s) = same(out, ref), same(st, ref_st)
            worst = max(worst, e_o, e_s)
            check(ok_o and ok_s, f"dfpwm_encode kernel == plain at {lanes} x {n}, call {call}")
    say("kernel_vs_plain", kernel="dfpwm_encode", shapes="[[1,8],[65,264],[300,776]]",
        calls=2, out_equal=True, state_equal=True)
    for lanes, n in ((FULL_LANES, 4096), (ENCODE_CHECK_LANES, 48000)):
        x = levels[:lanes, :n].contiguous()
        st0 = random_state(rng, lanes)
        (out, st), ms = timed(lambda: kc.dfpwm_encode_kernel(x, st0))
        (ref, ref_st), plain_ms = timed(lambda: kc.dfpwm_encode_ref(x, st0))
        (ok_o, e_o), (ok_s, e_s) = same(out, ref), same(st, ref_st)
        worst = max(worst, e_o, e_s)
        say("kernel_vs_plain", kernel="dfpwm_encode", lanes=lanes, samples=n, out_equal=ok_o,
            state_equal=ok_s, ms=round(ms, 4), plain_ms=round(plain_ms, 2))
        check(ok_o and ok_s, f"dfpwm_encode kernel == plain at {lanes} x {n}")
    (out, st), ms = timed(lambda: kc.dfpwm_encode_kernel(levels, DfpwmState.zeros(FULL_LANES, "cuda")))
    ok, err = same(out, tones)
    worst = max(worst, err)
    say("kernel_vs_plain_main_shape", kernel="dfpwm_encode", lanes=FULL_LANES,
        samples=levels.shape[1], out_equal=ok, ms=round(ms, 4))
    check(ok, "dfpwm_encode kernel == plain at the main path's shape, every lane")
    corr = []
    for i in range(0, FULL_LANES, 4096):
        rows = out[i: i + 4096].contiguous()
        dec, _ = kc.dfpwm_decode_kernel(rows, DfpwmState.zeros(len(rows), "cuda"))
        corr.append(tone_correlation(dec, levels[i: i + 4096]))
    corr = torch.cat(corr)
    say("encode_round_trip", lanes=FULL_LANES, samples=levels.shape[1],
        corr_min=round(float(corr.min()), 4), corr_median=round(float(corr.median()), 4))
    check(bool(torch.isfinite(corr).all()) and float(corr.min()) > 0.8,
          "kernel (a) on kernel (c)'s bytes follows the source tone")
    return worst


def pcm16_tone_rows(rng, lanes: int, frames: int, rate: int, channels: int):
    """uint8[lanes, frames * channels * 2] host rows of interleaved
    little-endian PCM16: one tone a lane (110-1000 Hz, 30-90% of full scale),
    the second channel the same tone at 0.8 of the level, 0.5 rad ahead.
    Made on the card a block of lanes at a time. -> (rows, freq, amp)."""
    rows = np.empty((lanes, frames * channels * 2), np.uint8)
    freq = torch.tensor(rng.uniform(110, 1000, lanes), device="cuda")[:, None]
    amp = torch.tensor(rng.uniform(0.3, 0.9, lanes) * 32767, device="cuda")[:, None]
    t = torch.arange(frames, device="cuda", dtype=torch.float64) / rate
    for i in range(0, lanes, 1024):
        phase = 2 * np.pi * freq[i: i + 1024] * t
        chans = [amp[i: i + 1024] * torch.sin(phase)]
        if channels == 2:
            chans.append(0.8 * amp[i: i + 1024] * torch.sin(phase + 0.5))
        x = torch.trunc(torch.stack(chans, dim=-1)).to(torch.int16)  # [l, frames, C]
        rows[i: i + 1024] = x.reshape(x.shape[0], -1).cpu().numpy().view(np.uint8)
    return rows, freq, amp


def transcode_engines(device: str, mono_lanes: int, stereo_lanes: int):
    """The transcode's five engines: a mono and a per-channel windowed
    decode engine, and the encoders they feed (mono DFPWM; interleaved
    stereo DFPWM and stereo pcm16 from the same windows)."""
    return (BatchStreamEngine([LaneSpec("pcm16", 48000)] * mono_lanes, device=device,
                              windowed=True),
            BatchStreamEngine([LaneSpec("pcm16", 44100, 2)] * stereo_lanes, device=device,
                              mono=False, windowed=True),
            BatchEncodeEngine([EncodeSpec("dfpwm")] * mono_lanes, device=device),
            BatchEncodeEngine([EncodeSpec("dfpwm", 2)] * stereo_lanes, device=device),
            BatchEncodeEngine([EncodeSpec("pcm16", 2)] * stereo_lanes, device=device))


def transcode_step(engines):
    """One window of every lane through the five engines -> the three
    encoders' results, or None when the decoders are done."""
    dec_m, dec_s, enc_m, enc_s, enc_p = engines
    if dec_m.done and dec_s.done:
        return None
    wm, mask_m, _ = dec_m.step()
    ws, mask_s, _ = dec_s.step()
    # the three encoders are independent: side by side on streams
    return tuple(encode_windows_many([(enc_m, wm, mask_m), (enc_s, ws, mask_s),
                                      (enc_p, ws, mask_s)]))


def run_transcode(device: str, mono_rows, stereo_rows, pick_m, pick_s, windows=None):
    """Bulk-feed and run the transcode on ``device``, all of it or its first
    ``windows`` windows. -> (every step's (bytes, nbytes, mask, positions)
    of the picked lanes of each encoder, the first step's full DFPWM
    outputs, the engines)."""
    engines = transcode_engines(device, len(mono_rows), len(stereo_rows))
    engines[0].feed_array(mono_rows)
    engines[1].feed_array(stereo_rows)
    picks = (pick_m, pick_s, pick_s)
    picks_dev = [torch.tensor(p, device=device) for p in picks]
    steps, first = [], None
    while len(steps) != windows and (r := transcode_step(engines)) is not None:
        if first is None:
            first = (r[0][0], r[1][0])
        steps.append([(out[pd].cpu().numpy(), nbytes[p], mask[p], pos[p])
                      for (out, nbytes, mask, pos), p, pd in zip(r, picks, picks_dev)])
    return steps, first, engines


@phase
def phase_transcode() -> dict:
    """The write path at full width, through the engines' entry points:
    16384 mono PCM16 lanes at 48 kHz and 8192 stereo PCM16 lanes at 44.1 kHz,
    TRANSCODE_SECONDS each, bulk-fed from host memory, decoded to one-second
    windows (``mono=True`` and ``mono=False``) and encoded device-to-device
    into mono DFPWM, interleaved stereo DFPWM and stereo pcm16. Launch counts
    are zeroed just before and read just after. Then: TRANSCODE_CHECK lanes
    of each kind against the same engines on the CPU over the first
    TRANSCODE_CPU_WINDOWS windows, bit for bit; the
    first window's DFPWM bytes decoded by kernel (a) against the source
    tones; the pcm16 bytes' layout. Returns the launch counts."""
    rng = np.random.default_rng(18)
    t0 = time.perf_counter()
    mono_rows, freq_m, amp_m = pcm16_tone_rows(rng, TRANSCODE_MONO, TRANSCODE_SECONDS * 48000,
                                               48000, 1)
    stereo_rows, freq_s, amp_s = pcm16_tone_rows(rng, TRANSCODE_STEREO, TRANSCODE_SECONDS * 44100,
                                                 44100, 2)
    say("transcode_bytes", mono_lanes=TRANSCODE_MONO, stereo_lanes=TRANSCODE_STEREO,
        seconds_per_lane=TRANSCODE_SECONDS, bytes=mono_rows.nbytes + stereo_rows.nbytes,
        build_seconds=round(time.perf_counter() - t0, 3))
    pick_m = np.linspace(0, TRANSCODE_MONO - 1, TRANSCODE_CHECK).astype(np.int64)
    pick_s = np.linspace(0, TRANSCODE_STEREO - 1, TRANSCODE_CHECK).astype(np.int64)
    torch.cuda.empty_cache()
    kernels.reset_counts()
    t0 = sync_time()
    steps, first, engines = run_transcode("cuda", mono_rows, stereo_rows, pick_m, pick_s)
    dt = sync_time() - t0
    launches = {"dfpwm_encode": kc.dfpwm_encode_kernel.launches, "fma": kf.fma_kernel.launches}
    plain = {fn.__name__: fn.calls for fn in kernels.PLAIN}
    audio = sum(e.metrics.samples_decoded for e in engines[2:4]) / 48000
    say("main_path", case="transcode", mono_lanes=TRANSCODE_MONO, stereo_lanes=TRANSCODE_STEREO,
        seconds_per_lane=TRANSCODE_SECONDS, windows=len(steps), seconds=round(dt, 4),
        audio_seconds=round(audio, 1), realtime_factor=round(audio / dt, 1),
        launches=json.dumps(launches), plain_calls=sum(plain.values()))
    check(len(steps) == TRANSCODE_SECONDS, f"one window a second ({len(steps)})")
    check(launches["dfpwm_encode"] == 2 * len(steps) and launches["fma"] > 0,
          f"kernel (c) launched once per DFPWM group per window ({launches})")
    check(all(n == 0 for n in plain.values()), f"no plain version on the CUDA path ({plain})")
    check(audio == (TRANSCODE_MONO + TRANSCODE_STEREO) * TRANSCODE_SECONDS,
          "every lane transcoded its seconds")
    for out, nbytes, mask, pos in steps[-1]:
        check(bool(mask.all()) and float(pos.min()) == TRANSCODE_SECONDS - 1.0, "masks, positions")
    check(tuple(first[0].shape) == (TRANSCODE_MONO, 6000) and first[0].dtype == torch.uint8
          and tuple(first[1].shape) == (TRANSCODE_STEREO, 12000), "DFPWM output shapes")
    check(steps[0][2][0].shape == (TRANSCODE_CHECK, 192000)
          and steps[0][2][1].tolist() == [192000] * TRANSCODE_CHECK, "pcm16 output shape")
    del engines
    torch.cuda.empty_cache()

    # the picked lanes on the CPU: the plain versions, bit for bit
    t0 = time.perf_counter()
    want, _, _ = run_transcode("cpu", mono_rows[pick_m], stereo_rows[pick_s],
                               np.arange(TRANSCODE_CHECK), np.arange(TRANSCODE_CHECK),
                               TRANSCODE_CPU_WINDOWS)
    check(len(want) == TRANSCODE_CPU_WINDOWS, "the CPU engines take their windows")
    for got_step, want_step in zip(steps, want):
        for got, ref in zip(got_step, want_step):
            check(all(np.array_equal(a, b) for a, b in zip(got, ref, strict=True)),
                  "transcode on the card == the CPU engines, picked lanes")
    # what came out follows its source: kernel (a) on the first window's bytes
    dec_m, _ = kc.dfpwm_decode_kernel(first[0], DfpwmState.zeros(TRANSCODE_MONO, "cuda"))
    dec_s, _ = kc.dfpwm_decode_kernel(first[1], DfpwmState.zeros(TRANSCODE_STEREO, "cuda"))
    dec_s = dec_s[:, 0::2]  # the left channel of the interleaved frames
    corr_m, corr_s = (torch.cat([window_tone_correlation(dec[i: i + 2048], freq[i: i + 2048],
                                                         amp[i: i + 2048], start=0)
                                 for i in range(0, dec.shape[0], 2048)])
                      for dec, freq, amp in ((dec_m, freq_m, amp_m), (dec_s, freq_s, amp_s)))
    # the pcm16 body of a picked stereo lane: frames of (left, right) at 48 kHz
    frames = np.frombuffer(steps[1][2][0][0].tobytes(), "<i2").reshape(-1, 2).astype(np.float64)
    pcm_corr = float(np.corrcoef(frames[:, 0], np.sin(
        2 * np.pi * float(freq_s[pick_s[0]]) * (48000 + np.arange(48000)) / 48000))[0, 1])
    say("transcode_output", lanes_equal_cpu=2 * TRANSCODE_CHECK, compared_windows=len(want),
        cpu_seconds=round(time.perf_counter() - t0, 3),
        mono_corr_min=round(float(corr_m.min()), 4), mono_corr_median=round(float(corr_m.median()), 4),
        stereo_corr_min=round(float(corr_s.min()), 4),
        stereo_corr_median=round(float(corr_s.median()), 4), pcm16_corr=round(pcm_corr, 4))
    check(bool(torch.isfinite(corr_m).all()) and float(corr_m.min()) > 0.8,
          "mono DFPWM output follows its source tone")
    check(bool(torch.isfinite(corr_s).all()) and float(corr_s.min()) > 0.8,
          "stereo DFPWM output's left channel follows its source tone")
    check(pcm_corr > 0.99, "pcm16 output's left channel is its source tone")
    del dec_m, dec_s, first
    torch.cuda.empty_cache()
    phase_transcode_breakdown(mono_rows, stereo_rows)
    return launches


@phase
def phase_transcode_breakdown(mono_rows, stereo_rows) -> None:
    """Where the time of one transcode window goes: fresh engines over the
    same bytes step once (allocations), then one window under torch.profiler:
    its wall time, the host time of the decoders' staging (the column view
    and its copy to the card, timed by wrapping ``_to_device``), the device
    time of kernel (c), of the FMA kernel, of the host->device copies and of
    the other torch ops (PCM decode, resample, lookup, interleave, pack), and
    the device's busy share of the wall time."""
    from aukit_tpu_torch.stream import batch as engine_module

    engines = transcode_engines("cuda", len(mono_rows), len(stereo_rows))
    engines[0].feed_array(mono_rows)
    engines[1].feed_array(stereo_rows)
    staged = [0.0]
    to_device = engine_module._to_device

    def timed_to_device(x, device):
        t0 = time.perf_counter()
        r = to_device(x, device)
        if isinstance(x, np.ndarray):
            torch.cuda.synchronize()
            staged[0] += time.perf_counter() - t0
        return r

    engine_module._to_device = timed_to_device
    try:
        t0 = sync_time()
        transcode_step(engines)
        first_ms = (sync_time() - t0) * 1e3
        staged[0] = 0.0
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = sync_time()
            transcode_step(engines)
            wall = (sync_time() - t0) * 1e3
    finally:
        engine_module._to_device = to_device
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {"dfpwm_encode": "dfpwm_encode_kernel", "fma": "fma_kernel", "htod": "Memcpy HtoD"}
    spans = {k: [(e.time_range.start, e.time_range.end) for e in dev if v in e.name]
             for k, v in names.items()}
    spans["other"] = [(e.time_range.start, e.time_range.end) for e in dev
                      if not any(v in e.name for v in names.values())]
    everything = [iv for ivs in spans.values() for iv in ivs]
    kernels_only = [iv for k, ivs in spans.items() if k != "htod" for iv in ivs]
    # kernel (c)'s two launches: each one's own time, and from the first's
    # start to the last's end (less than their sum where the streams overlap them)
    enc = sorted(spans["dfpwm_encode"])
    check(len(enc) == 2, f"kernel (c) launched twice in the window ({len(enc)})")
    say("step_breakdown", case="transcode", lanes=len(mono_rows) + len(stereo_rows),
        first_step_ms=round(first_ms, 3), profiled_window_ms=round(wall, 3),
        staging_host_ms=round(staged[0] * 1e3, 3),
        dfpwm_encode_each_ms=json.dumps([round((b - a) / 1e3, 3) for a, b in enc]),
        dfpwm_encode_span_ms=round((enc[-1][1] - enc[0][0]) / 1e3, 3),
        **{f"{k}_ms": round(busy_ms(v), 3) for k, v in spans.items()},
        device_events=len(dev), busy_kernels=round(busy_ms(kernels_only) / wall, 4),
        busy_with_copies=round(busy_ms(everything) / wall, 4))
    del engines
    torch.cuda.empty_cache()


def encode_fleet_run(device: str, specs, sigs, wins):
    """A small encode fleet on ``device``: host-fed floats in jittery chunks
    (a feed-time gain on one lane), stepped to the end; then two window
    batches with a volume ramp on two lanes and one lane masked in the
    first. -> (every step's results, every lane's checkpoint)."""
    enc = BatchEncodeEngine(specs, chunk_samples=400, device=device)
    enc.set_volume(3, 0.6)
    for i, s in enumerate(sigs):
        for off in range(0, s.shape[1], 170):
            enc.feed(i, s[:, off: off + 170])
        enc.feed(i, None)
    steps = []
    while (r := enc.step()) is not None:
        steps.append((r[0].cpu().numpy(), *r[1:]))
    enc.set_volume(0, 0.4, ramp=True)
    enc.set_volume(4, 1.8, ramp=True)
    for k, w in enumerate(wins):
        mask = np.ones(len(specs), bool)
        mask[1] = k == 1
        r = enc.encode_windows(torch.tensor(w, device=device), mask)
        steps.append((r[0].cpu().numpy(), *r[1:]))
    return steps, [enc.checkpoint(i) for i in range(len(specs))]


@phase
def phase_encode_engines() -> None:
    """The CUDA encode engine against the CPU engine: every encode codec,
    mono and stereo, 16 lanes each: bytes, nbytes, masks, positions and
    checkpoints equal."""
    rng = np.random.default_rng(19)
    for channels in (1, 2):
        specs = [EncodeSpec(c, channels) for c in ENCODE_CODECS for _ in range(16)]
        sigs = [rng.uniform(-1.1, 1.1, (channels, 400 * (1 + i % 3) + 24 * (i % 5)))
                for i in range(len(specs))]
        wins = [rng.integers(-128, 128, (len(specs), channels, 1600)).astype(np.int8)
                for _ in range(2)]
        launches = kc.dfpwm_encode_kernel.launches
        (got, ck_got), (want, ck_want) = (encode_fleet_run(d, specs, sigs, wins)
                                          for d in ("cuda", "cpu"))
        check(kc.dfpwm_encode_kernel.launches > launches, "kernel (c) ran for the CUDA engine")
        check(len(got) == len(want) and all(
            np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w, strict=True)),
            f"encode fleet ({channels} ch): CUDA engine == CPU engine")
        check(deep_equal(ck_got, ck_want), f"encode fleet ({channels} ch): checkpoints equal")
        say("encode_engine_cuda_vs_cpu", channels=channels, lanes=len(specs), steps=len(got),
            codecs=json.dumps(ENCODE_CODECS), equal=True)


@phase
def phase_flac_transcode(fx) -> None:
    """FLAC -> WAV16 through ``transcode_fleet``: eight ragged FLAC lanes of
    four geometries on the device-resident route (kernels (g), (h) upstream
    of the PCM pack) against the same fleet and encoder on the CPU, bit for
    bit; each body wraps into a WAV file."""
    streams = flac_check_streams(fx, 8)
    counts = (kg.lpc_restore_kernel.launches, kh.iir_zero_kernel.launches)
    outs = []
    for device in ("cuda", "cpu"):
        fleet = FlacFleet(len(streams), device_restore=True, device_dsp=True, device=device)
        fleet.feed_many(streams)
        fleet.feed_many([None] * len(streams))
        outs.append(transcode_fleet(fleet, BatchEncodeEngine([EncodeSpec("pcm16")] * len(streams),
                                                             device=device)))
    check(kg.lpc_restore_kernel.launches > counts[0] and kh.iir_zero_kernel.launches > counts[1],
          "kernels (g) and (h) ran upstream of the pack")
    check(outs[0] == outs[1], "FLAC -> WAV16 on the card == on the CPU")
    check(all(len(b) >= 96000 and len(b) % 96000 == 0 and np.frombuffer(b, "<i2").any()
              for b in outs[0]), "every lane has whole one-second pcm16 windows of audio")
    wav = pcm_wav_header(1, 48000, 16, len(outs[0][0])) + outs[0][0]
    check(wav[:4] == b"RIFF" and len(wav) == 44 + len(outs[0][0]), "the body wraps into a WAV file")
    say("flac_transcode", lanes=len(streams), bytes=sum(map(len, outs[0])), equal_cpu=True)


@phase
def phase_encode_time(plain_ms: float) -> dict:
    """Kernel (c) alone at 32768 x 48000 levels (one second of every lane of
    the headline fleet), by CUDA events; ``plain_ms`` is its plain version's
    time on the card at the same shape. Then at the two shapes a transcode
    window launches it on."""
    lanes, n = FULL_LANES, 48000
    x = torch.randint(-128, 128, (lanes, n), dtype=torch.int8, device="cuda")
    st = [DfpwmState.zeros(lanes, "cuda")]

    def encode():
        _, st[0] = kc.dfpwm_encode_kernel(x, st[0])

    encode()
    ms = min(event_ms(encode, 5), event_ms(encode, 5))
    say("time", kernel="dfpwm_encode", lanes=lanes, samples=n, ms=round(ms, 4),
        plain_ms=round(plain_ms, 2), gsamples_per_s=round(lanes * n / ms / 1e6, 2),
        realtime_factor=round(lanes * n / (ms / 1e3) / 48000, 1))
    # eight int8 levels in, a byte out
    row = timing("dfpwm_encode", ms, plain_ms, lanes * n * OPS_PER_SAMPLE["dfpwm_encode"],
                 lanes * n * 9 / 8)
    del x, st
    torch.cuda.empty_cache()
    # a transcode window's two launches: the mono group's rows of one second,
    # the stereo group's interleaved rows of twice the length
    for label, lanes, n in (("mono", TRANSCODE_MONO, 48000), ("stereo", TRANSCODE_STEREO, 96000)):
        x = torch.randint(-128, 128, (lanes, n), dtype=torch.int8, device="cuda")
        st0 = DfpwmState.zeros(lanes, "cuda")
        kc.dfpwm_encode_kernel(x, st0)
        ms = min(event_ms(lambda: kc.dfpwm_encode_kernel(x, st0), 5) for _ in range(2))
        say("time", kernel=f"dfpwm_encode_window_{label}", lanes=lanes, samples=n, ms=round(ms, 4),
            gsamples_per_s=round(lanes * n / ms / 1e6, 2))
        timing(f"dfpwm_encode_window_{label}", ms, float("nan"),
               lanes * n * OPS_PER_SAMPLE["dfpwm_encode"], lanes * n * 9 / 8)
        del x
    return {"dfpwm_encode": row}


# -- the engine's DSP stages (the batched auplay chain) and the Fleet facade ----------

AUPLAY_LANES = 16384  # bench.py:510-541's config 6b (4096 lanes on its TPU run) at 4x
AUPLAY_SECONDS = 3
ENGINE_DSP_PER_SPEC = 8  # lanes of each of the six specs CUDA and CPU both decode
FLEET_STATIONS = 3072  # bench.py:600-640's station mix (48 on its TPU run) at 64x
FLEET_SECONDS = 10
CLI_FLEET_SECONDS = 3  # the --fleet programs' files (cut from 10 s to fit [multi_gpu]'s replays)
FLEET_CHECK_STATIONS = 48


def dsp_counts() -> dict:
    return {"dfpwm_decode": kc.dfpwm_decode_kernel.launches,
            "dfpwm_decode_dsp": kc.dfpwm_decode_dsp_kernel.launches,
            "dfpwm_encode": kc.dfpwm_encode_kernel.launches,
            "ima_decode": ka.ima_decode_kernel.launches,
            "msadpcm_decode": ka.msadpcm_decode_kernel.launches,
            "qoa_lms": kq.qoa_lms_kernel.launches, "lpc_restore": kg.lpc_restore_kernel.launches,
            "iir_zero": kh.iir_zero_kernel.launches, "fma": kf.fma_kernel.launches,
            "flac_dsp_f64": kd.flac_dsp_kernel.launches}


def plain_calls() -> int:
    return sum(fn.calls for fn in kernels.PLAIN)


def steps_equal(a, b) -> bool:
    """Two runs' [(windows, mask, positions)] lists are equal."""
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2])
        for x, y in zip(a, b))


@phase
def phase_engine_dsp() -> None:
    """The auplay chain on a mono=False engine at a small width, CUDA against
    CPU (tests/torch_kernel_cases.py's ``engine_dsp_fleet``: DFPWM at 48 and
    32 kHz, IMA and MS ADPCM at 22.05 kHz, stereo QOA at 44.1 kHz with the
    mono toggle on half its lanes, PCM16; lowpass and highpass lanes,
    normalize(0.8), a lowpass reconfigured mid-stream, a filtered lane
    checkpointed and restored): windows, masks, positions and checkpoints
    (carried filter y/x included) bit-equal. Kernels (a), (d), (e), (f) and
    the FMA launch on the CUDA run, the fused (b) does not (its groups carry
    stages), and no plain version is called there."""
    cases = load_test_module("torch_kernel_cases")
    specs, feeds = cases.engine_dsp_fleet(np.random.default_rng(31), ENGINE_DSP_PER_SPEC, 1.5)
    runs = []
    for dev in ("cuda", "cpu"):
        kernels.reset_counts()
        eng = BatchStreamEngine([LaneSpec(*s) for s in specs], device=dev, mono=False)
        runs.append(cases.drive_engine_dsp(eng, specs, feeds))
        if dev == "cuda":
            counts, plain = dsp_counts(), plain_calls()
    (steps_c, cks_c), (steps_p, cks_p) = runs
    check(steps_equal(steps_c, steps_p), "engine_dsp: CUDA windows/masks/positions == CPU")
    check(deep_equal(cks_c, cks_p), "engine_dsp: CUDA checkpoints (filter carries too) == CPU")
    ran = ("dfpwm_decode", "ima_decode", "msadpcm_decode", "qoa_lms", "fma")
    say("engine_dsp", lanes=len(specs), windows=len(steps_c), equal=True,
        launches=json.dumps(counts), plain_calls=plain)
    check(all(counts[k] > 0 for k in ran) and counts["dfpwm_decode_dsp"] == 0,
          f"engine_dsp: kernels (a), (d), (e), (f), FMA ran and (b) did not ({counts})")
    check(plain == 0, "engine_dsp: no plain version on the CUDA path")


def auplay_bytes() -> np.ndarray:
    """bench.py:514-515's feed at AUPLAY_LANES: uniform int16 noise in
    +-8192, 3 s a lane (64 distinct rows repeated), as uint8[L, 288000]."""
    rng = np.random.default_rng(41)
    rows = rng.integers(-(1 << 13), 1 << 13, (64, 48000 * AUPLAY_SECONDS)).astype("<i2")
    return np.ascontiguousarray(rows.view(np.uint8)[np.arange(AUPLAY_LANES) % 64])


def auplay_engine(feed, device="cuda"):
    """bench.py:518-521: a windowed pcm16 engine, lowpass(12 kHz) on every lane."""
    lanes = feed.shape[0]
    eng = BatchStreamEngine([LaneSpec("pcm16", 48000)] * lanes, windowed=True, device=device)
    for lane in range(lanes):
        eng.set_filter(lane, "lowpass", 12000)
    eng.feed_array(feed)
    return eng


def run_auplay(feed):
    """normalize(0.8) (its measuring pass) and every step, timed together
    -> (seconds, windows, first window, peak device bytes)."""
    eng = auplay_engine(feed)
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_time()
    eng.normalize(0.8)
    first, windows = None, 0
    while (r := eng.step()) is not None:
        check(tuple(r[0].shape) == (AUPLAY_LANES, 48000) and bool(r[1].all()),
              "auplay window shape and mask")
        first = r[0] if first is None else first
        windows += 1
    return sync_time() - t0, windows, first, torch.cuda.max_memory_allocated()


def auplay_fma_vs_plain(host: np.ndarray) -> float:
    """The FMA kernel at the auplay step's own shapes, against ``fma_ref``:
    on a device-fed engine's second step (filter carries warm), the per-lane
    [L] launch of the filter's first sample in ``_stages`` is held to
    ``fma_ref`` on the same operands, and the step's (A, B) are scanned
    again by ``linear_scan`` twice, once through the kernel (29 launches on
    stride-2 views from [L, 24000] down) and once with ``fma_ref`` in its
    place. Both bit-equal; returns the largest difference (0)."""
    eng = auplay_engine(torch.tensor(host, device="cuda"))
    eng.normalize(0.8)
    eng.step()
    caught, errs = [], []

    def fma_checked(x, y, z):
        out = kf.fma_kernel(x, y, z)
        ref = kf.fma_ref(x, y, z)
        errs.append(0.0 if torch.equal(out, ref) else float((out - ref).abs().max()))
        return out

    def scan_caught(A, B):
        caught.append((A, B))
        return oscan.linear_scan(A, B)

    patched = (sb.fma_kernel, sb.linear_scan)
    sb.fma_kernel, sb.linear_scan = fma_checked, scan_caught
    try:
        eng.step()
    finally:
        sb.fma_kernel, sb.linear_scan = patched
    del eng
    check(len(caught) == 1 and len(errs) == 1, "auplay step: one scan, one first-sample FMA")
    A, B = caught[0]
    check(tuple(B.shape) == (AUPLAY_LANES, 48000) and A.stride(-1) == 0,
          "auplay scan operands: B [L, 48000], A broadcast over the samples")
    launches = kf.fma_kernel.launches
    y = oscan.linear_scan(A, B)
    levels = kf.fma_kernel.launches - launches
    oscan.fma_kernel = kf.fma_ref
    try:
        y_ref = oscan.linear_scan(A, B)
    finally:
        oscan.fma_kernel = kf.fma_kernel
    scan_err = 0.0 if torch.equal(y, y_ref) else float((y - y_ref).abs().max())
    say("kernel_vs_plain_main_shape", kernel="fma", case="auplay_scan", lanes=B.shape[0],
        samples=B.shape[1], scan_launches=levels, scan_equal=scan_err == 0,
        first_sample_lanes=B.shape[0], first_sample_equal=errs[0] == 0)
    n, expected = B.shape[-1], 0
    while n >= 2:  # a level's pair combine, and its even combine unless empty
        expected, n = expected + 1 + (n >= 3), n // 2
    check(scan_err == 0 and levels == expected, "linear_scan through the FMA kernel == through "
          f"fma_ref at the auplay step's [16384, 48000] ({levels} of {expected} launches)")
    check(errs[0] == 0, "the auplay step's first-sample FMA [L] == fma_ref")
    del A, B, y, y_ref, caught
    torch.cuda.empty_cache()
    return max(scan_err, errs[0])


@phase
def phase_auplay_main_path() -> tuple[dict, float]:
    """bench.py:510-541's config 6b at AUPLAY_LANES pcm16 lanes, 48 kHz, 3 s a
    lane, lowpass(12 kHz) on every lane, normalize(0.8) with its measuring
    pass inside the timed window, one-second windows: fed from host memory
    (4.7 GB of numpy bytes), then the same bytes as a CUDA tensor. Then
    16384 DFPWM lanes at 48 kHz with a lowpass, device-fed: the identity
    rate with a stage set, kernel (a) instead of the fused (b). Launch
    counts are zeroed before each run and read after; the first window of 8
    lanes of each is held against the CPU engine."""
    host = auplay_bytes()
    out = {}
    for fed in ("host", "device"):
        feed = host if fed == "host" else torch.tensor(host, device="cuda")
        kernels.reset_counts()
        dt, windows, first, peak = run_auplay(feed)
        counts, plain = dsp_counts(), plain_calls()
        check(windows == AUPLAY_SECONDS and counts["fma"] > 0 and plain == 0,
              f"auplay {fed}-fed: 3 windows, FMA launched, no plain version ({counts})")
        say("main_path", case="auplay", fed=fed, lanes=AUPLAY_LANES,
            seconds_per_lane=AUPLAY_SECONDS, windows=windows, seconds=round(dt, 4),
            realtime_factor=round(AUPLAY_LANES * AUPLAY_SECONDS / dt, 1),
            max_memory_allocated_gb=round(peak / 1e9, 3), launches=json.dumps(counts))
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
        del feed
        torch.cuda.empty_cache()
    cpu = auplay_engine(host[:8], device="cpu")
    cpu.normalize(0.8)
    check(torch.equal(first[:8].cpu(), cpu.step()[0]), "auplay first window == CPU engine, 8 lanes")
    check(bool(first.abs().amax(dim=1).min() > 40), "auplay windows carry normalized audio")
    del first
    torch.cuda.empty_cache()
    fma_err = auplay_fma_vs_plain(host)
    del host

    # the identity-rate DFPWM path with a stage set
    rng = np.random.default_rng(42)
    dbytes = rng.integers(0, 256, (AUPLAY_LANES, 6000 * AUPLAY_SECONDS), dtype=np.uint8)
    dev = torch.tensor(dbytes, device="cuda")
    kernels.reset_counts()
    eng = BatchDfpwmDecoder(AUPLAY_LANES, 48000, chunk_bytes=6000, device="cuda")
    for lane in range(AUPLAY_LANES):
        eng.set_filter(lane, "lowpass", 12000)
    eng.feed_array(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_time()
    first, steps = None, 0
    while (r := eng.step()) is not None:
        first = r[0] if first is None else first
        steps += 1
    dt = sync_time() - t0
    counts, plain = dsp_counts(), plain_calls()
    say("main_path", case="dfpwm_lowpass_48k", fed="device", lanes=AUPLAY_LANES, steps=steps,
        seconds=round(dt, 4), realtime_factor=round(AUPLAY_LANES * steps / dt, 1),
        max_memory_allocated_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
        launches=json.dumps(counts))
    check(steps == AUPLAY_SECONDS and counts["dfpwm_decode"] == steps and counts["fma"] > 0
          and counts["dfpwm_decode_dsp"] == 0 and plain == 0,
          f"dfpwm lowpass: kernel (a) each step, FMA, not (b), no plain version ({counts})")
    for k, v in counts.items():
        out[k] = out.get(k, 0) + v
    cpu = BatchDfpwmDecoder(8, 48000, chunk_bytes=6000, device="cpu")
    for lane in range(8):
        cpu.set_filter(lane, "lowpass", 12000)
    cpu.feed_array(dbytes[:8, :6000])
    check(torch.equal(first[:8].cpu(), cpu.step()[0]), "dfpwm lowpass first window == CPU, 8 lanes")
    del eng, dev, first
    torch.cuda.empty_cache()
    return out, fma_err


def event_wrap(fn, spans: list):
    """``fn`` with CUDA events recorded around each call into ``spans``."""
    def wrapped(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        r = fn(*a, **k)
        end.record()
        spans.append((start, end))
        return r
    return wrapped


def events_ms(spans) -> float:
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans)


@phase
def phase_auplay_step_breakdown() -> None:
    """Where one full-width auplay step goes (normalize done before): the
    step fed from host memory and from the card; on one device-fed step, by
    CUDA events, the device time of the filter scan (``linear_scan``), of
    the FMA launches inside it, and of ``dsp_chain`` (resample-free FIR
    through the FMA kernel, int8 quantize); and under torch.profiler over
    two host-fed steps, the host staging (``_to_device``: the fed column
    view's contiguous host copy and its pageable copy to the card), the device
    time of the FMA kernel, of the host->device copies and of the other
    torch ops, and the device's busy share of the wall time."""
    host = auplay_bytes()

    def engine(feed):
        eng = auplay_engine(feed)
        eng.normalize(0.8)
        return eng

    def step_ms(eng) -> float:
        t0 = sync_time()
        eng.step()
        return (sync_time() - t0) * 1e3

    dev_eng = engine(torch.tensor(host, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    dev_step = step_ms(dev_eng)
    peak = torch.cuda.max_memory_allocated()
    spans = {"scan": [], "scan_fma": [], "dsp_chain": []}
    patched = (sb.linear_scan, oscan.fma_kernel, sb.dsp_chain)
    sb.linear_scan = event_wrap(sb.linear_scan, spans["scan"])
    oscan.fma_kernel = event_wrap(oscan.fma_kernel, spans["scan_fma"])
    sb.dsp_chain = event_wrap(sb.dsp_chain, spans["dsp_chain"])
    try:
        t0 = sync_time()
        dev_eng.step()
        instrumented = (sync_time() - t0) * 1e3
    finally:
        sb.linear_scan, oscan.fma_kernel, sb.dsp_chain = patched
    parts = {k: events_ms(v) for k, v in spans.items()}
    del dev_eng
    torch.cuda.empty_cache()

    host_eng = engine(host)
    host_step = step_ms(host_eng)
    stage, to_device = [], sb._to_device

    def timed_to_device(x, device):
        t0 = time.perf_counter()
        r = to_device(x, device)
        stage.append(time.perf_counter() - t0)
        return r

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sb._to_device = timed_to_device
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = sync_time()
            host_eng.step()
            host_eng.step()
            wall = (sync_time() - t0) * 1e3
    finally:
        sb._to_device = to_device
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {"fma": "fma_kernel", "htod": "Memcpy HtoD"}
    prof_spans = {k: [(e.time_range.start, e.time_range.end) for e in dev if v in e.name]
                  for k, v in names.items()}
    prof_spans["other"] = [(e.time_range.start, e.time_range.end) for e in dev
                           if not any(v in e.name for v in names.values())]
    check(prof_spans["fma"], "the auplay step's profile shows the FMA kernel")
    everything = [iv for ivs in prof_spans.values() for iv in ivs]
    kernels_only = [iv for k, ivs in prof_spans.items() if k != "htod" for iv in ivs]
    say("step_breakdown", case="auplay", lanes=AUPLAY_LANES,
        host_fed_step_ms=round(host_step, 3), device_fed_step_ms=round(dev_step, 3),
        device_fed_step_max_memory_allocated_gb=round(peak / 1e9, 3),
        instrumented_step_ms=round(instrumented, 3), scan_ms=round(parts["scan"], 3),
        scan_fma_ms=round(parts["scan_fma"], 3), scan_fma_launches=len(spans["scan_fma"]),
        scan_other_ms=round(parts["scan"] - parts["scan_fma"], 3),
        dsp_chain_ms=round(parts["dsp_chain"], 3),
        host_staging_ms_per_step=round(sum(stage) / 2 * 1e3, 3), profiled_steps=2,
        profiled_wall_ms=round(wall, 3), device_events=len(dev),
        **{f"{k}_ms_per_step": round(busy_ms(v) / 2, 3) for k, v in prof_spans.items()},
        busy_kernels=round(busy_ms(kernels_only) / wall, 4),
        busy_with_copies=round(busy_ms(everything) / wall, 4))
    del host_eng, host
    torch.cuda.empty_cache()


def ima_wav(rng, seconds: int, rate: int = 16000, ba: int = 256) -> bytes:
    """bench.py:606-618's IMA-in-WAV station: random nibbles, predictor 0
    and a valid step index in every block header."""
    spb = (ba - 4) * 2
    kblk = -(-seconds * rate // spb)
    payload = rng.integers(0, 256, kblk * ba, dtype=np.uint8)
    payload[::ba] = 0
    payload[1::ba] = 0
    payload[2::ba] = rng.integers(0, 89, kblk)
    pay = payload.tobytes()
    fmt = struct.pack("<HHIIHHHH", 0x11, 1, rate, rate * ba // spb, ba, 4, 2, spb)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(pay)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
            + struct.pack("<I", len(pay)) + pay)


def fleet_flac_stream(fx, rng, seconds: int) -> bytes:
    """bench.py:620-621's FLAC station: 48 kHz mono, block 4096, config 7's
    LPC-8 frame (bench_subframe), ``seconds`` long."""
    frame = fx.flac_frame([bench_subframe(rng, FLAC_N)], FLAC_N, 0, 16)
    nfr = seconds * 48000 // FLAC_N
    return fx.flac_stream_header(48000, 1, 16, nfr * FLAC_N) + frame * nfr


def fleet_check_sources(fx, rng) -> list:
    """FLEET_CHECK_STATIONS stations of six kinds in turn, ~2 s each: FLAC
    (numbered LPC-8 frames, so a seek lands mid-stream), raw DFPWM,
    IMA-in-WAV, stereo QOA, MDFPWM, PCM16-in-WAV (22.05 kHz)."""
    t = np.arange(2 * 22050)
    nfr = 2 * 48000 // FLAC_N
    flac = fx.flac_stream_header(48000, 1, 16, nfr * FLAC_N) + b"".join(
        fx.flac_frame([bench_subframe(rng, FLAC_N)], FLAC_N, 0, 16, frame_number=k)
        for k in range(nfr))
    out = []
    for i in range(FLEET_CHECK_STATIONS):
        kind = i % 6
        if kind == 0:
            out.append(flac)
        elif kind == 1:
            out.append((LaneSpec("dfpwm", 48000), rng.integers(0, 256, 12000, np.uint8).tobytes()))
        elif kind == 2:
            out.append(ima_wav(rng, 2))
        elif kind == 3:
            out.append(fx.qoa_stream(rng, 2, 44100, [5120] * 17))
        elif kind == 4:
            body = rng.integers(0, 256, (2, 12000 + 700), np.uint8)
            out.append(fx.mdfpwm_file(body[0].tobytes(), body[1].tobytes(), 2 * (12000 + 700)))
        else:
            sig = (np.sin(t / (3.0 + i)) * 12000 + rng.normal(0, 500, len(t))).astype(np.int16)
            out.append(fx.wav_pcm(sig[None], 22050, 16))
    return out


def drive_fleet_check(fleet) -> tuple[list, list, list]:
    """The [fleet] scenario: per-station filters and mono toggles, one window,
    seeks on a DFPWM, an MDFPWM, a FLAC, a WAV and a QOA station, a
    reset_station of an IMA station mid-play, a window, a checkpoint ->
    restore of a filtered DFPWM station and of a FLAC station, then to the
    end -> (steps, seek landings, the final checkpoint of every station)."""
    for i, st in enumerate(fleet.stations):
        if st.kind == "flac":
            continue
        if i % 4 == 1:
            fleet.set_filter(i, "lowpass", 6000)
        elif i % 4 == 2:
            fleet.set_filter(i, "highpass", 150)
        if i % 6 == 3 and i % 12 == 3:
            fleet.set_mono(i, True)
    steps = []

    def step():
        r = fleet.step()
        if r is not None:
            steps.append((r[0].cpu().numpy(), r[1].copy(), r[2].copy()))

    step()
    landings = [fleet.seek(i, s) for i, s in ((1, 0.5), (4, 0.75), (0, 1.0), (5, 0.5), (3, 0.5))]
    fleet.reset_station(2)  # replay the IMA station's retained source, mid-play
    step()
    for i in (13, 6):  # a lowpass DFPWM station (48 kHz: a window boundary), a FLAC one
        fleet.restore(i, fleet.checkpoint(i))
    for _ in range(10_000):
        if fleet.done:
            break
        step()
    check(fleet.done, "the [fleet] scenario ends")
    return steps, landings, [fleet.checkpoint(i) for i in range(len(fleet.stations))]


@phase
def phase_fleet_check() -> dict:
    """The Fleet facade at FLEET_CHECK_STATIONS stations (mono=False, two
    channels; FLAC stations on the device route), CUDA against CPU: the
    ``drive_fleet_check`` scenario, then a FLAC-free fleet with
    normalize(0.8) and filters. Windows, masks, positions, seek landings and
    final checkpoints bit-equal; the launch counts of the CUDA runs are
    printed, and no plain version is called there."""
    fx = load_fixtures()
    sources = fleet_check_sources(fx, np.random.default_rng(51))
    engine_only = [s for i, s in enumerate(sources) if i % 6 in (1, 2, 3, 5)][:12]
    runs = []
    for dev in ("cuda", "cpu"):
        kernels.reset_counts()
        f = Fleet(sources, device=dev, mono=False, channels=2, device_restore=True,
                  device_dsp=True)
        res = drive_fleet_check(f)
        g = Fleet(engine_only, device=dev)
        for i in range(0, len(engine_only), 2):
            g.set_filter(i, "lowpass", 5000)
        g.normalize(0.8)
        res2 = []
        while (r := g.step()) is not None:
            res2.append((r[0].cpu().numpy(), r[1].copy(), r[2].copy()))
        runs.append((res, res2))
        if dev == "cuda":
            counts, plain = dsp_counts(), plain_calls()
    ((steps_c, land_c, cks_c), norm_c), ((steps_p, land_p, cks_p), norm_p) = runs
    check(steps_equal(steps_c, steps_p), "fleet: CUDA windows/masks/positions == CPU")
    check(land_c == land_p, f"fleet: CUDA seek landings == CPU ({land_c})")
    check(deep_equal(cks_c, cks_p), "fleet: CUDA final checkpoints == CPU")
    check(steps_equal(norm_c, norm_p), "fleet: normalized engine-only fleet CUDA == CPU")
    ran = ("dfpwm_decode", "ima_decode", "qoa_lms", "lpc_restore", "iir_zero", "fma")
    say("fleet", stations=FLEET_CHECK_STATIONS, windows=len(steps_c),
        landings=json.dumps(land_c), normalized_stations=len(engine_only),
        normalized_windows=len(norm_c), equal=True, launches=json.dumps(counts),
        plain_calls=plain)
    check(all(counts[k] > 0 for k in ran), f"fleet: kernels (a), (d), (f), (g), (h), FMA ({counts})")
    check(plain == 0, "fleet: no plain version on the CUDA path")
    return counts


def fleet_main_sources(fx, seconds: int = FLEET_SECONDS):
    """bench.py:620-629 at FLEET_STATIONS: one third FLAC 48 kHz mono, one
    third raw DFPWM 48 kHz, one third IMA-in-WAV at 16 kHz, ``seconds``
    each, in turn."""
    rng = np.random.default_rng(61)
    fl = fleet_flac_stream(fx, rng, seconds)
    df = (LaneSpec("dfpwm", 48000), rng.integers(0, 256, seconds * 6000, np.uint8).tobytes())
    wav = ima_wav(rng, seconds)
    return [(fl, df, wav)[i % 3] for i in range(FLEET_STATIONS)]


@phase
def phase_fleet_main_path() -> dict:
    """The Fleet facade at full width (bench.py:600-640's mix at
    FLEET_STATIONS stations, FLAC on the device route): construction
    (container bridging, whole-file feeds) and every step, timed. Launch
    counts are zeroed just before and read just after. The first window of
    two stations of each kind is held against a CPU Fleet on those
    stations. Then [step_breakdown]: two steady steps under torch.profiler
    (after a warm-up step it discards), per step: the host time of the
    engine step, the FLAC fleet step (parse, restore staging) and the merge;
    the device time of kernels (b), (d), (g), (h), the FMA, the copies and
    the other ops, (b) also by CUDA events; the device's busy share. Every
    kernel launched in those steps must show in the profile."""
    fx = load_fixtures()
    sources = fleet_main_sources(fx)
    kernels.reset_counts()
    t0 = sync_time()
    fleet = Fleet(sources, device="cuda", device_restore=True, device_dsp=True)
    build = sync_time() - t0
    t0 = sync_time()  # bench.py:630-636 times the steps, not the construction
    first, windows = None, 0
    while not fleet.done:
        r = fleet.step()
        if r is None:
            continue
        check(tuple(r[0].shape) == (FLEET_STATIONS, 48000) and r[0].dtype == torch.int8,
              "fleet window shape")
        first = r[0] if first is None else first
        windows += 1
    dt = sync_time() - t0
    counts, plain = dsp_counts(), plain_calls()
    audio = fleet.metrics.samples_decoded / 48000
    say("main_path", case="fleet", stations=FLEET_STATIONS, seconds_per_station=FLEET_SECONDS,
        windows=windows, construct_seconds=round(build, 4), seconds=round(dt, 4),
        audio_seconds=round(audio, 1), realtime_factor=round(audio / dt, 1),
        launches=json.dumps(counts), plain_calls=plain)
    ran = ("dfpwm_decode_dsp", "ima_decode", "lpc_restore", "iir_zero", "fma")
    check(all(counts[k] > 0 for k in ran) and plain == 0,
          f"fleet: kernels (b), (d), (g), (h), FMA launched, no plain version ({counts})")
    check(audio >= FLEET_STATIONS * FLEET_SECONDS * 0.99, "every station decoded its seconds")
    sub = [0, 1, 2, 3, 4, 5]
    cpu = Fleet([sources[i] for i in sub], device="cpu", device_restore=True, device_dsp=True)
    r = cpu.step()
    check(r is not None and torch.equal(first[torch.tensor(sub, device="cuda")].cpu(), r[0]),
          "fleet first window == CPU Fleet on two stations of each kind")
    del fleet, first
    torch.cuda.empty_cache()

    # two steady steps under the profiler, after a warm-up step that it
    # discards: the first kernel of a profile's first step can go unrecorded
    fleet = Fleet(sources, device="cuda", device_restore=True, device_dsp=True)
    fleet.step()
    clock = {"engine": 0.0, "flac": 0.0}

    def timed_sub(name, orig):
        def wrapped():
            t1 = time.perf_counter()
            r = orig()
            clock[name] += time.perf_counter() - t1
            return r
        return wrapped

    fleet.engine.step = timed_sub("engine", fleet.engine.step)
    fleet.flac.step = timed_sub("flac", fleet.flac.step)
    b_spans = []
    fused = sb.dfpwm_decode_dsp_kernel
    sb.dfpwm_decode_dsp_kernel = event_wrap(fused, b_spans)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=2, repeat=1)
    try:
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            fleet.step()
            prof.step()
            kernels.reset_counts()
            clock.update(engine=0.0, flac=0.0)
            b_spans.clear()
            t0 = sync_time()
            r = fleet.step()
            prof.step()
            r2 = fleet.step()
            wall = (sync_time() - t0) * 1e3
            prof.step()
    finally:
        sb.dfpwm_decode_dsp_kernel = fused
    step_counts = {k: v for k, v in dsp_counts().items() if v}
    check(r is not None and bool(r[1].all()) and r2 is not None and bool(r2[1].all()),
          "the profiled fleet steps deliver every station")
    # the schedule's step markers span the whole step on the device too
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")]
    kernel_names = sorted({e.name[:90] for e in dev if "at::" not in e.name})
    names = {"decode_dsp": "dfpwm_decode_kernel<true", "ima": "ima_decode",
             "lpc_restore": "lpc_restore_kernel", "iir_zero": "iir_zero_kernel",
             "fma": "fma_kernel", "htod": "Memcpy HtoD", "dtoh": "Memcpy DtoH"}
    spans = {k: [(e.time_range.start, e.time_range.end) for e in dev if v in e.name]
             for k, v in names.items()}
    spans["other"] = [(e.time_range.start, e.time_range.end) for e in dev
                      if not any(v in e.name for v in names.values())]
    shown = {"dfpwm_decode_dsp": "decode_dsp", "ima_decode": "ima", "lpc_restore": "lpc_restore",
             "iir_zero": "iir_zero", "fma": "fma"}
    missing = [k for k in step_counts if shown.get(k) not in spans or not spans[shown[k]]]
    check(not missing, f"the fleet steps' profile shows every kernel they launched "
          f"(missing {missing}; launched {step_counts})")
    everything = [iv for ivs in spans.values() for iv in ivs]
    kernels_only = [iv for k, ivs in spans.items() if k not in ("htod", "dtoh") for iv in ivs]
    engine_ms, flac_ms = clock["engine"] * 1e3 / 2, clock["flac"] * 1e3 / 2
    say("step_breakdown", case="fleet", stations=FLEET_STATIONS, profiled_steps=2,
        profiled_step_ms=round(wall / 2, 3), engine_step_host_ms=round(engine_ms, 3),
        flac_step_host_ms=round(flac_ms, 3), merge_host_ms=round(wall / 2 - engine_ms - flac_ms, 3),
        launches=json.dumps(step_counts), kernel_names=json.dumps(kernel_names),
        device_events=len(dev), decode_dsp_events_ms=round(events_ms(b_spans) / 2, 3),
        **{f"{k}_ms": round(busy_ms(v) / 2, 3) for k, v in spans.items()},
        busy_kernels=round(busy_ms(kernels_only) / wall, 4),
        busy_with_copies=round(busy_ms(everything) / wall, 4))
    del fleet
    torch.cuda.empty_cache()
    return counts


# -- the whole-file surface: auplay's preload chain and the effects -------------------

CARD = "cuda"  # the device of the whole-file phases and the two-process workers (a
# rehearsal on the CPU sets "cpu")
WHOLE_SECONDS = 180  # a 3-minute track
PODCAST_REPEATS = 20  # the 60-minute case: the 3-minute PCM16 track 20 times
CUT_SECONDS = 10  # the cut the CPU chain runs too
# the DFPWM files' cut: their plain loop takes ~80 us a sample (2 s until the
# [cli] phase came; 1 s is the least whole MDFPWM block pair)
DFPWM_CUT_SECONDS = 1
EFFECTS_CHANNELS = 64  # bench.py:771-792's config 5
EFFECTS_SECONDS = 180
EFFECTS_CUT_SECONDS = 2
# A one-lane DFPWM sample, read from the SASS of the tame loops
# (tools/cuda_kernel_probe.py sass dfpwm): (the dependent chain from one charge
# to the next, the integer-pipe instructions a sample). The decode's chain is
# IMAD.IADD, IMAD, ISETP, VIADDMNMX, VIADDMNMX; 222 of the 16-sample loop's
# 319 instructions are not IMADs. The encode's is IADD3, IMAD, IMAD, VIADD,
# SHF, VIMNMX, IMAD.IADD; 594 of the 32-sample loop's 731. A dependent
# instruction follows the one before after 4.06 cycles, and one warp issues
# an independent integer instruction every 2.04 (tools/int_rate_probe.cu,
# PERF.md section 7), at the card's 1980 MHz boost clock.
DFPWM_ONE_LANE = {"dfpwm_decode": (5, 222 / 16), "dfpwm_encode": (7, 594 / 32)}
DEPENDENT_CYCLES, ISSUE_CYCLES = 4.06, 2.04
SM_CLOCK_HZ = 1.98e9


def whole_file_tracks(tracks, seconds: float) -> list:
    """[(name, loader, file bytes, lossless samples or None, seconds)] of the
    same tones-plus-noise tracks in every container: stereo 44.1 kHz in WAV
    PCM16, IMA and MS ADPCM (``block_align`` 1024), FLAC (LPC-8, mid/side),
    QOA, AIFF, AU µ-law and DFPWM-in-WAV; raw DFPWM mono and MDFPWM stereo
    at 48 kHz. The DFPWM files are the port's own encoders' output on the
    card (``Audio.wav(1)``, ``Audio.dfpwm()``: kernel (c), one lane
    interleaved or a lane a channel)."""
    from aukit_tpu_torch.codecs.g711 import g711_expand_lut
    from aukit_tpu_torch.ops.pcmcode import normalize_pcm

    x = tracks.synth_track(seconds, 44100, seed=70)
    x48 = tracks.synth_track(seconds, 48000, seed=71)
    pcm = normalize_pcm(x.T.reshape(-1), 16, "signed").reshape(-1, 2).T
    flac, flac_samples = tracks.flac_file(x, 44100)
    left, right = tk.new_audio(x48 / 32768.0, 48000, device=CARD).dfpwm(False)
    return [
        ("wav_pcm16", "wav", tracks.pcm16_wav(x, 44100), pcm),
        ("wav_ima", "wav", tracks.ima_wav(x, 44100), None),
        ("wav_msadpcm", "wav", tracks.msadpcm_wav(x, 44100), None),
        ("flac", "flac", flac, (flac_samples / 65536.0).astype(np.float32)),
        ("qoa", "qoa", tracks.qoa_file(x, 44100), None),
        ("aiff", "aiff", tracks.aiff16(x, 44100), pcm),
        ("au_ulaw", "au", tracks.ulaw_au(x, 44100, g711_expand_lut(True)), None),
        ("wav_dfpwm", "wav", tk.new_audio(x / 32768.0, 44100, device=CARD).wav(1), None),
        ("dfpwm", "dfpwm", tk.new_audio(x48[:1] / 32768.0, 48000, device=CARD).dfpwm(), None),
        ("mdfpwm", "mdfpwm", load_fixtures().mdfpwm_file(left, right, len(left) + len(right)),
         None),
    ]


# the FMA call sites of the whole-file surface and the stream iterators: the
# scan, the resampler, the effects' feedback and allpass blocks, the
# ChunkResampler's device twin
FMA_SITES = ((oscan, "fma_kernel"), (ores, "fma"), (tfx, "_fma_kernel"),
             (sengine, "fma_kernel"))


def fma_held_to_plain(run) -> tuple[int, float, tuple]:
    """Runs ``run()`` with every FMA launch at ``FMA_SITES`` held to
    ``fma_ref`` on the same operands: the kernel at the very shapes a path
    gives it. -> (launches held, largest |difference| (inf where a NaN
    differs), the largest launch's shape)."""
    seen = {"n": 0, "err": 0.0, "numel": -1, "shape": ()}

    def checked(x, y, z):
        before = kf.fma_kernel.launches
        out = kf.fma_kernel(x, y, z)
        seen["n"] += kf.fma_kernel.launches - before  # an empty output launches nothing
        ref = kf.fma_ref(x, y, z)
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            diff = float((out - ref).abs().max())
            seen["err"] = max(seen["err"], diff if diff == diff else float("inf"))
        if out.numel() > seen["numel"]:
            seen["numel"], seen["shape"] = out.numel(), tuple(out.shape)
        return out

    saved = [getattr(m, n) for m, n in FMA_SITES]
    for m, n in FMA_SITES:
        setattr(m, n, checked)
    try:
        run()
    finally:
        for (m, n), fn in zip(FMA_SITES, saved):
            setattr(m, n, fn)
    return seen["n"], seen["err"], seen["shape"]


def native_lpc_ms(args) -> float:
    """The native host restore (``restore_lpc_flat``, the JAX package's host
    route) over kernel (g)'s staged rows ``args`` (vals, orders, shifts,
    blocks, coefs[, K]), timed alone: its flat values, offsets and
    coefficients in 32 columns, as it reads them, are made first."""
    vals, orders, shifts, blocks, coefs = (a.cpu().numpy() for a in args[:5])
    keep = np.arange(vals.shape[1])[None, :] < blocks[:, None]
    flat = vals[keep].astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(blocks)])[:-1]
    taps = np.zeros((len(blocks), 32), np.int64)
    taps[:, :coefs.shape[1]] = coefs
    t0 = time.perf_counter()
    flacbits.restore_lpc_flat(flat, offs, blocks, orders, shifts, np.zeros_like(blocks), taps)
    return (time.perf_counter() - t0) * 1e3


def card_sync() -> None:
    if CARD == "cuda":
        torch.cuda.synchronize()


def auplay_chain(loader: str, raw: bytes, device: str, stages: dict | None = None):
    """aukit_tpu/cli/auplay.py:58-70 without the sink: load -> resample(48000)
    -> mono() -> normalize(0.8) -> lowpass(rate / 2) -> stream(48000), every
    chunk drawn. -> (loaded Audio, samples streamed, [chunks]); ``stages``
    gets each stage's seconds, the device synchronised after each ("plan":
    the resampler's host index tables, cached for the resample)."""
    marks = [time.perf_counter()]

    def mark():
        if device != "cpu":
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    args = (1, 48000) if loader == "dfpwm" else ()
    audio = getattr(tk, loader)(raw, *args, device=device)
    mark()
    resample_plan(audio.num_samples, audio.sample_rate, 48000)  # the host's index tables
    mark()
    out = audio.resample(48000)
    mark()
    out = out.mono()
    mark()
    tfx.normalize(out, 0.8)
    mark()
    tfx.lowpass(out, audio.sample_rate / 2)
    mark()
    it, _ = out.stream(48000)
    chunks = [c for c, _ in it]
    mark()
    if stages is not None:
        for name, a, b in zip(("load", "plan", "resample", "mono", "normalize", "lowpass",
                               "stream"), marks, marks[1:]):
            stages[name] = round(b - a, 4)
    return audio, out.num_samples, chunks


@phase
def phase_whole_file() -> dict:
    """auplay's preload chain on the card over a 3-minute track in every
    container and a 60-minute PCM16 WAV (a podcast episode): each stage
    timed with the card synchronised, the realtime factor and the peak
    device memory. Lossless containers (PCM WAV, AIFF, FLAC) decode to the
    synthesised samples at full length, raw DFPWM to the port's native host
    decode; every file's chain on a cut (CUT_SECONDS; DFPWM_CUT_SECONDS for
    the three DFPWM files) gives the CPU chain's chunks bit for bit. The
    launch counts are zeroed before the files are made (the DFPWM files are
    kernel (c)'s output) and read after the last chain; then every chain
    runs again with each FMA launch held to ``fma_ref``. -> (launches, the
    FMA's largest |difference|)."""
    from aukit_tpu_torch.ops.pcmcode import normalize_pcm

    tracks = load_test_module("torch_tracks")
    t0 = time.perf_counter()
    kernels.reset_counts()
    files = whole_file_tracks(tracks, WHOLE_SECONDS)
    say("whole_file_tracks", files=len(files), bytes=sum(len(f[2]) for f in files),
        build_seconds=round(time.perf_counter() - t0, 3))
    pcm = files[0][3]
    podcast = tracks.pcm16_wav(np.tile(tracks.synth_track(WHOLE_SECONDS, 44100, seed=70),
                                       PODCAST_REPEATS), 44100)
    # the first file again after the others: its first run carries the
    # process's first launches of the chain's torch operations on the card
    files += [("wav_pcm16_again", "wav", files[0][2], pcm),
              ("podcast_wav_pcm16", "wav", podcast, None)]
    for name, loader, raw, lossless in files:
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        t0 = time.perf_counter()
        audio, streamed, chunks = auplay_chain(loader, raw, CARD, stages)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if name == "podcast_wav_pcm16":
            check(audio.num_samples == pcm.shape[1] * PODCAST_REPEATS and bool(
                (audio.data[:, : pcm.shape[1]].cpu() == torch.from_numpy(pcm)).all()),
                "podcast: the 60-minute WAV decodes to its samples")
        elif lossless is not None:
            check(np.array_equal(audio.numpy(), lossless), f"{name}: decodes to its samples")
        if name == "dfpwm":
            nat, _ = flacbits.dfpwm_decode_rows(np.frombuffer(raw, np.uint8)[None, :],
                                                np.zeros((5, 1), np.int32))
            check(np.array_equal(audio.numpy()[0], normalize_pcm(nat[0], 8, "signed")),
                  "dfpwm: the whole file == the native host decode")
        check(len(chunks) == -(-streamed // 48000) and np.isfinite(chunks[-1]).all(),
              f"{name}: every second streamed")
        say("whole_file", file=name, rate=audio.sample_rate, channels=audio.channels,
            seconds_of_audio=round(audio.duration, 3), bytes=len(raw), wall_s=round(dt, 4),
            realtime_factor=round(audio.duration / dt, 1), chunks=len(chunks),
            max_memory_allocated_gb=round(peak / 1e9, 3), stages_s=json.dumps(stages))
        del audio, chunks
    counts, plain = dsp_counts(), plain_calls()
    say("whole_file_launches", launches=json.dumps(counts), plain_calls=plain)
    ran = ("dfpwm_decode", "dfpwm_encode", "ima_decode", "msadpcm_decode", "qoa_lms",
           "lpc_restore", "fma")
    check(all(counts[k] > 0 for k in ran) and plain == 0,
          f"whole_file: kernels (a), (c), (d), (e), (f), (g) and the FMA ran, no plain "
          f"version ({counts})")
    # every file's chain again at full length, each FMA launch held to fma_ref
    held, fma_err, largest = fma_held_to_plain(
        lambda: [auplay_chain(loader, raw, CARD) for _, loader, raw, _ in files])
    say("kernel_vs_plain_main_shape", kernel="fma", case="whole_file_chains", launches=held,
        largest=json.dumps(list(largest)), equal=fma_err == 0)
    check(held == counts["fma"] and fma_err == 0, "whole_file: every FMA launch of the chains "
          f"at full length == fma_ref ({held} of {counts['fma']} launches, error {fma_err})")
    del files, podcast
    # the CUDA chain against the CPU chain on a cut of each file (the encoders
    # start each block from its own header: a cut's file is the full file's start)
    cuts = {s: whole_file_tracks(tracks, s) for s in (CUT_SECONDS, DFPWM_CUT_SECONDS)}
    for name, loader, raw, _ in cuts[CUT_SECONDS]:
        seconds = DFPWM_CUT_SECONDS if "dfpwm" in name else CUT_SECONDS
        raw = next(f[2] for f in cuts[seconds] if f[0] == name)
        (_, _, got), (_, _, want) = (auplay_chain(loader, raw, CARD),
                                     auplay_chain(loader, raw, "cpu"))
        ok = len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))
        say("whole_file_cut", file=name, seconds=seconds, chunks=len(got), cuda_equals_cpu=ok)
        check(ok, f"{name}: the CUDA chain == the CPU chain on a {seconds} s cut")
    return counts, fma_err


@phase
def whole_file_kernel_shapes() -> dict:
    """Kernels (a), (c), (d), (e), (f), (g) at the whole-file phase's launch
    shapes (tests/torch_kernel_cases.py ``whole_file_cases``, a 3-minute
    track), each against its plain version on the same tensors (the
    one-lane DFPWM decode and encode against the native host routes at full
    length and the plain version over the first quarter second), then timed
    by CUDA events beside its bound, its plain version (for (a) and (c) over
    that quarter second) and the native host route where the port's binding has
    one ((a), (c), (f), (g)). -> max |error| by row of the ``kernels`` line."""
    cases = load_test_module("torch_kernel_cases")
    errs = {}
    for name, kern, args in cases.whole_file_cases(CARD, WHOLE_SECONDS):
        if kern in ("dfpwm_decode", "dfpwm_encode"):
            data, st = args
            zeros = DfpwmState.zeros(1, CARD)
            if kern == "dfpwm_decode":
                run = lambda: kc.dfpwm_decode_kernel(data, st)  # noqa: E731
                head = data[:, :1500].contiguous()  # a quarter second
                plain = lambda: kc.dfpwm_decode_ref(head, zeros)  # noqa: E731
                host = data.cpu().numpy()
                t0 = time.perf_counter()
                nat, nat_st = flacbits.dfpwm_decode_rows(host, np.zeros((5, 1), np.int32))
                native_ms = (time.perf_counter() - t0) * 1e3
                samples, nbytes = data.shape[1] * 8, data.shape[1] * 9
                ops = samples * OPS_PER_SAMPLE["dfpwm_decode"]
            else:
                run = lambda: kc.dfpwm_encode_kernel(data, st)  # noqa: E731
                head = data[:, :12000].contiguous()
                plain = lambda: kc.dfpwm_encode_ref(head, zeros)  # noqa: E731
                host = data.cpu().numpy().astype(np.int32)
                t0 = time.perf_counter()
                nat, nat_st = flacbits.dfpwm_encode_rows(host, np.zeros((3, 1), np.int32))
                native_ms = (time.perf_counter() - t0) * 1e3
                samples, nbytes = data.shape[1], data.shape[1] * 9 // 8
                ops = samples * OPS_PER_SAMPLE["dfpwm_encode"]
            (out, out_st), ms = timed(run)
            (ref, _), plain_ms = timed(plain)
            leaves = np.stack([a.cpu().numpy() for a in out_st.leaves()][: len(nat_st)])
            ok = (np.array_equal(out.cpu().numpy(), nat.astype(out.cpu().numpy().dtype))
                  and np.array_equal(leaves, nat_st) and torch.equal(out[:, : ref.shape[1]], ref))
            err = 0 if ok else int((out[:, : ref.shape[1]].int() - ref.int()).abs().max())
            ms = min(ms, event_ms(run, 2))
            key = kern
            chain, pipe = DFPWM_ONE_LANE[kern]
            chain_ms = samples * chain * DEPENDENT_CYCLES / SM_CLOCK_HZ * 1e3
            issue_ms = samples * pipe * ISSUE_CYCLES / SM_CLOCK_HZ * 1e3
            say("whole_file_kernel", case=name, shape=json.dumps(list(data.shape)), equal=ok,
                ms=round(ms, 4), native_host_ms=round(native_ms, 4),
                plain_ms_first_quarter_second=round(plain_ms, 2),
                dependent_chain_ms=round(chain_ms, 4), integer_issue_ms=round(issue_ms, 4),
                share_of_one_lane_bound=round(max(chain_ms, issue_ms) / ms, 4))
            timing(name, ms, plain_ms, ops, nbytes)
        else:
            kernel, plain_fn, ops_key = {
                "ima": (ka.ima_decode_kernel, ka.ima_decode_ref, "ima"),
                "msadpcm": (ka.msadpcm_decode_kernel, ka.msadpcm_decode_ref, "msadpcm"),
                "qoa": (kq.qoa_lms_kernel, kq.qoa_lms_ref, "qoa"),
                "lpc": (kg.lpc_restore_kernel, kg.lpc_restore_ref, None)}[kern]
            out, ms = timed(lambda: kernel(*args))
            ref, plain_ms = timed(lambda: plain_fn(*args))
            ok, err = same(out, ref) if kern == "lpc" else same(out[0], ref[0])
            if kern != "lpc":
                st_ok, st_err = same(out[1], ref[1])
                ok, err = ok and st_ok, max(err, st_err)
            ms = min(ms, event_ms(lambda: kernel(*args), 3))
            rows, T = args[0].shape
            native_ms = None
            if kern == "qoa":
                dq, hist, wts = (a.cpu().numpy() for a in args)
                t0 = time.perf_counter()
                flacbits.qoa_lms(dq, hist, wts)
                native_ms = (time.perf_counter() - t0) * 1e3
            if kern == "lpc":
                native_ms = native_lpc_ms(args)
                ops = int(args[3].sum()) * lpc_ops_per_sample(8)
                nbytes = rows * T * 8
            else:
                ops = rows * T * OPS_PER_SAMPLE[ops_key]
                nbytes = args[0].numel() * args[0].element_size() + rows * T * 2
            key = {"ima": "ima", "msadpcm": "msadpcm", "qoa": "qoa", "lpc": "lpc_restore"}[kern]
            say("whole_file_kernel", case=name, shape=json.dumps([rows, T]), equal=ok,
                ms=round(ms, 4), plain_ms=round(plain_ms, 2),
                native_host_ms=None if native_ms is None else round(native_ms, 4))
            timing(name, ms, plain_ms, ops, nbytes)
        errs[key] = max(errs.get(key, 0), err)
        check(ok, f"{name}: kernel == plain (and native host) at the whole file's shape")
        del args
        torch.cuda.empty_cache()
    return errs


def effects_chain(audio) -> tuple:
    """bench.py:777-785: normalize(0.9) -> mono() -> lowpass(12000) ->
    resample(48000, "cubic") on a copy of ``audio``; -> (result, seconds of
    each stage, the device synchronised after each)."""
    a = tk.new_audio(audio.data, audio.sample_rate, device=audio.device)
    stages, t0 = {}, time.perf_counter()
    for name, step in (("normalize", lambda x: tfx.normalize(x, 0.9)), ("mono", lambda x: x.mono()),
                       ("lowpass", lambda x: tfx.lowpass(x, 12000)),
                       ("resample", lambda x: x.resample(48000, "cubic"))):
        a = step(a)
        if a.device.type == "cuda":
            torch.cuda.synchronize()
        stages[name] = round(time.perf_counter() - t0, 4)
        t0 = time.perf_counter()
    return a, stages


OTHER_EFFECTS = (("amplify", (1.3,)), ("speed", (1.25,)), ("fade", (1.0, 0.2, 1.8, 1.0)),
                 ("invert", ()), ("center", ()), ("trim", ()), ("delay", (0.3, 0.5)),
                 ("echo", (1.0, 0.5)), ("reverb", ()), ("highpass", (200,)))


@phase
def phase_effects_chain() -> dict:
    """bench.py config 5's chain on a 64-channel 44.1 kHz Audio of 180 s
    (2.0 GB a float32 tensor; bench.py: 2 s), made on the card from a seed,
    each stage timed; then every other effect once on the stereo 3-minute
    track, each timed. The CUDA results equal the CPU's on a 2 s cut. The
    chain and every effect that launches the FMA run again at full size with
    each launch held to ``fma_ref``. -> (launches, the FMA's largest
    |difference|)."""
    gen = torch.Generator(device=CARD).manual_seed(55)
    n = EFFECTS_SECONDS * 44100
    data = (torch.rand((EFFECTS_CHANNELS, n), generator=gen, device=CARD) * 2 - 1) * 0.5
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, stages = effects_chain(tk.new_audio(data, 44100, device=CARD))
    dt = time.perf_counter() - t0
    counts = dsp_counts()
    check(plain_calls() == 0 and counts["fma"] > 0,
          f"effects_chain: the FMA kernel ran, no plain version ({counts})")
    say("effects_chain", channels=EFFECTS_CHANNELS, seconds_of_audio=EFFECTS_SECONDS,
        input_gb=round(data.numel() * 4 / 1e9, 3), wall_s=round(dt, 4),
        realtime_factor=round(EFFECTS_CHANNELS * EFFECTS_SECONDS / dt, 1),
        out_samples=out.num_samples, stages_s=json.dumps(stages), launches=json.dumps(counts),
        max_memory_allocated_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    check(out.num_samples == EFFECTS_SECONDS * 48000 and bool(torch.isfinite(out.data).all()),
          "effects_chain: finite 48 kHz output of the full length")
    del out
    held, fma_err, largest = fma_held_to_plain(
        lambda: effects_chain(tk.new_audio(data, 44100, device=CARD)))
    check(held == counts["fma"] and fma_err == 0, "effects_chain: every FMA launch at full size "
          f"== fma_ref ({held} of {counts['fma']} launches, error {fma_err})")
    fma_held = {"config5": (held, list(largest))}
    cut = data[:, : EFFECTS_CUT_SECONDS * 44100]
    got, _ = effects_chain(tk.new_audio(cut, 44100, device=CARD))
    want, _ = effects_chain(tk.new_audio(cut.cpu(), 44100, device="cpu"))
    check(np.array_equal(got.numpy(), want.numpy()), "effects_chain: CUDA == CPU on a 2 s cut")
    del data, cut
    torch.cuda.empty_cache()
    tracks = load_test_module("torch_tracks")
    x = torch.from_numpy(tracks.synth_track(WHOLE_SECONDS, 44100, seed=70) / 32768.0)
    stereo = tk.new_audio(x, 44100, device=CARD)
    times = {}
    for name, args in OTHER_EFFECTS:
        a = tk.new_audio(stereo.data, 44100, device=CARD)
        kernels.reset_counts()
        card_sync()
        t0 = time.perf_counter()
        getattr(tfx, name)(a, *args)
        card_sync()
        times[name] = round(time.perf_counter() - t0, 4)
        launched = dsp_counts()
        for k, v in launched.items():
            counts[k] += v
        check(plain_calls() == 0 and bool(torch.isfinite(a.data).all()),
              f"{name}: finite output, no plain version")
        if launched["fma"]:
            a = tk.new_audio(stereo.data, 44100, device=CARD)
            held, err, largest = fma_held_to_plain(lambda: getattr(tfx, name)(a, *args))
            check(held == launched["fma"] and err == 0, f"{name}: every FMA launch at full "
                  f"length == fma_ref ({held} of {launched['fma']} launches, error {err})")
            fma_held[name] = (held, list(largest))
            fma_err = max(fma_err, err)
        cut = x[:, : EFFECTS_CUT_SECONDS * 44100]
        c, p = tk.new_audio(cut, 44100, device=CARD), tk.new_audio(cut, 44100, device="cpu")
        getattr(tfx, name)(c, *args)
        getattr(tfx, name)(p, *args)
        check(np.array_equal(c.numpy(), p.numpy()), f"{name}: CUDA == CPU on a 2 s cut")
    say("effects_each", track="stereo 44.1 kHz", seconds_of_audio=WHOLE_SECONDS,
        seconds=json.dumps(times), launches=json.dumps(counts))
    say("kernel_vs_plain_main_shape", kernel="fma", case="effects",
        launches_and_largest_shape=json.dumps(fma_held), equal=fma_err == 0)
    del stereo, a
    torch.cuda.empty_cache()
    return counts, fma_err


# the stream iterators over whole_file_tracks' files: (case, iterator, the
# file's name in whole_file_tracks, positional arguments, keyword arguments)
STREAM_ITERATORS = (
    ("wav_pcm16", "wav", "wav_pcm16", (), {}),
    ("wav_pcm16_mono", "wav", "wav_pcm16", (), {"mono": True}),
    ("wav_ima", "wav", "wav_ima", (), {}),
    ("wav_msadpcm", "wav", "wav_msadpcm", (), {}),
    ("wav_dfpwm", "wav", "wav_dfpwm", (), {}),
    ("aiff", "aiff", "aiff", (), {}),
    ("au_ulaw", "au", "au_ulaw", (), {}),
    ("flac", "flac", "flac", (), {}),
    ("qoa", "qoa", "qoa", (), {}),
    ("dfpwm", "dfpwm", "dfpwm", (48000, 1), {}),
    ("mdfpwm", "mdfpwm", "mdfpwm", (), {}),
    ("g711", "g711", "au_ulaw", (True, 2, 44100), {}),
    ("pcm", "pcm", "wav_pcm16", (16, "signed", 2, 44100), {}),
)
# the iterators whose block decodes run on ``device`` (the others are host code)
DEVICE_ITERATORS = ("wav", "dfpwm", "mdfpwm", "flac", "qoa")
# the kernel each recorded block decode launches, and its row of OPS_PER_SAMPLE
STREAM_KERNELS = {"ima": ("ima_decode", ka, "ima_decode_kernel"),
                  "msadpcm": ("msadpcm_decode", ka, "msadpcm_decode_kernel"),
                  "qoa": ("qoa_lms", kq, "qoa_lms_kernel"),
                  "lpc": ("lpc_restore", kg, "lpc_restore_kernel")}
TWIN_MODES = ("none", "linear", "cubic", "sinc")
TWIN_CUT_SECONDS = 1  # the device twin's cut: its FMAs' plain version is slow on the CPU
STREAM_DRAIN_S: dict = {}  # each iterator's drain seconds, read by the [cli] phase


def stream_source(name: str, raw: bytes) -> bytes:
    """What an iterator reads: the file, or for the raw ``g711`` and ``pcm``
    streams the AU file's µ-law payload (after its 24-byte header) and the
    WAV's PCM16 payload (after its 44-byte header)."""
    return raw[24:] if name == "g711" else raw[44:] if name == "pcm" else raw


def drain_stream(case, files: dict, device: str):
    """One iterator of ``STREAM_ITERATORS`` drained to the end of its file
    on ``device``: -> ([numpy chunks], seconds of audio by the positions)."""
    name, fn, file, args, kw = case
    extra = {"device": device} if fn in DEVICE_ITERATORS else {}
    it, _ = getattr(tk.stream, fn)(stream_source(name, files[file]), *args, **kw, **extra)
    chunks = [c for c, _ in it]
    return chunks, sum(c.shape[1] for c in chunks) / 48000


@contextlib.contextmanager
def recorded_flac_restores():
    """Within the block, the int64 samples every ``restore_and_decorrelate``
    call returns (``stream.flac``'s restore of a batch of frames, [C, n]):
    yields the list they are appended to."""
    from aukit_tpu_torch.codecs import flac as tflac

    fn, out = tflac.restore_and_decorrelate, []

    def recording(*args, **kwargs):
        out.append(fn(*args, **kwargs))
        return out[-1]

    tflac.restore_and_decorrelate = recording
    try:
        yield out
    finally:
        tflac.restore_and_decorrelate = fn


def kernel_launch_ms(module, name: str, run) -> list:
    """``run()`` with each launch of ``module.name`` timed by CUDA events
    (these launches are not counted: the wrapper's count is not the
    kernel's). -> [ms a launch]."""
    fn, spans = getattr(module, name), []

    def timed_kernel(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn(*args, **kwargs)
        ev[1].record()
        spans.append(ev)
        return out

    timed_kernel.launches = timed_kernel.wide_launches = 0
    setattr(module, name, timed_kernel)
    try:
        run()
    finally:
        setattr(module, name, fn)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in spans]


def stream_call_work(kind: str, call) -> tuple[tuple, float, float]:
    """((rows, T), operations, bytes) of one recorded block decode: its
    kernel's rows, its samples times ``OPS_PER_SAMPLE`` (the LPC restore at
    its call's tap count), and each input byte read and output byte written
    once (kernel (g): the samples of each row's block, 4 bytes each way, 8
    in a wide call)."""
    args = call[0]
    if kind == "lpc":
        vals, blocks, K = args[0], args[3], args[5]
        n = int(blocks.clamp(0, vals.shape[1]).sum())
        return tuple(vals.shape), n * lpc_ops_per_sample(K), n * 2 * vals.element_size()
    rows, T = np.shape(args[0])
    per_sample = {"ima": 3, "msadpcm": 3, "qoa": 4}[kind]  # nibble or int16 in, int16 out
    return (rows, T), rows * T * OPS_PER_SAMPLE[kind], rows * T * per_sample


def stream_native_ms(kind: str, calls) -> float | None:
    """The host route the JAX package takes for the same work, over every
    recorded call: the native ``qoa_lms``; the native ``restore_lpc_flat``
    over kernel (g)'s rows (``native_lpc_ms``); None for the ADPCM decodes
    (the JAX package has no host route for them)."""
    if kind == "lpc":
        return sum(native_lpc_ms(args) for args, _, _ in calls)
    if kind != "qoa":
        return None
    t0 = time.perf_counter()
    for args, _, _ in calls:
        flacbits.qoa_lms(*args)
    return (time.perf_counter() - t0) * 1e3


@phase
def phase_stream_iterators() -> tuple[dict, dict]:
    """The single-stream iterators on the card over whole_file_tracks' 3-minute
    files (ROADMAP queue 1's former item 1): every iterator drained to the end
    of its file, timed, with the kernels it launched. The block decodes they
    made are recorded and replayed: each kernel's launches timed by CUDA
    events, the first and the last call of each against the plain version on
    the CPU, and (f), (g) against the native host routes. Lossless files
    give their source: PCM WAV and AIFF the chunks of ``stream.pcm`` over
    the samples, FLAC its restore, with no row of it wrapped in kernel (g)'s
    int32 store. A broken FLAC stream whose rows do wrap (fault 3.3) takes
    kernel (g)'s wide int64 calls, each held to the plain version. Each
    kernel-backed iterator's chunks on the card equal its chunks on the CPU
    over the first CUT_SECONDS of its file. Then the device twin (``stream.pcm`` over the track's values on the card,
    int16 and float32, in all four modes; sinc over int16 alone) against the
    host oracle within the reference's 2e-2, its FMA launches each held to ``fma_ref``, and bench.py
    config 1 at its own size. -> (launches, max |error| by row of the
    ``kernels`` line)."""
    tracks = load_test_module("torch_tracks")
    cases = load_test_module("torch_kernel_cases")
    x = tracks.synth_track(WHOLE_SECONDS, 44100, seed=70)
    full = whole_file_tracks(tracks, WHOLE_SECONDS)
    files = {f[0]: f[2] for f in full}
    flac_samples = tracks.flac_file(x, 44100)[1]
    counts = {k: 0 for k in dsp_counts()}
    recorded = {}
    for case in STREAM_ITERATORS:
        kernels.reset_counts()
        with cases.recorded_stream_decodes() as calls, recorded_flac_restores() as restores:
            t0 = time.perf_counter()
            chunks, seconds = drain_stream(case, files, CARD)
            dt = time.perf_counter() - t0
        STREAM_DRAIN_S[case[0]] = dt
        wide = kg.lpc_restore_kernel.wide_launches
        launched = dsp_counts()
        check(plain_calls() == 0, f"{case[0]}: no plain version on the card")
        for k, v in launched.items():
            counts[k] += v
        for kind, made in calls.items():
            if made:
                recorded[case[0], kind] = made
        say("stream_iterators", iterator=case[0], seconds_of_audio=round(seconds, 3),
            chunks=len(chunks), wall_s=round(dt, 4), realtime_factor=round(seconds / dt, 1),
            launches=json.dumps({k: v for k, v in launched.items() if v}))
        check(seconds > WHOLE_SECONDS - 0.5 and all(np.isfinite(c).all() for c in chunks[-2:]),
              f"{case[0]}: finite chunks to the end of the file")
        if case[0] in ("wav_pcm16", "aiff"):
            want = [c for c, _ in tk.stream.pcm(x.T.reshape(-1).tolist(), 16, "signed", 2,
                                                44100)[0]]
            check(len(chunks) == len(want) and all(np.array_equal(a, b) for a, b in
                                                   zip(chunks, want)),
                  f"{case[0]}: the chunks of stream.pcm over the source samples")
        if case[0] == "flac":
            check(np.array_equal(np.concatenate(restores, axis=1), flac_samples),
                  "flac: restores its source samples")
            check(wide == 0, "flac: no row of the valid file wrapped kernel (g)'s int32 store")
        del chunks
    # ROADMAP queue 3, fault 3.3: a broken FLAC stream whose unstable
    # predictor leaves int32 (tests/torch_tracks.py's LPC track with byte 68
    # set to 0). Kernel (g) reports the rows it wrapped and restores them
    # again in int64 on the card (its wide entry point); the chunks equal
    # the CPU's.
    raw = tracks.flac_file(tracks.synth_track(0.5, 22050, 6), 22050, 3, 1024)[0]
    broken = raw[:68] + b"\x00" + raw[69:]
    kernels.reset_counts()
    with cases.recorded_stream_decodes() as calls:
        got = [c for c, _ in tk.stream.flac(broken, device=CARD)[0]]
    wide = kg.lpc_restore_kernel.wide_launches
    for k, v in dsp_counts().items():
        counts[k] += v
    recorded["flac_wrapping", "lpc"] = calls["lpc"]
    want = [c for c, _ in tk.stream.flac(broken, device="cpu")[0]]
    ok = len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    say("stream_iterators", iterator="flac_wrapping", chunks=len(got),
        lpc_calls=len(calls["lpc"]), wide_launches=wide, cuda_equals_cpu=ok)
    check(wide > 0 and ok, "flac_wrapping: wrapped rows restored wide on the card, == the CPU")
    expect = {"wav_ima": "ima_decode", "wav_msadpcm": "msadpcm_decode", "qoa": "qoa_lms",
              "flac": "lpc_restore"}
    check(all(counts[k] > 0 for k in expect.values()),
          f"stream_iterators: kernels (d), (e), (f), (g) ran ({counts})")
    errs = {}
    for (name, kind), made in recorded.items():
        row, module, fn_name = STREAM_KERNELS[kind]
        t0 = sync_time()
        launch_ms = kernel_launch_ms(module, fn_name,
                                     lambda: [cases.replay(kind, c, CARD) for c in made])
        replay_ms = (sync_time() - t0) * 1e3
        native_ms = stream_native_ms(kind, made)
        err = 0
        for c in made if name == "flac_wrapping" else (made[0], made[-1]):
            t0 = time.perf_counter()
            plain = cases.replay(kind, c, "cpu")
            plain_ms = (time.perf_counter() - t0) * 1e3
            diff = np.abs(np.asarray(plain, np.int64) - np.asarray(c[2], np.int64))
            err = max(err, int(diff.max()) if diff.size else 0)
        shapes, ops, nbytes = zip(*(stream_call_work(kind, c) for c in made))
        ops, nbytes = sum(ops), sum(nbytes)
        say("stream_kernel", iterator=name, kernel=row, calls=len(made),
            largest_shape=json.dumps(list(max(shapes, key=np.prod))),
            kernel_ms=round(sum(launch_ms), 4),
            replay_with_copies_ms=round(replay_ms, 4),
            native_host_ms=None if native_ms is None else round(native_ms, 4),
            plain_ms_last_call=round(plain_ms, 2), equal_plain=err == 0)
        timing(f"stream_{name}", sum(launch_ms), plain_ms, ops, nbytes)
        errs[row] = max(errs.get(row, 0), err)
        check(err == 0, f"{name}: kernel ({row}) == plain at the iterator's shapes")
    del recorded, full, files
    cut = {f[0]: f[2] for f in whole_file_tracks(tracks, CUT_SECONDS)}
    for case in STREAM_ITERATORS:
        if case[1] not in DEVICE_ITERATORS:
            continue
        got, _ = drain_stream(case, cut, CARD)
        want, _ = drain_stream(case, cut, "cpu")
        ok = len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
        # the DFPWM iterators decode on the host's native route on either
        # device, as the JAX package routes them: their cut checks that
        # routing, not kernel (a); the PCM WAV's is host code throughout
        route = "kernel" if case[0] in expect else "native host" if "dfpwm" in case[0] else "host"
        say("stream_cut", iterator=case[0], seconds=CUT_SECONDS, chunks=len(got), route=route,
            cuda_equals_cpu=ok)
        check(ok, f"{case[0]}: the card's chunks == the CPU's over a {CUT_SECONDS} s cut")
    twin_counts, twin_err = stream_device_twin(x)
    for k, v in twin_counts.items():
        counts[k] += v
    errs["fma"] = twin_err
    sig = np.random.default_rng(0).integers(-20000, 20000, (2, 44100 * 20)).astype("<i2")
    t0 = time.perf_counter()
    n_out = sum(c.shape[1] for c, _ in tk.stream.pcm(sig.T.reshape(-1).tobytes(), 16, "signed",
                                                     2, 44100, False, True)[0])
    dt = time.perf_counter() - t0
    say("stream_iterators", iterator="bench_config1_stream_pcm_wav16_mono", seconds_of_audio=20,
        out_samples=n_out, wall_s=round(dt, 4), realtime_factor=round(n_out / dt / 48000, 1))
    say("stream_launches", launches=json.dumps(counts))
    return counts, errs


def stream_device_twin(x: np.ndarray) -> tuple[dict, float]:
    """``stream.pcm`` over the 3-minute track's values on the card, int16 and
    float32, in each mode: ChunkResampler's device twin (CUDA chunks) held
    to the host oracle over the same values within the reference's 2e-2
    (sinc over the int16 values alone) and timed; then every drain again with each FMA launch held to ``fma_ref``.
    -> (launches, the FMA's largest |difference|)."""
    inter = x.T.reshape(-1)
    sources = (("int16", torch.tensor(inter, device=CARD), inter, 16, "signed"),
               ("float32", torch.tensor(inter / np.float32(32768), device=CARD),
                inter.astype(np.float32) / np.float32(32768), 32, "float"))
    saved = tk.CONFIG.default_interpolation

    def drains(compare: bool):
        for mode in TWIN_MODES:
            tk.CONFIG.default_interpolation = mode
            for dtype, values, host, depth, kind in sources:
                t0 = sync_time()
                got = [c for c, _ in tk.stream.pcm(values, depth, kind, 2, 44100)[0]]
                dt = sync_time() - t0
                if not compare:
                    continue
                check(all(c.is_cuda and c.dtype == torch.float32 for c in got),
                      "device twin: float32 chunks on the card")
                host_s = err = None
                # the sinc oracle takes 14-20 s a drain on the host: the int16
                # values' drain holds that mode (the float32 values differ only
                # in the source's scale, held in the other three modes)
                if (mode, dtype) != ("sinc", "float32"):
                    t0 = time.perf_counter()
                    want = [c for c, _ in tk.stream.pcm(host, depth, kind, 2, 44100)[0]]
                    host_s = round(time.perf_counter() - t0, 4)
                    err = max(float(np.abs(g.cpu().numpy() - w).max())
                              for g, w in zip(got, want))
                    check(len(got) == len(want) and err <= 2e-2,
                          f"device twin {mode}/{dtype}: within 2e-2 of the host oracle")
                say("stream_device_twin", mode=mode, values=dtype, chunks=len(got),
                    wall_s=round(dt, 4), realtime_factor=round(WHOLE_SECONDS / dt, 1),
                    host_oracle_s=host_s, max_abs_vs_host=err)

    try:
        kernels.reset_counts()
        drains(True)
        launched = dsp_counts()
        held, err, largest = fma_held_to_plain(lambda: drains(False))
        cut = torch.tensor(inter[: 2 * 44100 * TWIN_CUT_SECONDS])
        for mode in TWIN_MODES:
            tk.CONFIG.default_interpolation = mode
            got, want = ([c.cpu().numpy() for c, _ in tk.stream.pcm(v, 16, "signed", 2, 44100)[0]]
                         for v in (cut.to(CARD), cut))
            ok = len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
            say("stream_cut", iterator=f"pcm_device_twin_{mode}", seconds=TWIN_CUT_SECONDS,
                chunks=len(got), cuda_equals_cpu=ok)
            check(ok, f"device twin {mode}: the card's chunks == the CPU's over a "
                  f"{TWIN_CUT_SECONDS} s cut")
    finally:
        tk.CONFIG.default_interpolation = saved
    say("kernel_vs_plain_main_shape", kernel="fma", case="stream_device_twin", launches=held,
        largest=json.dumps(list(largest)), equal=err == 0)
    check(held == launched["fma"] and err == 0, "device twin: every FMA launch == fma_ref "
          f"({held} of {launched['fma']} launches, error {err})")
    return launched, err


# -- the programs: playback and the four CLIs (aukit_tpu_torch.cli) --------------------------

# the extension auplay and austream dispatch on, by whole_file_tracks' loader
CLI_EXT = {"wav": ".wav", "flac": ".flac", "qoa": ".qoa", "aiff": ".aiff", "au": ".au",
           "dfpwm": ".dfpwm", "mdfpwm": ".mdfpwm"}


def write_tracks(files, folder: str) -> dict:
    """whole_file_tracks' files written into a new ``folder`` under the
    extension the programs dispatch on: -> {name: path}."""
    os.makedirs(folder)
    paths = {}
    for name, loader, raw, _ in files:
        paths[name] = os.path.join(folder, name + CLI_EXT[loader])
        Path(paths[name]).write_bytes(raw)
    return paths


def run_cli(main, argv) -> tuple[float, str | None]:
    """One program's ``main(argv)`` with its standard output sent to
    os.devnull (``austream --fleet``'s progress line writes tens of MB a
    step), the card synchronised at its end: -> (seconds, the message of the
    ValueError it raised or None). A sink refuses a chunk of more than 48000
    samples that ``play`` passes whole (48000 to 96000 samples), in both
    packages: the ADPCM, QOA and DFPWM-in-WAV iterators' chunks at 44.1 kHz
    (ROADMAP fault 3.11)."""
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        t0 = time.perf_counter()
        try:
            main(argv)
            err = None
        except ValueError as e:
            err = str(e)
        card_sync()
        return time.perf_counter() - t0, err


def refused(widths) -> bool:
    """Whether a sink refuses one of these chunk widths (``run_cli``)."""
    from aukit_tpu_torch.playback.sink import MAX_CHUNK

    return any(MAX_CHUNK < w < 2 * MAX_CHUNK for w in widths)


def file_sink_bytes(chunks) -> bytes:
    """What auplay's FileSink writes for mono ``chunks`` (volume 1): each
    chunk's channel 0 floored, clipped and cast to int8 (playback/sink.py)."""
    return b"".join(np.clip(np.floor(np.asarray(c[0], np.float64)), -128, 127)
                    .astype(np.int8).tobytes() for c in chunks)


@contextlib.contextmanager
def fleet_play_clock():
    """Within the block, the seconds ``play_fleet`` spends in ``Fleet.step``,
    in the window's copy to the host (``playback._host``), in the progress
    callback, in the sinks' ``play_audio`` (summed over the consumer
    threads) and in all: yields the dict they are added to."""
    from aukit_tpu_torch import playback as tpb
    from aukit_tpu_torch.stream import fleet as sfleet

    clock = {"step": 0.0, "host_copy": 0.0, "progress": 0.0, "sinks": 0.0, "play_fleet": 0.0}
    lock = threading.Lock()

    def timed_as(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    clock[name] += time.perf_counter() - t0
        return run

    saved = (sfleet.Fleet.step, tpb._host, tpb.play_fleet, tpb.SinkBase.play_audio)

    def play_fleet(source, sinks, **kw):
        if kw.get("progress") is not None:
            kw["progress"] = timed_as("progress", kw["progress"])
        return timed_as("play_fleet", saved[2])(source, sinks, **kw)

    sfleet.Fleet.step = timed_as("step", saved[0])
    tpb._host = timed_as("host_copy", saved[1])
    tpb.play_fleet = play_fleet
    tpb.SinkBase.play_audio = timed_as("sinks", saved[3])
    try:
        yield clock
    finally:
        sfleet.Fleet.step, tpb._host, tpb.play_fleet, tpb.SinkBase.play_audio = saved


def station0_windows(fleet) -> bytes:
    """A fleet stepped to its end: station 0's windows, as bytes."""
    out = []
    while not fleet.done:
        r = fleet.step()
        if r is not None and r[1][0]:
            out.append(r[0][0].cpu().numpy().tobytes())
    return b"".join(out)


def fleet_cli_files(folder: str, kinds, n: int) -> list:
    """``n`` paths in a new ``folder``, path i hard-linked to the file
    ``kinds[i % 3]`` ((extension, bytes)): one copy of each on disk."""
    os.makedirs(folder)
    bases = []
    for k, (ext, raw) in enumerate(kinds):
        bases.append(os.path.join(folder, f"base{k}{ext}"))
        Path(bases[-1]).write_bytes(raw)
    paths = []
    for i in range(n):
        paths.append(os.path.join(folder, f"st{i:05d}{os.path.splitext(bases[i % 3])[1]}"))
        os.link(bases[i % 3], paths[-1])
    return paths


@phase
def phase_cli() -> dict:
    """The four programs and playback on the card, through the entry points a
    user calls (``python -m aukit_tpu_torch.cli.<name>``'s ``main``), each run
    timed with its standard output sent to os.devnull and its launch counts
    zeroed just before and read just after (-> their sum):
    1. ``auplay FILE -o OUT`` on every whole_file track: its bytes == the
       FileSink bytes of ``auplay_chain``'s chunks on the card; the card's
       program == the CPU's (``--device cpu``) on the cut;
    2. ``austream FILE -o OUT`` (mono: one speaker) on the same files, beside
       the drain of the iterator it dispatches to and [stream_iterators]'
       drain; the card == the CPU on the cut; an IMA WAV at 48 kHz run
       again with ``--trace DIR``, whose trace names kernel (d);
    3. ``play`` and ``player`` over ``stream.pcm``'s CUDA chunks (the device
       twin over the 3-minute track's values on the card): both captures
       equal, and == the CPU run's on TWIN_CUT_SECONDS;
    4. ``austream --fleet`` over FLEET_STATIONS paths of [fleet]'s three
       kinds of file (FLAC, raw DFPWM, IMA-in-WAV; CLI_FLEET_SECONDS each;
       hard links), with the split of
       ``play_fleet``'s time (it starts a thread a station and one
       producer: FLEET_STATIONS + 1); station 0's bytes == a direct Fleet's
       (of one station of each kind: stations are independent lanes);
    5. ``auconvert --fleet`` of FLEET_STATIONS inputs (the FLAC, the IMA WAV
       and bench.py config 7c's 48 kHz PCM16 stream in a WAV) to .dfpwm: every
       output == ``transcode_fleet`` of a direct Fleet and encode engine over
       one input of each kind;
    6. ``auconvert`` of the 3-minute stereo PCM16 WAV with tests/test_cli.py's
       cases (a channel map to WAV16, mono 48 kHz DFPWM, unsigned WAV8); the
       card == the CPU on the cut;
    7. ``play_file`` of the 3-minute QOA and FLAC files into two BufferSinks
       (the QOA file's chunks are refused, as in the JAX package); the card
       == the CPU on the cut. Runs 2 and 7 hold a refusal to the CPU's and to
       the chunk widths that cause it."""
    from aukit_tpu_torch.cli import auconvert, auplay, austream
    from aukit_tpu_torch.playback import BufferSink

    tracks = load_test_module("torch_tracks")
    fx = load_fixtures()
    totals = {k: 0 for k in dsp_counts()}

    def on_card(run):
        """``run()`` with the launch counts zeroed just before and added to
        the phase's just after: -> (its result, its launches)."""
        kernels.reset_counts()
        out = run()
        launched = dsp_counts()
        check(plain_calls() == 0, "cli: no plain version on the card")
        for k, v in launched.items():
            totals[k] += v
        return out, {k: v for k, v in launched.items() if v}

    full = whole_file_tracks(tracks, WHOLE_SECONDS)
    cuts = {s: whole_file_tracks(tracks, s) for s in (CUT_SECONDS, DFPWM_CUT_SECONDS)}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    paths = write_tracks(full, os.path.join(tmp, "full"))
    cut_paths = {s: write_tracks(f, os.path.join(tmp, f"cut{s}")) for s, f in cuts.items()}
    out = os.path.join(tmp, "out.raw")

    def cut_equal(main, args, path_of, seconds):
        """``main(args)`` with ``path_of(seconds)`` as its input, on the card
        and on the CPU: -> the two outputs and outcomes equal (an output not
        empty unless a sink refused a chunk)."""
        got = []
        for dev in (CARD, "cpu"):
            Path(out).unlink(missing_ok=True)
            _, err = run_cli(main, [a.replace("{in}", path_of(seconds)) for a in args]
                             + ["--device", dev])
            got.append((Path(out).read_bytes(), err))
        return got[0] == got[1] and (len(got[0][0]) > 0 or got[0][1] is not None)

    def cut_of(name):
        return lambda s: cut_paths[s][name]

    try:
        # 1. auplay
        for name, loader, raw, _ in full:
            (dt, err), launched = on_card(lambda: run_cli(auplay.main, [
                paths[name], "-o", out, "--device", CARD]))
            got = Path(out).read_bytes()
            _, streamed, chunks = auplay_chain(loader, raw, CARD)
            check(err is None and got == file_sink_bytes(chunks) and len(got) == streamed,
                  f"cli auplay {name}: the output == the FileSink bytes of the chain's chunks")
            del chunks
            seconds = DFPWM_CUT_SECONDS if "dfpwm" in name else CUT_SECONDS
            ok = cut_equal(auplay.main, ["{in}", "-o", out], cut_of(name), seconds)
            say("cli", run="auplay", file=name, seconds=round(dt, 4), bytes=len(got),
                realtime_factor=round(streamed / 48000 / dt, 1),
                launches=json.dumps(launched), cut_seconds=seconds, cuda_equals_cpu=ok)
            check(ok, f"cli auplay {name}: the card == the CPU on a {seconds} s cut")
        # 2. austream; a sink refuses the first chunk of four of the files
        for name, _, raw, _ in full:
            t0 = sync_time()
            widths = [c.shape[-1] for c, _ in austream.dispatch(paths[name], raw, {}, True,
                                                                 CARD)[0]]
            drain = sync_time() - t0
            (dt, err), launched = on_card(lambda: run_cli(austream.main, [
                paths[name], "-o", out, "--device", CARD]))
            got = Path(out).read_bytes()
            check((err is not None) == refused(widths) and (err is not None or len(got)
                                                            == sum(widths)),
                  f"cli austream {name}: every sample written, or the sink's refusal of a "
                  f"chunk over 48000 samples ({err})")
            seconds = DFPWM_CUT_SECONDS if "dfpwm" in name else CUT_SECONDS
            ok = cut_equal(austream.main, ["{in}", "-o", out], cut_of(name), seconds)
            say("cli", run="austream", file=name, seconds=round(dt, 4), bytes=len(got),
                refused=err, widest_chunk=max(widths), iterator_drain_s=round(drain, 4),
                stream_iterators_drain_s=round(STREAM_DRAIN_S.get(name, float("nan")), 4),
                realtime_factor=round(sum(widths) / 48000 / dt, 1),
                launches=json.dumps(launched), cut_seconds=seconds, cuda_equals_cpu=ok)
            check(ok, f"cli austream {name}: the card == the CPU on a {seconds} s cut")
        # the traced run: a 48 kHz IMA WAV of 2000-sample blocks, whose
        # one-second chunks the sink takes (the 44.1 kHz file's are refused)
        ima48 = os.path.join(tmp, "ima48.wav")
        Path(ima48).write_bytes(ima_wav(np.random.default_rng(72), WHOLE_SECONDS, 48000, 1004))
        trace_dir = os.path.join(tmp, "trace")
        runs = {}
        for name, extra in (("untraced", []), ("traced", ["--trace", trace_dir])):
            runs[name], launched = on_card(lambda: run_cli(austream.main, [
                ima48, "-o", out, *extra, "--device", CARD]))
        traces = list(Path(trace_dir).glob("*.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
        named = sum(1 for e in events if "ima_decode" in str(e.get("name", "")))
        say("cli", run="austream_trace", file="ima_48k_wav", seconds=round(runs["traced"][0], 4),
            untraced_seconds=round(runs["untraced"][0], 4), trace_files=len(traces),
            trace_events=len(events), ima_decode_events=named, launches=json.dumps(launched))
        check(runs["traced"][1] is None and runs["untraced"][1] is None and len(traces) == 1
              and named >= launched.get("ima_decode", 1) // 2 > 0,
              "cli austream --trace: the trace names kernel (d) at its launches")

        # 3. play and player over the device twin's CUDA chunks
        x = tracks.synth_track(WHOLE_SECONDS, 44100, seed=70)
        inter = x.T.reshape(-1)

        def play_both(values):
            on = []

            def chunks():
                for c, pos in tk.stream.pcm(values, 16, "signed", 2, 44100)[0]:
                    on.append(isinstance(c, torch.Tensor) and c.device == values.device)
                    yield c, pos

            played, heard = (BufferSink(), BufferSink()), (BufferSink(), BufferSink())
            t0 = time.perf_counter()
            tk.play(chunks(), *played)
            t_play = time.perf_counter() - t0
            t0 = time.perf_counter()
            p = tk.player(chunks(), *heard)
            p.join(600)
            t_player = time.perf_counter() - t0
            check(not p._player.is_alive() and all(on), "cli play/player: drained the chunks "
                  "of the values' device")
            return ([s.samples() for s in played + heard], t_play, t_player)

        values = torch.tensor(inter, device=CARD)
        (caught, t_play, t_player), launched = on_card(lambda: play_both(values))
        same_play = all(np.array_equal(a, b) for a, b in zip(caught[:2], caught[2:]))
        cut = torch.tensor(inter[: 2 * 44100 * TWIN_CUT_SECONDS])
        got, want = play_both(cut.to(CARD))[0], play_both(cut)[0]
        ok = all(np.array_equal(a, b) for a, b in zip(got, want))
        say("cli", run="play_player_device_twin", seconds_of_audio=WHOLE_SECONDS,
            play_s=round(t_play, 4), player_s=round(t_player, 4), samples=len(caught[0]),
            play_equals_player=same_play, launches=json.dumps(launched),
            cut_seconds=TWIN_CUT_SECONDS, cuda_equals_cpu=ok)
        check(same_play and len(caught[0]) >= (WHOLE_SECONDS - 1) * 48000,
              "cli play and player: the same bytes from the card's chunks")
        check(ok, f"cli play/player: the card == the CPU on a {TWIN_CUT_SECONDS} s cut")
        del values, caught

        # 4. austream --fleet
        flac, (_, dfpwm), ima = fleet_main_sources(fx, CLI_FLEET_SECONDS)[:3]
        paths4 = fleet_cli_files(os.path.join(tmp, "fleet"),
                                 ((".flac", flac), (".dfpwm", dfpwm), (".wav", ima)),
                                 FLEET_STATIONS)
        out0 = os.path.join(tmp, "station0.raw")
        with fleet_play_clock() as clock:
            (dt, err), launched = on_card(lambda: run_cli(austream.main, [
                paths4[0], "--fleet", *paths4[1:], "-o", out0, "--device", CARD]))
        got = Path(out0).read_bytes()
        # a Fleet's stations are independent lanes (as [fleet] holds): a
        # direct Fleet of one station of each kind gives station 0's windows
        t0 = sync_time()
        want = station0_windows(Fleet([austream._fleet_source(p, {}) for p in paths4[:3]],
                                      mono=True, channels=1, device=CARD))
        direct = sync_time() - t0
        busy = clock["step"] + clock["host_copy"] + clock["progress"]
        say("cli", run="austream_fleet", stations=FLEET_STATIONS,
            seconds_per_station=CLI_FLEET_SECONDS, seconds=round(dt, 4),
            station_seconds_per_second=round(FLEET_STATIONS * CLI_FLEET_SECONDS / dt, 1),
            fleet_step_s=round(clock["step"], 4), host_copy_s=round(clock["host_copy"], 4),
            progress_s=round(clock["progress"], 4),
            producer_waits_s=round(clock["play_fleet"] - busy, 4),
            sinks_summed_over_threads_s=round(clock["sinks"], 4),
            play_fleet_s=round(clock["play_fleet"], 4), direct_fleet_s=round(direct, 4),
            launches=json.dumps(launched), station0_bytes=len(got),
            station0_equals_direct_fleet=got == want)
        check(err is None and got == want and len(got) >= CLI_FLEET_SECONDS * 48000,
              "cli austream --fleet: station 0 == a direct Fleet's station 0")
        del want
        torch.cuda.empty_cache()

        # 5. auconvert --fleet
        rng = np.random.default_rng(77)
        pcm = fx.wav_pcm(rng.integers(-(1 << 14), 1 << 14, (1, 48000 * CLI_FLEET_SECONDS)), 48000,
                         16)
        kinds = ((".flac", flac), (".wav", pcm), (".wav", ima))
        ins = fleet_cli_files(os.path.join(tmp, "convert"), kinds, FLEET_STATIONS)
        outs = [os.path.join(tmp, "convert", f"out{i:05d}.dfpwm") for i in range(len(ins))]
        argv = ["--fleet", *[a for p in ins for a in ("-i", p)],
                *[a for o in outs for a in ("-o", o)], "--device", CARD]
        (dt, err), launched = on_card(lambda: run_cli(auconvert.main, argv))
        # the inputs are three files (hard links): a direct transcode of one
        # input of each kind gives what every output of that kind must hold
        t0 = sync_time()
        bodies = transcode_fleet(Fleet([raw for _, raw in kinds], device=CARD),
                                 BatchEncodeEngine([EncodeSpec("dfpwm")] * 3, device=CARD))
        direct = sync_time() - t0
        same_all = all(Path(o).read_bytes() == bodies[i % 3] for i, o in enumerate(outs))
        say("cli", run="auconvert_fleet", inputs=len(ins), seconds_per_input=CLI_FLEET_SECONDS,
            seconds=round(dt, 4),
            input_seconds_per_second=round(len(ins) * CLI_FLEET_SECONDS / dt, 1),
            output_bytes=sum(len(bodies[i % 3]) for i in range(len(outs))),
            direct_transcode_s=round(direct, 4),
            launches=json.dumps(launched), outputs_equal_transcode_fleet=same_all)
        check(err is None and same_all and all(len(b) >= CLI_FLEET_SECONDS * 6000 for b in bodies),
              "cli auconvert --fleet: every output == transcode_fleet's")
        del bodies
        torch.cuda.empty_cache()

        # 6. auconvert on one file
        for case, ext, args, seconds in (
                ("map_wav16", ".wav", ["-m", "1&2=1", "-m", "1[,0]*2=2", "-B", "16"],
                 CUT_SECONDS),
                ("mono_48k_dfpwm", ".dfpwm", ["-e", "mono", "-R", "48000"], DFPWM_CUT_SECONDS),
                ("wav8_unsigned", ".wav", ["-B", "8"], CUT_SECONDS)):
            out = os.path.join(tmp, case + ext)
            (dt, err), launched = on_card(lambda: run_cli(auconvert.main, [
                "-i", paths["wav_pcm16"], "-o", out, *args, "--device", CARD]))
            size = os.path.getsize(out) if err is None else 0
            ok = cut_equal(auconvert.main, ["-i", "{in}", "-o", out, *args],
                           cut_of("wav_pcm16"), seconds)
            say("cli", run="auconvert", case=case, seconds=round(dt, 4), bytes=size,
                launches=json.dumps(launched), cut_seconds=seconds, cuda_equals_cpu=ok)
            check(ok and size > 0,
                  f"cli auconvert {case}: the card == the CPU on a {seconds} s cut")

        # 7. play_file: the QOA file (a sink refuses its 50155-sample chunks, as in
        # the JAX package) and the FLAC file
        def play_file(path, dev):
            sinks = (BufferSink(), BufferSink())
            t0 = time.perf_counter()
            try:
                tk.play_file(path, *sinks, device=dev)
                err = None
            except ValueError as e:
                err = str(e)
            card_sync()
            return [s.samples() for s in sinks], err, time.perf_counter() - t0

        for name in ("qoa", "flac"):
            widths = [c.shape[-1] for c, _ in getattr(tk.stream, name)(
                Path(paths[name]).read_bytes(), device=CARD)[0]]
            (heard, err, dt), launched = on_card(lambda: play_file(paths[name], CARD))
            got, want = (play_file(cut_paths[CUT_SECONDS][name], dev)[:2] for dev in (CARD, "cpu"))
            ok = got[1] == want[1] and all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
            say("cli", run="play_file", file=name, seconds=round(dt, 4), samples=len(heard[0]),
                refused=err, widest_chunk=max(widths), launches=json.dumps(launched),
                cut_seconds=CUT_SECONDS, cuda_equals_cpu=ok)
            check((err is not None) == refused(widths) and (err is not None or len(heard[0])
                                                            == sum(widths)),
                  f"cli play_file {name}: every second played, or the sink's refusal ({err})")
            check(ok, f"cli play_file {name}: the card == the CPU on a {CUT_SECONDS} s cut")
    finally:
        tmp_dir.cleanup()
    say("cli_launches", launches=json.dumps(totals))
    ran = ("dfpwm_decode", "dfpwm_decode_dsp", "dfpwm_encode", "ima_decode", "msadpcm_decode",
           "qoa_lms", "lpc_restore", "fma")
    check(all(totals[k] > 0 for k in ran), f"cli: kernels (a)-(g) and the FMA ran ({totals})")
    return totals


# -- the multi-device layer: lane shards over a mesh, and two processes ---------------

MULTI_SHARDS = 4  # make_mesh(4): four shards, all on cuda:0 on a one-card machine
MULTI_SECONDS = 4  # seconds a lane of the 32768-lane sharded DFPWM engine
MULTI_CHECK_LANES = 66  # the check-size engines: no multiple of the shards
MULTIHOST_LANES = 16384  # lanes of each of the two processes
MULTIHOST_SECONDS = 2
MULTIHOST_TIMEOUT = 300


def accumulate(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def stop(proc) -> None:
    proc.kill()
    proc.wait()


# the wrappers the sharded paths launch, by their name in the launch counts,
# with their plain versions
SHARDED_KERNELS = {
    "dfpwm_decode": (kc.dfpwm_decode_kernel, kc.dfpwm_decode_ref),
    "dfpwm_decode_dsp": (kc.dfpwm_decode_dsp_kernel, kc.dfpwm_decode_dsp_ref),
    "dfpwm_encode": (kc.dfpwm_encode_kernel, kc.dfpwm_encode_ref),
    "ima_decode": (ka.ima_decode_kernel, ka.ima_decode_ref),
    "msadpcm_decode": (ka.msadpcm_decode_kernel, ka.msadpcm_decode_ref),
    "qoa_lms": (kq.qoa_lms_kernel, kq.qoa_lms_ref),
    "lpc_restore": (kg.lpc_restore_kernel, kg.lpc_restore_ref),
    "iir_zero": (kh.iir_zero_kernel, kh.iir_zero_ref),
    "fma": (kf.fma_kernel, kf.fma_ref)}
# the plain versions take a Python step a sample whatever their rows, ~3x
# cheaper on the CPU than on the card for a few rows: the DFPWM kernels'
# recorded calls of one signature replay as one call, stacked by rows
STACKED_REPLAYS = ("dfpwm_decode", "dfpwm_decode_dsp", "dfpwm_encode")
# their per-lane parameters: every tensor these hold, and every tensor of
# the result, has the call's rows first; no other parameter holds a tensor
LANE_PARAMS = {"dfpwm_decode": ("bytes_u8", "state"),
               "dfpwm_decode_dsp": ("bytes_u8", "state", "mask", "gain"),
               "dfpwm_encode": ("levels_i8", "state")}
REPLAY_BLOCK_ROWS = 32  # one thread block of the DFPWM kernels (LANES, csrc/dfpwm.cu)
CARD_REPLAY_ROWS = 4096  # a replay this wide runs on the card, a narrower one on the CPU
REPLAY_TIMEOUT = 600  # the process of the CPU replays


def map_tree(fn, x):
    """``fn`` on every tensor of ``x`` (tuples, lists, dicts, DfpwmStates)."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, DfpwmState):
        return DfpwmState(*(fn(a) for a in x.leaves()))
    if isinstance(x, (tuple, list)):
        return type(x)(map_tree(fn, a) for a in x)
    if isinstance(x, dict):
        return {k: map_tree(fn, v) for k, v in x.items()}
    return x


def tree_leaves(x) -> list:
    if isinstance(x, DfpwmState):
        return list(x.leaves())
    if isinstance(x, (tuple, list)):
        return [leaf for a in x for leaf in tree_leaves(a)]
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in tree_leaves(x[k])]
    return [x]


def tree_signature(x):
    """What must agree for two calls' arguments to stack by rows: every
    tensor's dtype and trailing shape, every other value itself."""
    if torch.is_tensor(x):
        return str(x.dtype), tuple(x.shape[1:])
    if isinstance(x, (DfpwmState, tuple, list, dict)):
        return type(x).__name__, tuple(tree_signature(a) for a in tree_leaves(x))
    return x


def stack_trees(trees):
    """Trees of one signature as one tree, each tensor concatenated by rows."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.cat(trees)
    if isinstance(first, DfpwmState):
        return DfpwmState(*(torch.cat(col) for col in zip(*(t.leaves() for t in trees))))
    if isinstance(first, (tuple, list)):
        return type(first)(stack_trees(col) for col in zip(*trees))
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return first


def tree_err(a, b) -> float:
    """Largest |a - b| over two results' leaves (inf where a dtype, a shape,
    a NaN or a non-tensor value differs; 0 for bit-equal floats)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return float("inf")
    err = 0.0
    for x, y in zip(la, lb):
        if not torch.is_tensor(x):
            if torch.is_tensor(y) or x != y:
                return float("inf")
            continue
        y = y.to(x.device)
        if x.dtype != y.dtype or x.shape != y.shape:
            return float("inf")
        if x.is_floating_point():
            if torch.equal(*(t.contiguous().reshape(-1).view(torch.uint8) for t in (x, y))):
                continue
            d = float((x.double() - y.double()).abs().max())
            err = max(err, d if d == d else float("inf"))
        elif not torch.equal(x, y):
            err = max(err, float((x.long() - y.long()).abs().max()))
    return err


@contextlib.contextmanager
def recorded_kernel_calls(calls: dict, case: str):
    """Within the block, every launch of a ``SHARDED_KERNELS`` wrapper, under
    every name a module of the package binds it to, goes through a recorder:
    ``calls[name, case]`` keeps the first and the last launch as ((args,
    kwargs) cloned before it, (result, kwargs) cloned after it: kernel (g)'s
    ``wrapped`` flags are an output), and ``calls[name, case, "launches"]``
    counts every launch recorded. The wrappers count their launches on the
    recorder while it stands in their module; the counts go back to them at
    the end."""
    modules = [m for n, m in list(sys.modules.items())
               if m is not None and (n == "aukit_tpu_torch" or n.startswith("aukit_tpu_torch."))]
    saved, recorders = [], {}
    for name, (fn, _) in SHARDED_KERNELS.items():
        def recording(*args, _fn=fn, _name=name, **kwargs):
            inputs = map_tree(torch.clone, (args, kwargs))
            before = recorders[_name].launches
            out = _fn(*args, **kwargs)
            if recorders[_name].launches > before:  # an empty call launches nothing
                made = calls.setdefault((_name, case), [])
                made[1:] = []  # the first stays, the newest is the last so far
                made.append((inputs, map_tree(torch.clone, (out, kwargs))))
                key = (_name, case, "launches")
                calls[key] = calls.get(key, 0) + recorders[_name].launches - before
            return out

        recording.launches = recording.wide_launches = 0
        recorders[name] = recording
        for module in modules:
            for attr, value in list(vars(module).items()):
                if value is fn:
                    saved.append((module, attr, fn))
                    setattr(module, attr, recording)
    try:
        yield calls
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)
        for name, (fn, _) in SHARDED_KERNELS.items():
            fn.launches += recorders[name].launches
            if hasattr(fn, "wide_launches"):
                fn.wide_launches += recorders[name].wide_launches


def meshed_run(launches: dict, run, calls: dict | None = None, case: str = ""):
    """``run()`` with the launch counts zeroed just before it and read just
    after, added to ``launches``; no plain version may run on the card. With
    ``calls``, every launch is recorded (``recorded_kernel_calls``) under
    ``case``, and each kernel's recorded launches must equal its count."""
    kernels.reset_counts()
    if calls is None:
        out = run()
    else:
        with recorded_kernel_calls(calls, case):
            out = run()
    check(plain_calls() == 0, "no plain version on the sharded path")
    counts = dsp_counts()
    if calls is not None:  # the recorder stands in for the SHARDED_KERNELS wrappers
        seen = {k: calls.get((k, case, "launches"), 0) for k in SHARDED_KERNELS}
        want = {k: counts[k] for k in SHARDED_KERNELS}
        check(seen == want, f"{case}: every launch went through the recorder "
                            f"({seen} of {want})")
    accumulate(launches, counts)
    return out


def held_rows(rows: int) -> torch.Tensor | None:
    """The rows of a DFPWM call that its replay holds: the REPLAY_BLOCK_ROWS
    rows from the call's start, from a quarter, a half and three quarters
    of the way (each rounded down to a thread block's start) and up to its
    end: five thread blocks spread over the grid (None: every row, where
    that is no more)."""
    B = REPLAY_BLOCK_ROWS
    starts = {min(rows * k // 4 // B * B, max(rows - B, 0)) for k in range(4)} | {max(rows - B, 0)}
    keep = torch.unique(torch.cat([torch.arange(s, min(s + B, rows)) for s in starts]))
    return None if len(keep) >= rows else keep


def held_call(name: str, made):
    """A recorded DFPWM call ((args, kwargs), (result, kwargs)) cut to its
    ``held_rows``: only the kernel's LANE_PARAMS and its result are cut, and
    each must hold the call's rows first; any other parameter that holds a
    tensor fails the check."""
    (args, kwargs), (out, kw_after) = made
    rows = args[0].shape[0]
    keep = held_rows(rows)
    if keep is None:
        return made
    params = list(inspect.signature(SHARDED_KERNELS[name][1]).parameters)

    def cut(param, value):
        tensors = [t for t in tree_leaves(value) if torch.is_tensor(t)]
        if param in LANE_PARAMS[name] or param == "result":
            check(all(t.dim() and t.shape[0] == rows for t in tensors),
                  f"{name}: every tensor of {param} has the call's {rows} rows first")
            return map_tree(lambda t: t[keep.to(t.device)], value)
        check(not tensors, f"{name}: {param}, not a per-lane parameter, holds no tensor")
        return value

    def cut_kwargs(k):
        return {p: cut(p, v) for p, v in k.items()}

    return ((tuple(cut(p, v) for p, v in zip(params, args)), cut_kwargs(kwargs)),
            (cut("result", out), cut_kwargs(kw_after)))


def replay_error(name: str, inputs, want, on: str) -> float:
    """max |error| of kernel ``name``'s plain version on ``on``, given a
    recorded call's (args, kwargs), against the recorded (result, kwargs)."""
    args, kwargs = map_tree(lambda t: t.to(on, copy=True), inputs)
    return tree_err((SHARDED_KERNELS[name][1](*args, **kwargs), kwargs), want)


def replay_saved(path: str) -> None:
    """The CPU replays that ``replay_recorded_calls`` saved to ``path``, as
    one ``REPLAYED <json>`` line: [kernel, cases, max |error|, seconds]."""
    torch.set_num_threads(1)
    done = []
    for name, cases, inputs, want in torch.load(path, weights_only=False):
        t0 = time.perf_counter()
        done.append((name, cases, replay_error(name, inputs, want, "cpu"),
                     time.perf_counter() - t0))
    print("REPLAYED " + json.dumps(done), flush=True)


def replay_recorded_calls(calls: dict, line: str):
    """Each kernel's recorded first and last launch of every case against its
    plain version on the same inputs: of the DFPWM kernels' calls five
    thread blocks spread over the grid (``held_rows``), the calls of one
    signature stacked by rows into one plain call; every other call
    replayed alone, whole. A replay of CARD_REPLAY_ROWS rows or more runs
    here on the card; a narrower one on the CPU (the plain loops take a
    Python step a sample whatever the rows), in a process of its own
    (``replay_saved``, no card visible) that goes on while the caller does
    other work. -> ``finish()``: waits for that process, prints one
    ``[line]`` line a kernel, checks every replay exact -> max |error| by
    kernel."""
    by_kernel: dict = {}
    for key, made in calls.items():
        if len(key) == 2:
            by_kernel.setdefault(key[0], []).extend((key[1], m) for m in made)
    done, saved, stats = [], [], {}
    for name, items in by_kernel.items():
        if name in STACKED_REPLAYS:
            items = [(case, held_call(name, m)) for case, m in items]
            groups: dict = {}
            for case, m in items:
                groups.setdefault(tree_signature(m[0]), []).append((case, m))
            batches = list(groups.values())
        else:
            batches = [[item] for item in items]
        rows = []
        for batch in batches:
            inputs, want = batch[0][1] if len(batch) == 1 else (
                stack_trees([m[k] for _, m in batch]) for k in (0, 1))
            rows.append(max((t.shape[0] for t in tree_leaves(inputs)
                             if torch.is_tensor(t) and t.dim()), default=0))
            cases = sorted({c for c, _ in batch})
            if rows[-1] >= CARD_REPLAY_ROWS:
                t0 = sync_time()
                done.append((name, cases, replay_error(name, inputs, want, CARD),
                             sync_time() - t0))
            else:
                saved.append((name, cases, *map_tree(lambda t: t.cpu(), (inputs, want))))
        stats[name] = (len(items), len(batches), max(rows),
                       sum(r >= CARD_REPLAY_ROWS for r in rows),
                       sorted({c for c, _ in items}))
    path = os.path.join(tempfile.mkdtemp(), "replays.pt")
    torch.save(saved, path)
    log = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c",
                             "import sys, chip_smoke; chip_smoke.replay_saved(sys.argv[1])", path],
                            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    atexit.register(stop, proc)

    def finish() -> dict:
        t0 = time.perf_counter()
        try:
            proc.wait(timeout=REPLAY_TIMEOUT)
            log.seek(0)
            text = log.read()
        finally:
            stop(proc)
            log.close()
            os.remove(path)
            os.rmdir(os.path.dirname(path))
        check(proc.returncode == 0 and "REPLAYED " in text,
              f"the CPU replays ran ({proc.returncode}):\n{text[-3000:]}")
        replayed = json.loads(text.split("REPLAYED ", 1)[1].splitlines()[0])
        check(len(replayed) == len(saved), "every CPU replay ran")
        errs = {}
        for name, (n_calls, n_plain, widest, on_card, cases) in stats.items():
            mine = [r for r in done + replayed if r[0] == name]
            for _, batch_cases, e, _ in mine:
                check(e == 0, f"{name}: kernel == plain on the recorded calls {batch_cases} ({e})")
            errs[name] = max(e for _, _, e, _ in mine)
            say(line, kernel=name, calls=n_calls, plain_calls=n_plain, widest_rows=widest,
                on_card=on_card, cases=json.dumps(cases), max_abs_err=errs[name],
                plain_seconds=round(sum(s for _, _, _, s in mine), 3))
        say(f"{line}_process", waited_seconds=round(time.perf_counter() - t0, 3))
        return errs

    return finish


def sharded_vs_plain_full(label: str, mesh, host: np.ndarray, launches: dict,
                          calls: dict) -> dict:
    """The sharded 32768-lane DFPWM engine and the unsharded one over the same
    bulk-fed bytes, stepped in turns, each step timed to a synchronise;
    every window, mask and position equal. The sharded steps also record
    CUDA events around each shard's device step and around the gather. The
    first step of each engine is not timed: it pays the lazy loads of a
    process's first launches, and its sharded launches are recorded into
    ``calls`` under ``label`` (the first shard's and the last's)."""
    sharded = BatchDfpwmDecoder(FULL_LANES, 48000, chunk_bytes=6000, mesh=mesh)
    plain = BatchDfpwmDecoder(FULL_LANES, 48000, chunk_bytes=6000)
    sharded.feed_array(host)
    plain.feed_array(host)
    spans = {"shard": [], "gather": []}
    step_fn, gather_fn = sb._Group._step, sb.gather_rows

    def timed_step(self, sh, *a, **k):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        out = step_fn(self, sh, *a, **k)
        e[1].record()
        spans["shard"].append(e)
        return out

    def timed_gather(*a, **k):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        out = gather_fn(*a, **k)
        e[1].record()
        spans["gather"].append(e)
        return out

    t_sharded = t_plain = 0.0
    steps = 0
    while True:
        sb._Group._step, sb.gather_rows = timed_step, timed_gather
        try:
            t0 = sync_time()
            r = meshed_run(launches, sharded.step, calls if steps == 0 else None, label)
            t1 = sync_time()
        finally:
            sb._Group._step, sb.gather_rows = step_fn, gather_fn
        p = plain.step()
        t2 = sync_time()
        if r is None or p is None:
            check(r is None and p is None, f"{label}: both engines end together")
            break
        if steps:
            t_sharded, t_plain = t_sharded + t1 - t0, t_plain + t2 - t1
        check(torch.equal(r[0], p[0]) and np.array_equal(r[1], p[1])
              and np.array_equal(r[2], p[2]), f"{label}: step {steps} sharded == unsharded")
        steps += 1
    check(steps == MULTI_SECONDS, f"{label}: {MULTI_SECONDS} steps")
    audio = sharded.metrics.samples_decoded / 48000 * (steps - 1) / steps
    shard_ms = [a.elapsed_time(b) for a, b in spans["shard"][mesh.size:]]
    gather_ms = [a.elapsed_time(b) for a, b in spans["gather"][1:]]
    row = {"mesh": label, "shards": mesh.size, "devices": len({str(d) for d in mesh.devices.flat}),
           "lanes": FULL_LANES, "steps": steps, "equal": True,
           "realtime_factor_sharded": round(audio / t_sharded, 1),
           "realtime_factor_unsharded": round(audio / t_plain, 1),
           "timed_steps": steps - 1,
           "step_ms_sharded": round(t_sharded / (steps - 1) * 1e3, 3),
           "step_ms_unsharded": round(t_plain / (steps - 1) * 1e3, 3),
           "shard_step_ms_mean": round(float(np.mean(shard_ms)), 4),
           "shard_step_ms_max": round(float(np.max(shard_ms)), 4),
           "gather_ms_mean": round(float(np.mean(gather_ms)), 4)}
    say("multi_gpu_main_path", **row)
    return row


def sharded_vs_plain(name: str, make, run, launches: dict, calls: dict) -> None:
    """``run(make(mesh))`` over make_mesh(MULTI_SHARDS) (its launches counted
    and recorded into ``calls`` under ``name``) equals ``run(make(None))``,
    both on the card (``deep_equal``)."""
    mesh = make_mesh(MULTI_SHARDS)
    got = meshed_run(launches, lambda: run(make(mesh)), calls, name)
    want = run(make(None))
    check(deep_equal(got, want), f"{name}: sharded == unsharded on the card")
    say("multi_gpu_engine", case=name, shards=MULTI_SHARDS, equal=True)


def engine_steps(eng, feeds, volumes=()):
    """Per-lane feeds through ``drive``: every step's (windows, mask,
    positions) on the host and every lane's final checkpoint."""
    steps = [(r[0].cpu().numpy(), r[1].copy(), r[2].copy()) for r in drive(eng, feeds, volumes)]
    return steps, [eng.checkpoint(i) for i in range(eng.lanes)]


def multihost_reference(rng_seed: int = 7):
    """The single-process 32768-lane card engine over the two workers' fleet
    (tests/torch_dist_worker.py draws it from ``default_rng(7)``) and the
    unsharded flagship step over their pipeline batch -> ({pid: pipeline
    SHA-256}, {pid: [each step's SHA-256]})."""
    rng = np.random.default_rng(rng_seed)
    lanes = 2 * MULTIHOST_LANES
    pipe = torch.tensor(rng.integers(0, 256, (lanes, 96), dtype=np.uint8), device=CARD)
    out, _ = sp.decode_pipeline_scan(pipe, DfpwmState.zeros(lanes, CARD), 48000, 0.9)
    out = out.cpu().numpy()
    feed = rng.integers(0, 256, (lanes, 6000 * MULTIHOST_SECONDS), dtype=np.uint8)
    eng = BatchStreamEngine([LaneSpec("dfpwm", 48000, chunk_bytes=6000)] * lanes, device=CARD)
    for i in range(lanes):
        eng.feed(i, feed[i].tobytes())
        eng.feed(i, None)
    pipes, steps = {}, {0: [], 1: []}
    for pid in (0, 1):
        lo = pid * MULTIHOST_LANES
        pipes[pid] = hashlib.sha256(out[lo: lo + MULTIHOST_LANES].tobytes()).hexdigest()
    for chunk, mask, pos in iter(eng.step, None):
        chunk = chunk.cpu().numpy()
        for pid in (0, 1):
            lo, hi = pid * MULTIHOST_LANES, (pid + 1) * MULTIHOST_LANES
            steps[pid].append(hashlib.sha256(chunk[lo:hi].tobytes() + mask[lo:hi].tobytes()
                                             + pos[lo:hi].tobytes()).hexdigest())
    return pipes, steps


def phase_multihost(launches: dict) -> None:
    """MultiHostEngine and multihost_pipeline_step in two processes on this
    card, a gloo group on a free localhost port, MULTIHOST_LANES lanes a
    process in two shards each, MULTIHOST_SECONDS a lane: each worker's
    per-step SHA-256 of its rows, masks and positions, and of its pipeline
    rows, against the single-process card runs; the workers' kernel launches
    are added to ``launches``. Both workers are killed if they outlive
    MULTIHOST_TIMEOUT."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    worker = str(ROOT / "tests" / "torch_dist_worker.py")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, worker, str(pid), port, CARD,
                               str(MULTIHOST_LANES), str(6000 * MULTIHOST_SECONDS), "6000", "2",
                               "-"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    try:
        pipes, steps = multihost_reference()
        logs = [p.communicate(timeout=MULTIHOST_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    for pid, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0 and f"DIST_ENGINE_OK {pid} {MULTIHOST_SECONDS}" in log,
              f"multihost worker {pid} ran ({p.returncode}):\n{log[-3000:]}")
        check(f"DIST_PIPE {pid} {pipes[pid]}" in log,
              f"multihost worker {pid}: pipeline rows == the unsharded card step")
        for k, digest in enumerate(steps[pid]):
            check(f"DIST_STEP {pid} {k} {digest}" in log,
                  f"multihost worker {pid}: step {k} == the single-process card engine")
        got = json.loads(log.split(f"DIST_LAUNCHES {pid} ", 1)[1].splitlines()[0])
        accumulate(launches, {k.removesuffix("_kernel"): v for k, v in got.items()})
    say("multi_gpu_multihost", processes=2, lanes_per_process=MULTIHOST_LANES,
        shards_per_process=2, seconds_per_lane=MULTIHOST_SECONDS, steps=len(steps[0]),
        equal=True, wall_seconds=round(seconds, 3))


@phase
def phase_multi_gpu() -> tuple[dict, dict]:
    """The multi-device layer on the card. The sharded main path: a
    32768-lane identity-rate DFPWM engine (MULTI_SECONDS a lane, bulk-fed)
    over make_mesh(MULTI_SHARDS) (four shards on one card), and over
    make_mesh() when the machine has two cards or more, each step equal to
    the unsharded card engine's, both realtime factors, a shard's device
    step and the gather by CUDA events. ``sharded_pipeline_step`` at 32768 x
    6000 bytes against the unsharded ``decode_pipeline_scan(normalize_peak=
    0.9)``. Check-size sharded engines, each equal to its unsharded card
    run: a mixed 48/32 kHz DFPWM fleet, a block fleet whose groups divide no
    shard count, a transcode of a sharded decode engine into a sharded
    encode engine, the FLAC fleet on its host and device routes, and the
    Fleet facade over six kinds of station. Every sharded launch of these
    runs goes through a recorder, and each kernel's first and last launch of
    each run are held to its plain version on the same inputs (the DFPWM
    kernels' on five thread blocks spread over each call:
    ``replay_recorded_calls``; the CPU replays go on alongside
    MultiHostEngine in two processes, ``phase_multihost``). Returns (the launches of every sharded run, each
    run's counts zeroed just before and read just after; max |error| of
    each kernel against its plain version at the sharded shapes)."""
    launches: dict = {}
    calls: dict = {}
    rng = np.random.default_rng(71)
    host = rng.integers(0, 256, (FULL_LANES, 6000 * MULTI_SECONDS), dtype=np.uint8)
    meshes = [(f"make_mesh({MULTI_SHARDS})", make_mesh(MULTI_SHARDS))]
    if torch.cuda.device_count() >= 2:
        meshes.append(("make_mesh()", make_mesh()))
    else:
        say("multi_gpu_main_path", mesh="make_mesh()", skipped="one card: make_mesh() is one shard")
    main_launches: dict = {}
    for label, mesh in meshes:
        sharded_vs_plain_full(label, mesh, host, main_launches, calls)
    del host
    check(main_launches.get("dfpwm_decode_dsp", 0) == MULTI_SECONDS * sum(m.size for _, m in meshes),
          f"kernel (b) launched once a shard a step ({main_launches})")
    accumulate(launches, main_launches)
    torch.cuda.empty_cache()

    mesh = make_mesh(MULTI_SHARDS)
    fn, args = sp.sharded_pipeline_step(mesh, FULL_LANES, 6000)
    whole = torch.cat(args[0]), DfpwmState(*(torch.cat(a) for a in args[1:]))
    t_sharded = t_plain = 0.0
    for k in range(2):  # the second run of each is timed: the first pays lazy loads
        t0 = sync_time()
        out = meshed_run(launches, lambda: fn(*args), calls if k == 0 else None, "pipeline_step")
        t_sharded = sync_time() - t0
        ref, st = sp.decode_pipeline_scan(*whole, 48000, 0.9)
        t_plain = sync_time() - t0 - t_sharded
    ok = torch.equal(torch.cat(out[0]), ref) and all(
        torch.equal(torch.cat(a), b) for a, b in zip(out[1:], st.leaves()))
    say("multi_gpu_pipeline_step", shards=MULTI_SHARDS, lanes=FULL_LANES, bytes=6000,
        equal=ok, ms_sharded=round(t_sharded * 1e3, 3), ms_unsharded=round(t_plain * 1e3, 3))
    check(ok, "sharded_pipeline_step == decode_pipeline_scan(normalize_peak=0.9) on the card")
    del out, ref, st, args, whole
    torch.cuda.empty_cache()

    n = MULTI_CHECK_LANES
    feeds = [rng.integers(0, 256, int(rng.integers(9000, 13000)), dtype=np.uint8).tobytes()
             for _ in range(n)]
    vols = [(1, 0.5, True), (n - 1, 1.3, False)]
    sharded_vs_plain(
        "mixed_48k_32k",
        lambda m: BatchStreamEngine([LaneSpec("dfpwm", 48000 if i % 2 else 32000)
                                     for i in range(n)], m),
        lambda eng: engine_steps(eng, feeds, vols), launches, calls)
    block_lanes = (7, 5, 3, 6, 5)
    groups = [block_fleet_bytes(rng, spec, k, 2)[0] for spec, k in zip(BLOCK_FLEET, block_lanes)]
    block_specs = [spec for spec, k in zip(BLOCK_FLEET, block_lanes) for _ in range(k)]
    block_feeds = [row.tobytes() for g in groups for row in g]
    block_vols = [(1, 0.5, True), (len(block_specs) - 1, 1.3, False)]
    sharded_vs_plain("block_fleet", lambda m: BatchStreamEngine(block_specs, m),
                     lambda eng: engine_steps(eng, block_feeds, block_vols), launches, calls)
    pcm = [(np.sin(np.arange(96000) / (5.0 + i % 9)) * (6000 + 300 * i)).astype("<i2").tobytes()
           for i in range(10)]

    def transcode(engines):
        dec, enc = engines
        for lane, data in enumerate(pcm):
            dec.feed(lane, data)
            dec.feed(lane, None)
        enc.set_volume(2, 0.8, ramp=True)
        return transcode_fleet(dec, enc)

    sharded_vs_plain(
        "transcode",
        lambda m: (BatchStreamEngine([LaneSpec("pcm16", 48000)] * 10, m, windowed=True),
                   BatchEncodeEngine([EncodeSpec("dfpwm")] * 5 + [EncodeSpec("pcm16")] * 5,
                                     48000, m)),
        transcode, launches, calls)
    fx = load_fixtures()
    streams = flac_check_streams(fx, FLAC_CHECK_LANES)[:FLAC_CHECK_LANES - 2]
    for route, kw in (("flac_host_route", {}),
                      ("flac_device_route", {"device_restore": True, "device_dsp": True})):
        sharded_vs_plain(route, lambda m, kw=kw: FlacFleet(len(streams), mesh=m, **kw),
                         lambda fleet: run_flac(fleet, streams, 1 << 16, [(1, 0.5), (6, 1.4)]),
                         launches, calls)
    sources = fleet_check_sources(fx, np.random.default_rng(51))
    sharded_vs_plain("fleet", lambda m: Fleet(sources, mesh=m, mono=False, channels=2,
                                              device_restore=True, device_dsp=True),
                     drive_fleet_check, launches, calls)
    finish = replay_recorded_calls(calls, "multi_gpu_kernel")
    del calls
    torch.cuda.empty_cache()
    phase_multihost(launches)
    errs = finish()
    ran = ("dfpwm_decode", "dfpwm_decode_dsp", "dfpwm_encode", "ima_decode", "msadpcm_decode",
           "qoa_lms", "lpc_restore", "iir_zero", "fma")
    say("multi_gpu_launches", **launches)
    check(all(launches.get(k, 0) > 0 for k in ran),
          f"every kernel ran on the sharded paths ({launches})")
    check(sorted(errs) == sorted(ran), f"every kernel held to its plain version ({sorted(errs)})")
    return launches, errs


# -- the example servers ----------------------------------------------------------------

EXAMPLES = {"batch_server": batch_server, "flac_radio_fleet": flac_radio_fleet,
            "mixed_fleet_server": mixed_fleet_server}
# the fleet widths (8192 lanes, FLAC_LANES and FLEET_STATIONS stations) are
# halved: at full width the phase took 260 s, against its budget of ~90 s
EXAMPLE_WIDTH_CUT = 2
# each example's arguments at the cut width, and at the check size that the
# CPU runs too: batch_server's 2 s give each lane two 6000-byte chunks, so
# the check crosses ticks with starved, carried and recycled lanes (the
# plain DFPWM encode and decode loops cost ~100 us a step on the CPU, the
# decode 48000 steps a tick whatever the stream's length)
EXAMPLE_ARGS = {"batch_server": ((8192 // EXAMPLE_WIDTH_CUT, 2.0), (8, 2.0)),
                "flac_radio_fleet": ((FLAC_LANES // EXAMPLE_WIDTH_CUT, 6), (8, 6)),
                "mixed_fleet_server": ((FLEET_STATIONS // EXAMPLE_WIDTH_CUT, 3, 1), (9, 1, 1))}
# the check-size runs: flac_radio_fleet at the field's default and at 0
EXAMPLE_CHECKS = (("batch_server", None), ("flac_radio_fleet", None), ("flac_radio_fleet", 0),
                  ("mixed_fleet_server", None))
EXAMPLE_CPU_TIMEOUT = 600  # the CPU runs of the check sizes, in their own process
EXAMPLE_TIMES = ("wall_seconds", "realtime_factor")
EXAMPLE_KERNELS = ("dfpwm_decode_dsp", "dfpwm_encode", "ima_decode", "lpc_restore", "fma")


def window_keeper():
    """(``on_window`` for an example's ``main()``, ``digest()``): the first
    keeps each tick's step result (tensors cloned on their device, host
    arrays copied); the second gives the SHA-256 of every window, mask and
    position kept, so the hashing stays out of the example's wall time."""
    kept = []

    def on_window(*result):
        kept.append(tuple(a.clone() if torch.is_tensor(a) else np.array(a) for a in result))

    def digest() -> str:
        sha = hashlib.sha256()
        for result in kept:
            for a in result:
                sha.update(np.ascontiguousarray(a.cpu().numpy() if torch.is_tensor(a) else a)
                           .tobytes())
        return sha.hexdigest()

    return on_window, digest


def run_example(name: str, args, device: str = "cuda", windows: bool = False,
                restore_min: int | None = None) -> dict:
    """``main(*args)`` of an example on ``device``, its printed lines kept out
    of this script's output, with ``CONFIG.flac_device_restore_min`` at
    ``restore_min`` for the run (at its default when None) -> its summary;
    with ``windows``, ``windows_sha256`` (``window_keeper``) too."""
    saved = tk.CONFIG.flac_device_restore_min
    if restore_min is not None:
        tk.CONFIG.flac_device_restore_min = restore_min
    on_window, digest = window_keeper() if windows else (None, None)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = EXAMPLES[name].main(*args, device=device, on_window=on_window)
    finally:
        tk.CONFIG.flac_device_restore_min = saved
    if windows:
        out["windows_sha256"] = digest()
    return out


def untimed(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in EXAMPLE_TIMES}


def example_checks(device: str) -> list:
    """Each EXAMPLE_CHECKS run at its check size on ``device`` -> [(name,
    restore_min, untimed summary with windows_sha256, seconds)]."""
    done = []
    for name, restore_min in EXAMPLE_CHECKS:
        t0 = time.perf_counter()
        out = run_example(name, EXAMPLE_ARGS[name][1], device, True, restore_min)
        done.append((name, restore_min, untimed(out), time.perf_counter() - t0))
    return done


def cpu_example_checks() -> None:
    """``example_checks("cpu")`` as one ``EXAMPLES_CPU <json>`` line; run by
    ``phase_examples`` in a process of its own with no card visible."""
    torch.set_num_threads(1)
    print("EXAMPLES_CPU " + json.dumps(example_checks("cpu")), flush=True)


def example_full_width(case: str, name: str, launches: dict, calls: dict, **kw) -> dict:
    """One example at its (cut) fleet width on the card, every launch recorded into
    ``calls`` under ``case``, its launch counts zeroed just before and read
    just after (added to ``launches``); one ``[examples]`` line: the seconds
    of the whole run and of its serving loop, the realtime factor, the
    launches and the peak device memory."""
    args = EXAMPLE_ARGS[name][0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts: dict = {}
    t0 = sync_time()
    out = meshed_run(counts, lambda: run_example(name, args, **kw), calls, case)
    seconds = sync_time() - t0
    accumulate(launches, counts)
    say("examples", case=case, args=json.dumps(args), seconds=round(seconds, 3),
        serving_seconds=round(out["wall_seconds"], 4),
        realtime_factor=round(out["realtime_factor"], 1), ticks=out["ticks"],
        samples_decoded=out["samples_decoded"], launches=json.dumps({k: v for k, v in counts.items() if v}),
        max_memory_allocated_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    return out


def start_cpu_example_checks() -> tuple:
    """``cpu_example_checks`` in a process of its own with no card visible,
    started early so that its plain loops (~140 s, batch_server's 8 lanes x
    2 s the most) run alongside the card phases -> (the process, its
    output file) for ``phase_examples``. The process is stopped at exit."""
    log = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c",
                             "import chip_smoke; chip_smoke.cpu_example_checks()"],
                            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    atexit.register(stop, proc)
    return proc, log


@phase
def phase_examples(cpu_checks: tuple) -> tuple[dict, object]:
    """The three example servers of ``aukit_tpu_torch.examples`` as a user
    runs them (``main()``, the card by default), at fleet width halved
    (EXAMPLE_WIDTH_CUT): batch_server at 4096 lanes x 2 s (kernel (c)
    encodes each client's tone, (b) decodes every tick), flac_radio_fleet at
    1024 stations x 6 s (the host restore at the field's default),
    mixed_fleet_server at 1536 stations x 3 s with one rotation of every
    station onto a fresh source ((b), (d), the FMA; FLAC on the host
    restore). Every launch of these runs goes through the recorder, and
    each kernel's first and last launch is replayed through its plain
    version (``[examples_kernel]``, printed by ``phase_examples_replays``
    once the CPU replays, which go on alongside the phases after this one,
    are done). Each example at its check size on the
    card equals its CPU run, time fields masked and a SHA-256 of every
    window compared (``[examples_check]``; the CPU runs come from the
    process of ``start_cpu_example_checks``). ``[examples_flac_route]``:
    flac_radio_fleet at that width again with ``flac_device_restore_min =
    0`` (kernel (g)), its summary and windows equal to the host restore's,
    each run's serving seconds, (g)'s launches and the range of a step's
    restore batch (subframes x largest block). -> (the launches of the
    fleet-width runs; the replays' ``finish``)."""
    cpu, log = cpu_checks
    try:
        launches, finish = examples_on_card()
        card = example_checks("cuda")
        t0 = time.perf_counter()
        cpu.wait(timeout=EXAMPLE_CPU_TIMEOUT)
        waited = time.perf_counter() - t0
        log.seek(0)
        text = log.read()
    finally:
        stop(cpu)
        log.close()
    check(cpu.returncode == 0 and "EXAMPLES_CPU " in text,
          f"the CPU runs of the check sizes ran ({cpu.returncode}):\n{text[-3000:]}")
    cpu_runs = json.loads(text.split("EXAMPLES_CPU ", 1)[1].splitlines()[0])
    check([tuple(r[:2]) for r in cpu_runs] == [r[:2] for r in card],
          "every check size ran on the card and on the CPU")
    for (name, restore_min, on_card, card_s), (_, _, on_cpu, cpu_s) in zip(card, cpu_runs):
        # through JSON, as the CPU runs came: tuples as lists
        same_run = json.loads(json.dumps(on_card)) == on_cpu
        say("examples_check", example=name, args=json.dumps(EXAMPLE_ARGS[name][1]),
            flac_device_restore_min=restore_min, equal=same_run, ticks=on_card["ticks"],
            live=json.dumps(on_card["live"]), card_seconds=round(card_s, 3),
            cpu_seconds=round(cpu_s, 3))
        check(same_run, f"{name}{EXAMPLE_ARGS[name][1]}: card run == CPU run")
    say("examples_cpu_process", waited_seconds=round(waited, 3))
    say("examples_launches", **launches)
    check(all(launches.get(k, 0) > 0 for k in EXAMPLE_KERNELS),
          f"kernels (b), (c), (d), (g) and the FMA ran in the examples ({launches})")
    return launches, finish


@phase
def phase_examples_replays(finish) -> dict:
    """The end of ``[examples]``' replays (``replay_recorded_calls``), whose
    CPU part went on alongside the phases since -> max |error| by kernel."""
    errs = finish()
    check(sorted(errs) == sorted(EXAMPLE_KERNELS),
          f"every kernel held to its plain version ({sorted(errs)})")
    return errs


def examples_on_card() -> tuple[dict, object]:
    """The fleet-width runs of ``phase_examples`` and the FLAC route line;
    the replays of their recorded launches started -> (launches, the
    replays' ``finish``)."""
    launches: dict = {}
    calls: dict = {}
    example_full_width("batch_server", "batch_server", launches, calls)
    example_full_width("mixed_fleet_server", "mixed_fleet_server", launches, calls)
    batches: list = []
    restore = ff.flac_codec.restore_flat

    def sized(sub, *args, **kwargs):
        if len(sub["order"]):
            batches.append(len(sub["order"]) * int(sub["block"].max()))
        return restore(sub, *args, **kwargs)

    route = {}
    ff.flac_codec.restore_flat = sized
    try:
        for label, restore_min in (("host", None), ("kernel_g", 0)):
            batches.clear()
            g0 = launches.get("lpc_restore", 0)
            out = example_full_width(f"flac_radio_fleet_{label}", "flac_radio_fleet", launches,
                                     calls, windows=True, restore_min=restore_min)
            route[label] = (out, launches.get("lpc_restore", 0) - g0, list(batches))
    finally:
        ff.flac_codec.restore_flat = restore
    (host, host_g, host_sizes), (dev, dev_g, dev_sizes) = route["host"], route["kernel_g"]
    equal = untimed(host) == untimed(dev)
    say("examples_flac_route", stations=EXAMPLE_ARGS["flac_radio_fleet"][0][0], equal=equal,
        host_serving_seconds=round(host["wall_seconds"], 4), host_lpc_launches=host_g,
        kernel_g_serving_seconds=round(dev["wall_seconds"], 4), kernel_g_lpc_launches=dev_g,
        restores=len(dev_sizes), restore_batch_min=min(dev_sizes),
        restore_batch_max=max(dev_sizes))
    check(equal, "flac_radio_fleet: kernel (g)'s route == the host restore (summary and windows)")
    check(host_g == 0 and dev_g == len(dev_sizes) == len(host_sizes),
          f"the host route launches no (g), the field at 0 one a step ({host_g}, {dev_g})")
    finish = replay_recorded_calls(calls, "examples_kernel")
    del calls
    torch.cuda.empty_cache()
    return launches, finish


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    cpu_checks = start_cpu_example_checks()
    phase_golden()
    errs = phase_kernel_vs_plain()
    path_errs = phase_redesigned_kernel_paths()
    errs.update(phase_block_kernel_vs_plain())
    tones_u8, levels, encode_plain_ms = encoded_tones(FULL_LANES, 1.0, seed=3)
    say("encode", lanes=FULL_LANES, bytes=tones_u8.shape[1], plain_ms=round(encode_plain_ms, 2))
    main_errs, times = phase_kernel_vs_plain_main_shapes(tones_u8)
    for name, err in main_errs.items():
        errs[name] = max(errs[name], err)
    errs["dfpwm_encode"] = phase_encode_kernel_vs_plain(tones_u8, levels)
    phase_engines(tones_u8)
    launches = phase_main_path(tones_u8, levels)
    del levels
    torch.cuda.empty_cache()
    phase_step_breakdown(tones_u8)
    phase_mixed_step_breakdown(tones_u8)
    del tones_u8
    torch.cuda.empty_cache()
    specs, groups = block_fleet_data()
    block_launches, block_errs = phase_block_fleet(specs, groups)
    for name, err in block_errs.items():
        errs[name] = max(errs.get(name, 0), err)
    torch.cuda.empty_cache()
    phase_block_step_breakdown(specs, groups)
    del specs, groups
    phase_block_engines()
    phase_encode_engines()
    transcode_launches = phase_transcode()
    fx = load_fixtures()
    for name, err in [*phase_flac_kernel_vs_plain().items(), *path_errs.items()]:
        errs[name] = max(errs.get(name, 0), err)
    phase_flac_engines(fx)
    t0 = time.perf_counter()
    flac_streams = flac_main_streams(fx)
    say("flac_fleet_bytes", lanes=FLAC_LANES, distinct_streams=len({id(s) for s in flac_streams}),
        bytes=sum(map(len, flac_streams)), build_seconds=round(time.perf_counter() - t0, 3))
    flac_launches = phase_flac_fleet(flac_streams)
    for name, err in phase_flac_step_breakdown(flac_streams).items():
        errs[name] = max(errs[name], err)
    del flac_streams
    phase_flac_transcode(fx)
    times["flac_dsp_f64"], errs["flac_dsp_f64"], dsp_launches = phase_flac_f64_dsp()
    phase_engine_dsp()
    auplay_launches, auplay_fma_err = phase_auplay_main_path()
    errs["fma"] = max(errs["fma"], auplay_fma_err)
    path_launches = [auplay_launches]
    phase_auplay_step_breakdown()
    phase_fleet_check()
    path_launches.append(phase_fleet_main_path())
    example_launches, example_replays = phase_examples(cpu_checks)
    path_launches.append(example_launches)
    whole_launches, whole_fma_err = phase_whole_file()
    path_launches.append(whole_launches)
    for name, err in whole_file_kernel_shapes().items():
        errs[name] = max(errs.get(name, 0), err)
    effects_launches, effects_fma_err = phase_effects_chain()
    path_launches.append(effects_launches)
    errs["fma"] = max(errs["fma"], whole_fma_err, effects_fma_err)
    stream_launches, stream_errs = phase_stream_iterators()
    path_launches.append(stream_launches)
    for name, err in stream_errs.items():
        key = {"ima_decode": "ima", "msadpcm_decode": "msadpcm", "qoa_lms": "qoa"}.get(name, name)
        errs[key] = max(errs.get(key, 0), err)
    path_launches.append(phase_cli())
    for name, err in phase_examples_replays(example_replays).items():
        key = {"ima_decode": "ima"}.get(name, name)
        errs[key] = max(errs.get(key, 0), err)
    multi_launches, multi_errs = phase_multi_gpu()
    path_launches.append(multi_launches)
    for name, err in multi_errs.items():
        key = {"ima_decode": "ima", "msadpcm_decode": "msadpcm", "qoa_lms": "qoa"}.get(name, name)
        errs[key] = max(errs.get(key, 0), err)
    phase_times()
    times.update(phase_encode_time(encode_plain_ms))
    times.update(phase_block_times())
    times.update(phase_flac_times())
    rows = (("dfpwm_decode", "dfpwm_decode", "dfpwm.cu", "aukit_tpu/kernels/dfpwm_pallas.py:113",
             launches),
            ("dfpwm_decode_dsp", "dfpwm_decode_dsp", "dfpwm.cu",
             "aukit_tpu/kernels/dfpwm_pallas.py:237", launches),
            ("dfpwm_encode", "dfpwm_encode", "dfpwm.cu", "aukit_tpu/kernels/dfpwm_pallas.py:348",
             transcode_launches),
            ("ima_decode", "ima", "adpcm.cu", "aukit_tpu/kernels/ima_pallas.py:94", block_launches),
            ("msadpcm_decode", "msadpcm", "adpcm.cu", "aukit_tpu/kernels/msadpcm_pallas.py:104",
             block_launches),
            ("qoa_lms", "qoa", "qoa.cu", "aukit_tpu/kernels/qoa_pallas.py:105", block_launches),
            ("lpc_restore", "lpc_restore", "flac.cu", "aukit_tpu/kernels/flac_pallas.py:131",
             flac_launches),
            ("iir_zero", "iir_zero", "iir.cu", "aukit_tpu/kernels/iir_pallas.py:62",
             flac_launches),
            # no Pallas kernel: XLA's fused multiply-add in the jitted dsp_chain
            ("fma", "fma", "fma.cu", "aukit_tpu/parallel/pipeline.py:97", block_launches),
            # no TPU kernel: the FLAC fleet's numpy host DSP
            ("flac_dsp_f64", "flac_dsp_f64", "flac_dsp.cu",
             "aukit_tpu/stream/flac_fleet.py _host_dsp (numpy)", dsp_launches))
    say("phase_seconds", **PHASE_SECONDS)
    say("total", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"aukit_tpu_torch/csrc/{src}",
         "replaces": replaces, "max_abs_err": errs[key], **times[key],
         "launches": counts[name] + sum(c.get(name, 0) for c in path_launches)}
        for name, key, src, replaces, counts in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
