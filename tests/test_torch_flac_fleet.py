"""The port's FlacFleet against the JAX package's FlacFleet on the same
bytes, on the CPU.

Host route (the default): every window, mask and position of every step,
the metrics and the checkpoints must be identical — mixed formats and every
stereo mode, drip sizes, a poisoned and a starved lane, volume ramps,
``mono=False``, interpolation modes, and checkpoints restored across the two
packages in both directions.

Device routes (``device="cpu"``: the plain versions of kernels (g) and (h))
against the JAX device routes with the Pallas kernels in interpret mode
(``_block_iir = "interpret"``): the integer stages bit-equal, the windows
bit-equal except where noted, and within the reference's 5e-3 of the host
route. The JAX runs are computed once per module.
"""

import numpy as np
import pytest
import torch

from aukit_tpu.stream import flac_fleet as jax_ff
from aukit_tpu.stream.flac_fleet import FlacFleet as JaxFleet
from aukit_tpu_torch import kernels
from aukit_tpu_torch.codecs import flac
from aukit_tpu_torch.kernels.flac_cuda import lpc_restore_kernel, order_bucket
from aukit_tpu_torch.stream import flac_fleet as ff
from aukit_tpu_torch.stream.flac_fleet import FlacFleet
from portbench.inputs import cd_stations
from tests import fixtures
from tests.test_flac_fleet import make_flac
from tests.torch_kernel_cases import flac_dsp_cases

FLAC_DSP_CASES = [c[0] for c in flac_dsp_cases("cpu")]


def port_fleet(lanes, **kw):
    return FlacFleet(lanes, device="cpu", **kw)


def drive(fleet, datas, chunk=4096, volumes=(), max_steps=None):
    """Drip-feed ``chunk`` bytes per lane per step (EOF after the last) and
    collect every step's (window, mask, positions)."""
    for lane, vol, ramp in volumes:
        fleet.set_volume(lane, vol, ramp=ramp)
    offs = [0] * len(datas)
    eof = [d is None for d in datas]  # a None lane is not fed at all
    fed = np.array([d is not None for d in datas])
    steps = []
    while fleet.active[fed].any() and (max_steps is None or len(steps) < max_steps):
        for i, d in enumerate(datas):
            if eof[i]:
                continue
            if offs[i] < len(d):
                fleet.feed(i, d[offs[i]: offs[i] + chunk])
                offs[i] += chunk
            elif max_steps is None:  # a run cut at max_steps never ends its lanes
                fleet.feed(i, None)
                eof[i] = True
        steps.append(fleet.step())
        assert len(steps) < 5000
    return steps


def assert_steps_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


def assert_checkpoints_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def run_both(datas, chunk=4096, volumes=(), **kw):
    runs = []
    for fleet in (port_fleet(len(datas), **kw), JaxFleet(len(datas), **kw)):
        steps = drive(fleet, datas, chunk, volumes)
        runs.append((steps, fleet))
    (got, pf), (want, jf) = runs
    assert_steps_equal(got, want)
    assert pf.metrics.samples_decoded == jf.metrics.samples_decoded
    assert pf.metrics.underruns == jf.metrics.underruns
    for lane in range(len(datas)):
        assert_checkpoints_equal(pf.checkpoint(lane), jf.checkpoint(lane))
        assert pf.lane_error(lane) == jf.lane_error(lane)
        assert pf.lane_info(lane) == jf.lane_info(lane)
    return got


def mixed_formats():
    return [make_flac(32000, 8, seed=1),
            make_flac(44100, 6, seed=2, final_short=100),
            make_flac(48000, 5, channels=2, chan_asgn=0, seed=3),
            make_flac(24000, 6, channels=2, chan_asgn=8, seed=4),   # left/side
            make_flac(22050, 6, channels=2, chan_asgn=9, seed=5),   # side/right
            make_flac(48000, 6, channels=2, chan_asgn=10, seed=6),  # mid/side
            make_flac(44100, 3, channels=2, chan_asgn=10, seed=7, depth=24),
            make_flac(16000, 4, seed=8, depth=8)]


@pytest.mark.parametrize("chunk", [700, 4096, 1 << 24])
def test_host_route_mixed_formats_matches_jax(chunk):
    """Mixed rates, depths 8/16/24, mono and stereo, all four subframe
    types, every stereo mode, a short final frame; drip sizes from 700
    bytes to whole files."""
    steps = run_both(mixed_formats(), chunk=chunk)
    assert any(s is not None for s in steps)


def test_host_route_poisoned_and_starved_lanes_match_jax():
    """A bad-magic lane, a lane that turns to garbage, and a lane fed only
    after the others are done (masked, never stalled)."""
    rng = np.random.default_rng(9)
    good = make_flac(48000, 8, seed=9)
    bad_magic = b"OggS" + bytes(rng.integers(0, 256, 4000, dtype=np.uint8))
    garbage = make_flac(32000, 4, seed=10) + b"\xde\xad" * 3000
    late = make_flac(44100, 5, seed=11)
    runs = []
    for fleet in (port_fleet(4), JaxFleet(4)):
        steps = drive(fleet, [good, bad_magic, garbage, None], chunk=3000)
        for _ in range(2):  # lane 3 starves: no window, no error
            steps.append(fleet.step())
        steps += drive(fleet, [None, None, None, late], chunk=3000)
        runs.append((steps, fleet))
    (got, pf), (want, jf) = runs
    assert_steps_equal(got, want)
    assert pf.lane_error(1) == jf.lane_error(1) is not None
    assert pf.lane_error(2) == jf.lane_error(2)
    assert pf.lane_error(3) is None
    for lane in range(4):
        assert_checkpoints_equal(pf.checkpoint(lane), jf.checkpoint(lane))


def test_host_route_volume_and_ramp_match_jax():
    """A constant volume, a ramp started before the first step, and a ramp
    re-started mid-flight from the instantaneous gain."""
    datas = [make_flac(48000, 60, seed=12), make_flac(44100, 30, seed=13),
             make_flac(32000, 30, channels=2, chan_asgn=9, seed=14)]
    runs = []
    for fleet in (port_fleet(3), JaxFleet(3)):
        steps = drive(fleet, datas, chunk=9000, volumes=[(0, 0.5, False), (1, 0.25, True)],
                      max_steps=3)
        fleet.set_volume(1, 1.5, ramp=True)
        fleet.set_volume(2, 0.7, ramp=True)
        assert fleet.get_volume(1) == 1.5
        steps += drive(fleet, [d[27000:] for d in datas], chunk=9000)
        runs.append((steps, fleet))
    assert_steps_equal(runs[0][0], runs[1][0])


@pytest.mark.parametrize("channels", [2, 3])
def test_host_route_multichannel_windows_match_jax(channels):
    """mono=False: [L, C, T] windows; a mono lane replicates channel 0, a
    lane with more channels than the fleet truncates."""
    datas = [make_flac(44100, 6, channels=2, chan_asgn=10, seed=15),
             make_flac(32000, 6, seed=16),
             make_flac(44100, 4, channels=3, chan_asgn=2, seed=17)]
    steps = run_both(datas, mono=False, channels=channels)
    window = next(s for s in steps if s is not None)[0]
    assert window.shape == (3, channels, 48000)
    np.testing.assert_array_equal(window[1, 0], window[1, -1])


@pytest.mark.parametrize("mode", ["none", "cubic", "sinc"])
def test_host_route_interpolation_modes_match_jax(mode):
    datas = [make_flac(44100, 4, seed=18), make_flac(22050, 3, channels=2, chan_asgn=8, seed=19)]
    run_both(datas, interpolation=mode)


def test_host_route_tiny_blocks_match_jax():
    """Blocks of 1 sample: the reference's short-block history splice."""
    r = np.random.default_rng(17)
    frames = []
    for k, n in enumerate([192, 1, 1, 192, 64]):
        frames.append(fixtures.flac_frame(
            [{"type": "verbatim", "values": list(r.integers(-2000, 2000, n))}],
            n, 0, 16, frame_number=k))
    data = fixtures.flac_stream_header(8000, 1, 16, 192 * 2 + 64 + 2) + b"".join(frames)
    run_both([data], chunk=100)


@pytest.mark.parametrize("into", ["port", "jax"])
def test_checkpoints_restore_across_packages(into):
    """A checkpoint taken mid-stream (mid-window, a ramp in flight) by one
    package restores into the other's fleet and resumes bit-exactly: the
    resumed steps equal the uninterrupted run of the first package."""
    data = make_flac(44100, 40, channels=2, chan_asgn=10, seed=20)
    make_src, make_dst = ((JaxFleet, port_fleet) if into == "port" else (port_fleet, JaxFleet))
    full = drive(make_src(1), [data], chunk=3000, volumes=[(0, 0.4, True)])
    src = make_src(1)
    head = drive(src, [data[:30000]], chunk=3000, volumes=[(0, 0.4, True)], max_steps=10)
    ck = src.checkpoint(0)
    assert ck["byte_offset"] + len(ck["pending"]) == 30000 and ck["ramp"][2] == 48000
    dst = make_dst(1)
    dst.restore(0, ck)
    assert_checkpoints_equal(dst.checkpoint(0), ck)
    tail = drive(dst, [data[30000:]], chunk=3000)
    got = [s for s in head + tail if s is not None]
    want = [s for s in full if s is not None]
    for g, w in zip(got, want):  # positions restart with samples_out: equal too
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert len(got) == len(want)


def test_host_route_runs_no_kernel_and_fleet_options():
    """The default route calls neither kernel's plain version; a mesh must
    be the port's (``make_mesh``); a device route on "cuda" needs a card."""
    from aukit_tpu_torch import kernels
    from aukit_tpu_torch.parallel.pipeline import make_mesh

    kernels.reset_counts()
    run_both([make_flac(48000, 3, seed=21)])
    assert all(fn.calls == 0 for fn in kernels.PLAIN)
    with pytest.raises(TypeError, match="make_mesh"):
        FlacFleet(2, mesh=object(), device="cpu")
    assert FlacFleet(2, mesh=make_mesh(2, device="cpu"), device="cpu").mesh.size == 2
    FlacFleet(2)  # the host route needs no card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FlacFleet(2, device_dsp=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            FlacFleet(2, device_restore=True)


# -- the host route's float64 DSP in kernel aukit_flac_dsp_f64 (its plain version) ---------

@pytest.mark.parametrize("name", FLAC_DSP_CASES)
def test_flac_dsp_plain_equals_host_dsp(name):
    """The kernel's plain version on its cases (``flac_dsp_cases``) against
    ``FlacFleet._host_dsp`` on the same restored samples, lane states and
    gains: every lane's samples, lowpass states and resample history bit
    for bit, and nothing written outside the lanes' outputs. Each lane's
    frames take their channel assignments from the case's per-block
    table."""
    _, restored, lanes, asgn, fin, numel, geo = next(c for c in flac_dsp_cases("cpu")
                                                     if c[0] == name)
    C, n = geo.channels, geo.block
    multi = geo.out_mode == "multi"
    out = torch.full((numel,), -999.0)
    state = kernels.flac_dsp_ref(restored, lanes, asgn, fin, out, geo).numpy()
    fleet = port_fleet(len(lanes), mono=not multi, channels=C,
                       interpolation="linear" if geo.linear else "none")
    rng = np.random.default_rng(5)
    parsed, segments = [], []
    for j, (in_off, m, _o, ramp_pos, ramp_len, a_off) in enumerate(lanes.tolist()):
        ln = fleet._lanes[j]
        ln.rate, ln.channels, ln.depth, ln.alpha = geo.rate, C, geo.depth, geo.alpha
        ln.last = rng.standard_normal((C, 2))  # none and linear never read it
        ln.ls = fin[j, 2:].numpy().copy()
        ln.gain0, ln.gain = float(fin[j, 0]), float(fin[j, 1])
        ln.ramp_pos, ln.ramp_len = ramp_pos, ramp_len
        fm = np.stack([np.full(m, n), asgn.numpy()[a_off: a_off + m]], axis=1)
        parsed.append((j, fm, {"block": np.full(m * C, n)}, None, None))
        segments.append(restored.numpy()[in_off: in_off + m * C * n])
    fleet._host_dsp(parsed, segments)
    written = np.zeros(numel, bool)
    for j, (_i, m, out_off, _p, _l, _a) in enumerate(lanes.tolist()):
        ln = fleet._lanes[j]
        T = m * geo.out_len
        want = np.concatenate(list(ln.fifo), axis=-1)
        got = out.numpy()[out_off: out_off + (C if multi else 1) * T]
        np.testing.assert_array_equal(got.reshape(C, T) if multi else got, want)
        written[out_off: out_off + got.size] = True
        np.testing.assert_array_equal(state[j, :C], ln.ls)
        np.testing.assert_array_equal(state[j, C:].reshape(C, 2), ln.last)
    assert (out.numpy()[~written] == -999.0).all()


def card_dsp_fleet(lanes, **kw):
    """A CPU fleet whose host route takes the f64 DSP kernel's route, as a
    fleet on a card does: the kernel's plain version runs on CPU tensors."""
    fleet = port_fleet(lanes, **kw)
    fleet._card_dsp = lambda: True
    return fleet


def assert_card_dsp_equals_numpy(datas, chunk=3000, volumes=(), **kw):
    """The same bytes through the numpy route and the kernel's route: every
    window, mask and position, and every checkpoint, bit-equal. -> the
    kernel route's fleet and steps."""
    want_fleet = port_fleet(len(datas), **kw)
    want = drive(want_fleet, datas, chunk, volumes)
    kernels.reset_counts()
    fleet = card_dsp_fleet(len(datas), **kw)
    got = drive(fleet, datas, chunk, volumes)
    assert kernels.flac_dsp_ref.calls > 0
    assert_steps_equal(got, want)
    for lane in range(len(datas)):
        assert_checkpoints_equal(fleet.checkpoint(lane), want_fleet.checkpoint(lane))
    assert want_fleet.metrics.dsp_lanes_device == 0
    return fleet, got


@pytest.mark.parametrize("datas,kw", [
    pytest.param([make_flac(48000, 6, seed=101)], {}, id="mono"),
    *(pytest.param([make_flac(48000, 6, channels=2, chan_asgn=a, seed=102 + a)], {},
                   id=f"stereo_asgn{a}") for a in (0, 8, 9, 10)),
    pytest.param([make_flac(44100, 5, channels=3, chan_asgn=2, seed=103),
                  make_flac(48000, 5, channels=2, chan_asgn=10, seed=104),
                  make_flac(32000, 5, seed=119)],
                 {"mono": False, "channels": 3}, id="multichannel_mono_false"),
    pytest.param([make_flac(44100, 5, channels=3, chan_asgn=2, seed=105)], {},
                 id="three_channels_mixed"),
    *(pytest.param([make_flac(44100, 6, channels=2, chan_asgn=10, seed=106, depth=d),
                    make_flac(48000, 6, seed=107, depth=d)], {}, id=f"depth{d}")
      for d in (8, 16, 24)),
    pytest.param([make_flac(48000, 6, seed=108)], {"interpolation": "linear"},
                 id="identity_48k"),
    *(pytest.param([make_flac(r, 6, seed=109), make_flac(r, 6, channels=2, chan_asgn=8,
                                                         seed=110)],
                   {"interpolation": "linear"}, id=f"linear_{r}") for r in (44100, 32000)),
    pytest.param([make_flac(44100, 6, seed=111), make_flac(32000, 6, channels=2, chan_asgn=9,
                                                           seed=112)],
                 {"interpolation": "none"}, id="none"),
])
def test_card_dsp_plain_equals_numpy_route(datas, kw):
    """The f64 DSP kernel's plain version against ``_host_dsp``, lane by
    lane bit for bit over every step (the lowpass states and resample
    histories carried from step to step): stereo assignments, three
    channels mixed or kept, depths 8-24, identity, linear and none."""
    fleet, got = assert_card_dsp_equals_numpy(datas, **kw)
    assert len(got) >= 3 and fleet.metrics.dsp_lanes_device > 0
    assert fleet.metrics.dsp_lanes_host == 0


@pytest.mark.parametrize("volumes", [
    pytest.param([(0, 0.5, False), (1, 1.25, False)], id="constant"),
    pytest.param([(0, 0.25, True), (1, 1.7, True)], id="ramp")])
def test_card_dsp_plain_gain_equals_numpy_route(volumes):
    """A constant gain, and a ramp over a second of output that crosses
    steps (drip-fed 3000 bytes a step) and ends inside a block."""
    datas = [make_flac(48000, 30, seed=113), make_flac(44100, 30, channels=2, chan_asgn=10,
                                                      seed=114)]
    fleet, got = assert_card_dsp_equals_numpy(datas, volumes=volumes)
    assert len(got) >= 3 and fleet.metrics.dsp_lanes_host == 0


def test_card_dsp_ramp_ending_before_a_steps_last_block_equals_numpy_route():
    """Ramps to 0.3 on 44.1 kHz lanes whose first step commits 12 blocks of
    4096 or more: each ramp ends inside the 11th block, where g0 + (g1 -
    g0) * 1.0 is not 0.3 in float64 (from 1.0: 0.30000000000000004; from
    1e20: 0.0, silence), and the blocks after it take 0.3 itself, on both
    routes: the numpy route decides the line block by block."""
    datas = [make_flac(44100, 14, n=4096, seed=120),
             make_flac(44100, 14, n=4096, channels=2, chan_asgn=10, seed=121)]
    volumes = [(0, 0.3, True), (1, 1e20, False), (1, 0.3, True)]
    fleet, got = assert_card_dsp_equals_numpy(datas, chunk=1 << 22, volumes=volumes)
    assert got[0] is not None and fleet.metrics.dsp_lanes_host == 0
    assert fleet.metrics.frames_parsed >= 24 and fleet.get_volume(1) == 0.3
    # the lane ramped from 1e20 is loud after its ramp, not silent
    assert np.abs(got[1][0][1, 8000:]).max() > 1.0


def test_card_dsp_fifos_view_one_step_of_windows():
    """The kernel route's lane FIFOs view its block of windows for one step
    at most: a lane fed 3.4 s at once (its remainder outlives the next
    step's pop) and a drip-fed lane. After every step no FIFO entry views
    any block but that step's, and the windows, masks, positions and
    checkpoints equal the numpy route's."""
    datas = [make_flac(48000, 40, n=4096, seed=122), make_flac(48000, 40, n=4096, seed=123)]
    want_fleet = port_fleet(len(datas))
    fleet = card_dsp_fleet(len(datas))
    copied = 0
    for step in range(12):
        feeds = [datas[0] if step == 0 else None if step == 1 else b"",
                 datas[1][step * 16000: (step + 1) * 16000] or None]
        for f in (want_fleet, fleet):
            for lane, d in enumerate(feeds):
                if d != b"":
                    f.feed(lane, d)
        assert_steps_equal([fleet.step()], [want_fleet.step()])
        blocks = {id(a.base) for ln in fleet._lanes for a in ln.fifo
                  if a.base is not None and isinstance(a.base.base, torch.Tensor)}
        held = fleet._windows_held
        assert blocks <= ({id(held[0])} if held else set())
        copied += sum(a.base is None or not isinstance(a.base.base, torch.Tensor)
                      for a in fleet._lanes[0].fifo)
    assert copied > 0 and fleet.metrics.dsp_lanes_device > 0
    for lane in range(len(datas)):
        assert_checkpoints_equal(fleet.checkpoint(lane), want_fleet.checkpoint(lane))


def test_card_dsp_ragged_fleet_equals_numpy_route():
    """A ragged fleet: uniform lanes, a lane whose short final frame sends
    its last step to the numpy route, and a lane whose blocks (8 kHz, 4096
    samples: 24576 at 48 kHz) overflow the kernel's shared memory. Windows,
    masks, positions and checkpoints equal the numpy route's, and each
    decoded lane of each step counts once, on one route."""
    datas = [make_flac(48000, 6, seed=115), make_flac(44100, 5, seed=116, final_short=300),
             make_flac(8000, 2, n=4096, seed=117),
             make_flac(32000, 5, channels=2, chan_asgn=8, seed=118)]
    decoded = []

    class Counted(FlacFleet):
        def _decode_step(self, parsed):
            decoded.append(len(parsed))
            return super()._decode_step(parsed)

    want_fleet = port_fleet(len(datas))
    want = drive(want_fleet, datas, chunk=3000)
    kernels.reset_counts()
    fleet = Counted(len(datas), device="cpu")
    fleet._card_dsp = lambda: True
    got = drive(fleet, datas, chunk=3000)
    assert_steps_equal(got, want)
    for lane in range(len(datas)):
        assert_checkpoints_equal(fleet.checkpoint(lane), want_fleet.checkpoint(lane))
    m = fleet.metrics
    assert m.dsp_lanes_device + m.dsp_lanes_host == sum(decoded)
    assert m.dsp_lanes_device > 0 and m.dsp_lanes_host >= 3
    assert kernels.flac_dsp_ref.calls > 0


# -- CD rips: stereo frames that mix channel assignments (flac -5 -m) ----------------------

def cd_streams():
    """Three ``flac -5`` CD tracks (``portbench/inputs/cd_stations.py``)
    whose frames mix all four stereo assignments: one of 32 whole frames,
    one whose last frame is short, and that one joined at its 5th frame."""
    whole = cd_stations.CdTrack(np.random.default_rng(31),
                                32 * cd_stations.BLOCK / cd_stations.RATE)
    short = cd_stations.CdTrack(np.random.default_rng(32), 3.0)
    return [whole.stream(), short.stream(), short.stream(5)]


CD_FEEDS = [pytest.param(chunk, kw, id=f"{feed}_{out}")
            for chunk, feed in ((60000, "chunks"), (1 << 24, "whole"))
            for kw, out in (({}, "mono"), ({"mono": False}, "stereo"))]


@pytest.mark.parametrize("chunk,kw", CD_FEEDS)
def test_host_route_cd_tracks_match_jax(chunk, kw):
    """Streams whose frames mix channel assignments, fed about seven frames
    a step or whole, mixed to mono or kept stereo: the port's host route
    equals the JAX fleet's step by step, checkpoints included."""
    run_both(cd_streams(), chunk=chunk, **kw)


@pytest.mark.parametrize("chunk,kw", CD_FEEDS)
def test_card_dsp_cd_tracks_equal_numpy_route(chunk, kw, monkeypatch):
    """The f64 DSP kernel's route (its plain version) on streams whose frames
    mix channel assignments equals the numpy route bit for bit, and takes
    every lane of a step whose frames share one block size, whatever their
    assignments: only the steps that hold a track's short last frame with
    others go to numpy."""
    routes = []
    kernel_dsp = FlacFleet._kernel_dsp

    def recorded(self, parsed, restored, voffs):
        rest = kernel_dsp(self, parsed, restored, voffs)
        routes.extend((p[1], k in rest) for k, p in enumerate(parsed))
        return rest

    monkeypatch.setattr(FlacFleet, "_kernel_dsp", recorded)
    assert_card_dsp_equals_numpy(cd_streams(), chunk=chunk, **kw)
    assert all(on_numpy == (len(set(fm[:, 0])) > 1) for fm, on_numpy in routes)
    assert any(not on_numpy and len(set(fm[:, 1])) > 1 for fm, on_numpy in routes)


# -- the device routes --------------------------------------------------------------------

def wasted_flac(seed, n=512, frames=4):
    """Verbatim subframes with 2 wasted bits (order 0: shift only)."""
    r = np.random.default_rng(seed)
    out = [fixtures.flac_frame([{"type": "verbatim", "wasted": 2,
                                 "values": [int(v) for v in r.integers(-1000, 1000, n)]}],
                               n, 0, 16, frame_number=k) for k in range(frames)]
    return fixtures.flac_stream_header(48000, 1, 16, frames * n) + b"".join(out)


def device_datas():
    return [make_flac(44100, 6, seed=60, channels=2, chan_asgn=10),  # resampled, mid/side
            make_flac(48000, 6, seed=61),                            # identity rate
            make_flac(32000, 5, n=520, seed=62, channels=2, chan_asgn=8),  # odd block size
            wasted_flac(44),                                         # wasted bits
            make_flac(44100, 2, seed=63, final_short=300)]           # short final frame


class Routes:
    """Counts which route each lane group of each step took."""

    def __init__(self, cls):
        self.counts = {"full": 0, "fallback": 0}
        counts = self.counts

        class Counted(cls):
            def _device_full_step(self, parsed):
                r = super()._device_full_step(parsed)
                counts["full" if r is not None else "fallback"] += 1
                return r

            def _lane_geometry(self, p):
                key = super()._lane_geometry(p)
                counts["fallback"] += key is None
                return key

        self.cls = Counted


@pytest.fixture(scope="module")
def jax_runs():
    """(route, mode, mono) -> the JAX device route's steps and fleet, computed
    once per module."""
    cache = {}

    def get(route, mode, mono=True):
        key = (route, mode, mono)
        if key not in cache:
            datas = device_datas() if route == "full" else staged_datas()
            fleet = JaxFleet(len(datas), device_restore=route == "full", device_dsp=True,
                             interpolation=mode, mono=mono)
            fleet._block_iir = "interpret"
            cache[key] = (drive(fleet, datas, chunk=3000), fleet)
        return cache[key]

    return get


def staged_datas():
    """One geometry (the staged route's single resample group): 22.05 kHz
    side/right stereo, and a lane with a volume ramp."""
    return [make_flac(22050, 6, seed=70, channels=2, chan_asgn=9),
            make_flac(22050, 6, seed=71, channels=2, chan_asgn=9)]


def assert_close_to_host(got, host):
    """The reference's tolerance of a device route against the host route."""
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert (g is None) == (h is None)
        if h is not None:
            np.testing.assert_array_equal(g[1], h[1])
            np.testing.assert_array_equal(g[2], h[2])
            np.testing.assert_allclose(g[0], h[0], rtol=0, atol=5e-3)


@pytest.mark.parametrize("mode", ["none", "linear", "cubic", "sinc"])
def test_device_resident_route_matches_jax(mode, jax_runs):
    """Mixed-rate geometry groups (44.1 kHz mid/side, 48 kHz identity, 32 kHz
    left/side at an odd block size of 520), wasted bits, and a short final
    frame that falls back to the staged route: the windows and the
    checkpoints equal the JAX route's bit for bit. Cubic is the exception:
    the JAX fleet without a mesh computes it in the Pallas kernels' grouped
    layout, where XLA contracts other multiply-adds than in its lane-major
    route (the one the port mirrors; the JAX package's own two routes differ
    there by one float32 ulp of the int8-range value), so cubic windows agree
    within 2e-6."""
    datas = device_datas()
    routes = Routes(FlacFleet)
    kernels.reset_counts()
    port = routes.cls(len(datas), device_restore=True, device_dsp=True, interpolation=mode,
                      device="cpu")
    got = drive(port, datas, chunk=3000)
    assert routes.counts["full"] >= 6 and routes.counts["fallback"] >= 1, routes.counts
    assert kernels.lpc_restore_ref.calls > 0 and kernels.iir_zero_ref.calls > 0
    want, jf = jax_runs("full", mode)
    if mode == "cubic":
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(g[1], w[1])
                np.testing.assert_array_equal(g[2], w[2])
                np.testing.assert_allclose(g[0], w[0], rtol=0, atol=2e-6)
    else:
        assert_steps_equal(got, want)
        for lane in range(len(datas)):
            assert_checkpoints_equal(port.checkpoint(lane), jf.checkpoint(lane))
    assert_close_to_host(got, drive(port_fleet(len(datas), interpolation=mode), datas, 3000))


@pytest.mark.parametrize("mode", ["none", "linear", "cubic", "sinc"])
def test_staged_route_matches_jax(mode, jax_runs):
    """device_restore=False: the host restore, then the resample and kernel
    (h)'s lowpass on the device, a volume ramp in flight; bit-equal to the
    JAX staged route with its Pallas lowpass."""
    datas = staged_datas()
    kernels.reset_counts()
    port = port_fleet(len(datas), device_restore=False, device_dsp=True, interpolation=mode)
    got = drive(port, datas, chunk=3000)
    assert kernels.lpc_restore_ref.calls == 0 and kernels.iir_zero_ref.calls > 0
    want, jf = jax_runs("staged", mode)
    assert_steps_equal(got, want)
    for lane in range(len(datas)):
        assert_checkpoints_equal(port.checkpoint(lane), jf.checkpoint(lane))
    assert_close_to_host(got, drive(port_fleet(len(datas), interpolation=mode), datas, 3000))


def test_device_route_multichannel_matches_jax(jax_runs):
    """mono=False on the device-resident route: [L, C, T] windows, bit-equal."""
    datas = device_datas()
    got = drive(port_fleet(len(datas), device_restore=True, device_dsp=True, mono=False,
                           interpolation="linear"), datas, chunk=3000)
    want, _ = jax_runs("full", "linear", mono=False)
    assert_steps_equal(got, want)
    assert next(s for s in got if s is not None)[0].shape == (len(datas), 2, 48000)


@pytest.mark.parametrize("name,depth,channels,asgn", [
    ("mono16", 16, 1, 0), ("mono24", 24, 1, 0),
    ("independent", 16, 2, 1), ("left_side", 16, 2, 8), ("side_right", 16, 2, 9),
    ("mid_side", 24, 2, 10)])
def test_device_integer_stages_match_jax(name, depth, channels, asgn):
    """The restore (kernel (g)'s plain version), wasted-bits shift, stereo
    decorrelation, sign wrap and normalise of the device route equal the
    JAX device route's (its Pallas restore in interpret mode, at an identity
    rate, where its resample passes the decoded rows through) bit for bit."""
    n = 1024
    data = make_flac(48000, 4, n=n, channels=channels, chan_asgn=asgn, seed=90 + asgn,
                     depth=depth)
    _, ch, d, _, _, pos = flac.parse_flac_header(data)
    fm, sub, coefs, values = flac.parse_all_frames(data, pos, ch, d)
    S = len(sub["order"])
    nsubs = ch if asgn <= 7 else 2
    K = order_bucket(int(sub["order"].max()))

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    restored = lpc_restore_kernel(i32(values.reshape(S, n)), i32(sub["order"]), i32(sub["shift"]),
                                  i32(np.full(S, n)), i32(coefs[:, :K]), K=K)
    got = ff.frames_to_float(restored, i32(sub["wasted"]), nsubs, asgn, d).numpy()
    fn, out_len = jax_ff._device_decode_fn(K, nsubs, asgn, d, n, 48000, 48000, "linear", 8,
                                           True)
    F = S // nsubs
    want, tails = fn(values.reshape(S, n).astype(np.int32), sub["order"].astype(np.int32),
                     sub["shift"].astype(np.int32), np.full(S, n, np.int32),
                     coefs.astype(np.int32), sub["wasted"].astype(np.int32),
                     np.zeros(F, bool), np.zeros(F, np.int32),
                     np.zeros((F, channels, 2), np.float32))
    assert out_len == n and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))
    raw = flac.decorrelate_frames(fm, sub["block"], flac.restore_flat(sub, coefs, values, d),
                                  ch, d)
    np.testing.assert_array_equal(got.transpose(1, 0, 2).reshape(ch, -1),
                                  (raw / (1 << d)).astype(np.float32))
