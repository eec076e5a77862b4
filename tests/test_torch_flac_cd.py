"""The benchmark's CD radio configuration (``portbench/``, config ``flac_cd``)
on the CPU: the stereo ``flac -5`` writer against the plain reference's
decoder; the port's ``Fleet`` (through the benchmark's driver) and
``FlacFleet`` against the reference's int8 windows and masks, rotations
included; the FLAC lanes' counters of channel assignments and DSP routes,
which count only while a profiler records; and the control, the reference
one precision below the configuration's in the Fleet's place, which the
check finds not correct: its float32 windows before the int8 cast are off
the reference's float64 mix by more than a unit in the last place."""

import numpy as np
import pytest
import torch

from aukit_tpu_torch.stream.flac_fleet import FlacFleet
from portbench.harness import registry
from portbench.harness.core import Spans
from portbench.inputs import cd_stations
from portbench.reference import cd_radio, flac, flac_stereo

WINDOW = 48000
ASSIGNMENTS = {1, 8, 9, 10}  # independent, left/side, side/right, mid/side
# a seed whose control run also flips a checked int8 sample in its first ticks
CONTROL_SEED, CONTROL_TICKS = 14, 4


def cd_track(seed: int, seconds: float = 3.0) -> cd_stations.CdTrack:
    return cd_stations.CdTrack(np.random.default_rng(seed), seconds)


def frame_offsets(trk, first: int = 0) -> np.ndarray:
    """Each frame's start in ``trk.stream(first)``, then the end."""
    *_info, head = flac.streaminfo(trk.stream(first))
    return trk.offsets[first:] - trk.offsets[first] + head


def reference_windows(trk, first: int = 0) -> list:
    """The reference's int8 windows of a track joined at frame ``first``, the
    last one zero-padded."""
    (out,) = cd_radio.station_outputs([(trk.stream(first), frame_offsets(trk, first))])
    out = np.concatenate([out, np.zeros(-len(out) % WINDOW, np.int8)])
    return list(out.reshape(-1, WINDOW))


def tiny_cell(seed: int, factory=None):
    """The driver's cell of ``flac_cd.cd_live`` at a small size: 8 stations
    of 44.1 kHz stereo, two pool tracks of 3-3.5 s, every station checked."""
    spec = registry.cell("flac_cd.cd_live")
    spec["config"].update(stations=8, track_pool=2)
    spec["traffic"].update(track_seconds=[3.0, 3.5], check_stations={"flac": 8},
                           warmup_ticks=1)
    cell = registry.driver("flac_cd").Cell(spec["config"], spec["traffic"], seed, "cpu",
                                           Spans(), engine_factory=factory)
    cell.setup()
    return cell


@pytest.mark.parametrize("first", [0, 5])
def test_writer_streams_decode_to_the_writers_samples(first):
    """Every assignment and a short last frame, from the start and joined
    part way."""
    trk = cd_track(7)
    assert set(trk.asgn.tolist()) == ASSIGNMENTS
    assert 0 < trk.frame_samples[-1] < cd_stations.BLOCK
    stream = trk.stream(first)
    assert flac.streaminfo(stream)[:4] == (44100, 2, 16, trk.pcm.shape[1] - first * 4096)
    (got,) = flac_stereo.decode_frames([(stream, frame_offsets(trk, first))])
    assert np.array_equal(got, trk.pcm[:, first * cd_stations.BLOCK:])


def test_writer_keeps_the_smallest_assignment():
    """Each frame's coded size is the least of the four assignments': the
    frame recoded with each other assignment is no smaller."""
    trk = cd_track(8)
    cand = cd_stations.candidates(trk.pcm[:, : 8 * cd_stations.BLOCK].reshape(2, 8, -1))
    bits = np.stack([cd_stations.subframe_bits(16 + (c == cd_stations.SIDE),
                                               cd_stations.lpc_code(cand[c], 5)[5])
                     for c in range(4)])
    for f in range(8):
        sizes = {a: int(bits[p, f] + bits[q, f]) for a, (p, q) in cd_stations.PAIRS.items()}
        assert sizes[int(trk.asgn[f])] == min(sizes.values())


def test_flac_fleet_equals_the_reference_through_a_rotation():
    """Two lanes drip-fed about a second of bytes a step: lane 0 plays one
    track and is reused for another (``reset_lane``), lane 1 plays a track
    joined at its 5th frame. Every window equals the reference's."""
    a, b, c = cd_track(11), cd_track(12), cd_track(13, 2.2)
    plays = [[(a, 0), (c, 0)], [(b, 5)]]
    want = [[w for trk, first in p for w in reference_windows(trk, first)] for p in plays]
    fleet = FlacFleet(2, device="cpu")
    got = [[], []]
    pos = [0, 0]
    track = [0, 0]
    streams = [p[0][0].stream(p[0][1]) for p in plays]
    for _ in range(20):
        for lane in range(2):
            if pos[lane] is None:
                continue
            s = streams[lane]
            if pos[lane] < len(s):
                fleet.feed(lane, s[pos[lane]: pos[lane] + 90000])
                pos[lane] += 90000
            else:
                fleet.feed(lane, None)
                pos[lane] = None
        r = fleet.step()
        if r is not None:
            for lane in range(2):
                if r[1][lane]:
                    got[lane].append(torch.from_numpy(r[0][lane]).clamp(-128, 127)
                                     .to(torch.int8).numpy())
        # a played-out lane is reused for its next track
        for lane in range(2):
            if pos[lane] is None and fleet.active[lane] == 0 \
                    and track[lane] + 1 < len(plays[lane]):
                track[lane] += 1
                trk, first = plays[lane][track[lane]]
                fleet.reset_lane(lane)
                streams[lane], pos[lane] = trk.stream(first), 0
    assert track == [1, 0]
    for lane in range(2):
        assert len(got[lane]) == len(want[lane])
        assert all(np.array_equal(g, w) for g, w in zip(got[lane], want[lane]))


def test_fleet_equals_the_reference_in_the_drivers_check():
    """The benchmark's driver on the CPU: 8 live stations of a FLAC-only
    ``Fleet``, several ticks with rotations; the check's numbers are 0."""
    cell = tiny_cell(5)
    for _ in range(4):
        cell.tick()
        cell.keep()
    assert any(resets for resets, _fed, _ends in cell.events)
    assert sum(int(m.sum()) for m in cell.masks) > 8
    assert cell.check() == {"lsb_max": 0, "off_ppm": 0.0, "state_off": 0, "carry_err": 0.0}


def drive_counted(fleet, datas, chunks) -> None:
    """Feed each lane its stream ``chunks[lane]`` bytes a step, then its end,
    and step until every lane has ended."""
    at = [0] * len(datas)
    while not fleet.done:
        for lane, data in enumerate(datas):
            if at[lane] is None:
                continue
            if at[lane] < len(data):
                fleet.feed(lane, data[at[lane]: at[lane] + chunks[lane]])
                at[lane] += chunks[lane]
            else:
                fleet.feed(lane, None)
                at[lane] = None
        fleet.step()


NEW_COUNTERS = ("dsp_frames_device", "dsp_frames_host", "dsp_lanes_mixed_asgn",
                "dsp_lanes_mixed_asgn_device", "frames_asgn_indep", "frames_asgn_left_side",
                "frames_asgn_side_right", "frames_asgn_mid_side")


def test_assignment_and_route_counters_add_up():
    """With the kernel's route on (its plain version on the CPU): a lane fed
    a few kilobytes a step commits a frame or none and takes the kernel; a
    lane fed a track of whole frames at once commits frames of mixed
    assignments and takes the kernel too; a lane fed a track whose last
    frame is short at once takes numpy (two block sizes in one step). Under
    a profiler the frames on each route add up to the frames parsed, the
    assignments' counts too, each route's mixed lanes count, on the
    ``aukit.flac.dsp`` records as in the metrics; without one the new
    counters stay 0."""
    from aukit_tpu_torch.utils import trace

    trks = [cd_track(21), cd_track(22, 32 * cd_stations.BLOCK / cd_stations.RATE),
            cd_track(23)]
    assert trks[1].frame_samples[-1] == cd_stations.BLOCK
    assert 0 < trks[2].frame_samples[-1] < cd_stations.BLOCK
    assert all(len(set(t.asgn.tolist())) > 1 for t in trks[1:])
    datas = [t.stream(0) for t in trks]
    counts = {}
    for profiled in (False, True):
        fleet = FlacFleet(3, device="cpu")
        fleet._card_dsp = lambda: True
        trace.clear_span_records()
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                drive_counted(fleet, datas, [3000, 1 << 22, 1 << 22])
        else:
            drive_counted(fleet, datas, [3000, 1 << 22, 1 << 22])
        counts[profiled] = fleet.metrics
    assert all(getattr(counts[False], k) == 0 for k in NEW_COUNTERS)
    m = counts[True]
    assert m.frames_parsed == sum(t.frames for t in trks)
    assert m.dsp_frames_device + m.dsp_frames_host == m.frames_parsed
    assert m.dsp_frames_device >= trks[0].frames - 1 + trks[1].frames
    assert m.dsp_frames_host >= trks[2].frames
    by_asgn = [m.frames_asgn_indep, m.frames_asgn_left_side, m.frames_asgn_side_right,
               m.frames_asgn_mid_side]
    assert by_asgn == [int(sum((t.asgn == a).sum() for t in trks)) for a in (1, 8, 9, 10)]
    assert m.dsp_lanes_mixed_asgn_device == 1 and m.dsp_lanes_mixed_asgn == 1
    dsp = [r for r in trace.span_records() if r.name == "aukit.flac.dsp"]
    for k in ("dsp_lanes_mixed_asgn", "dsp_lanes_mixed_asgn_device", "dsp_lanes_device",
              "dsp_lanes_host"):
        assert sum(r.counts.get(k, 0) for r in dsp) == getattr(m, k)
    numpy_route = [r for r in trace.span_records() if r.name == "aukit.flac.dsp.numpy"]
    assert numpy_route and {r.parent for r in numpy_route} == {"aukit.flac.dsp"}


def control_check(seed: int) -> dict:
    """The check's numbers of the control (int32 restore, float32 DSP) in
    the Fleet's place."""
    factory = registry.driver("flac_cd").control(torch.int32, torch.float32)
    cell = tiny_cell(seed, factory)
    for _ in range(CONTROL_TICKS):
        cell.tick()
        cell.keep()
    return cell.check()


def test_control_one_precision_below_is_not_correct():
    """The reference in the Fleet's place with an int32 restore and a
    float32 DSP: float32 moves a few int8 samples in a million across an
    integer (the int32 restore changes nothing: FLAC keeps it in 32 bits),
    and its float32 windows are several units in the last place off the
    float64 mix, so the check finds the control not correct where the
    program reads 0."""
    got = control_check(CONTROL_SEED)
    limits = registry.cell("flac_cd.cd_live")["limits"]["limits"]
    assert got["state_off"] == 0 and got["lsb_max"] >= 1 and got["off_ppm"] > 0
    assert got["carry_err"] > limits["carry_err"]


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_control_fails_the_float_windows_where_no_int8_sample_flips(seed):
    """Seeds on which the control's int8 windows may all come out right:
    its float32 windows still fail ``carry_err``, their distance in units in
    the last place from the float64 mix."""
    got = control_check(seed)
    limits = registry.cell("flac_cd.cd_live")["limits"]["limits"]
    assert got["state_off"] == 0
    assert got["carry_err"] > limits["carry_err"]


def test_ulp_distance_counts_float32_steps():
    """Units in the last place of the second operand, taken at 1 below 1."""
    from portbench.drivers.flac_cd import ulp_distance

    b = np.array([3.0, -100.0, 0.25, 0.0, 1.0], np.float32)
    a = np.array([np.nextafter(np.float32(3.0), np.float32(4.0)), -100.0,
                  np.nextafter(np.float32(0.25), np.float32(1.0)), -0.0, 1.0 + 2**-21],
                 np.float32)
    got = ulp_distance(a, b)
    assert got[0] == 1.0 and got[1] == 0.0 and got[3] == 0.0 and got[4] == 4.0
    assert got[2] == 0.25  # a step of 0.25's spacing, a quarter of 1's

