"""The ``Fleet`` facade against the JAX package's: the same sources go through
``aukit_tpu.stream.fleet.Fleet`` (JAX on the CPU) and
``aukit_tpu_torch.stream.fleet.Fleet`` (plain PyTorch on the CPU). Windows,
masks and positions are held bit-equal step by step (tolerance 0), and
checkpoints restore across the packages both ways.

The port's DFPWM plain loops cost ~4 s per one-second step here, so the
DFPWM sources are kept to one or two seconds; the scenarios are those of
``tests/test_fleet.py`` (stations, seeks, rotations, checkpoints)."""

import numpy as np
import pytest
import torch

import aukit_tpu as ak
from aukit_tpu.stream import batch as jax_batch
from aukit_tpu.stream import fleet as jax_fleet
from aukit_tpu_torch.parallel.pipeline import make_mesh
from aukit_tpu_torch.stream import batch, fleet
from tests import fixtures
from tests.test_fleet import fir_48k_f, make_mdfpwm
from tests.test_flac_fleet import make_flac, solo_reference
from tests.ref.codecs import dfpwm_decode_ref
from tests.test_torch_batch import assert_checkpoints_equal, assert_steps_equal, to_numpy

RNG = np.random.default_rng(199)
DFPWM = ("dfpwm", 48000)


def sources_for(mod, sources):
    """Sources with ``(spec args, bytes)`` pairs mapped to ``mod``'s LaneSpec."""
    return [(mod.LaneSpec(*s[0]), s[1]) if isinstance(s, tuple) else s for s in sources]


def twins(sources, **kw):
    """(JAX Fleet, port Fleet on the CPU) over the same sources."""
    return (jax_fleet.Fleet(sources_for(jax_batch, sources), **kw),
            fleet.Fleet(sources_for(batch, sources), device="cpu", **kw))


def steps(f, limit=10000):
    """Every non-None step until done: [(windows, mask, positions)]."""
    out = []
    for _ in range(limit):
        if f.done:
            return out
        r = f.step()
        if r is not None:
            out.append((to_numpy(r[0]), r[1].copy(), r[2].copy()))
    raise AssertionError("fleet did not finish")


def run_twins(jf, tf):
    """Step both fleets to the end; assert equal; return the port's steps."""
    got, want = steps(tf), steps(jf)
    assert_steps_equal(got, want)
    return got


def per_station(st, n):
    """Concatenated real audio of each station from a steps list."""
    outs = [[] for _ in range(n)]
    for w, m, _ in st:
        for i in np.nonzero(m)[0]:
            outs[i].append(w[i])
    return [np.concatenate(o, axis=-1) if o else np.zeros(0, np.int8) for o in outs]


def test_fleet_facade_mixed_sources():
    """WAV(pcm16) + raw DFPWM + FLAC + QOA in one Fleet: bit-equal to the JAX
    Fleet, and the DFPWM and FLAC stations to their solo references."""
    wav = ak.tone(440, 1.0, 0.5, "sine", sample_rate=24000).wav(16)
    dfp = RNG.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    flac = make_flac(44100, 6, seed=80)
    qoa = fixtures.qoa_stream(RNG, 1, 10240, [5120, 5120]) + b"\x00" * 8
    jf, tf = twins([wav, (DFPWM, dfp), flac, qoa])
    assert [st.kind for st in tf.stations] == ["engine"] * 2 + ["flac", "engine"]
    outs = per_station(run_twins(jf, tf), 4)
    exp_d = fir_48k_f(dfpwm_decode_ref(dfp))
    np.testing.assert_array_equal(outs[1][: len(exp_d)], exp_d)
    exp_f = np.clip(solo_reference(flac), -128, 127).astype(np.int8)
    np.testing.assert_array_equal(outs[2][: len(exp_f)], exp_f)


def test_fleet_facade_mdfpwm_station_and_drip_invariance():
    """An MDFPWM station merges its two DFPWM lanes (floor-mean), bit-equal
    to the JAX Fleet, and is drip-size invariant."""
    data, _length = make_mdfpwm(1)
    whole = run_twins(*twins([data]))
    drip = fleet.Fleet([data[:50]], eof=False, device="cpu")
    for pos in range(50, len(data), 7013):
        drip.feed(0, data[pos: pos + 7013])
    drip.feed(0, None)
    np.testing.assert_array_equal(per_station(steps(drip), 1)[0], per_station(whole, 1)[0])
    info = drip.station_info(0)
    assert info["artist"] == "a" and info["title"] == "t"


def test_fleet_facade_multichannel_windows():
    """mono=False: [N, C, T] windows, bit-equal to the JAX Fleet; the stereo
    FLAC station carries distinct channels, the DFPWM station replicates
    channel 0."""
    flac = make_flac(44100, 6, channels=2, chan_asgn=10, seed=81)
    dfp = RNG.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    got = run_twins(*twins([flac, (DFPWM, dfp)], mono=False, channels=2))
    assert all(w.ndim == 3 and w.shape[1] == 2 for w, _, _ in got)
    fl, df = per_station(got, 2)
    assert not np.array_equal(fl[0], fl[1])
    np.testing.assert_array_equal(df[0], df[1])


def test_fleet_facade_checkpoint_roundtrip():
    """Engine and FLAC station checkpoints equal the JAX Fleet's and restore
    into a fresh Fleet of either package with the same windows after."""
    flac = make_flac(48000, 8, seed=82)
    dfp = RNG.integers(0, 256, 12000, dtype=np.uint8).tobytes()
    full = per_station(steps(fleet.Fleet(sources_for(batch, [(DFPWM, dfp), flac]),
                                         device="cpu")), 2)
    jf, tf = twins([(DFPWM, dfp), flac], eof=False)
    heads = []
    for f in (jf, tf):
        r = f.step()
        heads.append(None if r is None else (to_numpy(r[0]), r[1].copy()))
    np.testing.assert_array_equal(heads[1][0], heads[0][0])
    cks = [[f.checkpoint(i) for i in range(2)] for f in (jf, tf)]
    assert_checkpoints_equal(cks[1][0]["sub"], cks[0][0]["sub"])
    for ckset in cks:  # each package's checkpoints into a fresh port fleet
        f2 = fleet.Fleet(sources_for(batch, [(DFPWM, b""), flac[:4]]), eof=False,
                         device="cpu")
        f2.restore(0, ckset[0])
        f2.restore(1, ckset[1])
        f2.feed(0, dfp[ckset[0]["fed"]:])
        f2.feed(0, None)
        sub = ckset[1]["sub"]
        f2.feed(1, flac[sub["byte_offset"] + len(sub["pending"]):])
        f2.feed(1, None)
        rest = per_station(steps(f2), 2)
        for i in range(2):
            head = [heads[1][0][i]] if heads[1][1][i] else []
            np.testing.assert_array_equal(np.concatenate(head + [rest[i]], axis=-1), full[i])


def test_fleet_facade_explicit_lanespec_and_errors():
    """(LaneSpec, bytes) stations bypass detection; undetectable sources
    raise; a checkpoint of the wrong kind raises."""
    raw = (np.sin(np.arange(8000) / 5.0) * 100).astype(np.int8).tobytes()
    outs = per_station(run_twins(*twins([(("pcm8", 8000), raw)])), 1)
    assert len(outs[0]) >= 47000 and outs[0].any()
    with pytest.raises(ValueError):
        fleet.Fleet([RNG.integers(60, 200, 200, dtype=np.uint8).tobytes()], device="cpu")
    f2 = fleet.Fleet([make_flac(48000, 2, seed=83)], device="cpu")
    with pytest.raises(ValueError, match="kind"):
        f2.restore(0, {"kind": "engine", "fed": 0, "sub": {}})
    with pytest.raises(TypeError, match="make_mesh"):
        fleet.Fleet([raw], mesh=object(), device="cpu")
    station = (batch.LaneSpec("pcm8", 8000), raw)
    meshed = fleet.Fleet([station], mesh=make_mesh(2, device="cpu"), device="cpu")
    assert meshed.engine.mesh.size == 2


@pytest.mark.parametrize("channels", [4, 1])
def test_fleet_facade_channel_capacity_mismatch(channels):
    """A stereo engine station in a 4- or 1-channel facade fits (replicates
    channel 0 / truncates), bit-equal to the JAX Fleet."""
    t = np.arange(24000)
    inter = np.stack([(np.sin(t / 9.0) * 20000).astype(np.int16),
                      (np.cos(t / 5.0) * 15000).astype(np.int16)], axis=1).reshape(-1).tobytes()
    got = run_twins(*twins([(("pcm16", 24000, 2), inter)], mono=False, channels=channels))
    w = got[0][0]
    assert w.shape[1] == channels
    if channels == 4:
        np.testing.assert_array_equal(w[0, 3], w[0, 0])
        assert not np.array_equal(w[0, 0], w[0, 1])


def test_fleet_facade_poisoned_flac_station_isolated(monkeypatch):
    """A FLAC station fed garbage after a valid header poisons with a reason
    while the healthy station decodes to its solo reference."""
    import aukit_tpu_torch.stream.flac_fleet as ff

    monkeypatch.setattr(ff, "_PULL_STALL_LIMIT", 100_000)
    healthy = make_flac(48000, 4, seed=97)
    garbage = bytes(RNG.integers(0, 255, 400_000, dtype=np.uint8))
    f = fleet.Fleet([healthy[:50], healthy], eof=False, device="cpu")
    f.feed(1, None)
    f.feed(0, garbage[:200_000])
    outs = []
    r = f.step()
    if r is not None and r[1][1]:
        outs.append(to_numpy(r[0])[1])
    f.feed(0, garbage[200_000:])
    for _ in range(1000):
        if f.flac.done:
            break
        r = f.step()
        if r is not None and r[1][1]:
            outs.append(to_numpy(r[0])[1])
    assert "undecodable" in f.station_error(0)
    assert f.station_error(1) is None
    exp = np.clip(solo_reference(healthy), -128, 127).astype(np.int8)
    np.testing.assert_array_equal(np.concatenate(outs)[: len(exp)], exp)


def test_fleet_detects_real_tail_pcm():
    """A headerless-PCM source with a quiet tail detects as pcm8 from the
    real construction bytes, as in the JAX Fleet."""
    body = RNG.integers(-100, 100, 4000, dtype=np.int64)
    body[-16:] = np.array([1, -2, 3, -1, 2, -3, 1, -2] * 2)
    src = body.astype(np.int8).tobytes()
    jf, tf = twins([src])
    assert tf.stations[0].kind == "engine"
    assert tf.engine.specs[tf.stations[0].lanes[0]].codec == "pcm8"
    run_twins(jf, tf)


def test_fleet_facade_flac_volume_ramp():
    """set_volume(ramp=True) on a FLAC station: bit-equal to the JAX Fleet."""
    data = make_flac(48000, 110, seed=77)
    jf, tf = twins([data])
    for f in (jf, tf):
        f.set_volume(0, 0.25, ramp=True)
    got = per_station(run_twins(jf, tf), 1)[0].astype(np.float64)
    assert np.abs(got[60000:100000]).mean() < 0.45 * np.abs(got[:8000]).mean() + 1


def test_fleet_step_returns_device_windows_bit_equal_to_host_merge():
    """``Fleet.step`` returns a tensor on the fleet's device, bit-equal to an
    explicit host merge of its two engines' outputs (FLAC truncating int8
    cast, MDFPWM floor-mean, station permutation, mask)."""
    fl = make_flac(44100, 40, seed=21)
    dfp = RNG.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    mdf, _ = make_mdfpwm(1)
    srcs = sources_for(batch, [fl, (DFPWM, dfp), mdf])
    f, twin = fleet.Fleet(srcs, device="cpu"), fleet.Fleet(srcs, device="cpu")
    while (r := f.step()) is not None:
        w, m, _p = r
        assert isinstance(w, torch.Tensor) and w.device == f.device
        er, hr = twin.engine.step(), twin.flac.step()
        exp = np.zeros((3, 48000), np.int8)
        if hr is not None and hr[1][0]:
            exp[0] = np.clip(hr[0][0], -128, 127).astype(np.int8)
        if er is not None:
            ewh = er[0].numpy()
            if er[1][0]:
                exp[1] = ewh[0]
            if er[1][1] or er[1][2]:
                exp[2] = np.floor((ewh[1].astype(np.float64) + ewh[2]) / 2)
        np.testing.assert_array_equal(w.numpy(), exp)
    assert f.done


def test_fleet_station_scale():
    """128 mixed stations (DFPWM and every 32nd FLAC) through the one facade:
    bit-equal to the JAX Fleet, and every station decodes."""
    dfpwm_srcs = [RNG.integers(0, 256, 6000, dtype=np.uint8).tobytes() for _ in range(4)]
    fl = make_flac(48000, 40, seed=31)
    sources = [fl if i % 32 == 0 else (DFPWM, dfpwm_srcs[i % 4]) for i in range(128)]
    outs = per_station(run_twins(*twins(sources)), 128)
    assert all(len(o) > 0 for o in outs)


def test_fleet_dsp_passthrough_and_honest_flac_errors():
    """set_filter/set_mono/normalize reach engine stations; FLAC stations
    reject them. A normalized DFPWM station matches the JAX Fleet."""
    dfp = RNG.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    fl = make_flac(48000, 4, seed=55)
    f = fleet.Fleet(sources_for(batch, [(DFPWM, dfp), fl]), device="cpu")
    f.set_filter(0, "lowpass", 9000)
    assert f.engine.groups[0].lp_kind[0] == 1
    with pytest.raises(ValueError, match="FLAC"):
        f.set_filter(1, "lowpass", 9000)
    with pytest.raises(ValueError, match="FLAC"):
        f.set_mono(1, True)
    with pytest.raises(ValueError, match="FLAC"):
        f.normalize(0.8)
    jf, tf = twins([(DFPWM, dfp)])
    for x in (jf, tf):
        x.normalize(0.8)
    run_twins(jf, tf)


def test_fleet_station_dsp_stages_mixed():
    """Per-station filter, mono toggle and normalize on a mono=False fleet of
    engine stations (stereo WAV, IMA WAV, PCM): unfiltered stations
    bit-equal to the JAX Fleet, filtered ones within the scan's residue
    (``tests/test_torch_batch_dsp.py``)."""
    from tests.test_batch_dsp import mostly_equal

    t = np.arange(22050)
    stereo = fixtures.wav_pcm((np.stack([np.sin(t / 7.0), np.cos(t / 17.0)]) * 20000)
                              .astype(np.int16), 22050, 16)
    ima = fixtures.wav_ima(fixtures.ima_wav_blocks(RNG, 20, 256, 1), 16000, 1, 256)
    raw = (np.sin(np.arange(24000) / 5.0) * 90).astype(np.int8).tobytes()
    jf, tf = twins([stereo, ima, (("pcm8", 24000), raw)], mono=False, channels=2)
    for f in (jf, tf):
        f.set_mono(0, True)
        f.set_filter(1, "highpass", 300)
        f.normalize(0.8)
    got, want = per_station(steps(tf), 3), per_station(steps(jf), 3)
    for i in (0, 2):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(got[0][0], got[0][1])
    mostly_equal(got[1], want[1])


def test_fleet_station_iterator_yields_host_chunks():
    """``station_iterator`` yields one station's windows as host numpy
    chunks with their positions, equal to the JAX Fleet's iterator."""
    wav = ak.tone(330, 1.5, 0.5, "sine", sample_rate=24000).wav(16)
    jf, tf = twins([wav, make_flac(48000, 6, seed=84)])
    got, want = list(tf.station_iterator(0)), list(jf.station_iterator(0))
    assert [p for _, p in got] == [p for _, p in want] == [0.0, 1.0]
    for (g, _), (w, _) in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.int8
        np.testing.assert_array_equal(g, w)
