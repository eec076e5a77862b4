"""``Fleet`` station lifecycle against the JAX package's: seeks on every
kind of station, rotations (``reset_station``), checkpoints after a seek
across the packages, and ``transcode_fleet`` over a Fleet. The same sources
go through both packages' Fleets on the CPU; windows, masks, positions and
seek landings are held bit-equal (tolerance 0), a filtered station within the
filter scan's residue (``tests/test_torch_batch_dsp.py``)."""

import numpy as np
import pytest

import aukit_tpu as ak
from aukit_tpu.stream import batch as jax_batch
from aukit_tpu.stream import fleet as jax_fleet
from aukit_tpu_torch.stream import batch, fleet
from tests import fixtures
from tests.test_fleet import make_mdfpwm
from tests.test_flac_fleet import make_flac, solo_reference
from tests.test_torch_batch import assert_checkpoints_equal, assert_steps_equal, to_numpy
from tests.test_torch_fleet import DFPWM, per_station, run_twins, sources_for, steps, twins

RNG = np.random.default_rng(299)


def test_fleet_reset_station_rotates_sources():
    """Finished stations host new sources without a rebuild; the rotated
    fleet is bit-equal to the JAX Fleet's and to a fresh fleet."""
    dfp_a = RNG.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    dfp_b = RNG.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    wav = ak.tone(440, 1.0, 0.5, "sine", sample_rate=24000).wav(16)
    fl_a, fl_b = make_flac(48000, 6, seed=60), make_flac(48000, 9, seed=61)
    mdf_a, mdf_b = make_mdfpwm(1)[0], make_mdfpwm(1, extra=3000)[0]
    jf, tf = twins([(DFPWM, dfp_a), wav, fl_a, mdf_a])
    first = run_twins(jf, tf)
    for f, mod in ((jf, jax_batch), (tf, batch)):
        f.reset_station(0, (mod.LaneSpec(*DFPWM), dfp_b))
        f.reset_station(1)
        f.reset_station(2, fl_b)
        f.reset_station(3, mdf_b)
    second = per_station(run_twins(jf, tf), 4)
    fresh = fleet.Fleet(sources_for(batch, [(DFPWM, dfp_b), wav, fl_b, mdf_b]), device="cpu")
    for got, exp in zip(second, per_station(steps(fresh), 4)):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(second[1], per_station(first, 4)[1])


def test_fleet_reset_station_guards():
    wav = ak.tone(440, 0.5, 0.5, "sine", sample_rate=24000).wav(16)
    fl = make_flac(48000, 4, seed=63)
    f = fleet.Fleet([wav, fl], device="cpu")
    steps(f)
    with pytest.raises(ValueError, match="kind|detects"):
        f.reset_station(0, fl)
    with pytest.raises(ValueError, match="spec"):
        f.reset_station(0, ak.tone(440, 0.5, 0.5, "sine", sample_rate=48000).wav(16))
    live = fleet.Fleet([wav[:2048]], eof=False, device="cpu")
    with pytest.raises(ValueError, match="retained"):
        live.reset_station(0)


def test_fleet_seek_dfpwm_bit_exact():
    """DFPWM seek rebuilds the decoder state from the byte prefix (native
    ``dfpwm_decode_rows``): windows after the seek equal the continuous
    decode from the landing and the JAX Fleet's."""
    dfp = RNG.integers(0, 256, 12000, dtype=np.uint8).tobytes()
    full = per_station(steps(fleet.Fleet(sources_for(batch, [(DFPWM, dfp)]), device="cpu")),
                       1)[0]
    jf, tf = twins([(DFPWM, dfp)])
    for f in (jf, tf):
        steps(f)
        assert f.seek(0, 1.0) == 1.0
    got = per_station(run_twins(jf, tf), 1)[0]
    np.testing.assert_array_equal(got, full[48000:])
    for f in (jf, tf):  # an un-drained fleet repositions too
        assert f.seek(0, 0.5) == 0.5
    got = per_station(run_twins(jf, tf), 1)[0]
    np.testing.assert_array_equal(got[: len(full) - 24000], full[24000:])


def test_fleet_seek_mdfpwm_bit_exact():
    data, _ = make_mdfpwm(2)
    full = per_station(steps(fleet.Fleet([data], device="cpu")), 1)[0]
    jf, tf = twins([data])
    for f in (jf, tf):
        steps(f)
        assert f.seek(0, 1.0) == 1.0
    np.testing.assert_array_equal(per_station(run_twins(jf, tf), 1)[0], full[48000:])


def test_fleet_seek_flac_frame_aligned():
    fl = make_flac(48000, 110, seed=62)
    solo = np.clip(solo_reference(fl), -128, 127).astype(np.int8)
    jf, tf = twins([fl])
    landings = []
    for f in (jf, tf):
        steps(f)
        landings.append(f.seek(0, 1.0))
    assert landings[0] == landings[1] and 0.0 < landings[1] <= 1.0
    got = per_station(run_twins(jf, tf), 1)[0]
    exp = solo[int(round(landings[1] * 48000)):]
    np.testing.assert_array_equal(got[: len(exp)], exp)


def test_fleet_seek_wav_pcm_sample_exact():
    wav = ak.tone(440, 3.0, 0.5, "sine", sample_rate=24000).wav(16)
    full = per_station(steps(fleet.Fleet([wav], device="cpu")), 1)[0]
    jf, tf = twins([wav])
    for f in (jf, tf):
        steps(f)
        assert f.seek(0, 2.0) == 2.0
    got = per_station(run_twins(jf, tf), 1)[0]
    np.testing.assert_array_equal(got[48000:], full[144000:])


def test_fleet_seek_qoa_frame_aligned():
    from aukit_tpu_torch.stream.batch_codecs import lane_spec_for_qoa
    from aukit_tpu_torch.stream.seek import qoa_seek

    qoa = fixtures.qoa_stream(RNG, 1, 10240, [5120, 5120, 5120])
    jf, tf = twins([qoa])
    for f in (jf, tf):
        steps(f)
        assert f.seek(0, 1.0) == 2 * 5120 / 10240
    got = per_station(run_twins(jf, tf), 1)[0]
    spec, _off, _sz = lane_spec_for_qoa(qoa)
    pos, _ = qoa_seek(qoa, 1.0)
    fresh = fleet.Fleet([(spec, qoa[pos:])], device="cpu")
    np.testing.assert_array_equal(got, per_station(steps(fresh), 1)[0])


def test_fleet_seek_keeps_volume_and_dsp_config():
    """Seek keeps the station's volume and filter configuration and resets
    only the transient filter state; checkpoints taken after the seek
    restore across packages both ways."""
    from tests.test_batch_dsp import mostly_equal

    dfp = RNG.integers(0, 256, 12000, dtype=np.uint8).tobytes()
    jf, tf = twins([(DFPWM, dfp)])
    for f in (jf, tf):
        f.set_volume(0, 0.5)
        f.set_filter(0, "lowpass", 6000)
        steps(f)
        f.seek(0, 1.0)
        g = f.engine.groups[0]
        assert float(g.gain1[0]) == 0.5 and int(g.lp_kind[0]) == 1 and float(g.lp_a[0]) > 0
    cks = [f.checkpoint(0) for f in (jf, tf)]
    assert_checkpoints_equal(cks[1]["sub"], cks[0]["sub"])
    want = per_station(steps(jf), 1)[0]
    mostly_equal(per_station(steps(tf), 1)[0], want)
    for ck in cks:  # the post-seek checkpoint of either package into each
        for make in (lambda s: jax_fleet.Fleet(sources_for(jax_batch, s)),
                     lambda s: fleet.Fleet(sources_for(batch, s), device="cpu")):
            f2 = make([(DFPWM, dfp)])
            f2.restore(0, ck)
            mostly_equal(per_station(steps(f2), 1)[0], want)


def test_fleet_seek_requires_retained_source():
    wav = ak.tone(440, 0.5, 0.5, "sine", sample_rate=24000).wav(16)
    live = fleet.Fleet([wav], eof=False, device="cpu")
    with pytest.raises(ValueError, match="eof station"):
        live.seek(0, 0.1)


def _ima_pair(n):
    return [fixtures.wav_ima(fixtures.ima_wav_blocks(RNG, 40, 256, 1), 8000, 1, 256)
            for _ in range(n)]


def test_fleet_seek_mid_play_discards_fifo_remnant():
    """A mid-play seek with the group FIFO part-full drops the stale audio:
    bit-equal to the JAX Fleet, and to the undisturbed timelines."""
    w0, w1 = _ima_pair(2)
    base = per_station(steps(fleet.Fleet([w0, w1], device="cpu")), 2)
    jf, tf = twins([w0, w1])
    head = [[steps_one(f) for _ in range(2)] for f in (jf, tf)]
    assert_steps_equal(head[1], head[0])
    gi, _ = tf.engine._lane_map[tf.stations[0].lanes[0]]
    assert tf.engine.groups[gi].fill > 0
    for f in (jf, tf):
        assert f.seek(0, 0.0) == 0.0
    rest = run_twins(jf, tf)
    assert rest[0][2][0] == 0.0
    np.testing.assert_array_equal(per_station(rest, 2)[0], base[0])
    np.testing.assert_array_equal(per_station(head[1] + rest, 2)[1], base[1])


def steps_one(f):
    r = f.step()
    assert r is not None
    return to_numpy(r[0]), r[1].copy(), r[2].copy()


def test_fleet_reset_station_mid_play_no_stale_audio():
    w0, w1, w2 = _ima_pair(3)
    base = per_station(steps(fleet.Fleet([w2, w1], device="cpu")), 2)
    jf, tf = twins([w0, w1])
    for f in (jf, tf):
        for _ in range(2):
            assert f.step() is not None
        f.reset_station(0, w2)
    np.testing.assert_array_equal(per_station(run_twins(jf, tf), 2)[0], base[0])


def test_transcode_fleet_over_fleet_matches_jax():
    """``transcode_fleet`` over a port Fleet (WAV and FLAC stations) into a
    PCM16 encode engine: bytes equal the JAX package's over its Fleet."""
    from aukit_tpu.stream import batch_encode as jax_encode
    from aukit_tpu_torch.stream import batch_encode

    wav = ak.tone(330, 1.2, 0.6, "sine", sample_rate=24000).wav(16)
    fl = make_flac(44100, 30, seed=12)
    jf, tf = twins([wav, fl])
    outs = [mod.transcode_fleet(f, mod.BatchEncodeEngine([mod.EncodeSpec("pcm16")] * 2, **kw))
            for f, mod, kw in ((tf, batch_encode, {"device": "cpu"}), (jf, jax_encode, {}))]
    assert outs[0] == outs[1] and all(len(o) for o in outs[0])
