"""The engine's per-lane DSP stages (mono toggle -> normalize -> one-pole
filter, the batched auplay chain) against the JAX engine: the same bytes go
through ``aukit_tpu``'s jitted engine and ``aukit_tpu_torch``'s on the CPU.

The filter recurrence runs as ``associative_scan``'s combine tree with one
fused multiply-add per combine (``aukit_tpu_torch/ops/scan.py``). XLA leaves
a few of those multiply-adds unfused where its vectoriser shuffles the
product, so the float stream may differ from the JAX one by an ulp on about
one sample in a thousand (smallest case: 2 lanes x 136 samples in
``test_linear_scan_matches_associative_scan``); where it falls depends on
the shapes and on how XLA vectorises for the host CPU. Through the int8
quantiser that residue reaches 2 of the 2,256,000 filtered-lane samples of
this file (1.04e-5 of one lane's samples at worst). So a lane with a filter
set is held to ``RESIDUE_FRAC`` (99.99% of int8 samples equal, the rest
within 1 LSB) and its float carries to 1.2e-7; every other lane, normalize
gains and flags are held bit-equal. The scan alone is held to 1.2e-7 with
99% of samples bit-equal.

``test_windows_bit_equal_given_jax_scan`` swaps the port's scan for the
jitted ``associative_scan`` and holds the filtered lanes of the mono engine
cases bit-equal, windows and carries: where the float streams are equal,
so are the int8 windows.
"""
import math

import jax
import numpy as np
import pytest
import torch

from aukit_tpu.stream import batch as jax_batch
from aukit_tpu_torch.ops.scan import linear_scan
from aukit_tpu_torch.stream import batch
from tests.test_batch import norm16f
from tests.test_batch_dsp import fir_quant, mostly_equal, run_lanes, seq_filter
from tests.test_torch_batch import assert_checkpoints_equal

RNG_SEED = 7
# share of a filtered lane's int8 samples bit-equal to the JAX engine's
RESIDUE_FRAC = 0.9999
# True while the port runs the JAX scan: filtered lanes are then bit-equal
STRICT = False


def engines(specs, **kw):
    """A JAX engine and a port engine (CPU) over the same lane specs."""
    return (jax_batch.BatchStreamEngine([jax_batch.LaneSpec(*s) for s in specs], **kw),
            batch.BatchStreamEngine([batch.LaneSpec(*s) for s in specs], device="cpu", **kw))


def assert_residue(got, want):
    """A filtered lane's int8 samples: ``RESIDUE_FRAC`` of them bit-equal and
    the rest within 1 LSB (the scan's residue); all bit-equal under STRICT."""
    if STRICT:
        np.testing.assert_array_equal(got, want)
    else:
        mostly_equal(got, want, frac=RESIDUE_FRAC)


def assert_lanes_match(got, want, filtered=()):
    """Windows lane by lane: bit-equal, except that a lane in ``filtered``
    (a filter set) is held to ``assert_residue``."""
    for lane, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        if lane in filtered:
            assert_residue(g, w)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"lane {lane}")


def assert_carries_equal(jeng, teng, filtered=()):
    """Carried filter y/x, fir, started flags and gains, group by group:
    bit-equal, except the float carries of the engine lanes in ``filtered``,
    held to 1.2e-7 (the scan's residue)."""
    for jg, tg in zip(jeng.groups, teng.groups):
        loose = np.isin(tg.slots, () if STRICT else filtered)
        for name in ("filt_y", "filt_x", "fir"):
            j, t = np.asarray(getattr(jg, name))[: jg.lanes], getattr(tg, name).numpy()
            np.testing.assert_array_equal(t[~loose], j[~loose], err_msg=name)
            np.testing.assert_allclose(t[loose], j[loose], rtol=0, atol=1.2e-7, err_msg=name)
        np.testing.assert_array_equal(jg.filt_started[: jg.lanes], tg.filt_started)
        np.testing.assert_array_equal(jg.norm_gain[: jg.lanes], tg.norm_gain)


def assert_checkpoints_match(got, want):
    """Checkpoints of a filtered lane: the float carries (fir, filter y/x)
    within 1.2e-7 (the scan's residue), every other field equal."""
    if STRICT:
        return assert_checkpoints_equal(got, want)
    got = dict(got, dsp=dict(got["dsp"]))
    np.testing.assert_allclose(got["fir_state"], want["fir_state"], rtol=0, atol=1.2e-7)
    got["fir_state"] = want["fir_state"]
    for f in ("y", "x"):
        assert type(got["dsp"][f]) is type(want["dsp"][f])
        np.testing.assert_allclose(got["dsp"][f], want["dsp"][f], rtol=0, atol=1.2e-7)
        got["dsp"][f] = want["dsp"][f]
    assert_checkpoints_equal(got, want)


def feed_all(engs, datas):
    for eng in engs:
        for i, d in enumerate(datas):
            eng.feed(i, d)
            eng.feed(i, None)


def pcm(sig) -> bytes:
    return np.asarray(sig).astype("<i2").tobytes()


@pytest.mark.parametrize("n", [1, 2, 5, 8, 63, 64, 65, 127, 128, 129, 136, 48000])
def test_linear_scan_matches_associative_scan(n):
    """The port's tree against the jitted ``jax.lax.associative_scan`` of the
    same (A, B), lowpass at 12 kHz of 48 kHz over 8 lanes: within 1.2e-7
    (2 ulp at full scale) and at least 99% of samples bit-equal."""
    rng = np.random.default_rng(0)
    a = np.float32(1 - np.exp(-2 * np.pi * 12000 / 48000))
    x = rng.standard_normal((8, n)).astype(np.float32) * 0.3
    A = np.full((8, n), 1 - a, np.float32)
    A[:, 0] = 0
    B = (a * x).astype(np.float32)
    B[:, 0] = x[:, 0]

    @jax.jit
    def scan(A, B):
        return jax.lax.associative_scan(
            lambda p, q: (p[0] * q[0], q[0] * p[1] + q[1]), (A, B), axis=-1)[1]

    want = np.asarray(scan(A, B))
    got = linear_scan(torch.tensor(A), torch.tensor(B)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    assert (got.view(np.int32) == want.view(np.int32)).mean() >= 0.99


@pytest.mark.parametrize("kind", ["lowpass", "highpass"])
def test_lane_filter_matches_sequential_oracle(kind):
    """A filtered pcm16 lane across three carried-state chunks: the JAX
    engine's output within the scan's residue, and within the JAX test's
    tolerance of the sequential f64 reference filter."""
    n = int(48000 * 2.5)
    sig = (np.sin(np.arange(n) / 13.0) * 18000
           + np.sin(np.arange(n) / 271.0) * 9000).astype(np.int16)
    cutoff = 2000.0
    je, te = engines([("pcm16", 48000)], windowed=True)
    for e in (je, te):
        e.set_filter(0, kind, cutoff)
    feed_all((je, te), [pcm(sig)])
    want, got = run_lanes(je, 1)[0], run_lanes(te, 1)[0]
    assert_lanes_match([got], [want], filtered=(0,))
    assert_carries_equal(je, te, filtered=(0,))

    f = norm16f(sig.astype(np.int64)).astype(np.float64)
    a = (1.0 - math.exp(-(cutoff / 48000) * 2 * math.pi) if kind == "lowpass"
         else 1.0 / (2 * math.pi * (cutoff / 48000) + 1.0))
    exp = fir_quant(seq_filter(f, kind, a))
    mostly_equal(got[: len(exp)], exp)
    assert np.abs(got[-1000:].astype(np.int32)).max() <= 2


def test_lane_filter_batch_invariance():
    """The filtered lane is identical alone and beside unfiltered lanes, and
    the unfiltered lanes of the DSP-active group equal a DSP-free engine's."""
    rng = np.random.default_rng(RNG_SEED)
    n = 48000 * 2
    sig = (np.cos(np.arange(n) / 7.0) * 15000).astype(np.int16)
    other = rng.integers(-20000, 20000, n, dtype=np.int16)

    solo = batch.BatchStreamEngine([batch.LaneSpec("pcm16", 48000)], device="cpu",
                                   windowed=True)
    solo.set_filter(0, "lowpass", 4000)
    feed_all([solo], [pcm(sig)])
    a = run_lanes(solo, 1)[0]

    je, te = engines([("pcm16", 48000)] * 3, windowed=True)
    for e in (je, te):
        e.set_filter(1, "lowpass", 4000)
    feed_all((je, te), [pcm(other), pcm(sig), pcm(other)])
    b, jb = run_lanes(te, 3), run_lanes(je, 3)
    np.testing.assert_array_equal(a, b[1])
    assert_lanes_match(b, jb, filtered=(1,))
    plain = batch.BatchStreamEngine([batch.LaneSpec("pcm16", 48000)], device="cpu",
                                    windowed=True)
    feed_all([plain], [pcm(other)])
    np.testing.assert_array_equal(run_lanes(plain, 1)[0], b[0])


def test_lane_lowpass_matches_effects_lowpass():
    """A lowpass lane: the JAX engine's output within the scan's residue, and
    within 1 LSB of the
    solo chain ``effects.lowpass -> playback DSP`` of the JAX package."""
    import aukit_tpu as ak

    n = 48000 * 2
    sig = (np.sin(np.arange(n) / 29.0) * 24000).astype(np.int16)
    cutoff = 6000.0
    je, te = engines([("pcm16", 48000)], windowed=True)
    for e in (je, te):
        e.set_filter(0, "lowpass", cutoff)
    feed_all((je, te), [pcm(sig)])
    got, want = run_lanes(te, 1)[0], run_lanes(je, 1)[0]
    assert_lanes_match([got], [want], filtered=(0,))
    audio = ak.new_audio(norm16f(sig.astype(np.int64))[None], 48000)
    ak.effects.lowpass(audio, cutoff)
    exp = fir_quant(np.asarray(audio.data)[0].astype(np.float64))
    mostly_equal(got[: len(exp)], exp)


def test_engine_normalize_two_pass():
    """normalize(0.8): the port's gains equal the JAX engine's bit for bit,
    the buffers are untouched by the measuring pass, and the output hits
    the target amplitude."""
    n = 48000 * 2
    quiet = (np.sin(np.arange(n) / 11.0) * 3000).astype(np.int16)
    loud = (np.sin(np.arange(n) / 17.0) * 30000).astype(np.int16)
    je, te = engines([("pcm16", 48000)] * 2, windowed=True)
    feed_all((je, te), [pcm(quiet), pcm(loud)])
    je.normalize(0.8)
    te.normalize(0.8)
    np.testing.assert_array_equal(te.groups[0].norm_gain, je.groups[0].norm_gain[:2])
    for i, s in enumerate((quiet, loud)):
        peak = np.abs(norm16f(s.astype(np.int64))).max()
        assert np.isclose(te.groups[0].norm_gain[i], 0.8 / peak, rtol=1e-6)
    outs, jouts = run_lanes(te, 2), run_lanes(je, 2)
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(o, jo)
        assert len(o) == n
        peak8 = np.abs(o.astype(np.int32)).max()
        assert 0.74 * 127 <= peak8 <= 0.82 * 128


def test_engine_normalize_requires_eof():
    eng = batch.BatchStreamEngine([batch.LaneSpec("pcm16", 48000)], device="cpu",
                                  windowed=True)
    eng.feed(0, b"\x00\x00" * 100)
    with pytest.raises(ValueError, match="fed to EOF"):
        eng.normalize(0.8)
    eng.feed(0, None)
    eng.step()
    with pytest.raises(ValueError, match="before stepping"):
        eng.normalize(0.8)


def test_lane_mono_toggle_multichannel():
    """mono=False: a toggled stereo lane carries its channel mean on every
    channel, bit-equal to the JAX engine; untouched lanes keep distinct
    channels."""
    n = 48000
    left = (np.sin(np.arange(n) / 9.0) * 20000).astype(np.int16)
    right = (np.cos(np.arange(n) / 31.0) * 12000).astype(np.int16)
    inter = np.stack([left, right], axis=1).reshape(-1).astype("<i2").tobytes()
    je, te = engines([("pcm16", 48000, 2)] * 2, mono=False, windowed=True)
    for e in (je, te):
        e.set_mono(0, True)
    feed_all((je, te), [inter, inter])
    outs, jouts = run_lanes(te, 2), run_lanes(je, 2)
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(outs[0][0], outs[0][1])
    assert not np.array_equal(outs[1][0], outs[1][1])
    f = norm16f(np.stack([left, right]).astype(np.int64)).mean(axis=0)
    mostly_equal(outs[0][0][:n], fir_quant(f.astype(np.float64)))


def test_auplay_pipeline_fleet_wide():
    """The full auplay chain (mono + normalize(0.8) + lowpass(rate/2)) over
    a mixed fleet: a 24 kHz pcm16 lane and a 48 kHz DFPWM lane, whose group
    leaves the fused kernel for kernel (a) + stages. Bit-equal to the JAX
    engine, within the scan's residue on these filtered lanes."""
    rng = np.random.default_rng(RNG_SEED)
    n = 24000 * 2
    s16 = (np.sin(np.arange(n) / 5.0) * 8000).astype(np.int16)
    dfp = rng.integers(0, 256, 6000 * 2, dtype=np.uint8).tobytes()
    specs = [("pcm16", 24000), ("dfpwm", 48000)]
    je, te = engines(specs, windowed=True)
    for e in (je, te):
        for lane in range(2):
            e.set_mono(lane, True)
            e.set_filter(lane, "lowpass", e.specs[lane].sample_rate / 2)
    feed_all((je, te), [pcm(s16), dfp])
    je.normalize(0.8)
    te.normalize(0.8)
    for jg, tg in zip(je.groups, te.groups):
        np.testing.assert_array_equal(tg.norm_gain, jg.norm_gain[: jg.lanes])
    outs = run_lanes(te, 2)
    assert_lanes_match(outs, run_lanes(je, 2), filtered=(0, 1))
    for o in outs:
        assert len(o) > 48000
        assert np.abs(o.astype(np.int32)).max() >= 0.5 * 127
    assert_carries_equal(je, te, filtered=(0, 1))


def test_engine_dsp_checkpoint_resume():
    """Filter settings and carried filter state survive checkpoint/restore
    within the port and across packages both ways: the resumed output
    equals the uninterrupted run."""
    n = 48000 * 3
    sig = (np.sin(np.arange(n) / 21.0) * 15000).astype(np.int16)
    data = pcm(sig)
    full = batch.BatchStreamEngine([batch.LaneSpec("pcm16", 48000)], device="cpu",
                                   windowed=True)
    full.set_filter(0, "lowpass", 3000)
    feed_all([full], [data])
    ref = run_lanes(full, 1)[0]

    je, te = engines([("pcm16", 48000)], windowed=True)
    for e in (je, te):
        e.set_filter(0, "lowpass", 3000)
        e.feed(0, data[: 2 * 48000])
    heads = [np.asarray(e.step()[0])[0] for e in (je, te)]
    assert_lanes_match(heads[1:], heads[:1], filtered=(0,))
    jck, tck = je.checkpoint(0), te.checkpoint(0)
    assert tck["dsp"]["kind"] == 1 and tck["dsp"]["started"]
    assert_checkpoints_match(tck, jck)
    # port -> port resumes the port's run exactly; port -> JAX and JAX ->
    # port resume it within the scan's residue
    for ck, make in ((tck, "port"), (tck, "jax"), (jck, "port")):
        je2, te2 = engines([("pcm16", 48000)], windowed=True)
        eng = te2 if make == "port" else je2
        eng.restore(0, ck)
        eng.feed(0, data[ck["byte_offset"] + len(ck["pending"]):])
        eng.feed(0, None)
        tail = run_lanes(eng, 1)[0]
        resumed = np.concatenate([heads[1], tail])
        if ck is tck and make == "port":
            np.testing.assert_array_equal(resumed, ref)
        else:
            assert_residue(resumed, ref)


def test_stereo_filter_checkpoint_across_packages():
    """A filtered stereo lane of a mono=False engine (normalize gain, lowpass
    and mono toggle on the neighbour): checkpoints with f32[C] carries equal
    the JAX engine's and restore both ways with the same windows after."""
    rng = np.random.default_rng(RNG_SEED)
    n = 48000 * 3
    t = np.arange(n)
    stereo = [np.stack([np.sin(t / (5.0 + i)) * 14000 + rng.normal(0, 900, n),
                        np.cos(t / (13.0 + i)) * 9000], axis=1).astype("<i2").tobytes()
              for i in range(2)]
    spec = [("pcm16", 48000, 2)] * 2

    def setup(e):
        e.set_filter(0, "highpass", 300)
        e.set_filter(1, "lowpass", 5000)
        e.set_mono(1, True)
        feed_all([e], stereo)
        e.normalize(0.8)

    je, te = engines(spec, mono=False, windowed=True)
    for e in (je, te):
        setup(e)
    w = [np.asarray(e.step()[0]) for e in (je, te)]
    assert_lanes_match(list(w[1]), list(w[0]), filtered=(0, 1))
    cks = [(e.checkpoint(0), e.checkpoint(1)) for e in (je, te)]
    for j, p in zip(*cks):
        assert isinstance(p["dsp"]["y"], np.ndarray) and p["dsp"]["y"].shape == (2,)
        assert_checkpoints_match(p, j)
    rest_j = run_lanes(je, 2)
    for src, dst in ((1, 0), (0, 1)):
        je2, te2 = engines(spec, mono=False, windowed=True)
        eng = (te2, je2)[dst]
        for lane in range(2):
            ck = cks[src][lane]
            eng.restore(lane, ck)
            eng.feed(lane, stereo[lane][ck["byte_offset"] + len(ck["pending"]):])
            eng.feed(lane, None)
        assert_lanes_match(run_lanes(eng, 2), rest_j, filtered=(0, 1))


def test_set_filter_mid_stream_starts_fresh_recurrence():
    """A filter enabled on a lane that already stepped in a DSP-active group
    (normalize-only) starts fresh (y[0] = x[0]): the JAX engine's output
    within the scan's residue, and within 1 LSB of the oracle."""
    n = 48000 * 2
    sig = (np.sin(np.arange(n) / 13.0) * 15000
           + np.sin(np.arange(n) / 301.0) * 8000).astype(np.int16)
    cutoff = 2000.0
    je, te = engines([("pcm16", 48000)], windowed=True)
    feed_all((je, te), [pcm(sig)])
    outs = []
    for e in (je, te):
        e.normalize(0.8)
        r1 = e.step()
        assert r1 is not None and bool(r1[1][0])
        e.set_filter(0, "lowpass", cutoff)
        outs.append(np.concatenate([np.asarray(r1[0])[0], run_lanes(e, 1)[0]])[:n])
    assert_lanes_match(outs[1:], outs[:1], filtered=(0,))
    assert_carries_equal(je, te, filtered=(0,))

    f = norm16f(sig.astype(np.int64)).astype(np.float64)
    gf = 0.8 / np.abs(f).max() * f
    a = 1.0 - math.exp(-(cutoff / 48000) * 2 * math.pi)
    exp = fir_quant(np.concatenate([gf[:48000], seq_filter(gf[48000:], "lowpass", a)]))
    mostly_equal(outs[1], exp)


def test_set_filter_reconfigure_resets_transient_state():
    """Reconfiguring an active filter restarts the recurrence: the JAX
    engine's output within the scan's residue, and within 1 LSB of two fresh sequential filters."""
    n = 48000 * 2
    sig = (np.cos(np.arange(n) / 9.0) * 14000).astype(np.int16)
    je, te = engines([("pcm16", 48000)], windowed=True)
    for e in (je, te):
        e.set_filter(0, "lowpass", 8000)
    feed_all((je, te), [pcm(sig)])
    outs = []
    for e in (je, te):
        r1 = e.step()
        assert r1 is not None and bool(r1[1][0])
        e.set_filter(0, "lowpass", 1000)
        outs.append(np.concatenate([np.asarray(r1[0])[0], run_lanes(e, 1)[0]])[:n])
    assert_lanes_match(outs[1:], outs[:1], filtered=(0,))

    f = norm16f(sig.astype(np.int64)).astype(np.float64)
    a1 = 1.0 - math.exp(-(8000 / 48000) * 2 * math.pi)
    a2 = 1.0 - math.exp(-(1000 / 48000) * 2 * math.pi)
    exp = fir_quant(np.concatenate([seq_filter(f[:48000], "lowpass", a1),
                                    seq_filter(f[48000:], "lowpass", a2)]))
    mostly_equal(outs[1], exp)


def test_block_codec_lanes_with_stages():
    """Stages on block-codec lanes (IMA and MS ADPCM at 22.05 kHz, stereo
    QOA at 44.1 kHz with mono=False and the toggle on one lane), a highpass
    and a lowpass, normalize: unfiltered lanes bit-equal to the JAX engine,
    filtered ones within the scan's residue."""
    from aukit_tpu_torch.stream.batch_codecs import lane_spec_for_qoa, lane_spec_for_wav
    from tests import fixtures

    rng = np.random.default_rng(RNG_SEED)
    ba = 256
    ima = fixtures.wav_ima(fixtures.ima_wav_blocks(rng, 30, ba, 1), 22050, 1, ba)
    pcm_ms = (np.sin(np.arange(22050) / 7.0) * 12000).astype(np.int16)
    ms = fixtures.wav_msadpcm(fixtures.ms_encode(pcm_ms[None], ba), 22050, 1, ba)
    qoa = fixtures.qoa_stream(rng, 2, 44100, [5120, 5120])
    lanes = []
    for data, bridge in ((ima, lane_spec_for_wav), (ms, lane_spec_for_wav),
                         (qoa, lane_spec_for_qoa), (qoa, lane_spec_for_qoa)):
        spec, off, size = bridge(data)
        lanes.append((spec, data[off: off + size]))
    specs = [(s.codec, s.sample_rate, s.channels, s.block_align) for s, _ in lanes]
    je = jax_batch.BatchStreamEngine([jax_batch.LaneSpec(*s) for s in specs], mono=False)
    te = batch.BatchStreamEngine([batch.LaneSpec(*s) for s in specs], mono=False,
                                 device="cpu")
    for e in (je, te):
        e.set_filter(0, "highpass", 200)
        e.set_filter(2, "lowpass", 4000)
        e.set_mono(3, True)
    feed_all((je, te), [d for _, d in lanes])
    je.normalize(0.8)
    te.normalize(0.8)
    assert_lanes_match(run_lanes(te, 4), run_lanes(je, 4), filtered=(0, 2))
    assert_carries_equal(je, te, filtered=(0, 2))


@jax.jit
def _jax_scan(a_row, B):
    A = jax.numpy.broadcast_to(a_row, B.shape).at[..., 0].set(0.0)
    return jax.lax.associative_scan(
        lambda p, q: (p[0] * q[0], q[0] * p[1] + q[1]), (A, B), axis=-1)[1]


@pytest.mark.parametrize("case", [
    "lane_filter_lowpass", "lane_filter_highpass", "lane_filter_batch_invariance",
    "lane_lowpass_matches_effects_lowpass", "auplay_pipeline_fleet_wide",
    "engine_dsp_checkpoint_resume", "set_filter_mid_stream_starts_fresh_recurrence",
    "set_filter_reconfigure_resets_transient_state"])
def test_windows_bit_equal_given_jax_scan(case, monkeypatch):
    """The mono engine cases with the port's scan swapped for the jitted
    ``associative_scan`` of the same (A, B): every filtered lane's windows,
    carries and checkpoints bit-equal to the JAX engine's. Everything around
    the scan (stages, chain, quantiser, masks, carries) adds no residue.
    mono=False cases are left out: over [L, C, T] the jitted scan of a given
    B does not reproduce the engine's in-step scan (2 of 192,000 int8
    samples differ in ``test_block_codec_lanes_with_stages``)."""
    monkeypatch.setattr(batch, "linear_scan", lambda A, B: torch.tensor(
        np.asarray(_jax_scan(A[..., :1].numpy(), B.numpy()))))
    monkeypatch.setitem(globals(), "STRICT", True)
    if case.startswith("lane_filter_") and case.endswith("pass"):
        test_lane_filter_matches_sequential_oracle(case.rsplit("_", 1)[1])
    else:
        globals()["test_" + case]()
