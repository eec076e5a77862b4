"""Every lane codec of the engine: the same bytes go through aukit_tpu's
batched engine (JAX on the CPU, its scan route) and aukit_tpu_torch's (plain
PyTorch on the CPU). Windows, masks, positions and checkpoints must be
identical; the container bridges must map the same files to the same lanes."""

import dataclasses
import struct

import numpy as np
import pytest

from aukit_tpu.stream import batch as jax_batch
from aukit_tpu.stream import batch_codecs as jax_codecs
from aukit_tpu_torch.stream import batch, batch_codecs
from tests import fixtures
from tests.test_torch_batch import (assert_checkpoints_equal, assert_steps_equal, collect,
                                    collect_one, feed_lanes)

BYTES_PER_SAMPLE = {"pcm8": 1, "pcm8u": 1, "ulaw": 1, "alaw": 1, "pcm16": 2, "pcm16be": 2,
                    "pcm24": 3, "pcm24be": 3, "pcm32": 4, "pcm32be": 4, "f32": 4, "f32be": 4}
VOLUMES = ((0, 0.5, False), (1, 1.6, True))


def run_both(specs, feeds, volumes=VOLUMES, **engine_kw):
    """Run the port's and the JAX engine on the same per-lane feeds (EOF
    after each); -> [(steps, checkpoints, samples_decoded)] for each."""
    runs = []
    for module, kw in ((batch, {"device": "cpu"}), (jax_batch, {})):
        eng = module.BatchStreamEngine([module.LaneSpec(**dataclasses.asdict(s)) for s in specs],
                                       **kw, **engine_kw)
        for lane, vol, ramp in volumes:
            eng.set_volume(lane, vol, ramp=ramp)
        feed_lanes(eng, feeds)
        steps = collect(eng)
        runs.append((steps, [eng.checkpoint(lane) for lane in range(len(specs))],
                     eng.metrics.samples_decoded))
    return runs


def assert_runs_equal(runs):
    (got, got_ck, got_n), (want, want_ck, want_n) = runs
    assert len(want) > 1 and any(m.any() for _, m, _ in want)
    assert_steps_equal(got, want)
    for g, w in zip(got_ck, want_ck):
        assert_checkpoints_equal(g, w)
    assert got_n == want_n


def elementwise_feed(rng, codec: str, nbytes: int) -> bytes:
    if codec.startswith("f32"):  # finite float samples, as a float loader gives
        x = rng.uniform(-1, 1, -(-nbytes // 4)).astype(">f4" if codec == "f32be" else "<f4")
        return x.tobytes()[:nbytes]
    return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("codec", sorted(BYTES_PER_SAMPLE))
def test_elementwise_codec_engine_matches_jax(codec, channels):
    """Ragged EOF tails (a partial last sample too) and a volume ramp."""
    rng = np.random.default_rng(sorted(BYTES_PER_SAMPLE).index(codec) * 2 + channels)
    rate = 1000
    second = BYTES_PER_SAMPLE[codec] * rate * channels
    feeds = [elementwise_feed(rng, codec, second * (1 + i % 2) + 37 * i) for i in range(3)]
    assert_runs_equal(run_both([batch.LaneSpec(codec, rate, channels)] * 3, feeds))


@pytest.mark.parametrize("codec,channels", [(c, 2) for c in sorted(BYTES_PER_SAMPLE)]
                         + [("pcm16", 1), ("ulaw", 1), ("f32be", 1)])
def test_elementwise_codec_per_channel_matches_jax(codec, channels):
    """``mono=False``: windows int8[L, C, T], every channel through the
    resample and the FIR with its own carry, the ramp broadcast over them;
    checkpoints carry f32[C] rows."""
    rng = np.random.default_rng(100 + sorted(BYTES_PER_SAMPLE).index(codec) * 2 + channels)
    rate = 1000
    second = BYTES_PER_SAMPLE[codec] * rate * channels
    feeds = [elementwise_feed(rng, codec, second * (1 + i % 2) + 37 * i) for i in range(3)]
    runs = run_both([batch.LaneSpec(codec, rate, channels)] * 3, feeds, mono=False)
    assert runs[0][0][0][0].shape == (3, channels, 48000)
    assert runs[0][1][0]["fir_state"].shape == (channels,)
    assert_runs_equal(runs)


@pytest.mark.parametrize("mode", ["none", "cubic", "sinc"])
def test_per_channel_interpolation_modes_match_jax(mode):
    """The interpolators over a 3-D ``[L, C, T]`` block: XLA compiles another
    program than for ``[L, T]``, with the same fused multiply-adds."""
    rng = np.random.default_rng(120)
    feeds = [elementwise_feed(rng, "f32", 4 * 2 * 1000 * (1 + i) + 8 * i) for i in range(2)]
    runs = run_both([batch.LaneSpec("f32", 1000, 2)] * 2, feeds, interpolation=mode, mono=False)
    assert_runs_equal(runs)


def test_block_codecs_per_channel_match_jax():
    """Stereo IMA, MS ADPCM and QOA lanes and a mono IMA lane in one
    ``mono=False`` fleet (one-second windows, channel 0 replicated for the
    mono lane), short final QOA frame included."""
    rng = np.random.default_rng(130)
    rate = 2000
    ima2 = batch.LaneSpec("ima", rate, 2, block_align=72)
    ima1 = batch.LaneSpec("ima", rate, 1, block_align=36)
    ms2 = batch.LaneSpec("msadpcm", rate, 2, block_align=46)
    specs = [ima2, ima1, ms2, batch.LaneSpec("qoa", 5120, 2)]
    feeds = [fixtures.ima_wav_blocks(rng, 2 * batch_codecs.geometry(ima2)[0] // 72 + 3, 72, 2),
             fixtures.ima_wav_blocks(rng, batch_codecs.geometry(ima1)[0] // 36, 36, 1),
             fixtures.ms_encode(ms_signal(rng, 2, batch_codecs.geometry(ms2)[1] + 200), 46),
             fixtures.qoa_stream(rng, 2, 5120, [5120, 1000])[8:]]
    runs = run_both(specs, feeds, ((0, 0.5, False), (2, 1.6, True)), mono=False)
    first = runs[0][0][0][0]
    assert first.shape == (4, 2, 48000)
    np.testing.assert_array_equal(first[1, 0], first[1, 1])
    assert (first[0, 0] != first[0, 1]).any() and (first[3, 0] != first[3, 1]).any()
    assert_runs_equal(runs)


def test_three_channel_mixdown_matches_jax():
    """The mean mixdown over a channel count whose reciprocal is inexact."""
    rng = np.random.default_rng(11)
    feeds = [rng.integers(0, 256, 2 * 3 * 1000 * (1 + i), dtype=np.uint8).tobytes()
             for i in range(2)]
    assert_runs_equal(run_both([batch.LaneSpec("pcm16", 1000, 3)] * 2, feeds))


def ima_feeds(rng, ba, channels, blocks_per_step):
    """Valid IMA block streams: 1-2 steps of blocks, the last lane cut
    mid-block (a partial, zero-padded final block)."""
    feeds = [fixtures.ima_wav_blocks(rng, blocks_per_step * (1 + i % 2) + 3 * i, ba, channels)
             for i in range(3)]
    feeds[-1] = feeds[-1][: -(ba // 2)]
    return feeds


@pytest.mark.parametrize("channels,ba", [(1, 36), (2, 72)])
def test_ima_engine_matches_jax(channels, ba):
    rng = np.random.default_rng(20 + channels)
    rate = 2000
    spec = batch.LaneSpec("ima", rate, channels, block_align=ba)
    k = batch_codecs.geometry(spec)[0] // ba
    assert_runs_equal(run_both([spec] * 3, ima_feeds(rng, ba, channels, k)))


def ms_signal(rng, channels, n):
    t = np.arange(n)
    f = rng.uniform(0.01, 0.2, (channels, 1))
    return (np.sin(t * f) * rng.uniform(3000, 20000, (channels, 1))).astype(np.int64)


@pytest.mark.parametrize("channels,ba", [(1, 32), (2, 46)])
def test_msadpcm_engine_matches_jax(channels, ba):
    """Real encoder output (signal-scaled deltas), 1-2 steps per lane, the
    last lane cut mid-block."""
    rng = np.random.default_rng(30 + channels)
    rate = 2000
    spec = batch.LaneSpec("msadpcm", rate, channels, block_align=ba)
    in_bytes, in_samples = batch_codecs.geometry(spec)
    feeds = [fixtures.ms_encode(ms_signal(rng, channels, in_samples * (1 + i % 2) + 200), ba)
             for i in range(3)]
    feeds[-1] = feeds[-1][: -(ba // 3)]
    assert_runs_equal(run_both([spec] * 3, feeds))


@pytest.mark.parametrize("channels", [1, 2])
def test_qoa_engine_matches_jax(channels):
    """Full frames and a short final frame (header-count masking)."""
    rng = np.random.default_rng(40 + channels)
    rate = 5120
    feeds = [fixtures.qoa_stream(rng, channels, rate, [5120, 1000])[8:],
             fixtures.qoa_stream(rng, channels, rate, [5120])[8:]]
    assert_runs_equal(run_both([batch.LaneSpec("qoa", rate, channels)] * 2, feeds))


def test_mixed_fleet_matches_jax():
    """bench.py's mixed fleet (DFPWM 48 kHz, PCM16 44.1 kHz, IMA 22.05 kHz
    block_align 256, µ-law 8 kHz) in one engine, two lanes each."""
    rng = np.random.default_rng(50)
    specs = ([batch.LaneSpec("dfpwm", 48000)] * 2 + [batch.LaneSpec("pcm16", 44100)] * 2
             + [batch.LaneSpec("ima", 22050, 1, block_align=256)] * 2
             + [batch.LaneSpec("ulaw", 8000)] * 2)
    feeds = [rng.integers(0, 256, 3000, dtype=np.uint8).tobytes() for _ in range(2)]
    feeds += [rng.integers(0, 256, 2 * 44100 + 20000 * i, dtype=np.uint8).tobytes()
              for i in range(2)]
    feeds += [fixtures.ima_wav_blocks(rng, 50 + 20 * i, 256, 1) for i in range(2)]
    feeds += [rng.integers(0, 256, 9000 + 7000 * i, dtype=np.uint8).tobytes() for i in range(2)]
    vols = ((0, 0.5, False), (3, 1.6, True), (4, 0.3, True))
    assert_runs_equal(run_both(specs, feeds, vols))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_block_codec_checkpoint_restores_across_packages(direction):
    """A mid-stream checkpoint of IMA lanes (``codec_state == []``, the
    pending bytes, a volume ramp) continues bit-identically in the other
    package's engine."""
    rng = np.random.default_rng(60)
    spec = batch.LaneSpec("ima", 2000, 1, block_align=36)
    feeds = ima_feeds(rng, 36, 1, batch_codecs.geometry(spec)[0] // 36)

    def make(module):
        kw = {"device": "cpu"} if module is batch else {}
        return module.BatchStreamEngine(
            [module.LaneSpec(**dataclasses.asdict(spec))] * len(feeds), **kw)

    src_mod, dst_mod = (jax_batch, batch) if direction == "jax_to_port" else (batch, jax_batch)
    src = make(src_mod)
    src.set_volume(1, 0.4, ramp=True)
    feed_lanes(src, feeds)
    collect_one(src)
    src.set_volume(2, 1.3, ramp=True)
    dst = make(dst_mod)
    for lane in range(len(feeds)):
        ckpt = src.checkpoint(lane)
        assert ckpt["codec_state"] == []
        dst.restore(lane, ckpt)
    assert_steps_equal(collect(dst), collect(src))
    for lane in range(len(feeds)):
        assert_checkpoints_equal(dst.checkpoint(lane), src.checkpoint(lane))


def dfpwm_wav(payload: bytes) -> bytes:
    """DFPWM in a WAVE_FORMAT_EXTENSIBLE fmt chunk (the DFPWM UUID)."""
    fmt = struct.pack("<HHIIHHHHI", 0xFFFE, 1, 48000, 6000, 1, 1, 22, 1, 4)
    return fixtures._riff(fmt + bytes.fromhex("3ac1fa38811d4361a40dce53ca607cd1"), payload)


def container_files():
    rng = np.random.default_rng(70)
    sig = (np.sin(np.arange(2000) / 7.0) * 9000).astype(np.int64)
    stereo = np.stack([sig, sig[::-1]])
    raw = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    return {
        "wav_pcm16_stereo": ("wav", fixtures.wav_pcm(stereo, 22050, 16)),
        "wav_pcm24": ("wav", fixtures.wav_pcm(sig[None, :] * 100, 44100, 24)),
        "wav_pcm32": ("wav", fixtures.wav_pcm(sig[None, :] * 10000, 44100, 32)),
        "wav_pcm8u": ("wav", fixtures.wav_pcm((sig[None, :] >> 8) + 128, 8000, 8)),
        "wav_f32": ("wav", fixtures.wav_pcm(stereo.astype(np.float32) / 9000, 48000, 32)),
        "wav_ulaw": ("wav", fixtures.wav_g711(raw, 8000, 1, True)),
        "wav_alaw_stereo": ("wav", fixtures.wav_g711(raw, 8000, 2, False)),
        "wav_ima": ("wav", fixtures.wav_ima(fixtures.ima_wav_blocks(rng, 4, 256, 1),
                                            22050, 1, 256)),
        "wav_msadpcm_stereo": ("wav", fixtures.wav_msadpcm(fixtures.ms_encode(stereo, 512),
                                                           11025, 2, 512)),
        "wav_dfpwm": ("wav", dfpwm_wav(raw)),
        "aiff_pcm16be": ("aiff", fixtures.aiff_file(sig.astype(">i2").tobytes(), 1, 24000, 16)),
        "aifc_sowt": ("aiff", fixtures.aiff_file(stereo.T.astype("<i2").tobytes(), 2, 44100, 16,
                                                 aifc=True, compression=b"sowt")),
        "aifc_ulaw": ("aiff", fixtures.aiff_file(raw, 1, 8000, 8, aifc=True,
                                                 compression=b"ulaw")),
        "au_ulaw": ("au", fixtures.au_file(raw, 1, 8000, 1)),
        "au_pcm16be_stereo": ("au", fixtures.au_file(stereo.T.astype(">i2").tobytes(), 3,
                                                     16000, 2)),
        "au_f32be": ("au", fixtures.au_file(sig.astype(">f4").tobytes(), 6, 32000, 1)),
        "au_alaw": ("au", fixtures.au_file(raw, 27, 8000, 1)),
        "qoa_stereo": ("qoa", fixtures.qoa_stream(rng, 2, 44100, [5120, 700]) + b"\x00" * 8),
    }


@pytest.mark.parametrize("name", sorted(container_files()))
def test_bridge_maps_files_like_jax(name):
    kind, data = container_files()[name]
    fn = f"lane_spec_for_{kind}"
    spec, off, size = getattr(batch_codecs, fn)(data)
    want_spec, want_off, want_size = getattr(jax_codecs, fn)(data)
    assert isinstance(spec, batch.LaneSpec)
    assert dataclasses.astuple(spec) == dataclasses.astuple(want_spec)
    assert (off, size) == (want_off, want_size)


def test_bridges_reject_what_jax_rejects():
    for fn in ("lane_spec_for_wav", "lane_spec_for_aiff", "lane_spec_for_au",
               "lane_spec_for_qoa"):
        for module in (batch_codecs, jax_codecs):
            with pytest.raises(ValueError):
                getattr(module, fn)(b"\x00" * 64)


def test_mdfpwm_to_lanes_matches_jax():
    rng = np.random.default_rng(80)
    left = rng.integers(0, 256, 14000, dtype=np.uint8).tobytes()
    right = rng.integers(0, 256, 14000, dtype=np.uint8).tobytes()
    for length in (28000, 19001):
        f = fixtures.mdfpwm_file(left, right, length)
        spec, lb, rb = batch_codecs.mdfpwm_to_lanes(f)
        want_spec, want_lb, want_rb = jax_codecs.mdfpwm_to_lanes(f)
        assert dataclasses.astuple(spec) == dataclasses.astuple(want_spec)
        assert (lb, rb) == (want_lb, want_rb)
