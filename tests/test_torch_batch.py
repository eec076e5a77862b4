"""The slice as a whole: the same bytes go through aukit_tpu's batched engine
(JAX on the CPU) and aukit_tpu_torch's (plain PyTorch on the CPU). Windows,
masks, positions and checkpoints must be identical, and a checkpoint of
either engine must restore into the other."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aukit_tpu.stream import batch as jax_batch
from aukit_tpu_torch.stream import batch
from tests import fixtures

REPO = Path(__file__).resolve().parent.parent
RATES = (8000, 11025)  # a mixed fleet of cheap-to-decode rates (1 s windows)


def to_numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def collect(eng):
    steps = []
    while (r := eng.step()) is not None:
        steps.append((to_numpy(r[0]), r[1].copy(), r[2].copy()))
    return steps


def feed_lanes(eng, feeds, eof=True):
    for lane, data in enumerate(feeds):
        eng.feed(lane, data)
        if eof:
            eng.feed(lane, None)


def assert_steps_equal(got, want):
    assert len(got) == len(want)
    for i, ((wg, mg, pg), (ww, mw, pw)) in enumerate(zip(got, want)):
        assert wg.dtype == ww.dtype == np.int8
        np.testing.assert_array_equal(wg, ww, err_msg=f"window {i}")
        np.testing.assert_array_equal(mg, mw, err_msg=f"mask {i}")
        np.testing.assert_array_equal(pg, pw, err_msg=f"positions {i}")


def assert_values_equal(got, want, what):
    """Same type, and equal: a per-channel checkpoint field is an f32[C] row."""
    assert type(got) is type(want), what
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def assert_checkpoints_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "codec_state":
            assert [type(x) for x in got[k]] == [type(x) for x in want[k]]
            np.testing.assert_array_equal(got[k], want[k])
        elif k == "dsp":
            assert got[k].keys() == want[k].keys()
            for f in want[k]:
                assert_values_equal(got[k][f], want[k][f], f"dsp.{f}")
        else:
            assert_values_equal(got[k], want[k], k)


def ragged_feeds(rng, lanes, chunk):
    """Lanes end at different steps, most with a partial (zero-padded) tail."""
    return [rng.integers(0, 256, chunk * (1 + i % 3) + 37 * (i % 5), dtype=np.uint8).tobytes()
            for i in range(lanes)]


VOLUMES = ((0, 0.5, False), (2, 1.7, False), (3, 0.25, True))


def test_identity_rate_engine_matches_jax():
    """48 kHz lanes (the fused decode+DSP route) with ragged EOF tails and a
    volume ramp; checkpoints after the first step and at the end."""
    rng = np.random.default_rng(1)
    lanes, chunk = 8, 400
    feeds = ragged_feeds(rng, lanes, chunk)
    runs = []
    for eng in (batch.BatchDfpwmDecoder(lanes, 48000, chunk_bytes=chunk, device="cpu"),
                jax_batch.BatchDfpwmDecoder(lanes, 48000, chunk_bytes=chunk)):
        for lane, vol, ramp in VOLUMES:
            eng.set_volume(lane, vol, ramp=ramp)
        feed_lanes(eng, feeds)
        first = collect_one(eng)
        mid = [eng.checkpoint(lane) for lane in range(lanes)]
        runs.append(([first, *collect(eng)], mid, [eng.checkpoint(lane) for lane in range(lanes)],
                     eng.metrics.samples_decoded, eng.metrics.underruns))
    (got, got_mid, got_end, got_n, got_u), (want, want_mid, want_end, want_n, want_u) = runs
    assert_steps_equal(got, want)
    for g, w in zip(got_mid + got_end, want_mid + want_end):
        assert_checkpoints_equal(g, w)
    assert (got_n, got_u) == (want_n, want_u)


def collect_one(eng):
    r = eng.step()
    return to_numpy(r[0]), r[1].copy(), r[2].copy()


def test_bulk_fed_engine_matches_jax():
    """feed_array in two segments, the second ending mid-chunk at EOF."""
    rng = np.random.default_rng(2)
    lanes, chunk = 4, 300
    a = rng.integers(0, 256, (lanes, 450), dtype=np.uint8)
    b = rng.integers(0, 256, (lanes, 250), dtype=np.uint8)
    runs = []
    for eng in (batch.BatchDfpwmDecoder(lanes, 48000, chunk_bytes=chunk, device="cpu"),
                jax_batch.BatchDfpwmDecoder(lanes, 48000, chunk_bytes=chunk)):
        eng.feed_array(a, eof=False)
        eng.feed_array(b, eof=True)
        runs.append((collect(eng), eng.checkpoint(1)))
    assert_steps_equal(runs[0][0], runs[1][0])
    assert_checkpoints_equal(runs[0][1], runs[1][1])


def test_bulk_fed_engine_takes_torch_tensors():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (3, 500), dtype=np.uint8)
    outs = []
    for arr in (data, torch.tensor(data)):
        eng = batch.BatchDfpwmDecoder(3, 48000, chunk_bytes=200, device="cpu")
        eng.feed_array(arr)
        outs.append((collect(eng), eng.checkpoint(2)))
    assert_steps_equal(outs[0][0], outs[1][0])
    assert_checkpoints_equal(outs[0][1], outs[1][1])


def mixed_specs(module, lanes):
    return [module.LaneSpec("dfpwm", RATES[i % 2]) for i in range(lanes)]


def test_mixed_rate_fleet_matches_jax():
    """Heterogeneous fleet: per-group decode kernel + dsp_chain, device FIFOs
    and one-second windows, with ragged EOF and a volume ramp."""
    rng = np.random.default_rng(4)
    lanes = 6
    feeds = [rng.integers(0, 256, 900 + 450 * i, dtype=np.uint8).tobytes()
             for i in range(lanes)]
    runs = []
    for module, kw in ((batch, {"device": "cpu"}), (jax_batch, {})):
        eng = module.BatchStreamEngine(mixed_specs(module, lanes), **kw)
        for lane, vol, ramp in VOLUMES:
            eng.set_volume(lane, vol, ramp=ramp)
        feed_lanes(eng, feeds)
        runs.append((collect(eng), [eng.checkpoint(lane) for lane in range(lanes)]))
    assert_steps_equal(runs[0][0], runs[1][0])
    for g, w in zip(runs[0][1], runs[1][1]):
        assert_checkpoints_equal(g, w)


NONFINITE_GAINS = (float("nan"), 3e38, -3e38, 1e30, -1e30)


def test_nonfinite_gains_match_jax():
    """``set_volume`` with NaN and with gains that overflow float32 in the
    ramp or at the int8 scaling (0 * inf is NaN there), at rest and as a
    ramp, on identity-rate (the fused decode + DSP's plain version) and 32 kHz
    (``dsp_chain``'s int8 cast) DFPWM lanes: the port's windows equal the JAX
    engine's jitted step, where XLA's float -> int8 cast saturates and gives
    0 for NaN. The 32 kHz lanes run a second window, at rest after the ramp."""
    rng = np.random.default_rng(60)
    lanes = 4 * len(NONFINITE_GAINS)
    feeds = [rng.integers(0, 256, 4500, dtype=np.uint8).tobytes() for _ in range(lanes)]
    runs = []
    for module, kw in ((batch, {"device": "cpu"}), (jax_batch, {})):
        specs = [module.LaneSpec("dfpwm", 48000 if i % 2 == 0 else 32000) for i in range(lanes)]
        eng = module.BatchStreamEngine(specs, **kw)
        for i in range(lanes):
            eng.set_volume(i, NONFINITE_GAINS[i // 4], ramp=i % 4 >= 2)
        feed_lanes(eng, feeds)
        runs.append((collect(eng), [eng.checkpoint(lane) for lane in range(lanes)]))
    (got, got_ck), (want, want_ck) = runs
    assert len(got) == 2
    assert_steps_equal(got, want)
    for g, w in zip(got_ck, want_ck):
        np.testing.assert_equal(g, w)  # a NaN volume equals itself here
    first = got[0][0]
    assert not first[:4].any()  # a NaN gain is silence, at rest and as a ramp
    assert first[4:8].max() == 127 and first[4:8].min() == -128  # 3e38: both rails


def test_reset_lane_mid_window_matches_jax():
    """reset_lane on a lane whose group FIFO still holds samples: its read
    cursor skips the stale columns (the per-lane-cursor pop)."""
    rng = np.random.default_rng(5)
    lanes = 4
    feeds = [rng.integers(0, 256, 2800, dtype=np.uint8).tobytes() for _ in range(lanes)]
    fresh = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    runs = []
    for module, kw in ((batch, {"device": "cpu"}), (jax_batch, {})):
        eng = module.BatchStreamEngine(mixed_specs(module, lanes), **kw)
        feed_lanes(eng, feeds)
        first = collect_one(eng)
        eng.reset_lane(1)  # an 11025 Hz lane: its group FIFO is not empty
        assert eng.groups[eng._lane_map[1][0]].skip.max() > 0
        eng.feed(1, fresh)
        eng.feed(1, None)
        runs.append([first, *collect(eng)])
    assert_steps_equal(runs[0], runs[1])


def test_lane_iterator_matches_jax():
    rng = np.random.default_rng(6)
    feeds = ragged_feeds(rng, 3, 250)
    outs = []
    for eng in (batch.BatchDfpwmDecoder(3, 48000, chunk_bytes=250, device="cpu"),
                jax_batch.BatchDfpwmDecoder(3, 48000, chunk_bytes=250)):
        feed_lanes(eng, feeds)
        outs.append(list(eng.lane_iterator(2)))
    assert len(outs[0]) == len(outs[1]) > 1
    for (cg, pg), (cw, pw) in zip(*outs):
        np.testing.assert_array_equal(cg, np.asarray(cw))
        assert pg == pw


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_packages(direction):
    """A mid-stream checkpoint (codec state, FIR state, a volume ramp, the
    pending bytes) taken by one engine continues bit-identically in the
    other."""
    rng = np.random.default_rng(7)
    lanes, chunk = 4, 300
    feeds = ragged_feeds(rng, lanes, chunk)

    def make(module):
        kw = {"device": "cpu"} if module is batch else {}
        return module.BatchDfpwmDecoder(lanes, 48000, chunk_bytes=chunk, **kw)

    src_mod, dst_mod = (jax_batch, batch) if direction == "jax_to_port" else (batch, jax_batch)
    src = make(src_mod)
    src.set_volume(1, 0.4, ramp=True)
    feed_lanes(src, feeds)
    collect_one(src)
    src.set_volume(3, 1.3, ramp=True)  # pending ramp carried in the checkpoint
    dst = make(dst_mod)
    for lane in range(lanes):
        dst.restore(lane, src.checkpoint(lane))
    assert_steps_equal(collect(dst), collect(src))
    for lane in range(lanes):
        assert_checkpoints_equal(dst.checkpoint(lane), src.checkpoint(lane))


def test_unported_pieces_raise():
    """Nothing is left unported: every ``mesh`` option takes the port's mesh
    (``make_mesh``) and raises TypeError naming ``make_mesh`` for any other
    object; the DSP stages are ported: a checkpoint that carries them
    restores (it raised before they were)."""
    from aukit_tpu_torch.parallel.pipeline import make_mesh
    from aukit_tpu_torch.stream.batch_encode import BatchEncodeEngine, EncodeSpec
    from aukit_tpu_torch.stream.flac_fleet import FlacFleet
    from aukit_tpu_torch.stream.fleet import Fleet

    wav = fixtures.wav_pcm(np.zeros((1, 800), np.int16), 8000, 16)
    for make in (lambda m: FlacFleet(2, mesh=m, device="cpu"),
                 lambda m: Fleet([wav], mesh=m, device="cpu"),
                 lambda m: BatchEncodeEngine([EncodeSpec("dfpwm")], mesh=m, device="cpu")):
        with pytest.raises(TypeError, match="make_mesh"):
            make(object())
        assert make(make_mesh(2, device="cpu")) is not None
    eng = batch.BatchDfpwmDecoder(2, 48000, chunk_bytes=100, device="cpu")
    ckpt = eng.checkpoint(0)
    ckpt["dsp"] = {**ckpt["dsp"], "kind": 1, "alpha": 0.25, "y": 0.5}
    eng.restore(1, ckpt)
    g = eng.groups[0]
    assert g.lp_kind[1] == 1 and g.lp_a[1] == np.float32(0.25) and float(g.filt_y[1]) == 0.5
    ckpt = batch.BatchStreamEngine([batch.LaneSpec("pcm16", 8000, 2)], device="cpu",
                                   mono=False).checkpoint(0)
    assert ckpt["dsp"]["y"].shape == (2,)
    with pytest.raises(ValueError):
        batch.LaneSpec("dfpwm", channels=2)


# -- per-channel windows (mono=False; twins of tests/test_batch.py:878-955) ---------------

def stereo_pcm16(rate, seconds=1.0):
    t = np.arange(int(rate * seconds))
    left = (np.sin(t / 9.0) * 20000).astype(np.int16)
    right = (np.cos(t / 5.0) * 15000).astype(np.int16)
    return np.stack([left, right], axis=1).reshape(-1).tobytes()


def both_per_channel(specs, feeds, volumes=()):
    """The same per-lane feeds through both packages' ``mono=False`` engines
    -> [(engine, steps)]."""
    runs = []
    for module, kw in ((batch, {"device": "cpu"}), (jax_batch, {})):
        eng = module.BatchStreamEngine([module.LaneSpec(*s) for s in specs], mono=False, **kw)
        for lane, vol, ramp in volumes:
            eng.set_volume(lane, vol, ramp=ramp)
        feed_lanes(eng, feeds)
        runs.append((eng, collect(eng)))
    return runs


def test_per_channel_pcm16_stereo_matches_jax():
    """A stereo pcm16 lane emits int8[C, T] windows, no mixdown, with a
    volume ramp broadcast over the channels."""
    rate = 24000
    (eng, got), (jeng, want) = both_per_channel([("pcm16", rate, 2)], [stereo_pcm16(rate)],
                                                [(0, 0.6, True)])
    assert eng.out_channels == jeng.out_channels == 2
    assert got[0][0].shape == (1, 2, 48000)
    assert_steps_equal(got, want)
    assert (got[0][0][0, 0] != got[0][0][0, 1]).any()
    assert_checkpoints_equal(eng.checkpoint(0), jeng.checkpoint(0))


def test_per_channel_mixed_fleet_and_channel_pad_matches_jax():
    """A mixed ``mono=False`` fleet: the stereo QOA lane keeps its channels,
    the mono DFPWM lanes (the fused identity-rate route and an 8 kHz lane)
    pad to the fleet's 2-channel window by replicating channel 0."""
    rng = np.random.default_rng(9)
    specs = [("dfpwm", 48000), ("qoa", 10240, 2), ("dfpwm", 8000)]
    feeds = [rng.integers(0, 256, 6000, dtype=np.uint8).tobytes(),
             fixtures.qoa_stream(rng, 2, 10240, [5120, 5120])[8:],
             rng.integers(0, 256, 1700, dtype=np.uint8).tobytes()]
    (eng, got), (jeng, want) = both_per_channel(specs, feeds, [(2, 0.5, False)])
    assert len(got) == 2 and got[0][0].shape == (3, 2, 48000)
    assert_steps_equal(got, want)
    for lane in (0, 2):
        np.testing.assert_array_equal(got[0][0][lane, 0], got[0][0][lane, 1])
    assert (got[0][0][1, 0] != got[0][0][1, 1]).any()
    for lane in range(3):
        assert_checkpoints_equal(eng.checkpoint(lane), jeng.checkpoint(lane))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_per_channel_checkpoint_restores_across_packages(direction):
    """``mono=False`` checkpoints carry a per-channel FIR row (f32[C]); a
    mid-stream checkpoint of one package's engine continues bit-identically
    in the other's."""
    rate = 24000
    sig = (np.sin(np.arange(rate * 2) / 7.0) * 9000).astype(np.int16)
    inter = np.stack([sig, -sig // 2], axis=1).reshape(-1).tobytes()

    def make(module):
        kw = {"device": "cpu"} if module is batch else {}
        return module.BatchStreamEngine([module.LaneSpec("pcm16", rate, 2)] * 2, mono=False, **kw)

    src_mod, dst_mod = (jax_batch, batch) if direction == "jax_to_port" else (batch, jax_batch)
    src = make(src_mod)
    feed_lanes(src, [inter, inter[: len(inter) // 2 + 10000]])
    collect_one(src)
    src.set_volume(1, 1.3, ramp=True)
    dst = make(dst_mod)
    for lane in range(2):
        ck = src.checkpoint(lane)
        assert isinstance(ck["fir_state"], np.ndarray) and ck["fir_state"].shape == (2,)
        assert ck["fir_state"].dtype == np.float32 and ck["fir_state"].any()
        dst.restore(lane, ck)
        np.testing.assert_array_equal(to_numpy(dst.groups[0].fir)[lane], ck["fir_state"])
    assert_steps_equal(collect(dst), collect(src))
    for lane in range(2):
        assert_checkpoints_equal(dst.checkpoint(lane), src.checkpoint(lane))


def test_per_channel_lane_iterator_and_reset_match_jax():
    """``lane_iterator`` yields [C, T] chunks (sink i takes channel i); a
    ``reset_lane`` mid-window reads the per-channel FIFO at the lane's own
    cursor."""
    rng = np.random.default_rng(10)
    rate = 8000  # two QOA frames a step: 1.28 s, so a window leaves samples in the FIFO
    specs = [("pcm16", rate, 2), ("qoa", rate, 2)]
    feeds = [stereo_pcm16(rate, 2.5), fixtures.qoa_stream(rng, 2, rate, [5120] * 4)[8:]]
    fresh = fixtures.qoa_stream(rng, 2, rate, [5120, 3000])[8:]
    outs = []
    for module, kw in ((batch, {"device": "cpu"}), (jax_batch, {})):
        eng = module.BatchStreamEngine([module.LaneSpec(*s) for s in specs], mono=False, **kw)
        feed_lanes(eng, feeds)
        first = collect_one(eng)
        eng.reset_lane(1)  # its group FIFO still holds samples
        assert eng.groups[1].skip.max() > 0
        eng.feed(1, fresh)
        eng.feed(1, None)
        outs.append((first, [(np.asarray(c), p) for c, p in eng.lane_iterator(1)]))
    (first_g, got), (first_w, want) = outs
    assert_steps_equal([first_g], [first_w])
    assert len(got) == len(want) > 1
    for (cg, pg), (cw, pw) in zip(got, want):
        assert cg.shape == (2, 48000) and cg.dtype == np.int8
        np.testing.assert_array_equal(cg, cw)
        assert pg == pw


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.BatchDfpwmDecoder(2)


def test_engines_take_the_jax_positional_arguments():
    """``BatchStreamEngine(specs, mesh, use_pallas, mono, ...)`` and
    ``BatchDfpwmDecoder(lanes, sample_rate, chunk_bytes, mesh, use_pallas,
    codec)`` as in the JAX package, the device keyword only (ROADMAP queue 3,
    fault 3.5): the same windows as the JAX engines; a mesh in the mesh
    slot must be the port's (``make_mesh``; another object raises
    TypeError), as for FlacFleet, Fleet and BatchEncodeEngine."""
    data = np.random.default_rng(404).integers(0, 256, (2, 300), dtype=np.uint8)
    pairs = []
    for module, kw in ((batch, {"device": "cpu"}), (jax_batch, {})):
        specs = [module.LaneSpec("pcm16", 24000), module.LaneSpec("dfpwm", 48000)]
        pairs.append((module.BatchDfpwmDecoder(2, 48000, 100, None, None, "dfpwm", **kw),
                      module.BatchStreamEngine(specs, None, None, False, **kw)))
    for port_eng, jax_eng in zip(*pairs):
        outs = []
        for eng in (port_eng, jax_eng):
            for lane in range(2):
                eng.feed(lane, data[lane].tobytes())
                eng.feed(lane, None)
            outs.append([(np.asarray(r[0]), np.asarray(r[1])) for r in iter(eng.step, None)])
        assert len(outs[0]) == len(outs[1]) > 0
        for (w, m), (jw, jm) in zip(*outs):
            np.testing.assert_array_equal(w, jw)
            np.testing.assert_array_equal(m, jm)
    specs = [batch.LaneSpec("pcm16", 24000)]
    from aukit_tpu_torch.parallel.pipeline import make_mesh

    for make in (lambda m: batch.BatchStreamEngine(specs, m, device="cpu"),
                 lambda m: batch.BatchDfpwmDecoder(2, 48000, 100, m, device="cpu")):
        with pytest.raises(TypeError, match="make_mesh"):
            make(object())
        assert make(make_mesh(2, device="cpu")).mesh.size == 2
    assert batch.BatchStreamEngine(specs, None, False, device="cpu").device.type == "cpu"


def test_port_imports_and_runs_without_jax():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["aukit_tpu"] = None
import numpy as np
import aukit_tpu_torch as t
rng = np.random.default_rng(0)
eng = t.BatchDfpwmDecoder(4, 48000, chunk_bytes=64, device="cpu")
eng.feed_array(rng.integers(0, 256, (4, 150), dtype=np.uint8))
n = 0
while (r := eng.step()) is not None:
    assert r[0].shape == (4, 512) and r[1].all()
    n += 1
assert n == 3 and eng.done
# a heterogeneous fleet with a block-codec (IMA, QOA) group of each kernel
specs = [t.LaneSpec("ima", 2000, 1, block_align=36), t.LaneSpec("qoa", 5120, 1),
         t.LaneSpec("pcm16", 1000)]
eng = t.BatchStreamEngine(specs, device="cpu")
for lane, nbytes in enumerate((36 * 32, 8 + 16 + 256 * 8, 2000)):
    eng.feed(lane, rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())
    eng.feed(lane, None)
windows = []
while (r := eng.step()) is not None:
    assert r[0].shape == (3, 48000)
    windows.append(r[1])
assert len(windows) == 2 and windows[0].all() and eng.done
assert eng.checkpoint(0)["codec_state"] == []
# the FLAC fleet: the host route, and the device-resident route on the CPU
from tests import fixtures
sig = [int(v) for v in rng.integers(-500, 500, 256)]
frame = fixtures.flac_frame([{"type": "verbatim", "values": sig}], 256, 0, 16)
data = fixtures.flac_stream_header(8000, 1, 16, 256 * 40) + frame * 40
for kw in ({}, {"device_restore": True, "device_dsp": True}):
    fleet = t.FlacFleet(2, device="cpu", **kw)
    fleet.feed_many([data, data[:5000]])
    fleet.feed_many([None, None])
    r = fleet.step()
    assert r[0].shape == (2, 48000) and r[1].all() and r[2].tolist() == [0.0, 0.0]
    while fleet.step() is not None:
        pass
    assert fleet.done and fleet.checkpoint(0)["ended"]
# the Fleet facade over a FLAC and a WAV station, with DSP stages and a seek
from aukit_tpu_torch.stream.fleet import Fleet
wav = fixtures.wav_pcm(rng.integers(-9000, 9000, (1, 4000)), 2000, 16)
facade = Fleet([data, wav], device="cpu")
facade.set_filter(1, "lowpass", 300)
r = facade.step()
assert r[0].shape == (2, 48000) and r[1].all()
assert facade.seek(1, 1.0) == 1.0
while facade.step() is not None:
    pass
assert facade.done and facade.checkpoint(1)["sub"]["dsp"]["kind"] == 1
# per-channel windows, and the write path: a transcode and a host-fed encode
dec = t.BatchStreamEngine([t.LaneSpec("pcm16", 1000, 2), t.LaneSpec("ulaw", 1000)],
                          device="cpu", mono=False)
enc = t.BatchEncodeEngine([t.EncodeSpec("pcm24", 2), t.EncodeSpec("dfpwm", 2)], chunk_samples=64,
                          device="cpu")
dec.feed(0, rng.integers(0, 256, 4000, dtype=np.uint8).tobytes())
dec.feed(1, rng.integers(0, 256, 1000, dtype=np.uint8).tobytes())
r = dec.step()
assert r[0].shape == (2, 2, 48000) and r[1].all()
out, nbytes, mask, pos = enc.encode_windows(r[0][:, :, :512], r[1])
assert out.shape == (2, 512 * 2 * 3) and nbytes.tolist() == [3072, 128]
enc.feed(0, rng.uniform(-1, 1, (2, 100)))
enc.feed(1, rng.uniform(-1, 1, (2, 100)))
enc.feed_many([None, None])
sizes = []
while (r := enc.step()) is not None:
    sizes.append(r[1].tolist())
assert sizes == [[384, 16], [216, 9]] and enc.done
assert len(enc.checkpoint(1)["codec_state"]) == 3
pcm8 = t.BatchDfpwmEncoder(2, chunk_samples=64, device="cpu")
pcm8.feed_array(rng.integers(0, 256, (2, 128), dtype=np.uint8))
assert pcm8.step()[0].shape == (2, 8) and pcm8.step() is not None and pcm8.done
# the multi-device layer: a 2-shard decoder, and the multi-process module
import aukit_tpu_torch.parallel.distributed
from aukit_tpu_torch.parallel.pipeline import make_mesh
sharded = t.BatchDfpwmDecoder(3, 48000, chunk_bytes=64, mesh=make_mesh(2, device="cpu"),
                              device="cpu")
sharded.feed_array(rng.integers(0, 256, (3, 100), dtype=np.uint8))
assert [r[0].shape for r in iter(sharded.step, None)] == [(3, 512)] * 2
# playback, the trace hooks and the four programs
import aukit_tpu_torch.playback, aukit_tpu_torch.utils.trace
from aukit_tpu_torch.cli import auconvert, auplay, austream, austream_tm
assert auconvert.parse_map("1&2=1") == (1, 1, [{"channel": 1}, {"channel": 2}, "&"])
sink = aukit_tpu_torch.playback.BufferSink()
t.play(iter([(np.full((1, 10), 3.0), 0.0)]), sink)
assert sink.samples().tolist() == [3] * 10
assert not any(m.startswith(("jax", "aukit_tpu.")) for m in sys.modules if sys.modules[m])
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
