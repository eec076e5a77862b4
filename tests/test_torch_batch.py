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


def assert_checkpoints_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "codec_state":
            assert [type(x) for x in got[k]] == [type(x) for x in want[k]]
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert type(got[k]) is type(want[k]), k
            assert got[k] == want[k], k


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
    eng = batch.BatchDfpwmDecoder(2, 48000, chunk_bytes=100, device="cpu")
    for call in (lambda: eng.set_filter(0, "lowpass", 1000.0), lambda: eng.set_mono(0),
                 lambda: eng.normalize(0.8)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    ckpt = eng.checkpoint(0)
    ckpt["dsp"] = {**ckpt["dsp"], "kind": 1}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.restore(0, ckpt)
    for spec in (batch.LaneSpec("dfpwm"), batch.LaneSpec("ima", 22050, 2, block_align=256)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            batch.BatchStreamEngine([spec], device="cpu", mono=False)
    with pytest.raises(ValueError):
        batch.LaneSpec("dfpwm", channels=2)


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.BatchDfpwmDecoder(2)


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
assert not any(m.startswith(("jax", "aukit_tpu.")) for m in sys.modules if sys.modules[m])
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
