"""The write path: kernel (c)'s plain version, the int8 -> target-int lookup,
``BatchDfpwmEncoder`` and ``BatchEncodeEngine`` of aukit_tpu_torch (plain
PyTorch on the CPU) against aukit_tpu (JAX on the CPU) on the same inputs.
Everything is compared bit for bit (tolerance 0), the gained float32 window
path included: the port places its fused multiply-adds where XLA does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aukit_tpu.codecs import dfpwm as jax_dfpwm
from aukit_tpu.containers import wav as jax_wav
from aukit_tpu.kernels import dfpwm_pallas
from aukit_tpu.ops import pcmcode as jax_pcmcode
from aukit_tpu.stream import batch_encode as jax_encode
from aukit_tpu_torch import interop
from aukit_tpu_torch.codecs import dfpwm
from aukit_tpu_torch.containers import wav
from aukit_tpu_torch.kernels import dfpwm_cuda
from aukit_tpu_torch.ops import pcmcode
from aukit_tpu_torch.stream import batch_encode
from tests import torch_kernel_cases as kernel_cases
from tests.test_torch_batch import to_numpy

CHUNK = 800  # samples per host-fed step: the plain encode loop costs ~80 us a sample
PACKAGES = ((batch_encode, {"device": "cpu"}), (jax_encode, {}))


def encode_state(rng, lanes):
    """Random non-zero encoder state as numpy leaves (JAX leaf order)."""
    return [rng.integers(-128, 128, lanes).astype(np.int32),
            rng.integers(8, 1024, lanes).astype(np.int32),
            rng.integers(0, 2, lanes).astype(np.int32),
            rng.integers(-128, 128, lanes).astype(np.int32),
            rng.integers(-128, 128, lanes).astype(np.int32)]


def tie_levels(rng, lanes, n):
    """Random levels with rows pinned at the rails, so the charge reaches 127
    and -128 and the tie rule ``level == charge == 127`` decides bits."""
    levels = rng.integers(-128, 128, (lanes, n)).astype(np.int8)
    levels[0] = 127
    levels[1] = -128
    levels[2, n // 2:] = 127
    return levels


def test_encode_plain_version_matches_jax_scan_and_pallas():
    """Kernel (c)'s plain version against the JAX scan ``dfpwm_encode`` and
    against ``dfpwm_encode_pallas(interpret=True)``: bytes and state, two
    chained calls from a random state, ragged lane count, rail levels."""
    rng = np.random.default_rng(1)
    lanes, n = 5, 256
    leaves = encode_state(rng, lanes)
    st = interop.dfpwm_state_from_numpy(leaves)
    st_scan = st_pallas = jax_dfpwm.DfpwmState(*(jnp.asarray(a) for a in leaves))
    for _call in range(2):
        levels = tie_levels(rng, lanes, n)
        got, st = dfpwm_cuda.dfpwm_encode_kernel(torch.tensor(levels), st)
        want, st_scan = jax_dfpwm.dfpwm_encode(jnp.asarray(levels, jnp.int32), st_scan)
        want_p, st_pallas = dfpwm_pallas.dfpwm_encode_pallas(levels, st_pallas, interpret=True)
        assert got.dtype == torch.uint8 and got.shape == (lanes, n // 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
        for g, w, wp in zip(interop.dfpwm_state_to_numpy(st), jax.tree_util.tree_leaves(st_scan),
                            jax.tree_util.tree_leaves(st_pallas), strict=True):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, np.asarray(wp))
    # the decoder-only leaves pass through untouched
    np.testing.assert_array_equal(st.previous_charge.numpy(), leaves[3])
    np.testing.assert_array_equal(st.lowpass.numpy(), leaves[4])


ENCODE_CASES = {name: rest for name, *rest in kernel_cases.encode_cases("cpu")}


@pytest.mark.parametrize("name", sorted(ENCODE_CASES))
def test_kernel_cases_plain_version_matches_pallas_interpret(name):
    """Every case the card holds kernel (c) to (its plain version there, max
    |error| 0), on CPU tensors through the plain version, through the JAX
    scan ``dfpwm_encode`` and through ``dfpwm_encode_pallas(interpret=True)``:
    bytes and state bit-equal over the chained calls, states no stream
    produces included. The Pallas kernel compares the bit with the previous
    one as ``bit + previous != 1``, which holds for 0 and 1 only, so a lane
    that starts from any other previous bit is held to the scan alone."""
    calls, st = ENCODE_CASES[name]
    leaves = [jnp.asarray(leaf.numpy()) for leaf in st.leaves()]
    st_scan = st_pallas = jax_dfpwm.DfpwmState(*leaves)
    in_domain = np.isin(st.previous_bit.numpy(), (0, 1))
    assert in_domain.all() or name == "wild_state"
    for k, levels in enumerate(calls):
        got, st = dfpwm_cuda.dfpwm_encode_kernel(levels, st)
        want, st_scan = jax_dfpwm.dfpwm_encode(jnp.asarray(levels.numpy(), jnp.int32), st_scan)
        want_p, st_pallas = dfpwm_pallas.dfpwm_encode_pallas(levels.numpy(), st_pallas,
                                                             interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"call {k}")
        np.testing.assert_array_equal(got.numpy()[in_domain], np.asarray(want_p)[in_domain],
                                      err_msg=f"call {k}")
        for g, w, wp in zip(interop.dfpwm_state_to_numpy(st), jax.tree_util.tree_leaves(st_scan),
                            jax.tree_util.tree_leaves(st_pallas), strict=True):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"call {k}")
            np.testing.assert_array_equal(g[in_domain], np.asarray(wp)[in_domain],
                                          err_msg=f"call {k}")


def test_encode_wrapper_counts_and_checks():
    st = dfpwm.DfpwmState.zeros(2)
    levels = torch.zeros((2, 16), dtype=torch.int8)
    calls = dfpwm_cuda.dfpwm_encode_ref.calls
    launches = dfpwm_cuda.dfpwm_encode_kernel.launches
    out, _ = dfpwm_cuda.dfpwm_encode_kernel(levels, st)
    # silence encodes to alternating bits, LSB first
    assert out.tolist() == [[0xAA, 0xAA]] * 2
    assert dfpwm_cuda.dfpwm_encode_ref.calls == calls + 1
    assert dfpwm_cuda.dfpwm_encode_kernel.launches == launches  # CPU: no launch
    assert dfpwm_cuda.dfpwm_encode_kernel in dfpwm_cuda.KERNELS
    assert dfpwm_cuda.dfpwm_encode_ref in dfpwm_cuda.PLAIN
    with pytest.raises(ValueError, match="multiple of 8"):
        dfpwm_cuda.dfpwm_encode_kernel(torch.zeros((2, 12), dtype=torch.int8), st)
    with pytest.raises(ValueError, match="int8"):
        dfpwm_cuda.dfpwm_encode_kernel(levels.to(torch.int32), st)
    with pytest.raises(ValueError, match="state"):
        dfpwm_cuda.dfpwm_encode_kernel(levels, dfpwm.DfpwmState.zeros(3))
    empty, st2 = dfpwm_cuda.dfpwm_encode_kernel(torch.zeros((2, 0), dtype=torch.int8), st)
    assert empty.shape == (2, 0) and st2.charge.tolist() == [0, 0]


@pytest.mark.parametrize("codec", batch_encode.ENCODE_CODECS)
def test_int8_lookup_matches_jax_device_conversion(codec):
    """The port's table lookup against the JAX package's gather-free
    ``int8_to_target_ints_device`` (jitted), for all 256 int8 inputs; the
    tables themselves are equal too."""
    x = np.arange(-128, 128, dtype=np.int8)
    want = np.asarray(jax.jit(
        lambda v: jax_encode.int8_to_target_ints_device(v, codec))(jnp.asarray(x)))
    group = batch_encode._EncGroup(batch_encode.EncodeSpec(codec), np.arange(1),
                                   torch.device("cpu"), 8)
    got = group._window_vals(torch.tensor(x)[None, None, :], None)[0, 0]
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    np.testing.assert_array_equal(batch_encode._int8_lut(codec), jax_encode._int8_lut(codec))


def test_host_helpers_match_jax():
    """The copied host code: float -> target ints (pcm32's +1.0 wraps), the
    PCM value conversions and the WAV header."""
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 500), [1.0, -1.0, 0.0, -0.0]])
    for codec in batch_encode.ENCODE_CODECS:
        np.testing.assert_array_equal(batch_encode.float_to_target_ints(x, codec),
                                      jax_encode.float_to_target_ints(x, codec))
    for depth, kind in ((8, "unsigned"), (8, "signed"), (16, "signed"), (24, "signed"),
                        (32, "signed")):
        raw = pcmcode.denormalize_pcm(x[:500] / 1.2, depth, kind)
        np.testing.assert_array_equal(raw, jax_pcmcode.denormalize_pcm(x[:500] / 1.2, depth, kind))
        assert pcmcode.pack_pcm(raw, depth, kind) == jax_pcmcode.pack_pcm(raw, depth, kind)
        ints = np.trunc(raw)
        np.testing.assert_array_equal(pcmcode.normalize_pcm(ints, depth, kind),
                                      jax_pcmcode.normalize_pcm(ints, depth, kind))
    assert pcmcode.pack_pcm(x, 32, "float", True) == jax_pcmcode.pack_pcm(x, 32, "float", True)
    for args in ((1, 48000, 16, 96000), (2, 44100, 24, 3), (1, 8000, 8, 0)):
        assert wav.pcm_wav_header(*args) == jax_wav.pcm_wav_header(*args)
    with pytest.raises(ValueError):
        wav.pcm_wav_header(1, 48000, 12, 0)


# -- BatchDfpwmEncoder (twins of tests/test_batch.py:352 and :381) --------------------

def run_pcm8_encoder(module, kw, feed):
    enc = module.BatchDfpwmEncoder(3, chunk_samples=CHUNK, **kw)
    feed(enc)
    steps = []
    while (r := enc.step()) is not None:
        steps.append((to_numpy(r[0]), r[1].copy(), r[2].copy()))
    assert enc.done
    return steps, enc.metrics.samples_decoded


def assert_byte_steps_equal(got, want):
    assert len(got) == len(want) > 0
    for (bg, mg, pg), (bw, mw, pw) in zip(got, want):
        assert bg.dtype == bw.dtype == np.uint8
        np.testing.assert_array_equal(bg, bw)
        np.testing.assert_array_equal(mg, mw)
        np.testing.assert_array_equal(pg, pw)


def test_batch_dfpwm_encoder_matches_jax():
    """Lanes of PCM8 bytes -> DFPWM bytes, state carried across chunks, ragged
    EOF tails (zero-padded to whole bytes), masked lanes frozen."""
    t = np.arange(CHUNK * 2 + 300)
    sigs = [np.floor(np.sin(t[: len(t) - 350 * i] / (17 + 7 * i)) * 90).astype(np.int64)
            for i in range(3)]

    def feed(enc):
        for i, s in enumerate(sigs):
            enc.feed(i, (s & 0xFF).astype(np.uint8).tobytes())  # signed-byte wire form
            enc.feed(i, None)

    (got, got_n), (want, want_n) = (run_pcm8_encoder(m, kw, feed) for m, kw in PACKAGES)
    assert_byte_steps_equal(got, want)
    assert got_n == want_n


def test_batch_dfpwm_encoder_roundtrips_through_decoder():
    """Encode fleet -> the port's decode fleet: the reconstruction tracks the
    input; the bulk-fed encoder equals the JAX one."""
    from aukit_tpu_torch.stream.batch import BatchDfpwmDecoder

    t = np.arange(CHUNK * 3)
    sig = np.stack([np.floor(np.sin(t / 30) * 60), np.floor(np.cos(t / 45) * 70),
                    np.floor(np.sin(t / 11) * 20)])
    wire = (sig.astype(np.int64) & 0xFF).astype(np.uint8)
    (got, _), (want, _) = (run_pcm8_encoder(m, kw, lambda enc: enc.feed_array(wire))
                           for m, kw in PACKAGES)
    assert_byte_steps_equal(got, want)
    encoded = np.concatenate([b for b, _, _ in got], axis=1)
    dec = BatchDfpwmDecoder(3, 48000, chunk_bytes=encoded.shape[1], device="cpu")
    dec.feed_array(encoded)
    rec = dec.step()[0].numpy().astype(np.float64)
    err = rec[:, 1200:] - sig[:, 1200:]
    assert np.sqrt((err ** 2).mean()) < 12.0  # codec noise after adaptation


# -- BatchEncodeEngine, host-fed (twins of tests/test_batch_encode.py) ----------------

def drain(enc):
    """Step to the end -> (per-lane bytes, every step's (nbytes, mask, positions))."""
    outs = [bytearray() for _ in range(enc.lanes)]
    meta = []
    while (r := enc.step()) is not None:
        out, nbytes, mask, pos = r
        host = to_numpy(out)
        meta.append((nbytes.copy(), mask.copy(), pos.copy()))
        for i in np.nonzero(mask)[0]:
            outs[i].extend(host[i, : nbytes[i]].tobytes())
    return [bytes(o) for o in outs], meta


def assert_meta_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def both_engines(specs, feed, chunk=CHUNK):
    """Run ``feed(engine)`` then drain, in both packages -> [(bytes, meta)]."""
    runs = []
    for module, kw in PACKAGES:
        enc = module.BatchEncodeEngine([module.EncodeSpec(*s) for s in specs],
                                       chunk_samples=chunk, **kw)
        feed(enc)
        runs.append(drain(enc))
        assert enc.done
    return runs


def test_encode_engine_dfpwm_matches_jax():
    """Host-fed float lanes -> DFPWM bytes, jittery chunk feeds, a trailing
    partial truncated to whole bytes like the solo encoder."""
    t = np.arange(CHUNK * 2 + 44)  # not a multiple of 8: truncates
    sigs = [np.sin(t / (17 + 9 * i)) * (0.5 + 0.1 * i) for i in range(3)]

    def feed(enc):
        for i, s in enumerate(sigs):
            for off in range(0, len(t), 333):
                enc.feed(i, s[off: off + 333].astype(np.float32))
            enc.feed(i, None)

    (got, got_meta), (want, want_meta) = both_engines([("dfpwm",)] * 3, feed)
    assert got == want and len(got[0]) == (CHUNK * 2 + 44) // 8
    assert_meta_equal(got_meta, want_meta)


def test_encode_engine_pcm_all_depths_match_jax():
    """pcm8 (unsigned)/16/24/32 lanes in one engine (four groups, rows padded
    to the widest): the solo to_pcm_bytes numerics, bias-then-trunc order."""
    sig = (np.sin(np.arange(CHUNK + 100) / 7.3) * 0.9).astype(np.float32)

    def feed(enc):
        for i in range(4):
            enc.feed(i, sig)
            enc.feed(i, None)

    (got, got_meta), (want, want_meta) = both_engines(
        [("pcm8",), ("pcm16",), ("pcm24",), ("pcm32",)], feed)
    assert got == want
    assert [len(b) for b in got] == [len(sig) * k for k in (1, 2, 3, 4)]
    assert_meta_equal(got_meta, want_meta)
    # and the solo writer's own bytes
    for body, depth in zip(got, (8, 16, 24, 32)):
        raw = pcmcode.denormalize_pcm(sig, depth, "unsigned" if depth == 8 else "signed")
        assert body == pcmcode.pack_pcm(raw, depth, "unsigned" if depth == 8 else "signed")


def test_encode_engine_stereo_interleave_matches_jax():
    """Stereo pcm16 and interleaved stereo DFPWM lanes: frames interleave
    before the encode, one encoder state per lane."""
    n = CHUNK + 200
    st = np.stack([np.sin(np.arange(n) / 11.0) * 0.7,
                   np.cos(np.arange(n) / 23.0) * 0.6]).astype(np.float32)

    def feed(enc):
        for lane in range(2):
            enc.feed(lane, st)
            enc.feed(lane, None)

    (got, got_meta), (want, want_meta) = both_engines([("pcm16", 2), ("dfpwm", 2)], feed)
    assert got == want
    assert_meta_equal(got_meta, want_meta)
    with pytest.raises(ValueError, match="channels"):
        both_engines([("pcm16", 2)], lambda enc: enc.feed(0, st[0]))


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("codec", batch_encode.ENCODE_CODECS)
def test_encode_engine_every_codec_matches_jax(codec, channels):
    """Every ``ENCODE_CODECS`` entry, mono and stereo: jittery float feeds
    (out-of-range samples too: ungained feeds are not clipped), ragged EOF,
    a starved lane, a host-side gain."""
    rng = np.random.default_rng(batch_encode.ENCODE_CODECS.index(codec) * 2 + channels)
    chunk = 400
    sigs = [rng.uniform(-1.1, 1.1, (channels, chunk * (1 + i) + 56 * i)) for i in range(3)]

    def feed(enc):
        enc.set_volume(1, 0.6)
        for i, s in enumerate(sigs):
            for off in range(0, s.shape[1], 170):
                enc.feed(i, s[:, off: off + 170])
            if i != 2:
                enc.feed(i, None)

    runs = []
    for module, kw in PACKAGES:
        enc = module.BatchEncodeEngine([module.EncodeSpec(codec, channels)] * 3,
                                       chunk_samples=chunk, **kw)
        feed(enc)
        first = drain(enc)  # lane 2 starves on its partial tail
        assert not enc.done
        enc.feed(2, None)
        runs.append((first, drain(enc), enc.metrics.underruns))
    (g1, g2, gu), (w1, w2, wu) = runs
    assert g1[0] == w1[0] and g2[0] == w2[0] and gu == wu
    assert_meta_equal(g1[1], w1[1])
    assert_meta_equal(g2[1], w2[1])


def test_encode_engine_checkpoint_resume():
    """A checkpointed DFPWM encode lane restores into a fresh engine and the
    joined bytes equal the uninterrupted run."""
    sig = (np.sin(np.arange(3 * CHUNK) / 9.0) * 0.7).astype(np.float32)
    new = lambda: batch_encode.BatchEncodeEngine(  # noqa: E731
        [batch_encode.EncodeSpec("dfpwm")], chunk_samples=CHUNK, device="cpu")
    full_enc = new()
    full_enc.feed(0, sig)
    full_enc.feed(0, None)
    full = drain(full_enc)[0][0]
    enc = new()
    enc.feed(0, sig[: CHUNK + 100])
    r = enc.step()
    head = r[0].numpy()[0, : r[1][0]].tobytes()
    enc2 = new()
    enc2.restore(0, enc.checkpoint(0))
    enc2.feed(0, sig[CHUNK + 100:])
    enc2.feed(0, None)
    assert head + drain(enc2)[0][0] == full
    enc2.reset_lane(0)
    assert enc2.checkpoint(0)["codec_state"] == [0, 0, 0]


def assert_encoder_checkpoints_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert type(got[k]) is type(want[k]), k
        if k == "pending":
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k
    assert all(type(v) is int for v in got["codec_state"])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_encoder_checkpoint_restores_across_packages(direction):
    """A mid-stream encoder checkpoint (three state ints or ``[]``, the
    volume, pending samples, eof, samples_in) taken by one package's engine
    continues bit-identically in the other's."""
    rng = np.random.default_rng(7)
    specs = [("dfpwm",), ("dfpwm", 2), ("pcm24",)]
    sigs = [rng.uniform(-1, 1, (ch, CHUNK * 2 + 120 * i))
            for i, ch in enumerate((1, 2, 1))]

    def make(module):
        kw = {"device": "cpu"} if module is batch_encode else {}
        return module.BatchEncodeEngine([module.EncodeSpec(*s) for s in specs],
                                        chunk_samples=CHUNK, **kw)

    src_mod, dst_mod = ((jax_encode, batch_encode) if direction == "jax_to_port"
                        else (batch_encode, jax_encode))
    src = make(src_mod)
    for i, s in enumerate(sigs):
        src.feed(i, s)
    src.step()
    src.set_volume(0, 0.8, ramp=True)
    dst = make(dst_mod)
    for lane in range(3):
        ck = src.checkpoint(lane)
        assert len(ck["codec_state"]) == (3 if specs[lane][0] == "dfpwm" else 0)
        assert ck["pending"].shape[1] == CHUNK + 120 * lane
        dst.restore(lane, ck)
    for lane in range(3):
        assert_encoder_checkpoints_equal(dst.checkpoint(lane), src.checkpoint(lane))
    for enc in (src, dst):
        enc.feed_many([None] * 3)
    (got, got_meta), (want, want_meta) = drain(dst), drain(src)
    assert got == want and all(got)
    assert_meta_equal(got_meta, want_meta)
    for lane in range(3):
        assert_encoder_checkpoints_equal(dst.checkpoint(lane), src.checkpoint(lane))


# -- encode_windows: the device-to-device glue ------------------------------------------

def windows_for(module, w):
    return torch.tensor(w) if module is batch_encode else jnp.asarray(w)


def glue(specs, calls, setup=lambda enc: None):
    """``encode_windows`` over ``calls`` = [(windows, mask)] in both packages
    -> [[(bytes, nbytes, mask, positions)]]."""
    runs = []
    for module, kw in PACKAGES:
        enc = module.BatchEncodeEngine([module.EncodeSpec(*s) for s in specs], **kw)
        setup(enc)
        res = []
        for w, mask in calls:
            out, nbytes, m, pos = enc.encode_windows(windows_for(module, w), mask)
            res.append((to_numpy(out), nbytes, m, pos))
        runs.append(res)
    return runs


def assert_glue_equal(runs):
    for (bg, ng, mg, pg), (bw, nw, mw, pw) in zip(*runs, strict=True):
        assert bg.dtype == np.uint8 and bg.shape == bw.shape
        np.testing.assert_array_equal(bg, bw)
        for a, b in ((ng, nw), (mg, mw), (pg, pw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("codec", batch_encode.ENCODE_CODECS)
def test_encode_windows_gain_paths_match_jax(codec, channels):
    """Tolerance 0 on both window paths. A group at gain 1 takes the lookup;
    a group with any gained lane takes the float32 path for all its lanes,
    where the ramp ``g0 + slope*t`` and pcm8's ``d*127 + 128`` are fused
    multiply-adds in XLA's compiled step and ``fma_kernel`` calls here
    (unfused, pcm16/24/32 differ in thousands of samples of 48000). The
    second call carries the finished ramp and masks a lane."""
    rng = np.random.default_rng(20 + batch_encode.ENCODE_CODECS.index(codec) * 2 + channels)
    T = 256 if codec == "dfpwm" else 4800
    calls = [(rng.integers(-128, 128, (3, channels, T)).astype(np.int8),
              np.array([True, True, k == 0])) for k in range(2)]
    assert_glue_equal(glue([(codec, channels)] * 3, calls))  # the lookup

    def setup(enc):
        enc.set_volume(0, 0.37)
        enc.set_volume(1, 1.9, ramp=True)
        assert enc.get_volume(1) == pytest.approx(1.9)

    assert_glue_equal(glue([(codec, channels)] * 3, calls, setup))


def test_encode_windows_mixed_groups_and_lut_vs_float():
    """Twin of test_encode_engine_gain_lut_vs_float_paths, on a two-group
    engine (rows of the DFPWM group are zero-padded to the pcm16 width): the
    unity pcm16 lane equals the solo writer; the gained lane tracks the
    float64 expectation within 1 LSB, as the reference's own test allows."""
    rng = np.random.default_rng(123)
    win = rng.integers(-100, 101, (4, 4800), dtype=np.int64).astype(np.int8)
    specs = [("pcm16",), ("dfpwm",), ("pcm16",), ("dfpwm",)]
    runs = glue(specs, [(win, np.ones(4, bool))], lambda enc: enc.set_volume(2, 0.5))
    assert_glue_equal(runs)
    out, nbytes, _, _ = runs[0][0]
    assert nbytes.tolist() == [9600, 600, 9600, 600] and not out[1, 600:].any()
    solo = pcmcode.pack_pcm(pcmcode.denormalize_pcm(
        pcmcode.normalize_pcm(win[0], 8, "signed"), 16, "signed"), 16, "signed")
    # lane 0 shares its group with the gained lane, so it rides the float path
    got0 = np.frombuffer(out[0].tobytes(), "<i2").astype(np.int64)
    assert np.abs(got0 - np.frombuffer(solo, "<i2")).max() <= 1
    d = win[2].astype(np.float64) / np.where(win[2] < 0, 128.0, 127.0) * 0.5
    expv = np.trunc(d * np.where(d < 0, 32768.0, 32767.0)).astype(np.int64)
    got = np.frombuffer(out[2].tobytes(), "<i2").astype(np.int64)
    assert np.abs(got - expv).max() <= 1
    # an ungained engine is exact
    plain = glue([("pcm16",)], [(win[:1], np.ones(1, bool))])
    assert plain[0][0][0][0].tobytes() == solo


def test_encode_windows_many_equals_the_calls_in_sequence():
    """``encode_windows_many`` over three engines (mono DFPWM, stereo DFPWM,
    stereo pcm16; two windows, a lane masked in the second): on the CPU it
    is the calls in sequence, and both equal the JAX engines' results."""
    rng = np.random.default_rng(21)
    shapes = ((batch_encode.EncodeSpec("dfpwm"), 5, 1), (batch_encode.EncodeSpec("dfpwm", 2), 3, 2),
              (batch_encode.EncodeSpec("pcm16", 2), 3, 2))
    wins = [[rng.integers(-128, 128, (lanes, ch, 320)).astype(np.int8) for _s, lanes, ch in shapes]
            for _ in range(2)]
    runs = []
    for how in ("many", "sequence", "jax"):
        module = jax_encode if how == "jax" else batch_encode
        kw = {} if how == "jax" else {"device": "cpu"}
        engines = [module.BatchEncodeEngine([module.EncodeSpec(sp.codec, sp.channels)] * lanes, **kw)
                   for sp, lanes, _ch in shapes]
        steps = []
        for k, ws in enumerate(wins):
            masks = [np.ones(lanes, bool) for _s, lanes, _c in shapes]
            masks[0][1] = masks[1][2] = k == 0
            jobs = [(e, windows_for(module, w), m) for e, w, m in zip(engines, ws, masks)]
            rs = (batch_encode.encode_windows_many(jobs) if how == "many"
                  else [e.encode_windows(w, m) for e, w, m in jobs])
            steps.append([(to_numpy(r[0]), *r[1:]) for r in rs])
        runs.append((steps, [e.checkpoint(0) for e in engines]))
    for steps, ckpts in runs[1:]:
        for got_step, want_step in zip(runs[0][0], steps):
            for got, want in zip(got_step, want_step):
                for a, b in zip(got, want, strict=True):
                    np.testing.assert_array_equal(a, b)
        for got, want in zip(runs[0][1], ckpts):
            assert_encoder_checkpoints_equal(got, want)


def test_encode_windows_masked_lane_state_freeze():
    """A masked (starved) lane's encoder state does not advance and its row
    is zeros: encoding a window later yields an uninterrupted run's bytes."""
    rng = np.random.default_rng(5)
    w1, w2 = (rng.integers(-90, 91, (2, 800), dtype=np.int64).astype(np.int8) for _ in range(2))
    runs = glue([("dfpwm",)] * 2, [(w1, np.array([True, False])), (w2, np.array([True, True]))])
    assert_glue_equal(runs)
    (a1, n1, _, _), (a2, _, _, _) = runs[0]
    assert n1.tolist() == [100, 0] and not a1[1].any()
    ref = glue([("dfpwm",)], [(w2[1:], np.array([True]))])
    np.testing.assert_array_equal(a2[1], ref[0][0][0][0])


def test_encode_gain_saturates_not_wraps():
    """|gain * sample| > 1 saturates to the target's full scale instead of
    wrapping in the int cast, on the window path and the host feed path;
    pcm32's +1.0 saturates at 2**31 - 1 as XLA's float -> int32 cast does."""
    for value, full in ((115, 32767), (-115, -32768)):
        win = np.full((1, 256), value, np.int8)
        runs = glue([("pcm16",)], [(win, np.array([True]))], lambda enc: enc.set_volume(0, 2.0))
        assert_glue_equal(runs)
        assert (np.frombuffer(runs[0][0][0][0].tobytes(), "<i2") == full).all()
    runs = glue([("pcm32",)], [(np.full((1, 64), 127, np.int8), np.array([True]))],
                lambda enc: enc.set_volume(0, 1.5))
    assert_glue_equal(runs)
    assert (np.frombuffer(runs[0][0][0][0].tobytes(), "<i4") == 2**31 - 1).all()

    def feed(enc):
        enc.set_volume(0, 2.0)
        enc.feed(0, np.full(256, 0.9))
        enc.feed(0, None)

    (got, _), (want, _) = both_engines([("pcm16",)], feed, chunk=256)
    assert got == want and (np.frombuffer(got[0], "<i2") == 32767).all()


def test_encode_windows_positions_chunk_start():
    """Positions report the chunk start: 0.0 for the first window, one window
    length for the second, at the spec's sample rate."""
    win = np.zeros((1, 4800), np.int8)
    runs = glue([("dfpwm", 1, 24000)], [(win, np.array([True]))] * 2)
    assert_glue_equal(runs)
    assert runs[0][0][3][0] == 0.0 and runs[0][1][3][0] == 0.2


def test_encode_engine_argument_errors():
    from aukit_tpu_torch.parallel.pipeline import make_mesh

    with pytest.raises(TypeError, match="make_mesh"):
        batch_encode.BatchEncodeEngine([batch_encode.EncodeSpec("dfpwm")], device="cpu",
                                       mesh=object())
    assert batch_encode.BatchEncodeEngine([batch_encode.EncodeSpec("dfpwm")], device="cpu",
                                          mesh=make_mesh(2, device="cpu")).mesh.size == 2
    with pytest.raises(ValueError):
        batch_encode.EncodeSpec("opus")
    with pytest.raises(ValueError):
        batch_encode.EncodeSpec("pcm16", channels=0)
    with pytest.raises(ValueError):
        batch_encode.BatchEncodeEngine([], device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        batch_encode.BatchDfpwmEncoder(2, chunk_samples=100, device="cpu")
    with pytest.raises(ValueError, match="% 8"):
        batch_encode.BatchEncodeEngine([batch_encode.EncodeSpec("dfpwm")], chunk_samples=100,
                                       device="cpu")
    enc = batch_encode.BatchEncodeEngine([batch_encode.EncodeSpec("pcm16", 2)], device="cpu")
    with pytest.raises(ValueError, match="channels"):
        enc.encode_windows(torch.zeros((1, 8), dtype=torch.int8), np.array([True]))
    with pytest.raises(ValueError, match="int8"):
        enc.encode_windows(torch.zeros((1, 2, 8)), np.array([True]))


def test_cuda_encode_engines_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_encode.BatchEncodeEngine([batch_encode.EncodeSpec("dfpwm")])
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_encode.BatchDfpwmEncoder(2)
