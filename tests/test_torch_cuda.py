"""The CUDA kernels of aukit_tpu_torch on the card, against their plain
PyTorch versions on the same CUDA tensors (also at the whole-file loaders'
launch shapes), the CUDA engines (decode, per-channel decode, the DSP
stages, encode, transcode) against the CPU engines, and the whole-file
surface (loaders, auplay's chain, the effects) on the card against the CPU. A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU
and skip elsewhere. This file imports neither jax nor aukit_tpu, so it also
runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from aukit_tpu_torch import (BatchDfpwmDecoder, BatchDfpwmEncoder, BatchEncodeEngine,
                             BatchStreamEngine, EncodeSpec, LaneSpec, encode_windows_many,
                             transcode_fleet)
import aukit_tpu_torch as tk
from aukit_tpu_torch import effects as fx
from aukit_tpu_torch import kernels
from aukit_tpu_torch.codecs import adpcm, qoa
from aukit_tpu_torch.codecs.dfpwm import DfpwmState
from aukit_tpu_torch.codecs.g711 import g711_expand_lut
from aukit_tpu_torch.native import flacbits
from aukit_tpu_torch.kernels import (dfpwm_decode_dsp_kernel, dfpwm_decode_dsp_ref,
                                     dfpwm_decode_kernel, dfpwm_decode_ref, dfpwm_encode_kernel,
                                     dfpwm_encode_ref, fma_kernel, fma_ref,
                                     iir_zero_kernel, iir_zero_ref, ima_decode_kernel,
                                     ima_decode_ref, lpc_restore_kernel, lpc_restore_ref,
                                     msadpcm_decode_kernel, msadpcm_decode_ref, qoa_lms_kernel,
                                     qoa_lms_ref)

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
pytestmark = [pytest.mark.cuda, needs_cuda]

ALPHA_48K = float(1.0 - np.exp(-0.5 * 2.0 * np.pi))


def load_sibling(stem):
    """tests/<stem>.py by path: on a machine without this repository's
    conftest, ``tests`` may name another installed package."""
    spec = importlib.util.spec_from_file_location(stem, Path(__file__).parent / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


kernel_cases = load_sibling("torch_kernel_cases")
# the case names, from the builders run on the CPU (cheap: a few hundred lanes)
DSP_CASES = [c[0] for c in kernel_cases.dsp_cases("cpu")]
LPC_CASES = [c[0] for c in kernel_cases.lpc_cases("cpu")]
ENCODE_CASES = [c[0] for c in kernel_cases.encode_cases("cpu")]
IIR_CASES = [c[0] for c in kernel_cases.iir_cases("cpu")]
QOA_CASES = [c[0] for c in kernel_cases.qoa_cases("cpu")]
MSADPCM_CASES = [c[0] for c in kernel_cases.msadpcm_cases("cpu")]
IMA_CASES = [c[0] for c in kernel_cases.ima_cases("cpu")]
DECODE_CASES = [c[0] for c in kernel_cases.decode_cases("cpu")]
WHOLE_FILE_CASES = [c[0] for c in kernel_cases.whole_file_cases("cpu", 0.05)]
FLAC_DSP_CASES = [c[0] for c in kernel_cases.flac_dsp_cases("cpu")]


def random_state(rng, lanes, device):
    leaves = (rng.integers(-128, 128, lanes), rng.integers(8, 1024, lanes),
              rng.integers(0, 2, lanes), rng.integers(-128, 128, lanes),
              rng.integers(-128, 128, lanes))
    return DfpwmState(*(torch.tensor(a.astype(np.int32), device=device) for a in leaves))


def assert_same(out, state, ref_out, ref_state):
    torch.cuda.synchronize()
    assert torch.equal(out, ref_out)
    for got, want in zip(state.leaves(), ref_state.leaves()):
        assert torch.equal(got, want)


@pytest.mark.parametrize("lanes,nbytes", [(1, 1), (65, 33), (300, 97)])
def test_decode_kernel_matches_plain(lanes, nbytes):
    rng = np.random.default_rng(lanes)
    st = ref_st = random_state(rng, lanes, "cuda")
    for _ in range(2):  # chained calls carry the state
        data = torch.tensor(rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8), device="cuda")
        out, st = dfpwm_decode_kernel(data, st)
        ref, ref_st = dfpwm_decode_ref(data, ref_st)
        assert_same(out, st, ref, ref_st)


@pytest.mark.parametrize("with_gain", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_decode_dsp_kernel_matches_plain(with_gain, with_mask):
    rng = np.random.default_rng(7 + 2 * with_gain + with_mask)
    lanes, nbytes = 130, 70
    st = ref_st = random_state(rng, lanes, "cuda")
    for _ in range(2):
        data = torch.tensor(rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8), device="cuda")
        mask = (torch.tensor(rng.integers(0, 2, lanes).astype(bool), device="cuda")
                if with_mask else None)
        gain = None
        if with_gain:
            gain = (torch.tensor(rng.uniform(0.2, 1.8, lanes).astype(np.float32), device="cuda"),
                    torch.tensor((rng.uniform(-1, 1, lanes) / 560).astype(np.float32),
                                 device="cuda"))
        out, st = dfpwm_decode_dsp_kernel(data, st, ALPHA_48K, mask, gain)
        ref, ref_st = dfpwm_decode_dsp_ref(data, ref_st, ALPHA_48K, mask, gain)
        assert_same(out, st, ref, ref_st)


@pytest.mark.parametrize("name", DSP_CASES)
def test_decode_dsp_kernel_paths_match_plain(name):
    """Every path of the redesigned fused kernel (the table's 256 lowpass
    words, states outside their ranges, odd and short rows, ragged tiles, a
    misaligned base, gains past the rails and to +-inf and NaN, masked
    lanes) and kernel (a) on the same bytes: outputs and state bit-equal."""
    _, data, st, mask, gain = next(c for c in kernel_cases.dsp_cases("cuda") if c[0] == name)
    out, new = dfpwm_decode_dsp_kernel(data, st, ALPHA_48K, mask, gain)
    ref, ref_new = dfpwm_decode_dsp_ref(data, st, ALPHA_48K, mask, gain)
    assert_same(out, new, ref, ref_new)
    raw, raw_new = dfpwm_decode_kernel(data, st)
    ref, ref_new = dfpwm_decode_ref(data, st)
    assert_same(raw, raw_new, ref, ref_new)
    if name.startswith("every_lowpass_word"):
        assert len(torch.unique(raw)) == 256


@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_kernel_cases_match_plain(name):
    """Kernels (a) and (b) at the bounds of their tame test (the short step
    and the epilogue's table on one side, predict() and the division on the
    other), over chained calls whose first leaves wild lanes tame, and on the
    mixed fleet's 4000-byte rows: outputs and state bit-equal after every
    call."""
    _, calls, st = next(c for c in kernel_cases.decode_cases("cuda") if c[0] == name)
    raw_st = ref_raw_st = dsp_st = ref_dsp_st = st
    for data in calls:
        out, raw_st = dfpwm_decode_kernel(data, raw_st)
        ref, ref_raw_st = dfpwm_decode_ref(data, ref_raw_st)
        assert_same(out, raw_st, ref, ref_raw_st)
        out, dsp_st = dfpwm_decode_dsp_kernel(data, dsp_st, ALPHA_48K)
        ref, ref_dsp_st = dfpwm_decode_dsp_ref(data, ref_dsp_st, ALPHA_48K)
        assert_same(out, dsp_st, ref, ref_dsp_st)


@pytest.mark.parametrize("name", LPC_CASES)
def test_lpc_restore_kernel_paths_match_plain(name):
    """Every path of the pipelined restore kernel: rows on and off the
    16-byte grid, a misaligned base, fewer rows than a block, every tap
    count, wide and negative shifts, ragged blocks, orders beyond the taps.
    The rows whose int32 store wraps (the random predictors of most cases
    are unstable) are reported as the plain version reports them, and the
    int64 rows of the wide entry point equal the plain int64 restore."""
    _, args, K = next(c for c in kernel_cases.lpc_cases("cuda") if c[0] == name)
    got = lpc_restore_kernel(*args, K)
    torch.cuda.synchronize()
    assert torch.equal(got, lpc_restore_ref(*args, K))
    wrapped, ref_wrapped = (torch.full((args[0].shape[0],), 7, dtype=torch.int32, device="cuda")
                            for _ in range(2))
    got = lpc_restore_kernel(*args, K, wrapped=wrapped)
    assert torch.equal(got, lpc_restore_ref(*args, K, wrapped=ref_wrapped))
    assert torch.equal(wrapped, ref_wrapped)
    wide = (args[0].to(torch.int64).contiguous(), *args[1:])
    got = lpc_restore_kernel(*wide, K)
    assert got.dtype == torch.int64 and torch.equal(got, lpc_restore_ref(*wide, K))


@pytest.mark.parametrize("name", ENCODE_CASES)
def test_encode_kernel_paths_match_plain(name):
    """Every path of the pipelined encode kernel: tame states (the
    two-target step) and wild ones (the general predictor), levels on both
    rails, every copy and store width, ragged tiles, a misaligned base,
    chained calls: bytes and state bit-equal."""
    _, calls, st = next(c for c in kernel_cases.encode_cases("cuda") if c[0] == name)
    ref_st = st
    for levels in calls:
        out, st = dfpwm_encode_kernel(levels, st)
        ref, ref_st = dfpwm_encode_ref(levels, ref_st)
        assert_same(out, st, ref, ref_st)


@pytest.mark.parametrize("name", IIR_CASES)
def test_iir_zero_kernel_paths_match_plain(name):
    """Every path of the pipelined lowpass kernel: row lengths from one
    sample to a 44.1 kHz block's 4458, every copy width, a misaligned base,
    alphas near 0 and 1, denormal inputs and outputs: bit-equal."""
    _, x, alpha = next(c for c in kernel_cases.iir_cases("cuda") if c[0] == name)
    got = iir_zero_kernel(x, alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, iir_zero_ref(x, alpha))


def test_decode_kernel_golden_vectors():
    golden = np.load(Path(__file__).parent / "golden" / "golden.npz")
    data = torch.tensor(golden["dfpwm_in"][None, :], device="cuda")
    out, _ = dfpwm_decode_kernel(data, DfpwmState.zeros(1, "cuda"))
    np.testing.assert_array_equal(out[0].cpu().numpy().astype(np.int32), golden["dfpwm_out"])


def test_kernel_wrapper_rejects_non_contiguous_bytes():
    data = torch.zeros((4, 8), dtype=torch.uint8, device="cuda")[:, ::2]
    with pytest.raises(ValueError):
        dfpwm_decode_kernel(data, DfpwmState.zeros(4, "cuda"))


def run_engine(make, feeds, volumes=()):
    eng = make()
    for lane, vol, ramp in volumes:
        eng.set_volume(lane, vol, ramp=ramp)
    for lane, data in enumerate(feeds):
        eng.feed(lane, data)
        eng.feed(lane, None)
    steps = []
    while (r := eng.step()) is not None:
        steps.append((r[0].cpu().numpy(), r[1].copy(), r[2].copy()))
    return steps, [eng.checkpoint(lane) for lane in range(len(feeds))]


def assert_engines_equal(a, b):
    (steps_a, ck_a), (steps_b, ck_b) = a, b
    assert len(steps_a) == len(steps_b)
    for (wa, ma, pa), (wb, mb, pb) in zip(steps_a, steps_b):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(pa, pb)
    for x, y in zip(ck_a, ck_b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], dict):  # per-channel DSP carries are f32[C] rows
                assert x[k].keys() == y[k].keys()
                for f in x[k]:
                    np.testing.assert_array_equal(x[k][f], y[k][f], err_msg=f"{k}.{f}")
            else:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)


def test_engine_on_cuda_matches_engine_on_cpu():
    """Identity-rate lanes (fused kernel) with ragged EOF tails and a volume
    ramp, then a mixed-rate fleet (decode kernel + dsp_chain): windows,
    masks, positions and checkpoints bit-equal."""
    rng = np.random.default_rng(3)
    feeds = [rng.integers(0, 256, 300 * (1 + i % 3) + 29 * (i % 4), dtype=np.uint8).tobytes()
             for i in range(8)]
    vols = [(0, 0.5, False), (2, 1.7, True)]
    assert_engines_equal(
        *(run_engine(lambda d=d: BatchDfpwmDecoder(8, 48000, chunk_bytes=300, device=d),
                     feeds, vols) for d in ("cuda", "cpu")))
    specs = [LaneSpec("dfpwm", 8000), LaneSpec("dfpwm", 11025)] * 3
    feeds = [rng.integers(0, 256, 1000 + 400 * i, dtype=np.uint8).tobytes() for i in range(6)]
    launches = dfpwm_decode_kernel.launches
    cuda = run_engine(lambda: BatchStreamEngine(specs, device="cuda"), feeds, vols)
    assert dfpwm_decode_kernel.launches > launches
    assert_engines_equal(cuda, run_engine(lambda: BatchStreamEngine(specs, device="cpu"),
                                          feeds, vols))


def cuda_i32(a):
    return torch.tensor(np.asarray(a, np.int32), device="cuda")


def assert_kernel_state_equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lanes,T", [(1, 1), (65, 70), (300, 504)])
def test_ima_kernel_matches_plain(lanes, T):
    """Two chained calls; step indices over 0..88 and out of range (the
    lookup clamps, the raw index feeds one update)."""
    rng = np.random.default_rng(lanes)
    st = ref_st = (cuda_i32(rng.integers(-32768, 32768, lanes)),
                   cuda_i32(rng.integers(-5, 200, lanes)))
    for _ in range(2):
        nibs = torch.tensor(rng.integers(0, 16, (lanes, T), dtype=np.uint8), device="cuda")
        out, st = ima_decode_kernel(nibs, *st)
        ref, ref_st = ima_decode_ref(nibs, *ref_st)
        assert out.dtype == torch.int16 and torch.equal(out, ref)
        assert_kernel_state_equal(st, ref_st)


@pytest.mark.parametrize("lanes,T", [(1, 1), (65, 70), (300, 1010)])
def test_msadpcm_kernel_matches_plain(lanes, T):
    """Two chained calls from negative header deltas, every coefficient pair."""
    rng = np.random.default_rng(lanes)
    pidx = np.arange(lanes) % 7
    c1 = cuda_i32(np.array([256, 512, 0, 192, 240, 460, 392])[pidx])
    c2 = cuda_i32(np.array([0, -256, 0, 64, 0, -208, -232])[pidx])
    st = ref_st = (cuda_i32(rng.integers(-2000, 2000, lanes)),
                   cuda_i32(rng.integers(-2000, 2000, lanes)),
                   cuda_i32(rng.integers(-400, 400, lanes)))
    for _ in range(2):
        nibs = torch.tensor(rng.integers(-8, 8, (lanes, T), dtype=np.int8), device="cuda")
        out, st = msadpcm_decode_kernel(nibs, *st, c1, c2)
        ref, ref_st = msadpcm_decode_ref(nibs, *ref_st, c1, c2)
        assert out.dtype == torch.int16 and torch.equal(out, ref)
        assert_kernel_state_equal(st, ref_st)


@pytest.mark.parametrize("wrap", [False, True])
def test_qoa_kernel_matches_plain(wrap):
    """Two chained calls; with ``wrap`` the state of
    tests/test_pallas_kernels.py whose predictor sums overflow int32."""
    rng = np.random.default_rng(wrap)
    lanes, T = 130, 300
    if wrap:
        hist, wts = cuda_i32(np.full((lanes, 4), 32767)), cuda_i32(np.full((lanes, 4), 2 * 10**8))
    else:
        hist = cuda_i32(rng.integers(-32768, 32768, (lanes, 4)))
        wts = cuda_i32(rng.integers(-30000, 30000, (lanes, 4)))
    st = ref_st = (hist, wts)
    for _ in range(2):
        dq = torch.tensor(rng.integers(-14336, 14337, (lanes, T)).astype(np.int16), device="cuda")
        out, st = qoa_lms_kernel(dq, *st)
        ref, ref_st = qoa_lms_ref(dq, *ref_st)
        assert out.dtype == torch.int16 and torch.equal(out, ref)
        assert_kernel_state_equal(st, ref_st)


@pytest.mark.parametrize("name", MSADPCM_CASES)
def test_msadpcm_kernel_cases_match_plain(name):
    """Every path of the pipelined MS ADPCM decode: rows on and off the
    16-byte grid (the engine's 1010 nibbles), odd lengths, one sample, less
    than a tile, ragged lanes, bases off the grid, chained calls, deltas
    negative, at the cap and at the floor: samples and state bit-equal."""
    _, calls, st, coefs = next(c for c in kernel_cases.msadpcm_cases("cuda") if c[0] == name)
    ref_st = st
    for nibs in calls:
        out, st = msadpcm_decode_kernel(nibs, *st, *coefs)
        ref, ref_st = msadpcm_decode_ref(nibs, *ref_st, *coefs)
        assert out.dtype == torch.int16 and torch.equal(out, ref)
        assert_kernel_state_equal(st, ref_st)


@pytest.mark.parametrize("name", IMA_CASES)
def test_ima_kernel_cases_match_plain(name):
    """Every path of the IMA decode on window_rows: the same row shapes, the
    engine's 504-nibble rows, bases off the grid, chained calls, the index
    at 0 and 88 and out of range (-1, 89, 255, -2^31: the warp's clamped
    lookup), predictors at both rails, runs of nibbles that drive the index
    to both ends: samples and state bit-equal."""
    _, calls, st = next(c for c in kernel_cases.ima_cases("cuda") if c[0] == name)
    ref_st = st
    for nibs in calls:
        out, st = ima_decode_kernel(nibs, *st)
        ref, ref_st = ima_decode_ref(nibs, *ref_st)
        assert out.dtype == torch.int16 and torch.equal(out, ref)
        assert_kernel_state_equal(st, ref_st)


@pytest.mark.parametrize("name", QOA_CASES)
def test_qoa_kernel_cases_match_plain(name):
    """Every path of the pipelined QOA LMS: the same row shapes, states that
    wrap int32, residuals at both ends of the dequant range: samples and
    state bit-equal."""
    _, calls, st = next(c for c in kernel_cases.qoa_cases("cuda") if c[0] == name)
    ref_st = st
    for dq in calls:
        out, st = qoa_lms_kernel(dq, *st)
        ref, ref_st = qoa_lms_ref(dq, *ref_st)
        assert out.dtype == torch.int16 and torch.equal(out, ref)
        assert_kernel_state_equal(st, ref_st)


def test_fma_kernel_matches_plain():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.uniform(-1, 1, (70, 3001)).astype(np.float32), device="cuda")
    y = torch.tensor(rng.uniform(-1, 1, 3001).astype(np.float32), device="cuda")
    z = torch.tensor(rng.uniform(-1, 1, (70, 1)).astype(np.float32), device="cuda")
    for args in ((x, y, z), (0.7352, x, x.flip(0)), (y, y, 0.25)):
        got = fma_kernel(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, fma_ref(*args))


def test_block_fleet_engine_on_cuda_matches_cpu():
    """IMA, MS ADPCM, QOA, PCM16 and µ-law lanes in one engine, ragged EOF
    tails and a volume ramp: windows, masks, positions and checkpoints of
    the CUDA engine equal the CPU engine's, and each block kernel ran."""
    rng = np.random.default_rng(5)
    specs = [LaneSpec("ima", 8000, 1, block_align=256), LaneSpec("msadpcm", 8000, 2, block_align=512),
             LaneSpec("qoa", 10240, 2), LaneSpec("pcm16", 11025), LaneSpec("ulaw", 8000)] * 2
    nbytes = [256 * 16, 512 * 16, 2 * (8 + 2 * (16 + 2048)), 2 * 11025, 8000]
    feeds = [rng.integers(0, 256, nbytes[i % 5] * (1 + i // 5) + 100 * i, dtype=np.uint8).tobytes()
             for i in range(len(specs))]
    vols = [(0, 0.5, False), (2, 1.7, True)]
    launches = [k.launches for k in (ima_decode_kernel, msadpcm_decode_kernel, qoa_lms_kernel)]
    cuda = run_engine(lambda: BatchStreamEngine(specs, device="cuda"), feeds, vols)
    assert all(k.launches > n for k, n in zip(
        (ima_decode_kernel, msadpcm_decode_kernel, qoa_lms_kernel), launches))
    assert_engines_equal(cuda, run_engine(lambda: BatchStreamEngine(specs, device="cpu"),
                                          feeds, vols))


def test_dsp_stage_engine_on_cuda_matches_cpu():
    """The auplay chain (mono toggle, normalize, lowpass/highpass, a filter
    reconfigured mid-stream, a filtered lane checkpointed and restored) over
    DFPWM at 48 and 32 kHz, IMA and MS ADPCM at 22.05 kHz, stereo QOA and
    PCM16 with ``mono=False``: windows, masks, positions and checkpoints of
    the CUDA engine equal the CPU engine's; kernels (a), (d), (e), (f) and
    the FMA ran, the fused kernel (b) did not."""
    specs, feeds = kernel_cases.engine_dsp_fleet(np.random.default_rng(21), 4, 1.5)
    ran = (dfpwm_decode_kernel, ima_decode_kernel, msadpcm_decode_kernel, qoa_lms_kernel,
           fma_kernel)
    before = [k.launches for k in ran] + [dfpwm_decode_dsp_kernel.launches]
    runs = [kernel_cases.drive_engine_dsp(
        BatchStreamEngine([LaneSpec(*sp) for sp in specs], device=dev, mono=False), specs, feeds)
        for dev in ("cuda", "cpu")]
    assert all(k.launches > n for k, n in zip(ran, before))
    assert dfpwm_decode_dsp_kernel.launches == before[-1]
    assert_engines_equal(*runs)


def lpc_rows(rng, rows, T, max_order):
    """Restore arguments on the card (torch_kernel_cases.lpc_rows: random
    orders up to ``max_order``, shifts 0..31 and negative, ragged blocks)."""
    return tuple(cuda_i32(a) for a in kernel_cases.lpc_rows(rng, rows, T, max_order))


@pytest.mark.parametrize("rows,T,max_order", [(1, 1, 1), (65, 70, 3), (130, 300, 8),
                                              (300, 257, 13), (70, 600, 32)])
def test_lpc_restore_kernel_matches_plain(rows, T, max_order):
    """Kernel (g) against its plain version, one case per tap bucket K."""
    args = lpc_rows(np.random.default_rng(rows + max_order), rows, T, max_order)
    got = lpc_restore_kernel(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, lpc_restore_ref(*args))


@pytest.mark.parametrize("rows,T", [(1, 1), (65, 70), (300, 4458)])
@pytest.mark.parametrize("alpha", [0.9568, 0.12])
def test_iir_zero_kernel_matches_plain(rows, T, alpha):
    """Kernel (h) against its plain version: the fused multiply-add sides
    of every sample of the group of 8, rows not a multiple of the block."""
    rng = np.random.default_rng(rows)
    x = torch.tensor((rng.standard_normal((rows, T)) * 0.5).astype(np.float32), device="cuda")
    got = iir_zero_kernel(x, alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, iir_zero_ref(x, alpha))


@pytest.mark.parametrize("name", FLAC_DSP_CASES)
def test_flac_dsp_kernel_matches_plain(name):
    """The FLAC lanes' float64 DSP kernel against its plain version on the
    CPU: every channel assignment, lanes whose blocks mix them, every out
    mode, depths 8-24, identity, linear and none, ramps and the sign wrap;
    outputs (the gaps between
    lanes untouched) and states bit-equal, one launch."""
    from aukit_tpu_torch.kernels import flac_dsp_kernel, flac_dsp_ref

    _, restored, lanes, asgn, fin, numel, geo = next(
        c for c in kernel_cases.flac_dsp_cases("cuda") if c[0] == name)
    out = torch.full((numel,), -999.0, device="cuda")
    want_out = torch.full((numel,), -999.0)
    launches = flac_dsp_kernel.launches
    state = flac_dsp_kernel(restored, lanes, asgn, fin, out, geo)
    torch.cuda.synchronize()
    assert flac_dsp_kernel.launches == launches + 1
    want = flac_dsp_ref(restored.cpu(), lanes, asgn, fin, want_out, geo)
    assert torch.equal(out.cpu(), want_out) and torch.equal(state.cpu(), want)


def test_flac_fleet_host_route_dsp_on_cuda_matches_cpu():
    """The default route of ``FlacFleet`` on the card runs the host route's
    float64 DSP in the kernel: windows, masks, positions and checkpoints
    equal the CPU fleet's (the numpy route) bit for bit, with a ramp in
    flight, 44.1 kHz mid/side lanes and a short final frame, which takes
    the numpy route; the kernel launched, no plain version ran, and every
    decoded lane counted on one route."""
    from aukit_tpu_torch import FlacFleet
    from aukit_tpu_torch.examples.flac_radio_fleet import _make_station

    fixtures = load_sibling("fixtures")
    rng = np.random.default_rng(8)
    frames = []
    for k, n in enumerate([1000] * 5 + [300]):
        frames.append(fixtures.flac_frame(
            [{"type": "verbatim", "values": [int(v) for v in rng.integers(-30000, 30000, n)]},
             {"type": "fixed", "order": 2, "warmup": [1, -1],
              "residuals": [int(v) for v in rng.integers(-200, 200, n - 2)]}],
            n, 10, 16, frame_number=k))
    stereo = fixtures.flac_stream_header(44100, 2, 16, 5300) + b"".join(frames)
    streams = [_make_station(rng, 3) for _ in range(3)] + [stereo]
    runs = []
    for device in ("cuda", "cpu"):
        kernels.reset_counts()
        fleet = FlacFleet(len(streams), device=device)
        fleet.set_volume(1, 0.4, ramp=True)
        steps = []
        for off in range(0, max(map(len, streams)), 9000):
            for lane, d in enumerate(streams):
                if off < len(d):
                    fleet.feed(lane, d[off: off + 9000])
            steps.append(fleet.step())
        for lane in range(len(streams)):
            fleet.feed(lane, None)
        while not fleet.done:
            steps.append(fleet.step())
        runs.append((steps, [fleet.checkpoint(lane) for lane in range(len(streams))], fleet,
                     kernels.flac_dsp_kernel.launches, sum(p.calls for p in kernels.PLAIN)))
    (got, ck_got, card, launched, plain), (want, ck_want, cpu, _, _) = runs
    assert launched > 0 and plain == 0
    assert card.metrics.dsp_lanes_host > 0 and cpu.metrics.dsp_lanes_device == 0
    assert (card.metrics.dsp_lanes_device + card.metrics.dsp_lanes_host
            == cpu.metrics.dsp_lanes_host)
    assert len(got) == len(want) and any(s is not None for s in got)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        for a, b in zip(g or (), w or ()):
            np.testing.assert_array_equal(a, b)
    for x, y in zip(ck_got, ck_want):
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k], dtype=object),
                                          np.asarray(y[k], dtype=object), err_msg=k)


def test_flac_fleet_on_cuda_matches_cpu():
    """Both FLAC device routes on the card against the same fleets on the
    CPU (the kernels' plain versions): windows, masks, positions and
    checkpoints bit-equal, and kernels (g) and (h) ran."""
    from aukit_tpu_torch import FlacFleet

    fixtures = load_sibling("fixtures")
    rng = np.random.default_rng(6)
    frames = []
    for k in range(6):
        sig = np.cumsum(rng.integers(-60, 60, 1000))
        frames.append(fixtures.flac_frame(
            [{"type": "lpc", "order": 8, "warmup": [int(v) for v in sig[:8]], "precision": 8,
              "shift": 9, "coefs": [120, -60, 30, -15, 8, -4, 2, -1],
              "residuals": [int(v) for v in rng.integers(-300, 300, 992)]},
             {"type": "fixed", "order": 2, "warmup": [1, -1],
              "residuals": [int(v) for v in rng.integers(-200, 200, 998)]}],
            1000, 10, 16, frame_number=k))
    data = fixtures.flac_stream_header(44100, 2, 16, 6000) + b"".join(frames)
    feeds = [data, data[: len(data) - 700], data]
    for kw in ({"device_restore": True}, {"device_restore": False}):
        counts = (lpc_restore_kernel.launches, iir_zero_kernel.launches)
        runs = []
        for device in ("cuda", "cpu"):
            fleet = FlacFleet(3, device_dsp=True, device=device, interpolation="cubic", **kw)
            fleet.set_volume(2, 0.4, ramp=True)
            steps = []
            for off in range(0, len(data), 5000):
                for lane, d in enumerate(feeds):
                    fleet.feed(lane, d[off: off + 5000])
                steps.append(fleet.step())
            for lane in range(3):
                fleet.feed(lane, None)
            while not fleet.done:
                steps.append(fleet.step())
            runs.append((steps, [fleet.checkpoint(lane) for lane in range(3)]))
        (got, ck_got), (want, ck_want) = runs
        assert len(got) == len(want) and any(s is not None for s in got)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            for a, b in zip(g or (), w or ()):
                np.testing.assert_array_equal(a, b)
        for x, y in zip(ck_got, ck_want):
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k], dtype=object),
                                              np.asarray(y[k], dtype=object), err_msg=k)
        assert iir_zero_kernel.launches > counts[1]
        assert (lpc_restore_kernel.launches > counts[0]) == kw["device_restore"]


@pytest.mark.parametrize("restore_min", ["default", 0])
def test_flac_fleet_default_restore_follows_the_field(restore_min):
    """``FlacFleet(device_restore=None)`` on the card: with
    ``CONFIG.flac_device_restore_min`` at 0 each step's restore launches
    kernel (g), at the default none; the windows, masks and positions equal
    the host route's (``device_restore=False``) bit for bit."""
    from aukit_tpu_torch import FlacFleet
    from aukit_tpu_torch.config import CONFIG
    from aukit_tpu_torch.examples.flac_radio_fleet import _make_station

    rng = np.random.default_rng(9)
    streams = [_make_station(rng, 3) for _ in range(4)]
    saved = CONFIG.flac_device_restore_min
    runs = []
    try:
        if restore_min != "default":
            CONFIG.flac_device_restore_min = restore_min
        for device_restore in (None, False):
            launches = lpc_restore_kernel.launches
            fleet = FlacFleet(len(streams), device_restore=device_restore, device="cuda")
            steps = []
            for off in range(0, len(streams[0]), 40000):
                for lane, d in enumerate(streams):
                    fleet.feed(lane, d[off: off + 40000])
                steps.append(fleet.step())
            for lane in range(len(streams)):
                fleet.feed(lane, None)
            while not fleet.done:
                steps.append(fleet.step())
            runs.append((steps, lpc_restore_kernel.launches - launches))
    finally:
        CONFIG.flac_device_restore_min = saved
    (got, field_launches), (want, host_launches) = runs
    assert host_launches == 0
    assert (field_launches > 0) == (restore_min == 0)
    assert len(got) == len(want) and any(s is not None for s in got)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        for a, b in zip(g or (), w or ()):
            np.testing.assert_array_equal(a, b)


# -- the write path: kernel (c), the encode engines, per-channel windows ------------------

@pytest.mark.parametrize("lanes,nsamples", [(1, 8), (65, 264), (300, 776)])
def test_encode_kernel_matches_plain(lanes, nsamples):
    """Kernel (c) against its plain version: bytes and state, two chained
    calls from a random state, ragged lanes and a ragged last tile, rows at
    the rails (the tie rule ``level == charge == 127`` decides bits there)."""
    rng = np.random.default_rng(lanes)
    st = ref_st = random_state(rng, lanes, "cuda")
    for _ in range(2):
        levels = rng.integers(-128, 128, (lanes, nsamples)).astype(np.int8)
        levels[::7] = 127
        levels[3::7] = -128
        levels = torch.tensor(levels, device="cuda")
        out, st = dfpwm_encode_kernel(levels, st)
        ref, ref_st = dfpwm_encode_ref(levels, ref_st)
        assert out.dtype == torch.uint8 and out.shape == (lanes, nsamples // 8)
        assert_same(out, st, ref, ref_st)


def test_encode_kernel_takes_strided_and_unaligned_levels():
    """The kernel reads rows as 4-byte words: a strided view, and a
    contiguous view whose base is not word-aligned, are copied first."""
    rng = np.random.default_rng(8)
    base = torch.tensor(rng.integers(-128, 128, (9, 72)).astype(np.int8), device="cuda")
    st = random_state(rng, 4, "cuda")
    for levels in (base[::2, :64][:4], base.reshape(-1)[1: 1 + 4 * 64].reshape(4, 64)):
        out, new = dfpwm_encode_kernel(levels, st)
        ref, ref_new = dfpwm_encode_ref(levels, st)
        assert_same(out, new, ref, ref_new)


def test_encode_then_decode_on_card_tracks_the_signal():
    t = torch.arange(48000, device="cuda", dtype=torch.float64) / 48000
    freq = torch.tensor([220.0, 440.0, 1000.0], device="cuda", dtype=torch.float64)[:, None]
    levels = torch.trunc(80 * torch.sin(2 * np.pi * freq * t)).to(torch.int8)
    enc, _ = dfpwm_encode_kernel(levels, DfpwmState.zeros(3, "cuda"))
    dec, _ = dfpwm_decode_kernel(enc, DfpwmState.zeros(3, "cuda"))
    err = (dec[:, 4800:].double() - levels[:, 4800:].double())
    assert float(err.pow(2).mean().sqrt()) < 12.0


def drain_encoder(enc):
    steps = []
    while (r := enc.step()) is not None:
        steps.append((r[0].cpu().numpy(), r[1].copy(), r[2].copy(), r[3].copy()))
    return steps


def assert_encode_steps_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a, b)


def test_encode_engine_on_cuda_matches_cpu():
    """Every encode codec, mono and stereo, in one engine: host-fed floats in
    jittery chunks with ragged EOF, then ``encode_windows`` at gain 1 and
    with a ramp and a masked lane; bytes, nbytes, masks, positions and
    checkpoints of the CUDA engine equal the CPU engine's."""
    rng = np.random.default_rng(9)
    codecs = ("dfpwm", "pcm8", "pcm16", "pcm24", "pcm32")
    for channels in (1, 2):
        specs = [EncodeSpec(c, channels) for c in codecs for _ in range(2)]
        sigs = [rng.uniform(-1.1, 1.1, (channels, 400 * (1 + i % 3) + 24 * i))
                for i in range(len(specs))]
        wins = [rng.integers(-128, 128, (len(specs), channels, 1600)).astype(np.int8)
                for _ in range(2)]
        launches = dfpwm_encode_kernel.launches
        runs = []
        for device in ("cuda", "cpu"):
            enc = BatchEncodeEngine(specs, chunk_samples=400, device=device)
            enc.set_volume(3, 0.6)
            for i, s in enumerate(sigs):
                for off in range(0, s.shape[1], 170):
                    enc.feed(i, s[:, off: off + 170])
                enc.feed(i, None)
            steps = drain_encoder(enc)
            enc.set_volume(0, 0.4, ramp=True)
            enc.set_volume(4, 1.8, ramp=True)
            for k, w in enumerate(wins):
                mask = np.ones(len(specs), bool)
                mask[1] = k == 1
                out, nbytes, m, pos = enc.encode_windows(torch.tensor(w, device=device), mask)
                steps.append((out.cpu().numpy(), nbytes, m, pos))
            runs.append((steps, [enc.checkpoint(i) for i in range(len(specs))]))
        assert dfpwm_encode_kernel.launches > launches
        assert_encode_steps_equal(runs[0][0], runs[1][0])
        for x, y in zip(runs[0][1], runs[1][1]):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)


def test_batch_dfpwm_encoder_on_cuda_matches_cpu():
    rng = np.random.default_rng(10)
    wire = rng.integers(0, 256, (5, 2000), dtype=np.uint8)
    runs = []
    for device in ("cuda", "cpu"):
        enc = BatchDfpwmEncoder(5, chunk_samples=800, device=device)
        enc.feed_array(torch.tensor(wire, device=device))
        steps = []
        while (r := enc.step()) is not None:
            steps.append((r[0].cpu().numpy(), r[1].copy(), r[2].copy()))
        runs.append(steps)
    assert_encode_steps_equal(*runs)


def test_per_channel_transcode_on_cuda_matches_cpu():
    """A ``mono=False`` fleet (stereo PCM16, stereo QOA, stereo IMA and a
    mono DFPWM lane padded to two channels, a volume ramp) decoded to
    ``[L, 2, T]`` windows and transcoded device-to-device into interleaved
    stereo DFPWM: windows, masks, positions, per-channel checkpoints and the
    encoded bytes of the CUDA engines equal the CPU engines'."""
    rng = np.random.default_rng(11)
    specs = [LaneSpec("pcm16", 8000, 2), LaneSpec("qoa", 10240, 2),
             LaneSpec("ima", 8000, 2, block_align=256), LaneSpec("dfpwm", 48000)]
    nbytes = [8000 * 4 + 100, 2 * (8 + 2 * (16 + 2048)), 256 * 20, 7000]
    feeds = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in nbytes]
    vols = [(0, 0.5, True)]
    runs = [run_engine(lambda d=d: BatchStreamEngine(specs, device=d, mono=False), feeds, vols)
            for d in ("cuda", "cpu")]
    assert runs[0][0][0][0].shape == (4, 2, 48000)
    assert runs[0][1][0]["fir_state"].shape == (2,)
    assert_engines_equal(*runs)
    outs = []
    for device in ("cuda", "cpu"):
        dec = BatchStreamEngine(specs, device=device, mono=False)
        for lane, data in enumerate(feeds):
            dec.feed(lane, data[: len(data) // 2])  # about half a second a lane
            dec.feed(lane, None)
        outs.append(transcode_fleet(dec, BatchEncodeEngine([EncodeSpec("dfpwm", 2)] * 4,
                                                           device=device)))
    assert outs[0] == outs[1] and all(b and len(b) % 12000 == 0 for b in outs[0])


def test_encode_windows_many_on_streams_matches_in_sequence():
    """Three encoders fed side by side on CUDA streams (mono DFPWM, stereo
    DFPWM, stereo pcm16, two windows each, a lane masked in the second):
    bytes, byte counts, masks, positions and checkpoints equal the same
    engines called one after the other, and the launch count is the same."""
    rng = np.random.default_rng(12)
    specs = ([EncodeSpec("dfpwm")] * 70, [EncodeSpec("dfpwm", 2)] * 40, [EncodeSpec("pcm16", 2)] * 40)
    wins = [(rng.integers(-128, 128, (70, 4000)).astype(np.int8),
             rng.integers(-128, 128, (40, 2, 4000)).astype(np.int8)) for _ in range(2)]
    runs, launches = [], []
    for many in (True, False):
        engines = [BatchEncodeEngine(sp, device="cuda") for sp in specs]
        before = dfpwm_encode_kernel.launches
        steps = []
        for k, (wm, ws) in enumerate(wins):
            mm, ms = np.ones(70, bool), np.ones(40, bool)
            mm[3] = ms[5] = k == 0
            jobs = [(engines[0], torch.tensor(wm, device="cuda"), mm),
                    (engines[1], torch.tensor(ws, device="cuda"), ms),
                    (engines[2], torch.tensor(ws, device="cuda"), ms)]
            rs = encode_windows_many(jobs) if many else [e.encode_windows(w, m) for e, w, m in jobs]
            steps.append([(r[0].cpu().numpy(), *r[1:]) for r in rs])
        launches.append(dfpwm_encode_kernel.launches - before)
        runs.append((steps, [[e.checkpoint(i) for i in range(e.lanes)] for e in engines]))
    assert launches == [4, 4]
    for got_step, want_step in zip(runs[0][0], runs[1][0]):
        for got, want in zip(got_step, want_step):
            assert all(np.array_equal(a, b) for a, b in zip(got, want, strict=True))
    for got_engine, want_engine in zip(runs[0][1], runs[1][1]):
        for got, want in zip(got_engine, want_engine):
            assert got["codec_state"] == want["codec_state"] and got["samples_in"] == want["samples_in"]


# -- the whole-file surface -----------------------------------------------------------

@pytest.fixture(scope="module")
def whole_file_cases():
    """The cases at a 3-minute track's launch shapes, built once."""
    return {name: (kern, args) for name, kern, args in kernel_cases.whole_file_cases("cuda")}


@pytest.mark.parametrize("name", WHOLE_FILE_CASES)
def test_whole_file_kernel_cases_match_plain(name, whole_file_cases):
    """Each kernel at a whole file's launch shape (``whole_file_cases``):
    IMA and MS ADPCM at a WAV's blocks x channels (1016, 2040, 1010 and 2034
    nibbles a row), QOA at F*C x 5120 with a short last frame, the LPC
    restore at a stereo file's subframes, against the plain version on the
    same tensors; the one-lane DFPWM decode (1,080,000 bytes) and encode
    (8,640,000 levels) against the native host routes at full length and
    the plain version over their first quarter second. Outputs and states
    bit-equal."""
    kern, args = whole_file_cases[name]
    if kern in ("dfpwm_decode", "dfpwm_encode"):
        data, st = args
        zeros = DfpwmState.zeros(1, "cuda")
        if kern == "dfpwm_decode":
            out, st = dfpwm_decode_kernel(data, st)
            nat, nat_st = flacbits.dfpwm_decode_rows(data.cpu().numpy(), np.zeros((5, 1), np.int32))
            ref, _ = dfpwm_decode_ref(data[:, :1500].contiguous(), zeros)
            head = out[:, :12000]
        else:
            out, st = dfpwm_encode_kernel(data, st)
            nat, nat_st = flacbits.dfpwm_encode_rows(data.cpu().numpy().astype(np.int32),
                                                     np.zeros((3, 1), np.int32))
            ref, _ = dfpwm_encode_ref(data[:, :12000].contiguous(), zeros)
            head = out[:, :1500]
        torch.cuda.synchronize()
        assert np.array_equal(out.cpu().numpy(), nat.astype(out.cpu().numpy().dtype))
        leaves = [a.cpu().numpy() for a in st.leaves()][: len(nat_st)]
        assert np.array_equal(np.stack(leaves), nat_st)
        assert torch.equal(head, ref)
        return
    kernel, plain = {"ima": (ima_decode_kernel, ima_decode_ref),
                     "msadpcm": (msadpcm_decode_kernel, msadpcm_decode_ref),
                     "qoa": (qoa_lms_kernel, qoa_lms_ref),
                     "lpc": (lpc_restore_kernel, lpc_restore_ref)}[kern]
    if kern == "lpc":
        assert torch.equal(kernel(*args), plain(*args))
        return
    (out, st), (ref, ref_st) = kernel(*args), plain(*args)
    assert out.dtype == torch.int16 and torch.equal(out, ref)
    assert_kernel_state_equal(st, ref_st)


def test_whole_file_decoders_keep_empty_inputs_from_the_kernels():
    kernels.reset_counts()
    assert adpcm.ima_adpcm_blocks(np.zeros((0, 1016)), np.zeros(0), np.zeros(0)).shape == (0, 1016)
    assert adpcm.decode_msadpcm_blocks(np.zeros((3, 0)), np.zeros(3, int), np.zeros(3),
                                       np.zeros(3), np.zeros(3)).shape == (3, 0)
    empty_qoa = b"qoaf" + (0).to_bytes(4, "big") + bytes([2]) + (44100).to_bytes(3, "big")
    assert qoa.decode_qoa(empty_qoa)[0].shape == (2, 0)
    assert tk.dfpwm(b"").num_samples == 0
    assert tk.new_audio(np.zeros((1, 5)), 48000).dfpwm(True) == b""
    torch.cuda.synchronize()
    assert sum(fn.launches for fn in kernels.KERNELS) == 0
    assert sum(fn.calls for fn in kernels.PLAIN) == 0


def _auplay(loader, raw, device):
    a = getattr(tk, loader)(raw, device=device)
    rate = a.sample_rate
    m = a.resample(48000).mono()
    fx.normalize(m, 0.8)
    fx.lowpass(m, rate / 2)
    return m.numpy(), [c for c, _ in m.stream(48000)[0]]


def test_auplay_chain_on_cuda_matches_cpu():
    """auplay's preload chain on short tracks of six containers, on the card
    and on the CPU: every streamed chunk bit-equal; the loaders launch
    kernels (d), (e), (f), (g) and the FMA, and no plain version runs on the
    card."""
    tracks = load_sibling("torch_tracks")
    x = tracks.synth_track(1.5, 44100, seed=3)
    files = [("wav", tracks.pcm16_wav(x, 44100)), ("wav", tracks.ima_wav(x, 44100)),
             ("wav", tracks.msadpcm_wav(x, 44100)), ("qoa", tracks.qoa_file(x, 44100)),
             ("flac", tracks.flac_file(x, 44100, variants=3)[0]),
             ("au", tracks.ulaw_au(x, 44100, g711_expand_lut(True)))]
    launched = {k: 0 for k in (ima_decode_kernel, msadpcm_decode_kernel, qoa_lms_kernel,
                               lpc_restore_kernel, fma_kernel)}
    for loader, raw in files:
        want, want_chunks = _auplay(loader, raw, "cpu")
        kernels.reset_counts()
        got, got_chunks = _auplay(loader, raw, "cuda")
        assert np.array_equal(got, want)
        assert all(np.array_equal(g, w) for g, w in zip(got_chunks, want_chunks, strict=True))
        assert sum(fn.calls for fn in kernels.PLAIN) == 0
        for k in launched:
            launched[k] += k.launches
    assert all(n > 0 for n in launched.values())


def test_effects_on_cuda_match_cpu():
    """Every effect on a stereo 44.1 kHz track, on the card and on the CPU:
    bit-equal (the scans and block loops launch the FMA kernel on the card)."""
    rng = np.random.default_rng(8)
    d = ((rng.random((2, 88200)) * 2 - 1) * 0.6).astype(np.float32)
    d[:, :400] = 0
    calls = [("amplify", (1.3,)), ("speed", (1.2,)), ("fade", (0.2, 0.1, 1.5, 1.0)),
             ("invert", ()), ("normalize", (0.8, True)), ("center", ()), ("trim", ()),
             ("delay", (0.3, 0.5)), ("echo", (0.25, 0.5)), ("reverb", ()),
             ("lowpass", (3000,)), ("highpass", (200,))]
    for name, args in calls:
        a, b = tk.new_audio(d, 44100), tk.new_audio(d, 44100, device="cpu")
        getattr(fx, name)(a, *args)
        getattr(fx, name)(b, *args)
        assert np.array_equal(a.numpy(), b.numpy()), name
    a, b = tk.new_audio(d, 44100), tk.new_audio(d, 44100, device="cpu")
    for mode in ("none", "linear", "cubic", "sinc"):
        assert np.array_equal(a.resample(48000, mode).numpy(), b.resample(48000, mode).numpy())
    x = rng.random((64, 500))
    assert np.array_equal(tk.new_audio(x, 44100).mono().numpy(),
                          tk.new_audio(x, 44100, device="cpu").mono().numpy())


# -- the single-stream iterators -------------------------------------------------------

STREAM_FILES = ("wav_ima", "wav_msadpcm", "flac", "flac_wrapping", "qoa", "wav_dfpwm",
                "mdfpwm")


@pytest.fixture(scope="module")
def stream_files():
    """3 s of the whole-file phase's track in the kernel-backed containers
    (tests/torch_tracks.py), the DFPWM files made on the card."""
    tracks = load_sibling("torch_tracks")
    x = tracks.synth_track(3, 44100, seed=70)
    x48 = tracks.synth_track(3, 48000, seed=71)
    left, right = tk.new_audio(x48 / 32768.0, 48000).dfpwm(False)
    wrapping = tracks.flac_file(tracks.synth_track(0.5, 22050, 6), 22050, 3, 1024)[0]
    return {"wav_ima": tracks.ima_wav(x, 44100), "wav_msadpcm": tracks.msadpcm_wav(x, 44100),
            "flac": tracks.flac_file(x, 44100)[0], "qoa": tracks.qoa_file(x, 44100),
            # ROADMAP queue 3, fault 3.3: its unstable predictor leaves int32
            "flac_wrapping": wrapping[:68] + b"\x00" + wrapping[69:],
            "wav_dfpwm": tk.new_audio(x / 32768.0, 44100).wav(1),
            "mdfpwm": load_sibling("fixtures").mdfpwm_file(left, right,
                                                           len(left) + len(right))}


@pytest.mark.parametrize("name", STREAM_FILES)
def test_stream_iterator_kernels_match_plain(name, stream_files):
    """Each kernel-backed iterator drained on the card: every block decode
    it made (kernels (d), (e), (f), (g) at the iterator's own shapes: a
    second's blocks x channels, a refill's frames and subframes; kernel
    (g)'s rows with the rows it reported wrapped, and its wide int64 calls
    where a broken stream's rows wrapped) equals the plain version on the
    same inputs, and the chunks equal the iterator's on the CPU."""
    fn = "mdfpwm" if name == "mdfpwm" else "flac" if "flac" in name else \
        "qoa" if name == "qoa" else "wav"
    raw = stream_files[name]
    kernels.reset_counts()
    with kernel_cases.recorded_stream_decodes() as calls:
        got = [c for c, _ in getattr(tk.stream, fn)(raw)[0]]
    assert sum(p.calls for p in kernels.PLAIN) == 0
    # no row of a valid file wraps kernel (g)'s int32 store; the broken one's do
    assert (lpc_restore_kernel.wide_launches > 0) == (name == "flac_wrapping")
    made = [(kind, c) for kind, cs in calls.items() for c in cs]
    assert len(made) > 0 or "dfpwm" in name  # DFPWM decodes on the host's native route
    for kind, call in made:
        np.testing.assert_array_equal(kernel_cases.replay(kind, call, "cpu"), call[2])
    want = [c for c, _ in getattr(tk.stream, fn)(raw, device="cpu")[0]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["none", "linear", "cubic", "sinc"])
def test_stream_pcm_device_twin_matches_cpu(mode):
    """``stream.pcm`` over values on the card (ChunkResampler's device twin,
    its FMAs by the kernel) equals the same stream over CPU values (the
    FMA's plain version) bit for bit, and stays within the reference's 2e-2
    of the host oracle."""
    rng = np.random.default_rng(12)
    vals = rng.integers(-20000, 20000, 2 * 44100 * 2)
    saved = tk.CONFIG.default_interpolation
    tk.CONFIG.default_interpolation = mode
    try:
        kernels.reset_counts()
        got = [c for c, _ in tk.stream.pcm(torch.tensor(vals, device="cuda"), 16, "signed", 2,
                                           44100)[0]]
        assert fma_kernel.launches > 0 and all(c.is_cuda for c in got)
        cpu = [c for c, _ in tk.stream.pcm(torch.tensor(vals), 16, "signed", 2, 44100)[0]]
        host = [c for c, _ in tk.stream.pcm(vals.tolist(), 16, "signed", 2, 44100)[0]]
    finally:
        tk.CONFIG.default_interpolation = saved
    assert len(got) == len(cpu) == len(host)
    for g, c, h in zip(got, cpu, host):
        assert torch.equal(g.cpu(), c)
        np.testing.assert_allclose(c.numpy(), h, atol=2e-2)


def test_flac_restore_leaving_int32_restores_wrapped_rows_wide():
    """A FLAC stream whose unstable predictor leaves int32 (ROADMAP queue 3,
    fault 3.3): kernel (g) reports the rows its int32 store wrapped, and its
    wide entry point restores them again in int64 on the card (two launches,
    one of them wide); the samples equal the CPU's, nothing restores on the
    host."""
    from aukit_tpu_torch.codecs import flac

    tracks = load_sibling("torch_tracks")
    raw = tracks.flac_file(tracks.synth_track(0.5, 22050, 6), 22050, 3, 1024)[0]
    data = raw[:68] + b"\x00" + raw[69:]
    kernels.reset_counts()
    native_calls = []
    saved = flacbits.restore_lpc_flat
    flacbits.restore_lpc_flat = lambda *a, **k: native_calls.append(a)
    try:
        got = flac.decode_flac(data)[0]
    finally:
        flacbits.restore_lpc_flat = saved
    assert not native_calls
    assert lpc_restore_kernel.launches == 2 and lpc_restore_kernel.wide_launches == 1
    want = flac.decode_flac(data, device="cpu")[0]
    np.testing.assert_array_equal(got, want)
    assert got[0, 273] == np.float32(36739.324)


def test_programs_on_cuda_match_cpu(tmp_path):
    """The four programs' card runs against their ``--device cpu`` runs on
    short files: auplay and austream on a FLAC and an IMA WAV (austream
    refuses the IMA WAV's 48,620-sample chunks on both devices, as the JAX
    package does), auconvert to mono 48 kHz DFPWM and ``--fleet``, and
    ``play_fleet`` over a card Fleet's windows: equal bytes and outcomes;
    kernels (c), (d), (g) and the FMA launch, no plain version on the card."""
    from aukit_tpu_torch.cli import auconvert, auplay, austream
    from aukit_tpu_torch.playback import BufferSink, play_fleet
    from aukit_tpu_torch.stream.fleet import Fleet

    tracks = load_sibling("torch_tracks")
    x = tracks.synth_track(1.5, 44100, seed=5)
    files = {"flac": tracks.flac_file(x, 44100, variants=3)[0], "wav": tracks.ima_wav(x, 44100)}
    for ext, raw in files.items():
        (tmp_path / f"in.{ext}").write_bytes(raw)
    flac, wav = str(tmp_path / "in.flac"), str(tmp_path / "in.wav")
    runs = [(auplay.main, [flac, "-o", "{0}.raw"]), (auplay.main, [wav, "-o", "{0}.raw"]),
            (austream.main, [flac, "-o", "{0}.raw"]), (austream.main, [wav, "-o", "{0}.raw"]),
            (auconvert.main, ["-i", wav, "-o", "{0}.dfpwm", "-e", "mono", "-R", "48000"]),
            (auconvert.main, ["--fleet", "-i", flac, "-i", wav, "-o", "{0}.dfpwm", "-o",
                              "{1}.dfpwm"])]

    def outcome(main, args, device):
        outs = [str(tmp_path / f"{device}{k}") for k in range(2)]
        args = [a.format(*outs) for a in args]
        try:
            main(args + ["--device", device])
            err = None
        except ValueError as e:
            err = str(e)
        return err, [Path(a).read_bytes() for a in args if a.startswith(tuple(outs))]

    kernels.reset_counts()
    got = [outcome(*r, "cuda") for r in runs]
    assert sum(fn.calls for fn in kernels.PLAIN) == 0
    assert all(k.launches > 0 for k in (dfpwm_encode_kernel, ima_decode_kernel,
                                        lpc_restore_kernel, fma_kernel))
    want = [outcome(*r, "cpu") for r in runs]
    assert got == want
    assert got[3][0] == "chunk too large (48620 > 48000)"
    assert all(b for i, (_, outs) in enumerate(got) if i != 3 for b in outs)
    sinks = {}
    for device in ("cuda", "cpu"):
        sinks[device] = [BufferSink() for _ in files]
        play_fleet(Fleet(list(files.values()), device=device), sinks[device])
    for g, w in zip(sinks["cuda"], sinks["cpu"]):
        assert len(g.samples()) >= 48000 and np.array_equal(g.samples(), w.samples())


def test_sharded_engines_on_the_card_equal_the_cpu():
    """The multi-device layer on the card: a mixed fleet (fused DFPWM, DFPWM at
    32 kHz, IMA, QOA, PCM16; groups that divide no shard count) over three
    lane shards of the card, the sharded flagship step and the sharded FLAC
    restore, each equal to the CPU run, with every kernel launched once a
    live shard and no plain version on the card."""
    from aukit_tpu_torch.kernels.flac_cuda import lpc_restore_sharded
    from aukit_tpu_torch.parallel.pipeline import (decode_pipeline_scan, make_mesh,
                                                   sharded_pipeline_step)

    rng = np.random.default_rng(131)
    specs = ([LaneSpec("dfpwm", 48000)] * 4 + [LaneSpec("dfpwm", 32000)] * 2
             + [LaneSpec("ima", 8000, 1, block_align=256)] + [LaneSpec("qoa", 5120, 1)]
             + [LaneSpec("pcm16", 8000)] * 2)
    feeds = [rng.integers(0, 256, 7000, dtype=np.uint8).tobytes() for _ in range(6)]
    ima = rng.integers(0, 256, (12, 256), dtype=np.uint8)
    ima[:, 2], ima[:, 3] = rng.integers(0, 89, 12), 0
    feeds.append(ima.tobytes())
    feeds.append(rng.integers(0, 256, 8 + 16 + 256 * 8, dtype=np.uint8).tobytes())
    feeds += [rng.integers(0, 256, 20000, dtype=np.uint8).tobytes() for _ in range(2)]
    runs = []
    for mesh, device in ((make_mesh(3), "cuda"), (make_mesh(3, device="cpu"), "cpu")):
        kernels.reset_counts()
        eng = BatchStreamEngine(specs, mesh, device=device)
        eng.set_volume(1, 0.5, ramp=True)
        for lane, data in enumerate(feeds):
            eng.feed(lane, data)
            eng.feed(lane, None)
        runs.append([(r[0].cpu().numpy(), r[1].copy(), r[2].copy()) for r in iter(eng.step, None)])
        if device == "cuda":
            assert sum(fn.calls for fn in kernels.PLAIN) == 0
            assert dfpwm_decode_dsp_kernel.launches > 0 and dfpwm_decode_kernel.launches > 0
            assert ima_decode_kernel.launches > 0 and qoa_lms_kernel.launches > 0
    assert len(runs[0]) == len(runs[1]) > 0
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    fn, args = sharded_pipeline_step(make_mesh(4), 64, 200)
    out = [torch.cat(o).cpu() for o in fn(*args)]
    want, st = decode_pipeline_scan(torch.cat(args[0]).cpu(), DfpwmState.zeros(64), 48000, 0.9)
    assert torch.equal(out[0], want)
    assert all(torch.equal(o, s) for o, s in zip(out[1:], st.leaves()))
    _name, (vals, orders, shifts, blocks, coefs), _k = list(kernel_cases.lpc_cases("cpu"))[2]
    got = lpc_restore_sharded(vals, orders, shifts, blocks, coefs, make_mesh(3))
    assert got.device.type == "cuda"
    want = lpc_restore_sharded(vals, orders, shifts, blocks, coefs, make_mesh(3, device="cpu"))
    assert torch.equal(got.cpu(), want)
