"""Effects suite — counterpart of ``aukit_tpu.effects`` (reference
aukit.effects, aukit.lua:3349-3618).

Reference effects mutate the Audio in place and return it; that contract is
kept (``_set`` replaces the object's ``data`` with a new tensor) while every
transform is a tensor computation on the data's device.

Float rounding follows the JAX package as it runs: its eager effects round
every operation on its own, so they are written here as separate torch
operations and never fused. Its jitted scans are compiled by XLA, which
contracts each multiply that feeds an add into a fused multiply-add (read
from the optimised code of ``_feedback_blocks`` and ``_allpass_inplace``);
those multiply-adds are ``fma_kernel`` calls here. A Python float constant is
a float32 constant in JAX; it is rounded to float32 here before use, and
every division divides two tensors (torch divides by a host scalar on the
card as a multiply by its reciprocal).

 - ``lowpass``/``highpass``: first-order linear recurrences (aukit.lua:3586,
   3604) as ``ops.scan.linear_scan``, the combine tree of the JAX package's
   ``associative_scan``.
 - ``echo`` (aukit.lua:3524) and the four comb filters of ``reverb``: feedback
   at a lag of ``delay * rate`` samples, a loop over lag-sized blocks, each
   reading only the previous block's finished values.
 - ``reverb`` (aukit.lua:3546): the combs, then the reference's two in-place
   allpass passes, including its forward tap ``sum[i + 20 - samples]`` and
   the double application to sample ``samples + 1``.

Divergences from reference defects, as in the JAX package: ``trim``
implements the documented intent (the reference's own trim always errors);
``normalize`` of silence returns silence (the reference divides by 0);
``fade`` clamps its index range into the samples.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .audio import Audio
# private names: the public callables of this module are the JAX module's
# (``auconvert -e list`` lists them)
from .kernels.fma_cuda import fma_kernel as _fma_kernel
from .ops.scan import linear_scan as _linear_scan

_ALLPASS = float(np.float32(0.131))  # the allpass gain, a float32 constant


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX takes a Python constant."""
    return float(np.float32(x))


def _set(audio: Audio, data) -> Audio:
    audio.data = data
    return audio


def amplify(audio: Audio, multiplier: float) -> Audio:
    """clamp(x * multiplier) (aukit.lua:3356)."""
    if multiplier == 1:
        return audio
    return _set(audio, (audio.data * _f32(multiplier)).clamp(-1.0, 1.0))


def speed(audio: Audio, multiplier: float) -> Audio:
    """Change speed+pitch, keeping the sample rate (aukit.lua:3376): resample
    from rate*multiplier to rate. Exact rational ratio via Fraction."""
    if multiplier == 1:
        return audio
    from .config import get_interpolation
    from .ops.resample import resample_audio_array

    frac = Fraction(multiplier).limit_denominator(1 << 24)
    out = resample_audio_array(
        audio.data, int(frac.numerator), int(frac.denominator), get_interpolation(None)
    )
    return _set(audio, out)


def fade(
    audio: Audio,
    start_time: float,
    start_amplitude: float,
    end_time: float,
    end_amplitude: float,
) -> Audio:
    """Linear amplitude ramp over [start_time, end_time] seconds (aukit.lua:3394);
    the gains in float64 on the host, rounded to float32 once."""
    if start_amplitude == 1 and end_amplitude == 1:
        return audio
    sr = audio.sample_rate
    n = audio.num_samples
    start = start_time * sr
    m = (end_amplitude - start_amplitude) / ((end_time - start_time) * sr)
    i0 = max(int(np.ceil(start)), 1)
    i1 = min(int(np.floor(end_time * sr)), n)
    if i1 < i0:
        return audio
    idx = np.arange(i0, i1 + 1, dtype=np.float64)
    gain = torch.from_numpy((m * (idx - start) + start_amplitude).astype(np.float32))
    out = audio.data.clone()
    out[:, i0 - 1: i1] = (audio.data[:, i0 - 1: i1] * gain.to(audio.device)).clamp(-1.0, 1.0)
    return _set(audio, out)


def invert(audio: Audio) -> Audio:
    """Polarity inversion (aukit.lua:3417)."""
    return _set(audio, -audio.data)


def normalize(audio: Audio, peak_amplitude: float = 1.0, independent: bool = False) -> Audio:
    """Scale to a peak amplitude, globally or per channel (aukit.lua:3431)."""
    d = audio.data
    if independent:
        peak = d.abs().amax(dim=1, keepdim=True)
    else:
        peak = d.abs().amax()
    target = torch.tensor(_f32(peak_amplitude), dtype=torch.float32, device=d.device)
    mult = torch.where(peak > 0, target / peak.clamp(min=_f32(1e-30)), 0.0)
    return _set(audio, (d * mult).clamp(-1.0, 1.0))


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halves (zero-padded to a power of two): the
    same order on every device. XLA's reduce order is its own: the results
    agree to float32 rounding (held to 2e-6 in the tests)."""
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def center(audio: Audio) -> Audio:
    """Remove DC offset per one-second window (aukit.lua:3464)."""
    d = audio.data
    c, n = d.shape
    sr = audio.sample_rate
    nwin = -(-n // sr)
    pad = nwin * sr - n
    w = torch.nn.functional.pad(d, (0, pad)).reshape(c, nwin, sr)
    counts = np.maximum(np.minimum(n - np.arange(nwin) * sr, sr), 1).astype(np.float32)
    means = _tree_sum(w) / torch.from_numpy(counts).to(d.device)  # [c, nwin]
    out = (w - means[:, :, None]).clamp(-1.0, 1.0).reshape(c, nwin * sr)[:, :n]
    return _set(audio, out)


def trim(audio: Audio, threshold: float = 1.0 / 65536) -> Audio:
    """Strip leading/trailing silence below threshold (intended semantics of
    aukit.lua:3483; the reference implementation itself errors)."""
    d = audio.data
    if d.shape[1] == 0:
        return _set(audio, d[:, :0])
    above = torch.nonzero(d.abs().amax(dim=0) > threshold)[:, 0].cpu()
    if len(above) == 0:
        return _set(audio, d[:, :0])
    return _set(audio, d[:, int(above[0]): int(above[-1]) + 1])


def delay(audio: Audio, delay_time: float, multiplier: float = 0.5) -> Audio:
    """Add a scaled copy of the *original* signal shifted by delay seconds
    (aukit.lua:3505)."""
    samples = int(np.floor(delay_time * audio.sample_rate))
    d = audio.data
    if samples <= 0 or samples >= d.shape[1]:
        return audio
    shifted = torch.nn.functional.pad(d[:, : d.shape[1] - samples], (samples, 0))
    return _set(audio, (d + shifted * _f32(multiplier)).clamp(-1.0, 1.0))


def _feedback_blocks(d: torch.Tensor, lag: int, multiplier, clamp: bool) -> torch.Tensor:
    """In-place feedback ``y[i] = f(y[i] + y[i-lag]*mult)`` for i >= lag, as a
    loop over lag-sized blocks: each block reads only the previous block's
    updated values. The multiply-add is one ``fma_kernel`` call, as XLA
    contracts it in the JAX package's jitted block scan."""
    n = d.shape[1]
    mult = _f32(multiplier)
    out = d.clone()
    for s in range(lag, n, lag):
        e = min(s + lag, n)
        y = _fma_kernel(out[:, s - lag: e - lag], mult, d[:, s:e])
        out[:, s:e] = y.clamp(-1.0, 1.0) if clamp else y
    return out


def echo(audio: Audio, delay_time: float = 1.0, multiplier: float = 0.5) -> Audio:
    """In-place feedback echo with clamping (aukit.lua:3524)."""
    samples = int(np.floor(delay_time * audio.sample_rate))
    d = audio.data
    if samples <= 0 or samples >= d.shape[1]:
        return audio
    return _set(audio, _feedback_blocks(d, samples, multiplier, clamp=True))


_COMB_DELAY_SHIFT = (0.0, -11.73, 19.31, -7.97)  # ms (aukit.lua:3543)
_COMB_DECAY_SHIFT = (0.0, 0.1313, 0.2743, 0.31)


def _allpass_inplace(s: torch.Tensor, lag: int) -> torch.Tensor:
    """The reference's *in-place* allpass pass (aukit.lua:3574-3575, with its
    forward tap): sequentially for j >= lag+1 (0-based),
        s[j] = s[j] - 0.131*s[j-lag] + 0.131*s[j-(lag-20)]
    reading already-updated values. Both taps lie at least blk = lag-20
    samples back, so a loop over blk-sized blocks (on the JAX package's block
    grid) sees only finished history. Both multiply-adds are ``fma_kernel``
    calls, as XLA contracts them."""
    c, n = s.shape
    if lag <= 21 or lag + 1 >= n:
        return s
    blk = lag - 20
    out = s.clone()
    for a in range(0, n, blk):
        b, lo = min(a + blk, n), max(a, lag + 1)
        if lo >= b:
            continue
        upd = _fma_kernel(out[:, lo - lag: b - lag], -_ALLPASS, out[:, lo:b])
        out[:, lo:b] = _fma_kernel(out[:, lo - blk: b - blk], _ALLPASS, upd)
    return out


def reverb(
    audio: Audio,
    delay_ms: float = 100.0,
    decay: float = 0.3,
    wet_multiplier: float = 1.0,
    dry_multiplier: float = 0.0,
) -> Audio:
    """Schroeder-style reverb (aukit.lua:3546): 4 parallel comb filters with
    per-comb delay/decay shifts, wet/dry mix, then two in-place allpass passes
    at 0.08927 s (with the reference's forward tap)."""
    d = audio.data
    c, n = d.shape
    sr = audio.sample_rate
    total = torch.zeros_like(d)
    for k in range(4):
        lag = int(np.floor((delay_ms + _COMB_DELAY_SHIFT[k]) / 1000.0 * sr))
        mult = decay - _COMB_DECAY_SHIFT[k]
        if lag <= 0 or lag >= n:
            total = total + d
        else:
            total = total + _feedback_blocks(d, lag, mult, clamp=False)
    total = total * _f32(wet_multiplier) + d * _f32(dry_multiplier)
    lag = int(np.floor(0.08927 * sr))
    if 21 < lag + 1 < n:
        # pass 1 (aukit.lua:3573-3575): pre-step at index lag (0-based), then
        # the sequential in-place allpass over sum
        total = total.clone()
        total[:, lag] = total[:, lag] + total[:, 0] * -_ALLPASS
        total = _allpass_inplace(total, lag)
        # pass 2 (aukit.lua:3576-3577): pure FIR over the *finished* sum,
        # written into the output; index lag gets the 0.131*sum[0]
        # subtraction applied a second time (the reference's double application)
        tap_lag = torch.nn.functional.pad(total[:, : n - lag], (lag, 0))
        fwd = lag - 20
        tap_fwd = torch.nn.functional.pad(total[:, : n - fwd], (fwd, 0))
        fir = (total - tap_lag * _ALLPASS + tap_fwd * _ALLPASS).clamp(-1.0, 1.0)
        out = d.clone()
        out[:, lag + 1:] = fir[:, lag + 1:]
        out[:, lag] = (total[:, lag] - total[:, 0] * _ALLPASS).clamp(-1.0, 1.0)
    else:
        out = d
    return _set(audio, out)


def lowpass(audio: Audio, frequency: float) -> Audio:
    """One-pole lowpass y[i] = y[i-1] + a*(x[i]-y[i-1]) (aukit.lua:3586),
    evaluated as the associative scan over affine maps."""
    a = 1.0 - np.exp(-(frequency / audio.sample_rate) * 2.0 * np.pi)
    d = audio.data
    n = d.shape[1]
    if n < 2:
        return audio
    # y[0] = x[0]; for i>0: y[i] = (1-a) y[i-1] + a x[i]
    A = torch.full(d.shape, _f32(1.0 - a), dtype=torch.float32, device=d.device)
    A[:, 0] = 0.0
    B = d * _f32(a)
    B[:, 0] = d[:, 0]
    return _set(audio, _linear_scan(A, B))


def highpass(audio: Audio, frequency: float) -> Audio:
    """One-pole highpass y[i] = a*(y[i-1] + x[i] - x[i-1]) (aukit.lua:3604),
    the associative scan over affine maps."""
    a = 1.0 / (2.0 * np.pi * (frequency / audio.sample_rate) + 1.0)
    d = audio.data
    n = d.shape[1]
    if n < 2:
        return audio
    dx = d[:, 1:] - d[:, :-1]  # x[i] - x[i-1] for i>=1
    A = torch.full(d.shape, _f32(a), dtype=torch.float32, device=d.device)
    A[:, 0] = 0.0
    B = torch.cat([d[:, :1], dx * _f32(a)], dim=1)
    return _set(audio, _linear_scan(A, B))
