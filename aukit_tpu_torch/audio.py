"""The Audio object — counterpart of ``aukit_tpu.audio``: a float32
``torch.Tensor[C, N]`` on an explicit device, plus its sample rate.

The reference's Audio class (aukit.lua:631-1024) stores per-channel Lua
arrays of doubles in [-1, 1]; here one dense tensor holds every channel and
every operation is a tensor transform that stays on the data's device.
The encoders (``pcm``, ``to_pcm_bytes``, ``wav``, ``dfpwm``, ``stream``)
return what the JAX package returns: numpy values, bytes, and an iterator of
numpy chunks.

Semantics parity notes (reference line numbers):
 - ``resample``      aukit.lua:653  ratio interpolation, clamp only on fractional x
 - ``mono``          aukit.lua:677  mean over channels
 - ``concat``        aukit.lua:696  time-axis concat, auto-resample, zero-fill
 - ``sub``           aukit.lua:726  seconds-based subregion, +/-/0 end conventions
 - ``combine``       aukit.lua:751  channel-axis concat, zero-pad to longest
 - ``split``         aukit.lua:779  select channel subsets
 - ``mix``           aukit.lua:804  sum + amplify + clip (audio-as-amplifier form)
 - ``rep``           aukit.lua:840  tiling
 - ``reverse``       aukit.lua:857  time reversal
 - operators         aukit.lua:1020 ``+``=combine ``*``=rep (``..``=concat -> .concat)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .config import get_interpolation, require_device
from .utils.validation import check_bit_depth, check_data_type


def _as_data(x, device) -> torch.Tensor:
    """Samples as float32 [C, N] on ``device`` (a 1-D input is one channel);
    float64 input is rounded to nearest once, as ``jnp.asarray`` does."""
    if isinstance(x, torch.Tensor):
        arr = x.to(device=device, dtype=torch.float32)
    else:  # a copy: the Audio never shares the caller's buffer
        arr = torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    if arr.dim() == 1:
        arr = arr[None, :]
    if arr.dim() != 2:
        raise ValueError(f"audio data must be [channels, samples], got shape {tuple(arr.shape)}")
    return arr


def _sum_in_order(rows: list) -> torch.Tensor:
    """rows[0] + rows[1] + ..., each add rounded in turn."""
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc


def mean_channels(data: torch.Tensor) -> torch.Tensor:
    """The mean of ``data[C, N]``'s rows as ``[1, N]``, in the order XLA
    computes a jitted ``mean(axis=0)``: see ``Audio.mono``."""
    c = data.shape[0]
    run = -(-c // 2) if 32 < c <= 64 else 32 if c % 32 == 0 else c
    rows = [data[i: i + 1] for i in range(c)]
    parts = [_sum_in_order(rows[i: i + run]) for i in range(0, c, run)]
    return _sum_in_order(parts) * float(np.float32(1.0 / c))


@dataclasses.dataclass
class Audio:
    """A chunk of audio: ``data[C, N]`` float32 in [-1, 1] at ``sample_rate`` Hz."""

    data: torch.Tensor
    sample_rate: int
    metadata: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)

    # -- basic queries -------------------------------------------------------
    @property
    def channels(self) -> int:
        """Number of channels (reference Audio:channels, aukit.lua:644)."""
        return int(self.data.shape[0])

    @property
    def num_samples(self) -> int:
        return int(self.data.shape[1])

    @property
    def duration(self) -> float:
        """Length in seconds (reference Audio:len / ``#audio``, aukit.lua:638)."""
        return self.num_samples / self.sample_rate

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __len__(self) -> int:
        return self.num_samples

    def __repr__(self) -> str:
        return (
            f"Audio: {self.sample_rate} Hz, {self.channels} channels, "
            f"{self.duration} seconds"
        )

    def _like(self, data: torch.Tensor, sample_rate: int | None = None) -> "Audio":
        return Audio(
            data,
            sample_rate if sample_rate is not None else self.sample_rate,
            dict(self.metadata),
            dict(self.info),
        )

    def _at_rate(self, other: "Audio") -> "Audio":
        return other.resample(self.sample_rate) if other.sample_rate != self.sample_rate else other

    # -- transforms ----------------------------------------------------------
    def resample(self, sample_rate: int, interpolation: str | None = None) -> "Audio":
        """Resample to a new rate (reference Audio:resample, aukit.lua:653)."""
        from .ops.resample import resample_audio_array

        interpolation = get_interpolation(interpolation)
        if sample_rate == self.sample_rate:
            return self._like(self.data)
        out = resample_audio_array(self.data, self.sample_rate, sample_rate, interpolation)
        return self._like(out, sample_rate)

    def mono(self) -> "Audio":
        """Mix all channels to one by arithmetic mean (aukit.lua:677): a sum
        in XLA's order for the JAX package's mean, then a multiply by
        float32(1 / C), as XLA compiles the division. XLA adds up to 32
        channels in order; 33 to 64 as two runs of ceil(C / 2), and a
        multiple of 32 as runs of 32, each run in order, then the runs in
        order. Other counts above 64 are added in order here, which differs
        from XLA's reduce within float32 rounding. The same on every device."""
        return self._like(mean_channels(self.data))

    def concat(self, *others: "Audio") -> "Audio":
        """Concatenate along time (aukit.lua:696): later audios are resampled to
        this rate; missing channels are zero-filled."""
        audios = [self] + [self._at_rate(o) for o in others]
        cn = max(a.channels for a in audios)
        parts = [torch.nn.functional.pad(a.data, (0, 0, 0, cn - a.channels)) for a in audios]
        return self._like(torch.cat(parts, dim=1))

    def sub(self, start: float | None = None, last: float | None = None) -> "Audio":
        """Subregion in *seconds* with string.sub-like conventions (aukit.lua:726):
        negative start counts from the end; ``last <= 0`` counts from the end."""
        start = int(np.floor(start or 0))
        last = int(np.floor(last or 0))
        length = self.num_samples / self.sample_rate
        if start < 0:
            start = length + start
        if last <= 0:
            last = length + last
        if not (0 <= start <= length and 0 <= last <= length):
            raise ValueError("sub range out of bounds")
        i0 = int(start * self.sample_rate)
        i1 = int(last * self.sample_rate) + 1  # inclusive end, like the reference
        return self._like(self.data[:, i0:i1])

    def combine(self, *others: "Audio") -> "Audio":
        """Stack channels (aukit.lua:751), zero-padding shorter audio."""
        audios = [self] + [self._at_rate(o) for o in others]
        n = max(a.num_samples for a in audios)
        parts = [torch.nn.functional.pad(a.data, (0, n - a.num_samples)) for a in audios]
        return self._like(torch.cat(parts, dim=0))

    def split(self, *channel_lists: Sequence[int]) -> "Audio | tuple[Audio, ...]":
        """Select channel subsets (1-based indices, like the reference,
        aukit.lua:779). Returns one Audio per list."""
        out = []
        for cl in channel_lists:
            if len(cl) == 0:
                raise ValueError("cannot use empty channel list")
            for c in cl:
                if not (1 <= c <= self.channels):
                    raise ValueError(f"channel {c} out of range")
            idx = torch.tensor([c - 1 for c in cl], device=self.device)
            out.append(self._like(self.data.index_select(0, idx)))
        return out[0] if len(out) == 1 else tuple(out)

    def mix(self, amplifier, *others: "Audio") -> "Audio":
        """Mix audios sample-wise with optional amplifier then clip (aukit.lua:804).
        ``amplifier`` may be a number or another Audio (then treated as an input
        with amplifier 1, matching the reference)."""
        audios = [self]
        amp = 1.0
        if isinstance(amplifier, Audio):
            audios.append(self._at_rate(amplifier))
        else:
            amp = float(amplifier)
        audios += [self._at_rate(o) for o in others]
        n = max(a.num_samples for a in audios)
        cn = max(a.channels for a in audios)
        acc = torch.zeros((cn, n), dtype=torch.float32, device=self.device)
        for a in audios:
            acc = acc + torch.nn.functional.pad(a.data, (0, n - a.num_samples,
                                                         0, cn - a.channels))
        # a Python float is a float32 constant, as in the JAX package
        return self._like((acc * float(np.float32(amp))).clamp(-1.0, 1.0))

    def rep(self, count: int) -> "Audio":
        """Repeat ``count`` times along time (aukit.lua:840)."""
        return self._like(self.data.repeat(1, int(count)))

    def reverse(self) -> "Audio":
        """Reverse along time (aukit.lua:857)."""
        return self._like(self.data.flip(1))

    # -- operators (aukit.lua:1020) -------------------------------------------
    def __add__(self, other: "Audio") -> "Audio":
        return self.combine(other)

    def __mul__(self, count: int) -> "Audio":
        return self.rep(count)

    __rmul__ = __mul__

    # -- encoders --------------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """The samples as a float32 numpy array [C, N] on the host."""
        return self.data.detach().cpu().numpy()

    def pcm(self, bit_depth: int = 8, data_type: str = "signed", interleaved: bool = True):
        """Convert to raw PCM sample values (reference Audio:pcm, aukit.lua:901).

        Returns a numpy float array of *unquantized* sample values exactly like the
        reference's encodePCM (aukit.lua:868): ``d * (d < 0 ? 2^(b-1) : 2^(b-1)-1)
        + bias`` with no rounding (and the float path returning data untouched).
        Shape: ``[C*N]`` interleaved or ``[C, N]`` planar.
        """
        from .ops.pcmcode import encode_pcm_values

        check_bit_depth(bit_depth)
        check_data_type(data_type, bit_depth)
        vals = encode_pcm_values(self.numpy(), bit_depth, data_type)
        if interleaved:
            return vals.T.reshape(-1)
        return vals

    def to_pcm_bytes(
        self,
        bit_depth: int = 8,
        data_type: str = "signed",
        interleaved: bool = True,
        big_endian: bool = False,
    ) -> bytes:
        """Quantize and serialize to raw PCM bytes (composes Audio:pcm +
        aukit.pack, aukit.lua:901/1861)."""
        from .ops.pcmcode import pack_pcm

        vals = self.pcm(bit_depth, data_type, interleaved)
        return pack_pcm(np.asarray(vals).reshape(-1), bit_depth, data_type, big_endian)

    def wav(self, bit_depth: int = 16) -> bytes:
        """Encode as a WAV file (reference Audio:wav, aukit.lua:942).
        ``bit_depth == 1`` produces DFPWM-in-WAV (WAVE_FORMAT_EXTENSIBLE)."""
        from .containers.wav import encode_wav

        return encode_wav(self, bit_depth)

    def dfpwm(self, interleaved: bool = True):
        """Encode to DFPWM1a (reference Audio:dfpwm, aukit.lua:1005) on the
        data's device: all channels share one encoder when interleaved;
        otherwise one encoder per channel."""
        from .codecs.dfpwm import encode_dfpwm_audio

        return encode_dfpwm_audio(self, interleaved)

    def stream(self, chunk_size: int = 131072, bit_depth: int = 8, data_type: str = "signed"):
        """Chunked PCM iterator (reference Audio:stream, aukit.lua:921): yields
        ``(values_per_channel, position_seconds)`` tuples of numpy values."""
        check_bit_depth(bit_depth)
        check_data_type(data_type, bit_depth)
        from .ops.pcmcode import encode_pcm_values

        data = self.numpy()
        total = data.shape[1]
        sr = self.sample_rate

        def iterator():
            pos = 0
            while pos < total:
                chunk = encode_pcm_values(data[:, pos: pos + chunk_size], bit_depth, data_type)
                yield chunk, pos / sr
                pos += chunk_size

        return iterator(), total / sr


def new_audio(data, sample_rate: int, metadata: dict | None = None, info: dict | None = None,
              device="cuda") -> Audio:
    """An Audio over ``data`` ([C, N] or [N] samples, any array or tensor) as
    float32 on ``device`` (pass ``device="cpu"`` for the CPU)."""
    device = require_device(device, "new_audio")
    return Audio(_as_data(data, device), int(sample_rate), metadata or {}, info or {})


def loaded_audio(data, sample_rate, metadata: dict, info: dict, device) -> Audio:
    """The loaders' Audio: as ``new_audio``, but the sample rate is kept as
    given, as the JAX loaders keep it (an AIFF header or a caller may give a
    fractional rate, such as 22254.545 Hz)."""
    device = require_device(device, "loaded_audio")
    return Audio(_as_data(data, device), sample_rate, metadata, info)
