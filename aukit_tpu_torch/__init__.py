"""aukit_tpu_torch: the PyTorch/CUDA port of aukit-tpu.

The whole-file surface: the loaders ``pcm``, ``adpcm``, ``msadpcm``,
``g711``, ``dfpwm``, ``mdfpwm``, ``wav``, ``aiff``, ``au``, ``flac``, ``qoa``
(each decodes onto ``device``, the card unless the caller passes "cpu"),
the generators ``new``, ``tone``, ``noise``, ``pack`` and ``detect``, the
``Audio`` object (transforms on its device; encoders to PCM values, WAV and
DFPWM bytes, chunked streams) and ``effects``. The lane-batched decode
engine (DFPWM, PCM, f32, G.711, IMA and MS ADPCM, QOA -> 48 kHz int8, mono
or per-channel windows, with per-lane filter, mono and normalize stages),
the batched FLAC fleet, the ``Fleet`` facade over both (any container, with
seek) and the batched encode engine (the write path: DFPWM and PCM
8/16/24/32, device-to-device transcodes) on an NVIDIA GPU, with hand-written
CUDA kernels for Hopper; and the single-stream iterators of ``stream``
(``stream.pcm``, ``.wav``, ``.flac``, ...: one second of 48 kHz audio a
call, their block decodes on ``device``); playback (``play``, ``player``,
``play_file``, ``playback.play_fleet`` and the sinks of ``playback``),
``utils.trace`` on ``torch.profiler``, and the four programs of ``cli``
(``python -m aukit_tpu_torch.cli.auplay``, ``.austream``, ``.austream_tm``,
``.auconvert``; each takes ``--device {cuda,cpu}``, the card by default); and
the multi-device layer: ``parallel.pipeline.make_mesh`` (lane shards over
the visible cards, round-robin, several to a card), the ``mesh=`` option of
every engine, ``sharded_pipeline_step``, the sharded FLAC restore, and
``parallel.distributed`` (``MultiHostEngine`` and the flagship step over a
``torch.distributed`` gloo group). It mirrors the module paths and public
names of the JAX package ``aukit_tpu``, which stays the reference, and
imports neither ``jax`` nor ``aukit_tpu``.
"""

from __future__ import annotations

import numpy as np

from .audio import Audio, loaded_audio, new_audio
from .codecs.dfpwm import (DfpwmState, decode_dfpwm_bytes, dfpwm_decode, dfpwm_encode,
                           encode_dfpwm_bytes)
from .config import CONFIG, require_device
from .kernels import (dfpwm_decode_dsp_kernel, dfpwm_decode_kernel, dfpwm_encode_kernel,
                      iir_zero_kernel, ima_decode_kernel, lpc_restore_kernel,
                      msadpcm_decode_kernel, qoa_lms_kernel)
from .stream import (BatchDfpwmDecoder, BatchDfpwmEncoder, BatchEncodeEngine, BatchMetrics,
                     BatchStreamEngine, EncodeSpec, FlacFleet, Fleet, LaneSpec,
                     encode_windows_many, lane_spec_for_aiff,
                     lane_spec_for_au, lane_spec_for_qoa, lane_spec_for_wav, mdfpwm_to_lanes,
                     transcode_fleet)

__version__ = "0.3.0"
_REFERENCE_VERSION = "1.10.0"  # aukit.lua:98

__all__ = ["Audio", "new_audio", "pcm", "adpcm", "msadpcm", "g711", "dfpwm", "mdfpwm", "wav",
           "aiff", "au", "flac", "qoa", "new", "tone", "noise", "pack", "detect", "effects",
           "stream", "play", "player", "play_file", "CONFIG", "DfpwmState", "dfpwm_decode",
           "dfpwm_encode", "decode_dfpwm_bytes", "encode_dfpwm_bytes", "dfpwm_decode_kernel", "dfpwm_decode_dsp_kernel",
           "dfpwm_encode_kernel", "BatchDfpwmEncoder", "BatchEncodeEngine", "EncodeSpec",
           "encode_windows_many", "transcode_fleet",
           "ima_decode_kernel", "msadpcm_decode_kernel", "qoa_lms_kernel",
           "lpc_restore_kernel", "iir_zero_kernel", "FlacFleet", "Fleet",
           "BatchStreamEngine", "BatchDfpwmDecoder", "BatchMetrics", "LaneSpec",
           "lane_spec_for_wav", "lane_spec_for_aiff", "lane_spec_for_au", "lane_spec_for_qoa",
           "mdfpwm_to_lanes"]


# -- loaders (reference aukit.* constructors, aukit.lua:1049-1777) -------------------------
# Each decodes onto ``device`` (the card unless the caller passes "cpu"); the
# container and codec modules say which kernels each one launches.


def pcm(
    data,
    bit_depth: int = 8,
    data_type: str = "signed",
    channels: int = 1,
    sample_rate: int = 48000,
    interleaved: bool = True,
    big_endian: bool = False,
    device="cuda",
) -> Audio:
    """Raw PCM -> Audio (reference aukit.pcm, aukit.lua:1049)."""
    from .ops import pcmcode
    from .utils.validation import check_bit_depth, check_data_type

    check_bit_depth(bit_depth)
    check_data_type(data_type, bit_depth)
    device = require_device(device, "pcm")
    arr = pcmcode.decode_pcm(data, bit_depth, data_type, channels, interleaved, big_endian)
    return loaded_audio(arr, sample_rate, {}, {"bitDepth": bit_depth, "dataType": data_type},
                        device)


def adpcm(
    data,
    channels: int = 1,
    sample_rate: int = 48000,
    top_first: bool = True,
    interleaved: bool = True,
    predictor=None,
    step_index=None,
    device="cuda",
) -> Audio:
    """IMA ADPCM -> Audio (reference aukit.adpcm, aukit.lua:1183)."""
    from .codecs.adpcm import decode_ima_adpcm
    from .ops import pcmcode

    preds = decode_ima_adpcm(data, channels, top_first, interleaved, predictor, step_index,
                             device)
    norm = pcmcode.normalize_pcm(preds, 16, "signed")
    return loaded_audio(norm, sample_rate, {}, {"bitDepth": 16, "dataType": "signed"}, device)


def msadpcm(
    data: bytes,
    block_align: int,
    channels: int = 1,
    sample_rate: int = 48000,
    coefficients=None,
    device="cuda",
) -> Audio:
    """Microsoft ADPCM -> Audio (reference aukit.msadpcm, aukit.lua:1283)."""
    from .codecs.adpcm import decode_msadpcm
    from .ops import pcmcode

    device = require_device(device, "msadpcm")
    preds = decode_msadpcm(data, block_align, channels, coefficients, device=device)
    norm = pcmcode.normalize_pcm(preds, 16, "signed")
    return loaded_audio(norm, sample_rate, {}, {"bitDepth": 16, "dataType": "signed"}, device)


def g711(data: bytes, ulaw: bool, channels: int = 1, sample_rate: int = 8000,
         device="cuda") -> Audio:
    """G.711 u-law/A-law -> Audio (reference aukit.g711, aukit.lua:1361).
    The reference stores bitDepth/dataType in *metadata*, replicated here."""
    from .codecs.g711 import decode_g711

    device = require_device(device, "g711")
    arr = decode_g711(data, ulaw, channels, denom=0x2000)
    return loaded_audio(arr, sample_rate, {"bitDepth": 14 if ulaw else 13, "dataType": "signed"},
                        {}, device)


def dfpwm(data: bytes, channels: int = 1, sample_rate: int = 48000, device="cuda") -> Audio:
    """DFPWM1a -> Audio (reference aukit.dfpwm, aukit.lua:1392): one shared
    decoder over the full stream, samples interleaved."""
    from .codecs.dfpwm import decode_dfpwm_audio

    device = require_device(device, "dfpwm")
    arr = decode_dfpwm_audio(data, channels, sample_rate, device)
    return loaded_audio(arr, sample_rate, {}, {"bitDepth": 8, "dataType": "signed"}, device)


def mdfpwm(data: bytes, head: bool = False, device="cuda") -> Audio:
    """MDFPWMv3 -> Audio (reference aukit.mdfpwm, aukit.lua:1420)."""
    from .containers.mdfpwm import decode_mdfpwm

    return decode_mdfpwm(data, head, device)


def wav(data: bytes, head: bool = False, device="cuda") -> Audio:
    """WAV -> Audio (reference aukit.wav, aukit.lua:1456)."""
    from .containers.wav import decode_wav

    return decode_wav(data, head, device)


def aiff(data: bytes, head: bool = False, device="cuda") -> Audio:
    """AIFF/AIFC -> Audio (reference aukit.aiff, aukit.lua:1580)."""
    from .containers.aiff import decode_aiff

    return decode_aiff(data, head, device)


def au(data: bytes, device="cuda") -> Audio:
    """Sun AU -> Audio (reference aukit.au, aukit.lua:1639)."""
    from .containers.au import decode_au

    return decode_au(data, device)


def flac(data: bytes, head: bool = False, device="cuda") -> Audio:
    """FLAC -> Audio (reference aukit.flac, aukit.lua:1657)."""
    from .codecs.flac import decode_flac_audio

    return decode_flac_audio(data, head, device)


def qoa(data: bytes, device="cuda") -> Audio:
    """QOA -> Audio (reference aukit.qoa, aukit.lua:1706)."""
    from .codecs.qoa import decode_qoa_audio

    return decode_qoa_audio(data, device)


# -- generators and utilities ------------------------------------------------------------

from .ops.generate import noise, silence, tone  # noqa: E402


def new(duration: float, channels: int = 1, sample_rate: int = 48000, device="cuda") -> Audio:
    """Silence (reference aukit.new, aukit.lua:1784)."""
    return silence(duration, channels, sample_rate, device)


def pack(data, bit_depth: int = 8, data_type: str = "signed", big_endian: bool = False) -> bytes:
    """Sample values -> packed bytes (reference aukit.pack, aukit.lua:1861)."""
    from .ops import pcmcode
    from .utils.validation import check_bit_depth, check_data_type

    check_bit_depth(bit_depth)
    check_data_type(data_type, bit_depth)
    return pcmcode.pack_pcm(np.asarray(data), bit_depth, data_type, big_endian)


def detect(data: bytes):
    """Magic/heuristic format detection (reference aukit.detect, aukit.lua:2156).
    Returns (type, bit_depth, data_type) with Nones where unknown."""
    from .containers.detect import detect_format

    return detect_format(data)


# the stream iterators that take ``device`` (their block decodes run there)
_DEVICE_STREAMS = ("dfpwm", "mdfpwm", "wav", "flac", "qoa")


def play_file(path: str, *sinks, volume: float | None = None, device="cuda"):
    """One-liner player (the reference module's __call metamethod,
    aukit.lua:100-107): detect the format from the first 64 bytes (DFPWM as
    the fallback), stream-decode, and play. With no sinks, a realtime-paced
    null sink is used. The iterators that decode blocks do so on ``device``
    (the card unless the caller passes "cpu")."""
    from .playback import NullSink

    device = require_device(device, "play_file")
    with open(path, "rb") as f:
        head = f.read(64)
        f.seek(0)
        data = f.read()
    kind = detect(head)[0] or "dfpwm"
    streamer = getattr(stream, kind)
    kw = {"device": device} if kind in _DEVICE_STREAMS else {}
    if kind == "dfpwm":
        it, _ = streamer(data, 48000, 1, **kw)
    else:
        it, _ = streamer(data, **kw)
    if not sinks:
        sinks = (NullSink(realtime=True),)
    play(it, *sinks, volume=volume)


from . import effects, stream  # noqa: E402
from .playback import play, player  # noqa: E402
