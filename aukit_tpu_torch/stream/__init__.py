"""The batched multi-stream decode engine, its container -> lane bridges, the
batched FLAC fleet, the ``Fleet`` facade over both, and the batched encode
engine (the write path). The JAX package's single-stream iterators
(``aukit_tpu.stream.pcm``, ``.wav``, ...) are not ported yet: reading one
raises ``NotImplementedError``."""

from .batch import BatchDfpwmDecoder, BatchMetrics, BatchStreamEngine, LaneSpec
from .batch_codecs import (lane_spec_for_aiff, lane_spec_for_au, lane_spec_for_qoa,
                           lane_spec_for_wav, mdfpwm_to_lanes)
from .batch_encode import (ENCODE_CODECS, BatchDfpwmEncoder, BatchEncodeEngine, EncodeSpec,
                           encode_windows_many, transcode_fleet)
from .flac_fleet import FlacFleet
from .fleet import Fleet

__all__ = ["BatchStreamEngine", "BatchDfpwmDecoder", "BatchMetrics", "LaneSpec",
           "lane_spec_for_wav", "lane_spec_for_aiff", "lane_spec_for_au", "lane_spec_for_qoa",
           "mdfpwm_to_lanes", "FlacFleet", "Fleet", "BatchDfpwmEncoder", "BatchEncodeEngine",
           "EncodeSpec", "ENCODE_CODECS", "encode_windows_many", "transcode_fleet"]

# the JAX package's chunked single-stream iterators (aukit_tpu/stream/__init__.py)
_SINGLE_STREAM = ("ChunkIterator", "ChunkResampler", "pcm", "dfpwm", "g711", "adpcm", "msadpcm",
                  "mdfpwm", "wav", "aiff", "au", "flac", "qoa")


def __getattr__(name: str):
    if name in _SINGLE_STREAM:
        raise NotImplementedError(
            f"aukit_tpu_torch.stream.{name}: the single-stream iterators are not ported yet "
            "(ROADMAP queue 1 item 6, the single-stream surface and the CLIs)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
