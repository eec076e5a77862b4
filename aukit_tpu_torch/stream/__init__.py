"""The batched multi-stream decode engine, its container -> lane bridges, the
batched FLAC fleet, the ``Fleet`` facade over both, and the batched encode
engine (the write path)."""

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
