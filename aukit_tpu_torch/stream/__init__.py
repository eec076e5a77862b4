"""The batched multi-stream engine, its container -> lane bridges, and the
batched FLAC fleet."""

from .batch import BatchDfpwmDecoder, BatchMetrics, BatchStreamEngine, LaneSpec
from .batch_codecs import (lane_spec_for_aiff, lane_spec_for_au, lane_spec_for_qoa,
                           lane_spec_for_wav, mdfpwm_to_lanes)
from .flac_fleet import FlacFleet

__all__ = ["BatchStreamEngine", "BatchDfpwmDecoder", "BatchMetrics", "LaneSpec",
           "lane_spec_for_wav", "lane_spec_for_aiff", "lane_spec_for_au", "lane_spec_for_qoa",
           "mdfpwm_to_lanes", "FlacFleet"]
