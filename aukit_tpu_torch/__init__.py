"""aukit_tpu_torch: the PyTorch/CUDA port of aukit-tpu.

The lane-batched decode engine (DFPWM, PCM, f32, G.711, IMA and MS ADPCM,
QOA -> 48 kHz int8, mono or per-channel windows, with per-lane filter, mono
and normalize stages), the batched FLAC fleet, the ``Fleet`` facade over both
(any container, with seek) and the batched encode engine (the write path: DFPWM and PCM 8/16/24/32,
device-to-device transcodes) on an NVIDIA GPU, with hand-written CUDA kernels
for Hopper. It mirrors the module paths and public
names of the JAX package ``aukit_tpu``, which stays the reference, and
imports neither ``jax`` nor ``aukit_tpu``.
"""

from __future__ import annotations

from .codecs.dfpwm import (DfpwmState, decode_dfpwm_bytes, dfpwm_decode, dfpwm_encode,
                           encode_dfpwm_bytes)
from .config import CONFIG
from .kernels import (dfpwm_decode_dsp_kernel, dfpwm_decode_kernel, dfpwm_encode_kernel,
                      iir_zero_kernel, ima_decode_kernel, lpc_restore_kernel,
                      msadpcm_decode_kernel, qoa_lms_kernel)
from .stream import (BatchDfpwmDecoder, BatchDfpwmEncoder, BatchEncodeEngine, BatchMetrics,
                     BatchStreamEngine, EncodeSpec, FlacFleet, Fleet, LaneSpec,
                     encode_windows_many, lane_spec_for_aiff,
                     lane_spec_for_au, lane_spec_for_qoa, lane_spec_for_wav, mdfpwm_to_lanes,
                     transcode_fleet)

__all__ = ["CONFIG", "DfpwmState", "dfpwm_decode", "dfpwm_encode", "decode_dfpwm_bytes",
           "encode_dfpwm_bytes", "dfpwm_decode_kernel", "dfpwm_decode_dsp_kernel",
           "dfpwm_encode_kernel", "BatchDfpwmEncoder", "BatchEncodeEngine", "EncodeSpec",
           "encode_windows_many", "transcode_fleet",
           "ima_decode_kernel", "msadpcm_decode_kernel", "qoa_lms_kernel",
           "lpc_restore_kernel", "iir_zero_kernel", "FlacFleet", "Fleet",
           "BatchStreamEngine", "BatchDfpwmDecoder", "BatchMetrics", "LaneSpec",
           "lane_spec_for_wav", "lane_spec_for_aiff", "lane_spec_for_au", "lane_spec_for_qoa",
           "mdfpwm_to_lanes"]
