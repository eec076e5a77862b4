"""Hand-written CUDA kernels (sources in ``csrc/``) and their plain versions."""

from . import adpcm_cuda, dfpwm_cuda, flac_cuda, flac_dsp_cuda, fma_cuda, iir_cuda, qoa_cuda
from .adpcm_cuda import (ima_decode_kernel, ima_decode_ref, msadpcm_decode_kernel,
                         msadpcm_decode_ref)
from .dfpwm_cuda import (dfpwm_decode_dsp_kernel, dfpwm_decode_dsp_ref, dfpwm_decode_kernel,
                         dfpwm_decode_ref, dfpwm_encode_kernel, dfpwm_encode_ref)
from .flac_cuda import lpc_restore_kernel, lpc_restore_ref
from .flac_dsp_cuda import flac_dsp_kernel, flac_dsp_ref
from .fma_cuda import fma_kernel, fma_ref
from .iir_cuda import iir_zero_kernel, iir_zero_ref
from .qoa_cuda import qoa_lms_kernel, qoa_lms_ref

MODULES = (dfpwm_cuda, adpcm_cuda, qoa_cuda, fma_cuda, flac_cuda, iir_cuda, flac_dsp_cuda)
KERNELS = tuple(k for m in MODULES for k in m.KERNELS)
PLAIN = tuple(p for m in MODULES for p in m.PLAIN)

__all__ = ["dfpwm_decode_kernel", "dfpwm_decode_dsp_kernel", "dfpwm_decode_ref",
           "dfpwm_decode_dsp_ref", "dfpwm_encode_kernel", "dfpwm_encode_ref",
           "ima_decode_kernel", "ima_decode_ref",
           "msadpcm_decode_kernel", "msadpcm_decode_ref", "qoa_lms_kernel", "qoa_lms_ref",
           "fma_kernel", "fma_ref", "lpc_restore_kernel", "lpc_restore_ref",
           "iir_zero_kernel", "iir_zero_ref", "flac_dsp_kernel", "flac_dsp_ref",
           "KERNELS", "PLAIN", "reset_counts"]


def reset_counts() -> None:
    """Zero every kernel's launch count and every plain version's call count."""
    for fn in KERNELS:
        fn.launches = 0
        if hasattr(fn, "wide_launches"):
            fn.wide_launches = 0
    for fn in PLAIN:
        fn.calls = 0
