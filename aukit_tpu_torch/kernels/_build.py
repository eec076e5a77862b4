"""Build and load the hand-written CUDA kernels (``aukit_tpu_torch/csrc``).

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into one shared library with a plain C interface
under ``aukit_tpu_torch/_build/``, loaded with ``ctypes``. The library's file
name carries a hash of the sources (headers included) and the flags, so an
edited source is rebuilt on its next use. Nothing here runs at import: the
CPU-only environment that runs the tests has no ``nvcc``.

``--fmad=false`` is part of the contract: the float code is compared bit for
bit with the JAX engine's, which fuses exactly the multiply-adds the kernels
write as ``__fmaf_rn``; any other ``a*b+c`` that nvcc contracted would flip
int8 outputs. The float64 FLAC DSP (``csrc/flac_dsp.cu``) is compared bit for
bit with the numpy host route, which fuses nothing. Never add
``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# entry point -> argtypes; pointers and the stream are c_void_p
_SIGNATURES = {
    "aukit_dfpwm_decode": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P),
    "aukit_dfpwm_decode_dsp": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_float, _P, _P, _P, _P),
    "aukit_dfpwm_encode": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P),
    "aukit_ima_decode": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P),
    "aukit_msadpcm_decode": (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P),
    "aukit_qoa_lms": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P),
    "aukit_fma": (_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P),
    "aukit_lpc_restore": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _LL, ctypes.c_int, _P),
    "aukit_lpc_restore_wide": (_P, _P, _P, _P, _P, _P, ctypes.c_int, _LL, ctypes.c_int, _P),
    "aukit_iir_zero": (_P, _P, ctypes.c_int, _LL, ctypes.c_float, ctypes.c_float, _P),
    "aukit_flac_dsp_f64": (_P, _P, _P, _P, _P, _P, *(ctypes.c_int,) * 9, ctypes.c_double, _P),
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from aukit_tpu_torch/csrc at first use")
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*SRC_DIR.glob("*.cu"), *SRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaukit_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load() -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernel library."""
    so = _library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = []
        for src in sorted(SRC_DIR.glob("*.cu")):
            obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for cmd, _obj, proc in jobs:
            out, err = proc.communicate()
            log.append(f"{' '.join(cmd)}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err}")
        try:
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _c, obj, _p in jobs)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            log.append(f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
        finally:
            for _c, obj, _p in jobs:
                obj.unlink(missing_ok=True)
        for old in BUILD_DIR.glob("libaukit_kernels_*.so"):
            old.unlink()
        os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
        (BUILD_DIR / "build.log").write_text(
            f"{time.perf_counter() - t0:.3f} s\n" + "\n".join(log))
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.aukit_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.aukit_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (its cudaGetLastError)."""
    if rc != 0:
        msg = load().aukit_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
