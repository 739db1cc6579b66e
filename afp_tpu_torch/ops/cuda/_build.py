"""Build and load the port's CUDA kernels (the counterpart of
`native/Makefile` for the host ring).

`csrc/*.cu` compile with nvcc into one shared library with a plain C
interface, loaded with ctypes::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/afp_tpu_torch/libafp_<hash>.so csrc/*.cu

The library is built at first use into ``build/afp_tpu_torch/`` at the root of
the checkout, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads in milliseconds.  Nothing here runs at
import time, and a build failure raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "afp_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_float, ctypes.c_longlong)
_EPI = (_I, _F, _I, _U, _U, _F)  # has_clip, clip, dither, seed, counter, lsb
#: C entry points and their ctypes signatures (csrc/*.cu); every function
#: returns the cudaError_t of its launch
_SIGNATURES = {
    "afp_fir_td": (_P, _P, _P, _I, _I, _I, *_EPI, _P),
    "afp_fir_td_ring": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *_EPI, _P),
    "afp_fir_td_ring_mega": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             *_EPI, _P),
    "afp_dither": (_P, _P, _LL, _I, _U, _U, _F, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the afp_tpu_torch CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libafp_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the hashed library is missing; return its
    path.  Raises RuntimeError with nvcc's output when the build fails."""
    out = _library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
