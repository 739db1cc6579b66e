"""Build and load the port's CUDA kernels (the counterpart of
`native/Makefile` for the host ring).

`csrc/*.cu` compile with nvcc into one shared library with a plain C
interface, loaded with ctypes: one nvcc per source, all started together,
then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <obj> csrc/<name>.cu          # each, in parallel
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/afp_tpu_torch/libafp_<hash>.so <objs>

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

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: compile flags of each source: IEEE division and square root, no fast
#: math; ptxas reports each kernel's registers and spills into the build log
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_float, ctypes.c_longlong)
_EPI = (_I, _F, _I, _U, _U, _F)  # has_clip, clip, dither, seed, counter, lsb
#: C entry points and their ctypes signatures (csrc/*.cu); every function
#: returns the cudaError_t of its launch
_SIGNATURES = {
    "afp_fir_td": (_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, *_EPI, _I, _P),
    "afp_fir_td_ring": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P, _I, _I, *_EPI, _I, _P),
    "afp_fir_td_ps": (_P, _P, _P, _P, _I, _I, _I, _I, _I, *_EPI, _I, _P),
    "afp_fir_td_ps_pair": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, *_EPI, _I, _P, _U, _P),
    "afp_conv_geometry": (_I, _I, _P),
    "afp_dither": (_P, _P, _LL, _I, _U, _U, _F, _P),
    "afp_fir_td_pair": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, *_EPI, _I, _P, _U, _P),
    "afp_rms_desired": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                        _F, _F, _P, _P, _P),
    "afp_agc_apply": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                      _F, _F, _P, _P, _P, _P),
    "afp_agc_scan": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    "afp_agc_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                      _F, _P),
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


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently and return their outputs; raise with
    the output of the first that fails.  Every process is waited for, or
    killed on the way out."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    try:
        outs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> Path:
    """Compile the kernels if the hashed library is missing; return its
    path.  Raises RuntimeError with nvcc's output when the build fails."""
    out = _library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in _sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(_sources(), objs)])
        lib = Path(tmpdir) / out.name
        _run_all([[nvcc, *_ARCH, "-shared", "-o", str(lib), *map(str, objs)]])
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, out)  # atomic: a concurrent loader sees all or none
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
