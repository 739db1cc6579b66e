"""ctypes bindings for the native host runtime (counterpart of
`afp_tpu/runtime/host.py`, over the repo's own ``native/host_ring.cpp``).

Provides :class:`BlockRing` — a bounded block queue with the reference's
backpressure semantics (put_nowait + drop-on-full, timeout'd blocking gets;
`stream_process_AGC.py:111-115, 198-199`) — and :class:`Pacer`, a
monotonic-clock block ticker standing in for the sound card's DMA interrupt
(the simulated-clock stream driver, SURVEY.md §5.3/§6).

The shared library is built on first use with g++, with the flags of
``native/Makefile``, into ``build/afp_tpu_torch/`` at the root of the
checkout, keyed by a hash of the source and flags (an edited source
rebuilds).  The source is only read: nothing is written under ``native/``.
No pybind11; a pure C ABI.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["BlockRing", "Pacer", "load_library", "native_available"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "host_ring.cpp"
BUILD_DIR = _ROOT / "build" / "afp_tpu_torch"
#: `native/Makefile`'s CXXFLAGS, its -shared link and -lpthread
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_lib = None
_lib_lock = threading.Lock()


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libafp_host_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/host_ring.cpp`` if its hashed library is missing;
    return the library's path.  Raises RuntimeError with the compiler's
    diagnostics when the build fails."""
    out = _library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        lib = Path(tmpdir) / out.name
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE),
                            "-lpthread"], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(
                f"native build failed (exit {r.returncode}):\n{r.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or none
    return out


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the native library; thread-safe, cached."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        # signatures
        lib.afp_ring_create.restype = ctypes.c_void_p
        lib.afp_ring_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.afp_ring_destroy.argtypes = [ctypes.c_void_p]
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.afp_ring_push.restype = ctypes.c_int
        lib.afp_ring_push.argtypes = [ctypes.c_void_p, fptr]
        lib.afp_ring_pop.restype = ctypes.c_int
        lib.afp_ring_pop.argtypes = [ctypes.c_void_p, fptr]
        lib.afp_ring_push_blocking.restype = ctypes.c_int
        lib.afp_ring_push_blocking.argtypes = [ctypes.c_void_p, fptr, ctypes.c_double]
        lib.afp_ring_pop_blocking.restype = ctypes.c_int
        lib.afp_ring_pop_blocking.argtypes = [ctypes.c_void_p, fptr, ctypes.c_double]
        lib.afp_ring_size.restype = ctypes.c_uint64
        lib.afp_ring_size.argtypes = [ctypes.c_void_p]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.afp_ring_stats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p, u64p]
        lib.afp_pacer_create.restype = ctypes.c_void_p
        lib.afp_pacer_create.argtypes = [ctypes.c_double]
        lib.afp_pacer_destroy.argtypes = [ctypes.c_void_p]
        lib.afp_pacer_wait.restype = ctypes.c_int
        lib.afp_pacer_wait.argtypes = [ctypes.c_void_p]
        lib.afp_pacer_ticks.restype = ctypes.c_uint64
        lib.afp_pacer_ticks.argtypes = [ctypes.c_void_p]
        lib.afp_pacer_overruns.restype = ctypes.c_uint64
        lib.afp_pacer_overruns.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_library()
        return True
    except Exception:
        return False


def _as_float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class BlockRing:
    """Bounded queue of fixed-size blocks (native-backed).

    `capacity` mirrors the reference's ``queue.Queue(maxsize=20)``
    (`stream_process_EQ_GUI.py:47-48`).  The native ring moves raw bytes
    (in float-sized units); `dtype` selects the block element type —
    float32 (default, the reference's callback format) or int16
    (``ingest='pcm16'`` engines: blocks ride the ring as bit views, half
    the queue memory and copy bytes per block, zero conversion).
    """

    def __init__(self, capacity: int = 20, block_shape: Tuple[int, ...] = (2048,),
                 dtype=np.float32):
        self._lib = load_library()
        self.block_shape = tuple(int(s) for s in block_shape)
        self.dtype = np.dtype(dtype)
        if capacity <= 0 or any(s <= 0 for s in self.block_shape):
            # negative values would wrap through the C ABI's uint64 and
            # make vector::resize throw across extern-C → std::terminate
            # (SIGABRT), not a Python exception
            raise ValueError(
                f"capacity and block_shape must be positive, got "
                f"{capacity} / {self.block_shape}")
        nbytes = int(np.prod(self.block_shape)) * self.dtype.itemsize
        if nbytes % 4:
            raise ValueError(
                f"block byte size {nbytes} must be float-aligned (multiple "
                f"of 4) to ride the native ring")
        self.block_floats = nbytes // 4
        self._h = self._lib.afp_ring_create(capacity, self.block_floats)
        if not self._h:
            raise RuntimeError("failed to create native ring")
        self.capacity = capacity

    def push(self, block: np.ndarray, timeout: Optional[float] = 0.0) -> bool:
        """timeout=0 → nowait (drop on full, returns False); timeout=None →
        wait forever; else seconds."""
        block = np.asarray(block)
        if self.dtype != np.float32 and block.dtype != self.dtype:
            # int rings never coerce: an f32→int16 cast would silently
            # quantize (the same contract as StreamEngine._coerce_in)
            raise ValueError(
                f"this ring carries {self.dtype} blocks, got {block.dtype}")
        b = np.ascontiguousarray(block, dtype=self.dtype)
        if b.size != int(np.prod(self.block_shape)):
            raise ValueError(
                f"block must have {int(np.prod(self.block_shape))} elements")
        b = b.reshape(-1).view(np.float32)  # bit view, no conversion
        if timeout == 0.0:
            return self._lib.afp_ring_push(self._h, _as_float_ptr(b)) == 0
        t = -1.0 if timeout is None else timeout * 1000.0
        return self._lib.afp_ring_push_blocking(self._h, _as_float_ptr(b), t) == 0

    def pop(self, timeout: Optional[float] = 0.0) -> Optional[np.ndarray]:
        """Returns a block or None on empty/timeout."""
        out = np.empty(self.block_floats, dtype=np.float32)
        if timeout == 0.0:
            ok = self._lib.afp_ring_pop(self._h, _as_float_ptr(out)) == 0
        else:
            t = -1.0 if timeout is None else timeout * 1000.0
            ok = self._lib.afp_ring_pop_blocking(self._h, _as_float_ptr(out), t) == 0
        return out.view(self.dtype).reshape(self.block_shape) if ok else None

    def __len__(self) -> int:
        return int(self._lib.afp_ring_size(self._h))

    @property
    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.afp_ring_stats(self._h, *[ctypes.byref(v) for v in vals])
        return dict(zip(("pushes", "pops", "drops", "underruns"),
                        (v.value for v in vals)))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.afp_ring_destroy(h)
            self._h = None


class Pacer:
    """Monotonic block-rate ticker (simulated sound-card clock)."""

    def __init__(self, period_seconds: float):
        self._lib = load_library()
        self._h = self._lib.afp_pacer_create(float(period_seconds))
        if not self._h:  # the C side rejects non-positive/sub-ns periods
            raise ValueError(
                f"pacer period must be >= 1 ns, got {period_seconds}s")

    def wait(self) -> int:
        """Sleep to the next block boundary; returns missed-tick count."""
        return int(self._lib.afp_pacer_wait(self._h))

    @property
    def ticks(self) -> int:
        return int(self._lib.afp_pacer_ticks(self._h))

    @property
    def overruns(self) -> int:
        return int(self._lib.afp_pacer_overruns(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.afp_pacer_destroy(h)
            self._h = None
