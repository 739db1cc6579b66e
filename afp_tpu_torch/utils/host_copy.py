"""The native staging copy: a host block's bytes into pinned memory, over a
pool of threads, with streaming stores (``csrc/host_copy.cpp``, built with
g++ on first use into ``build/afp_tpu_torch/``, loaded with ctypes: the
copy runs without the GIL).

One pool serves the process, made at its first copy and kept to its end: a
copy takes one thread a CPU of the process's affinity mask, the caller
included, up to :data:`MAX_THREADS`.
"""
from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import torch

from .native import build_library

__all__ = ["MAX_THREADS", "Copier", "copier", "copy_into"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_copy.cpp"
#: baseline x86-64 (SSE2), no -march flag
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
#: the most threads a copy takes, the caller's included: where the copy
#: rate stops rising on the card's host (PERF.md §5: 64 MiB at 13.6, 23.1,
#: 28.8, 32.5 and 32.9 GiB/s over 2, 4, 6, 7 and 8 threads)
MAX_THREADS = 8

_lib = None
_pool = None
_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(SOURCE, CXX_FLAGS,
                                            "libafp_copy")))
        lib.afp_copier_create.restype = ctypes.c_void_p
        lib.afp_copier_create.argtypes = [ctypes.c_int]
        lib.afp_copier_destroy.restype = None
        lib.afp_copier_destroy.argtypes = [ctypes.c_void_p]
        lib.afp_copy.restype = ctypes.c_int
        lib.afp_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_uint64]
        _lib = lib
    return _lib


class Copier:
    """A pool of ``threads - 1`` parked worker threads: a copy through it
    takes `threads` threads, the caller's included."""

    def __init__(self, threads: int):
        self._lib = _library()
        self.threads = max(int(threads), 1)
        self._h = self._lib.afp_copier_create(self.threads - 1)
        if not self._h:
            raise RuntimeError("the copy's worker threads could not start")

    def copy(self, dst: int, src: int, nbytes: int) -> int:
        """Copy `nbytes` from address `src` to address `dst` (ranges that
        do not overlap); returns the threads used."""
        return self._lib.afp_copy(self._h, dst, src, nbytes)

    def close(self) -> None:
        """Stop and join the workers."""
        if self._h:
            self._lib.afp_copier_destroy(self._h)
            self._h = None


def copier() -> Copier:
    """The process's pool, made at first call."""
    global _pool
    with _lock:
        if _pool is None:
            _pool = Copier(min(len(os.sched_getaffinity(0)), MAX_THREADS))
        return _pool


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> int:
    """Copy the host tensor `src` into the host tensor `dst` byte for byte
    with the native copy, over the process's pool; returns the threads
    used.  Both must be contiguous with the same number of bytes (a
    non-contiguous tensor is refused: stage it with ``dst.copy_(src)``)."""
    if dst.device.type != "cpu" or src.device.type != "cpu":
        raise ValueError("copy_into copies between host tensors")
    if not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError("copy_into needs contiguous tensors")
    n = src.nbytes
    if dst.nbytes != n:
        raise ValueError(f"copy_into: {dst.nbytes} bytes into {n}")
    if n == 0:
        return 1
    return copier().copy(dst.data_ptr(), src.data_ptr(), n)
