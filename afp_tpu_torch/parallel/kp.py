"""Kernel (tensor) parallelism: one very long FIR sharded over the mesh
(counterpart of `afp_tpu/parallel/kp.py`).

A long-kernel convolution decomposes exactly over the tap axis::

    h = Σ_d shift(h_d, d·C),   h_d = h[d·C : (d+1)·C]
    ⇒ y[t] = Σ_d z_d[t − d·C],  z_d = x ⊛ h_d

so each shard convolves the same input stream against its own C-tap chunk
(overlap-save over ``next_pow2(L + C − 1)`` points, D× shorter than the
full kernel's: ``torch.fft``, cuFFT on a card), delays its partial stream
by d·C samples through a carried FIFO, and one sum per block
(`collectives.psum`, in shard order) reassembles the exact full-kernel
output.  The streamed output ≡ a zero-primed full-kernel
:class:`~afp_tpu_torch.ops.convolve.OverlapSave`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.convolve import next_pow2
from .collectives import psum
from .mesh import Mesh

__all__ = ["KernelParallelConv", "KPState"]


class KPState(NamedTuple):
    tail: tuple  # per shard [B, C-1] overlap-save input history
    delay: tuple  # per shard [B, (D-1)·C] output-delay FIFO


class KernelParallelConv:
    """Streaming FIR convolution with the kernel sharded over a mesh axis.

    Usage::

        mesh = make_mesh(8, axis_names=("kernel",), devices=["cuda:0"] * 8)
        kp = KernelParallelConv(h, block=4096, mesh=mesh, batch=16)
        state = kp.init_state()
        state, y = kp.step(state, x_block)     # y == full-kernel conv

    The output is on the mesh's first device.
    """

    def __init__(self, h: np.ndarray, block: int, mesh: Mesh,
                 axis: str = "kernel", batch: int = 1):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}")
        self.devices = mesh.along(axis)
        D = len(self.devices)
        h = np.asarray(h, dtype=np.float64)
        self.mesh = mesh
        self.axis = axis
        self.D = D
        self.N = len(h)
        self.C = max(-(-self.N // D), 2)  # keep per-device tails non-empty
        self.block = int(block)
        self.batch = int(batch)
        self.nfft = next_pow2(self.block + self.C - 1)
        self.maxdelay = (D - 1) * self.C
        self._H = self._spectra(h)

    def _spectra(self, h: np.ndarray) -> tuple:
        """Each shard's chunk spectrum [F] on its device."""
        chunks = np.zeros(self.D * self.C)
        chunks[: len(h)] = h
        chunks = chunks.reshape(self.D, self.C).astype(np.float32)
        return tuple(torch.fft.rfft(torch.as_tensor(c, device=dev), n=self.nfft)
                     for c, dev in zip(chunks, self.devices))

    def init_state(self) -> KPState:
        def z(n):
            return tuple(torch.zeros((self.batch, n), dtype=torch.float32,
                                     device=dev) for dev in self.devices)
        return KPState(tail=z(self.C - 1), delay=z(self.maxdelay))

    def step(self, state: KPState, block):
        """[B, L] in → (state, [B, L] out): the zero-primed valid-mode
        streaming convolution of the FULL kernel."""
        x = torch.as_tensor(block, dtype=torch.float32)
        C, L, M = self.C, self.block, self.maxdelay
        tails, delays, parts = [], [], []
        for d, dev in enumerate(self.devices):
            ext = torch.cat([state.tail[d], x.to(dev)], dim=-1)  # [B, C-1+L]
            z = torch.fft.irfft(torch.fft.rfft(ext, n=self.nfft) * self._H[d],
                                n=self.nfft)[..., C - 1:C - 1 + L]
            buf = torch.cat([state.delay[d], z], dim=-1)  # [B, M+L]
            start = M - d * C
            parts.append(buf[..., start:start + L])
            tails.append(ext[..., ext.shape[-1] - (C - 1):].clone())
            delays.append(buf[..., buf.shape[-1] - M:].clone())
        y = psum(parts, self.devices[0])
        return KPState(tail=tuple(tails), delay=tuple(delays)), y

    def with_kernel(self, h: np.ndarray) -> "KernelParallelConv":
        """Glitch-free kernel swap (the same length class, the same
        shapes)."""
        h = np.asarray(h, dtype=np.float64)
        if -(-len(h) // self.D) > self.C:
            raise ValueError("new kernel is longer than the sharded layout")
        new = object.__new__(KernelParallelConv)
        new.__dict__ = dict(self.__dict__)
        new._H = self._spectra(h)
        return new
