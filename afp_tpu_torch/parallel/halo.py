"""Time-axis context parallelism via halo exchange (counterpart of
`afp_tpu/parallel/halo.py`).

To filter one long signal over D devices, shard its time axis: each shard
needs only the ``N−1`` samples to its left (the FIR's receptive field),
one right-neighbour push (`collectives.shift_right`) per pass.  The first
shard receives zeros, which is exactly the zero-primed causal convolution
the streaming engine defines.  Each shard then convolves its chunk behind
that halo in valid mode, one ``torch.fft`` round trip over
``next_pow2(N−1 + C + N−1)`` points (`halo.py:25-33`; cuFFT on a card).

On a 2-D ('streams' × 'time') mesh the batch rows also shard over
'streams' (a mono signal replicates its row); the halo push stays inside
each streams row.  Outputs are gathered on the mesh's first device.
"""
from __future__ import annotations

import torch

from ..ops.convolve import next_pow2
from .collectives import shift_right
from .mesh import Mesh

__all__ = ["batch_axis_of", "halo_convolve", "halo_convolve_sharded"]


def _local_causal_conv(ext: torch.Tensor, h: torch.Tensor,
                       n_out: int) -> torch.Tensor:
    """Valid-mode FFT conv of [.., N-1+n_out] against h[N] (or [.., N]) →
    [.., n_out], a copy (it does not pin the FFT buffer)."""
    N = h.shape[-1]
    nfft = next_pow2(ext.shape[-1] + N - 1)
    Y = torch.fft.rfft(ext, n=nfft) * torch.fft.rfft(h, n=nfft)
    return torch.fft.irfft(Y, n=nfft)[..., N - 1:N - 1 + n_out].clone()


def batch_axis_of(mesh: Mesh, time_axis: str):
    """The mesh's stream-DP axis name on a 2-D (streams × time) mesh, or
    None on a pure time mesh: batch rows are independent, so sharding them
    beside the halo exchange adds no collective."""
    return ("streams" if "streams" in mesh.axis_names
            and time_axis != "streams" else None)


def _as_rows(x) -> tuple:
    """`x` as a float32 [B, T] tensor (on its own device), and whether it
    was [T]."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return (x[None], True) if x.ndim == 1 else (x, False)


def place(x: torch.Tensor, mesh: Mesh, axis: str, n_halo: int = 0,
          group: int = 1) -> tuple:
    """The time-sharded layout of [B, T] `x`: (the device grid [S][D], the
    chunks [S][D] on their devices, the row ranges [S]).  S is the
    'streams' axis's size on a 2-D mesh (1 on a time mesh, or for a mono
    row, which replicates); each shard holds whole ``group`` row groups.
    The reference's errors: T must divide over D, the per-device chunk
    must hold the ``n_halo`` halo, the batch must divide over S."""
    D = mesh.shape[axis]
    B, T = x.shape
    if T % D:
        raise ValueError(f"signal length {T} must divide over {D} devices")
    C = T // D
    if C < n_halo:
        raise ValueError("per-device chunk shorter than the filter halo")
    bax = batch_axis_of(mesh, axis)
    if bax and B == 1:
        bax = None  # a mono signal on a 2-D mesh: replicate the row
    S = mesh.shape[bax] if bax else 1
    if bax and (B % S or (B // S) % group):
        if group > 1:
            raise ValueError(
                f"batch {B} must divide over the {S}-way '{bax}' axis in "
                f"whole agc_link_group={group} groups (groups are "
                "shard-local, like ShardedPipeline)")
        raise ValueError(
            f"batch {B} must divide over the {S}-way '{bax}' axis")
    flat = mesh.along(bax, axis) if bax else mesh.along(axis)
    grid = [flat[s * D:(s + 1) * D] for s in range(S)]
    b = B // S
    rows = [(s * b, (s + 1) * b) for s in range(S)]
    chunks = [[x[r0:r1, d * C:(d + 1) * C].to(dev)
               for d, dev in enumerate(grid[s])]
              for s, (r0, r1) in enumerate(rows)]
    return grid, chunks, rows


def convolve_placed(grid, chunks, rows, h: torch.Tensor) -> list:
    """The halo convolution of placed chunks (:func:`place`) against `h`
    ([N] shared or [B, N] per-stream): one neighbour push per streams row,
    then each shard's local valid-mode conv.  Returns the output chunks
    [S][D] on their devices."""
    N = h.shape[-1]
    out = []
    for devs, row, (r0, r1) in zip(grid, chunks, rows):
        hs = h[r0:r1] if h.ndim == 2 else h
        tails = [c[:, c.shape[-1] - (N - 1):] for c in row]
        halos = shift_right(tails, devs)
        out.append([_local_causal_conv(torch.cat([lh, c], dim=-1), hs.to(dev),
                                       c.shape[-1])
                    for lh, c, dev in zip(halos, row, devs)])
    return out


def gather(chunks) -> torch.Tensor:
    """Placed [S][D] chunks as one [B, T] tensor on the first device."""
    home = chunks[0][0].device
    return torch.cat([torch.cat([c.to(home) for c in row], dim=-1)
                      for row in chunks], dim=0)


def halo_convolve(x, h, mesh: Mesh, axis: str = "time") -> torch.Tensor:
    """Causal FIR convolution of a long signal sharded over `axis`.

    `x`: [T] or [B, T] (numpy or a tensor) with T divisible by the mesh
    axis's size; `h`: [N] (shared) or [B, N] (per-stream kernels).  Output
    (on the mesh's first device) ≡ ``convolve(zero-primed x, h, 'valid')``,
    the streaming engine's overlap-save output, computed as one sharded
    pass with one neighbour push."""
    x, squeeze = _as_rows(x)
    h = torch.as_tensor(h, dtype=torch.float32)
    out = gather(convolve_placed(*place(x, mesh, axis, h.shape[-1] - 1), h))
    return out[0] if squeeze else out


def halo_convolve_sharded(x, h, mesh: Mesh, axis: str = "time") -> torch.Tensor:
    """:func:`halo_convolve` for a signal to be placed on the mesh first.
    The port's halo_convolve places each chunk on its device itself, with
    the layout the reference's ``halo_convolve_sharded`` pre-places with
    (a mono or indivisible batch is not sharded over 'streams'), so the two
    are one computation."""
    return halo_convolve(x, h, mesh, axis)
