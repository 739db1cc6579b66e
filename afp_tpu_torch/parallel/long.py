"""Long-signal processing: the fused pipeline over a time-sharded mesh
(counterpart of `afp_tpu/parallel/long.py`).

The engine's linear chain collapses to one base-rate FIR, the fused
cascade, so filtering a long signal over D devices is
:func:`~afp_tpu_torch.parallel.halo.halo_convolve` with the cascade's
taps.  The nonlinear stages keep their structure:

* the AGC splits into its parallel and sequential parts: the moving RMS →
  desired gain → ``agc_link_group`` group-min is per-engine-block local
  math and runs per shard (K5 over the shard's blocks folded into its
  batch, chunk edges on block boundaries, so the per-block 'same' padding
  matches the streaming engine), then the attack/release recurrence runs
  in shard order, one K9 launch per engine block, from the previous
  block's clipped last gain (a [B] hand-off between shards).  Without
  ``agc_carry`` each block restarts, so each shard runs one K9 over all
  its blocks.  The gain is clipped to [0.1, max_gain] and applied, ±0.99.
  The recurrence is always the exact one ('fast' and 'parallel' modes
  included), as in the reference;
* dither is K2 over the gathered output under the key
  ``(dither_seed, 0)``, then the output clip (`long.py:171-180`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..engine.pipeline import DeviceParams, Pipeline
from ..ops.agc import link_desired
from ..ops.cuda.agc_rms import rms_desired
from ..ops.cuda.agc_scan import smooth_gain_scan
from ..ops.cuda.dither import dither_cuda
from .halo import _as_rows, convolve_placed, gather, place
from .mesh import Mesh

__all__ = ["filter_long_signal"]


def _agc_apply_long(pipe: Pipeline, params: DeviceParams, chunks) -> list:
    """The C8 AGC stage over placed chunks [S][D] (`long.py:41-127`):
    returns the gained chunks, each on its device."""
    cfg = pipe.cfg
    L = cfg.blocksize
    C = chunks[0][0].shape[-1]
    if C % L:
        raise ValueError(
            f"per-device chunk {C} must be a multiple of blocksize {L} for "
            "AGC (the engine's per-block RMS centering is part of the "
            "reference semantics)")
    if any(k.ndim for k in (params.agc_target, params.agc_max_gain,
                            params.agc_a_att, params.agc_a_rel)):
        raise ValueError("filter_long_signal takes scalar AGC knobs, not "
                         "per-stream [B] vectors")
    lp, rp = pipe._rms_pad
    a_att, a_rel = float(params.agc_a_att), float(params.agc_a_rel)
    mg = float(params.agc_max_gain)
    nb = C // L

    def desired(chunk: torch.Tensor) -> torch.Tensor:
        """[b, C] → the linked desired gain [b, nb, L] (K5 over the blocks
        folded into the batch)."""
        b = chunk.shape[0]
        d = rms_desired(chunk.reshape(b * nb, L), pipe._rms_band.to(chunk.device),
                        lp, rp, params.agc_target, params.agc_max_gain,
                        exact_band=pipe._rms_exact)
        return link_desired(d.reshape(b, C), cfg.agc_link_group
                            ).reshape(b, nb, L)

    ds = [[desired(c) for c in row] for row in chunks]
    gains = []
    for row in ds:
        if not cfg.agc_carry:
            # the reference's per-block restart: block-local, no hand-off
            gains.append([smooth_gain_scan(d.reshape(-1, L), a_att, a_rel,
                                           out_batch_major=True)
                          .reshape(d.shape[0], C) for d in row])
            continue
        # in shard order, per engine block: the streaming engine clips each
        # block's gain and carries the CLIPPED last value (`long.py:99-120`)
        carry = torch.ones(row[0].shape[0], dtype=torch.float32)
        out = []
        for d in row:
            carry = carry.to(d.device)
            gb = []
            for j in range(nb):
                g = torch.clamp(smooth_gain_scan(d[:, j], a_att, a_rel,
                                                 init=carry,
                                                 out_batch_major=True),
                                0.1, mg)
                carry = g[:, -1].contiguous()
                gb.append(g)
            out.append(torch.cat(gb, dim=-1))
        gains.append(out)
    return [[torch.clamp(c * torch.clamp(g, 0.1, mg), -0.99, 0.99)
             for c, g in zip(crow, grow)] for crow, grow in zip(chunks, gains)]


def _cascade_taps(pipe: Pipeline, params: DeviceParams) -> torch.Tensor:
    """The fused cascade's taps [n_casc], or per stream [B, n_casc]: the
    'td_mxu' taps, or from the spectrum when there are none
    (`long.py:155-163`)."""
    if params.casc_bank is not None:
        raise ValueError("filter_long_signal takes the shared cascade or "
                         "per-stream EQ gains; per-stream filter banks run "
                         "through the streaming Pipeline")
    if params.casc_main is None:
        # taps axis LAST: H may be per-stream [B, F]
        H = params.combined_response(pipe.has_eq, premultiplied=True)
        return torch.fft.irfft(H, n=pipe.nfft)[..., :pipe.n_casc]
    return params.combined_cascade(pipe.has_eq)


def filter_long_signal(pipe: Pipeline, params: DeviceParams, x, mesh: Mesh,
                       axis: str = "time",
                       dither_seed: Optional[int] = None) -> torch.Tensor:
    """Filter [T] or [B, T] through the fused cascade, time-sharded over
    `axis`; the result is on the mesh's first device.

    T must divide over the mesh axis and the per-device chunk must hold the
    cascade's halo (and whole engine blocks under AGC).  With dither off
    the output ≡ streaming the signal through `pipe` block by block, to the
    FFT-against-the-conv-kernel class.  On a 2-D ('streams' × 'time') mesh
    the rows also shard over 'streams' (per-stream taps with their rows;
    ``agc_link_group`` groups must be shard-local)."""
    if not pipe.fused:
        raise ValueError("long-signal mode requires fuse_rate_conversion=True")
    x, squeeze = _as_rows(x)
    k = _cascade_taps(pipe, params)
    cfg = pipe.cfg
    grid, chunks, rows = place(
        x, mesh, axis, pipe.n_casc - 1,
        group=cfg.agc_link_group if cfg.agc_enabled else 1)
    if cfg.agc_enabled:
        chunks = _agc_apply_long(pipe, params, chunks)
    y = gather(convolve_placed(grid, chunks, rows, k))
    if cfg.dither_kind != "off" and dither_seed is not None:
        y = dither_cuda(y, (int(dither_seed), 0), cfg.dither_bits,
                        cfg.dither_kind)
    if cfg.output_clip is not None:
        y = torch.clamp(y, -cfg.output_clip, cfg.output_clip)
    return y[0] if squeeze else y
