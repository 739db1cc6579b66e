"""Per-stream parameter banks (counterpart of `afp_tpu/engine/batch.py`).

A batch of thousands of streams can be mixed-tenant: each stream carries
its own EQ gain vector, its own main filter, or its own AGC policy, through
the same kernels and with no rebuild.

* **EQ gains** (:func:`with_per_stream_gains`): ``eq_gains`` becomes
  [B, n_bands].  The 'fft' strategy contracts it into a [B, F] response;
  'td_mxu' runs K11 (`fir_td_mxu_per_stream`), every band's conv mixed per
  stream, n_bands× the shared conv's work.
* **Main filters** (:func:`with_per_stream_filters`): one design per
  stream from dynamic overrides.  'fft' carries a [B, F] ``H_main`` bank;
  'td_mxu' deduplicates the designs into ``casc_bank`` [D, n_casc] and a
  per-tile assignment ``casc_assign`` [B / bt] that K10 and the banked ring
  forms of K3, K4 and K12 read (selection is addressing).  Streams that
  share a design must fill whole tiles; ``pack=True`` sorts an arbitrary
  ordering into tile order and returns the :class:`StreamPacking`.
* **AGC policies** (:func:`with_per_stream_agc`): any of the AGC knobs as
  a [B] vector on the device, read by K5 and K6 per stream.

Per-stream AGC vectors stay in caller order, as in the reference:
``StreamPacking.pack``/``unpack`` move the data, not the params, so with a
packing the vectors are given in device order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.agc import agc_alphas
from ..ops.cuda.fir_td import ring_k_pad
from .config import PipelineParams
from .pipeline import DeviceParams, Pipeline, _host_scalar

__all__ = ["with_per_stream_gains", "with_per_stream_filters",
           "with_per_stream_agc", "broadcast_gains", "StreamPacking"]


def with_per_stream_agc(pipe: Pipeline, params: DeviceParams,
                        target_level=None, max_gain=None,
                        attack=None, release=None) -> DeviceParams:
    """Per-stream AGC policy banks: promote any of the batch-global AGC
    knobs to a [batch] vector (`afp_tpu/engine/batch.py:33-97`).

    `target_level` / `max_gain`: scalars or [batch] vectors, stored as
    given.  `attack` / `release`: per-stream time constants, converted to
    alphas with the reference's rule (:func:`~afp_tpu_torch.ops.agc.agc_alphas`
    at the static ``agc_window_size``).  Omitted knobs keep their value.
    Vectors live on the pipeline's device; scalars stay 0-d host tensors.
    Linked streams (``agc_link_group``) should share a policy."""
    cfg = pipe.cfg
    if not cfg.agc_enabled:
        raise ValueError("with_per_stream_agc requires agc_enabled=True")
    B = pipe.batch

    def vec(v, name):
        a = np.asarray(v, dtype=np.float32)
        if a.ndim == 0:
            return _host_scalar(a)
        if a.shape != (B,):
            raise ValueError(f"{name} must be a scalar or [{B}] vector, "
                             f"got shape {a.shape}")
        return torch.as_tensor(a, device=pipe.device)

    upd = {}
    if target_level is not None:
        upd["agc_target"] = vec(target_level, "target_level")
    if max_gain is not None:
        upd["agc_max_gain"] = vec(max_gain, "max_gain")
    for name, times, field in (("attack", attack, "agc_a_att"),
                               ("release", release, "agc_a_rel")):
        if times is None:
            continue
        t = np.asarray(times, dtype=np.float64)
        pick = 0 if name == "attack" else 1
        if t.ndim == 0:
            upd[field] = vec(agc_alphas(cfg.agc_window_size, float(t),
                                        float(t))[pick], name)
            continue
        if t.shape != (B,):
            raise ValueError(f"{name} must be a scalar or [{B}] vector, "
                             f"got shape {t.shape}")
        upd[field] = vec([agc_alphas(cfg.agc_window_size, float(v),
                                     float(v))[pick] for v in t], name)
    return params._replace(**upd)


@dataclasses.dataclass(frozen=True)
class StreamPacking:
    """Stream→tile design packing for banked per-stream filters
    (`afp_tpu/engine/batch.py:100-141`): the permutation that sorts the
    caller's streams into tile-compatible device order, and its inverse.

    * ``pack(x)``: caller order → device order (at ingest);
    * ``unpack(y)``: device order → caller order (on drain).

    ``perm[p] = c``: device row ``p`` processes caller stream ``c``.  Works
    on numpy arrays and torch tensors along any axis; on a tensor it is an
    ``index_select`` with the index cached on the tensor's device."""

    perm: np.ndarray  # device_row -> caller_row
    inv: np.ndarray  # caller_row -> device_row
    _index: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def identity(self) -> bool:
        return bool(np.array_equal(self.perm, np.arange(len(self.perm))))

    def index(self, which: str, device) -> torch.Tensor:
        """``perm`` or ``inv`` as an int64 tensor on `device` (cached)."""
        key = (which, torch.device(device))
        if key not in self._index:
            self._index[key] = torch.as_tensor(getattr(self, which),
                                               dtype=torch.int64,
                                               device=key[1])
        return self._index[key]

    def _take(self, x, which: str, axis: int):
        if isinstance(x, torch.Tensor):
            return torch.index_select(x, axis, self.index(which, x.device))
        return np.take(np.asarray(x), getattr(self, which), axis=axis)

    def pack(self, x, axis: int = 0):
        """Reorder caller-order streams into device (tile-sorted) order."""
        return self._take(x, "perm", axis)

    def unpack(self, y, axis: int = 0):
        """Restore device-order outputs to the caller's stream order."""
        return self._take(y, "inv", axis)


def broadcast_gains(gains, batch: int, n_bands: int,
                    device="cpu") -> torch.Tensor:
    """Normalize a gain spec to a [batch, n_bands] float32 tensor on
    `device`: accepts [n_bands] (shared), [batch, n_bands] (per-stream), or
    a scalar."""
    g = np.asarray(gains, dtype=np.float32)
    if g.ndim == 0:
        g = np.full((batch, n_bands), g, dtype=np.float32)
    elif g.ndim == 1:
        if g.shape[0] != n_bands:
            raise ValueError(f"expected {n_bands} gains, got {g.shape[0]}")
        g = np.broadcast_to(g[None, :], (batch, n_bands))
    elif g.ndim == 2:
        if g.shape != (batch, n_bands):
            raise ValueError(f"expected gains [{batch}, {n_bands}], got {g.shape}")
    else:
        raise ValueError("gains must be scalar, [n_bands], or [batch, n_bands]")
    return torch.as_tensor(np.ascontiguousarray(g), device=device)


def with_per_stream_gains(pipe: Pipeline, params: DeviceParams,
                          gains) -> DeviceParams:
    """Params with a per-stream gain matrix [batch, n_bands]: each stream
    is filtered by its own EQ curve ('fft': a [B, F] response; 'td_mxu':
    K11)."""
    cfg = pipe.cfg
    if not (cfg.eq_enabled and len(cfg.eq_bands)):
        raise ValueError(
            "with_per_stream_gains requires eq_enabled=True with at "
            "least one EQ band (per-stream gains weight the band bank)")
    g = broadcast_gains(gains, pipe.batch, params.H_bands.shape[0],
                        pipe.device)
    return params._replace(eq_gains=g)


def _batched_convolve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Full linear conv of shared `a` [K] with each row of `b` [B, N]
    (float64, one batched FFT — the cold design path for stream banks)."""
    K, N = len(a), b.shape[-1]
    n = 1 << (K + N - 2).bit_length()
    out = np.fft.irfft(np.fft.rfft(a, n) * np.fft.rfft(b, n, axis=-1), n,
                       axis=-1)
    return out[..., : K + N - 1]


def _design_sort_perm(assign: np.ndarray, link: int = 1) -> np.ndarray:
    """Stable permutation grouping identical designs contiguously; whole
    ``agc_link_group`` blocks move together (the linked group-min runs over
    adjacent streams, so groups must stay intact)."""
    B = len(assign)
    if link > 1:
        g = assign.reshape(B // link, link)
        if not np.all(g == g[:, :1]):
            raise ValueError(
                "pack=True requires a constant design within each "
                f"agc_link_group of {link} adjacent streams (linked "
                "streams share one gain and must share one kernel)")
        order = np.argsort(g[:, 0], kind="stable")
        return (order[:, None] * link
                + np.arange(link)[None, :]).reshape(-1)
    return np.argsort(assign, kind="stable")


def with_per_stream_filters(pipe: Pipeline, variants: Sequence[dict],
                            bt: Optional[int] = None, pack: bool = False):
    """Per-stream main-filter banks (`afp_tpu/engine/batch.py:210-342`):
    design one main filter per stream from `variants` (dicts of dynamic
    design-field overrides: cutoff, filter_type, window_type,
    design_method).

    Constraints: one variant per stream, shape-static fields untouched, no
    numtaps bump, ``eq_enabled=False``.  'fft' carries a [B, F] ``H_main``
    bank (row-level granularity): the fused cascades, or under the literal
    chain the raw main filters.  'td_mxu' carries the deduplicated
    ``casc_bank`` [D, n_casc] and the per-tile ``casc_assign`` [B / bt]:
    streams sharing a design fill whole tiles of `bt` rows (the reference's
    tile ladder, :func:`_banked_tile`).  ``pack=True`` sorts an arbitrary
    ordering into tile order and returns ``(params, StreamPacking)``
    (identity on 'fft'); apply ``pack`` at ingest and ``unpack`` on drain,
    or hand the packing to `RingServer`."""
    cfg = pipe.cfg
    if len(variants) != pipe.batch:
        raise ValueError(f"need {pipe.batch} variants, got {len(variants)}")
    if cfg.eq_enabled and len(cfg.eq_bands):
        raise NotImplementedError(
            "per-stream filter banks require eq_enabled=False "
            "(fold per-stream EQ into the kernel design instead)")
    static = {"numtaps", "blocksize", "upsample_factor", "batch",
              "samplerate", "min_phase", "agc_window_size"}
    mains = []
    designed: dict = {}  # identical overrides design once (a pure function)
    for ov in variants:
        key = repr(sorted(ov.items()))
        if key not in designed:
            bad = static.intersection(ov)
            if bad:
                raise ValueError(f"per-stream overrides cannot change "
                                 f"{sorted(bad)} (shape-static fields)")
            c = dataclasses.replace(cfg, **ov).validate()
            if c.numtaps != cfg.numtaps:
                raise ValueError(
                    f"variant {ov!r} changes numtaps {cfg.numtaps} → "
                    f"{c.numtaps} (the even→odd bump for "
                    f"{c.filter_type}): use an odd base numtaps so every "
                    "per-stream kernel shares one static length")
            designed[key] = PipelineParams.design(c)
        mains.append(designed[key].main_taps.astype(np.float64))
    design0 = next(iter(designed.values()))
    mains = np.stack(mains)  # [B, n_kernel]

    if pipe.fused:
        # the fused cascade of every stream: upsampler ⊛ main
        # (⊛ downsampler), phase-0 polyphase component
        casc = _batched_convolve(pipe._h_up_np, mains)
        if pipe._h_down_np is not None:
            casc = _batched_convolve(pipe._h_down_np, casc)
        casc = casc[:, :: pipe.upf]
        bank = np.zeros((pipe.batch, pipe.n_casc))
        bank[:, : casc.shape[-1]] = casc[:, : pipe.n_casc]
    else:
        # the literal chain filters at the upsampled rate: the raw mains
        # (`afp_tpu/engine/batch.py:301-302`)
        bank = mains
    params = pipe.device_params(design0)

    def spectra(rows):
        return torch.fft.rfft(torch.as_tensor(rows, dtype=torch.float32,
                                              device=pipe.device),
                              n=pipe.nfft, dim=-1)

    if not pipe._use_td:
        p = params._replace(H_main=spectra(bank))
        if pack:  # fft banks are row-granular: packing is the identity
            ident = np.arange(pipe.batch)
            return p, StreamPacking(perm=ident, inv=ident.copy())
        return p

    # td_mxu: deduplicated design bank + tile-constant assignment
    uniq: dict = {}
    assign = np.empty(pipe.batch, dtype=np.int32)
    for b in range(pipe.batch):
        assign[b] = uniq.setdefault(bank[b].tobytes(), len(uniq))
    designs = np.empty((len(uniq), pipe.n_casc))
    designs[assign] = bank
    packing = None
    if pack:
        perm = _design_sort_perm(assign, link=cfg.agc_link_group)
        packing = StreamPacking(perm=perm, inv=np.argsort(perm))
        assign = assign[perm]
        bank = bank[perm]  # the [B, F] response bank rides device order too
    bt = _banked_tile(pipe, assign, bt)
    params = params._replace(
        H_main=spectra(bank),
        casc_bank=torch.as_tensor(designs, dtype=torch.float32,
                                  device=pipe.device),
        casc_assign=torch.as_tensor(assign[::bt], dtype=torch.int32,
                                    device=pipe.device))
    return (params, packing) if pack else params


# The TPU kernels' batch-tile ladders (`afp_tpu/ops/pallas/fir_td.py:345-364,
# 599-622, 1066-1076`), copied as plain functions of the shapes.  In the port
# they fix only the granularity of the design assignment, so that
# `casc_assign` is `afp_tpu`'s and params move between the packages both
# ways; the CUDA kernels' own tile is 4 rows and any multiple-of-4 (or
# whole-batch) assignment tile suits it.


def _pick_b_tile(B: int, text: int, T: int, cap: int = 256) -> int:
    """The staged conv's ladder: 256 rows up to 16 tiles, else halve until
    a double-buffered [tile, text] + [tile, T] f32 pair fits ~12 MB."""
    for b_tile in (256, 128, 64, 32, 16, 8):
        if b_tile > cap or B % b_tile:
            continue
        if b_tile == 256 and B // b_tile <= 16:
            return b_tile
        if 2 * b_tile * (text + T) * 4 <= 12 * 2**20:
            return b_tile
    return min(B, 8)


def _pick_b_tile_banded(B: int, bytes_per_row: int) -> int:
    """The ring kernels' ladder: the largest tile within ~12 MB, a whole
    batch of at most 8 rows, else an error."""
    for b_tile in (256, 128, 64, 32, 16, 8):
        if B % b_tile:
            continue
        if b_tile * bytes_per_row <= 12 * 2**20:
            return b_tile
    if B <= 8:
        return B
    raise ValueError(
        f"batch {B} is not divisible by any supported batch tile "
        "(must be ≤ 8 or a multiple of 8)")


def _pick_b_tile_b3t_f32(B: int, k_pad: int, T: int) -> int:
    """The f32 ring's ladder entry: f32 block, its pair temporaries, tails
    and output per row."""
    return _pick_b_tile_banded(
        B, 2 * T * 4 + 2 * T * 2 + 4 * k_pad * 4 + 2 * T * 4)


def _banked_tile(pipe: Pipeline, assign: np.ndarray,
                 bt: Optional[int] = None) -> int:
    """The assignment tile (`afp_tpu/engine/batch.py:345-394`): a ladder
    value that divides the batch, at or below both ladders' picks, within
    which the design assignment is constant.  The default also caps it at
    ``max(8, B // 8)``.  Raises with guidance when the assignment is finer
    than 8 rows."""
    B = pipe.batch
    n_casc = pipe.n_casc
    text = pipe.block + n_casc - 1
    cap = min(_pick_b_tile(B, text, pipe.block),
              _pick_b_tile_b3t_f32(B, ring_k_pad(n_casc), pipe.block))
    if bt is not None:
        if bt > cap or B % bt or bt not in (256, 128, 64, 32, 16, 8, B):
            raise ValueError(
                f"bt={bt} must be a ladder tile ≤ the VMEM pick {cap} "
                f"dividing batch {B}")
        groups = assign.reshape(B // bt, bt)
        if not np.all(groups == groups[:, :1]):
            raise ValueError(
                f"design assignment is not constant within bt={bt} row "
                "groups")
        return bt
    default_cap = min(cap, max(8, B // 8))
    for cand in (256, 128, 64, 32, 16, 8):
        if cand > default_cap or B % cand:
            continue
        groups = assign.reshape(B // cand, cand)
        if np.all(groups == groups[:, :1]):
            return cand
    if B <= 8 and np.all(assign == assign[0]):
        return B
    raise ValueError(
        "per-stream designs must be constant within aligned batch-tile "
        "row groups (multiples of 8 rows; the MXU tile floor) — pass "
        "pack=True to sort arbitrary orderings into tile-compatible "
        "device order (with_per_stream_filters then returns (params, "
        "StreamPacking)), or use conv_strategy='fft' for row-level banks")
