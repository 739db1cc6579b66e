"""The plain reference of the served chain with each listener's own EQ, in
float64 NumPy.

A farm that streams to many listeners gives each one their own setting of
the upstream GUI's nine sliders (`stream_process_EQ_GUI.py:162-172`); the
upstream sums the bands into one kernel per setting, Σ gain·h_band
(`:87-90`).  This reference works each sampled row out again in that
combined-kernel form, and takes nothing from the program under test:

* the gains: :func:`draw_gains` draws every listener's gains from the
  configuration's ``per_stream_gains`` and the run's ``--seed`` (the loop
  hands the program the same draw);
* the AGC of `stream_process_AGC.py`, the band and main designs, the
  upsampler and the TPDF/RPDF Philox noise, all from `chain.py` beside this
  file, so the two references cannot drift apart;
* each row's own kernel: the phase-0 polyphase component of upsampler ⊛
  main ⊛ (Σ_k g[row, k]·band_k), the gains mixed into the band taps first
  (not band by band, as the program's K11 mixes its outputs, so the two
  share no structure);
* the block's FIR with the carried input history, the output clip, the
  dither, and the int16 quantizer's exact value.

It imports neither the program nor JAX.  The arithmetic is float64 NumPy
on the CPU, as in `chain.py`.  ``precision='bfloat16'`` runs the same
chain with the input, the gained signal and each row's taps rounded to
bfloat16: the control, which the comparison has to refuse.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

__all__ = ["draw_gains", "row_kernels", "reference_blocks"]


def _sibling(name: str):
    """The reference module `name` beside this file."""
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_reference_{name}_of_per_stream_eq", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chain = _sibling("chain")

#: the stream of the seed's generator that draws the gains (the sampled
#: rows and the kept blocks take streams 1 and 2, `harness/check.py`)
GAIN_STREAM = 3


def draw_gains(config: dict, seed: int, batch: int) -> np.ndarray:
    """Every listener's EQ gains [batch, bands] float32: drawn uniformly on
    the grid ``low + k·step`` (k = 0 … (high − low)/step) of the
    configuration's ``per_stream_gains``, per listener and band, from the
    run's `seed`.  The loop hands these to the program; the reference
    reads its sampled rows."""
    spec = config["per_stream_gains"]
    low, high, step = (float(spec[k]) for k in ("low", "high", "step"))
    n = int(round((high - low) / step))
    rng = np.random.default_rng([int(seed) & 0xFFFF_FFFF_FFFF_FFFF,
                                 GAIN_STREAM])
    k = rng.integers(0, n + 1, size=(int(batch), int(spec["bands"])))
    return (low + k * step).astype(np.float32)


def _fft_conv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Full linear convolution of the last axes of `a` and `b` (float64)."""
    n = a.shape[-1] + b.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    return np.fft.irfft(np.fft.rfft(a, nfft) * np.fft.rfft(b, nfft),
                        nfft)[..., :n]


def row_kernels(stream: dict, gains: np.ndarray) -> np.ndarray:
    """Each row's fused single-rate kernel [rows, n] (float64) for its gains
    [rows, bands]: the phase-0 component of upsampler ⊛ main ⊛ Σ_k
    g[row, k]·band_k, the upstream's combined-kernel form."""
    up = int(stream["upsample_factor"])
    fs = float(stream["samplerate"]) * up
    n = int(stream["numtaps"])
    if stream.get("filter_type", "lowpass") != "lowpass":
        raise ValueError("the reference designs lowpass main filters only")
    if stream.get("downsample_mode") != "decimate":
        raise ValueError("the reference runs the decimating chain only")
    if not (stream.get("eq_enabled") and stream.get("eq_bands")):
        raise ValueError("per-listener gains weight the EQ bands: "
                         "eq_enabled with bands is required")
    bands = np.stack([chain._bandpass(n, b["low"], b["high"], fs)
                      for b in stream["eq_bands"]])
    g = np.asarray(gains, dtype=np.float64)
    if g.ndim != 2 or g.shape[1] != len(bands):
        raise ValueError(f"gains must be [rows, {len(bands)}], got {g.shape}")
    main = chain._lowpass(n, float(stream["cutoff"]), fs,
                          chain._periodic_window(
                              stream.get("window_type", "hamming"), n))
    base = np.convolve(chain._upsampler(up, stream.get("resample_quality",
                                                       "hq")), main)
    eq = (g[:, :, None] * bands[None]).sum(1)  # Σ_k g·band_k, [rows, n]
    return np.ascontiguousarray(_fft_conv(eq, base[None])[:, ::up])


def reference_blocks(block_of, rows, blocks, stream: dict, dither_seed: int,
                     precision: str = "float64", *, config: dict,
                     seed: int) -> np.ndarray:
    """The chain's output before the int16 quantizer, float64
    [len(blocks), len(rows), blocksize], for the given global block indices
    and rows, each row through its own listener's kernel (the gains of
    :func:`draw_gains` for `config` and `seed`).  Blocks are worked out as
    `chain.reference_blocks` works them: from the stream's start, or from
    `chain.agc_history_blocks` + 1 blocks before them."""
    rows = np.asarray(rows)
    blocks = [int(k) for k in blocks]
    T = int(stream["blocksize"])
    gains = draw_gains(config, seed, int(stream["batch"]))[rows]
    lowp = precision == "bfloat16"
    if not lowp and precision != "float64":
        raise ValueError(f"precision {precision!r}")
    h = row_kernels(stream, gains)  # [R, n]
    if lowp:
        h = chain._bf16(h)
    agc = bool(stream.get("agc_enabled", False))
    hist = chain.agc_history_blocks(stream) + 1
    clip = stream.get("output_clip")
    kind = stream.get("dither_kind", "tpdf")
    bits = int(stream.get("dither_bits", 24))
    if stream.get("emit") == "pcm16" and kind != "off":
        bits = min(bits, 16)

    def rows_of(k):
        x = np.asarray(block_of(k))[rows]
        x = (x.astype(np.float64) / 32768.0 if x.dtype == np.int16
             else x.astype(np.float64))
        return chain._bf16(x) if lowp else x

    out = np.empty((len(blocks), len(rows), T))
    groups: dict = {}  # as chain.reference_blocks groups them
    for j, k in enumerate(blocks):
        groups.setdefault(k if k < hist else -1, []).append(j)
    R = len(rows)
    for key, js in groups.items():
        depth = key + 1 if key >= 0 else hist + 1
        xs = np.stack([np.stack([rows_of(blocks[j] - depth + 1 + i)
                                 for i in range(depth)]) for j in js])
        S = len(js)  # xs: [S, depth, R, T]
        sig = xs
        if agc:
            g = np.ones(S * R)
            sig = np.empty_like(xs)
            for i in range(depth):
                gained, g = chain._agc(xs[:, i].reshape(S * R, T), g,
                                       stream)
                sig[:, i] = gained.reshape(S, R, T)
            if lowp:
                sig = chain._bf16(sig)
        prev = sig[:, depth - 2] if depth > 1 else np.zeros((S, R, T))
        seg = np.concatenate([prev, sig[:, depth - 1]], -1)  # [S, R, 2T]
        y = _fft_conv(seg, h[None])[..., T:2 * T]
        if clip is not None:
            y = np.clip(y, -float(clip), float(clip))
        for s, j in enumerate(js):
            if kind != "off":
                y[s] = y[s] + chain.philox_noise(dither_seed, blocks[j],
                                                 rows, T, bits, kind)
            out[j] = y[s]
    return out

