"""The plain reference of the served chain, in float64 NumPy.

It works everything out again from the configuration's `stream` fields and
the generated input blocks, and takes nothing from the program under test:

* the design: the windowed-sinc main filter and EQ bands of the upstream
  project (`filter_methods.py`: periodic window, unity gain at DC for a
  lowpass, at the geometric band centre on an 8000-point grid for a
  bandpass), the Kaiser-windowed upsampler of each quality tier, and the
  fused single-rate kernel: the phase-0 polyphase component of
  upsampler ⊛ (EQ band sum ⊛) main, since the chain returns to the base
  rate by decimation;
* the AGC of `stream_process_AGC.py`: moving RMS over the block ('same'
  zero padding), desired gain ``clip(target / (rms + 1e-10), 0,
  max_gain)``, the attack/release recurrence sample by sample, the gains
  clipped to [0.1, max_gain] and the last one carried, the gained signal
  clipped to ±0.99;
* the block's FIR with the carried input history, the output clip, the
  TPDF/RPDF dither of the stated algorithm (Philox4x32-10 keyed by
  (seed, block counter) over the flat element index of the [batch, block]
  output), and the int16 quantizer's exact value.

It imports neither the program nor JAX.  `precision='bfloat16'` runs the
same chain with the input, the gained signal and the taps rounded to
bfloat16: the control, which the comparison has to refuse.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["design", "agc_alphas", "agc_history_blocks", "philox_noise",
           "reference_blocks", "QUALITY"]

#: resampler quality tier → (half length per rate factor, Kaiser beta)
QUALITY = {"fast": (10, 5.0), "hq": (40, 12.26), "vhq": (64, 14.47)}

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = np.uint64(0xFFFFFFFF)


def _periodic_window(name: str, n: int) -> np.ndarray:
    """The upstream project's `get_window(name, n)`: periodic (fftbins)."""
    coef = {"hamming": (0.54, 0.46), "hann": (0.5, 0.5),
            "blackman": (0.42, 0.5, 0.08)}[name]
    k = np.arange(n) * (2.0 * np.pi / n)
    return sum(((-1) ** i) * c * np.cos(i * k) for i, c in enumerate(coef))


def _sinc_taps(numtaps: int, lo: float | None, hi: float, fs: float,
               window: np.ndarray) -> np.ndarray:
    """Windowed sinc: lowpass at `hi`, or bandpass (`lo`, `hi`), in Hz."""
    t = np.arange(numtaps) - (numtaps - 1) / 2.0
    t[t == 0] = 1e-20
    nyq = fs / 2.0
    h = (hi / nyq) * np.sinc((hi / nyq) * t)
    if lo is not None:
        h = h - (lo / nyq) * np.sinc((lo / nyq) * t)
    return h * window


def _lowpass(numtaps: int, cutoff: float, fs: float, window) -> np.ndarray:
    h = _sinc_taps(numtaps, None, cutoff, fs, window)
    return h / h.sum()


def _bandpass(numtaps: int, lo: float, hi: float, fs: float) -> np.ndarray:
    h = _sinc_taps(numtaps, lo, hi, fs, _periodic_window("hamming", numtaps))
    grid = np.arange(8000) * (fs / 2.0 / 8000)  # freqz(worN=8000) frequencies
    f = grid[int(np.argmin(np.abs(grid - math.sqrt(lo * hi))))]
    resp = np.sum(h * np.exp(-2j * np.pi * f / fs * np.arange(numtaps)))
    return h / abs(resp)


def _upsampler(up: int, quality: str) -> np.ndarray:
    """The causal streaming upsampler's impulse response: a Kaiser-windowed
    sinc at 1/up of Nyquist, 2·mult·up + 1 taps, gain `up`, one leading
    zero (the polyphase centring pre-pad for a down factor of 1)."""
    mult, beta = QUALITY[quality]
    n = 2 * mult * up + 1
    h = _lowpass(n, 1.0 / up, 2.0, np.kaiser(n, beta)) * up
    return np.concatenate([[0.0], h])


def design(stream: dict) -> np.ndarray:
    """The fused single-rate kernel of the configuration (float64)."""
    up = int(stream["upsample_factor"])
    fs = float(stream["samplerate"]) * up
    n = int(stream["numtaps"])
    if stream.get("filter_type", "lowpass") != "lowpass":
        raise ValueError("the reference designs lowpass main filters only")
    if stream.get("downsample_mode") != "decimate":
        raise ValueError("the reference runs the decimating chain only")
    main = _lowpass(n, float(stream["cutoff"]), fs,
                    _periodic_window(stream.get("window_type", "hamming"), n))
    k = np.convolve(_upsampler(up, stream.get("resample_quality", "hq")), main)
    if stream.get("eq_enabled", False):
        bands = stream["eq_bands"]
        eq = sum(float(b.get("gain", 1.0)) * _bandpass(n, b["low"], b["high"], fs)
                 for b in bands)
        k = np.convolve(k, eq)
    return k[::up]


def agc_alphas(window: int, attack: float, release: float) -> tuple:
    """α = 1 − exp(−1/τ) with τ = int(time · window) samples (1 at τ = 0)."""
    def alpha(time_s):
        tau = int(time_s * window)
        return 1.0 - math.exp(-1.0 / tau) if tau > 0 else 1.0
    return alpha(attack), alpha(release)


def agc_history_blocks(stream: dict) -> int:
    """Blocks of history after which a gain started anywhere in (0, max]
    agrees with the true one to below 1e-20: the recurrence contracts by at
    least (1 − α_release) a sample."""
    if not stream.get("agc_enabled", False):
        return 0
    _, a_rel = agc_alphas(int(stream["agc_window_size"]),
                          float(stream["agc_attack"]), float(stream["agc_release"]))
    per_block = -math.log1p(-a_rel) * int(stream["blocksize"])
    return int(math.ceil(50.0 / per_block))


def _agc(x: np.ndarray, g: np.ndarray, stream: dict) -> tuple:
    """One block of the AGC over rows `x` [N, T] from the carried gains
    `g` [N]: (gained block, new carried gains)."""
    w = int(stream["agc_window_size"])
    a_att, a_rel = agc_alphas(w, float(stream["agc_attack"]),
                              float(stream["agc_release"]))
    target, mg = float(stream["agc_target_level"]), float(stream["agc_max_gain"])
    T = x.shape[-1]
    c = np.concatenate([np.zeros((x.shape[0], 1)), np.cumsum(x * x, axis=-1)], -1)
    i = np.arange(T)
    half = (w - 1) // 2
    hi = np.minimum(T, i + half + 1)
    lo = np.maximum(0, i + half + 1 - w)
    ms = (c[:, hi] - c[:, lo]) / w
    d = np.clip(target / (np.sqrt(np.maximum(ms, 0.0)) + 1e-10), 0.0, mg)
    gs = np.empty_like(d)
    for t in range(T):
        a = np.where(d[:, t] > g, a_att, a_rel)
        g = a * d[:, t] + (1.0 - a) * g
        gs[:, t] = g
    gs = np.clip(gs, 0.1, mg)
    return np.clip(x * gs, -0.99, 0.99), gs[:, -1].copy()


def _philox(c0, c1, k0: int, k1: int, c2=None, c3=None):
    """Philox4x32-10 over uint64 arrays holding 32-bit words (counter words
    2 and 3 zero unless given); returns the four output words."""
    c2 = np.zeros_like(c0) if c2 is None else c2
    c3 = np.zeros_like(c0) if c3 is None else c3
    k0, k1 = k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & 0xFFFFFFFF
            k1 = (k1 + _W1) & 0xFFFFFFFF
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ np.uint64(k0),
                          p1 & _MASK,
                          (p0 >> np.uint64(32)) ^ c3 ^ np.uint64(k1),
                          p0 & _MASK)
    return c0, c1, c2, c3


def philox_noise(seed: int, counter: int, rows, block: int, bits: int,
                 kind: str) -> np.ndarray:
    """Dither noise [len(rows), block] of block `counter` for the given
    rows of the [batch, block] output: element i = row·block + t takes
    word i mod 4 of philox(i div 4, key=(seed, counter)).  TPDF is
    (u₁ − u₂)·lsb/65536 from the two 16-bit halves, RPDF
    ((b >> 8)/2²⁴ − 0.5)·lsb, lsb = 2^(1 − bits)."""
    rows = np.asarray(rows, dtype=np.uint64)
    if block % 4:
        raise ValueError("block must be a multiple of 4")
    ctr = rows[:, None] * np.uint64(block // 4) + np.arange(block // 4, dtype=np.uint64)
    words = _philox(ctr & _MASK, ctr >> np.uint64(32), int(seed), int(counter))
    b = np.stack(words, axis=-1).reshape(len(rows), block)
    lsb = 2.0 ** (1 - int(bits))
    if kind == "tpdf":
        return ((b & np.uint64(0xFFFF)).astype(np.float64)
                - (b >> np.uint64(16)).astype(np.float64)) * (lsb / 65536.0)
    if kind == "rpdf":
        return ((b >> np.uint64(8)).astype(np.float64) / 2.0 ** 24 - 0.5) * lsb
    raise ValueError(f"dither kind {kind!r}")


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round float64 values to bfloat16 (nearest, ties to even) via f32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + np.uint64(0x7FFF) + ((u >> np.uint64(16)) & np.uint64(1))) & np.uint64(0xFFFF0000)
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _fir(seg: np.ndarray, h: np.ndarray, out_len: int) -> np.ndarray:
    """The last `out_len` samples of each row of `seg` [N, S] through `h`."""
    n = seg.shape[-1] + len(h) - 1
    nfft = 1 << (n - 1).bit_length()
    y = np.fft.irfft(np.fft.rfft(seg, nfft) * np.fft.rfft(h, nfft), nfft)
    return y[:, seg.shape[-1] - out_len:seg.shape[-1]]


def reference_blocks(block_of, rows, blocks, stream: dict, dither_seed: int,
                     precision: str = "float64", *, config: dict | None = None,
                     seed: int | None = None) -> np.ndarray:
    """The chain's output before the int16 quantizer, float64
    [len(blocks), len(rows), blocksize], for the given global block indices
    and rows.  `block_of(k)` returns input block k, [batch, blocksize]
    float32 or int16 PCM (n/32768).  Each block is worked out from the
    stream's start (block 0, zero history, unity gain) or, deeper in the
    stream, from `agc_history_blocks` + 1 blocks before it.  `config` (the
    whole configuration file) and `seed` (the run's) are every reference's
    keywords; this chain needs neither."""
    rows = np.asarray(rows)
    blocks = [int(k) for k in blocks]
    T = int(stream["blocksize"])
    h = design(stream)
    lowp = precision == "bfloat16"
    if lowp:
        h = _bf16(h)
    elif precision != "float64":
        raise ValueError(f"precision {precision!r}")
    agc = bool(stream.get("agc_enabled", False))
    hist = agc_history_blocks(stream) + 1
    clip = stream.get("output_clip")
    kind = stream.get("dither_kind", "tpdf")
    bits = int(stream.get("dither_bits", 24))
    if stream.get("emit") == "pcm16" and kind != "off":
        bits = min(bits, 16)

    def rows_of(k):
        x = np.asarray(block_of(k))[rows]
        x = x.astype(np.float64) / 32768.0 if x.dtype == np.int16 else x.astype(np.float64)
        return _bf16(x) if lowp else x

    out = np.empty((len(blocks), len(rows), T))
    groups: dict = {}  # blocks near the start run from block 0, the rest
    for j, k in enumerate(blocks):  # from `hist` blocks before them
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
                gained, g = _agc(xs[:, i].reshape(S * R, T), g, stream)
                sig[:, i] = gained.reshape(S, R, T)
            if lowp:
                sig = _bf16(sig)
        prev = sig[:, depth - 2] if depth > 1 else np.zeros((S, R, T))
        seg = np.concatenate([prev, sig[:, depth - 1]], -1).reshape(S * R, 2 * T)
        y = _fir(seg, h, T).reshape(S, R, T)
        if clip is not None:
            y = np.clip(y, -float(clip), float(clip))
        for s, j in enumerate(js):
            if kind != "off":
                y[s] = y[s] + philox_noise(dither_seed, blocks[j], rows, T, bits, kind)
            out[j] = y[s]
    return out
