"""The port's ops against `afp_tpu` on the CPU: bf16 split, band matrix,
resampler kernels, the Philox dither noise, and the plain versions of the
conv kernels K1/K3/K4 against the Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and handed to both packages.  Each
test states its tolerance and prints the measured value."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu import design as jdesign
from afp_tpu.ops import resample as jres
from afp_tpu.ops.convolve import next_pow2 as jnext_pow2
from afp_tpu.ops.dither import dither as jdither
from afp_tpu.ops.pallas import fir_td as jfir
from afp_tpu_torch import design as tdesign
from afp_tpu_torch.ops import resample as tres
from afp_tpu_torch.ops.convolve import next_pow2
from afp_tpu_torch.ops.cuda import (KERNELS, band_matrix, dither_cuda,
                                    fir_td_mxu, fir_td_mxu_ring_f32,
                                    fir_td_mxu_ring_mega_f32, merge_bf16,
                                    ring_k_pad, split_bf16)
from afp_tpu_torch.ops.dither import (dither_plain, lsb_for_bits, noise,
                                      noise_bits, philox4x32)

#: the bf16×3 accumulation-order class: the same split products summed in
#: another fp32 order (`docs/DESIGN.md`, "f32 conv ring")
CONV_DB = -110.0


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


# ---------------------------------------------------------------- split_bf16


def _split_both(v: np.ndarray):
    jh, jl = jfir.split_bf16(jnp.asarray(v))
    th, tl = split_bf16(torch.from_numpy(v))
    return (np.asarray(jh.astype(jnp.float32)), np.asarray(jl.astype(jnp.float32)),
            th.float().numpy(), tl.float().numpy())


@pytest.mark.parametrize("log_scale", [0.0, 10.0, 40.0])
def test_split_bf16_bit_exact_random(log_scale):
    """Tolerance: bit-exact (integer mask, then the same RNE cast)."""
    rng = np.random.default_rng(1)
    v = (rng.standard_normal(20000)
         * np.exp(rng.uniform(-log_scale, log_scale, 20000))).astype(np.float32)
    v = v[np.abs(v) >= np.finfo(np.float32).tiny * 2 ** 16]  # lo stays normal
    jh, jl, th, tl = _split_both(v)
    n_diff = int(np.sum(bits(jh) != bits(th)) + np.sum(bits(jl) != bits(tl)))
    print(f"split_bf16: {v.size} values, {n_diff} differing bit patterns")
    assert n_diff == 0


def test_split_bf16_ties_and_edges():
    """Ties of the hi rounding (mantissa low half exactly 0x8000, both
    parities), the largest finite values and zeros: bit-exact.  Subnormal lo
    halves and infinities: equal as values (XLA's CPU convert flushes a
    subnormal lo to +0 where torch keeps −0; inf − inf is a NaN in both)."""
    hi_bits = np.arange(0x3F800000, 0x3F800000 + (64 << 16), 1 << 16, dtype=np.uint32)
    ties = np.concatenate([hi_bits | 0x8000, hi_bits | 0x7FFF, hi_bits | 0x8001])
    edges = np.array([0.0, -0.0, 1.0, -1.0, np.finfo(np.float32).max,
                      -np.finfo(np.float32).max, np.finfo(np.float32).tiny * 2 ** 20,
                      3.3895314e38], dtype=np.float32)
    v = np.concatenate([ties.view(np.float32), -ties.view(np.float32), edges])
    jh, jl, th, tl = _split_both(v)
    assert np.array_equal(bits(jh), bits(th)) and np.array_equal(bits(jl), bits(tl))
    odd = np.array([1e-40, -1e-42, np.finfo(np.float32).tiny * 1.5,
                    np.inf, -np.inf], dtype=np.float32)
    jh, jl, th, tl = _split_both(odd)
    assert np.array_equal(bits(jh), bits(th))
    np.testing.assert_array_equal(jl, tl)  # NaN positions equal, ±0 equal
    print(f"split_bf16: {v.size} ties/edges bit-exact, {odd.size} subnormal/inf "
          "equal as values")


def test_merge_bf16_inverts_split():
    """merge(split(v)) equals jax's merge bit for bit."""
    v = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    jm = np.asarray(jfir.merge_bf16(*jfir.split_bf16(jnp.asarray(v))))
    tm = merge_bf16(*split_bf16(torch.from_numpy(v))).numpy()
    assert np.array_equal(bits(jm), bits(tm))
    print(f"merge_bf16: max |v - merge(split(v))| = {np.max(np.abs(tm - v)):.3g}")


# ---------------------------------------------------------------- host design


@pytest.mark.parametrize("name", jdesign.WINDOW_NAMES)
def test_design_copy_windows_bit_exact(name):
    """The port's copy of `afp_tpu.design`: every window, bit for bit."""
    assert tdesign.WINDOW_NAMES == jdesign.WINDOW_NAMES
    for n in (16, 101):
        assert np.array_equal(tdesign.get_window(name, n), jdesign.get_window(name, n))


@pytest.mark.parametrize("method,ftype,cutoff,n", [
    ("window", "lowpass", 11000.0, 1001), ("window", "highpass", 3000.0, 129),
    ("window", "bandpass", (500.0, 4000.0), 257),
    ("window", "bandstop", (500.0, 4000.0), 257),
    ("remez", "lowpass", 8000.0, 65), ("remez", "bandpass", (1000.0, 5000.0), 101)])
def test_design_copy_filters_bit_exact(method, ftype, cutoff, n):
    """create_fir_filter, its minimum-phase conversion and freqz, bit for
    bit against `afp_tpu.design`."""
    kw = dict(method=method, cutoff=cutoff, numtaps=n, window_type="hamming",
              filter_type=ftype, samplerate=176400)
    h = tdesign.create_fir_filter(**kw)
    assert np.array_equal(h, jdesign.create_fir_filter(**kw))
    assert np.array_equal(tdesign.minimum_phase(h), jdesign.minimum_phase(h),
                          equal_nan=True)  # NaN where |H| has zeros, in both
    for a, b in zip(tdesign.freqz(h, fs=176400), jdesign.freqz(h, fs=176400)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [3, 31, 129, 379])
def test_band_matrix_bit_exact(n):
    h = np.random.default_rng(n).standard_normal(n)
    ours = band_matrix(h).numpy()
    assert ours.shape == (n - 1 + 128, 128)
    assert np.array_equal(bits(ours), bits(jfir.band_matrix(h)))


@pytest.mark.parametrize("up,down,quality", [
    (2, 1, "fast"), (4, 1, "hq"), (4, 1, "vhq"), (1, 4, "vhq"), (3, 2, "hq"),
    (1, 1, "fast")])
def test_resample_kernels_bit_exact(up, down, quality):
    assert np.array_equal(tres.quality_kernel(up, down, quality),
                          jres.quality_kernel(up, down, quality))
    assert np.array_equal(tres.streaming_kernel(up, down, quality=quality),
                          jres.streaming_kernel(up, down, quality=quality))
    assert tres.QUALITY_TIERS == jres.QUALITY_TIERS


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 257, 4474])
def test_next_pow2(n):
    assert next_pow2(n) == jnext_pow2(n)


# ---------------------------------------------------------------- Philox noise


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox4x32-10 against the Random123 known-answer vectors."""
    words = philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_noise_counter_is_flat_index():
    """Element i draws word i % 4 of philox(i // 4): any shape, any slice of
    the flat index sees the same bits (the kernels' tiling cannot matter)."""
    key = (7, 3)
    flat = noise_bits(4096, key)
    c = torch.arange(1024, dtype=torch.int64)
    z = torch.zeros_like(c)
    words = torch.stack(philox4x32(c, z, z, z, *key), -1).reshape(-1)
    assert torch.equal(flat, words)
    a = noise((8, 512), key, 2.0 ** -15, True)
    b = noise((4096,), key, 2.0 ** -15, True)
    assert torch.equal(a.reshape(-1), b)


def test_noise_determinism_and_keys():
    """Same key ⇒ same noise; another seed or block counter ⇒ other noise."""
    shape, lsb = (16, 384), 2.0 ** -15
    a = noise(shape, (5, 9), lsb, True)
    assert torch.equal(a, noise(shape, (5, 9), lsb, True))
    for other in [(6, 9), (5, 10)]:
        frac = (noise(shape, other, lsb, True) == a).float().mean().item()
        print(f"key {other}: {frac:.4f} of samples equal the key (5, 9) noise")
        assert frac < 0.01


@pytest.mark.parametrize("kind,var_factor", [("tpdf", 1 / 6), ("rpdf", 1 / 12)])
def test_noise_variance(kind, var_factor):
    """Zero input, 16 bits: TPDF variance lsb²/6, RPDF lsb²/12, mean 0,
    peak within ±1 lsb (TPDF) or ±lsb/2 (RPDF).  Tolerance 2% on the
    variance (2^20 samples: the estimator's sd is ~0.2%)."""
    lsb = lsb_for_bits(16)
    y = dither_plain(torch.zeros(256, 4096), (11, 0), 16, kind).double()
    var = y.var().item() / (lsb ** 2 * var_factor)
    mean = y.mean().item() / lsb
    print(f"{kind}: var / (lsb²·{var_factor:.4f}) = {var:.5f}, mean/lsb = {mean:.2e}")
    assert abs(var - 1) < 0.02 and abs(mean) < 0.01
    assert y.abs().max().item() <= lsb * (1.0 if kind == "tpdf" else 0.5)


@pytest.mark.parametrize("kind", ["tpdf", "rpdf"])
def test_noise_statistics_match_jax_dither(kind):
    """Against `afp_tpu.ops.dither.dither` on zeros: mean, variance and
    range agree (different generators, same distribution).  Tolerance: 2%
    of lsb² on the variance, 0.01 lsb on the mean."""
    import jax

    lsb = lsb_for_bits(16)
    j = np.asarray(jdither(jax.random.PRNGKey(0), jnp.zeros((64, 4096)), 16, kind),
                   dtype=np.float64)
    t = dither_plain(torch.zeros(64, 4096), (0, 0), 16, kind).double().numpy()
    dv = abs(j.var() - t.var()) / lsb ** 2
    dm = abs(j.mean() - t.mean()) / lsb
    print(f"{kind}: |Δvar|/lsb² = {dv:.2e}, |Δmean|/lsb = {dm:.2e}, "
          f"ranges {j.min() / lsb:.3f}..{j.max() / lsb:.3f} vs "
          f"{t.min() / lsb:.3f}..{t.max() / lsb:.3f}")
    assert dv < 0.02 * (1 / 6 if kind == "tpdf" else 1 / 12) and dm < 0.01
    assert abs(j.max() - t.max()) < 0.01 * lsb and abs(j.min() - t.min()) < 0.01 * lsb


def test_dither_wrapper_on_cpu_is_plain():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 256))
                         .astype(np.float32))
    assert torch.equal(dither_cuda(x, (1, 2), 24, "tpdf"),
                       dither_plain(x, (1, 2), 24, "tpdf"))
    assert dither_cuda(x, (1, 2), 24, "off") is x
    with pytest.raises(ValueError, match="kind"):
        dither_cuda(x, (1, 2), 24, "gaussian")


# ---------------------------------------------------------------- conv plains


def _taps_and_signal(n, B, width, seed):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal(n) * 0.1).astype(np.float32)
    x = (rng.standard_normal((B, width)) * 0.5).astype(np.float32)
    return h, x


@pytest.mark.parametrize("n,T,B,clip", [(31, 256, 8, None), (129, 512, 4, 0.3),
                                         (300, 128, 8, None)])
def test_k1_plain_vs_pallas(n, T, B, clip):
    """K1's plain version against `fir_td_mxu` (interpret): ≤ −110 dB."""
    h, x = _taps_and_signal(n, B, n - 1 + T, n)
    want = np.asarray(jfir.fir_td_mxu(x, jfir.band_matrix(h), interpret=True,
                                      out_clip=clip))
    got = fir_td_mxu(torch.from_numpy(x), torch.from_numpy(h), out_clip=clip).numpy()
    e = err_db(got, want)
    print(f"K1 n={n} T={T} B={B} clip={clip}: {e:.1f} dB (bound {CONV_DB})")
    assert got.shape == (B, T) and e <= CONV_DB


@pytest.mark.parametrize("n,T,S,idx", [(129, 256, 3, 1), (300, 128, 2, 0)])
def test_k3_plain_vs_pallas(n, T, S, idx):
    """K3's plain version against `fir_td_mxu_ring_f32` (interpret), with a
    narrow tail padded to k_pad and k_pad > T (300 taps, T 128): ≤ −110 dB
    on the written slot, the tail bit-exact, other slots untouched."""
    B = 8
    h, x = _taps_and_signal(n, B, S * T + n - 1, n + 1)
    ring = x[:, n - 1:].reshape(B, S, T).transpose(1, 0, 2).copy()
    tail = x[:, : n - 1]
    out0 = np.full((S, B, T), 7.0, np.float32)
    j_out, j_tail = jfir.fir_td_mxu_ring_f32(
        jnp.asarray(ring), idx, jnp.asarray(tail), jfir.band_matrix(h),
        jnp.asarray(out0), interpret=True)
    t_out, t_tail = fir_td_mxu_ring_f32(
        torch.from_numpy(ring), idx, torch.from_numpy(tail), torch.from_numpy(h),
        torch.from_numpy(out0.copy()))
    e = err_db(t_out[idx].numpy(), np.asarray(j_out)[idx])
    print(f"K3 n={n} T={T} k_pad={ring_k_pad(n)}: {e:.1f} dB (bound {CONV_DB})")
    assert e <= CONV_DB
    assert np.array_equal(bits(t_tail.numpy()), bits(j_tail))
    others = [s for s in range(S) if s != idx]
    assert np.all(t_out.numpy()[others] == 7.0)


@pytest.mark.parametrize("n,T,S,start,n_steps", [(129, 256, 4, 3, 3),
                                                  (300, 128, 3, 1, 5)])
def test_k4_plain_vs_pallas(n, T, S, start, n_steps):
    """K4's plain version against `fir_td_mxu_ring_mega_f32` (interpret),
    including n_steps > S with k_pad > T: ≤ −110 dB over the ring, the
    tail bit-exact."""
    B = 8
    h, x = _taps_and_signal(n, B, S * T + n - 1, n + 2)
    ring = x[:, n - 1:].reshape(B, S, T).transpose(1, 0, 2).copy()
    tail = np.zeros((B, ring_k_pad(n)), np.float32)
    tail[:, -(n - 1):] = x[:, : n - 1]
    out0 = np.zeros((S, B, T), np.float32)
    j_out, j_tail = jfir.fir_td_mxu_ring_mega_f32(
        jnp.asarray(ring), start, jnp.asarray(tail), jfir.band_matrix(h),
        jnp.asarray(out0), n_steps, interpret=True)
    t_out, t_tail = fir_td_mxu_ring_mega_f32(
        torch.from_numpy(ring), start, torch.from_numpy(tail),
        torch.from_numpy(h), torch.from_numpy(out0.copy()), n_steps)
    e = err_db(t_out.numpy(), np.asarray(j_out))
    print(f"K4 n={n} T={T} S={S} steps={n_steps}: {e:.1f} dB (bound {CONV_DB})")
    assert e <= CONV_DB
    assert np.array_equal(bits(t_tail.numpy()), bits(j_tail))


def test_k4_equals_chained_k3_with_dither():
    """Inside the port: one K4 dispatch of n steps ≡ n K3 steps, bit for
    bit, dither and clip on (block counter c+i for step i)."""
    n, T, S, B = 129, 256, 4, 8
    h, x = _taps_and_signal(n, B, S * T, 5)
    ring = torch.from_numpy(x.reshape(B, S, T).transpose(1, 0, 2).copy())
    ht = torch.from_numpy(h)
    kw = dict(out_clip=0.2, dither_key=(3, 40), dither_bits=16, dither_tpdf=True)
    mega, mtail = fir_td_mxu_ring_mega_f32(ring, 2, torch.zeros(B, 128), ht,
                                           torch.zeros(S, B, T), 6, **kw)
    out, tail = torch.zeros(S, B, T), torch.zeros(B, 128)
    for i in range(6):
        out, tail = fir_td_mxu_ring_f32(ring, (2 + i) % S, tail, ht, out,
                                        **{**kw, "dither_key": (3, 40 + i)})
    assert torch.equal(mega, out) and torch.equal(mtail, tail)


def test_ring_equals_staged_with_dither():
    """Inside the port: a K3 step ≡ the K1 step on concat(tail, slot), bit
    for bit, with clip and dither fused (same noise counter and key)."""
    n, T, B = 129, 256, 8
    h, x = _taps_and_signal(n, B, T + n - 1, 6)
    kw = dict(out_clip=0.2, dither_key=(1, 2), dither_bits=20, dither_tpdf=False)
    staged = fir_td_mxu(torch.from_numpy(x), torch.from_numpy(h), **kw)
    tail = torch.zeros(B, 128)
    tail[:, -(n - 1):] = torch.from_numpy(x[:, : n - 1])
    out, _ = fir_td_mxu_ring_f32(torch.from_numpy(x[None, :, n - 1:].copy()), 0,
                                 tail, torch.from_numpy(h), torch.zeros(1, B, T), **kw)
    assert torch.equal(out[0], staged)


def test_conv_shape_rules():
    """The reference's LANE rule and its message; bad devices raise."""
    h = torch.zeros(31)
    with pytest.raises(ValueError, match="output length 100 must be a multiple of 128"):
        fir_td_mxu(torch.zeros(2, 130), h)
    with pytest.raises(ValueError, match="T=100 must be a multiple of 128"):
        fir_td_mxu_ring_f32(torch.zeros(2, 2, 100), 0, torch.zeros(2, 128), h,
                            torch.zeros(2, 2, 100))
    with pytest.raises(ValueError, match="tail must be"):
        fir_td_mxu_ring_f32(torch.zeros(2, 2, 128), 0, torch.zeros(128), h,
                            torch.zeros(2, 2, 128))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fir_td_mxu_ring_f32(torch.zeros(2, 2, 128), 0, torch.zeros(2, 128), h,
                            torch.zeros(2 * 2 * 128 + 1)[1:].view(2, 2, 128))
    with pytest.raises(ValueError, match="unsupported device"):
        fir_td_mxu(torch.zeros(2, 158, device="meta"), torch.zeros(31, device="meta"))
    assert all(k.launches == 0 for k in KERNELS)  # no kernel runs on the CPU
