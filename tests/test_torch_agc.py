"""The port's AGC ops and kernels K5-K8 against `afp_tpu` on the CPU: the
plain `ops/agc.py`, and the plain versions of K5 (`rms_desired`), K6
(`smooth_gain_apply`), K8 (`fir_td_mxu_pair`) and K7
(`fir_td_mxu_pair_to_ring`) against the Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and handed to both packages.  Each
test states its bound (max-abs error over peak, in dB) and prints the
measured value.  The Pallas AGC apply kernel is slow to trace in interpret
mode (seconds per option set at its smallest tile, B = 1024), so its cases
share shapes and option sets."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.ops import agc as jagc
from afp_tpu.ops.pallas import agc_rms as jrms
from afp_tpu.ops.pallas import agc_scan as jscan
from afp_tpu.ops.pallas import fir_td as jfir
from afp_tpu_torch.ops import agc as tagc
from afp_tpu_torch.ops.cuda import (band_is_exact_bf16, band_matrix,
                                    fir_td_mxu_pair,
                                    fir_td_mxu_pair_plain,
                                    fir_td_mxu_pair_to_ring, ring_k_pad,
                                    rms_desired, rms_desired_plain,
                                    smooth_gain_apply, split_bf16)

EXACT_DB = -130.0  # the same f32 ops in the same order: bit-exact expected
FFT_DB = -100.0  # two FFT libraries
CONV_DB = -110.0  # the bf16×3 (and bf16-split boxcar) accumulation-order class

A_ATT, A_REL = tagc.agc_alphas(128)  # α of the C8 window scaled to W = 128


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def ulps(a, b) -> int:
    """Largest distance in f32 units in the last place."""
    ia = np.asarray(a, dtype=np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, dtype=np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(ia - ib)))


def signal(shape, seed=0, scale=0.3) -> np.ndarray:
    """Noise with a loud row and a quiet row, so the gain both attacks and
    releases and reaches its clips."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    x[..., 0, : shape[-1] // 2] *= 4.0
    x[..., 1, :] *= 1e-3
    return x


def desired(shape, seed=1) -> np.ndarray:
    """A desired-gain signal: a smooth walk in [0.2, 8] with steps."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.standard_normal(shape) * 0.05, axis=-1)
    return np.clip(2.0 + walk + rng.uniform(-1, 1, shape[:-1] + (1,)),
                   0.2, 8.0).astype(np.float32)


def check(name, got, want, bound):
    e = err_db(got, want)
    print(f"{name}: {e:.1f} dB, {ulps(got, want)} ulp (bound {bound})")
    assert np.asarray(got).shape == np.asarray(want).shape and e <= bound


# ---------------------------------------------------------------- ops/agc.py


def test_alphas_and_params_match():
    for w in (1, 50, 128, 512, 4096):
        assert tagc.agc_alphas(w) == jagc.agc_alphas(w)
        assert tagc.agc_alphas(w, 0.0, 0.5) == jagc.agc_alphas(w, 0.0, 0.5)
    p, q = tagc.AGCParams(0.2, 300, 6.0, 0.02, 0.3), jagc.AGCParams(0.2, 300, 6.0, 0.02, 0.3)
    assert vars(p) == vars(q)


@pytest.mark.parametrize("vector", [False, True])
def test_desired_gain_matches(vector):
    rms = np.abs(signal((4, 256), seed=2))
    t, m = (np.array([0.1, 0.2, 0.05, 0.3], np.float32), np.full(4, 6.0, np.float32)) \
        if vector else (0.1, 10.0)
    check("desired_gain", tagc.desired_gain(torch.from_numpy(rms), t, m).numpy(),
          np.asarray(jagc.desired_gain(jnp.asarray(rms), t, m)), EXACT_DB)


@pytest.mark.parametrize("group,axis", [(1, 0), (2, 0), (4, 0), (2, 1)])
def test_link_desired_bit_exact(group, axis):
    d = desired((8, 64), seed=3)
    if axis == 1:
        d = np.ascontiguousarray(d.T)
    got = tagc.link_desired(torch.from_numpy(d), group, batch_axis=axis).numpy()
    assert np.array_equal(got, np.asarray(jagc.link_desired(jnp.asarray(d), group,
                                                            batch_axis=axis)))


@pytest.mark.parametrize("use_init", [False, True])
def test_smooth_gain_scan_matches(use_init):
    d = desired((6, 300), seed=4)
    init = np.linspace(0.3, 5.0, 6).astype(np.float32) if use_init else None
    got = tagc.smooth_gain_scan(torch.from_numpy(d), A_ATT, A_REL,
                                None if init is None else torch.from_numpy(init))
    want = jagc.smooth_gain_scan(jnp.asarray(d), A_ATT, A_REL,
                                 None if init is None else jnp.asarray(init))
    check(f"smooth_gain_scan init={use_init}", got.numpy(), np.asarray(want), EXACT_DB)


@pytest.mark.parametrize("f32_alphas", [False, True])
@pytest.mark.parametrize("use_init", [False, True])
def test_smooth_gain_blockwise_matches(use_init, f32_alphas):
    """Python-float alphas compound in float64 on both sides; f32 alphas by
    repeated squaring (`lax.integer_pow`)."""
    d = desired((5, 256), seed=5)
    init = np.linspace(0.5, 3.0, 5).astype(np.float32) if use_init else None
    ta, tr = (torch.tensor(A_ATT, dtype=torch.float32), torch.tensor(A_REL, dtype=torch.float32)) \
        if f32_alphas else (A_ATT, A_REL)
    ja, jr = (jnp.float32(A_ATT), jnp.float32(A_REL)) if f32_alphas else (A_ATT, A_REL)
    got = tagc.smooth_gain_blockwise(torch.from_numpy(d), ta, tr,
                                     init=None if init is None else torch.from_numpy(init))
    want = jagc.smooth_gain_blockwise(jnp.asarray(d), ja, jr,
                                      init=None if init is None else jnp.asarray(init))
    check(f"smooth_gain_blockwise init={use_init} f32={f32_alphas}", got.numpy(),
          np.asarray(want), EXACT_DB)


def test_compound_alpha_bit_exact():
    """K6's blockwise coefficient 1 − (1 − α)^32 in f32, against the JAX
    wrapper's `lax.integer_pow` (`agc_scan.py:458-459`), bit for bit."""
    for a in (A_ATT, A_REL, *tagc.agc_alphas(512), 0.5, 1.0, 1e-4):
        want = np.asarray(1.0 - (1.0 - jnp.asarray(a, jnp.float32)) ** 32)
        assert tagc.compound_alpha(a, 32).numpy().view(np.uint32) == want.view(np.uint32), a


@pytest.mark.parametrize("w", [1, 64, 100, 512])
def test_moving_rms_matches(w):
    x = signal((3, 1024), seed=6)
    check(f"moving_rms w={w}", tagc.moving_rms(torch.from_numpy(x), w).numpy(),
          np.asarray(jagc.moving_rms(jnp.asarray(x), w)), FFT_DB)


def test_apply_agc_matches():
    x = signal((4, 512), seed=7)
    p = tagc.AGCParams(window_size=128)
    y, g = tagc.apply_agc(torch.from_numpy(x), p, carry=torch.full((4,), 2.0))
    jy, jg = jagc.apply_agc(jnp.asarray(x), jagc.AGCParams(window_size=128),
                            carry=jnp.full((4,), 2.0))
    check("apply_agc y", y.numpy(), np.asarray(jy), FFT_DB)
    check("apply_agc gain", g.numpy(), np.asarray(jg), FFT_DB)


# ---------------------------------------------------------------- K5


def rms_band(w):
    return band_matrix(np.full(w, 1.0 / w, dtype=np.float32))


@pytest.mark.parametrize("w,transposed,mean_chunk,ring", [
    (128, False, 0, False),   # two-level, one lane
    (256, True, 0, False),    # two-level, window as wide as the block
    (100, False, 0, False),   # direct, 1/100 not exact in bf16: three products
    (64, True, 0, True),      # direct, exact weight, ring slot
    (128, True, 32, False),   # the 'fast' chunk means
    (100, True, 32, True),    # means of the direct form, ring slot
])
def test_rms_desired_matches_pallas(w, transposed, mean_chunk, ring):
    B, T, S, idx = 8, 256, 3, 2
    x = signal((S, B, T) if ring else (B, T), seed=8)
    band = rms_band(w)
    exact = band_is_exact_bf16(band)
    assert exact == jrms.band_is_exact_bf16(jfir.band_matrix(np.full(w, 1.0 / w, np.float32)))
    lp, rp = w // 2, w - 1 - w // 2
    kw = dict(transposed=transposed, mean_chunk=mean_chunk,
              ring_idx=idx if ring else None)
    got = rms_desired(torch.from_numpy(x), band, lp, rp, 0.1, 10.0, exact, **kw)
    want = jrms.rms_desired_pallas(jnp.asarray(x), jnp.asarray(band.numpy()), lp, rp,
                                   0.1, 10.0, exact, interpret=True, **kw)
    check(f"K5 w={w} transposed={transposed} mc={mean_chunk} ring={ring}",
          got.numpy(), np.asarray(want), CONV_DB)


@pytest.mark.parametrize("vector,transposed", [(False, False), (True, True)])
def test_rms_desired_plain_sqrt_correctly_rounded(vector, transposed):
    """The plain K5's sqrt is the correctly rounded f32 sqrt, as the kernel's
    __fsqrt_rn (torch's f32 sqrt on the CPU is not): over 102 400 samples of
    a one-sample window, whose window sum is the exact f32 hi + lo of x², d
    equals a numpy float32 replica (np.sqrt on f32 rounds correctly) bit for
    bit: 0 ulp."""
    B, T = 25, 4096
    x = (np.random.default_rng(21).standard_normal((B, T))
         * np.logspace(-3, 0, B)[:, None]).astype(np.float32)
    t = np.linspace(0.05, 0.3, B).astype(np.float32) if vector else np.float32(0.1)
    m = np.full(B, 1e30, np.float32) if vector else np.float32(1e30)
    hi, lo = split_bf16(torch.from_numpy(x * x))
    s = hi.float().numpy() + lo.float().numpy()  # exact: the halves do not overlap
    rms = np.sqrt(s)
    tt = t[:, None] if vector else t
    want = np.minimum(np.maximum(tt / (rms + np.float32(1e-10)), np.float32(0)),
                      m[:, None] if vector else m).astype(np.float32)
    got = rms_desired_plain(torch.from_numpy(x), rms_band(1), 0, 0,
                            torch.from_numpy(t) if vector else float(t),
                            torch.from_numpy(m) if vector else float(m), True,
                            transposed=transposed).numpy()
    if transposed:
        got = got.T
    n = int(np.sum(got.view(np.uint32) != want.view(np.uint32)))
    print(f"K5 plain sqrt: {n} of {got.size} values differ from the correctly "
          f"rounded replica, {ulps(got, want)} ulp (bound 0)")
    assert n == 0


def test_rms_desired_checks():
    x, band = torch.zeros(4, 256), rms_band(128)
    with pytest.raises(ValueError, match="mean_chunk"):
        rms_desired(x, band, 64, 63, 0.1, 10.0, True, mean_chunk=32)
    with pytest.raises(ValueError, match="multiple of 128"):
        rms_desired(torch.zeros(4, 200), band, 64, 63, 0.1, 10.0, True)
    with pytest.raises(ValueError, match="pads"):
        rms_desired(x, band, 64, 64, 0.1, 10.0, True)
    with pytest.raises(ValueError, match=r"target must be a scalar or a \[4\]"):
        rms_desired(x, band, 64, 63, torch.full((3,), 0.1), 10.0, True)


# ---------------------------------------------------------------- K6


def _apply_both(d, x, init, **kw):
    got = smooth_gain_apply(torch.from_numpy(d), torch.from_numpy(x), A_ATT,
                            A_REL, 10.0,
                            init=None if init is None else torch.from_numpy(init),
                            out_clip=0.99, **kw)
    want = jscan.smooth_gain_apply_pallas(
        jnp.asarray(d), jnp.asarray(x), A_ATT, A_REL, 10.0,
        init=None if init is None else jnp.asarray(init), out_clip=0.99,
        interpret=True, **kw)
    return got, want


@pytest.mark.parametrize("use_init", [False, True])
def test_smooth_gain_apply_exact_pair_ring(use_init):
    """Exact recurrence over a ring slot: y and the carry ≤ −130 dB against
    the Pallas kernel; the bf16-pair store is `split_bf16` of the f32 y, bit
    for bit, in the port and (with a carry) in the Pallas kernel."""
    B, T, S, idx = 1024, 256, 2, 1
    x = signal((S, B, T), seed=9)
    d = np.ascontiguousarray(desired((B, T), seed=10).T)
    init = np.random.default_rng(11).uniform(0.2, 6.0, B).astype(np.float32) \
        if use_init else None
    (y, carry), (jy, jcarry) = _apply_both(d, x, init, ring_idx=idx)
    check(f"K6 exact init={use_init} y", y.numpy(), np.asarray(jy), EXACT_DB)
    check(f"K6 exact init={use_init} carry", carry.numpy(), np.asarray(jcarry), EXACT_DB)
    (yh, yl), carry_p = smooth_gain_apply(
        torch.from_numpy(d), torch.from_numpy(x), A_ATT, A_REL, 10.0,
        init=None if init is None else torch.from_numpy(init), emit_split=True,
        ring_idx=idx)
    sh, sl = split_bf16(y)
    assert torch.equal(yh, sh) and torch.equal(yl, sl) and torch.equal(carry_p, carry)
    if use_init:
        (jh, jl), _ = jscan.smooth_gain_apply_pallas(
            jnp.asarray(d), jnp.asarray(x), A_ATT, A_REL, 10.0,
            init=jnp.asarray(init), out_clip=0.99, interpret=True,
            emit_split=True, ring_idx=idx)
        wh, wl = split_bf16(torch.from_numpy(np.asarray(jy)))
        assert np.array_equal(np.asarray(jh.astype(jnp.float32)), wh.float().numpy())
        assert np.array_equal(np.asarray(jl.astype(jnp.float32)), wl.float().numpy())


@pytest.mark.parametrize("d_is_means", [False, True])
def test_smooth_gain_apply_blockwise(d_is_means):
    """'fast' mode: the chunk means reduced in the kernel or handed in, the
    compounded alphas, the ramp; with and without a carry."""
    B, T = 1024, 256
    x = signal((B, T), seed=12)
    d = desired((B, T), seed=13)
    if d_is_means:  # the chunk means K5 would emit, time-major
        d = np.ascontiguousarray(d.reshape(B, T // 32, 32).mean(-1).T)
    else:
        d = np.ascontiguousarray(d.T)
    for init in (None, np.random.default_rng(14).uniform(0.2, 6.0, B).astype(np.float32)):
        (y, carry), (jy, jcarry) = _apply_both(d, x, init, blockwise=32,
                                               d_is_means=d_is_means)
        tag = f"K6 blockwise means={d_is_means} init={init is not None}"
        check(f"{tag} y", y.numpy(), np.asarray(jy), EXACT_DB)
        check(f"{tag} carry", carry.numpy(), np.asarray(jcarry), EXACT_DB)


@pytest.mark.parametrize("use_init", [False, True])
def test_smooth_gain_apply_small_batch_vs_scan(use_init):
    """At B = 8 (below the Pallas tile) against the identity the JAX kernel
    documents: scan, clip, apply (`agc_scan.py:398-402`)."""
    B, T = 8, 300
    x = signal((B, T), seed=15)
    d = desired((B, T), seed=16)
    init = np.linspace(0.5, 4.0, B).astype(np.float32) if use_init else None
    y, carry = smooth_gain_apply(torch.from_numpy(np.ascontiguousarray(d.T)),
                                 torch.from_numpy(x), A_ATT, A_REL, 10.0,
                                 init=None if init is None else torch.from_numpy(init),
                                 out_clip=0.99)
    g = jagc.smooth_gain_scan(jnp.asarray(d), A_ATT, A_REL,
                              None if init is None else jnp.asarray(init))
    g = jnp.clip(g, 0.1, 10.0)
    check("K6 B=8 y", y.numpy(), np.asarray(jnp.clip(jnp.asarray(x) * g, -0.99, 0.99)),
          EXACT_DB)
    check("K6 B=8 carry", carry.numpy(), np.asarray(g[:, -1]), EXACT_DB)


def test_smooth_gain_apply_checks():
    d, x = torch.ones(256, 4), torch.zeros(4, 256)
    with pytest.raises(ValueError, match="requires blockwise"):
        smooth_gain_apply(d, x, 0.1, 0.01, 10.0, d_is_means=True)
    with pytest.raises(ValueError, match="must divide 128"):
        smooth_gain_apply(d, x, 0.1, 0.01, 10.0, blockwise=48)
    with pytest.raises(ValueError, match="x must be"):
        smooth_gain_apply(d, torch.zeros(4, 128), 0.1, 0.01, 10.0)
    with pytest.raises(ValueError, match=r"a_att must be a scalar or a \[4\]"):
        smooth_gain_apply(d, x, torch.full((5,), 0.1), 0.01, 10.0)


# ---------------------------------------------------------------- K8 / K7


def _pair(v):
    return split_bf16(torch.from_numpy(v))


def _jpair(hl):
    return tuple(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in hl)


def _bits(t) -> np.ndarray:
    return np.asarray(t).view(np.uint16) if not isinstance(t, torch.Tensor) \
        else t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("T,n,tail_w", [
    (256, 129, "k_pad"),   # the C8 geometry at a small block
    (256, 129, "n-1"),     # a narrow tail, zero-padded to k_pad
    (128, 300, "k_pad"),   # k_pad = 384 > T: the next tail reaches into the old one
])
def test_fir_td_mxu_pair_matches_pallas(T, n, tail_w):
    B = 8
    rng = np.random.default_rng(17)
    h = (rng.standard_normal(n) * 0.1).astype(np.float32)
    kp = ring_k_pad(n)
    width = kp if tail_w == "k_pad" else n - 1
    x = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    tail = (rng.standard_normal((B, width)) * 0.3).astype(np.float32)
    xp, tp = _pair(x), _pair(tail)
    y, th, tl = fir_td_mxu_pair(*xp, *tp, torch.from_numpy(h))
    jy, jth, jtl = jfir.fir_td_mxu_pair(*_jpair(xp), *_jpair(tp), jfir.band_matrix(h),
                                        interpret=True, emit_tail=True)
    check(f"K8 T={T} n={n} tail={tail_w}", y.numpy(), np.asarray(jy), CONV_DB)
    assert th.shape == (B, kp)
    assert np.array_equal(_bits(th), _bits(jth)) and np.array_equal(_bits(tl), _bits(jtl))
    # equal to the f32 conv K1 on concat(tail, x) when the pairs split f32
    from afp_tpu_torch.ops.cuda import fir_td_mxu
    ext = np.concatenate([tail[:, width - (n - 1):], x], axis=-1)
    assert torch.equal(y, fir_td_mxu(torch.from_numpy(ext), torch.from_numpy(h)))


def test_fir_td_mxu_pair_to_ring_equals_k8():
    """K7 writes K8's output, bit for bit, into its slot (clip and dither
    on), leaves the other slots as they were, and emits K8's tail; against
    the Pallas K7 (dither off) ≤ −110 dB."""
    B, T, n, S, idx = 8, 256, 129, 3, 1
    rng = np.random.default_rng(18)
    h = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    xp = _pair((rng.standard_normal((B, T)) * 0.3).astype(np.float32))
    tp = _pair((rng.standard_normal((B, ring_k_pad(n))) * 0.3).astype(np.float32))
    ring0 = torch.from_numpy((rng.standard_normal((S, B, T))).astype(np.float32))
    dkw = dict(out_clip=0.2, dither_key=(3, 5), dither_bits=16, dither_tpdf=True)
    out, th, tl = fir_td_mxu_pair_to_ring(*xp, *tp, h, idx, ring0.clone(), **dkw)
    y, kh, kl = fir_td_mxu_pair_plain(*xp, *tp, h, **dkw)
    assert torch.equal(out[idx], y) and torch.equal(th, kh) and torch.equal(tl, kl)
    assert all(torch.equal(out[s], ring0[s]) for s in range(S) if s != idx)
    out, _, _ = fir_td_mxu_pair_to_ring(*xp, *tp, h, idx, ring0.clone(), out_clip=0.2)
    jout, jth, _ = jfir.fir_td_mxu_pair_to_ring(
        *_jpair(xp), *_jpair(tp), jfir.band_matrix(h.numpy()), idx,
        jnp.asarray(ring0.numpy()), interpret=True, out_clip=0.2, emit_tail=True)
    check("K7 vs Pallas", out[idx].numpy(), np.asarray(jout)[idx], CONV_DB)
    assert np.array_equal(_bits(th), _bits(jth))


def test_pair_checks():
    h = torch.ones(129)
    x = split_bf16(torch.zeros(2, 256))
    with pytest.raises(ValueError, match="tail pair"):
        fir_td_mxu_pair(*x, *split_bf16(torch.zeros(2, 100)), h)
    with pytest.raises(ValueError, match="bfloat16"):
        fir_td_mxu_pair(torch.zeros(2, 256), x[1], *split_bf16(torch.zeros(2, 256)), h)
    with pytest.raises(ValueError, match="out_ring"):
        fir_td_mxu_pair_to_ring(*x, *split_bf16(torch.zeros(2, 256)), h, 0,
                                torch.zeros(2, 2, 128))
