"""K5's summation order on the CPU: `rms_desired_model` (the plain float32
model of `csrc/agc_rms.cu`'s order, which the kernel equals bit for bit on
the card, `tests/test_torch_cuda.py`) against `rms_desired_plain` (float64
window sums rounded once) within the class, ≤ −110 dB, at windows of one
chunk, of four, wider than the block, wider than the kernel's time tile,
not a multiple of 128 (the direct
form) and of one sample; on loud, quiet (amplitude 1e-4), int16
full-scale input and a silent stretch inside a loud row, where a running
difference would cancel.  Also the model's own identities: int16 ≡ f32 of
n/32768, a ring slot ≡ the staged block, [B] vectors ≡ the scalar rows,
and the warp scans against float64 cumulative sums.
"""
import numpy as np
import pytest
import torch

from afp_tpu_torch.ops.cuda import agc_rms as R
from afp_tpu_torch.ops.cuda import fir_td as F

CONV_DB = -110.0  # the model vs the plain version: one summation class


def err_db(a, b) -> float:
    a, b = a.double(), b.double()
    return float(20 * torch.log10((a - b).abs().max() / b.abs().max() + 1e-300))


def block(kind: str, B: int, T: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "int16":
        x = rng.integers(-32768, 32768, (B, T)).astype(np.int16)
        x.reshape(-1)[:2] = (-32768, 32767)
        return torch.from_numpy(x)
    x = rng.standard_normal((B, T)).astype(np.float32) * 0.3
    if kind == "quiet":
        x *= np.float32(1e-4 / 0.3)
    if kind == "silent":
        x[:, T // 4: T // 4 + 300] = 0.0
    return torch.from_numpy(x)


def boxcar(W: int):
    band = F.band_matrix(np.full(W, 1.0 / W, np.float32))
    return band, R.band_is_exact_bf16(band), W // 2, W - 1 - W // 2


@pytest.mark.parametrize("kind", ["loud", "quiet", "int16", "silent"])
@pytest.mark.parametrize("W", [128, 512, 384, 1024, 300, 1])
def test_model_vs_plain(W, kind):
    """Every layout: [B, T], [T, B] and the chunk means."""
    # 384: a window wider than the block; 1024: wider than the kernel's
    # 512-output time tile, at a T that is not whole tiles
    T = {384: 256, 1024: 1152}.get(W, 640)
    x = block(kind, 5, T)
    band, exact, lp, rp = boxcar(W)
    mg = 1e4  # the quiet rows' gain (0.1 / 1e-4) stays below the clip
    for kw in (dict(), dict(transposed=True), dict(transposed=True, mean_chunk=32)):
        got = R.rms_desired_model(x, band, lp, rp, 0.1, mg, exact, **kw)
        want = R.rms_desired_plain(x, band, lp, rp, 0.1, mg, exact, **kw)
        e = err_db(got, want)
        print(f"W={W} {kind} {kw}: {e:.1f} dB")
        assert got.shape == want.shape and e <= CONV_DB
        assert bool((got < mg).any())  # not every gain clipped


@pytest.mark.parametrize("W", [128, 512, 300])
def test_model_identities(W):
    """int16 ≡ f32 of n/32768, a ring slot ≡ the staged block, [B] vectors
    ≡ the scalar runs row by row: bit for bit."""
    band, exact, lp, rp = boxcar(W)
    x16 = block("int16", 4, 384, seed=1)
    kw = dict(transposed=True)
    d = R.rms_desired_model(x16, band, lp, rp, 0.1, 10.0, exact, **kw)
    assert torch.equal(d, R.rms_desired_model(F.pcm16_to_f32(x16), band, lp, rp,
                                              0.1, 10.0, exact, **kw))
    ring = torch.stack([block("loud", 4, 384, seed=2), F.pcm16_to_f32(x16)])
    assert torch.equal(d, R.rms_desired_model(ring, band, lp, rp, 0.1, 10.0, exact,
                                              ring_idx=1, **kw))
    t, mg = torch.tensor([0.05, 0.1, 0.2, 0.3]), torch.tensor([4.0, 10.0, 10.0, 20.0])
    dv = R.rms_desired_model(x16, band, lp, rp, t, mg, exact, **kw)
    for b in range(4):
        ds = R.rms_desired_model(x16, band, lp, rp, float(t[b]), float(mg[b]), exact,
                                 **kw)
        assert torch.equal(dv[:, b], ds[:, b])


def test_lane_scans_are_chunk_sums():
    """The warp scans: P[r] the sum of positions < r, S[r] of positions ≥ r,
    the total of all 128, each within a few ulp of float64 (every term is
    non-negative), and P[0] exactly 0."""
    v = block("loud", 3, 4 * 128).reshape(3, 4, 128) ** 2
    p, s, tot = R._lane_scans(v)
    cum = torch.cumsum(v.double(), -1)
    want_p = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], -1)
    want_s = cum[..., -1:] - want_p
    assert bool((p[..., 0] == 0).all())
    for got, want in ((p, want_p), (s, want_s), (tot, cum[..., -1])):
        rel = ((got.double() - want).abs() / want.clamp_min(1e-30)).max()
        assert float(rel) < 16 * 2.0 ** -24
