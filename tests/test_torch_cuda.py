"""The port's CUDA kernels against their plain versions on the card, at
edge shapes the smoke's headline run does not reach: ragged time tiles,
masked batch rows, one tap, k_pad > T, n_steps > S, an unaligned dither
buffer; for the AGC kernels, a window wider than the block, batches that
fill no tile, a block that is not whole recurrence chunks; for the
transport forms, K12/K13 at those shapes, int16 extremes, the int16 store
at rounding ties, and K5/K6 on int16 x; for the per-stream banks, K10 and
the banked K3/K4/K12 at assignment tiles of 8 rows and of a whole 6-row
batch with up to 8 designs, K11 with 1 and 9 bands over 12 rows, and the
[B] vectors of K5/K6; for the last three kernels, K15's HIGHEST K1 and K11
at those shapes (B3F/B3C ≡ B3), K14 over f32, int16, pair and ring-slot
input with and without the carry, on batches that fill no block, K9 in
every layout, `apply_agc` on the card, and the offline fold ≡ the scan;
for the tensor-core K11, both precisions over tap counts around its
k-steps, 1 to 40 bands and ragged batches, rows alone ≡ in the batch, the
band tiles card ≡ CPU and the per-stream fold ≡ the scan; C8's kernels
at batch 8 after the caching allocator was poisoned with NaN; and for the
tensor-core conv body, K1 ≡ K11 with one band at gain 1.0 at both
precisions, the bank option with two designs in every m16 tile, and K1, K3
and K8 at tap counts around the accumulation and window chunks and the
k-step edges; for the chunk-scan K5, its output ≡ `rms_desired_model` bit
for bit in every layout at time tiles that are not whole, at 1, 5, 33 and
4096 rows and windows wider than the block, and for the two-role K6, the
branch at d == g and one ulp either side, both gain clips, T of one chunk,
part chunks and runs that are not whole, in exact mode and blockwise with
chunks of 1, 32 and 128; for the role-split K14 and K9, the edges of
their barrier protocols (one chunk, fewer chunks than window warps, a
reused d slot, h = 8, one stream, a block and one more, the C8 batch),
unaligned views (the 4-byte paths), a silent and a near-silent row, and
the first step at, above and below the start value; and for the CLI
slice, `process_frames` with pinned staging ≡ a Pipeline fed pageable
blocks, the chunked upload ≡ one shot, a checkpoint round trip on the
card, and `python -m afp_tpu_torch devices`; and for the multirate
slice, `upfirdn`, `resample_poly` and `PolyResampler` on the card ≡ the
CPU's (cuFFT against torch's CPU FFT, ≤ −100 dB) at every ratio, the
literal chain and the compat ASRC on the card ≡ their CPU runs, the
exact frontend on the card chunked ≡ one shot bit for bit, and the
'parallel' AGC route on the card ≡ the exact route; and for the
per-listener EQ farm, K11's pair forms against their plain twins, the
per-stream AGC ring ≡ the staged steps (at the served cell's shape too),
and its counted operations against the profiler's.
Marked
``cuda``: they skip without a CUDA device.  The card's machine has no jax,
so run them there without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from afp_tpu_torch.ops import agc as A
from afp_tpu_torch.ops.cuda import agc_fused as K14
from afp_tpu_torch.ops.cuda import agc_rms as R
from afp_tpu_torch.ops.cuda import agc_scan as S
from afp_tpu_torch.ops.cuda import dither_cuda
from afp_tpu_torch.ops.cuda import fir_td as F
from afp_tpu_torch.ops.dither import dither_plain

pytestmark = pytest.mark.cuda

CONV_DB = -110.0  # kernel vs plain: the bf16×3 accumulation-order class
EPI = dict(out_clip=0.3, dither_key=(9, 4), dither_bits=16, dither_tpdf=True)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def err_db(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(20 * torch.log10((a - b).abs().max() / b.abs().max() + 1e-300))


def randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev) * 0.3


@pytest.mark.parametrize("B,T,n", [(5, 384, 31), (1, 128, 1), (3, 640, 2),
                                   (7, 256, 300), (4, 1024, 1151)])
def test_k1_vs_plain(dev, B, T, n):
    x, h = randn(dev, B, n - 1 + T), randn(dev, n, seed=1)
    y = F.fir_td_mxu(x, h)
    e = err_db(y, F.fir_td_mxu_plain(x, h))
    print(f"K1 B={B} T={T} n={n}: {e:.1f} dB")
    assert y.shape == (B, T) and e <= CONV_DB
    assert torch.equal(F.fir_td_mxu(x, h, **EPI), F._finish(y, 0.3, (9, 4), 16, True))


@pytest.mark.parametrize("B,T,n,S,idx", [(5, 128, 300, 3, 2), (2, 384, 129, 1, 0)])
def test_k3_vs_plain_and_k1(dev, B, T, n, S, idx):
    """The conv against the plain version (no clip or dither: the bound is
    relative to the unclipped peak); the fused epilogue bit-exact; a ring
    step ≡ the staged K1 step on concat(tail, slot)."""
    ring, h = randn(dev, S, B, T), randn(dev, n, seed=1)
    tail = randn(dev, B, F.ring_k_pad(n), seed=2)
    out, nt = F.fir_td_mxu_ring_f32(ring, idx, tail, h, torch.zeros_like(ring))
    pout, pnt = F.fir_td_mxu_ring_f32_plain(ring, idx, tail, h, torch.zeros_like(ring))
    e = err_db(out[idx], pout[idx])
    print(f"K3 B={B} T={T} n={n} k_pad={tail.shape[1]}: {e:.1f} dB")
    assert e <= CONV_DB and torch.equal(nt, pnt)
    oe, _ = F.fir_td_mxu_ring_f32(ring, idx, tail, h, torch.zeros_like(ring), **EPI)
    assert torch.equal(oe[idx], F._finish(out[idx], 0.3, (9, 4), 16, True))
    ext = torch.cat([tail, ring[idx]], dim=-1)[:, tail.shape[1] - (n - 1):]
    assert torch.equal(oe[idx], F.fir_td_mxu(ext.contiguous(), h, **EPI))


@pytest.mark.parametrize("S,start,steps", [(3, 2, 7), (4, 0, 4), (2, 1, 1)])
def test_k4_vs_plain_and_chained_k3(dev, S, start, steps):
    """As K3, over a dispatch; the last step to reach a slot writes it."""
    B, T, n = 6, 128, 300  # k_pad 384 > T: history spans earlier slots
    ring, h = randn(dev, S, B, T), randn(dev, n, seed=1)
    tail = randn(dev, B, F.ring_k_pad(n), seed=2)
    out, nt = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h,
                                         torch.zeros_like(ring), steps)
    pout, pnt = F.fir_td_mxu_ring_mega_f32_plain(ring, start, tail, h,
                                                 torch.zeros_like(ring), steps)
    e = err_db(out, pout)
    print(f"K4 S={S} start={start} steps={steps}: {e:.1f} dB")
    assert e <= CONV_DB and torch.equal(nt, pnt)
    oe, _ = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h,
                                       torch.zeros_like(ring), steps, **EPI)
    last = {(start + i) % S: i for i in range(steps)}
    assert all(torch.equal(oe[s], F._finish(out[s], 0.3, (9, 4 + i), 16, True))
               for s, i in last.items())
    ck, ct = torch.zeros_like(ring), tail
    for i in range(steps):
        ck, ct = F.fir_td_mxu_ring_f32(ring, (start + i) % S, ct, h, ck,
                                       **{**EPI, "dither_key": (9, 4 + i)})
    assert torch.equal(ck, oe) and torch.equal(ct, nt)


@pytest.mark.parametrize("numel,offset", [(4096, 0), (1001, 0), (1001, 1)])
def test_k2_vs_plain(dev, numel, offset):
    """Bit-exact, including a length not a multiple of 4 and a buffer not
    16-byte aligned (the scalar path)."""
    x = randn(dev, numel + offset)[offset:]
    for kind in ("tpdf", "rpdf"):
        assert torch.equal(dither_cuda(x, (2, 3), 20, kind),
                           dither_plain(x, (2, 3), 20, kind))


@pytest.mark.parametrize("B,T,W,transposed,mean_chunk", [
    (5, 256, 384, True, 0),     # two-level window wider than the block
    (13, 128, 300, False, 0),   # direct, 1/300 not exact in bf16, W > T
    (3, 384, 100, True, 32),    # chunk means, batch below one row tile
    (9, 640, 1, False, 0),      # one-sample window
])
def test_k5_vs_plain(dev, B, T, W, transposed, mean_chunk):
    x = randn(dev, B, T)
    x[0] *= 10.0
    band = F.band_matrix(np.full(W, 1.0 / W, np.float32)).to(dev)
    exact = R.band_is_exact_bf16(band.cpu())
    lp, rp = W // 2, W - 1 - W // 2
    kw = dict(transposed=transposed, mean_chunk=mean_chunk)
    d = R.rms_desired(x, band, lp, rp, 0.1, 10.0, exact, **kw)
    e = err_db(d, R.rms_desired_plain(x, band, lp, rp, 0.1, 10.0, exact, **kw))
    print(f"K5 B={B} T={T} W={W} {kw}: {e:.1f} dB")
    assert e <= CONV_DB
    ring = torch.stack([randn(dev, B, T, seed=3), x])
    assert torch.equal(R.rms_desired(ring, band, lp, rp, 0.1, 10.0, exact,
                                     ring_idx=1, **kw), d)


@pytest.mark.parametrize("B,T,blockwise", [(45, 200, None), (7, 96, 32),
                                           (33, 384, 32)])
def test_k6_vs_plain(dev, B, T, blockwise):
    """Bit-exact: the f32 and pair stores, with and without a carry; a
    block that is not whole 128-step chunks and batches that fill no
    32-stream block."""
    x = randn(dev, B, T)
    d = (torch.rand(T, B, generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev) * 6.0 + 0.1)
    init = torch.linspace(0.2, 8.0, B, device=dev)
    for kw in (dict(init=None), dict(init=init), dict(init=init, emit_split=True)):
        a = S.smooth_gain_apply(d, x, 0.3, 0.02, 10.0, blockwise=blockwise, **kw)
        b = S.smooth_gain_apply_plain(d, x, 0.3, 0.02, 10.0, blockwise=blockwise, **kw)
        (ya, ca), (yb, cb) = a, b
        assert torch.equal(ca, cb)
        if isinstance(ya, tuple):
            assert all(torch.equal(u, v) for u, v in zip(ya, yb))
        else:
            assert torch.equal(ya, yb)
    y0, _ = S.smooth_gain_apply(d, x, 0.3, 0.02, 10.0, blockwise=blockwise)
    y1, _ = S.smooth_gain_apply(d, x, 0.3, 0.02, 10.0, init=init, blockwise=blockwise)
    assert not torch.equal(y0, y1)  # the carry reaches the output


@pytest.mark.parametrize("B,T,W,dtype", [
    (1, 1152, 512, torch.float32),   # a time tile and one more chunk
    (5, 256, 384, torch.float32),    # the window wider than the block
    (37, 1152, 1024, torch.float32),  # wider than the 512-output time tile
    (33, 1152, 128, torch.int16),    # a block of 32 streams and one more
    (4096, 2048, 512, torch.float32),  # the C8 point
    (33, 640, 300, torch.float32),   # direct form
    (5, 384, 1, torch.int16),        # direct, one sample
])
def test_k5_equals_model(dev, B, T, W, dtype):
    """K5 ≡ `rms_desired_model` bit for bit in all three layouts (the
    kernel's summation order, modelled in plain float32 on the CPU), and
    ≤ −110 dB against the plain version."""
    x = randn(dev, B, T)
    x[0] *= 10.0
    if dtype == torch.int16:
        x = torch.clamp(torch.round(x * 32768), -32768, 32767).to(torch.int16)
    band = F.band_matrix(np.full(W, 1.0 / W, np.float32)).to(dev)
    exact = R.band_is_exact_bf16(band.cpu())
    lp, rp = W // 2, W - 1 - W // 2
    for kw in (dict(), dict(transposed=True), dict(transposed=True, mean_chunk=32)):
        d = R.rms_desired(x, band, lp, rp, 0.1, 10.0, exact, **kw).cpu()
        want = R.rms_desired_model(x.cpu(), band.cpu(), lp, rp, 0.1, 10.0, exact, **kw)
        e = err_db(d, R.rms_desired_plain(x, band, lp, rp, 0.1, 10.0, exact, **kw))
        nd = int((d != want).sum())
        print(f"K5 B={B} T={T} W={W} {dtype} {kw}: {nd} differ from the model, "
              f"{e:.1f} dB vs plain")
        assert nd == 0 and e <= CONV_DB


@pytest.mark.parametrize("B,T,blockwise", [
    (1, 128, None), (33, 200, None), (4096, 128, None), (33, 101, None),
    (1, 128, 1), (33, 200, 1), (33, 256, 32), (4096, 256, 128)])
def test_k6_edges(dev, B, T, blockwise):
    """K6 bit-exact to its plain version where the step's branch and the
    clips are on edge: d[0] == the carry exactly and one ulp either side,
    gains beyond max_gain and below 0.1; T of one chunk, of a part chunk and
    not whole 8-sample runs (the scalar apply), batches of one stream, of a
    block and one more, and the C8 batch; exact and blockwise with chunks
    of 1, 32 and 128; f32 and pair stores, with and without the carry."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = randn(dev, B, T) * 3.0
    d = torch.exp(torch.rand(T, B, generator=g, device=dev) * 8.0 - 4.5)  # 0.01 .. 30
    init = torch.exp(torch.rand(B, generator=g, device=dev) * 5.0 - 3.0)
    k = torch.arange(B, device=dev) % 3
    d[0] = torch.where(k == 0, init, torch.where(
        k == 1, torch.nextafter(init, torch.full_like(init, 1e9)),
        torch.nextafter(init, torch.zeros_like(init))))
    if blockwise:
        d[1:blockwise] = d[0]  # the first chunk mean ties the carry too
    cases = [dict(init=init), dict(init=init, emit_split=True), dict(init=None)]
    if blockwise == 32:
        dm = torch.stack([S._chunk_mean(d[c: c + 32]) for c in range(0, T, 32)])
        cases.append(dict(init=init, d_is_means=True, d=dm))
    for kw in cases:
        dd = kw.pop("d", d)
        a = S.smooth_gain_apply(dd, x, 0.3, 0.02, 10.0, blockwise=blockwise, **kw)
        b = S.smooth_gain_apply_plain(dd, x, 0.3, 0.02, 10.0, blockwise=blockwise, **kw)
        (ya, ca), (yb, cb) = a, b
        assert torch.equal(ca, cb)
        if isinstance(ya, tuple):
            assert all(torch.equal(u, v) for u, v in zip(ya, yb))
        else:
            assert torch.equal(ya, yb)
    assert bool((d > 10.0).any()) and bool((d < 0.1).any())  # both clips reached


@pytest.mark.parametrize("B,T,n", [(6, 128, 300), (5, 256, 129), (1, 384, 2)])
def test_k8_k7_vs_plain(dev, B, T, n):
    """k_pad > T (the next tail reaches into the old one) and ragged last
    row tiles: the conv ≤ −110 dB, the tail bit-exact, K7's slot ≡ K8."""
    h = randn(dev, n, seed=1)
    xh, xl = F.split_bf16(randn(dev, B, T))
    th, tl = F.split_bf16(randn(dev, B, F.ring_k_pad(n), seed=2))
    y, nh, nl = F.fir_td_mxu_pair(xh, xl, th, tl, h)
    yp, ph, pl = F.fir_td_mxu_pair_plain(xh, xl, th, tl, h)
    e = err_db(y, yp)
    print(f"K8 B={B} T={T} n={n}: {e:.1f} dB")
    assert e <= CONV_DB and torch.equal(nh, ph) and torch.equal(nl, pl)
    ye, _, _ = F.fir_td_mxu_pair(xh, xl, th, tl, h, **EPI)
    assert torch.equal(ye, F._finish(y, 0.3, (9, 4), 16, True))
    out = torch.full((3, B, T), 5.0, device=dev)
    out, rh, rl = F.fir_td_mxu_pair_to_ring(xh, xl, th, tl, h, 2, out, **EPI)
    assert torch.equal(out[2], ye) and torch.equal(rh, nh) and torch.equal(rl, nl)
    assert bool((out[:2] == 5.0).all())


def pcm(dev, *shape, seed=0):
    """int16 PCM on the card reaching both ends of the range."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-32768, 32768, shape, generator=g, device=dev,
                      dtype=torch.int32).to(torch.int16)
    x.view(-1)[:2] = torch.tensor([-32768, 32767], dtype=torch.int16, device=dev)
    return x


@pytest.mark.parametrize("B,T,n,S,start,steps", [
    (5, 384, 31, 2, 1, 1),     # ragged time tile, masked rows
    (6, 128, 300, 3, 2, 7),    # k_pad > T, n_steps > S
    (3, 640, 129, 4, 0, 4),
])
def test_k12_vs_plain_and_k3(dev, B, T, n, S, start, steps):
    """K12 (and its mega form) against the plain version: ≤ −110 dB, the
    int16 tail bit-exact; ≡ K3/K4 on n/32768 bit for bit, int16 store and
    dither on."""
    ring, h = pcm(dev, S, B, T), randn(dev, n, seed=1)
    tail = pcm(dev, B, F.ring_k_pad(n), seed=2)
    z = torch.zeros((S, B, T), device=dev)
    out, nt = F.fir_td_mxu_ring_mega_pcm16(ring, start, tail, h, z.clone(), steps)
    pout, pnt = F.fir_td_mxu_ring_mega_pcm16_plain(ring, start, tail, h,
                                                   z.clone(), steps)
    e = err_db(out, pout)
    print(f"K12 mega B={B} T={T} n={n} S={S} steps={steps}: {e:.1f} dB")
    assert e <= CONV_DB and torch.equal(nt, pnt) and nt.dtype == torch.int16
    o1, t1 = F.fir_td_mxu_ring_pcm16(ring, start, tail, h, z.clone())
    p1, q1 = F.fir_td_mxu_ring_pcm16_plain(ring, start, tail, h, z.clone())
    assert err_db(o1, p1) <= CONV_DB and torch.equal(t1, q1)
    z16 = torch.zeros((S, B, T), dtype=torch.int16, device=dev)
    a, at = F.fir_td_mxu_ring_mega_pcm16(ring, start, tail, h, z16.clone(),
                                         steps, **EPI)
    b, bt = F.fir_td_mxu_ring_mega_f32(F.pcm16_to_f32(ring), start,
                                       F.pcm16_to_f32(tail), h, z16.clone(),
                                       steps, **EPI)
    assert torch.equal(a, b) and torch.equal(F.pcm16_to_f32(at), bt)


@pytest.mark.parametrize("B,T,n,S,start,steps", [
    (5, 384, 31, 2, 1, 1), (6, 128, 300, 3, 2, 7), (1, 256, 2, 2, 1, 3)])
def test_k13_vs_plain_k3_and_k7(dev, B, T, n, S, start, steps):
    """K13 (and its mega form) against the plain version: ≤ −110 dB, the
    pair tail bit-exact; K13 on split(ring) ≡ K3/K4 on ring and a K13 step
    ≡ K7 on the slot's views, bit for bit, dither on."""
    ring, h = randn(dev, S, B, T), randn(dev, n, seed=1)
    tail = randn(dev, B, F.ring_k_pad(n), seed=2)
    (rh, rl), (th, tl) = F.split_bf16(ring), F.split_bf16(tail)
    z = torch.zeros((S, B, T), device=dev)
    out, nh, nl = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h, z.clone(), steps)
    pout, ph, pl = F.fir_td_mxu_ring_mega_plain(rh, rl, start, th, tl, h,
                                                z.clone(), steps)
    e = err_db(out, pout)
    print(f"K13 mega B={B} T={T} n={n} S={S} steps={steps}: {e:.1f} dB")
    assert e <= CONV_DB and torch.equal(nh, ph) and torch.equal(nl, pl)
    a, ah, al = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h, z.clone(),
                                       steps, **EPI)
    b, bt = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, z.clone(), steps,
                                       **EPI)
    assert torch.equal(a, b)
    assert all(torch.equal(u, v) for u, v in zip((ah, al), F.split_bf16(bt)))
    s1, h1, l1 = F.fir_td_mxu_ring(rh, rl, start, th, tl, h, z.clone(), **EPI)
    s7, h7, l7 = F.fir_td_mxu_pair_to_ring(rh[start], rl[start], th, tl, h,
                                           start, z.clone(), **EPI)
    assert torch.equal(s1, s7) and torch.equal(h1, h7) and torch.equal(l1, l7)


def test_int16_store_at_ties_and_full_scale(dev):
    """One unit tap, so y is x where x splits exactly: the int16 store of
    K1, K3 and K8 at values of y·32768 exactly ±k+0.5 (half to even) and
    beyond ±full scale ≡ quantize_pcm16 of the same kernel's f32 output,
    bit for bit."""
    k = torch.arange(-256, 256, device=dev, dtype=torch.float32)
    y = torch.cat([(k + 0.5) / 32768.0, torch.tensor(
        [32767.5 / 32768, -32768.5 / 32768, 1.5, -1.5, 1.0, -1.0, 0.0],
        device=dev)])
    T = 1024
    x = torch.zeros(4, T, device=dev)
    x.view(-1)[: y.numel()] = y
    h = torch.ones(1, device=dev)
    yk = F.fir_td_mxu(x, h)
    assert torch.equal(yk.view(-1)[:512], x.view(-1)[:512])  # the ties
    assert torch.equal(F.fir_td_mxu(x, h, emit_i16=True), F.quantize_pcm16(yk))
    tail = torch.zeros(4, 128, device=dev)
    ring = x[None].contiguous()
    yr, _ = F.fir_td_mxu_ring_f32(ring, 0, tail, h, torch.zeros_like(ring))
    qr, _ = F.fir_td_mxu_ring_f32(ring, 0, tail, h, torch.zeros(
        1, 4, T, dtype=torch.int16, device=dev))
    assert torch.equal(qr, F.quantize_pcm16(yr))
    xh, xl = F.split_bf16(x)
    th, tl = F.split_bf16(tail)
    yp = F.fir_td_mxu_pair(xh, xl, th, tl, h)[0]
    assert torch.equal(F.fir_td_mxu_pair(xh, xl, th, tl, h, emit_i16=True)[0],
                       F.quantize_pcm16(yp))


@pytest.mark.parametrize("B,T,W,blockwise", [(5, 256, 384, None), (33, 384, 300, 32)])
def test_k5_k6_int16_x(dev, B, T, W, blockwise):
    """K5 and K6 on an int16 ring slot, the window wider than the block:
    ≡ their f32 form on n/32768 bit for bit; K5 ≤ −110 dB against its
    plain version and K6 bit-exact to its plain version."""
    ring = pcm(dev, 2, B, T)
    band = F.band_matrix(np.full(W, 1.0 / W, np.float32)).to(dev)
    exact = R.band_is_exact_bf16(band.cpu())
    lp, rp = W // 2, W - 1 - W // 2
    d = R.rms_desired(ring, band, lp, rp, 0.1, 10.0, exact, transposed=True,
                      ring_idx=1)
    assert torch.equal(d, R.rms_desired(F.pcm16_to_f32(ring), band, lp, rp, 0.1,
                                        10.0, exact, transposed=True, ring_idx=1))
    e = err_db(d, R.rms_desired_plain(ring, band, lp, rp, 0.1, 10.0, exact,
                                      transposed=True, ring_idx=1))
    print(f"K5 int16 B={B} T={T} W={W}: {e:.1f} dB")
    assert e <= CONV_DB
    init = torch.linspace(0.2, 8.0, B, device=dev)
    kw = dict(init=init, emit_split=True, ring_idx=1, blockwise=blockwise)
    (yh, yl), c = S.smooth_gain_apply(d, ring, 0.3, 0.02, 10.0, **kw)
    (fh, fl), fc = S.smooth_gain_apply(d, F.pcm16_to_f32(ring), 0.3, 0.02, 10.0, **kw)
    (ph, pl), pc = S.smooth_gain_apply_plain(d, ring, 0.3, 0.02, 10.0, **kw)
    assert torch.equal(yh, fh) and torch.equal(yl, fl) and torch.equal(c, fc)
    assert torch.equal(yh, ph) and torch.equal(yl, pl) and torch.equal(c, pc)


def _bank(dev, D, n, B, bt, seed=5):
    bank = randn(dev, D, n, seed=seed)
    assign = ((torch.arange(B // bt, device=dev) * 5 + 1) % D).to(torch.int32)
    return bank, assign


@pytest.mark.parametrize("B,T,n,D,bt", [(16, 640, 129, 8, 8), (6, 384, 300, 2, 6),
                                        (24, 128, 31, 3, 8)])
def test_k10_vs_plain_and_k1(dev, B, T, n, D, bt):
    """Ragged time tiles, masked rows (B = 6), up to 8 designs: K10 ≤ −110
    dB against its plain version, its epilogue bit-exact, and each row ≡
    K1 on its design bit for bit."""
    x = randn(dev, B, n - 1 + T)
    bank, assign = _bank(dev, D, n, B, bt)
    y = F.fir_td_mxu_banked(x, bank, assign)
    e = err_db(y, F.fir_td_mxu_banked_plain(x, bank, assign))
    print(f"K10 B={B} T={T} n={n} D={D} bt={bt}: {e:.1f} dB")
    assert y.shape == (B, T) and e <= CONV_DB
    ye = F.fir_td_mxu_banked(x, bank, assign, **EPI)
    assert torch.equal(ye, F._finish(y, 0.3, (9, 4), 16, True))
    for d in torch.unique(assign).tolist():
        rows = (assign.long().repeat_interleave(bt) == d)
        assert torch.equal(ye[rows], F.fir_td_mxu(x, bank[d], **EPI)[rows])
    assert torch.equal(F.fir_td_mxu_banked(x, bank, assign, emit_i16=True, **EPI),
                       F.quantize_pcm16(ye))


@pytest.mark.parametrize("B,T,n,S,start,steps,bt", [
    (6, 128, 300, 3, 2, 7, 6),     # k_pad > T, n_steps > S, masked rows
    (16, 384, 129, 2, 1, 3, 8)])
def test_banked_rings_vs_plain_and_shared(dev, B, T, n, S, start, steps, bt):
    """The banked K3, K4, K12 and K12-mega against their plain versions,
    and row by row ≡ their shared-taps forms on that row's design (dither
    and clip on), tails bit-exact."""
    D = 3
    bank, assign = _bank(dev, D, n, B, bt)
    kp = F.ring_k_pad(n)
    ringf, tailf = randn(dev, S, B, T), randn(dev, B, kp, seed=2)
    ring16, tail16 = pcm(dev, S, B, T), pcm(dev, B, kp, seed=3)
    rows = assign.long().repeat_interleave(bt)
    for fn, plain, ring, tail, mega in (
            (F.fir_td_mxu_ring_f32, F.fir_td_mxu_ring_f32_plain, ringf, tailf, False),
            (F.fir_td_mxu_ring_mega_f32, F.fir_td_mxu_ring_mega_f32_plain, ringf,
             tailf, True),
            (F.fir_td_mxu_ring_pcm16, F.fir_td_mxu_ring_pcm16_plain, ring16, tail16,
             False),
            (F.fir_td_mxu_ring_mega_pcm16, F.fir_td_mxu_ring_mega_pcm16_plain,
             ring16, tail16, True)):
        args = (start, steps) if mega else (start,)

        def run(f, h, **kw):
            a0 = (ring, args[0], tail, h, torch.zeros(S, B, T, device=dev))
            return f(*a0, *args[1:], **kw)

        out, nt = run(fn, bank, assign=assign)
        pout, pnt = run(plain, bank, assign=assign)
        e = err_db(out, pout)
        print(f"banked {fn.__name__} B={B} T={T} n={n}: {e:.1f} dB")
        assert e <= CONV_DB and torch.equal(nt, pnt)
        oe, _ = run(fn, bank, assign=assign, **EPI)
        for d in torch.unique(assign).tolist():
            se, st = run(fn, bank[d], **EPI)
            assert torch.equal(oe[:, rows == d], se[:, rows == d])
            assert torch.equal(st, nt)


@pytest.mark.parametrize("bad", [3, -1])
def test_banked_design_out_of_range(dev, bad):
    """An assignment entry outside the bank (D = 3) reads no taps: the
    kernel writes those rows NaN (−32768 in the int16 store), as the plain
    version does, and every other row ≡ K1 on its design; the ring forms
    too, tails untouched."""
    B, T, n, S = 16, 384, 129, 2
    bank, _ = _bank(dev, 3, n, B, 8)
    assign = torch.tensor([2, bad], dtype=torch.int32, device=dev)
    x = randn(dev, B, n - 1 + T)
    y = F.fir_td_mxu_banked(x, bank, assign)
    assert torch.isnan(y[8:]).all() and not torch.isnan(y[:8]).any()
    assert torch.equal(y[:8], F.fir_td_mxu(x, bank[2])[:8])
    p = F.fir_td_mxu_banked_plain(x, bank, assign)
    assert torch.equal(torch.isnan(p), torch.isnan(y)) and err_db(y[:8], p[:8]) <= CONV_DB
    y16 = F.fir_td_mxu_banked(x, bank, assign, emit_i16=True)
    assert (y16[8:] == -32768).all()
    assert torch.equal(y16[:8], F.fir_td_mxu(x, bank[2], emit_i16=True)[:8])
    kp = F.ring_k_pad(n)
    ring, tail = randn(dev, S, B, T), randn(dev, B, kp, seed=2)
    out, nt = F.fir_td_mxu_ring_mega_f32(ring, 1, tail, bank,
                                         torch.zeros(S, B, T, device=dev), 3,
                                         assign=assign)
    ref, rt = F.fir_td_mxu_ring_mega_f32(ring, 1, tail, bank[2],
                                         torch.zeros(S, B, T, device=dev), 3)
    assert torch.isnan(out[:, 8:]).all() and torch.equal(out[:, :8], ref[:, :8])
    assert torch.equal(nt, rt)


@pytest.mark.parametrize("B,T,n,K", [(12, 384, 65, 9), (12, 128, 300, 1),
                                     (5, 640, 209, 9)])
def test_k11_vs_plain(dev, B, T, n, K):
    """K11 with one band and with nine, history longer than the block,
    masked rows: ≤ −110 dB against its plain version (every row written),
    the fused epilogue ≡ K11 → clip → K2 → quantize_pcm16 bit for bit."""
    x = randn(dev, B, n - 1 + T)
    kernels = randn(dev, K, n, seed=1) * 0.3
    gains = torch.rand(B, K, generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev) * 2.0
    y = F.fir_td_mxu_per_stream(x, kernels, gains)
    e = err_db(y, F.fir_td_mxu_per_stream_plain(x, kernels, gains))
    print(f"K11 B={B} T={T} n={n} K={K}: {e:.1f} dB")
    assert y.shape == (B, T) and e <= CONV_DB
    assert bool((y.abs().amax(dim=1) > 0).all())
    unfused = dither_cuda(torch.clamp(y, -0.3, 0.3), (9, 4), 16, "tpdf")
    assert torch.equal(F.fir_td_mxu_per_stream(x, kernels, gains, **EPI), unfused)
    assert torch.equal(F.fir_td_mxu_per_stream(x, kernels, gains, emit_i16=True, **EPI),
                       F.quantize_pcm16(unfused))


@pytest.mark.parametrize("precision", ["B3", "HIGHEST"])
@pytest.mark.parametrize("B,T,n,K", [(5, 128, 1, 1), (33, 256, 15, 9), (12, 384, 16, 12),
                                     (7, 128, 17, 40), (37, 640, 209, 9),
                                     (5, 128, 300, 12)])
def test_k11_tensor_cores(dev, precision, B, T, n, K):
    """The tensor-core K11 at both precisions over tap counts around its
    16-position k-steps (1, 15, 16, 17), the C8-psg taps and 300, 1 to 40
    bands, batches that fill no 32-row tile and T = 128 (half a time tile):
    ≤ −110 dB against the plain version, the fused epilogue bit-exact
    (f32 and int16), rows run alone ≡ the same rows in the batch (at
    other positions of their row tile), and the card's band tiles ≡ the
    CPU's bit for bit."""
    kw = dict(precision=precision)
    highest = precision == "HIGHEST"
    x = randn(dev, B, n - 1 + T)
    kernels = randn(dev, K, n, seed=1)
    gains = torch.rand(B, K, generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev) * 2.0
    y = F.fir_td_mxu_per_stream(x, kernels, gains, **kw)
    e = err_db(y, F.fir_td_mxu_per_stream_plain(x, kernels, gains, **kw))
    print(f"K11 {precision} B={B} T={T} n={n} K={K}: {e:.1f} dB")
    assert y.shape == (B, T) and e <= CONV_DB
    unfused = dither_cuda(torch.clamp(y, -0.3, 0.3), (9, 4), 16, "tpdf")
    assert torch.equal(F.fir_td_mxu_per_stream(x, kernels, gains, **kw, **EPI), unfused)
    assert torch.equal(F.fir_td_mxu_per_stream(x, kernels, gains, emit_i16=True,
                                               **kw, **EPI), F.quantize_pcm16(unfused))
    for b in (0, B // 2, B - 1):
        assert torch.equal(F.fir_td_mxu_per_stream(x[b:b + 1], kernels, gains[b:b + 1],
                                                   **kw), y[b:b + 1]), b
    assert torch.equal(F.band_tiles(kernels, highest).cpu(),
                       F.band_tiles(kernels.cpu(), highest))


@pytest.mark.parametrize("precision", ["B3", "HIGHEST"])
def test_per_stream_fold_equals_scan(dev, precision):
    """The offline fold with per-stream EQ gains (K11 over B·nb rows, each
    stream's gains repeated over its blocks) ≡ the scan bit for bit on the
    card with dither off: 6 streams × 5 blocks fold into 30 rows."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig, batch

    cfg = StreamConfig(samplerate=44100, blocksize=256, upsample_factor=2,
                       numtaps=65, batch=6, conv_strategy="td_mxu",
                       eq_enabled=True, dither_kind="off")
    pipe = Pipeline(cfg, dev, td_precision=precision)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    gains = np.random.default_rng(8).uniform(0.25, 2.0, (6, len(cfg.eq_bands)))
    params = batch.with_per_stream_gains(pipe, params, gains.astype(np.float32))
    x = (np.random.default_rng(7).standard_normal((6, 5 * 256 + 77)) * 0.3
         ).astype(np.float32)
    st0 = pipe.init_state(seed=3)
    before = F.fir_td_mxu_per_stream.launches
    sf, yf = pipe.process_signal(params, st0, x, fold=True)
    ss, ys = pipe.process_signal(params, st0, x, fold=False)
    assert F.fir_td_mxu_per_stream.launches == before + 6
    assert torch.equal(yf, ys) and torch.equal(sf.conv_tail, ss.conv_tail)


def test_c8_batch8_after_allocator_poisoning(dev):
    """C8's kernels at batch 8 (below K6's 32-stream block and K8's row
    tiles) after the caching allocator was filled with NaN and freed, so a
    workspace or output element a kernel failed to write would read NaN:
    K5 ≤ −110 dB, K6 bit-exact and K8 ≤ −110 dB against their plain
    versions on the same inputs, four blocks with the gain carry, outputs
    finite, and the Pipeline step ≡ the kernels called in order."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig

    junk = torch.full((1 << 26,), float("nan"), device=dev)  # 256 MiB
    torch.cuda.synchronize()
    del junk
    cfg = StreamConfig(samplerate=44100, blocksize=2048, upsample_factor=2,
                       numtaps=129, batch=8, cutoff=14000.0, eq_enabled=True,
                       agc_enabled=True, agc_mode="exact", agc_window_size=512,
                       agc_carry=True, downsample_mode="decimate",
                       dither_kind="tpdf", output_clip=0.99, conv_strategy="td_mxu")
    pipe = Pipeline(cfg, dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    lp, rp = pipe._rms_pad
    h = params.combined_cascade(True)
    sig = torch.from_numpy((np.random.default_rng(4).standard_normal((4, 8, 2048)) * 0.1
                            ).astype(np.float32)).to(dev)
    sig[:, 0] *= 8.0
    st = pipe.init_state(seed=1)
    for blk in sig:
        d = R.rms_desired(blk, pipe._rms_band, lp, rp, params.agc_target,
                          params.agc_max_gain, True, transposed=True)
        dp = R.rms_desired_plain(blk, pipe._rms_band, lp, rp, params.agc_target,
                                 params.agc_max_gain, True, transposed=True)
        assert err_db(d, dp) <= CONV_DB and bool(torch.isfinite(d).all())
        knobs = (params.agc_a_att, params.agc_a_rel, params.agc_max_gain)
        (yh, yl), c = S.smooth_gain_apply(d, blk, *knobs, init=st.agc_gain,
                                          emit_split=True)
        (ph, pl), pc = S.smooth_gain_apply_plain(d, blk, *knobs, init=st.agc_gain,
                                                 emit_split=True)
        assert torch.equal(yh, ph) and torch.equal(yl, pl) and torch.equal(c, pc)
        th, tl = st.conv_tail
        dkw = pipe._dither_kw(st, cfg.output_clip)
        y, nh, nl = F.fir_td_mxu_pair(yh, yl, th, tl, h, **dkw)
        yp, _, _ = F.fir_td_mxu_pair_plain(yh, yl, th, tl, h, **dkw)
        assert err_db(y, yp) <= CONV_DB and bool(torch.isfinite(y).all())
        st2, ys = pipe.step(params, st, blk)
        assert torch.equal(ys, y) and torch.equal(st2.agc_gain, c)
        assert torch.equal(st2.conv_tail[0], nh) and torch.equal(st2.conv_tail[1], nl)
        st = st2


@pytest.mark.parametrize("B,T,blockwise", [(40, 256, 32), (9, 384, None)])
def test_k5_k6_vectors(dev, B, T, blockwise):
    """K5/K6 with [B] vectors ≡ the scalar runs on each row, bit for bit;
    against their plain versions K5 ≤ −110 dB and K6 bit-exact ('fast'
    compounds per stream; the carry)."""
    x = randn(dev, B, T)
    x[0] *= 10.0
    W = 128
    band = F.band_matrix(np.full(W, 1.0 / W, np.float32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(6)
    target = torch.rand(B, generator=g, device=dev) * 0.3 + 0.02
    mg = torch.rand(B, generator=g, device=dev) * 15.0 + 2.0
    a_att = torch.rand(B, generator=g, device=dev) * 0.3 + 0.01
    a_rel = torch.rand(B, generator=g, device=dev) * 0.05 + 0.001
    init = torch.linspace(0.2, 8.0, B, device=dev)
    mc = 32 if blockwise else 0
    d = R.rms_desired(x, band, 64, 63, target, mg, True, transposed=True,
                      mean_chunk=mc)
    e = err_db(d, R.rms_desired_plain(x, band, 64, 63, target, mg, True,
                                      transposed=True, mean_chunk=mc))
    print(f"K5 vectors B={B} T={T} mean_chunk={mc}: {e:.1f} dB")
    assert e <= CONV_DB
    kw = dict(init=init, blockwise=blockwise, d_is_means=bool(mc))
    y, c = S.smooth_gain_apply(d, x, a_att, a_rel, mg, **kw)
    yp, cp = S.smooth_gain_apply_plain(d, x, a_att, a_rel, mg, **kw)
    assert torch.equal(y, yp) and torch.equal(c, cp)
    for b in (0, B // 2, B - 1):
        ds = R.rms_desired(x, band, 64, 63, float(target[b]), float(mg[b]), True,
                           transposed=True, mean_chunk=mc)
        assert torch.equal(ds[:, b], d[:, b])
        ys, cs = S.smooth_gain_apply(d, x, float(a_att[b]), float(a_rel[b]),
                                     float(mg[b]), **kw)
        assert torch.equal(ys[b], y[b]) and torch.equal(cs[b], c[b])


@pytest.mark.parametrize("B,T,n", [(5, 384, 31), (1, 128, 1), (7, 256, 300),
                                   (6, 640, 379)])
def test_k15_highest_k1_vs_plain(dev, B, T, n):
    """HIGHEST K1 ≤ −110 dB against its plain version (fp32 sums in another
    order), the fused epilogue bit-exact; B3F and B3C ≡ B3 bit for bit."""
    x, h = randn(dev, B, n - 1 + T), randn(dev, n, seed=1)
    y = F.fir_td_mxu(x, h, precision="HIGHEST")
    e = err_db(y, F.fir_td_mxu_plain(x, h, precision="HIGHEST"))
    print(f"K15 HIGHEST K1 B={B} T={T} n={n}: {e:.1f} dB")
    assert y.shape == (B, T) and e <= CONV_DB
    assert torch.equal(F.fir_td_mxu(x, h, precision="HIGHEST", **EPI),
                       F._finish(y, 0.3, (9, 4), 16, True))
    b3 = F.fir_td_mxu(x, h, **EPI)
    assert all(torch.equal(F.fir_td_mxu(x, h, precision=p, **EPI), b3)
               for p in ("B3F", "B3C"))


@pytest.mark.parametrize("B,T,n,K", [(12, 384, 65, 9), (6, 128, 300, 1)])
def test_k15_highest_k11_vs_plain(dev, B, T, n, K):
    """HIGHEST K11 ≤ −110 dB against its plain version, every row written,
    the fused epilogue ≡ K11 → clip → K2 → quantize_pcm16."""
    x = randn(dev, B, n - 1 + T)
    kernels = randn(dev, K, n, seed=1) * 0.3
    gains = torch.rand(B, K, generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev) * 2.0
    kw = dict(precision="HIGHEST")
    y = F.fir_td_mxu_per_stream(x, kernels, gains, **kw)
    e = err_db(y, F.fir_td_mxu_per_stream_plain(x, kernels, gains, **kw))
    print(f"K15 HIGHEST K11 B={B} T={T} n={n} K={K}: {e:.1f} dB")
    assert y.shape == (B, T) and e <= CONV_DB
    assert bool((y.abs().amax(dim=1) > 0).all())
    unfused = dither_cuda(torch.clamp(y, -0.3, 0.3), (9, 4), 16, "tpdf")
    assert torch.equal(F.fir_td_mxu_per_stream(x, kernels, gains, **kw, **EPI),
                       unfused)
    assert torch.equal(F.fir_td_mxu_per_stream(x, kernels, gains, emit_i16=True,
                                               **kw, **EPI),
                       F.quantize_pcm16(unfused))


@pytest.mark.parametrize("B,T,w", [(6, 256, 256), (45, 384, 512), (33, 640, 256)])
def test_k14_vs_plain(dev, B, T, w):
    """K14 ≡ its plain version bit for bit (y, pair, carry) over f32,
    int16 and ring-slot input, with and without the carry; a window wider
    than the block; batches that fill no 32-stream block."""
    x = randn(dev, B, T)
    x[0, : T // 2] = 0.95
    x[1] *= 1e-3
    init = torch.linspace(0.2, 8.0, B, device=dev)
    x16 = torch.clamp(torch.round(x * 32768), -32768, 32767).to(torch.int16)
    ring = torch.stack([randn(dev, B, T, seed=3), x])
    args = (w, 0.02, 0.002, 0.1, 10.0)
    for src, kw in ((x, {}), (x16, {}), (ring, dict(ring_idx=1))):
        for ini in (None, init):
            for split in (False, True):
                y, c = K14.agc_rms_apply(src, *args, init=ini, emit_split=split, **kw)
                yp, cp = K14.agc_rms_apply_plain(src, *args, init=ini,
                                                 emit_split=split, **kw)
                same = (all(torch.equal(a, b) for a, b in zip(y, yp)) if split
                        else torch.equal(y, yp))
                assert same and torch.equal(c, cp), (src.dtype, ini is None, split)
    assert K14.agc_rms_apply.launches > 0


@pytest.mark.parametrize("B,T", [(6, 256), (300, 300), (17, 128)])
def test_k9_vs_plain(dev, B, T):
    """K9 ≡ smooth_gain_scan bit for bit in every layout (time-major in,
    batch-major store), with the restart and with the carry."""
    d = torch.rand(B, T, generator=torch.Generator(device=dev).manual_seed(4),
                   device=dev) * 4.0 + 0.1
    init = torch.linspace(0.5, 2.0, B, device=dev)
    for ini in (None, init):
        want = A.smooth_gain_scan(d, 0.15, 0.013, init=ini)
        for tm in (False, True):
            for bm in (False, True):
                g = S.smooth_gain_scan(d.T.contiguous() if tm else d, 0.15, 0.013,
                                       init=ini, time_major=tm, out_batch_major=bm)
                assert g.shape == (B, T) and torch.equal(g, want), (tm, bm)


def _offset_copy(t):
    """A copy of `t` in a contiguous view that starts one element into its
    buffer: not 16-byte aligned, so the kernels take their 4-byte paths."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("B,T,w", [
    (1, 128, 256),      # one chunk, one block of one stream
    (33, 256, 1024),    # the window wider than the block (nch < 2h)
    (5, 896, 512),      # one more chunk than the 6 window warps: a slot reused
    (33, 1664, 512),    # three rounds, the last of one chunk
    (1, 2048, 2048),    # h = 8, one stream
    (4096, 2048, 2048),  # h = 8 at the C8 batch
    (4096, 2048, 512),  # the C8 point
])
def test_k14_edges(dev, B, T, w):
    """The redesigned K14 (window warps, recurrence warp, apply warps and
    their barriers) ≡ its plain version bit for bit, output and
    gain, where a wrong barrier count or slot would hang or differ: one
    chunk, fewer chunks than the window warps, a reused d slot, a last
    round of one chunk, h = 8; one stream, a block and one more, the C8
    batch; f32, int16, a ring slot and unaligned x; the pair and f32
    stores; restart and carry; a silent row between loud ones and a row
    so quiet that the window warps' checked fast path gives way to the
    IEEE intrinsics."""
    x = randn(dev, B, T) * 2.0
    x[: (B + 7) // 8] *= 4.0
    if B > 2:
        x[B // 2] = 0.0  # silent inside loud rows
        x[B // 2 - 1] *= 8.0
        x[B // 2 + 1] *= 1e-18  # mean squares below 2^-100: the IEEE path
    x16 = torch.clamp(torch.round(x * 32768), -32768, 32767).to(torch.int16)
    ring = torch.stack([randn(dev, B, T, seed=3), x, randn(dev, B, T, seed=5)])
    init = torch.exp(torch.linspace(-2.0, 2.5, B, device=dev))
    args = (w, 0.02, 0.002, 0.1, 10.0)
    forms = [(x, {}), (x16, {}), (ring, dict(ring_idx=1)), (_offset_copy(x), {}),
             (_offset_copy(x16), {})]
    before = K14.agc_rms_apply.launches
    for src, kw in forms:
        for ini in (None, init):
            for split in (False, True):
                y, c = K14.agc_rms_apply(src, *args, init=ini, emit_split=split, **kw)
                yp, cp = K14.agc_rms_apply_plain(src, *args, init=ini,
                                                 emit_split=split, **kw)
                same = (all(torch.equal(a, b) for a, b in zip(y, yp)) if split
                        else torch.equal(y, yp))
                assert same and torch.equal(c, cp), (src.dtype, kw, ini is None, split)
    assert K14.agc_rms_apply.launches == before + 4 * len(forms)


@pytest.mark.parametrize("B,T", [(1, 128), (33, 129), (4096, 300), (1, 300),
                                 (33, 2048), (4096, 2048)])
def test_k9_edges(dev, B, T):
    """The redesigned K9 (a recurrence warp a chunk ahead of 8 store
    warps) ≡ the plain scan bit for bit: one chunk, a chunk and one step,
    T not a multiple of 4, 8 or 128; one stream, a block and one more, the
    C8 batch; both layouts of d and both stores, aligned and one element
    off (the 4-byte paths); restart and carry, with the first step's d ==
    the start value exactly and one ulp either side."""
    g = torch.Generator(device=dev).manual_seed(8)
    d = torch.exp(torch.rand(B, T, generator=g, device=dev) * 8.0 - 4.5)
    init = torch.exp(torch.rand(B, generator=g, device=dev) * 5.0 - 3.0)
    k = torch.arange(B, device=dev) % 3
    up, down = torch.full_like(init, 1e9), torch.zeros_like(init)

    def ties(v, ref):  # == ref, one ulp above, one below, by row
        return torch.where(k == 0, ref, torch.where(
            k == 1, torch.nextafter(ref, up), torch.nextafter(ref, down)))

    d[:, 0] = ties(d[:, 0], init)  # the carry's first step
    if T > 1:
        d[:, 1] = ties(d[:, 1], d[:, 0])  # the restart's first step
    before = S.smooth_gain_scan.launches
    for ini in (None, init):
        want = A.smooth_gain_scan(d, 0.3, 0.02, init=ini)
        for tm in (False, True):
            src = d.T.contiguous() if tm else d
            for aligned in (True, False):
                s = src if aligned else _offset_copy(src)
                for bm in (False, True):
                    got = S.smooth_gain_scan(s, 0.3, 0.02, init=ini, time_major=tm,
                                             out_batch_major=bm)
                    assert got.shape == (B, T) and torch.equal(got, want), (
                        ini is None, tm, aligned, bm)
    assert S.smooth_gain_scan.launches == before + 16


def test_apply_agc_on_the_card(dev):
    """`apply_agc` on a CUDA tensor runs K9 and equals the same chain with
    the plain recurrence, bit for bit, with and without the carry."""
    x = randn(dev, 5, 512)
    x[0] *= 8.0
    params = A.AGCParams(window_size=128)
    before = S.smooth_gain_scan.launches
    for carry in (None, torch.linspace(0.5, 3.0, 5, device=dev)):
        y, g = A.apply_agc(x, params, carry)
        d = A.desired_gain(A.moving_rms(x, 128), params.target_level, params.max_gain)
        gp = torch.minimum(torch.clamp_min(A.smooth_gain_scan(
            d, params.a_att, params.a_rel, init=carry), 0.1),
            torch.tensor(params.max_gain, dtype=torch.float32, device=dev))
        assert torch.equal(y, x * gp) and torch.equal(g, gp[:, -1])
    assert S.smooth_gain_scan.launches == before + 2


@pytest.mark.parametrize("precision,over", [
    ("B3", dict()), ("B3", dict(ingest="pcm16")), ("B3", dict(ingest="pair")),
    ("B3", dict(emit="pcm16", output_clip=0.5)), ("HIGHEST", dict()),
    ("HIGHEST", dict(emit="pcm16", output_clip=0.5))])
def test_fold_equals_scan(dev, precision, over):
    """The offline fold ≡ the block-by-block scan bit for bit on the card
    with dither off (the conv body's sums do not depend on the batch),
    outputs and carried state, for each input form and at HIGHEST; B = 6
    streams × 5 blocks fold into 30 rows, which fill no 16-row tile."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig

    cfg = StreamConfig(samplerate=44100, blocksize=256, upsample_factor=2,
                       numtaps=65, batch=6, conv_strategy="td_mxu",
                       dither_kind="off", **over)
    pipe = Pipeline(cfg, dev, td_precision=precision)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    x = np.random.default_rng(7).standard_normal((6, 5 * 256 + 77)) * 0.3
    x = (np.round(x * 8000).astype(np.int16) if over.get("ingest") == "pcm16"
         else x.astype(np.float32))
    st0 = pipe.init_state(seed=3)
    sf, yf = pipe.process_signal(params, st0, x, fold=True)
    ss, ys = pipe.process_signal(params, st0, x, fold=False)
    assert yf.dtype == pipe.out_dtype and torch.equal(yf, ys)
    tails = sf.conv_tail if isinstance(sf.conv_tail, tuple) else (sf.conv_tail,)
    want = ss.conv_tail if isinstance(ss.conv_tail, tuple) else (ss.conv_tail,)
    assert all(torch.equal(a, b) for a, b in zip(tails, want)) and sf.step == ss.step


@pytest.mark.parametrize("precision", ["B3", "HIGHEST"])
@pytest.mark.parametrize("n", [1, 17, 209, 379, 457])
def test_k1_equals_one_band_k11(dev, precision, n):
    """K1 ≡ K11 run with the one band h at gain 1.0, bit for bit (both sum
    each output's k-steps in the same chunks and order; the mix adds
    0 + 1·z), at both precisions; K1 ≤ −110 dB against its plain version.
    37 rows fill no row tile and T = 640 no 512-output tile."""
    B, T = 37, 640
    x, h = randn(dev, B, n - 1 + T), randn(dev, n, seed=1)
    y = F.fir_td_mxu(x, h, precision=precision)
    e = err_db(y, F.fir_td_mxu_plain(x, h, precision=precision))
    print(f"K1 {precision} n={n}: {e:.1f} dB")
    assert e <= CONV_DB
    one = torch.ones(B, 1, device=dev)
    assert torch.equal(y, F.fir_td_mxu_per_stream(x, h[None], one, precision=precision))


@pytest.mark.parametrize("n", [31, 300])
def test_banked_bt8_alternating_designs(dev, n):
    """Assignment tiles of 8 rows whose designs alternate, so every m16
    tile holds two designs, plus one entry
    outside the bank: K10 and the banked K3, K4, K12 and K12-mega ≤ −110 dB
    against their plain versions, every row ≡ the shared-taps form on its
    design bit for bit (clip and dither on), the bad entry's rows NaN
    (−32768 in int16), tails bit-exact."""
    B, T, S, D = 48, 384, 2, 3
    bank = randn(dev, D, n, seed=5)
    assign = torch.tensor([0, 1, 0, 2, 1, 7], dtype=torch.int32, device=dev)
    rows = assign.long().repeat_interleave(8)
    good = rows < D
    x = randn(dev, B, n - 1 + T)
    y = F.fir_td_mxu_banked(x, bank, assign)
    e = err_db(y[good], F.fir_td_mxu_banked_plain(x, bank, assign)[good])
    print(f"K10 bt=8 alternating n={n}: {e:.1f} dB")
    assert e <= CONV_DB and torch.isnan(y[~good]).all()
    ye = F.fir_td_mxu_banked(x, bank, assign, **EPI)
    y16 = F.fir_td_mxu_banked(x, bank, assign, emit_i16=True, **EPI)
    assert (y16[~good] == -32768).all()
    for d in range(D):
        assert torch.equal(ye[rows == d], F.fir_td_mxu(x, bank[d], **EPI)[rows == d])
        assert torch.equal(y16[rows == d], F.fir_td_mxu(x, bank[d], emit_i16=True,
                                                        **EPI)[rows == d])
    kp = F.ring_k_pad(n)
    for fn, plain, ring, tail, mega in (
            (F.fir_td_mxu_ring_f32, F.fir_td_mxu_ring_f32_plain, randn(dev, S, B, T),
             randn(dev, B, kp, seed=2), False),
            (F.fir_td_mxu_ring_mega_f32, F.fir_td_mxu_ring_mega_f32_plain,
             randn(dev, S, B, T), randn(dev, B, kp, seed=2), True),
            (F.fir_td_mxu_ring_pcm16, F.fir_td_mxu_ring_pcm16_plain, pcm(dev, S, B, T),
             pcm(dev, B, kp, seed=3), False),
            (F.fir_td_mxu_ring_mega_pcm16, F.fir_td_mxu_ring_mega_pcm16_plain,
             pcm(dev, S, B, T), pcm(dev, B, kp, seed=3), True)):
        args = (1, 3) if mega else (1,)

        def run(f, h, **kw):
            z = torch.zeros(S, B, T, device=dev)
            return f(ring, args[0], tail, h, z, *args[1:], **kw)

        out, nt = run(fn, bank, assign=assign)
        pout, pnt = run(plain, bank, assign=assign)
        e = err_db(out[:, good], pout[:, good])
        print(f"banked {fn.__name__} bt=8 alternating n={n}: {e:.1f} dB")
        written = [0, 1] if mega else [1]  # three steps from slot 1 reach both
        assert e <= CONV_DB and torch.equal(nt, pnt)
        assert torch.isnan(out[written][:, ~good]).all()
        oe, _ = run(fn, bank, assign=assign, **EPI)
        for d in range(D):
            se, st = run(fn, bank[d], **EPI)
            assert torch.equal(oe[:, rows == d], se[:, rows == d]) and torch.equal(st, nt)


def window_chunk_edges(highest: bool) -> list[tuple[int, int]]:
    """(tap count, window chunks) at the edges of `conv_geometry`'s window
    chunks: the last tap count of one chunk, the first of two and the first
    of three (bf16×3 2057, 2058, 4090; HIGHEST 1225, 1226, 2042)."""
    edges, last, n = [], 1, 1
    while len(edges) < 3:
        chunks = F.conv_geometry(n, highest)["chunks"]
        if chunks > last:
            edges += [(n - 1, last)] if not edges else []
            edges.append((n, chunks))
            last = chunks
        n += 1
    return edges


@pytest.mark.parametrize("precision,n,chunks", [
    (p, n, c) for p in ("B3", "HIGHEST")
    for n, c in [(249, 1), (250, 1)] + window_chunk_edges(p == "HIGHEST")])
def test_k1_at_chunk_boundaries(dev, precision, n, chunks):
    """K1 at the last tap count of one accumulation chunk of 16 k-steps and
    the first of two (249, 250), and at the last of one window chunk, the
    first of two and the first of three (`window_chunk_edges`): ≤ −110 dB
    against the plain version, ≡ K11 with the one band at gain 1.0 where
    K11 takes the taps (up to 1033, HIGHEST 457)."""
    B, T = 9, 384
    x, h = randn(dev, B, n - 1 + T), randn(dev, n, seed=1)
    geo = F.conv_geometry(n, precision == "HIGHEST")
    assert geo["chunks"] == chunks
    y = F.fir_td_mxu(x, h, precision=precision)
    e = err_db(y, F.fir_td_mxu_plain(x, h, precision=precision))
    print(f"K1 {precision} n={n} (S={geo['S']}, {chunks} window chunks of {geo['C']}): "
          f"{e:.1f} dB")
    assert e <= CONV_DB
    if n <= (457 if precision == "HIGHEST" else 1033):
        one = torch.ones(B, 1, device=dev)
        assert torch.equal(y, F.fir_td_mxu_per_stream(x, h[None], one,
                                                      precision=precision))


@pytest.mark.parametrize("n,chunks", [(41, 1), (42, 1), (250, 1)]
                         + window_chunk_edges(False))
def test_k3_k8_at_chunk_boundaries(dev, n, chunks):
    """K3 and K8 at the k-step edge of the steady loop (S = 3, 4), two
    accumulation chunks (250) and the window-chunk edges (one, two and
    three chunks; the window of a later chunk starts in the carried tail or
    the slot): ≤ −110 dB against their plain versions, tails bit-exact, and
    each ≡ K1 on its extended block bit for bit (dither on)."""
    B, T, S = 6, 256, 2
    assert F.conv_geometry(n)["chunks"] == chunks
    h = randn(dev, n, seed=1)
    kp = F.ring_k_pad(n)
    ring, tail = randn(dev, S, B, T), randn(dev, B, kp, seed=2)
    out, nt = F.fir_td_mxu_ring_f32(ring, 1, tail, h, torch.zeros_like(ring))
    pout, pnt = F.fir_td_mxu_ring_f32_plain(ring, 1, tail, h, torch.zeros_like(ring))
    e3 = err_db(out[1], pout[1])
    ext = torch.cat([tail, ring[1]], dim=-1)[:, kp - (n - 1):].contiguous()
    oe, _ = F.fir_td_mxu_ring_f32(ring, 1, tail, h, torch.zeros_like(ring), **EPI)
    assert e3 <= CONV_DB and torch.equal(nt, pnt)
    assert torch.equal(oe[1], F.fir_td_mxu(ext, h, **EPI))
    (xh, xl), (th, tl) = F.split_bf16(ring[1]), F.split_bf16(tail)
    y, nh, nl = F.fir_td_mxu_pair(xh, xl, th, tl, h)
    yp, ph, pl = F.fir_td_mxu_pair_plain(xh, xl, th, tl, h)
    e8 = err_db(y, yp)
    print(f"K3 n={n}: {e3:.1f} dB, K8 n={n}: {e8:.1f} dB")
    assert e8 <= CONV_DB and torch.equal(nh, ph) and torch.equal(nl, pl)
    assert torch.equal(F.fir_td_mxu_pair(xh, xl, th, tl, h, **EPI)[0], oe[1])


@pytest.mark.parametrize("highest", [False, True])
def test_conv_geometry_mirror(dev, highest):
    """`conv_geometry` (the Python mirror) ≡ the geometry the built library
    launches with, at tap counts of one to three window chunks and beyond;
    the accumulation chunk is ACC_STEPS."""
    for n in (1, 17, 209, 379, 457, 1151, 1225, 1226, 2042, 2057, 2058, 4090, 16384):
        want, got = F.conv_geometry(n, highest), F.built_conv_geometry(n, highest)
        assert all(got[k] == v for k, v in want.items()), (n, want, got)
        assert got["acc_steps"] == F.ACC_STEPS
    print(f"conv geometry {'HIGHEST' if highest else 'B3'}: mirror == library")


# ---------------------------------------------------------------- CLI slice

#: the engine's forms on the card: the f32 conv (K1), int16 in and out (K12
#: over a one-slot view), and the AGC chain (K5 → K6 → K8)
ENGINE_FORMS = {
    "f32": {},
    "pcm16-io": dict(ingest="pcm16", emit="pcm16"),
    "agc": dict(agc_enabled=True, agc_window_size=128, output_clip=0.99),
}


def _engine_cfg(**over):
    from afp_tpu_torch.engine import StreamConfig

    return StreamConfig(**{**dict(
        samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
        batch=6, cutoff=9000.0, downsample_mode="decimate", output_clip=None,
        conv_strategy="td_mxu", dither_kind="tpdf"), **over})


def _engine_signal(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.ingest == "pcm16":
        return (rng.standard_normal((cfg.batch, n)) * 6000).astype(np.int16)
    return (0.3 * rng.standard_normal((cfg.batch, n))).astype(np.float32)


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
def test_process_frames_pinned_equals_pageable(dev, form):
    """`process_frames` on the card, its copies staged through pinned
    memory, ≡ a Pipeline on the card fed pageable numpy blocks (one block
    late), bit for bit, dither on."""
    from afp_tpu_torch.engine import (Pipeline, PipelineParams,
                                      StreamEngine)

    cfg = _engine_cfg(**ENGINE_FORMS[form])
    x = _engine_signal(cfg, 6 * 512)
    eng = StreamEngine(cfg, device=dev, seed=5)
    got, i = [], 0
    for size in (1, 700, 0, 300, 511, 1000, 561):
        got.append(eng.process_frames(x[:, i:i + size]))
        i += size
    got = np.concatenate(got, axis=1)
    pipe = Pipeline(cfg, dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    state = pipe.init_state(seed=5)
    want = [np.zeros((cfg.batch, 512), got.dtype)]
    for k in range(5):
        state, y = pipe.step(params, state, x[:, k * 512:(k + 1) * 512])
        want.append(y.cpu().numpy())
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
    m = eng.metrics
    assert m.blocks_processed == 6 and m.fallback_replays == m.underruns == 0


@pytest.mark.parametrize("fold,dither", [("prefer", "off"), (False, "tpdf")])
def test_chunked_upload_equals_one_shot_on_the_card(dev, monkeypatch, fold,
                                                    dither):
    """`process_signal` in chunks uploaded on a copy stream ≡ one shot, bit
    for bit: the fold per chunk with dither off (its sums depend only on the
    column), the scan with dither on."""
    from afp_tpu_torch.engine import StreamEngine

    cfg = _engine_cfg(dither_kind=dither)
    x = _engine_signal(cfg, 37 * 512 + 9, seed=1)
    want = StreamEngine(cfg, device=dev).process_signal(x, fold=fold)
    monkeypatch.setenv("AFP_STAGE_CHUNK_MB", str(5 * 6 * 512 * 4 / 2 ** 20))
    eng = StreamEngine(cfg, device=dev)
    assert eng._stage_chunk_blocks(x) == 5
    np.testing.assert_array_equal(eng.process_signal(x, fold=fold), want)


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
def test_checkpoint_round_trip_on_the_card(dev, tmp_path, form):
    """Save on the card mid-block, restore on the card (every tensor there
    once), stream on: ≡ the uninterrupted stream, bit for bit, dither on."""
    from afp_tpu_torch.engine import StreamEngine
    from afp_tpu_torch.engine.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    cfg = _engine_cfg(**ENGINE_FORMS[form])
    x = _engine_signal(cfg, 5 * 512, seed=2)
    eng = StreamEngine(cfg, device=dev, seed=3)
    eng.process_frames(x[:, :1300])
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, eng)
    resumed = load_checkpoint(path, device=dev)
    tails = (resumed.state.conv_tail if isinstance(resumed.state.conv_tail,
                                                   tuple)
             else (resumed.state.conv_tail,))
    assert all(t.is_cuda for t in tails) and resumed.params.H_main.is_cuda
    np.testing.assert_array_equal(resumed.process_frames(x[:, 1300:]),
                                  eng.process_frames(x[:, 1300:]))


def test_cli_devices_lists_the_card(dev):
    """`python -m afp_tpu_torch devices` runs on the card by default and
    lists it."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = {k: v for k, v in os.environ.items() if k != "AFP_FORCE_CPU"}
    r = subprocess.run([sys.executable, "-m", "afp_tpu_torch", "devices"],
                       cwd=Path(__file__).resolve().parents[1], env=env,
                       capture_output=True, text=True, timeout=300)
    print(r.stdout, r.stderr[-2000:])
    assert r.returncode == 0
    assert torch.cuda.get_device_name(0) in r.stdout


# ---------------------------------------------------------------- multirate

MULTI_DB = -100.0  # cuFFT against torch's CPU FFT: two f32 FFT libraries


@pytest.mark.parametrize("up,down", [(4, 1), (2, 1), (3, 2), (1, 2), (1, 4),
                                     (160, 147), (147, 160)])
def test_resampling_on_the_card_equals_cpu(dev, up, down):
    """upfirdn, resample_poly and a blocked PolyResampler on the card ≡
    their CPU runs (≤ −100 dB); blocked ≡ one-shot causal upfirdn."""
    from afp_tpu_torch.ops import resample as T

    dn = T._reduce_ratio(up, down)[1]
    L = dn * -(-1024 // dn)  # a block of whole decimation periods
    g = torch.Generator().manual_seed(up * 1000 + down)
    x = torch.randn(3, 4 * L, generator=g) * 0.3
    h = T.quality_kernel(up, down, "hq")
    for fn in (lambda v: T.upfirdn(h, v, up, down),
               lambda v: T.resample_poly(v, up, down, quality="hq")):
        e = err_db(fn(x.to(dev)), fn(x))
        print(f"{up}/{down}: card vs CPU {e:.1f} dB")
        assert e <= MULTI_DB
    st = T.PolyResampler.init(up, down, block=L, batch_shape=(3,), device=dev)
    outs = []
    for i in range(0, x.shape[1], L):
        st, y = st.process(x[:, i:i + L].to(dev))
        outs.append(y)
    blocked = torch.cat(outs, -1)
    causal = T.upfirdn(st.h.cpu(), x, st.up, st.down)[:, :blocked.shape[-1]]
    assert blocked.is_cuda and err_db(blocked, causal) <= MULTI_DB


@pytest.mark.parametrize("over", [
    dict(fuse_rate_conversion=False, downsample_mode="resample"),
    dict(fuse_rate_conversion=False, downsample_mode="decimate", upsample_factor=4),
    dict(output_rate="upsampled", eq_enabled=True),
    dict(source_samplerate=48000, asrc_mode="compat"),
    dict(source_samplerate=88200, asrc_mode="compat", conv_strategy="td_mxu"),
    dict(agc_enabled=True, agc_mode="parallel", agc_window_size=128,
         conv_strategy="td_mxu"),
])
def test_multirate_pipeline_on_the_card_equals_cpu(dev, over):
    """The literal chain, upsampled output, compat ASRC (both submodes)
    and the parallel AGC on the card ≡ their CPU runs (≤ −100 dB, dither
    off)."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig

    cfg = StreamConfig(**{**dict(samplerate=44100, blocksize=512,
                                 upsample_factor=2, numtaps=65, batch=6,
                                 dither_kind="off"), **over})
    x = torch.randn(6, 6 * 512, generator=torch.Generator().manual_seed(5)) * 0.3
    outs = []
    for d in (dev, torch.device("cpu")):
        p = Pipeline(cfg, d)
        params = p.device_params(PipelineParams.design(p.cfg))
        outs.append(p.process_signal(params, p.init_state(), x.to(d))[1])
    e = err_db(*outs)
    print(f"{over}: card vs CPU {e:.1f} dB")
    assert outs[0].is_cuda and outs[0].shape == outs[1].shape and e <= MULTI_DB


def test_frontend_on_the_card_chunked_equals_one_shot(dev):
    """The exact frontend's resampler on the card: any chunking of the
    pushes ≡ one push, bit for bit; ≡ the CPU frontend within −100 dB."""
    from afp_tpu_torch.runtime import AsrcFrontend

    x = (np.random.default_rng(6).standard_normal((2, 40000)) * 0.3).astype(np.float32)
    outs = []
    for d, sizes in ((dev, [40000]), (dev, [1, 4159, 1, 9000, 333]),
                     ("cpu", [40000])):
        front, i = AsrcFrontend(48000, 44100, batch=2, device=d), 0
        for n in sizes:
            front.push(x[:, i:i + n])
            i += n
        front.push(x[:, i:])
        outs.append(front.flush())
    np.testing.assert_array_equal(outs[0], outs[1])
    e = err_db(torch.from_numpy(outs[0]), torch.from_numpy(outs[2]))
    print(f"frontend card vs CPU: {e:.1f} dB")
    assert e <= MULTI_DB


def test_parallel_agc_on_the_card_equals_exact(dev):
    """smooth_gain_parallel on the card ≡ the exact recurrence within
    −105 dB (the reference's bar), in at most 24 solves."""
    d = A.desired_gain(A.moving_rms(
        torch.randn(64, 2048, generator=torch.Generator().manual_seed(7)) * 0.3,
        512), 0.1, 10.0)
    a_att, a_rel = A.agc_alphas(512)
    g, it, _ = A._smooth_gain_parallel(d.to(dev), a_att, a_rel,
                                       init=torch.ones(64, device=dev))
    e = err_db(g, A.smooth_gain_scan(d, a_att, a_rel, init=torch.ones(64)))
    print(f"parallel on the card: {it} solves, {e:.1f} dB vs exact")
    assert g.is_cuda and it <= 24 and e < -105


@pytest.mark.parametrize("form", ["td", "agc"])
def test_sharded_step_equals_unsharded(dev, form):
    """The parallel slice: a 2-shard mesh of the one card (C5's conv, or
    the C8 chain linked in pairs) ≡ the unsharded pipeline bit for bit,
    dither off, over 3 chained steps and a run, carried state included."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
    from afp_tpu_torch.parallel import ShardedPipeline, make_mesh

    over = (dict(upsample_factor=4, numtaps=1001, eq_enabled=False)
            if form == "td" else dict(agc_enabled=True, agc_window_size=256,
                                      agc_link_group=2, output_clip=0.99))
    cfg = StreamConfig(samplerate=44100, blocksize=1024, batch=64,
                       conv_strategy="td_mxu", dither_kind="off", **over)
    pipe = Pipeline(cfg, dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    x = randn(dev, 3, 64, 1024, seed=8) * 0.2
    ust, gold = pipe.run(params, pipe.init_state(), x)
    sp = ShardedPipeline(cfg, make_mesh(2, devices=[dev] * 2))
    st, outs = sp.init_state(), []
    for blk in x:
        st, y = sp.step(params, st, blk)
        outs.append(y)
    _, yr = sp.run(params, sp.init_state(), x)
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(outs), gold) and torch.equal(yr, gold)
    tail, utail = st.gather("conv_tail"), ust.conv_tail
    for a, b in (zip(tail, utail) if isinstance(tail, tuple)
                 else [(tail, utail)]):
        assert torch.equal(a, b)
    print(f"{form}: 2 shards of the card == unsharded")


def _traced_device_ops(fn):
    """Run `fn` under `torch.profiler` with the program's trace records
    emptied first; returns (the records, the names of the device operations
    in the profiler's trace: kernels and copies, not the spans' mirrors)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from afp_tpu_torch.utils import trace

    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    recs = [r for r in trace.records() if r is not None]
    trace.clear()
    return recs, ops


_SERVE_FORMS = {
    # the C5 mega ring (K4 and its tail), f32 in and out
    "mega": (dict(upsample_factor=4, numtaps=1001, eq_enabled=False), True),
    # the C8 AGC ring (the EQ's taps, K5, K6, K7 and its tail), 16-bit PCM
    "agc": (dict(upsample_factor=2, numtaps=129, eq_enabled=True,
                 agc_enabled=True, agc_window_size=512, output_clip=0.99,
                 ingest="pcm16", emit="pcm16"), False),
    # f32 blocks split on the card into the pair rings (K13 mega)
    "pair": (dict(upsample_factor=2, numtaps=65, eq_enabled=False,
                  ingest="pair"), True),
    # a filter bank with interleaved designs: the packing's two gathers
    "packed": (dict(upsample_factor=2, numtaps=65, eq_enabled=False), False),
}


@pytest.mark.parametrize("form", list(_SERVE_FORMS))
def test_traced_ops_equal_the_profilers_device_operations(dev, form):
    """A served stream under `torch.profiler`: the ``ops`` the pump and the
    dispatch count equal the device operations in the profiler's trace of
    the same blocks, one for one, and no span of the program is among
    them."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
    from afp_tpu_torch.engine.batch import with_per_stream_filters
    from afp_tpu_torch.runtime import RingServer

    over, mega = _SERVE_FORMS[form]
    cfg = StreamConfig(**{**dict(samplerate=44100, blocksize=1024, batch=32,
                                 cutoff=9000.0, downsample_mode="decimate",
                                 conv_strategy="td_mxu", dither_kind="tpdf"),
                          **over})
    pipe = Pipeline(cfg, dev)
    packing = None
    if form == "packed":
        params, packing = with_per_stream_filters(
            pipe, [dict(cutoff=4000.0 if i % 2 else 12000.0)
                   for i in range(32)], pack=True)
    else:
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
    srv = RingServer(pipe, params, slots=12, chunk=4, max_inflight=2, seed=5,
                     mega=mega, packing=packing)
    rng = np.random.default_rng(3)
    if cfg.ingest == "pcm16":
        blks = [(rng.standard_normal((32, 1024)) * 3000).astype(np.int16)
                for _ in range(10)]
    else:
        blks = [(rng.standard_normal((32, 1024)) * 0.2).astype(np.float32)
                for _ in range(10)]
    list(srv.stream(iter(blks)))  # every shape once, before the profiler
    recs, ops = _traced_device_ops(lambda: list(srv.stream(iter(blks))))
    counted = sum(r[5].get("ops", 0) for r in recs)
    land = [r for r in recs if r[0] == "afp.serve.land"]
    print(f"{form}: {counted} ops counted, {len(ops)} in the trace "
          f"({len(land)} blocks): {sorted(set(ops))}")
    assert len(land) == 10 and counted == len(ops)
    assert not [n for n in ops if n.startswith("afp.")]


def test_traced_ops_count_the_tail_pads(dev):
    """A tail narrower than k_pad is padded on the card before the ring and
    pair kernels: the pads' operations are counted with the kernels'."""
    from afp_tpu_torch.ops.cuda import device_launches
    from afp_tpu_torch.utils import trace

    h = randn(dev, 33, seed=1)
    ring = randn(dev, 2, 16, 256, seed=2)
    out = torch.zeros_like(ring)
    tail = randn(dev, 16, 20, seed=3)
    xh, xl = F.split_bf16(randn(dev, 16, 256, seed=4))
    th, tl = F.split_bf16(randn(dev, 16, 32, seed=5))

    def run():
        with trace.span("afp.test.pads", counter=device_launches):
            F.fir_td_mxu_ring_f32(ring, 1, tail, h, out)
            F.fir_td_mxu_pair_to_ring(xh, xl, th, tl, h, 0, out)

    run()
    recs, ops = _traced_device_ops(run)
    print(f"pads: {recs[0][5]} against {ops}")
    assert recs[0][5]["ops"] == len(ops)


_LANDING_FORMS = {
    # C5's mega ring at its served block (64 MiB), f32 in and out
    "c5_f32": (dict(blocksize=4096, upsample_factor=4, numtaps=1001,
                    eq_enabled=False), True),
    # C8's AGC ring at its served block (16 MiB), 16-bit PCM in and out
    "c8_pcm16": (dict(blocksize=2048, upsample_factor=2, numtaps=129,
                      eq_enabled=True, agc_enabled=True, agc_window_size=512,
                      output_clip=0.99, ingest="pcm16", emit="pcm16"), False),
}


def _landing_pipe(dev, form, n_blocks):
    """A served cell's pipeline at batch 4096 and `n_blocks` of its input."""
    from afp_tpu_torch.engine import Pipeline, StreamConfig

    over, mega = _LANDING_FORMS[form]
    cfg = StreamConfig(**{**dict(samplerate=44100, batch=4096, cutoff=11000.0,
                                 downsample_mode="decimate",
                                 conv_strategy="td_mxu", dither_kind="tpdf"),
                          **over})
    rng = np.random.default_rng(19)
    shape = (cfg.batch, cfg.blocksize)
    if cfg.ingest == "pcm16":
        blks = [(rng.standard_normal(shape, dtype=np.float32) * 3000
                 ).astype(np.int16) for _ in range(n_blocks)]
    else:
        blks = [rng.standard_normal(shape, dtype=np.float32) * 0.2
                for _ in range(n_blocks)]
    return Pipeline(cfg, dev), mega, blks


@pytest.mark.parametrize("form", list(_LANDING_FORMS))
def test_native_stage_keeps_buffers_until_copied(dev, form, monkeypatch):
    """Blocks staged natively while a spin kernel stalls the stream before
    every dispatch equal the same blocks staged with ``copy_``, bit for
    bit: no pinned buffer the native copy fills is rewritten before its
    host→device copy has run (the caching host allocator holds it), at C5
    f32's and C8 pcm16's served shapes.  11 blocks over chunks of 4 end in
    a short chunk."""
    from afp_tpu_torch.runtime import RingServer
    from afp_tpu_torch.utils import staging

    pipe, mega, blks = _landing_pipe(dev, form, 11)
    name = "run_ring_mega" if mega else "run_ring"
    run = getattr(pipe, name)

    def stalled(*args, **kwargs):
        torch.cuda._sleep(50_000_000)  # tens of ms: the copies behind wait
        return run(*args, **kwargs)

    def serve(threshold):
        monkeypatch.setattr(staging, "NATIVE_MIN_BYTES", threshold)
        srv = RingServer(pipe, slots=16, chunk=4, max_inflight=2, seed=7,
                         mega=mega)
        setattr(pipe, name, stalled)
        try:
            torch.cuda._sleep(50_000_000)
            return np.stack(list(srv.stream(iter(blks))))
        finally:
            delattr(pipe, name)

    native = serve(1)
    copied = serve(1 << 62)
    print(f"{form}: {native.shape} {native.dtype}")
    assert native.shape == (11, *blks[0].shape)
    assert np.array_equal(native, copied)


def test_stage_counts_threads_at_the_served_sizes(dev):
    """Under the profiler `afp.h2d.stage` carries ``threads`` from
    ``NATIVE_MIN_BYTES`` up (C5 f32's 64 MiB blocks) and none below (C5
    pcm16's 32 MiB, C8 pcm16's 16 MiB, one byte short of the threshold);
    a served C5 f32 stream stages every block natively, a C8 pcm16 stream
    none."""
    from afp_tpu_torch.runtime import RingServer
    from afp_tpu_torch.utils.staging import NATIVE_MIN_BYTES, to_device

    srcs = [torch.full((4096, 4096), 0.25),
            torch.full((NATIVE_MIN_BYTES,), 1, dtype=torch.uint8),
            torch.full((NATIVE_MIN_BYTES - 1,), 2, dtype=torch.uint8),
            torch.full((4096, 4096), 3, dtype=torch.int16),
            torch.full((4096, 2048), -3, dtype=torch.int16)]
    outs = []
    recs, _ = _traced_device_ops(
        lambda: outs.extend(to_device(s, device=dev) for s in srcs))
    stages = [r[5] for r in recs if r[0] == "afp.h2d.stage"]
    print(f"stages: {stages}")
    assert [c["bytes"] for c in stages] == [s.nbytes for s in srcs]
    assert [c.get("threads", 0) > 0 for c in stages] == [
        s.nbytes >= NATIVE_MIN_BYTES for s in srcs] == [True, True, False,
                                                        False, False]
    assert all(torch.equal(o.cpu(), s) for o, s in zip(outs, srcs))

    for form, native in (("c5_f32", True), ("c8_pcm16", False)):
        pipe, mega, blks = _landing_pipe(dev, form, 14)
        srv = RingServer(pipe, slots=16, chunk=4, max_inflight=2, seed=7,
                         mega=mega)
        recs, _ = _traced_device_ops(lambda: list(srv.stream(iter(blks))))
        stages = [r for r in recs if r[0] == "afp.h2d.stage"]
        print(f"{form}: {len(stages)} stages, threads "
              f"{sorted({r[5].get('threads', 0) for r in stages})}")
        assert len(stages) == 14
        assert all((r[5].get("threads", 0) > 0) == native for r in stages)
        assert all(recs[r[3]][0] == "afp.serve.land" for r in stages)


@pytest.mark.parametrize("B,T,n,K", [(12, 384, 65, 9), (5, 640, 209, 9),
                                     (7, 128, 300, 1), (37, 2048, 209, 9)])
def test_k11_pair_forms_vs_plain(dev, B, T, n, K):
    """K11's staged pair form and pair-to-ring form (the per-listener EQ
    behind the AGC) at masked rows, a tail longer than the block (300 taps:
    k_pad 384 > T = 128) and the C8-psg taps: ≤ −110 dB against their plain
    twins, the tails bit-exact; the clip and the noise fused bit for bit
    (f32 and int16 stores); the ring slot ≡ the staged output, other slots
    untouched; and the pair forms on the split of an f32 block and tail ≡
    K11's x_ext form on that f32 history and block, as K8 ≡ K1."""
    kernels = randn(dev, K, n, seed=1) * 0.3
    gains = torch.rand(B, K, generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev) * 4.0
    x, t = randn(dev, B, T), randn(dev, B, F.ring_k_pad(n), seed=3)
    xh, xl = F.split_bf16(x)
    th, tl = F.split_bf16(t)
    y, nh, nl = F.fir_td_mxu_per_stream_pair(xh, xl, th, tl, kernels, gains)
    yp, ph, pl = F.fir_td_mxu_per_stream_pair_plain(xh, xl, th, tl, kernels, gains)
    e = err_db(y, yp)
    print(f"K11 pair B={B} T={T} n={n} K={K}: {e:.1f} dB")
    assert y.shape == (B, T) and e <= CONV_DB
    assert torch.equal(nh, ph) and torch.equal(nl, pl)
    ext = torch.cat([t, x], dim=-1)[:, F.ring_k_pad(n) - (n - 1):].contiguous()
    assert torch.equal(y, F.fir_td_mxu_per_stream(ext, kernels, gains))
    ye, _, _ = F.fir_td_mxu_per_stream_pair(xh, xl, th, tl, kernels, gains, **EPI)
    assert torch.equal(ye, dither_cuda(torch.clamp(y, -0.3, 0.3), (9, 4), 16, "tpdf"))
    yi, _, _ = F.fir_td_mxu_per_stream_pair(xh, xl, th, tl, kernels, gains,
                                            emit_i16=True, **EPI)
    assert torch.equal(yi, F.quantize_pcm16(ye))
    for dtype, want in ((torch.float32, ye), (torch.int16, yi)):
        out = torch.full((3, B, T), 5, dtype=dtype, device=dev)
        out, rh, rl = F.fir_td_mxu_per_stream_pair_to_ring(
            xh, xl, th, tl, kernels, gains, 2, out, **EPI)
        assert torch.equal(out[2], want) and bool((out[:2] == 5).all())
        assert torch.equal(rh, nh) and torch.equal(rl, nl)
    pout = torch.zeros((3, B, T), device="cpu")
    pout, _, _ = F.fir_td_mxu_per_stream_pair_to_ring_plain(
        xh.cpu(), xl.cpu(), th.cpu(), tl.cpu(), kernels.cpu(), gains.cpu(), 1,
        pout)
    assert err_db(pout[1], y) <= CONV_DB


def _psg_pipe(dev, B, T, ingest, emit, seed=11):
    """The C8-psg chain (AGC, 2×, 129 taps, the 9-band EQ, clip 0.99,
    TPDF) at batch B, block T, with seeded per-stream gains in 0-4."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig, batch

    cfg = StreamConfig(samplerate=44100, blocksize=T, upsample_factor=2,
                       numtaps=129, batch=B, cutoff=14000.0, eq_enabled=True,
                       agc_enabled=True, agc_window_size=512, agc_carry=True,
                       output_clip=0.99, dither_kind="tpdf",
                       downsample_mode="decimate", conv_strategy="td_mxu",
                       ingest=ingest, emit=emit)
    pipe = Pipeline(cfg, dev)
    gains = (np.random.default_rng(seed).integers(0, 41, (B, 9)) / 10.0
             ).astype(np.float32)
    params = batch.with_per_stream_gains(
        pipe, pipe.device_params(PipelineParams.design(pipe.cfg)), gains)
    return pipe, params


def _psg_blocks(n, B, T, ingest, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, B, T)) * 10 ** rng.uniform(-2, -0.2, (n, B, 1))
    if ingest == "pcm16":
        return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    return x.astype(np.float32)


@pytest.mark.parametrize("B,T,ingest,emit", [
    (32, 1024, "f32", "f32"), (32, 1024, "pcm16", "pcm16"),
    (4096, 2048, "pcm16", "pcm16")])
def test_per_stream_agc_ring_equals_staged(dev, B, T, ingest, emit):
    """Per-stream EQ gains on the AGC ring (K5 → K6 → K11 pair-to-ring)
    ≡ the staged steps (K5 → K6 → K11 pair), bit for bit on the card over
    6 blocks with the dither on, at a small batch and at the served cell's
    shape (4096 listeners × 2048 samples, 16-bit PCM): outputs, the pair
    tail and the gain carry; and through `RingServer`."""
    from afp_tpu_torch.runtime import RingServer

    pipe, params = _psg_pipe(dev, B, T, ingest, emit)
    xs = _psg_blocks(6, B, T, ingest)
    st = pipe.init_state(seed=7)
    outs = []
    for x in xs:
        st, y = pipe.step(params, st, x)
        outs.append(y)
    staged = torch.stack(outs)
    before = F.fir_td_mxu_per_stream_pair_to_ring.launches
    ring = torch.as_tensor(xs, device=dev)
    out = torch.zeros(xs.shape, dtype=pipe.out_dtype, device=dev)
    rs, out = pipe.run_ring(params, pipe.init_state(seed=7), ring, None, out, 6)
    assert F.fir_td_mxu_per_stream_pair_to_ring.launches == before + 6
    assert torch.equal(out, staged)
    assert all(torch.equal(a, b) for a, b in zip(rs.conv_tail, st.conv_tail))
    assert torch.equal(rs.agc_gain, st.agc_gain)
    srv = RingServer(pipe, params, slots=8, chunk=2, max_inflight=2, seed=7)
    served = np.stack(list(srv.stream(iter(xs))))
    assert np.array_equal(served, staged.cpu().numpy())
    print(f"psg ring B={B} T={T} {ingest}/{emit}: served == staged")


def test_traced_ops_of_the_per_stream_ring(dev):
    """The per-listener EQ ring served under `torch.profiler`: the counted
    ``ops`` equal the trace's device operations one for one (K5, K6, K11
    and its tail a block, no shared taps computed, and each chunk's CUDA
    graph captured here, the second time it is dispatched, with the two
    fills of the capture's start), one ``afp.pipe.eq_mix`` span a block
    with its counts, and each mix one `fir_ps_kernel` operation."""
    from collections import Counter

    from afp_tpu_torch.runtime import RingServer

    pipe, params = _psg_pipe(dev, 32, 1024, "pcm16", "pcm16")
    srv = RingServer(pipe, params, slots=12, chunk=4, max_inflight=2, seed=5)
    blks = list(_psg_blocks(10, 32, 1024, "pcm16"))
    list(srv.stream(iter(blks)))  # every shape once, before the profiler
    recs, ops = _traced_device_ops(lambda: list(srv.stream(iter(blks))))
    counted = sum(r[5].get("ops", 0) for r in recs
                  if r[0] != "afp.pipe.eq_mix")
    mixes = [r[5] for r in recs if r[0] == "afp.pipe.eq_mix"]
    ring = sum(r[5].get("ops", 0) for r in recs if r[0] == "afp.pipe.run_ring")
    by_span = Counter()
    for r in recs:
        by_span[r[0]] += r[5].get("ops", 0)
    print(f"psg: {counted} ops counted ({dict(by_span)}), {len(ops)} in the "
          f"trace: {dict(Counter(n[:40] for n in ops))}; first {ops[:6]}")
    caps = sum(r[5].get("captures", 0) for r in recs
               if r[0] == "afp.pipe.run_ring")
    assert counted == len(ops) and ring == 4 * 10 + 2 * caps and caps == 3
    assert len(mixes) == 10 and all(
        m == dict(rows=32, bands=9, taps=pipe.n_casc, samples=32 * 1024,
                  bytes=2 * 32 * 1024) for m in mixes)
    assert sum("fir_ps_kernel" in n for n in ops) == 10


# ------------------------------------------- direct landing (the pump's DMA)

_DIRECT_FORMS = {
    # C5's mega ring (K4), f32 in and out
    "c5_f32_mega": (dict(upsample_factor=4, numtaps=1001, eq_enabled=False,
                         cutoff=11000.0), True),
    # C5's mega ring on 16-bit PCM (K12's megakernel form)
    "c5_pcm16": (dict(upsample_factor=4, numtaps=1001, eq_enabled=False,
                      cutoff=11000.0, ingest="pcm16", emit="pcm16"), True),
    # C8's AGC ring (K5, K6, K7), its chunks replayed from CUDA graphs
    "c8_agc_graphs": (dict(upsample_factor=2, numtaps=129, eq_enabled=True,
                           agc_enabled=True, agc_window_size=512,
                           output_clip=0.99, cutoff=14000.0, ingest="pcm16",
                           emit="pcm16"), False),
    # each listener's own EQ gains on the AGC ring (K11 pair-to-ring)
    "c8_psg": (None, False),
}
_DIRECT_B, _DIRECT_T, _DIRECT_N = 256, 1024, 29  # 14 chunks of 2, then 1
_STALL = 20_000_000  # spin cycles: ~10 ms a stall


def _direct_case(dev, form):
    """(pipeline, params, mega, [n, B, T] input, the mid-serve changes
    ``{output index: f(server)}``) of a direct-landing form."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig

    B, T, n = _DIRECT_B, _DIRECT_T, _DIRECT_N
    over, mega = _DIRECT_FORMS[form]
    if over is None:
        pipe, params = _psg_pipe(dev, B, T, "pcm16", "pcm16")
        gains = (np.random.default_rng(5).integers(0, 41, (B, 9)) / 10.0
                 ).astype(np.float32)
        swapped = params._replace(eq_gains=params.eq_gains.flip(0))
        changes = {5: lambda srv: srv.swap_params(swapped),
                   11: lambda srv: srv.set_eq_gains(gains)}
        return pipe, params, mega, _psg_blocks(n, B, T, "pcm16"), changes
    cfg = StreamConfig(**{**dict(samplerate=44100, blocksize=T, batch=B,
                                 downsample_mode="decimate",
                                 conv_strategy="td_mxu", dither_kind="tpdf"),
                          **over})
    pipe = Pipeline(cfg, dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    other = dataclasses.replace(cfg, cutoff=cfg.cutoff * 0.6)
    retuned = (dataclasses.replace(cfg, agc_target_level=0.2)
               if cfg.agc_enabled else dataclasses.replace(cfg, cutoff=9000.0))
    swapped = pipe.device_params(PipelineParams.design(other))
    changes = {5: lambda srv: srv.swap_params(swapped),
               11: lambda srv: srv.retune(retuned)}
    x = _psg_blocks(n, B, T, cfg.ingest, seed=13)
    return pipe, params, mega, x, changes


def _serve_direct(dev, form, monkeypatch, direct, stalls=False,
                  overwrite=False):
    """Serve a form's input through one `RingServer`, the caller handing the
    pump 3 buffers of its own in turn (views of one array), and applying
    the mid-serve changes; returns (the outputs [n, B, T], the landings
    that went direct).  `direct` False serves with direct landing off:
    today's one-stream staging.  `stalls`: a spin kernel on the compute
    stream before each dispatch and on the landing stream before each
    landing.  `overwrite`: the caller writes garbage into the buffer it
    handed over right after the pump's next `next()`, and into all three
    after each output."""
    from afp_tpu_torch.runtime import RingServer, serving

    pipe, params, mega, xs, changes = _direct_case(dev, form)
    with monkeypatch.context() as m:
        if not direct:
            m.setattr(serving, "lands_directly", lambda *a: False)
        srv = RingServer(pipe, params, slots=8, chunk=2, max_inflight=2,
                         seed=7, mega=mega)
    assert (srv._land_stream is not None) == direct
    hits = []
    land = serving.land

    def counted(*args):
        ev = land(*args)
        hits.append(ev is not None)
        return ev

    monkeypatch.setattr(serving, "land", counted)
    name = "run_ring_mega" if mega else "run_ring"
    if stalls:
        run, land_block = getattr(pipe, name), srv._land

        def stalled(*args, **kwargs):
            torch.cuda._sleep(_STALL)
            return run(*args, **kwargs)

        def late_land(slot, block):
            with torch.cuda.stream(srv._land_stream):
                torch.cuda._sleep(_STALL)
            return land_block(slot, block)

        setattr(pipe, name, stalled)
        srv._land = late_land
    junk = np.full(xs.shape[1:], np.nan if xs.dtype == np.float32 else 23130,
                   dtype=xs.dtype)
    bufs = np.empty((3, *xs.shape[1:]), dtype=xs.dtype)

    def source():
        for k, x in enumerate(xs):
            buf = bufs[k % 3]
            buf[...] = x
            yield buf
            if overwrite:
                buf[...] = junk

    outs = []
    try:
        for out in srv.stream(source()):
            outs.append(out.copy())
            if overwrite:
                bufs[...] = junk
            if len(outs) in changes:
                changes[len(outs)](srv)
    finally:
        if stalls:
            delattr(pipe, name)
        srv.close()
    if direct and form == "c8_agc_graphs":
        assert srv._graphs.graphed > 0
    return np.stack(outs), sum(hits)


@pytest.mark.parametrize("form", list(_DIRECT_FORMS))
def test_direct_landing_equals_staged(dev, form, monkeypatch):
    """Direct landing ≡ today's one-stream staged landing, bit for bit, at
    C5 f32's mega ring, C5 pcm16's, C8's AGC ring under graph replay and
    the per-listener ring: with spin kernels stalling the compute stream
    before each dispatch and the landing stream before each landing, a
    short final chunk, a `swap_params` and a `retune` (or new per-stream
    gains) mid-serve, and a caller that overwrites its buffers with garbage
    right after each `next()` and after each output.  Every block from the
    fourth on lands directly (the three buffers, views of one array, are
    each handed again)."""
    staged, none = _serve_direct(dev, form, monkeypatch, direct=False)
    plain, hits = _serve_direct(dev, form, monkeypatch, direct=True)
    busy, busy_hits = _serve_direct(dev, form, monkeypatch, direct=True,
                                    stalls=True, overwrite=True)
    print(f"{form}: {staged.shape} {staged.dtype}, direct {hits} and "
          f"{busy_hits} of {_DIRECT_N}")
    assert none == 0 and hits == busy_hits == _DIRECT_N - 3
    assert staged.shape == (_DIRECT_N, _DIRECT_B, staged.shape[-1])
    assert np.array_equal(plain, staged)
    assert np.array_equal(busy, staged)


def test_direct_count_follows_the_second_sighting(dev):
    """Under the profiler, a caller cycling three blocks of one array: the
    first sighting of each block is staged, the second sighting of the
    first block registers the array once (``afp.h2d.register``, the
    array's bytes) and lands directly, and so does every later block:
    ``direct`` on ``afp.serve.land`` counts the blocks landed from the
    second sighting on, and a direct landing has an ``afp.h2d.copy`` (one
    counted operation) and an ``afp.h2d.wait``, and no stage or pin span.
    Fresh arrays each block, and one array walked through once, never land
    directly."""
    from afp_tpu_torch.runtime import RingServer

    pipe, params = _psg_pipe(dev, 32, 1024, "pcm16", "pcm16")
    pool = _psg_blocks(10, 32, 1024, "pcm16")
    srv = RingServer(pipe, params, slots=12, chunk=4, max_inflight=2, seed=5)
    list(srv.stream(iter([b.copy() for b in pool])))  # shapes warmed, fresh
    cycled = [pool[k % 3] for k in range(10)]
    recs, ops = _traced_device_ops(lambda: list(srv.stream(iter(cycled))))
    lands = [r for r in recs if r[0] == "afp.serve.land"]
    kids = {}
    for r in recs:
        if r[3] >= 0 and recs[r[3]][0] == "afp.serve.land":
            kids.setdefault(r[3], []).append(r[0])
    regs = [r[5] for r in recs if r[0] == "afp.h2d.register"]
    print(f"direct: {[r[5].get('direct', 0) for r in lands]}, register "
          f"{regs}, children {[kids.get(recs.index(r)) for r in lands[:3]]}")
    assert [r[5].get("direct", 0) for r in lands] == [0] * 3 + [1] * 7
    assert regs == [dict(bytes=pool.nbytes)]
    for r in lands[3:]:
        names = kids[recs.index(r)]
        assert "afp.h2d.wait" in names and "afp.h2d.copy" in names
        assert "afp.h2d.stage" not in names and "afp.h2d.pin" not in names
    copies = [r[5] for r in recs if r[0] == "afp.h2d.copy"]
    assert copies == [dict(bytes=pool[0].nbytes, ops=1)] * 10
    assert sum(n.startswith("Memcpy HtoD") for n in ops) <= 10
    for blocks in ([b.copy() for b in pool], pool.copy()):
        recs, _ = _traced_device_ops(lambda: list(srv.stream(iter(blocks))))
        assert sum(r[5].get("direct", 0) for r in recs) == 0
        assert not [r for r in recs if r[0] == "afp.h2d.register"]
    used = srv._pins.used  # the process's: other servers' too
    srv.close()
    assert all(o is not pool for o in srv._pins.held())
    assert srv._pins.used == used - pool.nbytes


def test_failed_registration_stages_and_the_card_goes_on(dev):
    """Blocks in memory that is page-locked already (a pinned tensor's,
    handed as NumPy views): registering it fails, so every block is staged,
    and the runtime's error is not left for a later launch to raise; the
    outputs are those of the same blocks in pageable memory, landed
    directly."""
    from afp_tpu_torch.runtime import RingServer

    pipe, params = _psg_pipe(dev, 32, 1024, "pcm16", "pcm16")
    pool = _psg_blocks(6, 32, 1024, "pcm16")
    locked = torch.from_numpy(pool).pin_memory()
    one = RingServer(pipe, params, slots=8, chunk=2, max_inflight=2, seed=5)
    want = np.stack(list(one.stream(pool[k % 3] for k in range(6))))
    two = RingServer(pipe, params, slots=8, chunk=2, max_inflight=2, seed=5)
    got = np.stack(list(two.stream(locked.numpy()[k % 3]
                                   for k in range(6))))
    st = locked.untyped_storage()
    assert all(o is not st for o in two._pins.held())
    assert two._pins._in(two._pins._refused, st)
    torch.zeros(4, device=dev).add_(1)
    torch.cuda.synchronize()
    assert np.array_equal(got, want)
    one.close()
    two.close()


def test_two_servers_share_one_registration(dev):
    """Two live servers over one array: the array is registered once, in
    the process's cache, and both land its blocks directly; it stays
    registered until the second server is closed, and both serve the same
    outputs."""
    from afp_tpu_torch.runtime import RingServer
    from afp_tpu_torch.runtime import serving

    pipe, params = _psg_pipe(dev, 32, 1024, "pcm16", "pcm16")
    pool = _psg_blocks(6, 32, 1024, "pcm16")
    direct = []
    land = serving.land

    def counted(*args):
        ev = land(*args)
        direct.append(ev is not None)
        return ev

    servers = [RingServer(pipe, params, slots=8, chunk=2, max_inflight=2,
                          seed=5) for _ in range(2)]
    outs = []
    try:
        serving.land = counted
        for srv in servers:
            outs.append(np.stack(list(srv.stream(pool[k % 3]
                                                 for k in range(6)))))
    finally:
        serving.land = land
    assert direct == [False] * 3 + [True] * 9
    assert sum(o is pool for o in _pins_held()) == 1
    servers[0].close()
    assert sum(o is pool for o in _pins_held()) == 1
    servers[1].close()
    assert all(o is not pool for o in _pins_held())
    assert np.array_equal(outs[0], outs[1])


def _pins_held():
    from afp_tpu_torch.utils.host_pins import PINS

    return PINS.held()
