"""The port's CUDA kernels against their plain versions on the card, at
edge shapes the smoke's headline run does not reach: ragged time tiles,
masked batch rows, one tap, k_pad > T, n_steps > S, an unaligned dither
buffer.  Marked ``cuda``: they skip without a CUDA device.  The card's
machine has no jax, so run them there without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

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
