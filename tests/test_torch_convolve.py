"""The port's FFT convolution ops (`afp_tpu_torch/ops/convolve.py`) against
`afp_tpu.ops.convolve` and the float64 oracle on the CPU, in every regime
of `tests/test_convolve.py`: the same seeded numpy inputs through both
packages.  Bounds: ≤ −100 dB against `afp_tpu` (two f32 FFT libraries),
< −90 dB against scipy/numpy float64 (the reference's contract); each test
prints what it measured."""
import numpy as np
import pytest
import scipy.signal as sps
import torch

from afp_tpu.ops import OverlapAdd as JOverlapAdd
from afp_tpu.ops import OverlapSave as JOverlapSave
from afp_tpu.ops import fft_convolve as j_fft_convolve
from afp_tpu_torch.ops import (OverlapAdd, OverlapSave, fft_convolve,
                               kernel_rfft, next_pow2)

REF_DB, ORACLE_DB = -100.0, -90.0


def err_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def stream(state, sig, L):
    """Run a streaming state over `sig` [..., n·L] in blocks of L."""
    outs = []
    for b in range(sig.shape[-1] // L):
        state, y = state.process(sig[..., b * L:(b + 1) * L])
        outs.append(np.asarray(y))
    return state, np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("T,N", [(4096, 301), (2048, 129), (1000, 51), (512, 512)])
def test_fft_convolve_matches_reference(rng, mode, T, N):
    x = rng.normal(size=T).astype(np.float32)
    h = rng.normal(size=N).astype(np.float32)
    ours = fft_convolve(torch.from_numpy(x), torch.from_numpy(h), mode=mode).numpy()
    ref = np.asarray(j_fft_convolve(x, h, mode=mode))
    gold = sps.oaconvolve(x.astype(np.float64), h.astype(np.float64), mode=mode)
    e_ref, e_gold = err_db(ours, ref), err_db(ours, gold)
    print(f"{mode} T={T} N={N}: {e_ref:.1f} dB vs afp_tpu, {e_gold:.1f} dB vs scipy")
    assert ours.shape == ref.shape == gold.shape
    assert e_ref <= REF_DB and e_gold < ORACLE_DB


@pytest.mark.parametrize("per_stream", [False, True])
def test_fft_convolve_batched(rng, per_stream):
    """[B, T] signals against one kernel ('same') or a kernel per stream
    ('valid'), as `tests/test_convolve.py` runs them."""
    B, T, N = (4, 1024, 129) if per_stream else (8, 2048, 301)
    x = rng.normal(size=(B, T)).astype(np.float32)
    h = rng.normal(size=(B, N) if per_stream else N).astype(np.float32)
    mode = "valid" if per_stream else "same"
    ours = fft_convolve(x, h, mode=mode).numpy()
    ref = np.asarray(j_fft_convolve(x, h, mode=mode))
    gold = np.stack([sps.oaconvolve(x[i].astype(np.float64),
                                    (h[i] if per_stream else h).astype(np.float64),
                                    mode=mode) for i in range(B)])
    e_ref = err_db(ours, ref)
    e_gold = max(err_db(ours[i], gold[i]) for i in range(B))
    print(f"batched per_stream={per_stream}: {e_ref:.1f} dB vs afp_tpu, "
          f"worst row {e_gold:.1f} dB vs scipy")
    assert e_ref <= REF_DB and e_gold < ORACLE_DB


def test_fft_convolve_valid_needs_long_signal():
    with pytest.raises(ValueError):
        fft_convolve(np.zeros(10, np.float32), np.ones(11, np.float32), mode="valid")
    with pytest.raises(ValueError):
        fft_convolve(np.zeros(10, np.float32), np.ones(3, np.float32), mode="x")


@pytest.mark.parametrize("N,L,B", [(301, 1024, ()), (129, 512, (6,))])
def test_overlap_save_streaming_equivalence(rng, N, L, B):
    """Blocked OverlapSave == the zero-primed one-shot valid conv, and ==
    `afp_tpu`'s blocked OverlapSave."""
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=B + (L * 6,)).astype(np.float32)
    _, ours = stream(OverlapSave.init(h, block=L, batch_shape=B), sig, L)
    _, ref = stream(JOverlapSave.init(h, block=L, batch_shape=B), sig, L)
    rows = sig.reshape(-1, sig.shape[-1]).astype(np.float64)
    gold = np.stack([np.convolve(np.concatenate([np.zeros(N - 1), r]), h, "valid")
                     for r in rows]).reshape(ours.shape)
    e_ref, e_gold = err_db(ours, ref), err_db(ours, gold)
    print(f"OverlapSave N={N} L={L} batch {B}: {e_ref:.1f} dB vs afp_tpu, "
          f"{e_gold:.1f} dB vs numpy")
    assert ours.shape == gold.shape and e_ref <= REF_DB and e_gold < ORACLE_DB


@pytest.mark.parametrize("N,L", [
    (513, 128),   # N−1 = 4·L: the carry spans 4 blocks
    (2048, 256),  # the config-clamp extremes (numtaps 2048, blocksize 256)
    (301, 1024),  # short-filter regime
    (257, 256),   # N−1 exactly == L
    (258, 256),   # N−1 == L+1 (one carried sample)
])
def test_overlap_add_streaming_equivalence_all_regimes(rng, N, L):
    """Streaming ≡ one shot for every (N, L), including N−1 > L, where the
    reference's own OverlapAddFilter is wrong (not reproduced)."""
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=L * 8).astype(np.float32)
    _, ours = stream(OverlapAdd.init(h, block=L), sig, L)
    _, ref = stream(JOverlapAdd.init(h, block=L), sig, L)
    gold = np.convolve(sig.astype(np.float64), h.astype(np.float64))[: len(sig)]
    e_ref, e_gold = err_db(ours, ref), err_db(ours, gold)
    print(f"OverlapAdd N={N} L={L}: {e_ref:.1f} dB vs afp_tpu, {e_gold:.1f} dB "
          f"vs numpy")
    assert e_ref <= REF_DB and e_gold < ORACLE_DB


def test_overlap_add_long_filter_batched(rng):
    N, L, B = 513, 128, 3
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=(B, L * 10)).astype(np.float32)
    _, ours = stream(OverlapAdd.init(h, block=L, batch_shape=(B,)), sig, L)
    gold = np.stack([np.convolve(r.astype(np.float64), h)[: L * 10] for r in sig])
    e = max(err_db(ours[i], gold[i]) for i in range(B))
    print(f"OverlapAdd batched long filter: worst row {e:.1f} dB vs numpy")
    assert e < ORACLE_DB


def test_overlap_add_short_filter_identity():
    """An empty kernel is the identity (`stream_process_GUI_Presets.py:46-48`)."""
    state = OverlapAdd.init(np.array([], dtype=np.float32), block=256)
    x = np.linspace(-1, 1, 256).astype(np.float32)
    _, y = state.process(x)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-6)


@pytest.mark.parametrize("cls", [OverlapSave, OverlapAdd])
def test_kernel_swap_no_shape_change(rng, cls):
    """with_kernel swaps the spectrum and keeps every shape; a tap count
    change raises; process leaves the state it was called on intact."""
    h1, h2 = (rng.normal(size=101).astype(np.float32) for _ in range(2))
    x = rng.normal(size=512).astype(np.float32)
    s0 = cls.init(h1, block=512)
    s1, y1 = s0.process(x)
    _, y1_again = s0.process(x)
    np.testing.assert_array_equal(y1.numpy(), y1_again.numpy())
    s2 = s1.with_kernel(h2)
    assert s2.H.shape == s1.H.shape and s2.nfft == s1.nfft == next_pow2(612)
    torch.testing.assert_close(s2.H, kernel_rfft(h2, s1.nfft))
    _, y = s2.process(x)
    assert np.all(np.isfinite(y.numpy()))
    with pytest.raises(ValueError):
        s2.with_kernel(rng.normal(size=55).astype(np.float32))
