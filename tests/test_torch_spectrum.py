"""The port's spectrum ops and `freqz_torch` against `afp_tpu`'s on the
CPU, on the same seeded numpy inputs.  Float spectra are compared as
magnitudes ``10^(dB/20)`` relative to each row's maximum (never as raw dB
near the −200 floor); the numpy copies and the ring layout bit for bit.
Each test states its bound and prints the measured value."""
import numpy as np
import pytest
import torch

from afp_tpu.design.freqz import freqz_jax
from afp_tpu.ops import spectrum as J
from afp_tpu_torch.design import freqz_torch
from afp_tpu_torch.ops import spectrum as S

#: two f32 FFT libraries: the rfft class of `afp_tpu`'s 'fft' contract
SPECTRUM_DB = -110.0
#: freqz's direct branch: float32 phase products summed over many taps
DIRECT_DB = -100.0


def rel_mag_db(a_db, b_db) -> float:
    """Worst row of max |10^(a/20) − 10^(b/20)| over the row's max
    magnitude of `b`, in dB."""
    ma = 10.0 ** (np.asarray(a_db, np.float64) / 20.0)
    mb = 10.0 ** (np.asarray(b_db, np.float64) / 20.0)
    err = np.abs(ma - mb).max(axis=-1) / mb.max(axis=-1)
    return float(20 * np.log10(err.max() + 1e-300))


def err_db(a, b) -> float:
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return float(20 * np.log10(np.abs(a - b).max() / np.abs(b).max() + 1e-300))


def noise(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("shape", [(2048,), (3, 512), (2, 2, 256)])
def test_spectrum_db_against_afp_tpu(shape):
    x = noise(shape, seed=len(shape))
    got = S.spectrum_db(torch.from_numpy(x))
    want = np.asarray(J.spectrum_db(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    e = rel_mag_db(got.numpy(), want)
    print(f"spectrum_db {shape}: {e:.1f} dB (bound {SPECTRUM_DB})")
    assert e <= SPECTRUM_DB


def test_spectrum_db_window_tensor_equals_default():
    """A window passed once as a tensor (the pipeline's form) gives the
    default window's bits."""
    from afp_tpu_torch.design.windows import hann

    x = torch.from_numpy(noise((4, 256), seed=3))
    w = torch.as_tensor(hann(256), dtype=torch.float32)
    assert torch.equal(S.spectrum_db(x, w), S.spectrum_db(x))


@pytest.mark.parametrize("T,fs", [(256, 44100.0), (2048, 48000.0),
                                  (4096, 88200.0), (1000, 8000.0)])
def test_numpy_copies_bit_exact(T, fs):
    x = noise((3, T), seed=T)
    assert np.array_equal(S.spectrum_freqs(T, fs), J.spectrum_freqs(T, fs))
    a, b = S.spectrum_db_np(x), J.spectrum_db_np(x)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    w = np.linspace(0.1, 1.0, T)
    assert np.array_equal(S.spectrum_db_np(x[0], w, floor=1e-6),
                          J.spectrum_db_np(x[0], w, floor=1e-6))


def test_waterfall_layout_bit_exact():
    """init and 60 pushes ≡ `afp_tpu`'s (newest last, −200 primed, the
    oldest rows dropped), and every push leaves the ring it was given
    intact."""
    rows = noise((60, 3, 129), seed=5) * 100
    ring = S.waterfall_init(129, batch_shape=(3,))
    jring = J.waterfall_init(129, batch_shape=(3,))
    assert ring.shape == (3, S.WATERFALL_DEPTH, 129) == tuple(jring.shape)
    assert S.WATERFALL_DEPTH == J.WATERFALL_DEPTH == 50
    for i, r in enumerate(rows):
        before = ring.clone()
        nxt = S.waterfall_push(ring, torch.from_numpy(r))
        assert torch.equal(ring, before)
        ring, jring = nxt, J.waterfall_push(jring, r)
        assert np.array_equal(ring.numpy(), np.asarray(jring)), i
        if i == 5:
            assert torch.all(ring[:, :-6] == -200.0)


def test_spectrum_peak_on_tones():
    """Tones peak at their bin (first index on ties, as `jnp.argmax`), and
    the (freq, level) pairs ≡ `afp_tpu`'s on the same dB rows."""
    fs, T = 44100.0, 2048
    t = np.arange(T) / fs
    tones = np.stack([np.sin(2 * np.pi * f * t) for f in (440.0, 1000.0, 9000.0)])
    db = S.spectrum_db(torch.from_numpy(tones.astype(np.float32)))
    freqs = S.spectrum_freqs(T, fs)
    f, lvl = S.spectrum_peak(db, freqs)
    jf, jl = J.spectrum_peak(db.numpy(), freqs)
    print("peaks:", f.tolist())
    assert np.array_equal(f.numpy(), np.asarray(jf))
    assert np.array_equal(lvl.numpy(), np.asarray(jl))
    assert np.all(np.abs(f.numpy() - [440.0, 1000.0, 9000.0]) < fs / T)
    tie = torch.tensor([[-3.0, 5.0, 5.0, 1.0]])
    ft, lt = S.spectrum_peak(tie, np.arange(4.0))
    assert ft.item() == 1.0 and lt.item() == 5.0
    assert float(np.asarray(J.spectrum_peak(tie.numpy(), np.arange(4.0))[0])[0]) == 1.0


@pytest.mark.parametrize("n,worN,batch,bound", [
    (129, 8000, (), SPECTRUM_DB),       # rfft branch, the design grid
    (2048, 1024, (2,), SPECTRUM_DB),    # rfft branch at its edge n = 2·worN
    (3000, 512, (), DIRECT_DB),         # direct branch
    (20000, 256, (2,), DIRECT_DB),      # direct branch, long filter, batched
])
def test_freqz_torch_against_freqz_jax(n, worN, batch, bound):
    h = noise(batch + (n,), seed=n) / np.sqrt(n)
    w, H = freqz_torch(torch.from_numpy(h), worN, fs=44100.0)
    jw, jH = freqz_jax(h, worN, fs=44100.0)
    assert H.dtype == torch.complex64 and H.shape == tuple(jH.shape)
    assert w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-3)
    e = err_db(H.numpy(), np.asarray(jH))
    print(f"freqz_torch n={n} worN={worN}: {e:.1f} dB of max |H| (bound {bound})")
    assert e <= bound


def test_freqz_torch_refuses_past_the_exact_phase_bound():
    """The direct branch keeps the reference's 2·worN ≤ 2^20 bound."""
    worN = (1 << 19) + 1
    h = np.zeros(2 * worN + 1, np.float32)
    for fn in (freqz_torch, freqz_jax):
        with pytest.raises(ValueError, match="2\\^20"):
            fn(h, worN)
