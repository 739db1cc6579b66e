"""The carried waterfall (``waterfall_enabled``) of the port against
`afp_tpu`'s on the CPU: `tests/test_ui_viz.py:test_engine_scan_carried_
waterfall`'s tone setup through both engines, the audio with the waterfall
≡ without it, the forms that refuse it, and checkpoints that carry it.
Spectra are compared as magnitudes relative to each row's maximum.  Each
test states its bound and prints the measured value."""
import dataclasses

import numpy as np
import pytest
import torch

from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.engine import StreamEngine as JEngine
from afp_tpu.engine.checkpoint import save_checkpoint as jsave
from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  StreamEngine)
from afp_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from afp_tpu_torch.ops.spectrum import spectrum_db, spectrum_freqs
from afp_tpu_torch.runtime import RingServer

#: rows of two engines' rings: outputs within their path's contract
#: ('fft' −100 dB, int16 1 LSB), seen through one rfft each
ROW_DB = -95.0

#: `tests/test_ui_viz.py:196-228`: two streams, 1 kHz and 5 kHz tones
BASE = dict(samplerate=44100, blocksize=512, upsample_factor=1, numtaps=65,
            batch=2, eq_enabled=False, agc_enabled=False, dither_kind="off",
            downsample_mode="decimate", output_clip=None,
            waterfall_enabled=True, cutoff=11000.0)
CASES = {
    "fft": {},
    "td_mxu": dict(conv_strategy="td_mxu"),
    "td_mxu-emit16": dict(conv_strategy="td_mxu", emit="pcm16"),
    "fft-upsampled": dict(upsample_factor=2, output_rate="upsampled"),
}


def tones(n_blocks=6, L=512, fs=44100):
    t = np.arange(L * n_blocks) / fs
    return np.stack([0.5 * np.sin(2 * np.pi * 1000 * t),
                     0.5 * np.sin(2 * np.pi * 5000 * t)]).astype(np.float32)


def rel_mag_db(a_db, b_db) -> float:
    ma = 10.0 ** (np.asarray(a_db, np.float64) / 20.0)
    mb = 10.0 ** (np.asarray(b_db, np.float64) / 20.0)
    err = np.abs(ma - mb).max(axis=-1) / mb.max(axis=-1)
    return float(20 * np.log10(err.max() + 1e-300))


@pytest.mark.parametrize("case", list(CASES))
def test_engine_scan_carried_waterfall(case):
    """Both engines over the same tones: the newest rows agree within
    ROW_DB with equal peak bins (the tones), the 44 rows never pushed are
    exactly −200 in both."""
    kw = {**BASE, **CASES[case]}
    sig = tones()
    jeng = JEngine(JConfig(**kw))
    jeng.process_signal(sig)
    want = jeng.waterfall_ring()
    eng = StreamEngine(StreamConfig(**kw), device="cpu")
    eng.process_signal(sig)
    got = eng.waterfall_ring()
    L = eng.pipeline.out_block
    assert got.shape == want.shape == (2, 50, L // 2 + 1)
    assert np.all(got[:, :44] == -200.0) and np.all(want[:, :44] == -200.0)
    e = rel_mag_db(got[:, 44:], want[:, 44:])
    print(f"{case}: newest 6 rows {e:.1f} dB (bound {ROW_DB})")
    assert e <= ROW_DB
    peaks = np.argmax(got[:, 44:], axis=-1)
    assert np.array_equal(peaks, np.argmax(want[:, 44:], axis=-1))
    rate = 44100 * (2 if case == "fft-upsampled" else 1)
    freqs = spectrum_freqs(L, rate)
    assert abs(freqs[peaks[0, -1]] - 1000) < 200
    assert abs(freqs[peaks[1, -1]] - 5000) < 200


@pytest.mark.parametrize("case", ["fft", "td_mxu", "td_mxu-emit16",
                                  "fft-upsampled"])
def test_waterfall_leaves_the_audio_and_pushes_each_block(case):
    """Inside the port, dither on: the output with the waterfall ≡ without
    it, bit for bit, and each pushed row ≡ `spectrum_db` of the block
    emitted (int16 dequantized n/32768), bit for bit; the state passed to
    a step stays intact."""
    kw = {**BASE, **CASES[case], "dither_kind": "tpdf"}
    on = Pipeline(StreamConfig(**kw), "cpu")
    off = Pipeline(StreamConfig(**{**kw, "waterfall_enabled": False}), "cpu")
    params = on.device_params(PipelineParams.design(on.cfg))
    sig = tones(4)
    blocks = torch.from_numpy(sig.reshape(2, 4, 512).transpose(1, 0, 2).copy())
    st_on, st_off = on.init_state(seed=3), off.init_state(seed=3)
    assert st_off.wf is None
    rows = []
    for blk in blocks:
        before = st_on.wf.clone()
        nxt, y = on.step(params, st_on, blk)
        assert torch.equal(st_on.wf, before)
        st_off, y_off = off.step(params, st_off, blk)
        assert torch.equal(y, y_off)
        f = y.to(torch.float32) / 32768.0 if y.dtype == torch.int16 else y
        rows.append(spectrum_db(f))
        st_on = nxt
    assert torch.equal(st_on.wf[:, -4:], torch.stack(rows, dim=1))
    assert torch.all(st_on.wf[:, :-4] == -200.0)
    _, whole = on.process_signal(params, on.init_state(seed=3), sig)
    _, whole_off = off.process_signal(params, off.init_state(seed=3), sig)
    assert torch.equal(whole, whole_off)


@pytest.mark.parametrize("form", ["fold", "ring", "ring_server", "no_ring"])
def test_forms_without_the_waterfall(form):
    """The rings and the fold do not carry it (as `afp_tpu`'s
    `supports_ring_step`/`supports_fold`); `waterfall_ring()` raises when
    it is off."""
    kw = {**BASE, "conv_strategy": "td_mxu", "ingest": "pair"}
    p = Pipeline(StreamConfig(**kw), "cpu")
    params = p.device_params(PipelineParams.design(p.cfg))
    if form == "fold":
        assert not p.supports_fold
        with pytest.raises(ValueError, match="waterfall"):
            p.process_signal(params, p.init_state(), tones(2), fold=True)
    elif form == "ring":
        assert not p.supports_ring_step
        ring = torch.zeros(2, 2, 512, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="waterfall disabled"):
            p.ring_step(params, p.init_state(), ring, ring, 0,
                        torch.zeros(2, 2, 512))
    elif form == "ring_server":
        with pytest.raises(ValueError, match="waterfall disabled"):
            RingServer(p, params, slots=8, chunk=2)
    else:
        eng = StreamEngine(StreamConfig(**{**BASE, "waterfall_enabled": False}),
                           device="cpu")
        with pytest.raises(ValueError, match="waterfall_enabled=False"):
            eng.waterfall_ring()


def test_waterfall_through_the_ladder_and_reconfig():
    """A failed block keeps the last good ring; a dynamic `apply_config`
    keeps it; a rebuild primes a new one."""
    cfg = StreamConfig(**{**BASE, "dither_kind": "tpdf"})
    eng = StreamEngine(cfg, device="cpu")
    sig = tones(3)
    eng.process_block(sig[:, :512])
    ring = eng.waterfall_ring()
    eng.process_block(np.full((2, 512), np.nan, np.float32))
    assert eng.metrics.fallback_replays == 1
    assert np.array_equal(eng.waterfall_ring(), ring)
    assert eng.apply_config(dataclasses.replace(cfg, cutoff=9000.0))
    assert np.array_equal(eng.waterfall_ring(), ring)
    eng.process_block(sig[:, 512:1024])
    assert np.array_equal(eng.waterfall_ring()[:, -2], ring[:, -1])
    assert not eng.apply_config(dataclasses.replace(cfg, numtaps=33))
    assert np.all(eng.waterfall_ring() == -200.0)


def test_waterfall_checkpoint_port_layout(tmp_path):
    """The port's checkpoint carries the ring bit for bit, and the resumed
    stream's rings and audio ≡ the uninterrupted one's, dither on."""
    cfg = StreamConfig(**{**BASE, "dither_kind": "tpdf",
                          "conv_strategy": "td_mxu"})
    sig = tones(6)
    eng = StreamEngine(cfg, device="cpu", seed=2)
    eng.process_signal(sig[:, :1536])
    path = str(tmp_path / "wf.npz")
    save_checkpoint(path, eng)
    res = load_checkpoint(path, device="cpu")
    assert np.array_equal(res.waterfall_ring(), eng.waterfall_ring())
    a, b = eng.process_signal(sig[:, 1536:]), res.process_signal(sig[:, 1536:])
    assert np.array_equal(a, b)
    assert np.array_equal(res.waterfall_ring(), eng.waterfall_ring())


def test_waterfall_checkpoint_from_afp_tpu(tmp_path):
    """`afp_tpu`'s checkpoint carries `wf` as the last StreamState leaf
    (after the key); the port restores it bit for bit."""
    kw = {**BASE, "conv_strategy": "td_mxu"}
    jeng = JEngine(JConfig(**kw))
    jeng.process_signal(tones(3))
    path = str(tmp_path / "jwf.npz")
    jsave(path, jeng)
    eng = load_checkpoint(path, device="cpu")
    got, want = eng.waterfall_ring(), jeng.waterfall_ring()
    assert np.array_equal(got, want) and np.any(got[:, -1] > -200.0)
    eng.process_signal(tones(1))
    assert np.array_equal(eng.waterfall_ring()[:, -2], want[:, -1])
