"""The port's controller (L5), plots (L4) and the serving spectrum tap on
CPU engines: the cases of `tests/test_ui_viz.py` and of
`tests/test_serving.py:440-505`, with `compute_response` and the tap held
to `afp_tpu`'s.  Each test states its bound and prints the measured
value."""
import os
import time

import numpy as np
import pytest
import torch

from afp_tpu.ops.spectrum import spectrum_db_np as jspectrum_db_np
from afp_tpu.viz.plot_filter import compute_response as jcompute_response
from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  StreamEngine, with_per_stream_gains)
from afp_tpu_torch.ops.spectrum import (WATERFALL_DEPTH, spectrum_db,
                                        spectrum_db_np, spectrum_freqs,
                                        spectrum_peak, waterfall_init,
                                        waterfall_push)
from afp_tpu_torch.runtime import RingServer
from afp_tpu_torch.ui import DEFAULT_CONFIG, EqualizerController
from afp_tpu_torch.viz import (compute_response, matplotlib_available,
                               plot_waterfall)

#: the tap's rows against `afp_tpu`'s server: outputs of two conv classes
#: seen through one rfft each
TAP_DB = -95.0

#: `tests/test_ui_viz.py`'s controller engine
CTL = dict(samplerate=44100, blocksize=512, upsample_factor=2, numtaps=65,
           batch=1, eq_enabled=True, agc_enabled=False, dither_kind="off",
           downsample_mode="decimate", output_clip=None)

#: `tests/test_serving.py:make_cfg(ingest="f32", dither_kind="off")`
SERVE = dict(resample_quality="fast", samplerate=44100, blocksize=512,
             upsample_factor=1, numtaps=65, batch=2, filter_type="lowpass",
             cutoff=11000.0, window_type="hamming", eq_enabled=False,
             agc_enabled=False, downsample_mode="decimate", dither_kind="off",
             output_clip=None, conv_strategy="td_mxu", ingest="f32")


@pytest.fixture
def ctl(tmp_path):
    return EqualizerController(StreamEngine(StreamConfig(**CTL), device="cpu"),
                               preset_path=str(tmp_path / "p.json"))


def test_default_config_is_the_reference_gui_defaults():
    from afp_tpu.ui import DEFAULT_CONFIG as J

    assert DEFAULT_CONFIG.to_dict() == J.to_dict()


def test_gain_surface(ctl):
    assert ctl.get_gains() == [1.0] * 9
    ctl.set_gain(3, 2.5)
    assert ctl.get_gains()[3] == 2.5
    ctl.set_gains([0.5] * 9)
    assert ctl.get_gains() == [0.5] * 9


def test_apply_changes_glitch_free(ctl):
    ctl.set_field(cutoff=9000.0)
    assert ctl.apply_changes()  # dynamic-only → glitch-free
    assert ctl.engine.cfg.cutoff == 9000.0
    ctl.set_field(numtaps=129)
    assert not ctl.apply_changes()  # shape change → rebuild


def test_bandpass_cutoff_pair(ctl):
    ctl.set_field(filter_type="bandpass", cutoff_low=400.0, cutoff_high=8000.0)
    ctl.apply_changes()
    assert ctl.engine.cfg.cutoff == (400.0, 8000.0)


def test_reset_to_defaults(ctl):
    """Reset restores unity gains and the default filter design, never the
    deployment fields (a reset must not rebuild or reframe the stream)."""
    before = ctl.engine.cfg
    ctl.set_gains([2.0] * 9)
    ctl.set_field(cutoff=5000.0)
    ctl.apply_changes()
    ctl.reset_to_defaults()
    cfg = ctl.engine.cfg
    assert cfg.cutoff == 14000.0 and cfg.numtaps == 129
    assert all(abs(b.gain - 1.0) < 1e-6 for b in cfg.eq_bands)
    assert cfg.blocksize == before.blocksize
    assert cfg.upsample_factor == before.upsample_factor
    assert cfg.batch == before.batch


def test_presets_via_controller(ctl):
    ctl.set_gains([1.5] * 9)
    ctl.save_preset("loud")
    ctl.set_gains([1.0] * 9)
    assert ctl.load_preset("loud")
    assert ctl.get_gains() == [1.5] * 9
    ctl.delete_preset("loud")
    assert "loud" not in ctl.preset_names


@pytest.mark.parametrize("coeffs,fs", [
    ("design", 88200.0), ("design", 16000.0), ("noise", 44100.0)])
def test_compute_response_bit_exact(ctl, coeffs, fs):
    """The panel data ≡ `afp_tpu`'s, bit for bit (both numpy over the same
    freqz copy)."""
    h = (PipelineParams.design(ctl.engine.cfg).main_taps if coeffs == "design"
         else np.random.default_rng(9).standard_normal(301))
    a, b = compute_response(h, fs), jcompute_response(h, fs)
    for f in ("freqs", "magnitude_db", "phase_rad", "taps"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.impulse_window, a.fs, a.log_axis, a.ticks) == \
        (b.impulse_window, b.fs, b.log_axis, b.ticks)


def test_plot_response_renders(ctl, tmp_path):
    assert matplotlib_available()
    path = str(tmp_path / "resp.png")
    fig = ctl.plot_response(save_path=path)
    assert fig is not None and os.path.getsize(path) > 1000


def test_spectrum_ops():
    fs, T = 44100, 2048
    t = np.arange(T) / fs
    x = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    db = spectrum_db(x)
    freqs = spectrum_freqs(T, fs)
    pf, _ = spectrum_peak(db, freqs)
    assert abs(float(pf) - 1000) < fs / T * 2
    ring = waterfall_init(len(freqs))
    assert ring.shape == (WATERFALL_DEPTH, len(freqs))
    ring = waterfall_push(ring, db)
    assert torch.equal(ring[-1], db)
    ring2 = waterfall_push(ring, db * 0 - 100)
    assert torch.equal(ring2[-2], db)


def test_waterfall_renders(tmp_path):
    ring = (np.random.default_rng(0).normal(size=(WATERFALL_DEPTH, 257))
            .astype(np.float32) * 10 - 60)
    path = str(tmp_path / "wf.png")
    fig = plot_waterfall(ring, spectrum_freqs(512, 44100), save_path=path)
    assert fig is not None and os.path.getsize(path) > 1000


def test_gui_import_gated():
    from afp_tpu_torch.ui.gui import gui_available

    assert isinstance(gui_available(), bool)  # no display → False is fine


def test_spectrum_overlay_lands_in_figure(ctl, tmp_path):
    """The captured output spectrum is rendered on the response plot with
    the peak annotated; the controller's peak ≡ `afp_tpu`'s numpy
    spectrum of the same block within one bin."""
    ctl.show_spectrum = True
    t = np.arange(512) / 44100
    block = (0.5 * np.sin(2 * np.pi * 2000 * t)).astype(np.float32)[None, :]
    ctl.update_spectrum(block)
    assert ctl.spectrum_peak is not None
    assert abs(ctl.spectrum_peak[0] - 2000) < 44100 / 512 * 2
    want = jspectrum_db_np(block[0])
    assert np.argmax(ctl._last_spectrum[0]) == np.argmax(want)
    assert ctl.waterfall_ring is not None and ctl.waterfall_ring.shape[0] == 50

    fig = ctl.plot_response(save_path=str(tmp_path / "overlay.png"))
    ax_mag = fig.axes[0]
    labels = [ln.get_label() for ln in ax_mag.get_lines()]
    assert "Output spectrum" in labels
    assert any(t.get_text().startswith("Peak:") for t in ax_mag.texts)
    n_lines = len(ax_mag.get_lines())
    ctl._last_spectrum = None
    fig2 = ctl.plot_response()
    assert len(fig2.axes[0].get_lines()) < n_lines


def test_update_spectrum_dequantizes_int16(ctl):
    """emit='pcm16' blocks are read n/32768: the same spectrum as the f32
    block of those values, bit for bit."""
    ctl.show_spectrum = True
    pcm = np.random.default_rng(2).integers(-9000, 9000, (1, 512)).astype(np.int16)
    ctl.update_spectrum(pcm)
    a = ctl._last_spectrum
    ctl.update_spectrum(pcm.astype(np.float32) / np.float32(32768.0))
    assert np.array_equal(a, ctl._last_spectrum)


def test_controller_waterfall_from_own_history(ctl, tmp_path):
    ctl.show_spectrum = True
    rng = np.random.default_rng(0)
    for _ in range(5):
        ctl.update_spectrum(rng.normal(size=(1, 512)).astype(np.float32) * 0.1)
    assert np.all(ctl.waterfall_ring[:-5] == -200.0)
    path = str(tmp_path / "wf2.png")
    fig = ctl.waterfall(save_path=path)
    assert fig is not None and os.path.getsize(path) > 1000


def test_controller_waterfall_requires_history(ctl):
    with pytest.raises(ValueError):
        ctl.waterfall()


def test_controller_per_stream_gain_banks(tmp_path):
    """With per-stream [B, n_bands] gains on the device the controller view
    is the cross-stream mean; a slider write sets its band for every
    stream and keeps the other bands' per-stream values."""
    cfg = StreamConfig(samplerate=44100, blocksize=512, upsample_factor=1,
                       numtaps=65, batch=2, eq_enabled=True,
                       dither_kind="off", downsample_mode="decimate",
                       output_clip=None)
    eng = StreamEngine(cfg, device="cpu")
    n = len(cfg.eq_bands)
    bank = np.tile(np.linspace(0.5, 1.5, n, dtype=np.float32), (2, 1))
    bank[1] *= 2.0
    eng.params = with_per_stream_gains(eng.pipeline, eng.params, bank)
    ctl = EqualizerController(eng, preset_path=str(tmp_path / "p.json"))
    np.testing.assert_allclose(ctl.get_gains(), bank.mean(axis=0), rtol=1e-6)
    ctl.set_gain(2, 3.0)
    g = eng.params.eq_gains.cpu().numpy()
    assert g.shape == (2, n)
    np.testing.assert_allclose(g[:, 2], 3.0)
    np.testing.assert_allclose(g[0, 3], bank[0, 3])
    ctl.set_gains([1.0] * n)  # 1-D broadcast onto the 2-D bank
    np.testing.assert_allclose(eng.params.eq_gains.cpu().numpy(), 1.0)


# ---------------------------------------------------------------- the tap


def serve_blocks(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 2, 512)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("emit", ["f32", "pcm16"])
def test_ring_server_spectrum_tap(emit):
    """Every 2nd drained block lands the host-FFT dB spectrum of row 1 in
    the server's depth-50 ring (newest last) and the peak readout, ≡
    `spectrum_db_np` of that drained row bit for bit (int16 dequantized
    n/32768), while the outputs ≡ an untapped server's, bit for bit."""
    pipe = Pipeline(StreamConfig(**{**SERVE, "emit": emit}), "cpu")
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    blocks = serve_blocks()
    gold = list(RingServer(pipe, params, slots=8, chunk=2, seed=1)
                .stream(iter(blocks)))
    srv = RingServer(pipe, params, slots=8, chunk=2, seed=1,
                     spectrum_every=2, spectrum_row=1)
    seen = []
    srv.spectrum_sink = lambda blk: seen.append(blk.copy())
    outs = list(srv.stream(iter(blocks)))
    assert np.array_equal(np.stack(outs), np.stack(gold))
    assert len(seen) == 3 and srv.waterfall_ring.shape == (50, 257)
    row = outs[4][1]
    if emit == "pcm16":
        row = row.astype(np.float32) / np.float32(32768.0)
    assert np.array_equal(srv.waterfall_ring[-1], spectrum_db_np(row))
    assert np.array_equal(srv.waterfall_ring[-3], spectrum_db_np(
        outs[0][1] if emit == "f32"
        else outs[0][1].astype(np.float32) / np.float32(32768.0)))
    assert np.all(srv.waterfall_ring[:-3] == -200.0)
    assert seen[-1].dtype == np.float32
    f, lvl = srv.spectrum_peak
    assert 0 <= f <= 22050 and np.isfinite(lvl)
    assert srv.last_spectrum.shape == (257,)


def test_ring_server_tap_against_afp_tpu():
    """The port's tap rows against `afp_tpu`'s server on the same blocks
    (its f32 conv ring in interpret mode), within TAP_DB."""
    from afp_tpu.engine import Pipeline as JPipeline
    from afp_tpu.engine import StreamConfig as JConfig
    from afp_tpu.runtime import RingServer as JRingServer

    blocks = serve_blocks(seed=3)
    rings = []
    for P, C, R, kw in ((JPipeline, JConfig, JRingServer, {}),
                        (Pipeline, StreamConfig, RingServer, dict(device="cpu"))):
        pipe = P(C(**SERVE), **kw)
        srv = R(pipe, slots=8, chunk=2, spectrum_every=1, spectrum_row=0)
        list(srv.stream(iter(blocks)))
        rings.append(srv.waterfall_ring[-6:])
    ma, mb = (10.0 ** (r.astype(np.float64) / 20) for r in rings)
    e = float(20 * np.log10((np.abs(ma - mb).max(-1) / mb.max(-1)).max()))
    print(f"tap rows vs afp_tpu: {e:.1f} dB (bound {TAP_DB})")
    assert e <= TAP_DB


def test_controller_ring_stream_waterfall(tmp_path):
    """The controller serves through a RingServer while its overlay and
    waterfall render from the serving drain; the server's tap is set
    after construction."""
    pipe = Pipeline(StreamConfig(**SERVE), "cpu")
    srv = RingServer(pipe, slots=8, chunk=2)
    ctl = EqualizerController(StreamEngine(StreamConfig(**SERVE), device="cpu"))
    got = []
    ctl.start_ring_stream(srv, iter(serve_blocks()), sink=got.append,
                          spectrum_every=2)
    assert ctl.streaming and srv.spectrum_every == 2
    for _ in range(300):
        if len(got) == 6:
            break
        time.sleep(0.1)
    ctl.stop_stream(timeout=30.0)
    assert len(got) == 6 and not ctl.streaming
    assert ctl.waterfall_ring is not None
    fig = ctl.waterfall(save_path=str(tmp_path / "wf.png"))
    assert fig is not None and (tmp_path / "wf.png").exists()
    assert ctl.spectrum_peak is not None


def test_spectrum_row_out_of_range_rejected():
    pipe = Pipeline(StreamConfig(**SERVE), "cpu")
    with pytest.raises(ValueError, match="spectrum_row"):
        RingServer(pipe, slots=8, chunk=2, spectrum_every=2,
                   spectrum_row=pipe.batch)
