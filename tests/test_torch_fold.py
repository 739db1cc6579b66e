"""The offline fold (`Pipeline.process_signal_folded`) against `afp_tpu`'s on
the CPU, at the cases of `tests/test_fold.py`: the blocks fold into the
batch axis and the conv chain runs as one batched call — K1 (at the
pipeline's precision), K8 for pcm16 and pair ingest, K11 for per-stream
gains, one batched overlap-save for 'fft'.

Inputs are made with numpy from a seed and handed to both packages, dither
off.  The bounds: the port's fold against `afp_tpu`'s fold ≤ −110 dB for the
'td_mxu' conv forms (the bf16×3 or fp32 accumulation-order class) and
≤ −100 dB for 'fft' (two FFT libraries), int16 outputs ≤ 1 LSB; the port's
fold against its own scan ≤ −110 dB here (the plain versions' matmul
blocking may reassociate across batch sizes, as `afp_tpu` says of its
interpret mode; on the card the two are equal bit for bit, a card test);
the carried state, framing and tails bit for bit (they are slices)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.engine import batch as jbatch
from afp_tpu.ops.pallas import fir_td as jfir
from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  StreamEngine, batch)

CONV_DB, FFT_DB = -110.0, -100.0


def make_kw(**kw):
    base = dict(resample_quality="fast", samplerate=44100, blocksize=512,
                upsample_factor=2, numtaps=129, batch=1, filter_type="lowpass",
                cutoff=11000.0, eq_enabled=True, agc_enabled=False,
                downsample_mode="decimate", dither_kind="off", output_clip=0.9,
                conv_strategy="td_mxu")
    return {**base, **kw}


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def close(name, got, want, bound):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.int16:
        d = int(np.max(np.abs(got.astype(np.int32) - want.astype(np.int32))))
        print(f"{name}: {d} LSB (bound 1)")
        assert d <= 1
    else:
        e = err_db(got, want)
        print(f"{name}: {e:.1f} dB (bound {bound})")
        assert e <= bound


def tail_np(t):
    """A conv tail as numpy (a pair as two uint16 arrays of the bf16 bits),
    its last `width` columns compared against `afp_tpu`'s."""
    if isinstance(t, tuple):
        return tuple(np.asarray(h.view(torch.int16) if isinstance(h, torch.Tensor)
                                else np.asarray(h).view(np.int16)) for h in t)
    return (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),)


def same_tail(a, b):
    """Bit-equal carried tails: the port carries k_pad columns, `afp_tpu`'s
    staged f32 tail n−1; the common last columns must agree."""
    for x, y in zip(tail_np(a), tail_np(b)):
        w = min(x.shape[-1], y.shape[-1])
        assert np.array_equal(x[..., -w:], y[..., -w:])


def run(kw, sig, fold, params_of=None, precision="B3", warm=1, jax_fold=None):
    """(port output, port state, afp_tpu output, afp_tpu state, the port's
    (pipeline, params, state before the fold, folded signal)):
    `warm` blocks streamed first so the carried tail is real, then the rest
    with `fold` (the port) and `jax_fold` (`afp_tpu`, default the same)."""
    L = kw["blocksize"]
    jp, tp = JPipeline(JConfig(**kw)), Pipeline(StreamConfig(**kw), "cpu",
                                                td_precision=precision)
    jparams = jp.device_params(JParams.design(jp.cfg))
    tparams = tp.device_params(PipelineParams.design(tp.cfg))
    if params_of is not None:
        jparams, tparams = params_of(jp, jparams, tp, tparams)
    jst, tst = jp.init_state(0), tp.init_state(0)
    if warm:
        jst, _ = jp.process_signal(jparams, jst, sig[:, : warm * L], fold=False)
        tst, _ = tp.process_signal(tparams, tst, sig[:, : warm * L], fold=False)
    rest = sig[:, warm * L:]
    jst, jy = jp.process_signal(jparams, jst, rest,
                                fold=fold if jax_fold is None else jax_fold)
    port = (tp, tparams, tst, rest)
    tst, ty = tp.process_signal(tparams, tst, rest, fold=fold)
    return ty.numpy(), tst, np.asarray(jy), jst, port


def scan_of(port):
    """The port's scan over the folded part, from the state the fold had."""
    tp, tparams, st, rest = port
    return tp.process_signal(tparams, st, rest, fold=False)


@pytest.mark.parametrize("batch_,nb", [(1, 5), (4, 6), (3, 3)])
def test_fold_td_matches(batch_, nb):
    sig = (np.random.default_rng(batch_).normal(size=(batch_, (nb + 1) * 512)) * 0.4
           ).astype(np.float32)
    ty, tst, jy, jst, port = run(make_kw(batch=batch_), sig, "prefer")
    close(f"td fold B={batch_} nb={nb} vs afp_tpu", ty, jy, CONV_DB)
    same_tail(tst.conv_tail, jst.conv_tail)


def test_fold_equals_scan_framing_and_state():
    """The port's fold against its own scan from the same state: outputs in
    the conv class here, the carried tail and step bit for bit, and the
    continuation after the fold equal to the scan's."""
    kw = make_kw(batch=2)
    pipe = Pipeline(StreamConfig(**kw), "cpu")
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    rng = np.random.default_rng(7)
    sig = (rng.normal(size=(2, 4 * 512 + 100)) * 0.4).astype(np.float32)
    nxt = (rng.normal(size=(2, 512)) * 0.4).astype(np.float32)
    sa, ya = pipe.process_signal(params, pipe.init_state(0), sig, fold=False)
    sb, yb = pipe.process_signal(params, pipe.init_state(0), sig, fold=True)
    assert yb.shape == (2, 4 * 512)
    close("fold vs scan (CPU)", yb.numpy(), ya.numpy(), CONV_DB)
    assert torch.equal(sa.conv_tail, sb.conv_tail) and sa.step == sb.step == 4
    _, za = pipe.step(params, sa, nxt)
    _, zb = pipe.step(params, sb, nxt)
    assert torch.equal(za, zb)


def test_fold_fft_matches():
    sig = (np.random.default_rng(8).normal(size=(2, 6 * 512)) * 0.4).astype(np.float32)
    ty, tst, jy, jst, port = run(make_kw(conv_strategy="fft", batch=2), sig, "prefer")
    close("fft fold vs afp_tpu", ty, jy, FFT_DB)
    close("fft fold vs the port's scan", ty, scan_of(port)[1].numpy(), FFT_DB)
    same_tail(tst.conv_tail, jst.conv_tail)


def test_fold_pcm16_ingest_matches():
    f = (np.random.default_rng(9).normal(size=(1, 6 * 512)) * 0.3).astype(np.float32)
    sig = np.clip(np.round(f * 32768.0), -32768, 32767).astype(np.int16)
    ty, tst, jy, jst, port = run(make_kw(ingest="pcm16"), sig, "prefer")
    close("pcm16 fold vs afp_tpu", ty, jy, CONV_DB)
    assert tst.conv_tail.dtype == torch.int16
    same_tail(tst.conv_tail, jst.conv_tail)


def test_fold_pair_ingest_matches():
    sig = (np.random.default_rng(10).normal(size=(1, 5 * 512)) * 0.4).astype(np.float32)
    ty, tst, jy, jst, port = run(make_kw(ingest="pair"), sig, "prefer")
    close("pair fold vs afp_tpu", ty, jy, CONV_DB)
    assert isinstance(tst.conv_tail, tuple)
    same_tail(tst.conv_tail, jst.conv_tail)


def test_fold_emit16_matches():
    sig = (np.random.default_rng(11).normal(size=(1, 6 * 512)) * 0.4).astype(np.float32)
    ty, tst, jy, jst, port = run(make_kw(emit="pcm16"), sig, "prefer")
    assert ty.dtype == jy.dtype == np.int16
    close("emit16 fold vs afp_tpu", ty, jy, CONV_DB)
    close("emit16 fold vs the port's scan", ty, scan_of(port)[1].numpy(), CONV_DB)


@pytest.mark.parametrize("strategy", ["td_mxu", "fft"])
def test_fold_per_stream_gains_matches(strategy):
    """Per-stream gains fold too (each stream's gain row repeated over its
    blocks): K11 for 'td_mxu', a [B·nb, F] response for 'fft'."""
    gains = np.ones((4, 9), np.float32)
    gains[1] *= 0.5
    gains[3, :4] = 2.0

    def ps(jp, jparams, tp, tparams):
        return (jbatch.with_per_stream_gains(jp, jparams, gains),
                batch.with_per_stream_gains(tp, tparams, gains))

    sig = (np.random.default_rng(12).normal(size=(4, 4 * 512)) * 0.3).astype(np.float32)
    ty, tst, jy, jst, port = run(make_kw(batch=4, conv_strategy=strategy), sig,
                                 True, params_of=ps)
    close(f"per-stream {strategy} fold vs afp_tpu", ty, jy,
          CONV_DB if strategy == "td_mxu" else FFT_DB)
    same_tail(tst.conv_tail, jst.conv_tail)


def test_fold_per_stream_pcm16_matches():
    gains = np.ones((4, 9), np.float32)
    gains[2] *= 0.25

    def ps(jp, jparams, tp, tparams):
        return (jbatch.with_per_stream_gains(jp, jparams, gains),
                batch.with_per_stream_gains(tp, tparams, gains))

    f = (np.random.default_rng(13).normal(size=(4, 4 * 512)) * 0.3).astype(np.float32)
    sig = np.clip(np.round(f * 32768.0), -32768, 32767).astype(np.int16)
    ty, tst, jy, jst, port = run(make_kw(batch=4, ingest="pcm16"), sig, True,
                                 params_of=ps)
    close("per-stream pcm16 fold vs afp_tpu", ty, jy, CONV_DB)
    assert tst.conv_tail.dtype == torch.int16
    same_tail(tst.conv_tail, jst.conv_tail)


def test_fold_highest_matches(monkeypatch):
    """Under td_precision='HIGHEST' the fold runs HIGHEST K1, against
    `afp_tpu`'s fold with its precision set to HIGHEST."""
    monkeypatch.setattr(jfir, "PRECISION_MODE", "HIGHEST")
    sig = (np.random.default_rng(14).normal(size=(2, 5 * 512)) * 0.4).astype(np.float32)
    ty, tst, jy, jst, port = run(make_kw(batch=2), sig, True, precision="HIGHEST")
    close("HIGHEST fold vs afp_tpu", ty, jy, CONV_DB)
    close("HIGHEST fold vs the port's scan", ty, scan_of(port)[1].numpy(), CONV_DB)


def test_fold_dither_auto_gates_and_prefer_differs_sub_lsb():
    """'auto' never changes semantics (with dither on, or on the CPU, it
    scans); 'prefer' folds with the one key of the fold: deterministic, the
    same filter output under noise of ±2 LSB."""
    kw = make_kw(dither_kind="tpdf", dither_bits=24)
    pipe = Pipeline(StreamConfig(**kw), "cpu")
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sig = (np.random.default_rng(15).normal(size=(1, 4 * 512)) * 0.4).astype(np.float32)
    _, y_auto = pipe.process_signal(params, pipe.init_state(0), sig)
    _, y_scan = pipe.process_signal(params, pipe.init_state(0), sig, fold=False)
    assert torch.equal(y_auto, y_scan)
    _, y1 = pipe.process_signal(params, pipe.init_state(0), sig, fold="prefer")
    _, y2 = pipe.process_signal(params, pipe.init_state(0), sig, fold="prefer")
    assert torch.equal(y1, y2) and not torch.equal(y1, y_scan)
    lsb = 2.0 ** (1 - kw["dither_bits"])
    assert float((y1 - y_scan).abs().max()) <= 2 * lsb + 1e-5


def test_fold_decisions():
    """The reference's decisions (`pipeline.py:1552-1601`): AGC cannot fold
    (True raises, 'auto' scans), banks refuse True and decline 'auto',
    typos raise, and 'auto' folds only 'td_mxu' without per-stream gains,
    dither off, on the card, batch < 256."""
    sig = (np.random.default_rng(16).normal(size=(4, 2 * 512)) * 0.3).astype(np.float32)
    ap = Pipeline(StreamConfig(**make_kw(agc_enabled=True, batch=4)), "cpu")
    assert not ap.supports_fold
    aparams = ap.device_params(PipelineParams.design(ap.cfg))
    with pytest.raises(ValueError, match="fold"):
        ap.process_signal(aparams, ap.init_state(0), sig, fold=True)
    assert ap.process_signal(aparams, ap.init_state(0), sig)[1].shape == (4, 1024)

    td = Pipeline(StreamConfig(**make_kw(batch=4)), "cpu")
    ff = Pipeline(StreamConfig(**make_kw(batch=4, conv_strategy="fft")), "cpu")
    tparams = td.device_params(PipelineParams.design(td.cfg))
    fparams = ff.device_params(PipelineParams.design(ff.cfg))
    ps = batch.with_per_stream_gains(td, tparams, np.ones((4, 9), np.float32))
    assert not td._fold_decision("auto", tparams)  # the CPU never auto-folds
    for p in (td, ff):
        p.device = torch.device("cuda")  # read by the decision only
    assert td._fold_decision("auto", tparams)
    assert not ff._fold_decision("auto", fparams) and ff._fold_decision("prefer", fparams)
    assert not td._fold_decision("auto", ps) and td._fold_decision(True, ps)
    td.device = torch.device("cpu")
    for bad in ("Prefer", "fold", 1, None):
        with pytest.raises(ValueError, match="fold"):
            td.process_signal(tparams, td.init_state(0), sig, fold=bad)
    bp = Pipeline(StreamConfig(**make_kw(batch=4, eq_enabled=False)), "cpu")
    banked = batch.with_per_stream_filters(bp, [dict(cutoff=9000.0)] * 4)
    with pytest.raises(ValueError, match="fold=True"):
        bp.process_signal(banked, bp.init_state(0), sig, fold=True)
    assert not bp._fold_decision("prefer", banked)


def test_fold_empty_signal_guarded():
    pipe = Pipeline(StreamConfig(**make_kw(batch=2, emit="pcm16")), "cpu")
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    for fold in (True, "prefer"):
        st, y = pipe.process_signal(params, pipe.init_state(0),
                                    np.zeros((2, 100), np.float32), fold=fold)
        assert y.shape == (2, 0) and y.dtype == torch.int16 and st.step == 0


def test_engine_fold_prefer_matches_scan():
    kw = make_kw(batch=1)
    sig = (np.random.default_rng(17).normal(size=(1, 6 * 512)) * 0.4).astype(np.float32)
    y_scan = StreamEngine(StreamConfig(**kw), device="cpu").process_signal(sig, fold=False)
    y_fold = StreamEngine(StreamConfig(**kw), device="cpu").process_signal(sig, fold="prefer")
    close("engine fold vs scan (CPU)", y_fold, y_scan, CONV_DB)
