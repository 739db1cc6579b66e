"""The port's config, Pipeline and StreamEngine against `afp_tpu` on the
CPU, at small shapes: the same numpy inputs through both packages' whole
chain, dither off (the JAX side runs its Pallas kernels in interpret mode
and its XLA dither uses threefry, so dither is compared on distribution in
`test_torch_ops.py` only).  Each test states its tolerance and prints the
measured value."""
import dataclasses

import numpy as np
import pytest
import scipy.signal as sps
import torch

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  StreamEngine)
from afp_tpu_torch.ops.resample import streaming_kernel

#: td: the bf16×3 accumulation-order class; fft: two f32 FFT libraries
TD_DB, FFT_DB, ORACLE_DB = -110.0, -100.0, -90.0

#: small configurations: the C5 shape (decimate, no EQ) and the README shape
#: (EQ on, resample down, clip), each under both strategies
SMALL = {
    "c5": dict(samplerate=44100, blocksize=256, upsample_factor=4, numtaps=63,
               batch=4, cutoff=9000.0, eq_enabled=False,
               downsample_mode="decimate", output_clip=None,
               resample_quality="fast"),
    "readme": dict(samplerate=44100, blocksize=256, upsample_factor=2,
                   numtaps=31, batch=4, cutoff=11000.0, eq_enabled=True,
                   resample_quality="hq", output_clip=0.99),
}


def err_db(a, b) -> float:
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def both(name, **over):
    kw = {**SMALL[name], **over}
    return JConfig(**kw), StreamConfig(**kw)


def signal(B, T, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((B, T)) * scale).astype(np.float32)


def port(cfg):
    p = Pipeline(cfg, "cpu")
    return p, p.device_params(PipelineParams.design(p.cfg))


def jax_run(cfg, sig, state=None):
    p = JPipeline(cfg)
    params = p.device_params(JParams.design(p.cfg))
    st = p.init_state() if state is None else state
    st, y = p.process_signal(params, st, sig, fold=False)
    return p, params, st, np.asarray(y)


# ---------------------------------------------------------------- config


def test_config_fields_match():
    """Same field names, order and defaults (the EQ bands compared as
    dicts: the two packages have their own EQBand class)."""
    assert JConfig().to_dict() == StreamConfig().to_dict()
    assert [f.name for f in dataclasses.fields(JConfig)] == \
        [f.name for f in dataclasses.fields(StreamConfig)]


@pytest.mark.parametrize("over", [
    {}, dict(blocksize=3000, numtaps=5000, upsample_factor=9, samplerate=500),
    dict(filter_type="highpass", numtaps=64, cutoff=30000.0),
    dict(filter_type="bandpass", cutoff=(100.0, 90000.0)),
    dict(emit="pcm16", dither_bits=24), dict(agc_window_size=100000, blocksize=512)])
def test_config_validate_and_static_key_match(over):
    j, t = JConfig(**over).validate(), StreamConfig(**over).validate()
    assert j.to_dict() == t.to_dict()
    assert j.static_key() == t.static_key()


@pytest.mark.parametrize("over", [dict(filter_type="notch"), dict(ingest="x"),
                                  dict(conv_strategy="td_mxu",
                                       fuse_rate_conversion=False)])
def test_config_rejections_match(over):
    for cls in (JConfig, StreamConfig):
        with pytest.raises(ValueError):
            cls(**over).validate()


@pytest.mark.parametrize("over", [
    {}, dict(eq_enabled=False), dict(min_phase=True, numtaps=101),
    dict(design_method="remez", numtaps=65, cutoff=8000.0),
    dict(filter_type="bandstop", cutoff=(2000.0, 6000.0), numtaps=101)])
def test_design_bit_exact(over):
    j = JParams.design(JConfig(**over).validate())
    t = PipelineParams.design(StreamConfig(**over).validate())
    for a, b in [(j.main_taps, t.main_taps), (j.eq_taps, t.eq_taps),
                 (j.eq_gains, t.eq_gains)]:
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("name", ["c5", "readme"])
def test_geometry_matches(name):
    j, t = both(name, conv_strategy="td_mxu")
    jp, tp = JPipeline(j), Pipeline(t, "cpu")
    assert (tp.n_casc, tp.nfft, tp._k_pad, tp.n_kernel) == \
        (jp.n_casc, jp.nfft, jp._k_pad, jp.n_kernel)


def test_headline_geometry():
    """The C5 headline (`bench.py:312-334`): n_casc 379, k_pad 384."""
    cfg = StreamConfig(samplerate=44100, blocksize=4096, upsample_factor=4,
                       numtaps=1001, batch=4, cutoff=11000.0, eq_enabled=False,
                       downsample_mode="decimate", dither_kind="tpdf",
                       output_clip=None, conv_strategy="td_mxu",
                       resample_quality="vhq")
    p = Pipeline(cfg, "cpu")
    assert (p.n_casc, p._k_pad) == (379, 384)


@pytest.mark.parametrize("name", ["c5", "readme"])
def test_device_params_match(name):
    """Cascade taps bit-exact (same float64 host math, same f32 cast);
    spectra within −120 dB (two rfft implementations)."""
    j, t = both(name, conv_strategy="td_mxu")
    jp = JPipeline(j)
    jpar = jp.device_params(JParams.design(jp.cfg))
    tp, tpar = port(t)
    assert np.array_equal(np.asarray(jpar.casc_main), tpar.casc_main.numpy())
    if tp.has_eq:
        assert np.array_equal(np.asarray(jpar.casc_bands), tpar.casc_bands.numpy())
        e = err_db(tpar.H_bands.numpy(), np.asarray(jpar.H_bands))
        print(f"{name}: H_bands {e:.1f} dB")
        assert e < -120
    e = err_db(tpar.H_main.numpy(), np.asarray(jpar.H_main))
    print(f"{name}: H_main {e:.1f} dB")
    assert e < -120


# ---------------------------------------------------------------- the chain


@pytest.mark.parametrize("strategy,bound", [("td_mxu", TD_DB), ("fft", FFT_DB)])
@pytest.mark.parametrize("name", ["c5", "readme"])
def test_pipeline_matches_jax(name, strategy, bound):
    """The whole chain, 4 blocks, dither off, vs JAX's
    ``process_signal(fold=False)``."""
    j, t = both(name, conv_strategy=strategy, dither_kind="off")
    sig = signal(4, 4 * 256, seed=1)
    *_, want = jax_run(j, sig)
    tp, tpar = port(t)
    _, got = tp.process_signal(tpar, tp.init_state(), sig, fold=False)
    e = err_db(got.numpy(), want)
    print(f"{name}/{strategy}: {e:.1f} dB vs afp_tpu (bound {bound})")
    assert got.shape == want.shape and e <= bound


@pytest.mark.parametrize("strategy", ["td_mxu", "fft"])
def test_pipeline_vs_float64_oracle(strategy):
    """The C5 chain against the float64 oracle of `bench.py:394-418` (one
    stream, dither off): under −90 dB."""
    _, t = both("c5", conv_strategy=strategy, dither_kind="off", batch=1,
                resample_quality="hq")
    tp, tpar = port(t)
    sig = signal(1, 4 * 256, seed=2)
    _, out = tp.process_signal(tpar, tp.init_state(), sig, fold=False)
    design = PipelineParams.design(tp.cfg)
    upf = t.upsample_factor
    y = sps.upfirdn(streaming_kernel(upf, 1, quality=t.resample_quality),
                    sig[0].astype(np.float64), upf, 1)[: sig.shape[1] * upf]
    gold = np.convolve(y, design.main_taps.astype(np.float64))[: len(y)][::upf]
    e = err_db(out.numpy()[0], gold)
    print(f"c5/{strategy}: {e:.1f} dB vs the float64 oracle (bound {ORACLE_DB})")
    assert e < ORACLE_DB


@pytest.mark.parametrize("strategy", ["td_mxu", "fft"])
def test_blocked_equals_one_shot(strategy):
    """step() block by block ≡ process_signal, bit for bit, dither on."""
    _, t = both("readme", conv_strategy=strategy, dither_kind="tpdf")
    tp, tpar = port(t)
    sig = signal(4, 3 * 256, seed=3)
    _, whole = tp.process_signal(tpar, tp.init_state(seed=5), sig)
    st = tp.init_state(seed=5)
    parts = []
    for i in range(3):
        st, y = tp.step(tpar, st, sig[:, i * 256:(i + 1) * 256])
        parts.append(y)
    assert torch.equal(torch.cat(parts, dim=-1), whole)
    assert st.step == 3


@pytest.mark.parametrize("strategy,bound", [("td_mxu", TD_DB), ("fft", FFT_DB)])
def test_state_carry_from_jax(strategy, bound):
    """Run 2 blocks in JAX, carry its params and state into the port
    (`params_from_numpy`, `state_from_numpy`), run 2 more: equals JAX's
    4-block run."""
    j, t = both("readme", conv_strategy=strategy, dither_kind="off")
    sig = signal(4, 4 * 256, seed=4)
    jp, jpar, jst, first = jax_run(j, sig[:, :512])
    *_, whole = jax_run(j, sig)
    tp = Pipeline(t, "cpu")
    tpar = tp.params_from_numpy({k: None if v is None else np.asarray(v)
                                 for k, v in jpar._asdict().items()})
    st = tp.state_from_numpy(np.asarray(jst.conv_tail), seed=0, step=2)
    assert st.conv_tail.shape == (4, tp._k_pad)
    _, rest = tp.process_signal(tpar, st, sig[:, 512:])
    e = err_db(rest.numpy(), whole[:, 512:])
    print(f"{strategy}: carried state {e:.1f} dB vs the 4-block JAX run "
          f"(bound {bound})")
    assert e <= bound and np.array_equal(first, whole[:, :512])


def test_dither_seeded_and_bounded():
    """Dither on: same seed ⇒ same output; the noise stays within ±1 lsb
    (TPDF) of the dither-off output; another seed changes it."""
    _, t = both("readme", conv_strategy="td_mxu", dither_kind="tpdf",
                dither_bits=16, output_clip=None)
    tp, tpar = port(t)
    sig = signal(4, 2 * 256, seed=6)
    _, a = tp.process_signal(tpar, tp.init_state(seed=1), sig)
    _, b = tp.process_signal(tpar, tp.init_state(seed=1), sig)
    _, c = tp.process_signal(tpar, tp.init_state(seed=2), sig)
    off = dataclasses.replace(t, dither_kind="off")
    tq, _ = port(off)
    _, clean = tq.process_signal(tpar, tq.init_state(), sig)
    dev = (a - clean).abs().max().item() / 2.0 ** -15
    print(f"max |dithered − clean| = {dev:.4f} lsb (bound 1 lsb + rounding)")
    assert torch.equal(a, b) and not torch.equal(a, c) and dev < 1.001


@pytest.mark.parametrize("over,item", [
    (dict(waterfall_enabled=True), "item 10b")])
def test_outside_the_slice_raises(over, item):
    """The configuration that raised before its ROADMAP item was ported now
    builds and steps: the waterfall ring starts primed and takes the
    block's spectrum (its numbers are held to `afp_tpu` in
    `tests/test_torch_waterfall.py`)."""
    p, params = port(StreamConfig(blocksize=256, numtaps=31, batch=2, **over))
    st = p.init_state()
    assert st.wf.shape == (2, 50, 129) and torch.all(st.wf == -200.0)
    st, y = p.step(params, st, signal(2, 256))
    print(f"{item}: newest row max {st.wf[:, -1].max().item():.1f} dB")
    assert y.shape == (2, 256) and torch.all(st.wf[:, -1] > -200.0)
    assert torch.all(st.wf[:, :-1] == -200.0)


@pytest.mark.parametrize("over", [
    dict(agc_enabled=True, agc_mode="parallel"),
    dict(source_samplerate=48000, asrc_mode="compat"),
    dict(fuse_rate_conversion=False),
    dict(output_rate="upsampled")])
def test_rule3_configs_build_and_step(over):
    """The configurations that raised before the multirate slice build on
    the CPU and step a block of the right shape (their numbers are held
    to `afp_tpu` in `tests/test_torch_resample.py` and
    `test_torch_asrc.py`)."""
    p, params = port(StreamConfig(blocksize=256, numtaps=31, batch=2, **over))
    _, y = p.step(params, p.init_state(), signal(2, 256))
    assert y.shape == (2, p.out_block) and torch.isfinite(y).all()


def test_fold_and_per_stream_raise():
    """The offline fold runs (item 9, ported: `tests/test_torch_fold.py`)
    and matches the scan; a bad fold value raises; per-stream gains run; a
    filter bank refuses ``fold=True``, and an assignment outside the bank
    is refused as it arrives; the framer runs (item 5)."""
    _, t = both("readme", conv_strategy="td_mxu")
    tp, tpar = port(t)
    sig = signal(4, 256)
    _, scan = tp.process_signal(tpar, tp.init_state(), sig, fold=False)
    for fold in (True, "prefer"):
        _, y = tp.process_signal(tpar, tp.init_state(), sig, fold=fold)
        assert y.shape == scan.shape and err_db(y.numpy(), scan.numpy()) <= TD_DB
    with pytest.raises(ValueError, match="fold must be"):
        tp.process_signal(tpar, tp.init_state(), sig, fold="sometimes")
    # per-stream gains run (K11): all-ones rows against the shared all-ones
    # gains (K11 mixes the band convs, the shared form the taps: two
    # roundings of one function, each within the oracle contract)
    per_stream = tpar._replace(eq_gains=torch.ones(4, 9))
    _, y = tp.step(per_stream, tp.init_state(), sig)
    _, want = tp.step(tpar._replace(eq_gains=torch.ones(9)), tp.init_state(), sig)
    e = err_db(y.numpy(), want.numpy())
    print(f"per-stream ones vs shared ones: {e:.1f} dB (bound {ORACLE_DB})")
    assert e < ORACLE_DB
    # a filter bank refuses the fold with the reference's ValueError
    fields = {k: None if v is None else v.numpy() for k, v in tpar._asdict().items()}
    bank = tp.params_from_numpy({**fields,
                                 "casc_bank": np.zeros((2, tp.n_casc), np.float32),
                                 "casc_assign": np.zeros(1, np.int32)})
    with pytest.raises(ValueError, match="casc_assign must index"):
        tp.params_from_numpy({**fields, "casc_bank": np.zeros((2, tp.n_casc)),
                              "casc_assign": np.full(1, 2, np.int32)})
    with pytest.raises(ValueError, match="per-stream filter banks"):
        tp.process_signal(bank, tp.init_state(), sig, fold=True)
    # the framer runs (item 5, ported: `tests/test_torch_runtime.py`): its
    # first block of output is the framing latency's silence
    out = StreamEngine(t, device="cpu").process_frames(sig[:, :100])
    assert out.shape == (4, 100) and not np.any(out)


# ---------------------------------------------------------------- engine


def test_engine_blocks_gains_and_metrics():
    """The README quick-start flow at small size: process_block ×4,
    set_eq_gains, ×2; zero ladder fallbacks, outputs equal the bare
    pipeline's, and the gain change reaches the output."""
    _, t = both("readme", dither_kind="tpdf")
    eng = StreamEngine(t, device="cpu", seed=3)
    tp, tpar = port(t)
    st = tp.init_state(seed=3)
    sig = signal(4, 6 * 256, seed=7)
    gains = [1.0] * 6 + [2.0] * 3
    for i in range(6):
        if i == 4:
            eng.set_eq_gains(gains)
            tpar = tpar._replace(eq_gains=torch.tensor(gains))
        blk = sig[:, i * 256:(i + 1) * 256]
        out = eng.process_block(blk)
        st, want = tp.step(tpar, st, blk)
        assert np.array_equal(out, want.numpy())
    m = eng.metrics
    print(f"engine metrics: {m.snapshot()}")
    assert m.blocks_processed == 6
    assert m.underruns == m.fallback_replays == m.fallback_silence == 0
    with pytest.raises(ValueError, match="EQ band count"):
        eng.set_eq_gains([1.0, 2.0])


def test_engine_ladder_and_reconfig():
    """A non-finite block replays the last good one; apply_config swaps
    dynamic changes in place and rebuilds on shape changes."""
    _, t = both("c5", dither_kind="off", conv_strategy="td_mxu")
    eng = StreamEngine(t, device="cpu")
    good = eng.process_block(signal(4, 256))
    bad = np.full((4, 256), np.nan, np.float32)
    assert np.array_equal(eng.process_block(bad), good)
    assert (eng.metrics.underruns, eng.metrics.fallback_replays) == (1, 1)
    assert np.array_equal(eng.underrun_block(), (0.8 * good).astype(np.float32))
    assert eng.apply_config(dataclasses.replace(t, cutoff=5000.0)) is True
    assert eng.apply_config(dataclasses.replace(t, numtaps=65)) is False
    assert eng.pipeline.cfg.numtaps == 65


def test_engine_process_signal_matches_pipeline():
    _, t = both("c5", dither_kind="tpdf")
    eng = StreamEngine(t, device="cpu", seed=9)
    sig = signal(4, 2 * 256 + 100, seed=8)
    out = eng.process_signal(sig)
    tp, tpar = port(t)
    _, want = tp.process_signal(tpar, tp.init_state(seed=9), sig)
    assert out.shape == (4, 512) and np.array_equal(out, want.numpy())
