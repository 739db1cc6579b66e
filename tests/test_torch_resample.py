"""The port's polyphase resampling (`afp_tpu_torch/ops/resample.py`) and the
literal multirate chain (`Pipeline` with ``fuse_rate_conversion=False`` or
``output_rate='upsampled'``) against `afp_tpu` and the float64 oracle on
the CPU: the same seeded numpy inputs through both packages, dither off.

Bounds: ≤ −100 dB against `afp_tpu` (two f32 FFT libraries), < −90 dB
against scipy float64 (the reference's contract), −85 dB for blocked ≡
one-shot (`tests/test_resample.py`), −90 dB for literal ≡ fused
(`tests/test_fusion.py:21`); inside the port the decimated upsampled output
≡ the base-rate output bit for bit.  Each test prints what it measured.
At the 48 → 44.1 kHz ratio (up 160, down 147 or the reverse) the
intermediates reach 2^20 points, where torch's CPU FFT over a batch of
rows reads ~−105 dB against float64 (one row alone ~−130 dB); the bounds
above hold there too."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.ops import resample as J
from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
from afp_tpu_torch.engine.batch import with_per_stream_filters
from afp_tpu_torch.ops import resample as T

REF_DB, ORACLE_DB, BLOCKED_DB, FUSION_DB = -100.0, -90.0, -85.0, -90.0
RATIOS = [(4, 1), (2, 1), (3, 2), (1, 2), (1, 4), (160, 147)]


def err_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


@pytest.mark.parametrize("up,down", RATIOS)
def test_upfirdn_matches_reference_and_scipy(rng, up, down):
    x = rng.normal(size=(2, 1000)).astype(np.float32)
    h = T.quality_kernel(up, down)
    ours = T.upfirdn(h, torch.from_numpy(x), up, down).numpy()
    ref = np.asarray(J.upfirdn(h, jnp.asarray(x), up, down))
    gold = np.stack([sps.upfirdn(h, r.astype(np.float64), up, down) for r in x])
    e_ref, e_gold = err_db(ours, ref), err_db(ours, gold)
    print(f"upfirdn {up}/{down}: {e_ref:.1f} dB vs afp_tpu, {e_gold:.1f} dB vs scipy")
    assert ours.shape == ref.shape == gold.shape
    assert T.output_len(len(h), 1000, up, down) == ours.shape[-1]
    assert e_ref <= REF_DB and e_gold < ORACLE_DB


@pytest.mark.parametrize("quality", ["fast", "hq"])
@pytest.mark.parametrize("up,down", RATIOS)
def test_resample_poly_matches_reference_and_scipy(rng, up, down, quality):
    """resample_poly at every ratio and two tiers: scipy's recipe with the
    tier's kernel (scipy scales the window by `up` itself)."""
    x = rng.normal(size=(2, 4096)).astype(np.float32)
    ours = T.resample_poly(torch.from_numpy(x), up, down, quality=quality).numpy()
    ref = np.asarray(J.resample_poly(jnp.asarray(x), up, down, quality=quality))
    h = T.quality_kernel(up, down, quality)
    u = T._reduce_ratio(up, down)[0]
    gold = np.stack([sps.resample_poly(r.astype(np.float64), up, down, window=h / u)
                     for r in x])
    e_ref, e_gold = err_db(ours, ref), err_db(ours, gold)
    print(f"resample_poly {up}/{down} {quality}: {e_ref:.1f} dB vs afp_tpu, "
          f"{e_gold:.1f} dB vs scipy")
    assert ours.shape == ref.shape == gold.shape == (2, -(-4096 * up // down))
    assert e_ref <= REF_DB and e_gold < ORACLE_DB


def test_resample_poly_identity_and_decimate():
    x = torch.linspace(-1, 1, 100)
    assert torch.equal(T.resample_poly(x, 3, 3), x)
    assert torch.equal(T.decimate(torch.arange(64.0), 4), torch.arange(0.0, 64, 4))
    assert torch.equal(T.decimate(torch.arange(64.0), 4, 1), torch.arange(1.0, 64, 4))


@pytest.mark.parametrize("up,down,L", [(4, 1, 1024), (2, 1, 512), (3, 2, 1024),
                                       (1, 4, 1024), (147, 160, 1120)])
def test_poly_resampler_streaming_equals_oneshot(rng, up, down, L):
    """Blocked PolyResampler ≡ the full-signal causal upfirdn (−85 dB), ≡
    resample_poly delayed by `delay_outputs` (−85 dB), and ≡ `afp_tpu`'s
    blocked resampler (≤ −100 dB)."""
    sig = rng.normal(size=(2, L * 5)).astype(np.float32)
    st, jst = T.PolyResampler.init(up, down, block=L, batch_shape=(2,)), \
        J.PolyResampler.init(up, down, block=L, batch_shape=(2,))
    assert (st.hist_len, st.skip, st.delay_outputs) == (
        jst.hist_len, jst.skip, jst.delay_outputs)
    outs, refs = [], []
    for b in range(5):
        st, y = st.process(torch.from_numpy(sig[:, b * L:(b + 1) * L]))
        jst, jy = jst.process(jnp.asarray(sig[:, b * L:(b + 1) * L]))
        outs.append(y.numpy())
        refs.append(np.asarray(jy))
    ours, ref = np.concatenate(outs, 1), np.concatenate(refs, 1)
    n = ours.shape[1]
    assert n == 5 * L * st.up // st.down
    h = st.h.numpy().astype(np.float64)
    causal = np.stack([sps.upfirdn(h, r.astype(np.float64), st.up, st.down)[:n]
                       for r in sig])
    u = T._reduce_ratio(up, down)[0]
    centered = np.stack([sps.resample_poly(r.astype(np.float64), up, down,
                                           window=T.quality_kernel(up, down) / u)
                         for r in sig])
    d = st.delay_outputs
    m = min(centered.shape[1], n - d)
    e_ref, e_causal = err_db(ours, ref), err_db(ours, causal)
    e_centered = err_db(ours[:, d:d + m], centered[:, :m])
    print(f"PolyResampler {up}/{down} L={L}: {e_ref:.1f} dB vs afp_tpu, "
          f"{e_causal:.1f} dB vs causal upfirdn, {e_centered:.1f} dB vs centered")
    assert e_ref <= REF_DB and e_causal < BLOCKED_DB and e_centered < BLOCKED_DB


def test_poly_resampler_refuses_ragged_block(rng):
    """A block that is not a multiple of `down` would shift the decimation
    phase of every later block: init and process refuse it, and the state
    it was called on stays usable."""
    with pytest.raises(ValueError):
        T.PolyResampler.init(1, 4, block=1022)
    st = T.PolyResampler.init(1, 4, block=1024)
    with pytest.raises(ValueError, match="multiple of down"):
        st.process(torch.zeros(1022))
    st2, y = st.process(torch.zeros(1024))
    assert y.shape == (256,) and st.hist.abs().sum() == 0
    ident = T.PolyResampler.init(3, 3, block=7)
    _, y = ident.process(torch.arange(7.0))
    assert torch.equal(y, torch.arange(7.0))


def test_poly_resampler_block_size_invariance(rng):
    """The output does not depend on the block partitioning (different
    block sizes take different FFT lengths: f32 rounding)."""
    sig = rng.normal(size=4096).astype(np.float32)
    outs = {}
    for L in (512, 1024, 2048):
        st, parts = T.PolyResampler.init(4, 1, block=L), []
        for i in range(0, 4096, L):
            st, y = st.process(torch.from_numpy(sig[i:i + L]))
            parts.append(y.numpy())
        outs[L] = np.concatenate(parts)
    e = max(err_db(outs[512], outs[L]) for L in (1024, 2048))
    print(f"PolyResampler 4/1 blocks 512/1024/2048: {e:.1f} dB apart")
    assert e < BLOCKED_DB


# ---------------------------------------------------------------- the chain

#: small literal-chain configurations (the C5 shape's 'fft' strategy)
CHAIN = dict(samplerate=44100, blocksize=256, numtaps=33, batch=3,
             cutoff=9000.0, resample_quality="fast", dither_kind="off",
             output_clip=0.99)


def sig(B, T, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, T)) * 0.3).astype(np.float32)


def port_run(kw, x, params_fn=None):
    p = Pipeline(StreamConfig(**kw), "cpu")
    params = p.device_params(PipelineParams.design(p.cfg))
    if params_fn is not None:
        params = params_fn(p, params)
    state, y = p.process_signal(params, p.init_state(), torch.from_numpy(x))
    return p, state, y.numpy()


def jax_run(kw, x):
    p = JPipeline(JConfig(**kw))
    params = p.device_params(JParams.design(p.cfg))
    _, y = p.process_signal(params, p.init_state(0), jnp.asarray(x))
    return np.asarray(y)


@pytest.mark.parametrize("eq", [False, True])
@pytest.mark.parametrize("upf", [2, 4])
@pytest.mark.parametrize("down", ["decimate", "resample"])
def test_literal_chain_matches_fused_and_reference(down, upf, eq):
    """fuse_rate_conversion=False ≡ the fused chain (−90 dB, the
    reference's fusion bound) and ≡ `afp_tpu`'s literal chain (≤ −100 dB)."""
    kw = dict(CHAIN, upsample_factor=upf, downsample_mode=down, eq_enabled=eq)
    x = sig(3, 4 * 256)
    p, state, lit = port_run({**kw, "fuse_rate_conversion": False}, x)
    _, _, fused = port_run(kw, x)
    ref = jax_run({**kw, "fuse_rate_conversion": False}, x)
    assert not p.fused and p.nfft == 1 << (p.up_block + p.n_fused - 2).bit_length()
    assert (state.up is not None) and ((state.down is not None) == (down == "resample"))
    e_fused, e_ref = err_db(lit, fused), err_db(lit, ref)
    print(f"literal {down} x{upf} eq={eq}: {e_fused:.1f} dB vs fused, "
          f"{e_ref:.1f} dB vs afp_tpu's literal chain")
    assert lit.shape == fused.shape == ref.shape == x.shape
    assert e_fused < FUSION_DB and e_ref <= REF_DB


@pytest.mark.parametrize("upf", [2, 4])
def test_upsampled_output_shapes_and_decimation(upf):
    """output_rate='upsampled' returns [B, U·L] per block (the literal
    chain, even under 'td_mxu'), ≡ `afp_tpu`'s (≤ −100 dB), and its
    decimation ≡ the base-rate literal output (decimate), bit for bit."""
    kw = dict(CHAIN, upsample_factor=upf, downsample_mode="decimate")
    x = sig(3, 4 * 256, seed=1)
    up_kw = {**kw, "output_rate": "upsampled"}
    p, state, yu = port_run(up_kw, x)
    assert p.upsampled_out and not p.fused and p.out_block == upf * 256
    assert yu.shape == (3, upf * 4 * 256) and state.down is None
    _, _, base = port_run({**kw, "fuse_rate_conversion": False}, x)
    np.testing.assert_array_equal(yu[:, ::upf], base)
    pt = Pipeline(StreamConfig(**up_kw, conv_strategy="td_mxu"), "cpu")
    assert not pt._use_td and not pt.supports_ring_step and not pt.supports_fold
    blocks = torch.from_numpy(x.reshape(3, 4, 256).transpose(1, 0, 2).copy())
    _, outs = pt.run(pt.device_params(PipelineParams.design(pt.cfg)),
                     pt.init_state(), blocks)
    assert outs.shape == (4, 3, upf * 256)
    e = err_db(yu, jax_run(up_kw, x))
    print(f"upsampled x{upf}: {e:.1f} dB vs afp_tpu")
    assert e <= REF_DB


def test_literal_chain_emits_pcm16_and_dithers():
    """emit='pcm16' quantizes after K2's plain version on the [B, U·L]
    grid; the dither is keyed by (seed, step)."""
    kw = dict(CHAIN, upsample_factor=2, output_rate="upsampled",
              dither_kind="tpdf", dither_bits=16)
    x = sig(3, 2 * 256, seed=2)
    p, _, a = port_run(kw, x)
    _, _, b = port_run(kw, x)
    _, _, clean = port_run({**kw, "dither_kind": "off"}, x)
    dev = np.max(np.abs(a - clean)) / 2.0 ** -15
    print(f"upsampled dither: max |dithered − clean| = {dev:.4f} lsb")
    assert np.array_equal(a, b) and 0 < dev < 1.001
    p16, _, q = port_run({**kw, "emit": "pcm16"}, x)
    assert q.dtype == np.int16 and q.shape == (3, 2 * 2 * 256)
    np.testing.assert_array_equal(
        q, np.clip(np.round(a.astype(np.float64) * 32768), -32768, 32767))


def test_literal_chain_refuses_ring_and_fold():
    p = Pipeline(StreamConfig(**CHAIN, fuse_rate_conversion=False), "cpu")
    params = p.device_params(PipelineParams.design(p.cfg))
    assert not p.supports_ring_step and not p.supports_fold
    with pytest.raises(ValueError, match="cannot fold"):
        p.process_signal(params, p.init_state(), torch.zeros(3, 512), fold=True)
    with pytest.raises(ValueError, match="ring"):
        p.ring_step(params, p.init_state(), torch.zeros(2, 3, 256), None, 0,
                    torch.zeros(2, 3, 256))


def test_unfused_filter_bank_matches_reference():
    """Per-stream main filters under the literal chain: the bank is the raw
    mains (`afp_tpu/engine/batch.py:301-302`), a [B, F] H_main on 'fft';
    ≡ `afp_tpu`'s banked literal chain (≤ −100 dB)."""
    from afp_tpu.engine.batch import with_per_stream_filters as j_filters

    kw = dict(CHAIN, upsample_factor=2, fuse_rate_conversion=False,
              downsample_mode="decimate", eq_enabled=False)
    variants = [dict(cutoff=c) for c in (6000.0, 9000.0, 12000.0)]
    x = sig(3, 4 * 256, seed=3)
    p, _, ours = port_run(kw, x, lambda p, _: with_per_stream_filters(p, variants))
    jp = JPipeline(JConfig(**kw))
    jparams = j_filters(jp, variants)
    _, ref = jp.process_signal(jparams, jp.init_state(0), jnp.asarray(x))
    e = err_db(ours, np.asarray(ref))
    print(f"un-fused bank: {e:.1f} dB vs afp_tpu")
    assert e <= REF_DB
    for i, v in enumerate(variants):
        _, _, one = port_run(dict(kw, cutoff=v["cutoff"]), x)
        assert err_db(ours[i], one[i]) < -120


def test_literal_chain_state_round_trip():
    """state_from_numpy restores the up/down histories: a run resumed from
    a state rebuilt from numpy ≡ the uninterrupted run, bit for bit."""
    kw = dict(CHAIN, upsample_factor=2, fuse_rate_conversion=False)
    x = torch.from_numpy(sig(3, 4 * 256, seed=4))
    p = Pipeline(StreamConfig(**kw), "cpu")
    params = p.device_params(PipelineParams.design(p.cfg))
    _, full = p.process_signal(params, p.init_state(), x)
    s1, a = p.process_signal(params, p.init_state(), x[:, :512])
    s2 = p.state_from_numpy(s1.conv_tail.numpy(), s1.seed, s1.step,
                            resampler_hist={"up": s1.up.hist.numpy(),
                                            "down": s1.down.hist.numpy()})
    _, b = p.process_signal(params, s2, x[:, 512:])
    assert torch.equal(torch.cat([a, b], 1), full)
    with pytest.raises(ValueError, match="resamplers"):
        p.state_from_numpy(s1.conv_tail.numpy(), 0, 0,
                           resampler_hist={"asrc": np.zeros((3, 4))})


def test_resampling_quality_in_literal_chain():
    """The literal chain honors resample_quality: its up/down kernels are
    the tier's (different tiers give different outputs)."""
    x = sig(3, 2 * 256, seed=5)
    outs = {q: port_run(dict(CHAIN, fuse_rate_conversion=False,
                             resample_quality=q), x)[2] for q in ("fast", "vhq")}
    p = Pipeline(StreamConfig(**dict(CHAIN, fuse_rate_conversion=False,
                                     resample_quality="vhq")), "cpu")
    st = p.init_state()
    np.testing.assert_array_equal(
        st.up.h.numpy(), T._prepad_kernel(T.quality_kernel(2, 1, "vhq"), 1)[0]
        .astype(np.float32))
    assert err_db(outs["fast"], outs["vhq"]) > -60
