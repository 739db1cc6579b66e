"""``emit='pcm16'`` in the port against `afp_tpu` on the CPU: the int16
quantizer, the int16 store of every conv kernel (K1, K3, K4, K7, K8, K12,
K13), and int16 output through Pipeline, RingServer and StreamEngine.

Contracts: a kernel's int16 output ≡ `quantize_pcm16` of its own f32
output under the same epilogue, bit for bit; against `afp_tpu` (dither
off) the int16 outputs differ by at most 1 LSB, since a ≤ −110 dB f32
difference can flip a rounding tie: each comparison prints how many
samples differ.  Inside the port the serving forms equal the staged step
bit for bit with dither on (the reference refuses that only in its
interpret mode, `pipeline.py:1133-1137, 1381-1386`)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.ops.pallas import fir_td as jfir
from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  StreamEngine)
from afp_tpu_torch.ops.cuda import fir_td as F
from afp_tpu_torch.runtime import RingServer

LSB = 1  # int16 outputs against afp_tpu: at most one step apart

#: the C5 chain at small size with int16 output (`bench.py:563-578`)
C5 = dict(samplerate=44100, blocksize=256, upsample_factor=4, numtaps=63,
          batch=4, cutoff=9000.0, eq_enabled=False, downsample_mode="decimate",
          output_clip=None, resample_quality="fast", conv_strategy="td_mxu",
          dither_kind="off", emit="pcm16")
#: the C8 AGC chain at small size, int16 in and out (`bench.py:879-912`)
C8 = dict(samplerate=44100, blocksize=256, upsample_factor=2, numtaps=129,
          cutoff=14000.0, eq_enabled=True, agc_enabled=True, agc_mode="exact",
          agc_window_size=128, agc_carry=True, downsample_mode="decimate",
          dither_kind="off", output_clip=0.99, conv_strategy="td_mxu",
          batch=8, ingest="pcm16", emit="pcm16")
#: dither and clip on, so the quantizer sees the fused epilogue
EPI = dict(out_clip=0.3, dither_key=(9, 4), dither_bits=16, dither_tpdf=True)


def lsb_diff(name, got, want) -> None:
    """Assert int16 outputs at most :data:`LSB` apart; print the count."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{name}: max |Δ| {d.max()} LSB, {int((d > 0).sum())} of {d.size} "
          f"samples differ (bound {LSB} LSB)")
    assert d.max() <= LSB


def pcm(shape, seed=0, scale=6000.0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    x = np.clip(np.round(x), -32768, 32767).astype(np.int16)
    x.reshape(-1)[:2] = (-32768, 32767)
    return x


def noise(shape, seed=0, scale=0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def port(kw):
    p = Pipeline(StreamConfig(**kw), "cpu")
    return p, p.device_params(PipelineParams.design(p.cfg))


def staged(p, params, xs, seed=0):
    st = p.init_state(seed=seed)
    outs = []
    for x in xs:
        st, y = p.step(params, st, x)
        outs.append(y)
    return st, torch.stack(outs)


# ---------------------------------------------------------------- quantizer


def test_quantize_pcm16_matches_jax():
    """Bit-exact to `afp_tpu`'s quantizer: ties of y·32768 at ±k+0.5 round
    to even, ±full scale and beyond clamp, tiny values round to 0."""
    k = np.arange(-40, 40, dtype=np.float64)
    ties = (k + 0.5) / 32768.0
    edges = [0.0, -0.0, 1.0, -1.0, 0.5, 2.0, -2.0, 1.0 / 32768.0,
             32767.5 / 32768.0, -32768.5 / 32768.0, 1e30, -1e30, 1e-30,
             np.inf, -np.inf]
    y = np.concatenate([ties, -ties, edges,
                        np.random.default_rng(0).uniform(-1.2, 1.2, 4096)]
                       ).astype(np.float32)
    got = F.quantize_pcm16(torch.from_numpy(y)).numpy()
    want = np.asarray(jfir.quantize_pcm16(jnp.asarray(y)))
    assert got.dtype == np.int16 and np.array_equal(got, want)
    assert list(F.quantize_pcm16(torch.tensor([0.5 / 32768, 1.5 / 32768,
                                               -0.5 / 32768, 1.0, -1.0]))) == \
        [0, 2, 0, 32767, -32768]
    print(f"quantize_pcm16: {y.size} values bit-exact to afp_tpu")


# ---------------------------------------------------------------- int16 store


def _conv_case(name):
    """Run conv kernel `name` at a small shape with the int16 store and
    with the f32 store under the same epilogue: (int16 out, f32 out)."""
    n, B, T, S = 129, 8, 256, 3
    rng = np.random.default_rng(1)
    h = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    k_pad = F.ring_k_pad(n)
    ring = torch.from_numpy(noise((S, B, T), seed=2))
    tail = torch.from_numpy(noise((B, k_pad), seed=3))
    ring16, tail16 = torch.from_numpy(pcm((S, B, T), seed=4)), torch.from_numpy(
        pcm((B, k_pad), seed=5))
    (rh, rl), (th, tl) = F.split_bf16(ring), F.split_bf16(tail)

    def out(dtype):
        return torch.zeros((S, B, T), dtype=dtype)

    ext = torch.cat([tail[:, k_pad - (n - 1):], ring[0]], -1)
    runs = {
        "K1": lambda e: F.fir_td_mxu(ext, h, emit_i16=e, **EPI),
        "K8": lambda e: F.fir_td_mxu_pair(rh[1], rl[1], th, tl, h, emit_i16=e,
                                          **EPI)[0],
        "K3": lambda e: F.fir_td_mxu_ring_f32(ring, 1, tail, h, out(e), **EPI)[0],
        "K4": lambda e: F.fir_td_mxu_ring_mega_f32(ring, 2, tail, h, out(e), 4,
                                                   **EPI)[0],
        "K7": lambda e: F.fir_td_mxu_pair_to_ring(rh[1], rl[1], th, tl, h, 2,
                                                  out(e), **EPI)[0],
        "K12": lambda e: F.fir_td_mxu_ring_pcm16(ring16, 0, tail16, h, out(e),
                                                 **EPI)[0],
        "K12 mega": lambda e: F.fir_td_mxu_ring_mega_pcm16(
            ring16, 1, tail16, h, out(e), 5, **EPI)[0],
        "K13": lambda e: F.fir_td_mxu_ring(rh, rl, 2, th, tl, h, out(e),
                                           **EPI)[0],
        "K13 mega": lambda e: F.fir_td_mxu_ring_mega(rh, rl, 0, th, tl, h,
                                                     out(e), 4, **EPI)[0],
    }
    run = runs[name]
    # K1/K8 take emit_i16; the ring forms follow their output ring's dtype
    if name in ("K1", "K8"):
        return run(True), run(False)
    return run(torch.int16), run(torch.float32)


@pytest.mark.parametrize("name", ["K1", "K8", "K3", "K4", "K7", "K12",
                                  "K12 mega", "K13", "K13 mega"])
def test_int16_store_is_quantized_f32(name):
    """Each conv form's int16 store ≡ quantize_pcm16 of its own f32 output
    under the same clip + dither epilogue, bit for bit (slots it does not
    write stay 0 in both)."""
    q, y = _conv_case(name)
    assert q.dtype == torch.int16 and torch.equal(q, F.quantize_pcm16(y))


@pytest.mark.parametrize("name", ["K1", "K8", "K3"])
def test_int16_store_vs_pallas(name):
    """The int16 store against `afp_tpu`'s (interpret, dither off, clip on):
    K1 ``emit_i16``, K8 ``emit_i16`` and K3 into an int16 ring."""
    n, B, T = 129, 8, 256
    rng = np.random.default_rng(6)
    h = (rng.standard_normal(n) * 0.1).astype(np.float32)
    x = noise((B, n - 1 + T), seed=7)
    band = jfir.band_matrix(h)
    if name == "K1":
        got = F.fir_td_mxu(torch.from_numpy(x), torch.from_numpy(h),
                           out_clip=0.3, emit_i16=True)
        want = jfir.fir_td_mxu(x, band, interpret=True, out_clip=0.3,
                               emit_i16=True)
    elif name == "K8":
        k_pad = F.ring_k_pad(n)
        ext = np.concatenate([np.zeros((B, k_pad - (n - 1)), np.float32), x], -1)
        (xh, xl), (th, tl) = (F.split_bf16(torch.from_numpy(ext[:, k_pad:])),
                              F.split_bf16(torch.from_numpy(ext[:, :k_pad])))
        got = F.fir_td_mxu_pair(xh, xl, th, tl, torch.from_numpy(h),
                                out_clip=0.3, emit_i16=True)[0]
        jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (xh, xl, th, tl)]
        want = jfir.fir_td_mxu_pair(*jb, band, interpret=True, out_clip=0.3,
                                    emit_i16=True)
    else:
        S = 2
        ring = noise((S, B, T), seed=8)
        tail = x[:, : n - 1]
        got = F.fir_td_mxu_ring_f32(
            torch.from_numpy(ring), 1, torch.from_numpy(tail),
            torch.from_numpy(h), torch.zeros((S, B, T), dtype=torch.int16),
            out_clip=0.3)[0]
        want = jfir.fir_td_mxu_ring_f32(
            jnp.asarray(ring), 1, jnp.asarray(tail), band,
            jnp.zeros((S, B, T), jnp.int16), interpret=True, out_clip=0.3)[0]
    lsb_diff(f"{name} int16 store vs afp_tpu", got.numpy(), want)


# ---------------------------------------------------------------- the chain


@pytest.mark.parametrize("over", [
    dict(ingest="f32"), dict(ingest="f32", conv_strategy="fft"),
    dict(ingest="pcm16")], ids=["td", "fft", "pcm16-in"])
def test_emit_pipeline_matches_jax(over):
    """Four blocks through `process_signal` against `afp_tpu`'s pipeline
    with the same config, dither off: int16 out, at most 1 LSB apart
    ('fft' quantizes after the clip as `afp_tpu`'s XLA epilogue does)."""
    kw = {**C5, **over}
    sig = pcm((4, 4 * 256), seed=9)
    if kw["ingest"] == "f32":
        sig = sig.astype(np.float32) / 32768.0
    jp = JPipeline(JConfig(**kw))
    jpar = jp.device_params(JParams.design(jp.cfg))
    _, want = jp.process_signal(jpar, jp.init_state(), jnp.asarray(sig), fold=False)
    tp, tpar = port(kw)
    _, got = tp.process_signal(tpar, tp.init_state(), sig)
    lsb_diff(f"C5 emit {over}", got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ingest", ["f32", "pcm16"])
def test_emit_serving_equals_staged_with_dither(ingest):
    """Dither (clamped to 16 bits) and clip on: run_ring ≡ run_ring_mega ≡
    the staged steps, RingServer (per-step and mega) yields the same int16
    blocks, and all of it ≡ quantize_pcm16 of the f32-output pipeline with
    the same 16-bit dither."""
    kw = {**C5, "ingest": ingest, "dither_kind": "tpdf", "dither_bits": 24,
          "output_clip": 0.5}
    tp, tpar = port(kw)
    assert tp.cfg.dither_bits == 16  # validate() clamps under emit
    xs = pcm((4, 4, 256), seed=10)
    if ingest == "f32":
        xs = xs.astype(np.float32) / 32768.0
    _, want = staged(tp, tpar, xs, seed=2)
    assert want.dtype == torch.int16
    ring = torch.from_numpy(xs)
    for run in (tp.run_ring, tp.run_ring_mega):
        _, out = run(tpar, tp.init_state(seed=2), ring, None,
                     torch.zeros(4, 4, 256, dtype=torch.int16), 4)
        assert torch.equal(out, want)
    for mega in (False, True):
        srv = RingServer(tp, tpar, slots=4, chunk=2, max_inflight=1, seed=2,
                         mega=mega)
        got = np.stack(list(srv.stream(iter(xs))))
        assert got.dtype == np.int16 and np.array_equal(got, want.numpy())
    fp, fpar = port({**kw, "emit": "f32", "dither_bits": 16})
    assert torch.equal(F.quantize_pcm16(staged(fp, fpar, xs, seed=2)[1]), want)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_c8_i16io_matches_jax_and_ring(mode):
    """C8 with int16 in and out, three blocks: against `afp_tpu` (dither
    off) at most 1 LSB apart; with dither on, the ring (K5/K6 on the int16
    slot, K7 into an int16 ring) ≡ the staged steps."""
    kw = {**C8, "agc_mode": mode}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 8, 256)) * 0.05
    x[:, 0] *= 12.0
    x[1::2, 2:4] *= 8.0
    xs = np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    jp = JPipeline(JConfig(**kw))
    jpar = jp.device_params(JParams.design(jp.cfg))
    jst, want = jp.init_state(), []
    for blk in xs:
        jst, y = jp.step(jpar, jst, jnp.asarray(blk))
        want.append(np.asarray(y))
    tp, tpar = port(kw)
    _, got = staged(tp, tpar, xs)
    lsb_diff(f"C8 {mode} int16 in and out", got.numpy(), np.stack(want))
    dp, dpar = port({**kw, "dither_kind": "tpdf"})
    st, want_d = staged(dp, dpar, xs, seed=5)
    rst, out = dp.run_ring(dpar, dp.init_state(seed=5), torch.from_numpy(xs), None,
                           torch.zeros(3, 8, 256, dtype=torch.int16), 3)
    assert torch.equal(out, want_d) and torch.equal(rst.agc_gain, st.agc_gain)


def test_emit_ring_dtype_contract():
    """emit='pcm16' rings are int16 and f32-output rings float32, in the
    pipeline and in the kernels."""
    tp, tpar = port({**C5, "ingest": "f32"})
    ring = torch.zeros(2, 4, 256)
    with pytest.raises(ValueError, match="int16"):
        tp.run_ring(tpar, tp.init_state(), ring, None, torch.zeros(2, 4, 256), 2)
    fp, fpar = port({**C5, "ingest": "f32", "emit": "f32"})
    with pytest.raises(ValueError, match="float32"):
        fp.run_ring(fpar, fp.init_state(), ring, None,
                    torch.zeros(2, 4, 256, dtype=torch.int16), 2)
    with pytest.raises(ValueError, match="float32 or int16"):
        F.fir_td_mxu_ring_f32(ring, 0, torch.zeros(4, 128), torch.zeros(31),
                              torch.zeros(2, 4, 256, dtype=torch.float64))


def test_engine_emit16_surfaces(monkeypatch):
    """StreamEngine under emit='pcm16' ('fft' and 'td_mxu'): int16 blocks
    out equal to the pipeline's; the underrun blend requantizes 0.8·last
    (round half to even); the ladder's silence is int16."""
    for strategy in ("fft", "td_mxu"):
        kw = {**C5, "ingest": "f32", "conv_strategy": strategy,
              "dither_kind": "tpdf"}
        eng = StreamEngine(StreamConfig(**kw), device="cpu", seed=1)
        tp, tpar = port(kw)
        x = noise((4, 256), seed=12)
        out = eng.process_block(x)
        assert out.dtype == np.int16
        assert np.array_equal(out, tp.step(tpar, tp.init_state(seed=1), x)[1].numpy())
        blend = eng.underrun_block()
        assert blend.dtype == np.int16 and np.array_equal(
            blend, np.clip(np.round(0.8 * out.astype(np.float64)), -32768,
                           32767).astype(np.int16))
    eng = StreamEngine(StreamConfig(**{**C5, "ingest": "f32"}), device="cpu")

    def fail(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(eng.pipeline, "step", fail)
    silence = eng.process_block(noise((4, 256)))
    assert silence.dtype == np.int16 and not silence.any()
    assert (eng.metrics.underruns, eng.metrics.fallback_silence) == (1, 1)
    cfg = dataclasses.replace(eng.cfg, cutoff=5000.0)
    assert eng.apply_config(cfg) is True
