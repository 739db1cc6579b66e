"""K15, the conv's precision, against `afp_tpu` on the CPU: the HIGHEST K1
and K11 plain versions against the Pallas kernels' HIGHEST branches in
interpret mode (`_fir_kernel`, `_fir_kernel_ps`), B3F and B3C ≡ B3 inside the
port and against `afp_tpu`'s B3F/B3C layouts, the Pipeline's C5 and C8
chains under ``td_precision='HIGHEST'`` against `afp_tpu`'s Pipeline with its
``PRECISION_MODE`` set to 'HIGHEST', and the reference's gates.

Inputs are made with numpy from a seed and handed to both packages.  Each
test states its bound (max-abs error over peak, in dB) and prints the
measured value: the conv forms ≤ −110 dB (fp32 or bf16×3 sums in another
order), the AGC chain ≤ −100 dB (K5's boxcar against `afp_tpu`'s CPU
route)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.ops.pallas import fir_td as jfir
from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig, batch
from afp_tpu_torch.ops.cuda import fir_td as F
from afp_tpu_torch.runtime import RingServer

CONV_DB = -110.0  # fp32 or bf16×3 sums in another order
CHAIN_DB = -100.0  # the AGC chain against `afp_tpu`'s CPU route


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def check(name, got, want, bound):
    e = err_db(got, want)
    print(f"{name}: {e:.1f} dB (bound {bound})")
    assert np.asarray(got).shape == np.asarray(want).shape and e <= bound


def randn(*shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("B,T,n", [(8, 256, 31), (8, 384, 129)])
def test_highest_k1_matches(B, T, n):
    """Plain HIGHEST K1 against `fir_td_mxu(precision='HIGHEST')` (the 6-pass
    fp32 branch, interpret mode), with the fused clip."""
    x, h = randn(B, n - 1 + T), randn(n, seed=1)
    want = jfir.fir_td_mxu(jnp.asarray(x), jnp.asarray(jfir.band_matrix(h)),
                           interpret=True, precision="HIGHEST", out_clip=0.2)
    got = F.fir_td_mxu(torch.from_numpy(x), torch.from_numpy(h),
                       precision="HIGHEST", out_clip=0.2)
    check(f"HIGHEST K1 B={B} T={T} n={n}", got.numpy(), np.asarray(want), CONV_DB)


def test_highest_k11_matches():
    """Plain HIGHEST K11 against `fir_td_mxu_per_stream(precision='HIGHEST')`
    (`_fir_kernel_ps`, interpret mode)."""
    B, T, n, K = 8, 256, 33, 4
    x, k = randn(B, n - 1 + T), randn(K, n, seed=1)
    g = np.random.default_rng(2).uniform(0, 2, (B, K)).astype(np.float32)
    want = jfir.fir_td_mxu_per_stream(jnp.asarray(x), jnp.asarray(k), jnp.asarray(g),
                                      interpret=True, precision="HIGHEST")
    got = F.fir_td_mxu_per_stream(torch.from_numpy(x), torch.from_numpy(k),
                                  torch.from_numpy(g), precision="HIGHEST")
    check("HIGHEST K11", got.numpy(), np.asarray(want), CONV_DB)


@pytest.mark.parametrize("precision", ["B3F", "B3C"])
def test_b3f_b3c_are_b3(precision):
    """B3F and B3C ≡ B3 in the port bit for bit (one body: the loader
    splits the f32 input), and ≤ −110 dB from `afp_tpu`'s B3F (split in the
    kernel) and B3C (the time-chunk-pair layout, which runs at B ≤ 8,
    T % 512 == 0)."""
    B, T, n = 8, 512, 65
    x, h = randn(B, n - 1 + T), randn(n, seed=1)
    tx, th = torch.from_numpy(x), torch.from_numpy(h)
    b3 = F.fir_td_mxu(tx, th, out_clip=0.2)
    got = F.fir_td_mxu(tx, th, out_clip=0.2, precision=precision)
    assert torch.equal(got, b3)
    assert torch.equal(F.fir_td_mxu(tx, th, emit_i16=True, precision=precision.lower()),
                       F.fir_td_mxu(tx, th, emit_i16=True))
    want = jfir.fir_td_mxu(jnp.asarray(x), jnp.asarray(jfir.band_matrix(h)),
                           interpret=True, precision=precision, out_clip=0.2)
    check(f"{precision} vs afp_tpu", got.numpy(), np.asarray(want), CONV_DB)


def test_precision_argument_checked():
    x, h = torch.zeros(2, 30 + 128), torch.zeros(31)
    for bad in ("DEFAULT", "b4", None):
        with pytest.raises(ValueError, match="precision"):
            F.fir_td_mxu(x, h, precision=bad)
    with pytest.raises(ValueError, match="precision"):
        F.fir_td_mxu_per_stream(x, torch.zeros(2, 31), torch.zeros(2, 2),
                                precision="HIGH")


# ---------------------------------------------------------------- pipeline

C5 = dict(samplerate=44100, blocksize=256, upsample_factor=4, numtaps=63, batch=8,
          cutoff=9000.0, eq_enabled=False, downsample_mode="decimate",
          output_clip=None, resample_quality="fast", conv_strategy="td_mxu",
          dither_kind="off")
C8 = dict(samplerate=44100, blocksize=256, upsample_factor=2, numtaps=33, batch=8,
          cutoff=14000.0, eq_enabled=True, agc_enabled=True, agc_mode="exact",
          agc_window_size=128, agc_carry=True, downsample_mode="decimate",
          output_clip=0.99, resample_quality="fast", conv_strategy="td_mxu",
          dither_kind="off")


@pytest.fixture
def jax_highest(monkeypatch):
    """`afp_tpu` with its conv precision set to HIGHEST: the module attribute
    is read at call time (`fir_td.py:1695, 1810`, `pipeline.py:273`); the
    environment variable is read only at import."""
    monkeypatch.setattr(jfir, "PRECISION_MODE", "HIGHEST")


def both_runs(cfg_kw, sig, params_of=None):
    """The port at HIGHEST and `afp_tpu` (its precision set by the caller)
    over the same signal, block by block."""
    jp = JPipeline(JConfig(**cfg_kw))
    jparams = jp.device_params(JParams.design(jp.cfg))
    _, jy = jp.process_signal(jparams, jp.init_state(), sig, fold=False)
    tp = Pipeline(StreamConfig(**cfg_kw), "cpu", td_precision="HIGHEST")
    tparams = tp.device_params(PipelineParams.design(tp.cfg))
    if params_of is not None:
        jparams, tparams = params_of(jp, jparams, tp, tparams)
        _, jy = jp.process_signal(jparams, jp.init_state(), sig, fold=False)
    _, ty = tp.process_signal(tparams, tp.init_state(), sig, fold=False)
    return tp, np.asarray(jy), ty.numpy()


def test_pipeline_c5_highest_matches(jax_highest):
    sig = randn(8, 4 * 256, seed=3)
    before = F.fir_td_mxu.launches
    tp, jy, ty = both_runs(C5, sig)
    check("C5 HIGHEST Pipeline", ty, jy, CONV_DB)
    assert F.fir_td_mxu.launches == before  # the CPU runs the plain version


def test_pipeline_c8_highest_matches(jax_highest):
    """K5 → K6 (f32 store) → HIGHEST K1, against `afp_tpu`'s HIGHEST chain;
    the carried conv tail is f32, not the pair."""
    sig = randn(8, 4 * 256, seed=4, scale=0.1)
    sig[0, :256] *= 8.0
    tp, jy, ty = both_runs(C8, sig)
    assert not tp._pair_tail and tp.init_state().conv_tail.dtype == torch.float32
    check("C8 HIGHEST Pipeline", ty, jy, CHAIN_DB)


def test_pipeline_per_stream_highest_matches(jax_highest):
    """Per-stream EQ gains under HIGHEST run HIGHEST K11 (`_fir_kernel_ps`)."""
    from afp_tpu.engine import batch as jbatch

    kw = {**C5, "eq_enabled": True}
    gains = np.random.default_rng(5).uniform(0, 2, (8, 9)).astype(np.float32)

    def per_stream(jp, jparams, tp, tparams):
        return (jbatch.with_per_stream_gains(jp, jparams, gains),
                batch.with_per_stream_gains(tp, tparams, gains))

    _, jy, ty = both_runs(kw, randn(8, 3 * 256, seed=5), per_stream)
    check("per-stream HIGHEST Pipeline", ty, jy, CONV_DB)


def test_highest_gates_match(jax_highest):
    """`afp_tpu`'s gates under HIGHEST: pair and pcm16 ingest raise, no ring
    form (RingServer refuses), banks stay on K10's bf16×3 body, 'fft'
    ignores the precision."""
    for ingest in ("pair", "pcm16"):
        for make in (lambda c: JPipeline(JConfig(**c)),
                     lambda c: Pipeline(StreamConfig(**c), "cpu",
                                        td_precision="HIGHEST")):
            with pytest.raises(ValueError, match="bf16-class"):
                make({**C5, "ingest": ingest})
    hp = Pipeline(StreamConfig(**C5), "cpu", td_precision="HIGHEST")
    assert not hp.supports_ring_step
    assert not JPipeline(JConfig(**C5)).supports_ring_step
    with pytest.raises(ValueError, match="ring-capable"):
        RingServer(hp)
    params = hp.device_params(PipelineParams.design(hp.cfg))
    ring = torch.zeros((2, 8, 256))
    with pytest.raises(ValueError, match="bf16-class"):
        hp.ring_step(params, hp.init_state(), ring, None, 0, torch.zeros_like(ring))

    # banks: K10's bf16×3 body at either precision, bit for bit
    bp = Pipeline(StreamConfig(**C5), "cpu")
    variants = [dict(cutoff=8000.0)] * 8  # one design: a tile of the 8 rows
    sig = randn(8, 2 * 256, seed=6)
    _, yb = bp.process_signal(batch.with_per_stream_filters(bp, variants),
                              bp.init_state(), sig, fold=False)
    _, yh = hp.process_signal(batch.with_per_stream_filters(hp, variants),
                              hp.init_state(), sig, fold=False)
    assert torch.equal(yb, yh)

    # 'fft' ignores it
    fkw = {**C5, "conv_strategy": "fft"}
    outs = []
    for prec in ("B3", "HIGHEST"):
        p = Pipeline(StreamConfig(**fkw), "cpu", td_precision=prec)
        _, y = p.process_signal(p.device_params(PipelineParams.design(p.cfg)),
                                p.init_state(), sig, fold=False)
        outs.append(y)
    assert torch.equal(*outs)
    with pytest.raises(ValueError, match="precision"):
        Pipeline(StreamConfig(**C5), "cpu", td_precision="DEFAULT")


def test_engine_takes_the_precision(jax_highest):
    """StreamEngine passes ``td_precision`` to its pipeline (and keeps it
    through a rebuild)."""
    from afp_tpu_torch.engine import StreamEngine

    eng = StreamEngine(StreamConfig(**C5), device="cpu", td_precision="HIGHEST")
    assert eng.pipeline._highest
    eng.apply_config(StreamConfig(**{**C5, "numtaps": 65}))
    assert eng.pipeline._highest
    out = eng.process_block(randn(8, 256, seed=7))
    assert out.shape == (8, 256) and eng.metrics.underruns == 0
