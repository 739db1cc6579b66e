"""K14, the one-kernel AGC (`ops/cuda/agc_fused.py`), against `afp_tpu` on
the CPU, at the reference's cases (`tests/test_agc_fused.py`: batch 1024,
block 512, window 256) and at the C8 window (block 1024, window 512) and a
window as wide as the block (2048): the plain version against
`agc_rms_apply_pallas` in interpret mode, the gate, the float64 oracle,
and the Pipeline's ``agc_one_kernel`` route (one vs two kernels, ring ≡
staged).

Inputs are made with numpy from a seed and handed to both packages.  The
bounds: the kernel's output and gain bit for bit against `afp_tpu`'s (the
same f32 operations in the same order, as XLA's CPU backend rounds them);
the chain < −100 dB against float64; one vs two kernels ≤ −95 dB (the
two-kernel boxcar's bf16-split error, the reference's bound)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.ops.pallas.agc_fused import agc_rms_apply_pallas
from afp_tpu.ops.pallas.agc_fused import fused_rms_supported as j_supported
from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig, batch
from afp_tpu_torch.ops.cuda import agc_fused as K14
from afp_tpu_torch.ops.cuda import merge_bf16, split_bf16

ARGS = (0.02, 0.002, 0.1, 10.0)  # a_att, a_rel, target, max_gain


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def loud_quiet(B, T, seed=1234, scale=0.2) -> np.ndarray:
    """Noise with the reference's adversarial loud-then-quiet row, which a
    block-long running sum would fail on."""
    x = (np.random.default_rng(seed).normal(size=(B, T)) * scale).astype(np.float32)
    x[0, : T // 2] = 0.95
    x[0, T // 2:] = 1e-4
    return x


def test_gate_shapes():
    """The reference's gate, without its batch ladder (the kernel masks
    rows, so the untileable batch 1000 runs here)."""
    for args in [(4096, 2048, 512, 256), (1024, 256, 256, 128),
                 (1024, 256, 128, 64), (1024, 256, 384, 192),
                 (1024, 250, 256, 128), (1024, 256, 256, 127)]:
        assert K14.fused_rms_supported(*args) == j_supported(*args)
    assert not j_supported(1000, 256, 256, 128)
    assert K14.fused_rms_supported(1000, 256, 256, 128)
    with pytest.raises(ValueError, match="fused_rms_supported"):
        K14.agc_rms_apply(torch.zeros(4, 256), 128, *ARGS)


@pytest.fixture(scope="module", params=[(512, 256), (1024, 512), (2048, 2048)],
                ids=["w256", "w512", "w2048"])
def reference_run(request):
    """`afp_tpu`'s kernel in interpret mode (one ~15-20 s compile a shape),
    with and without the carry, at the smallest batch its gate takes:
    w = 256 (h = 1: one order of the base sum), the C8 window w = 512
    (h = 2) and w = 2048 (h = 8, a window as wide as the block)."""
    B, (T, w) = 1024, request.param
    x = loud_quiet(B, T)
    init = np.random.default_rng(5).uniform(0.2, 5.0, B).astype(np.float32)
    out = {}
    for ini in (None, init):
        y, g = agc_rms_apply_pallas(jnp.asarray(x), w, *ARGS,
                                    init=None if ini is None else jnp.asarray(ini),
                                    out_clip=0.99, interpret=True)
        out[ini is None] = (np.asarray(y), np.asarray(g))
    return x, w, init, out


@pytest.mark.parametrize("restart", [True, False])
def test_kernel_matches_afp_tpu(reference_run, restart):
    x, w, init, out = reference_run
    y, g = K14.agc_rms_apply(torch.from_numpy(x), w, *ARGS,
                             init=None if restart else torch.from_numpy(init))
    want_y, want_g = out[restart]
    nd = int(np.sum(y.numpy() != want_y))
    print(f"K14 T={x.shape[1]} w={w} restart={restart}: {nd} samples and "
          f"{int(np.sum(g.numpy() != want_g))} gains differ from afp_tpu (bound 0)")
    assert nd == 0 and np.array_equal(g.numpy(), want_g)


def test_input_forms_are_the_same_function():
    """int16 x ≡ f32 x of n/32768, the pair store ≡ split_bf16 of the f32
    store, a ring slot ≡ the block itself, bit for bit; the knobs are
    scalars (vectors raise)."""
    B, T, w = 40, 384, 256
    x = loud_quiet(B, T, seed=2)
    x16 = np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    xf = torch.from_numpy(x16.astype(np.float32) / np.float32(32768))
    init = torch.linspace(0.3, 6.0, B)
    y, g = K14.agc_rms_apply(xf, w, *ARGS, init=init)
    y16, g16 = K14.agc_rms_apply(torch.from_numpy(x16), w, *ARGS, init=init)
    (yh, yl), gp = K14.agc_rms_apply(xf, w, *ARGS, init=init, emit_split=True)
    ring = torch.stack([torch.zeros(B, T), xf, torch.ones(B, T)])
    yr, gr = K14.agc_rms_apply(ring, w, *ARGS, init=init, ring_idx=4)
    sh, sl = split_bf16(y)
    assert torch.equal(y16, y) and torch.equal(g16, g)
    assert torch.equal(yh, sh) and torch.equal(yl, sl) and torch.equal(gp, g)
    assert torch.equal(yr, y) and torch.equal(gr, g)
    assert float(merge_bf16(yh, yl).sub(y).abs().max()) <= float(y.abs().max()) * 2 ** -16
    with pytest.raises(ValueError, match="scalar"):
        K14.agc_rms_apply(xf, w, torch.full((B,), 0.02), 0.002, 0.1, 10.0)


def test_vs_f64_oracle():
    """The window-local sums keep the chain < −100 dB from float64, the
    loud-then-quiet row included (`tests/test_agc_fused.py:102-116`)."""
    B, T, w = 64, 512, 512
    x = loud_quiet(B, T, seed=3)
    a_att, a_rel, target, mg = ARGS
    xd = x.astype(np.float64)
    ss = np.stack([np.convolve(r, np.ones(w) / w, "same") for r in xd * xd])
    d = np.clip(target / (np.sqrt(np.maximum(ss, 0)) + 1e-10), 0, mg)
    g = np.empty_like(d)
    g[:, 0] = d[:, 0]
    for t in range(1, T):
        a = np.where(d[:, t] > g[:, t - 1], a_att, a_rel)
        g[:, t] = a * d[:, t] + (1 - a) * g[:, t - 1]
    g = np.clip(g, 0.1, mg)
    y64 = np.clip(xd * g, -0.99, 0.99)
    y, gl = K14.agc_rms_apply(torch.from_numpy(x), w, *ARGS)
    e = err_db(y.numpy(), y64)
    print(f"K14 vs float64: {e:.1f} dB, gain {np.max(np.abs(gl.numpy() - g[:, -1])):.2e}")
    assert e < -100.0 and np.max(np.abs(gl.numpy() - g[:, -1])) < 1e-4


# ---------------------------------------------------------------- pipeline


def c8(**kw):
    base = dict(resample_quality="fast", samplerate=44100, blocksize=512,
                upsample_factor=2, numtaps=33, batch=1024, eq_enabled=True,
                agc_enabled=True, agc_mode="exact", agc_window_size=256,
                agc_carry=True, dither_kind="tpdf", output_clip=0.99,
                conv_strategy="td_mxu")
    return StreamConfig(**{**base, **kw})


def test_pipeline_gate():
    """``agc_one_kernel`` applies under the reference's conditions
    (`pipeline.py:256-264`, `tests/test_agc_fused.py:152-158`)."""
    assert Pipeline(c8(), "cpu", agc_one_kernel=True)._agc_one_kernel
    assert not Pipeline(c8(), "cpu")._agc_one_kernel
    for over in (dict(blocksize=256),  # window clamped to 128 < 2·TC
                 dict(agc_window_size=64), dict(agc_mode="fast"),
                 dict(agc_link_group=2, batch=1024)):
        assert not Pipeline(c8(**over), "cpu", agc_one_kernel=True)._agc_one_kernel


def run_steps(pipe, params, sig, seed=9):
    st = pipe.init_state(seed=seed)
    outs = []
    for b in sig:
        st, y = pipe.step(params, st, b)
        outs.append(y)
    return st, torch.stack(outs)


def test_pipeline_one_vs_two_kernel():
    """K14 → K8 against K5 → K6 → K8: the two-kernel boxcar's bf16-split
    error, ≤ −95 dB on the chain output (the reference's bound); K14 ran,
    through its pair store."""
    sig = (np.random.default_rng(11).normal(size=(3, 1024, 512)) * 0.1).astype(np.float32)
    one = Pipeline(c8(), "cpu", agc_one_kernel=True)
    two = Pipeline(c8(), "cpu")
    params = one.device_params(PipelineParams.design(one.cfg))
    _, y1 = run_steps(one, params, sig)
    _, y2 = run_steps(two, params, sig)
    for i in range(3):
        e = err_db(y1[i].numpy(), y2[i].numpy())
        print(f"one vs two kernel, block {i}: {e:.1f} dB (bound -95)")
        assert e <= -95.0


def test_pipeline_one_kernel_ring_matches_step():
    """The ring form (K14 over the slot → K7) ≡ the staged steps (K14 →
    K8), bit for bit with dither on, the gain carry and pair tail included;
    run_ring over the same ring reproduces it; per-stream AGC vectors take
    the two-kernel chain, as in the reference."""
    sig = (np.random.default_rng(12).normal(size=(3, 1024, 512)) * 0.1).astype(np.float32)
    pipe = Pipeline(c8(), "cpu", agc_one_kernel=True)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    st, ref = run_steps(pipe, params, sig)
    ring = torch.from_numpy(sig)
    st2, out = pipe.run_ring(params, pipe.init_state(seed=9), ring, None,
                             torch.zeros_like(ring), 3)
    assert torch.equal(out, ref) and torch.equal(st.agc_gain, st2.agc_gain)
    assert all(torch.equal(a, b) for a, b in zip(st.conv_tail, st2.conv_tail))

    vec = batch.with_per_stream_agc(pipe, params,
                                    target_level=np.full(1024, 0.1, np.float32))
    two = Pipeline(c8(), "cpu")
    _, yv = run_steps(pipe, vec, sig[:1])
    _, y2 = run_steps(two, vec, sig[:1])
    assert torch.equal(yv, y2)


def test_engine_and_fft_take_the_option():
    """StreamEngine passes ``agc_one_kernel``; under 'fft' and HIGHEST K14
    stores f32 for the conv."""
    from afp_tpu_torch.engine import StreamEngine

    kw = dict(batch=64)
    eng = StreamEngine(c8(**kw), device="cpu", agc_one_kernel=True)
    assert eng.pipeline._agc_one_kernel
    blk = (np.random.default_rng(13).normal(size=(64, 512)) * 0.1).astype(np.float32)
    assert eng.process_block(blk).shape == (64, 512) and eng.metrics.underruns == 0
    for pipe in (Pipeline(c8(conv_strategy="fft", **kw), "cpu", agc_one_kernel=True),
                 Pipeline(c8(**kw), "cpu", agc_one_kernel=True,
                          td_precision="HIGHEST")):
        assert pipe._agc_one_kernel and not pipe._pair_tail
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        _, y = pipe.step(params, pipe.init_state(), blk)
        assert bool(torch.isfinite(y).all())
