"""The port's AGC chain (C8) through Pipeline, RingServer and StreamEngine
on the CPU, against `afp_tpu` and against its own forms.

The C8 configuration of `bench.py:827-843` at a small size: 2× upsample,
129 taps at 14 kHz, 9-band EQ, AGC window 128 (the bench's 512 scaled to the
256-sample block), decimate, clip 0.99.  Dither is off wherever `afp_tpu`
is compared (its threefry noise is not the port's Philox).  Each test
states its bound (max-abs error over peak, in dB) and prints the measured
value.  `afp_tpu` runs its default CPU route, and once, through its own
test hook ``AFP_AGC_FUSED_FORCE=1``, the TPU route in interpret mode."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.engine import StreamEngine as JEngine
from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  StreamEngine)
from afp_tpu_torch.runtime import RingServer

CHAIN_DB = -100.0  # vs afp_tpu: the AGC branch points and the bf16×3 conv

C8 = dict(samplerate=44100, blocksize=256, upsample_factor=2, numtaps=129,
          cutoff=14000.0, eq_enabled=True, agc_enabled=True, agc_mode="exact",
          agc_window_size=128, agc_carry=True, downsample_mode="decimate",
          dither_kind="off", output_clip=0.99, conv_strategy="td_mxu", batch=8)


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def blocks(n, B=8, L=256, seed=0) -> np.ndarray:
    """[n, B, L] noise whose level steps up, down and back, so the gain
    attacks, releases and clips; one row stays near silence."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, B, L)).astype(np.float32) * 0.05
    x[:, 0] *= 12.0
    x[:, 1] *= 1e-3
    x[1::2, 2:4] *= 8.0
    return x.astype(np.float32)


def jax_steps(kw, xs):
    """`afp_tpu`'s Pipeline over the blocks: (pipeline, params, the state
    after each block, outputs)."""
    p = JPipeline(JConfig(**kw))
    params = p.device_params(JParams.design(p.cfg))
    st, states, outs = p.init_state(), [], []
    for x in xs:
        st, y = p.step(params, st, jnp.asarray(x))
        states.append(st)
        outs.append(np.asarray(y))
    return p, params, states, np.stack(outs)


def port(kw):
    p = Pipeline(StreamConfig(**kw), "cpu")
    return p, p.device_params(PipelineParams.design(p.cfg))


def port_steps(p, params, xs, state=None):
    st = p.init_state() if state is None else state
    outs = []
    for x in xs:
        st, y = p.step(params, st, x)
        outs.append(y.numpy())
    return st, np.stack(outs)


def carried(tp, jparams, jstate, step):
    """afp_tpu's params and state, carried into the port."""
    params = tp.params_from_numpy({k: None if v is None else np.asarray(v)
                                   for k, v in jparams._asdict().items()})
    tail = jstate.conv_tail
    tail = tuple(np.asarray(t) for t in tail) if isinstance(tail, tuple) \
        else np.asarray(tail)
    return params, tp.state_from_numpy(tail, seed=0, step=step,
                                       agc_gain=np.asarray(jstate.agc_gain))


def check(name, got, want, bound=CHAIN_DB):
    e = err_db(got, want)
    print(f"{name}: {e:.1f} dB (bound {bound})")
    assert np.asarray(got).shape == np.asarray(want).shape and e <= bound


# ---------------------------------------------------------------- geometry


def test_c8_geometry_and_params():
    """The C8 point (`bench.py:827-843`, block 2048, W = 512): n_casc 209,
    k_pad 256, the exact two-level boxcar, the same α and AGC scalars as
    `afp_tpu`, bit for bit."""
    kw = {**C8, "blocksize": 2048, "agc_window_size": 512, "batch": 4}
    jp, tp = JPipeline(JConfig(**kw)), Pipeline(StreamConfig(**kw), "cpu")
    assert (tp.n_casc, tp._k_pad) == (jp.n_casc, jp._k_pad) == (209, 256)
    assert tp._rms_pad == jp._rms_pad and tp._rms_exact and jp._rms_exact
    assert np.array_equal(tp._rms_band.numpy(), np.asarray(jp._rms_band))
    jpar = jp.device_params(JParams.design(jp.cfg))
    tpar = tp.device_params(PipelineParams.design(tp.cfg))
    for f in ("agc_target", "agc_max_gain", "agc_a_att", "agc_a_rel"):
        assert np.asarray(getattr(jpar, f)).tobytes() == getattr(tpar, f).numpy().tobytes()
    new = dataclasses.replace(tp.cfg, agc_attack=0.05, agc_target_level=0.2)
    tp.refresh_dynamic(new)
    jp.refresh_dynamic(dataclasses.replace(jp.cfg, agc_attack=0.05,
                                           agc_target_level=0.2))
    assert (tp.agc.a_att, tp.agc.target_level) == (jp.agc.a_att, jp.agc.target_level)


# ---------------------------------------------------------------- the chain


@pytest.mark.parametrize("strategy", ["td_mxu", "fft"])
def test_c8_steps_match_jax(strategy):
    """Three blocks, exact mode, against `afp_tpu`'s default CPU route; and
    the same after carrying its params and state (its f32 tail split into
    the port's pair) into the port after block 1."""
    kw = {**C8, "conv_strategy": strategy}
    xs = blocks(3, seed=1)
    _, jpar, jstates, want = jax_steps(kw, xs)
    tp, tpar = port(kw)
    st, got = port_steps(tp, tpar, xs)
    check(f"C8 {strategy} y", got, want)
    check(f"C8 {strategy} gain carry", st.agc_gain.numpy(),
          np.asarray(jstates[-1].agc_gain))
    params, state = carried(tp, jpar, jstates[0], step=1)
    st2, rest = port_steps(tp, params, xs[1:], state)
    check(f"C8 {strategy} carried from afp_tpu", rest, want[1:])
    check(f"C8 {strategy} carried gain", st2.agc_gain.numpy(),
          np.asarray(jstates[-1].agc_gain))


@pytest.mark.parametrize("mode,group", [("fast", 1), ("fast", 2), ("exact", 2)])
def test_c8_fast_and_linked_match_jax(mode, group):
    kw = {**C8, "agc_mode": mode, "agc_link_group": group}
    xs = blocks(3, seed=2)
    _, _, jstates, want = jax_steps(kw, xs)
    tp, tpar = port(kw)
    st, got = port_steps(tp, tpar, xs)
    check(f"C8 {mode} link {group} y", got, want)
    check(f"C8 {mode} link {group} gain", st.agc_gain.numpy(),
          np.asarray(jstates[-1].agc_gain))


def test_c8_no_carry_restarts_each_block():
    """agc_carry=False: every block restarts from its own d[0] (the
    reference's per-block behavior), against `afp_tpu`."""
    kw = {**C8, "agc_carry": False}
    xs = blocks(2, seed=3)
    *_, want = jax_steps(kw, xs)
    tp, tpar = port(kw)
    _, got = port_steps(tp, tpar, xs)
    check("C8 agc_carry=False", got, want)


def test_c8_tpu_route_forced(monkeypatch):
    """`afp_tpu`'s TPU route (K5 → K6 → K8 staged, K5 → K6 → K7 ring) in
    interpret mode through its test hook, at K6's smallest tile B = 1024:
    the port's staged steps and ring steps against both (≤ −100 dB), the
    port's ring ≡ its staged steps bit for bit, and the state carried from
    `afp_tpu`'s bf16 pair tail."""
    monkeypatch.setenv("AFP_AGC_FUSED_FORCE", "1")
    kw = {**C8, "batch": 1024}
    xs = blocks(3, B=1024, seed=4)
    jp, jpar, jstates, want = jax_steps(kw, xs)
    assert jp._agc_chain_pair and isinstance(jstates[0].conv_tail, tuple)
    ring = jnp.asarray(xs)
    _, jring = jp.run_ring(jpar, jp.init_state(), ring, None,
                           jnp.zeros_like(ring), 3, start=0)
    tp, tpar = port(kw)
    st, got = port_steps(tp, tpar, xs)
    check("forced staged", got, want)
    check("forced ring_step", got, np.asarray(jring))
    rst, rout = tp.run_ring(tpar, tp.init_state(), torch.from_numpy(xs), None,
                            torch.zeros(xs.shape), 3, start=0)
    assert np.array_equal(rout.numpy(), got)
    assert all(torch.equal(a, b) for a, b in zip(rst.conv_tail, st.conv_tail))
    assert torch.equal(rst.agc_gain, st.agc_gain) and rst.step == 3
    params, state = carried(tp, jpar, jstates[0], step=1)
    _, rest = port_steps(tp, params, xs[1:], state)
    check("forced, carried pair tail", rest, want[1:])


@pytest.mark.parametrize("strategy", ["td_mxu", "fft"])
def test_c8_blocked_equals_one_shot(strategy):
    """step() block by block ≡ process_signal, bit for bit, dither on."""
    kw = {**C8, "conv_strategy": strategy, "dither_kind": "tpdf"}
    tp, tpar = port(kw)
    sig = np.concatenate(list(blocks(3, seed=5)), axis=-1)
    st1, whole = tp.process_signal(tpar, tp.init_state(seed=2), sig)
    st2, parts = port_steps(tp, tpar, blocks(3, seed=5), tp.init_state(seed=2))
    assert np.array_equal(whole.numpy(), np.concatenate(list(parts), axis=-1))
    assert torch.equal(st1.agc_gain, st2.agc_gain) and st1.step == 3


# ---------------------------------------------------------------- serving


def test_ring_server_c8_equals_staged():
    """RingServer (per-step AGC ring, 8 slots, chunk 2) over 7 blocks yields
    the staged steps' outputs bit for bit with dither on; a retune of the
    AGC target takes effect at the next chunk; mega=True has no AGC form."""
    kw = {**C8, "dither_kind": "tpdf"}
    tp, tpar = port(kw)
    xs = blocks(7, seed=6)
    srv = RingServer(tp, tpar, slots=8, chunk=2, max_inflight=1, seed=3)
    got = list(srv.stream(iter(xs[:4])))
    new_cfg = dataclasses.replace(tp.cfg, agc_target_level=0.3)
    srv.retune(new_cfg)
    got += list(srv.stream(iter(xs[4:])))
    q, qpar = port(kw)
    new = q.device_params(PipelineParams.design(new_cfg), cfg=new_cfg)
    st = q.init_state(seed=3)
    for i, x in enumerate(xs):
        st, y = q.step(qpar if i < 4 else new, st, x)
        assert np.array_equal(got[i], y.numpy()), i
    assert torch.equal(srv.state.agc_gain, st.agc_gain) and srv.state.step == 7
    with pytest.raises(ValueError, match="mega=True"):
        RingServer(tp, tpar, mega=True)
    with pytest.raises(ValueError, match="run_ring_mega"):
        tp.run_ring_mega(tpar, tp.init_state(), torch.zeros(2, 8, 256), None,
                         torch.zeros(2, 8, 256), 2)


def test_fft_c8_has_no_ring_form():
    tp, tpar = port({**C8, "conv_strategy": "fft"})
    assert not tp.supports_ring_step
    with pytest.raises(ValueError, match="ring-capable"):
        RingServer(tp, tpar)


# ---------------------------------------------------------------- engine


def test_engine_c8_matches_jax_with_dynamic_swap():
    """StreamEngine: 3 blocks, apply_config with a new AGC target (a
    dynamic swap: the α and scalars are re-derived, the state kept), 2
    more, against `afp_tpu`'s engine; no ladder rung fires."""
    kw = {**C8, "batch": 8}
    eng, jeng = StreamEngine(StreamConfig(**kw), device="cpu"), JEngine(JConfig(**kw))
    xs = blocks(5, seed=7)
    got, want = [], []
    for i, x in enumerate(xs):
        if i == 3:
            assert eng.apply_config(StreamConfig(**{**kw, "agc_target_level": 0.25}))
            assert jeng.apply_config(JConfig(**{**kw, "agc_target_level": 0.25}))
        got.append(eng.process_block(x))
        want.append(jeng.process_block(x))
    check("engine with a dynamic AGC swap", np.stack(got), np.stack(want))
    m = eng.metrics
    print(f"engine metrics: {m.snapshot()}")
    assert m.blocks_processed == 5
    assert m.underruns == m.fallback_replays == m.fallback_silence == 0
    assert float(eng.params.agc_target) == np.float32(0.25)


def test_engine_ladder_keeps_the_gain_carry():
    """A non-finite block replays the last good one and leaves the carried
    state (pair tail and gain) as the last good block left it."""
    eng = StreamEngine(StreamConfig(**C8), device="cpu")
    good = eng.process_block(blocks(1, seed=8)[0])
    before = eng.state
    bad = np.full((8, 256), np.nan, np.float32)
    assert np.array_equal(eng.process_block(bad), good)
    assert (eng.metrics.underruns, eng.metrics.fallback_replays) == (1, 1)
    assert eng.state is before and torch.all(before.agc_gain != 1.0)


# ---------------------------------------------------------------- the slice


@pytest.mark.parametrize("over,item", [
    # 'parallel' (item 6) is ported: `tests/test_torch_agc_parallel.py`
    (dict(waterfall_enabled=True), "item 10b"),
])
def test_agc_outside_the_slice_raises(over, item):
    """The AGC chain with the waterfall (refused before its item was
    ported) runs: the same audio and gain carry as without it, bit for
    bit, dither on, the ring's newest row ≡ the output's spectrum, and no
    ring form."""
    from afp_tpu_torch.ops.spectrum import spectrum_db

    on = Pipeline(StreamConfig(**{**C8, **over}), "cpu")
    off, params = port(C8)
    assert not on.supports_ring_step
    x = blocks(2)
    st_on, st_off = on.init_state(seed=5), off.init_state(seed=5)
    for b in x:
        st_on, y_on = on.step(params, st_on, b)
        st_off, y_off = off.step(params, st_off, b)
        assert torch.equal(y_on, y_off)
        assert torch.equal(st_on.agc_gain, st_off.agc_gain)
        assert torch.equal(st_on.wf[:, -1], spectrum_db(y_on))
    print(f"{item}: C8 with the waterfall ≡ without it over {len(x)} blocks")


def test_per_stream_agc_vectors_raise():
    """[B] AGC vectors run (K5/K6 read them per stream): a vector of the
    scalar values ≡ the scalar params, bit for bit; a vector of the wrong
    length raises."""
    tp, tpar = port(C8)
    x = blocks(1)[0]
    per_stream = tpar._replace(agc_target=torch.full((8,), float(tpar.agc_target)),
                               agc_a_rel=torch.full((8,), float(tpar.agc_a_rel)))
    st, y = tp.step(per_stream, tp.init_state(), x)
    st0, want = tp.step(tpar, tp.init_state(), x)
    assert torch.equal(y, want) and torch.equal(st.agc_gain, st0.agc_gain)
    with pytest.raises(ValueError, match=r"must be a scalar or a \[8\]"):
        tp.step(tpar._replace(agc_target=torch.full((3,), 0.1)), tp.init_state(), x)
