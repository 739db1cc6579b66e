"""``ingest='pcm16'`` in the port against `afp_tpu` on the CPU: the int16
convert and split, K12 and its megakernel form, K5/K6 on int16 x, the C5
and C8 chains through Pipeline, RingServer and StreamEngine.

Contract (ROADMAP.md "pcm16 ≡ f32 fed n/32768"): every convert is exact,
so inside the port a pcm16 path equals the f32 path on ``n/32768`` bit for
bit; against `afp_tpu` the conv holds ≤ −110 dB and the C8 chain ≤ −100 dB,
with dither off (`afp_tpu`'s noise is not the port's Philox), and the int16
tails are bit-exact.  `afp_tpu`'s Pallas kernels run in interpret mode; its
C8 pipeline takes its default CPU route, which converts at entry (exact).
Each test states its bound and prints the measured value."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.ops.pallas import agc_rms as jrms
from afp_tpu.ops.pallas import agc_scan as jscan
from afp_tpu.ops.pallas import fir_td as jfir
from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  StreamEngine)
from afp_tpu_torch.ops.agc import agc_alphas
from afp_tpu_torch.ops.cuda import (PCM16_SCALE, band_is_exact_bf16,
                                    band_matrix, fir_td_mxu_ring_f32,
                                    fir_td_mxu_ring_mega_f32,
                                    fir_td_mxu_ring_mega_pcm16,
                                    fir_td_mxu_ring_pcm16, pcm16_to_f32,
                                    ring_k_pad, rms_desired,
                                    smooth_gain_apply, split_bf16)
from afp_tpu_torch.runtime import RingServer

CONV_DB = -110.0  # the bf16×3 accumulation-order class
CHAIN_DB = -100.0  # the C8 chain: K5's order and the recurrence's branch points
EXACT_DB = -130.0  # the same f32 ops in the same order

#: the C5 chain at small size, pcm16 in (`bench.py:535-562`)
C5 = dict(samplerate=44100, blocksize=256, upsample_factor=4, numtaps=63,
          batch=4, cutoff=9000.0, eq_enabled=False, downsample_mode="decimate",
          output_clip=None, resample_quality="fast", conv_strategy="td_mxu",
          dither_kind="off", ingest="pcm16")
#: one k_pad (384) wider than the block (256)
WIDE = dict(C5, upsample_factor=1, numtaps=385)
#: the C8 AGC chain at small size, pcm16 in (`bench.py:879-912`; the shapes of
#: `tests/test_torch_agc_pipeline.py`)
C8 = dict(samplerate=44100, blocksize=256, upsample_factor=2, numtaps=129,
          cutoff=14000.0, eq_enabled=True, agc_enabled=True, agc_mode="exact",
          agc_window_size=128, agc_carry=True, downsample_mode="decimate",
          dither_kind="off", output_clip=0.99, conv_strategy="td_mxu",
          batch=8, ingest="pcm16")


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def pcm(shape, seed=0, scale=6000.0) -> np.ndarray:
    """int16 PCM noise that reaches both ends of the range."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    x = np.clip(np.round(x), -32768, 32767).astype(np.int16)
    x.reshape(-1)[:2] = (-32768, 32767)
    return x


def agc_pcm(n, B=8, L=256, seed=0) -> np.ndarray:
    """[n, B, L] int16 noise whose level steps up, down and back, so the
    gain attacks, releases and clips; one row stays near silence."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, B, L)) * 0.05
    x[:, 0] *= 12.0
    x[:, 1] *= 1e-2
    x[1::2, 2:4] *= 8.0
    return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)


def f32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) * np.float32(PCM16_SCALE)


def check(name, got, want, bound):
    e = err_db(got, want)
    print(f"{name}: {e:.1f} dB (bound {bound})")
    assert np.asarray(got).shape == np.asarray(want).shape and e <= bound


def port(kw):
    p = Pipeline(StreamConfig(**kw), "cpu")
    return p, p.device_params(PipelineParams.design(p.cfg))


def jax_pipe(kw):
    p = JPipeline(JConfig(**kw))
    return p, p.device_params(JParams.design(p.cfg))


def staged(p, params, xs, seed=0):
    st = p.init_state(seed=seed)
    outs = []
    for x in xs:
        st, y = p.step(params, st, x)
        outs.append(y)
    return st, torch.stack(outs)


# ---------------------------------------------------------------- convert


def test_convert_and_split_exact_over_int16_range():
    """Every int16 n: ``n/32768`` bit-exact to `afp_tpu`'s convert, and its
    bf16 split exact (hi + lo == x) and bit-exact to `afp_tpu`'s."""
    n = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16).reshape(64, 1024)
    x = pcm16_to_f32(torch.from_numpy(n))
    want = np.asarray(jnp.asarray(n).astype(jnp.float32) * jfir.PCM16_SCALE)
    assert np.array_equal(bits(x.numpy()), bits(want))
    hi, lo = split_bf16(x)
    assert torch.equal(hi.double() + lo.double(), x.double())
    jh, jl = jfir.split_bf16(jnp.asarray(want))
    assert np.array_equal(bits(hi.float().numpy()), bits(jh.astype(jnp.float32)))
    assert np.array_equal(bits(lo.float().numpy()), bits(jl.astype(jnp.float32)))
    print("pcm16: 65536 values convert and split exactly, bit for bit")


# ---------------------------------------------------------------- K12


def _taps(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n,T,S,idx", [(129, 256, 3, 1), (300, 128, 2, 0)])
def test_k12_plain_vs_pallas(n, T, S, idx):
    """The plain K12 against `fir_td_mxu_ring_pcm16` (interpret), with a
    narrow tail padded to k_pad and k_pad > T (300 taps, T 128): the slot
    ≤ −110 dB, the int16 tail bit-exact, other slots untouched; and K12 ≡
    K3 on the f32 ring of n/32768, bit for bit."""
    B = 8
    h = _taps(n, n)
    ring, tail = pcm((S, B, T), seed=n), pcm((B, n - 1), seed=n + 1)
    out0 = np.full((S, B, T), 7.0, np.float32)
    j_out, j_tail = jfir.fir_td_mxu_ring_pcm16(
        jnp.asarray(ring), idx, jnp.asarray(tail), jfir.band_matrix(h),
        jnp.asarray(out0), interpret=True)
    t_out, t_tail = fir_td_mxu_ring_pcm16(
        torch.from_numpy(ring), idx, torch.from_numpy(tail), torch.from_numpy(h),
        torch.from_numpy(out0.copy()))
    check(f"K12 n={n} T={T} k_pad={ring_k_pad(n)}", t_out[idx].numpy(),
          np.asarray(j_out)[idx], CONV_DB)
    assert t_tail.dtype == torch.int16
    assert np.array_equal(t_tail.numpy(), np.asarray(j_tail))
    assert np.all(t_out.numpy()[[s for s in range(S) if s != idx]] == 7.0)
    f_out, f_tail = fir_td_mxu_ring_f32(
        torch.from_numpy(f32(ring)), idx, torch.from_numpy(f32(tail)),
        torch.from_numpy(h), torch.from_numpy(out0.copy()))
    assert torch.equal(f_out, t_out) and torch.equal(f_tail, pcm16_to_f32(t_tail))


@pytest.mark.parametrize("n,T,S,start,n_steps", [(129, 256, 4, 3, 3),
                                                  (300, 128, 3, 1, 5)])
def test_k12_mega_plain_vs_pallas(n, T, S, start, n_steps):
    """The plain K12 megakernel against `fir_td_mxu_ring_mega_pcm16`
    (interpret), n_steps > S with k_pad > T included: ≤ −110 dB over the
    ring, the int16 tail bit-exact; and ≡ K4 on n/32768 with clip and
    dither on, bit for bit."""
    B = 8
    h = _taps(n, n + 2)
    ring, tail = pcm((S, B, T), seed=n + 3), pcm((B, ring_k_pad(n)), seed=n + 4)
    out0 = np.zeros((S, B, T), np.float32)
    j_out, j_tail = jfir.fir_td_mxu_ring_mega_pcm16(
        jnp.asarray(ring), start, jnp.asarray(tail), jfir.band_matrix(h),
        jnp.asarray(out0), n_steps, interpret=True)
    t_out, t_tail = fir_td_mxu_ring_mega_pcm16(
        torch.from_numpy(ring), start, torch.from_numpy(tail),
        torch.from_numpy(h), torch.from_numpy(out0.copy()), n_steps)
    check(f"K12 mega n={n} T={T} S={S} steps={n_steps}", t_out.numpy(),
          np.asarray(j_out), CONV_DB)
    assert np.array_equal(t_tail.numpy(), np.asarray(j_tail))
    kw = dict(out_clip=0.2, dither_key=(3, 40), dither_bits=16, dither_tpdf=True)
    a, at = fir_td_mxu_ring_mega_pcm16(
        torch.from_numpy(ring), start, torch.from_numpy(tail), torch.from_numpy(h),
        torch.zeros(S, B, T), n_steps, **kw)
    b, bt = fir_td_mxu_ring_mega_f32(
        torch.from_numpy(f32(ring)), start, torch.from_numpy(f32(tail)),
        torch.from_numpy(h), torch.zeros(S, B, T), n_steps, **kw)
    assert torch.equal(a, b) and torch.equal(pcm16_to_f32(at), bt)


def test_k12_checks():
    ring, h = torch.zeros(2, 4, 256, dtype=torch.int16), torch.zeros(31)
    with pytest.raises(ValueError, match="int16"):
        fir_td_mxu_ring_pcm16(ring.float(), 0, torch.zeros(4, 128, dtype=torch.int16),
                              h, torch.zeros(2, 4, 256))
    with pytest.raises(ValueError, match="tail must be int16"):
        fir_td_mxu_ring_pcm16(ring, 0, torch.zeros(4, 128), h, torch.zeros(2, 4, 256))
    with pytest.raises(ValueError, match="8-byte aligned"):
        fir_td_mxu_ring_mega_pcm16(
            ring, 0, torch.zeros(4, 128, dtype=torch.int16), h,
            torch.zeros(2 * 4 * 256 + 1, dtype=torch.int16)[1:].view(2, 4, 256), 2)


# ---------------------------------------------------------------- K5 / K6


def test_k5_k6_int16_vs_pallas():
    """K5 and K6 on an int16 block or ring slot against the Pallas kernels
    fed the same int16 (interpret): K5 ≤ −110 dB, K6's y and carry
    ≤ −130 dB; inside the port both ≡ their f32 form on n/32768, bit for
    bit (K6 at its smallest Pallas tile, B = 1024)."""
    B, T, S, idx, w = 1024, 256, 2, 1, 128
    ring = agc_pcm(S, B=B, L=T, seed=3)
    band = band_matrix(np.full(w, 1.0 / w, np.float32))
    exact = band_is_exact_bf16(band)
    lp, rp = w // 2, w - 1 - w // 2
    d = rms_desired(torch.from_numpy(ring), band, lp, rp, 0.1, 10.0, exact,
                    transposed=True, ring_idx=idx)
    jd = jrms.rms_desired_pallas(jnp.asarray(ring), jnp.asarray(band.numpy()),
                                 lp, rp, 0.1, 10.0, exact, interpret=True,
                                 transposed=True, ring_idx=idx)
    check("K5 int16 ring slot", d.numpy(), np.asarray(jd), CONV_DB)
    assert torch.equal(d, rms_desired(torch.from_numpy(f32(ring)), band, lp, rp,
                                      0.1, 10.0, exact, transposed=True,
                                      ring_idx=idx))
    a_att, a_rel = agc_alphas(w)
    init = np.random.default_rng(4).uniform(0.2, 6.0, B).astype(np.float32)
    y, carry = smooth_gain_apply(d, torch.from_numpy(ring[idx]), a_att, a_rel,
                                 10.0, init=torch.from_numpy(init))
    jy, jc = jscan.smooth_gain_apply_pallas(
        jnp.asarray(d.numpy()), jnp.asarray(ring[idx]), a_att, a_rel, 10.0,
        init=jnp.asarray(init), out_clip=0.99, interpret=True)
    check("K6 int16 y", y.numpy(), np.asarray(jy), EXACT_DB)
    check("K6 int16 carry", carry.numpy(), np.asarray(jc), EXACT_DB)
    for kw in (dict(), dict(emit_split=True, blockwise=32)):
        (y16, c16), (yf, cf) = (
            smooth_gain_apply(d, torch.from_numpy(r), a_att, a_rel, 10.0,
                              init=torch.from_numpy(init), ring_idx=idx, **kw)
            for r in (ring, f32(ring)))
        assert torch.equal(c16, cf)
        assert all(torch.equal(u, v) for u, v in
                   zip(torch.atleast_1d(y16) if not isinstance(y16, tuple) else y16,
                       torch.atleast_1d(yf) if not isinstance(yf, tuple) else yf))


# ---------------------------------------------------------------- C5 pcm16


@pytest.mark.parametrize("kw", [C5, WIDE], ids=["c5", "k_pad>T"])
def test_c5_pcm16_matches_jax_and_f32(kw):
    """Four blocks through `process_signal`: against `afp_tpu`'s pcm16
    pipeline ≤ −110 dB; ≡ the port's f32 pipeline on n/32768 bit for bit;
    the int16 tail is the raw input history, bit-exact to `afp_tpu`'s; and
    a state carried from `afp_tpu` after two blocks continues its run."""
    sig = pcm((4, 4 * 256), seed=5)
    jp, jpar = jax_pipe(kw)
    jst, want = jp.process_signal(jpar, jp.init_state(), jnp.asarray(sig), fold=False)
    tp, tpar = port(kw)
    st, got = tp.process_signal(tpar, tp.init_state(), sig)
    check(f"C5 pcm16 k_pad={tp._k_pad}", got.numpy(), np.asarray(want), CONV_DB)
    assert st.conv_tail.dtype == torch.int16
    assert np.array_equal(st.conv_tail.numpy(), np.asarray(jst.conv_tail))
    fp, fpar = port({**kw, "ingest": "f32"})
    assert torch.equal(fp.process_signal(fpar, fp.init_state(), f32(sig))[1], got)
    jst2, first = jp.process_signal(jpar, jp.init_state(), jnp.asarray(sig[:, :512]),
                                    fold=False)
    carried = tp.state_from_numpy(np.asarray(jst2.conv_tail), seed=0, step=2)
    _, rest = tp.process_signal(tpar, carried, sig[:, 512:])
    assert torch.equal(rest, got[:, 512:])


@pytest.mark.parametrize("kw", [C5, WIDE], ids=["c5", "k_pad>T"])
def test_c5_pcm16_ring_and_mega_equal_staged(kw):
    """run_ring (K12 per step) and run_ring_mega (one K12 dispatch) ≡ the
    staged steps, bit for bit, dither and clip on, with a wrap of the slot
    index and n_steps > S; the carried int16 tails agree."""
    tp, tpar = port({**kw, "dither_kind": "tpdf", "output_clip": 0.5})
    S, start, n = 3, 2, 5
    ring = torch.from_numpy(pcm((S, 4, 256), seed=6))
    st, want = staged(tp, tpar, [ring[(start + i) % S] for i in range(n)], seed=4)
    for run in (tp.run_ring, tp.run_ring_mega):
        rst, out = run(tpar, tp.init_state(seed=4), ring, None,
                       torch.full((S, 4, 256), 5.0), n, start=start)
        last = {(start + i) % S: i for i in range(n)}
        assert all(torch.equal(out[s], want[i]) for s, i in last.items())
        assert torch.equal(rst.conv_tail, st.conv_tail) and rst.step == n


def test_c5_pcm16_ring_matches_jax_run_ring():
    """The port's run_ring against `afp_tpu`'s pcm16 ring (interpret, dither
    off): ≤ −110 dB over the ring, the int16 tail bit-exact."""
    ring = pcm((4, 4, 256), seed=7)
    jp, jpar = jax_pipe(C5)
    jst, jout = jp.run_ring(jpar, jp.init_state(), jnp.asarray(ring), None,
                            jnp.zeros((4, 4, 256), jnp.float32), 4, start=1)
    tp, tpar = port(C5)
    st, out = tp.run_ring(tpar, tp.init_state(), torch.from_numpy(ring), None,
                          torch.zeros(4, 4, 256), 4, start=1)
    check("C5 pcm16 run_ring vs afp_tpu", out.numpy(), np.asarray(jout), CONV_DB)
    assert np.array_equal(st.conv_tail.numpy(), np.asarray(jst.conv_tail))


def test_pcm16_refuses_floats():
    """Floats never reach a pcm16 pipeline (they would be silently
    quantized): step, run, process_signal, the rings, RingServer and
    StreamEngine raise ValueError; an f32 pipeline refuses an int16 ring;
    an int16 conv tail belongs to pcm16 ingest alone."""
    tp, tpar = port(C5)
    fl = np.zeros((4, 256), np.float32)
    for call in (lambda: tp.step(tpar, tp.init_state(), fl),
                 lambda: tp.run(tpar, tp.init_state(), fl[None]),
                 lambda: tp.process_signal(tpar, tp.init_state(), np.zeros((4, 512)))):
        with pytest.raises(ValueError, match="int16"):
            call()
    with pytest.raises(ValueError, match="int16"):
        tp.run_ring(tpar, tp.init_state(), torch.zeros(2, 4, 256), None,
                    torch.zeros(2, 4, 256), 2)
    with pytest.raises(ValueError, match="int16"):
        list(RingServer(tp, tpar, slots=4, chunk=2, max_inflight=1).stream(iter([fl])))
    eng = StreamEngine(StreamConfig(**C5), device="cpu")
    with pytest.raises(ValueError, match="int16"):
        eng.process_block(fl)
    assert eng.metrics.underruns == 0  # refused before the ladder
    fp, fpar = port({**C5, "ingest": "f32"})
    with pytest.raises(ValueError, match="float32"):
        fp.run_ring(fpar, fp.init_state(), torch.zeros(2, 4, 256, dtype=torch.int16),
                    None, torch.zeros(2, 4, 256), 2)
    with pytest.raises(ValueError, match="int16"):
        fp.state_from_numpy(np.zeros((4, 128), np.int16), seed=0, step=0)
    with pytest.raises(ValueError, match="int16"):
        tp.state_from_numpy(np.zeros((4, 128), np.float32), seed=0, step=0)


def test_ring_server_and_engine_pcm16():
    """RingServer (per-step and mega) over int16 blocks ≡ the staged steps,
    dither on; its input ring is int16.  StreamEngine: int16 blocks ≡
    Pipeline.step; the pad/trim rung pads in int16."""
    kw = {**C5, "dither_kind": "tpdf"}
    tp, tpar = port(kw)
    xs = list(pcm((6, 4, 256), seed=8))
    _, want = staged(tp, tpar, xs, seed=3)
    for mega in (False, True):
        srv = RingServer(tp, tpar, slots=4, chunk=2, max_inflight=1, seed=3,
                         mega=mega)
        assert srv._ring.dtype == torch.int16
        got = np.stack(list(srv.stream(iter(xs))))
        assert np.array_equal(got, want.numpy()) and srv.state.step == 6
    eng = StreamEngine(StreamConfig(**kw), device="cpu", seed=3)
    st = tp.init_state(seed=3)
    for x in xs[:2]:
        st, y = tp.step(tpar, st, x)
        assert np.array_equal(eng.process_block(x), y.numpy())
    short = xs[2][:3, :200]
    padded = np.zeros((4, 256), np.int16)
    padded[:3, :200] = short
    _, y = tp.step(tpar, st, padded)
    assert np.array_equal(eng.process_block(short), y.numpy())
    m = eng.metrics
    assert m.blocks_processed == 3 and m.underruns == m.fallback_silence == 0


# ---------------------------------------------------------------- C8 pcm16


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_c8_pcm16_matches_jax_and_f32(mode):
    """C8 with int16 in, three blocks: against `afp_tpu`'s CPU route (it
    converts at entry, exact) ≤ −100 dB, the gain carry too; ≡ the port's
    f32 C8 on n/32768 bit for bit (K5/K6 read the int16 block); the ring
    (K5/K6 read the int16 slot, K7) ≡ the staged steps; and a state carried
    from `afp_tpu` (its pair tail and gain) after one block."""
    kw = {**C8, "agc_mode": mode}
    xs = agc_pcm(3, seed=1)
    jp, jpar = jax_pipe(kw)
    jst, want, jstates = jp.init_state(), [], []
    for x in xs:
        jst, y = jp.step(jpar, jst, jnp.asarray(x))
        want.append(np.asarray(y))
        jstates.append(jst)
    tp, tpar = port(kw)
    st, got = staged(tp, tpar, xs)
    check(f"C8 {mode} pcm16 y", got.numpy(), np.stack(want), CHAIN_DB)
    check(f"C8 {mode} pcm16 gain", st.agc_gain.numpy(),
          np.asarray(jstates[-1].agc_gain), CHAIN_DB)
    fp, fpar = port({**kw, "ingest": "f32"})
    fst, fgot = staged(fp, fpar, f32(xs))
    assert torch.equal(fgot, got) and torch.equal(fst.agc_gain, st.agc_gain)
    rst, rout = tp.run_ring(tpar, tp.init_state(), torch.from_numpy(xs), None,
                            torch.zeros(3, 8, 256), 3)
    assert torch.equal(rout, got) and torch.equal(rst.agc_gain, st.agc_gain)
    params = tp.params_from_numpy({k: None if v is None else np.asarray(v)
                                   for k, v in jpar._asdict().items()})
    tail = tuple(np.asarray(t) for t in jstates[0].conv_tail)
    carried = tp.state_from_numpy(tail, seed=0, step=1,
                                  agc_gain=np.asarray(jstates[0].agc_gain))
    outs = []
    for x in xs[1:]:
        carried, y = tp.step(params, carried, x)
        outs.append(y.numpy())
    check(f"C8 {mode} pcm16 carried from afp_tpu", np.stack(outs),
          np.stack(want[1:]), CHAIN_DB)


def test_c8_pcm16_server_and_engine():
    """The C8 pcm16 RingServer (per-step AGC ring over an int16 ring) ≡ the
    staged steps with dither on; mega has no AGC form; StreamEngine takes
    int16 blocks through apply_config (a dynamic AGC swap) with no ladder
    rung firing."""
    kw = {**C8, "dither_kind": "tpdf"}
    tp, tpar = port(kw)
    xs = list(agc_pcm(5, seed=2))
    st, want = staged(tp, tpar, xs, seed=1)
    srv = RingServer(tp, tpar, slots=4, chunk=2, max_inflight=1, seed=1)
    got = np.stack(list(srv.stream(iter(xs))))
    assert np.array_equal(got, want.numpy())
    assert torch.equal(srv.state.agc_gain, st.agc_gain)
    with pytest.raises(ValueError, match="mega=True"):
        RingServer(tp, tpar, mega=True)
    eng = StreamEngine(StreamConfig(**kw), device="cpu")
    for i, x in enumerate(xs):
        if i == 3:
            assert eng.apply_config(dataclasses.replace(eng.cfg, agc_target_level=0.2))
        assert eng.process_block(x).shape == (8, 256)
    m = eng.metrics
    assert m.blocks_processed == 5 and m.underruns == m.fallback_replays == 0
