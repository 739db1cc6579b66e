"""``ingest='pair'`` in the port against `afp_tpu` on the CPU: K13 and its
megakernel form against the Pallas pair-ring kernels in interpret mode,
and the C5 chain with bf16 (hi, lo) pair ingest through Pipeline,
RingServer and StreamEngine.

Contracts: K13 on ``split_bf16(ring)`` ≡ K3 on ``ring``, K13 on a slot ≡
K7 on that slot's views, the megakernel ≡ the chained steps, bit for bit
inside the port; against `afp_tpu` (dither off) the conv holds ≤ −110 dB
and the pair tails are bit-exact.  Each test states its bound and prints
the measured value."""
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

CONV_DB = -110.0  # the bf16×3 accumulation-order class

#: the C5 chain at small size, pair in (`bench.py:434-470`)
C5 = dict(samplerate=44100, blocksize=256, upsample_factor=4, numtaps=63,
          batch=4, cutoff=9000.0, eq_enabled=False, downsample_mode="decimate",
          output_clip=None, resample_quality="fast", conv_strategy="td_mxu",
          dither_kind="off", ingest="pair")
#: one k_pad (384) wider than the block (256)
WIDE = dict(C5, upsample_factor=1, numtaps=385)
EPI = dict(out_clip=0.3, dither_key=(9, 4), dither_bits=16, dither_tpdf=True)


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def check(name, got, want, bound):
    e = err_db(got, want)
    print(f"{name}: {e:.1f} dB (bound {bound})")
    assert np.asarray(got).shape == np.asarray(want).shape and e <= bound


def noise(shape, seed=0, scale=0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_jax(t: torch.Tensor):
    """A bf16 torch tensor as a JAX bf16 array (exact: every value is bf16)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def same_bits(t: torch.Tensor, j) -> bool:
    return np.array_equal(bits(t.float().numpy()), bits(j.astype(jnp.float32)))


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


# ---------------------------------------------------------------- K13


def _case(n, T, S, seed):
    B = 8
    h = (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)
    ring = torch.from_numpy(noise((S, B, T), seed=seed + 1))
    tail = torch.from_numpy(noise((B, F.ring_k_pad(n)), seed=seed + 2))
    return torch.from_numpy(h), ring, tail, F.split_bf16(ring), F.split_bf16(tail)


@pytest.mark.parametrize("n,T,S,idx", [(129, 256, 3, 1), (300, 128, 2, 0)])
def test_k13_plain_vs_pallas(n, T, S, idx):
    """The plain K13 against `fir_td_mxu_ring` (interpret, ``emit_tail``),
    k_pad > T included: the slot ≤ −110 dB, the pair tail bit-exact, other
    slots untouched; inside the port K13 ≡ K3 on the f32 ring and ≡ K7 on
    the slot's views, with clip and dither on, bit for bit."""
    h, ring, tail, (rh, rl), (th, tl) = _case(n, T, S, n)
    out0 = torch.full(ring.shape, 7.0)
    j_out, jth, jtl = jfir.fir_td_mxu_ring(
        to_jax(rh), to_jax(rl), idx, to_jax(th), to_jax(tl),
        jfir.band_matrix(h.numpy()), jnp.asarray(out0.numpy()), interpret=True,
        emit_tail=True)
    out, nh, nl = F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, out0.clone())
    check(f"K13 n={n} T={T} k_pad={F.ring_k_pad(n)}", out[idx].numpy(),
          np.asarray(j_out)[idx], CONV_DB)
    assert same_bits(nh, jth) and same_bits(nl, jtl)
    assert torch.all(out[[s for s in range(S) if s != idx]] == 7.0)
    a, ah, al = F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, out0.clone(), **EPI)
    b, bt = F.fir_td_mxu_ring_f32(ring, idx, tail, h, out0.clone(), **EPI)
    c, ch, cl = F.fir_td_mxu_pair_to_ring(rh[idx], rl[idx], th, tl, h, idx,
                                          out0.clone(), **EPI)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(ah, ch) and torch.equal(al, cl)
    assert all(torch.equal(u, v) for u, v in zip((ah, al), F.split_bf16(bt)))


@pytest.mark.parametrize("n,T,S,start,n_steps", [(129, 256, 4, 3, 3),
                                                  (300, 128, 3, 1, 5)])
def test_k13_mega_plain_vs_pallas(n, T, S, start, n_steps):
    """The plain K13 megakernel against `fir_td_mxu_ring_mega` (interpret),
    n_steps > S with k_pad > T included: ≤ −110 dB over the ring, the pair
    tail bit-exact; inside the port ≡ the chained K13 steps and ≡ K4 on the
    f32 ring, clip and dither on, bit for bit."""
    h, ring, tail, (rh, rl), (th, tl) = _case(n, T, S, n + 5)
    out0 = torch.zeros(ring.shape)
    j_out, jth, jtl = jfir.fir_td_mxu_ring_mega(
        to_jax(rh), to_jax(rl), start, to_jax(th), to_jax(tl),
        jfir.band_matrix(h.numpy()), jnp.asarray(out0.numpy()), n_steps,
        interpret=True)
    out, nh, nl = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h, out0.clone(),
                                         n_steps)
    check(f"K13 mega n={n} T={T} S={S} steps={n_steps}", out.numpy(),
          np.asarray(j_out), CONV_DB)
    assert same_bits(nh, jth) and same_bits(nl, jtl)
    mega, mh, ml = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h,
                                          out0.clone(), n_steps, **EPI)
    ck, ch, cl = out0.clone(), th, tl
    for i in range(n_steps):
        ck, ch, cl = F.fir_td_mxu_ring(rh, rl, (start + i) % S, ch, cl, h, ck,
                                       **{**EPI, "dither_key": (9, 4 + i)})
    assert torch.equal(mega, ck) and torch.equal(mh, ch) and torch.equal(ml, cl)
    f, _ = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, out0.clone(),
                                      n_steps, **EPI)
    assert torch.equal(mega, f)


def test_k13_checks():
    h = torch.zeros(31)
    hi = torch.zeros(2, 4, 256, dtype=torch.bfloat16)
    th = torch.zeros(4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        F.fir_td_mxu_ring(hi.float(), hi, 0, th, th, h, torch.zeros(2, 4, 256))
    with pytest.raises(ValueError, match="two"):
        F.fir_td_mxu_ring(hi, hi[:1], 0, th, th, h, torch.zeros(2, 4, 256))
    with pytest.raises(ValueError, match="tail pair"):
        F.fir_td_mxu_ring_mega(hi, hi, 0, th[:, :10], th[:, :10], h,
                               torch.zeros(2, 4, 256), 2)
    with pytest.raises(ValueError, match="n_steps"):
        F.fir_td_mxu_ring_mega(hi, hi, 0, th, th, h, torch.zeros(2, 4, 256), 0)


@pytest.mark.parametrize("taps", ["2-D", "float64"])
@pytest.mark.parametrize("form", ["K8", "K7", "K13", "K13 mega"])
def test_pair_forms_refuse_taps_that_are_not_1d_f32(form, taps):
    """K8, K7 and K13 take one 1-D float32 taps vector on the block's
    device; band kernels [K, n] are K11's, and its pair forms check them."""
    h = torch.zeros(2, 31) if taps == "2-D" else torch.zeros(31, dtype=torch.float64)
    xh = torch.zeros(4, 256, dtype=torch.bfloat16)
    ring = torch.zeros(2, 4, 256, dtype=torch.bfloat16)
    th = torch.zeros(4, 128, dtype=torch.bfloat16)
    out = torch.zeros(2, 4, 256)
    call = {"K8": lambda: F.fir_td_mxu_pair(xh, xh, th, th, h),
            "K7": lambda: F.fir_td_mxu_pair_to_ring(xh, xh, th, th, h, 0, out),
            "K13": lambda: F.fir_td_mxu_ring(ring, ring, 0, th, th, h, out),
            "K13 mega": lambda: F.fir_td_mxu_ring_mega(ring, ring, 0, th, th,
                                                       h, out, 2)}[form]
    with pytest.raises(ValueError, match="taps must be 1-D float32"):
        call()


# ---------------------------------------------------------------- the chain


@pytest.mark.parametrize("kw", [C5, WIDE], ids=["c5", "k_pad>T"])
def test_c5_pair_matches_jax_and_f32(kw):
    """Four f32 blocks, split at entry: against `afp_tpu`'s pair pipeline
    ≤ −110 dB with the pair tail bit-exact; ≡ the port's f32 pipeline and ≡
    the same blocks handed in as (hi, lo) pairs, bit for bit; and a pair
    tail carried from `afp_tpu` after two blocks continues its run."""
    sig = noise((4, 4 * 256), seed=1)
    jp = JPipeline(JConfig(**kw))
    jpar = jp.device_params(JParams.design(jp.cfg))
    jst, want = jp.process_signal(jpar, jp.init_state(), jnp.asarray(sig),
                                  fold=False)
    tp, tpar = port(kw)
    st, got = tp.process_signal(tpar, tp.init_state(), sig)
    check(f"C5 pair k_pad={tp._k_pad}", got.numpy(), np.asarray(want), CONV_DB)
    assert all(same_bits(t, j) for t, j in zip(st.conv_tail, jst.conv_tail))
    fp, fpar = port({**kw, "ingest": "f32"})
    assert torch.equal(fp.process_signal(fpar, fp.init_state(), sig)[1], got)
    blocks = torch.from_numpy(sig).reshape(4, 4, 256).transpose(0, 1)
    hi, lo = F.split_bf16(blocks)
    _, pairs = tp.run(tpar, tp.init_state(), (hi, lo))
    assert torch.equal(pairs.transpose(0, 1).reshape(4, -1), got)
    jst2, _ = jp.process_signal(jpar, jp.init_state(), jnp.asarray(sig[:, :512]),
                                fold=False)
    carried = tp.state_from_numpy(tuple(np.asarray(t) for t in jst2.conv_tail),
                                  seed=0, step=2)
    assert torch.equal(tp.process_signal(tpar, carried, sig[:, 512:])[1],
                       got[:, 512:])


@pytest.mark.parametrize("kw", [C5, WIDE], ids=["c5", "k_pad>T"])
def test_c5_pair_serving_equals_staged(kw):
    """Dither and clip on: run_ring (K13) ≡ run_ring_mega ≡ the staged
    steps, with a slot wrap and n_steps > S; RingServer (per-step and mega)
    fed (hi, lo) pairs or f32 blocks yields the same blocks."""
    kw = {**kw, "dither_kind": "tpdf", "output_clip": 0.5}
    tp, tpar = port(kw)
    S, start, n = 3, 2, 5
    ring = torch.from_numpy(noise((S, 4, 256), seed=2))
    rh, rl = F.split_bf16(ring)
    st, want = staged(tp, tpar, [ring[(start + i) % S] for i in range(n)], seed=4)
    last = {(start + i) % S: i for i in range(n)}
    for run in (tp.run_ring, tp.run_ring_mega):
        rst, out = run(tpar, tp.init_state(seed=4), rh, rl,
                       torch.full((S, 4, 256), 5.0), n, start=start)
        assert all(torch.equal(out[s], want[i]) for s, i in last.items())
        assert all(torch.equal(a, b) for a, b in zip(rst.conv_tail, st.conv_tail))
    xs = list(noise((5, 4, 256), seed=3))
    _, want = staged(tp, tpar, xs, seed=1)
    pairs = [F.split_bf16(torch.from_numpy(x)) for x in xs]
    for mega in (False, True):
        for src in (xs, pairs):
            srv = RingServer(tp, tpar, slots=4, chunk=2, max_inflight=1, seed=1,
                             mega=mega)
            got = np.stack(list(srv.stream(iter(src))))
            assert np.array_equal(got, want.numpy())


def test_c5_pair_ring_matches_jax_run_ring():
    """The port's pair run_ring against `afp_tpu`'s (interpret, dither off):
    ≤ −110 dB over the ring, the pair tail bit-exact."""
    ring = torch.from_numpy(noise((4, 4, 256), seed=5))
    rh, rl = F.split_bf16(ring)
    jp = JPipeline(JConfig(**C5))
    jpar = jp.device_params(JParams.design(jp.cfg))
    jst, jout = jp.run_ring(jpar, jp.init_state(), to_jax(rh), to_jax(rl),
                            jnp.zeros((4, 4, 256), jnp.float32), 4, start=1)
    tp, tpar = port(C5)
    st, out = tp.run_ring(tpar, tp.init_state(), rh, rl, torch.zeros(4, 4, 256),
                          4, start=1)
    check("C5 pair run_ring vs afp_tpu", out.numpy(), np.asarray(jout), CONV_DB)
    assert all(same_bits(t, j) for t, j in zip(st.conv_tail, jst.conv_tail))


def test_pair_form_checks_and_engine():
    """A pair pipeline takes pair rings only, and bf16 halves only; pair
    ingest refuses AGC (validate); StreamEngine takes f32 blocks and splits
    them at entry, equal to Pipeline.step."""
    tp, tpar = port(C5)
    ring = torch.zeros(2, 4, 256)
    with pytest.raises(ValueError, match="ring form mismatch"):
        tp.run_ring(tpar, tp.init_state(), ring, None, ring.clone(), 2)
    with pytest.raises(ValueError, match="bfloat16"):
        tp.step(tpar, tp.init_state(), (np.zeros((4, 256), np.float32),) * 2)
    with pytest.raises(ValueError, match="agc"):
        StreamConfig(**{**C5, "agc_enabled": True}).validate()
    eng = StreamEngine(StreamConfig(**{**C5, "dither_kind": "tpdf"}), device="cpu",
                       seed=2)
    q, qpar = port({**C5, "dither_kind": "tpdf"})
    st = q.init_state(seed=2)
    for x in noise((2, 4, 256), seed=6):
        st, y = q.step(qpar, st, x)
        assert np.array_equal(eng.process_block(x), y.numpy())
    assert eng.metrics.blocks_processed == 2 and eng.metrics.underruns == 0
