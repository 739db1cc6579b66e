"""The port's per-stream banks (`afp_tpu_torch/engine/batch.py`, K10, K11,
the banked K3/K4/K12, the [B] AGC vectors of K5/K6, `RingServer(packing=)`)
on the CPU, against `afp_tpu` and against the port's own shared forms.

The reference's `tests/test_batch.py` at its sizes: batch 16, block 512,
33 taps, 'fast' resampling.  Dither is off wherever `afp_tpu` is compared
(its threefry noise is not the port's Philox); the port's own identities
hold with dither on.  `afp_tpu` runs its Pallas kernels in interpret mode
and its unforced AGC route.  Each test states its bound (max-abs error over
peak, in dB) and prints the measured value."""
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
from afp_tpu_torch.ops.cuda import (fir_td_mxu, fir_td_mxu_banked,
                                    fir_td_mxu_per_stream, fir_td_mxu_plain,
                                    fir_td_mxu_ring_f32,
                                    fir_td_mxu_ring_mega_f32,
                                    fir_td_mxu_ring_mega_pcm16,
                                    fir_td_mxu_ring_pcm16, quantize_pcm16,
                                    rms_desired, smooth_gain_apply)
from afp_tpu_torch.ops.cuda import agc_rms, fir_td
from afp_tpu_torch.ops.dither import dither_plain
from afp_tpu_torch.runtime import RingServer

TD_DB = -110.0  # the bf16×3 accumulation-order class
FFT_DB = -100.0  # two FFT libraries
CHAIN_DB = -100.0  # the C8 chain: AGC branch points and the bf16×3 conv
PAIR_DB = -90.0  # pair ingest under banks: the reference's ~2^-16 pair class

#: the reference's banked-filter test configuration (`tests/test_batch.py:205-215`)
TD = dict(samplerate=44100, blocksize=512, upsample_factor=2, numtaps=33,
          batch=16, eq_enabled=False, agc_enabled=False,
          downsample_mode="decimate", dither_kind="off", output_clip=None,
          conv_strategy="td_mxu", resample_quality="fast")
#: per-stream EQ gains: the same with the 9-band EQ, clip on
EQ = {**TD, "eq_enabled": True, "output_clip": 0.99}
#: the C8 shape at a small size (AGC window 128, 9-band EQ, clip)
C8 = dict(samplerate=44100, blocksize=256, upsample_factor=2, numtaps=129,
          cutoff=14000.0, eq_enabled=True, agc_enabled=True, agc_mode="exact",
          agc_window_size=128, agc_carry=True, downsample_mode="decimate",
          dither_kind="off", output_clip=0.99, conv_strategy="td_mxu",
          batch=8, resample_quality="fast")

HALVES = [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)]
INTERLEAVED = [dict(cutoff=4000.0 if i % 2 == 0 else 12000.0) for i in range(16)]


def err_db(a, b) -> float:
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def check(name, got, want, bound):
    e = err_db(got, want)
    print(f"{name}: {e:.1f} dB (bound {bound})")
    assert np.asarray(got).shape == np.asarray(want).shape and e <= bound


def blocks(n, B=16, L=512, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((n, B, L)) * scale
            ).astype(np.float32)


def pcm(x):
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def steps(p, params, xs, seed=0, state=None):
    st = p.init_state(seed=seed) if state is None else state
    outs = []
    for x in xs:
        st, y = p.step(params, st, x)
        outs.append(y.numpy())
    return st, np.stack(outs)


def jsteps(p, params, xs):
    st, outs = p.init_state(), []
    for x in xs:
        st, y = p.step(params, st, jnp.asarray(x))
        outs.append(np.asarray(y))
    return st, np.stack(outs)


def np_fields(params) -> dict:
    return {k: None if v is None else np.asarray(v)
            for k, v in params._asdict().items()}


# ---------------------------------------------------------------- host banks


@pytest.mark.parametrize("spec", [1.5, [1.0] * 9, "rows"])
def test_broadcast_gains_matches(spec):
    if spec == "rows":
        spec = np.random.default_rng(0).uniform(0, 2, (4, 9)).astype(np.float32)
    got = batch.broadcast_gains(spec, 4, 9)
    want = np.asarray(jbatch.broadcast_gains(spec, 4, 9))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec,match", [([1.0] * 5, "expected 9 gains"),
                                        (np.ones((3, 9)), r"expected gains \[4, 9\]"),
                                        (np.ones((1, 4, 9)), "gains must be")])
def test_broadcast_gains_guards(spec, match):
    for fn in (batch.broadcast_gains, jbatch.broadcast_gains):
        with pytest.raises(ValueError, match=match):
            fn(spec, 4, 9)


def test_per_stream_gains_require_eq():
    p = Pipeline(StreamConfig(**TD), "cpu")
    params = p.device_params(PipelineParams.design(p.cfg))
    with pytest.raises(ValueError, match="eq_enabled"):
        batch.with_per_stream_gains(p, params, 2.0)


@pytest.mark.parametrize("ingest,variants,pack", [
    ("f32", HALVES, False), ("f32", INTERLEAVED, True),
    ("pcm16", HALVES, False)])
def test_filter_bank_matches_jax(ingest, variants, pack):
    """The bank, the per-tile assignment and the packing equal `afp_tpu`'s
    exactly (the same float64 host design); the [B, F] response bank within
    two FFT libraries."""
    kw = {**TD, "ingest": ingest}
    jp, p = JPipeline(JConfig(**kw)), Pipeline(StreamConfig(**kw), "cpu")
    jout = jbatch.with_per_stream_filters(jp, variants, pack=pack)
    out = batch.with_per_stream_filters(p, variants, pack=pack)
    (jb, jpk), (tb, tpk) = (jout, out) if pack else ((jout, None), (out, None))
    assert np.array_equal(tb.casc_bank.numpy(), np.asarray(jb.casc_bank))
    assert tb.casc_assign.dtype == torch.int32
    assert np.array_equal(tb.casc_assign.numpy(), np.asarray(jb.casc_assign))
    check("H_main bank", tb.H_main.numpy(), np.asarray(jb.H_main), FFT_DB)
    if pack:
        assert np.array_equal(tpk.perm, jpk.perm) and np.array_equal(tpk.inv, jpk.inv)
        assert not tpk.identity


def test_filter_bank_fft_is_row_granular():
    """'fft' banks are [B, F] responses, row by row; packing is the
    identity."""
    kw = {**TD, "conv_strategy": "fft"}
    variants = [dict(cutoff=1000.0 + 500 * i) for i in range(16)]
    jb, jpk = jbatch.with_per_stream_filters(JPipeline(JConfig(**kw)), variants,
                                             pack=True)
    tb, tpk = batch.with_per_stream_filters(Pipeline(StreamConfig(**kw), "cpu"),
                                            variants, pack=True)
    assert tpk.identity and jpk.identity and tb.casc_bank is None
    check("fft H_main bank", tb.H_main.numpy(), np.asarray(jb.H_main), FFT_DB)


@pytest.mark.parametrize("case", ["count", "static", "eq", "bump", "rows",
                                  "ladder", "constant", "link"])
def test_filter_bank_guards(case):
    """Every refusal of `afp_tpu`'s `with_per_stream_filters`, with its
    message, raised by both packages."""
    kw, variants, extra = dict(TD), HALVES, {}
    err, match = ValueError, None
    if case == "count":
        variants, match = [dict(cutoff=5000.0)], "variants"
    elif case == "static":
        variants, match = [dict(numtaps=65)] * 16, "static"
    elif case == "eq":
        kw["eq_enabled"], err, match = True, NotImplementedError, "eq_enabled"
    elif case == "bump":
        kw["numtaps"] = 32
        variants = [dict(filter_type="highpass", cutoff=1000.0)] * 16
        match = "odd base numtaps"
    elif case == "rows":
        variants = [dict(cutoff=1000.0 + 500 * i) for i in range(16)]
        match = "constant within aligned"
    elif case == "ladder":
        extra, match = dict(bt=12), "ladder tile"
    elif case == "constant":
        extra, match = dict(bt=16), "not constant"
    else:
        kw.update(agc_enabled=True, agc_link_group=2, agc_window_size=128)
        variants = [dict(cutoff=4000.0 if i % 2 else 12000.0) for i in range(16)]
        extra, match = dict(pack=True), "agc_link_group"
    for P, C, mod in ((JPipeline, JConfig, jbatch), (Pipeline, StreamConfig, batch)):
        p = P(C(**kw)) if P is JPipeline else P(C(**kw), "cpu")
        with pytest.raises(err, match=match):
            mod.with_per_stream_filters(p, variants, **extra)


@pytest.mark.parametrize("link", [1, 2])
def test_design_sort_perm_matches(link):
    assign = np.array([1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0], dtype=np.int32)
    assert np.array_equal(batch._design_sort_perm(assign, link),
                          jbatch._design_sort_perm(assign, link))


def test_stream_packing_numpy_and_torch_any_axis():
    p = Pipeline(StreamConfig(**TD), "cpu")
    _, pk = batch.with_per_stream_filters(p, INTERLEAVED, pack=True)
    x = np.arange(3 * 16 * 4, dtype=np.float32).reshape(3, 16, 4)
    packed = pk.pack(x, axis=1)
    assert np.array_equal(packed, x[:, pk.perm])
    assert torch.equal(pk.pack(torch.from_numpy(x), axis=1), torch.from_numpy(packed))
    assert np.array_equal(pk.unpack(packed, axis=1), x)
    assert torch.equal(pk.unpack(torch.from_numpy(packed), axis=1), torch.from_numpy(x))


# ---------------------------------------------------------------- kernels


def _bank(D=3, n=33, seed=1):
    return (np.random.default_rng(seed).standard_normal((D, n)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("B,bt", [(16, 8), (6, 6)])
def test_k10_matches_pallas_and_k1(B, bt):
    """K10's plain version against `afp_tpu`'s banked Pallas kernel
    (interpret, clip fused) ≤ −110 dB; each row equals K1 on its design bit
    for bit."""
    T, n = 256, 33
    bank = _bank(n=n)
    assign_t = np.arange(B // bt, dtype=np.int32) % 3
    x = blocks(1, B=B, L=n - 1 + T, seed=2)[0]
    y = fir_td_mxu_banked(torch.from_numpy(x), torch.from_numpy(bank),
                          torch.from_numpy(assign_t), out_clip=0.2)
    want = jfir.fir_td_mxu_banked(jnp.asarray(x), jnp.asarray(jfir.band_stack(bank)),
                                  np.repeat(assign_t, bt), interpret=True, bt=bt,
                                  out_clip=0.2)
    check(f"K10 B={B} bt={bt}", y.numpy(), np.asarray(want), TD_DB)
    for b in range(B):
        row = fir_td_mxu(torch.from_numpy(x), torch.from_numpy(bank[assign_t[b // bt]]),
                         out_clip=0.2)[b]
        assert torch.equal(y[b], row)


def test_bank_checks():
    x, bank = torch.zeros(16, 32 + 256), torch.zeros(2, 33)
    with pytest.raises(ValueError, match="multiple of 8"):
        fir_td_mxu_banked(x, bank, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        fir_td_mxu_banked(x, bank, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="tap bank"):
        fir_td_mxu_banked(x, bank[0], torch.zeros(2, dtype=torch.int32))
    # an entry outside [0, D) reads no taps: its rows are NaN (int16: −32768)
    x = torch.from_numpy(blocks(1, B=16, L=32 + 256, seed=6)[0])
    bank = torch.from_numpy(_bank(D=2))
    for bad in (2, -1):
        assign = torch.tensor([1, bad], dtype=torch.int32)
        y = fir_td_mxu_banked(x, bank, assign)
        assert torch.isnan(y[8:]).all() and torch.equal(y[:8], fir_td_mxu(x, bank[1])[:8])
        y16 = fir_td_mxu_banked(x, bank, assign, emit_i16=True)
        assert (y16[8:] == -32768).all() and y16.dtype == torch.int16


@pytest.mark.parametrize("form", ["K3", "K4", "K12", "K12-mega"])
def test_banked_rings_match_pallas_and_shared(form):
    """The banked ring forms' plain versions against `afp_tpu`'s (interpret,
    dither off) ≤ −110 dB, and row by row ≡ the shared-taps ring on that
    row's design, bit for bit with dither on; the tails bit-exact."""
    B, T, n, S, bt = 16, 256, 33, 3, 8
    bank = _bank(n=n)
    assign_t = np.array([2, 0], dtype=np.int32)
    xs = blocks(S, B=B, L=T, seed=3)
    mega = "4" in form or "mega" in form
    i16 = "12" in form
    ring = torch.from_numpy(pcm(xs) if i16 else xs)
    kp = fir_td.ring_k_pad(n)
    tail = torch.from_numpy(pcm(blocks(1, B=B, L=kp, seed=4)[0]) if i16
                            else blocks(1, B=B, L=kp, seed=4)[0])
    fn = {"K3": fir_td_mxu_ring_f32, "K4": fir_td_mxu_ring_mega_f32,
          "K12": fir_td_mxu_ring_pcm16, "K12-mega": fir_td_mxu_ring_mega_pcm16}[form]
    jfn = {"K3": jfir.fir_td_mxu_ring_f32, "K4": jfir.fir_td_mxu_ring_mega_f32,
           "K12": jfir.fir_td_mxu_ring_pcm16,
           "K12-mega": jfir.fir_td_mxu_ring_mega_pcm16}[form]
    at, bk = torch.from_numpy(assign_t), torch.from_numpy(bank)
    args = (2, 4) if mega else (1,)  # (start, n_steps) or idx
    out, nt = (fn(ring, args[0], tail, bk, torch.zeros(S, B, T), args[1], assign=at)
               if mega else fn(ring, args[0], tail, bk, torch.zeros(S, B, T), assign=at))
    jargs = dict(interpret=True, assign=np.repeat(assign_t, bt), bt=bt)
    jring, jtail, jout = jnp.asarray(ring.numpy()), jnp.asarray(tail.numpy()), \
        jnp.zeros((S, B, T), jnp.float32)
    if mega:
        jo, jt = jfn(jring, 2, jtail, jnp.asarray(jfir.band_stack(bank)), jout, 4, **jargs)
    else:
        jo, jt = jfn(jring, 1, jtail, jnp.asarray(jfir.band_stack(bank)), jout, **jargs)
    check(f"banked {form}", out.numpy(), np.asarray(jo), TD_DB)
    assert np.array_equal(nt.numpy(), np.asarray(jt))
    dkw = dict(out_clip=0.3, dither_key=(5, 2), dither_bits=16, dither_tpdf=True)
    got = (fn(ring, 2, tail, bk, torch.zeros(S, B, T), 4, assign=at, **dkw) if mega
           else fn(ring, 1, tail, bk, torch.zeros(S, B, T), assign=at, **dkw))[0]
    for d in (0, 2):
        shared = (fn(ring, 2, tail, bk[d], torch.zeros(S, B, T), 4, **dkw) if mega
                  else fn(ring, 1, tail, bk[d], torch.zeros(S, B, T), **dkw))[0]
        rows = np.repeat(assign_t, bt) == d
        assert torch.equal(got[:, rows], shared[:, rows])


@pytest.mark.parametrize("B,K", [(8, 3), (12, 9)])
def test_k11_matches_pallas_and_oracle(B, K):
    """K11's plain version against `afp_tpu`'s Pallas kernel (interpret; B
    a multiple of its tile) ≤ −110 dB, and against the float64 per-band
    oracle (`tests/test_batch.py:75-94`) < −90 dB.  Batch 12 (which the TPU
    kernel refuses) writes every row."""
    rng = np.random.default_rng(5)
    N, T = 65, 256
    kernels = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    gains = rng.uniform(0.5, 2.0, size=(B, K)).astype(np.float32)
    x = (rng.standard_normal((B, T + N - 1)) * 0.5).astype(np.float32)
    y = fir_td_mxu_per_stream(torch.from_numpy(x), torch.from_numpy(kernels),
                              torch.from_numpy(gains)).numpy()
    gold = np.zeros((B, T))
    for b in range(B):
        for k in range(K):
            gold[b] += gains[b, k] * np.convolve(x[b].astype(np.float64),
                                                 kernels[k].astype(np.float64), "valid")
    check(f"K11 B={B} K={K} vs float64", y, gold, -90.0)
    if B % 8 == 0:
        want = jfir.fir_td_mxu_per_stream(jnp.asarray(x), jnp.asarray(kernels),
                                          jnp.asarray(gains), interpret=True,
                                          precision="B3")
        check(f"K11 B={B} K={K} vs Pallas", y, np.asarray(want), TD_DB)
    assert np.all(np.abs(y).max(axis=1) > 0)


def test_k11_fused_epilogue_equals_unfused():
    """K11 with clip, dither and the int16 store fused ≡ K11 → clip → K2
    → quantize_pcm16, bit for bit (the same Philox noise over the same
    flat index)."""
    rng = np.random.default_rng(6)
    B, N, T, K = 12, 33, 384, 4
    x = torch.from_numpy((rng.standard_normal((B, T + N - 1)) * 0.5).astype(np.float32))
    kernels = torch.from_numpy((rng.standard_normal((K, N)) * 0.2).astype(np.float32))
    gains = torch.from_numpy(rng.uniform(0, 2, (B, K)).astype(np.float32))
    y = fir_td_mxu_per_stream(x, kernels, gains)
    unfused = dither_plain(torch.clamp(y, -0.2, 0.2), (7, 3), 16, "tpdf")
    dkw = dict(out_clip=0.2, dither_key=(7, 3), dither_bits=16, dither_tpdf=True)
    assert torch.equal(fir_td_mxu_per_stream(x, kernels, gains, **dkw), unfused)
    assert torch.equal(fir_td_mxu_per_stream(x, kernels, gains, emit_i16=True, **dkw),
                       quantize_pcm16(unfused))


def test_agc_vectors_equal_rowwise_scalars():
    """K5 with [B] target/max-gain and K6 with [B] alphas/max-gain ('exact'
    and 'fast', with a carry) equal, on each row group, the scalar run with
    that group's values, bit for bit (either K5 vector promotes both)."""
    B, T, W = 8, 256, 128
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((B, T)) * 0.1).astype(np.float32))
    x[:2] *= 8.0
    band = fir_td.band_matrix(np.full(W, 1.0 / W, np.float32))
    pol = [(0.05, 4.0, 0.3, 0.02), (0.2, 20.0, 0.05, 0.004)]
    rows = [slice(0, 4), slice(4, 8)]
    vec = [torch.tensor(np.repeat([p[i] for p in pol], 4), dtype=torch.float32)
           for i in range(4)]
    init = torch.linspace(0.5, 3.0, B)
    for mc in (0, 32):
        dv = rms_desired(x, band, 64, 63, vec[0], 10.0, True, transposed=True,
                         mean_chunk=mc)
        for r, p in zip(rows, pol):
            ds = rms_desired(x, band, 64, 63, p[0], 10.0, True, transposed=True,
                             mean_chunk=mc)
            assert torch.equal(dv[:, r], ds[:, r])
        dv = rms_desired(x, band, 64, 63, 0.1, vec[1], True, transposed=True)
        for r, p in zip(rows, pol):
            assert torch.equal(dv[:, r], rms_desired(x, band, 64, 63, 0.1, p[1], True,
                                                     transposed=True)[:, r])
    d = rms_desired(x, band, 64, 63, 0.1, 10.0, True, transposed=True)
    for bw in (None, 32):
        yv, cv = smooth_gain_apply(d, x, vec[2], vec[3], vec[1], init=init,
                                   blockwise=bw)
        for r, p in zip(rows, pol):
            ys, cs = smooth_gain_apply(d, x, p[2], p[3], p[1], init=init, blockwise=bw)
            assert torch.equal(yv[r], ys[r]) and torch.equal(cv[r], cs[r])
    assert agc_rms.knobs(B, "cpu", a=0.5, b=vec[0])[1]["a"].shape == (B,)


# ---------------------------------------------------------------- pipelines


def test_default_device_is_the_card():
    """`Pipeline(cfg)` and `StreamEngine(cfg)` default to the card; without
    one they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(StreamConfig(**TD))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamEngine(StreamConfig(**TD))


@pytest.mark.parametrize("ingest", ["f32", "pcm16"])
def test_bank_pipeline_matches_jax(ingest):
    """The banked staged step (K10; banked K12 over the one-slot view under
    pcm16) against `afp_tpu`'s, 3 blocks, dither off ≤ −110 dB; and the
    same after carrying `afp_tpu`'s params into the port."""
    kw = {**TD, "ingest": ingest}
    xs = blocks(3, seed=8)
    xs = pcm(xs) if ingest == "pcm16" else xs
    jp = JPipeline(JConfig(**kw))
    jb = jbatch.with_per_stream_filters(jp, HALVES)
    _, want = jsteps(jp, jb, xs)
    p = Pipeline(StreamConfig(**kw), "cpu")
    _, got = steps(p, batch.with_per_stream_filters(p, HALVES), xs)
    check(f"banked {ingest} staged vs afp_tpu", got, want, TD_DB)
    _, carried = steps(p, p.params_from_numpy(np_fields(jb)), xs)
    assert np.array_equal(carried, got)


@pytest.mark.parametrize("ingest", ["f32", "pcm16"])
def test_bank_equals_per_design_pipelines(ingest):
    """A banked pipeline's rows ≡ the shared pipeline on their design's
    taps, bit for bit, dither and clip on (and within the conv class of the
    per-design pipelines, whose cascades come from another float64 path);
    ring and mega ≡ staged, bit for bit."""
    kw = {**TD, "ingest": ingest, "dither_kind": "tpdf", "output_clip": 0.5}
    xs = blocks(3, seed=9, scale=0.5)
    xs = pcm(xs) if ingest == "pcm16" else xs
    p = Pipeline(StreamConfig(**kw), "cpu")
    bank = batch.with_per_stream_filters(p, HALVES)
    st, got = steps(p, bank, xs, seed=4)
    shared = p.device_params(PipelineParams.design(p.cfg))
    for d, rows in ((0, slice(0, 8)), (1, slice(8, 16))):
        # the shared pipeline on the bank's design: bit for bit
        _, want = steps(p, shared._replace(casc_main=bank.casc_bank[d]), xs, seed=4)
        assert np.array_equal(got[:, rows], want[:, rows])
        # the design of that cutoff from the shared design path (np.convolve,
        # not the bank's batched FFT cascade): the conv class
        q = Pipeline(StreamConfig(**{**kw, "cutoff": (4000.0, 12000.0)[d]}), "cpu")
        _, qy = steps(q, q.device_params(PipelineParams.design(q.cfg)), xs, seed=4)
        check(f"bank row group {d} vs its own pipeline", got[:, rows], qy[:, rows],
              TD_DB)
    ring = torch.from_numpy(xs)
    for run in (p.run_ring, p.run_ring_mega):
        rst, out = run(bank, p.init_state(seed=4), ring, None,
                       torch.zeros(xs.shape), 3, start=0)
        assert np.array_equal(out.numpy(), got) and torch.equal(rst.conv_tail, st.conv_tail)


def test_bank_pcm16_equals_f32():
    """Banked pcm16 ≡ banked f32 fed n/32768, bit for bit (staged and the
    mega ring), dither on."""
    kw = {**TD, "dither_kind": "tpdf"}
    q = pcm(blocks(2, seed=10))
    outs = {}
    for ingest, xs in (("pcm16", q), ("f32", q.astype(np.float32) / np.float32(32768))):
        p = Pipeline(StreamConfig(**{**kw, "ingest": ingest}), "cpu")
        bank = batch.with_per_stream_filters(p, INTERLEAVED, pack=True)[0]
        _, outs[ingest] = steps(p, bank, xs, seed=1)
        _, m = p.run_ring_mega(bank, p.init_state(seed=1), torch.from_numpy(xs), None,
                               torch.zeros(xs.shape), 2)
        assert np.array_equal(m.numpy(), outs[ingest])
    assert np.array_equal(outs["pcm16"], outs["f32"])


def test_bank_fold_refusal_and_rings_refused():
    """With a bank, ``fold=True`` raises the reference's ValueError and
    'prefer' scans; the pair rings and the AGC ring refuse banks."""
    p = Pipeline(StreamConfig(**TD), "cpu")
    bank = batch.with_per_stream_filters(p, HALVES)
    sig = blocks(1, L=1024, seed=11)[0]
    with pytest.raises(ValueError, match="per-stream filter banks"):
        p.process_signal(bank, p.init_state(), sig, fold=True)
    _, y = p.process_signal(bank, p.init_state(seed=1), sig, fold="prefer")
    _, want = steps(p, bank, [sig[:, :512], sig[:, 512:]], seed=1)
    assert np.array_equal(y.numpy(), np.concatenate(list(want), axis=-1))
    for kw in (dict(ingest="pair"), dict(agc_enabled=True, agc_window_size=128)):
        q = Pipeline(StreamConfig(**{**TD, **kw}), "cpu")
        qb = batch.with_per_stream_filters(q, HALVES)
        ring = torch.zeros(2, 16, 512)
        lo = ring.bfloat16() if q._pair_ingest else None
        with pytest.raises(ValueError, match="per-stream filter banks ride"):
            q.ring_step(qb, q.init_state(), ring.bfloat16() if lo is not None else ring,
                        lo, 0, torch.zeros_like(ring))


@pytest.mark.parametrize("kw", [dict(ingest="pair"),
                                dict(agc_enabled=True, agc_window_size=128,
                                     output_clip=0.99)])
def test_bank_staged_pair_and_agc(kw):
    """Banks on the staged step under pair ingest (the f32 block rebuilt
    from the pair: the reference's pair class) and under AGC (K6 stores
    f32; the pair tail merged and re-split): against `afp_tpu`."""
    kw = {**TD, **kw}
    xs = blocks(3, seed=12, scale=0.1 if "agc_enabled" in kw else 0.3)
    jp = JPipeline(JConfig(**kw))
    _, want = jsteps(jp, jbatch.with_per_stream_filters(jp, HALVES), xs)
    p = Pipeline(StreamConfig(**kw), "cpu")
    st, got = steps(p, batch.with_per_stream_filters(p, HALVES), xs)
    bound = PAIR_DB if "ingest" in kw else CHAIN_DB
    check(f"banked staged {kw}", got, want, bound)
    assert isinstance(st.conv_tail, tuple)


@pytest.mark.parametrize("strategy,bound", [("td_mxu", TD_DB), ("fft", FFT_DB)])
def test_per_stream_gains_match_jax(strategy, bound):
    """[B, 9] gains drawn in [0, 2]: K11 ('td_mxu') or the [B, F] response
    ('fft') against `afp_tpu`, 3 blocks, dither off; 'td_mxu' vs 'fft'
    within the FFT bound."""
    kw = {**EQ, "conv_strategy": strategy}
    gains = np.random.default_rng(13).uniform(0, 2, (16, 9)).astype(np.float32)
    xs = blocks(3, seed=14)
    jp = JPipeline(JConfig(**kw))
    jparams = jbatch.with_per_stream_gains(
        jp, jp.device_params(JParams.design(jp.cfg)), gains)
    _, want = jsteps(jp, jparams, xs)
    p = Pipeline(StreamConfig(**kw), "cpu")
    params = batch.with_per_stream_gains(
        p, p.device_params(PipelineParams.design(p.cfg)), gains)
    _, got = steps(p, params, xs)
    check(f"per-stream gains {strategy}", got, want, bound)
    if strategy == "fft":
        check("[B, F] response", params.combined_response(True).numpy(),
              np.asarray(jparams.combined_response(True, premultiplied=True)), FFT_DB)


def test_per_stream_td_matches_fft():
    """K11 ≡ the 'fft' strategy's [B, F] response within −100 dB, at the
    reference's own test point (`tests/test_batch.py:56-72`)."""
    kw = dict(resample_quality="fast", samplerate=44100, blocksize=256,
              upsample_factor=2, numtaps=65, batch=2, cutoff=11000.0,
              eq_enabled=True, downsample_mode="decimate", dither_kind="off",
              output_clip=None)
    gains = np.array([[1.0] * 9, np.linspace(0.5, 2.0, 9)], dtype=np.float32)
    sig = blocks(1, B=2, L=3 * 256, seed=27)[0]
    outs = {}
    for strategy in ("fft", "td_mxu"):
        p = Pipeline(StreamConfig(**kw, conv_strategy=strategy), "cpu")
        params = batch.with_per_stream_gains(
            p, p.device_params(PipelineParams.design(p.cfg)), gains)
        _, outs[strategy] = p.process_signal(params, p.init_state(), sig)
    check("per-stream gains td vs fft", outs["td_mxu"].numpy(), outs["fft"].numpy(),
          FFT_DB)


@pytest.mark.parametrize("ingest", ["pair", "pcm16"])
def test_per_stream_gains_transport(ingest):
    """Per-stream gains under pair ingest (the block merged to f32: the
    pair class) and pcm16 ingest (converted first: exact) against
    `afp_tpu`; the pcm16 tail stays the raw int16 history."""
    kw = {**EQ, "ingest": ingest}
    gains = np.random.default_rng(15).uniform(0, 2, (16, 9)).astype(np.float32)
    xs = blocks(2, seed=16)
    xs = pcm(xs) if ingest == "pcm16" else xs
    jp = JPipeline(JConfig(**kw))
    _, want = jsteps(jp, jbatch.with_per_stream_gains(
        jp, jp.device_params(JParams.design(jp.cfg)), gains), xs)
    p = Pipeline(StreamConfig(**kw), "cpu")
    st, got = steps(p, batch.with_per_stream_gains(
        p, p.device_params(PipelineParams.design(p.cfg)), gains), xs)
    check(f"per-stream gains, {ingest} ingest", got, want,
          PAIR_DB if ingest == "pair" else TD_DB)
    if ingest == "pcm16":
        assert st.conv_tail.dtype == torch.int16
        assert torch.equal(st.conv_tail, torch.from_numpy(xs[-1][:, -p._k_pad:]))


def test_per_stream_gains_rings_refused():
    p = Pipeline(StreamConfig(**EQ), "cpu")
    params = batch.with_per_stream_gains(
        p, p.device_params(PipelineParams.design(p.cfg)), 1.5)
    ring = torch.zeros(2, 16, 512)
    with pytest.raises(ValueError, match="ring_step does not support per-stream"):
        p.ring_step(params, p.init_state(), ring, None, 0, torch.zeros_like(ring))
    with pytest.raises(ValueError, match="run_ring_mega does not support per-stream"):
        p.run_ring_mega(params, p.init_state(), ring, None, torch.zeros_like(ring), 2)
    with pytest.raises(ValueError, match="no shared cascade"):
        params.combined_cascade(True)


def _policies(p):
    """Four AGC policies in batch/4-row groups (the C8-psagc shape)."""
    B = p.batch
    pol = dict(target=[0.05, 0.1, 0.2, 0.3], mg=[4.0, 10.0, 10.0, 20.0],
               att=[0.005, 0.01, 0.02, 0.05], rel=[0.05, 0.1, 0.2, 0.5])
    return {k: np.repeat(np.asarray(v, np.float32), B // 4) for k, v in pol.items()}, pol


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_agc_vectors_pipeline(mode):
    """[B] AGC policies through the C8 chain: against `afp_tpu`'s unforced
    route ≤ −100 dB; each row group ≡ the scalar pipeline of its policy,
    bit for bit; the per-step ring ≡ the staged steps, dither on."""
    kw = {**C8, "agc_mode": mode}
    xs = blocks(3, B=8, L=256, seed=17, scale=0.05)
    xs[:, 0] *= 12.0
    p = Pipeline(StreamConfig(**kw), "cpu")
    v, pol = _policies(p)
    params = batch.with_per_stream_agc(
        p, p.device_params(PipelineParams.design(p.cfg)), target_level=v["target"],
        max_gain=v["mg"], attack=v["att"], release=v["rel"])
    assert params.agc_a_att.shape == (8,) and params.agc_target.device == p.device
    st, got = steps(p, params, xs)
    jp = JPipeline(JConfig(**kw))
    jparams = jbatch.with_per_stream_agc(
        jp, jp.device_params(JParams.design(jp.cfg)), target_level=v["target"],
        max_gain=v["mg"], attack=v["att"], release=v["rel"])
    for f in ("agc_target", "agc_max_gain", "agc_a_att", "agc_a_rel"):
        assert np.asarray(jparams._asdict()[f]).tobytes() == getattr(params, f).numpy().tobytes()
    jst, want = jsteps(jp, jparams, xs)
    check(f"AGC vectors {mode}", got, want, CHAIN_DB)
    check(f"AGC vectors {mode} gain", st.agc_gain.numpy(), np.asarray(jst.agc_gain),
          CHAIN_DB)
    for g in range(4):
        c = StreamConfig(**{**kw, "agc_target_level": pol["target"][g],
                            "agc_max_gain": pol["mg"][g], "agc_attack": pol["att"][g],
                            "agc_release": pol["rel"][g]})
        q = Pipeline(c, "cpu")
        _, sc = steps(q, q.device_params(PipelineParams.design(q.cfg)), xs)
        assert np.array_equal(got[:, 2 * g:2 * g + 2], sc[:, 2 * g:2 * g + 2]), g
    dkw = {**kw, "dither_kind": "tpdf"}
    p = Pipeline(StreamConfig(**dkw), "cpu")
    params = batch.with_per_stream_agc(p, p.device_params(PipelineParams.design(p.cfg)),
                                       target_level=v["target"], attack=v["att"])
    st, staged = steps(p, params, xs, seed=2)
    rst, ring = p.run_ring(params, p.init_state(seed=2), torch.from_numpy(xs), None,
                           torch.zeros(xs.shape), 3)
    assert np.array_equal(ring.numpy(), staged) and torch.equal(rst.agc_gain, st.agc_gain)


def test_agc_validation_matches():
    p = Pipeline(StreamConfig(**TD), "cpu")
    pp = p.device_params(PipelineParams.design(p.cfg))
    with pytest.raises(ValueError, match="agc_enabled"):
        batch.with_per_stream_agc(p, pp, target_level=0.2)
    q = Pipeline(StreamConfig(**C8), "cpu")
    qp = q.device_params(PipelineParams.design(q.cfg))
    with pytest.raises(ValueError, match="vector"):
        batch.with_per_stream_agc(q, qp, target_level=np.ones(3, np.float32))
    out = batch.with_per_stream_agc(q, qp, target_level=0.25, attack=0.02)
    assert out.agc_target.ndim == 0 and out.agc_a_att.ndim == 0
    assert out.agc_target.device.type == "cpu"


@pytest.mark.parametrize("agc", ["gains", "bank"])
def test_c8_with_gains_or_bank_matches_jax(agc):
    """The C8 chain (AGC, K6 storing f32) with per-stream EQ gains (K11) or,
    without EQ, a filter bank (K10) against `afp_tpu`'s unforced route
    ≤ −100 dB, over 3 blocks (the pair tail merged and re-split)."""
    kw = dict(C8) if agc == "gains" else {**C8, "eq_enabled": False}
    xs = blocks(3, B=8, L=256, seed=18, scale=0.05)
    xs[:, 0] *= 12.0
    jp, p = JPipeline(JConfig(**kw)), Pipeline(StreamConfig(**kw), "cpu")
    if agc == "gains":
        gains = np.random.default_rng(19).uniform(0, 2, (8, 9)).astype(np.float32)
        jparams = jbatch.with_per_stream_gains(
            jp, jp.device_params(JParams.design(jp.cfg)), gains)
        params = batch.with_per_stream_gains(
            p, p.device_params(PipelineParams.design(p.cfg)), gains)
    else:
        variants = [dict(cutoff=9000.0)] * 8
        jparams = jbatch.with_per_stream_filters(jp, variants)
        params = batch.with_per_stream_filters(p, variants)
    jst, want = jsteps(jp, jparams, xs)
    st, got = steps(p, params, xs)
    check(f"C8 with per-stream {agc}", got, want, CHAIN_DB)
    check(f"C8 with per-stream {agc}, gain", st.agc_gain.numpy(),
          np.asarray(jst.agc_gain), CHAIN_DB)


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("ingest,mega", [("f32", False), ("f32", True),
                                         ("pcm16", True)])
def test_ring_server_packing_caller_order(ingest, mega):
    """RingServer(packing=) over interleaved designs: outputs in caller
    order ≡ the staged banked steps with manual pack/unpack, bit for bit,
    dither on."""
    kw = {**TD, "ingest": ingest, "dither_kind": "tpdf"}
    p = Pipeline(StreamConfig(**kw), "cpu")
    bank, pk = batch.with_per_stream_filters(p, INTERLEAVED, pack=True)
    xs = blocks(5, seed=20)
    xs = pcm(xs) if ingest == "pcm16" else xs
    st, gold = p.init_state(seed=2), []
    for x in xs:
        st, y = p.step(bank, st, pk.pack(x))
        gold.append(pk.unpack(y.numpy()))
    srv = RingServer(p, bank, slots=8, chunk=2, max_inflight=2, seed=2, mega=mega,
                     packing=pk)
    outs = list(srv.stream(iter(xs)))
    assert len(outs) == 5 and all(np.array_equal(o, g) for o, g in zip(outs, gold))


def test_ring_server_packing_pair_ingest():
    """A packing on the pair rings (no bank): tuples and f32 blocks land in
    device order and drain in caller order, ≡ an unpacked server fed the
    packed blocks, its output unpacked (the same device rows, so the same
    noise: bit for bit with dither on)."""
    kw = {**TD, "ingest": "pair", "dither_kind": "tpdf"}
    p = Pipeline(StreamConfig(**kw), "cpu")
    _, pk = batch.with_per_stream_filters(Pipeline(StreamConfig(**TD), "cpu"),
                                          INTERLEAVED, pack=True)
    xs = blocks(4, seed=21)
    params = p.device_params(PipelineParams.design(p.cfg))
    plain = RingServer(p, params, slots=8, chunk=2, seed=1)
    want = [pk.unpack(y) for y in plain.stream(iter(pk.pack(xs, axis=1)))]
    src = [fir_td.split_bf16(torch.from_numpy(x)) if i % 2 else x
           for i, x in enumerate(xs)]
    srv = RingServer(p, params, slots=8, chunk=2, seed=1, packing=pk)
    assert np.array_equal(np.stack(list(srv.stream(iter(src)))), np.stack(want))


def test_packing_moves_data_not_agc_vectors():
    """The reference's semantics: pack/unpack move the data; per-stream AGC
    vectors are not permuted, so they are supplied in device order: device
    row r runs caller stream perm[r] with the vectors' entry r (against
    the shared-taps pipeline on row r's design and scalar target)."""
    kw = {**C8, "eq_enabled": False, "batch": 16}
    p = Pipeline(StreamConfig(**kw), "cpu")
    vs = [dict(cutoff=4000.0 if i % 2 else 12000.0) for i in range(16)]
    bank, pk = batch.with_per_stream_filters(p, vs, pack=True)
    targets = np.linspace(0.05, 0.3, 16).astype(np.float32)
    params = batch.with_per_stream_agc(p, bank, target_level=targets)
    assert np.array_equal(params.agc_target.numpy(), targets)
    xs = pk.pack(blocks(1, B=16, L=256, seed=22, scale=0.05)[0])
    _, y = p.step(params, p.init_state(), xs)
    bt = 16 // len(bank.casc_assign)
    for r in (0, 13):
        q = Pipeline(StreamConfig(**{**kw, "agc_target_level": float(targets[r])}),
                     "cpu")
        design = bank.casc_bank[bank.casc_assign[r // bt]]
        _, yq = q.step(q.device_params(PipelineParams.design(q.cfg))._replace(
            casc_main=design), q.init_state(), xs)
        assert torch.equal(y[r], yq[r])


def test_engine_per_stream_gains():
    """StreamEngine with a per-stream gain bank: process_block ≡ the
    pipeline's step, set_eq_gains takes [B, n_bands] once the live params
    carry that shape, and no ladder rung fires."""
    kw = {**EQ, "conv_strategy": "fft", "dither_kind": "tpdf"}
    eng = StreamEngine(StreamConfig(**kw), device="cpu", seed=3)
    p = Pipeline(StreamConfig(**kw), "cpu")
    params = p.device_params(PipelineParams.design(p.cfg))
    st = p.init_state(seed=3)
    rng = np.random.default_rng(23)
    for i, x in enumerate(blocks(4, seed=24)):
        if i == 1:
            with pytest.raises(ValueError, match="EQ band count"):
                eng.set_eq_gains(np.ones((16, 9)))
            g = rng.uniform(0, 2, (16, 9)).astype(np.float32)
            eng.params = batch.with_per_stream_gains(eng.pipeline, eng.params, g)
            params = batch.with_per_stream_gains(p, params, g)
        if i == 3:
            g = rng.uniform(0, 2, (16, 9)).astype(np.float32)
            eng.set_eq_gains(g)
            params = batch.with_per_stream_gains(p, params, g)
        st, want = p.step(params, st, x)
        assert np.array_equal(eng.process_block(x), want.numpy())
    m = eng.metrics
    assert m.underruns == m.fallback_replays == m.fallback_silence == 0


def test_fft_bank_equals_single_stream_pipelines():
    """A [B, F] filter bank on 'fft' equals B single-stream pipelines
    within the FFT bound (`tests/test_batch.py:97-118`)."""
    kw = {**TD, "conv_strategy": "fft", "batch": 3}
    variants = [dict(cutoff=6000.0), dict(cutoff=15000.0, window_type="hann"),
                dict(cutoff=(500.0, 8000.0), filter_type="bandpass")]
    p = Pipeline(StreamConfig(**kw), "cpu")
    sig = blocks(1, B=3, L=3 * 512, seed=26)[0]
    _, got = p.process_signal(batch.with_per_stream_filters(p, variants),
                              p.init_state(), sig)
    for b, ov in enumerate(variants):
        q = Pipeline(StreamConfig(**{**kw, "batch": 1, **ov}), "cpu")
        _, want = q.process_signal(q.device_params(PipelineParams.design(q.cfg)),
                                   q.init_state(), sig[b:b + 1])
        check(f"fft bank row {b}", got.numpy()[b], want.numpy()[0], FFT_DB)
