"""The port's parallel layer (`afp_tpu_torch/parallel/`) on the CPU:
`ShardedPipeline` over ``devices=["cpu"] * n`` against `afp_tpu`'s on the
suite's 8 virtual CPU devices, `halo_convolve`, `filter_long_signal` and
`KernelParallelConv` against `afp_tpu`'s, the serving rings and
`RingServer` over a sharded pipeline, the refusals, and the mesh helpers.

Inputs are made with numpy from a seed and handed to both packages, dither
off wherever `afp_tpu` is compared (its threefry noise is not the port's
Philox).  The bounds, max-abs error over peak: the 'td_mxu' conv forms
≤ −110 dB (the bf16×3 accumulation-order class), 'fft' and every FFT
route (halo, long signal, kernel-parallel) ≤ −100 dB (two FFT libraries),
the AGC chain ≤ −100 dB.  Inside the port, sharded ≡ unsharded, ring ≡
run, and `RingServer` ≡ sharded run hold bit for bit: each shard runs the
unsharded code on its rows, and the conv forms order their sums by taps
and window, not by batch.  Each test prints the measured value."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.engine import batch as jbatch
from afp_tpu.ops.pallas.fir_td import split_bf16 as jsplit
from afp_tpu.parallel import KernelParallelConv as JKernelParallelConv
from afp_tpu.parallel import ShardedPipeline as JShardedPipeline
from afp_tpu.parallel import filter_long_signal as jfilter_long_signal
from afp_tpu.parallel import halo_convolve as jhalo_convolve
from afp_tpu.parallel import make_mesh as jmake_mesh
from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig, batch
from afp_tpu_torch.ops.convolve import OverlapSave
from afp_tpu_torch.ops.cuda import split_bf16
from afp_tpu_torch.parallel import (KernelParallelConv, Mesh, ShardedPipeline,
                                    filter_long_signal, halo_convolve,
                                    halo_convolve_sharded, make_mesh,
                                    make_multislice_mesh, shard_seed)
from afp_tpu_torch.parallel import collectives
from afp_tpu_torch.runtime import RingServer

TD_DB = -110.0  # the bf16×3 accumulation-order class
FFT_DB = -100.0  # two FFT libraries
CHAIN_DB = -100.0  # the AGC chain: branch points and the conv

#: the reference's `tests/test_parallel.py` shapes, cut to block 256
BASE = dict(resample_quality="fast", samplerate=44100, blocksize=256,
            upsample_factor=2, numtaps=65, batch=8, filter_type="lowpass",
            cutoff=11000.0, eq_enabled=True, agc_enabled=False,
            downsample_mode="decimate", dither_kind="off", output_clip=None)
TD = dict(conv_strategy="td_mxu")
AGC = dict(conv_strategy="td_mxu", agc_enabled=True, agc_window_size=64,
           agc_carry=True, output_clip=0.99)


def kw(**over) -> dict:
    return {**BASE, **over}


def cpu_mesh(n: int, axes=("streams",), shape=None) -> Mesh:
    return make_mesh(n, axes, shape=shape, devices=["cpu"] * n)


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def close(name, got, want, bound):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    e = err_db(got, want)
    print(f"{name}: {e:.1f} dB (bound {bound})")
    assert e <= bound


def same(a, b) -> bool:
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def signal(shape, seed=0, scale=0.3) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def pair(k: dict, n_shards: int = 8):
    """The reference's and the port's ShardedPipeline on n CPU shards, and
    their banks from one design."""
    jsp = JShardedPipeline(JConfig(**k), jmake_mesh(n_shards))
    tsp = ShardedPipeline(StreamConfig(**k), cpu_mesh(n_shards))
    return (jsp, jsp.device_params(JParams.design(jsp.cfg)),
            tsp, tsp.device_params(PipelineParams.design(tsp.cfg)))


# ---------------------------------------------------------------- stream DP


@pytest.mark.parametrize("strategy,bound", [("fft", FFT_DB), ("td_mxu", TD_DB)])
def test_dp_matches_afp_tpu(strategy, bound):
    """step, run, and process_signal with the fold and with the scan, on
    the 8-shard mesh, against `afp_tpu`'s sharded outputs."""
    k = kw(conv_strategy=strategy, upsample_factor=4, numtaps=101,
           output_clip=0.9)
    jsp, jp, tsp, tp = pair(k)
    x = signal((3, 8, 256), seed=1)
    _, jy = jsp.step(jp, jsp.init_state(), x[0])
    _, ty = tsp.step(tp, tsp.init_state(), x[0])
    close(f"{strategy} step", ty, jy, bound)
    _, jy = jsp.run(jp, jsp.init_state(), x)
    _, ty = tsp.run(tp, tsp.init_state(), x)
    close(f"{strategy} run", ty, jy, bound)
    sig = signal((8, 4 * 256), seed=2)
    for fold in ("prefer", False):
        _, jy = jsp.process_signal(jp, jsp.init_state(), sig, fold=fold)
        _, ty = tsp.process_signal(tp, tsp.init_state(), sig, fold=fold)
        close(f"{strategy} process_signal fold={fold}", ty, jy, bound)


def test_dp_pair_ingest_and_pair_state():
    """Pair ingest: the pair tail shards with its rows, and f32 blocks
    (split per shard) and pre-split (hi, lo) pairs both match `afp_tpu`."""
    k = kw(**TD, ingest="pair", eq_enabled=False, upsample_factor=4,
           numtaps=101)
    jsp, jp, tsp, tp = pair(k)
    st = tsp.init_state()
    assert all(isinstance(s.conv_tail, tuple) for s in st.shards)
    x = signal((3, 8, 256), seed=3)
    _, jy = jsp.run(jp, jsp.init_state(), x)
    _, ty = tsp.run(tp, st, x)
    close("pair f32 run", ty, jy, TD_DB)
    _, ty2 = tsp.run(tp, st, split_bf16(torch.as_tensor(x)))
    assert same(ty2, ty)
    _, jy2 = jsp.run(jp, jsp.init_state(), jsplit(jnp.asarray(x)))
    close("pair (hi, lo) run", ty2, jy2, TD_DB)


def test_dp_multirate_chain():
    """The literal chain (resampler states shard with their rows)."""
    jsp, jp, tsp, tp = pair(kw(fuse_rate_conversion=False))
    x = signal((2, 8, 256), seed=4)
    _, jy = jsp.run(jp, jsp.init_state(), x)
    _, ty = tsp.run(tp, tsp.init_state(), x)
    close("literal chain run", ty, jy, FFT_DB)


@pytest.mark.parametrize("strategy,bound", [("fft", FFT_DB), ("td_mxu", TD_DB)])
def test_dp_per_stream_gains(strategy, bound):
    """Per-stream EQ gains [B, 9] split with their rows (K11 on 'td_mxu')."""
    k = kw(conv_strategy=strategy, output_clip=0.99)
    jsp, jp, tsp, tp = pair(k)
    gains = np.linspace(0.5, 2.0, 8 * 9).reshape(8, 9).astype(np.float32)
    jbank = jbatch.with_per_stream_gains(JPipeline(JConfig(**k)), jp, gains)
    tbank = batch.with_per_stream_gains(Pipeline(StreamConfig(**k), "cpu"),
                                        tp, gains)
    x = signal((2, 8, 256), seed=5)
    _, jy = jsp.run(jbank, jsp.init_state(), x)
    _, ty = tsp.run(tbank, tsp.init_state(), x)
    close(f"{strategy} per-stream gains run", ty, jy, bound)


@pytest.mark.parametrize("strategy,bound", [("fft", FFT_DB), ("td_mxu", TD_DB)])
def test_dp_filter_banks(strategy, bound):
    """Per-stream filters: a [B, F] H_main ('fft') or the design bank with
    its per-tile assignment ('td_mxu', K10, and the banked rings), built
    at the global batch and split per shard, on the reference's 2-shard
    mesh."""
    k = kw(conv_strategy=strategy, eq_enabled=False, numtaps=33, batch=16)
    variants = [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)]
    jbank = jbatch.with_per_stream_filters(JPipeline(JConfig(**k)), variants)
    tbank = batch.with_per_stream_filters(Pipeline(StreamConfig(**k), "cpu"),
                                          variants)
    jsp, _, tsp, _ = pair(k, n_shards=2)
    x = signal((2, 16, 256), seed=6)
    _, jy = jsp.run(jbank, jsp.init_state(seed=1), x)
    _, ty = tsp.run(tbank, tsp.init_state(seed=1), x)
    close(f"{strategy} filter banks run", ty, jy, bound)
    if strategy == "td_mxu":  # the banked rings (K3, K4) ≡ the banked run
        lay = tsp.ring_layout
        for form in (tsp.run_ring, tsp.run_ring_mega):
            _, out = form(tbank, tsp.init_state(seed=1), lay.split(x), None,
                          lay.zeros(2, 256, torch.float32), 2)
            assert same(lay.gather(out), ty)


@pytest.mark.parametrize("group", [1, 2])
def test_dp_agc_chain(group):
    """The C8 chain (K5 → link → K6 → K8), linked in shard-local groups."""
    k = kw(**AGC, batch=16, agc_link_group=group)
    jsp, jp, tsp, tp = pair(k)
    x = signal((3, 16, 256), seed=7, scale=0.1)
    x[:, ::3] *= 0.05  # quiet streams: the gain rises
    jst, jy = jsp.run(jp, jsp.init_state(), x)
    tst, ty = tsp.run(tp, tsp.init_state(), x)
    close(f"AGC chain link {group} run", ty, jy, CHAIN_DB)
    close(f"AGC chain link {group} gain carry", tst.gather("agc_gain"),
          jst.agc_gain, CHAIN_DB)


def test_dp_one_kernel_agc():
    """``agc_one_kernel=True`` (K14) sharded ≡ the port's unsharded
    one-kernel pipeline bit for bit, and its sharded ring ≡ its sharded
    run; against `afp_tpu`'s sharded AGC chain ≤ −100 dB."""
    # K14's gate: w = 2·128 (and the config caps w at half the block)
    k = kw(**{**AGC, "agc_window_size": 256}, batch=16, blocksize=512)
    jsp, jp, _, _ = pair(k)
    tsp = ShardedPipeline(StreamConfig(**k), cpu_mesh(4), agc_one_kernel=True)
    assert tsp.pipeline._agc_one_kernel
    tp = tsp.device_params(PipelineParams.design(tsp.cfg))
    one = Pipeline(StreamConfig(**k), "cpu", agc_one_kernel=True)
    x = signal((3, 16, 512), seed=8, scale=0.1)
    st, ty = tsp.run(tp, tsp.init_state(), x)
    _, uy = one.run(tp, one.init_state(), x)
    assert same(ty, uy)
    _, jy = jsp.run(jp, jsp.init_state(), x)
    close("one-kernel AGC run vs afp_tpu's chain", ty, jy, CHAIN_DB)
    lay = tsp.ring_layout
    out = lay.zeros(3, 512, torch.float32)
    st2, out = tsp.run_ring(tp, tsp.init_state(), lay.split(x), None, out, 3)
    assert same(lay.gather(out), ty)
    assert same(st2.gather("agc_gain"), st.gather("agc_gain"))


# ---------------------------------------------------------------- inside the port

#: the forms a sharded pipeline runs, each against the unsharded pipeline
FORMS = {
    "fft": kw(),
    "td": kw(**TD, upsample_factor=4, numtaps=101),
    "pair": kw(**TD, ingest="pair", eq_enabled=False),
    "pcm16": kw(**TD, ingest="pcm16", emit="pcm16", output_clip=0.9),
    "agc-linked": kw(**AGC, batch=16, agc_link_group=2),
    "literal": kw(fuse_rate_conversion=False),
}


def blocks_for(cfg: StreamConfig, n: int, seed: int) -> np.ndarray:
    x = signal((n, cfg.batch, cfg.blocksize), seed=seed, scale=0.2)
    return (np.round(x * 32767).astype(np.int16) if cfg.ingest == "pcm16"
            else x)


@pytest.mark.parametrize("form", list(FORMS))
def test_sharded_equals_unsharded(form):
    """Each form over 8 CPU shards ≡ the one-device pipeline on the same
    rows, bit for bit, dither off: the outputs and every carried tail;
    chained steps ≡ run ≡ process_signal's scan; the state passed in stays
    intact."""
    cfg = StreamConfig(**FORMS[form])
    pipe = Pipeline(cfg, "cpu")
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sp = ShardedPipeline(cfg, cpu_mesh(8))
    sparams = sp.device_params(PipelineParams.design(sp.cfg))
    x = blocks_for(cfg, 3, seed=10)
    ust, uy = pipe.run(params, pipe.init_state(), x)
    st0 = sp.init_state()
    st0_tails = [s.conv_tail for s in st0.shards]
    st, y = sp.run(sparams, st0, x)
    assert same(y, uy)
    tail, utail = st.gather("conv_tail"), ust.conv_tail
    for a, b in (zip(tail, utail) if isinstance(tail, tuple) else [(tail, utail)]):
        assert same(a, b)
    assert all(s.conv_tail is t for s, t in zip(st0.shards, st0_tails))
    assert all(s.step == 0 for s in st0.shards) and all(
        s.step == 3 for s in st.shards)
    chained, outs = sp.init_state(), []
    for blk in x:
        chained, yb = sp.step(sparams, chained, blk)
        outs.append(yb)
    assert same(torch.stack(outs), y)
    sig = np.concatenate(list(x), axis=-1)
    _, ys = sp.process_signal(sparams, sp.init_state(), sig, fold=False)
    assert same(ys, torch.cat(list(y), dim=-1))
    print(f"{form}: sharded == unsharded, steps == run == scan, bit for bit")


@pytest.mark.parametrize("form", ["td", "pcm16"])
def test_sharded_fold_equals_unsharded_fold(form):
    """process_signal's fold per shard ≡ the one-device fold of the same
    rows, bit for bit."""
    cfg = StreamConfig(**FORMS[form])
    pipe = Pipeline(cfg, "cpu")
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sp = ShardedPipeline(cfg, cpu_mesh(4))
    sig = np.concatenate(list(blocks_for(cfg, 4, seed=11)), axis=-1)
    _, uy = pipe.process_signal(params, pipe.init_state(), sig, fold=True)
    st, y = sp.process_signal(params, sp.init_state(), sig, fold="prefer")
    assert same(y, uy) and all(s.step == 4 for s in st.shards)


def test_banks_and_gains_split_by_field():
    """Per-stream gains and banks split by field, never by shape: at batch
    9 (the band count) the shared [9] gains are not split; whole tiles per
    shard; sharded ≡ unsharded for per-stream gains (K11) and banks (K10)."""
    k = kw(**TD, eq_enabled=True, batch=16, numtaps=33)
    cfg = StreamConfig(**k)
    pipe = Pipeline(cfg, "cpu")
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    sp = ShardedPipeline(cfg, cpu_mesh(2))
    gains = np.random.default_rng(12).uniform(0, 2, (16, 9)).astype(np.float32)
    psg = batch.with_per_stream_gains(pipe, params, gains)
    parts = sp.shard_params(psg)
    assert [tuple(p.eq_gains.shape) for p in parts] == [(8, 9), (8, 9)]
    assert parts[0].casc_bands is parts[1].casc_bands  # shared, one copy
    assert sp.shard_params(psg) is parts  # one split per bank object
    x = signal((2, 16, 256), seed=13)
    assert same(sp.run(psg, sp.init_state(), x)[1],
                pipe.run(psg, pipe.init_state(), x)[1])
    cfg = StreamConfig(**{**k, "eq_enabled": False})  # banks take no EQ
    pipe = Pipeline(cfg, "cpu")
    sp = ShardedPipeline(cfg, cpu_mesh(2))
    bank = batch.with_per_stream_filters(
        pipe, [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)])
    assert [p.casc_assign.tolist() for p in sp.shard_params(bank)] == [[0], [1]]
    assert same(sp.run(bank, sp.init_state(), x)[1],
                pipe.run(bank, pipe.init_state(), x)[1])
    nine = ShardedPipeline(StreamConfig(**{**k, "batch": 9}), cpu_mesh(1))
    p9 = nine.device_params(PipelineParams.design(nine.cfg))
    assert nine.shard_params(p9)[0].eq_gains is p9.eq_gains


# ---------------------------------------------------------------- serving


RING_FORMS = {
    "f32": kw(**TD, output_clip=0.9),
    "pcm16": kw(**TD, ingest="pcm16", emit="pcm16", output_clip=0.9),
    "pair": kw(**TD, ingest="pair", eq_enabled=False),
    "agc": kw(**AGC, batch=16),
}


@pytest.mark.parametrize("form", list(RING_FORMS))
def test_ring_and_server_equal_sharded_run(form):
    """Sharded run_ring (and run_ring_mega where there is one) over the
    per-shard rings of `ring_layout` ≡ sharded run, bit for bit, with
    dither on; `RingServer` over the sharded pipeline (per step and mega)
    serves the same blocks, its rings one per shard."""
    cfg = StreamConfig(**{**RING_FORMS[form], "dither_kind": "tpdf"})
    sp = ShardedPipeline(cfg, cpu_mesh(4))
    params = sp.device_params(PipelineParams.design(sp.cfg))
    K, n = 4, 6  # wraparound
    x = blocks_for(cfg, n, seed=14)
    st, gold = sp.run(params, sp.init_state(seed=3), x)
    lay = sp.ring_layout
    megas = [False] if cfg.agc_enabled else [False, True]
    for mega in megas:
        rin = x[:K]
        if sp._pair_ingest:
            hi, lo = split_bf16(torch.as_tensor(rin))
            rh, rl = lay.split(hi), lay.split(lo)
        else:
            rh, rl = lay.split(rin), None
        out = lay.zeros(K, 256, sp.out_dtype)
        form_ = sp.run_ring_mega if mega else sp.run_ring
        st2, out = form_(params, sp.init_state(seed=3), rh, rl, out, K)
        assert same(lay.gather(out), gold[:K])
        srv = RingServer(sp, params, slots=K, chunk=2, max_inflight=1, seed=3,
                         mega=mega)
        assert isinstance(srv._out, tuple) and len(srv._out) == 4
        served = np.stack(list(srv.stream(iter(x))))
        assert np.array_equal(served, gold.numpy())
        if sp._pair_ingest:  # (hi, lo) pairs land half by half
            pairs = [split_bf16(torch.as_tensor(b)) for b in x]
            srv = RingServer(sp, params, slots=K, chunk=2, max_inflight=1,
                             seed=3, mega=mega)
            assert np.array_equal(np.stack(list(srv.stream(iter(pairs)))),
                                  gold.numpy())
    print(f"{form}: ring == server == sharded run, bit for bit, dither on")


def test_server_retunes_every_shard():
    """`RingServer.retune` over a sharded pipeline designs the new bank,
    refreshes every shard's config and serves it: ≡ a sharded run on the
    new design."""
    import dataclasses

    cfg = StreamConfig(**kw(**TD, numtaps=33))
    sp = ShardedPipeline(cfg, cpu_mesh(2))
    srv = RingServer(sp, slots=4, chunk=2, max_inflight=1)
    new = dataclasses.replace(sp.cfg, cutoff=6000.0)
    srv.retune(new)
    assert all(p.cfg.cutoff == 6000.0 for p in sp.pipelines)
    x = signal((4, 8, 256), seed=27)
    served = np.stack(list(srv.stream(iter(x))))
    _, gold = sp.run(sp.device_params(PipelineParams.design(new)),
                     sp.init_state(), x)
    assert np.array_equal(served, gold.numpy())


def test_server_refuses_packing_over_shards():
    cfg = StreamConfig(**kw(**TD, eq_enabled=False, batch=16, numtaps=33))
    sp = ShardedPipeline(cfg, cpu_mesh(2))
    pipe = Pipeline(cfg, "cpu")
    _, packing = batch.with_per_stream_filters(
        pipe, [dict(cutoff=4000.0 if i % 2 else 12000.0) for i in range(16)],
        pack=True)
    with pytest.raises(ValueError, match="packing"):
        RingServer(sp, packing=packing)
    with pytest.raises(ValueError, match="one ring per shard"):
        params = sp.device_params(PipelineParams.design(sp.cfg))
        z = torch.zeros((4, 16, 256))
        sp.run_ring(params, sp.init_state(), z, None, z, 1)


# ---------------------------------------------------------------- the dither key


def test_dither_decorrelated_and_deterministic():
    """Shard i dithers under ``shard_seed(seed, i)``: on zero input the
    shards' noise differs, the same seed gives the same bits, another seed
    other bits, and chained steps ≡ run with dither on."""
    cfg = StreamConfig(**kw(dither_kind="tpdf", eq_enabled=False,
                            upsample_factor=1))
    sp = ShardedPipeline(cfg, cpu_mesh(8))
    params = sp.device_params(PipelineParams.design(sp.cfg))
    z = np.zeros((2, 8, 256), np.float32)
    _, a = sp.run(params, sp.init_state(seed=4), z)
    _, b = sp.run(params, sp.init_state(seed=4), z)
    _, c = sp.run(params, sp.init_state(seed=5), z)
    assert same(a, b) and not same(a, c) and bool(a.abs().max() > 0)
    assert all(not torch.equal(a[:, i], a[:, j])
               for i in range(8) for j in range(i))
    seeds = [s.seed for s in sp.init_state(seed=4).shards]
    assert seeds == [shard_seed(4, i) for i in range(8)]
    assert len(set(seeds)) == 8
    st, outs = sp.init_state(seed=4), []
    for blk in z:
        st, y = sp.step(params, st, blk)
        outs.append(y)
    assert same(torch.stack(outs), a)


def test_shard_seed_is_fixed():
    """The derivation is documented and stable: splitmix64's output
    function of (seed << 32 | shard), low 32 bits."""
    # splitmix64's first output from state 0 is 0xE220A8397B1DCDAF
    assert shard_seed(0, 0) == 0x7B1DCDAF
    assert shard_seed(2 ** 32 + 7, 1) == shard_seed(7, 1)
    assert all(0 <= shard_seed(s, i) < 2 ** 32 for s in (0, 1, 99)
               for i in range(8))


# ---------------------------------------------------------------- refusals


def test_refusals_match_afp_tpu():
    """An indivisible batch, link groups that straddle shards, banks whose
    tiles straddle shards, and [B] AGC vectors (which `afp_tpu`'s
    ShardedPipeline replicates whole and fails on) raise."""
    with pytest.raises(ValueError, match="divide over"):
        JShardedPipeline(JConfig(**kw(batch=9)), jmake_mesh(8))
    with pytest.raises(ValueError, match="divide over"):
        ShardedPipeline(StreamConfig(**kw(batch=9)), cpu_mesh(8))
    with pytest.raises(ValueError, match="agc_link_group"):
        ShardedPipeline(StreamConfig(**kw(**AGC, batch=8, agc_link_group=2)),
                        cpu_mesh(8))
    with pytest.raises(ValueError, match="'streams' axis"):
        ShardedPipeline(StreamConfig(**kw()), cpu_mesh(2, ("time",)))
    k = kw(**TD, eq_enabled=False, batch=16, numtaps=33)
    bank = batch.with_per_stream_filters(
        Pipeline(StreamConfig(**k), "cpu"),
        [dict(cutoff=4000.0 if i < 8 else 12000.0) for i in range(16)])
    sp = ShardedPipeline(StreamConfig(**k), cpu_mesh(4))
    assert len(bank.casc_assign) == 2  # tiles of 8 rows, shards of 4
    with pytest.raises(ValueError, match="whole tiles"):
        sp.shard_params(bank)
    # [B] AGC vectors: afp_tpu raises, and so does the port
    ka = kw(**AGC, batch=16)
    target = np.linspace(0.05, 0.3, 16).astype(np.float32)
    jpipe = JPipeline(JConfig(**ka))
    jv = jbatch.with_per_stream_agc(
        jpipe, jpipe.device_params(JParams.design(jpipe.cfg)),
        target_level=target)
    jsp = JShardedPipeline(JConfig(**ka), jmake_mesh(8))
    with pytest.raises(ValueError):
        jsp.step(jv, jsp.init_state(), signal((16, 256)))
    tpipe = Pipeline(StreamConfig(**ka), "cpu")
    tv = batch.with_per_stream_agc(
        tpipe, tpipe.device_params(PipelineParams.design(tpipe.cfg)),
        target_level=target)
    tsp = ShardedPipeline(StreamConfig(**ka), cpu_mesh(8))
    with pytest.raises(ValueError, match="per-stream AGC vectors"):
        tsp.step(tv, tsp.init_state(), signal((16, 256)))
    with pytest.raises(ValueError, match="global batch"):
        tsp.step(tsp.device_params(PipelineParams.design(tsp.cfg)),
                 tsp.init_state(), signal((8, 256)))


# ---------------------------------------------------------------- no collectives


def test_dp_paths_run_no_collective():
    """step, run, the fold, the scan, the rings and the server on a
    sharded pipeline call no collective; on the ('slice', 'streams') mesh
    the step equals the 1-D mesh's bit for bit (the same shards, the same
    seeds), and so do its ring and its fold."""
    cfg = StreamConfig(**kw(**AGC, batch=16, dither_kind="tpdf"))
    before = (collectives.shift_right.calls, collectives.psum.calls)
    sp1 = ShardedPipeline(cfg, cpu_mesh(8))
    ms = make_multislice_mesh(2, devices=["cpu"] * 8)
    sp2 = ShardedPipeline(cfg, ms)
    assert sp2.n_shards == 8
    x = signal((2, 16, 256), seed=15, scale=0.1)
    p1 = sp1.device_params(PipelineParams.design(sp1.cfg))
    p2 = sp2.device_params(PipelineParams.design(sp2.cfg))
    s1, y1 = sp1.step(p1, sp1.init_state(seed=3), x[0])
    s2, y2 = sp2.step(p2, sp2.init_state(seed=3), x[0])
    assert same(y1, y2) and same(s1.gather("agc_gain"), s2.gather("agc_gain"))
    lay = sp2.ring_layout
    _, r2 = sp2.run_ring(p2, sp2.init_state(seed=1), lay.split(x), None,
                         lay.zeros(2, 256, torch.float32), 2)
    _, r1 = sp1.run(p1, sp1.init_state(seed=1), x)
    assert same(lay.gather(r2), r1)
    list(RingServer(sp2, p2, slots=4, chunk=2, max_inflight=1).stream(iter(x)))
    cfg = StreamConfig(**kw(**TD, numtaps=33))
    sp1, sp2 = ShardedPipeline(cfg, cpu_mesh(8)), ShardedPipeline(cfg, ms)
    p1 = sp1.device_params(PipelineParams.design(sp1.cfg))
    p2 = sp2.device_params(PipelineParams.design(sp2.cfg))
    sig = signal((8, 3 * 256), seed=16)
    for fold in (True, False):
        _, a = sp1.process_signal(p1, sp1.init_state(seed=2), sig, fold=fold)
        _, b = sp2.process_signal(p2, sp2.init_state(seed=2), sig, fold=fold)
        assert same(a, b)
    lay = sp2.ring_layout
    sp2.run_ring_mega(p2, sp2.init_state(), lay.split(x[:, :8]), None,
                      lay.zeros(2, 256, torch.float32), 2)
    assert (collectives.shift_right.calls, collectives.psum.calls) == before
    print("stream-parallel paths: 0 collectives")


# ---------------------------------------------------------------- halo exchange


def oracle_conv(x, h):
    """The zero-primed causal convolution in float64, row by row."""
    x, h = np.atleast_2d(x).astype(np.float64), np.atleast_2d(h).astype(np.float64)
    N = h.shape[-1]
    return np.stack([np.convolve(np.concatenate([np.zeros(N - 1), r]),
                                 h[i % h.shape[0]], "valid")
                     for i, r in enumerate(x)])


def test_halo_convolve_1d_and_batched():
    """A 'time' mesh of 8 and 4 shards: ≡ `afp_tpu`'s ≤ −100 dB and the
    float64 oracle ≤ −100 dB, one neighbour push per call."""
    rng = np.random.default_rng(17)
    h = rng.normal(size=129).astype(np.float32)
    x = rng.normal(size=8 * 1024).astype(np.float32)
    calls = collectives.shift_right.calls
    y = halo_convolve(x, h, cpu_mesh(8, ("time",)))
    assert collectives.shift_right.calls == calls + 1 and y.shape == x.shape
    close("halo 1-D vs afp_tpu", y, jhalo_convolve(x, h, jmake_mesh(8, ("time",))),
          FFT_DB)
    close("halo 1-D vs oracle", y[None], oracle_conv(x, h), FFT_DB)
    xb = rng.normal(size=(3, 4096)).astype(np.float32)
    h65 = h[:65]
    yb = halo_convolve(xb, h65, cpu_mesh(4, ("time",)))
    close("halo batched vs afp_tpu", yb,
          jhalo_convolve(xb, h65, jmake_mesh(4, ("time",))), FFT_DB)
    close("halo batched vs oracle", yb, oracle_conv(xb, h65), FFT_DB)


def test_halo_convolve_2d_mesh_and_per_stream_taps():
    """The 2×4 ('streams' × 'time') mesh ≡ the time mesh, with shared and
    per-stream [B, N] taps, both against `afp_tpu`; one push per streams
    row; an indivisible batch raises.  The two meshes hand torch's CPU FFT
    2 and 4 rows, and it may round a row differently with the batch it is
    given (its passes take rows in vector groups), so here they agree
    within −110 dB, not bit for bit (`afp_tpu`'s XLA FFT: bit for bit)."""
    rng = np.random.default_rng(18)
    mesh2d = cpu_mesh(8, ("streams", "time"), shape=(2, 4))
    jmesh2d = jmake_mesh(8, ("streams", "time"), shape=(2, 4))
    tmesh = cpu_mesh(4, ("time",))
    x = (rng.normal(size=(4, 4096)) * 0.3).astype(np.float32)
    for h in ((rng.normal(size=65) * 0.1).astype(np.float32),
              (rng.normal(size=(4, 65)) * 0.1).astype(np.float32)):
        calls = collectives.shift_right.calls
        y = halo_convolve(x, h, mesh2d)
        assert collectives.shift_right.calls == calls + 2
        close(f"halo 2-D taps {h.shape} vs the time mesh", y,
              halo_convolve(x, h, tmesh), TD_DB)
        close(f"halo 2-D taps {h.shape} vs afp_tpu", y,
              jhalo_convolve(x, h, jmesh2d), FFT_DB)
    with pytest.raises(ValueError, match="divide over"):
        halo_convolve(x[:3], h, mesh2d)
    with pytest.raises(ValueError, match="must divide over 4"):
        halo_convolve(x[:, :4095], h, tmesh)
    with pytest.raises(ValueError, match="halo"):
        halo_convolve(x[:, :128], np.ones(65, np.float32), cpu_mesh(4, ("time",)))


def test_halo_mono_replicates_and_sharded_entry():
    """A mono [T] or [1, T] signal on the 2-D mesh replicates its row;
    halo_convolve_sharded ≡ halo_convolve, mono and batched, and
    ≡ `afp_tpu`'s halo_convolve_sharded."""
    from afp_tpu.parallel import halo_convolve_sharded as jsharded

    rng = np.random.default_rng(19)
    mesh2d = cpu_mesh(8, ("streams", "time"), shape=(2, 4))
    tmesh = cpu_mesh(4, ("time",))
    x = (rng.normal(size=4096) * 0.3).astype(np.float32)
    h = (rng.normal(size=65) * 0.1).astype(np.float32)
    assert same(halo_convolve(x, h, mesh2d), halo_convolve(x, h, tmesh))
    y = halo_convolve_sharded(x[None], h, mesh2d)
    assert same(y, halo_convolve(x, h, tmesh)[None])
    close("halo_sharded mono vs afp_tpu", y,
          jsharded(x[None], h, jmake_mesh(8, ("streams", "time"), shape=(2, 4))),
          FFT_DB)
    x2 = (rng.normal(size=(2, 4096)) * 0.3).astype(np.float32)
    assert same(halo_convolve_sharded(x2, h, mesh2d), halo_convolve(x2, h, tmesh))


# ---------------------------------------------------------------- long signals


def long_kw(B, **over) -> dict:
    return kw(**{"upsample_factor": 2, "blocksize": 512, "batch": B, **over})


def long_case(seed, B, **over):
    """Both packages' pipelines and banks at batch B, and a [B, 8192]
    signal."""
    k = long_kw(B, **over)
    jp, tp = JPipeline(JConfig(**k)), Pipeline(StreamConfig(**k), "cpu")
    return (jp, jp.device_params(JParams.design(jp.cfg)), tp,
            tp.device_params(PipelineParams.design(tp.cfg)),
            signal((B, 8 * 1024), seed=seed))


@pytest.mark.parametrize("strategy", ["fft", "td_mxu"])
def test_filter_long_signal_matches(strategy):
    """The fused cascade over an 8-shard 'time' mesh ≡ `afp_tpu`'s and ≡
    the port's streaming Pipeline (≤ −100 dB: FFT against the FFT or the
    bf16×3 conv)."""
    jp, jpar, tp, tpar, sig = long_case(20, 1, upsample_factor=4,
                                        conv_strategy=strategy)
    y = filter_long_signal(tp, tpar, sig, cpu_mesh(8, ("time",)))
    close(f"long {strategy} vs afp_tpu", y,
          jfilter_long_signal(jp, jpar, sig, jmake_mesh(8, ("time",))), FFT_DB)
    _, streamed = tp.process_signal(tpar, tp.init_state(), sig, fold=False)
    close(f"long {strategy} vs the streaming Pipeline", y, streamed, FFT_DB)


@pytest.mark.parametrize("carry", [True, False])
def test_filter_long_signal_agc(carry):
    """The C8 chain: the front half per shard, the recurrence in shard
    order with the clipped carry (or block-local without it) ≡ `afp_tpu`'s
    and the streaming Pipeline's, ≤ −100 dB."""
    jp, jpar, tp, tpar, sig = long_case(21, 2, agc_enabled=True,
                                        agc_carry=carry, agc_window_size=256,
                                        conv_strategy="td_mxu")
    y = filter_long_signal(tp, tpar, sig, cpu_mesh(8, ("time",)))
    close(f"long AGC carry={carry} vs afp_tpu", y,
          jfilter_long_signal(jp, jpar, sig, jmake_mesh(8, ("time",))), CHAIN_DB)
    _, streamed = tp.process_signal(tpar, tp.init_state(), sig)
    close(f"long AGC carry={carry} vs streaming", y, streamed, CHAIN_DB)


def test_filter_long_signal_gain_clipping():
    """A loud passage drives the desired gain under 0.1: the clipped carry
    keeps long ≡ streaming (`afp_tpu`'s case)."""
    jp, jpar, tp, tpar, sig = long_case(22, 1, agc_enabled=True,
                                        agc_carry=True, agc_window_size=256,
                                        agc_target_level=0.05)
    sig = sig / 15.0
    sig[:, 2048:4096] *= 200.0
    y = filter_long_signal(tp, tpar, sig, cpu_mesh(8, ("time",)))
    close("long gain clipping vs afp_tpu", y,
          jfilter_long_signal(jp, jpar, sig, jmake_mesh(8, ("time",))), CHAIN_DB)
    _, streamed = tp.process_signal(tpar, tp.init_state(), sig)
    close("long gain clipping vs streaming", y, streamed, CHAIN_DB)


def test_filter_long_signal_2d_mesh_link_and_gains():
    """2×4 ('streams' × 'time'): AGC carry, stereo links shard-local,
    per-stream gains sharding with their rows; ≡ `afp_tpu` and the
    streaming pipeline; the link holds exactly; a mono row replicates;
    shard-straddling groups raise."""
    k = dict(dither_kind="off", agc_enabled=True, agc_carry=True,
             agc_window_size=256, agc_link_group=2, agc_max_gain=2.0,
             output_clip=0.99)
    jp, jpar, tp, tpar, sig = long_case(23, 4, **k)
    gains = np.ones((4, 9), np.float32)
    gains[2:] *= 0.7
    jpar = jbatch.with_per_stream_gains(jp, jpar, gains)
    tpar = batch.with_per_stream_gains(tp, tpar, gains)
    sig = sig / 6.0
    sig[1::2] = np.float32(0.5) * sig[0::2]
    mesh2d = cpu_mesh(8, ("streams", "time"), shape=(2, 4))
    y = filter_long_signal(tp, tpar, sig, mesh2d)
    close("long 2-D vs afp_tpu", y, jfilter_long_signal(
        jp, jpar, sig, jmake_mesh(8, ("streams", "time"), shape=(2, 4))),
        CHAIN_DB)
    _, streamed = tp.process_signal(tpar, tp.init_state(), sig)
    close("long 2-D vs streaming", y, streamed, CHAIN_DB)
    assert same(y[1::2], y[0::2] * np.float32(0.5))
    mp = Pipeline(StreamConfig(**long_kw(1, **{**k, "agc_link_group": 1})),
                  "cpu")
    mpar = mp.device_params(PipelineParams.design(mp.cfg))
    mono = filter_long_signal(mp, mpar, sig[0], mesh2d)
    _, streamed = mp.process_signal(mpar, mp.init_state(), sig[:1])
    close("long mono on the 2-D mesh vs streaming", mono[None], streamed,
          CHAIN_DB)
    bad = Pipeline(StreamConfig(**long_kw(2, **k)), "cpu")
    with pytest.raises(ValueError, match="shard-local"):
        filter_long_signal(bad, bad.device_params(PipelineParams.design(bad.cfg)),
                           sig[:2], mesh2d)


def test_filter_long_signal_guards():
    """Not fused, a chunk that is not whole blocks under AGC, and filter
    banks raise; dither adds K2's noise under ``(dither_seed, 0)``."""
    tmesh = cpu_mesh(4, ("time",))
    lit = Pipeline(StreamConfig(**kw(fuse_rate_conversion=False, batch=1)), "cpu")
    with pytest.raises(ValueError, match="fuse_rate_conversion"):
        filter_long_signal(lit, lit.device_params(PipelineParams.design(lit.cfg)),
                           np.zeros((1, 4096), np.float32), tmesh)
    agc = Pipeline(StreamConfig(**kw(batch=1, blocksize=512, agc_enabled=True)),
                   "cpu")
    with pytest.raises(ValueError, match="multiple of blocksize"):
        filter_long_signal(agc, agc.device_params(PipelineParams.design(agc.cfg)),
                           signal((1, 8 * 256)), cpu_mesh(8, ("time",)))
    k = kw(**TD, eq_enabled=False, batch=16, numtaps=33)
    pipe = Pipeline(StreamConfig(**k), "cpu")
    bank = batch.with_per_stream_filters(pipe, [dict(cutoff=4000.0)] * 16)
    with pytest.raises(ValueError, match="banks"):
        filter_long_signal(pipe, bank, signal((16, 4096)), tmesh)
    dk = kw(batch=1, dither_kind="tpdf")
    dp = Pipeline(StreamConfig(**dk), "cpu")
    dpar = dp.device_params(PipelineParams.design(dp.cfg))
    z = np.zeros((1, 4096), np.float32)
    assert not filter_long_signal(dp, dpar, z, tmesh).any()
    a = filter_long_signal(dp, dpar, z, tmesh, dither_seed=7)
    assert a.any() and same(a, filter_long_signal(dp, dpar, z, tmesh,
                                                  dither_seed=7))


# ---------------------------------------------------------------- kernel parallelism


def test_kernel_parallel_conv_matches():
    """A 1000-tap FIR over an 8-shard 'kernel' mesh ≡ `afp_tpu`'s
    KernelParallelConv and ≡ the port's full-kernel OverlapSave, block by
    block, ≤ −100 dB; one psum per block."""
    rng = np.random.default_rng(25)
    N, L, B = 1000, 512, 3
    h = rng.normal(size=N).astype(np.float32)
    sig = rng.normal(size=(B, L * 6)).astype(np.float32)
    kp = KernelParallelConv(h, block=L, mesh=cpu_mesh(8, ("kernel",)), batch=B)
    jkp = JKernelParallelConv(h, block=L, mesh=jmake_mesh(8, ("kernel",)),
                              batch=B)
    assert (kp.C, kp.nfft, kp.maxdelay) == (jkp.C, jkp.nfft, jkp.maxdelay)
    ref = OverlapSave.init(h, block=L, batch_shape=(B,))
    st, jst = kp.init_state(), jkp.init_state()
    calls = collectives.psum.calls
    for b in range(6):
        blk = sig[:, b * L:(b + 1) * L]
        st, y = kp.step(st, blk)
        jst, jy = jkp.step(jst, blk)
        ref, gold = ref.process(blk)
        close(f"kp block {b} vs afp_tpu", y, jy, FFT_DB)
        close(f"kp block {b} vs OverlapSave", y, gold, FFT_DB)
    assert collectives.psum.calls == calls + 6


def test_kernel_parallel_swap_and_ragged_length():
    """777 taps over 8 shards (not divisible); a swap to 770 taps keeps the
    shapes and, once the delay FIFOs flush, ≡ the new kernel's
    OverlapSave (and `afp_tpu`'s swap); a longer kernel is refused."""
    rng = np.random.default_rng(26)
    h1 = rng.normal(size=777).astype(np.float32)
    h2 = rng.normal(size=770).astype(np.float32)
    sig = rng.normal(size=(2, 256 * 6)).astype(np.float32)
    kp = KernelParallelConv(h1, block=256, mesh=cpu_mesh(8, ("kernel",)), batch=2)
    jkp = JKernelParallelConv(h1, block=256, mesh=jmake_mesh(8, ("kernel",)),
                              batch=2)
    st, jst = kp.init_state(), jkp.init_state()
    st, _ = kp.step(st, sig[:, :256])
    jst, _ = jkp.step(jst, sig[:, :256])
    kp2, jkp2 = kp.with_kernel(h2), jkp.with_kernel(h2)
    ref = OverlapSave.init(h2, block=256, batch_shape=(2,))
    ref, _ = ref.process(sig[:, :256])
    for b in range(1, 6):
        blk = sig[:, b * 256:(b + 1) * 256]
        st, y = kp2.step(st, blk)
        jst, jy = jkp2.step(jst, blk)
        ref, gold = ref.process(blk)
        close(f"kp swap block {b} vs afp_tpu", y, jy, FFT_DB)
    close("kp swap flushed vs OverlapSave", y, gold, FFT_DB)
    with pytest.raises(ValueError, match="longer"):
        kp.with_kernel(np.zeros(5000, np.float32))
    one = KernelParallelConv(h1, block=256, mesh=cpu_mesh(1, ("kernel",)), batch=2)
    s1, y1 = one.step(one.init_state(), sig[:, :256])
    close("kp one shard vs OverlapSave", y1,
          OverlapSave.init(h1, block=256, batch_shape=(2,)).process(
              sig[:, :256])[1], FFT_DB)
    with pytest.raises(ValueError, match="no axis"):
        KernelParallelConv(h1, block=256, mesh=cpu_mesh(2), batch=2)


# ---------------------------------------------------------------- meshes


def test_make_mesh_shapes_and_errors():
    """The reference's 1-D default and 2-D shapes, repeated devices, and
    its errors; make_multislice_mesh's single-slice branch."""
    m = cpu_mesh(8)
    assert m.axis_names == ("streams",) and m.shape == {"streams": 8}
    m2 = cpu_mesh(8, ("streams", "time"), shape=(2, 4))
    assert m2.shape == {"streams": 2, "time": 4} and m2.devices.shape == (2, 4)
    assert m2.along("time") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(4, ("streams", "time"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="available"):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 6"):
        make_mesh(4, ("a", "b"), shape=(2, 3), devices=["cpu"] * 4)
    ms = make_multislice_mesh(2, devices=["cpu"] * 8)
    assert ms.axis_names == ("slice", "streams")
    assert ms.shape == {"slice": 2, "streams": 4}
    assert make_multislice_mesh(4, 2, devices=["cpu"] * 8).shape == {
        "slice": 4, "streams": 2}
    with pytest.raises(ValueError, match="n_slices required"):
        make_multislice_mesh(devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs"):
        make_multislice_mesh(3, 4, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            make_mesh(2)
