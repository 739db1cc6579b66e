"""The served AGC ring's chunk graphs (`afp_tpu_torch/engine/ring_graphs.py`,
`Pipeline.run_ring(..., graphs=)`).

On the CPU the graphs never engage: `run_ring` with and without the cache
gives the same outputs and captures nothing.  The body a graph captures
(`Pipeline._agc_ring_chunk`) runs on the CPU too, through the plain
kernels and their device-counter arguments; with a stand-in for the
capture whose replay re-runs the captured body with what it was captured
with, as a graph does, the served ring still equals the staged steps over
three laps of a 16-slot ring and a short final chunk, through bank swaps,
an AGC retune, a restored state and a block counter across 2^32: the body
reads nothing but its static inputs.

The tests marked ``cuda`` hold the real graphs to the eager steps on the
card, bit for bit, and their counted operations to the profiler's; the
card's machine has no jax, so run them there without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_ring_graph.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig, batch
from afp_tpu_torch.engine.ring_graphs import RingGraphs
from afp_tpu_torch.ops.cuda import _build
from afp_tpu_torch.ops.cuda import fir_td as F
from afp_tpu_torch.runtime import RingServer
from afp_tpu_torch.utils import trace

FORMS = ("shared", "per_stream", "one_kernel", "agc_vectors")
B = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def replayed(monkeypatch):
    """Graphs on the CPU: they engage as on a card, and a capture records
    nothing and hands back a replay that re-runs the captured body with the
    arguments of its capture."""
    monkeypatch.setattr(RingGraphs, "engages",
                        staticmethod(lambda *a: True))

    def capture(self, body, dev):
        self.captures += 1
        return types.SimpleNamespace(replay=body, ops=0)

    monkeypatch.setattr(RingGraphs, "_capture", capture)


def make(form, dev, **over):
    """The C8 chain at a small size in the ring form `form`: K5 → K6 → K7
    on shared taps, K11's pair-to-ring form under per-stream gains, K14 →
    K7, or K5 → K6 → K7 with every AGC knob a [B] vector; 16-bit PCM in and
    out except under K14."""
    kw = dict(samplerate=44100, blocksize=256, upsample_factor=2, numtaps=33,
              batch=B, cutoff=9000.0, eq_enabled=True, agc_enabled=True,
              agc_mode="exact", agc_window_size=128, agc_carry=True,
              output_clip=0.99, dither_kind="tpdf", dither_bits=16,
              downsample_mode="decimate", conv_strategy="td_mxu",
              resample_quality="fast", ingest="pcm16", emit="pcm16")
    if form == "one_kernel":
        kw.update(blocksize=512, agc_window_size=256, ingest="f32",
                  emit="f32")
    pipe = Pipeline(StreamConfig(**{**kw, **over}), dev,
                    agc_one_kernel=form == "one_kernel")
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    rng = np.random.default_rng(5)
    if form == "per_stream":
        params = batch.with_per_stream_gains(
            pipe, params, rng.integers(0, 41, (B, 9)) / 10.0)
    elif form == "agc_vectors":
        params = batch.with_per_stream_agc(
            pipe, params, target_level=rng.uniform(0.05, 0.3, B),
            max_gain=rng.uniform(4.0, 12.0, B),
            attack=rng.uniform(0.005, 0.02, B),
            release=rng.uniform(0.05, 0.2, B))
    return pipe, params


def blocks(pipe, n, seed=12):
    """n blocks in the pipeline's ingest form, at levels from -40 to -2 dBFS."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, B, pipe.block))
         * 10 ** rng.uniform(-2, -0.1, (n, B, 1)))
    if pipe.in_dtype == torch.int16:
        return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    return np.clip(x, -1, 1).astype(np.float32)


def staged(pipe, banks, xs, state):
    """The staged steps over `xs`, block i under `banks[i]`; returns (the
    state, the outputs as numpy)."""
    outs = []
    for bank, x in zip(banks, xs):
        state, y = pipe.step(bank, state, x)
        outs.append(y.cpu().numpy())
    return state, np.stack(outs)


def same_state(a, b):
    assert a.step == b.step and a.seed == b.seed
    assert torch.equal(a.agc_gain, b.agc_gain)
    assert all(torch.equal(x, y) for x, y in zip(a.conv_tail, b.conv_tail))


def laps(form, dev):
    """Three laps of a 16-slot ring in chunks of 4 and a short final chunk
    of 3, served and staged; returns (server, served, staged, the staged
    state)."""
    pipe, params = make(form, dev)
    xs = blocks(pipe, 3 * 16 + 3)
    srv = RingServer(pipe, params, slots=16, chunk=4, max_inflight=2, seed=7)
    served = np.stack(list(srv.stream(iter(xs))))
    st, want = staged(pipe, [params] * len(xs), xs, pipe.init_state(seed=7))
    return srv, served, want, st


# ---------------------------------------------------------------- the CPU


@pytest.fixture
def traced(monkeypatch):
    """The program's spans on, as under a profiler, without one: on the
    card's machine, CPU-only profiler sessions over these tests left the
    card's later sessions in the same process without device events."""
    monkeypatch.setattr(trace, "on", lambda: True)
    trace.clear()
    yield
    trace.clear()


@pytest.mark.parametrize("form", FORMS)
def test_without_a_card_the_cache_changes_nothing(form, traced):
    """On the CPU `run_ring` with a cache is `run_ring` without one: the same
    outputs, state and spans, nothing graphed and nothing captured."""
    pipe, params = make(form, "cpu")
    ring = torch.as_tensor(blocks(pipe, 6))
    got = []
    for graphs in (None, RingGraphs()):
        trace.clear()
        out = torch.zeros(ring.shape, dtype=pipe.out_dtype)
        st = pipe.init_state(seed=3)
        for start in (0, 4, 0, 4):
            st, out = pipe.run_ring(params, st, ring, None, out, 2,
                                    start=start, graphs=graphs)
        recs = [r for r in trace.records() if r[0] == "afp.pipe.run_ring"]
        got.append((st, out, recs))
        if graphs is not None:
            assert graphs.captures == 0 and graphs.graphed == 0
    (s0, o0, r0), (s1, o1, r1) = got
    assert torch.equal(o0, o1)
    same_state(s0, s1)
    assert len(r1) == 4 and [r[5] for r in r0] == [r[5] for r in r1]
    assert not any({"graphed", "captures"} & set(r[5]) for r in r1)
    srv = RingServer(pipe, params, slots=8, chunk=2, max_inflight=2, seed=3)
    list(srv.stream(iter(blocks(pipe, 12))))
    assert srv._graphs.captures == 0 and srv._graphs.graphed == 0


def test_the_eager_epilogue_is_unchanged_without_a_counter():
    """A launch without the device counter passes the epilogue's arguments
    as before and a null counter; the plain versions read a counter as
    ``counter + dither_key[1]`` and advance it, as the tail kernel does."""
    lsb = 2.0 ** -15
    assert F._epi(0.99, (5, 7), 16, True) == (1, 0.99, 2, 5, 7, lsb)
    assert F._epi(None, (5, 2 ** 32 + 3), 24, False)[3:5] == (5, 3)
    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    assert F._counter_args(None, 0, x) == (None, 0)
    c = torch.tensor([9], dtype=torch.int32)
    assert F._counter_args(c, 2 ** 32 + 4, x) == (c.data_ptr(), 4)
    with pytest.raises(ValueError, match="counter"):
        F._counter_args(torch.tensor([9]), 4, x)
    for name in ("afp_fir_td_pair", "afp_fir_td_ps_pair"):
        assert _build._SIGNATURES[name][-4:] == (
            _build._I, _build._P, _build._U, _build._P)

    g = torch.Generator().manual_seed(1)
    h = torch.randn(33, generator=g)
    xh, xl = F.split_bf16(torch.randn(4, 256, generator=g) * 0.2)
    th, tl = F.split_bf16(torch.randn(4, 128, generator=g) * 0.2)
    epi = dict(out_clip=0.5, dither_bits=16, dither_tpdf=True)
    want, wh, wl = F.fir_td_mxu_pair_to_ring(
        xh, xl, th, tl, h, 1, torch.zeros(2, 4, 256), dither_key=(3, 12),
        **epi)
    c = torch.tensor([10], dtype=torch.int32)
    hold = (torch.empty_like(th), torch.empty_like(tl))
    got, gh, gl = F.fir_td_mxu_pair_to_ring(
        xh, xl, th, tl, h, 1, torch.zeros(2, 4, 256), dither_key=(3, 2),
        counter=c, counter_add=4, tail_out=hold, **epi)
    assert torch.equal(got, want) and int(c) == 14
    assert gh is hold[0] and torch.equal(gh, wh) and torch.equal(gl, wl)


@pytest.mark.parametrize("form", FORMS)
def test_replayed_chunks_equal_the_staged_steps(form, replayed):
    """Three laps of a 16-slot ring (the dither counter past the first lap)
    and a short final chunk, each full chunk replayed from the third lap
    on: served ≡ staged, outputs, pair tail, gain carry and counters."""
    srv, served, want, st = laps(form, "cpu")
    assert np.array_equal(served, want)
    same_state(srv.state, st)
    g = srv._graphs
    assert g.captures == 4 and g.graphed == 2 * 16
    assert int(g._counter) == st.step and g._at == st.step


@pytest.mark.parametrize("form", ("shared", "per_stream"))
def test_swaps_land_at_the_next_chunk(form, replayed):
    """A gain update, a new bank and a new AGC target between chunks: each
    next chunk equals the staged steps under the new params; the gains and
    the bank take no new capture, the AGC scalar drops the graphs."""
    pipe, params = make(form, "cpu")
    xs = blocks(pipe, 64, seed=21)
    srv = RingServer(pipe, params, slots=16, chunk=4, max_inflight=2, seed=4)
    got = list(srv.stream(iter(xs[:32])))
    banks = [params] * 32
    g = srv._graphs
    assert g.captures == 4

    rng = np.random.default_rng(8)
    gains = (rng.integers(0, 41, (B, 9)) / 10.0 if form == "per_stream"
             else rng.uniform(0.0, 2.0, 9)).astype(np.float32)
    srv.set_eq_gains(gains)
    got += list(srv.stream(iter(xs[32:40])))
    banks += [srv.params] * 8
    other = pipe.device_params(PipelineParams.design(
        dataclasses.replace(pipe.cfg, cutoff=6000.0)))
    if form == "per_stream":
        other = batch.with_per_stream_gains(pipe, other, gains)
    srv.swap_params(other)
    got += list(srv.stream(iter(xs[40:48])))
    banks += [other] * 8
    assert g.captures == 4
    srv.swap_params(other._replace(agc_target=torch.tensor(0.25)))
    for a in (48, 56):  # the chunks at slots 0 and 4: seen, then captured
        got += list(srv.stream(iter(xs[a:a + 8])))
    banks += [srv.params] * 16
    assert g.captures == 6

    st, want = staged(pipe, banks, xs, pipe.init_state(seed=4))
    assert np.array_equal(np.stack(got), want)
    same_state(srv.state, st)


@pytest.mark.parametrize("form", ("shared", "per_stream"))
def test_a_restored_state_is_copied_in(form, replayed):
    """A state that is not the cache's (restored, at a block counter just
    below 2^32) is copied in before the chunk runs, and the counter filled:
    the chunks then equal the eager ring from that state, across the
    counter's wrap."""
    pipe, params = make(form, "cpu")
    ring = torch.as_tensor(blocks(pipe, 8, seed=3))
    graphs = RingGraphs()
    out = torch.zeros(ring.shape, dtype=pipe.out_dtype)
    st = pipe.init_state(seed=6)
    for start in (0, 4, 0, 4, 0):  # seen, captured, replayed
        st, out = pipe.run_ring(params, st, ring, None, out, 4, start=start,
                                graphs=graphs)
    assert graphs.captures == 2
    rng = np.random.default_rng(4)
    tail = rng.standard_normal((B, pipe._k_pad)).astype(np.float32) * 0.1
    gain = rng.uniform(0.5, 3.0, B).astype(np.float32)
    restored = pipe.state_from_numpy(tail, 6, 2 ** 32 - 6, agc_gain=gain)
    want_out = out.clone()
    want = restored
    for start in (4, 0, 4):
        st_in = want
        want, want_out = pipe.run_ring(params, st_in, ring, None, want_out, 4,
                                       start=start)
    st = restored
    for start in (4, 0, 4):
        st, out = pipe.run_ring(params, st, ring, None, out, 4, start=start,
                                graphs=graphs)
    assert torch.equal(out, want_out)
    same_state(st, want)
    assert graphs.captures == 2 and int(graphs._counter) == 6


def test_the_server_state_is_a_snapshot(replayed):
    """`RingServer.state` hands out copies: later chunks, which rewrite the
    cache's buffers in place, leave a state taken earlier as it was."""
    pipe, params = make("shared", "cpu")
    srv = RingServer(pipe, params, slots=16, chunk=4, max_inflight=2, seed=1)
    list(srv.stream(iter(blocks(pipe, 32))))
    s = srv.state
    kept = (s.conv_tail[0].clone(), s.conv_tail[1].clone(), s.agc_gain.clone())
    assert s.conv_tail[0] is not srv._state.conv_tail[0]
    assert srv._state.conv_tail[0] is srv._graphs._home[0]
    list(srv.stream(iter(blocks(pipe, 8, seed=2))))
    assert all(torch.equal(a, b)
               for a, b in zip(kept, (*s.conv_tail, s.agc_gain)))
    assert not torch.equal(kept[2], srv.state.agc_gain)


def test_muted_spans_and_counts(traced):
    """Inside `trace.muted` no span opens and no count is added."""
    with trace.span("afp.test.outer", ops=1):
        with trace.muted():
            with trace.span("afp.test.inner"):
                trace.add(ops=5)
        trace.add(ops=2)
    recs = [r for r in trace.records() if r is not None]
    assert [(r[0], r[5]) for r in recs] == [("afp.test.outer", {"ops": 3})]


# ---------------------------------------------------------------- the card


def _profiled(fn):
    """`fn` under `torch.profiler` with the trace records emptied first;
    returns (the records, the names of the device operations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    recs = [r for r in trace.records() if r is not None]
    trace.clear()
    return recs, ops


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_graphs_equal_the_eager_steps_on_the_card(dev, form):
    """The real graphs: three laps of a 16-slot ring and a short final chunk
    served ≡ staged bit for bit (outputs, pair tail, gain carry), the block
    counter on the device equal to the state's, four captures and two laps
    replayed."""
    srv, served, want, st = laps(form, dev)
    assert np.array_equal(served, want)
    same_state(srv.state, st)
    g = srv._graphs
    assert g.captures == 4 and g.graphed == 2 * 16
    assert int(g._counter) == st.step
    print(f"{form}: served == staged over {len(served)} blocks, "
          f"{g.captures} captures, {g.graphed} blocks replayed")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ("shared", "per_stream"))
def test_swaps_and_a_restored_state_on_the_card(dev, form, monkeypatch):
    """The swaps and the restored state of the CPU tests, with real graphs:
    each next chunk ≡ the staged steps, across the counter's wrap."""
    pipe, params = make(form, dev)
    xs = blocks(pipe, 56, seed=21)
    srv = RingServer(pipe, params, slots=16, chunk=4, max_inflight=2, seed=4)
    got = list(srv.stream(iter(xs[:32])))
    banks = [params] * 32
    rng = np.random.default_rng(8)
    gains = (rng.integers(0, 41, (B, 9)) / 10.0 if form == "per_stream"
             else rng.uniform(0.0, 2.0, 9)).astype(np.float32)
    srv.set_eq_gains(gains)
    got += list(srv.stream(iter(xs[32:40])))
    banks += [srv.params] * 8
    if form == "shared":
        srv.retune(dataclasses.replace(pipe.cfg, agc_target_level=0.25))
    else:
        srv.swap_params(srv.params._replace(agc_target=torch.tensor(0.25)))
    for a in (40, 48):  # the chunks at slots 0 and 4: seen, then captured
        got += list(srv.stream(iter(xs[a:a + 8])))
    banks += [srv.params] * 16
    assert srv._graphs.captures == 6
    ref, _ = make(form, dev)
    st, want = staged(ref, banks, xs, ref.init_state(seed=4))
    assert np.array_equal(np.stack(got), want)
    same_state(srv.state, st)

    tail = rng.standard_normal((B, pipe._k_pad)).astype(np.float32) * 0.1
    gain = rng.uniform(0.5, 3.0, B).astype(np.float32)
    restored = pipe.state_from_numpy(tail, 6, 2 ** 32 - 6, agc_gain=gain)
    ring = torch.as_tensor(xs[:16], device=dev)
    out = torch.zeros(ring.shape, dtype=pipe.out_dtype, device=dev)
    graphs = RingGraphs()
    st = pipe.init_state(seed=6)
    for start in (0, 4, 0, 4):  # seen, then captured
        st, out = pipe.run_ring(srv.params, st, ring, None, out, 4,
                                start=start, graphs=graphs)
    want_st, want_out = restored, out.clone()
    st = restored
    for start in (4, 0, 4):
        want_st, want_out = pipe.run_ring(srv.params, want_st, ring, None,
                                          want_out, 4, start=start)
        st, out = pipe.run_ring(srv.params, st, ring, None, out, 4,
                                start=start, graphs=graphs)
    assert torch.equal(out, want_out) and graphs.captures == 2
    same_state(st, want_st)
    assert int(graphs._counter) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("form", ("shared", "per_stream", "one_kernel"))
def test_replayed_ops_equal_the_profilers(dev, form):
    """A warmed server under `torch.profiler`: every chunk replayed; the
    ``ops`` counted equal the trace's device operations one for one, a
    replayed chunk's equal an eager chunk's, and under per-stream gains
    each block has its ``afp.pipe.eq_mix`` span with the eager counts."""
    pipe, params = make(form, dev)
    xs = list(blocks(pipe, 16))
    eager = RingServer(pipe, params, slots=16, chunk=4, max_inflight=2, seed=5)
    eager._graphs = None
    list(eager.stream(iter(xs)))
    e_recs, e_ops = _profiled(lambda: list(eager.stream(iter(xs))))
    srv = RingServer(pipe, params, slots=16, chunk=4, max_inflight=2, seed=5)
    for _ in range(2):
        list(srv.stream(iter(xs)))
    recs, ops = _profiled(lambda: list(srv.stream(iter(xs))))
    rings = [r[5] for r in recs if r[0] == "afp.pipe.run_ring"]
    e_rings = [r[5] for r in e_recs if r[0] == "afp.pipe.run_ring"]
    counted = sum(r[5].get("ops", 0) for r in recs)
    print(f"{form}: {counted} ops counted, {len(ops)} in the trace; "
          f"replayed {rings[:2]}, eager {e_rings[:2]}")
    assert counted == len(ops)
    assert all(r.get("graphed") == 4 and "captures" not in r for r in rings)
    taps = 2 if form != "per_stream" else 0  # eager builds them each step
    assert [r["ops"] for r in rings] == [r["ops"] - 4 * taps for r in e_rings]
    mixes = [r[5] for r in recs if r[0] == "afp.pipe.eq_mix"]
    e_mixes = [r[5] for r in e_recs if r[0] == "afp.pipe.eq_mix"]
    assert mixes == e_mixes and len(mixes) == (16 if form == "per_stream"
                                               else 0)
