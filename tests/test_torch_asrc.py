"""The port's ASRC on the CPU: the pipeline's device ASRC
(``asrc_mode='compat'``, streaming and stateless submodes), the exact host
frontend (`afp_tpu_torch/runtime/asrc.py`) and the engine and dispatcher
surfaces over it, against `afp_tpu` on the same seeded numpy inputs,
dither off.

Bounds: ≤ −100 dB against `afp_tpu` (two f32 FFT libraries; the AGC chain's
contract, `tests/test_torch_agc_pipeline.py`); < −90 dB against the
zero-phase oracle; inside the port every chunking of the frontend's pushes
gives the same bits, and a lockstep stream ≡ `process_signal`, bit for
bit.  Each test prints what it measured."""
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.engine import StreamEngine as JEngine
from afp_tpu.runtime.asrc import AsrcFrontend as JFrontend
from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  StreamEngine)
from afp_tpu_torch.ops.resample import resample_poly
from afp_tpu_torch.runtime import AsrcFrontend, SimulatedStream

REF_DB, ORACLE_DB = -100.0, -90.0

#: small engine shapes: one-rate chain (upsample 1) so the ASRC is the
#: only resampler, 'fast' tier kernels
BASE = dict(samplerate=44100, blocksize=512, upsample_factor=1, numtaps=65,
            batch=2, cutoff=11000.0, eq_enabled=False, resample_quality="fast",
            dither_kind="off", output_clip=None)


def err_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def sig(B, T, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, T)) * 0.3).astype(np.float32)


def engine(**over):
    return StreamEngine(StreamConfig(**{**BASE, **over}), device="cpu")


# ---------------------------------------------------------------- compat

@pytest.mark.parametrize("source,form", [
    (48000, "fft"),          # stateless: 512 is no multiple of 160
    (88200, "fft"),          # streaming: down 2
    (22050, "fft"),          # streaming up-conversion: up 2, down 1
    (48000, "td-agc"),       # stateless into the AGC pair chain (K5 → K6 → K8)
    (88200, "td"),           # streaming into K1
])
def test_compat_asrc_matches_reference(source, form):
    """asrc_mode='compat' in both submodes ≡ `afp_tpu`'s (≤ −100 dB), each
    block padded or trimmed to blocksize: at 88.2 → 44.1 kHz the second
    half of every block's input is zeros (the reference's semantics)."""
    kw = dict(BASE, source_samplerate=source, asrc_mode="compat",
              upsample_factor=2, batch=4)
    if form != "fft":
        kw.update(conv_strategy="td_mxu")
    if form == "td-agc":
        kw.update(agc_enabled=True, agc_window_size=128, output_clip=0.99)
    x = sig(4, 4 * 512, seed=source)
    p = Pipeline(StreamConfig(**kw), "cpu")
    params = p.device_params(PipelineParams.design(p.cfg))
    st = p.init_state()
    assert p._asrc_device and p._asrc_stateless == (source == 48000)
    assert (st.asrc is None) == (source == 48000)
    assert not p.supports_ring_step and not p.supports_fold
    _, ours = p.process_signal(params, st, torch.from_numpy(x))
    jp = JPipeline(JConfig(**kw))
    _, ref = jp.process_signal(jp.device_params(JParams.design(jp.cfg)),
                               jp.init_state(0), jnp.asarray(x))
    e = err_db(ours.numpy(), np.asarray(ref))
    print(f"compat ASRC {source} Hz, {form}: {e:.1f} dB vs afp_tpu")
    assert ours.shape == x.shape and e <= REF_DB


def test_compat_asrc_pads_half_block():
    """The compat stage itself: at 88.2 → 44.1 kHz a block converts to L/2
    samples, padded with L/2 zeros; at 22.05 → 44.1 kHz to 2L, trimmed."""
    for source, live in ((88200, 256), (22050, 512)):
        p = Pipeline(StreamConfig(**dict(BASE, source_samplerate=source,
                                         asrc_mode="compat")), "cpu")
        x, st = torch.from_numpy(sig(2, 512, seed=1)), p.init_state()
        y, asrc = p._asrc(x, st.asrc)
        assert y.shape == (2, 512) and torch.all(y[:, live:] == 0)
        assert asrc.hist.shape == st.asrc.hist.shape


# ---------------------------------------------------------------- frontend

def chunked(front, x, sizes):
    i = 0
    for n in sizes:
        front.push(x[:, i:i + n])
        i += n
    front.push(x[:, i:])
    return front.flush()


@pytest.mark.parametrize("source,engine_rate", [(48000, 44100), (44100, 48000),
                                                (88200, 44100)])
def test_frontend_chunking_invariance_and_reference(source, engine_rate):
    """Any chunking of the pushes ≡ any other, bit for bit; ≡ `afp_tpu`'s
    frontend (≤ −100 dB); ≡ the delayed zero-phase resample_poly (< −90 dB)."""
    x = sig(2, 30000, seed=2)
    rng = np.random.default_rng(3)
    outs = [chunked(AsrcFrontend(source, engine_rate, batch=2, device="cpu"), x, sizes)
            for sizes in ([30000], [1] * 5 + [4999, 7], list(rng.integers(1, 5000, 9)))]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    jf = JFrontend(source, engine_rate, batch=2)
    ref = chunked(jf, x, [30000])
    front = AsrcFrontend(source, engine_rate, batch=2, device="cpu")
    assert (front.l_dev, front.delay_outputs) == (jf.l_dev, jf.delay_outputs)
    d = front.delay_outputs
    gold = resample_poly(torch.from_numpy(x).double(), engine_rate, source).numpy()
    n = min(gold.shape[1], outs[0].shape[1] - d)
    e_ref, e_gold = err_db(outs[0], ref), err_db(outs[0][:, d:d + n], gold[:, :n])
    print(f"frontend {source} -> {engine_rate}: {e_ref:.1f} dB vs afp_tpu, "
          f"{e_gold:.1f} dB vs zero-phase resample_poly")
    assert outs[0].shape == ref.shape and e_ref <= REF_DB and e_gold < ORACLE_DB


def test_frontend_default_device_is_the_card():
    """`AsrcFrontend(source, engine, batch)`, the reference's call, runs on
    the card; without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsrcFrontend(48000, 44100, 2)
    assert AsrcFrontend(48000, 44100, 2, device="cpu").device.type == "cpu"


def test_frontend_pull_state_and_refusals():
    front = AsrcFrontend(48000, 44100, batch=2, device="cpu")
    with pytest.raises(ValueError):
        AsrcFrontend(48000, 44100, l_dev=100, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        front.push(np.zeros((3, 10), np.float32))
    front.push(sig(1, 5000, seed=4)[0])  # 1-D broadcasts to the batch
    assert front.available() == 3822 and front.pull(4000) is None
    assert front.pull(1000).shape == (2, 1000) and front.available() == 2822
    snap = front.get_state()
    other = AsrcFrontend(48000, 44100, batch=2, device="cpu")
    other.set_state(snap)
    nxt = sig(2, 9000, seed=5)
    front.push(nxt)
    other.push(nxt)
    np.testing.assert_array_equal(front.pull(5000), other.pull(5000))
    with pytest.raises(ValueError, match="asrc_hist"):
        other.set_state({**snap, "asrc_hist": np.zeros((2, 3))})


# ---------------------------------------------------------------- engine

def test_engine_chunking_invariance_and_reference():
    """StreamEngine under asrc_mode='exact': process_signal ≡ any chunking
    through process_source_block, bit for bit, ≡ `afp_tpu`'s engine
    (≤ −100 dB)."""
    kw = dict(BASE, source_samplerate=48000, blocksize=1024)
    x = sig(2, 24000, seed=6)
    e1 = engine(**kw)
    out1 = e1.process_signal(x)
    e2 = engine(**kw)
    outs, i, rng = [], 0, np.random.default_rng(7)
    while i < x.shape[1]:
        n = int(rng.integers(100, 4000))
        y = e2.process_source_block(x[:, i:i + n])
        i += n
        if y is not None:
            outs.append(y)
    # the blocks completed beyond one a call wait in the queue
    outs += e2.drain_source_blocks(np.zeros((2, 0), np.float32))
    out2 = np.concatenate(outs, 1)
    n = min(out1.shape[1], out2.shape[1])
    assert n >= 16 * 1024
    np.testing.assert_array_equal(out1[:, :n], out2[:, :n])
    ref = JEngine(JConfig(**kw)).process_signal(x)
    e = err_db(out1, ref)
    print(f"engine exact ASRC: {e:.1f} dB vs afp_tpu")
    assert out1.shape == ref.shape and e <= REF_DB
    with pytest.raises(ValueError, match="process_source_block"):
        e1.process_frames(x[:, :100])


def test_engine_blends_while_buffering_and_never_raises():
    """process_block routes through the frontend: the underrun blend while
    it buffers; bad shapes (1-D, another batch, odd lengths) never raise."""
    eng = engine(source_samplerate=48000)
    out = eng.process_block(sig(2, 64, seed=8))
    assert out.shape == (2, 512) and eng.metrics.underruns == 1
    for blk in (sig(1, 300, seed=9)[0], sig(5, 700, seed=10), sig(1, 4200, seed=11)):
        assert eng.process_block(blk).shape == (2, 512)
    rest = eng.drain_source_blocks(np.zeros((2, 0), np.float32))
    assert all(b.shape == (2, 512) for b in rest) and not eng._asrc_outq


def test_engine_upconversion_bounded():
    """Engine rate above the source rate completes more engine blocks than
    calls: every one drains through the queue and the frontend stays
    bounded."""
    eng = engine(samplerate=48000, source_samplerate=44100)
    blk = sig(2, 512, seed=12)
    got = 0
    for _ in range(60):
        got += len(eng.drain_source_blocks(blk))
        assert eng._asrc_frontend._out.shape[1] < 512 * 4
    assert got > 60 and eng.metrics.drops == 0
    for _ in range(60):
        assert eng.process_block(blk).shape == (2, 512)
    assert len(eng._asrc_outq) <= eng._asrc_outq.maxlen


def test_full_queue_drops_newest():
    """A full output queue drops the INCOMING block and counts it (the
    reference's put_nowait): the queue keeps the oldest blocks."""
    eng = engine(source_samplerate=48000)
    eng._asrc_outq = deque(maxlen=2)
    x = sig(2, 2 * eng._asrc_frontend.l_dev, seed=13)
    eng._asrc_drain(x)
    assert eng.metrics.drops >= 1 and len(eng._asrc_outq) == 2
    other = engine(source_samplerate=48000)
    other._asrc_drain(x)
    np.testing.assert_array_equal(eng._asrc_outq[0], other._asrc_outq[0])
    np.testing.assert_array_equal(eng._asrc_outq[1], other._asrc_outq[1])


def test_lockstep_asrc_stream_equals_process_signal():
    """SimulatedStream in lockstep over the exact frontend drives the engine
    synchronously (no worker thread): every emitted block is a whole
    converted block, none fabricated, and the capture ≡ process_signal's
    prefix, bit for bit (the AGC chain, dither on)."""
    kw = dict(BASE, source_samplerate=48000, agc_enabled=True,
              agc_window_size=128, output_clip=0.99, dither_kind="tpdf")
    x = sig(2, 20 * 512, seed=14)
    eng = engine(**kw)
    cap = []
    snap = SimulatedStream(eng, lambda i: x[:, i * 512:(i + 1) * 512],
                           sink=cap.append, realtime=False).run(n_blocks=20)
    y = np.concatenate(cap, 1)
    assert snap["underruns"] == 0 and snap["fallback_silence"] == 0
    assert snap["in_ring"]["pushes"] == 0  # no ring handoff in lockstep ASRC
    full = engine(**kw).process_signal(x)
    print(f"lockstep ASRC stream: {y.shape[1]} of {full.shape[1]} samples")
    assert 0 < y.shape[1] <= full.shape[1] and y.shape[1] % 512 == 0
    np.testing.assert_array_equal(y, full[:, :y.shape[1]])


def test_process_frames_emits_upsampled_rate():
    """process_frames under upsampled output: n samples in → U·n out, for
    any chunking, the stream one block late, ≡ step by step."""
    eng = engine(upsample_factor=2, output_rate="upsampled")
    x = sig(2, 4 * 512, seed=15)
    outs = [eng.process_frames(x[:, a:b]) for a, b in
            ((0, 100), (100, 1500), (1500, 2048))]
    assert [o.shape[1] for o in outs] == [200, 2800, 1096]
    y = np.concatenate(outs, 1)
    ref = engine(upsample_factor=2, output_rate="upsampled")
    blocks = [ref.process_block(x[:, i * 512:(i + 1) * 512]) for i in range(3)]
    assert all(b.shape == (2, 1024) for b in blocks)
    np.testing.assert_array_equal(y[:, :1024], 0)
    np.testing.assert_array_equal(y[:, 1024:], np.concatenate(blocks, 1))
