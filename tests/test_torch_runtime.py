"""The port's host runtime against `afp_tpu` on the CPU: WAV I/O and the
block framer bit for bit, the native ring and pacer built from
`native/host_ring.cpp` into `build/afp_tpu_torch/` (nothing written under
`native/`), the dispatcher, `FaultInjector` and `SimulatedStream`, the
sound-card bridge against a fake `sounddevice`, and the engine's
`process_frames`, chunked upload and `profile`.  Dither is off wherever
the two packages are compared (the port's Philox dither is not `afp_tpu`'s
threefry).  Each test states its bound and prints the measured value."""
import json
import subprocess
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import afp_tpu.runtime.dispatcher as jdispatch
import afp_tpu.runtime.framer as jframer
import afp_tpu.utils.wavio as jwavio
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.engine import StreamEngine as JEngine
from afp_tpu_torch.engine import StreamConfig, StreamEngine
from afp_tpu_torch.runtime import (AudioStream, BlockDispatcher, BlockFramer,
                                   BlockRing, FaultInjector, Pacer,
                                   SimulatedStream, host)
from afp_tpu_torch.utils import wavio

REPO = Path(__file__).resolve().parents[1]
#: the port's conv against `afp_tpu`'s: the bf16×3 accumulation-order class
TD_DB = -110.0

SMALL = dict(samplerate=8000, blocksize=256, upsample_factor=2, numtaps=33,
             batch=2, cutoff=2000.0, dither_kind="off",
             downsample_mode="decimate", output_clip=None,
             conv_strategy="td_mxu")


def err_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    e = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
    return 20 * np.log10(max(e, 1e-30))


def engine(**over) -> StreamEngine:
    return StreamEngine(StreamConfig(**{**SMALL, **over}), device="cpu")


# ---------------------------------------------------------------- wavio


@pytest.mark.parametrize("form", ["pcm8", "pcm16", "pcm24", "pcm32", "float"])
def test_wavio_bit_exact_against_reference(tmp_path, form):
    """The same float signal written by both packages gives the same file
    bytes, and both read any file to the same array, bit for bit."""
    rng = np.random.default_rng(1)
    x = np.clip(0.5 * rng.standard_normal((2, 999)), -1.2, 1.2).astype(np.float32)
    ours, ref = tmp_path / "ours.wav", tmp_path / "ref.wav"
    if form == "pcm8":  # read only: neither package writes 8-bit
        import wave

        with wave.open(str(ours), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(1)
            w.setframerate(44100)
            w.writeframes(rng.integers(0, 256, 2 * 999, np.uint8).tobytes())
    else:
        kw = (dict(float_format=True) if form == "float"
              else dict(width=int(form[3:]) // 8))
        wavio.write_wav(str(ours), x, 44100, **kw)
        jwavio.write_wav(str(ref), x, 44100, **kw)
        assert ours.read_bytes() == ref.read_bytes()
    a, ra = wavio.read_wav(str(ours))
    b, rb = jwavio.read_wav(str(ours))
    assert ra == rb == 44100 and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_wavio_pcm16_raw_bit_exact(tmp_path):
    """The raw int16 pair: same bytes written, same samples read, and both
    refuse the other's form."""
    rng = np.random.default_rng(2)
    q = (rng.standard_normal((3, 500)) * 9000).astype(np.int16)
    ours, ref = tmp_path / "o.wav", tmp_path / "r.wav"
    wavio.write_wav_pcm16(str(ours), q, 48000)
    jwavio.write_wav_pcm16(str(ref), q, 48000)
    assert ours.read_bytes() == ref.read_bytes()
    y, rate = wavio.read_wav_pcm16(str(ours))
    assert rate == 48000 and y.dtype == np.int16
    np.testing.assert_array_equal(y, jwavio.read_wav_pcm16(str(ours))[0])
    with pytest.raises(ValueError, match="raw int16"):
        wavio.write_wav_pcm16(str(ours), q.astype(np.float32), 48000)
    wavio.write_wav(str(ours), q / 32768.0, 48000, width=3)
    with pytest.raises(ValueError, match="not 16-bit PCM"):
        wavio.read_wav_pcm16(str(ours))


# ---------------------------------------------------------------- framer


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_framer_matches_reference(dtype):
    """Ragged pushes and pulls through both framers give the same slices,
    bit for bit, in the framer's own dtype."""
    rng = np.random.default_rng(3)
    ours, ref = BlockFramer(2, dtype=dtype), jframer.BlockFramer(2, dtype=dtype)
    for n_push, n_pull in [(5, 3), (100, 64), (1, 64), (0, 2), (300, 128),
                           (7, 200), (64, 1)]:
        chunk = (rng.standard_normal((2, n_push)) * 1000).astype(dtype)
        ours.push(chunk)
        ref.push(chunk)
        a, b = ours.pull(n_pull), ref.pull(n_pull)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == dtype
            np.testing.assert_array_equal(a, b)
        assert ours.available() == ref.available()
    np.testing.assert_array_equal(ours.get_state(), ref.get_state())
    if dtype == np.int16:
        with pytest.raises(ValueError, match="carries int16"):
            ours.push(np.zeros((2, 4), np.float32))


# ---------------------------------------------------------------- native


def test_native_ring_and_pacer_built_outside_native():
    """The ring's FIFO, drop-on-full, int16 bit views and stats, and the
    pacer's rate; the library is built into build/afp_tpu_torch/ and the
    tracked native/ tree stays as committed."""
    ring = BlockRing(capacity=2, block_shape=(2, 4), dtype=np.int16)
    a = np.arange(8, dtype=np.int16).reshape(2, 4)
    assert ring.push(a) and ring.push(-a) and not ring.push(a)  # full: drop
    np.testing.assert_array_equal(ring.pop(), a)
    np.testing.assert_array_equal(ring.pop(), -a)
    assert ring.pop() is None and ring.pop(timeout=0.01) is None
    assert ring.stats == dict(pushes=2, pops=2, drops=1, underruns=2)
    with pytest.raises(ValueError, match="carries int16"):
        ring.push(a.astype(np.float32))
    with pytest.raises(ValueError, match="positive"):
        BlockRing(capacity=0)
    pacer = Pacer(0.01)
    t0 = time.monotonic()
    for _ in range(5):
        pacer.wait()
    wall = time.monotonic() - t0
    print(f"5 ticks of 10 ms: {wall * 1e3:.1f} ms")
    assert 0.035 <= wall < 1.0 and pacer.ticks == 5
    lib = host.build()
    assert lib.parent == REPO / "build" / "afp_tpu_torch" and lib.is_file()
    r = subprocess.run(["git", "status", "--porcelain", "--", "native"],
                       cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0 and r.stdout == "", r.stdout


# ---------------------------------------------------------------- dispatcher


def test_fault_injector_matches_reference():
    """The same injected sequence as `afp_tpu`'s: which blocks drop, which
    are poisoned (NaN for floats, a full-scale click for int16)."""
    rng = np.random.default_rng(4)
    for dtype in (np.float32, np.int16):
        ours = FaultInjector(drop_every=3, corrupt_every=4)
        ref = jdispatch.FaultInjector(drop_every=3, corrupt_every=4)
        for _ in range(13):
            blk = (rng.standard_normal((2, 8)) * 100).astype(dtype)
            a, b = ours.apply(blk), ref.apply(blk)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ingest", ["f32", "pcm16"])
def test_lockstep_stream_equals_process_block(ingest):
    """`SimulatedStream(realtime=False)` is 1-in-1-out through the threaded
    dispatcher and the native rings in the transport dtype: its outputs
    equal the engine's own `process_block` sequence bit for bit, and a
    dropped input yields no output block."""
    rng = np.random.default_rng(5)
    n = 6
    if ingest == "pcm16":
        x = (rng.standard_normal((2, n * 256)) * 6000).astype(np.int16)
    else:
        x = (0.3 * rng.standard_normal((2, n * 256))).astype(np.float32)
    blocks = [x[:, i * 256:(i + 1) * 256] for i in range(n)]
    ref_eng = engine(ingest=ingest)
    want = [ref_eng.process_block(b) for b in blocks]
    got = []
    eng = engine(ingest=ingest)
    snap = SimulatedStream(eng, lambda i: blocks[i], sink=got.append,
                           realtime=False).run(n_blocks=n)
    assert snap["blocks"] == n and snap["underruns"] == 0
    assert snap["in_ring"]["drops"] == snap["out_ring"]["drops"] == 0
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    got = []
    snap = SimulatedStream(engine(ingest=ingest), lambda i: blocks[i],
                           sink=got.append, faults=FaultInjector(drop_every=2),
                           realtime=False).run(n_blocks=n)
    assert len(got) == n // 2 and snap["blocks"] == n // 2


def test_paced_stream_runs_at_the_block_rate():
    """The paced mode waits on the native pacer: n blocks take at least
    n−1 block periods; the output ring is primed, so the consumer sees
    silence first and nothing underruns."""
    eng = engine()
    L, sr, n = 256, 8000, 6
    x = (0.2 * np.random.default_rng(6).standard_normal((2, L))).astype(np.float32)
    got = []
    t0 = time.monotonic()
    snap = SimulatedStream(eng, lambda i: x, sink=got.append).run(n_blocks=n)
    wall = time.monotonic() - t0
    print(f"{n} blocks of {L / sr * 1e3:.0f} ms in {wall * 1e3:.0f} ms: {snap}")
    assert wall >= (n - 1) * L / sr * 0.9
    assert len(got) == n and not np.any(got[0])
    assert snap["underruns"] == 0 and "pacer_overruns" in snap


def test_dispatcher_realtime_underrun_blend():
    """A realtime dispatcher with nothing ready blends 0.8·last (int16
    requantized under emit='pcm16')."""
    eng = engine(emit="pcm16")
    d = BlockDispatcher(eng, prime=0)
    assert not np.any(d.fetch()) and eng.metrics.underruns == 1
    d._last_out = np.full((2, 256), 1001, np.int16)
    out = d.fetch()
    assert out.dtype == np.int16 and np.all(out == 801)  # round(800.8)


# ---------------------------------------------------------------- audio


class _FakeStream:
    def __init__(self, **kw):
        self.kw = kw
        self.started = self.stopped = self.closed = False
        self.cpu_load = 0.1

    def start(self):
        self.started = True

    def stop(self):
        self.stopped = True

    def close(self):
        self.closed = True


def _fake_sd():
    sd = types.ModuleType("sounddevice")
    sd.Stream = _FakeStream
    sd.query_devices = lambda: []
    return sd


def test_audio_bridge_with_fake_sounddevice():
    """The duplex contract (`stream_process.py:128-136`): latency 'high',
    the device pair, channels = batch, the transport dtypes; a callback of
    a size other than the block regroups losslessly, and the primed output
    is silence until the worker has processed a block."""
    eng = engine(ingest="pcm16", emit="pcm16")
    bridge = AudioStream(eng, device=(1, 0), sd_module=_fake_sd())
    kw = bridge._stream.kw
    assert kw["latency"] == "high" and kw["device"] == (1, 0)
    assert kw["blocksize"] == 256 and kw["samplerate"] == 8000
    assert kw["channels"] == 2 and kw["dtype"] == ("int16", "int16")
    bridge.start()
    try:
        indata = (np.random.default_rng(7).standard_normal((300, 2)) * 3000
                  ).astype(np.int16)
        outdata = np.empty((300, 2), np.int16)
        bridge._callback(indata, outdata, 300, None, None)
        assert not np.any(outdata)
        deadline = time.time() + 10
        while eng.metrics.blocks_processed < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.metrics.blocks_processed >= 1
        bridge._callback(indata, outdata, 300, None, types.SimpleNamespace(
            output_underflow=True, input_overflow=True))
        assert eng.metrics.underruns >= 1 and eng.metrics.drops >= 1
    finally:
        bridge.stop()
        bridge.close()
    assert bridge._stream.stopped and bridge._stream.closed
    with pytest.raises(RuntimeError, match="sounddevice"):
        import afp_tpu_torch.runtime.audio as audio

        orig = audio._sounddevice
        audio._sounddevice = lambda: None
        try:
            AudioStream(eng)
        finally:
            audio._sounddevice = orig


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("form", ["f32", "pcm16-io"])
def test_process_frames_ragged_chunks(form):
    """`process_frames` at ragged chunk sizes: the port's output is its own
    `process_block` sequence one block late, bit for bit, and `afp_tpu`'s
    `process_frames` on the same chunks within the conv class."""
    rng = np.random.default_rng(8)
    over = dict(ingest="pcm16", emit="pcm16") if form == "pcm16-io" else {}
    n = 5 * 256
    if over:
        x = (rng.standard_normal((2, n)) * 6000).astype(np.int16)
    else:
        x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    chunks, i = [], 0
    for size in (1, 100, 300, 0, 255, 2, 600, 999):
        chunks.append(x[:, i:i + size])
        i += size
    eng, jeng = engine(**over), JEngine(JConfig(**{**SMALL, **over}))
    got = np.concatenate([eng.process_frames(c) for c in chunks], axis=1)
    ref = np.concatenate([np.asarray(jeng.process_frames(c)) for c in chunks],
                         axis=1)
    assert got.shape == (2, n) and got.dtype == (np.int16 if over else np.float32)
    blocks = engine(**over)
    want = np.concatenate([np.zeros((2, 256), got.dtype)] + [
        blocks.process_block(x[:, k * 256:(k + 1) * 256]) for k in range(4)],
        axis=1)
    np.testing.assert_array_equal(got, want)
    if over:
        lsb = np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()
        print(f"process_frames int16 vs afp_tpu: {lsb} LSB (bound 1)")
        assert lsb <= 1
    else:
        db = err_db(got[:, 256:], ref[:, 256:])
        print(f"process_frames vs afp_tpu: {db:.1f} dB (bound {TD_DB})")
        assert db <= TD_DB
    with pytest.raises(ValueError, match="int16"):
        engine(ingest="pcm16").process_frames(np.zeros((2, 8), np.float32))


@pytest.mark.parametrize("agc", [False, True])
def test_chunked_upload_equals_one_shot(monkeypatch, agc):
    """``AFP_STAGE_CHUNK_MB`` splits `process_signal` on whole blocks and
    threads the state: the scan's output and state equal the one-shot
    scan's bit for bit (dither on: one Philox key per block either way)."""
    over = dict(dither_kind="tpdf", agc_enabled=agc, agc_window_size=64,
                output_clip=0.99 if agc else None)
    x = (0.3 * np.random.default_rng(9).standard_normal((2, 11 * 256 + 17))
         ).astype(np.float32)
    one = engine(**over)
    want = one.process_signal(x, fold=False)
    monkeypatch.setenv("AFP_STAGE_CHUNK_MB", str(3 * 2 * 256 * 4 / 2 ** 20))
    chunked = engine(**over)
    assert chunked._stage_chunk_blocks(x) == 3
    got = chunked.process_signal(x, fold=False)
    assert got.shape == (2, 11 * 256)
    np.testing.assert_array_equal(got, want)
    assert chunked.state.step == one.state.step == 11
    tails = [s.conv_tail if agc else (s.conv_tail,)
             for s in (chunked.state, one.state)]
    assert all(torch.equal(a, b) for a, b in zip(*tails))
    if agc:
        assert torch.equal(chunked.state.agc_gain, one.state.agc_gain)


def test_profile_writes_one_chrome_trace(tmp_path):
    """`profile(logdir)` traces the region with `torch.profiler` and
    writes one Chrome trace into `logdir`."""
    eng = engine()
    with eng.profile(str(tmp_path / "trace")):
        eng.process_block(np.zeros((2, 256), np.float32))
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "traceEvents" in json.loads(files[0].read_text())
