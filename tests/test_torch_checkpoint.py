"""Checkpoints of the port on the CPU: its own layout restores a stream bit
for bit with dither on (the Philox key is the state's ``(seed, step)``),
in every tail form; and `afp_tpu`'s v1/v2 ``.npz`` restore the conv tail
(f32, the bf16 pair, raw int16), the AGC gain, the parameters and the
framer residuals bit for bit; with the multirate slice also the ASRC
frontend mid-buffer (its accumulators, resampler history and queued
blocks) and the compat ASRC's and the literal chain's resampler
histories, in both layouts.  The JAX PRNG key has no Philox
counterpart, so a restore across packages re-keys the dither from the
checkpoint's seed at step 0: after it the two packages are compared with
dither off, within the conv class.  Each test states its bound and prints
the measured value."""
import json

import numpy as np
import pytest
import torch

from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.engine import StreamEngine as JEngine
from afp_tpu.engine.checkpoint import save_checkpoint as jsave
from afp_tpu_torch.engine import StreamConfig, StreamEngine
from afp_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint

#: the port's conv against `afp_tpu`'s: the bf16×3 accumulation-order
#: class; with the AGC in front, the AGC chain's class (K5's summation
#: order and the recurrence's near-tie branch, as
#: `tests/test_torch_agc_pipeline.py:CHAIN_DB` holds it)
TD_DB, AGC_DB = -110.0, -100.0

BASE = dict(samplerate=8000, blocksize=256, upsample_factor=2, numtaps=33,
            batch=4, cutoff=2000.0, downsample_mode="decimate",
            output_clip=None, conv_strategy="td_mxu")
AGC = dict(agc_enabled=True, agc_mode="exact", agc_window_size=64,
           agc_carry=True, output_clip=0.99)
#: one configuration per tail form (and the 'fft' strategy with EQ)
FORMS = {
    "f32": {},
    "pair-agc": AGC,
    "pcm16-int16-tail": dict(ingest="pcm16", emit="pcm16"),
    "fft-eq": dict(conv_strategy="fft", eq_enabled=True, output_clip=0.99),
}


def err_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    e = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
    return 20 * np.log10(max(e, 1e-30))


def signal(cfg, n: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = (cfg.get("batch", BASE["batch"]), n)
    if cfg.get("ingest") == "pcm16":
        return (rng.standard_normal(shape) * 6000).astype(np.int16)
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


def chunks(x, sizes):
    i = 0
    for s in sizes:
        yield x[:, i:i + s]
        i += s


@pytest.mark.parametrize("form", list(FORMS))
def test_port_checkpoint_resumes_bit_for_bit_dither_on(tmp_path, form):
    """Stream ragged chunks, checkpoint mid-block (framer residuals in
    flight), restore, stream on: the resumed output equals the
    uninterrupted one bit for bit, TPDF dither on, in the tail's own form."""
    over = FORMS[form]
    cfg = StreamConfig(**{**BASE, **over, "dither_kind": "tpdf"})
    x = signal(over, 6 * 256, seed=1)
    head, tail = x[:, :700], x[:, 700:]
    eng = StreamEngine(cfg, device="cpu", seed=7)
    for c in chunks(head, (300, 400)):
        eng.process_frames(c)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, eng)
    resumed = load_checkpoint(path, device="cpu")
    assert resumed._in_framer.available() == 700 % 256
    assert resumed.state.step == eng.state.step == 2
    want = [eng.process_frames(c) for c in chunks(tail, (5, 500, 331))]
    got = [resumed.process_frames(c) for c in chunks(tail, (5, 500, 331))]
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))
    assert resumed.cfg == eng.cfg and resumed._pipe_kw == eng._pipe_kw


def test_port_checkpoint_keeps_live_params(tmp_path):
    """The parameter bank rides the checkpoint as it is live: a gain update
    after the design survives the restore."""
    cfg = StreamConfig(**{**BASE, "eq_enabled": True, "dither_kind": "off"})
    eng = StreamEngine(cfg, device="cpu")
    eng.set_eq_gains(np.linspace(0.5, 2.0, len(cfg.eq_bands)))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, eng)
    resumed = load_checkpoint(path, device="cpu")
    for name in eng.params._fields:
        a, b = getattr(eng.params, name), getattr(resumed.params, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), name
    x = signal({}, 256, seed=2)
    np.testing.assert_array_equal(eng.process_block(x),
                                  resumed.process_block(x))


#: `afp_tpu` checkpoints: its f32 tail, its bf16 pair tail (the conv-pair
#: AGC route, forced on the CPU; it needs a batch of 8 × 128-stream
#: tiles), its raw int16 tail, and a v1 file
REFERENCE = {
    "v2-f32": ({}, False),
    "v2-pair": ({**AGC, "batch": 1024}, True),
    "v2-int16": (dict(ingest="pcm16", emit="pcm16"), False),
    "v1-f32": ({}, False),
}


@pytest.mark.parametrize("case", list(REFERENCE))
def test_reference_checkpoint_restores(tmp_path, monkeypatch, case):
    """An `afp_tpu` engine streams ragged chunks and saves its v2 (or v1)
    checkpoint; the port restores the tail, the AGC gain, the parameters
    and the framer residuals bit for bit, re-keys the dither at (seed, 0),
    and the two streams go on within the conv class (dither off)."""
    over, pair = REFERENCE[case]
    if pair:
        monkeypatch.setenv("AFP_AGC_FUSED_FORCE", "1")
    kw = {**BASE, **over, "dither_kind": "off"}
    jeng = JEngine(JConfig(**kw), seed=3)
    assert isinstance(jeng.state.conv_tail, tuple) == pair
    x = signal(over, 4 * 256, seed=4)
    for c in chunks(x[:, :600], (250, 350)):
        jeng.process_frames(c)
    path = str(tmp_path / "ref.npz")
    jsave(path, jeng)
    if case.startswith("v1"):  # v1: the same leaves, no v2 features
        with np.load(path) as z:
            arrays = dict(z)
        meta = json.loads(bytes(arrays["meta_json"]).decode())
        assert not meta["conv_pair"] and not meta["bf16_leaves"]
        meta["version"] = 1
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        np.savez(path, **arrays)
    eng = load_checkpoint(path, device="cpu")
    st, jst = eng.state, jeng.state
    assert (st.seed, st.step) == (3, 0)
    if pair:
        for ours, ref in zip(st.conv_tail, jst.conv_tail):
            ref = np.asarray(ref).view(np.uint16)
            np.testing.assert_array_equal(
                ours.view(torch.int16).numpy().view(np.uint16), ref)
    else:
        ref = np.asarray(jst.conv_tail)
        ours = st.conv_tail.numpy()
        assert ours.dtype == ref.dtype
        n = ref.shape[1]
        np.testing.assert_array_equal(ours[:, -n:], ref)
        assert not np.any(ours[:, :-n])  # the left pad meets zero taps
    if over.get("agc_enabled"):
        np.testing.assert_array_equal(st.agc_gain.numpy(),
                                      np.asarray(jst.agc_gain))
    np.testing.assert_array_equal(eng.params.H_main.numpy(),
                                  np.asarray(jeng.params.H_main))
    np.testing.assert_array_equal(eng.params.casc_main.numpy(),
                                  np.asarray(jeng.params.casc_main))
    np.testing.assert_array_equal(eng._in_framer.get_state(),
                                  jeng._in_framer.get_state())
    np.testing.assert_array_equal(eng._out_framer.get_state(),
                                  jeng._out_framer.get_state())
    got = eng.process_frames(x[:, 600:])
    ref = np.asarray(jeng.process_frames(x[:, 600:]))
    if got.dtype == np.int16:
        lsb = np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()
        print(f"{case}: resumed int16 vs afp_tpu {lsb} LSB (bound 1)")
        assert lsb <= 1
    else:
        bound = AGC_DB if over.get("agc_enabled") else TD_DB
        db = err_db(got, ref)
        print(f"{case}: resumed vs afp_tpu {db:.1f} dB (bound {bound})")
        assert db <= bound


def test_unknown_versions_refused(tmp_path):
    eng = StreamEngine(StreamConfig(**BASE), device="cpu")
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, eng)
    with np.load(path) as z:
        arrays = dict(z)
    for fmt, version in (("afp_tpu_torch", 3), (None, 3)):
        meta = json.loads(bytes(arrays["meta_json"]).decode())
        meta["version"] = version
        if fmt is None:
            del meta["format"]
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        np.savez(path, **arrays)
        with pytest.raises(ValueError, match="unsupported"):
            load_checkpoint(path, device="cpu")


#: the multirate state: the exact frontend (48 → 44.1 kHz), the compat
#: ASRC's streaming resampler (88.2 → 44.1 kHz) and the literal chain's
#: up and down resamplers ('fft' strategy)
MULTIRATE = {
    "frontend": dict(samplerate=44100, source_samplerate=48000,
                     conv_strategy="fft"),
    "frontend-agc": dict(samplerate=44100, source_samplerate=48000,
                         conv_strategy="fft", **AGC),
    "compat": dict(samplerate=44100, source_samplerate=88200,
                   asrc_mode="compat", conv_strategy="fft"),
    "literal": dict(samplerate=44100, fuse_rate_conversion=False,
                    downsample_mode="resample", conv_strategy="fft"),
}


def feed(eng, x, sizes):
    """Push ragged source chunks through the engine's own surface: the
    frontend under exact ASRC, else the framer."""
    outs = []
    for c in chunks(x, sizes):
        if eng._asrc_frontend is not None:
            outs += eng.drain_source_blocks(c)
        else:
            outs.append(eng.process_frames(c))
    return np.concatenate(outs, 1) if outs else np.zeros((x.shape[0], 0))


@pytest.mark.parametrize("case", list(MULTIRATE))
def test_port_checkpoint_multirate_resumes_bit_for_bit(tmp_path, case):
    """A checkpoint taken with the frontend holding data (a residual
    super-block, converted samples short of a block, and queued blocks)
    or with resampler histories in flight resumes ≡ the uninterrupted
    stream, bit for bit, TPDF dither on."""
    cfg = StreamConfig(**{**BASE, **MULTIRATE[case], "dither_kind": "tpdf"})
    x = signal({}, 30 * 256, seed=11)
    eng = StreamEngine(cfg, device="cpu", seed=5)
    feed(eng, x[:, :5000], (1000, 4000))
    if case.startswith("frontend"):
        front = eng._asrc_frontend
        assert front._in.shape[1] and front.available()
        eng._asrc_outq.append(np.full((4, 256), 0.25, np.float32))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, eng)
    resumed = load_checkpoint(path, device="cpu")
    st = resumed.state
    for r in ("asrc", "up", "down"):
        a, b = getattr(eng.state, r), getattr(st, r)
        assert (a is None) == (b is None) and (a is None or torch.equal(a.hist, b.hist))
    if case.startswith("frontend"):
        for k, v in eng._asrc_frontend.get_state().items():
            np.testing.assert_array_equal(resumed._asrc_frontend.get_state()[k], v)
        assert len(resumed._asrc_outq) == 1
    want = feed(eng, x[:, 5000:], (7, 1500, 1100))
    got = feed(resumed, x[:, 5000:], (7, 1500, 1100))
    assert want.shape[1] > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", list(MULTIRATE))
def test_reference_checkpoint_multirate_restores(tmp_path, case):
    """`afp_tpu`'s checkpoint of the same multirate stream: the port
    restores the conv tail, the AGC gain, the resampler histories (each
    `PolyResampler` flattened to (hist, h)) and the frontend's arrays bit
    for bit, and the two streams go on within the 'fft' and AGC chain
    contract (dither off)."""
    kw = {**BASE, **MULTIRATE[case], "dither_kind": "off"}
    jeng = JEngine(JConfig(**kw), seed=3)
    x = signal({}, 60 * 256, seed=12)
    feed(jeng, x[:, :5000], (1000, 4000))
    path = str(tmp_path / "ref.npz")
    jsave(path, jeng)
    eng = load_checkpoint(path, device="cpu")
    st, jst = eng.state, jeng.state
    n = np.asarray(jst.conv_tail).shape[1]
    np.testing.assert_array_equal(st.conv_tail.numpy()[:, -n:],
                                  np.asarray(jst.conv_tail))
    for r in ("asrc", "up", "down"):
        ours, ref = getattr(st, r), getattr(jst, r)
        assert (ours is None) == (ref is None), r
        if ours is not None:
            np.testing.assert_array_equal(ours.hist.numpy(), np.asarray(ref.hist))
            np.testing.assert_array_equal(ours.h.numpy(), np.asarray(ref.h))
    if case.startswith("frontend"):
        held = jeng._asrc_frontend.get_state()
        assert held["asrc_in"].shape[1] and held["asrc_out"].shape[1]  # mid-buffer
        for k, v in held.items():
            np.testing.assert_array_equal(eng._asrc_frontend.get_state()[k], v)
    if kw.get("agc_enabled"):
        np.testing.assert_array_equal(st.agc_gain.numpy(), np.asarray(jst.agc_gain))
    got = feed(eng, x[:, 5000:], (3000, 7360))
    ref = np.asarray(feed(jeng, x[:, 5000:], (3000, 7360)))
    db = err_db(got, ref)
    print(f"{case}: resumed vs afp_tpu {db:.1f} dB (bound {AGC_DB})")
    assert got.shape == ref.shape and db <= AGC_DB


def test_version_1_port_checkpoint_loads(tmp_path):
    """A file of the port's first layout (no resamplers, no frontend)
    still loads."""
    eng = StreamEngine(StreamConfig(**{**BASE, "dither_kind": "tpdf"}),
                       device="cpu", seed=2)
    x = signal({}, 4 * 256, seed=13)
    eng.process_block(x[:, :256])
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, eng)
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays["meta_json"]).decode())
    meta["version"] = 1
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    resumed = load_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(resumed.process_block(x[:, 256:512]),
                                  eng.process_block(x[:, 256:512]))
