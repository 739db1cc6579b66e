"""The plain reference (`perfbench/reference/chain.py`) at tiny sizes:
against a direct float64 literal chain with a per-sample AGC loop, its
Philox against the published known-answer vectors and the program's
noise, its design against the program's, and the program's CPU path
against it (the control in bfloat16 fails where the program passes)."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.harness import check
from perfbench.reference import chain

BENCH = Path(__file__).resolve().parents[1]
C5 = json.loads((BENCH / "configs" / "c5_headline.json").read_text())
C8 = json.loads((BENCH / "configs" / "c8_agc.json").read_text())


def tiny(conf: dict, **kw) -> dict:
    s = dict(conf["stream"])
    s.update(batch=4, **kw)
    return s


def signal(stream, n_blocks, seed, pcm16=False):
    rng = np.random.default_rng(seed)
    B, T = stream["batch"], stream["blocksize"]
    lv = 10 ** rng.uniform(-2, -0.1, size=(n_blocks, B, 1))
    x = (rng.standard_normal((n_blocks, B, T)) * lv).astype(np.float32)
    if pcm16:
        return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    return x


def literal_chain(x: np.ndarray, stream: dict) -> np.ndarray:
    """The chain written out directly over the whole signal [B, N]: the AGC
    block by block with a per-sample loop ('same' boxcar by np.convolve),
    zero-stuffing, the upsampler, EQ and main FIR by np.convolve at the
    upsampled rate, decimation, clip (no dither)."""
    B, N = x.shape
    T, up = stream["blocksize"], stream["upsample_factor"]
    if stream.get("agc_enabled"):
        w = stream["agc_window_size"]
        a_att, a_rel = chain.agc_alphas(w, stream["agc_attack"], stream["agc_release"])
        t, mg = stream["agc_target_level"], stream["agc_max_gain"]
        g = np.ones(B)
        y = np.empty_like(x)
        for b0 in range(0, N, T):
            blk = x[:, b0:b0 + T]
            for r in range(B):
                ms = np.convolve(blk[r] ** 2, np.ones(w) / w, "same")
                d = np.minimum(t / (np.sqrt(ms) + 1e-10), mg)
                gs = np.empty(T)
                gr = g[r]
                for i in range(T):
                    a = a_att if d[i] > gr else a_rel
                    gr = a * d[i] + (1 - a) * gr
                    gs[i] = gr
                gs = np.clip(gs, 0.1, mg)
                g[r] = gs[-1]
                y[r, b0:b0 + T] = np.clip(blk[r] * gs, -0.99, 0.99)
        x = y
    fs = stream["samplerate"] * up
    n = stream["numtaps"]
    main = chain._lowpass(n, stream["cutoff"], fs, chain._periodic_window("hamming", n))
    if stream.get("eq_enabled"):
        main = np.convolve(main, sum(b["gain"] * chain._bandpass(n, b["low"], b["high"], fs)
                                     for b in stream["eq_bands"]))
    h_up = chain._upsampler(up, stream["resample_quality"])
    out = np.empty((B, N))
    for r in range(B):
        z = np.zeros(N * up)
        z[::up] = x[r]
        v = np.convolve(np.convolve(z, h_up)[:N * up], main)[:N * up]
        out[r] = v[::up]
    clip = stream.get("output_clip")
    return out if clip is None else np.clip(out, -clip, clip)


@pytest.mark.parametrize("conf,kw", [(C5, dict(blocksize=512)),
                                     (C8, dict(blocksize=256, agc_window_size=64))],
                         ids=["c5", "c8"])
def test_reference_equals_the_literal_chain(conf, kw):
    stream = tiny(conf, dither_kind="off", **kw)
    nb = 5
    x = signal(stream, nb, 1)
    whole = literal_chain(np.concatenate(list(x), axis=-1).astype(np.float64), stream)
    ref = chain.reference_blocks(lambda k: x[k], np.arange(4), range(nb), stream, 0)
    got = np.concatenate(list(ref), axis=-1)
    assert np.abs(got - whole).max() <= 1e-12 * np.abs(whole).max()


def test_a_block_deep_in_the_stream_needs_only_its_history():
    stream = tiny(C8, blocksize=256, agc_window_size=64)
    x = signal(stream, 9, 2)
    full = chain.reference_blocks(lambda k: x[k], np.arange(4), range(9), stream, 7)
    deep = chain.reference_blocks(lambda k: x[k], np.array([2, 0]), [8, 6], stream, 7)
    assert np.abs(deep - full[[8, 6]][:, [2, 0]]).max() <= 1e-15


def test_philox_known_answers():
    # Random123's kat_vectors for philox4x32-10
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        c = [np.array([v], dtype=np.uint64) for v in ctr]
        got = chain._philox(c[0], c[1], key[0], key[1], c[2], c[3])
        assert tuple(int(w[0]) for w in got) == want


@pytest.mark.parametrize("kind,bits", [("tpdf", 24), ("tpdf", 16), ("rpdf", 24)])
def test_noise_equals_the_programs(kind, bits):
    from afp_tpu_torch.ops.dither import lsb_for_bits, noise

    want = noise((6, 64), (2**31 - 5, 1234), lsb_for_bits(bits), kind == "tpdf").numpy()
    got = chain.philox_noise(2**31 - 5, 1234, np.arange(6), 64, bits, kind)
    assert np.array_equal(got, want.astype(np.float64))
    sub = chain.philox_noise(2**31 - 5, 1234, np.array([4, 1]), 64, bits, kind)
    assert np.array_equal(sub, got[[4, 1]])


@pytest.mark.parametrize("conf", [C5, C8], ids=["c5", "c8"])
def test_design_equals_the_programs_to_float32(conf):
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from perfbench.harness.runner import stream_config

    stream = tiny(conf)
    cfg = stream_config(stream)
    pipe = Pipeline(cfg, "cpu")
    casc = pipe._cascade(np.asarray(PipelineParams.design(cfg).main_taps, np.float64), None)
    p = PipelineParams.design(cfg)
    if p.eq_taps.shape[0] and cfg.eq_enabled:
        casc = sum(g * pipe._cascade(np.asarray(p.main_taps, np.float64),
                                     np.asarray(b, np.float64))
                   for g, b in zip(p.eq_gains, p.eq_taps))
    h = chain.design(stream)
    assert len(h) == pipe.n_casc
    assert np.abs(h - casc[:len(h)]).max() <= 1e-6 * np.abs(h).max()


@pytest.mark.parametrize("conf,kw,wire", [
    (C5, dict(blocksize=512), "f32"), (C5, dict(blocksize=512), "pcm16"),
    (C8, dict(blocksize=1024), "f32"), (C8, dict(blocksize=1024), "pcm16")],
    ids=["c5-f32", "c5-pcm16", "c8-f32", "c8-pcm16"])
def test_program_passes_and_the_control_fails(conf, kw, wire):
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from perfbench.harness.runner import stream_config
    from perfbench.harness.traffic import WIRES

    stream = {**tiny(conf, **kw), **WIRES[wire]}
    cfg = stream_config(stream)
    pipe = Pipeline(cfg, "cpu")
    params = pipe.device_params(PipelineParams.design(cfg))
    st = pipe.init_state(seed=2**31 - 99)
    x = signal(stream, 4, 3, pcm16=wire == "pcm16")
    outs = []
    for b in x:
        st, y = pipe.step(params, st, b)
        outs.append(y.numpy())
    prog = np.stack(outs)
    rows = np.arange(4)
    ref = chain.reference_blocks(lambda k: x[k], rows, range(4), stream, 2**31 - 99)
    ok, nums = check.compare(prog, ref, conf["limits"], 0, 0)
    assert ok, nums
    low = chain.reference_blocks(lambda k: x[k], rows, range(4), stream, 2**31 - 99,
                                 "bfloat16")
    if wire == "pcm16":
        low = np.clip(np.round(low * 32768), -32768, 32767).astype(np.int16)
    bad, nums_c = check.compare(low.astype(prog.dtype), ref, conf["limits"], 0, 0)
    assert not bad, nums_c
