"""`python -m afp_tpu_torch` against `afp_tpu`'s CLI on the CPU
(``AFP_FORCE_CPU=1``): `process`, `batch` and `stream --lockstep` on small
WAVs through both packages, dither off; `batch` ≡ `process` and `stream
--lockstep` ≡ `process` inside the port, bit for bit; stream checkpoints
resumed bit for bit with dither on; presets written byte for byte as the
reference writes them; the plot flags draw, their arrays held to
`afp_tpu`'s; ``--mesh`` on CPU shards ≡ `afp_tpu`'s ``--mesh`` and the
port's ``--mesh 1``; and with no card and no switch the CLI exits
non-zero.  The
multirate flags: ``--samplerate`` (the exact ASRC frontend) and
``--output-rate upsampled`` (the literal chain) against `afp_tpu`, `batch`
≡ `process` and the lockstep ASRC stream ≡ `process` inside the port.

Bounds against `afp_tpu`: int16 output within 1 LSB (a conv difference of
the bf16×3 class can flip a rounding tie); 24-bit output within the
contract of its path, 'fft' ≤ −100 dB (two FFT libraries: a few 24-bit
LSB; through the ASRC's 2^20-point FFTs a few tens) and the AGC chain
≤ −100 dB (`tests/test_torch_agc_pipeline.py`); each test prints the
measured value."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from afp_tpu.cli import main as jmain
from afp_tpu_torch.cli import main
from afp_tpu_torch.utils import (read_wav, read_wav_pcm16, write_wav,
                                 write_wav_pcm16)

REPO = Path(__file__).resolve().parents[1]
FFT_DB = AGC_DB = -100.0
#: small shapes: block 512, 2× upsample, 65 taps, dither off
FLAGS = ["--blocksize", "512", "--upsample", "2", "--numtaps", "65",
         "--dither", "off"]
#: the CLI's paths: the defaults ('fft'), int16 in and out (the td_mxu
#: fold, K8 on the card), and the linked AGC (K5 → K6, no fold)
FORMS = {
    "fft": [],
    "pcm16-io": ["--ingest", "pcm16", "--emit", "pcm16"],
    "agc-link": ["--agc", "--agc-link"],
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AFP_FORCE_CPU", "1")


def err_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    e = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
    return 20 * np.log10(max(e, 1e-30))


def wav(path, form: str, n: int, seed: int, ch: int = 2) -> str:
    """A seeded WAV: 16-bit PCM for the pcm16 form, else 24-bit."""
    rng = np.random.default_rng(seed)
    if form == "pcm16-io":
        write_wav_pcm16(str(path), (rng.standard_normal((ch, n)) * 6000
                                    ).astype(np.int16), 44100)
    else:
        write_wav(str(path), np.clip(0.3 * rng.standard_normal((ch, n)), -1, 1),
                  44100, width=3)
    return str(path)


def read(path: str, form: str) -> np.ndarray:
    return (read_wav_pcm16 if form == "pcm16-io" else read_wav)(path)[0]


def compare(form: str, got: np.ndarray, ref: np.ndarray, what: str) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == np.int16:
        lsb = np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()
        print(f"{what}: int16 {lsb} LSB from afp_tpu (bound 1)")
        assert lsb <= 1
        return
    bound = AGC_DB if form == "agc-link" else FFT_DB
    db = err_db(got, ref)
    lsb = np.abs(got.astype(np.float64) - ref).max() * 2 ** 23
    print(f"{what}: {db:.1f} dB, {lsb:.0f} 24-bit LSB from afp_tpu "
          f"(bound {bound} dB)")
    assert db <= bound


@pytest.mark.parametrize("form", list(FORMS))
def test_process_against_reference(tmp_path, form):
    """`process` on a stereo WAV with a partial final block, through both
    packages' CLIs."""
    src = wav(tmp_path / "in.wav", form, 22050 + 77, seed=1)
    ours, ref = str(tmp_path / "ours.wav"), str(tmp_path / "ref.wav")
    assert main(["process", src, ours, *FLAGS, *FORMS[form]]) == 0
    assert jmain(["process", src, ref, *FLAGS, *FORMS[form]]) == 0
    compare(form, read(ours, form), read(ref, form), f"process {form}")


@pytest.mark.parametrize("form", ["fft", "pcm16-io"])
def test_batch_equals_process(tmp_path, form):
    """`batch` packs every file's rows into one fold dispatch per rate
    group; each file's output equals `process` on that file alone, bit for
    bit, and `afp_tpu`'s batch within the bound."""
    srcs = [wav(tmp_path / f"f{i}.wav", form, 5000 + 900 * i, seed=10 + i,
                ch=1 + i % 2) for i in range(3)]
    assert main(["batch", *srcs, "-o", str(tmp_path / "ours"), *FLAGS,
                 *FORMS[form]]) == 0
    assert jmain(["batch", *srcs, "-o", str(tmp_path / "ref"), *FLAGS,
                  *FORMS[form]]) == 0
    for src in srcs:
        name = os.path.basename(src)
        one = str(tmp_path / "one.wav")
        assert main(["process", src, one, *FLAGS, *FORMS[form]]) == 0
        got = read(str(tmp_path / "ours" / name), form)
        np.testing.assert_array_equal(got, read(one, form))
        compare(form, got, read(str(tmp_path / "ref" / name), form),
                f"batch {form} {name}")


@pytest.mark.parametrize("form", ["fft", "agc-link"])
def test_stream_lockstep_equals_process(tmp_path, capsys, form):
    """`stream --lockstep -o` is 1-in-1-out through the dispatcher: its
    capture equals `process` bit for bit (the fold or the scan of the same
    blocks), with no ladder event."""
    src = wav(tmp_path / "in.wav", form, 5000, seed=2)
    cap, one = str(tmp_path / "cap.wav"), str(tmp_path / "one.wav")
    assert main(["stream", src, "-o", cap, "--lockstep", *FLAGS,
                 *FORMS[form]]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["blocks"] == 10 and snap["realtime"] is False
    assert all(snap[k] == 0 for k in ("underruns", "drops", "fallback_replays",
                                      "fallback_silence", "design_fallbacks"))
    assert main(["process", src, one, *FLAGS, *FORMS[form]]) == 0
    np.testing.assert_array_equal(read(cap, form), read(one, form))


def test_stream_checkpoint_resume_dither_on(tmp_path):
    """Stream 5 blocks and checkpoint, then resume with --skip-blocks 5:
    the joined captures equal one uninterrupted stream bit for bit, TPDF
    dither and the AGC on (the pair tail and the Philox (seed, step) ride
    the checkpoint)."""
    src = wav(tmp_path / "in.wav", "agc-link", 10 * 512 + 100, seed=3)
    full, h1, h2 = (str(tmp_path / n) for n in ("f.wav", "1.wav", "2.wav"))
    ck = str(tmp_path / "ck.npz")
    flags = ["--lockstep", "--blocksize", "512", "--upsample", "2",
             "--numtaps", "65", "--agc"]
    assert main(["stream", src, "-o", full, *flags]) == 0
    assert main(["stream", src, "-o", h1, "--blocks", "5",
                 "--checkpoint-out", ck, *flags]) == 0
    assert main(["stream", src, "-o", h2, "--skip-blocks", "5",
                 "--resume", ck, "--lockstep"]) == 0
    f = read_wav(full)[0]
    j = np.concatenate([read_wav(h1)[0], read_wav(h2)[0]], axis=1)
    assert f.shape == j.shape == (2, 10 * 512 + 100)
    np.testing.assert_array_equal(f, j)
    mono = wav(tmp_path / "mono.wav", "fft", 1024, seed=4, ch=1)
    with pytest.raises(SystemExit, match="expects 2 channels"):
        main(["stream", mono, "--resume", ck, "--lockstep"])
    src16 = wav(tmp_path / "in16.wav", "pcm16-io", 1024, seed=4)
    with pytest.raises(SystemExit, match="matching --ingest"):
        main(["stream", src16, "--resume", ck, "--lockstep", "--ingest",
              "pcm16"])


def test_stream_faults_and_paced(tmp_path, capsys):
    """--fault-drop and --fault-corrupt in lockstep: a dropped block yields
    no output, a poisoned one a replay, and the counters equal the injected
    counts; then a short paced run takes at least its block periods."""
    import time

    src = wav(tmp_path / "in.wav", "fft", 12 * 256, seed=5, ch=1)
    cap = str(tmp_path / "cap.wav")
    assert main(["stream", src, "-o", cap, "--lockstep", "--blocksize", "256",
                 "--upsample", "1", "--numtaps", "33", "--dither", "off",
                 "--fault-drop", "3", "--fault-corrupt", "4"]) == 0
    snap = json.loads(capsys.readouterr().out)
    # of blocks 1..12, 3/6/9/12 drop and 4/8 are poisoned
    assert snap["blocks"] == 6 and snap["fallback_replays"] == 2
    assert snap["in_ring"]["pushes"] == 8 and snap["fallback_silence"] == 0
    assert read_wav(cap)[0].shape == (1, 8 * 256)
    t0 = time.monotonic()
    assert main(["stream", src, "--blocks", "4", "--blocksize", "256",
                 "--upsample", "1", "--numtaps", "17", "--dither", "off",
                 "--samplerate", "44100"]) == 0
    wall = time.monotonic() - t0
    snap = json.loads(capsys.readouterr().out)
    print(f"paced: 4 blocks of {256 / 44100 * 1e3:.1f} ms in "
          f"{wall * 1e3:.0f} ms, {snap}")
    assert snap["realtime"] is True and wall >= 3 * 256 / 44100 * 0.9


def test_unported_flags_raise_naming_their_item(tmp_path):
    """The flags that once raised naming their ROADMAP.md items now run:
    ``--mesh`` (item 11) shards the rows over CPU shards under
    ``AFP_FORCE_CPU``, and ``process --mesh 2`` and ``batch --mesh 4``
    match `afp_tpu`'s ``--mesh`` (its virtual CPU devices) and the port's
    ``--mesh 1`` (bit for bit); ``--mesh`` with rate conversion and on
    ``stream`` is refused as in `afp_tpu`; the plot flags, which raised
    before items 10b and 12b, write their PNGs."""
    src = wav(tmp_path / "in.wav", "fft", 2048 + 77, seed=6)
    srcs = [src, wav(tmp_path / "m.wav", "fft", 3000, seed=7, ch=1)]
    out = str(tmp_path / "o.wav")
    for flags in ([], ["--agc", "--agc-link"]):
        argv = ["process", src, out, "--mesh", "2", *flags, *FLAGS]
        assert main(argv) == 0
        assert jmain(argv[:2] + [str(tmp_path / "ref.wav")] + argv[3:]) == 0
        assert main(["process", src, str(tmp_path / "one.wav"), *flags,
                     *FLAGS]) == 0
        got = read(out, "fft")
        np.testing.assert_array_equal(got, read(str(tmp_path / "one.wav"), "fft"))
        compare("agc-link" if flags else "fft", got,
                read(str(tmp_path / "ref.wav"), "fft"),
                f"process --mesh 2 {' '.join(flags)}")
    for d, cli in (("ours", main), ("ref", jmain)):
        assert cli(["batch", *srcs, "-o", str(tmp_path / d), "--mesh", "4",
                    *FLAGS]) == 0
    assert main(["batch", *srcs, "-o", str(tmp_path / "one"), *FLAGS]) == 0
    for p in srcs:
        name = os.path.basename(p)
        got = read(str(tmp_path / "ours" / name), "fft")
        np.testing.assert_array_equal(got, read(str(tmp_path / "one" / name),
                                                "fft"))
        compare("fft", got, read(str(tmp_path / "ref" / name), "fft"),
                f"batch --mesh 4 {name}")
    with pytest.raises(SystemExit, match="rate conversion"):
        main(["process", src, out, "--mesh", "2", "--samplerate", "48000",
              *FLAGS])
    with pytest.raises(SystemExit, match="process/batch"):
        main(["stream", src, "--lockstep", "--mesh", "2", *FLAGS])
    png = {k: str(tmp_path / f"{k}.png") for k in "swcr"}
    for argv in (["process", src, out, "--spectrum-plot", png["s"],
                  "--waterfall-plot", png["w"]],
                 ["stream", src, "--lockstep", "--spectrum-plot", png["c"]],
                 ["design", "--plot", png["r"], "--taps-out",
                  str(tmp_path / "h.txt")]):
        assert main(argv + FLAGS) == 0
    assert os.path.exists(out)
    for k, p in png.items():
        assert os.path.getsize(p) > 1000, k


@pytest.mark.parametrize("form", ["fft", "pcm16-io"])
def test_plot_arrays_against_afp_tpu(tmp_path, monkeypatch, form):
    """The arrays `--spectrum-plot` and `--waterfall-plot` draw, caught at
    the plot calls of both CLIs on the same file: the bin frequencies and
    the response taps equal, the power-mean spectrum and the ring's rows
    within ROW_DB as magnitudes relative to the row maximum, the −200 dB
    priming exact (a 20-block file fills 20 of the 50 rows)."""
    import afp_tpu.viz as jviz
    import afp_tpu_torch.viz as tviz

    ROW_DB = -95.0
    src = wav(tmp_path / "in.wav", form, 20 * 512, seed=11)
    got = {}
    for name, mod, fn in (("ref", jviz, jmain), ("port", tviz, main)):
        seen = got.setdefault(name, {})
        monkeypatch.setattr(mod, "plot_filter_response",
                            lambda taps, spectrum, **k: seen.update(
                                taps=taps, freqs=spectrum[0],
                                mean_db=spectrum[1]))
        monkeypatch.setattr(mod, "plot_waterfall",
                            lambda ring, freqs, **k: seen.update(
                                ring=ring, wf_freqs=freqs, **k))
        assert fn(["process", src, str(tmp_path / f"{name}.wav"),
                   "--spectrum-plot", "s.png", "--waterfall-plot", "w.png",
                   *FORMS[form], *FLAGS]) == 0
    ref, port = got["ref"], got["port"]
    for k in ("taps", "freqs", "wf_freqs"):
        assert np.array_equal(np.asarray(port[k]), np.asarray(ref[k])), k
    assert port["block_seconds"] == ref["block_seconds"]
    assert np.all(port["ring"][:30] == -200.0) and np.all(ref["ring"][:30] == -200.0)
    for k, a, b in (("mean_db", port["mean_db"], ref["mean_db"]),
                    ("ring", port["ring"][30:], ref["ring"][30:])):
        ma = 10.0 ** (np.asarray(a, np.float64) / 20)
        mb = 10.0 ** (np.asarray(b, np.float64) / 20)
        e = 20 * np.log10((np.abs(ma - mb).max(-1) / mb.max(-1)).max())
        print(f"{form} {k}: {e:.1f} dB (bound {ROW_DB})")
        assert e <= ROW_DB


def test_no_card_and_no_switch_exits(monkeypatch, capsys):
    """Without a CUDA device and without AFP_FORCE_CPU the CLI refuses to
    run (it never carries on on the CPU); under the switch `devices` lists
    the CPU, and the `-m` entry point runs."""
    import torch

    monkeypatch.delenv("AFP_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device") as e:
        main(["devices"])
    assert e.value.code != 0
    r = subprocess.run([sys.executable, "-m", "afp_tpu_torch", "devices"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "AFP_FORCE_CPU": "1"})
    print(r.stdout, r.stderr[-500:])
    assert r.returncode == 0 and r.stdout.startswith("0: cpu (cpu")


def test_presets_byte_identical_and_applied(tmp_path, capsys):
    """The same saves through both CLIs write the same JSON bytes; show,
    list and delete work; a saved preset applies to `process` as its flags
    would (the preset carries the filter and dither, not the block)."""
    ours, ref = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    saves = [["warm", "--eq-gains", "2,2,1.5,1,1,1,1,0.5,0.5", *FLAGS],
             ["loud", "--agc", "--agc-target", "0.2", "--cutoff", "9000",
              "--numtaps", "65"],
             ["band", "--filter-type", "bandpass", "--cutoff", "300",
              "--cutoff-high", "3000", "--method", "remez"]]
    for argv in saves:
        assert main(["preset", "save", *argv, "--store", ours]) == 0
        assert jmain(["preset", "save", *argv, "--store", ref]) == 0
    assert Path(ours).read_bytes() == Path(ref).read_bytes()
    capsys.readouterr()
    assert main(["preset", "list", "--store", ours]) == 0
    assert capsys.readouterr().out.split() == ["warm", "loud", "band"]
    assert main(["preset", "show", "loud", "--store", ours]) == 0
    assert json.loads(capsys.readouterr().out)["settings"]["agc_enabled"]
    assert main(["preset", "delete", "band", "--store", ours]) == 0
    assert jmain(["preset", "delete", "band", "--store", ref]) == 0
    assert Path(ours).read_bytes() == Path(ref).read_bytes()
    src = wav(tmp_path / "in.wav", "fft", 4096, seed=7)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    assert main(["process", src, a, *FLAGS, "--preset", "warm",
                 "--preset-store", ours]) == 0
    assert main(["process", src, b, *FLAGS,
                 "--eq-gains", "2,2,1.5,1,1,1,1,0.5,0.5"]) == 0
    np.testing.assert_array_equal(read_wav(a)[0], read_wav(b)[0])
    with pytest.raises(SystemExit, match="unknown preset"):
        main(["process", src, a, "--preset", "nope", "--preset-store", ours])


def test_design_taps_equal_reference(tmp_path):
    """`design --taps-out` writes the taps `afp_tpu` writes (the design
    code is a float64 copy)."""
    ours, ref = str(tmp_path / "o.txt"), str(tmp_path / "r.txt")
    argv = ["design", "--cutoff", "11000", "--numtaps", "101"]
    assert main([*argv, "--taps-out", ours]) == 0
    assert jmain([*argv, "--taps-out", ref]) == 0
    assert Path(ours).read_bytes() == Path(ref).read_bytes()


# ---------------------------------------------------------------- multirate

#: the 48 kHz file into the 44.1 kHz engine (the everyday ASRC case)
SR_FLAGS = ["--samplerate", "44100", *FLAGS]


def wav48(path, n: int, seed: int, ch: int = 2) -> str:
    rng = np.random.default_rng(seed)
    write_wav(str(path), np.clip(0.3 * rng.standard_normal((ch, n)), -1, 1),
              48000, width=3)
    return str(path)


@pytest.mark.parametrize("form", ["fft", "agc-link"])
def test_process_samplerate_matches_reference(tmp_path, form):
    """--samplerate 44100 of a 48 kHz file: the exact ASRC frontend, the
    output ceil(n·44100/48000) samples at 44.1 kHz, ≡ `afp_tpu`'s within
    the path's contract."""
    n = 9000
    src = wav48(tmp_path / "in.wav", n, seed=20)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    flags = SR_FLAGS + FORMS[form]
    assert main(["process", src, a] + flags) == 0
    assert jmain(["process", src, b] + flags) == 0
    got, rate = read_wav(a)
    assert rate == 44100 and got.shape == (2, -(-n * 44100 // 48000))
    compare(form, got, read_wav(b)[0], f"process --samplerate 44100 {form}")


def test_process_output_rate_upsampled_matches_reference(tmp_path):
    """--output-rate upsampled: twice the samples at 88.2 kHz, ≡ `afp_tpu`'s."""
    src = wav(tmp_path / "in.wav", "fft", 3000, seed=21)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    flags = FLAGS + ["--output-rate", "upsampled"]
    assert main(["process", src, a] + flags) == 0
    assert jmain(["process", src, b] + flags) == 0
    got, rate = read_wav(a)
    assert rate == 88200 and got.shape == (2, 6000)
    compare("fft", got, read_wav(b)[0], "process --output-rate upsampled")


def test_batch_samplerate_equals_process(tmp_path):
    """batch --samplerate: each file ≡ process of it alone within one 24-bit
    LSB: torch's CPU FFT rounds a 2^20-point row (the frontend's) in a
    batch of 6 rows differently from one in a batch of 2 (the card's run
    is held bit for bit by `chip_smoke.py` phase 9)."""
    srcs = [wav48(tmp_path / f"f{i}.wav", 5000 + 700 * i, seed=30 + i)
            for i in range(3)]
    assert main(["batch", *srcs, "-o", str(tmp_path / "out")] + SR_FLAGS) == 0
    for i, src in enumerate(srcs):
        one = str(tmp_path / "one.wav")
        assert main(["process", src, one] + SR_FLAGS) == 0
        got, rate = read_wav(str(tmp_path / "out" / f"f{i}.wav"))
        assert rate == 44100 and got.shape[1] == -(-(5000 + 700 * i) * 44100 // 48000)
        lsb = np.abs(got.astype(np.float64) - read_wav(one)[0]).max() * 2 ** 23
        print(f"batch --samplerate file {i}: {lsb:.0f} 24-bit LSB from process")
        assert lsb <= 1


def test_stream_lockstep_samplerate_equals_process(tmp_path, capsys):
    """stream --lockstep with --samplerate: the synchronous drain emits a
    block exactly when a whole converted block exists (no underrun, no
    silence, no drop), and the capture ≡ the whole-block prefix of
    `process` (the linked AGC: neither side folds), bit for bit."""
    n = 16 * 512
    src = wav48(tmp_path / "in.wav", n, seed=22)
    cap, ref = str(tmp_path / "cap.wav"), str(tmp_path / "ref.wav")
    flags = SR_FLAGS + FORMS["agc-link"]
    assert main(["stream", src, "-o", cap, "--lockstep"] + flags) == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert snap["underruns"] == 0 and snap["fallback_silence"] == 0
    assert snap["drops"] == 0 and snap["fallback_replays"] == 0
    assert main(["process", src, ref] + flags) == 0
    y, rate = read_wav(cap)
    z = read_wav(ref)[0]
    print(f"lockstep ASRC capture: {y.shape[1]} of {z.shape[1]} samples")
    assert rate == 44100 and y.shape[1] % 512 == 0 and 0 < y.shape[1] < z.shape[1]
    np.testing.assert_array_equal(y, z[:, :y.shape[1]])


def test_stream_output_rate_upsampled_equals_process(tmp_path, capsys):
    src = wav(tmp_path / "in.wav", "fft", 2500, seed=23)
    cap, ref = str(tmp_path / "cap.wav"), str(tmp_path / "ref.wav")
    flags = FLAGS + ["--output-rate", "upsampled"] + FORMS["agc-link"]
    assert main(["stream", src, "-o", cap, "--lockstep"] + flags) == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert snap["blocks"] == 5 and snap["fallback_silence"] == 0
    assert main(["process", src, ref] + flags) == 0
    y, rate = read_wav(cap)
    assert rate == 88200 and y.shape == (2, 5000)
    np.testing.assert_array_equal(y, read_wav(ref)[0])


def test_multirate_refusals(tmp_path):
    """The reference's refusals: pcm16 with rate conversion or upsampled
    output; --audio with upsampled output."""
    src = wav(tmp_path / "in.wav", "pcm16-io", 2048, seed=24)
    out = str(tmp_path / "o.wav")
    for extra, msg in ((["--samplerate", "48000"], "rate conversion"),
                       (["--output-rate", "upsampled"], "upsampled")):
        with pytest.raises(SystemExit, match=msg):
            main(["process", src, out, "--ingest", "pcm16"] + extra + FLAGS)
    with pytest.raises(SystemExit, match="upsampled"):
        main(["stream", "--audio", "--output-rate", "upsampled", "--blocks", "1"])
    assert not os.path.exists(out)
