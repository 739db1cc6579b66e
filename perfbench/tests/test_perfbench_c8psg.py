"""The per-listener EQ cell `c8psg.serve.pcm16` on the CPU at a tiny size:
a sound run reads `correct`; a run whose listeners each get a neighbour's
EQ (the gains rolled by one row) does not; the control (the reference in
bfloat16) is refused; and the two readers of the EQ mix (`harness/eq_mix.py`)
over hand-made traces."""
from __future__ import annotations

import time
import types

import numpy as np
import pytest

from perfbench.control import control_reading
from perfbench.harness import eq_mix, program
from perfbench.harness.peaks import PEAKS
from perfbench.harness.runner import run_cell
from perfbench.harness.trace import TraceData

CELL = "c8psg.serve.pcm16"
SEED = 2**31 + 77


def run(bench, seed=SEED):
    return run_cell(CELL, seed, 0.3, False, t_start=time.perf_counter(),
                    device="cpu", bench=bench,
                    shrink={"stream": {"batch": 8, "blocksize": 1024}})


@pytest.mark.parametrize("seed", [SEED, 5])
def test_a_sound_run_is_correct(bench, seed):
    out = run(bench, seed)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["check"]["err_lsb"]["value"] < 2


def test_a_neighbours_eq_is_not_correct(bench, monkeypatch):
    """Each listener served its neighbour's gains: the loop hands the
    program the draw rolled by one row."""
    from afp_tpu_torch.engine import batch

    orig = batch.with_per_stream_gains

    def rolled(pipe, params, gains):
        return orig(pipe, params, np.roll(np.asarray(gains), 1, axis=0))

    monkeypatch.setattr(batch, "with_per_stream_gains", rolled)
    out = run(bench)
    assert not out["correct"], out["check"]
    assert out["check"]["err_lsb"]["value"] > out["check"]["err_lsb"]["limit"]


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_the_control_is_not_correct(bench, seed):
    r = control_reading(bench, CELL, seed, 40, device="cpu",
                        shrink={"stream": {"batch": 32, "blocksize": 1024}})
    assert r["correct"] is False
    assert r["check"]["err_lsb"]["value"] > r["check"]["err_lsb"]["limit"]


#: the cell's mix: 4096 listeners × 2048 samples, 209 taps, int16 out
MIX = dict(rows=4096, bands=9, taps=209, samples=4096 * 2048,
           bytes=2 * 4096 * 2048)
US = 1000  # ns in a µs


def traced(monkeypatch, ops, recs, blocks=2):
    monkeypatch.setattr(program, "_source", lambda: types.SimpleNamespace(
        records=lambda: list(recs), dropped=lambda: 0))
    return TraceData(device_ops=list(ops), spans=[], window=(0, 2000),
                     blocks=blocks)


def test_the_mix_readers_by_hand(monkeypatch):
    """Two blocks, each mix 300 µs of `fir_ps_kernel` beside other
    kernels: 0.3 ms a block; the least time of a mix is its int16 output
    at the HBM peak (5.0 µs, above the 3.5 µs of its multiply-adds at the
    bf16 peak), so the share is 5.0 / 300."""
    ops = [("void fir_ps_kernel<2, 2, 2, 4>", 100, 400),
           ("agc_apply_kernel", 400, 450),
           ("void fir_ps_kernel<2, 2, 2, 4>", 1100, 1400),
           ("void fir_conv_kernel<2, 2, 2>", 1400, 1500)]
    recs = [("afp.pipe.eq_mix", 90 * US, 95 * US, 0, 0, dict(MIX)),
            ("afp.pipe.eq_mix", 1090 * US, 1095 * US, 0, 1, dict(MIX))]
    trace = traced(monkeypatch, ops, recs)
    assert eq_mix.mix_ms(trace) == pytest.approx(0.3)
    least = MIX["bytes"] / PEAKS["hbm_bytes_per_s"] * 1e6
    assert least > 2 * MIX["samples"] * MIX["taps"] / PEAKS["bf16_flops"] * 1e6
    assert eq_mix.least_us(MIX) == pytest.approx(least)
    assert eq_mix.mix_roofline_pct(trace) == pytest.approx(100 * least / 300)


def test_the_mix_readers_find_nothing(monkeypatch):
    """No `fir_ps_kernel` operation (a cell without the mix), no span (a
    program without it), or no block: nothing to read."""
    recs = [("afp.pipe.eq_mix", 90 * US, 95 * US, 0, 0, dict(MIX))]
    conv = [("void fir_conv_kernel<2, 2, 2>", 100, 400)]
    trace = traced(monkeypatch, conv, recs)
    assert eq_mix.mix_ms(trace) is None and eq_mix.mix_roofline_pct(trace) is None
    ps = [("void fir_ps_kernel<2, 2, 2, 4>", 100, 400)]
    trace = traced(monkeypatch, ps, [])
    assert eq_mix.mix_ms(trace) == pytest.approx(0.15)
    assert eq_mix.mix_roofline_pct(trace) is None
    trace = traced(monkeypatch, ps, recs, blocks=0)
    assert eq_mix.mix_ms(trace) is None and eq_mix.mix_roofline_pct(trace) is None
