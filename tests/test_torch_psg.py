"""The per-listener EQ farm (`c8_psg`) on the CPU: the port's C8 chain with
each stream's own EQ gains against the benchmark's plain reference
`perfbench/reference/per_stream_eq.py` (float64, the upstream's
combined-kernel form), that reference against `chain.py` where every row
has the shared gains, and the ``afp.pipe.eq_mix`` span of the per-stream
AGC ring."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig, batch
from afp_tpu_torch.runtime import RingServer
from afp_tpu_torch.utils import trace
from perfbench.harness import check
from perfbench.reference import chain, per_stream_eq

CONF = json.loads((Path(__file__).resolve().parents[1] / "perfbench" / "configs"
                   / "c8_psg.json").read_text())
SEED = 2**31 + 1234
#: the limit the port is held to here, in 16-bit steps: 0.5 is the int16
#: rounding alone; the bf16×3 conv and the f32 AGC sit ~0.2 steps off
#: float64 at full scale (0.62-0.80 at the cell's sizes), and 2 leaves
#: room for both while the bf16 control reads two orders of magnitude above
LSB_LIMIT = 2.0


def stream(**kw):
    """The configuration's stream at B = 8, L = 256, 16-bit PCM; the AGC
    window min(512, L // 2) = 128, as the upstream (and the port) take it
    at this block (the reference takes the window as stated)."""
    s = dict(CONF["stream"])
    s.update(batch=8, blocksize=256, agc_window_size=128, ingest="pcm16",
             emit="pcm16", **kw)
    return s


def pool(n, B, T, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, B, T)) * 10 ** rng.uniform(-2, -0.3, (n, B, 1))
    return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)


def test_the_port_against_the_per_listener_reference():
    """The port's staged per-stream steps (K5 → K6 → K11 pair) over 4 blocks
    at B = 8, L = 256 on the configuration's seeded gains against
    `per_stream_eq` in float64: within `LSB_LIMIT`; the reference's own
    bf16 control is refused by it; and a neighbour's gains (rolled by a
    row) are refused too."""
    s = stream()
    xs = pool(4, 8, 256, seed=5)
    ds = SEED % (1 << 31)
    p = Pipeline(StreamConfig.from_dict(s).validate(), "cpu")
    gains = per_stream_eq.draw_gains(CONF, SEED, 8)
    assert gains.shape == (8, 9) and gains.min() >= 0 and gains.max() <= 4.0
    assert np.allclose(gains * 10, np.round(gains * 10), atol=1e-5)
    params = p.device_params(PipelineParams.design(p.cfg))
    st, outs = p.init_state(seed=ds), []
    for x in xs:
        st, y = p.step(batch.with_per_stream_gains(p, params, gains), st, x)
        outs.append(y.numpy())
    prog = np.stack(outs)
    rows = np.arange(8)

    def ref(precision="float64"):
        return per_stream_eq.reference_blocks(
            lambda k: xs[k], rows, range(4), s, ds, precision, config=CONF,
            seed=SEED)

    want = ref()
    e = check.err_lsb(prog, want)
    control = check.err_lsb(np.clip(np.round(ref("bfloat16") * 32768), -32768,
                                    32767).astype(np.int16), want)
    st, rolled = p.init_state(seed=ds), []
    for x in xs:
        st, y = p.step(batch.with_per_stream_gains(
            p, params, np.roll(gains, 1, axis=0)), st, x)
        rolled.append(y.numpy())
    wrong = check.err_lsb(np.stack(rolled), want)
    print(f"port {e:.3f}, bf16 control {control:.1f}, rolled gains {wrong:.1f} LSB")
    assert e <= LSB_LIMIT < control and LSB_LIMIT < wrong


@pytest.mark.parametrize("gain,wire", [(1.0, "pcm16"), (2.5, "f32")])
def test_the_reference_at_shared_gains_is_chain(gain, wire):
    """Every listener at the configuration's shared gains: `per_stream_eq`
    (gains mixed into each row's taps, NumPy float64) equals `chain.py`
    (one design for the batch, NumPy float64) to 1e-12 of full scale."""
    wkw = {} if wire == "f32" else dict(ingest="pcm16", emit="pcm16")
    s = {**stream(), "ingest": "f32", "emit": "f32", **wkw}
    s["eq_bands"] = [{**b, "gain": gain} for b in s["eq_bands"]]
    conf = {**CONF, "per_stream_gains": {**CONF["per_stream_gains"],
                                         "low": gain, "high": gain}}
    xs = pool(5, 8, 256, seed=6)
    if wire == "f32":
        xs = xs.astype(np.float32) / np.float32(32768)
    rows, ks = np.array([1, 4, 6]), [0, 2, 4]
    got = per_stream_eq.reference_blocks(lambda k: xs[k], rows, ks, s, 77,
                                         config=conf, seed=SEED)
    want = chain.reference_blocks(lambda k: xs[k], rows, ks, s, 77,
                                  config=conf, seed=SEED)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"per_stream_eq at shared gain {gain} vs chain: {rel:.2e}")
    assert rel <= 1e-12


def test_eq_mix_span_of_the_per_stream_ring():
    """Under the profiler the per-stream AGC ring keeps one
    ``afp.pipe.eq_mix`` span a block, inside its ``afp.pipe.run_ring``,
    with the counts ``rows``, ``bands``, ``taps``, ``samples`` (rows ×
    block) and ``bytes`` (the int16 output)."""
    s = stream()
    p = Pipeline(StreamConfig.from_dict(s).validate(), "cpu")
    params = batch.with_per_stream_gains(
        p, p.device_params(PipelineParams.design(p.cfg)),
        per_stream_eq.draw_gains(CONF, SEED, 8))
    srv = RingServer(p, params, slots=6, chunk=2, max_inflight=2, seed=3)
    xs = pool(6, 8, 256, seed=7)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        list(srv.stream(iter(xs)))
    recs = [r for r in trace.records() if r is not None]
    trace.clear()
    mixes = [(i, r) for i, r in enumerate(recs) if r[0] == "afp.pipe.eq_mix"]
    assert [r[4] for _, r in mixes] == list(range(6))
    for _, r in mixes:
        assert recs[r[3]][0] == "afp.pipe.run_ring"
        assert r[5] == dict(rows=8, bands=9, taps=p.n_casc, samples=8 * 256,
                            bytes=2 * 8 * 256)
    assert torch.is_tensor(params.eq_gains) and params.eq_gains.shape == (8, 9)
