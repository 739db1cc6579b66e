"""The port's serving forms on the CPU: ring steps (K3) and the megakernel
dispatch (K4) against the staged step and against `afp_tpu`'s ring, and
`RingServer`'s pump, reconfiguration and validation.  Each test states its
tolerance and prints the measured value."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
from afp_tpu_torch.runtime import RingServer

TD_DB = -110.0  # the bf16×3 accumulation-order class

#: the C5 chain at small size, dither and clip on
KW = dict(samplerate=44100, blocksize=256, upsample_factor=4, numtaps=63,
          batch=4, cutoff=9000.0, eq_enabled=False, downsample_mode="decimate",
          output_clip=0.5, resample_quality="fast", conv_strategy="td_mxu",
          dither_kind="tpdf", dither_bits=16)


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def blocks(n, seed=0, B=4, L=256):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, L)) * 0.3).astype(np.float32) for _ in range(n)]


def port(**over):
    p = Pipeline(StreamConfig(**{**KW, **over}), "cpu")
    return p, p.device_params(PipelineParams.design(p.cfg))


def staged(p, params, blks, seed=0):
    st = p.init_state(seed=seed)
    outs = []
    for b in blks:
        st, y = p.step(params, st, b)
        outs.append(y.numpy())
    return st, outs


def test_ring_equals_staged():
    """run_ring over 6 slots ≡ 6 staged steps, bit for bit (dither, clip);
    the carried tail and block counter agree too."""
    p, params = port()
    blks = blocks(6)
    st0, want = staged(p, params, blks, seed=4)
    ring = torch.from_numpy(np.stack(blks))
    st, out = p.run_ring(params, p.init_state(seed=4), ring, None,
                         torch.zeros_like(ring), 6, start=0)
    assert all(np.array_equal(out[i].numpy(), want[i]) for i in range(6))
    assert torch.equal(st.conv_tail, st0.conv_tail) and st.step == st0.step == 6


@pytest.mark.parametrize("start,n_steps", [(0, 4), (3, 4), (1, 9)])
def test_mega_equals_chained_ring(start, n_steps):
    """run_ring_mega ≡ run_ring (one K4 launch vs n K3 launches), bit for
    bit with dither on, including a wrap of the slot index and n_steps > S."""
    p, params = port()
    ring = torch.from_numpy(np.stack(blocks(4, seed=1)))
    s1, a = p.run_ring(params, p.init_state(seed=2), ring, None,
                       torch.zeros_like(ring), n_steps, start=start)
    s2, b = p.run_ring_mega(params, p.init_state(seed=2), ring, None,
                            torch.zeros_like(ring), n_steps, start=start)
    assert torch.equal(a, b) and torch.equal(s1.conv_tail, s2.conv_tail)
    assert s1.step == s2.step == n_steps


def test_ring_matches_jax_run_ring():
    """The port's run_ring vs `afp_tpu`'s (f32 conv ring, interpret mode,
    dither off): ≤ −110 dB over the ring."""
    kw = {**KW, "dither_kind": "off"}
    jp = JPipeline(JConfig(**kw))
    jpar = jp.device_params(JParams.design(jp.cfg))
    ring = np.stack(blocks(4, seed=3))
    jst, jout = jp.run_ring(jpar, jp.init_state(), jnp.asarray(ring), None,
                            jnp.zeros_like(jnp.asarray(ring)), 4, start=1)
    p, params = port(dither_kind="off")
    _, out = p.run_ring(params, p.init_state(), torch.from_numpy(ring), None,
                        torch.zeros(4, 4, 256), 4, start=1)
    e = err_db(out.numpy(), np.asarray(jout))
    print(f"run_ring vs afp_tpu: {e:.1f} dB (bound {TD_DB})")
    assert e <= TD_DB
    assert np.array_equal(p.init_state().conv_tail.shape, np.asarray(jst.conv_tail).shape)


@pytest.mark.parametrize("mega", [False, True])
def test_ring_server_serves_staged_outputs(mega):
    """RingServer over 10 blocks (chunk 4: two full chunks and a short one)
    yields the staged pipeline's outputs in order, bit for bit."""
    p, params = port()
    blks = blocks(10, seed=5)
    _, want = staged(p, params, blks, seed=7)
    srv = RingServer(p, params, slots=12, chunk=4, max_inflight=2, seed=7,
                     mega=mega)
    got = list(srv.stream(iter(blks)))
    assert len(got) == 10
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    stats = srv.latency_stats()
    print(f"mega={mega}: latency {stats}")
    assert stats["n"] == 10 and srv.blocks_served == 10 and srv.state.step == 10


def test_ring_server_serve_and_reconfig():
    """serve() counts blocks; retune/set_eq_gains/swap_params take effect at
    the next chunk: the output equals a staged run switched at that block."""
    p, params = port(eq_enabled=True, dither_kind="off")
    blks = blocks(8, seed=6)
    srv = RingServer(p, params, slots=8, chunk=2, max_inflight=1)
    got = []
    res = srv.serve(iter(blks[:4]), got.append)
    assert res["blocks"] == 4 and res["latency"]["n"] == 4
    new_cfg = dataclasses.replace(p.cfg, cutoff=4000.0)
    srv.retune(new_cfg)
    srv.set_eq_gains([0.5] * 9)
    srv.serve(iter(blks[4:]), got.append)
    q, qp = port(eq_enabled=True, dither_kind="off")
    st = q.init_state()
    new = q.device_params(PipelineParams.design(new_cfg), cfg=new_cfg)
    new = new._replace(eq_gains=torch.full((9,), 0.5))
    for i, b in enumerate(blks):
        st, y = q.step(qp if i < 4 else new, st, b)
        assert np.array_equal(got[i], y.numpy()), i
    with pytest.raises(ValueError, match="EQ band count"):
        srv.set_eq_gains([1.0])
    with pytest.raises(ValueError, match="shape"):
        srv.swap_params(params._replace(casc_main=torch.zeros(3)))
    with pytest.raises(ValueError, match="dynamic-only"):
        srv.retune(dataclasses.replace(p.cfg, numtaps=65))


@pytest.mark.parametrize("kw,err,match", [
    (dict(slots=10, chunk=4), ValueError, "must divide"),
    (dict(max_inflight=0), ValueError, "max_inflight"),
    (dict(slots=8, chunk=4, max_inflight=2), ValueError, "undrained"),
    (dict(spectrum_row=9), ValueError, "spectrum_row"),
    (dict(spectrum_every=4, spectrum_row=4), ValueError, "spectrum_row"),
    (dict(packing=object()), ValueError, "packing must be a StreamPacking")])
def test_ring_server_validation(kw, err, match):
    p, params = port()
    with pytest.raises(err, match=match):
        RingServer(p, params, **kw)


def test_ring_forms_rejected():
    """The fft strategy has no ring form; an f32 pipeline takes one ring,
    not a pair, of float32, into a float32 output ring."""
    p, params = port(conv_strategy="fft")
    assert not p.supports_ring_step
    with pytest.raises(ValueError, match="ring-capable"):
        RingServer(p, params)
    q, qp = port()
    ring = torch.zeros(2, 4, 256)
    with pytest.raises(ValueError, match="ring form mismatch"):
        q.ring_step(qp, q.init_state(), ring, ring, 0, torch.zeros_like(ring))
    with pytest.raises(ValueError, match="float32"):
        q.ring_step(qp, q.init_state(), ring.to(torch.int16), None, 0,
                    torch.zeros_like(ring))
    with pytest.raises(ValueError, match="output rings must be torch.float32"):
        q.run_ring_mega(qp, q.init_state(), ring, None,
                        torch.zeros(2, 4, 256, dtype=torch.int16), 2)
