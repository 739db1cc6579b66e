"""``agc_mode='parallel'`` in the port: `ops.agc.smooth_gain_parallel` (the
branch-consistent fixed-point solver over an associative scan in log₂T
doubling steps) against the exact recurrence and against `afp_tpu`'s
solver, and the pipeline's parallel route against its exact route and
`afp_tpu`'s, on the CPU with the same seeded numpy inputs, dither off.

Bounds: −105 dB for the solver against the exact recurrence and against
`afp_tpu`'s solver (the reference's own bar, `afp_tpu/ops/agc.py:176-182`),
and for the pipeline's gained block and gain carry against its exact mode;
≤ −100 dB for the chain's output against the exact chain and against
`afp_tpu` (the AGC chain's contract).  Each test prints what it
measured."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afp_tpu.engine import Pipeline as JPipeline
from afp_tpu.engine import PipelineParams as JParams
from afp_tpu.engine import StreamConfig as JConfig
from afp_tpu.ops.agc import smooth_gain_parallel as j_parallel
from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
from afp_tpu_torch.ops.agc import (_smooth_gain_parallel,
                                   _solve_linear_recurrence, agc_alphas,
                                   desired_gain, moving_rms,
                                   smooth_gain_parallel, smooth_gain_scan)

SOLVER_DB, CHAIN_DB = -105.0, -100.0


def err_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def desired(B, T, seed):
    """A realistic desired gain: noise with a quiet passage, RMS over 256."""
    x = np.random.default_rng(seed).standard_normal((B, T)).astype(np.float32) * 0.3
    x[:, T // 3: T // 2] *= 0.02
    return desired_gain(moving_rms(torch.from_numpy(x), 256), 0.1, 10.0)


def test_solve_linear_recurrence_matches_loop():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0, 1, (1000, 3)))
    d = torch.from_numpy(rng.uniform(0, 5, (1000, 3)))
    g0 = torch.from_numpy(rng.uniform(0, 5, 3))
    got = _solve_linear_recurrence(a, d, g0)
    g, want = g0.clone(), []
    for t in range(1000):
        g = (1 - a[t]) * g + a[t] * d[t]
        want.append(g)
    e = err_db(got, torch.stack(want))
    print(f"affine-map scan vs the loop (float64): {e:.1f} dB")
    assert e < -250


@pytest.mark.parametrize("case", ["restart", "carry", "vector", "adversarial"])
def test_parallel_matches_exact_and_reference(case):
    """The solver ≡ the exact recurrence and ≡ `afp_tpu`'s solver within
    −105 dB: restarting at d[0], carrying a gain, [B] α vectors, and a
    jagged random desired gain (many branch flips)."""
    B, T = 4, 2048
    a_att, a_rel = agc_alphas(512)
    d = desired(B, T, seed=2)
    init = None
    if case == "carry":
        init = torch.tensor([0.5, 1.0, 2.0, 8.0])
    elif case == "vector":
        a_att = torch.tensor([agc_alphas(512, at, 0.1)[0] for at in (0.005, 0.01, 0.02, 0.05)])
        a_rel = torch.tensor([agc_alphas(512, 0.01, r)[1] for r in (0.05, 0.1, 0.2, 0.5)])
    elif case == "adversarial":
        d = torch.from_numpy(np.random.default_rng(3).uniform(0.1, 10, (B, T))
                             .astype(np.float32))
    g, iters, _ = _smooth_gain_parallel(d, a_att, a_rel, init=init)
    exact = smooth_gain_scan(d, a_att, a_rel, init=init)
    ref = np.asarray(j_parallel(jnp.asarray(d.numpy()), jnp.asarray(np.asarray(a_att, np.float32)),
                                jnp.asarray(np.asarray(a_rel, np.float32)),
                                init=None if init is None else jnp.asarray(init.numpy())))
    e_exact, e_ref = err_db(g, exact), err_db(g, ref)
    print(f"parallel {case}: {iters} solves, {e_exact:.1f} dB vs exact, "
          f"{e_ref:.1f} dB vs afp_tpu's solver")
    assert g.shape == d.shape and 1 <= iters <= 24
    assert e_exact < SOLVER_DB and e_ref < SOLVER_DB


def test_parallel_edges():
    """One sample restarts to d itself; max_iters bounds the solves."""
    d = torch.tensor([[3.0], [4.0]])
    assert torch.equal(smooth_gain_parallel(d, 0.5, 0.1), d)
    g, it, _ = _smooth_gain_parallel(desired(2, 512, seed=4), 0.5, 0.01,
                                     max_iters=1)
    assert it == 1 and torch.isfinite(g).all()
    assert torch.equal(g, smooth_gain_parallel(desired(2, 512, seed=4), 0.5,
                                               0.01, max_iters=1))


def test_parallel_at_the_gain_clip_stops_at_its_cap_as_the_reference_does():
    """The smoke's C8 input (noise at 0.1, every 7th stream at 0.02×, so
    its desired gain sits at `max_gain` = 10): the loop runs all 24
    solves in the port and in `afp_tpu` alike (its output still changes
    from the 23rd solve to the 24th), and every decision still flipping
    at the cap is a tie at the clip, d = 10 with |d − g[t−1]| within a few
    ulp of 10; the gains agree with the exact recurrence within −105 dB."""
    B, T, max_gain = 14, 2048, 10.0
    x = np.random.default_rng(93).standard_normal((B, T)).astype(np.float32) * 0.1
    x[::7] *= 0.02
    d = desired_gain(moving_rms(torch.from_numpy(x), 512), 0.1, max_gain)
    a_att, a_rel = agc_alphas(512)
    ones = torch.ones(B)
    g, iters, flips = _smooth_gain_parallel(d, a_att, a_rel, init=ones)
    g_prev = torch.cat([ones[:, None], g[:, :-1]], dim=1)
    gap = (d - g_prev)[flips].abs()
    dj = jnp.asarray(d.numpy())
    ref = [np.asarray(j_parallel(dj, float(a_att), float(a_rel), init=jnp.ones(B),
                                 max_iters=k)) for k in (23, 24)]
    quiet = sorted(set(flips.nonzero()[:, 0].tolist()))
    e_exact = err_db(g, smooth_gain_scan(d, a_att, a_rel, init=ones))
    e_ref = err_db(g, ref[1])
    print(f"gain clip: port {iters} solves, afp_tpu's output changes from solve "
          f"23 to 24: {not np.array_equal(*ref)}; {int(flips.sum())} decisions "
          f"still flipping at the cap, in streams {quiet}, d there "
          f"{float(d[flips].min()):g}..{float(d[flips].max()):g}, |d - g[t-1]| "
          f"<= {float(gap.max()):.3g}; {e_exact:.1f} dB vs exact, {e_ref:.1f} dB "
          f"vs afp_tpu")
    assert iters == 24 and not np.array_equal(*ref)
    assert quiet and set(quiet) <= set(range(0, B, 7))
    ulp = 2.0 ** -20  # of 10 in f32
    assert bool((d[flips] == max_gain).all()) and float(gap.max()) < 16 * ulp
    assert e_exact < SOLVER_DB and e_ref < SOLVER_DB


@pytest.mark.parametrize("strategy", ["fft", "td_mxu"])
def test_pipeline_parallel_matches_exact_and_reference(strategy):
    """agc_mode='parallel' in the pipeline: K5's batch-major desired gain,
    the solver, the torch clip and apply, then the conv on the f32 block
    (K1 on 'td_mxu'); the gained block and the gain carry ≡ the exact mode's
    (−105 dB), the chain ≡ the exact chain and `afp_tpu`'s parallel
    pipeline (≤ −100 dB: the bf16×3 conv splits two inputs a few ulp
    apart); no ring form."""
    kw = dict(samplerate=44100, blocksize=512, upsample_factor=2, numtaps=33,
              batch=4, agc_enabled=True, agc_mode="parallel",
              agc_window_size=128, agc_link_group=2, output_clip=0.99,
              dither_kind="off", conv_strategy=strategy)
    x = np.random.default_rng(5).standard_normal((4, 4 * 512)).astype(np.float32) * 0.3
    x[:, 700:1500] *= 0.02

    def port(mode):
        p = Pipeline(StreamConfig(**dict(kw, agc_mode=mode)), "cpu")
        params = p.device_params(PipelineParams.design(p.cfg))
        gained = p._agc(params, torch.from_numpy(x[:, :512]), torch.ones(4),
                        emit_split=False)[0]
        return p, gained, p.process_signal(params, p.init_state(),
                                           torch.from_numpy(x))

    p, gained, (st, ours) = port("parallel")
    _, gained_exact, (st_exact, exact) = port("exact")
    assert not p._pair_tail and not p.supports_ring_step
    jp = JPipeline(JConfig(**kw))
    _, ref = jp.process_signal(jp.device_params(JParams.design(jp.cfg)),
                               jp.init_state(0), jnp.asarray(x))
    e_exact, e_ref = err_db(ours, exact), err_db(ours, np.asarray(ref))
    e_gain = err_db(st.agc_gain, st_exact.agc_gain)
    e_agc = err_db(gained, gained_exact)
    print(f"pipeline parallel {strategy}: gained block {e_agc:.1f} dB and gain "
          f"carry {e_gain:.1f} dB vs exact mode; chain {e_exact:.1f} dB vs exact "
          f"mode, {e_ref:.1f} dB vs afp_tpu")
    assert e_agc < SOLVER_DB and e_gain < SOLVER_DB
    assert e_exact <= CHAIN_DB and e_ref <= CHAIN_DB
