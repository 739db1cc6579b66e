"""K9, the standalone AGC recurrence (`ops/cuda/agc_scan.py:smooth_gain_scan`),
against `afp_tpu` on the CPU: its plain version against
`smooth_gain_scan_pallas` in interpret mode at the shapes of
`tests/test_pallas.py:134-158` (batches that fill no tile, 300 and 17, and
both input layouts), and `apply_agc`, whose recurrence is K9 on the card.

Inputs are made with numpy from a seed and handed to both packages.  The
bounds: against `afp_tpu`'s `smooth_gain_scan` bit for bit; against its
Pallas kernel the reference's own bound, atol 1e-6 (its restart runs one
recurrence step from g = d[0], where the scan and K9 take d[0] itself; the
measured ulps are printed)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.ops import agc as jagc
from afp_tpu.ops.pallas.agc_scan import smooth_gain_scan_pallas
from afp_tpu_torch.ops import agc as tagc
from afp_tpu_torch.ops.cuda import agc_scan as S


def ulps(a, b) -> int:
    ia = np.asarray(a, dtype=np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, dtype=np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(ia - ib)))


@pytest.mark.parametrize("B,T,pallas", [(300, 1024, True), (128, 2048, False),
                                         (17, 256, True)])
@pytest.mark.parametrize("time_major", [False, True])
def test_scan_layouts_match(B, T, pallas, time_major):
    """Plain K9 in both layouts (either store) against the lax.scan
    recurrence and, at the batches that fill no tile, the Pallas scan (each
    new shape costs it a ~10 s interpret-mode compile), with the restart and
    with the carry."""
    rng = np.random.default_rng(B + T)
    d = rng.uniform(0.1, 4.0, size=(B, T)).astype(np.float32)
    init = rng.uniform(0.5, 2.0, size=(B,)).astype(np.float32)
    din = np.ascontiguousarray(d.T) if time_major else d
    for ini in (None, init):
        jinit = None if ini is None else jnp.asarray(ini)
        gold = np.asarray(jagc.smooth_gain_scan(jnp.asarray(d), 0.15, 0.013, init=jinit))
        for bm in (False, True):
            got = S.smooth_gain_scan(torch.from_numpy(din), 0.15, 0.013,
                                     init=None if ini is None else torch.from_numpy(ini),
                                     time_major=time_major, out_batch_major=bm).numpy()
            assert got.shape == (B, T) and np.array_equal(got, gold)
        if not pallas:
            continue
        want = np.asarray(smooth_gain_scan_pallas(
            jnp.asarray(din), 0.15, 0.013, init=jinit, interpret=True,
            time_major=time_major, out_batch_major=True))
        print(f"K9 B={B} T={T} time_major={time_major} init={ini is not None}: "
              f"== lax.scan bit for bit, {ulps(got, want)} ulp from the Pallas scan")
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_scan_leading_axes_and_checks():
    """[..., T] input keeps its leading axes; the plain version is
    `ops.agc.smooth_gain_scan`; no kernel launches on the CPU."""
    d = torch.from_numpy(np.random.default_rng(1).uniform(0.1, 4.0, (2, 3, 64))
                         .astype(np.float32))
    init = torch.full((2, 3), 1.5)
    before = S.smooth_gain_scan.launches
    got = S.smooth_gain_scan(d, 0.2, 0.01, init=init)
    assert got.shape == (2, 3, 64)
    assert torch.equal(got, tagc.smooth_gain_scan(d, 0.2, 0.01, init))
    assert S.smooth_gain_scan.launches == before
    with pytest.raises(ValueError, match="float32"):
        S.smooth_gain_scan(d.double(), 0.2, 0.01)
    with pytest.raises(ValueError, match="time_major"):
        S.smooth_gain_scan(d, 0.2, 0.01, time_major=True)


@pytest.mark.parametrize("carry", [False, True])
def test_apply_agc_matches(carry):
    """`apply_agc` (K9's path on the card, plain here) against `afp_tpu`'s,
    block by block with the carried gain: ≤ −100 dB (the moving RMS runs
    through two FFT libraries) and the gain bit-exact given the same d."""
    x = (np.random.default_rng(2).standard_normal((4, 3, 512)) * 0.1).astype(np.float32)
    x[0, 0] *= 8.0
    tp, jp = tagc.AGCParams(window_size=128), jagc.AGCParams(window_size=128)
    tc = jc = None
    for blk in x:
        ty, tc = tagc.apply_agc(torch.from_numpy(blk), tp, tc if carry else None)
        jy, jc = jagc.apply_agc(jnp.asarray(blk), jp, jc if carry else None)
        e = 20 * np.log10(np.max(np.abs(ty.numpy() - np.asarray(jy)))
                          / np.max(np.abs(np.asarray(jy))) + 1e-300)
        print(f"apply_agc carry={carry}: {e:.1f} dB")
        assert e <= -100.0
    d = tagc.desired_gain(tagc.moving_rms(torch.from_numpy(x[0]), 128), 0.1, 10.0)
    g = S.smooth_gain_scan(d, tp.a_att, tp.a_rel)
    assert np.array_equal(g.numpy(), np.asarray(
        jagc.smooth_gain_scan(jnp.asarray(d.numpy()), jp.a_att, jp.a_rel)))
