"""K11's tensor-core operands on the CPU: `band_tiles` (the Toeplitz tiles in
the mma B-fragment order, `csrc/band_mma.cuh`) against `afp_tpu`'s
`band_matrix` / `wide_band_matrix` entry by entry, the exact three-way bf16
split of HIGHEST, and a plain torch model of the kernel's route (the window
cut into 16-position k-steps per 8-output column tile against the decoded
tiles; bf16×3 or the six products, fp32 sums) against `afp_tpu`'s
`fir_td_mxu_per_stream` in interpret mode and the port's plain version.

Inputs are made with numpy from a seed and handed to both packages.  Each
test states its bound and prints the measured value."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from afp_tpu.ops.pallas import fir_td as jfir
from afp_tpu_torch.ops.cuda import fir_td as F

CONV_DB = -110.0  # bf16×3, or fp32-class products, summed in another order


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def randn(*shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def decode(tiles: torch.Tensor) -> torch.Tensor:
    """[K, S, P, 32, 4] fragment-order tiles → [K, S, P, 16, 8] f32 tiles
    B[i][j]: lane l = 4g + t holds B[2t][g], B[2t+1][g], B[2t+8][g],
    B[2t+9][g]."""
    K, S, P = tiles.shape[:3]
    out = torch.zeros((K, S, P, 16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e, i in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
            out[..., i, g] = tiles[..., lane, e].float()
    return out


def tile_model(x_ext: np.ndarray, kernels: np.ndarray, gains: np.ndarray,
               highest: bool) -> np.ndarray:
    """The kernel's route in plain torch: for each band, the output column
    tile at c0 takes the window positions c0 + 16s .. c0 + 16s + 15 against
    tile s (s ascending), each product of bf16 halves exact in fp32 (fp32
    matmuls), then the mix y = y + g·z in band order."""
    x = torch.from_numpy(x_ext)
    B, text = x.shape
    K, n = kernels.shape
    T = text - (n - 1)
    S = F.band_steps(n)
    tiles = decode(F.band_tiles(torch.from_numpy(kernels), highest))
    halves = [h.float() for h in (F.split3_bf16(x) if highest else F.split_bf16(x))]
    pad = T - 8 + 16 * S - text
    halves = [torch.nn.functional.pad(h, (0, pad)) for h in halves]
    pairs = ([(0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)] if highest
             else [(0, 0), (0, 1), (1, 0)])
    y = torch.zeros((B, T))
    for k in range(K):
        z = torch.zeros((B, T // 8, 8))
        for s in range(S):
            for a, b in pairs:
                w = halves[a][:, 16 * s:].unfold(1, 16, 8)[:, : T // 8]  # [B, T/8, 16]
                z = z + w @ tiles[k, s, b]
        y = y + torch.from_numpy(gains[:, k:k + 1]) * z.reshape(B, T)
    return y.numpy()


@pytest.mark.parametrize("n", [1, 15, 16, 17, 209])
@pytest.mark.parametrize("highest", [False, True])
def test_band_tiles_match_band_matrix(n, highest):
    """Every tile entry, at every 8-output column tile c0 of a LANE-wide
    output tile, is the split of `wide_band_matrix`'s entry [c0 + 16s + i,
    k·128 + c0 + j] (zero where the row lies past the band's n−1+128 rows),
    exactly: hi and lo are `afp_tpu`'s `split_bf16` halves (B3); hi, mid
    and lo are its split of the entry and of its remainder (HIGHEST)."""
    K = 3
    kernels = randn(K, n, seed=n)
    wide = np.asarray(jfir.wide_band_matrix(jnp.asarray(kernels)))  # [n-1+128, K*128]
    assert np.array_equal(wide[:, :128], jfir.band_matrix(kernels[0]))
    hi, lo = (np.asarray(h).astype(np.float32) for h in jfir.split_bf16(jnp.asarray(wide)))
    halves = [hi, lo]
    if highest:
        rest = jnp.asarray(wide - hi - lo)
        halves.append(np.asarray(rest.astype(jnp.bfloat16)).astype(np.float32))
    tiles = decode(F.band_tiles(torch.from_numpy(kernels), highest)).numpy()
    S = F.band_steps(n)
    assert tiles.shape == (K, S, len(halves), 16, 8)
    rows = n - 1 + 128
    checked = 0
    for k in range(K):
        for c0 in range(0, 128, 8):
            for s in range(S):
                r = c0 + 16 * s + np.arange(16)
                inside = r < rows
                for p, h in enumerate(halves):
                    want = np.zeros((16, 8), np.float32)
                    want[inside] = h[r[inside], k * 128 + c0: k * 128 + c0 + 8]
                    assert np.array_equal(tiles[k, s, p], want), (k, c0, s, p)
                    checked += want.size
        # the steps cover every nonzero entry of the band's columns
        assert S * 16 >= n + 7
    print(f"band_tiles n={n} highest={highest}: {checked} entries equal "
          f"(K={K}, S={S})")


def test_cached_band_tiles_follow_the_kernels():
    """K11's tile memo: the same kernels tensor reuses its tiles; an
    in-place write, another tensor or the other precision builds them
    again, equal to `band_tiles` each time."""
    k = torch.from_numpy(randn(3, 20, seed=4))
    t1 = F.cached_band_tiles(k, False)
    assert F.cached_band_tiles(k, False) is t1
    assert torch.equal(t1, F.band_tiles(k))
    t3 = F.cached_band_tiles(k, True)
    assert t3.shape[2] == 3 and torch.equal(t3, F.band_tiles(k, True))
    k.mul_(2.0)
    t2 = F.cached_band_tiles(k, False)
    assert t2 is not t1 and torch.equal(t2, F.band_tiles(k))
    other = k.clone()
    assert F.cached_band_tiles(other, False) is not t2


def _edge_values() -> np.ndarray:
    """Finite f32 edge cases: signed zeros, powers of two, all-ones and
    tie mantissas at low, middle and high exponents, the split's range
    limits."""
    bits = []
    for e in (17, 60, 127, 140, 200, 253):  # biased exponents
        for m in (0, 0x7FFFFF, 0x008000, 0x018000, 0x00FFFF, 0x7F7FFF,
                  0x400001, 0x000001, 0x7F0000, 0x00007F, 0x555555):
            bits.append((e << 23) | m)
    v = np.array(bits, dtype=np.uint32).view(np.float32)
    v = np.concatenate([v, -v, np.float32([0.0, -0.0, 2.0 ** -110,
                                           np.float32(3.38e38)])])
    return v.astype(np.float32)


@pytest.mark.parametrize("data", ["random", "edge"])
def test_split3_is_exact(data):
    """hi + mid + lo == v exactly (summed in float64), each half a bf16
    value, hi and mid the `split_bf16` pair; on random f32 over 2⁻¹⁰⁰ ..
    2¹⁰⁰ and on the edge cases."""
    if data == "random":
        rng = np.random.default_rng(3)
        v = (rng.standard_normal(200_000)
             * 2.0 ** rng.uniform(-100, 100, 200_000)).astype(np.float32)
    else:
        v = _edge_values()
    t = torch.from_numpy(v)
    hi, mid, lo = F.split3_bf16(t)
    h2, l2 = F.split_bf16(t)
    assert torch.equal(hi, h2) and torch.equal(mid, l2)
    total = (hi.double() + mid.double() + lo.double()).numpy()
    bad = int(np.sum(total != v.astype(np.float64)))
    print(f"split3 {data}: {bad} of {v.size} values not exact (bound 0)")
    assert bad == 0


@pytest.mark.parametrize("highest", [False, True])
@pytest.mark.parametrize("B,T,n,K", [(5, 256, 33, 4), (3, 128, 17, 9)])
def test_tile_model_matches(highest, B, T, n, K):
    """The kernel's route (bf16×3, or the six products of the three-way
    split), modelled in plain torch, against `afp_tpu`'s
    `fir_td_mxu_per_stream` at the same precision (interpret mode, B padded
    to its batch tile) and against the port's plain version: ≤ −110 dB."""
    x, k = randn(B, n - 1 + T), randn(K, n, seed=1)
    g = np.random.default_rng(2).uniform(0, 2, (B, K)).astype(np.float32)
    prec = "HIGHEST" if highest else "B3"
    got = tile_model(x, k, g, highest)
    Bp = 8  # afp_tpu refuses a batch that is not a multiple of its tile
    xp = np.concatenate([x, np.zeros((Bp - B, x.shape[1]), np.float32)])
    gp = np.concatenate([g, np.zeros((Bp - B, K), np.float32)])
    want = np.asarray(jfir.fir_td_mxu_per_stream(
        jnp.asarray(xp), jnp.asarray(k), jnp.asarray(gp), interpret=True,
        precision=prec))[:B]
    plain = F.fir_td_mxu_per_stream_plain(torch.from_numpy(x), torch.from_numpy(k),
                                          torch.from_numpy(g), precision=prec).numpy()
    e_ref, e_plain = err_db(got, want), err_db(got, plain)
    print(f"tile model {prec} B={B} T={T} n={n} K={K}: {e_ref:.1f} dB vs afp_tpu, "
          f"{e_plain:.1f} dB vs the port's plain version (bound {CONV_DB})")
    assert got.shape == want.shape and e_ref <= CONV_DB and e_plain <= CONV_DB
