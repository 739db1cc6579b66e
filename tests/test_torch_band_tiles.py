"""The tensor-core conv's operands on the CPU: `band_tiles` (the Toeplitz
tiles in the mma B-fragment order, `csrc/band_mma.cuh`) against `afp_tpu`'s
`band_matrix` / `wide_band_matrix` entry by entry, the exact three-way bf16
split of HIGHEST, and a plain torch model of the kernels' route (the window
cut into 16-position k-steps per 8-output column tile against the decoded
tiles, summed in chunks of `ACC_STEPS` k-steps; bf16×3 or the six products,
fp32 sums): K11's against `afp_tpu`'s `fir_td_mxu_per_stream`, and the
body's one-band route (K1 and its forms, walked in the window chunks of
`conv_geometry`) against `afp_tpu`'s `fir_td_mxu`, both in interpret mode,
and the port's plain versions; the body's bank pass over an m16 tile that
holds two designs; and the body's geometry against the 227 KB of shared
memory.

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
               highest: bool, window_steps: int | None = None) -> np.ndarray:
    """The kernels' route in plain torch: for each band, the output column
    tile at c0 takes the window positions c0 + 16s .. c0 + 16s + 15 against
    tile s (s ascending), each product of bf16 halves exact in fp32 (fp32
    matmuls); the steps go in window chunks of `window_steps` (default all
    S) and, inside them, in accumulation chunks of ACC_STEPS, each summed
    alone and mixed y = y + g·z_chunk in order (the body: one band, g = 1)."""
    x = torch.from_numpy(x_ext)
    B, text = x.shape
    K, n = kernels.shape
    T = text - (n - 1)
    S = F.band_steps(n)
    C = window_steps or S
    tiles = decode(F.band_tiles(torch.from_numpy(kernels), highest))
    halves = [h.float() for h in (F.split3_bf16(x) if highest else F.split_bf16(x))]
    pad = T - 8 + 16 * S - text
    halves = [torch.nn.functional.pad(h, (0, pad)) for h in halves]
    pairs = ([(0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)] if highest
             else [(0, 0), (0, 1), (1, 0)])
    y = torch.zeros((B, T))
    for k in range(K):
        for c0 in range(0, S, C):
            for a0 in range(c0, min(c0 + C, S), F.ACC_STEPS):
                z = torch.zeros((B, T // 8, 8))
                for s in range(a0, min(a0 + F.ACC_STEPS, c0 + C, S)):
                    for a, b in pairs:
                        w = halves[a][:, 16 * s:].unfold(1, 16, 8)[:, : T // 8]  # [B, T/8, 16]
                        z = z + w @ tiles[k, s, b]
                y = y + torch.from_numpy(gains[:, k:k + 1]) * z.reshape(B, T)
    return y.numpy()


def bank_tile_model(x_ext: np.ndarray, bank: np.ndarray, assign: np.ndarray,
                    highest: bool = False) -> np.ndarray:
    """The body's bank option in plain torch: per block of `conv_geometry`'s
    rows, one pass of the whole block per distinct design among its 8-row
    groups (in group order), each chunk sum added only to the rows of that
    pass's groups; rows of an entry outside the bank NaN."""
    B = x_ext.shape[0]
    bt = B // len(assign)
    rows = np.repeat(assign, bt)
    D = bank.shape[0]
    R = F.conv_geometry(bank.shape[1], highest)["rows"]
    y = np.zeros((B, x_ext.shape[1] - bank.shape[1] + 1), np.float32)
    for b0 in range(0, B, R):
        groups = [int(rows[b]) for b in range(b0, min(b0 + R, B), 8)]
        for d in dict.fromkeys(g for g in groups if 0 <= g < D):
            z = tile_model(x_ext[b0:b0 + R], bank[d:d + 1], np.ones(
                (min(R, B - b0), 1), np.float32), highest)
            for i, g in enumerate(groups):
                if g == d:
                    y[b0 + 8 * i: b0 + 8 * i + 8] = z[8 * i: 8 * i + 8]
    y[(rows < 0) | (rows >= D)] = np.nan
    return y


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


def window_chunk_edges(highest: bool) -> list[tuple[int, int]]:
    """(tap count, window chunks) at the edges of `conv_geometry`'s window
    chunks: the last tap count of one chunk, the first of two and the first
    of three."""
    edges, last, n = [], 1, 1
    while len(edges) < 3:
        chunks = F.conv_geometry(n, highest)["chunks"]
        if chunks > last:
            edges += [(n - 1, last)] if not edges else []
            edges.append((n, chunks))
            last = chunks
        n += 1
    return edges


#: (highest, tap count, window chunks) of the body's route: one tap, one
#: k-step's edge (16, 17), the last tap count of one accumulation chunk and
#: the first of two, 1151, and the window-chunk edges at each precision
ROUTE = [(hi, n, c) for hi in (False, True)
         for n, c in [(n, F.conv_geometry(n, hi)["chunks"])
                      for n in (1, 16, 17, 16 * F.ACC_STEPS - 7, 16 * F.ACC_STEPS - 6, 1151)]
         + window_chunk_edges(hi)]


@pytest.mark.parametrize("highest,n,chunks", ROUTE)
def test_one_band_route_matches(n, highest, chunks):
    """The body's route (one band, no mix, the window chunks of
    `conv_geometry` and the accumulation chunks) against `afp_tpu`'s
    `fir_td_mxu` at the same precision (interpret mode) and against the
    port's plain K1: ≤ −110 dB.  At the window-chunk edges the geometry
    takes 1, 2 and 3 chunks (bf16×3 2057, 2058, 4090; HIGHEST 1225, 1226,
    2042)."""
    B, T = 8, 128
    x, h = randn(B, n - 1 + T, seed=n), randn(1, n, seed=n + 1)
    prec = "HIGHEST" if highest else "B3"
    geo = F.conv_geometry(n, highest)
    assert geo["chunks"] == chunks and (chunks == 1) == (geo["C"] == geo["S"])
    got = tile_model(x, h, np.ones((B, 1), np.float32), highest, geo["C"])
    want = np.asarray(jfir.fir_td_mxu(jnp.asarray(x), jfir.band_matrix(h[0]),
                                      interpret=True, precision=prec))
    plain = F.fir_td_mxu_plain(torch.from_numpy(x), torch.from_numpy(h[0]),
                               precision=prec).numpy()
    e_ref, e_plain = err_db(got, want), err_db(got, plain)
    print(f"one-band route {prec} n={n} (S={geo['S']}, {chunks} window chunks of {geo['C']}, "
          f"sums in chunks of {F.ACC_STEPS}): {e_ref:.1f} dB vs afp_tpu, "
          f"{e_plain:.1f} dB vs the port's plain K1 (bound {CONV_DB})")
    assert got.shape == (B, T) and e_ref <= CONV_DB and e_plain <= CONV_DB


@pytest.mark.parametrize("highest", [False, True])
@pytest.mark.parametrize("n,C", [(300, 16), (1151, 32), (1151, 48)])
def test_window_chunks_keep_the_order(n, C, highest):
    """The route walked in window chunks of C steps (a multiple of
    ACC_STEPS, fewer than S) equals the one-pass route bit for bit, since
    the accumulation chunks and their order stay the same; ≤ −110 dB
    against the port's plain K1."""
    B, T = 4, 128
    x, h = randn(B, n - 1 + T, seed=n + C), randn(1, n, seed=n + C + 1)
    ones = np.ones((B, 1), np.float32)
    assert C % F.ACC_STEPS == 0 and C < F.band_steps(n)
    got = tile_model(x, h, ones, highest, C)
    assert np.array_equal(got, tile_model(x, h, ones, highest))
    plain = F.fir_td_mxu_plain(torch.from_numpy(x), torch.from_numpy(h[0]),
                               precision="HIGHEST" if highest else "B3").numpy()
    e = err_db(got, plain)
    print(f"window chunks of {C} at n={n} highest={highest}: == one pass bit for bit; "
          f"{e:.1f} dB vs the plain K1 (bound {CONV_DB})")
    assert e <= CONV_DB


@pytest.mark.parametrize("n", [17, 300])
def test_bank_tile_two_designs(n):
    """bt = 8: two designs alternate in every m16 tile (and a third, and
    one entry outside the bank, in later tiles).  The bank pass model's rows
    equal the shared-taps model on each row's design, bit for bit, and the
    bad entry's rows are NaN; against the port's plain K10 ≤ −110 dB."""
    B, T, D = 48, 128, 3
    x, bank = randn(B, n - 1 + T, seed=7), randn(D, n, seed=8)
    assign = np.array([0, 1, 0, 1, 2, 5], np.int32)
    got = bank_tile_model(x, bank, assign)
    rows = np.repeat(assign, 8)
    ones = np.ones((B, 1), np.float32)
    for d in range(D):
        shared = tile_model(x, bank[d:d + 1], ones, False)
        assert np.array_equal(got[rows == d], shared[rows == d]), d
    assert np.isnan(got[rows == 5]).all() and not np.isnan(got[rows != 5]).any()
    plain = F.fir_td_mxu_banked_plain(torch.from_numpy(x), torch.from_numpy(bank),
                                      torch.from_numpy(assign)).numpy()
    e = err_db(got[rows != 5], plain[rows != 5])
    print(f"bank tile n={n}: rows == the shared model on their design bit for bit; "
          f"{e:.1f} dB vs the plain K10 (bound {CONV_DB})")
    assert e <= CONV_DB


def _config_taps() -> list[int]:
    """n_casc of the smoke's configurations (C5, C8, the quick start) and of
    the largest the config allows (2048 taps with the EQ, no resampling)."""
    from afp_tpu_torch.engine import Pipeline, StreamConfig

    cfgs = [dict(samplerate=44100, blocksize=4096, upsample_factor=4, numtaps=1001,
                 cutoff=11000.0, resample_quality="vhq", eq_enabled=False,
                 downsample_mode="decimate"),
            dict(samplerate=44100, blocksize=2048, upsample_factor=2, numtaps=129,
                 cutoff=14000.0, eq_enabled=True, downsample_mode="decimate"),
            dict(samplerate=44100, blocksize=4096, upsample_factor=4, numtaps=1001,
                 cutoff=11000.0, eq_enabled=True),
            dict(samplerate=44100, blocksize=4096, upsample_factor=1, numtaps=2048,
                 cutoff=11000.0, eq_enabled=True, min_phase=False)]
    return [Pipeline(StreamConfig(conv_strategy="td_mxu", batch=2, **c), "cpu").n_casc
            for c in cfgs]


#: tap counts of `tests/test_torch_cuda.py`
CARD_TAPS = [1, 2, 15, 16, 17, 31, 41, 42, 65, 129, 209, 249, 250, 300, 379, 457,
             1151, 1225, 1226, 2042, 2057, 2058, 4090]


@pytest.mark.parametrize("highest", [False, True])
def test_conv_geometry_fits(highest):
    """Every tap count of the card tests, the configurations' largest
    n_casc and 16384 taps fit one block's 227 KB of shared memory (no tap
    count raises); the card tests cover the window-chunk edges; the chunks are
    whole accumulation chunks (or all S steps) and cover S; the C5 and C8
    cascades take one window chunk."""
    taps = _config_taps()
    assert taps[0] == 379 and taps[1] == 209
    worst = 0
    for n in CARD_TAPS + taps + [16384]:
        g = F.conv_geometry(n, highest)
        assert g["smem"] <= 227 * 1024 and g["S"] == F.band_steps(n)
        assert g["C"] == g["S"] or g["C"] % F.ACC_STEPS == 0
        assert g["chunks"] * g["C"] >= g["S"] > (g["chunks"] - 1) * g["C"]
        assert g["W"] == g["cols"] - 8 + 16 * g["C"] and g["wp"] % 64 == 8
        worst = max(worst, g["smem"])
    for n in taps[:2]:
        assert F.conv_geometry(n, highest)["chunks"] == 1
    for n, chunks in window_chunk_edges(highest):
        assert n in CARD_TAPS and F.conv_geometry(n, highest)["chunks"] == chunks
    print(f"conv geometry {'HIGHEST' if highest else 'B3'}: taps {CARD_TAPS + taps} "
          f"fit, at most {worst} B of {227 * 1024} (largest n_casc {max(taps)})")
