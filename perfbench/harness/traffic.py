"""The one general traffic generator: every input of a run, from `--seed`.

A mix file (``perfbench/traffic/<mix>.json``) gives the parameters:

* ``loop``: the loop that drives the program (``perfbench/loops/``);
* ``wire``: ``f32`` or ``pcm16`` (16-bit PCM in and out: the configuration
  runs with ``ingest='pcm16'`` and ``emit='pcm16'``, and the blocks are
  int16, ``n/32768`` full scale, saturated as a converter would);
* ``pool_blocks``: distinct [batch, blocksize] blocks the loop cycles
  through (the carried tail, gain and dither counter keep every output
  distinct);
* ``level_dbfs``: [low, high] of each stream's RMS level in dB relative to
  full scale 1.0, drawn uniformly per stream and per level segment;
* ``level_step_blocks``: blocks per level segment (speech and programme
  changes: the AGC moves, and a few loud rows clip);
* ``tones``, ``tone_hz``: sines per stream, frequencies log-uniform in
  [low, high], random phases, continuous across the pool's blocks;
* ``noise_db``: white noise beside the tones, in dB relative to them.

Everything is drawn on the run's device by a seeded ``torch.Generator``
in a few large calls, then held on the host, which is where the program's
callers hold audio.  The program receives only these blocks.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["make_pool", "WIRES"]

WIRES = {"f32": {}, "pcm16": {"ingest": "pcm16", "emit": "pcm16"}}


def make_pool(mix: dict, batch: int, block: int, samplerate: float,
              seed: int, device) -> np.ndarray:
    """The pool [pool_blocks, batch, block] of input blocks (float32, or
    int16 under the pcm16 wire)."""
    import torch

    P = int(mix["pool_blocks"])
    J = int(mix["tones"])
    step = int(mix["level_step_blocks"])
    lo_db, hi_db = (float(v) for v in mix["level_dbfs"])
    f_lo, f_hi = (float(v) for v in mix["tone_hz"])
    rel = 10.0 ** (float(mix["noise_db"]) / 20.0)
    a_tone, a_noise = 1.0 / math.sqrt(1.0 + rel * rel), rel / math.sqrt(1.0 + rel * rel)
    pcm16 = mix["wire"] == "pcm16"
    if mix["wire"] not in WIRES:
        raise ValueError(f"wire {mix['wire']!r}")

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    freqs = torch.exp(math.log(f_lo) + torch.rand(batch, J, 1, **f64)
                      * (math.log(f_hi) - math.log(f_lo)))
    phase = torch.rand(batch, J, 1, **f64) * (2 * math.pi)
    n_seg = -(-P // step)
    level = 10.0 ** ((lo_db + torch.rand(batch, n_seg, **f64) * (hi_db - lo_db)) / 20.0)
    omega = freqs * (2 * math.pi / samplerate)
    out = np.empty((P, batch, block), dtype=np.int16 if pcm16 else np.float32)
    for p in range(P):
        n = torch.arange(p * block, (p + 1) * block, dtype=torch.float64,
                         device=device)
        tones = torch.sin(torch.remainder(omega * n, 2 * math.pi) + phase).sum(1)
        noise = torch.randn(batch, block, dtype=torch.float64, device=device,
                            generator=g)
        x = (a_tone * math.sqrt(2.0 / J) * tones + a_noise * noise) \
            * level[:, p // step, None]
        if pcm16:
            x = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)
        else:
            x = x.to(torch.float32)
        torch.from_numpy(out[p]).copy_(x)
    return out
