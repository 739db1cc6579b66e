#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`afp_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each; any failure raises (exit code != 0):

1. the card's name and power limit (nvidia-smi); no CUDA device → exit 1;
2. build the CUDA kernels from `afp_tpu_torch/csrc` with nvcc (one nvcc per
   source, in parallel), and print ptxas's registers and spills of each
   instantiation of the conv kernels;
3. the conv body's geometry at C5 and C8 (`conv_geometry`, held against
   the built library's, `built_conv_geometry`), then each
   kernel against its plain PyTorch version on the same device tensors,
   both timed with CUDA events: the C5 kernels K1-K4 and K2 at the C5
   headline (conv ≤ −110 dB, clip and noise bit-exact), and the C8 AGC
   kernels at the C8 point (batch 4096, block 2048, W = 512): K5 ≤ −110 dB
   and ≡ its CPU model (`rms_desired_model`) bit for bit, K6 bit-exact, K8/K7 ≤ −110 dB with tails bit-exact and K7 ≡ K8; then the
   transport forms: K12 and K12-mega (int16 PCM rings reaching −32768 and
   32767) ≡ K3/K4 fed n/32768, K13 and K13-mega ≡ K3/K4 fed the split, each
   ≤ −110 dB against its plain version; the int16 store of K1, K3, K4, K7,
   K8, K12, K13 ≡ quantize_pcm16 of its own f32 output; K5/K6 on int16 x ≡
   f32 x of n/32768; then the per-stream banks: K10 at C5-bank (4 designs)
   and the banked K3, K4, K12, K12-mega, each ≤ −110 dB against its plain
   version and row by row ≡ its shared-taps form on that row's design; K11
   at C8-psg (9 bands, per-stream gains; the tensor-core kernel) ≤ −110 dB,
   its fused epilogue ≡ K11 → clip → K2 → quantize_pcm16, rows run alone ≡
   the same rows in the batch, its band tiles built on the card ≡ the CPU's,
   its pair forms (staged and into a ring slot) ≡ K11 on the f32 block;
   K5/K6 with [B] vectors ≡ the scalar runs per policy group; then the last
   three: K15's HIGHEST K1 at the C5 headline and HIGHEST K11 at C8-psg
   (the six-product tensor-core form, with K11's checks; ≤ −110 dB, B3F/B3C
   ≡ B3; K1 ≡ K11 run with the one band at gain 1.0, bit for bit, at B3
   and HIGHEST), K14 at the C8 point (f32, int16, pair store, ring slot; restart
   and carry; its device time beside K5 + K6's in the same call) and K9
   (both layouts, aligned and one element off, and both stores), each
   bit-exact against its plain version; and one F.conv1d (fp32, TF32 off) per conv shape as the
   library yardstick, printed beside K11's times;
4. `Pipeline.run` at the C5 headline (batch 4096, 8 blocks), and the
   single-stream chain against the float64 oracle of `bench.py:394-418`
   (< −90 dB); then the C8 chain (`bench.py:827-843`): 'exact' and 'fast'
   AGC, 8 blocks each at batch 4096, a batch-8 run against the port's CPU
   run (≤ −100 dB), and 4 streams × 4 blocks against a float64 oracle of
   AGC + chain (< −90 dB); then the transport forms: C5-i16io (int16 in
   and out, 8 blocks) and C8-i16io 'exact' and 'fast' (8 blocks each), each
   ≡ quantize_pcm16 of the f32 chain fed n/32768, and the C5-pcm16 (one
   stream × 4 blocks) and C8-pcm16 (4 streams × 4 blocks) oracles (< −90 dB;
   with int16 out, ≤ 1 LSB from the quantized oracle); then the banks:
   C5-bank (rows ≡ the shared pipeline on their design), C8-psg and
   C8-psagc 'exact' and 'fast' (each policy group ≡ its scalar pipeline),
   8 blocks each, and their oracles (one stream per design, 4 streams with
   their own gains, one stream per policy; < −90 dB); then C5-highest and
   C8-highest (``td_precision='HIGHEST'``, 8 blocks each) and their oracles,
   C8-one (``agc_one_kernel=True``, 8 blocks) and its oracle, the offline
   fold of a stereo file (C5 at batch 2 over 256 blocks, B3 and HIGHEST:
   fold ≡ scan bit for bit, dither off, both walls), and `apply_agc` at the
   C8 point on the card (K9) ≡ its plain run;
5. `RingServer` at the C5 headline (16 slots, chunk 4, 16 blocks),
   megakernel and per-step forms: bit-identical with dither on, ≤ −110 dB
   against staged steps with dither off; then the C8 chain's per-step ring
   (16 slots, chunk 4, 16 blocks) ≡ its staged steps, dither on; then
   C5-i16io and C5-pair, mega and per-step ≡ each other and ≡ the staged
   steps with dither on, and C8-i16io's per-step ring ≡ its staged steps;
   then C5-bank mega ≡ per-step ≡ staged, C5-bank-packed (interleaved
   designs, `packing=`) ≡ C5-bank in caller order, C5-i16io-bank mega ≡
   staged, C8-psagc's per-step ring ≡ staged, all with dither on; C8-one's
   per-step ring (K14 → K7) ≡ its staged steps, dither on;
6. `StreamEngine` with the README quick-start configuration ('fft', EQ on,
   batch 512): process_block ×4, set_eq_gains, ×2, process_signal; and with
   the C8 configuration: process_block ×4, apply_config with a new AGC
   target, ×2; then at C8-i16io the same with int16 blocks in and out and a
   float block refused; then QS-psg: per-stream gains [512, 9] after 4
   blocks, ≡ a Pipeline stepped alongside; no degradation-ladder fallback;
8. the CLI and the live stream (in-process `afp_tpu_torch.cli.main`, data
   made from a seed into `build/smoke_cli/`): `process` of a 60 s stereo
   24-bit file at the CLI defaults ('fft', K2), of a 60 s 16-bit file with
   ``--ingest pcm16 --emit pcm16`` (the fold, K8) and with ``--agc
   --agc-link`` (K5 → K6), each against the float64 oracle over its first
   43 blocks (< −90 dB; int16 ≤ 1 LSB from the quantized oracle); `batch`
   of 32 stereo 30 s 16-bit files in one fold dispatch with the C5 filter
   (``--upsample 4 --numtaps 1001 --cutoff 11000``) ≡ `process` of each
   file, bit for bit, and its ×realtime; `stream --lockstep` with the
   linked AGC ≡ its `process`, and 646 blocks + ``--checkpoint-out`` then
   ``--resume --skip-blocks 646`` ≡ the uninterrupted stream, bit for bit,
   dither on; a 5 s stream paced at the block rate (underruns, overruns,
   busy share); ``--fault-drop 50`` (counters as injected); `devices`
   lists the card.  Every run without a fault processed every block it
   was handed, with no replay and no design fallback (in lockstep no
   underrun and no silence either: the ladder swallows exceptions);
9. multirate and ASRC: (a) the literal multirate chain at the C5 headline
   filter (``fuse_rate_conversion=False``, 'fft', batch 4096 × 4 blocks of
   4096, nfft 32 768) ≡ the fused K1 chain within −90 dB on every row,
   < −90 dB against the float64 oracle on 2 rows, ``output_rate=
   'upsampled'`` [4096, 16 384] per block whose decimation ≡ the base
   output bit for bit, walls and peak memory; (b) compat ASRC: C8 from
   48 kHz at batch 64 (stateless: resample_poly, K5 → K6 → K8) and C5
   'td_mxu' from 88.2 kHz at batch 4096 (streaming, K1), each ≡ the port's
   CPU run of 8 rows (≤ −100 dB); (c) the CLI: ``process --samplerate
   44100`` of a 60 s 48 kHz stereo file (the exact frontend, 'fft', K2)
   and with ``--agc --agc-link`` (K5 → K6), ceil(n·44100/48000) samples,
   < −90 dB against the float64 oracle; ``process --output-rate
   upsampled`` of a 60 s 44.1 kHz file (twice the samples at 88.2 kHz);
   ``batch`` of 32 × 30 s 48 kHz files with ``--samplerate 44100``, 4 of
   them, drawn from the seed, ≡ ``process`` of each, bit for bit; (d)
   ``stream --lockstep --samplerate 44100`` ≡ its ``process``, and
   checkpointed at half with the frontend holding data, then resumed ≡
   uninterrupted, bit for bit, dither on, nothing fabricated; (e) ``agc_mode='parallel'`` on C8 at batch 4096 ≡
   the exact mode within −105 dB, its solve count, the decisions still
   flipping at its last solve, and its wall;
10. observation and control: (a) the carried waterfall at the C5 headline
   (batch 4096, 8 blocks, ring [4096, 50, 2049]): each pushed row ≡
   `spectrum_db` of the block emitted and the audio ≡ the chain without
   the waterfall, bit for bit, dither on, f32 and ``emit='pcm16'``, the
   42 oldest rows exactly −200, ms per block with and without it and the
   peak memory; (b) `RingServer`'s drain-side tap at C8 every 8 blocks:
   served ≡ untapped and the tap rows ≡ `spectrum_db_np` of the drained
   row, bit for bit, and the tap's host ms; (c) `EqualizerController` at
   the GUI defaults (`DEFAULT_CONFIG`, 'fft', batch 4096, a 1 kHz tone):
   a lockstep `start_stream` with `set_gain` and `apply_changes`
   mid-stream (glitch-free), the peak within one bin of the tone, then
   `start_ring_stream` over a 'td_mxu' `RingServer` (K3); (d) the CLI's
   `process --spectrum-plot --waterfall-plot` of a 60 s stereo file and
   `design --plot`: the plotted arrays (`cli.viz_arrays`, on the card)
   within −100 dB of a numpy recomputation from the written output, PNGs
   where matplotlib imports (the line says which); (e) the examples
   `waterfall_stream` and `ring_serving` in two subprocesses on the card,
   each exiting 0 with jax blocked;
11. the parallel layer, every mesh's shards on the one card: (a) stream DP
   at the C5 headline over 4 shards: sharded step, run (8 blocks), the
   fold and C5-bank ≡ the unsharded pipeline bit for bit (dither off),
   `RingServer` over the per-shard f32 rings
   (per step and mega) ≡ sharded run with dither on, decorrelated shards,
   run ≡ chained steps, ms per block sharded and unsharded, the peak
   memory; (b) C8 linked in pairs over 4 shards: staged and run_ring ≡
   unsharded; (c) `filter_long_signal` of 8 streams × ≈60 s through C5
   (4-way 'time' and 2×2 'streams'×'time' meshes), ≤ −100 dB against the
   streaming pipeline, and C8 with the AGC carry, ≤ −110 dB against the
   streaming pipeline at ``td_precision='HIGHEST'``, < −90 dB against the
   oracle on the first blocks; the shard hand-off (C8, 8 blocks over 4
   shards, the gain clipped at 0.1 in loud shards) < −90 dB against the
   oracle over the whole signal; K2 under ``dither_seed``; (d)
   `KernelParallelConv` of 50 000 taps over 8 shards ≤ −100 dB against
   `OverlapSave`, with a `with_kernel` swap; (e) ``--mesh 2`` on one card
   refused with the reference's message, ``process``/``batch --mesh 4``
   on 4 shards of the card ≡ ``--mesh 1`` bit for bit, and the example
   `long_kernel_parallel` in a subprocess;
7. every kernel (K1-K15) and every option (the bank option of K3, K4, K12;
   the vector option of K5, K6; the HIGHEST option of K1 and K11, K15)
   launched during phases 4-6 and 8-11, and each transport, bank,
   last-slice, CLI, multirate, observation and parallel phase (and each
   CLI run) launched its own.

Then, as its last three lines: the nvidia-smi line, one JSON object with
each kernel's launches, error, times (CUDA events over back-to-back calls;
for K2, K5, K6, K9 and K14, whose kernels are about as short as their
wrappers' host time or shorter, also ``device_ms``: the same calls queued
behind a spin kernel, so the device runs them back to back), bound (its operations and bytes at
the card's peaks: bf16×3 and HIGHEST's six products on the tensor cores,
the elementwise kernels in fp32) and the library call's time, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np

#: the C5 headline (`bench.py:312-334`): upsample 4× vhq → 1001-tap hamming
#: lowpass at 11 kHz → decimate → TPDF dither, 'td_mxu', no EQ, no clip
HEADLINE = dict(samplerate=44100, blocksize=4096, upsample_factor=4,
                numtaps=1001, batch=4096, filter_type="lowpass",
                cutoff=11000.0, window_type="hamming", eq_enabled=False,
                agc_enabled=False, downsample_mode="decimate",
                dither_kind="tpdf", output_clip=None, conv_strategy="td_mxu",
                resample_quality="vhq")
#: the README quick start (`README.md:137-146`): config defaults otherwise
#: ('fft', clip 0.99, 'hq', resample down)
QUICKSTART = dict(samplerate=44100, blocksize=4096, upsample_factor=4,
                  numtaps=1001, cutoff=11000.0, window_type="hamming",
                  batch=512, eq_enabled=True, agc_enabled=False,
                  dither_kind="tpdf")

#: the C8 AGC chain (`bench.py:827-843`): 2× upsample → 129-tap lowpass at
#: 14 kHz with the 9-band EQ → decimate, AGC window 512 before it, clip
#: 0.99, TPDF dither, 'td_mxu', at the bench's batch (`bench.py:1382`)
C8 = dict(samplerate=44100, blocksize=2048, upsample_factor=2, numtaps=129,
          batch=4096, cutoff=14000.0, eq_enabled=True, agc_enabled=True,
          agc_mode="exact", agc_window_size=512, agc_carry=True,
          downsample_mode="decimate", dither_kind="tpdf", output_clip=0.99,
          conv_strategy="td_mxu")

CONV_DB = -110.0  # kernel vs plain, and ring vs staged: bf16×3 order class
ORACLE_DB = -90.0  # the reference's contract vs the float64 oracle
CHAIN_DB = -100.0  # the C8 chain on the card vs the port's CPU run
LIBRARY_DB = -90.0  # F.conv1d in fp32 vs the bf16×3 conv: the same function

#: the card's peaks (H100 SXM, NVIDIA's data sheet, dense rates): the
#: least time of a kernel is the larger of its operations at the rate of
#: their type and its bytes (each input read once, each output written
#: once) at the memory rate
BF16_FLOPS = 989e12  # dense bf16 on the tensor cores: the bf16×3 products,
# and HIGHEST's six bf16 products per tap (the tensor-core route of the fp32
# conv, as the TPU's 6-pass HIGHEST)
FP32_FLOPS = 67e12  # fp32 outside the tensor cores: the elementwise kernels
HBM_BYTES = 3.35e12

#: per-stream banks (the C5-bank and C8-psagc cells): four main-filter cutoffs in
#: batch/4-row groups, four AGC policies in batch/4-row groups
BANK_CUTOFFS = (8000.0, 10000.0, 11000.0, 12000.0)
AGC_POLICIES = dict(target=(0.05, 0.1, 0.2, 0.3), max_gain=(4.0, 10.0, 10.0, 20.0),
                    attack=(0.005, 0.01, 0.02, 0.05), release=(0.05, 0.1, 0.2, 0.5))


@dataclass
class Sizes:
    """Shapes of the run (the headline's; smaller ones rehearse on a CPU)."""

    batch: int = 4096
    block: int = 4096
    slots: int = 16
    chunk: int = 4
    serve_blocks: int = 16
    run_blocks: int = 8
    quick_batch: int = 512
    c8_batch: int = 4096
    c8_block: int = 2048
    c8_window: int = 512
    #: phase 8 (the CLI): a stereo file of `cli_seconds` at 44.1 kHz, a
    #: batch of `batch_files` stereo files of `batch_seconds`, a paced
    #: stream of `paced_seconds`, the oracle over the first `oracle_blocks`
    #: engine blocks of each output (the chain is causal); phase 9c holds
    #: `batch_checked` of its batch's files, drawn from the seed, against
    #: `process` of each alone
    cli_seconds: float = 60.0
    batch_files: int = 32
    batch_seconds: float = 30.0
    paced_seconds: float = 5.0
    batch_checked: int = 4
    oracle_blocks: int = 43
    #: phase 9 (multirate and ASRC): blocks of the literal chain at the C5
    #: headline, the batch of the compat ASRC's C8 run, rows of the CPU
    #: runs the card is held against
    multi_blocks: int = 4
    asrc_batch: int = 64
    cpu_rows: int = 8
    #: phase 11 (the parallel layer): shards of the stream-DP meshes, the
    #: long signal's streams and seconds, the kernel-parallel FIR's taps,
    #: shards and batch
    shards: int = 4
    long_streams: int = 8
    long_seconds: float = 60.0
    kp_taps: int = 50000
    kp_shards: int = 8
    kp_batch: int = 16


def err_db(a, b) -> float:
    """Max-abs relative error (dB) of `a` against `b`, in float64.  Large
    arrays of one shape (the served runs hold 2^28 samples) are reduced on
    the card in chunks: the same float64 maxima, without the host's
    multi-GiB float64 temporaries."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape == b.shape and a.size >= 1 << 22:
        import torch

        if torch.cuda.is_available():
            fa, fb = a.reshape(-1), b.reshape(-1)
            # torch.maximum carries a NaN through, as np.max does
            num = den = torch.zeros((), dtype=torch.float64, device="cuda")
            for i in range(0, fa.size, 1 << 26):
                ca = torch.from_numpy(np.ascontiguousarray(fa[i:i + (1 << 26)]))
                cb = torch.from_numpy(np.ascontiguousarray(fb[i:i + (1 << 26)]))
                ca, cb = ca.cuda().double(), cb.cuda().double()
                num = torch.maximum(num, (ca - cb).abs().max())
                den = torch.maximum(den, cb.abs().max())
            return float(20 * np.log10(float(num) / (float(den) + 1e-300) + 1e-300))
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def say(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def ptxas_report(log: Path, names) -> dict:
    """Registers and spill bytes of each kernel instantiation whose name
    holds one of `names`, from ptxas's ``-v`` report in the build log
    (names demangled by c++filt where it exists)."""
    found, cur = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
        elif cur is not None and any(n in cur for n in names):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                found.setdefault(cur, {})["spills"] = f"{m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                found.setdefault(cur, {})["registers"] = int(m.group(1))
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(found), capture_output=True,
                               text=True, timeout=60).stdout.split("\n")
    except OSError:
        plain = list(found)
    out = {}
    for mangled, name in zip(found, plain):
        m = re.search(r"((?:fir|agc)_\w+(?:<[^>]*>)?)", name)
        out[m.group(1) if m else mangled] = found[mangled]
    return out


def time_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds per call of `fn` on the device (CUDA events)."""
    for _ in range(warm):
        fn()
    if not torch.cuda.is_available():
        return float("nan")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, reps: int = 10) -> float:
    """Mean device milliseconds per call of `fn` when the device never waits
    for the host: CUDA events around `reps` calls queued behind a spin
    kernel (`torch.cuda._sleep`), so they run back to back on the device
    even where a call's host time is longer than its kernels (then
    `time_ms` reads the host).  The spin must outlast the host's queueing,
    measured on the host clock; it is lengthened until it does, and the
    function raises if it never does."""
    fn()
    if not torch.cuda.is_available():
        return float("nan")
    cycles = 1 << 22  # ~2 ms at the H100's clock
    for _ in range(4):
        spin, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        if spin.elapsed_time(start) > queued_ms:
            return start.elapsed_time(stop) / reps
        cycles *= 4
    raise AssertionError(f"the host took {queued_ms:.2f} ms to queue {reps} calls, "
                         f"longer than the spin ({spin.elapsed_time(start):.2f} ms)")


def bound(flops: float, nbytes: float, rate: float = BF16_FLOPS) -> dict:
    """The least time of a kernel (ms) and which of its operations and its
    bytes sets it."""
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def conv_bound(outputs: int, n_taps: int, nbytes: float) -> dict:
    """A bf16×3 conv: three products (six operations) per tap and output."""
    return bound(6.0 * outputs * n_taps, nbytes)


def elementwise_bound(samples: int, nbytes: float) -> dict:
    """The elementwise kernels (K2, K5, K6): about 8 fp32 operations per
    sample (square, window sum, sqrt, divide, clip; or compare, fma, clip,
    apply), far below their bytes."""
    return bound(8.0 * samples, nbytes, FP32_FLOPS)


def ring_windows(torch, ring, tail, slots, n):
    """The extended blocks [steps·B, n−1+T] that a dispatch over `slots`
    convolves: each step's n−1 history columns, then its slot."""
    kp, T = tail.shape[1], ring.shape[-1]
    stream = torch.cat([tail] + [ring[s] for s in slots], dim=-1)
    return torch.cat([stream[:, kp - (n - 1) + i * T: kp + (i + 1) * T]
                      for i in range(len(slots))])


#: the time of one F.conv1d (fp32, TF32 off) computing each conv shape,
#: measured once per shape and run: the yardstick of the conv kernels
LIBRARY_MS: dict = {}


def library_conv(torch, key: str, x_ext, h, want) -> float:
    """Time one `torch.nn.functional.conv1d` computing the conv y[b, t] =
    Σ_k h[k]·x_ext[b, t+n−1−k] (taps [n], or per-row taps [B, n] as a
    grouped conv), after checking it against the kernel's output `want`;
    cached under `key`."""
    if key in LIBRARY_MS:
        return LIBRARY_MS[key]
    import torch.nn.functional as Fn

    if h.ndim == 1:
        x, w, groups = x_ext[:, None, :], h.flip(0)[None, None, :], 1
    else:
        x, w, groups = x_ext[None], h.flip(1)[:, None, :], x_ext.shape[0]
    y = Fn.conv1d(x, w, groups=groups).reshape(want.shape)
    e = err_db(y.float().cpu(), want.float().cpu())
    check(e <= LIBRARY_DB, f"F.conv1d {key}: {e:.1f} dB from the kernel")
    del y
    LIBRARY_MS[key] = time_ms(torch, lambda: Fn.conv1d(x, w, groups=groups), 3)
    say(f"phase 3 library F.conv1d {key} {tuple(x_ext.shape)} x {h.shape[-1]} taps"
        f"{' (per-row taps)' if h.ndim == 2 else ''}: {e:.1f} dB from the kernel, "
        f"{LIBRARY_MS[key]:.3f} ms")
    return LIBRARY_MS[key]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def c8_config(sz: Sizes, **over):
    from afp_tpu_torch.engine import StreamConfig

    return StreamConfig(**{**C8, "batch": sz.c8_batch, "blocksize": sz.c8_block,
                           "agc_window_size": sz.c8_window, **over})


def c5_config(sz: Sizes, **over):
    from afp_tpu_torch.engine import StreamConfig

    return StreamConfig(**{**HEADLINE, "batch": sz.batch, "blocksize": sz.block,
                           **over})


def pcm16(torch, dev, shape, seed: int, scale: float = 0.3):
    """int16 PCM noise on `dev` (``scale`` of full scale) that reaches both
    ends of the range, −32768 and 32767."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, generator=g, device=dev) * (scale * 32768.0)
    x = torch.clamp(torch.round(x), -32768.0, 32767.0).to(torch.int16)
    x.view(-1)[:2] = torch.tensor([-32768, 32767], dtype=torch.int16, device=dev)
    return x


def lsb_diff(a, b) -> tuple[int, int]:
    """(max |a − b|, count of samples that differ) of two int16 arrays."""
    d = np.abs(np.asarray(a, dtype=np.int32) - np.asarray(b, dtype=np.int32))
    return int(d.max()), int((d > 0).sum())


def quantized(y: np.ndarray) -> np.ndarray:
    """`quantize_pcm16` in numpy (round half to even, then clamp)."""
    return np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)


# ---------------------------------------------------------------- phase 3


def phase_kernels(torch, dev, sz: Sizes) -> dict:
    """Each kernel against its plain version on the same device tensors."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
    from afp_tpu_torch.ops.cuda import dither_cuda
    from afp_tpu_torch.ops.cuda import fir_td as F
    from afp_tpu_torch.ops.dither import dither_plain

    cfg = StreamConfig(**{**HEADLINE, "batch": sz.batch, "blocksize": sz.block})
    pipe = Pipeline(cfg, dev)
    h = pipe.device_params(PipelineParams.design(pipe.cfg)).casc_main
    n, kp, B, T, S = pipe.n_casc, pipe._k_pad, sz.batch, sz.block, sz.slots
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev) * 0.3

    dkw = dict(out_clip=0.2, dither_key=(5, 7), dither_bits=16, dither_tpdf=True)
    res = {}
    n8 = Pipeline(c8_config(sz), dev).n_casc
    for name, taps, hi in (("C5", n, False), ("C5", n, True), ("C8", n8, False)):
        geo = F.conv_geometry(taps, hi)
        built = F.built_conv_geometry(taps, hi)
        check(all(built[k] == v for k, v in geo.items()) and built["acc_steps"] == F.ACC_STEPS,
              f"conv geometry: the library's {built} differs from the mirror's {geo}")
        say(f"phase 3 conv geometry {name} {'HIGHEST' if hi else 'B3'} ({taps} taps, "
            f"== the library's): "
            f"block {geo['rows']} rows x {geo['cols']} outputs, {geo['S']} k-steps in "
            f"{geo['chunks']} window chunk(s) of {geo['C']}, window {geo['W']} "
            f"positions (row {geo['wp']}), {geo['smem']} B shared; sums in chunks of "
            f"{F.ACC_STEPS} k-steps")

    # K1: staged conv (the tensor-core body)
    x_ext = randn(B, n - 1 + T)
    yk = F.fir_td_mxu(x_ext, h)
    yp = F.fir_td_mxu_plain(x_ext, h)
    e_conv = err_db(yk.cpu(), yp.cpu())
    ye = F.fir_td_mxu(x_ext, h, **dkw)
    epi_ok = torch.equal(ye, F._finish(yk, 0.2, (5, 7), 16, True))
    e_full = err_db(ye.cpu(), F.fir_td_mxu_plain(x_ext, h, **dkw).cpu())
    check(e_conv <= CONV_DB and e_full <= CONV_DB and epi_ok,
          f"K1: conv {e_conv:.1f} dB, dithered {e_full:.1f} dB, epilogue "
          f"bit-exact {epi_ok}")
    res["fir_td_mxu"] = dict(
        max_abs_err=float((yk - yp).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu(x_ext, h, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_plain(x_ext, h, **dkw), 3),
        **conv_bound(B * T, n, 4 * (B * (n - 1 + T) + n + B * T)),
        library_ms=library_conv(torch, "C5", x_ext, h, yk))
    say(f"phase 3 K1 fir_td_mxu [{B}, {n - 1}+{T}] x {n} taps: conv "
        f"{e_conv:.1f} dB, with clip+dither {e_full:.1f} dB vs plain, epilogue "
        f"bit-exact; {res['fir_td_mxu']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu']['plain_ms']:.3f} ms")
    del x_ext, yk, yp, ye

    # K3: one ring step (slot 5 of S)
    ring, tail = randn(S, B, T), randn(B, kp)
    idx = 5 % S
    ok_, tk = F.fir_td_mxu_ring_f32(ring, idx, tail, h, torch.zeros_like(ring))
    op_, tp = F.fir_td_mxu_ring_f32_plain(ring, idx, tail, h, torch.zeros_like(ring))
    e_conv = err_db(ok_[idx].cpu(), op_[idx].cpu())
    oe, _ = F.fir_td_mxu_ring_f32(ring, idx, tail, h, torch.zeros_like(ring), **dkw)
    epi_ok = torch.equal(oe[idx], F._finish(ok_[idx], 0.2, (5, 7), 16, True))
    untouched = bool((oe[(idx + 1) % S] == 0).all())
    check(e_conv <= CONV_DB and epi_ok and torch.equal(tk, tp) and untouched,
          f"K3: conv {e_conv:.1f} dB, epilogue {epi_ok}, tail "
          f"{torch.equal(tk, tp)}, other slots untouched {untouched}")
    out_r = torch.zeros_like(ring)
    res["fir_td_mxu_ring_f32"] = dict(
        max_abs_err=float((ok_[idx] - op_[idx]).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_f32(ring, idx, tail, h, out_r, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_f32_plain(
            ring, idx, tail, h, out_r, **dkw), 3),
        **conv_bound(B * T, n, 4 * (2 * B * T + 2 * B * kp + n)),
        library_ms=LIBRARY_MS["C5"])
    say(f"phase 3 K3 fir_td_mxu_ring_f32 ring [{S}, {B}, {T}] tail {kp}: conv "
        f"{e_conv:.1f} dB vs plain, tail and epilogue bit-exact; "
        f"{res['fir_td_mxu_ring_f32']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_f32']['plain_ms']:.3f} ms")
    del ok_, op_, oe

    # K4: a chunk of steps in one launch, wrapping the slot index
    start, steps = S - 2, sz.chunk
    slots = [(start + i) % S for i in range(steps)]
    mk, mtk = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, torch.zeros_like(ring), steps)
    mp, mtp = F.fir_td_mxu_ring_mega_f32_plain(ring, start, tail, h,
                                               torch.zeros_like(ring), steps)
    e_conv = max(err_db(mk[s].cpu(), mp[s].cpu()) for s in slots)
    me, _ = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, torch.zeros_like(ring),
                                       steps, **dkw)
    epi_ok = all(torch.equal(me[s], F._finish(mk[s], 0.2, (5, 7 + i), 16, True))
                 for i, s in enumerate(slots))
    ck, ct = torch.zeros_like(ring), tail
    for i, s in enumerate(slots):
        ck, ct = F.fir_td_mxu_ring_f32(ring, s, ct, h, ck,
                                       **{**dkw, "dither_key": (5, 7 + i)})
    chained = torch.equal(ck, me)
    check(e_conv <= CONV_DB and epi_ok and torch.equal(mtk, mtp) and chained,
          f"K4: conv {e_conv:.1f} dB, epilogue {epi_ok}, tail "
          f"{torch.equal(mtk, mtp)}, equals chained K3 {chained}")
    res["fir_td_mxu_ring_mega_f32"] = dict(
        max_abs_err=max(float((mk[s] - mp[s]).abs().max()) for s in slots),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_f32(
            ring, start, tail, h, out_r, steps, **dkw), 5),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_f32_plain(
            ring, start, tail, h, out_r, steps, **dkw), 2),
        **conv_bound(steps * B * T, n, 4 * (2 * steps * B * T + 2 * B * kp + n)),
        library_ms=library_conv(torch, "C5 steps", ring_windows(torch, ring, tail, slots, n),
                                h, torch.cat([mk[s] for s in slots])))
    say(f"phase 3 K4 fir_td_mxu_ring_mega_f32 {steps} steps from slot {start}: "
        f"conv {e_conv:.1f} dB vs plain, tail and epilogue bit-exact, equals "
        f"{steps} chained K3 steps bit for bit; "
        f"{res['fir_td_mxu_ring_mega_f32']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_mega_f32']['plain_ms']:.3f} ms per dispatch")
    del ring, out_r, mk, mp, me, ck

    # K2: standalone dither at the quick-start block [512, 4096]
    x = randn(sz.quick_batch, T)
    same = all(torch.equal(dither_cuda(x, (3, 9), 24, k), dither_plain(x, (3, 9), 24, k))
               for k in ("tpdf", "rpdf"))
    check(same, "K2: kernel noise differs from the plain version")
    def k2():
        return dither_cuda(x, (3, 9), 24, "tpdf")

    res["dither_cuda"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, k2, 20), device_ms=device_ms(torch, k2),
        plain_ms=time_ms(torch, lambda: dither_plain(x, (3, 9), 24, "tpdf"), 5),
        **elementwise_bound(x.numel(), 8 * x.numel()), library_ms=None)
    say(f"phase 3 K2 dither_cuda [{sz.quick_batch}, {T}]: TPDF and RPDF "
        f"bit-exact vs plain; {res['dither_cuda']['ms']:.4f} ms a call back to back "
        f"({res['dither_cuda']['device_ms']:.4f} ms on the device alone) vs plain "
        f"{res['dither_cuda']['plain_ms']:.3f} ms")
    return res


def phase_kernels_agc(torch, dev, sz: Sizes) -> dict:
    """K5-K8 against their plain versions at the C8 point."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import agc_rms as R
    from afp_tpu_torch.ops.cuda import agc_scan as S
    from afp_tpu_torch.ops.cuda import fir_td as F

    pipe = Pipeline(c8_config(sz), dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    h = params.combined_cascade(pipe.has_eq)
    B, T, W, kp, n = sz.c8_batch, sz.c8_block, sz.c8_window, pipe._k_pad, pipe.n_casc
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(B, T, generator=g, device=dev) * 0.1
    x[: B // 8] *= 8.0  # loud streams: the gain releases and clips
    a_att, a_rel = pipe.agc.a_att, pipe.agc.a_rel
    res = {}

    # K5: the two-level window (W = 512), a direct one, the chunk means
    lp, rp = pipe._rms_pad
    band = pipe._rms_band
    dk = R.rms_desired(x, band, lp, rp, 0.1, 10.0, True, transposed=True)
    e5 = err_db(dk.cpu(), R.rms_desired_plain(x, band, lp, rp, 0.1, 10.0, True,
                                              transposed=True).cpu())
    wd = 300
    band_d = F.band_matrix(np.full(wd, 1.0 / wd, np.float32)).to(dev)
    ex_d = R.band_is_exact_bf16(band_d.cpu())
    pd = (wd // 2, wd - 1 - wd // 2)
    dd = R.rms_desired(x, band_d, *pd, 0.1, 10.0, ex_d, transposed=True)
    e5d = err_db(dd.cpu(), R.rms_desired_plain(x, band_d, *pd, 0.1, 10.0, ex_d,
                                               transposed=True).cpu())
    mk = R.rms_desired(x, band, lp, rp, 0.1, 10.0, True, transposed=True, mean_chunk=32)
    e5m = err_db(mk.cpu(), R.rms_desired_plain(x, band, lp, rp, 0.1, 10.0, True,
                                               transposed=True, mean_chunk=32).cpu())
    check(max(e5, e5d, e5m) <= CONV_DB and not ex_d,
          f"K5: W={W} {e5:.1f} dB, W={wd} {e5d:.1f} dB, means {e5m:.1f} dB")
    # the kernel ≡ the CPU model of its summation order, bit for bit (on a
    # CPU tensor the wrapper runs the plain version: nothing to hold)
    xc, off = x.cpu(), {}
    for name, got, b, (p, q), ex, mc in (("two-level", dk, band, (lp, rp), True, 0),
                                         ("direct", dd, band_d, pd, ex_d, 0),
                                         ("chunk means", mk, band, (lp, rp), True, 32)):
        want = R.rms_desired_model(xc, b.cpu(), p, q, 0.1, 10.0, ex, transposed=True,
                                   mean_chunk=mc)
        off[name] = int((got.cpu() != want).sum()) if dev.type == "cuda" else 0
    check(not any(off.values()), f"K5 differs from its CPU model: {off}")
    del xc, dd
    dp = R.rms_desired_plain(x, band, lp, rp, 0.1, 10.0, True, transposed=True)

    def k5():
        return R.rms_desired(x, band, lp, rp, 0.1, 10.0, True, transposed=True)

    res["rms_desired"] = dict(
        max_abs_err=float((dk - dp).abs().max()),
        ms=time_ms(torch, k5, 10), device_ms=device_ms(torch, k5),
        plain_ms=time_ms(torch, lambda: R.rms_desired_plain(
            x, band, lp, rp, 0.1, 10.0, True, transposed=True), 3),
        **elementwise_bound(B * T, 8 * B * T), library_ms=None)
    say(f"phase 3 K5 rms_desired [{B}, {T}] -> [T, B]: W={W} two-level "
        f"{e5:.1f} dB, W={wd} direct {e5d:.1f} dB, chunk means {e5m:.1f} dB vs "
        f"plain, all three == the CPU model bit for bit; "
        f"{res['rms_desired']['ms']:.4f} ms a call back to back "
        f"({res['rms_desired']['device_ms']:.4f} ms on the device alone) vs plain "
        f"{res['rms_desired']['plain_ms']:.3f} ms")
    del dp

    # K6: exact and blockwise, f32 and pair, a ring slot; bit-exact
    init = torch.rand(B, generator=g, device=dev) * 4.0 + 0.2
    ring = torch.randn(3, B, T, generator=g, device=dev) * 0.1
    ring[1] = x
    cases = [
        ("exact f32 + init", dk, dict(init=init)),
        ("exact pair, ring slot", dk, dict(emit_split=True, ring_idx=1)),
        ("blockwise means f32", mk, dict(init=init, blockwise=32, d_is_means=True)),
        ("blockwise pair", dk, dict(emit_split=True, blockwise=32)),
    ]
    for name, d, kw in cases:
        src = ring if "ring_idx" in kw else x
        (yk, ck) = S.smooth_gain_apply(d, src, a_att, a_rel, 10.0, **kw)
        (yp, cp) = S.smooth_gain_apply_plain(d, src, a_att, a_rel, 10.0, **kw)
        same = torch.equal(ck, cp) and (
            all(torch.equal(a, b) for a, b in zip(yk, yp))
            if isinstance(yk, tuple) else torch.equal(yk, yp))
        check(same, f"K6 {name}: kernel differs from its plain version")
    def k6():
        return S.smooth_gain_apply(dk, x, a_att, a_rel, 10.0, init=init, emit_split=True)

    res["smooth_gain_apply"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, k6, 10), device_ms=device_ms(torch, k6),
        plain_ms=time_ms(torch, lambda: S.smooth_gain_apply_plain(
            dk, x, a_att, a_rel, 10.0, init=init, emit_split=True), 1),
        **elementwise_bound(B * T, 12 * B * T + 8 * B), library_ms=None)
    say(f"phase 3 K6 smooth_gain_apply [{T}, {B}]: {', '.join(c[0] for c in cases)} "
        f"bit-exact vs plain (y, pair, carry); "
        f"{res['smooth_gain_apply']['ms']:.4f} ms a call back to back "
        f"({res['smooth_gain_apply']['device_ms']:.4f} ms on the device alone) vs plain "
        f"{res['smooth_gain_apply']['plain_ms']:.3f} ms (exact, pair)")
    (xh, xl), _ = S.smooth_gain_apply(dk, x, a_att, a_rel, 10.0, init=init,
                                      emit_split=True)
    del ring, mk

    # K8: the pair conv, clip + dither fused; K7: the same into a ring slot
    th, tl = F.split_bf16(torch.randn(B, kp, generator=g, device=dev) * 0.1)
    dkw = dict(out_clip=0.2, dither_key=(5, 7), dither_bits=16, dither_tpdf=True)
    y8, t8h, t8l = F.fir_td_mxu_pair(xh, xl, th, tl, h)
    yp8, p8h, p8l = F.fir_td_mxu_pair_plain(xh, xl, th, tl, h)
    e8 = err_db(y8.cpu(), yp8.cpu())
    y8e, _, _ = F.fir_td_mxu_pair(xh, xl, th, tl, h, **dkw)
    e8e = err_db(y8e.cpu(), F.fir_td_mxu_pair_plain(xh, xl, th, tl, h, **dkw)[0].cpu())
    epi_ok = torch.equal(y8e, F._finish(y8, 0.2, (5, 7), 16, True))
    tails = torch.equal(t8h, p8h) and torch.equal(t8l, p8l)
    check(e8 <= CONV_DB and e8e <= CONV_DB and epi_ok and tails,
          f"K8: conv {e8:.1f} dB, dithered {e8e:.1f} dB, epilogue {epi_ok}, "
          f"tail {tails}")
    res["fir_td_mxu_pair"] = dict(
        max_abs_err=float((y8 - yp8).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_pair(xh, xl, th, tl, h, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_pair_plain(
            xh, xl, th, tl, h, **dkw), 3),
        **conv_bound(B * T, n, 4 * (2 * B * T + 2 * B * kp + n)),
        library_ms=library_conv(
            torch, "C8", torch.cat([F.merge_bf16(th, tl), F.merge_bf16(xh, xl)],
                                   dim=-1)[:, kp - (n - 1):], h, y8))
    say(f"phase 3 K8 fir_td_mxu_pair [{B}, {T}] pair + tail {kp} x {n} taps: "
        f"conv {e8:.1f} dB, with clip+dither {e8e:.1f} dB vs plain, epilogue "
        f"and tail bit-exact; {res['fir_td_mxu_pair']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_pair']['plain_ms']:.3f} ms")
    Sl, idx = sz.slots, 5 % sz.slots
    out0 = torch.full((Sl, B, T), 7.0, device=dev)
    o7, t7h, t7l = F.fir_td_mxu_pair_to_ring(xh, xl, th, tl, h, idx, out0.clone(), **dkw)
    untouched = all(bool((o7[s] == 7.0).all()) for s in (0, (idx + 1) % Sl))
    same = torch.equal(o7[idx], y8e) and torch.equal(t7h, p8h) and torch.equal(t7l, p8l)
    check(same and untouched, f"K7: slot equals K8 and tails {same}, other "
          f"slots untouched {untouched}")
    res["fir_td_mxu_pair_to_ring"] = dict(
        max_abs_err=float((o7[idx] - F.fir_td_mxu_pair_plain(
            xh, xl, th, tl, h, **dkw)[0]).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_pair_to_ring(
            xh, xl, th, tl, h, idx, out0, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_pair_to_ring_plain(
            xh, xl, th, tl, h, idx, out0, **dkw), 3),
        **conv_bound(B * T, n, 4 * (2 * B * T + 2 * B * kp + n)),
        library_ms=LIBRARY_MS["C8"])
    say(f"phase 3 K7 fir_td_mxu_pair_to_ring slot {idx} of [{Sl}, {B}, {T}]: "
        f"equals K8 bit for bit, tail bit-exact, other slots untouched; "
        f"{res['fir_td_mxu_pair_to_ring']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_pair_to_ring']['plain_ms']:.3f} ms")

    # the int16 store of K8 and K7 ≡ quantize_pcm16 of their f32 output
    q8 = F.fir_td_mxu_pair(xh, xl, th, tl, h, emit_i16=True, **dkw)[0]
    out16 = torch.zeros((Sl, B, T), dtype=torch.int16, device=dev)
    q7 = F.fir_td_mxu_pair_to_ring(xh, xl, th, tl, h, idx, out16, **dkw)[0]
    check(torch.equal(q8, F.quantize_pcm16(y8e)) and torch.equal(q7[idx], q8),
          "K8/K7 int16 store differs from quantize_pcm16 of the f32 output")
    t8 = time_ms(torch, lambda: F.fir_td_mxu_pair(xh, xl, th, tl, h,
                                                  emit_i16=True, **dkw), 10)
    t7 = time_ms(torch, lambda: F.fir_td_mxu_pair_to_ring(
        xh, xl, th, tl, h, idx, out16, **dkw), 10)
    say(f"phase 3 int16 store: K8 and K7 == quantize_pcm16 of their f32 "
        f"output bit for bit; K8 {t8:.3f} ms, K7 {t7:.3f} ms")
    del out16, q7

    # K5 and K6 on int16 x ≡ f32 x of n/32768 (exact, chunk means, pair)
    x16 = pcm16(torch, dev, (B, T), 14, scale=0.1)
    x16f = F.pcm16_to_f32(x16)
    kw5 = dict(transposed=True)
    same = True
    for mc in (0, 32):
        same = same and torch.equal(
            R.rms_desired(x16, band, lp, rp, 0.1, 10.0, True, mean_chunk=mc, **kw5),
            R.rms_desired(x16f, band, lp, rp, 0.1, 10.0, True, mean_chunk=mc, **kw5))
    d16 = R.rms_desired(x16, band, lp, rp, 0.1, 10.0, True, **kw5)
    for kw6 in (dict(init=init, emit_split=True), dict(emit_split=True, blockwise=32)):
        (ah, al), ac = S.smooth_gain_apply(d16, x16, a_att, a_rel, 10.0, **kw6)
        (bh, bl), bc = S.smooth_gain_apply(d16, x16f, a_att, a_rel, 10.0, **kw6)
        same = same and torch.equal(ah, bh) and torch.equal(al, bl) and torch.equal(ac, bc)
    check(same, "K5/K6 on int16 x differ from f32 x of n/32768")
    t5 = time_ms(torch, lambda: R.rms_desired(x16, band, lp, rp, 0.1, 10.0, True,
                                              **kw5), 10)
    t6 = time_ms(torch, lambda: S.smooth_gain_apply(
        d16, x16, a_att, a_rel, 10.0, init=init, emit_split=True), 10)
    say(f"phase 3 int16 x: K5 (exact, chunk means) and K6 (exact, blockwise, "
        f"pair) on int16 [{B}, {T}] == f32 x of n/32768 bit for bit; K5 "
        f"{t5:.3f} ms, K6 {t6:.3f} ms")
    return res


# ---------------------------------------------------------------- phase 4


def phase_pipeline(torch, dev, sz: Sizes) -> None:
    import scipy.signal as sps

    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
    from afp_tpu_torch.ops.resample import streaming_kernel

    cfg = StreamConfig(**{**HEADLINE, "batch": sz.batch, "blocksize": sz.block})
    pipe = Pipeline(cfg, dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    g = torch.Generator(device=dev).manual_seed(1)
    blocks = torch.randn(sz.run_blocks, sz.batch, sz.block, generator=g,
                         device=dev) * 0.3
    _, y0 = pipe.step(params, pipe.init_state(seed=0), blocks[0])
    outs, wall = run_wall(torch, dev, pipe, params, blocks)
    check(outs.shape == blocks.shape and bool(torch.isfinite(outs).all())
          and torch.equal(outs[0], y0), "Pipeline.run: shape, finiteness or "
          "first block differs from step")
    audio_s = sz.run_blocks * sz.batch * sz.block / cfg.samplerate
    say(f"phase 4 Pipeline.run headline batch {sz.batch} x {sz.run_blocks} "
        f"blocks: {wall * 1e3:.1f} ms wall ({wall * 1e3 / sz.run_blocks:.2f} "
        f"ms/block, {audio_s / wall:.0f}x realtime, host clock)")
    del blocks, outs

    # the bench's accuracy gate: one stream, dither off, vs float64 oracle
    ccfg = replace(pipe.cfg, batch=1, dither_kind="off")
    cpipe = Pipeline(ccfg, dev)
    cparams = cpipe.device_params(PipelineParams.design(cpipe.cfg))
    sig = (np.random.default_rng(0).standard_normal((1, sz.block * 4)) * 0.3
           ).astype(np.float32)
    _, out = cpipe.process_signal(cparams, cpipe.init_state(), sig, fold=False)
    out = out.cpu().numpy()[0]
    upf = ccfg.upsample_factor
    y = sps.upfirdn(streaming_kernel(upf, 1, quality=ccfg.resample_quality),
                    sig[0].astype(np.float64), upf, 1)[: sig.shape[1] * upf]
    main = PipelineParams.design(cpipe.cfg).main_taps.astype(np.float64)
    gold = np.convolve(y, main)[: len(y)][::upf]
    e = err_db(out, gold)
    check(e < ORACLE_DB, f"oracle: {e:.1f} dB breaks the {ORACLE_DB} dB contract")
    say(f"phase 4 oracle: one stream, 4 blocks, dither off: {e:.1f} dB vs the "
        f"float64 oracle (< {ORACLE_DB})")


# ---------------------------------------------------------------- phase 5


def phase_serving(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
    from afp_tpu_torch.runtime import RingServer

    g = torch.Generator(device=dev).manual_seed(2)
    src = (torch.randn(sz.serve_blocks, sz.batch, sz.block, generator=g,
                       device=dev) * 0.3).cpu().numpy()
    outs = {}
    for dither in ("tpdf", "off"):
        cfg = StreamConfig(**{**HEADLINE, "batch": sz.batch,
                              "blocksize": sz.block, "dither_kind": dither})
        for mega in (True, False):
            pipe = Pipeline(cfg, dev)
            srv = RingServer(pipe, slots=sz.slots, chunk=sz.chunk,
                             max_inflight=2, seed=0, mega=mega)
            got = []
            stats = srv.serve(iter(src), got.append)
            outs[dither, mega] = np.stack(got)
            check(stats["blocks"] == sz.serve_blocks, "RingServer lost blocks")
            lat = stats["latency"]
            say(f"phase 5 RingServer mega={mega} dither={dither}: "
                f"{stats['blocks']} blocks in {stats['wall_s'] * 1e3:.1f} ms "
                f"({stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, "
                f"p95 {lat['p95_ms']:.1f} ms land-to-drain, host clock)")
    check(np.array_equal(outs["tpdf", True], outs["tpdf", False]),
          "RingServer mega and per-step outputs differ with dither on")
    pipe = Pipeline(StreamConfig(**{**HEADLINE, "batch": sz.batch,
                                    "blocksize": sz.block, "dither_kind": "off"}), dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    st = pipe.init_state(seed=0)
    staged = []
    for blk in src:
        st, y = pipe.step(params, st, blk)
        staged.append(y.cpu().numpy())
    staged = np.stack(staged)
    e = {m: err_db(outs["off", m], staged) for m in (True, False)}
    check(all(v <= CONV_DB for v in e.values()),
          f"RingServer vs staged steps: {e}")
    check(all(np.isfinite(v).all() for v in outs.values()), "non-finite output")
    say(f"phase 5 RingServer: mega == per-step bit for bit (dither on); vs "
        f"staged steps (dither off) mega {e[True]:.1f} dB, per-step "
        f"{e[False]:.1f} dB (<= {CONV_DB})")


# ---------------------------------------------------------------- phase 6


def phase_engine(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import StreamConfig, StreamEngine

    cfg = StreamConfig(**{**QUICKSTART, "batch": sz.quick_batch,
                          "blocksize": sz.block})
    eng = StreamEngine(cfg, device=dev)
    rng = np.random.default_rng(3)
    outs = []
    for i in range(6):
        if i == 4:
            eng.set_eq_gains([1.0] * 6 + [2.0] * 3)
        blk = (rng.standard_normal((sz.quick_batch, sz.block)) * 0.1).astype(np.float32)
        outs.append(eng.process_block(blk))
    audio = (rng.standard_normal((sz.quick_batch, 44100)) * 0.1).astype(np.float32)
    sig_out = eng.process_signal(audio)
    m = eng.metrics
    check(m.underruns == m.fallback_replays == m.fallback_silence == 0,
          f"StreamEngine ladder fired: {m.snapshot()}")
    check(all(o.shape == (sz.quick_batch, sz.block) and np.isfinite(o).all()
              and np.abs(o).max() <= 0.99 + 2.0 ** -22 for o in outs)
          and sig_out.shape == (sz.quick_batch, 44100 // sz.block * sz.block),
          "StreamEngine outputs: shape, finiteness or clip")
    say(f"phase 6 StreamEngine quick start (fft, EQ, batch {sz.quick_batch}): "
        f"6 blocks + set_eq_gains + process_signal, metrics {m.snapshot()}")


# ---------------------------------------------------------------- C8 chain


def c8_oracle(x: np.ndarray, cfg, design, gains=None, policy=None) -> np.ndarray:
    """The C8 chain in float64 over [B, N·L] input: per block, the AGC of
    the reference (boxcar RMS with 'same' zero padding, desired gain, the
    attack/release recurrence carried across blocks from unity as
    `tests/test_agc_fused.py:37-53` writes it, the 0.1..max_gain clip, the
    ±0.99 clip); then the linear chain on the whole gained stream:
    upsample, main ⊛ Σ gᵢ·bandᵢ, decimate, clip.  Per-stream EQ `gains`
    [B, n_bands] and AGC `policy` (a dict of [B] target, max_gain, attack,
    release) replace the config's."""
    import scipy.signal as sps

    from afp_tpu_torch.ops.agc import agc_alphas
    from afp_tpu_torch.ops.resample import streaming_kernel

    B, N = x.shape
    L, w = cfg.blocksize, cfg.agc_window_size
    if policy is None:
        policy = dict(target=[cfg.agc_target_level] * B,
                      max_gain=[cfg.agc_max_gain] * B,
                      attack=[cfg.agc_attack] * B, release=[cfg.agc_release] * B)
    a_att, a_rel = np.array([agc_alphas(w, a, r) for a, r in
                             zip(policy["attack"], policy["release"])]).T
    t = np.asarray(policy["target"], np.float64)[:, None]
    mg = np.asarray(policy["max_gain"], np.float64)[:, None]
    g = np.ones(B)
    gained = np.empty((B, N))
    for b0 in range(0, N, L):
        xb = x[:, b0:b0 + L].astype(np.float64)
        ss = np.stack([np.convolve(r, np.ones(w) / w, "same") for r in xb * xb])
        d = np.clip(t / (np.sqrt(np.maximum(ss, 0)) + 1e-10), 0, mg)
        gs = np.empty_like(d)
        for i in range(L):
            a = np.where(d[:, i] > g, a_att, a_rel)
            g = a * d[:, i] + (1 - a) * g
            gs[:, i] = g
        gs = np.clip(gs, 0.1, mg)
        g = gs[:, -1]
        gained[:, b0:b0 + L] = np.clip(xb * gs, -0.99, 0.99)
    upf = cfg.upsample_factor
    gains = np.broadcast_to(design.eq_gains if gains is None else gains,
                            (B, len(design.eq_taps)))
    bands = [np.convolve(design.main_taps.astype(np.float64), b.astype(np.float64))
             for b in design.eq_taps]
    h_up = streaming_kernel(upf, 1, quality=cfg.resample_quality)
    out = []
    for r, gr in zip(gained, gains):
        h = sum(gi * band for gi, band in zip(gr.astype(np.float64), bands))
        y = sps.upfirdn(h_up, r, upf, 1)[: N * upf]
        out.append(np.convolve(y, h)[: len(y)][::upf])
    return np.clip(np.stack(out), -cfg.output_clip, cfg.output_clip)


def phase_c8_pipeline(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import Pipeline, PipelineParams

    g = torch.Generator(device=dev).manual_seed(11)
    blocks = torch.randn(sz.run_blocks, sz.c8_batch, sz.c8_block, generator=g,
                         device=dev) * 0.1
    for mode in ("exact", "fast"):
        pipe = Pipeline(c8_config(sz, agc_mode=mode), dev)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        pipe.run(params, pipe.init_state(seed=0), blocks[:1])  # warm-up
        sync(torch, dev)
        t0 = time.perf_counter()
        state, outs = pipe.run(params, pipe.init_state(seed=0), blocks)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        check(outs.shape == blocks.shape and bool(torch.isfinite(outs).all())
              and float(outs.abs().max()) <= 0.99 + 2.0 ** -14
              and bool(torch.isfinite(state.agc_gain).all()),
              f"C8 {mode}: shape, finiteness, clip or gain carry")
        audio_s = sz.run_blocks * sz.c8_batch * sz.c8_block / pipe.cfg.samplerate
        say(f"phase 4 C8 Pipeline.run agc_mode={mode} batch {sz.c8_batch} x "
            f"{sz.run_blocks} blocks of {sz.c8_block}: {wall * 1e3:.1f} ms wall "
            f"({wall * 1e3 / sz.run_blocks:.2f} ms/block, {audio_s / wall:.0f}x "
            f"realtime, host clock)")
    del blocks, outs

    # the card against the port's CPU run (plain versions), batch 8
    small = c8_config(sz, batch=8)
    sig = (np.random.default_rng(4).standard_normal((4, 8, sz.c8_block)) * 0.1
           ).astype(np.float32)
    sig[:, 0] *= 8.0
    outs = {}
    for where in (dev, torch.device("cpu")):
        pipe = Pipeline(small, where)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        _, y = pipe.run(params, pipe.init_state(seed=1), sig)
        outs[where.type] = y.cpu().numpy()
    e = err_db(outs[dev.type], outs["cpu"])
    diff = np.abs(outs[dev.type] - outs["cpu"])
    at = np.unravel_index(int(diff.argmax()), diff.shape)
    check(e <= CHAIN_DB, f"C8 batch 8: card vs CPU {e:.1f} dB, largest at (block, "
          f"stream, t) {tuple(int(i) for i in at)}: card {outs[dev.type][at]!r}, "
          f"CPU {outs['cpu'][at]!r}, per block "
          f"{[round(err_db(a, b), 1) for a, b in zip(outs[dev.type], outs['cpu'])]} dB")
    say(f"phase 4 C8 batch 8, 4 blocks, dither on: card vs the port's CPU run "
        f"{e:.1f} dB (<= {CHAIN_DB})")

    # the float64 oracle: 4 streams, 4 blocks, dither off
    ocfg = c8_config(sz, batch=4, dither_kind="off")
    pipe = Pipeline(ocfg, dev)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    x = (np.random.default_rng(5).standard_normal((4, 4 * sz.c8_block)) * 0.1
         ).astype(np.float32)
    x[0, : sz.c8_block] *= 8.0
    x[1] *= 1e-2
    _, out = pipe.process_signal(params, pipe.init_state(), x, fold=False)
    e = err_db(out.cpu().numpy(), c8_oracle(x, pipe.cfg, design))
    check(e < ORACLE_DB, f"C8 oracle: {e:.1f} dB breaks the {ORACLE_DB} dB contract")
    say(f"phase 4 C8 oracle: 4 streams, 4 blocks, dither off: {e:.1f} dB vs "
        f"the float64 AGC + chain (< {ORACLE_DB})")


def phase_c8_serving(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.runtime import RingServer

    g = torch.Generator(device=dev).manual_seed(12)
    src = (torch.randn(sz.serve_blocks, sz.c8_batch, sz.c8_block, generator=g,
                       device=dev) * 0.1).cpu().numpy()
    pipe = Pipeline(c8_config(sz), dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    # a first server over the same blocks warms the allocators (rings, the
    # pinned staging buffers of every in-flight block) and the kernels'
    # first launches; the second is the one measured and checked
    RingServer(pipe, params, slots=sz.slots, chunk=sz.chunk, max_inflight=2,
               seed=0).serve(iter(src), lambda _: None)
    srv = RingServer(pipe, params, slots=sz.slots, chunk=sz.chunk,
                     max_inflight=2, seed=0)
    got = []
    stats = srv.serve(iter(src), got.append)
    check(stats["blocks"] == sz.serve_blocks, "C8 RingServer lost blocks")
    st = pipe.init_state(seed=0)
    same = True
    for blk, o in zip(src, got):
        st, y = pipe.step(params, st, blk)
        same = same and np.array_equal(o, y.cpu().numpy())
    check(same and torch.equal(st.agc_gain, srv.state.agc_gain),
          "C8 RingServer differs from the staged steps (dither on)")
    lat = stats["latency"]
    say(f"phase 5 C8 RingServer per-step ring, {sz.slots} slots, chunk "
        f"{sz.chunk}: {stats['blocks']} blocks in {stats['wall_s'] * 1e3:.1f} ms "
        f"({stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, p95 "
        f"{lat['p95_ms']:.1f} ms land-to-drain, host clock); ring == staged "
        f"bit for bit, dither on")


def phase_c8_engine(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import StreamEngine

    cfg = c8_config(sz)
    eng = StreamEngine(cfg, device=dev)
    rng = np.random.default_rng(13)
    outs = []
    for i in range(6):
        if i == 4:
            check(eng.apply_config(replace(eng.cfg, agc_target_level=0.2)),
                  "C8 apply_config with a new AGC target was not a dynamic swap")
        blk = (rng.standard_normal((sz.c8_batch, sz.c8_block)) * 0.1).astype(np.float32)
        outs.append(eng.process_block(blk))
    m = eng.metrics
    check(m.underruns == m.fallback_replays == m.fallback_silence == 0,
          f"C8 StreamEngine ladder fired: {m.snapshot()}")
    check(all(o.shape == (sz.c8_batch, sz.c8_block) and np.isfinite(o).all()
              and np.abs(o).max() <= 0.99 + 2.0 ** -14 for o in outs)
          and float(eng.params.agc_target) == np.float32(0.2),
          "C8 StreamEngine outputs: shape, finiteness, clip or the swap")
    say(f"phase 6 C8 StreamEngine batch {sz.c8_batch}: 4 blocks + apply_config "
        f"(agc_target_level 0.1 -> 0.2, dynamic) + 2 blocks, metrics {m.snapshot()}")


# ---------------------------------------------------------------- transport


def phase_kernels_transport(torch, dev, sz: Sizes) -> dict:
    """K12 and K13 (and their megakernel forms) against their plain
    versions and against K3/K4, and the int16 store of K1, K3, K4, K12 and
    K13, at the C5 headline."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import fir_td as F

    pipe = Pipeline(c5_config(sz), dev)
    h = pipe.device_params(PipelineParams.design(pipe.cfg)).casc_main
    n, kp, B, T, S = pipe.n_casc, pipe._k_pad, sz.batch, sz.block, sz.slots
    dkw = dict(out_clip=0.2, dither_key=(5, 7), dither_bits=16, dither_tpdf=True)
    idx, start, steps = 5 % S, S - 2, sz.chunk
    slots = [(start + i) % S for i in range(steps)]

    def z(dtype=torch.float32):
        return torch.zeros((S, B, T), dtype=dtype, device=dev)

    res = {}
    ring16, tail16 = pcm16(torch, dev, (S, B, T), 20), pcm16(torch, dev, (B, kp), 21)
    ringf, tailf = F.pcm16_to_f32(ring16), F.pcm16_to_f32(tail16)

    # K12, one step: vs plain, ≡ K3 on n/32768, int16 store ≡ quantized
    ok, tk = F.fir_td_mxu_ring_pcm16(ring16, idx, tail16, h, z())
    op, tp = F.fir_td_mxu_ring_pcm16_plain(ring16, idx, tail16, h, z())
    e12 = err_db(ok[idx].cpu(), op[idx].cpu())
    of, tf = F.fir_td_mxu_ring_f32(ringf, idx, tailf, h, z())
    k3 = torch.equal(ok, of) and torch.equal(F.pcm16_to_f32(tk), tf)
    ye, _ = F.fir_td_mxu_ring_pcm16(ring16, idx, tail16, h, z(), **dkw)
    qe, _ = F.fir_td_mxu_ring_pcm16(ring16, idx, tail16, h, z(torch.int16), **dkw)
    store = torch.equal(qe, F.quantize_pcm16(ye))
    check(e12 <= CONV_DB and torch.equal(tk, tp) and k3 and store,
          f"K12: conv {e12:.1f} dB, tail {torch.equal(tk, tp)}, == K3 {k3}, "
          f"int16 store {store}")
    out16 = z(torch.int16)
    res["fir_td_mxu_ring_pcm16"] = dict(
        max_abs_err=float((ok[idx] - op[idx]).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_pcm16(
            ring16, idx, tail16, h, out16, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_pcm16_plain(
            ring16, idx, tail16, h, out16, **dkw), 3),
        **conv_bound(B * T, n, 2 * (2 * B * T + 2 * B * kp) + 4 * n),
        library_ms=LIBRARY_MS["C5"])
    say(f"phase 3 K12 fir_td_mxu_ring_pcm16 int16 ring [{S}, {B}, {T}] tail "
        f"{kp}: conv {e12:.1f} dB vs plain, int16 tail bit-exact, == K3 on "
        f"n/32768 bit for bit, int16 store == quantize_pcm16; "
        f"{res['fir_td_mxu_ring_pcm16']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_pcm16']['plain_ms']:.3f} ms (int16 in and out)")
    del ok, op, of, ye, qe

    # K12 megakernel: vs plain, ≡ K4 on n/32768, int16 store
    mk, mt = F.fir_td_mxu_ring_mega_pcm16(ring16, start, tail16, h, z(), steps)
    mp, mpt = F.fir_td_mxu_ring_mega_pcm16_plain(ring16, start, tail16, h, z(), steps)
    e12m = max(err_db(mk[s].cpu(), mp[s].cpu()) for s in slots)
    m4, m4t = F.fir_td_mxu_ring_mega_f32(ringf, start, tailf, h, z(), steps, **dkw)
    q12, q12t = F.fir_td_mxu_ring_mega_pcm16(ring16, start, tail16, h,
                                             z(torch.int16), steps, **dkw)
    k4 = torch.equal(q12, F.quantize_pcm16(m4)) and torch.equal(
        F.pcm16_to_f32(q12t), m4t)
    check(e12m <= CONV_DB and torch.equal(mt, mpt) and k4,
          f"K12 mega: conv {e12m:.1f} dB, tail {torch.equal(mt, mpt)}, int16 "
          f"store == quantized K4 on n/32768 {k4}")
    res["fir_td_mxu_ring_mega_pcm16"] = dict(
        max_abs_err=max(float((mk[s] - mp[s]).abs().max()) for s in slots),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_pcm16(
            ring16, start, tail16, h, out16, steps, **dkw), 5),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_pcm16_plain(
            ring16, start, tail16, h, out16, steps, **dkw), 2),
        **conv_bound(steps * B * T, n, 2 * (2 * steps * B * T + 2 * B * kp) + 4 * n),
        library_ms=LIBRARY_MS["C5 steps"])
    say(f"phase 3 K12 fir_td_mxu_ring_mega_pcm16 {steps} steps from slot "
        f"{start}: conv {e12m:.1f} dB vs plain, int16 tail bit-exact, int16 "
        f"store == quantize_pcm16 of K4 on n/32768 bit for bit; "
        f"{res['fir_td_mxu_ring_mega_pcm16']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_mega_pcm16']['plain_ms']:.3f} ms per dispatch")
    del ring16, mk, mp, q12, out16

    # the int16 store of K1, K3, K4 ≡ quantize_pcm16 of their f32 output
    g = torch.Generator(device=dev).manual_seed(22)
    ring = torch.randn(S, B, T, generator=g, device=dev) * 0.3
    tail = torch.randn(B, kp, generator=g, device=dev) * 0.3
    ext = torch.cat([tail[:, kp - (n - 1):], ring[idx]], dim=-1)
    y1 = F.fir_td_mxu(ext, h, **dkw)
    s1 = torch.equal(F.fir_td_mxu(ext, h, emit_i16=True, **dkw), F.quantize_pcm16(y1))
    y3, _ = F.fir_td_mxu_ring_f32(ring, idx, tail, h, z(), **dkw)
    s3 = torch.equal(F.fir_td_mxu_ring_f32(ring, idx, tail, h, z(torch.int16), **dkw)[0],
                     F.quantize_pcm16(y3))
    y4, _ = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, z(), steps, **dkw)
    s4 = torch.equal(F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, z(torch.int16),
                                                steps, **dkw)[0], F.quantize_pcm16(y4))
    check(s1 and s3 and s4, f"int16 store: K1 {s1}, K3 {s3}, K4 {s4}")
    out16 = z(torch.int16)
    t1 = time_ms(torch, lambda: F.fir_td_mxu(ext, h, emit_i16=True, **dkw), 10)
    t3 = time_ms(torch, lambda: F.fir_td_mxu_ring_f32(ring, idx, tail, h, out16,
                                                      **dkw), 10)
    t4 = time_ms(torch, lambda: F.fir_td_mxu_ring_mega_f32(
        ring, start, tail, h, out16, steps, **dkw), 5)
    say(f"phase 3 int16 store: K1, K3, K4 == quantize_pcm16 of their f32 "
        f"output bit for bit; K1 {t1:.3f} ms, K3 {t3:.3f} ms, K4 {t4:.3f} ms "
        f"per {steps} steps")
    del y1, y3, y4, out16

    # K13: the pair rings of the f32 ring ≡ K3/K4 on it, ≡ K7 on a slot
    rh, rl = F.split_bf16(ring)
    th, tl = F.split_bf16(tail)
    ck, ch, cl = F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, z())
    cp, cph, cpl = F.fir_td_mxu_ring_plain(rh, rl, idx, th, tl, h, z())
    e13 = err_db(ck[idx].cpu(), cp[idx].cpu())
    c3, c3t = F.fir_td_mxu_ring_f32(ring, idx, tail, h, z())
    c7, c7h, c7l = F.fir_td_mxu_pair_to_ring(rh[idx], rl[idx], th, tl, h, idx, z())
    sh, sl = F.split_bf16(c3t)
    same = (torch.equal(ck, c3) and torch.equal(ck, c7) and torch.equal(ch, sh)
            and torch.equal(cl, sl) and torch.equal(ch, c7h) and torch.equal(cl, c7l))
    q13 = F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, z(torch.int16), **dkw)[0]
    y13 = F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, z(), **dkw)[0]
    store = torch.equal(q13, F.quantize_pcm16(y13))
    tails = torch.equal(ch, cph) and torch.equal(cl, cpl)
    check(e13 <= CONV_DB and tails and same and store,
          f"K13: conv {e13:.1f} dB, tails {tails}, == K3 and K7 {same}, int16 "
          f"store {store}")
    out_r = z()
    res["fir_td_mxu_ring"] = dict(
        max_abs_err=float((ck[idx] - cp[idx]).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, out_r,
                                                    **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_plain(
            rh, rl, idx, th, tl, h, out_r, **dkw), 3),
        **conv_bound(B * T, n, 4 * (2 * B * T + 2 * B * kp + n)),
        library_ms=LIBRARY_MS["C5"])
    say(f"phase 3 K13 fir_td_mxu_ring pair rings [{S}, {B}, {T}] tail {kp}: "
        f"conv {e13:.1f} dB vs plain, pair tail bit-exact, == K3 on the f32 "
        f"ring and == K7 on the slot bit for bit, int16 store == "
        f"quantize_pcm16; {res['fir_td_mxu_ring']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring']['plain_ms']:.3f} ms")
    del ck, cp, c3, c7, q13, y13

    mk, mh, ml = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h, z(), steps)
    mp, mph, mpl = F.fir_td_mxu_ring_mega_plain(rh, rl, start, th, tl, h, z(), steps)
    e13m = max(err_db(mk[s].cpu(), mp[s].cpu()) for s in slots)
    me, meh, mel = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h, z(), steps, **dkw)
    m4, m4t = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, z(), steps, **dkw)
    sh, sl = F.split_bf16(m4t)
    k4 = torch.equal(me, m4) and torch.equal(meh, sh) and torch.equal(mel, sl)
    q13m = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h, z(torch.int16), steps,
                                  **dkw)[0]
    store = torch.equal(q13m, F.quantize_pcm16(me))
    tails = torch.equal(mh, mph) and torch.equal(ml, mpl)
    check(e13m <= CONV_DB and tails and k4 and store,
          f"K13 mega: conv {e13m:.1f} dB, tails {tails}, == K4 {k4}, int16 "
          f"store {store}")
    res["fir_td_mxu_ring_mega"] = dict(
        max_abs_err=max(float((mk[s] - mp[s]).abs().max()) for s in slots),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega(
            rh, rl, start, th, tl, h, out_r, steps, **dkw), 5),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_plain(
            rh, rl, start, th, tl, h, out_r, steps, **dkw), 2),
        **conv_bound(steps * B * T, n, 4 * (2 * steps * B * T + 2 * B * kp + n)),
        library_ms=LIBRARY_MS["C5 steps"])
    say(f"phase 3 K13 fir_td_mxu_ring_mega {steps} steps from slot {start}: "
        f"conv {e13m:.1f} dB vs plain, pair tail bit-exact, == K4 on the f32 "
        f"ring bit for bit, int16 store == quantize_pcm16; "
        f"{res['fir_td_mxu_ring_mega']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_mega']['plain_ms']:.3f} ms per dispatch")
    return res


def c5_oracle(x: np.ndarray, cfg, design) -> np.ndarray:
    """The C5 chain in float64 over [B, N] input (`bench.py:394-418`):
    upsample, the main FIR, decimate."""
    import scipy.signal as sps

    from afp_tpu_torch.ops.resample import streaming_kernel

    upf = cfg.upsample_factor
    h_up = streaming_kernel(upf, 1, quality=cfg.resample_quality)
    main = design.main_taps.astype(np.float64)
    out = []
    for r in x.astype(np.float64):
        y = sps.upfirdn(h_up, r, upf, 1)[: len(r) * upf]
        out.append(np.convolve(y, main)[: len(y)][::upf])
    return np.stack(out)


def run_wall(torch, dev, pipe, params, blocks) -> tuple:
    """`Pipeline.run` over `blocks` after a warm-up run over the same blocks
    (the allocator then holds every buffer the run needs): (outputs, wall
    seconds, host clock ending in a synchronize)."""
    pipe.run(params, pipe.init_state(seed=0), blocks)
    sync(torch, dev)
    t0 = time.perf_counter()
    _, outs = pipe.run(params, pipe.init_state(seed=0), blocks)
    sync(torch, dev)
    return outs, time.perf_counter() - t0


def phase_transport_pipeline(torch, dev, sz: Sizes) -> None:
    """C5-i16io and C8-i16io through `Pipeline.run`, each ≡ quantize_pcm16
    of the f32 chain fed n/32768 with the same 16-bit dither; the C5-pcm16
    and C8-pcm16 oracles."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import fir_td as F

    io = dict(ingest="pcm16", emit="pcm16")
    runs = [("C5-i16io", c5_config(sz, **io), sz.batch, sz.block, 0.3)]
    runs += [(f"C8-i16io {m}", c8_config(sz, agc_mode=m, **io), sz.c8_batch,
              sz.c8_block, 0.1) for m in ("exact", "fast")]
    for name, cfg, B, T, scale in runs:
        pipe = Pipeline(cfg, dev)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        blocks = pcm16(torch, dev, (sz.run_blocks, B, T), 30, scale=scale)
        outs, wall = run_wall(torch, dev, pipe, params, blocks)
        fpipe = Pipeline(replace(pipe.cfg, ingest="f32", emit="f32"), dev)
        fparams = fpipe.device_params(PipelineParams.design(fpipe.cfg))
        _, fo = fpipe.run(fparams, fpipe.init_state(seed=0),
                          F.pcm16_to_f32(blocks[:2]))
        check(outs.dtype == torch.int16 and outs.shape == blocks.shape
              and pipe.cfg.dither_bits == 16
              and torch.equal(outs[:2], F.quantize_pcm16(fo)),
              f"{name}: dtype, shape, or not quantize_pcm16 of the f32 chain")
        audio_s = sz.run_blocks * B * T / pipe.cfg.samplerate
        say(f"phase 4 {name} Pipeline.run batch {B} x {sz.run_blocks} blocks "
            f"of {T}, int16 in and out: {wall * 1e3:.1f} ms wall "
            f"({wall * 1e3 / sz.run_blocks:.2f} ms/block, {audio_s / wall:.0f}x "
            f"realtime, host clock); == quantize_pcm16 of the f32 chain on "
            f"n/32768 bit for bit (2 blocks, 16-bit dither)")
        del blocks, outs, fo

    # the oracles: pcm16 in, dither off; f32 out < −90 dB, int16 out ≤ 1 LSB
    rng = np.random.default_rng(6)
    x5 = np.clip(np.round(rng.standard_normal((1, 4 * sz.block)) * 0.3 * 32768),
                 -32768, 32767).astype(np.int16)
    x8 = np.clip(np.round(rng.standard_normal((4, 4 * sz.c8_block)) * 0.1 * 32768),
                 -32768, 32767).astype(np.int16)
    x8[0, : sz.c8_block] = np.clip(x8[0, : sz.c8_block].astype(np.int32) * 8,
                                   -32768, 32767)
    x8[1] //= 100
    for name, base, x, oracle in (
            ("C5-pcm16", c5_config(sz, batch=1), x5, c5_oracle),
            ("C8-pcm16", c8_config(sz, batch=4), x8, c8_oracle)):
        outs = {}
        for emit in ("f32", "pcm16"):
            pipe = Pipeline(replace(base, ingest="pcm16", emit=emit,
                                    dither_kind="off"), dev)
            design = PipelineParams.design(pipe.cfg)
            params = pipe.device_params(design)
            _, out = pipe.process_signal(params, pipe.init_state(), x, fold=False)
            outs[emit] = out.cpu().numpy()
        gold = oracle(x.astype(np.float32) / np.float32(32768.0), pipe.cfg, design)
        e = err_db(outs["f32"], gold)
        dmax, ndiff = lsb_diff(outs["pcm16"], quantized(gold))
        check(e < ORACLE_DB and dmax <= 1,
              f"{name} oracle: {e:.1f} dB, int16 out {dmax} LSB")
        say(f"phase 4 {name} oracle: {x.shape[0]} stream(s) x 4 blocks, int16 "
            f"in, dither off: {e:.1f} dB vs the float64 oracle on n/32768 "
            f"(< {ORACLE_DB}); int16 out max |d| {dmax} LSB from the quantized "
            f"oracle, {ndiff} of {gold.size} samples differ (<= 1 LSB)")


def serve_warm(pipe, params, src, sz: Sizes, mega: bool = False, packing=None):
    """Serve `src` once to warm the allocators (rings, pinned staging) and
    the kernels' first launches, then again: (outputs, serve() stats)."""
    from afp_tpu_torch.runtime import RingServer

    kw = dict(slots=sz.slots, chunk=sz.chunk, max_inflight=2, seed=0, mega=mega,
              packing=packing)
    RingServer(pipe, params, **kw).serve(iter(src), lambda _: None)
    got = []
    stats = RingServer(pipe, params, **kw).serve(iter(src), got.append)
    check(stats["blocks"] == len(src), "RingServer lost blocks")
    return np.stack(got), stats


def staged_outputs(torch, pipe, params, src) -> np.ndarray:
    st = pipe.init_state(seed=0)
    outs = []
    for blk in src:
        st, y = pipe.step(params, st, blk)
        outs.append(y.cpu().numpy())
    return np.stack(outs)


def phase_transport_serving(torch, dev, sz: Sizes) -> None:
    """RingServer at C5-i16io and C5-pair (mega and per-step) and at
    C8-i16io (per-step), each ≡ its staged steps with dither on."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import split_bf16
    from afp_tpu_torch.runtime import RingServer

    g = torch.Generator(device=dev).manual_seed(40)
    srcf = list((torch.randn(sz.serve_blocks, sz.batch, sz.block, generator=g,
                             device=dev) * 0.3).cpu().numpy())
    src16 = list(pcm16(torch, dev, (sz.serve_blocks, sz.batch, sz.block), 41)
                 .cpu().numpy())
    for name, cfg, src in (
            ("C5-i16io", c5_config(sz, ingest="pcm16", emit="pcm16"), src16),
            ("C5-pair", c5_config(sz, ingest="pair"), srcf)):
        pipe = Pipeline(cfg, dev)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        outs = {}
        for mega in (True, False):
            outs[mega], stats = serve_warm(pipe, params, src, sz, mega=mega)
            lat = stats["latency"]
            say(f"phase 5 {name} RingServer mega={mega}, {sz.slots} slots, chunk "
                f"{sz.chunk}: {stats['blocks']} blocks in "
                f"{stats['wall_s'] * 1e3:.1f} ms once warm "
                f"({stats['wall_s'] * 1e3 / stats['blocks']:.2f} ms/block, "
                f"{stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, p95 "
                f"{lat['p95_ms']:.1f} ms land-to-drain, host clock)")
        staged = staged_outputs(torch, pipe, params, src)
        same = (np.array_equal(outs[True], outs[False])
                and np.array_equal(outs[False], staged))
        if pipe._pair_ingest:  # the producer's own (hi, lo) pairs, landed as is
            pairs = [split_bf16(torch.from_numpy(b)) for b in src[: sz.chunk]]
            srv = RingServer(pipe, params, slots=sz.slots, chunk=sz.chunk,
                             max_inflight=2, seed=0)
            same = same and np.array_equal(np.stack(list(srv.stream(iter(pairs)))),
                                           staged[: sz.chunk])
        check(same, f"{name} RingServer: mega, per-step and staged differ "
              "(dither on)")
        say(f"phase 5 {name} RingServer: mega == per-step == staged steps bit "
            f"for bit, dither on, output {outs[True].dtype}")

    pipe = Pipeline(c8_config(sz, ingest="pcm16", emit="pcm16"), dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    src = list(pcm16(torch, dev, (sz.serve_blocks, sz.c8_batch, sz.c8_block), 42,
                     scale=0.1).cpu().numpy())
    got, stats = serve_warm(pipe, params, src, sz)
    check(np.array_equal(got, staged_outputs(torch, pipe, params, src))
          and got.dtype == np.int16,
          "C8-i16io RingServer differs from the staged steps (dither on)")
    lat = stats["latency"]
    say(f"phase 5 C8-i16io RingServer per-step ring, {sz.slots} slots, chunk "
        f"{sz.chunk}: {stats['blocks']} blocks in {stats['wall_s'] * 1e3:.1f} ms "
        f"once warm ({stats['wall_s'] * 1e3 / stats['blocks']:.2f} ms/block, "
        f"{stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, p95 "
        f"{lat['p95_ms']:.1f} ms land-to-drain, host clock); ring == staged bit "
        f"for bit, dither on, int16 in and out")


def phase_transport_engine(torch, dev, sz: Sizes) -> None:
    """StreamEngine at C8-i16io: int16 blocks in and out through a dynamic
    AGC swap; a float block is refused before the ladder."""
    from afp_tpu_torch.engine import StreamEngine

    eng = StreamEngine(c8_config(sz, ingest="pcm16", emit="pcm16"), device=dev)
    blocks = pcm16(torch, dev, (6, sz.c8_batch, sz.c8_block), 50, scale=0.1).cpu().numpy()
    outs = []
    for i, blk in enumerate(blocks):
        if i == 4:
            check(eng.apply_config(replace(eng.cfg, agc_target_level=0.2)),
                  "C8-i16io apply_config with a new AGC target was not a dynamic swap")
        outs.append(eng.process_block(blk))
    try:
        eng.process_block(blocks[0].astype(np.float32))
        refused = False
    except ValueError:
        refused = True
    m = eng.metrics
    check(refused and m.underruns == m.fallback_replays == m.fallback_silence == 0,
          f"C8-i16io StreamEngine: float block refused {refused}, metrics "
          f"{m.snapshot()}")
    check(all(o.dtype == np.int16 and o.shape == (sz.c8_batch, sz.c8_block)
              and np.abs(o.astype(np.int32)).max() <= 0.99 * 32768 + 2
              for o in outs) and float(eng.params.agc_target) == np.float32(0.2),
          "C8-i16io StreamEngine outputs: dtype, shape, clip or the swap")
    say(f"phase 6 C8-i16io StreamEngine batch {sz.c8_batch}: 4 int16 blocks + "
        f"apply_config (agc_target_level 0.1 -> 0.2, dynamic) + 2, int16 out, "
        f"a float block refused (ValueError), metrics {m.snapshot()}")


# ---------------------------------------------------------------- banks


def c5_bank(pipe, interleaved: bool = False):
    """C5-bank: the four cutoffs of :data:`BANK_CUTOFFS` in batch/4-row
    groups (stream b → cutoff b·4 // B), or interleaved (stream b → cutoff
    b mod 4, packed: returns (params, packing))."""
    from afp_tpu_torch.engine import batch

    B = pipe.batch
    pick = (lambda b: b % 4) if interleaved else (lambda b: b * 4 // B)
    variants = [dict(cutoff=BANK_CUTOFFS[pick(b)]) for b in range(B)]
    return batch.with_per_stream_filters(pipe, variants, pack=interleaved)


def psg_gains(B: int, seed: int = 60) -> np.ndarray:
    """C8-psg: per-stream EQ gains [B, 9], uniform in [0, 2] (the EQ's
    linear gain, default 1.0)."""
    return np.random.default_rng(seed).uniform(0.0, 2.0, (B, 9)).astype(np.float32)


def psagc_policy(B: int) -> dict:
    """C8-psagc: the four policies of :data:`AGC_POLICIES` in batch/4-row
    groups, as [B] arrays."""
    return {k: np.repeat(np.asarray(v, np.float32), B // 4)
            for k, v in AGC_POLICIES.items()}


def psagc_params(pipe, params):
    from afp_tpu_torch.engine import batch

    pol = psagc_policy(pipe.batch)
    return batch.with_per_stream_agc(pipe, params, target_level=pol["target"],
                                     max_gain=pol["max_gain"],
                                     attack=pol["attack"], release=pol["release"])


def phase_kernels_banks(torch, dev, sz: Sizes) -> dict:
    """K10 and the banked K3/K4/K12 at C5-bank, K11 at C8-psg, and K5/K6
    with [B] vectors at C8-psagc, against their plain versions and their
    shared-taps or scalar forms on the same device tensors."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import agc_rms as R
    from afp_tpu_torch.ops.cuda import agc_scan as S
    from afp_tpu_torch.ops.cuda import dither_cuda
    from afp_tpu_torch.ops.cuda import fir_td as F

    pipe = Pipeline(c5_config(sz), dev)
    params = c5_bank(pipe)
    bank, assign = params.casc_bank, params.casc_assign
    n, kp, B, T, Sl = pipe.n_casc, pipe._k_pad, sz.batch, sz.block, sz.slots
    D, bt = bank.shape[0], B // assign.shape[0]
    rows = assign.long().repeat_interleave(bt)
    g = torch.Generator(device=dev).manual_seed(70)

    def randn(*shape, scale=0.3):
        return torch.randn(*shape, generator=g, device=dev) * scale

    dkw = dict(out_clip=0.2, dither_key=(5, 7), dither_bits=16, dither_tpdf=True)
    res = {}

    def per_design(banked, shared):
        """Each design's rows of the banked output ≡ the shared form's."""
        return all(torch.equal(banked(d)[..., rows == d, :], shared(d)[..., rows == d, :])
                   for d in range(D))

    # K10: the staged banked conv
    x_ext = randn(B, n - 1 + T)
    yk = F.fir_td_mxu_banked(x_ext, bank, assign)
    yp = F.fir_td_mxu_banked_plain(x_ext, bank, assign)
    e10 = err_db(yk.cpu(), yp.cpu())
    ye = F.fir_td_mxu_banked(x_ext, bank, assign, **dkw)
    epi_ok = torch.equal(ye, F._finish(yk, 0.2, (5, 7), 16, True))
    same = per_design(lambda d: ye, lambda d: F.fir_td_mxu(x_ext, bank[d], **dkw))
    check(e10 <= CONV_DB and epi_ok and same,
          f"K10: conv {e10:.1f} dB, epilogue {epi_ok}, rows == K1 per design {same}")
    t1 = time_ms(torch, lambda: F.fir_td_mxu(x_ext, bank[0], **dkw), 10)
    res["fir_td_mxu_banked"] = dict(
        max_abs_err=float((yk - yp).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_banked(x_ext, bank, assign, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_banked_plain(
            x_ext, bank, assign, **dkw), 2),
        **conv_bound(B * T, n, 4 * (B * (n - 1 + T) + D * n + B * T) + 4 * len(assign)),
        library_ms=library_conv(torch, "C5-bank", x_ext, bank[rows], yk))
    say(f"phase 3 K10 fir_td_mxu_banked [{B}, {n - 1}+{T}], {D} designs, "
        f"tile {bt}: conv {e10:.1f} dB vs plain, epilogue bit-exact, rows == K1 "
        f"on their design bit for bit; {res['fir_td_mxu_banked']['ms']:.3f} ms "
        f"(K1 {t1:.3f} ms in this call) vs plain "
        f"{res['fir_td_mxu_banked']['plain_ms']:.3f} ms")
    del x_ext, yk, yp, ye

    # the bank option of K3, K4, K12 and K12-mega
    ringf, tailf = randn(Sl, B, T), randn(B, kp)
    ring16, tail16 = pcm16(torch, dev, (Sl, B, T), 71), pcm16(torch, dev, (B, kp), 72)
    idx, start, steps = 5 % Sl, Sl - 2, sz.chunk
    outb, outs = (torch.zeros((Sl, B, T), device=dev) for _ in range(2))
    forms = (("K3", F.fir_td_mxu_ring_f32, F.fir_td_mxu_ring_f32_plain, ringf, tailf, False),
             ("K4", F.fir_td_mxu_ring_mega_f32, F.fir_td_mxu_ring_mega_f32_plain,
              ringf, tailf, True),
             ("K12", F.fir_td_mxu_ring_pcm16, F.fir_td_mxu_ring_pcm16_plain, ring16,
              tail16, False),
             ("K12-mega", F.fir_td_mxu_ring_mega_pcm16,
              F.fir_td_mxu_ring_mega_pcm16_plain, ring16, tail16, True))
    for name, fn, plain, ring, tail, mega in forms:
        args = (start, steps) if mega else (idx,)
        slots = [(start + i) % Sl for i in range(steps)] if mega else [idx]

        def run(f, h, out, **kw):
            return f(ring, args[0], tail, h, out, *args[1:], **kw)

        _, nt = run(fn, bank, outb, assign=assign)
        kout = outb[slots]
        _, pt = run(plain, bank, outs, assign=assign)
        e = max(err_db(kout[i].cpu(), outs[s].cpu()) for i, s in enumerate(slots))
        run(fn, bank, outb, assign=assign, **dkw)
        same = True
        for d in range(D):
            run(fn, bank[d], outs, **dkw)
            same = same and torch.equal(outb[slots][:, rows == d], outs[slots][:, rows == d])
        check(e <= CONV_DB and same and torch.equal(nt, pt),
              f"banked {name}: conv {e:.1f} dB, == shared per design {same}, tail "
              f"{torch.equal(nt, pt)}")
        tb = time_ms(torch, lambda: run(fn, bank, outb, assign=assign, **dkw), 5)
        ts = time_ms(torch, lambda: run(fn, bank[0], outs, **dkw), 5)
        say(f"phase 3 banked {name} {fn.__name__} ({len(slots)} step(s)): conv "
            f"{e:.1f} dB vs plain, tail bit-exact, rows == the shared form on "
            f"their design bit for bit (dither on); {tb:.3f} ms banked vs "
            f"{ts:.3f} ms shared in this call")
    del ringf, ring16, outb, outs, kout

    # K11 at C8-psg: nine bands, per-stream gains
    p8 = Pipeline(c8_config(sz), dev)
    p8par = p8.device_params(PipelineParams.design(p8.cfg))
    bands = p8par.casc_bands
    K, n8, B8, T8 = bands.shape[0], p8.n_casc, sz.c8_batch, sz.c8_block
    gains = torch.as_tensor(psg_gains(B8), device=dev)
    x8 = randn(B8, n8 - 1 + T8, scale=0.1)
    yk = F.fir_td_mxu_per_stream(x8, bands, gains)
    yp = F.fir_td_mxu_per_stream_plain(x8, bands, gains)
    e11 = err_db(yk.cpu(), yp.cpu())
    unfused = dither_cuda(torch.clamp(yk, -0.2, 0.2), (5, 7), 16, "tpdf")
    fused = torch.equal(F.fir_td_mxu_per_stream(x8, bands, gains, **dkw), unfused)
    fused16 = torch.equal(F.fir_td_mxu_per_stream(x8, bands, gains, emit_i16=True, **dkw),
                          F.quantize_pcm16(unfused))
    tiles = torch.equal(F.band_tiles(bands).cpu(), F.band_tiles(bands.cpu()))
    rows = k11_rows_alone(torch, F, x8, bands, gains, yk)
    check(e11 <= CONV_DB and fused and fused16 and tiles and rows,
          f"K11: conv {e11:.1f} dB, fused == K11 -> clip -> K2 {fused}, int16 "
          f"{fused16}, band tiles card == CPU {tiles}, rows alone == in the "
          f"batch {rows}")
    t1 = time_ms(torch, lambda: F.fir_td_mxu(x8, bands[0], **dkw), 10)
    res["fir_td_mxu_per_stream"] = dict(
        max_abs_err=float((yk - yp).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_per_stream(x8, bands, gains, **dkw), 5),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_per_stream_plain(
            x8, bands, gains, **dkw), 1),
        **bound(6.0 * B8 * T8 * n8 * K + 2.0 * B8 * T8 * K,
                4 * (B8 * (n8 - 1 + T8) + K * n8 + B8 * K + B8 * T8)),
        # one grouped F.conv1d over each row's mixed taps Σ_k g[b, k]·h_k, the
        # same function (the mix, formed outside the timing, rounds apart)
        library_ms=library_conv(torch, "C8-psg", x8,
                                (gains[:, :, None] * bands[None]).sum(1), yk))
    r = res["fir_td_mxu_per_stream"]
    say(f"phase 3 K11 fir_td_mxu_per_stream [{B8}, {n8 - 1}+{T8}] x {K} bands of "
        f"{n8} taps (tensor cores, bf16x3): conv {e11:.1f} dB vs plain, fused clip "
        f"+ dither (+ int16) == K11 -> clip -> K2 (-> quantize_pcm16) bit for bit, "
        f"band tiles card == CPU, rows alone == in the batch; {r['ms']:.3f} ms vs "
        f"F.conv1d over mixed taps {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} "
        f"ms ({r['bound_ms'] / r['ms']:.0%}); {K} x K1's {t1:.3f} ms = {K * t1:.3f} "
        f"ms in this call; plain {r['plain_ms']:.3f} ms")

    # K11's pair forms (behind the AGC): the split of x8's block behind the
    # split of its history, ≡ K11 on x8; the ring form's slot ≡ the staged;
    # each against its plain twin (conv ≤ CONV_DB, tails bit-exact)
    kp = F.ring_k_pad(n8)
    hist = torch.cat([torch.zeros(B8, kp - (n8 - 1), device=dev), x8[:, :n8 - 1]], 1)
    (xh, xl), (th, tl) = F.split_bf16(x8[:, n8 - 1:]), F.split_bf16(hist)
    yq, qh, ql = F.fir_td_mxu_per_stream_pair(xh, xl, th, tl, bands, gains, **dkw)
    out8 = torch.zeros((2, B8, T8), dtype=torch.int16, device=dev)
    out8, rh, rl = F.fir_td_mxu_per_stream_pair_to_ring(xh, xl, th, tl, bands, gains,
                                                        1, out8, **dkw)
    same = (torch.equal(yq, F.fir_td_mxu_per_stream(x8, bands, gains, **dkw))
            and torch.equal(out8[1], F.quantize_pcm16(yq)) and torch.equal(qh, rh)
            and torch.equal(ql, rl) and torch.equal(qh, xh[:, T8 - kp:]))
    check(same, "K11 pair forms: staged != K11 on the f32 block, ring slot != "
          "staged, or tails differ")
    ringk, ringp = (torch.zeros((2, B8, T8), device=dev) for _ in range(2))
    errs = {}
    pair = dict(
        fir_td_mxu_per_stream_pair=(
            F.fir_td_mxu_per_stream_pair(xh, xl, th, tl, bands, gains),
            F.fir_td_mxu_per_stream_pair_plain(xh, xl, th, tl, bands, gains),
            lambda f: f(xh, xl, th, tl, bands, gains, emit_i16=True, **dkw)),
        fir_td_mxu_per_stream_pair_to_ring=(
            F.fir_td_mxu_per_stream_pair_to_ring(xh, xl, th, tl, bands, gains, 1,
                                                 ringk),
            F.fir_td_mxu_per_stream_pair_to_ring_plain(xh, xl, th, tl, bands, gains,
                                                       1, ringp),
            lambda f: f(xh, xl, th, tl, bands, gains, 1, out8, **dkw)))
    for name, ((yk2, kh, kl), (yp2, ph, pl), call) in pair.items():
        if yk2.ndim == 3:  # the ring forms: their slot 1
            yk2, yp2 = yk2[1], yp2[1]
        e = errs[name] = err_db(yk2.cpu(), yp2.cpu())
        tails = torch.equal(kh, ph) and torch.equal(kl, pl)
        check(e <= CONV_DB and tails, f"{name}: conv {e:.1f} dB vs plain, tails "
              f"bit-exact {tails}")
        # the library has no pair loader: its form of the pair forms is K11's,
        # the grouped F.conv1d over mixed taps on the merged f32 block
        res[name] = dict(max_abs_err=float((yk2 - yp2).abs().max()),
                         ms=time_ms(torch, lambda: call(getattr(F, name)), 5),
                         plain_ms=time_ms(torch, lambda: call(getattr(F, name + "_plain")),
                                          1),
                         library_ms=r["library_ms"],
                         **bound(6.0 * B8 * T8 * n8 * K + 2.0 * B8 * T8 * K,
                                 4 * (B8 * T8 + K * n8 + B8 * K + B8 * kp)
                                 + 2 * B8 * T8))
    a, b = (res[k] for k in pair)
    say(f"phase 3 K11 pair forms [{B8}, {kp}+{T8}] (int16 out): staged == K11 on the "
        f"f32 block bit for bit, ring slot == staged, tails == the block's last "
        f"{kp}; vs plain: conv {' / '.join(f'{e:.1f}' for e in errs.values())} dB, tails "
        f"bit-exact; {a['ms']:.3f} ms staged, {b['ms']:.3f} ms into the ring "
        f"(plain {a['plain_ms']:.3f} / {b['plain_ms']:.3f} ms, F.conv1d over mixed "
        f"taps {r['library_ms']:.3f} ms)")
    del x8, yk, yp, unfused, xh, xl, th, tl, yq, out8, ringk, ringp, pair

    # K5 and K6 with [B] vectors at C8-psagc ≡ the scalar runs per group
    from afp_tpu_torch.ops.agc import agc_alphas

    pol = psagc_policy(B8)
    alphas = np.array([agc_alphas(sz.c8_window, a, r)
                       for a, r in zip(pol["attack"], pol["release"])], np.float32)
    vt, vm, va, vr = (torch.as_tensor(v, device=dev) for v in
                      (pol["target"], pol["max_gain"], alphas[:, 0], alphas[:, 1]))
    x = randn(B8, T8, scale=0.1)
    x[: B8 // 8] *= 8.0
    band = p8._rms_band
    lp, rp = p8._rms_pad
    init = torch.rand(B8, generator=g, device=dev) * 4.0 + 0.2
    grp = [slice(q * B8 // 4, (q + 1) * B8 // 4) for q in range(4)]
    same = True
    for mc in (0, 32):
        dv = R.rms_desired(x, band, lp, rp, vt, vm, True, transposed=True, mean_chunk=mc)
        for q, r in enumerate(grp):
            ds = R.rms_desired(x, band, lp, rp, float(vt[r][0]), float(vm[r][0]), True,
                               transposed=True, mean_chunk=mc)
            same = same and torch.equal(dv[:, r], ds[:, r])
    d = R.rms_desired(x, band, lp, rp, 0.1, 10.0, True, transposed=True)
    for bw in (None, 32):
        (yh, yl), cv = S.smooth_gain_apply(d, x, va, vr, vm, init=init, blockwise=bw,
                                           emit_split=True)
        for r in grp:
            (sh, sl), cs = S.smooth_gain_apply(d, x, float(va[r][0]), float(vr[r][0]),
                                               float(vm[r][0]), init=init, blockwise=bw,
                                               emit_split=True)
            same = (same and torch.equal(yh[r], sh[r]) and torch.equal(yl[r], sl[r])
                    and torch.equal(cv[r], cs[r]))
    check(same, "K5/K6 with [B] vectors differ from the scalar runs per group")
    t5v = time_ms(torch, lambda: R.rms_desired(x, band, lp, rp, vt, vm, True,
                                               transposed=True), 10)
    t5s = time_ms(torch, lambda: R.rms_desired(x, band, lp, rp, 0.1, 10.0, True,
                                               transposed=True), 10)
    t6v = time_ms(torch, lambda: S.smooth_gain_apply(d, x, va, vr, vm, init=init,
                                                     emit_split=True), 10)
    t6s = time_ms(torch, lambda: S.smooth_gain_apply(d, x, 0.1, 0.01, 10.0, init=init,
                                                     emit_split=True), 10)
    say(f"phase 3 K5/K6 [B] vectors at [{B8}, {T8}], 4 policies: K5 (exact, chunk "
        f"means) and K6 (exact, blockwise, pair, carry) == the scalar runs per "
        f"group bit for bit; K5 {t5v:.3f} ms vectors vs {t5s:.3f} ms scalars, K6 "
        f"{t6v:.3f} ms vs {t6s:.3f} ms")
    return res


def phase_bank_pipeline(torch, dev, sz: Sizes) -> None:
    """C5-bank, C8-psg and C8-psagc ('exact', 'fast') through
    `Pipeline.run`, each against its shared or scalar form, and their
    float64 oracles."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, batch

    g = torch.Generator(device=dev).manual_seed(80)
    pipe = Pipeline(c5_config(sz), dev)
    params = c5_bank(pipe)
    blocks = torch.randn(sz.run_blocks, sz.batch, sz.block, generator=g,
                         device=dev) * 0.3
    shared = pipe.device_params(PipelineParams.design(pipe.cfg))
    _, wall_shared = run_wall(torch, dev, pipe, shared, blocks)
    outs, wall = run_wall(torch, dev, pipe, params, blocks)
    check(outs.shape == blocks.shape and bool(torch.isfinite(outs).all()),
          "C5-bank Pipeline.run: shape or finiteness")
    bt = sz.batch // params.casc_assign.shape[0]
    rows = params.casc_assign.long().repeat_interleave(bt)
    same = all(torch.equal(outs[:2, rows == d], pipe.run(
        shared._replace(casc_main=params.casc_bank[d]), pipe.init_state(seed=0),
        blocks[:2])[1][:, rows == d]) for d in range(params.casc_bank.shape[0]))
    check(same, "C5-bank rows differ from the shared pipeline on their design")
    audio_s = sz.run_blocks * sz.batch * sz.block / pipe.cfg.samplerate
    say(f"phase 4 C5-bank Pipeline.run batch {sz.batch} x {sz.run_blocks} blocks, "
        f"{params.casc_bank.shape[0]} designs: {wall * 1e3:.1f} ms wall "
        f"({wall * 1e3 / sz.run_blocks:.2f} ms/block, {audio_s / wall:.0f}x "
        f"realtime, host clock; the shared C5 pipeline "
        f"{wall_shared * 1e3 / sz.run_blocks:.2f} ms/block in this call); rows == "
        f"the shared pipeline on their design bit for bit (2 blocks, dither on)")
    del blocks, outs

    blocks = torch.randn(sz.run_blocks, sz.c8_batch, sz.c8_block, generator=g,
                         device=dev) * 0.1
    blocks[:, : sz.c8_batch // 8] *= 8.0
    p8 = Pipeline(c8_config(sz), dev)
    base8 = p8.device_params(PipelineParams.design(p8.cfg))
    runs = [("C8-psg", p8, batch.with_per_stream_gains(p8, base8, psg_gains(sz.c8_batch)))]
    for mode in ("exact", "fast"):
        pm = Pipeline(c8_config(sz, agc_mode=mode), dev)
        runs.append((f"C8-psagc {mode}", pm, psagc_params(
            pm, pm.device_params(PipelineParams.design(pm.cfg)))))
    for name, pm, pp in runs:
        outs, wall = run_wall(torch, dev, pm, pp, blocks)
        check(outs.shape == blocks.shape and bool(torch.isfinite(outs).all())
              and float(outs.abs().max()) <= 0.99 + 2.0 ** -14,
              f"{name}: shape, finiteness or clip")
        note = ""
        if "psagc" in name:  # each policy group ≡ its scalar pipeline
            pol, same = psagc_policy(sz.c8_batch), True
            for q in range(4):
                r = slice(q * sz.c8_batch // 4, (q + 1) * sz.c8_batch // 4)
                pq = Pipeline(replace(pm.cfg, agc_target_level=float(pol["target"][r][0]),
                                      agc_max_gain=float(pol["max_gain"][r][0]),
                                      agc_attack=float(pol["attack"][r][0]),
                                      agc_release=float(pol["release"][r][0])), dev)
                _, sq = pq.run(pq.device_params(PipelineParams.design(pq.cfg)),
                               pq.init_state(seed=0), blocks[:2])
                same = same and torch.equal(outs[:2, r], sq[:, r])
            check(same, f"{name}: a policy group differs from its scalar pipeline")
            note = "; each policy group == its scalar pipeline bit for bit (2 blocks)"
        audio_s = sz.run_blocks * sz.c8_batch * sz.c8_block / pm.cfg.samplerate
        say(f"phase 4 {name} Pipeline.run batch {sz.c8_batch} x {sz.run_blocks} "
            f"blocks of {sz.c8_block}: {wall * 1e3:.1f} ms wall "
            f"({wall * 1e3 / sz.run_blocks:.2f} ms/block, {audio_s / wall:.0f}x "
            f"realtime, host clock){note}")
    del blocks, outs

    # the oracles, dither off: one stream per design (C5-bank, batch 32 in
    # tiles of 8), 4 streams with their own gains (C8-psg), one stream per
    # policy (C8-psagc)
    rng = np.random.default_rng(81)
    pipe = Pipeline(c5_config(sz, batch=32, dither_kind="off"), dev)
    params = c5_bank(pipe)
    x5 = (rng.standard_normal((32, 4 * sz.block)) * 0.3).astype(np.float32)
    _, out = pipe.process_signal(params, pipe.init_state(), x5, fold=False)
    e5 = max(err_db(out.cpu().numpy()[8 * d], c5_oracle(
        x5[8 * d: 8 * d + 1], pipe.cfg,
        PipelineParams.design(replace(pipe.cfg, cutoff=c).validate()))[0])
             for d, c in enumerate(BANK_CUTOFFS))
    x8 = (rng.standard_normal((4, 4 * sz.c8_block)) * 0.1).astype(np.float32)
    x8[0, : sz.c8_block] *= 8.0
    x8[1] *= 1e-2
    e8 = {}
    for name in ("C8-psg", "C8-psagc"):
        pipe = Pipeline(c8_config(sz, batch=4, dither_kind="off"), dev)
        design = PipelineParams.design(pipe.cfg)
        base = pipe.device_params(design)
        if name == "C8-psg":
            gains = psg_gains(4, seed=82)
            params, okw = batch.with_per_stream_gains(pipe, base, gains), dict(gains=gains)
        else:
            params, okw = psagc_params(pipe, base), dict(policy=psagc_policy(4))
        _, out = pipe.process_signal(params, pipe.init_state(), x8, fold=False)
        e8[name] = err_db(out.cpu().numpy(), c8_oracle(x8, pipe.cfg, design, **okw))
    check(max(e5, *e8.values()) < ORACLE_DB,
          f"bank oracles: C5-bank {e5:.1f} dB, {e8} (< {ORACLE_DB})")
    say(f"phase 4 oracles, dither off, 4 blocks: C5-bank one stream per design "
        f"{e5:.1f} dB, C8-psg 4 streams with their own gains {e8['C8-psg']:.1f} dB, "
        f"C8-psagc one stream per policy {e8['C8-psagc']:.1f} dB vs float64 "
        f"(< {ORACLE_DB})")


def phase_bank_serving(torch, dev, sz: Sizes) -> None:
    """RingServer at C5-bank (mega and per-step), C5-i16io-bank (mega),
    C5-bank-packed, C8-psagc and C8-psg (per-step), each ≡ its staged steps
    (or the contiguous bank in caller order), dither on."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, batch

    g = torch.Generator(device=dev).manual_seed(90)
    src = list((torch.randn(sz.serve_blocks, sz.batch, sz.block, generator=g,
                            device=dev) * 0.3).cpu().numpy())
    pipe = Pipeline(c5_config(sz), dev)
    params = c5_bank(pipe)

    def served(name, pipe, params, src, mega, **kw):
        out, stats = serve_warm(pipe, params, src, sz, mega=mega, **kw)
        lat = stats["latency"]
        say(f"phase 5 {name} RingServer mega={mega}, {sz.slots} slots, chunk "
            f"{sz.chunk}: {stats['blocks']} blocks in {stats['wall_s'] * 1e3:.1f} ms "
            f"once warm ({stats['wall_s'] * 1e3 / stats['blocks']:.2f} ms/block, "
            f"{stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, p95 "
            f"{lat['p95_ms']:.1f} ms land-to-drain, host clock)")
        return out

    outs = {m: served("C5-bank", pipe, params, src, m) for m in (True, False)}
    staged = staged_outputs(torch, pipe, params, src)
    check(np.array_equal(outs[True], outs[False]) and np.array_equal(outs[True], staged),
          "C5-bank RingServer: mega, per-step and staged differ (dither on)")
    say("phase 5 C5-bank RingServer: mega == per-step == staged steps bit for bit, "
        "dither on")

    pp = Pipeline(c5_config(sz), dev)
    pparams, pk = c5_bank(pp, interleaved=True)
    same_bank = (torch.equal(pparams.casc_bank, params.casc_bank)
                 and torch.equal(pparams.casc_assign, params.casc_assign))
    packed = served("C5-bank-packed", pp, pparams, src, True, packing=pk)
    contiguous = served("C5-bank on the packed order", pipe, params,
                        [pk.pack(b) for b in src], True)
    check(same_bank and np.array_equal(packed, pk.unpack(contiguous, axis=1)),
          f"C5-bank-packed differs from C5-bank in caller order (same bank {same_bank})")
    say("phase 5 C5-bank-packed (stream i -> cutoff i mod 4, pack=True) == C5-bank "
        "on the same streams in caller order, bit for bit, dither on")
    del outs, staged, packed, contiguous

    p16 = Pipeline(c5_config(sz, ingest="pcm16", emit="pcm16"), dev)
    src16 = list(pcm16(torch, dev, (sz.serve_blocks, sz.batch, sz.block), 91)
                 .cpu().numpy())
    got = served("C5-i16io-bank", p16, params, src16, True)
    check(got.dtype == np.int16
          and np.array_equal(got, staged_outputs(torch, p16, params, src16)),
          "C5-i16io-bank RingServer differs from its staged steps (dither on)")
    say("phase 5 C5-i16io-bank RingServer mega == staged steps (banked K12 over "
        "the one-slot view) bit for bit, dither on, int16 in and out")
    del got, src, src16

    p8 = Pipeline(c8_config(sz), dev)
    par8 = psagc_params(p8, p8.device_params(PipelineParams.design(p8.cfg)))
    src8 = list((torch.randn(sz.serve_blocks, sz.c8_batch, sz.c8_block, generator=g,
                             device=dev) * 0.1).cpu().numpy())
    got = served("C8-psagc", p8, par8, src8, False)
    check(np.array_equal(got, staged_outputs(torch, p8, par8, src8)),
          "C8-psagc RingServer differs from its staged steps (dither on)")
    say("phase 5 C8-psagc RingServer per-step ring == staged steps bit for bit, "
        "dither on")
    psg = batch.with_per_stream_gains(
        p8, p8.device_params(PipelineParams.design(p8.cfg)), psg_gains(sz.c8_batch))
    got = served("C8-psg", p8, psg, src8, False)
    check(np.array_equal(got, staged_outputs(torch, p8, psg, src8)),
          "C8-psg RingServer differs from its staged steps (dither on)")
    say("phase 5 C8-psg RingServer per-step ring (K5 -> K6 -> K11 pair-to-ring) == "
        "staged steps (K11 pair) bit for bit, dither on")


def phase_bank_engine(torch, dev, sz: Sizes) -> None:
    """StreamEngine at QS-psg: 4 blocks, per-stream gains [B, 9], 2 more
    (set_eq_gains then takes [B, 9]); ≡ a Pipeline stepped alongside; no
    ladder fallback."""
    from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                      StreamEngine, batch)

    cfg = StreamConfig(**{**QUICKSTART, "batch": sz.quick_batch, "blocksize": sz.block})
    eng = StreamEngine(cfg, device=dev, seed=5)
    pipe = Pipeline(cfg, dev)
    params, st = pipe.device_params(PipelineParams.design(pipe.cfg)), pipe.init_state(seed=5)
    rng = np.random.default_rng(92)
    same = True
    for i in range(6):
        if i == 4:
            gains = psg_gains(sz.quick_batch, seed=93)
            eng.params = batch.with_per_stream_gains(eng.pipeline, eng.params, gains)
            params = batch.with_per_stream_gains(pipe, params, gains)
        if i == 5:
            gains = psg_gains(sz.quick_batch, seed=94)
            eng.set_eq_gains(gains)
            params = batch.with_per_stream_gains(pipe, params, gains)
        blk = (rng.standard_normal((sz.quick_batch, sz.block)) * 0.1).astype(np.float32)
        out = eng.process_block(blk)
        st, want = pipe.step(params, st, blk)
        same = same and np.array_equal(out, want.cpu().numpy())
        check(np.isfinite(out).all() and np.abs(out).max() <= 0.99 + 2.0 ** -22,
              "QS-psg StreamEngine: finiteness or clip")
    m = eng.metrics
    check(same and m.underruns == m.fallback_replays == m.fallback_silence == 0,
          f"QS-psg StreamEngine: == the pipeline {same}, metrics {m.snapshot()}")
    say(f"phase 6 QS-psg StreamEngine (fft, EQ, batch {sz.quick_batch}): 4 blocks + "
        f"per-stream gains [{sz.quick_batch}, 9] + 1 + set_eq_gains "
        f"[{sz.quick_batch}, 9] + 1, == a Pipeline stepped alongside bit for bit, "
        f"metrics {m.snapshot()}")


# ---------------------------------------------------------------- K15, K14, K9


def k11_rows_alone(torch, F, x_ext, bands, gains, y, **kw) -> bool:
    """Rows of K11 run alone, and as a 5-row batch that starts inside a row
    tile, equal the same rows inside the whole batch `y`, bit for bit (an
    output's sum order depends only on its column)."""
    alone = all(torch.equal(F.fir_td_mxu_per_stream(x_ext[b:b + 1], bands,
                                                    gains[b:b + 1], **kw), y[b:b + 1])
                for b in (0, 13, x_ext.shape[0] - 1))
    return alone and torch.equal(
        F.fir_td_mxu_per_stream(x_ext[3:8], bands, gains[3:8], **kw), y[3:8])


def phase_kernels_last(torch, dev, sz: Sizes) -> dict:
    """K15's HIGHEST K1 at the C5 headline and HIGHEST K11 at C8-psg
    (≤ −110 dB against their plain versions, B3F/B3C ≡ B3, with the
    same-function F.conv1d yardstick), K14 at the C8 point (f32, int16,
    pair store, ring slot; restart and carry) and K9 at [c8_batch, c8_block]
    (both layouts, restart and carry), each bit-exact against its plain
    version."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops import agc as A
    from afp_tpu_torch.ops.cuda import agc_fused as K14
    from afp_tpu_torch.ops.cuda import agc_rms as R
    from afp_tpu_torch.ops.cuda import agc_scan as S
    from afp_tpu_torch.ops.cuda import dither_cuda
    from afp_tpu_torch.ops.cuda import fir_td as F

    pipe = Pipeline(c5_config(sz), dev)
    h = pipe.device_params(PipelineParams.design(pipe.cfg)).casc_main
    n, B, T = pipe.n_casc, sz.batch, sz.block
    g = torch.Generator(device=dev).manual_seed(100)
    dkw = dict(out_clip=0.2, dither_key=(5, 7), dither_bits=16, dither_tpdf=True)
    hi = dict(precision="HIGHEST")
    res = {}

    # K15: HIGHEST K1 at the C5 headline; B3F and B3C are the B3 body
    x_ext = torch.randn(B, n - 1 + T, generator=g, device=dev) * 0.3
    yk = F.fir_td_mxu(x_ext, h, **hi)
    yp = F.fir_td_mxu_plain(x_ext, h, **hi)
    e15 = err_db(yk.cpu(), yp.cpu())
    epi = torch.equal(F.fir_td_mxu(x_ext, h, **hi, **dkw), F._finish(yk, 0.2, (5, 7), 16, True))
    b3 = F.fir_td_mxu(x_ext, h, **dkw)
    same = all(torch.equal(F.fir_td_mxu(x_ext, h, precision=p, **dkw), b3)
               for p in ("B3F", "B3C"))
    e_b3 = err_db(b3.cpu(), F.fir_td_mxu(x_ext, h, **hi, **dkw).cpu())
    one = torch.ones(B, 1, device=dev)
    k11 = {p: torch.equal(F.fir_td_mxu(x_ext, h, precision=p),
                          F.fir_td_mxu_per_stream(x_ext, h[None], one, precision=p))
           for p in ("B3", "HIGHEST")}
    check(e15 <= CONV_DB and epi and same and all(k11.values()),
          f"K15 HIGHEST K1: {e15:.1f} dB, epilogue {epi}, B3F/B3C == B3 {same}, "
          f"K1 == one-band K11 at gain 1 {k11}")
    t_b3 = time_ms(torch, lambda: F.fir_td_mxu(x_ext, h, **dkw), 10)
    res["fir_td_mxu:highest"] = dict(
        max_abs_err=float((yk - yp).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu(x_ext, h, **hi, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_plain(x_ext, h, **hi, **dkw), 3),
        # six bf16 products per tap on the tensor cores (the TPU's HIGHEST)
        **bound(12.0 * B * T * n, 4 * (B * (n - 1 + T) + n + B * T)),
        library_ms=library_conv(torch, "C5 HIGHEST", x_ext, h, yk))
    r = res["fir_td_mxu:highest"]
    say(f"phase 3 K15 HIGHEST K1 fir_td_mxu(precision='HIGHEST') [{B}, {n - 1}+{T}] "
        f"x {n} taps: {e15:.1f} dB vs plain, epilogue bit-exact, {e_b3:.1f} dB "
        f"from B3; B3F and B3C == B3 bit for bit; K1 == K11 with the one band at "
        f"gain 1.0, B3 and HIGHEST, bit for bit; {r['ms']:.3f} ms (B3 {t_b3:.3f} "
        f"ms in this call) vs plain {r['plain_ms']:.3f} ms")
    del x_ext, yk, yp, b3

    # K15: HIGHEST K11 at C8-psg
    p8 = Pipeline(c8_config(sz), dev)
    bands = p8.device_params(PipelineParams.design(p8.cfg)).casc_bands
    K, n8, B8, T8 = bands.shape[0], p8.n_casc, sz.c8_batch, sz.c8_block
    gains = torch.as_tensor(psg_gains(B8), device=dev)
    x8 = torch.randn(B8, n8 - 1 + T8, generator=g, device=dev) * 0.1
    yk = F.fir_td_mxu_per_stream(x8, bands, gains, **hi)
    yp = F.fir_td_mxu_per_stream_plain(x8, bands, gains, **hi)
    e11 = err_db(yk.cpu(), yp.cpu())
    unfused = dither_cuda(torch.clamp(yk, -0.2, 0.2), (5, 7), 16, "tpdf")
    fused = torch.equal(F.fir_td_mxu_per_stream(x8, bands, gains, **hi, **dkw), unfused)
    fused16 = torch.equal(F.fir_td_mxu_per_stream(x8, bands, gains, emit_i16=True, **hi,
                                                  **dkw), F.quantize_pcm16(unfused))
    tiles = torch.equal(F.band_tiles(bands, True).cpu(), F.band_tiles(bands.cpu(), True))
    rows = k11_rows_alone(torch, F, x8, bands, gains, yk, **hi)
    check(e11 <= CONV_DB and fused and fused16 and tiles and rows,
          f"K15 HIGHEST K11: {e11:.1f} dB, fused epilogue {fused}, int16 {fused16}, "
          f"band tiles card == CPU {tiles}, rows alone == in the batch {rows}")
    t_b3 = time_ms(torch, lambda: F.fir_td_mxu_per_stream(x8, bands, gains, **dkw), 5)
    res["fir_td_mxu_per_stream:highest"] = dict(
        max_abs_err=float((yk - yp).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_per_stream(x8, bands, gains, **hi,
                                                          **dkw), 5),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_per_stream_plain(
            x8, bands, gains, **hi, **dkw), 1),
        # six bf16 products per tap and band on the tensor cores, and the mix
        **bound(12.0 * B8 * T8 * n8 * K + 2.0 * B8 * T8 * K,
                4 * (B8 * (n8 - 1 + T8) + K * n8 + B8 * K + B8 * T8)),
        # one grouped F.conv1d over each row's mixed taps, as for K11
        library_ms=library_conv(torch, "C8-psg HIGHEST", x8,
                                (gains[:, :, None] * bands[None]).sum(1), yk))
    r = res["fir_td_mxu_per_stream:highest"]
    say(f"phase 3 K15 HIGHEST K11 fir_td_mxu_per_stream(precision='HIGHEST') "
        f"[{B8}, {n8 - 1}+{T8}] x {K} bands (tensor cores, six products): "
        f"{e11:.1f} dB vs plain, fused clip + dither (+ int16) == K11 -> clip -> "
        f"K2, band tiles card == CPU, rows alone == in the batch; {r['ms']:.3f} ms "
        f"vs F.conv1d over mixed taps {r['library_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_ms'] / r['ms']:.0%}); B3 {t_b3:.3f} ms "
        f"in this call; plain {r['plain_ms']:.3f} ms")
    del x8, yk, yp, unfused

    # K14 at the C8 point: every input form, restart and carry, bit-exact
    W = sz.c8_window
    knobs = (p8.agc.a_att, p8.agc.a_rel, 0.1, 10.0)
    x = torch.randn(B8, T8, generator=g, device=dev) * 0.1
    x[: B8 // 8] *= 8.0
    x16 = torch.clamp(torch.round(x * 32768), -32768, 32767).to(torch.int16)
    ring = torch.stack([torch.zeros_like(x), x, torch.ones_like(x)])
    init = torch.rand(B8, generator=g, device=dev) * 4.0 + 0.2
    cases = [("f32 restart", x, {}), ("f32 carry", x, dict(init=init)),
             ("int16 carry", x16, dict(init=init)),
             ("pair carry", x, dict(init=init, emit_split=True)),
             ("ring slot, pair, restart", ring, dict(ring_idx=1, emit_split=True))]
    for name, src, kw in cases:
        yk, ck = K14.agc_rms_apply(src, W, *knobs, **kw)
        yp, cp = K14.agc_rms_apply_plain(src, W, *knobs, **kw)
        ys = (all(torch.equal(a, b) for a, b in zip(yk, yp)) if isinstance(yk, tuple)
              else torch.equal(yk, yp))
        ng = int((ck != cp).sum())
        check(ys and ng == 0, f"K14 {name}: output equal {ys}, {ng} gains differ")
    def k14():
        return K14.agc_rms_apply(x, W, *knobs, init=init, emit_split=True)

    res["agc_rms_apply"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, k14, 10), device_ms=device_ms(torch, k14),
        plain_ms=time_ms(torch, lambda: K14.agc_rms_apply_plain(
            x, W, *knobs, init=init, emit_split=True), 1),
        # ~20 fp32 operations per sample (square, two running sums, the
        # window, sqrt, divide, clips, the recurrence, the apply)
        **bound(20.0 * B8 * T8, 8 * B8 * T8 + 8 * B8, FP32_FLOPS), library_ms=None)
    r = res["agc_rms_apply"]
    # the two-kernel chain it replaces, on the device alone in this call
    d56 = R.rms_desired(x, p8._rms_band, *p8._rms_pad, 0.1, 10.0, True, transposed=True)
    t5 = device_ms(torch, lambda: R.rms_desired(x, p8._rms_band, *p8._rms_pad, 0.1,
                                                10.0, True, transposed=True))
    t6 = device_ms(torch, lambda: S.smooth_gain_apply(d56, x, *knobs[:2], 10.0, init=init,
                                                      emit_split=True))
    say(f"phase 3 K14 agc_rms_apply [{B8}, {T8}] W={W}: {', '.join(c[0] for c in cases)} "
        f"== plain bit for bit (output and gain); {r['ms']:.4f} ms a call back to back, "
        f"{r['device_ms']:.4f} ms on the device alone (K5 + K6 on the device in this "
        f"call: {t5:.4f} + {t6:.4f} = {t5 + t6:.4f} ms) vs plain {r['plain_ms']:.3f} ms")
    del d56
    del ring, x16

    # K9 at the same shape: both layouts and stores, restart and carry
    d = R.rms_desired(x, p8._rms_band, *p8._rms_pad, 0.1, 10.0, True, transposed=True)
    db = d.T.contiguous()
    buf = torch.empty(d.numel() + 1, device=dev)
    d_off = buf[1:].view(d.shape)  # one element off: the 4-byte staging
    d_off.copy_(d)
    for ini in (None, init):
        want = A.smooth_gain_scan(db, *knobs[:2], init=ini)
        for tm, src in ((False, db), (True, d), (True, d_off)):
            for bm in (False, True):
                got = S.smooth_gain_scan(src, *knobs[:2], init=ini,
                                         time_major=tm, out_batch_major=bm)
                check(torch.equal(got, want),
                      f"K9 time_major={tm} out_batch_major={bm} aligned "
                      f"{src is not d_off} init={ini is not None}: differs from the "
                      f"plain scan")
    del buf, d_off

    def k9():
        return S.smooth_gain_scan(d, *knobs[:2], init=init, time_major=True,
                                  out_batch_major=True)

    res["smooth_gain_scan"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, k9, 10), device_ms=device_ms(torch, k9),
        plain_ms=time_ms(torch, lambda: A.smooth_gain_scan(db, *knobs[:2], init=init), 1),
        # compare, select, subtract, multiply, fma per step
        **bound(5.0 * B8 * T8, 8 * B8 * T8 + 4 * B8, FP32_FLOPS), library_ms=None)
    r = res["smooth_gain_scan"]
    say(f"phase 3 K9 smooth_gain_scan [{T8}, {B8}] (aligned and one element off) "
        f"and [{B8}, {T8}] in, both stores, restart and carry: == the plain scan bit "
        f"for bit; {r['ms']:.4f} ms a call back to back, {r['device_ms']:.4f} ms on "
        f"the device alone (time-major in, batch-major store) vs plain "
        f"{r['plain_ms']:.3f} ms")
    return res


def phase_highest_pipeline(torch, dev, sz: Sizes) -> None:
    """C5-highest, C8-highest and C8-psg-highest (``td_precision='HIGHEST'``:
    HIGHEST K1, and HIGHEST K11 under per-stream gains) through
    `Pipeline.run`, 8 blocks at full batch, and their float64 oracles."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, batch

    g = torch.Generator(device=dev).manual_seed(110)
    for name, cfg, B, T, scale in (
            ("C5-highest", c5_config(sz), sz.batch, sz.block, 0.3),
            ("C8-highest", c8_config(sz), sz.c8_batch, sz.c8_block, 0.1),
            ("C8-psg-highest", c8_config(sz), sz.c8_batch, sz.c8_block, 0.1)):
        pipe = Pipeline(cfg, dev, td_precision="HIGHEST")
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        if "psg" in name:
            params = batch.with_per_stream_gains(pipe, params, psg_gains(B))
        blocks = torch.randn(sz.run_blocks, B, T, generator=g, device=dev) * scale
        outs, wall = run_wall(torch, dev, pipe, params, blocks)
        check(outs.shape == blocks.shape and bool(torch.isfinite(outs).all()),
              f"{name} Pipeline.run: shape or finiteness")
        audio_s = sz.run_blocks * B * T / pipe.cfg.samplerate
        say(f"phase 4 {name} Pipeline.run batch {B} x {sz.run_blocks} blocks of {T}: "
            f"{wall * 1e3:.1f} ms wall ({wall * 1e3 / sz.run_blocks:.2f} ms/block, "
            f"{audio_s / wall:.0f}x realtime, host clock)")
        del blocks, outs

    rng = np.random.default_rng(111)
    x5 = (rng.standard_normal((1, 4 * sz.block)) * 0.3).astype(np.float32)
    x8 = (rng.standard_normal((4, 4 * sz.c8_block)) * 0.1).astype(np.float32)
    x8[0, : sz.c8_block] *= 8.0
    x8[1] *= 1e-2
    es = {}
    gains = psg_gains(4, seed=112)
    for name, base, x, oracle in (
            ("C5-highest", c5_config(sz, batch=1), x5, c5_oracle),
            ("C8-highest", c8_config(sz, batch=4), x8, c8_oracle),
            ("C8-psg-highest", c8_config(sz, batch=4), x8, c8_oracle)):
        pipe = Pipeline(replace(base, dither_kind="off"), dev, td_precision="HIGHEST")
        design = PipelineParams.design(pipe.cfg)
        params, okw = pipe.device_params(design), {}
        if "psg" in name:
            params = batch.with_per_stream_gains(pipe, params, gains)
            okw = dict(gains=gains)
        _, out = pipe.process_signal(params, pipe.init_state(), x, fold=False)
        es[name] = err_db(out.cpu().numpy(), oracle(x, pipe.cfg, design, **okw))
    check(max(es.values()) < ORACLE_DB, f"HIGHEST oracles: {es} (< {ORACLE_DB})")
    say(f"phase 4 HIGHEST oracles, dither off, 4 blocks: C5-highest one stream "
        f"{es['C5-highest']:.1f} dB, C8-highest 4 streams {es['C8-highest']:.1f} dB, "
        f"C8-psg-highest 4 streams with their own gains {es['C8-psg-highest']:.1f} dB "
        f"vs float64 (< {ORACLE_DB})")


def phase_one_kernel(torch, dev, sz: Sizes) -> None:
    """C8-one (``agc_one_kernel=True``, 'exact'): `Pipeline.run` 8 blocks at
    full batch (K14 → K8), its float64 oracle, and a per-step `RingServer`
    (K14 over the slot → K7) ≡ its staged steps bit for bit with dither on."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams

    g = torch.Generator(device=dev).manual_seed(120)
    pipe = Pipeline(c8_config(sz), dev, agc_one_kernel=True)
    check(pipe._agc_one_kernel, "C8-one: the one-kernel gate is off")
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    blocks = torch.randn(sz.run_blocks, sz.c8_batch, sz.c8_block, generator=g,
                         device=dev) * 0.1
    outs, wall = run_wall(torch, dev, pipe, params, blocks)
    check(outs.shape == blocks.shape and bool(torch.isfinite(outs).all())
          and float(outs.abs().max()) <= 0.99 + 2.0 ** -14,
          "C8-one Pipeline.run: shape, finiteness or clip")
    audio_s = sz.run_blocks * sz.c8_batch * sz.c8_block / pipe.cfg.samplerate
    say(f"phase 4 C8-one Pipeline.run batch {sz.c8_batch} x {sz.run_blocks} blocks "
        f"of {sz.c8_block}: {wall * 1e3:.1f} ms wall ({wall * 1e3 / sz.run_blocks:.2f} "
        f"ms/block, {audio_s / wall:.0f}x realtime, host clock)")
    del blocks, outs

    opipe = Pipeline(c8_config(sz, batch=4, dither_kind="off"), dev, agc_one_kernel=True)
    design = PipelineParams.design(opipe.cfg)
    x = (np.random.default_rng(121).standard_normal((4, 4 * sz.c8_block)) * 0.1
         ).astype(np.float32)
    x[0, : sz.c8_block] *= 8.0
    x[1] *= 1e-2
    _, out = opipe.process_signal(opipe.device_params(design), opipe.init_state(), x,
                                  fold=False)
    e = err_db(out.cpu().numpy(), c8_oracle(x, opipe.cfg, design))
    check(e < ORACLE_DB, f"C8-one oracle: {e:.1f} dB (< {ORACLE_DB})")
    say(f"phase 4 C8-one oracle: 4 streams, 4 blocks, dither off: {e:.1f} dB vs the "
        f"float64 AGC + chain (< {ORACLE_DB})")

    src = list((torch.randn(sz.serve_blocks, sz.c8_batch, sz.c8_block, generator=g,
                            device=dev) * 0.1).cpu().numpy())
    got, stats = serve_warm(pipe, params, src, sz)
    check(np.array_equal(got, staged_outputs(torch, pipe, params, src)),
          "C8-one RingServer differs from its staged steps (dither on)")
    lat = stats["latency"]
    say(f"phase 5 C8-one RingServer per-step ring, {sz.slots} slots, chunk "
        f"{sz.chunk}: {stats['blocks']} blocks in {stats['wall_s'] * 1e3:.1f} ms once "
        f"warm ({stats['wall_s'] * 1e3 / stats['blocks']:.2f} ms/block, "
        f"{stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, p95 "
        f"{lat['p95_ms']:.1f} ms land-to-drain, host clock); ring == staged bit for "
        f"bit, dither on")


def phase_fold(torch, dev, sz: Sizes) -> None:
    """The offline fold of a stereo file: C5 at batch 2 over 256 blocks
    (about 24 s of audio), dither off: ``fold=True`` ≡ the scan bit for bit
    (outputs and carried state), both walls printed; again at HIGHEST."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams

    nb = 256
    x = (np.random.default_rng(130).standard_normal((2, nb * sz.block)) * 0.3
         ).astype(np.float32)
    for prec in ("B3", "HIGHEST"):
        pipe = Pipeline(c5_config(sz, batch=2, dither_kind="off"), dev,
                        td_precision=prec)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        check(pipe._fold_decision("auto", params) == (dev.type == "cuda"),
              f"fold {prec}: 'auto' does not fold on the card")
        walls, res = {}, {}
        for fold in (True, False):
            pipe.process_signal(params, pipe.init_state(), x[:, : 8 * sz.block], fold=fold)
            sync(torch, dev)
            t0 = time.perf_counter()
            res[fold] = pipe.process_signal(params, pipe.init_state(), x, fold=fold)
            sync(torch, dev)
            walls[fold] = time.perf_counter() - t0
        (sf, yf), (ss, ys) = res[True], res[False]
        same = (torch.equal(yf, ys) and torch.equal(sf.conv_tail, ss.conv_tail)
                and sf.step == ss.step == nb)
        check(same, f"fold {prec}: the fold differs from the scan (dither off)")
        audio_s = nb * sz.block / pipe.cfg.samplerate
        say(f"phase 4 fold {prec} C5 batch 2 x {nb} blocks ({audio_s:.1f} s of stereo "
            f"audio): fold {walls[True] * 1e3:.1f} ms, scan {walls[False] * 1e3:.1f} ms "
            f"wall (host clock, {walls[False] / walls[True]:.1f}x); fold == scan bit "
            f"for bit (outputs, tail, step), dither off; 'auto' "
            f"{'folds' if dev.type == 'cuda' else 'scans'} here")


def phase_apply_agc(torch, dev, sz: Sizes) -> None:
    """`apply_agc` on the card at [c8_batch, c8_block] (its recurrence is K9)
    ≡ the same chain with the plain recurrence, bit for bit, restart and
    carry."""
    from afp_tpu_torch.ops import agc as A

    g = torch.Generator(device=dev).manual_seed(140)
    x = torch.randn(sz.c8_batch, sz.c8_block, generator=g, device=dev) * 0.1
    x[: sz.c8_batch // 8] *= 8.0
    params = A.AGCParams(window_size=sz.c8_window)
    mg = torch.tensor(params.max_gain, dtype=torch.float32, device=dev)
    A.apply_agc(x, params)  # warm-up: cuFFT's plans for the moving RMS
    carry = None
    for i in range(2):
        sync(torch, dev)
        t0 = time.perf_counter()
        y, gl = A.apply_agc(x, params, carry)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        d = A.desired_gain(A.moving_rms(x, params.window_size), params.target_level,
                           params.max_gain)
        gp = torch.minimum(torch.clamp_min(A.smooth_gain_scan(
            d, params.a_att, params.a_rel, init=carry), 0.1), mg)
        check(torch.equal(y, x * gp) and torch.equal(gl, gp[:, -1]),
              f"apply_agc on the card differs from its plain run (carry {i > 0})")
        say(f"phase 4 apply_agc [{sz.c8_batch}, {sz.c8_block}] W={sz.c8_window} on the "
            f"card (K9), carry {carry is not None}: == the plain recurrence bit for "
            f"bit; {wall * 1e3:.1f} ms wall (host clock)")
        carry = gl


# ---------------------------------------------------------------- phase 8

#: the CLI's rate and block (its defaults: 2048 samples, 2× upsample, the
#: 129-tap lowpass at 14 kHz, 'fft', TPDF dither at 24 bits)
CLI_RATE, CLI_BLOCK = 44100, 2048
SMOKE_CLI = Path(__file__).resolve().parent / "build" / "smoke_cli"


def cli_oracle(x: np.ndarray, cfg, design) -> np.ndarray:
    """The CLI's chain in float64 over [B, N] input of whole blocks: with
    ``agc_enabled`` first the AGC per block as `c8_oracle` writes it, its
    desired gain linked by the minimum over each ``agc_link_group`` rows;
    then upsample, the main FIR, the resampling downsampler
    (``downsample_mode='resample'``), decimate, and the output clip; under
    ``output_rate='upsampled'`` neither the downsampler nor the decimation
    (the literal chain's high-rate output)."""
    import scipy.signal as sps

    from afp_tpu_torch.ops.agc import agc_alphas
    from afp_tpu_torch.ops.resample import streaming_kernel

    x = x.astype(np.float64)
    B, N = x.shape
    if cfg.agc_enabled:
        L, w, grp = cfg.blocksize, cfg.agc_window_size, cfg.agc_link_group
        a_att, a_rel = agc_alphas(w, cfg.agc_attack, cfg.agc_release)
        g, gained = np.ones(B), np.empty_like(x)
        for b0 in range(0, N, L):
            xb = x[:, b0:b0 + L]
            ss = np.stack([np.convolve(r, np.ones(w) / w, "same") for r in xb * xb])
            d = np.clip(cfg.agc_target_level / (np.sqrt(np.maximum(ss, 0)) + 1e-10),
                        0, cfg.agc_max_gain)
            d = np.repeat(d.reshape(B // grp, grp, -1).min(axis=1), grp, axis=0)
            gs = np.empty_like(d)
            for i in range(d.shape[1]):
                a = np.where(d[:, i] > g, a_att, a_rel)
                g = a * d[:, i] + (1 - a) * g
                gs[:, i] = g
            gs = np.clip(gs, 0.1, cfg.agc_max_gain)
            g = gs[:, -1]
            gained[:, b0:b0 + L] = np.clip(xb * gs, -0.99, 0.99)
        x = gained
    upf = cfg.upsample_factor
    h_up = streaming_kernel(upf, 1, quality=cfg.resample_quality)
    upsampled = cfg.output_rate == "upsampled"
    h_down = (streaming_kernel(1, upf, quality=cfg.resample_quality)
              if cfg.downsample_mode == "resample" and upf > 1
              and not upsampled else None)
    out = []
    for r in x:
        y = sps.upfirdn(h_up, r, upf, 1)[: N * upf]
        y = np.convolve(y, design.main_taps.astype(np.float64))[: len(y)]
        if h_down is not None:
            y = np.convolve(y, h_down)[: len(y)]
        out.append(y if upsampled else y[::upf])
    y = np.stack(out)
    return y if cfg.output_clip is None else np.clip(y, -cfg.output_clip,
                                                     cfg.output_clip)


@contextlib.contextmanager
def tracked_engines():
    """The StreamEngines the CLI builds in the block, in order: the CLI
    keeps its engine inside the command, and the smoke reads their
    metrics (the degradation ladder swallows exceptions by design, so a
    kernel that failed would show only in its counters)."""
    import afp_tpu_torch.engine as E
    import afp_tpu_torch.engine.checkpoint as C

    built, base = [], E.StreamEngine

    class Tracked(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    E.StreamEngine = C.StreamEngine = Tracked
    try:
        yield built
    finally:
        E.StreamEngine = C.StreamEngine = base


def run_cli(torch, dev, argv, want=()) -> tuple:
    """``afp_tpu_torch.cli.main(argv)`` in this process: checks it returned
    0 and, on the card, that each kernel in `want` launched; returns (the
    stream's JSON metrics line or None, the engines it built, its wall in
    seconds on the host clock, ending in a synchronize)."""
    from afp_tpu_torch.cli import main
    from afp_tpu_torch.ops.cuda import KERNELS

    before = counts(KERNELS)
    out = io.StringIO()
    with tracked_engines() as engines, contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = main([str(a) for a in argv])
        sync(torch, dev)
        wall = time.perf_counter() - t0
    check(rc == 0, f"cli {argv[0]}: exit code {rc}")
    if dev.type == "cuda":
        delta = {k: v - before[k] for k, v in counts(KERNELS).items()}
        check(all(delta[k] > 0 for k in want),
              f"cli {' '.join(map(str, argv))} did not launch all of {want}: {delta}")
    text = out.getvalue().strip()
    snap = json.loads(text.splitlines()[-1]) if argv[0] == "stream" else None
    return snap, engines, wall, text


def check_ladder(what: str, engines, handed: int, lockstep: bool) -> None:
    """No degradation-ladder event in a run that injected no fault: every
    block the engine was handed was processed (`record_block` runs only on
    success), no replay and no design fallback; in lockstep no underrun and
    no silence either."""
    for eng in engines:
        m = eng.metrics
        check(m.blocks_processed == handed and m.fallback_replays == 0
              and m.design_fallbacks == 0,
              f"{what}: {m.blocks_processed} of {handed} blocks processed, "
              f"{m.fallback_replays} replays, {m.design_fallbacks} design fallbacks")
        if lockstep:
            check(m.underruns == 0 and m.fallback_silence == 0,
                  f"{what}: {m.underruns} underruns, {m.fallback_silence} silent")


def phase_cli(torch, dev, sz: Sizes) -> None:
    """`python -m afp_tpu_torch` (in-process `cli.main`) on the card at the
    sizes a user of the CLI runs: `process` of a 60 s stereo 24-bit file at
    the defaults ('fft', K2), of a 60 s 16-bit file with int16 in and out
    (the fold, K8) and with the linked AGC (K5 → K6, K2), each against the
    float64 oracle over its first blocks; `batch` of 32 stereo 30 s 16-bit
    files in one fold dispatch (the C5 filter) ≡ `process` of each file,
    bit for bit; `stream --lockstep` with the linked AGC ≡ its `process`,
    and stopped at half with a checkpoint and resumed ≡ uninterrupted, bit
    for bit, dither on; a paced stream; `--fault-drop 50`; `devices`."""
    from afp_tpu_torch.utils import (read_wav, read_wav_pcm16, write_wav,
                                     write_wav_pcm16)

    if dev.type == "cuda":
        os.environ.pop("AFP_FORCE_CPU", None)
    else:
        os.environ["AFP_FORCE_CPU"] = "1"
    shutil.rmtree(SMOKE_CLI, ignore_errors=True)
    SMOKE_CLI.mkdir(parents=True)
    d = SMOKE_CLI
    rng = np.random.default_rng(150)
    n = int(sz.cli_seconds * CLI_RATE)
    nb = -(-n // CLI_BLOCK)
    x24 = np.clip(0.3 * rng.standard_normal((2, n)), -1, 1).astype(np.float32)
    x24[:, n // 3: n // 2] *= 0.05  # a quiet passage for the AGC to lift
    write_wav(str(d / "in24.wav"), x24, CLI_RATE, width=3)
    x24 = read_wav(str(d / "in24.wav"))[0]  # the 24-bit grid the CLI reads
    q = np.clip(np.round(rng.standard_normal((2, n)) * 0.3 * 32768),
                -32768, 32767).astype(np.int16)
    write_wav_pcm16(str(d / "in16.wav"), q, CLI_RATE)
    n_or = min(n, sz.oracle_blocks * CLI_BLOCK)
    io16 = ["--ingest", "pcm16", "--emit", "pcm16"]
    agc = ["--agc", "--agc-link"]

    # ---- process: defaults, int16 in and out, the linked AGC
    walls, outs = {}, {}
    for name, src, flags, want in (
            ("defaults", "in24.wav", [], ("dither_cuda",)),
            ("pcm16", "in16.wav", [*io16, "--dither", "off"], ("fir_td_mxu_pair",)),
            ("agc", "in24.wav", agc, ("rms_desired", "smooth_gain_apply",
                                      "dither_cuda"))):
        dst = d / f"process_{name}.wav"
        _, engines, walls[name], _ = run_cli(torch, dev, ["process", d / src, dst,
                                                          *flags], want)
        eng = engines[0]
        check_ladder(f"process {name}", engines, 1, lockstep=True)
        check(eng.metrics.samples_processed == nb * CLI_BLOCK,
              f"process {name}: {eng.metrics.samples_processed} samples")
        if name == "pcm16":
            y = read_wav_pcm16(str(dst))[0]
            ref = quantized(cli_oracle(q[:, :n_or] / 32768.0, eng.cfg, eng.design))
            lsb, nd = lsb_diff(y[:, :n_or], ref)
            check(y.shape == q.shape and lsb <= 1,
                  f"process pcm16: {lsb} LSB from the quantized oracle")
            acc = f"{lsb} LSB from the quantized oracle ({nd} samples differ)"
        else:
            y = read_wav(str(dst))[0]
            e = err_db(y[:, :n_or], cli_oracle(x24[:, :n_or], eng.cfg, eng.design))
            check(y.shape == x24.shape and np.all(np.isfinite(y)) and e < ORACLE_DB,
                  f"process {name}: {e:.1f} dB vs the oracle")
            acc = f"{e:.1f} dB vs the oracle"
        outs[name] = y
        say(f"phase 8 process {name} ({' '.join(flags) or 'CLI defaults'}): 2 x {n} "
            f"samples ({sz.cli_seconds:g} s stereo), {acc} over the first "
            f"{n_or} samples; {walls[name]:.2f} s wall (host clock, WAV read and "
            f"write included), engine busy {eng.metrics.busy_seconds:.3f} s")

    # ---- batch: the C5 filter over 32 stereo files in one fold dispatch
    nbt = int(sz.batch_seconds * CLI_RATE)
    srcs = []
    for i in range(sz.batch_files):
        qi = np.clip(np.round(rng.standard_normal((2, nbt)) * 0.2 * 32768),
                     -32768, 32767).astype(np.int16)
        srcs.append(d / f"b{i:02d}.wav")
        write_wav_pcm16(str(srcs[-1]), qi, CLI_RATE)
    c5 = ["--upsample", 4, "--numtaps", 1001, "--cutoff", 11000, *io16,
          "--dither", "off"]
    _, engines, wall, _ = run_cli(torch, dev, ["batch", *srcs, "-o", d / "batch_out",
                                               *c5], ("fir_td_mxu_pair",))
    check(len(engines) == 1, f"batch: {len(engines)} dispatches, not one")
    check_ladder("batch", engines, 1, lockstep=True)
    busy = engines[0].metrics.busy_seconds
    rows = 2 * sz.batch_files
    for src in srcs:
        one = d / "one.wav"
        run_cli(torch, dev, ["process", src, one, *c5], ("fir_td_mxu_pair",))
        check(np.array_equal(read_wav_pcm16(str(d / "batch_out" / src.name))[0],
                             read_wav_pcm16(str(one))[0]),
              f"batch: {src.name} differs from process of the file alone")
    audio = rows * sz.batch_seconds
    say(f"phase 8 batch {sz.batch_files} stereo files x {sz.batch_seconds:g} s "
        f"({rows} rows x {nbt} samples, one fold dispatch; --upsample 4 --numtaps "
        f"1001 --cutoff 11000, int16 in and out): each file == process of it alone, "
        f"bit for bit, dither off; {wall:.2f} s wall, {audio / wall:.0f}x realtime "
        f"({rows} channels x {sz.batch_seconds:g} s / wall, host clock, WAV I/O "
        f"included), engine busy {busy:.3f} s ({audio / busy:.0f}x)")

    # ---- stream --lockstep with the linked AGC ≡ process, and resumed
    def stream(*argv, lockstep=True, want=("rms_desired", "smooth_gain_apply")):
        return run_cli(torch, dev, ["stream", d / "in24.wav", *agc, *argv,
                                    *(["--lockstep"] if lockstep else [])], want)

    snap, engines, wall, _ = stream("-o", d / "stream.wav")
    check_ladder("stream --lockstep", engines, nb, lockstep=True)
    full = read_wav(str(d / "stream.wav"))[0]
    check(np.array_equal(full, outs["agc"]),
          "stream --lockstep differs from process --agc --agc-link")
    say(f"phase 8 stream --lockstep --agc --agc-link: {snap['blocks']} blocks of "
        f"{CLI_BLOCK} == process bit for bit, dither on; {wall:.2f} s wall "
        f"({snap['blocks'] * CLI_BLOCK / CLI_RATE / wall:.0f}x realtime), "
        f"in ring {snap['in_ring']}, out ring {snap['out_ring']}")
    half = nb // 2
    ck = d / "ck.npz"
    _, e1, _, _ = stream("-o", d / "h1.wav", "--blocks", half, "--checkpoint-out", ck)
    _, e2, _, _ = run_cli(torch, dev, ["stream", d / "in24.wav", "-o", d / "h2.wav",
                                       "--skip-blocks", half, "--resume", ck,
                                       "--lockstep"],
                          ("rms_desired", "smooth_gain_apply"))
    check_ladder("stream, first half", e1, half, lockstep=True)
    check_ladder("stream, resumed", e2, nb - half, lockstep=True)
    joined = np.concatenate([read_wav(str(d / "h1.wav"))[0],
                             read_wav(str(d / "h2.wav"))[0]], axis=1)
    check(np.array_equal(joined, full),
          "checkpoint + resume differs from the uninterrupted stream")
    say(f"phase 8 stream {half} blocks + checkpoint, then --resume --skip-blocks "
        f"{half}: joined == uninterrupted, bit for bit, dither on")

    # ---- paced at the true block rate
    snap, engines, wall, _ = stream("--seconds", sz.paced_seconds, lockstep=False)
    m, ring = engines[0].metrics, snap["in_ring"]
    # realtime: each pop of the input ring hands the engine a block, and a
    # pop that times out hands it silence (`stream_process_AGC.py:111-115`)
    check(m.fallback_replays == 0 and m.design_fallbacks == 0
          and m.blocks_processed == ring["pops"] + ring["underruns"],
          f"paced stream: ladder events {snap}")
    share = m.busy_seconds / max(m.blocks_processed * CLI_BLOCK / CLI_RATE, 1e-12)
    say(f"phase 8 stream paced {sz.paced_seconds:g} s ({snap['blocks']} blocks of "
        f"{CLI_BLOCK / CLI_RATE * 1e3:.1f} ms): {wall:.2f} s wall; underruns "
        f"{snap['underruns']}, overruns {snap['overruns']} (pacer "
        f"{snap.get('pacer_overruns')}), drops {snap['drops']}; engine busy share "
        f"{share:.4f} of the block time ({m.blocks_processed} blocks processed)")

    # ---- --fault-drop 50: the counters equal the injected count
    snap, engines, _, _ = stream("--fault-drop", 50)
    dropped = nb // 50
    m = engines[0].metrics
    check(snap["blocks"] == nb - dropped and snap["in_ring"]["pushes"] == nb - dropped
          and snap["out_ring"]["pops"] == nb - dropped and m.fallback_replays == 0
          and m.underruns == 0, f"--fault-drop 50: {snap} for {dropped} drops")
    say(f"phase 8 stream --lockstep --fault-drop 50: {dropped} blocks dropped of "
        f"{nb}; {snap['blocks']} processed, ring pushes {snap['in_ring']['pushes']}: "
        f"as injected")

    # ---- devices
    _, _, _, text = run_cli(torch, dev, ["devices"])
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    check(name in text, f"devices does not list {name}: {text!r}")
    say(f"phase 8 devices: {text.splitlines()[0]}")
    shutil.rmtree(SMOKE_CLI, ignore_errors=True)


# ---------------------------------------------------------------- phase 9

#: phase 9's CLI files: 48 kHz sources for the ASRC (the everyday case of a
#: 48 kHz recording into the 44.1 kHz engine), 44.1 kHz for upsampled output
SOURCE_RATE = 48000
SMOKE_MULTI = Path(__file__).resolve().parent / "build" / "smoke_multirate"


def row_err_db(torch, a, b):
    """Per-row max-abs relative error (dB) of two [B, N] tensors."""
    a, b = a.double(), b.double()
    return 20 * torch.log10((a - b).abs().amax(1) / b.abs().amax(1).clamp_min(1e-300)
                            + 1e-300)


def timed(torch, dev, fn):
    """(fn's result, its wall in seconds on the host clock ending in a
    synchronize, the peak device memory in GiB it allocated)."""
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0
    return out, wall, peak


def phase_multirate_chain(torch, dev, sz: Sizes) -> None:
    """9a: the literal multirate chain at the C5 headline filter (4× 'vhq',
    1001 taps at 11 kHz, decimate, ``fuse_rate_conversion=False``, 'fft'):
    the up resampler, overlap-save at 176.4 kHz (up-block 16 384, nfft
    32 768), decimate.  ≡ the fused K1 chain within −90 dB on every row,
    < −90 dB against the float64 oracle on 2 rows; ``output_rate=
    'upsampled'`` gives [B, 4·L] per block and its decimation ≡ the base
    literal output bit for bit; walls, ×realtime and peak memory, the
    upsampled run with TPDF dither (K2 over [B, 4·L])."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams

    B, L, nb = sz.batch, sz.block, sz.multi_blocks
    g = torch.Generator(device=dev).manual_seed(90)
    x = torch.randn(B, nb * L, generator=g, device=dev) * 0.3
    audio_s = B * nb * L / HEADLINE["samplerate"]

    def build(**over):
        pipe = Pipeline(c5_config(sz, **over), dev)
        return pipe, pipe.device_params(PipelineParams.design(pipe.cfg))

    def run(pipe, params, sig):
        return pipe.process_signal(params, pipe.init_state(), sig, fold=False)[1]

    lit_pipe, lit_params = build(fuse_rate_conversion=False, conv_strategy="fft",
                                 dither_kind="off")
    check(not lit_pipe.fused and lit_pipe.up_block == 4 * L
          and lit_pipe.nfft == 1 << (4 * L + lit_pipe.n_fused - 2).bit_length(),
          f"literal chain: nfft {lit_pipe.nfft}, up-block {lit_pipe.up_block}")
    run(lit_pipe, lit_params, x[:, :L])  # warm-up: the cuFFT plans
    lit, wall, peak = timed(torch, dev, lambda: run(lit_pipe, lit_params, x))
    f_pipe, f_params = build(dither_kind="off")
    fused = run(f_pipe, f_params, x)
    rows = row_err_db(torch, lit, fused)
    worst = float(rows.max())
    check(lit.shape == x.shape and bool(torch.isfinite(lit).all()) and worst < ORACLE_DB,
          f"literal chain vs fused K1 chain: worst row {worst:.1f} dB")
    design = PipelineParams.design(lit_pipe.cfg)
    x2 = x[:2].cpu().numpy()
    e_or = err_db(lit[:2].cpu().numpy(), c5_oracle(x2, lit_pipe.cfg, design))
    check(e_or < ORACLE_DB, f"literal chain oracle: {e_or:.1f} dB")
    say(f"phase 9a literal chain (C5 filter, 4x vhq, fft, nfft {lit_pipe.nfft}) batch "
        f"{B} x {nb} blocks of {L}: == fused K1 chain, worst row {worst:.1f} dB (< "
        f"{ORACLE_DB}, dither off); {e_or:.1f} dB vs the float64 oracle on 2 rows; "
        f"{wall * 1e3:.1f} ms wall ({wall * 1e3 / nb:.2f} ms/block, "
        f"{audio_s / wall:.0f}x realtime, host clock), peak {peak:.2f} GiB")
    del fused, f_pipe, f_params

    up_pipe, up_params = build(output_rate="upsampled", conv_strategy="fft",
                               dither_kind="off")
    up = run(up_pipe, up_params, x)
    check(up.shape == (B, 4 * nb * L) and up_pipe.out_block == 4 * L,
          f"upsampled output shape {tuple(up.shape)}")
    check(torch.equal(up[:, ::4], lit), "decimated upsampled output differs from "
          "the base literal output")
    del up, lit
    up_pipe, up_params = build(output_rate="upsampled", conv_strategy="fft")
    run(up_pipe, up_params, x[:, :L])
    up, wall_u, peak_u = timed(torch, dev, lambda: run(up_pipe, up_params, x))
    check(bool(torch.isfinite(up).all()), "upsampled output with dither: not finite")
    say(f"phase 9a output_rate='upsampled': [{B}, {4 * L}] per block; decimate == "
        f"the base literal output, bit for bit; with TPDF dither (K2 over [{B}, "
        f"{4 * L}]) {wall_u * 1e3:.1f} ms wall ({wall_u * 1e3 / nb:.2f} ms/block, "
        f"{audio_s / wall_u:.0f}x realtime), peak {peak_u:.2f} GiB")


def phase_multirate_asrc(torch, dev, sz: Sizes) -> None:
    """9b: compat ASRC on the card.  C8 (AGC 'exact', 'td_mxu', block 2048)
    from 48 kHz sources at batch 64 (32 stereo streams), the stateless
    submode: resample_poly per block, then K5 → K6 → K8; and C5 'td_mxu'
    from 88.2 kHz at batch 4096, the streaming submode into K1.  Each ≡
    the port's CPU run of its first rows (≤ −100 dB, dither off), [B, L]
    out."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams

    cpu = torch.device("cpu")
    for name, cfg, nb, seed in (
            ("C8 from 48 kHz", c8_config(sz, batch=sz.asrc_batch,
                                         source_samplerate=48000,
                                         asrc_mode="compat", dither_kind="off"), 3, 91),
            ("C5 from 88.2 kHz", c5_config(sz, source_samplerate=88200,
                                           asrc_mode="compat", dither_kind="off"), 2, 92)):
        B, L = cfg.batch, cfg.blocksize
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal((nb, B, L)) * 0.1).astype(np.float32)
        pipe = Pipeline(cfg, dev)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        stateless = pipe._asrc_stateless
        xd = torch.from_numpy(x).to(dev)
        pipe.run(params, pipe.init_state(), xd[:1])
        (_, out), wall, peak = timed(torch, dev,
                                     lambda: pipe.run(params, pipe.init_state(), xd))
        cp = Pipeline(replace(cfg, batch=sz.cpu_rows), cpu)
        _, ref = cp.run(cp.device_params(PipelineParams.design(cp.cfg)),
                        cp.init_state(), x[:, :sz.cpu_rows])
        e = err_db(out[:, :sz.cpu_rows].cpu().numpy(), ref.numpy())
        check(out.shape == (nb, B, L) and bool(torch.isfinite(out).all())
              and e <= CHAIN_DB, f"compat ASRC {name}: {tuple(out.shape)}, {e:.1f} dB")
        audio_s = nb * B * L / cfg.samplerate
        say(f"phase 9b compat ASRC {name} ({'stateless' if stateless else 'streaming'}"
            f" submode) batch {B} x {nb} blocks of {L}: [{B}, {L}] out, card vs the "
            f"port's CPU run of {sz.cpu_rows} rows {e:.1f} dB (<= {CHAIN_DB}); "
            f"{wall * 1e3:.1f} ms wall ({wall * 1e3 / nb:.2f} ms/block, "
            f"{audio_s / wall:.0f}x realtime), peak {peak:.2f} GiB")


def check_asrc_stream(what: str, engines, captured: int) -> None:
    """A lockstep ASRC stream fabricates nothing: every engine block came
    from converted audio (the capture is whole blocks), with no underrun,
    silence, replay, drop or design fallback."""
    for eng in engines:
        m = eng.metrics
        check(m.underruns == 0 and m.fallback_silence == 0 and m.fallback_replays == 0
              and m.drops == 0 and m.design_fallbacks == 0,
              f"{what}: ladder events {m.snapshot()}")
    blocks = sum(e.metrics.blocks_processed for e in engines)
    check(captured == blocks * CLI_BLOCK, f"{what}: {captured} samples captured for "
          f"{blocks} blocks")


def phase_multirate_cli(torch, dev, sz: Sizes) -> None:
    """9c and 9d: the CLI and the stream with the multirate flags, on stereo
    24-bit WAVs.  `process --samplerate 44100` of a 60 s 48 kHz file (the
    exact frontend, 'fft', K2), again with ``--agc --agc-link`` (K5 → K6):
    ceil(n·44100/48000) samples, < −90 dB against the float64 oracle (the
    causal resampler in float64, then the chain); `process --output-rate
    upsampled` of a 60 s 44.1 kHz file: twice the samples at 88.2 kHz,
    against its oracle; `batch` of 32 × 30 s 48 kHz files with
    ``--samplerate 44100`` ≡ `process` of a file alone, bit for bit, on
    `batch_checked` files drawn from the seed (dither off: the fold keys its
    noise by the folded row); `stream --lockstep -o --samplerate 44100`
    (the linked AGC, dither on) ≡ its
    `process`, and stopped at half with the frontend holding data, then
    resumed ≡ uninterrupted, bit for bit."""
    import scipy.signal as sps

    from afp_tpu_torch.ops.resample import streaming_kernel
    from afp_tpu_torch.utils import read_wav, write_wav

    if dev.type == "cuda":
        os.environ.pop("AFP_FORCE_CPU", None)
    else:
        os.environ["AFP_FORCE_CPU"] = "1"
    shutil.rmtree(SMOKE_MULTI, ignore_errors=True)
    SMOKE_MULTI.mkdir(parents=True)
    d = SMOKE_MULTI
    rng = np.random.default_rng(160)
    n48 = int(sz.cli_seconds * SOURCE_RATE)
    x48 = np.clip(0.3 * rng.standard_normal((2, n48)), -1, 1).astype(np.float32)
    x48[:, n48 // 3: n48 // 2] *= 0.05  # a quiet passage for the AGC to lift
    write_wav(str(d / "in48.wav"), x48, SOURCE_RATE, width=3)
    x48 = read_wav(str(d / "in48.wav"))[0]
    n44 = int(sz.cli_seconds * CLI_RATE)
    x44 = np.clip(0.3 * rng.standard_normal((2, n44)), -1, 1).astype(np.float32)
    write_wav(str(d / "in44.wav"), x44, CLI_RATE, width=3)
    x44 = read_wav(str(d / "in44.wav"))[0]
    sr = ["--samplerate", CLI_RATE]
    agc = ["--agc", "--agc-link"]
    n_out = -(-n48 * CLI_RATE // SOURCE_RATE)
    n_or = min(n_out, sz.oracle_blocks * CLI_BLOCK)

    # ---- process --samplerate 44100: the defaults and the linked AGC
    outs = {}
    for name, flags, want in (
            ("samplerate", sr, ("dither_cuda",)),
            ("samplerate-agc", [*sr, *agc], ("rms_desired", "smooth_gain_apply",
                                             "dither_cuda"))):
        dst = d / f"{name}.wav"
        _, engines, wall, _ = run_cli(torch, dev, ["process", d / "in48.wav", dst,
                                                   *flags], want)
        eng = engines[0]
        check_ladder(f"process {name}", engines, 1, lockstep=True)
        y, rate = read_wav(str(dst))
        # the oracle: the causal streaming resampler in float64 (the
        # frontend's output from its first sample), then the chain
        h = streaming_kernel(CLI_RATE, SOURCE_RATE, quality=eng.cfg.resample_quality)
        n_src = (n_or + 64) * SOURCE_RATE // CLI_RATE + len(h)
        z = np.stack([sps.upfirdn(h, r[:n_src].astype(np.float64), CLI_RATE // 300,
                                  SOURCE_RATE // 300)[:n_or] for r in x48])
        e = err_db(y[:, :n_or], np.clip(cli_oracle(z, eng.cfg, eng.design), -1.0, 1.0))
        check(rate == CLI_RATE and y.shape == (2, n_out) and np.all(np.isfinite(y))
              and e < ORACLE_DB, f"process {name}: {y.shape} at {rate} Hz, {e:.1f} dB")
        outs[name] = y
        say(f"phase 9c process {' '.join(map(str, flags))} of a {sz.cli_seconds:g} s "
            f"stereo 48 kHz file: {n_out} samples at {rate} Hz (ceil(n*44100/48000)); "
            f"{e:.1f} dB vs the float64 oracle over the first {n_or} samples; "
            f"{wall:.2f} s wall (host clock, WAV I/O included), engine busy "
            f"{eng.metrics.busy_seconds:.3f} s")

    # ---- process --output-rate upsampled at the CLI defaults
    dst = d / "upsampled.wav"
    _, engines, wall, _ = run_cli(torch, dev, ["process", d / "in44.wav", dst,
                                               "--output-rate", "upsampled"],
                                  ("dither_cuda",))
    eng = engines[0]
    check_ladder("process --output-rate upsampled", engines, 1, lockstep=True)
    y, rate = read_wav(str(dst))
    n_up = min(n44, sz.oracle_blocks * CLI_BLOCK)
    # no output clip at the defaults: the 24-bit WAV's range clips overshoot
    gold = np.clip(cli_oracle(x44[:, :n_up], eng.cfg, eng.design), -1.0, 1.0)
    e = err_db(y[:, :2 * n_up], gold)
    check(rate == 2 * CLI_RATE and y.shape == (2, 2 * n44) and e < ORACLE_DB,
          f"process --output-rate upsampled: {y.shape} at {rate} Hz, {e:.1f} dB")
    say(f"phase 9c process --output-rate upsampled of a {sz.cli_seconds:g} s stereo "
        f"44.1 kHz file: {y.shape[1]} samples at {rate} Hz; {e:.1f} dB vs the float64 "
        f"oracle over the first {2 * n_up} samples; {wall:.2f} s wall, engine busy "
        f"{eng.metrics.busy_seconds:.3f} s")

    # ---- batch of 32 stereo 30 s 48 kHz files with --samplerate 44100
    nbt = int(sz.batch_seconds * SOURCE_RATE)
    srcs = []
    for i in range(sz.batch_files):
        xi = np.clip(0.2 * rng.standard_normal((2, nbt)), -1, 1).astype(np.float32)
        srcs.append(d / f"b{i:02d}.wav")
        write_wav(str(srcs[-1]), xi, SOURCE_RATE, width=3)
    # dither off: the fold keys its noise by the row of the folded batch
    bflags = [*sr, "--dither", "off"]
    _, engines, wall, _ = run_cli(torch, dev, ["batch", *srcs, "-o", d / "batch_out",
                                               *bflags], ())
    check(len(engines) == 1, f"batch: {len(engines)} dispatches, not one")
    check_ladder("batch --samplerate", engines, 1, lockstep=True)
    busy = engines[0].metrics.busy_seconds
    rows = 2 * sz.batch_files
    n_b = -(-nbt * CLI_RATE // SOURCE_RATE)
    picked = sorted(rng.choice(sz.batch_files, sz.batch_checked, replace=False))
    for src in [srcs[i] for i in picked]:
        one = d / "one.wav"
        run_cli(torch, dev, ["process", src, one, *bflags])
        got = read_wav(str(d / "batch_out" / src.name))[0]
        check(got.shape == (2, n_b) and np.array_equal(got, read_wav(str(one))[0]),
              f"batch --samplerate: {src.name} differs from process of the file alone")
    audio = rows * sz.batch_seconds
    say(f"phase 9c batch {sz.batch_files} stereo files x {sz.batch_seconds:g} s at "
        f"48 kHz --samplerate 44100 ({rows} rows, one dispatch): files "
        f"{[int(i) for i in picked]} == process of each alone, bit for bit (dither "
        f"off); {wall:.2f} s wall, "
        f"{audio / wall:.0f}x realtime (WAV I/O included), engine busy {busy:.3f} s "
        f"({audio / busy:.0f}x)")

    # ---- stream --lockstep with the ASRC ≡ process, and resumed
    def stream(*argv):
        return run_cli(torch, dev, ["stream", d / "in48.wav", *sr, *agc, "--lockstep",
                                    *argv], ("rms_desired", "smooth_gain_apply"))

    snap, engines, wall, _ = stream("-o", d / "stream.wav")
    full = read_wav(str(d / "stream.wav"))[0]
    check_asrc_stream("stream --lockstep --samplerate", engines, full.shape[1])
    ref = outs["samplerate-agc"]
    check(0 < full.shape[1] <= ref.shape[1]
          and np.array_equal(full, ref[:, :full.shape[1]]),
          "stream --lockstep --samplerate differs from process")
    nb_src = -(-n48 // CLI_BLOCK)
    say(f"phase 9d stream --lockstep --samplerate 44100 --agc --agc-link: {nb_src} "
        f"source blocks -> {snap['blocks']} engine blocks == process bit for bit, "
        f"dither on, nothing fabricated; {wall:.2f} s wall "
        f"({n48 / SOURCE_RATE / wall:.0f}x realtime)")
    half = nb_src // 2 + 1  # odd: the frontend holds a residual super-block
    ck = d / "ck.npz"
    _, e1, _, _ = stream("-o", d / "h1.wav", "--blocks", half, "--checkpoint-out", ck)
    with np.load(ck) as z:
        held = (z["asrc_in"].shape[1], z["asrc_out"].shape[1])
    check(held[0] > 0 and held[1] > 0, f"checkpoint: the frontend holds {held}")
    _, e2, _, _ = run_cli(torch, dev, ["stream", d / "in48.wav", "-o", d / "h2.wav",
                                       "--skip-blocks", half, "--resume", ck,
                                       "--lockstep"],
                          ("rms_desired", "smooth_gain_apply"))
    h1, h2 = read_wav(str(d / "h1.wav"))[0], read_wav(str(d / "h2.wav"))[0]
    check_asrc_stream("stream, first half", e1, h1.shape[1])
    check_asrc_stream("stream, resumed", e2, h2.shape[1])
    joined = np.concatenate([h1, h2], axis=1)
    check(np.array_equal(joined, full),
          "checkpoint + resume under the ASRC differs from the uninterrupted stream")
    say(f"phase 9d stream {half} source blocks + checkpoint (the frontend holding "
        f"{held[0]} source and {held[1]} converted samples), then --resume "
        f"--skip-blocks {half}: joined == uninterrupted, bit for bit, dither on")
    shutil.rmtree(SMOKE_MULTI, ignore_errors=True)


def phase_parallel_agc(torch, dev, sz: Sizes) -> None:
    """9e: ``agc_mode='parallel'`` on C8 at batch 4096 × 2048: K5's
    batch-major desired gain, the associative-scan solver (torch ops), the
    apply and K1.  Its gained block ≡ the exact mode's (K5 → K6, f32 store)
    within −105 dB, the reference's bar for the recurrence's consistency
    oracle; the chain's output ≡ the exact chain's within the AGC chain's
    −100 dB (the bf16×3 conv splits two slightly different inputs); dither
    off; its solve count and wall."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.agc import _smooth_gain_parallel
    from afp_tpu_torch.ops.cuda.agc_rms import rms_desired

    g = torch.Generator(device=dev).manual_seed(93)
    blocks = torch.randn(2, sz.c8_batch, sz.c8_block, generator=g, device=dev) * 0.1
    blocks[:, ::7] *= 0.02  # quiet streams: the gain rises to its clip
    outs, walls, gained = {}, {}, {}
    ones = torch.ones(sz.c8_batch, device=dev)
    for mode in ("parallel", "exact"):
        pipe = Pipeline(c8_config(sz, agc_mode=mode, dither_kind="off"), dev)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        pipe.run(params, pipe.init_state(), blocks[:1])
        (_, outs[mode]), walls[mode], _ = timed(
            torch, dev, lambda: pipe.run(params, pipe.init_state(), blocks))
        check(bool(torch.isfinite(outs[mode]).all()), f"C8 {mode}: not finite")
        gained[mode] = pipe._agc(params, blocks[0], ones, emit_split=False)[0]
        if mode == "parallel":
            lp, rp = pipe._rms_pad
            dd = rms_desired(blocks[0], pipe._rms_band, lp, rp, params.agc_target,
                             params.agc_max_gain, exact_band=pipe._rms_exact)
            gp, iters, flips = _smooth_gain_parallel(
                dd, params.agc_a_att, params.agc_a_rel, init=ones)
            gap = (dd - torch.cat([ones[:, None], gp[:, :-1]], 1))[flips].abs()
            n_flip = int(flips.sum())
            flip_rows = sorted(set(flips.nonzero()[:, 0].tolist()))
            at_clip = bool((dd[flips] == params.agc_max_gain).all())
    e_agc = err_db(gained["parallel"].cpu().numpy(), gained["exact"].cpu().numpy())
    e_out = err_db(outs["parallel"].cpu().numpy(), outs["exact"].cpu().numpy())
    check(e_agc < -105.0 and e_out <= CHAIN_DB,
          f"parallel vs exact: gained block {e_agc:.1f} dB, chain {e_out:.1f} dB")
    say(f"phase 9e C8 agc_mode='parallel' batch {sz.c8_batch} x 2 blocks of "
        f"{sz.c8_block}: gained block {e_agc:.1f} dB vs exact mode (< -105), chain "
        f"output {e_out:.1f} dB (<= {CHAIN_DB}), dither off; {iters} solves on block "
        f"0, {n_flip} decisions still flipping at the last, in {len(flip_rows)} "
        f"streams (all quiet ones, every 7th: "
        f"{all(r % 7 == 0 for r in flip_rows)}), d there at max_gain: {at_clip}, "
        f"|d - g[t-1]| <= {float(gap.max()) if n_flip else 0.0:.3g}; "
        f"{walls['parallel'] * 1e3:.1f} ms wall for 2 blocks (exact "
        f"{walls['exact'] * 1e3:.1f} ms)")


# ---------------------------------------------------------------- phase 10


SMOKE_OBSERVE = Path(__file__).resolve().parent / "build" / "smoke_observe"
#: the controller's and the examples' tone (Hz), and the tap's cadence
TONE_HZ, TAP_EVERY = 1000.0, 8
#: spectra of one output through two FFT libraries (cuFFT on the card,
#: numpy on the host), as magnitudes relative to the row maximum
SPECTRUM_DB = -100.0


def rel_mag_db(a_db, b_db) -> float:
    """Worst row of max |10^(a/20) − 10^(b/20)| over the row's maximum
    magnitude of `b`, in dB (spectra compared as magnitudes, never as raw
    dB near the −200 floor)."""
    ma = 10.0 ** (np.asarray(a_db, np.float64) / 20.0)
    mb = 10.0 ** (np.asarray(b_db, np.float64) / 20.0)
    err = np.abs(ma - mb).max(axis=-1) / mb.max(axis=-1)
    return float(20 * np.log10(err.max() + 1e-300))


def matplotlib_line() -> bool:
    """Whether matplotlib imports here (the plots need it; every array they
    draw is checked either way), said on a line of its own."""
    from afp_tpu_torch.viz import matplotlib_available

    ok = matplotlib_available()
    say("phase 10 matplotlib: " + ("installed, PNGs rendered" if ok else
                                   "not installed: no PNG rendered, the "
                                   "plotted arrays still checked"))
    return ok


def phase_observe_waterfall(torch, dev, sz: Sizes) -> None:
    """10a: the carried waterfall at the C5 headline, uncut ('td_mxu',
    TPDF; K1): over `run_blocks` blocks each pushed row ≡ `spectrum_db` of
    the block emitted, bit for bit, the rows never pushed exactly −200, and
    the audio ≡ the chain without the waterfall, bit for bit, dither on;
    the same under ``emit='pcm16'`` (the row of the dequantized block);
    ms per block with and without the ring, and the peak memory; the
    push's and the spectrum's device ms (CUDA events) beside the push's
    bound (the ring read and written once at the card's memory rate)."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.spectrum import (WATERFALL_DEPTH, spectrum_db,
                                            waterfall_push)

    nb = sz.run_blocks
    g = torch.Generator(device=dev).manual_seed(100)
    blocks = torch.randn(nb, sz.batch, sz.block, generator=g, device=dev) * 0.3
    walls = {}
    for emit in ("f32", "pcm16"):
        on = Pipeline(c5_config(sz, waterfall_enabled=True, emit=emit), dev)
        off = Pipeline(c5_config(sz, emit=emit), dev)
        params = on.device_params(PipelineParams.design(on.cfg))
        st_on, st_off = on.init_state(seed=7), off.init_state(seed=7)
        for i, blk in enumerate(blocks):
            st_on, y = on.step(params, st_on, blk)
            st_off, y_off = off.step(params, st_off, blk)
            f = y.to(torch.float32) / 32768.0 if y.dtype == torch.int16 else y
            check(torch.equal(y, y_off), f"10a {emit}: block {i} with the "
                  "waterfall differs from the chain without it")
            check(torch.equal(st_on.wf[:, -1], spectrum_db(f)),
                  f"10a {emit}: row of block {i} is not spectrum_db of the output")
        n_bins = sz.block // 2 + 1
        check(st_on.wf.shape == (sz.batch, WATERFALL_DEPTH, n_bins)
              and bool((st_on.wf[:, :WATERFALL_DEPTH - nb] == -200.0).all())
              and bool(torch.isfinite(st_on.wf).all()),
              f"10a {emit}: ring shape, priming or finiteness")
        if emit == "f32":
            ring, window = st_on.wf, on._wf_window
            push_ms = time_ms(torch, lambda: waterfall_push(ring, f[:, :n_bins]), 10)
            spec_ms = time_ms(torch, lambda: spectrum_db(f, window), 10)
            del ring
            for name, pipe in (("off", off), ("on", on)):
                run_wall(torch, dev, pipe, params, blocks)  # warm the allocator
                (_, wall), _, peak = timed(
                    torch, dev, lambda: run_wall(torch, dev, pipe, params, blocks))
                walls[name] = (wall, peak)
        del st_on, st_off, y, y_off, f
    ring_gb = sz.batch * WATERFALL_DEPTH * (sz.block // 2 + 1) * 4 / 1e9
    push_bound = 2 * ring_gb * 1e9 / HBM_BYTES * 1e3
    (w_off, p_off), (w_on, p_on) = walls["off"], walls["on"]
    say(f"phase 10a waterfall at the C5 headline, batch {sz.batch} x {nb} blocks "
        f"of {sz.block} (ring {ring_gb:.2f} GB): each row == spectrum_db of the "
        f"block emitted and the audio == the chain without it, bit for bit, "
        f"dither on, f32 and emit='pcm16'; {WATERFALL_DEPTH - nb} oldest rows "
        f"exactly -200; {w_on * 1e3 / nb:.3f} ms/block with it, "
        f"{w_off * 1e3 / nb:.3f} without (+{(w_on - w_off) * 1e3 / nb:.3f}; host "
        f"clock); peak {p_on:.2f} GiB with it, {p_off:.2f} without; device ms "
        f"(CUDA events): push {push_ms:.3f} (bound {push_bound:.3f}, bytes), "
        f"spectrum_db {spec_ms:.3f}")


def phase_observe_tap(torch, dev, sz: Sizes) -> None:
    """10b: `RingServer`'s drain-side tap at the C8 point (K5 → K6 → K7),
    every `TAP_EVERY` blocks: the served outputs ≡ a server without the
    tap, bit for bit, dither on; the newest tap rows ≡ `spectrum_db_np` of
    the drained row, bit for bit; the tap's host ms per tapped block."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.spectrum import spectrum_db_np
    from afp_tpu_torch.runtime import RingServer

    pipe = Pipeline(c8_config(sz), dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    g = torch.Generator(device=dev).manual_seed(101)
    src = (torch.randn(sz.serve_blocks, sz.c8_batch, sz.c8_block, generator=g,
                       device=dev) * 0.1).cpu().numpy()
    kw = dict(slots=sz.slots, chunk=sz.chunk, max_inflight=2, seed=0)
    gold, _ = serve_warm(pipe, params, src, sz)
    row = sz.c8_batch // 2
    srv = RingServer(pipe, params, **kw, spectrum_every=TAP_EVERY,
                     spectrum_row=row)
    tap, spent = srv._tap_spectrum, []

    def timed_tap(block):
        t0 = time.perf_counter()
        tap(block)
        spent.append(time.perf_counter() - t0)

    srv._tap_spectrum = timed_tap
    got = []
    stats = srv.serve(iter(src), got.append)
    got = np.stack(got)
    check(stats["blocks"] == sz.serve_blocks and np.array_equal(got, gold),
          "10b: the tapped server's outputs differ from the untapped server's")
    tapped = list(range(0, sz.serve_blocks, TAP_EVERY))
    want = np.stack([spectrum_db_np(got[i][row]) for i in tapped])
    ring = srv.waterfall_ring
    check(len(spent) == len(tapped)
          and np.array_equal(ring[-len(tapped):], want)
          and bool((ring[:-len(tapped)] == -200.0).all())
          and np.array_equal(srv.last_spectrum, want[-1]),
          "10b: the tap ring is not spectrum_db_np of the drained rows")
    say(f"phase 10b RingServer tap at C8 (batch {sz.c8_batch}, block {sz.c8_block}, "
        f"every {TAP_EVERY}): served == untapped server, bit for bit, dither on; "
        f"{len(tapped)} tap rows == spectrum_db_np of drained row {row}, bit for "
        f"bit; peak {srv.spectrum_peak[0]:.0f} Hz; tap "
        f"{np.mean(spent) * 1e3:.3f} ms host per tapped block; served "
        f"{stats['xrt']:.0f}x realtime (host clock)")


def phase_observe_controller(torch, dev, sz: Sizes) -> None:
    """10c: `EqualizerController` at the GUI defaults (`DEFAULT_CONFIG`:
    'fft', 9-band EQ, TPDF; cuFFT and K2) at batch `c8_batch`, a tone in
    every stream: a lockstep `start_stream` of 16 blocks with `set_gain`
    and a cutoff change through `apply_changes` mid-stream (glitch-free,
    True), the spectrum peak within one bin of the tone; then
    `start_ring_stream` over a 'td_mxu' `RingServer` (K3)."""
    from afp_tpu_torch.engine import Pipeline, StreamEngine
    from afp_tpu_torch.runtime import RingServer
    from afp_tpu_torch.ui import DEFAULT_CONFIG, EqualizerController

    cfg = replace(DEFAULT_CONFIG, batch=sz.c8_batch)
    check(cfg.conv_strategy == "fft" and cfg.eq_enabled
          and len(cfg.eq_bands) == 9 and cfg.dither_kind == "tpdf",
          f"DEFAULT_CONFIG is not the GUI's defaults: {cfg}")
    L, rate, n = cfg.blocksize, cfg.samplerate, 16
    tone = (0.3 * np.sin(2 * np.pi * TONE_HZ * np.arange(n * L) / rate)
            ).astype(np.float32)

    def block(i: int) -> np.ndarray:
        """Block i of the tone (cycling over n), in every stream."""
        j = i % n
        return np.ascontiguousarray(
            np.broadcast_to(tone[j * L:(j + 1) * L], (cfg.batch, L)))

    bin_hz = rate / L
    ctl = EqualizerController(StreamEngine(cfg, device=dev))
    ctl.show_spectrum = True
    eng = ctl.engine
    feed, fed = ctl.update_spectrum, []

    def timed_feed(out):
        t0 = time.perf_counter()
        feed(out)
        fed.append(time.perf_counter() - t0)

    ctl.update_spectrum = timed_feed  # the stream's sink, bound at start

    def wait_for(blocks: int, what: str) -> None:
        deadline = time.perf_counter() + 60
        while (eng.metrics.blocks_processed < blocks
               and time.perf_counter() < deadline):
            time.sleep(0.005)
        check(eng.metrics.blocks_processed >= blocks, f"10c: {what} stalled")

    t0 = time.perf_counter()
    ctl.start_stream(source=block)
    wait_for(n // 2, "start_stream")
    ctl.set_gain(8, 2.0)
    ctl.set_field(cutoff=12000.0)
    glitch_free = ctl.apply_changes()
    wait_for(n, "start_stream")
    ctl.stop_stream(timeout=30.0)
    wall = time.perf_counter() - t0
    m = eng.metrics
    f_peak, lvl = ctl.spectrum_peak
    check(glitch_free and eng.cfg.cutoff == 12000.0 and ctl.get_gains()[8] == 2.0,
          "10c: apply_changes was not a glitch-free swap")
    check(abs(f_peak - TONE_HZ) <= bin_hz and not ctl.streaming
          and m.fallback_replays == m.fallback_silence == 0
          and ctl.waterfall_ring is not None
          and bool((ctl.waterfall_ring[-1] > -200.0).all()),
          f"10c: peak {f_peak:.1f} Hz, metrics {m.snapshot()}")
    say(f"phase 10c controller at DEFAULT_CONFIG (fft, 9-band EQ, TPDF) batch "
        f"{cfg.batch}: lockstep start_stream of {m.blocks_processed} blocks with "
        f"set_gain and apply_changes(cutoff 12000) mid-stream, glitch-free; peak "
        f"{f_peak:.1f} Hz ({lvl:.1f} dB) within one bin ({bin_hz:.1f} Hz) of "
        f"{TONE_HZ:.0f} Hz; {wall * 1e3 / max(m.blocks_processed, 1):.2f} ms per "
        f"block in all, of it the engine {m.busy_seconds * 1e3 / m.blocks_processed:.2f} "
        f"(up, step, down) and update_spectrum {np.mean(fed) * 1e3:.2f} (host clock)")

    srv = RingServer(Pipeline(replace(cfg, conv_strategy="td_mxu"), dev),
                     slots=sz.slots, chunk=sz.chunk)
    ring_ctl = EqualizerController(eng)
    got = []
    ring_ctl.start_ring_stream(srv, (block(i) for i in range(n)),
                               sink=got.append, spectrum_every=TAP_EVERY)
    deadline = time.perf_counter() + 60
    while len(got) < n and time.perf_counter() < deadline:
        time.sleep(0.005)
    ring_ctl.stop_stream(timeout=30.0)
    f_ring = ring_ctl.spectrum_peak[0] if ring_ctl.spectrum_peak else float("nan")
    check(len(got) == n and srv.spectrum_every == TAP_EVERY
          and abs(f_ring - TONE_HZ) <= bin_hz
          and ring_ctl.waterfall_ring is not None,
          f"10c ring stream: {len(got)} of {n} blocks, peak {f_ring}")
    say(f"phase 10c start_ring_stream over a td_mxu RingServer (K3): {len(got)} "
        f"blocks served, the tap every {TAP_EVERY} fed the controller, peak "
        f"{f_ring:.1f} Hz")


def phase_observe_cli(torch, dev, sz: Sizes) -> None:
    """10d: `process` of a 60 s stereo file with ``--spectrum-plot`` and
    ``--waterfall-plot``, and ``design --plot``: the arrays the plots draw
    (`cli.viz_arrays`, on the card) against a CPU recomputation from the
    written output (numpy, `spectrum_db_np`) within SPECTRUM_DB as
    magnitudes; PNGs where matplotlib imports."""
    import afp_tpu_torch.cli as cli
    from afp_tpu_torch.design import create_fir_filter
    from afp_tpu_torch.ops.spectrum import (WATERFALL_DEPTH, spectrum_db_np,
                                            spectrum_freqs)
    from afp_tpu_torch.utils import read_wav, write_wav
    from afp_tpu_torch.viz import compute_response

    if dev.type == "cuda":
        os.environ.pop("AFP_FORCE_CPU", None)
    else:
        os.environ["AFP_FORCE_CPU"] = "1"
    plots = matplotlib_line()
    shutil.rmtree(SMOKE_OBSERVE, ignore_errors=True)
    SMOKE_OBSERVE.mkdir(parents=True)
    d = SMOKE_OBSERVE
    n = int(sz.cli_seconds * CLI_RATE)
    t = np.arange(n) / CLI_RATE
    rng = np.random.default_rng(160)
    x = np.clip(0.3 * np.sin(2 * np.pi * TONE_HZ * t)
                + 0.05 * rng.standard_normal((2, n)), -1, 1).astype(np.float32)
    write_wav(str(d / "in.wav"), x, CLI_RATE, width=3)
    argv = ["process", d / "in.wav", d / "out.wav"]
    seen = []
    if plots:
        argv += ["--spectrum-plot", d / "spectrum.png",
                 "--waterfall-plot", d / "waterfall.png"]
        draw = cli.viz_arrays
        cli.viz_arrays = lambda *a, **k: seen.append(draw(*a, **k)) or seen[-1]
    try:
        _, engines, wall, _ = run_cli(torch, dev, argv, want=("dither_cuda",))
    finally:
        if plots:
            cli.viz_arrays = draw
    y = read_wav(str(d / "out.wav"))[0]
    if not plots:
        seen.append(cli.viz_arrays(y, engines[0].cfg, dev))
    check(len(seen) == 1, f"10d: viz_arrays ran {len(seen)} times")
    got = seen[0]
    nb = y.shape[1] // CLI_BLOCK
    db = spectrum_db_np(y[0, : nb * CLI_BLOCK].reshape(nb, CLI_BLOCK))
    mean_db = 10.0 * np.log10(np.mean(10.0 ** (db.astype(np.float64) / 10.0),
                                      axis=0) + 1e-30)
    e_mean = rel_mag_db(got["mean_db"], mean_db)
    filled = min(nb, WATERFALL_DEPTH)  # a file under 50 blocks leaves rows primed
    e_ring = rel_mag_db(got["ring"][WATERFALL_DEPTH - filled:], db[-filled:])
    f_peak = got["freqs"][np.argmax(got["mean_db"])]
    check(np.array_equal(got["freqs"], spectrum_freqs(CLI_BLOCK, CLI_RATE))
          and got["ring"].shape == (WATERFALL_DEPTH, CLI_BLOCK // 2 + 1)
          and bool((got["ring"][:WATERFALL_DEPTH - filled] == -200.0).all())
          and e_mean <= SPECTRUM_DB and e_ring <= SPECTRUM_DB
          and abs(f_peak - TONE_HZ) <= CLI_RATE / CLI_BLOCK,
          f"10d: plotted arrays vs the CPU: mean {e_mean:.1f} dB, ring "
          f"{e_ring:.1f} dB, peak {f_peak:.1f} Hz")
    taps = d / "taps.txt"
    dargv = ["design", "--taps-out", taps]
    if plots:
        dargv += ["--plot", d / "response.png"]
    run_cli(torch, dev, dargv)
    h = np.loadtxt(taps)
    want_h = create_fir_filter(method="window", cutoff=14000.0, numtaps=129,
                               window_type="hamming", filter_type="lowpass",
                               samplerate=2 * CLI_RATE)
    resp = compute_response(h, 2 * CLI_RATE)
    check(np.allclose(h, want_h, rtol=1e-15, atol=1e-18)
          and abs(resp.magnitude_db[0]) < 0.1
          and bool(np.isfinite(resp.phase_rad).all()),
          "10d: design taps or their response")
    pngs = sorted(p.name for p in d.glob("*.png") if p.stat().st_size > 1000)
    check(pngs == (["response.png", "spectrum.png", "waterfall.png"] if plots
                   else []), f"10d: PNGs {pngs}")
    say(f"phase 10d CLI process of {sz.cli_seconds:.0f} s stereo "
        f"{'with' if plots else 'without'} the plot flags ({nb} blocks): the plotted power-mean spectrum {e_mean:.1f} dB and "
        f"the ring {e_ring:.1f} dB vs the CPU from the written output (<= "
        f"{SPECTRUM_DB}), peak {f_peak:.1f} Hz; {wall:.2f} s wall; design "
        f"--plot: DC {resp.magnitude_db[0]:.3f} dB; PNGs {pngs or 'none'}")
    shutil.rmtree(SMOKE_OBSERVE, ignore_errors=True)


#: run one example as ``python -m afp_tpu_torch.examples.<name>`` with jax
#: and the JAX package blocked; a blocked import fails the run
EXAMPLE_RUNNER = """
import runpy, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "afp_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
name, sys.argv = sys.argv[1], [sys.argv[1]] + sys.argv[2:]
runpy.run_module(f"afp_tpu_torch.examples.{name}", run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "afp_tpu"))
assert not bad, bad
"""


def phase_observe_examples(torch, dev, sz: Sizes) -> None:
    """10e: the examples `waterfall_stream` and `ring_serving` (at its
    defaults: 64 streams, 32 blocks of the C5 headline through the pair
    rings) in two subprocesses at once, on the card (on the CPU under
    ``AFP_FORCE_CPU`` in a rehearsal); each exits 0 with jax and the JAX
    package blocked."""
    env = dict(os.environ)
    if dev.type == "cuda":
        env.pop("AFP_FORCE_CPU", None)
    else:
        env["AFP_FORCE_CPU"] = "1"
    out = SMOKE_OBSERVE / "examples"
    out.mkdir(parents=True, exist_ok=True)
    runs = {"waterfall_stream": ["--out-dir", str(out)],
            "ring_serving": ([] if dev.type == "cuda"
                             else ["--streams", "2", "--blocks", "4",
                                   "--chunk", "2"])}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_RUNNER, name, *args],
        cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, args in runs.items()}
    lines = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=300)
            check(p.returncode == 0, f"10e example {name}: exit "
                  f"{p.returncode}\n{se[-2000:]}")
            lines[name] = [ln for ln in so.splitlines() if ln.strip()]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    shutil.rmtree(SMOKE_OBSERVE, ignore_errors=True)
    say(f"phase 10e examples waterfall_stream and ring_serving on {dev.type}: "
        f"exit 0 with jax blocked, {time.perf_counter() - t0:.1f} s together; "
        f"{lines['waterfall_stream'][-2]}; {lines['ring_serving'][-2]}")


# ---------------------------------------------------------------- phase 11


SMOKE_PARALLEL = Path(__file__).resolve().parent / "build" / "smoke_parallel"
#: 11c: the long signal's T is whole 4 × C5 blocks (the 4-way time mesh's
#: chunks hold whole engine blocks of C5 and of C8)
LONG_DB = -100.0  # the long signal's FFT conv against the bf16×3 stream
LONG_F32_DB = -110.0  # C8's long signal against the HIGHEST (fp32) stream


def shard_mesh(dev, n: int, axes=("streams",), shape=None):
    """A mesh of `n` shards, all on `dev` (the one card)."""
    from afp_tpu_torch.parallel import make_mesh

    return make_mesh(n, axes, shape=shape, devices=[dev] * n)


def walled(torch, dev, fn):
    """(fn's result, its wall in seconds on the host clock ending in a
    synchronize), leaving the peak-memory counter alone."""
    sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, time.perf_counter() - t0


def median_walls(torch, dev, fns: dict, reps: int = 5) -> tuple:
    """Each of `fns` (name → thunk) run `reps` times in turn after one
    warm-up: (the last result of each, the median wall of each)."""
    out, walls = {}, {k: [] for k in fns}
    for k, fn in fns.items():
        fn()  # warm the allocator's pools and cuFFT's plans
    for _ in range(reps):
        for k, fn in fns.items():
            out[k], w = walled(torch, dev, fn)
            walls[k].append(w)
    return out, {k: float(np.median(v)) for k, v in walls.items()}


def phase_sharded_c5(torch, dev, sz: Sizes) -> None:
    """11a: stream DP at the C5 headline over a 4-shard mesh of the card.
    Dither off: sharded step, run (8 blocks) and process_signal (the fold)
    ≡ the one-shard Pipeline bit for bit; C5-bank (four cutoffs in batch/4 groups) ≡ unsharded.  Dither on:
    `RingServer` over the per-shard f32 rings, per step and mega (16 slots,
    chunk 4), ≡ sharded run; shards' noise decorrelated; run ≡ chained
    steps.  ms per block sharded and unsharded, and the peak memory."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.parallel import ShardedPipeline
    from afp_tpu_torch.runtime import RingServer

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = shard_mesh(dev, sz.shards)
    g = torch.Generator(device=dev).manual_seed(160)
    blocks = torch.randn(sz.run_blocks, sz.batch, sz.block, generator=g,
                         device=dev) * 0.3
    cfg = c5_config(sz, dither_kind="off")
    design = PipelineParams.design(cfg.validate())
    pipe = Pipeline(cfg, dev)
    params = pipe.device_params(design)
    fns = {}
    for name, run in (("unsharded", pipe), ("sharded", ShardedPipeline(cfg, mesh))):
        p = params if run is pipe else run.device_params(design)
        fns[name] = (lambda run=run, p=p:
                     run.run(p, run.init_state(), blocks)[1])
    outs, walls = median_walls(torch, dev, fns)
    check(torch.equal(outs["sharded"], outs["unsharded"]),
          "11a: sharded run differs from the unsharded pipeline (dither off)")
    sp = ShardedPipeline(cfg, mesh)
    sparams = sp.device_params(design)
    _, y = sp.step(sparams, sp.init_state(), blocks[0])
    check(torch.equal(y, outs["unsharded"][0]), "11a: sharded step differs")
    sig = blocks.transpose(0, 1).reshape(sz.batch, -1)
    del outs
    (_, yf), wall_fold = walled(torch, dev, lambda: sp.process_signal(
        sparams, sp.init_state(), sig, fold="prefer"))
    _, uf = pipe.process_signal(params, pipe.init_state(), sig, fold=True)
    check(torch.equal(yf, uf), "11a: the sharded fold differs from the unsharded")
    del sig, yf, uf
    bank = c5_bank(pipe)
    check(torch.equal(sp.run(bank, sp.init_state(), blocks[:2])[1],
                      pipe.run(bank, pipe.init_state(), blocks[:2])[1]),
          "11a: sharded C5-bank differs from the unsharded bank")
    ms = {k: v * 1e3 / sz.run_blocks for k, v in walls.items()}
    say(f"phase 11a C5 batch {sz.batch} over {sz.shards} shards of one card "
        f"(dither off): step, run ({sz.run_blocks} blocks), the fold and C5-bank "
        f"(2 blocks) == the unsharded pipeline bit for bit; ms/block (host "
        f"clock, median of 5 runs in turn): unsharded {ms['unsharded']:.3f}, "
        f"sharded {ms['sharded']:.3f}; the sharded fold of "
        f"{sz.run_blocks} blocks {wall_fold * 1e3:.1f} ms")

    dcfg = c5_config(sz)  # TPDF dither on
    sd = ShardedPipeline(dcfg, mesh)
    dparams = sd.device_params(design)
    st, outs = sd.init_state(seed=0), []
    for blk in blocks[:2]:
        st, yb = sd.step(dparams, st, blk)
        outs.append(yb)
    _, yr = sd.run(dparams, sd.init_state(seed=0), blocks[:2])
    check(torch.equal(torch.stack(outs), yr), "11a: dithered run != chained steps")
    _, z = sd.step(dparams, sd.init_state(seed=0), torch.zeros_like(blocks[0]))
    b = sz.batch // sz.shards
    parts = [z[i * b:(i + 1) * b] for i in range(sz.shards)]
    check(bool(z.abs().max() > 0) and all(
        not torch.equal(parts[i], parts[j]) for i in range(sz.shards)
        for j in range(i)), "11a: shards' dither is not decorrelated")
    del outs, yr, z, parts
    src = (torch.randn(sz.serve_blocks, sz.batch, sz.block, generator=g,
                       device=dev) * 0.3)
    _, gold = sd.run(dparams, sd.init_state(seed=0), src)
    gold, src = gold.cpu().numpy(), src.cpu().numpy()
    served = {}
    for mega in (False, True):
        srv = RingServer(sd, dparams, slots=sz.slots, chunk=sz.chunk,
                         max_inflight=2, seed=0, mega=mega)
        check(isinstance(srv._out, tuple) and len(srv._out) == sz.shards,
              "11a: RingServer did not take the per-shard ring layout")
        got = []
        stats = srv.serve(iter(src), got.append)
        check(np.array_equal(np.stack(got), gold),
              f"11a: RingServer mega={mega} over shards != sharded run")
        served[mega] = stats
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0
    say(f"phase 11a RingServer over {sz.shards} per-shard f32 rings ({sz.slots} "
        f"slots, chunk {sz.chunk}, {sz.serve_blocks} blocks, dither on): per step "
        f"and mega == sharded run bit for bit ({served[False]['xrt']:.0f}x and "
        f"{served[True]['xrt']:.0f}x realtime, host clock); run == chained "
        f"steps, shards' noise decorrelated; peak memory {peak:.2f} GiB")


def phase_sharded_c8(torch, dev, sz: Sizes) -> None:
    """11b: stream DP at C8 (batch 4096, block 2048, W 512, linked in pairs)
    over 4 shards, dither off: sharded staged run and sharded run_ring over
    per-shard rings ≡ the unsharded pipeline, bit for bit."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.parallel import ShardedPipeline

    cfg = c8_config(sz, agc_link_group=2, dither_kind="off")
    design = PipelineParams.design(cfg.validate())
    pipe = Pipeline(cfg, dev)
    sp = ShardedPipeline(cfg, shard_mesh(dev, sz.shards))
    params, sparams = pipe.device_params(design), sp.device_params(design)
    g = torch.Generator(device=dev).manual_seed(170)
    blocks = torch.randn(sz.run_blocks, sz.c8_batch, sz.c8_block, generator=g,
                         device=dev) * 0.1
    blocks[:, ::5] *= 0.05  # quiet streams: the gain rises
    res, walls = median_walls(torch, dev, {
        "unsharded": lambda: pipe.run(params, pipe.init_state(), blocks),
        "sharded": lambda: sp.run(sparams, sp.init_state(), blocks)})
    (ust, gold), (st, y) = res["unsharded"], res["sharded"]
    lay = sp.ring_layout
    rings = lay.split(blocks)
    out = lay.zeros(sz.run_blocks, sz.c8_block, torch.float32)
    st2, out = sp.run_ring(sparams, sp.init_state(), rings, None, out, sz.run_blocks)
    check(torch.equal(y, gold) and torch.equal(lay.gather(out), gold)
          and torch.equal(st.gather("agc_gain"), ust.agc_gain)
          and torch.equal(st2.gather("agc_gain"), ust.agc_gain),
          "11b: sharded C8 staged or ring differs from the unsharded pipeline")
    say(f"phase 11b C8 batch {sz.c8_batch} x {sz.run_blocks} blocks of "
        f"{sz.c8_block}, link 2, over {sz.shards} shards (dither off): staged "
        f"run and run_ring == the unsharded pipeline bit for bit (outputs and "
        f"gain carry); ms/block (host clock, median of 5 runs in turn): "
        f"sharded {walls['sharded'] * 1e3 / sz.run_blocks:.3f}, unsharded "
        f"{walls['unsharded'] * 1e3 / sz.run_blocks:.3f}")


def phase_long_signal(torch, dev, sz: Sizes) -> None:
    """11c: `filter_long_signal` of 8 streams × ≈60 s at 44.1 kHz through
    the C5 cascade over a 4-way 'time' mesh and a 2×2 'streams'×'time'
    mesh, and through C8 with the AGC carry (K5 per shard, K9 in shard
    order); C5 against the port's streaming `Pipeline` (dither off,
    ≤ −100 dB: the FFT conv against the bf16×3 stream), C8 against the
    streaming pipeline at ``td_precision='HIGHEST'`` (≤ −110 dB: the bf16
    pair the bf16×3 stream reads keeps 16 bits of the gained signal, so
    that stream sits at −100 dB against either), the first blocks against
    the float64 oracle (< −90 dB).  The shard hand-off: C8 over 8 blocks
    on the 4-way mesh (2 blocks a shard, 3 boundaries; a quiet row, and
    rows loud enough to clip the gain at 0.1 in some shards and normal in
    the next, so the carried gain is the clipped one) against the float64
    oracle over the whole signal.  K2 under ``dither_seed``."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.parallel import filter_long_signal

    unit = 4 * sz.block
    T = int(sz.long_seconds * 44100) // unit * unit
    B = sz.long_streams
    gen = torch.Generator(device=dev).manual_seed(180)
    x = torch.randn(B, T, generator=gen, device=dev) * 0.1
    x[1::2] *= 0.05  # quiet rows: the AGC lifts them
    meshes = {"4-way time": shard_mesh(dev, 4, ("time",)),
              "2x2 streams x time": shard_mesh(dev, 4, ("streams", "time"),
                                               shape=(2, 2))}
    res = []
    n_or = 4 * sz.block
    for name, cfg, oracle, precision, limit in (
            ("C5", c5_config(sz, batch=B, dither_kind="off"), c5_oracle,
             "B3", LONG_DB),
            ("C8 AGC carry", c8_config(sz, batch=B, dither_kind="off"),
             c8_oracle, "HIGHEST", LONG_F32_DB)):
        design = PipelineParams.design(cfg.validate())
        pipe = Pipeline(cfg, dev)
        params = pipe.device_params(design)
        ref = Pipeline(cfg, dev, td_precision=precision)
        (_, streamed), swall, _ = timed(torch, dev, lambda: ref.process_signal(
            ref.device_params(design), ref.init_state(), x, fold=False))
        for mname, mesh in meshes.items():
            if name != "C5" and mname != "4-way time":
                continue
            y, wall, peak = timed(torch, dev, lambda: filter_long_signal(
                pipe, params, x, mesh))
            e = err_db(y.cpu().numpy(), streamed.cpu().numpy())
            eo = err_db(y[:2, :n_or].cpu().numpy(),
                        oracle(x[:2, :n_or].cpu().numpy(), cfg, design))
            check(y.shape == x.shape and bool(torch.isfinite(y).all())
                  and e <= limit and eo < ORACLE_DB,
                  f"11c {name} on the {mname} mesh: {e:.1f} dB vs streaming "
                  f"({precision}), {eo:.1f} dB vs the oracle")
            res.append(f"{name}, {mname}: {e:.1f} dB vs streaming {precision} "
                       f"(<= {limit}), {eo:.1f} dB vs the oracle; "
                       f"{wall * 1e3:.1f} ms (streaming {swall * 1e3:.1f} ms), "
                       f"peak {peak:.2f} GiB")
        del streamed
    # the hand-off: 4 rows × 8 C8 blocks, 2 a shard
    L8 = sz.c8_block
    xs = torch.randn(4, 8 * L8, generator=gen, device=dev) * 0.1
    xs[1] *= 0.05  # quiet: the gain rises across every boundary
    for r, shards in ((2, (0,)), (3, (0, 2))):  # loud: gain clipped at 0.1
        for i in shards:
            xs[r, 2 * i * L8:2 * (i + 1) * L8] *= 30.0
    cfg = c8_config(sz, batch=4, dither_kind="off")
    design = PipelineParams.design(cfg.validate())
    pipe = Pipeline(cfg, dev)
    ys = filter_long_signal(pipe, pipe.device_params(design), xs,
                            meshes["4-way time"])
    eh = err_db(ys.cpu().numpy(), c8_oracle(xs.cpu().numpy(), cfg, design))
    check(eh < ORACLE_DB, f"11c C8 hand-off: {eh:.1f} dB vs the oracle")
    cfg = c5_config(sz, batch=B)  # TPDF dither on
    pipe = Pipeline(cfg, dev)
    params = pipe.device_params(PipelineParams.design(cfg.validate()))
    quiet = filter_long_signal(pipe, params, x, meshes["4-way time"])
    noisy = filter_long_signal(pipe, params, x, meshes["4-way time"], dither_seed=1)
    lsb = float((noisy - quiet).abs().max()) * 2 ** 23
    check(0 < lsb <= 2.0, f"11c: dither_seed's noise is {lsb} 24-bit LSB")
    say(f"phase 11c long signal {B} streams x {T} samples "
        f"({T / 44100:.1f} s): " + "; ".join(res)
        + f"; C8 shard hand-off, 4 streams x 8 blocks over 4 shards (3 "
        f"boundaries, gain clipped at 0.1 in loud shards): {eh:.1f} dB vs the "
        f"float64 oracle over the whole signal (< {ORACLE_DB}); with "
        f"dither_seed the noise peaks at {lsb:.2f} 24-bit LSB (K2)")


def phase_kernel_parallel(torch, dev, sz: Sizes) -> None:
    """11d: `KernelParallelConv` of a 50 000-tap FIR, block 4096, batch 16,
    over an 8-way 'kernel' mesh of the card, 8 blocks: ≤ −100 dB against
    the full-kernel `OverlapSave`; a `with_kernel` swap from a fresh state
    ≡ the new kernel's OverlapSave; the FFT sizes and ms per block."""
    from afp_tpu_torch.ops.convolve import OverlapSave, next_pow2
    from afp_tpu_torch.parallel import KernelParallelConv

    rng = np.random.default_rng(190)
    h = (rng.standard_normal(sz.kp_taps) / np.sqrt(sz.kp_taps)).astype(np.float32)
    h2 = (rng.standard_normal(sz.kp_taps) / np.sqrt(sz.kp_taps)).astype(np.float32)
    mesh = shard_mesh(dev, sz.kp_shards, ("kernel",))
    x = torch.as_tensor((rng.standard_normal((sz.run_blocks, sz.kp_batch, sz.block))
                         * 0.3).astype(np.float32), device=dev)
    errs, walls = {}, {}
    for name, taps in (("kernel", h), ("swapped", h2)):
        kp = KernelParallelConv(h, block=sz.block, mesh=mesh, batch=sz.kp_batch)
        if name == "swapped":
            kp = kp.with_kernel(taps)
        ref = OverlapSave.init(taps, block=sz.block, batch_shape=(sz.kp_batch,),
                               device=dev)
        kp.step(kp.init_state(), x[0])  # warm cuFFT's plans
        ref.process(x[0])
        st, e, w = kp.init_state(), -1e9, [0.0, 0.0]
        for blk in x:
            sync(torch, dev)
            t0 = time.perf_counter()
            st, y = kp.step(st, blk)
            sync(torch, dev)
            t1 = time.perf_counter()
            ref, gold = ref.process(blk)
            sync(torch, dev)
            w[0] += t1 - t0
            w[1] += time.perf_counter() - t1
            e = max(e, err_db(y.cpu().numpy(), gold.cpu().numpy()))
        errs[name], walls[name] = e, w
    check(all(e <= -100.0 for e in errs.values()),
          f"11d: kernel-parallel vs OverlapSave {errs}")
    full = next_pow2(sz.block + sz.kp_taps - 1)
    n = sz.run_blocks
    say(f"phase 11d KernelParallelConv {sz.kp_taps} taps over {sz.kp_shards} "
        f"shards of one card, block {sz.block}, batch {sz.kp_batch}, {n} blocks: "
        f"{errs['kernel']:.1f} dB vs the full-kernel OverlapSave (<= -100), "
        f"with_kernel swap {errs['swapped']:.1f} dB vs the new kernel's; per-shard "
        f"FFT {kp.nfft} vs full {full}; {walls['kernel'][0] * 1e3 / n:.3f} ms/block "
        f"sharded vs {walls['kernel'][1] * 1e3 / n:.3f} OverlapSave (host clock)")


def phase_sharded_cli(torch, dev, sz: Sizes) -> None:
    """11e: the CLI's ``--mesh``.  On a one-card machine ``process --mesh 2``
    exits non-zero with the reference's message; the sharded row path on a
    4-shard mesh of the card (`main(..., mesh=)`) ≡ ``--mesh 1``, bit for
    bit, dither off, on a 60 s stereo file (phase 8's size, the CLI
    defaults) and on a `batch` set of phase 8's size (32 stereo 30 s 16-bit
    files, the C5 filter, int16 in and out); the example
    `long_kernel_parallel` runs in a subprocess and exits 0."""
    from afp_tpu_torch.cli import main
    from afp_tpu_torch.utils import read_wav, read_wav_pcm16, write_wav, write_wav_pcm16

    env = dict(os.environ)
    if dev.type == "cuda":
        os.environ.pop("AFP_FORCE_CPU", None)
        env.pop("AFP_FORCE_CPU", None)
    else:
        os.environ["AFP_FORCE_CPU"] = env["AFP_FORCE_CPU"] = "1"
    example = subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_RUNNER, "long_kernel_parallel",
         *([] if dev.type == "cuda" else ["--taps", "3000", "--block", "1024"])],
        cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        shutil.rmtree(SMOKE_PARALLEL, ignore_errors=True)
        SMOKE_PARALLEL.mkdir(parents=True)
        d = SMOKE_PARALLEL
        rng = np.random.default_rng(200)
        n = int(sz.cli_seconds * CLI_RATE)
        write_wav(str(d / "in24.wav"),
                  np.clip(0.3 * rng.standard_normal((2, n)), -1, 1), CLI_RATE, width=3)
        msg = ""
        if dev.type == "cuda":
            over = torch.cuda.device_count() + 1
            try:
                main(["process", str(d / "in24.wav"), str(d / "x.wav"), "--mesh",
                      str(over)])
            except SystemExit as e:
                msg = str(e)
            check(msg == f"--mesh {over}: only {over - 1} devices available",
                  f"11e: --mesh {over} on {over - 1} card(s) said {msg!r}")
        mesh = shard_mesh(dev, 4)
        off = ["--dither", "off"]
        walls = {}
        for tag, argv in (("1", []), ("4", ["--mesh", "4"])):
            t0 = time.perf_counter()
            rc = main(["process", str(d / "in24.wav"), str(d / f"p{tag}.wav"), *off,
                       *argv], mesh=mesh if argv else None)
            sync(torch, dev)
            walls["process", tag] = time.perf_counter() - t0
            check(rc == 0, f"11e: process --mesh {tag} exit {rc}")
        check(np.array_equal(read_wav(str(d / "p4.wav"))[0],
                             read_wav(str(d / "p1.wav"))[0]),
              "11e: process --mesh 4 differs from --mesh 1")
        nbt = int(sz.batch_seconds * CLI_RATE)
        srcs = []
        for i in range(sz.batch_files):
            srcs.append(str(d / f"b{i:02d}.wav"))
            write_wav_pcm16(srcs[-1], np.clip(np.round(rng.standard_normal(
                (2, nbt)) * 0.2 * 32768), -32768, 32767).astype(np.int16), CLI_RATE)
        c5 = ["--upsample", "4", "--numtaps", "1001", "--cutoff", "11000",
              "--ingest", "pcm16", "--emit", "pcm16", *off]
        for tag, argv in (("1", []), ("4", ["--mesh", "4"])):
            t0 = time.perf_counter()
            rc = main(["batch", *srcs, "-o", str(d / f"b{tag}"), *c5, *argv],
                      mesh=mesh if argv else None)
            sync(torch, dev)
            walls["batch", tag] = time.perf_counter() - t0
            check(rc == 0, f"11e: batch --mesh {tag} exit {rc}")
        check(all(np.array_equal(read_wav_pcm16(str(d / "b4" / Path(s).name))[0],
                                 read_wav_pcm16(str(d / "b1" / Path(s).name))[0])
                  for s in srcs), "11e: batch --mesh 4 differs from --mesh 1")
        so, se = example.communicate(timeout=300)
        check(example.returncode == 0,
              f"11e example long_kernel_parallel: exit {example.returncode}\n"
              f"{se[-2000:]}")
    finally:
        if example.poll() is None:
            example.kill()
            example.wait()
        shutil.rmtree(SMOKE_PARALLEL, ignore_errors=True)
    lines = [ln for ln in so.splitlines() if ln.strip()]
    say(f"phase 11e CLI: {msg or '--mesh on CPU shards here'}; process of a "
        f"{sz.cli_seconds:g} s stereo file --mesh 4 (4 shards of one card) == "
        f"--mesh 1 bit for bit ({walls['process', '4']:.2f} s vs "
        f"{walls['process', '1']:.2f} s wall, WAV I/O included); batch of "
        f"{sz.batch_files} stereo {sz.batch_seconds:g} s files, C5 int16 in and "
        f"out, --mesh 4 == --mesh 1 bit for bit ({walls['batch', '4']:.2f} s vs "
        f"{walls['batch', '1']:.2f} s); example long_kernel_parallel exit 0 with "
        f"jax blocked: {lines[-1] if lines else ''}")


# ---------------------------------------------------------------- main


REPLACES = {
    "fir_td_mxu": ("afp_tpu_torch/csrc/fir_td.cu", "afp_tpu/ops/pallas/fir_td.py:1665"),
    "fir_td_mxu_ring_f32": ("afp_tpu_torch/csrc/fir_td.cu",
                            "afp_tpu/ops/pallas/fir_td.py:1173"),
    "fir_td_mxu_ring_mega_f32": ("afp_tpu_torch/csrc/fir_td.cu",
                                 "afp_tpu/ops/pallas/fir_td.py:1612"),
    "dither_cuda": ("afp_tpu_torch/csrc/dither.cu",
                    "afp_tpu/ops/pallas/dither_pl.py:69"),
    "rms_desired": ("afp_tpu_torch/csrc/agc_rms.cu",
                    "afp_tpu/ops/pallas/agc_rms.py:330"),
    "smooth_gain_apply": ("afp_tpu_torch/csrc/agc_scan.cu",
                          "afp_tpu/ops/pallas/agc_scan.py:384"),
    "fir_td_mxu_pair_to_ring": ("afp_tpu_torch/csrc/fir_td.cu",
                                "afp_tpu/ops/pallas/fir_td.py:828"),
    "fir_td_mxu_pair": ("afp_tpu_torch/csrc/fir_td.cu",
                        "afp_tpu/ops/pallas/fir_td.py:700"),
    "fir_td_mxu_ring_pcm16": ("afp_tpu_torch/csrc/fir_td.cu",
                              "afp_tpu/ops/pallas/fir_td.py:1270"),
    "fir_td_mxu_ring_mega_pcm16": ("afp_tpu_torch/csrc/fir_td.cu",
                                   "afp_tpu/ops/pallas/fir_td.py:1638"),
    "fir_td_mxu_ring": ("afp_tpu_torch/csrc/fir_td.cu",
                        "afp_tpu/ops/pallas/fir_td.py:946"),
    "fir_td_mxu_ring_mega": ("afp_tpu_torch/csrc/fir_td.cu",
                             "afp_tpu/ops/pallas/fir_td.py:1445"),
    "fir_td_mxu_banked": ("afp_tpu_torch/csrc/fir_td.cu",
                          "afp_tpu/ops/pallas/fir_td.py:556"),
    "fir_td_mxu_per_stream": ("afp_tpu_torch/csrc/fir_td.cu",
                              "afp_tpu/ops/pallas/fir_td.py:1784"),
    # K11 behind the AGC with K8's loader (and K7's store): no TPU twin
    "fir_td_mxu_per_stream_pair": ("afp_tpu_torch/csrc/fir_td.cu", "none"),
    "fir_td_mxu_per_stream_pair_to_ring": ("afp_tpu_torch/csrc/fir_td.cu", "none"),
    "agc_rms_apply": ("afp_tpu_torch/csrc/agc_fused.cu",
                      "afp_tpu/ops/pallas/agc_fused.py:295"),
    "smooth_gain_scan": ("afp_tpu_torch/csrc/agc_scan.cu",
                         "afp_tpu/ops/pallas/agc_scan.py:142"),
    # K15: the HIGHEST option of the conv body (K1) and of K11's kernel
    "fir_td_mxu:highest": ("afp_tpu_torch/csrc/fir_td.cu",
                           "afp_tpu/ops/pallas/fir_td.py:370"),
    "fir_td_mxu_per_stream:highest": ("afp_tpu_torch/csrc/fir_td.cu",
                                      "afp_tpu/ops/pallas/fir_td.py:1701"),
}

#: what each phase must launch: kernels by wrapper name, and the options of a
#: wrapper as "name:option" (its ``<option>_launches`` count).  The transport
#: phases: K12 and K13, the int16 store (K12 at C5-i16io, K8 and K7 at
#: C8-i16io) and K5/K6's int16 loads (C8-i16io); the bank phases: K10, K11's
#: pair forms (C8-psg behind the AGC, staged and on the ring), the bank
#: option of K3, K4 and K12, the vector option of K5 and K6
PHASE_LAUNCHES = {
    "phase_transport_pipeline": ("fir_td_mxu_ring_pcm16", "fir_td_mxu_pair",
                                 "rms_desired", "smooth_gain_apply"),
    "phase_transport_serving": ("fir_td_mxu_ring_pcm16",
                                "fir_td_mxu_ring_mega_pcm16", "fir_td_mxu_ring",
                                "fir_td_mxu_ring_mega", "fir_td_mxu_pair_to_ring",
                                "rms_desired", "smooth_gain_apply"),
    "phase_transport_engine": ("fir_td_mxu_pair", "rms_desired",
                               "smooth_gain_apply"),
    "phase_bank_pipeline": ("fir_td_mxu_banked", "fir_td_mxu_per_stream_pair",
                            "rms_desired:vector", "smooth_gain_apply:vector"),
    "phase_bank_serving": ("fir_td_mxu_ring_f32:banked",
                           "fir_td_mxu_ring_mega_f32:banked",
                           "fir_td_mxu_ring_pcm16:banked",
                           "fir_td_mxu_ring_mega_pcm16:banked", "fir_td_mxu_banked",
                           "rms_desired:vector", "smooth_gain_apply:vector",
                           "fir_td_mxu_pair_to_ring",
                           "fir_td_mxu_per_stream_pair_to_ring"),
    "phase_bank_engine": ("dither_cuda",),
    "phase_highest_pipeline": ("fir_td_mxu:highest",
                               "fir_td_mxu_per_stream:highest", "rms_desired",
                               "smooth_gain_apply"),
    "phase_one_kernel": ("agc_rms_apply", "fir_td_mxu_pair",
                         "fir_td_mxu_pair_to_ring"),
    "phase_fold": ("fir_td_mxu", "fir_td_mxu:highest"),
    "phase_apply_agc": ("smooth_gain_scan",),
    "phase_cli": ("dither_cuda", "fir_td_mxu_pair", "rms_desired",
                  "smooth_gain_apply"),
    "phase_multirate_chain": ("dither_cuda", "fir_td_mxu"),
    "phase_multirate_asrc": ("rms_desired", "smooth_gain_apply", "fir_td_mxu_pair",
                             "fir_td_mxu"),
    "phase_multirate_cli": ("dither_cuda", "rms_desired", "smooth_gain_apply"),
    "phase_parallel_agc": ("rms_desired", "smooth_gain_apply", "fir_td_mxu_pair",
                           "fir_td_mxu"),
    "phase_observe_waterfall": ("fir_td_mxu",),
    "phase_observe_tap": ("rms_desired", "smooth_gain_apply",
                          "fir_td_mxu_pair_to_ring"),
    "phase_observe_controller": ("dither_cuda", "fir_td_mxu_ring_f32"),
    "phase_observe_cli": ("dither_cuda",),
    # phase 11, the parallel layer: K1-K10 between them
    "phase_sharded_c5": ("fir_td_mxu", "fir_td_mxu_ring_f32",
                         "fir_td_mxu_ring_mega_f32", "fir_td_mxu_banked"),
    "phase_sharded_c8": ("rms_desired", "smooth_gain_apply",
                         "fir_td_mxu_pair_to_ring", "fir_td_mxu_pair"),
    "phase_long_signal": ("rms_desired", "smooth_gain_scan", "dither_cuda"),
    "phase_sharded_cli": ("fir_td_mxu_pair",),
}


def counts(kernels) -> dict:
    """Every launch count: ``name`` and each ``name:option``."""
    out = {}
    for k in kernels:
        out[k.__name__] = k.launches
        for opt in ("banked", "vector", "highest"):
            if hasattr(k, f"{opt}_launches"):
                out[f"{k.__name__}:{opt}"] = getattr(k, f"{opt}_launches")
    return out


def reset(kernels) -> None:
    for k in kernels:
        for attr in ("launches", "banked_launches", "vector_launches",
                     "highest_launches"):
            if hasattr(k, attr):
                setattr(k, attr, 0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the plain references must run in full fp32, never TF32 (−60 dB class)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = gpu_line()
    say(f"phase 1 device: {smi} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")

    from afp_tpu_torch.ops.cuda import KERNELS, _build

    t0 = time.perf_counter()
    _build.load()
    say(f"phase 2 build: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for kern, r in ptxas_report(_build.build().with_suffix(".log"),
                                ("fir_conv_kernel", "fir_ps_kernel", "agc_")).items():
        say(f"phase 2 ptxas {kern}: {r.get('registers')} registers, spills "
            f"{r.get('spills')}")

    sz = Sizes()
    res = {}
    for phase in (phase_kernels, phase_kernels_agc, phase_kernels_transport,
                  phase_kernels_banks, phase_kernels_last):
        t0 = time.perf_counter()
        res.update(phase(torch, dev, sz))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s)")

    reset(KERNELS)  # count only the main path's launches from here on
    for phase in (phase_pipeline, phase_c8_pipeline, phase_transport_pipeline,
                  phase_bank_pipeline, phase_serving, phase_c8_serving,
                  phase_transport_serving, phase_bank_serving, phase_engine,
                  phase_c8_engine, phase_transport_engine, phase_bank_engine,
                  phase_highest_pipeline, phase_one_kernel, phase_fold,
                  phase_apply_agc, phase_cli, phase_multirate_chain,
                  phase_multirate_asrc, phase_multirate_cli, phase_parallel_agc,
                  phase_observe_waterfall, phase_observe_tap,
                  phase_observe_controller, phase_observe_cli,
                  phase_observe_examples, phase_sharded_c5, phase_sharded_c8,
                  phase_long_signal, phase_kernel_parallel, phase_sharded_cli):
        t0 = time.perf_counter()
        before = counts(KERNELS)
        phase(torch, dev, sz)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        delta = {k: v - before[k] for k, v in counts(KERNELS).items()}
        want = PHASE_LAUNCHES.get(phase.__name__, ())
        check(all(delta[k] > 0 for k in want),
              f"{phase.__name__} did not launch all of {want}: {delta}")
        say(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s"
            + (f"; launched {({k: delta[k] for k in want})}" if want else "")
            + ")")
    every = counts(KERNELS)
    launches = {k.__name__: k.launches for k in KERNELS}
    check(all(v > 0 for v in every.values()),
          f"a kernel or option of the path never launched: {every}")
    reference = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "afp_tpu"))
    check(not reference, f"jax or the JAX package was imported: {reference[:5]}")
    say(f"phase 7 launches on the main path: {every}")

    launches.update({k: every[k] for k in REPLACES if ":" in k})
    kernels = [dict(name=name, route="cuda", source=REPLACES[name][0],
                    replaces=REPLACES[name][1], launches=launches[name],
                    **res[name]) for name in launches]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
