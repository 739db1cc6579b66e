"""Per-stream metrics & observability — the port's jax-free copy of
`afp_tpu/engine/metrics.py` (SURVEY.md §5.5).

Structured counters replacing the reference's print-based monitoring:
overruns (`stream_process_EQ_GUI.py:107-111`), queue drops
(`stream_process_AGC.py:198-199`), underruns/fallbacks
(`stream_process.py:115-120`), and the aggregate real-time factor (xRT =
audio-seconds-processed / wall-seconds), the benchmark headline metric.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["EngineMetrics"]


@dataclass
class EngineMetrics:
    blocks_processed: int = 0
    samples_processed: int = 0  # per stream
    streams: int = 1
    underruns: int = 0  # output not ready → fallback used
    overruns: int = 0  # processing_time > block_time
    drops: int = 0  # output queue full → frame dropped
    fallback_replays: int = 0  # last-good block replayed
    fallback_silence: int = 0  # silence emitted
    design_fallbacks: int = 0  # moving-average kernel substituted
    wall_start: float = field(default_factory=time.monotonic)
    busy_seconds: float = 0.0

    def record_block(self, nsamples: int, busy: float, block_seconds: float) -> None:
        self.blocks_processed += 1
        self.samples_processed += nsamples
        self.busy_seconds += busy
        if busy > block_seconds:
            self.overruns += 1

    def xrt(self, samplerate: float) -> float:
        """Aggregate real-time factor across all streams (wall-clock based)."""
        wall = time.monotonic() - self.wall_start
        if wall <= 0:
            return 0.0
        return self.streams * self.samples_processed / samplerate / wall

    def xrt_busy(self, samplerate: float) -> float:
        """xRT counting only device-busy time (the benchmark's measure)."""
        if self.busy_seconds <= 0:
            return 0.0
        return self.streams * self.samples_processed / samplerate / self.busy_seconds

    def snapshot(self) -> dict:
        return {
            "blocks": self.blocks_processed,
            "samples": self.samples_processed,
            "streams": self.streams,
            "underruns": self.underruns,
            "overruns": self.overruns,
            "drops": self.drops,
            "fallback_replays": self.fallback_replays,
            "fallback_silence": self.fallback_silence,
            "design_fallbacks": self.design_fallbacks,
        }
