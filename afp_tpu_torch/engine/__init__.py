"""Streaming runtime of the port: config, fused pipeline, engine, metrics,
per-stream banks (counterpart of `afp_tpu/engine/`)."""
from .batch import (StreamPacking, broadcast_gains, with_per_stream_agc,
                    with_per_stream_filters, with_per_stream_gains)
from .config import DEFAULT_EQ_BANDS, EQBand, PipelineParams, StreamConfig
from .engine import StreamEngine
from .metrics import EngineMetrics
from .pipeline import DeviceParams, Pipeline, StreamState

__all__ = [
    "DEFAULT_EQ_BANDS", "EQBand", "PipelineParams", "StreamConfig",
    "DeviceParams", "Pipeline", "StreamState",
    "StreamEngine", "EngineMetrics",
    "StreamPacking", "broadcast_gains", "with_per_stream_agc",
    "with_per_stream_filters", "with_per_stream_gains",
]
