"""Streaming runtime of the port: config, fused pipeline, engine, metrics
(counterpart of `afp_tpu/engine/`)."""
from .config import DEFAULT_EQ_BANDS, EQBand, PipelineParams, StreamConfig
from .engine import StreamEngine
from .metrics import EngineMetrics
from .pipeline import DeviceParams, Pipeline, StreamState

__all__ = [
    "DEFAULT_EQ_BANDS", "EQBand", "PipelineParams", "StreamConfig",
    "DeviceParams", "Pipeline", "StreamState",
    "StreamEngine", "EngineMetrics",
]
