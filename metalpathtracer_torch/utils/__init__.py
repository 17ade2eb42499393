"""Render statistics, image-error metrics and profiling hooks."""

from metalpathtracer_torch.utils.metrics import (
    RenderStats,
    Timer,
    profile_trace,
    relative_mse,
    rmse,
    timed_render,
)

__all__ = [
    "RenderStats",
    "Timer",
    "profile_trace",
    "relative_mse",
    "rmse",
    "timed_render",
]
