"""Observability: render statistics, image-error metrics, profiling hooks.

Port of `metalpathtracer_tpu/utils/metrics.py`: renders report structured
stats (rays, Mrays/s, spp/s), image error is quantified (RMSE, relative
MSE), a `torch.profiler` trace can wrap any render for per-kernel
device times, and `span` names the parts of a bounce step in such a trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np


@dataclasses.dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    seconds: float
    rays: int | None = None

    @property
    def spp_per_sec(self) -> float:
        return self.spp / self.seconds if self.seconds > 0 else 0.0

    @property
    def mrays_per_sec(self) -> float | None:
        if self.rays is None or self.seconds <= 0:
            return None
        return self.rays / self.seconds / 1e6

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["spp_per_sec"] = round(self.spp_per_sec, 3)
        if self.mrays_per_sec is not None:
            d["mrays_per_sec"] = round(self.mrays_per_sec, 3)
        return d

    def json_line(self) -> str:
        return json.dumps(self.to_dict())


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square pixel error."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def relative_mse(a: np.ndarray, ref: np.ndarray, eps: float = 1e-2) -> float:
    """Luminance-relative MSE (less dominated by bright lights than RMSE)."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.mean(((a - ref) ** 2) / (ref**2 + eps)))


class Timer:
    """Plain wall-clock timer. Does NOT synchronise the device: CUDA work
    is asynchronous, so end the block with `torch.cuda.synchronize()` (or
    use `timed_render`, which does)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a `torch.profiler` trace (host and, where there is a card,
    device activity) of the enclosed render. On exit the Chrome trace is
    written to `log_dir/trace.json` (chrome://tracing, Perfetto); the
    profiler object is yielded for `key_averages()`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# the prefix of every range `span` opens: a profile's readers tell these
# ranges from torch's own events by it
SPAN_PREFIX = "mpt/"


def span(name: str):
    """A `torch.profiler.record_function` range named SPAN_PREFIX + `name`
    while a profiler runs, else nothing: the kernels a range's code
    launches are attributed to it in a profile (`chip_smoke.py`'s tables
    by range), and an unprofiled step pays one check."""
    import torch

    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _wait(img) -> None:
    """Block until the device that holds `img` has finished its work."""
    import torch

    if img.is_cuda:
        torch.cuda.synchronize(img.device)


def timed_render(fn, *args, repeats: int = 1, **kwargs):
    """Run `fn(*args, **kwargs)` -> ((image, rays), RenderStats). `fn` is
    any of the `render_image*` functions; one call before the timed ones
    takes the kernels' build and the allocator's warm-up out of the time,
    and every timed call ends with a synchronise of the image's device."""
    img, rays = fn(*args, **kwargs)
    _wait(img)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        img, rays = fn(*args, **kwargs)
        _wait(img)
        best = min(best, time.perf_counter() - t0)
    h, w = img.shape[:2]
    spp = kwargs.get("spp", args[4] if len(args) > 4 else 0)
    return (img, rays), RenderStats(w, h, spp, best, int(rays))
