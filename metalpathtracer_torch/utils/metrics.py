"""Observability: render statistics, image-error metrics, profiling hooks.

Port of `metalpathtracer_tpu/utils/metrics.py`: renders report structured
stats (rays, Mrays/s, spp/s), image error is quantified (RMSE, relative
MSE), a `torch.profiler` trace can wrap any render for per-kernel
device times, and `span` names the program's stages in such a trace, on
the graph path too (`charge_events` charges each device event to a span).
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
# where a device event launched outside every span is charged
NO_SPAN = "(no range)"

# the span map of the capture in progress (a `CaptureSpans`), else None:
# `render/graphs.py` sets it while it captures a function into a CUDA graph
_capture = [None]


def span(name: str, args: str | None = None):
    """A `torch.profiler.record_function` range named SPAN_PREFIX + `name`
    (with `args`: the progressive entries pass their first sample id) while
    a profiler runs, else nothing: an unprofiled call pays one check of the
    profiler and one of the capture, and makes no CUDA call. While a
    function is captured into a CUDA graph the span also marks which of the
    graph's nodes its code captured (`CaptureSpans`), so that a replay's
    device events are charged to it (`charge_events`), as an eager run's
    are by the range open at their launch."""
    if _capture[0] is not None:
        return _capture[0].span(name, args)
    return _range(name, args)


def _range(name: str, args: str | None):
    """The profiler range of `span`, or a null context without a profiler."""
    import torch

    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name, args)


class CaptureSpans:
    """The span map of one function's capture into a CUDA graph. `count()`
    returns the number of nodes captured so far; each span opened during
    the capture reads it when it opens and when it closes. Capture is on one
    stream, so the graph is a chain and a replay runs its nodes in capture
    order. `close()` returns (node count, segments): (innermost span, first
    node, end node) in node order, covering every node; nodes captured
    outside every inner span belong to `root`."""

    def __init__(self, root: str, count):
        self.count = count
        self.open = [root]
        self.at = 0
        self.segments: list = []

    def _mark(self) -> None:
        n = self.count()
        if n > self.at:
            self.segments.append((self.open[-1], self.at, n))
            self.at = n

    @contextlib.contextmanager
    def span(self, name: str, args: str | None = None):
        self._mark()
        self.open.append(name)
        try:
            with _range(name, args):
                yield
        finally:
            self._mark()
            self.open.pop()

    def close(self) -> tuple[int, list]:
        self._mark()
        return self.at, self.segments


@contextlib.contextmanager
def capture_spans(root: str, count):
    """Record a `CaptureSpans` map (yielded) of every span opened inside the
    block, which captures one function (`root`: its run span)."""
    spans = CaptureSpans(root, count)
    _capture[0] = spans
    try:
        yield spans
    finally:
        _capture[0] = None


def _innermost(ranges, times) -> list:
    """The name of the innermost of `ranges` ((start, end, name), on one
    thread) open at each of `times`, or NO_SPAN."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))  # the outer first
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [NO_SPAN] * len(times)
    stack, k = [], 0
    for i in order:
        at = times[i]
        while k < len(ranges) and ranges[k][0] <= at:
            while stack and stack[-1][1] < ranges[k][0]:
                stack.pop()
            stack.append(ranges[k])
            k += 1
        while stack and stack[-1][1] < at:
            stack.pop()
        if stack and at >= 0:
            out[i] = stack[-1][2]
    return out


def charge_events(device, host, maps) -> tuple[list, int, int]:
    """Each device event of a profile charged to one of the program's spans.

    `device`: (name, start ns, end ns, correlation id, linked correlation
    id) of each device event; `host`: (name, start ns, end ns, correlation
    id) of each host event: the spans (SPAN_PREFIX), the CUDA runtime's
    calls (names that start with "cu") and torch's operations; `maps`:
    {run span: {node count: segments}} of the captured graphs
    (`render/graphs.py::span_maps`).

    An eager event is charged to the innermost span open at its launch (its
    runtime call, or else the operation it is linked to). The events of one
    `cudaGraphLaunch` are a replay: ordered by start, they are the graph's
    nodes in capture order, and go through the map of the launch's
    innermost span (`graphs.run.<fn>`) for their count, the i-th to node
    i's span. A replay with no map of its count is charged whole to that
    span and counted unmatched.

    Returns (charges, replays, unmatched): charges holds (span, ns, device
    name) for each device event, NO_SPAN where it was launched outside
    every span; replays counts the launches under a `graphs.run.` span."""
    ranges, runtime, ops = [], {}, {}
    for name, start, end, corr in host:
        if name.startswith(SPAN_PREFIX):
            ranges.append((start, end, name[len(SPAN_PREFIX):]))
        elif name.startswith("cu"):
            runtime[corr] = (start, name)
        else:
            ops.setdefault(corr, start)
    rows = [r for r in device if not r[0].startswith(SPAN_PREFIX)]
    at = []
    for _, _, _, corr, linked in rows:
        call = runtime.get(corr)
        at.append(call[0] if call is not None else ops.get(linked, -1))
    where = _innermost(ranges, at)
    charges, replays = [], {}
    for row, span_name in zip(rows, where):
        call = runtime.get(row[3])
        if call is not None and call[1].startswith("cudaGraphLaunch"):
            replays.setdefault(row[3], (span_name, []))[1].append(row)
        else:
            charges.append((span_name, row[2] - row[1], row[0]))
    n_replays = unmatched = 0
    for span_name, events in replays.values():
        events.sort(key=lambda r: (r[1], r[2]))
        segments = maps.get(span_name, {}).get(len(events))
        if span_name.startswith("graphs.run."):
            n_replays += 1
            unmatched += segments is None
        if segments is None:
            charges += [(span_name, e[2] - e[1], e[0]) for e in events]
            continue
        it = iter(segments)
        seg = next(it)
        for i, e in enumerate(events):
            while i >= seg[2]:
                seg = next(it)
            charges.append((seg[0], e[2] - e[1], e[0]))
    return charges, n_replays, unmatched


def profile_events(prof) -> tuple[list, list]:
    """(device, host) event tuples of a finished `torch.profiler` profile, as
    `charge_events` takes them (read from the Kineto results: building
    `prof.events()` takes ~0.1 ms of Python an event)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.name().startswith(SPAN_PREFIX):  # a span's own annotation
                device.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id(),
                               e.linked_correlation_id()))
        else:
            host.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
    return device, host


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
