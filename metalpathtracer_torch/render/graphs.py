"""The integrators' device-resident loops: each window of wavefront advances
and each block of scan bounce steps as one CUDA graph, captured once per
render shape and replayed.

Counterpart of the reference's jitted loops (`_render_wavefront_jit` and
`_render_pass` in `metalpathtracer_tpu/render/pipeline.py`, `accumulate`,
and its sharding module's jit builders). XLA compiles a whole render into
one device program; here each feed window and drain block of
`trace_wavefront`, and each sample's start, bounce blocks and end of the
scan (`trace`, `render_tile`), is captured as a `torch.cuda.CUDAGraph` and
replayed, so the host issues one launch a function instead of some 400 a
bounce step, and reads the loop condition once a window or block.

An `Entry` holds what one render shape keeps between calls: a `program`
(the integrator's `_Wavefront` or `_Scan`), whose functions read and write
its static buffers alone and leave what the host reads in
`program.report`, and on the card one graph per function, all in one
memory pool. Entries live in a small LRU cache (`entry`); on the CPU they
hold no graph and run their functions eagerly, which is what the tests
run. A program whose `capturable` is false (its cfg names the BVH walk,
which reads the host on every level) runs eagerly on the card too, by that
flag alone: no capture is tried.

`Entry.run(name)` on the card:
- the first call of a function runs it eagerly on a side stream: the
  warm-up PyTorch's CUDA-graph notes ask for before a capture (the kernels'
  nvcc builds and first loads finish there), and real work;
- the second call captures it and replays the capture, every later call
  replays it;
- a capture that fails raises, and the entry is dropped: nothing falls
  back to the eager loop or to the CPU.
Under `eager()` every call runs eagerly, for comparison. Every eager run
(the CPU's, `eager()`'s, a warm-up, a program that is not capturable)
counts in `STATS["eager_runs"]`.

A replay runs no Python. The kernel wrappers' counters see the warm-up
and the capture alone; the kernels' device tallies (`kernels/_build.py`)
count every launch a replay makes. The cache key holds no function: a
caller who swaps a function that a window looks up on its module (a
comparison with a plain version, a count of bounce steps) calls `clear()`
before and after, so that no graph traced with the swap outlives it.

`STATS` counts captures (and their seconds), replays and the graph nodes
they ran (`replayed_ops`: each replay adds its graph's node count, no
device read), eager runs, host reads, the scan's idle steps (bounce steps
a block ran with no live lane, which the eager loop does not run), the
bounce steps traced through the plain shading with next-event estimation
(`nee_steps`: run eagerly or traced into a capture; the shading kernel
runs every other step) and the ray-sphere tests handed to the sphere pass
(`sphere_tests`: lanes times sphere-table rows a call, which the
integrator adds as it calls the closest hit) since it was last zeroed;
`chip_smoke.py` and the benchmark read it. What a captured function adds
to `sphere_tests` is kept as its graph's count and added at each replay
instead, with no device read and no graph node.

Every run opens the span `graphs.run.<fn>` and every read
`graphs.read.<fn>` (`utils/metrics.py::span`; `<fn>`: the function whose
report it reads). A replay runs no Python, so the spans inside the
functions exist only while they run eagerly or are captured: during a
capture each span marks the graph nodes its code captured (the driver's
node count of the capturing stream), and the entry keeps, for each
captured function, its node count and that map (`span_maps`), through
which `metrics.charge_events` charges a replay's device events to the
spans that launched them.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time

import torch

from metalpathtracer_torch.utils import metrics

# Entries kept. Every entry point reuses one shape at a time: progressive
# steps, viewer frames until a resize, repeated renders of one scene, a
# rank's shard. A caller that renders one scene on both integrators (an
# image of one checked against the other's) keeps a scan entry and a
# wavefront entry in use side by side. A new shape or scene (a resized
# viewer, each in-process `cli.main`, which uploads its scene anew) makes a
# new entry, and the one before it is stale. An entry holds its scene's
# tables and its graph memory on the device: a flagship scan entry
# (921,600 lanes) reserved 618-642 MiB on an H100, a viewer scan frame's
# 74-86 MiB (PERF.md). Four keep both integrators' shapes in use and the
# ones before them (a viewer resized and back), under 3 GB.
CACHE_SIZE = 4

STATS = dict(captures=0, capture_s=0.0, replays=0, replayed_ops=0, eager_runs=0,
             reads=0, idle_steps=0, nee_steps=0, sphere_tests=0)

_cache: collections.OrderedDict = collections.OrderedDict()
_eager = [0]  # depth of nested `eager()` blocks


@contextlib.contextmanager
def eager():
    """Run every window eagerly on the card, as the CPU does: the eager
    loop that the graphs are compared with."""
    _eager[0] += 1
    try:
        yield
    finally:
        _eager[0] -= 1


def clear() -> None:
    """Drop every entry (its buffers and graphs)."""
    _cache.clear()


def zero_stats() -> None:
    STATS.update(captures=0, capture_s=0.0, replays=0, replayed_ops=0, eager_runs=0,
                 reads=0, idle_steps=0, nee_steps=0, sphere_tests=0)


def span_maps() -> dict:
    """{"graphs.run.<fn>": {node count: segments}} of every cached entry's
    captured functions (`metrics.CaptureSpans`): what `metrics.charge_events`
    reads a replay's device events through. Two entries whose function has
    one node count share a map (the same shape of work)."""
    out: dict = {}
    for made in _cache.values():
        for name, (count, segments) in made.nodes.items():
            out.setdefault("graphs.run." + name, {})[count] = segments
    return out


@functools.cache
def _driver():
    """The CUDA driver's capture info and graph node count, through ctypes
    (torch binds neither)."""
    lib = ctypes.CDLL("libcuda.so.1")
    get = lib.cuStreamGetCaptureInfo_v2  # stream, status, id, graph, deps, count
    get.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p]
    get.restype = ctypes.c_int
    nodes = lib.cuGraphGetNodes  # graph, nodes (null: count only), count
    nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    nodes.restype = ctypes.c_int
    return get, nodes


def captured_nodes(device) -> int:
    """The number of nodes captured so far into the graph that `device`'s
    current stream is capturing."""
    get, nodes = _driver()
    status, graph, count = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_size_t()
    rc = get(torch.cuda.current_stream(device).cuda_stream, ctypes.byref(status),
             None, ctypes.byref(graph), None, None)
    if rc != 0 or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"no capture to count: CUDA driver error {rc}, "
                           f"capture status {status.value}")
    rc = nodes(graph, None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA driver error {rc}")
    return count.value


def entry(key, owner, build) -> "Entry":
    """The cached entry of (`owner`, `key`), now the most recently used, or a
    new one of `build()`'s program. `owner` (the scene) is matched by
    identity; the entry holds it, so its id is no other object's while the
    entry lives."""
    full = (id(owner), key)
    found = _cache.get(full)
    if found is not None:
        _cache.move_to_end(full)
        return found
    made = Entry(owner, build())
    _cache[full] = made
    while len(_cache) > CACHE_SIZE:
        _cache.popitem(last=False)
    return made


class Entry:
    """One render shape: its program (static buffers and the functions on
    them) and, on the card, a graph of each function run so far."""

    def __init__(self, owner, program):
        self.owner = owner
        self.program = program
        self.device = program.report.device
        self.graphs: dict = {}  # name -> CUDAGraph
        # name -> (node count, span segments) of its graph (`span_maps`)
        self.nodes: dict = {}
        self.sphere_tests: dict = {}  # name -> its graph's count of them
        self.warm: set = set()
        self.pool = None
        self.last = None  # the function run last: whose report `read` reads

    def replayed(self) -> bool:
        """Whether `run` captures and replays: on the card, outside
        `eager()`, for a capturable program."""
        return (self.device.type == "cuda" and not _eager[0]
                and self.program.capturable)

    def run(self, name: str) -> None:
        self.last = name
        with metrics.span("graphs.run." + name):
            fn = getattr(self.program, name)
            if not self.replayed():
                STATS["eager_runs"] += 1
                fn()
                return
            with torch.cuda.device(self.device):
                if name not in self.graphs:
                    if name not in self.warm:
                        self._warm_up(fn)
                        self.warm.add(name)
                        return
                    self._capture(name, fn)
                self.graphs[name].replay()
            STATS["replays"] += 1
            STATS["replayed_ops"] += self.nodes[name][0]
            STATS["sphere_tests"] += self.sphere_tests[name]

    def read(self) -> list:
        """The program's report on the host: the one read of a window or
        block."""
        with metrics.span("graphs.read." + self.last):
            STATS["reads"] += 1
            return self.program.report.tolist()

    def _warm_up(self, fn) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)
        STATS["eager_runs"] += 1

    def _capture(self, name: str, fn) -> None:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        tests = STATS["sphere_tests"]
        try:
            with torch.cuda.graph(graph, pool=self.pool), metrics.capture_spans(
                    "graphs.run." + name, lambda: captured_nodes(self.device)) as spans:
                fn()
                nodes = spans.close()
        except BaseException:
            for key, value in list(_cache.items()):
                if value is self:
                    del _cache[key]
            raise
        finally:
            tests, STATS["sphere_tests"] = STATS["sphere_tests"] - tests, tests
        self.graphs[name] = graph
        self.nodes[name] = nodes
        self.sphere_tests[name] = tests
        STATS["captures"] += 1
        STATS["capture_s"] += time.perf_counter() - t0
