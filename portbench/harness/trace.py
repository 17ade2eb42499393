"""Reading a `torch.profiler` trace of the window's passes.

The profiler records the device's kernels, copies and fills (CUPTI, also
inside CUDA graph replays) and the host's operations. The harness marks
its own stretches on the host with `record_function` ranges named
`portbench/...`; the program marks its eager code with `mpt/...` ranges.
Both also appear as annotations on the device's timeline and are not
device work.

Events are reduced to plain tuples (name, start ns, end ns), so that the
reductions below run on a recorded trace as well (`tests/data`).
"""

from __future__ import annotations

import heapq
import re

ANNOTATION_PREFIXES = ("portbench/", "mpt/", "ProfilerStep")


def events(prof) -> dict:
    """{"device": [(name, start, end)], "host": [(name, start, end)]} of a
    finished profile, host ranges of the harness included."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        row = (name, e.start_ns(), e.end_ns())
        if e.device_type() == cuda:
            if not name.startswith(ANNOTATION_PREFIXES):
                dev.append(row)
        else:
            host.append(row)
    return {"device": sorted(dev, key=lambda r: r[1]),
            "host": sorted(host, key=lambda r: r[1])}


def clip(rows, lo: int, hi: int):
    """The rows inside [lo, hi], cut to it."""
    return [(n, max(s, lo), min(e, hi)) for n, s, e in rows if e > lo and s < hi]


def merged(rows):
    """The union of the rows' intervals, as sorted disjoint (start, end)."""
    out = []
    for _, s, e in sorted(rows, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_ns(rows) -> int:
    return sum(e - s for s, e in merged(rows))


def charge(rows, layers: dict) -> dict:
    """Device ns of each layer (the first layer, in name order, one of whose
    patterns finds the event's name) and of "unclaimed" events."""
    out = {k: 0 for k in layers}
    out["unclaimed"] = 0
    keys: dict = {}  # a name's layer, matched once a name
    for name, s, e in rows:
        if name not in keys:
            keys[name] = next((k for k, pats in layers.items()
                               if any(p.search(name) for p in pats)), "unclaimed")
        out[keys[name]] += e - s
    return out


def kernel_label(name: str) -> str:
    """A device event's name, short: no return type, namespaces or
    parameter list."""
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"\(anonymous namespace\)::|at::native::|at_cuda_detail::|c10::|"
                  r"std::|cub::[A-Za-z_]*::", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i][:120]
    return name[:120]


def top_ops(rows, n: int = 10):
    """[[kernel, seconds], ...] of the n names with the most device time."""
    total: dict = {}
    for name, s, e in rows:
        key = kernel_label(name)
        total[key] = total.get(key, 0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in ranked]


def innermost(rows, points):
    """For each of the ascending `points`, the shortest of `rows` open at it
    (start <= point < end; of equal ones the first in `rows`), or None: one
    sweep, so that a trace of a few hundred thousand events reads in
    seconds."""
    order = sorted(range(len(rows)), key=lambda i: rows[i][1])
    heap, out, k = [], [], 0
    for at in points:
        while k < len(order) and rows[order[k]][1] <= at:
            i = order[k]
            heapq.heappush(heap, (rows[i][2] - rows[i][1], i))
            k += 1
        while heap and rows[heap[0][1]][2] <= at:  # closed: closed for later points too
            heapq.heappop(heap)
        out.append(rows[heap[0][1]] if heap else None)
    return out


def idle_gaps(device_rows, host_rows, lo: int, hi: int, n: int = 10):
    """[[what the host was doing, seconds], ...]: the device's idle time in
    [lo, hi], each gap charged to the harness range and the innermost host
    operation open at its middle, summed by that label, the n largest."""
    busy = merged(device_rows)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    ranges = [r for r in host_rows if r[0].startswith("portbench/")]
    ops = [r for r in host_rows if not r[0].startswith(ANNOTATION_PREFIXES)]
    mids = [(s + e) // 2 for s, e in gaps]
    total: dict = {}
    for (s, e), where, inner in zip(gaps, innermost(ranges, mids), innermost(ops, mids)):
        label = where[0] if where else "(no range)"
        if inner:
            label += " > " + inner[0]
        total[label] = total.get(label, 0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in ranked]


class Context:
    """What a per-layer metric's reader reads: the window's passes and the
    program's counters over them, and of the profiled stretch its passes,
    device events and length, with each layer's device time."""

    def __init__(self, passes: int, stats: dict, profiled_passes: int = 0,
                 device_rows=None, host_rows=None, lo: int = 0, hi: int = 0,
                 layers: dict | None = None):
        self.passes = passes
        self.stats = stats
        self.profiled_passes = profiled_passes
        self.device = clip(device_rows or [], lo, hi)
        self.host = host_rows or []
        self.window_ns = hi - lo
        self.layer_ns = charge(self.device, layers or {})
        self.busy_ns = busy_ns(self.device)

    @property
    def traced(self) -> bool:
        """Whether the profile holds device work to read."""
        return self.profiled_passes > 0 and bool(self.device)

    def layer_ms_per_pass(self, layer: str):
        """Device ms a profiled pass of `layer`'s kernels, or None where the
        profile holds none of them."""
        if not self.traced or not self.layer_ns.get(layer):
            return None
        return self.layer_ns[layer] / 1e6 / self.profiled_passes
