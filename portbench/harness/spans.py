"""The device's idle time in the profiled passes, split by the program's
host spans.

The program opens `torch.profiler.record_function` ranges named `mpt/...`
around its entries, their eager stages, each graph run (`graphs.run.<fn>`)
and each host read of its loop state (`graphs.read.<fn>`). Each idle gap of
the device in the profiled stretch (from the first harness pass range's
start to the last one's end: the stretch `device.idle_pct` reads) is cut at
the boundaries of those spans, and each piece is charged to the class of
the innermost span open then:

- "launch": a `graphs.run.*` span (a replay's launch; an eager run);
- "read": a `graphs.read.*` span (the read's wait and copy, and the
  device's ramp after a launch that has returned);
- "entry": any other program span (the progressive entries, their eager
  stages, `to_image`, and the loop's Python between its runs and reads);
- "outside": no program span (the harness's own time).

The four classes add up to the idle time, each nanosecond once. Rows are
the plain (name, start ns, end ns) tuples of `harness/trace.py`.
"""

from __future__ import annotations

from harness import trace

PREFIX = "mpt/"
CLASSES = ("launch", "read", "entry", "outside")
# the span names a class's metric needs in the trace to read anything
MARKS = {"launch": "mpt/graphs.run.", "read": "mpt/graphs.read.", "entry": "mpt/entry."}


def span_class(name: str) -> str:
    """The class of a program span (its full name, with PREFIX)."""
    if name.startswith(MARKS["launch"]):
        return "launch"
    if name.startswith(MARKS["read"]):
        return "read"
    return "entry"


def stretch(host_rows):
    """(lo, hi) of the profiled passes on the trace's clock, or None where
    the trace holds no harness pass range."""
    passes = [r for r in host_rows if r[0] == "portbench/pass"]
    if not passes:
        return None
    return min(r[1] for r in passes), max(r[2] for r in passes)


def gaps(device_rows, lo: int, hi: int) -> list:
    """The device's idle intervals in [lo, hi], sorted."""
    out, t = [], lo
    for s, e in trace.merged(trace.clip(device_rows, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def segments(host_rows) -> list:
    """(start, end, class) over the time the program's spans cover, sorted
    and disjoint: the class of the innermost span (the latest started of
    those open) on each piece between two span boundaries."""
    spans = [r for r in host_rows if r[0].startswith(PREFIX)]
    # closes before opens at one time; of spans opened at one time, the
    # outer (later ending) first
    marks = sorted([(s, 1, -e, i) for i, (_, s, e) in enumerate(spans)]
                   + [(e, 0, 0, i) for i, (_, _, e) in enumerate(spans)])
    out, open_, t = [], [], None
    for at, opens, _, i in marks:
        if open_ and at > t:
            out.append((t, at, span_class(spans[open_[-1]][0])))
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
        t = at
    return out


def idle_split(device_rows, host_rows, lo: int, hi: int) -> dict:
    """{class: idle ns in [lo, hi]} of CLASSES."""
    out = dict.fromkeys(CLASSES, 0)
    segs = segments(host_rows)
    k = 0
    for s, e in gaps(device_rows, lo, hi):
        covered = 0
        while k < len(segs) and segs[k][1] <= s:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < e:
            part = min(e, segs[j][1]) - max(s, segs[j][0])
            if part > 0:
                out[segs[j][2]] += part
                covered += part
            j += 1
        out["outside"] += (e - s) - covered
    return out


def context_split(ctx):
    """`idle_split` of a metric reader's context (`trace.Context`), computed
    once a context, or None where the profile holds no device work or no
    harness pass range, or its stretch is not the context's window."""
    if not ctx.traced:
        return None
    cached = getattr(ctx, "_idle_split", False)
    if cached is not False:
        return cached
    bounds = stretch(ctx.host)
    split = None
    if bounds is not None and bounds[1] - bounds[0] == ctx.window_ns:
        split = idle_split(ctx.device, ctx.host, *bounds)
    ctx._idle_split = split
    return split


def idle_ms_per_pass(ctx, cls: str):
    """Idle ms a profiled pass charged to `cls`, or None where the profile
    holds no span of the class's mark (a program without these spans) or
    nothing to split."""
    if not ctx.traced or not any(r[0].startswith(MARKS[cls]) for r in ctx.host):
        return None
    split = context_split(ctx)
    if split is None:
        return None
    return split[cls] / 1e6 / ctx.profiled_passes
