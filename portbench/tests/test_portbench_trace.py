"""The reduction of a profile to per-layer metrics, on a recorded trace:
two scan passes of the reference scene at 160x90 on an H100
(`data/trace_scan_160x90.json`)."""

import json
import re
from pathlib import Path

import pytest

from harness import manifest, trace

DATA = Path(__file__).resolve().parent / "data" / "trace_scan_160x90.json"


@pytest.fixture(scope="module")
def recorded():
    d = json.loads(DATA.read_text())
    dev = [tuple(r) for r in d["device"]]
    host = [tuple(r) for r in d["host"]]
    return dev, host, 0, max(e for _, _, e in dev)


def test_every_device_ns_is_charged_once(recorded):
    dev, _, _, _ = recorded
    got = trace.charge(dev, manifest.layers())
    assert sum(got.values()) == sum(e - s for _, s, e in dev)
    hit = sum(e - s for n, s, e in dev
              if re.search(r"mm_closest_hit_kernel|cull_tiles_kernel|hit_front_kernel", n))
    step = sum(e - s for n, s, e in dev if re.search(r"threefry_kernel|shade_hit_kernel", n))
    assert got["hit"] == hit > 0
    assert got["step"] == step > 0
    assert got["shard"] == 0
    assert got["unclaimed"] > 0  # torch's sorts, copies, fills and reductions


def test_busy_is_the_union(recorded):
    dev, _, lo, hi = recorded
    spans = trace.merged(dev)
    assert all(a[1] < b[0] for a, b in zip(spans, spans[1:]))
    busy = trace.busy_ns(dev)
    assert 0 < busy <= sum(e - s for _, s, e in dev)
    assert busy <= hi - lo


def test_idle_gaps_cover_the_idle_time(recorded):
    dev, host, lo, hi = recorded
    gaps = trace.idle_gaps(dev, host, lo, hi, n=1000)
    assert sum(s for _, s in gaps) * 1e9 == pytest.approx(hi - lo - trace.busy_ns(dev))
    assert all(k.startswith(("portbench/pass", "(no range)")) for k, _ in gaps)
    top = trace.idle_gaps(dev, host, lo, hi)
    assert len(top) <= 10 and [s for _, s in top] == sorted((s for _, s in top),
                                                            reverse=True)


def test_top_ops(recorded):
    dev, _, _, _ = recorded
    top = trace.top_ops(dev)
    assert len(top) == 10
    assert top[0][0] == "mm_closest_hit_kernel"
    assert [s for _, s in top] == sorted((s for _, s in top), reverse=True)
    assert trace.kernel_label("void at::native::foo<int>(int, float)") == "foo<int>"


def test_clip():
    rows = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30)]
    assert trace.clip(rows, 8, 22) == [("a", 8, 10), ("b", 8, 15), ("c", 20, 22)]


def _readers():
    spec = manifest.load_json(manifest.REPO / "BENCHMARK.json")
    cell = manifest.Cell(spec, "reference.scan_720p")
    return cell, {m["name"]: cell.reader(m["name"]) for m in cell.per_layer}


def test_the_metric_readers_on_the_recorded_trace(recorded):
    dev, host, lo, hi = recorded
    cell, readers = _readers()
    ctx = trace.Context(2, {"reads": 10}, 2, dev, host, lo, hi, manifest.layers())
    got = {k: f(ctx) for k, f in readers.items()}
    assert got["graphs.reads_per_pass"] == 5.0
    assert got["hit.device_ms_per_pass"] == pytest.approx(ctx.layer_ns["hit"] / 2e6)
    assert got["step.device_ms_per_pass"] == pytest.approx(ctx.layer_ns["step"] / 2e6)
    assert got["torchops.device_ms_per_pass"] == pytest.approx(
        ctx.layer_ns["unclaimed"] / 2e6)
    assert 0 < got["device.idle_pct"] < 100
    nccl = cell.reader("shard.nccl_ms_per_pass") if (
        manifest.ROOT / "metrics" / "shard.nccl_ms_per_pass.py").exists() else None
    if nccl is not None:
        assert nccl(ctx) is None  # one card: no nccl kernel to read


def test_a_reader_with_nothing_to_read_returns_nothing():
    _, readers = _readers()
    ctx = trace.Context(3, {"reads": 6}, 0, [], [], 0, 0, manifest.layers())
    got = {k: f(ctx) for k, f in readers.items()}
    assert got.pop("graphs.reads_per_pass") == 2.0
    assert all(v is None for v in got.values())


def test_innermost_is_the_shortest_open_row(recorded):
    """The sweep against a plain scan of every row at every gap's middle."""
    dev, host, lo, hi = recorded
    ops = [r for r in host if not r[0].startswith(trace.ANNOTATION_PREFIXES)]
    points = sorted({(s + e) // 2 for _, s, e in dev} | {lo, hi})
    for at, got in zip(points, trace.innermost(ops, points)):
        open_ = [r for r in ops if r[1] <= at < r[2]]
        assert got == (min(open_, key=lambda r: r[2] - r[1]) if open_ else None)
