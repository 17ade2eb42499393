"""The device's idle time split by the program's spans (`harness/spans.py`)
and the readers of the four metrics that read the spans and the replay
counter, on a synthetic trace and on a recorded one: two wavefront passes
of the reference scene at 160x90 on an H100, graph path, with the
program's spans (`data/trace_wavefront_160x90.json`)."""

import json
from pathlib import Path

import pytest

from harness import manifest, spans, trace

DATA = Path(__file__).resolve().parent / "data" / "trace_wavefront_160x90.json"
NEW = ("graphs.launch_idle_ms_per_pass", "graphs.read_idle_ms_per_pass",
       "entry.host_idle_ms_per_pass", "graphs.replayed_ops_per_pass")
IDLE = {"launch": "graphs.launch_idle_ms_per_pass", "read": "graphs.read_idle_ms_per_pass",
        "entry": "entry.host_idle_ms_per_pass"}

# one pass of 1,000 ns: the device busy 0-120, 150-300, 480-620, 950-980
DEVICE = [("k_a", 0, 120), ("k_b", 150, 300), ("k_c", 480, 620), ("k_d", 950, 980)]
HOST = [("portbench/pass", 0, 1000),
        ("mpt/entry.accumulate_wavefront", 50, 900),
        ("mpt/graphs.run.window", 100, 200), ("cudaGraphLaunch", 110, 190),
        ("mpt/graphs.read.window", 200, 400), ("cudaMemcpyAsync", 210, 390),
        ("mpt/graphs.run.window", 400, 450),
        ("mpt/graphs.read.window", 450, 500),
        ("mpt/wavefront.flush", 600, 700), ("aten::index_add_", 610, 690)]
# the idle 120-150 in a run; 300-400 read, 400-450 run, 450-480 read;
# 620-700 flush, 700-900 the entry; 900-950 and 980-1000 outside
WANT = {"launch": 80, "read": 130, "entry": 280, "outside": 70}


def _readers():
    spec = manifest.load_json(manifest.REPO / "BENCHMARK.json")
    cell = manifest.Cell(spec, "reference.wavefront_720p")
    return {m: cell.reader(m) for m in NEW}


def _ctx(device, host, passes, stats):
    lo, hi = spans.stretch(host)
    return trace.Context(passes, stats, passes, device, host, lo, hi, manifest.layers())


@pytest.fixture(scope="module")
def recorded():
    d = json.loads(DATA.read_text())
    return ([tuple(r) for r in d["device"]], [tuple(r) for r in d["host"]], d["stats"])


def test_the_split_of_a_synthetic_pass():
    assert spans.idle_split(DEVICE, HOST, 0, 1000) == WANT
    assert sum(WANT.values()) == 1000 - trace.busy_ns(DEVICE)


def test_a_span_open_at_a_gap_boundary_and_nested_spans():
    """A gap that starts inside one span and ends inside another is cut at
    the boundary; where spans nest, the latest started one takes the piece,
    and its end hands it back to the one around it."""
    host = [("portbench/pass", 0, 100), ("mpt/entry.accumulate", 0, 100),
            ("mpt/graphs.read.bounce_block", 10, 40),
            ("mpt/graphs.run.bounce_block", 40, 60)]
    got = spans.idle_split([("k", 0, 20), ("k", 50, 100)], host, 0, 100)
    assert got == {"launch": 10, "read": 20, "entry": 0, "outside": 0}
    got = spans.idle_split([("k", 0, 5)], host, 0, 100)
    assert got == {"launch": 20, "read": 30, "entry": 45, "outside": 0}
    # a span that opens with the one around it, listed first, is still inner
    host = [("portbench/pass", 0, 100), ("mpt/graphs.read.window", 0, 30),
            ("mpt/entry.accumulate_wavefront", 0, 100)]
    got = spans.idle_split([], host, 0, 100)
    assert got == {"launch": 0, "read": 30, "entry": 70, "outside": 0}


@pytest.mark.parametrize("data", ["synthetic", "recorded"])
def test_the_classes_add_up_to_the_idle_time(recorded, data):
    """The three idle metrics and the idle outside every span equal the idle
    time `device.idle_pct` reads, each nanosecond once."""
    device, host, stats = (DEVICE, HOST, {"replayed_ops": 30}) if data == "synthetic" \
        else recorded
    passes = sum(r[0] == "portbench/pass" for r in host)
    ctx = _ctx(device, host, passes, stats)
    idle_pct = manifest.Cell(manifest.load_json(manifest.REPO / "BENCHMARK.json"),
                             "reference.wavefront_720p").reader("device.idle_pct")(ctx)
    idle_ns = idle_pct / 100 * ctx.window_ns
    split = spans.context_split(ctx)
    assert sum(split.values()) == ctx.window_ns - ctx.busy_ns
    readers = _readers()
    got = {cls: readers[m](ctx) for cls, m in IDLE.items()}
    assert all(v is not None and v >= 0 for v in got.values())
    total = sum(got.values()) * 1e6 * passes + split["outside"]
    assert total == pytest.approx(idle_ns, rel=1e-9)
    if data == "synthetic":
        assert got == {k: WANT[k] / 1e6 for k in IDLE}


def test_the_recorded_passes(recorded):
    """On the card's graph path the device waits in every class: the runs,
    the reads, and the entry's eager stages (at this size the largest); the
    counter reads the replays' nodes a pass."""
    device, host, stats = recorded
    ctx = _ctx(device, host, 2, stats)
    split = spans.context_split(ctx)
    assert min(split.values()) > 0 and split["entry"] > split["launch"] > split["read"]
    assert stats["replays"] == sum(r[0] == "cudaGraphLaunch" for r in host) > 0
    assert _readers()["graphs.replayed_ops_per_pass"](ctx) == stats["replayed_ops"] / 2


def test_readers_with_nothing_to_read_return_nothing(recorded):
    """No profile, a profile without the program's spans (a program before
    them), a profile with no harness pass range, counters without the key
    (the sharded harness's fixed keys): each new reader returns None."""
    readers = _readers()
    device, host, _ = recorded
    empty = trace.Context(3, {"reads": 6}, 0, [], [], 0, 0, manifest.layers())
    assert all(readers[m](empty) is None for m in NEW)
    older = [r for r in host if not r[0].startswith(("mpt/graphs.", "mpt/entry."))]
    ctx = _ctx(device, older, 2, {"reads": 24})
    assert all(readers[m](ctx) is None for m in NEW)
    passes = spans.stretch(host)
    unbounded = trace.Context(2, {}, 2, device, [r for r in host
                                                 if r[0] != "portbench/pass"],
                              *passes, manifest.layers())
    assert all(readers[m](unbounded) is None for m in NEW)
    assert spans.stretch([]) is None
