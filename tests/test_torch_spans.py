"""The program's spans (`utils/metrics.py::span`) on the CPU: the ranges a
profiled progressive pass opens on each integrator, their nesting and the
first sample id the entries carry; that an unprofiled span costs no range
and no CUDA call; the capture-time span map (`CaptureSpans`) on a stand-in
node count; and `charge_events`, which charges a profile's device events to
the spans that launched them, on synthetic event tuples. The card's side
(replays against their capture-time maps) is in tests/test_torch_cuda.py.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metalpathtracer_torch.parallel import sharding as sh
from metalpathtracer_torch.render import graphs
from metalpathtracer_torch.render import pipeline as tpipe
from metalpathtracer_torch.render.camera import Camera
from metalpathtracer_torch.render.device_scene import upload_scene
from metalpathtracer_torch.render.integrator import RenderConfig
from metalpathtracer_torch.scene import presets
from metalpathtracer_torch.utils import metrics

torch.set_num_threads(1)

CFG = RenderConfig(max_depth=3)
W, H = 48, 32  # 3,072 paths a pass through 2,048 lanes: the wavefront drains
# the spans a pass opens outside the captured functions, and around each
# run and read, on each entry
FIXED = {
    "scan": {"entry.accumulate", "scan.begin", "scan.result", "entry.to_image",
             "graphs.run.start_sample", "graphs.run.bounce_block",
             "graphs.read.bounce_block", "graphs.run.end_sample"},
    "wavefront": {"entry.accumulate_wavefront", "wavefront.start",
                  "wavefront.compact", "wavefront.flush", "entry.to_image",
                  "graphs.run.window", "graphs.read.window",
                  "graphs.run.drain_block", "graphs.read.drain_block"},
    "sharded": {"entry.accumulate_sharded", "wavefront.start", "wavefront.compact",
                "wavefront.flush", "entry.to_image", "graphs.run.window",
                "graphs.read.window"},
}


@pytest.fixture(scope="module")
def scene():
    return upload_scene(presets.cornell_mesh(subdivisions=1), "cpu")


@pytest.fixture(autouse=True)
def _fresh_cache():
    graphs.clear()
    graphs.zero_stats()
    yield
    graphs.clear()


def _pass(kind, scene, state):
    cam = Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
    if kind == "scan":
        return tpipe.accumulate(state, scene, cam, W, H, 2, 7, CFG)
    if kind == "wavefront":
        return tpipe.accumulate_wavefront(state, scene, cam, W, H, 2, 7, CFG, 2048)[0]
    return sh.accumulate_sharded(state, scene, cam, 2, 7, CFG, sh.make_mesh(), 1024)[0]


@pytest.mark.parametrize("kind", sorted(FIXED))
def test_a_profiled_pass_opens_the_fixed_spans(scene, kind, monkeypatch):
    """Two passes under the profiler: each opens its entry's spans, every
    read nests in the entry span, and each entry span carries the pass's
    first sample id as its args (`to_image` the samples it resolves)."""
    args = []

    class Recorded(torch.profiler.record_function):
        def __init__(self, name, a=None):
            args.append((name, a))
            super().__init__(name, a)

    monkeypatch.setattr(torch.profiler, "record_function", Recorded)
    state = tpipe.init_accum(W, H, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state = _pass(kind, scene, state)
            tpipe.to_image(state)
    ranges = [(e.start_ns(), e.end_ns(), e.name()[len(metrics.SPAN_PREFIX):])
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(metrics.SPAN_PREFIX)]
    names = {r[2] for r in ranges}
    assert FIXED[kind] <= names
    entries = [r for r in ranges if r[2].startswith("entry.accumulate")]
    assert len(entries) == 2
    reads = [r for r in ranges if r[2].startswith("graphs.")]
    assert reads and all(any(e[0] <= r[0] and r[1] <= e[1] for e in entries)
                         for r in reads)
    carried = [(n[len(metrics.SPAN_PREFIX):], a) for n, a in args
               if n.startswith(metrics.SPAN_PREFIX + "entry.")]
    entry = {"scan": "entry.accumulate", "wavefront": "entry.accumulate_wavefront",
             "sharded": "entry.accumulate_sharded"}[kind]
    assert carried == [(entry, "0"), ("entry.to_image", "2"),
                       (entry, "2"), ("entry.to_image", "4")]
    assert graphs.STATS["replayed_ops"] == graphs.STATS["replays"] == 0


def test_an_unprofiled_span_opens_no_range_and_calls_no_cuda(scene, monkeypatch):
    """Without a profiler `span` is a null context: no `record_function`,
    no CUDA call, no node count; a whole pass runs so."""
    def refuse(*a, **k):
        raise AssertionError("called without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for name in ("current_stream", "synchronize", "Stream", "Event", "graph",
                 "device", "is_current_stream_capturing"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(graphs, "captured_nodes", refuse)
    assert not torch.autograd._profiler_enabled()
    with metrics.span("entry.accumulate", "0") as opened:
        assert opened is None
    assert isinstance(metrics.span("graphs.run.window"), contextlib.nullcontext)
    state = _pass("wavefront", scene, tpipe.init_accum(W, H, "cpu"))
    tpipe.to_image(state)
    assert state.spp == 2


def test_capture_spans_map_every_node_to_its_innermost_span():
    """The map of one capture on a stand-in node count: nodes before, between
    and after the inner spans belong to the root, nested spans take their
    own nodes, and a span that captured nothing leaves no segment."""
    nodes = [0]

    def add(k):
        nodes[0] += k

    with metrics.capture_spans("graphs.run.window", lambda: nodes[0]) as spans:
        add(2)
        with metrics.span("hit.front"):
            add(3)
            with metrics.span("hit.mm_closest_hit"):
                add(1)
            add(1)
        with metrics.span("step.draws"):
            pass
        with metrics.span("wavefront.queue"):
            add(4)
        add(1)
        count, segments = spans.close()
    assert metrics._capture[0] is None
    assert count == 12
    assert segments == [("graphs.run.window", 0, 2), ("hit.front", 2, 5),
                        ("hit.mm_closest_hit", 5, 6), ("hit.front", 6, 7),
                        ("wavefront.queue", 7, 11), ("graphs.run.window", 11, 12)]
    # an exception inside the capture clears the flag
    with pytest.raises(RuntimeError):
        with metrics.capture_spans("graphs.run.window", lambda: 0):
            raise RuntimeError("capture failed")
    assert metrics._capture[0] is None
    assert isinstance(metrics.span("hit.front"), contextlib.nullcontext)


def test_stats_count_replayed_ops_from_import():
    """The counter is in STATS before any replay (the benchmark diffs the
    keys it sees before its window) and `zero_stats` zeroes it; `span_maps`
    gathers every cached entry's maps by run span and node count."""
    assert "replayed_ops" in graphs.STATS
    graphs.STATS["replayed_ops"] += 5
    graphs.zero_stats()
    assert graphs.STATS["replayed_ops"] == 0

    class Made:
        def __init__(self, nodes):
            self.nodes = nodes

    seg_a, seg_b = [("graphs.run.window", 0, 3)], [("hit.front", 0, 4)]
    graphs._cache[("a",)] = Made({"window": (3, seg_a)})
    graphs._cache[("b",)] = Made({"window": (4, seg_b), "drain_block": (4, seg_b)})
    assert graphs.span_maps() == {"graphs.run.window": {3: seg_a, 4: seg_b},
                                  "graphs.run.drain_block": {4: seg_b}}


# ---------------------------------------------------------------------------
# charge_events on synthetic tuples: host (name, start, end, correlation),
# device (name, start, end, correlation, linked correlation)
# ---------------------------------------------------------------------------

MAPS = {"graphs.run.window": {3: [("graphs.run.window", 0, 1), ("hit.front", 1, 2),
                                   ("wavefront.queue", 2, 3)]}}
HOST = [("mpt/entry.accumulate_wavefront", 0, 1000, 1),
        ("mpt/graphs.run.window", 100, 200, 2),
        ("cudaGraphLaunch", 110, 150, 7),
        ("mpt/graphs.read.window", 200, 400, 3),
        ("cudaMemcpyAsync", 210, 390, 8),
        ("mpt/wavefront.flush", 500, 600, 4),
        ("aten::index_add_", 510, 560, 9),
        ("cudaLaunchKernel", 520, 530, 10)]


def _sums(charges):
    out = {}
    for span_name, ns, _ in charges:
        out[span_name] = out.get(span_name, 0) + ns
    return out


def test_a_replay_is_charged_through_its_map():
    """Three events of one launch, out of order in the list: by start they
    are nodes 0, 1, 2, each charged to its node's span."""
    device = [("k_queue", 180, 190, 7, 0), ("k_front", 160, 175, 7, 0),
              ("k_first", 152, 158, 7, 0), ("Memcpy DtoH", 385, 388, 8, 0)]
    charges, replays, unmatched = metrics.charge_events(device, HOST, MAPS)
    assert (replays, unmatched) == (1, 0)
    assert sorted(charges) == sorted([("graphs.run.window", 6, "k_first"),
                                      ("hit.front", 15, "k_front"),
                                      ("wavefront.queue", 10, "k_queue"),
                                      ("graphs.read.window", 3, "Memcpy DtoH")])


def test_a_replay_off_its_node_count_is_charged_whole_to_its_run():
    """Two events where the map holds three (a record lost): the replay
    goes whole to `graphs.run.window`, counted unmatched; a launch under no
    run span is no replay of the program."""
    device = [("k_front", 160, 175, 7, 0), ("k_queue", 180, 190, 7, 0),
              ("k_other", 1110, 1120, 11, 0)]
    host = HOST + [("cudaGraphLaunch", 1100, 1105, 11)]
    charges, replays, unmatched = metrics.charge_events(device, host, MAPS)
    assert (replays, unmatched) == (1, 1)
    assert _sums(charges) == {"graphs.run.window": 25, metrics.NO_SPAN: 10}


def test_eager_events_are_charged_by_correlation():
    """An eager kernel goes to the span open at its runtime call; one with
    no runtime call to the span open at the operation it is linked to; one
    linked to nothing, and the device copies of the spans' own annotations,
    to no span / nowhere."""
    device = [("index_add_kernel", 540, 545, 10, 9),
              ("fill_kernel", 570, 575, 99, 9),
              ("orphan_kernel", 800, 805, 98, 97),
              ("mpt/wavefront.flush", 500, 600, 0, 0)]
    charges, replays, unmatched = metrics.charge_events(device, HOST, MAPS)
    assert (replays, unmatched) == (0, 0)
    assert sorted(charges) == sorted([("wavefront.flush", 5, "index_add_kernel"),
                                      ("wavefront.flush", 5, "fill_kernel"),
                                      (metrics.NO_SPAN, 5, "orphan_kernel")])
