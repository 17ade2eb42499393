"""The wavefront's window functions on static buffers (`render/graphs.py`,
`integrator._Wavefront`) on the CPU, where every window and drain block
runs eagerly: the same functions the card captures as CUDA graphs. Also
the package's public surface against the reference's `__all__`.

Tolerances:
- against the JAX package's `trace_wavefront`: the bounds of the existing
  parity tests (tests/test_torch_wavefront.py, tests/test_torch_sharding.py):
  ray counts equal, images under 2% of pixels off by > 1e-3 with means
  within 5e-3;
- a cache entry reused with another camera or sample offset against a
  fresh entry, and the windows driven by hand against `trace_wavefront`:
  bit-equal (torch.equal), equal counters.
"""

import os

import numpy as np
import pytest
import torch

import metalpathtracer_torch.core as tcore
import metalpathtracer_torch.io as tio
import metalpathtracer_torch.render as trender
import metalpathtracer_torch.render.kernels as tkernels
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import device_scene as tds
from metalpathtracer_torch.render import graphs
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render import pipeline as tpipe
from metalpathtracer_torch.scene import presets
from metalpathtracer_tpu import core as jcore
from metalpathtracer_tpu import io as jio
from metalpathtracer_tpu import render as jrender
from metalpathtracer_tpu.render import pallas as jpallas
from metalpathtracer_tpu.core import rng as jrng
from metalpathtracer_tpu.render import camera as jcam
from metalpathtracer_tpu.render import integrator as jint
from metalpathtracer_tpu.scene import presets as jpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _cornell_cam(m, z=9.0):
    return m.Camera.look_at((0, 2.5, z), (0, 2.5, 0), vfov_deg=40.0)


@pytest.fixture(scope="module")
def cornell():
    return tds.upload_scene(presets.cornell_spheres(), "cpu")


@pytest.fixture(scope="module")
def cornell_mesh():
    scene = tds.upload_scene(presets.cornell_mesh(subdivisions=1), "cpu")
    assert scene.num_tris > 0 and scene.num_lights > 0
    return scene


@pytest.fixture(autouse=True)
def _fresh_cache():
    graphs.clear()
    graphs.zero_stats()
    yield
    graphs.clear()


# ---------------------------------------------------------------------------
# the window functions against the reference
# ---------------------------------------------------------------------------

# (width, height, spp, seed, cfg, pool, pixel range): the cases of the
# existing parity tests, tests/test_torch_wavefront.py and
# tests/test_torch_sharding.py
JAX_CASES = {
    "whole_image": (24, 24, 4, 5, dict(max_depth=6), 512, None),
    "pixel_range": (24, 24, 4, 5, dict(max_depth=6), 256, (288, 288)),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_windows_match_the_reference_trace_wavefront(cornell, case):
    w, h, spp, seed, cfg, pool, rng_ = JAX_CASES[case]
    offset, n_pix = rng_ or (0, None)
    mine, rays, _ = tint.trace_wavefront(
        cornell, _cornell_cam(tcam), w, h, spp, seed, tint.RenderConfig(**cfg),
        pool, pixel_offset=offset, n_pixels=n_pix)
    # every window and drain block ran eagerly, each followed by one read
    assert graphs.STATS["eager_runs"] == graphs.STATS["reads"] > 0
    assert graphs.STATS["captures"] == graphs.STATS["replays"] == 0
    theirs, j_rays = jint.trace_wavefront(
        jrender.upload_scene(jpresets.cornell_spheres()), _cornell_cam(jcam), w, h,
        spp, jrng.seed_from_int(seed), jint.RenderConfig(**cfg), pool,
        pixel_offset=offset, n_pixels=n_pix or w * h)
    mine, theirs = mine.numpy() / spp, np.asarray(theirs) / spp
    assert mine.shape == theirs.shape == ((n_pix or w * h), 3)
    assert np.isfinite(mine).all()
    assert (np.abs(mine - theirs) > 1e-3).mean() < 0.02
    assert abs(mine.mean() - theirs.mean()) < 5e-3
    assert rays == int(j_rays)


@pytest.mark.parametrize("pool", [256, 2048])
def test_windows_driven_by_hand_equal_trace_wavefront(cornell_mesh, pool):
    # pool 2048 > the drain width: the feed stops at 1,024 live lanes and the
    # drain blocks finish them
    cam, cfg = _cornell_cam(tcam), tint.RenderConfig(max_depth=5, nee=True)
    want, rays, stats = tint.trace_wavefront(cornell_mesh, cam, 48, 32, 2, 9, cfg, pool)
    wf = tint._Wavefront(cornell_mesh, 48, 32, 2, 9, cfg, pool, 0, 48 * 32, 1)
    wf.start(cam, 0)
    windows = blocks = 0
    while True:
        wf.window()
        windows += 1
        queued, live = wf.report[:2].tolist()
        if not (queued < wf.total or live > wf.drain_stop):
            break
    wf.compact()
    while wf.report[1] > 0:
        wf.drain_block()
        blocks += 1
    assert torch.equal(wf.flush(), want)
    assert wf.report[2].item() == rays and wf.report[3].item() == stats["shadow_rays"]
    assert wf.report[4].item() == stats["tile_passes"] > 0
    assert (blocks > 0) == (pool > tint.DRAIN_WIDTH)
    assert graphs.STATS["reads"] == windows + blocks


# ---------------------------------------------------------------------------
# the cache: what is reused, what makes a new entry
# ---------------------------------------------------------------------------

BASE = dict(width=24, height=16, spp=2, seed=3, cfg=tint.RenderConfig(max_depth=4),
            pool_size=128, sample_offset=0, pixel_offset=0, n_pixels=None)


def _trace(scene, cam, **kw):
    kw = dict(BASE, **kw)
    return tint.trace_wavefront(scene, cam, kw.pop("width"), kw.pop("height"),
                                kw.pop("spp"), kw.pop("seed"), kw.pop("cfg"),
                                kw.pop("pool_size"), **kw)


@pytest.mark.parametrize("change", [
    dict(cam=_cornell_cam(tcam, z=7.0)),
    dict(sample_offset=5),
    dict(cam=_cornell_cam(tcam, z=11.0), sample_offset=2),
])
def test_reused_entry_equals_a_fresh_one(cornell, change):
    change = dict(change)
    cam = change.pop("cam", _cornell_cam(tcam))
    _trace(cornell, _cornell_cam(tcam))
    assert len(graphs._cache) == 1
    (entry,) = graphs._cache.values()
    reused = _trace(cornell, cam, **change)
    assert len(graphs._cache) == 1 and next(iter(graphs._cache.values())) is entry
    graphs.clear()
    fresh = _trace(cornell, cam, **change)
    assert next(iter(graphs._cache.values())) is not entry
    assert torch.equal(reused[0], fresh[0])
    assert reused[1:] == fresh[1:]
    # the returned framebuffer is a copy: the next call does not touch it
    before = reused[0].clone()
    _trace(cornell, _cornell_cam(tcam))
    assert torch.equal(reused[0], before)


@pytest.mark.parametrize("change", [
    dict(seed=4), dict(width=16), dict(height=24), dict(spp=1), dict(pool_size=256),
    dict(cfg=tint.RenderConfig(max_depth=5)), dict(cfg=tint.RenderConfig(max_depth=4, nee=True)),
    dict(pixel_offset=192, n_pixels=192), dict(n_pixels=192),
])
def test_a_new_render_shape_makes_a_new_entry(cornell, change):
    _trace(cornell, _cornell_cam(tcam))
    _trace(cornell, _cornell_cam(tcam), **change)
    assert len(graphs._cache) == 2


def test_another_row_stride_makes_a_new_entry(cornell):
    # the same range length and first pixel, rows dealt instead of contiguous
    _trace(cornell, _cornell_cam(tcam), n_pixels=192)
    _trace(cornell, _cornell_cam(tcam), n_pixels=192, row_stride=2)
    assert len(graphs._cache) == 2


def test_another_scene_or_a_swapped_function_makes_a_new_entry(cornell, monkeypatch):
    _trace(cornell, _cornell_cam(tcam))
    other = tds.upload_scene(presets.cornell_spheres(), "cpu")
    _trace(other, _cornell_cam(tcam))
    assert len(graphs._cache) == 2
    # a capture replays the functions it traced and the key holds none: a
    # caller who swaps one on its module (as a comparison with a plain
    # version does) clears the cache, and the next call makes a new entry
    # that runs the swapped function
    step, calls = tint._bounce_step, []

    def counted(*a, **k):
        calls.append(1)
        return step(*a, **k)

    monkeypatch.setattr(tint, "_bounce_step", counted)
    graphs.clear()
    _trace(cornell, _cornell_cam(tcam))
    assert len(graphs._cache) == 1 and calls


def test_the_cache_keeps_the_most_recent_entries(cornell):
    for seed in range(graphs.CACHE_SIZE + 2):
        _trace(cornell, _cornell_cam(tcam), seed=seed)
    assert len(graphs._cache) == graphs.CACHE_SIZE
    seeds = [key[1][3] for key in graphs._cache]
    assert seeds == list(range(2, graphs.CACHE_SIZE + 2))


def test_an_entry_holds_its_scene():
    # the graphs read the scene's tensors, so the entry keeps them alive, and
    # with them the id its key holds
    scene = tds.upload_scene(presets.cornell_spheres(), "cpu")
    _trace(scene, _cornell_cam(tcam))
    (entry,) = graphs._cache.values()
    assert entry.owner is scene and entry.program.scene is scene
    key = next(iter(graphs._cache))
    del scene
    assert key[0] == id(entry.owner)
    _trace(tds.upload_scene(presets.cornell_spheres(), "cpu"), _cornell_cam(tcam))
    assert len(graphs._cache) == 2


def test_eager_blocks_nest(cornell):
    with graphs.eager():
        with graphs.eager():
            assert graphs._eager[0] == 2
        a = _trace(cornell, _cornell_cam(tcam))
    assert graphs._eager[0] == 0
    assert torch.equal(a[0], _trace(cornell, _cornell_cam(tcam))[0])


# ---------------------------------------------------------------------------
# nothing is uploaded inside a window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["window", "drain_block", "scan_bounce_step",
                                  "scan_start_sample", "scan_bounce_block",
                                  "scan_end_sample"])
def test_no_upload_inside_a_window(cornell_mesh, monkeypatch, what):
    # NEE and Russian roulette on, on a scene with triangles and lights: the
    # cull, the closest hit, the tileset sort, the light sampler, the sky and
    # every RNG bundle run under the patch
    cfg = tint.RenderConfig(max_depth=6, nee=True, rr_start=1)
    wf = tint._Wavefront(cornell_mesh, 48, 32, 1, 9, cfg, 2048, 0, 48 * 32, 1)
    wf.start(_cornell_cam(tcam), 0)  # the one upload of a render: the basis
    if what == "drain_block":
        wf.window()
        wf.compact()
    # the scan's program: `begin` (the pixel ids, the basis, the first
    # sample) runs eagerly once a call, before the patch; the functions that
    # come before the one under test run before it too
    sc = tint._Scan(cornell_mesh, 48 * 32, 48, 32, 9, cfg)
    sc.begin(torch.arange(48 * 32), 2, tpipe.camera_basis(_cornell_cam(tcam), 48, 32))
    scan_before = {"scan_bounce_block": ["start_sample"],
                   "scan_end_sample": ["start_sample", "bounce_block"]}
    for name in scan_before.get(what, []):
        getattr(sc, name)()

    def upload(*a, **k):
        raise AssertionError("a host value was uploaded inside a window")

    monkeypatch.setattr(torch, "tensor", upload)
    monkeypatch.setattr(torch, "as_tensor", upload)
    if what == "scan_bounce_step":
        st = wf.st
        out = tint._bounce_step(cornell_mesh, st["o"], st["d"], st["light"], st["tp"],
                                st["alive"], st["prev_pdf"], st["item"], 0, 2, 9, cfg)
        assert out[6] > 0 and out[7] > 0  # rays, and shadow rays among them
    elif what.startswith("scan_"):
        getattr(sc, what[len("scan_"):])()
        if what == "scan_start_sample":
            assert bool(sc.active.all()) and int(sc.bounce) == 0
        elif what == "scan_bounce_block":
            assert sc.report[2] > 0 and sc.report[3] > 0  # shadow rays among them
        else:
            assert int(sc.sample_id) == 3 and bool(sc.acc.any())
    else:
        getattr(wf, what)()
        assert wf.report[2] > 0


# ---------------------------------------------------------------------------
# the public surface
# ---------------------------------------------------------------------------

SURFACE = [(mine, theirs, name)
           for mine, theirs in ((trender, jrender), (tcore, jcore), (tio, jio),
                                (tkernels, jpallas))
           for name in theirs.__all__]


@pytest.mark.parametrize("mine,theirs,name", SURFACE,
                         ids=[f"{t.__name__.split('.')[-1]}.{n}" for _, t, n in SURFACE])
def test_reference_names_resolve_on_the_port(mine, theirs, name):
    assert name in mine.__all__
    value = getattr(mine, name)
    assert value is not None
    ref = getattr(theirs, name)
    if callable(ref) and not isinstance(ref, type):
        assert callable(value)
    if name == "DeviceScene":
        assert value is trender.TorchScene
    elif hasattr(value, "__module__") and not isinstance(ref, type(tcore)):
        assert value.__module__.startswith("metalpathtracer_torch")
