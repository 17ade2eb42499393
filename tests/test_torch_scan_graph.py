"""The scan integrator on its program of static buffers (`integrator._Scan`,
cached by `render/graphs.py`) on the CPU, where every function runs
eagerly: the same functions the card captures as CUDA graphs
(`start_sample`, `bounce_block`, `last_block`, `end_sample`).

Held against:
- the scan's eager loop as it ran before it had a program (`_eager_trace`
  below: a host read of the loop condition after every bounce step) and
  `render_tile` on it: bit-equal (torch.equal), equal ray counts; a block
  that runs past its last live lane changes neither, and its program's
  report counts the steps it ran with no live lane;
- the JAX package's `render_image` and `accumulate` on the CPU: the bounds
  of the existing parity tests (tests/test_torch_render.py,
  tests/test_torch_progressive.py): under 2% of pixels differ by > 1e-3,
  means within 5e-3, rays within 1% (a path whose hit flips at an edge
  takes another, equally valid, bounce chain);
- a cache entry reused after a camera move, another first sample or
  another sample count, against a fresh entry: bit-equal.
"""

import contextlib

import numpy as np
import pytest
import torch

from metalpathtracer_torch.core import rng as trng
from metalpathtracer_torch.parallel import sharding as sh
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import graphs
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render import pipeline as tpipe
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.scene import presets
from metalpathtracer_tpu.core import rng as jrng
from metalpathtracer_tpu.render import camera as jcam
from metalpathtracer_tpu.render import integrator as jint
from metalpathtracer_tpu.render import pipeline as jpipe
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu.scene import presets as jpresets

torch.set_num_threads(1)


def _cam(m, z=9.0):
    return m.Camera.look_at((0, 2.5, z), (0, 2.5, 0), vfov_deg=40.0)


@pytest.fixture(scope="module")
def cornell():
    return t_upload(presets.cornell_spheres(), "cpu")


@pytest.fixture(scope="module")
def cornell_mesh():
    scene = t_upload(presets.cornell_mesh(subdivisions=1), "cpu")
    assert scene.num_tris > 0 and scene.num_lights > 0
    return scene


@pytest.fixture(autouse=True)
def _fresh_cache():
    graphs.clear()
    graphs.zero_stats()
    yield
    graphs.clear()


def _eager_trace(scene, o, d, pixel_id, sample_id, seed, cfg):
    """The scan's bounce loop without a program: every lane one bounce a
    step, the loop condition read on the host after each. Returns
    (radiance, rays, steps run)."""
    n = o.shape[0]
    light = torch.zeros((n, 3), dtype=torch.float32)
    tp = torch.ones((n, 3), dtype=torch.float32)
    active = torch.ones((n,), dtype=torch.bool)
    prev_pdf = torch.zeros((n,), dtype=torch.float32)
    rays = torch.zeros((), dtype=torch.int64)
    bounce = 0
    while bounce < cfg.max_depth and bool(active.any()):
        o, d, light, tp, active, prev_pdf, counted, _, _, _ = tint._bounce_step(
            scene, o, d, light, tp, active, prev_pdf, pixel_id, sample_id, bounce,
            seed, cfg)
        rays = rays + counted
        bounce += 1
    if cfg.clamp_radiance:
        light = torch.clamp(light, 0.0, 1.0)
    return light, rays, bounce


def _eager_tile(scene, camera, w, h, pixel_id, sample_ids, seed, cfg):
    """`render_tile` on the eager loop: (rgb_sum, rays, steps run)."""
    acc = torch.zeros((pixel_id.shape[0], 3), dtype=torch.float32)
    rays, steps = 0, 0
    basis = tpipe.camera_basis(camera, w, h)
    for s in sample_ids:
        o, d = tpipe.rays_from_basis(basis, w, h, pixel_id, s, seed)
        radiance, r, k = _eager_trace(scene, o, d, pixel_id, s, seed, cfg)
        acc = acc + radiance
        rays += int(r)
        steps += k
    return acc, rays, steps


def _scan_entries():
    return [e for k, e in graphs._cache.items() if k[1][0] == "scan"]


# ---------------------------------------------------------------------------
# the program's functions against the eager loop
# ---------------------------------------------------------------------------

# (scene, cfg, SCAN_BLOCK): one block a sample, a block and a shorter last
# one, one step a block; NEE with Russian roulette; the per-sample clamp
HAND_CASES = {
    "whole_depth": ("cornell", dict(max_depth=6), 8),
    "block_and_last": ("cornell", dict(max_depth=6), 4),
    "one_step_blocks": ("cornell", dict(max_depth=5), 1),
    "nee_rr": ("cornell_mesh", dict(max_depth=6, nee=True, rr_start=2), 4),
    "clamp": ("cornell_mesh", dict(max_depth=5, clamp_radiance=True), 2),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_scan_functions_driven_by_hand_equal_the_eager_loop(request, monkeypatch,
                                                            case):
    name, cfg, block = HAND_CASES[case]
    scene, cfg = request.getfixturevalue(name), tint.RenderConfig(**cfg)
    monkeypatch.setattr(tint, "SCAN_BLOCK", block)
    w, h, seed, first, spp = 24, 16, 9, 3, 2
    pix = torch.arange(w * h, dtype=torch.int64)
    want, rays, steps = _eager_tile(scene, _cam(tcam), w, h, pix,
                                    range(first, first + spp), seed, cfg)
    sc = tint._Scan(scene, w * h, w, h, seed, cfg)
    sc.begin(pix, first, tpipe.camera_basis(_cam(tcam), w, h))
    ran = 0
    for _ in range(spp):
        sc.start_sample()
        bounce = 0
        while bounce < cfg.max_depth:
            k = sc.block if cfg.max_depth - bounce >= sc.block else sc.last
            (sc.bounce_block if k == sc.block else sc.last_block)()
            bounce += k
            ran += k
            assert int(sc.report[1]) == bounce
            if sc.report[0] == 0:
                break
        sc.end_sample()
    acc, got_rays = sc.result()
    assert torch.equal(acc, want) and int(got_rays) == rays
    assert int(sc.sample_id) == first + spp
    # the report counts the steps the blocks ran past the last live lane
    assert sc.report[5].item() == ran - steps
    assert sc.report[2].item() == rays
    # the result is a copy: the next call does not touch it
    before = acc.clone()
    sc.begin(pix, 0, tpipe.camera_basis(_cam(tcam, z=7.0), w, h))
    sc.start_sample()
    sc.bounce_block()
    sc.end_sample()
    assert torch.equal(acc, before)


@pytest.mark.parametrize("sample_id", [4, "tensor"])
def test_trace_equals_the_eager_loop(cornell_mesh, sample_id):
    cfg = tint.RenderConfig(max_depth=6, nee=True)
    w, h = 24, 16
    pix = torch.arange(w * h, dtype=torch.int64)
    o, d = tpipe.generate_rays(_cam(tcam), w, h, pix, 4, 5)
    sid = torch.tensor(4) if sample_id == "tensor" else sample_id
    got, rays = tint.trace(cornell_mesh, o, d, pix, sid, 5, cfg)
    want, want_rays, _ = _eager_trace(cornell_mesh, o, d, pix, 4, 5, cfg)
    assert torch.equal(got, want) and int(rays) == int(want_rays)
    assert rays.dtype == torch.int64 and rays.shape == ()
    (entry,) = _scan_entries()
    assert entry.program.width is None and entry.program.n == w * h


def test_a_block_past_the_last_live_lane_changes_nothing(monkeypatch):
    # every primary ray of the sky-only scene misses: each path ends on its
    # first bounce, and a block of max_depth steps runs the other 5 on no
    # live lane
    scene = t_upload(presets.sky_only(), "cpu")
    cfg, w, h, spp = tint.RenderConfig(max_depth=6), 16, 16, 3
    monkeypatch.setattr(tint, "SCAN_BLOCK", cfg.max_depth)  # one block a sample
    pix = torch.arange(w * h, dtype=torch.int64)
    want, rays, steps = _eager_tile(scene, _cam(tcam), w, h, pix, range(spp), 2, cfg)
    assert steps == spp and rays == spp * w * h
    img, got_rays = tpipe.render_image(scene, _cam(tcam), w, h, spp, seed=2, cfg=cfg,
                                       spp_per_pass=spp)
    assert torch.equal(img, (want / spp).reshape(h, w, 3)) and got_rays == rays
    (entry,) = _scan_entries()
    report = entry.program.report.tolist()
    assert report[0] == 0 and report[1] == cfg.max_depth
    assert report[5] == spp * (cfg.max_depth - 1)
    assert graphs.STATS["reads"] == spp  # one read a block


def test_render_tile_takes_consecutive_sample_ids(cornell):
    pix = torch.arange(64, dtype=torch.int64)
    with pytest.raises(ValueError, match="consecutive"):
        tpipe.render_tile(cornell, _cam(tcam), 8, 8, pix, [0, 2], 1,
                          tint.RenderConfig(max_depth=2))


# ---------------------------------------------------------------------------
# render_image and accumulate through the program against the reference
# ---------------------------------------------------------------------------


def _render_close(mine, theirs, rays, j_rays):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    assert mine.shape == theirs.shape and np.isfinite(mine).all()
    assert (np.abs(mine - theirs) > 1e-3).mean() < 0.02
    assert abs(mine.mean() - theirs.mean()) < 5e-3
    assert abs(rays - int(j_rays)) <= 0.01 * int(j_rays)


# (preset, cfg, spp, spp_per_pass, sample_offset)
JAX_CASES = {
    "nee_rr": ("cornell_materials", dict(max_depth=6, nee=True, rr_start=2), 2, 2, 0),
    "clamp": ("cornell_spheres", dict(max_depth=5, clamp_radiance=True), 2, 2, 0),
    "passes_and_offset": ("cornell_spheres", dict(max_depth=5), 3, 2, 5),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_render_image_matches_the_reference(case):
    preset, cfg, spp, per_pass, offset = JAX_CASES[case]
    w = h = 16
    mine, rays = tpipe.render_image(
        t_upload(getattr(presets, preset)(), "cpu"), _cam(tcam), w, h, spp, seed=7,
        cfg=tint.RenderConfig(**cfg), spp_per_pass=per_pass, sample_offset=offset)
    # every pass ran on the one entry of its shape
    assert len(_scan_entries()) == 1
    assert graphs.STATS["eager_runs"] > graphs.STATS["reads"] > 0
    theirs, j_rays = jpipe.render_image(
        j_upload(getattr(jpresets, preset)()), _cam(jcam), w, h, spp, seed=7,
        cfg=jint.RenderConfig(**cfg), spp_per_pass=per_pass, sample_offset=offset)
    _render_close(mine.numpy(), theirs, rays, j_rays)


def test_accumulate_matches_the_reference():
    # steps of 2, 2 and 1 samples on one entry
    w = h = 16
    cfg = dict(max_depth=5, nee=True, rr_start=3)
    scene = t_upload(presets.cornell_materials(), "cpu")
    j_scene = j_upload(jpresets.cornell_materials())
    st, js = tpipe.init_accum(w, h, "cpu"), jpipe.init_accum(w, h)
    for n in (2, 2, 1):
        st = tpipe.accumulate(st, scene, _cam(tcam), w, h, n, trng.seed_from_int(4),
                              tint.RenderConfig(**cfg))
        js = jpipe.accumulate(js, j_scene, _cam(jcam), w, h, n, jrng.seed_from_int(4),
                              jint.RenderConfig(**cfg))
    assert len(_scan_entries()) == 1
    assert st.spp == int(js.spp) == 5
    mine, theirs = st.rgb_sum.numpy() / 5, np.asarray(js.rgb_sum) / 5
    assert (np.abs(mine - theirs) > 1e-3).mean() < 0.02
    assert abs(mine.mean() - theirs.mean()) < 5e-3


# ---------------------------------------------------------------------------
# the cache: one entry a shape, whatever the camera and the samples
# ---------------------------------------------------------------------------

W, H, CFG = 24, 16, tint.RenderConfig(max_depth=4)


def _step(scene, state, n, cam=None):
    return tpipe.accumulate(state, scene, cam or _cam(tcam), W, H, n, 3, CFG)


@pytest.mark.parametrize("change", ["camera", "state_spp", "n_samples"])
def test_reused_entry_equals_a_fresh_one(cornell, change):
    first = _step(cornell, tpipe.init_accum(W, H, "cpu"), 2)
    (entry,) = _scan_entries()
    if change == "camera":
        args = (tpipe.init_accum(W, H, "cpu"), 2, _cam(tcam, z=7.0))
    elif change == "state_spp":
        args = (first, 2)
    else:
        args = (tpipe.init_accum(W, H, "cpu"), 1)
    reused = _step(cornell, *args)
    assert _scan_entries() == [entry]
    graphs.clear()
    fresh = _step(cornell, *args)
    assert _scan_entries()[0] is not entry
    assert torch.equal(reused.rgb_sum, fresh.rgb_sum) and reused.spp == fresh.spp


def _render(scene, **kw):
    args = dict(width=W, height=H, seed=3, cfg=CFG)
    args.update(kw)
    return tpipe.render_image(scene, _cam(tcam), args["width"], args["height"], 2,
                              seed=args["seed"], cfg=args["cfg"], spp_per_pass=2)


@pytest.mark.parametrize("change", [
    dict(width=16), dict(height=24), dict(seed=4), dict(cfg=tint.RenderConfig(max_depth=5)),
    dict(cfg=tint.RenderConfig(max_depth=4, rr_start=2)), "lanes", "scene",
])
def test_a_new_render_shape_makes_a_new_entry(cornell, change):
    _render(cornell)
    if change == "lanes":  # a row block of the same image: fewer lanes
        sh.shard_render(cornell, _cam(tcam), W, H, 2, 3, CFG, 0, 2)
    elif change == "scene":
        _render(t_upload(presets.cornell_spheres(), "cpu"))
    else:
        _render(cornell, **change)
    assert len(_scan_entries()) == 2


def test_a_row_block_of_either_shard_reuses_one_entry(cornell):
    blocks = [sh.shard_render(cornell, _cam(tcam), W, H, 4, 3, CFG, ti, 2, si, 2)
              for ti in range(2) for si in range(2)]
    assert len(_scan_entries()) == 1
    for (ti, si), (block, rays) in zip([(0, 0), (0, 1), (1, 0), (1, 1)], blocks):
        # block ti of 2 holds rows ti, ti + 2, ...
        rows = torch.arange(H // 2, dtype=torch.int64)[:, None] * 2 + ti
        pix = (rows * W + torch.arange(W, dtype=torch.int64)).reshape(-1)
        want, want_rays, _ = _eager_tile(cornell, _cam(tcam), W, H, pix,
                                         range(2 * si, 2 * si + 2),
                                         trng.seed_from_int(3), CFG)
        assert torch.equal(block, want.reshape(H // 2, W, 3)) and rays == want_rays


# ---------------------------------------------------------------------------
# the BVH walk: the eager loop by config, on both integrators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("integrator", ["scan", "wavefront"])
def test_bvh_runs_eagerly_by_config(monkeypatch, integrator):
    scene = t_upload(presets.cornell_mesh(subdivisions=1), "cpu", bvh=True)
    entries = {}
    for kind in ("bvh", "mm"):
        cfg = tint.RenderConfig(max_depth=3, intersector=kind)
        if integrator == "scan":
            tpipe.render_image(scene, _cam(tcam), 16, 16, 1, seed=2, cfg=cfg)
        else:
            tpipe.render_image_wavefront(scene, _cam(tcam), 16, 16, 1, seed=2, cfg=cfg,
                                         pool_size=128)
        entries[kind] = next(reversed(graphs._cache.values()))
    assert not entries["bvh"].program.capturable
    assert entries["mm"].program.capturable
    # as on the card: the BVH program runs eagerly by its flag, without a
    # warm-up or a capture; the other goes to the card's warm-up
    warmed = []
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(graphs.Entry, "_warm_up", lambda self, fn: warmed.append(fn))
    name = "bounce_block" if integrator == "scan" else "window"
    for kind, entry in entries.items():
        entry.device = torch.device("cuda")
        graphs.zero_stats()
        entry.run(name)
        if kind == "bvh":
            assert graphs.STATS["eager_runs"] == 1 and not warmed
        else:
            assert graphs.STATS["eager_runs"] == 0 and len(warmed) == 1
        assert graphs.STATS["captures"] == graphs.STATS["replays"] == 0


def test_the_eager_loop_on_a_card_reads_every_bounce(cornell, monkeypatch):
    # an entry on the card that does not replay (`graphs.eager()`, the BVH
    # walk) steps as the scan did before its blocks: one step and one read
    # a bounce, no idle step. The entry's device is set to CUDA by hand:
    # its functions still run on the CPU tensors
    cfg, spp = tint.RenderConfig(max_depth=5), 2
    pix = torch.arange(W * H, dtype=torch.int64)
    first, _ = tpipe.render_tile(cornell, _cam(tcam), W, H, pix, range(spp), 3, cfg)
    (entry,) = _scan_entries()
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    entry.device = torch.device("cuda")
    graphs.zero_stats()
    with graphs.eager():
        got, rays = tpipe.render_tile(cornell, _cam(tcam), W, H, pix, range(spp), 3, cfg)
    want, want_rays, steps = _eager_tile(cornell, _cam(tcam), W, H, pix, range(spp), 3,
                                         cfg)
    assert torch.equal(got, want) and torch.equal(got, first) and int(rays) == want_rays
    assert graphs.STATS["reads"] == steps and graphs.STATS["idle_steps"] == 0
    assert graphs.STATS["eager_runs"] == steps + 2 * spp
