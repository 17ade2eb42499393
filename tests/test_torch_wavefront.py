"""The port's persistent-wavefront integrator (`trace_wavefront`,
`render_image_wavefront`, `cli --wavefront`) against the port's scan
integrator and against the JAX reference, on the CPU.

Tolerances:
- wavefront vs the port's scan: RNG streams key on (pixel, sample, bounce),
  never on the lane, so the estimate is the same whatever the pool size,
  banking width, bounces per advance or lane order; only the order of the
  framebuffer additions and the subgroups the closest hit sees differ:
  rtol 1e-5, atol 1e-6 (tests/test_wavefront.py's bound), equal ray counts;
- wavefront vs the JAX reference's wavefront: the render bounds of
  tests/test_torch_render.py (under 2% of pixels differ by > 1e-3, means
  within 5e-3), equal ray counts;
- `_coarse_boxes`: the same numpy on both sides, so bit-equal.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from metalpathtracer_torch import cli as tcli
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import device_scene as tds
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render.kernels import wavefront as twfk
from metalpathtracer_torch.render.pipeline import render_image, render_image_wavefront
from metalpathtracer_tpu.render import camera as jcam
from metalpathtracer_tpu.render import device_scene as jds
from metalpathtracer_tpu.render import integrator as jint
from metalpathtracer_tpu.render import render_image_wavefront as j_render_wavefront
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_torch.scene import load_scene_xml, presets
from metalpathtracer_tpu import scene as jscene
from metalpathtracer_tpu.scene import presets as jpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _cornell_cam(m):
    return m.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def cornell():
    return tds.upload_scene(presets.cornell_spheres(), "cpu")


@pytest.fixture(scope="module")
def bunny():
    # the reference scene with the bunny: triangles, so the pool is sorted
    return tds.upload_scene(
        presets.reference_default(os.path.join(REPO, "assets", "bunny.obj")), "cpu")


@pytest.fixture(scope="module")
def scan_24():
    """The port's scan render the pool-size and bpi cases compare with."""
    scene = tds.upload_scene(presets.cornell_spheres(), "cpu")
    return render_image(scene, _cornell_cam(tcam), 24, 24, spp=4, seed=5,
                        cfg=tint.RenderConfig(max_depth=6))


def test_wavefront_matches_scan(cornell, scan_24):
    a, ra = scan_24
    b, rb = render_image_wavefront(cornell, _cornell_cam(tcam), 24, 24, spp=4,
                                   seed=5, cfg=tint.RenderConfig(max_depth=6),
                                   pool_size=512)
    _close(a, b)
    assert ra == rb


@pytest.mark.parametrize("pool", [256, 1024, 24 * 24 * 2])
def test_wavefront_pool_size_invariant(cornell, scan_24, pool):
    a, ra = scan_24
    b, rb = render_image_wavefront(cornell, _cornell_cam(tcam), 24, 24, spp=4,
                                   seed=5, cfg=tint.RenderConfig(max_depth=6),
                                   pool_size=pool)
    _close(a, b)
    assert ra == rb


@pytest.mark.parametrize("bpi", [2, 3])
def test_wavefront_bounces_per_iter_invariant(cornell, scan_24, bpi):
    a, ra = scan_24
    b, rb = render_image_wavefront(
        cornell, _cornell_cam(tcam), 24, 24, spp=4, seed=5,
        cfg=tint.RenderConfig(max_depth=6, bounces_per_iter=bpi), pool_size=512)
    _close(a, b)
    assert ra == rb


@pytest.mark.parametrize("bank_k", [2, 4])
def test_wavefront_bank_k_matches_scan(cornell, bank_k):
    # n_pix 576, pool 128: spb == spp and n_pix // k >= pool for k <= 4; the
    # automatic choice picks 1 here, so bank_k is asked for
    cfg = tint.RenderConfig(max_depth=6, bank_k=bank_k)
    a, ra = render_image(cornell, _cornell_cam(tcam), 24, 24, spp=4, seed=11, cfg=cfg)
    b, rb = render_image_wavefront(cornell, _cornell_cam(tcam), 24, 24, spp=4,
                                   seed=11, cfg=cfg, pool_size=128)
    _close(a, b)
    assert ra == rb


def test_wavefront_with_rr_and_nee(cornell):
    cfg = tint.RenderConfig(max_depth=8, rr_start=2, nee=True)
    a, ra = render_image(cornell, _cornell_cam(tcam), 16, 16, spp=4, seed=3, cfg=cfg)
    b, rb, stats = render_image_wavefront(cornell, _cornell_cam(tcam), 16, 16,
                                          spp=4, seed=3, cfg=cfg, pool_size=333,
                                          return_stats=True)
    _close(a, b)
    assert ra == rb
    assert 0 < stats["shadow_rays"] < rb


def test_wavefront_open_scene():
    # spheres under the sky: most paths end on bounce 1
    scene = tds.upload_scene(presets.reference_default(), "cpu")
    cam = tcam.Camera.reset()
    cfg = tint.RenderConfig(max_depth=8)
    a, ra = render_image(scene, cam, 32, 18, spp=2, seed=1, cfg=cfg)
    b, rb = render_image_wavefront(scene, cam, 32, 18, spp=2, seed=1, cfg=cfg,
                                   pool_size=128)
    _close(a, b)
    assert ra == rb


@pytest.mark.parametrize("sort_lanes", [True, False])
def test_wavefront_with_triangles_matches_scan(bunny, sort_lanes):
    # n_pix 2304, pool 128, bank_k 2: groups >= pool, spb == spp, and the
    # tileset sort runs every 4 advances (with sort_lanes)
    cam = tcam.Camera.reset()
    cfg = tint.RenderConfig(max_depth=6, bank_k=2, sort_lanes=sort_lanes)
    a, ra = render_image(bunny, cam, 64, 36, spp=4, seed=7, cfg=cfg)
    b, rb, stats = render_image_wavefront(bunny, cam, 64, 36, spp=4, seed=7,
                                          cfg=cfg, pool_size=128,
                                          return_stats=True)
    _close(a, b)
    assert ra == rb
    assert stats["tile_passes"] > 0 and stats["shadow_rays"] == 0


def test_wavefront_clamp(cornell):
    cfg = tint.RenderConfig(max_depth=4, clamp_radiance=True)
    img, _ = render_image_wavefront(cornell, _cornell_cam(tcam), 16, 16, spp=2,
                                    seed=4, cfg=cfg, pool_size=256)
    assert float(img.max()) <= 1.0
    a, _ = render_image(cornell, _cornell_cam(tcam), 16, 16, spp=2, seed=4, cfg=cfg)
    _close(a, img)


@pytest.mark.parametrize("spp", [0, -1])
def test_wavefront_rejects_bad_spp(cornell, spp):
    with pytest.raises(ValueError):
        render_image_wavefront(cornell, _cornell_cam(tcam), 8, 8, spp=spp)


def test_wavefront_rejects_unported_sort_keys(bunny):
    cfg = tint.RenderConfig(sort_key="morton")
    with pytest.raises(ValueError, match="sort key"):
        render_image_wavefront(bunny, tcam.Camera.reset(), 8, 8, spp=1, cfg=cfg)


def test_tileset_key_bits():
    # a ray through coarse boxes 0 and 2 of three gets key 0b101; a dead
    # lane gets 0
    box = np.zeros((3, 8), np.float32)
    for c, z in enumerate((0.0, 10.0, 20.0)):
        box[c, 0:3], box[c, 4:7] = [0, 0, z], [1, 1, z + 1]
    box[1, 0] = 5.0
    box[1, 4] = 6.0  # box 1 lies off the ray's line
    scene = dataclasses.replace(
        tds.upload_scene(presets.cornell_spheres(), "cpu"),
        mm_coarse_box=torch.as_tensor(box))
    o = torch.tensor([[0.5, 0.5, -5.0]] * 2)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    alive = torch.tensor([True, False])
    bits = twfk.tileset_bits(o, d, alive, scene.mm_coarse_box, tint.T_MIN)
    assert bits.tolist() == [0b101, 0]
    # the sort's int32 key: the signature minus 2^31, in the same order
    key = twfk.tileset_key(o, d, alive, scene.mm_coarse_box, tint.T_MIN)
    assert key.dtype == torch.int32
    assert key.tolist() == [0b101 - (1 << 31), -(1 << 31)]


@pytest.fixture(scope="module")
def jax_wavefront():
    """The one JAX wavefront render of this file."""
    img, rays = j_render_wavefront(j_upload(jpresets.cornell_spheres()),
                                   _cornell_cam(jcam), 24, 24, spp=4, seed=5,
                                   cfg=jint.RenderConfig(max_depth=6), pool_size=512)
    return np.asarray(img), rays


def test_wavefront_matches_reference_wavefront(jax_wavefront):
    theirs, j_rays = jax_wavefront
    mine, rays = render_image_wavefront(
        tds.upload_scene(presets.cornell_spheres(), "cpu"), _cornell_cam(tcam), 24, 24,
        spp=4, seed=5,
        cfg=tint.RenderConfig(max_depth=6), pool_size=512)
    mine = mine.numpy()
    assert mine.shape == theirs.shape == (24, 24, 3)
    assert np.isfinite(mine).all()
    assert (np.abs(mine - theirs) > 1e-3).mean() < 0.02
    assert abs(mine.mean() - theirs.mean()) < 5e-3
    assert rays == j_rays


@pytest.mark.parametrize("nt", [1, 5, 39, 64, 311])
def test_coarse_boxes_match_reference(nt):
    r = np.random.default_rng(nt)
    tile_box = np.zeros((nt, 8), np.float32)
    tile_box[:, 0:3] = r.uniform(-10, 10, (nt, 3))
    tile_box[:, 4:7] = tile_box[:, 0:3] + r.uniform(0, 3, (nt, 3))
    mine = tds._coarse_boxes(tile_box)
    theirs = jds._coarse_boxes(tile_box, 32)
    assert mine.shape == (min(nt, 32), 8)
    np.testing.assert_array_equal(mine, theirs)


def test_scene_from_jax_carries_the_coarse_boxes():
    path = os.path.join(REPO, "scenes", "reference.xml")
    js = j_upload(jscene.load_scene_xml(path))
    arrays = {f.name: (v if isinstance(v, int) else np.asarray(v))
              for f in dataclasses.fields(js) for v in [getattr(js, f.name)]}
    mine = tds.upload_scene(load_scene_xml(path), "cpu")
    theirs = tds.scene_from_jax(arrays, "cpu")
    np.testing.assert_array_equal(mine.mm_coarse_box.numpy(),
                                  np.asarray(js.mm_coarse_box))
    assert torch.equal(theirs.mm_coarse_box, mine.mm_coarse_box)
    # 39 tiles in 20 ranges of 2, then 12 empty boxes
    assert mine.mm_coarse_box.shape == (32, 8)
    assert torch.isfinite(mine.mm_coarse_box[:20]).all()
    assert torch.isinf(mine.mm_coarse_box[20:, [0, 1, 2, 4, 5, 6]]).all()


def test_cli_wavefront_writes_png_and_stats_on_cpu(tmp_path, capsys):
    from metalpathtracer_tpu.io.png import read_png

    out = tmp_path / "wf.png"
    argv = ["--scene", os.path.join(REPO, "scenes", "reference.xml"),
            "--width", "32", "--height", "18", "--spp", "2", "--max-depth", "4",
            "--output", str(out), "--stats-json", "--device", "cpu", "--seed", "3"]
    assert tcli.main(argv + ["--wavefront", "--pool-size", "256",
                             "--bounces-per-iter", "2"]) == 0
    img = read_png(str(out))
    assert img.shape == (18, 32, 3) and img.max() > 0
    wf = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(argv) == 0
    scan = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert wf["rays"] == scan["rays"] > 32 * 18 * 2
    assert set(wf) == set(scan)
