"""The port's sharded path (`parallel/sharding.py`, `trace_wavefront`'s
`pixel_offset` / `n_pixels` / `row_stride`) against the port's renders of
one device and against the JAX reference's sharded renders, on the CPU.

Three ways to run the shards:
- in one process: the shard-local layer (`shard_render`,
  `shard_render_wavefront`, `shard_accumulate`) looped over the shard
  indices and joined by the layer's own `join_rows` / a sum, at the 8
  virtual ranks (4x2 for the 2-D layouts) and the sizes of
  tests/test_sharding.py and tests/test_sharding_extra.py;
- in a world of one: the entry points themselves, which then call no
  collective;
- under real process groups: one launch of 2 ranks and one of 4 (gloo,
  a file store each), every rank a fresh interpreter running all of its
  world's jobs (`parallel/worker.py`); each job is a test case of its own.

Tolerances:
- tile sharding, scan and wavefront, `torch.equal` with equal ray counts:
  the RNG streams key on (pixel, sample, bounce) and a pixel's samples are
  added in the same order on a shard as on the whole image (the
  reference's `assert_array_equal`);
- sample and 2-D layouts: the join adds the slices' partial sums in
  another order than one pass does: rtol 1e-5, atol 1e-6 (the reference's
  bound), equal ray counts;
- two `accumulate_sharded` steps against a one-shot wavefront render: the
  per-pixel sums differ by addition order across steps: rtol 1e-6, atol
  1e-7 (the reference's bound), and the steps' rays add up;
- a resumed sharded accumulation against the uninterrupted one:
  `torch.equal`;
- against the JAX package: the render limit of tests/test_torch_render.py
  (under 2% of pixels differ by > 1e-3, means within 5e-3): a path whose
  hit flips at an edge takes another, equally valid, bounce chain.
"""

import os
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from metalpathtracer_torch.io.checkpoint import load_checkpoint, save_checkpoint
from metalpathtracer_torch.parallel import sharding as sh
from metalpathtracer_torch.parallel import worker
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render import pipeline as tpipe
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.scene import Material, presets
from metalpathtracer_torch.scene.procgen import icosphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

CAM = tcam.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
CAM_SPEC = {"look_at": [[0, 2.5, 9.0], [0, 2.5, 0], 40.0]}


def _close(a, b, rtol=1e-5, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _within_render_limit(mine, theirs):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    assert mine.shape == theirs.shape and np.isfinite(mine).all()
    assert (np.abs(mine - theirs) > 1e-3).mean() < 0.02
    assert abs(mine.mean() - theirs.mean()) < 5e-3


def _joined(shard, nt, ns, spp):
    """The image and rays of an nt x ns grid of shards run one after another:
    `shard(ti, nt, si, ns)` -> (rgb_sum block, rays); sample slices are
    added, tile blocks joined by the layer's `join_rows`."""
    rows, rays = [], 0
    for ti in range(nt):
        parts = [shard(ti, nt, si, ns) for si in range(ns)]
        block = parts[0][0]
        for p in parts[1:]:
            block = block + p[0]
        rows.append(block)
        rays += sum(p[1] for p in parts)
    return sh.join_rows(rows) / spp, rays


def _scan_shards(scene, w, h, spp, seed, cfg=tint.DEFAULT_CONFIG):
    return lambda ti, nt, si, ns: sh.shard_render(
        scene, CAM, w, h, spp, seed, cfg, ti, nt, si, ns)


def _wavefront_shards(scene, w, h, spp, seed, cfg, pool):
    return lambda ti, nt, si, ns: sh.shard_render_wavefront(
        scene, CAM, w, h, spp, seed, cfg, pool, ti, nt, si, ns)


@pytest.fixture(scope="module")
def cornell():
    return t_upload(presets.cornell_spheres(), "cpu")


@pytest.fixture(scope="module")
def cornell_mesh():
    scene = t_upload(presets.cornell_mesh(subdivisions=1), "cpu")
    assert scene.num_tris > 0
    return scene


@pytest.fixture(scope="module")
def single(cornell):
    return tpipe.render_image(cornell, CAM, 32, 32, spp=4, seed=3, spp_per_pass=4)


# ---------------------------------------------------------------------------
# (i) trace_wavefront's pixel_offset / n_pixels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pixel_range_blocks_join_to_the_whole(cornell_mesh, n):
    w = h = 16
    cfg = tint.RenderConfig(max_depth=4)
    whole, rays, _ = tint.trace_wavefront(cornell_mesh, CAM, w, h, 4, 7, cfg, 256)
    n_local = w * h // n
    blocks = [tint.trace_wavefront(cornell_mesh, CAM, w, h, 4, 7, cfg, 256,
                                   pixel_offset=i * n_local, n_pixels=n_local)
              for i in range(n)]
    assert all(b[0].shape == (n_local, 3) for b in blocks)
    assert torch.equal(torch.cat([b[0] for b in blocks]), whole)
    assert sum(b[1] for b in blocks) == rays


@pytest.mark.parametrize("n", [2, 4, 8])
def test_row_strided_ranges_join_to_the_whole(cornell_mesh, n):
    # rank r's range: rows r, r + n, ...; its framebuffer row i is image row
    # i n + r, and the layer's join puts every row back in its place
    w = h = 16
    cfg = tint.RenderConfig(max_depth=4)
    whole, rays, _ = tint.trace_wavefront(cornell_mesh, CAM, w, h, 4, 7, cfg, 256)
    n_local = w * h // n
    blocks = [tint.trace_wavefront(cornell_mesh, CAM, w, h, 4, 7, cfg, 256,
                                   pixel_offset=r * w, n_pixels=n_local, row_stride=n)
              for r in range(n)]
    assert all(b[0].shape == (n_local, 3) for b in blocks)
    joined = sh.join_rows([b[0].reshape(h // n, w, 3) for b in blocks])
    assert torch.equal(joined.reshape(w * h, 3), whole)
    assert sum(b[1] for b in blocks) == rays


def test_row_stride_must_be_positive(cornell):
    with pytest.raises(ValueError, match="row_stride must be positive, got 0"):
        tint.trace_wavefront(cornell, CAM, 16, 16, 1, 0, n_pixels=128, row_stride=0)


def test_pixel_range_matches_reference_range():
    from metalpathtracer_tpu.core import rng as jrng
    from metalpathtracer_tpu.render import camera as jcam
    from metalpathtracer_tpu.render import integrator as jint
    from metalpathtracer_tpu.render import upload_scene as j_upload
    from metalpathtracer_tpu.scene import presets as jpresets

    w = h = 24
    n_local = w * h // 2
    mine, rays, _ = tint.trace_wavefront(
        t_upload(presets.cornell_spheres(), "cpu"), CAM, w, h, 4, 5,
        tint.RenderConfig(max_depth=6), 256, pixel_offset=n_local,
        n_pixels=n_local)
    theirs, j_rays = jint.trace_wavefront(
        j_upload(jpresets.cornell_spheres()),
        jcam.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0), w, h, 4,
        jrng.seed_from_int(5), jint.RenderConfig(max_depth=6), 256,
        pixel_offset=n_local, n_pixels=n_local)
    assert mine.shape == (n_local, 3)
    _within_render_limit(mine.numpy() / 4, np.asarray(theirs) / 4)
    assert rays == int(j_rays)


def test_queue_guard_reads_the_local_count(cornell):
    # 2^32 pixels overflow the queue; a range of 64 of them does not
    big = 1 << 16
    with pytest.raises(ValueError, match="overflow"):
        tint.trace_wavefront(cornell, CAM, big, big, 1, 0)
    fb, rays, _ = tint.trace_wavefront(
        cornell, CAM, big, big, 1, 0, tint.RenderConfig(max_depth=2),
        pixel_offset=big * (big // 2) + big // 2 - 32, n_pixels=64)
    assert fb.shape == (64, 3) and rays >= 64 and torch.isfinite(fb).all()


def test_pixel_range_default_is_the_whole_image(cornell):
    cfg = tint.RenderConfig(max_depth=4)
    a = tint.trace_wavefront(cornell, CAM, 16, 16, 2, 3, cfg, 128)
    b = tint.trace_wavefront(cornell, CAM, 16, 16, 2, 3, cfg, 128,
                             pixel_offset=0, n_pixels=256)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]


# ---------------------------------------------------------------------------
# (ii) the shard-local layer in one process: tests/test_sharding.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 2])
def test_tile_sharded_bit_identical(cornell, single, n):
    img, rays = _joined(_scan_shards(cornell, 32, 32, 4, 3), n, 1, 4)
    assert torch.equal(img, single[0])
    assert rays == single[1]


def test_sample_sharded_matches(cornell):
    base, base_rays = tpipe.render_image(cornell, CAM, 32, 32, spp=8, seed=3,
                                         spp_per_pass=8)
    img, rays = _joined(_scan_shards(cornell, 32, 32, 8, 3), 1, 8, 8)
    _close(img, base)  # the join reorders the per-sample additions
    assert rays == base_rays


def test_2d_mesh_matches(cornell, single):
    img, rays = _joined(_scan_shards(cornell, 32, 32, 4, 3), 4, 2, 4)
    _close(img, single[0])
    assert rays == single[1]


def _mesh_of(n_tiles=1, n_samples=1):
    """A mesh made by hand: rank 0 of a grid no process group backs. An
    entry point must reject its arguments before it reaches a collective."""
    return sh.Mesh(n_tiles, n_samples)


BAD_ARGUMENTS = {
    "tile_height": (sh.render_image_sharded, dict(height=30, spp=1),
                    _mesh_of(8), "image height 30 must divide evenly across 8 tile"),
    "tile_wavefront_height": (sh.render_image_wavefront_sharded,
                              dict(height=30, spp=1), _mesh_of(8),
                              "image height 30 must divide evenly across 8 tile"),
    "tile_wavefront_spp": (sh.render_image_wavefront_sharded,
                           dict(height=32, spp=0), _mesh_of(8),
                           "spp must be positive, got 0"),
    "sample_spp": (sh.render_image_sample_sharded, dict(height=32, spp=3),
                   _mesh_of(1, 8), "spp 3 must divide evenly across 8 shards"),
    "sample_wavefront_spp": (sh.render_image_sample_sharded_wavefront,
                             dict(height=32, spp=3), _mesh_of(1, 8),
                             "spp 3 must divide evenly across 8 shards"),
    "grid_height": (sh.render_image_sharded_2d, dict(height=30, spp=2),
                    _mesh_of(4, 2), "image height 30 must divide evenly across 4"),
    "grid_spp": (sh.render_image_sharded_2d, dict(height=32, spp=3),
                 _mesh_of(4, 2), "spp 3 must divide across 2 sample shards"),
    "grid_wavefront_height": (sh.render_image_sharded_2d_wavefront,
                              dict(height=30, spp=2), _mesh_of(4, 2),
                              "image height 30 must divide evenly across 4"),
    "grid_wavefront_spp": (sh.render_image_sharded_2d_wavefront,
                           dict(height=32, spp=3), _mesh_of(4, 2),
                           "spp 3 must divide across 2 sample shards"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGUMENTS))
def test_sharding_rejects_bad_arguments(cornell, case):
    fn, kwargs, mesh, message = BAD_ARGUMENTS[case]
    with pytest.raises(ValueError, match=message):
        fn(cornell, CAM, 32, kwargs["height"], kwargs["spp"], seed=0, mesh=mesh)


def test_accumulate_sharded_rejects_bad_arguments(cornell):
    with pytest.raises(ValueError, match="image height 30 must divide"):
        sh.init_accum_sharded(32, 30, _mesh_of(4), "cpu")
    state = sh.init_accum_sharded(32, 32, _mesh_of(4), "cpu")
    assert state.rgb_sum.shape == (8, 32, 3) and state.spp == 0
    for n in (0, -2):
        with pytest.raises(ValueError, match=f"n_samples must be positive, got {n}"):
            sh.accumulate_sharded(state, cornell, CAM, n, mesh=_mesh_of(4))
    with pytest.raises(ValueError, match="must divide evenly across 3"):
        sh.block_rows(torch.zeros(32, 32, 3), 0, 3)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_whole_image_round_trips_through_the_blocks(monkeypatch, n):
    # cut (`block_rows`, `shard_accum`) and join (`join_rows`, `gather_accum`)
    # are inverses; block t holds rows t, t + n, ...; the all_gather is
    # stood in for by a copy of every rank's block
    whole = torch.as_tensor(np.random.default_rng(n).random((32, 24, 3), np.float32))
    blocks = [sh.block_rows(whole, t, n) for t in range(n)]
    for t, b in enumerate(blocks):
        assert b.shape == (32 // n, 24, 3)
        assert torch.equal(b, whole[[i * n + t for i in range(32 // n)]])
    assert torch.equal(sh.join_rows(blocks), whole)

    def all_gather(parts, mine, group=None):
        for p, b in zip(parts, blocks):
            p.copy_(b)
    monkeypatch.setattr(sh.dist, "all_gather", all_gather)
    state = tpipe.AccumState(whole, 6)
    for t in range(n):
        mesh = sh.Mesh(n, 1, tile_index=t)
        mine = sh.shard_accum(state, mesh)
        assert mine.spp == 6 and mine.rgb_sum.is_contiguous()
        assert torch.equal(mine.rgb_sum, blocks[t])
        back = sh.gather_accum(mine, mesh)
        assert back.spp == 6 and torch.equal(back.rgb_sum, whole)


def test_meshes_without_a_process_group():
    assert sh.make_mesh().shape == (1, 1)
    assert sh.make_mesh(1, axis="samples").shape == (1, 1)
    assert sh.make_mesh_2d(1, 1).size == 1
    mesh = sh.make_mesh()
    assert (mesh.tile_index, mesh.sample_index) == (0, 0)
    assert mesh.tiles_group is None and mesh.samples_group is None
    with pytest.raises(ValueError, match="a mesh of 4 needs a process group"):
        sh.make_mesh(4)
    with pytest.raises(ValueError, match="a 4x2 mesh needs a process group of 8"):
        sh.make_mesh_2d(4, 2)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        sh.make_mesh(axis="rows")


def _accumulate_blocks(states, scene, n, n_samples, seed, pool):
    """One `accumulate_sharded` step on each of the n tile blocks."""
    out = [sh.shard_accumulate(s, scene, CAM, n_samples, seed,
                               tint.DEFAULT_CONFIG, pool, i, n)
           for i, s in enumerate(states)]
    return [o[0] for o in out], sum(o[1] for o in out)


def test_progressive_sharded_accumulation_matches_wavefront(cornell):
    n = 4
    states = [sh.init_accum_sharded(32, 32, _mesh_of(n), "cpu") for _ in range(n)]
    states, rays1 = _accumulate_blocks(states, cornell, n, 2, 3, 256)
    assert all(s.spp == 2 for s in states)
    states, rays2 = _accumulate_blocks(states, cornell, n, 2, 3, 256)
    assert all(s.spp == 4 for s in states)
    img, rays = tpipe.render_image_wavefront(cornell, CAM, 32, 32, spp=4, seed=3,
                                             pool_size=256)
    _close(sh.join_rows([s.rgb_sum for s in states]) / 4.0, img, rtol=1e-6,
           atol=1e-7)
    assert rays1 + rays2 == rays


def test_accum_sharded_checkpoint_roundtrip(cornell, tmp_path):
    """Gather -> checkpoint -> restore -> cut -> continue == uninterrupted."""
    n = 4
    s0 = [sh.init_accum_sharded(32, 32, _mesh_of(n), "cpu") for _ in range(n)]
    s1, _ = _accumulate_blocks(s0, cornell, n, 2, 7, 256)
    path = tmp_path / "shard.npz"
    whole = tpipe.AccumState(sh.join_rows([s.rgb_sum for s in s1]), s1[0].spp)
    save_checkpoint(str(path), whole, seed=7)
    loaded, seed, _ = load_checkpoint(str(path), "cpu")
    assert seed == 7 and loaded.rgb_sum.shape == (32, 32, 3)
    resumed = [sh.shard_accum(loaded, sh.Mesh(n, 1, tile_index=i)) for i in range(n)]
    a, _ = _accumulate_blocks(resumed, cornell, n, 2, 7, 256)
    b, _ = _accumulate_blocks(s1, cornell, n, 2, 7, 256)
    for x, y in zip(a, b):
        assert torch.equal(x.rgb_sum, y.rgb_sum)
        assert x.spp == y.spp == 4


def test_dealt_rows_balance_the_ranks_where_contiguous_blocks_do_not():
    # the upstream scene from its default camera: the top rows are sky, one
    # ray a path; contiguous blocks leave rank 0 the sky and rank 3 the
    # bunny, dealt rows give each rank a share of both. `STATS` counts each
    # shard's own rays and tile passes
    scene = t_upload(presets.reference_default(os.path.join(REPO, "assets",
                                                            "bunny.obj")), "cpu")
    cam, cfg = tcam.Camera.reset(), tint.RenderConfig(max_depth=3)
    w, h, n = 64, 128, 4
    n_local = w * h // n
    whole_rays = tint.trace_wavefront(scene, cam, w, h, 1, 5, cfg, 256)[1]
    contiguous = [tint.trace_wavefront(scene, cam, w, h, 1, 5, cfg, 256,
                                       pixel_offset=r * n_local, n_pixels=n_local)[1]
                  for r in range(n)]
    dealt, passes = [], []
    for r in range(n):
        before = dict(sh.STATS)
        _, rays = sh.shard_render_wavefront(scene, cam, w, h, 1, 5, cfg, 256, r, n)
        dealt.append(sh.STATS["rays"] - before["rays"])
        passes.append(sh.STATS["tile_passes"] - before["tile_passes"])
        assert dealt[-1] == rays
    assert sum(dealt) == sum(contiguous) == whole_rays
    assert max(dealt) <= 1.05 * min(dealt), dealt
    assert max(contiguous) > 2 * min(contiguous), contiguous
    assert contiguous[0] == n_local  # the sky: one ray a path
    assert all(p > 0 for p in passes), passes


# --- tests/test_sharding_extra.py -------------------------------------------


def test_sharded_render_with_mesh_scene():
    s = presets.cornell_spheres()
    v, f = icosphere(1, radius=0.7)
    s.add_mesh(v, f, position=(0, 1.0, 0.3), scale=1.0,
               material=Material(albedo=(0.9, 0.8, 0.3)))
    scene = t_upload(s, "cpu")
    cfg = tint.RenderConfig(max_depth=4)
    base, rb = tpipe.render_image(scene, CAM, 16, 16, spp=2, seed=5, cfg=cfg,
                                  spp_per_pass=2)
    img, rays = _joined(_scan_shards(scene, 16, 16, 2, 5, cfg), 8, 1, 2)
    assert torch.equal(img, base) and rays == rb


def test_sharded_nee_rr_matches_single():
    scene = t_upload(presets.cornell_materials(), "cpu")
    cfg = tint.RenderConfig(max_depth=6, nee=True, rr_start=2)
    base, rb = tpipe.render_image(scene, CAM, 16, 16, spp=2, seed=9, cfg=cfg,
                                  spp_per_pass=2)
    img, rays = _joined(_scan_shards(scene, 16, 16, 2, 9, cfg), 8, 1, 2)
    assert torch.equal(img, base) and rays == rb


def test_accumulate_then_shard_consistency(cornell):
    # a progressive accumulation on one device equals a sharded batch render
    # of the same sample ids: checkpoints carry across device layouts
    cfg = tint.RenderConfig(max_depth=4)
    st = tpipe.init_accum(16, 16, "cpu")
    st = tpipe.accumulate(st, cornell, CAM, 16, 16, 4, 3, cfg)
    prog = tpipe.to_image(st, clamp=False)
    sharded, _ = _joined(_scan_shards(cornell, 16, 16, 4, 3, cfg), 4, 1, 4)
    _close(prog, sharded, rtol=1e-6, atol=1e-7)


def test_wavefront_sharded_mesh_scene_bit_identical(cornell_mesh):
    cfg = tint.RenderConfig(max_depth=4)
    base, rb = tpipe.render_image_wavefront(cornell_mesh, CAM, 16, 16, spp=2,
                                            seed=7, cfg=cfg, pool_size=256)
    img, r = _joined(_wavefront_shards(cornell_mesh, 16, 16, 2, 7, cfg, 256),
                     8, 1, 2)
    assert torch.equal(img, base) and r == rb


def test_wavefront_sharded_bit_identical(cornell):
    cfg = tint.RenderConfig(max_depth=4)
    base, rb = tpipe.render_image_wavefront(cornell, CAM, 16, 16, spp=4, seed=3,
                                            cfg=cfg, pool_size=256)
    img, r = _joined(_wavefront_shards(cornell, 16, 16, 4, 3, cfg, 256), 8, 1, 4)
    assert torch.equal(img, base) and r == rb


def test_wavefront_sample_sharded_bit_identical(cornell):
    cfg = tint.RenderConfig(max_depth=4)
    base, rb = tpipe.render_image_wavefront(cornell, CAM, 16, 16, spp=8, seed=3,
                                            cfg=cfg, pool_size=256)
    img, r = _joined(_wavefront_shards(cornell, 16, 16, 8, 3, cfg, 256), 1, 4, 8)
    _close(img, base)  # the join reorders the partial sums' additions
    assert r == rb


def test_wavefront_2d_mesh_bit_identical(cornell_mesh):
    cfg = tint.RenderConfig(max_depth=4)
    base, rb = tpipe.render_image_wavefront(cornell_mesh, CAM, 16, 16, spp=4,
                                            seed=7, cfg=cfg, pool_size=128)
    img, r = _joined(_wavefront_shards(cornell_mesh, 16, 16, 4, 7, cfg, 128),
                     4, 2, 4)
    _close(img, base)
    assert r == rb


def test_wavefront_sharded_streaming_kernel():
    # the reference streams this scene's 1,280 triangles through its slot
    # cache; the port's one closest-hit routine walks its 10 tiles
    s = presets.cornell_spheres()
    v, f = icosphere(3, radius=0.8)
    s.add_mesh(v, f, position=(0, 1.2, 0.0), scale=1.0,
               material=Material(albedo=(0.8, 0.7, 0.2)))
    scene = t_upload(s, "cpu")
    assert scene.num_tris == 1280
    cfg = tint.RenderConfig(max_depth=3)
    base, rb = tpipe.render_image_wavefront(scene, CAM, 16, 16, spp=2, seed=5,
                                            cfg=cfg, pool_size=256)
    img, r = _joined(_wavefront_shards(scene, 16, 16, 2, 5, cfg, 256), 2, 1, 2)
    assert torch.equal(img, base) and r == rb


# --- the entry points in a world of one: no collective ----------------------


WORLD_OF_ONE = {
    "render_image_sharded": ("scan", {}),
    "render_image_sample_sharded": ("scan", {}),
    "render_image_sharded_2d": ("scan", {}),
    "render_image_wavefront_sharded": ("wavefront", dict(pool_size=256)),
    "render_image_sample_sharded_wavefront": ("wavefront", dict(pool_size=256)),
    "render_image_sharded_2d_wavefront": ("wavefront", dict(pool_size=256)),
}


@pytest.mark.parametrize("name", sorted(WORLD_OF_ONE))
def test_world_of_one_equals_the_single_render(cornell_mesh, name):
    kind, kwargs = WORLD_OF_ONE[name]
    cfg = tint.RenderConfig(max_depth=4)
    if kind == "scan":
        base, rb = tpipe.render_image(cornell_mesh, CAM, 16, 16, spp=2, seed=7,
                                      cfg=cfg, spp_per_pass=2)
    else:
        base, rb = tpipe.render_image_wavefront(cornell_mesh, CAM, 16, 16, spp=2,
                                                seed=7, cfg=cfg, pool_size=256)
    img, r = getattr(sh, name)(cornell_mesh, CAM, 16, 16, 2, seed=7, cfg=cfg,
                               **kwargs)
    assert torch.equal(img, base) and r == rb and isinstance(r, int)


def test_world_of_one_accumulates_like_accumulate_wavefront(cornell):
    mesh = sh.make_mesh()
    state = sh.init_accum_sharded(16, 16, mesh, "cpu")
    want = tpipe.init_accum(16, 16, "cpu")
    for _ in range(2):
        kept = state
        state, rays = sh.accumulate_sharded(state, cornell, CAM, 2, seed=3,
                                            mesh=mesh, pool_size=128)
        want, want_rays = tpipe.accumulate_wavefront(
            want, cornell, CAM, 16, 16, 2, 3, pool_size=128)
        assert rays == want_rays
        assert kept.rgb_sum is not state.rgb_sum  # the input stays valid
    assert state.spp == 4 and torch.equal(state.rgb_sum, want.rgb_sum)
    whole = sh.gather_accum(state, mesh)
    assert torch.equal(sh.shard_accum(whole, mesh).rgb_sum, state.rgb_sum)


# ---------------------------------------------------------------------------
# (iii) the entry points under real process groups (gloo, 2 and 4 ranks)
# ---------------------------------------------------------------------------

SPHERES, MESH_SCENE = {"preset": "cornell_spheres"}, {
    "preset": "cornell_mesh", "kwargs": {"subdivisions": 1}}
MATERIALS = {"preset": "cornell_materials"}
DEPTH4 = {"max_depth": 4}
NEE_RR = {"max_depth": 6, "nee": True, "rr_start": 2}


def _render_job(name, fn, scene, size, spp, seed, cfg, mesh, pool=None):
    job = dict(name=name, kind="render", fn=fn, scene=scene, camera=CAM_SPEC,
               width=size, height=size, spp=spp, seed=seed, cfg=cfg, mesh=mesh)
    if pool is not None:
        job["pool_size"] = pool
    return job


def _jobs(world, tmp):
    tiles, samples = {"axis": "tiles"}, {"axis": "samples"}
    grid = {"grid": [2, world // 2]}
    cli = ["--scene", os.path.join(REPO, "scenes", "cornell.xml"), "--width", "32",
           "--height", "32", "--spp", "2", "--max-depth", "4", "--device", "cpu",
           "--stats-json", "--tile-shard"]
    return [
        _render_job("tile_scan", "render_image_sharded", SPHERES, 32, 4, 3, {}, tiles),
        _render_job("tile_scan_mesh", "render_image_sharded", MESH_SCENE, 16, 2, 5,
                    DEPTH4, tiles),
        _render_job("tile_scan_nee_rr", "render_image_sharded", MATERIALS, 16, 2, 9,
                    NEE_RR, tiles),
        _render_job("tile_wavefront", "render_image_wavefront_sharded", MESH_SCENE,
                    16, 2, 7, DEPTH4, tiles, 256),
        _render_job("sample_scan", "render_image_sample_sharded", SPHERES, 32, 8, 3,
                    {}, samples),
        _render_job("sample_wavefront", "render_image_sample_sharded_wavefront",
                    SPHERES, 16, 8, 3, DEPTH4, samples, 256),
        _render_job("grid_scan", "render_image_sharded_2d", SPHERES, 32, 4, 3, {},
                    grid),
        _render_job("grid_wavefront", "render_image_sharded_2d_wavefront", MESH_SCENE,
                    16, 4, 7, DEPTH4, grid, 128),
        dict(name="accumulate", kind="accumulate", scene=SPHERES, camera=CAM_SPEC,
             width=32, height=32, steps=[2, 2], seed=3, mesh=tiles, pool_size=256),
        dict(name="accumulate_resumed", kind="accumulate", scene=SPHERES,
             camera=CAM_SPEC, width=32, height=32, steps=[2, 2], seed=3, mesh=tiles,
             pool_size=256, checkpoint=str(tmp / "sharded.npz")),
        dict(_render_job("bad_height", "render_image_sharded", SPHERES, 32, 1, 0, {},
                         tiles), kind="raises", height=31),
        dict(_render_job("bad_spp", "render_image_sample_sharded", SPHERES, 32,
                         world + 1, 0, {}, samples), kind="raises"),
        dict(name="cli_scan", kind="cli", argv=cli + [
            "--output", str(tmp / "cli_scan.png"), "--npz", str(tmp / "cli_scan.npz")]),
        dict(name="cli_wavefront", kind="cli", argv=cli + [
            "--wavefront", "--pool-size", "256", "--output",
            str(tmp / "cli_wavefront.png"), "--npz", str(tmp / "cli_wavefront.npz")]),
    ]


JOB_NAMES = [j["name"] for j in _jobs(2, Path("."))]


class World(NamedTuple):
    """One launch of a world and what it left: `failure` the launch's or the
    read-back's exception (None if both went through), `why` the launch's
    seconds and the tail of every rank's log (a line a finished job), which
    every assertion about this world carries."""

    n: int
    tmp: Path
    jobs: dict
    results: dict
    files: dict
    failure: str | None
    why: str


LAUNCH_LIMIT_S = 240


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    """One launch per world size: every rank runs every job. The group's
    start and each collective may take 60 s, the whole launch 240 s.
    Everything the ranks left on disk (each job's result from every rank,
    the CLI jobs' images, the resumed job's checkpoint) is read back here,
    right after the launch, so that no test reads the world's directory
    later: what the tests hold are the launch's results, whatever happens
    to its files meanwhile. A launch or read-back that fails does not fail
    here, once for the module: every test of the world fails on it, with
    the launch's seconds and the ranks' logs in its message."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"world{n}")
    spec = dict(world=n, store=str(tmp / "store"), backend="gloo", device="cpu",
                timeout_s=60, threads=1, out_dir=str(tmp), jobs=_jobs(n, tmp))
    jobs = {j["name"]: j for j in spec["jobs"]}
    results, files, failure = {}, {}, None
    t0 = time.perf_counter()
    try:
        worker.launch(spec, limit_s=LAUNCH_LIMIT_S)
        seconds = time.perf_counter() - t0
        results = {name: [worker.load_result(tmp, name, r) for r in range(n)]
                   for name in jobs}
        for name, job in jobs.items():
            if job["kind"] == "cli":
                with np.load(tmp / f"{name}.npz") as z:
                    files[name] = z["radiance"]
            elif job.get("checkpoint"):
                files[name] = load_checkpoint(job["checkpoint"], "cpu")
    except Exception as e:  # noqa: BLE001 - every test of the world reports it
        seconds = time.perf_counter() - t0
        failure = f"{type(e).__name__}: {e}"
    tails = []
    for r in range(n):
        log = tmp / f"rank{r}.log"
        tail = log.read_text()[-1500:] if log.exists() else "(no log)"
        tails.append(f"--- rank {r} ---\n{tail}")
    why = (f"world {n}: launch and read-back {seconds:.1f} s (limit "
           f"{LAUNCH_LIMIT_S} s), pid {os.getpid()}\n" + "\n".join(tails))
    return World(n, tmp, jobs, results, files, failure, why)


def _single_of(job):
    """The render of one device that a render job is held to."""
    host = getattr(presets, job["scene"]["preset"])(**job["scene"].get("kwargs", {}))
    scene = t_upload(host, "cpu")
    cfg = tint.RenderConfig(**job["cfg"])
    size, spp, seed = job["width"], job["spp"], job["seed"]
    if "wavefront" in job["fn"]:
        return tpipe.render_image_wavefront(scene, CAM, size, size, spp=spp, seed=seed,
                                            cfg=cfg, pool_size=job["pool_size"])
    return tpipe.render_image(scene, CAM, size, size, spp=spp, seed=seed, cfg=cfg,
                              spp_per_pass=spp)


@pytest.mark.parametrize("name", JOB_NAMES)
def test_process_group(world, name, cornell):
    n, tmp, jobs = world.n, world.tmp, world.jobs
    why = world.why  # every assertion below carries the launch's record
    assert world.failure is None, f"{world.failure}\n{why}"
    job = jobs[name]
    results = world.results[name]
    if job["kind"] == "render":
        base, rays = _single_of(job)
        for res in results:  # every rank holds the whole image and count
            assert torch.equal(res["image"], results[0]["image"]), why
            assert res["rays"] == rays, why
        if name.startswith("tile_"):
            assert torch.equal(results[0]["image"], base), why
        else:
            _close(results[0]["image"], base, err_msg=why)
    elif job["kind"] == "accumulate":
        base, rays = tpipe.render_image_wavefront(cornell, CAM, 32, 32, spp=4,
                                                  seed=3, pool_size=256)
        straight = world.results["accumulate"][0]
        for res in results:
            assert res["spp"] == 4 and sum(res["rays"]) == rays, why
            # a resumed accumulation equals the uninterrupted one bit for bit
            assert torch.equal(res["rgb_sum"], straight["rgb_sum"]), why
        _close(results[0]["rgb_sum"] / 4.0, base, rtol=1e-6, atol=1e-7, err_msg=why)
        if "checkpoint" in job:
            loaded, seed, _ = world.files[name]
            assert loaded.spp == 2 and seed == 3, why
            assert loaded.rgb_sum.shape == (32, 32, 3), why
    elif job["kind"] == "raises":
        want = (f"image height 31 must divide evenly across {n} tile shards"
                if name == "bad_height"
                else f"spp {n + 1} must divide evenly across {n} shards")
        assert [res["message"] for res in results] == [want] * n, why
    else:
        # rank 0 alone wrote the image and the stats line
        assert [res["rc"] for res in results] == [0] * n, why
        assert all(res["stdout"] == "" for res in results[1:]), why
        lines = results[0]["stdout"].strip().splitlines()
        assert len(lines) == 1 and '"rays"' in lines[0], why
        argv = [a for a in job["argv"] if a != "--tile-shard"]
        out = tmp / f"{name}_single.npz"
        argv[argv.index("--npz") + 1] = str(out)
        argv[argv.index("--output") + 1] = str(tmp / f"{name}_single.png")
        from metalpathtracer_torch import cli as tcli

        assert tcli.main(argv) == 0, why
        with np.load(out) as b:
            np.testing.assert_array_equal(world.files[name], b["radiance"],
                                          err_msg=why)


def test_a_failing_rank_fails_the_launch(tmp_path):
    # rank 0 alone writes the image, into a directory that is a file: its
    # exception ends the launch, and rank 1, which went on to the next job's
    # barrier, is stopped with it
    (tmp_path / "a_file").write_text("")
    argv = ["--scene", os.path.join(REPO, "scenes", "cornell.xml"), "--width", "8",
            "--height", "8", "--spp", "1", "--max-depth", "2", "--device", "cpu",
            "--tile-shard", "--output", str(tmp_path / "a_file" / "x.png")]
    spec = dict(world=2, store=str(tmp_path / "store"), backend="gloo",
                device="cpu", timeout_s=20, out_dir=str(tmp_path),
                jobs=[dict(name="first", kind="cli", argv=argv),
                      dict(name="second", kind="cli", argv=argv)])
    with pytest.raises(RuntimeError, match="rank [01] exited with code") as e:
        worker.launch(spec, limit_s=60)
    assert "a_file" in str(e.value)
    assert not (tmp_path / "second.rank1.pt").exists()


@pytest.mark.parametrize("how", ["exits_0_early", "exit_status_lost"])
def test_a_rank_without_its_results_fails_the_launch(tmp_path, how):
    # a rank that exits 0 before its jobs are done, and a rank whose exit
    # status is lost (SIGCHLD ignored: the kernel reaps it, and its failure
    # reads as code 0): neither world passes for a whole one
    import signal
    import sys

    code = "pass" if how == "exits_0_early" else "import sys; sys.exit(3)"
    spec = dict(world=2, store=str(tmp_path / "store"), backend="gloo",
                device="cpu", timeout_s=20, out_dir=str(tmp_path),
                jobs=[dict(name="only", kind="cli", argv=[])])
    before = signal.getsignal(signal.SIGCHLD)
    if how == "exit_status_lost":
        signal.signal(signal.SIGCHLD, signal.SIG_IGN)
    try:
        with pytest.raises(RuntimeError, match=r"rank 0 exited without the results "
                                               r"of \['only'\]"):
            worker.launch(spec, limit_s=60, command=[sys.executable, "-c", code])
    finally:
        signal.signal(signal.SIGCHLD, before)


def test_a_rank_that_finished_leaves_without_the_interpreter_teardown(tmp_path,
                                                                    monkeypatch):
    # a rank whose jobs are all on disk exits 0 at once: the interpreter's
    # teardown, where a gloo rank could abort with code -6 after its last
    # job, never runs; a rank whose run raises is not made to exit 0
    import json

    spec_file = tmp_path / "spec.json"
    spec_file.write_text(json.dumps({}))
    ran, exits = [], []

    class _Exited(Exception):
        pass

    def fake_exit(code):
        exits.append(code)
        raise _Exited

    monkeypatch.setattr(worker, "_die_with_launcher", lambda: None)
    monkeypatch.setattr(worker, "run_rank", lambda spec, rank: ran.append(rank))
    monkeypatch.setattr(worker.os, "_exit", fake_exit)
    with pytest.raises(_Exited):
        worker.main([str(spec_file), "1"])
    assert ran == [1] and exits == [0]

    def failing(spec, rank):
        raise RuntimeError("a job failed")

    monkeypatch.setattr(worker, "run_rank", failing)
    with pytest.raises(RuntimeError, match="a job failed"):
        worker.main([str(spec_file), "0"])
    assert exits == [0]


# ---------------------------------------------------------------------------
# (iv) against the JAX package's sharded renders
# ---------------------------------------------------------------------------


def test_sharded_renders_match_the_reference_sharded():
    from metalpathtracer_tpu.parallel import (
        render_image_sharded as j_sharded,
        render_image_wavefront_sharded as j_wavefront_sharded,
    )
    from metalpathtracer_tpu.render import camera as jcam
    from metalpathtracer_tpu.render import integrator as jint
    from metalpathtracer_tpu.render import upload_scene as j_upload
    from metalpathtracer_tpu.scene import presets as jpresets

    jscene = j_upload(jpresets.cornell_mesh(subdivisions=1))
    jcamera = jcam.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
    scene = t_upload(presets.cornell_mesh(subdivisions=1), "cpu")
    cfg, jcfg = tint.RenderConfig(max_depth=4), jint.RenderConfig(max_depth=4)

    theirs, j_rays = j_sharded(jscene, jcamera, 32, 32, spp=4, seed=3, cfg=jcfg)
    mine, rays = _joined(_scan_shards(scene, 32, 32, 4, 3, cfg), 8, 1, 4)
    _within_render_limit(mine.numpy(), theirs)
    assert abs(rays - j_rays) <= 0.01 * j_rays

    theirs, j_rays = j_wavefront_sharded(jscene, jcamera, 32, 32, spp=4, seed=3,
                                         cfg=jcfg, pool_size=256)
    mine, rays = _joined(_wavefront_shards(scene, 32, 32, 4, 3, cfg, 256), 8, 1, 4)
    _within_render_limit(mine.numpy(), theirs)
    assert abs(rays - j_rays) <= 0.01 * j_rays
