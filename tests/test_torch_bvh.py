"""The port's BVH study path (`accel/bvh.py`, `accel/native.py`,
`intersect.ray_aabb`, `traverse.closest_hit_bvh`, `intersector="bvh"`)
against the JAX package and the port's brute oracle, on the CPU.

Tolerances:
- the builders are the same numpy on both sides: every array bit-equal;
- `ray_aabb`: the same float32 slab arithmetic: the masks are equal;
- `closest_hit_bvh` vs the port's brute oracle: both test a (ray,
  primitive) pair with the same `intersect_prims_block`, so t is bit-equal
  and the primitive equal, whatever order the walk visits the leaves in
  (an equal t at two primitives would be a tie; the seeded rays have none);
- `closest_hit_bvh` vs the JAX walk: XLA may contract the intersection
  tests' products into FMAs, so the primitive agrees on all but 0.1% of
  rays and t to rtol 5e-4, atol 1e-2 (the closest-hit bound of
  tests/test_torch_closest_hit.py) on triangles; on the scene's spheres
  (the ground has r = 10000) a grazing ray's contracted `b*b - a*c` moves t
  further: rtol 5e-3 there, on at most 0.1% of rays beyond the triangles'
  bound;
- a `--intersector bvh` render vs `mm`: the render bound of
  tests/test_torch_render.py (under 2% of pixels differ by > 1e-3, means
  within 5e-3).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch import accel as taccel
from metalpathtracer_torch import cli as tcli
from metalpathtracer_torch.accel import native as tnative
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render.device_scene import scene_from_jax
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.render.intersect import closest_hit_bruteforce, ray_aabb
from metalpathtracer_torch.render.pipeline import render_image
from metalpathtracer_torch.render.traverse import closest_hit_bvh
from metalpathtracer_torch.scene import load_scene_xml, presets
from metalpathtracer_tpu import accel as jaccel
from metalpathtracer_tpu.accel import native as jnative
from metalpathtracer_tpu.render import intersect as jintersect
from metalpathtracer_tpu.render import traverse as jtraverse
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu.scene import load_scene_xml as j_load_scene_xml
from metalpathtracer_tpu.scene import presets as jpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "scenes", "reference.xml")
torch.set_num_threads(1)
ARRAYS = ("node_lo", "node_hi", "node_a", "node_b", "prim_indices")


def _assert_bvh_equal(mine, theirs):
    assert mine.num_nodes == theirs.num_nodes
    assert mine.max_depth == theirs.max_depth
    for name in ARRAYS:
        a, b = getattr(mine, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


SCENES = {
    "cornell": lambda p, load: p.cornell_spheres(),
    "bunny": lambda p, load: load(REFERENCE),
    "cloud": lambda p, load: p.random_tri_cloud(2000, seed=1),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_bvh_equals_the_reference(name):
    packed = SCENES[name](presets, load_scene_xml).pack()
    j_packed = SCENES[name](jpresets, j_load_scene_xml).pack()
    mine = taccel.build_bvh(packed)
    _assert_bvh_equal(mine, jaccel.build_bvh(j_packed))
    lo, hi = packed.aabbs()
    taccel.validate_bvh(mine, lo[: packed.num_real], hi[: packed.num_real])
    assert mine.node_b[mine.node_b > 0].max() <= taccel.LEAF_SIZE == jaccel.LEAF_SIZE
    if name == "bunny":
        assert mine.num_nodes > 500 and mine.max_depth < 64


DEGENERATE = {
    "single": (np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32)),
    "coincident": (np.zeros((100, 3), np.float32), np.ones((100, 3), np.float32)),
    "zero_area": (np.zeros((20, 3), np.float32), np.zeros((20, 3), np.float32)),
}


@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_build_bvh_degenerate_cases_equal_the_reference(name):
    lo, hi = DEGENERATE[name]
    mine = taccel.build_bvh_from_aabbs(lo, hi)
    _assert_bvh_equal(mine, jaccel.build_bvh_from_aabbs(lo, hi))
    taccel.validate_bvh(mine, lo, hi)
    assert mine.node_b[mine.node_b > 0].max() <= 8
    if name == "single":
        assert mine.num_nodes == 1 and mine.node_b[0] == 1


def test_build_bvh_empty_raises():
    with pytest.raises(ValueError):
        taccel.build_bvh_from_aabbs(np.zeros((0, 3)), np.zeros((0, 3)))


def test_native_builder_is_looked_for_where_the_reference_looks():
    # the same native/libmptbvh.so: the port never builds it, and behaves as
    # the reference does with or without it
    assert tnative._LIB_PATHS == jnative._LIB_PATHS
    assert tnative.native_available() == jnative.native_available()
    packed = presets.cornell_spheres().pack()
    if not tnative.native_available():
        with pytest.raises(RuntimeError, match="make -C native"):
            taccel.build_bvh(packed, backend="native")
        with pytest.raises(RuntimeError, match="make -C native"):
            lo, hi = packed.aabbs()
            tnative.build_bvh_native(lo, hi)
    _assert_bvh_equal(taccel.build_bvh(packed, backend="numpy"),
                      taccel.build_bvh(packed, backend="auto"))


@pytest.fixture(scope="module")
def scenes():
    return j_upload(j_load_scene_xml(REFERENCE)), t_upload(load_scene_xml(REFERENCE),
                                                          "cpu", bvh=True)


def test_scene_carries_the_reference_bvh(scenes):
    js, ts = scenes
    for name in ARRAYS:
        a, b = getattr(ts, name), np.asarray(getattr(js, name))
        assert a.dtype == torch.as_tensor(np.array(b)).dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert ts.max_depth == js.max_depth and isinstance(ts.max_depth, int)
    assert ts.prim_indices.shape == ts.prim_type.shape  # padded like the prims
    # scene_from_jax carries them too
    arrays = {f.name: (v if isinstance(v := getattr(js, f.name), int) else np.asarray(v))
              for f in dataclasses.fields(js)}
    moved = scene_from_jax(arrays, "cpu")
    for name in ARRAYS:
        assert torch.equal(getattr(moved, name), getattr(ts, name)), name
    assert moved.max_depth == ts.max_depth
    bvh = taccel.build_bvh(load_scene_xml(REFERENCE).pack())
    assert ts.max_depth == bvh.max_depth and ts.node_a.shape[0] == bvh.num_nodes


def test_scene_without_bvh_has_empty_node_tables_and_the_walk_raises(scenes):
    # only intersector="bvh" reads the BVH, so upload_scene builds it on
    # request; every other table is the same with and without it
    _, ts = scenes
    bare = t_upload(load_scene_xml(REFERENCE), "cpu")
    for f in dataclasses.fields(bare):
        a, b = getattr(bare, f.name), getattr(ts, f.name)
        if f.name in ARRAYS[:4]:
            assert a.shape[0] == 0 and a.dtype == b.dtype and a.shape[1:] == b.shape[1:]
        elif f.name == "prim_indices":
            assert a.shape == b.shape and not a.any()
        elif f.name == "max_depth":
            assert a == 0
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    with pytest.raises(ValueError, match="bvh=True"):
        closest_hit_bvh(bare, o, d)
    with pytest.raises(ValueError, match="bvh=True"):
        render_image(bare, tcam.Camera.reset(), 4, 4, spp=1,
                     cfg=tint.RenderConfig(max_depth=1, intersector="bvh"))


def _rays(n, seed):
    """Random rays, every other one aimed at the bunny."""
    r = np.random.default_rng(seed)
    o = (r.uniform(-30, 30, (n, 3)) + [0.0, 20.0, 40.0]).astype(np.float32)
    d = r.standard_normal((n, 3))
    target = np.asarray([-25.0, 5.0, 0.0]) + r.uniform(-6.0, 6.0, (n, 3))
    d[1::2] = (target - o)[1::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def test_ray_aabb_equals_the_reference(scenes):
    js, ts = scenes
    o, d = _rays(2048, 1)
    # axis-parallel rays starting on a box plane: 0 * inf = NaN on that axis
    d[:8] = [0.0, 0.0, -1.0]
    o[:8, 0] = ts.node_lo[0, 0].item()
    r = np.random.default_rng(2)
    # half the boxes from the top of the tree (often entered), half from
    # anywhere in it (mostly missed)
    node = np.where(np.arange(2048) % 2 == 0, r.integers(0, 8, 2048),
                    r.integers(0, ts.node_lo.shape[0], 2048))
    t_max = np.where(r.uniform(size=2048) > 0.5, r.uniform(1, 100, 2048),
                     np.inf).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    mine = ray_aabb(torch.as_tensor(o), torch.as_tensor(inv), ts.node_lo[node],
                    ts.node_hi[node], 1e-4, torch.as_tensor(t_max))
    theirs = jintersect.ray_aabb(jnp.asarray(o), jnp.asarray(inv), js.node_lo[node],
                                 js.node_hi[node], 1e-4, jnp.asarray(t_max))
    assert mine.dtype == torch.bool and 100 < int(mine.sum()) < 1900
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    # the root box against the first eight: entered, not NaN-rejected
    root = ray_aabb(torch.as_tensor(o[:8]), torch.as_tensor(inv[:8]), ts.node_lo[0],
                    ts.node_hi[0], 1e-4, torch.full((8,), float("inf")))
    np.testing.assert_array_equal(
        root.numpy(), np.asarray(jintersect.ray_aabb(
            jnp.asarray(o[:8]), jnp.asarray(inv[:8]), js.node_lo[0], js.node_hi[0],
            1e-4, jnp.full((8,), jnp.inf))))


def test_closest_hit_bvh_equals_the_oracle_and_the_reference(scenes):
    js, ts = scenes
    o, d = _rays(2048, 3)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    t, idx = closest_hit_bvh(ts, to, td)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    t0, i0 = closest_hit_bruteforce(ts, to, td)
    assert torch.equal(idx, i0) and torch.equal(t, t0)
    assert int((idx >= 3).sum()) > 400 and int((idx < 0).sum()) > 0
    jt, ji = jtraverse.closest_hit_bvh(js, jnp.asarray(o), jnp.asarray(d))
    jt, ji = np.asarray(jt), np.asarray(ji)
    same = idx.numpy() == ji
    assert (~same).mean() <= 1e-3
    tri = same & (ji >= 3)
    np.testing.assert_allclose(t.numpy()[tri], jt[tri], rtol=5e-4, atol=1e-2)
    sph = same & (ji >= 0) & (ji < 3)
    np.testing.assert_allclose(t.numpy()[sph], jt[sph], rtol=5e-3, atol=1e-2)
    loose = ~np.isclose(t.numpy()[sph], jt[sph], rtol=5e-4, atol=1e-2)
    assert loose.sum() <= 1e-3 * len(o)
    assert np.isinf(t.numpy()[same & (ji < 0)]).all()


def test_closest_hit_bvh_drops_pushes_past_the_stack_bound(scenes):
    # a stack of 3 slots (max_depth 1) cannot hold the walk: pushes past it
    # are dropped, as the reference drops them, so hits go missing but
    # nothing is written out of range and every reported hit is a true one
    js, ts = scenes
    o, d = _rays(512, 5)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    small = dataclasses.replace(ts, max_depth=1)
    t, idx = closest_hit_bvh(small, to, td)
    jt, ji = jtraverse.closest_hit_bvh(dataclasses.replace(js, max_depth=1),
                                       jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    t0, i0 = closest_hit_bruteforce(ts, to, td)
    assert int((idx != i0).sum()) > 0  # the bound really bit
    found = idx >= 0
    assert bool((t[found] >= t0[found]).all())


def test_bvh_intersector_renders_like_mm(scenes):
    _, ts = scenes
    cam = tcam.Camera.reset()
    a, ra = render_image(ts, cam, 24, 16, spp=2, seed=5,
                         cfg=tint.RenderConfig(max_depth=4, intersector="bvh"))
    b, rb = render_image(ts, cam, 24, 16, spp=2, seed=5,
                         cfg=tint.RenderConfig(max_depth=4, intersector="mm"))
    diff = np.abs(a.numpy() - b.numpy())
    assert (diff > 1e-3).mean() < 0.02
    assert abs(a.numpy().mean() - b.numpy().mean()) < 5e-3
    assert abs(ra - rb) <= 0.01 * rb
    with pytest.raises(ValueError, match="unknown intersector"):
        render_image(ts, cam, 4, 4, spp=1,
                     cfg=tint.RenderConfig(max_depth=1, intersector="octree"))


def test_cli_accepts_intersector_bvh(tmp_path):
    from metalpathtracer_torch.io.png import read_png

    out = tmp_path / "bvh.png"
    rc = tcli.main(["--scene", REFERENCE, "--width", "16", "--height", "9",
                    "--spp", "1", "--max-depth", "3", "--device", "cpu",
                    "--intersector", "bvh", "--output", str(out)])
    assert rc == 0 and read_png(str(out)).shape == (9, 16, 3)
    assert tint.RenderConfig().intersector == "auto"  # never bvh by default
