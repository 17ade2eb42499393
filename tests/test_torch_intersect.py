"""The port's intersection oracles against the JAX reference's.

`ray_sphere`, `ray_triangle`, `intersect_prims_block` and
`surface_interaction_packed` run the same float32 ops in the same order as
the reference, op by op, so t, normals and flags agree to rtol 1e-6 (an ulp
where a 3-term sum rounds differently). Hit indices and miss masks must be
equal. The brute-force closest hit is the oracle the CUDA kernel is later
held to, so its indices must be equal to the reference's on the reference
scene (bunny + r=10000 ground). Its t is held at rtol 5e-4, atol 1e-2, the
bound of tests/test_intersect_mm.py: the reference's brute pass runs inside
`lax.scan`, where XLA contracts the giant ground sphere's b*b - a*c into an
FMA, and |c| ~ 1e8 makes that rounding visible (~1e-4 relative) in t.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.render import intersect as ti
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_tpu.render import intersect as ji
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_torch import scene as tscene
from metalpathtracer_tpu import scene as jscene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the suite runs in several pytest-xdist workers at once: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _rays(n, seed, span=30.0, center=(0.0, 20.0, 40.0)):
    r = np.random.default_rng(seed)
    o = (r.uniform(-span, span, (n, 3)) + np.asarray(center)).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _same_t(t_port, t_ref):
    t_port = np.asarray(t_port)
    t_ref = np.asarray(t_ref)
    np.testing.assert_array_equal(np.isinf(t_port), np.isinf(t_ref))
    f = np.isfinite(t_ref)
    np.testing.assert_allclose(t_port[f], t_ref[f], rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [1, 2])
def test_ray_sphere_matches(seed):
    o, d = _rays(512, seed, span=12.0, center=(0.0, 0.0, 0.0))
    r = np.random.default_rng(seed + 10)
    c = r.uniform(-6, 6, (512, 3)).astype(np.float32)
    rad = r.uniform(0.2, 8.0, 512).astype(np.float32)
    tj = ji.ray_sphere(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                       jnp.asarray(rad))
    tt = ti.ray_sphere(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(c),
                       torch.as_tensor(rad))
    assert np.isfinite(np.asarray(tj)).sum() > 20
    _same_t(tt.numpy(), tj)


def test_ray_sphere_giant_ground_sphere():
    # r=10000 ground: rays leaving the surface upward must not re-hit it
    # through a spurious far root, and rays from above must hit it at the
    # reference's t
    r = np.random.default_rng(0)
    n = 2048
    x = r.uniform(-3, 3, n).astype(np.float32)
    z = r.uniform(-3, 3, n).astype(np.float32)
    y = (-10000.0 + np.sqrt(1e8 - x * x - z * z) + 1e-4).astype(np.float32)
    o = np.stack([x, y, z], 1)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d[: n // 2, 1] = np.abs(d[: n // 2, 1]) + 0.05
    d[n // 2 :, 1] = -np.abs(d[n // 2 :, 1]) - 0.5
    o[n // 2 :, 1] += 5.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = np.array([[0.0, -10000.0, 0.0]], np.float32)
    rad = np.array([10000.0], np.float32)
    tj = ji.ray_sphere(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), jnp.asarray(rad))
    tt = ti.ray_sphere(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(c),
                       torch.as_tensor(rad))
    assert np.isinf(tt.numpy()[: n // 2]).all()
    assert np.isfinite(tt.numpy()[n // 2 :]).all()
    np.testing.assert_array_equal(np.isinf(tt.numpy()), np.isinf(np.asarray(tj)))
    # |oc|^2 - r^2 cancels at ~1e8: a 3-term sum rounded in another order
    # moves t by ~1e-4 relative (the bound of tests/test_intersect_mm.py)
    np.testing.assert_allclose(tt.numpy()[n // 2 :], np.asarray(tj)[n // 2 :],
                               rtol=5e-4, atol=1e-2)


def test_ray_triangle_matches():
    r = np.random.default_rng(4)
    v0 = r.uniform(-2, 2, (1024, 3)).astype(np.float32)
    v1 = v0 + r.uniform(-2, 2, (1024, 3)).astype(np.float32)
    v2 = v0 + r.uniform(-2, 2, (1024, 3)).astype(np.float32)
    # aim most rays at a point inside (or just outside) their triangle
    o, _ = _rays(1024, 3, span=2.0, center=(0.0, 0.0, 3.0))
    b = r.uniform(-0.1, 0.7, (1024, 2)).astype(np.float32)
    target = v0 + b[:, :1] * (v1 - v0) + b[:, 1:] * (v2 - v0)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # a few exact edge-on and parallel cases
    d[:8] = np.array([1.0, 0.0, 0.0], np.float32)
    v1[:8, 0] = v0[:8, 0] + 1.0
    tj = ji.ray_triangle(*(jnp.asarray(a) for a in (o, d, v0, v1, v2)))
    tt = ti.ray_triangle(*(torch.as_tensor(a) for a in (o, d, v0, v1, v2)))
    assert np.isfinite(np.asarray(tj)).sum() > 50
    _same_t(tt.numpy(), tj)


@pytest.fixture(scope="module")
def scenes():
    path = os.path.join(REPO, "scenes", "reference.xml")
    return j_upload(jscene.load_scene_xml(path)), t_upload(tscene.load_scene_xml(path), "cpu")


def test_intersect_prims_block_matches(scenes):
    js, ts = scenes
    o, d = _rays(96, 5)
    sl = slice(0, 256)  # the 3 spheres, the first triangles and padding
    tj = ji.intersect_prims_block(
        jnp.asarray(o)[:, None], jnp.asarray(d)[:, None], js.prim_type[None, sl],
        js.p0[None, sl], js.p1[None, sl], js.p2[None, sl],
    )
    tt = ti.intersect_prims_block(
        torch.as_tensor(o)[:, None], torch.as_tensor(d)[:, None],
        ts.prim_type[None, sl], ts.p0[None, sl], ts.p1[None, sl], ts.p2[None, sl],
    )
    assert tt.shape == (96, 256)
    _same_t(tt.numpy(), tj)


@pytest.mark.parametrize("chunk", [128, 1000])
def test_closest_hit_bruteforce_matches(scenes, chunk):
    js, ts = scenes
    o, d = _rays(300, 6)
    tj, ij = ji.closest_hit_bruteforce(js, jnp.asarray(o), jnp.asarray(d), chunk=chunk)
    tt, it = ti.closest_hit_bruteforce(ts, torch.as_tensor(o), torch.as_tensor(d),
                                       chunk=chunk)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (np.asarray(ij) >= 0).sum() > 30
    f = np.asarray(ij) >= 0
    np.testing.assert_allclose(tt.numpy()[f], np.asarray(tj)[f], rtol=5e-4,
                               atol=1e-2)


def test_closest_hit_bruteforce_two_prims_and_miss():
    s = tscene.HostScene()
    s.add_sphere((0, 0, -5), 1.0, tscene.Material())
    s.add_triangle((-1, -1, -3), (1, -1, -3), (0, 1, -3), tscene.Material())
    ts = t_upload(s, "cpu")
    o = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, -3.5], [0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    t, idx = ti.closest_hit_bruteforce(ts, o, d)
    np.testing.assert_allclose(t.numpy()[:2], [3.0, 0.5], rtol=1e-5)
    assert np.isinf(t.numpy()[2])
    np.testing.assert_array_equal(idx.numpy(), [1, 0, -1])


def test_surface_interaction_packed_matches(scenes):
    js, ts = scenes
    o, d = _rays(400, 7)
    tj, ij = ji.closest_hit_bruteforce(js, jnp.asarray(o), jnp.asarray(d))
    hit = np.asarray(ij) >= 0
    o, d = o[hit], d[hit]
    t = np.asarray(tj)[hit]
    idx = np.asarray(ij)[hit]
    pj, nj, fj = ji.surface_interaction_packed(
        js.geom_table[jnp.asarray(idx)], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t)
    )
    pt, nt, ft = ti.surface_interaction_packed(
        ts.geom_table[torch.as_tensor(idx).long()], torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(t),
    )
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
