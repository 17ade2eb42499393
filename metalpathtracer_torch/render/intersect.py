"""Ray-primitive intersection oracles, vectorized over (ray, primitive) blocks.

Port of `metalpathtracer_tpu/render/intersect.py`: the exact sphere
quadratic and Moller-Trumbore tests, the slab test of the BVH walk, the
chunked brute-force closest hit, and the surface frame of a hit (from a
gathered row, or from a primitive id: `surface_interaction`). Together
they are the brute oracle the closest-hit kernel is tested against.
Epsilons: ray t_min 1e-4, triangle parallel test 1e-5.
"""

from __future__ import annotations

import torch

from metalpathtracer_torch.core import vecmath as vm
from metalpathtracer_torch.scene import PRIM_SPHERE, PRIM_TRIANGLE

T_MIN = 1e-4
TRI_PARALLEL_EPS = 1e-5
INF = float("inf")


def ray_sphere(o, d, center, radius, t_min=T_MIN):
    """Sphere quadratic over broadcastable (..., 3) rays and centers, with
    `oc = o - center` first (no cancellation on giant spheres); the far
    root counts too (interior views, dielectrics). Returns t (inf on
    miss).

    The far root must exceed a radius-scaled floor: on the r=10000 ground
    sphere, f32 rounding of c = |oc|^2 - r^2 gives a ray leaving the surface
    a spurious far root at t ~ eps*r, while genuine interior chords are far
    longer (see `metalpathtracer_tpu.render.intersect.ray_sphere`).
    """
    oc = o - center
    a = vm.dot(d, d)
    b = vm.dot(oc, d)  # half-b form
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - a * c
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near = (-b - sqrt_d) / a
    t_far = (-b + sqrt_d) / a

    valid = disc > 0.0
    far_floor = torch.clamp(3.0e-5 * radius, min=t_min)
    ok_near = valid & (t_near > t_min)
    ok_far = valid & (t_far > far_floor)
    return torch.where(ok_near, t_near, torch.where(ok_far, t_far, INF))


def ray_triangle(o, d, v0, v1, v2, t_min=T_MIN):
    """Moller-Trumbore over broadcastable (..., 3) rays and triangle verts.
    Returns t (inf on miss)."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = vm.cross(d, e2)
    a = vm.dot(e1, h)
    parallel = torch.abs(a) <= TRI_PARALLEL_EPS
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = o - v0
    u = f * vm.dot(s, h)
    q = vm.cross(s, e1)
    v = f * vm.dot(d, q)
    t = f * vm.dot(e2, q)
    ok = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
    )
    return torch.where(ok, t, INF)


def ray_aabb(o, inv_d, box_lo, box_hi, t_min, t_max):
    """Slab test of rays against boxes, broadcastable over (..., 3);
    `t_max` is the ray's current closest hit. Returns bool.

    0 * inf = NaN when a direction component is 0 and the origin lies on
    the box plane; such an axis does not constrain the interval, so that
    axis-parallel rays do not falsely miss."""
    t0 = (box_lo - o) * inv_d
    t1 = (box_hi - o) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    lo = torch.where(torch.isnan(lo), -INF, lo)
    hi = torch.where(torch.isnan(hi), INF, hi)
    enter = torch.clamp(lo.amax(dim=-1), min=t_min)
    exit_ = torch.minimum(hi.amin(dim=-1), t_max)
    return exit_ > enter


def intersect_prims_block(o, d, prim_type, p0, p1, p2, t_min=T_MIN):
    """Intersect rays against a block of primitives laid out broadcast-
    compatibly (e.g. (N, 1, 3) rays against (1, C, 3) primitives).
    Returns t (N, C): inf where missed or padding."""
    t_sph = ray_sphere(o, d, p0, p1[..., 0], t_min)
    t_tri = ray_triangle(o, d, p0, p1, p2, t_min)
    return torch.where(
        prim_type == PRIM_SPHERE,
        t_sph,
        torch.where(prim_type == PRIM_TRIANGLE, t_tri, INF),
    )


def closest_hit_bruteforce(scene, o, d, t_min=T_MIN, chunk: int = 128):
    """Closest hit by testing every primitive, `chunk` primitives at a time.
    Exact: the oracle for the closest-hit kernel.

    Returns (t float32 (N,), prim_idx int32 (N,), -1 on miss). Ties keep
    the lowest primitive index.
    """
    total = scene.prim_type.shape[0]
    n = o.shape[0]
    o_b = o[:, None, :]
    d_b = d[:, None, :]
    best_t = torch.full((n,), INF, dtype=torch.float32, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for base in range(0, total, chunk):
        sl = slice(base, min(base + chunk, total))
        t = intersect_prims_block(
            o_b, d_b, scene.prim_type[None, sl], scene.p0[None, sl],
            scene.p1[None, sl], scene.p2[None, sl], t_min,
        )
        tj, j = torch.min(t, dim=1)
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_i = torch.where(better, (base + j).to(torch.int32), best_i)
    return best_t, best_i


def surface_interaction_packed(geom_row, o, d, t):
    """Hit point, geometric normal (flipped to oppose the ray) and front-
    face flag from a gathered (N, 16) row of `scene.geom_table`
    ([p0, p1, p2, prim_type, 0...])."""
    p0 = geom_row[:, 0:3]
    p1 = geom_row[:, 3:6]
    p2 = geom_row[:, 6:9]
    ptype = geom_row[:, 9]

    point = o + t[..., None] * d
    sph_n = vm.normalize(point - p0)
    tri_n = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    normal = vm.where3(ptype == PRIM_SPHERE, sph_n, tri_n)
    front_face = vm.dot(normal, d) < 0.0
    normal = vm.where3(front_face, normal, -normal)
    return point, normal, front_face


def surface_interaction(scene, o, d, t, prim_idx):
    """Hit point, geometric normal (flipped to oppose the ray) and front-
    face flag of each ray's hit on primitive `prim_idx` at distance `t`:
    `surface_interaction_packed` on the primitives' rows of
    `scene.geom_table`. `prim_idx` may be -1 (a miss): the outputs there
    are garbage and the caller masks them."""
    row = scene.geom_table[prim_idx.clamp(min=0).to(torch.int64)]
    return surface_interaction_packed(row, o, d, t)
