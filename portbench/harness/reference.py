"""The plain reference: the path tracer's estimator in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
builds its own geometry from the benchmark's scene arrays and its own
camera basis, and draws its own random numbers. It computes, for chosen
(pixel, sample) pairs, the radiance the program's estimator defines
(`metalpathtracer_torch/render/integrator.py`, without next-event
estimation or Russian roulette, the two features no cell turns on):

- a sample's primary ray is jittered in its pixel by the pair of uniforms
  of threefry-2x32 keyed (seed, pixel) with counter (sample, purpose 0 of
  bounce 0), through the Ray-Tracing-in-One-Weekend camera basis;
- each bounce finds the closest sphere or triangle beyond t = 1e-4 (the
  sphere's far root beyond max(3e-5 r, 1e-4)); a miss adds the sky
  gradient times the throughput and ends the path; a hit on an emitter
  adds emission * power times the throughput;
- the scatter direction is the Lambertian, fuzzy-mirror or dielectric
  (Schlick) lobe of the material, from a unit vector (purpose 1) and a
  Fresnel uniform (purpose 2) of (seed, pixel, sample, bounce); the next
  origin is offset 1e-4 along the normal, times max(|p|_inf, 1) where the
  configuration's `adaptive_offset` is on; the throughput takes the albedo;
- a path ends after `max_depth` closest hits; its radiance is the sum.

The same (seed, pixel, sample) gives the same path as the program's, up to
rounding, which moves a path only where it grazes an edge or ties.

`dtype` is the precision of the geometry and shading (float32 as the
configuration states; bfloat16 for the control). The closest hit tests
every triangle of each cluster (64 triangles near in Morton order) whose
padded box the ray enters: exact, and independent of the program's tile
tables.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness.scene import SPHERE, TRIANGLE, SceneArrays

T_MIN = 1e-4
TRI_PARALLEL_EPS = 1e-5
CLUSTER = 64
MASK = 0xFFFFFFFF
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
PURPOSE_JITTER, PURPOSE_LOBE, PURPOSE_FRESNEL = 0, 1, 2
SKY = ((1.0, 1.0, 1.0), (0.6, 0.7, 1.0))  # horizon, zenith


# ---------------------------------------------------------------------------
# random numbers: threefry-2x32, 20 rounds, u32 words held in int64
# ---------------------------------------------------------------------------


def threefry2x32(k0: int, k1, c0, c1):
    """Two u32 words (int64 tensors) of key (k0, k1) and counter (c0, c1)."""
    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & MASK

    k1 = k1 & MASK
    k2 = (PARITY ^ k0) ^ k1
    ks = (k0, k1, k2)
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    for block in range(5):
        for r in ROTATIONS[0:4] if block % 2 == 0 else ROTATIONS[4:8]:
            x0 = (x0 + x1) & MASK
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & MASK
    return x0, x1


def uniforms(seed: int, pixel, sample, bounce: int, purpose: int):
    """The pair of float32 uniforms in [0, 1) (top 24 bits of each word) of
    one (seed, pixel, sample, bounce, purpose) per lane."""
    c1 = ((bounce & MASK) << 8) | purpose
    b0, b1 = threefry2x32(seed & MASK, pixel, sample & MASK,
                          torch.full_like(pixel, c1))
    return ((b0 >> 8).to(torch.float32) * 2.0 ** -24,
            (b1 >> 8).to(torch.float32) * 2.0 ** -24)


# ---------------------------------------------------------------------------
# vector helpers
# ---------------------------------------------------------------------------


def dot(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def normalize(a):
    n2 = dot(a, a)
    inv = torch.where(n2 > 1e-20, 1.0 / torch.sqrt(n2), torch.zeros_like(n2))
    return a * inv[..., None]


def camera_basis(camera: dict, width: int, height: int) -> torch.Tensor:
    """(origin, first pixel, viewport u, viewport v) as a float32 (4, 3)
    tensor: w = -forward, u = up x w, v = w x u, the image plane at focal
    length 1, row 0 at the top."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    pos, fwd, up = f32(camera["position"]), f32(camera["forward"]), f32(camera["up"])
    half_h = torch.tan(f32(camera["vfov_deg"]) * (math.pi / 180.0) * 0.5)
    half_w = (width / height) * half_h
    w = -(fwd / torch.linalg.vector_norm(fwd))
    u = cross(up, w)
    u = u / torch.linalg.vector_norm(u)
    v = cross(w, u)
    vu = u * (2.0 * half_w)
    vv = -v * (2.0 * half_h)
    first = pos - w - 0.5 * vu - 0.5 * vv
    return torch.stack([pos, first, vu, vv])


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _morton(p: np.ndarray) -> np.ndarray:
    lo, hi = p.min(0), p.max(0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


class Geometry:
    """The scene on `device` in `dtype`: spheres as rows, triangles in
    clusters of CLUSTER (Morton order of their centroids, padded with
    triangles that never hit), each cluster with a padded box."""

    def __init__(self, arrays: SceneArrays, device, dtype=torch.float32):
        self.device, self.dtype = device, dtype
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(  # noqa: E731
            device=device, dtype=dtype)
        sph = np.flatnonzero(arrays.kind == SPHERE)
        tri = np.flatnonzero(arrays.kind == TRIANGLE)
        self.sph_id = torch.as_tensor(sph, device=device)
        self.center = put(arrays.p0[sph])
        self.radius = put(arrays.p1[sph, 0])
        self.mat = dict(albedo=put(arrays.albedo), mtype=put(arrays.material_type),
                        emission=put(arrays.emission), power=put(arrays.power),
                        fuzz=put(arrays.fuzz))
        # by primitive row, for the hit's normal
        self.is_sphere = torch.as_tensor(arrays.kind == SPHERE, device=device)
        self.row_p0 = put(arrays.p0)
        self.row_e1 = put(arrays.p1) - self.row_p0
        self.row_e2 = put(arrays.p2) - self.row_p0
        self.n_clusters = 0
        if tri.size:
            v0, v1, v2 = arrays.p0[tri], arrays.p1[tri], arrays.p2[tri]
            order = np.argsort(_morton((v0 + v1 + v2) / 3.0), kind="stable")
            tri, v0, v1, v2 = tri[order], v0[order], v1[order], v2[order]
            c = -(-tri.size // CLUSTER)
            pad = c * CLUSTER - tri.size
            far = np.full((pad, 3), 1e30, np.float32)
            ids = np.concatenate([tri, np.full(pad, -1)]).reshape(c, CLUSTER)
            v0, v1, v2 = (np.concatenate([x, far]).reshape(c, CLUSTER, 3)
                          for x in (v0, v1, v2))
            lo = np.minimum(np.minimum(v0, v1), v2)
            hi = np.maximum(np.maximum(v0, v1), v2)
            real = (ids >= 0)[..., None]
            lo = np.where(real, lo, np.inf).min(1)
            hi = np.where(real, hi, -np.inf).max(1)
            slack = 1e-3 * np.maximum(hi - lo, 1.0) + 1e-3
            self.box_lo = torch.as_tensor(lo - slack, device=device)
            self.box_hi = torch.as_tensor(hi + slack, device=device)
            self.tri_id = torch.as_tensor(ids, device=device)
            self.v0 = put(v0)
            self.e1 = put(v1) - self.v0
            self.e2 = put(v2) - self.v0
            self.n_clusters = c

    # -- spheres: every sphere for every ray
    def _spheres(self, o, d):
        oc = o[:, None, :] - self.center[None]
        a = dot(d, d)[:, None]
        b = dot(oc, d[:, None, :])
        c = dot(oc, oc) - self.radius * self.radius
        disc = b * b - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_near, t_far = (-b - sq) / a, (-b + sq) / a
        floor = torch.clamp(3.0e-5 * self.radius, min=T_MIN)
        inf = torch.full_like(t_near, math.inf)
        t = torch.where((disc > 0) & (t_near > T_MIN), t_near,
                        torch.where((disc > 0) & (t_far > floor), t_far, inf))
        best, j = t.min(1)
        return best, self.sph_id[j]

    # -- triangles: the clusters whose box the ray enters before `t_best`
    def _triangles(self, o, d, t_best, prim):
        o32 = o.float()
        inv = 1.0 / d.float()
        t0 = (self.box_lo[None] - o32[:, None]) * inv[:, None]
        t1 = (self.box_hi[None] - o32[:, None]) * inv[:, None]
        lo = torch.nan_to_num(torch.minimum(t0, t1), nan=-math.inf).amax(-1)
        hi = torch.nan_to_num(torch.maximum(t0, t1), nan=math.inf).amin(-1)
        enter = torch.clamp(lo, min=0.0)
        rays, clus = torch.nonzero((hi >= enter) & (enter <= t_best.float()[:, None]),
                                   as_tuple=True)
        step = max(1, (1 << 21) // CLUSTER)
        for s in range(0, rays.numel(), step):
            r, c = rays[s:s + step], clus[s:s + step]
            ro, rd = o[r][:, None, :], d[r][:, None, :]
            v0, e1, e2 = self.v0[c], self.e1[c], self.e2[c]
            h = cross(rd, e2)
            a = dot(e1, h)
            parallel = torch.abs(a) <= TRI_PARALLEL_EPS
            f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
            sv = ro - v0
            u = f * dot(sv, h)
            q = cross(sv, e1)
            v = f * dot(rd, q)
            t = f * dot(e2, q)
            ok = (~parallel & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                  & (t > T_MIN))
            t = torch.where(ok, t, torch.full_like(t, math.inf))
            tc, k = t.min(1)
            pid = self.tri_id[c, k]
            # the nearest over this block's clusters of each ray
            best = torch.full_like(t_best, math.inf).scatter_reduce(
                0, r, tc, "amin")
            win = (tc == best[r]) & (tc < t_best[r])
            t_best = t_best.scatter(0, r[win], tc[win])
            prim = prim.scatter(0, r[win], pid[win])
        return t_best, prim

    def normal(self, row, point):
        """Unit geometric normal at `point` on primitive `row` (not yet
        flipped to face the ray)."""
        sph = normalize(point - self.row_p0[row])
        tri = normalize(cross(self.row_e1[row], self.row_e2[row]))
        return torch.where(self.is_sphere[row][:, None], sph, tri)

    def closest_hit(self, o, d):
        """(t, primitive row) of each ray; t = inf and row -1 on a miss."""
        n = o.shape[0]
        if self.center.shape[0]:
            t, prim = self._spheres(o, d)
            prim = torch.where(torch.isinf(t), torch.full_like(prim, -1), prim)
        else:
            t = torch.full((n,), math.inf, dtype=self.dtype, device=o.device)
            prim = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        if self.n_clusters:
            step = max(1, (1 << 25) // self.n_clusters)  # rays x clusters a block
            parts = [self._triangles(o[i:i + step], d[i:i + step], t[i:i + step],
                                     prim[i:i + step]) for i in range(0, n, step)]
            t = torch.cat([a for a, _ in parts])
            prim = torch.cat([b for _, b in parts])
        return t, prim


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


def sample_bsdf(d, n, front, mtype, fuzz, unit, u_fresnel):
    """Scatter direction and the offset's sign (+1, -1 for transmission)."""
    one = torch.ones_like(mtype)
    diel = (mtype > 0) & (mtype != 2)
    mirror_m = mtype < 0
    lam = normalize(n + unit)
    lam = torch.where((dot(lam, lam) > 1e-12)[:, None], lam, n)
    refl = d - 2.0 * dot(d, n)[:, None] * n
    mir = normalize(refl + fuzz[:, None] * unit)
    mir = torch.where((dot(mir, n) > 0)[:, None], mir, normalize(refl))
    ior = torch.where(diel, mtype, 1.5 * one)
    eta = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(dot(-d, n), 0.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    x = 1.0 - cos_t
    x2 = x * x
    reflectance = r0 + (1.0 - r0) * (x * (x2 * x2))
    choose_reflect = (eta * sin_t > 1.0) | (reflectance > u_fresnel)
    cos_i = -dot(d, n)[:, None]
    e3 = eta[:, None]
    sin2 = (e3 * e3) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_o = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))
    refr = torch.where(sin2 > 1.0, torch.zeros_like(d), e3 * d + (e3 * cos_i - cos_o) * n)
    dl = torch.where(choose_reflect[:, None], normalize(refl), normalize(refr))
    out = torch.where(diel[:, None], dl, torch.where(mirror_m[:, None], mir, lam))
    sign = torch.where(diel & ~choose_reflect, -one, one)
    return out, sign


def primary_rays(basis, width: int, height: int, seed: int, pixel, sample):
    """The jittered primary rays (o, d) of (pixel, sample), in the basis's
    dtype and on its device: screen coordinates (px + u1) / W, (py + u2) / H
    with row 0 at the top."""
    dt = basis.dtype
    origin, first, vu, vv = basis.unbind(0)
    u1, u2 = uniforms(seed, pixel, sample, 0, PURPOSE_JITTER)
    sx = ((pixel % width).to(dt) + u1.to(dt)) / width
    sy = ((pixel // width).to(dt) + u2.to(dt)) / height
    d = first + sx[:, None] * vu + sy[:, None] * vv - origin
    d = d / torch.sqrt(dot(d, d))[:, None]
    return origin.expand(pixel.shape[0], 3).clone(), d


def radiance(geo: "Geometry", basis: torch.Tensor, width: int, height: int,
             seed: int, pixel: torch.Tensor, sample: torch.Tensor, render: dict):
    """Float32 (N, 3) radiance of each (pixel, sample) path: int64 tensors
    on the geometry's device. `render` holds max_depth, adaptive_offset and
    clamp_radiance."""
    dt, dev = geo.dtype, geo.device
    pixel, sample = pixel.to(dev), sample.to(dev)
    n = pixel.shape[0]
    o, d = primary_rays(basis.to(dev, dt), width, height, seed, pixel, sample)
    light = torch.zeros((n, 3), dtype=dt, device=dev)
    tp = torch.ones((n, 3), dtype=dt, device=dev)
    live = torch.arange(n, device=dev)
    sky_h, sky_z = (torch.tensor(s, dtype=dt, device=dev) for s in SKY)
    m = geo.mat
    for bounce in range(int(render["max_depth"])):
        if live.numel() == 0:
            break
        lo, ld, ltp = o[live], d[live], tp[live]
        t, prim = geo.closest_hit(lo, ld)
        miss = prim < 0
        sky = sky_h + (sky_z - sky_h) * (0.5 * (ld[:, 1] + 1.0))[:, None]
        light.index_add_(0, live[miss], (ltp * sky)[miss])
        hit = ~miss
        live, lo, ld, ltp, t, row = (x[hit] for x in (live, lo, ld, ltp, t, prim))
        power = m["power"][row]
        emit = (power > 0) | (m["mtype"][row] == 2.0)
        glow = ltp * m["emission"][row] * power[:, None]
        light.index_add_(0, live[emit], glow[emit])
        point = lo + t[:, None] * ld
        nrm = geo.normal(row, point)
        front = dot(nrm, ld) < 0
        nrm = torch.where(front[:, None], nrm, -nrm)
        p_, s_ = pixel[live], sample[live]
        a0, a1 = uniforms(seed, p_, s_, bounce, PURPOSE_LOBE)
        z = 2.0 * a0.to(dt) - 1.0
        ang = (2.0 * math.pi) * a1.to(dt)
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        unit = torch.stack([r * torch.cos(ang), r * torch.sin(ang), z], -1)
        uf, _ = uniforms(seed, p_, s_, bounce, PURPOSE_FRESNEL)
        d_out, sign = sample_bsdf(ld, nrm, front, m["mtype"][row], m["fuzz"][row],
                                  unit, uf.to(dt))
        if render.get("adaptive_offset", True):
            scale = torch.clamp(torch.abs(point).amax(-1), min=1.0)
            new_o = point + (1e-4 * sign * scale)[:, None] * nrm
        else:
            new_o = point + (1e-4 * sign)[:, None] * nrm
        o = o.index_copy(0, live, new_o)
        d = d.index_copy(0, live, d_out)
        tp = tp.index_copy(0, live, ltp * m["albedo"][row])
    out = light.float()
    if render.get("clamp_radiance", False):
        out = torch.clamp(out, 0.0, 1.0)
    return out
