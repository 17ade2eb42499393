"""The plain reference: the path tracer's estimator in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
builds its own geometry and light table from the benchmark's scene arrays
and its own camera basis, and draws its own random numbers. It computes,
for chosen (pixel, sample) pairs, the radiance the program's estimator
defines (`metalpathtracer_torch/render/integrator.py`), with next-event
estimation and Russian roulette where the configuration's `render` turns
them on (`nee`, `rr_start`):

- a sample's primary ray is jittered in its pixel by the pair of uniforms
  of threefry-2x32 keyed (seed, pixel) with counter (sample, purpose 0 of
  bounce 0), through the Ray-Tracing-in-One-Weekend camera basis;
- each bounce finds the closest sphere or triangle beyond t = 1e-4 (the
  sphere's far root beyond max(3e-5 r, 1e-4)); a miss adds the sky
  gradient times the throughput and ends the path; a hit on an emitter
  adds emission * power times the throughput (with NEE, times the BSDF
  route's MIS weight below);
- with NEE, on a Lambertian or glossy hit that does not emit: one light
  of the light table (every sphere whose power times largest emission
  channel is above 0), picked in proportion to its flux (largest emission
  channel * power * area) by the `LIGHT_PICK` uniform (purpose 6) through
  an inclusive CDF searched from the left; a direction uniform in the cone
  the light subtends, from the `LIGHT` pair (purpose 4), in the frame of
  the helper axis y where the cone's axis is near x, else x (no sample from
  inside the light); the shadow ray from the hit point + 1e-3 * normal,
  which lights the hit only if its first hit within 1.001 times the
  distance to the light's center is the light's own sphere; the light's
  radiance times albedo * pdf_bsdf / pdf_light * w_light, where pdf_bsdf
  is cos / pi (Lambertian) or the fuzzy mirror's pdf (glossy), and w_light
  the power heuristic pdf_light^2 / (pdf_light^2 + pdf_bsdf^2);
- with NEE, the scattered direction's pdf (the same two lobes, 0 on other
  lobes) is carried to the next bounce, where emission found by the BSDF
  route is weighted by pdf_bsdf^2 / (pdf_bsdf^2 + pdf_light^2), with
  pdf_light the density with which the light sampler would have drawn
  that direction from the ray's origin (1 where no pdf was carried);
- the scatter direction is the Lambertian, fuzzy-mirror or dielectric
  (Schlick) lobe of the material, from a unit vector (purpose 1) and a
  Fresnel uniform (purpose 2) of (seed, pixel, sample, bounce); the next
  origin is offset 1e-4 along the normal, times max(|p|_inf, 1) where the
  configuration's `adaptive_offset` is on; the throughput takes the albedo;
- with roulette, from bounce `rr_start` on: p = clamp(max channel of the
  throughput, 0.05, 1); the path goes on if the `RR` uniform (purpose 3)
  is under p, with its throughput divided by p, and else adds nothing more;
- a path ends after `max_depth` closest hits; its radiance is the sum.

The program draws a step's lobe, Fresnel, light pick, light pair and
roulette uniforms in one bundle; each is keyed by its purpose alone, so the
reference draws each on its own. Departure: the program's light table also
holds emissive triangles (sampled by area); the reference raises where NEE
is on and a triangle emits, since no configuration has one.

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
PURPOSE_JITTER, PURPOSE_LOBE, PURPOSE_FRESNEL, PURPOSE_RR = 0, 1, 2, 3
PURPOSE_LIGHT, PURPOSE_LIGHT_PICK = 4, 6
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
        # the light table: every sphere that emits, picked in proportion to
        # its flux (float32 on the host, as the scene's arrays are)
        bright = arrays.power * arrays.emission.max(-1)
        lights = np.flatnonzero((arrays.kind == SPHERE) & (bright > 0))
        self.emissive_triangles = int(((arrays.kind == TRIANGLE) & (bright > 0)).sum())
        radius = arrays.p1[lights, 0]
        flux = bright[lights] * (4.0 * np.pi * radius * radius)
        pick = flux / flux.sum() if lights.size else flux
        cdf = np.cumsum(pick)
        if lights.size:
            cdf[-1] = 1.0  # no uniform searches past the last light
        self.n_lights = int(lights.size)
        self.light_row = torch.as_tensor(lights, device=device)
        self.light_center = put(arrays.p0[lights])
        self.light_radius = put(radius)
        self.light_radiance = put(arrays.emission[lights] * arrays.power[lights, None])
        self.light_pick = put(pick)
        self.light_cdf = torch.as_tensor(cdf.astype(np.float32), device=device)
        row_light = np.full(arrays.kind.shape[0], -1, np.int64)
        row_light[lights] = np.arange(lights.size)
        self.row_light = torch.as_tensor(row_light, device=device)
        # the cone frame's helper axes: y where the cone's axis is near x, else x
        self.axis_y, self.axis_x = put(np.eye(3, dtype=np.float32)[[1, 0]]).unbind(0)
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


def glossy_pdf(refl, fuzz, w):
    """Solid-angle pdf of the fuzzy-mirror lobe normalize(refl + fuzz * s),
    s uniform on the unit sphere, toward unit `w`: (cos 2t + r^2) /
    (2 pi r sqrt(r^2 - sin^2 t)) inside the cone sin t < r = fuzz, 0 outside
    it or where r is outside (0, 1)."""
    r2 = fuzz * fuzz
    cos_t = dot(refl, w)
    sin2 = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
    disc = r2 - sin2
    inside = (disc > 0.0) & (cos_t > 0.0) & (fuzz > 0.0) & (fuzz < 1.0)
    root = torch.sqrt(torch.clamp(disc, min=1e-20))
    pdf = (2.0 * cos_t * cos_t - 1.0 + r2) / (
        2.0 * math.pi * torch.clamp(fuzz, min=1e-8) * root)
    return torch.where(inside, pdf, torch.zeros_like(pdf))


def bsdf_pdf(glossy, refl, fuzz, nrm, w):
    """The pdf of direction `w` under the Lambertian (cos / pi) or, where
    `glossy`, the fuzzy-mirror lobe."""
    return torch.where(glossy, glossy_pdf(refl, fuzz, w),
                       torch.clamp(dot(nrm, w), min=0.0) / math.pi)


def sphere_cone_pdf(center, radius, point):
    """Solid-angle pdf of a direction drawn uniformly in the cone that the
    sphere subtends from `point`: 1 / (2 pi (1 - cos_max)); 0 from inside."""
    to_c = center - point
    dist2 = dot(to_c, to_c)
    sin_max2 = torch.clamp(radius * radius / torch.clamp(dist2, min=1e-20), 0.0, 1.0)
    cos_max = torch.sqrt(1.0 - sin_max2)
    pdf = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-12)
    return torch.where(dist2 > radius * radius, pdf, torch.zeros_like(pdf))


def sample_light(geo: "Geometry", point, u_pick, u1, u2):
    """One light sample from each point: (unit direction, distance to the
    light's center, the light's radiance, pdf (solid angle, times the pick
    probability; 0 where invalid), the light's primitive row, valid)."""
    j = torch.searchsorted(geo.light_cdf, u_pick.float().contiguous(), side="left")
    j = j.clamp(0, geo.n_lights - 1)
    center, radius, pick = geo.light_center[j], geo.light_radius[j], geo.light_pick[j]
    to_c = center - point
    dist2 = torch.clamp(dot(to_c, to_c), min=1e-20)
    cdist = torch.sqrt(dist2)
    w = to_c / cdist[:, None]
    sin_max2 = torch.clamp(radius * radius / dist2, 0.0, 1.0)
    cos_max = torch.sqrt(1.0 - sin_max2)
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2
    a = torch.where((torch.abs(w[:, 0]) > 0.9)[:, None], geo.axis_y, geo.axis_x)
    t1 = normalize(cross(a, w))
    t2 = cross(w, t1)
    ldir = (t1 * (sin_t * torch.cos(phi))[:, None] + t2 * (sin_t * torch.sin(phi))[:, None]
            + w * cos_t[:, None])
    pdf = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-12)
    valid = (pick > 0.0) & (dist2 > radius * radius)  # no cone from inside the light
    pdf = torch.where(valid, pick * pdf, torch.zeros_like(pdf))
    return ldir, cdist, geo.light_radiance[j], pdf, geo.light_row[j], valid


def light_pdf_toward(geo: "Geometry", origin, row):
    """The pdf (with the pick probability) with which `sample_light` would
    draw, from `origin`, a direction whose first hit is primitive `row`; 0
    where `row` is no light."""
    lid = geo.row_light[row]
    k = lid.clamp(min=0)
    pdf = sphere_cone_pdf(geo.light_center[k], geo.light_radius[k], origin) * geo.light_pick[k]
    return torch.where(lid >= 0, pdf, torch.zeros_like(pdf))


def mis_weight(pdf_a, pdf_b):
    """The power heuristic's weight of the route with density `pdf_a`."""
    return (pdf_a * pdf_a) / torch.clamp(pdf_a * pdf_a + pdf_b * pdf_b, min=1e-20)


def direct_light(geo: "Geometry", seed: int, pixel, sample, bounce: int, point, nrm,
                 refl, row, tp, glossy, diffuse, emits):
    """Next-event estimation at each hit: (the light's MIS-weighted
    contribution, float (N, 3); the lanes it ran on, whose next bounce
    carries its scatter's pdf)."""
    dt = geo.dtype
    m = geo.mat
    fuzz = m["fuzz"][row]
    u_pick, _ = uniforms(seed, pixel, sample, bounce, PURPOSE_LIGHT_PICK)
    u1, u2 = uniforms(seed, pixel, sample, bounce, PURPOSE_LIGHT)
    ldir, ldist, lrad, pdf_l, lrow, valid = sample_light(geo, point, u_pick, u1.to(dt),
                                                         u2.to(dt))
    cos_s = dot(nrm, ldir)
    pdf_b = bsdf_pdf(glossy, refl, fuzz, nrm, ldir)
    cand = (cos_s > 0.0) & valid & ~emits & (diffuse | (glossy & (pdf_b > 0.0)))
    out = torch.zeros_like(tp)
    c = torch.nonzero(cand).squeeze(1)
    if c.numel():
        s_o = point[c] + 1e-3 * nrm[c]
        st, srow = geo.closest_hit(s_o, ldir[c])
        lit = (srow == lrow[c]) & (st <= ldist[c] * 1.001)
        scale = pdf_b[c] * mis_weight(pdf_l[c], pdf_b[c]) / torch.clamp(pdf_l[c], min=1e-12)
        contrib = tp[c] * m["albedo"][row[c]] * lrad[c] * scale[:, None]
        out[c[lit]] = contrib[lit]
    return out, (diffuse | glossy) & ~emits


def radiance(geo: "Geometry", basis: torch.Tensor, width: int, height: int,
             seed: int, pixel: torch.Tensor, sample: torch.Tensor, render: dict):
    """Float32 (N, 3) radiance of each (pixel, sample) path: int64 tensors
    on the geometry's device. `render` holds max_depth, adaptive_offset,
    clamp_radiance and, where on, nee and rr_start."""
    dt, dev = geo.dtype, geo.device
    pixel, sample = pixel.to(dev), sample.to(dev)
    n = pixel.shape[0]
    nee = bool(render.get("nee", False))
    rr_start = int(render.get("rr_start", 0))
    if nee and geo.emissive_triangles:
        raise ValueError(f"the reference samples spheres alone as lights; the scene has "
                         f"{geo.emissive_triangles} emissive triangles")
    nee = nee and geo.n_lights > 0
    o, d = primary_rays(basis.to(dev, dt), width, height, seed, pixel, sample)
    light = torch.zeros((n, 3), dtype=dt, device=dev)
    tp = torch.ones((n, 3), dtype=dt, device=dev)
    prev_pdf = torch.zeros((n,), dtype=dt, device=dev)  # the last scatter's pdf
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
        mtype = m["mtype"][row]
        emit = (power > 0) | (mtype == 2.0)
        glow = ltp * m["emission"][row] * power[:, None]
        if nee:  # weighted against the light sampler's density
            pdf_prev = prev_pdf[live]
            pdf_l = light_pdf_toward(geo, lo, row)
            w = torch.where(pdf_prev > 0.0, mis_weight(pdf_prev, pdf_l),
                            torch.ones_like(pdf_l))
            glow = glow * w[:, None]
        light.index_add_(0, live[emit], glow[emit])
        point = lo + t[:, None] * ld
        nrm = geo.normal(row, point)
        front = dot(nrm, ld) < 0
        nrm = torch.where(front[:, None], nrm, -nrm)
        p_, s_ = pixel[live], sample[live]
        fuzz = m["fuzz"][row]
        if nee:
            glossy = (mtype < 0.0) & (fuzz > 0.0) & (fuzz < 1.0)
            diffuse = (mtype == 0.0) | (mtype == 2.0)
            refl = ld - 2.0 * dot(ld, nrm)[:, None] * nrm
            direct, nee_ran = direct_light(geo, seed, p_, s_, bounce, point, nrm, refl,
                                           row, ltp, glossy, diffuse, emit)
            light.index_add_(0, live, direct)
        a0, a1 = uniforms(seed, p_, s_, bounce, PURPOSE_LOBE)
        z = 2.0 * a0.to(dt) - 1.0
        ang = (2.0 * math.pi) * a1.to(dt)
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        unit = torch.stack([r * torch.cos(ang), r * torch.sin(ang), z], -1)
        uf, _ = uniforms(seed, p_, s_, bounce, PURPOSE_FRESNEL)
        d_out, sign = sample_bsdf(ld, nrm, front, mtype, fuzz, unit, uf.to(dt))
        if render.get("adaptive_offset", True):
            scale = torch.clamp(torch.abs(point).amax(-1), min=1.0)
            new_o = point + (1e-4 * sign * scale)[:, None] * nrm
        else:
            new_o = point + (1e-4 * sign)[:, None] * nrm
        new_tp = ltp * m["albedo"][row]
        if nee:
            pdf_next = bsdf_pdf(glossy, refl, fuzz, nrm, d_out)
            prev_pdf = prev_pdf.index_copy(
                0, live, torch.where(nee_ran, pdf_next, torch.zeros_like(pdf_next)))
        if rr_start > 0 and bounce >= rr_start:  # Russian roulette
            u_rr, _ = uniforms(seed, p_, s_, bounce, PURPOSE_RR)
            p = torch.clamp(new_tp.amax(-1), 0.05, 1.0)
            new_tp = new_tp * (1.0 / p)[:, None]
            go_on = u_rr.to(dt) < p
            live, new_o, d_out, new_tp = (x[go_on] for x in (live, new_o, d_out, new_tp))
        o = o.index_copy(0, live, new_o)
        d = d.index_copy(0, live, d_out)
        tp = tp.index_copy(0, live, new_tp)
    out = light.float()
    if render.get("clamp_radiance", False):
        out = torch.clamp(out, 0.0, 1.0)
    return out
