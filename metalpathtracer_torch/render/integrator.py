"""Path-tracing integrator over the ray wavefront.

Port of the scan integrator of `metalpathtracer_tpu/render/integrator.py`
(`_trace_rays`, `_fetch_material`, `_sphere_cone_pdf`, `_sample_light`,
`_light_pdf_toward`, `_bounce_step`, `trace`). Every ray advances one bounce
per step with masked updates, in a Python loop that exits once every ray
has terminated or `max_depth` is reached.

Estimator:
- miss -> sky gradient, terminate;
- an emissive hit adds `throughput * emission * power` and keeps bouncing;
- throughput *= albedo once per bounce;
- the new origin is offset 1e-4 along the normal (scaled by the hit
  point's magnitude with `adaptive_offset`);
- optional per-sample clamp of radiance to [0, 1];
- optional Russian roulette, and next-event estimation over the flux-
  weighted light table with power-heuristic MIS against the BSDF route.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from metalpathtracer_torch.core import rng, vecmath as vm
from metalpathtracer_torch.render import bsdf
from metalpathtracer_torch.render.intersect import (
    T_MIN,
    closest_hit_bruteforce,
    surface_interaction_packed,
)
from metalpathtracer_torch.render.kernels.intersect_mm import closest_hit_mm_full


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Integrator configuration: the fields the scan path reads."""

    max_depth: int = 32
    # closest-hit backend: "auto" and "mm" take the tile kernel,
    # "brute" the brute-force oracle
    intersector: str = "auto"
    brute_chunk: int = 128
    clamp_radiance: bool = False  # per-sample [0,1] radiance clamp
    rr_start: int = 0  # 0 = off; else first bounce eligible for roulette
    nee: bool = False  # next-event estimation + MIS
    # scale the scatter-origin offset with the hit point's magnitude: a
    # fixed 1e-4 is below f32 position resolution once |p| > ~2
    adaptive_offset: bool = True


DEFAULT_CONFIG = RenderConfig()


def _trace_rays(scene, o, d, cfg, active=None, occ_t=None):
    """Closest hit + surface frame: (t, idx, normal, front_face, mat_id,
    tile_passes). mat_id is the winner's material-bank id where the
    intersector provides it (the tile path does), else None."""
    kind = cfg.intersector
    if kind in ("auto", "mm"):
        return closest_hit_mm_full(scene, o, d, T_MIN, active=active,
                                   occ_t=occ_t)
    if kind != "brute":
        raise ValueError(f"unknown intersector {cfg.intersector!r}")
    t, idx = closest_hit_bruteforce(scene, o, d, T_MIN, chunk=cfg.brute_chunk)
    geom_row = scene.geom_table[idx.clamp(min=0).to(torch.int64)]
    _, normal, front_face = surface_interaction_packed(geom_row, o, d, t)
    return (t, idx, normal, front_face, None,
            torch.zeros((), dtype=torch.float32, device=o.device))


def _fetch_material(scene, idx, mat_id=None):
    """Per-hit material row from the material bank."""
    if mat_id is None:
        mat_id = scene.prim_mat_id[idx.clamp(min=0).to(torch.int64)]
    return scene.mat_bank[mat_id.to(torch.int64)]


def _sphere_cone_pdf(center, radius, point):
    """Solid-angle pdf of cone-sampling the sphere from `point`:
    1 / (2 pi (1 - cos_max)); 0 when `point` is inside the sphere."""
    dist2 = vm.length_squared(center - point)
    sin_max2 = torch.clamp(radius * radius / torch.clamp(dist2, min=1e-20),
                           0.0, 1.0)
    cos_max = torch.sqrt(1.0 - sin_max2)
    pdf = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-12)
    return torch.where(dist2 > radius * radius, pdf, 0.0)


def _sample_light(scene, point, u_pick, u1, u2):
    """Flux-weighted next-event sample over the light table: spheres by
    uniform direction in the subtended cone, triangles by uniform area with
    the pdf turned into solid angle. Returns (dir, dist, radiance, pdf
    (solid angle, with the pick probability), light_prim, valid)."""
    j = torch.searchsorted(scene.light_cdf, u_pick, side="left")
    j = j.clamp(0, scene.light_cdf.shape[0] - 1)
    kind = scene.light_kind[j]
    q0 = scene.light_q0[j]
    e1 = scene.light_e1[j]
    e2 = scene.light_e2[j]
    nrm = scene.light_normal[j]
    emission = scene.light_emission[j]
    area = scene.light_area[j]
    pick_p = scene.light_pick_p[j]
    lprim = scene.light_prim[j]

    # sphere: cone sampling around the center direction
    to_c = q0 - point
    dist2 = torch.clamp(vm.length_squared(to_c), min=1e-20)
    cdist = torch.sqrt(dist2)
    w = to_c / cdist[..., None]
    radius = e1[..., 0]
    sin_max2 = torch.clamp(radius * radius / dist2, 0.0, 1.0)
    cos_max = torch.sqrt(1.0 - sin_max2)
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2
    y_axis = torch.tensor([0.0, 1.0, 0.0], device=point.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=point.device)
    a = vm.where3(torch.abs(w[..., 0]) > 0.9, y_axis, x_axis)
    t1 = vm.normalize(vm.cross(a, w))
    t2 = vm.cross(w, t1)
    sph_dir = (
        t1 * (sin_t * torch.cos(phi))[..., None]
        + t2 * (sin_t * torch.sin(phi))[..., None]
        + w * cos_t[..., None]
    )
    sph_pdf = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-12)
    sph_valid = dist2 > radius * radius  # inside the light: no cone

    # triangle: uniform area sample, pdf -> solid angle
    su = torch.sqrt(u1)
    b1 = 1.0 - su
    b2 = u2 * su
    x_l = q0 + b1[..., None] * e1 + b2[..., None] * e2
    to_l = x_l - point
    tdist2 = torch.clamp(vm.length_squared(to_l), min=1e-20)
    tdist = torch.sqrt(tdist2)
    tri_dir = to_l / tdist[..., None]
    # two-sided emitter -> |cos| at the light
    cos_l = torch.abs(vm.dot(nrm, tri_dir))
    tri_pdf = tdist2 / torch.clamp(cos_l * area, min=1e-12)
    tri_valid = cos_l > 1e-6

    is_tri = kind == 1
    dir_out = vm.where3(is_tri, tri_dir, sph_dir)
    dist = torch.where(is_tri, tdist, cdist)
    pdf_sa = torch.where(is_tri, tri_pdf, sph_pdf)
    valid = (pick_p > 0.0) & torch.where(is_tri, tri_valid, sph_valid)
    pdf = torch.where(valid, pick_p * pdf_sa, 0.0)
    return dir_out, dist, emission, pdf, lprim, valid


def _light_pdf_toward(scene, origin, d, t, idx):
    """Solid-angle pdf (with the pick probability) with which
    `_sample_light` would have drawn direction `d` from `origin`, given the
    ray hit primitive `idx` at distance `t`; 0 if that primitive is not a
    light. The MIS counterweight for emission found by the BSDF route."""
    lid = scene.prim_light_id[idx.clamp(min=0).to(torch.int64)]
    lid_c = lid.clamp(min=0).to(torch.int64)
    kind = scene.light_kind[lid_c]
    pick_p = scene.light_pick_p[lid_c]
    q0 = scene.light_q0[lid_c]
    radius = scene.light_e1[lid_c, 0]
    nrm = scene.light_normal[lid_c]
    area = scene.light_area[lid_c]

    sph_pdf = _sphere_cone_pdf(q0, radius, origin)
    cos_l = torch.abs(vm.dot(nrm, d))
    tri_pdf = (t * t) / torch.clamp(cos_l * area, min=1e-12)
    pdf = torch.where(kind == 1, tri_pdf, sph_pdf) * pick_p
    return torch.where((lid >= 0) & (idx >= 0), pdf, 0.0)


def _bounce_step(scene, o, d, light, throughput, active, prev_pdf,
                 pixel_id, sample_id, bounce, seed, cfg):
    """Advance every lane one bounce (`bounce` is the Python int index the
    RNG draws key on). `prev_pdf` carries the BSDF pdf of
    the previous bounce's scattered direction on lanes whose previous
    bounce sampled a light (0 otherwise): the MIS counterweight.

    Returns (o, d, light, throughput, still_active, prev_pdf, rays_counted,
    shadow_counted, tile_passes); rays_counted includes the NEE shadow rays
    and shadow_counted reports them on their own.
    """
    rays_counted = active.sum(dtype=torch.int64)
    shadow_counted = torch.zeros((), dtype=torch.int64, device=o.device)

    t, idx, normal, front_face, mat_id, tile_passes = _trace_rays(
        scene, o, d, cfg, active=active
    )
    miss = idx < 0

    # sky on miss
    sky = bsdf.sky_color(d)
    light = light + torch.where((active & miss)[:, None], throughput * sky, 0.0)

    hit_live = active & ~miss
    point = o + t[:, None] * d
    mat_row = _fetch_material(scene, idx, mat_id)
    albedo = mat_row[:, 0:3]
    mat_type = mat_row[:, 3]
    emission = mat_row[:, 4:7]
    power = mat_row[:, 7]
    fuzz = mat_row[:, 8]

    use_nee = cfg.nee and scene.num_lights > 0

    # emission; with NEE weighted by the power heuristic against the light
    # sampler's density for the same direction
    emissive = bsdf.is_emissive(mat_type, power)
    count_emission = hit_live & emissive
    emit = throughput * emission * power[:, None]
    if use_nee:
        pdf_l_hit = _light_pdf_toward(scene, o, d, t, idx)
        w_bsdf = torch.where(
            prev_pdf > 0.0,
            (prev_pdf * prev_pdf)
            / torch.clamp(prev_pdf * prev_pdf + pdf_l_hit * pdf_l_hit, min=1e-20),
            1.0,
        )
        emit = emit * w_bsdf[:, None]
    light = light + torch.where(count_emission[:, None], emit, 0.0)

    # next-event estimation + MIS on the Lambertian and glossy lobes; both
    # satisfy f * cos = albedo * pdf_b, so the light route contributes
    #   tp * albedo * L * pdf_b(ldir) / pdf_l * w_light
    if use_nee:
        is_diffuse = (mat_type == 0.0) | (mat_type == 2.0)
        is_glossy = (mat_type < 0.0) & (fuzz > 0.0) & (fuzz < 1.0)
        refl = vm.reflect(d, normal)
        u_pick = rng.uniform1(seed, pixel_id, sample_id, bounce,
                              rng.PURPOSE_LIGHT_PICK)
        ul1, ul2 = rng.uniform2(seed, pixel_id, sample_id, bounce,
                                rng.PURPOSE_LIGHT)
        ldir, ldist, lrad, pdf_l, lprim, lvalid = _sample_light(
            scene, point, u_pick, ul1, ul2
        )
        cos_s = vm.dot(normal, ldir)
        pdf_b_l = torch.where(
            is_glossy,
            bsdf.glossy_pdf(refl, fuzz, ldir),
            torch.clamp(cos_s, min=0.0) / math.pi,
        )
        cand = (
            hit_live & (cos_s > 0.0) & lvalid & ~emissive
            & (is_diffuse | (is_glossy & (pdf_b_l > 0.0)))
        )
        s_o = point + 1e-3 * normal
        # shadow query: hits beyond the light are irrelevant, so tiles past
        # it are pruned (the 1.001 slack keeps the light's own tile)
        st, sidx, _, _, _, s_passes = _trace_rays(
            scene, s_o, ldir, cfg, active=cand, occ_t=ldist * 1.001
        )
        tile_passes = tile_passes + s_passes
        shadow_counted = cand.sum(dtype=torch.int64)
        rays_counted = rays_counted + shadow_counted
        lit = cand & (sidx == lprim)
        w_light = (pdf_l * pdf_l) / torch.clamp(
            pdf_l * pdf_l + pdf_b_l * pdf_b_l, min=1e-20
        )
        scale = pdf_b_l * w_light / torch.clamp(pdf_l, min=1e-12)
        contrib = throughput * albedo * lrad * scale[..., None]
        light = light + torch.where(lit[:, None], contrib, 0.0)
        nee_ran = hit_live & (is_diffuse | is_glossy) & ~emissive

    # scatter
    unit_vec = rng.random_unit_vector(seed, pixel_id, sample_id, bounce)
    u_fres = rng.uniform1(seed, pixel_id, sample_id, bounce, rng.PURPOSE_FRESNEL)
    d_out, offset_sign = bsdf.sample_bsdf(
        d, normal, front_face, mat_type, fuzz, unit_vec, u_fres
    )
    if cfg.adaptive_offset:
        scale = torch.clamp(torch.abs(point).amax(dim=-1), min=1.0)
        new_o = point + (1e-4 * offset_sign * scale)[..., None] * normal
    else:
        new_o = point + (1e-4 * offset_sign)[..., None] * normal
    new_tp = throughput * albedo

    # Russian roulette (unbiased early termination)
    if 0 < cfg.rr_start <= bounce:
        u_rr = rng.uniform1(seed, pixel_id, sample_id, bounce, rng.PURPOSE_RR)
        p = torch.clamp(new_tp.amax(dim=-1), 0.05, 1.0)
        new_tp = new_tp * (1.0 / p)[..., None]
        hit_live = hit_live & (u_rr < p)

    # MIS counterweight for the next bounce: the sampled lobe's pdf of the
    # direction just scattered, on lanes where light sampling ran
    if use_nee:
        pdf_next = torch.where(
            is_glossy,
            bsdf.glossy_pdf(refl, fuzz, d_out),
            torch.clamp(vm.dot(normal, d_out), min=0.0) / math.pi,
        )
        new_pdf = torch.where(nee_ran, pdf_next, 0.0)
    else:
        new_pdf = torch.zeros_like(prev_pdf)

    o = vm.where3(hit_live, new_o, o)
    d = vm.where3(hit_live, d_out, d)
    throughput = torch.where(hit_live[:, None], new_tp, throughput)
    prev_pdf = torch.where(hit_live, new_pdf, prev_pdf)
    return (o, d, light, throughput, hit_live, prev_pdf, rays_counted,
            shadow_counted, tile_passes)


def trace(scene, o, d, pixel_id, sample_id, seed,
          cfg: RenderConfig = DEFAULT_CONFIG):
    """Trace one path per lane to completion.

    o, d: float32 (N, 3) primary rays (d unit); pixel_id: int64 (N,) u32
    RNG stream ids; sample_id: which spp sample this is; seed: u32 seed.
    Returns (radiance (N, 3), rays_traced int64 scalar tensor).
    """
    n = o.shape[0]
    dev = o.device
    light = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((n,), dtype=torch.float32, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    bounce = 0
    while bounce < cfg.max_depth and bool(active.any()):
        o, d, light, throughput, active, prev_pdf, counted, _, _ = _bounce_step(
            scene, o, d, light, throughput, active, prev_pdf,
            pixel_id, sample_id, bounce, seed, cfg,
        )
        rays_traced = rays_traced + counted
        bounce += 1
    if cfg.clamp_radiance:
        light = torch.clamp(light, 0.0, 1.0)
    return light, rays_traced
