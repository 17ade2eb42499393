"""Path-tracing integrator over the ray wavefront.

Port of `metalpathtracer_tpu/render/integrator.py` (`_trace_rays`,
`_fetch_material`, `_sphere_cone_pdf`, `_sample_light`, `_light_pdf_toward`,
`_bounce_step`, `trace`, `trace_wavefront`). Two integrators share the
bounce step:
- `trace` (scan): one lane per (pixel, sample); every lane advances one
  bounce per step with masked updates, in blocks of `SCAN_BLOCK` steps
  until every lane has terminated or `max_depth` is reached;
- `trace_wavefront`: a fixed pool of lanes works through the (pixel group,
  sample) queue; a lane whose path ends banks its radiance and restarts on
  the next work item, so every advance traces a dense pool.
Each runs on a program of static buffers (`_Scan`, `_Wavefront`) cached per
render shape by `render/graphs.py`, which on the card captures the
program's functions as CUDA graphs and replays them.

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
from metalpathtracer_torch.render import bsdf, graphs
from metalpathtracer_torch.render.camera import camera_basis, rays_from_basis
from metalpathtracer_torch.render.intersect import (
    T_MIN,
    closest_hit_bruteforce,
    surface_interaction_packed,
)
from metalpathtracer_torch.render.kernels import shade
from metalpathtracer_torch.render.kernels import wavefront as wfk
from metalpathtracer_torch.render.kernels.intersect_mm import (
    closest_hit_mm_full,
    closest_hit_mm_winners,
)
from metalpathtracer_torch.render.traverse import closest_hit_bvh
from metalpathtracer_torch.utils.metrics import span


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Integrator configuration."""

    max_depth: int = 32
    # closest-hit backend: "auto" and "mm" take the tile kernels, "bvh" the
    # lockstep BVH walk (a study path; "auto" never selects it), "brute"
    # the brute-force oracle
    intersector: str = "auto"
    brute_chunk: int = 128
    # wavefront: reorder the pool by each lane's tile-set signature, so that
    # a 128-lane subgroup's tile list covers few tiles. Positional RNG makes
    # the estimate invariant to the order. Ignored without triangles.
    sort_lanes: bool = True
    sort_key: str = "tileset"  # the one key ported
    clamp_radiance: bool = False  # per-sample [0,1] radiance clamp
    rr_start: int = 0  # 0 = off; else first bounce eligible for roulette
    nee: bool = False  # next-event estimation + MIS
    # wavefront bounces per advance (between regenerations); the estimate
    # is invariant to it
    bounces_per_iter: int = 1
    # scale the scatter-origin offset with the hit point's magnitude: a
    # fixed 1e-4 is below f32 position resolution once |p| > ~2
    adaptive_offset: bool = True
    # wavefront pixel-group banking: one work item covers bank_k adjacent
    # pixels x their samples and banks them as one framebuffer row.
    # 0 = auto (the largest k <= 8 that keeps the queue >= 4 pool fills)
    bank_k: int = 0


DEFAULT_CONFIG = RenderConfig()
# strict reference parity: per-sample [0,1] clamp and the fixed 1e-4
# scatter offset
REFERENCE_CONFIG = RenderConfig(max_depth=32, clamp_radiance=True,
                                adaptive_offset=False)


def _trace_rays(scene, o, d, cfg, active=None, occ_t=None):
    """Closest hit + surface frame: (t, idx, normal, front_face, mat_id,
    tile_passes). mat_id is the winner's material-bank id where the
    intersector provides it (the tile path does), else None."""
    kind = cfg.intersector
    if kind in ("auto", "mm"):
        return closest_hit_mm_full(scene, o, d, T_MIN, active=active,
                                   occ_t=occ_t)
    if kind == "bvh":
        t, idx = closest_hit_bvh(scene, o, d, T_MIN)
    elif kind == "brute":
        t, idx = closest_hit_bruteforce(scene, o, d, T_MIN, chunk=cfg.brute_chunk)
    else:
        raise ValueError(f"unknown intersector {cfg.intersector!r}")
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
    # the helper axis of the cone's frame: y where w is near x, else x
    a = vm.where3(torch.abs(w[..., 0]) > 0.9, scene.frame_axes[0],
                  scene.frame_axes[1])
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


def _step_draws(use_nee: bool, rr: bool) -> tuple:
    """The (purpose, mode) of each draw of a bounce step, for `rng.draws`:
    the scatter's lobe direction and Fresnel choice; the light pick and the
    light's point with NEE; the Russian roulette draw where it is on."""
    spec = ((rng.PURPOSE_LOBE, "unit_vector"), (rng.PURPOSE_FRESNEL, "single"))
    if use_nee:
        spec += ((rng.PURPOSE_LIGHT_PICK, "single"), (rng.PURPOSE_LIGHT, "pair"))
    if rr:
        spec += ((rng.PURPOSE_RR, "single"),)
    return spec


def _bounce_step(scene, o, d, light, throughput, active, prev_pdf,
                 pixel_id, sample_id, bounce, seed, cfg, bank=None):
    """Advance every lane one bounce. `bounce`, the index the RNG draws key
    on, is an int or a per-lane tensor, as are `sample_id` and `pixel_id`.
    `prev_pdf` carries the BSDF pdf of
    the previous bounce's scattered direction on lanes whose previous
    bounce sampled a light (0 otherwise): the MIS counterweight.

    The closest hit, then every draw of the step in one bundle, then the
    shading, by one of three routes:
    - with next-event estimation (and lights in the scene) `_shade_nee`,
      plain torch (counted in `graphs.STATS["nee_steps"]`);
    - without it on the tile intersector ("auto", "mm") the closest hit
      stops at its winners (`closest_hit_mm_winners`) and
      `shade.shade_hit` shades from them: one kernel on the card, which
      computes the epilogue in registers;
    - without it on the BVH walk and the brute oracle, which give the
      surface frame, `shade.shade_reference`, plain torch.

    Returns (o, d, light, throughput, still_active, prev_pdf, rays_counted,
    shadow_counted, tile_passes, banked); rays_counted includes the NEE
    shadow rays and shadow_counted reports them on their own.

    `bank` (the wavefront's lanes at one bounce an advance: (alive, schunk,
    acc, `shade.BankPlan`), with `bounce` an int64 tensor) has `shade_hit`
    bank the paths that ended in the same launch: `banked` is then its
    (acc, bounce, schunk, more, bank), with light 0 where a path banked and
    still_active the lanes whose path goes on. Without a bank, and on the
    other routes, `banked` is None and the caller banks
    (`shade.bank_paths`).
    """
    use_nee = cfg.nee and scene.num_lights > 0
    from_winners = not use_nee and cfg.intersector in ("auto", "mm")
    # after the wavefront's pool sort o and d are column views of one
    # packed tensor: one copy here, not one in each kernel's wrapper
    o, d = o.contiguous(), d.contiguous()
    if from_winners:
        t_tri, col, t_s, i_s, slot, tile_passes = closest_hit_mm_winners(
            scene, o, d, T_MIN, active=active)
        hit = (t_tri, col, t_s, i_s, slot, scene.mm_refine, scene.sph_center,
               scene.sph_mat_id, T_MIN)
    else:
        t, idx, normal, front_face, mat_id, tile_passes = _trace_rays(
            scene, o, d, cfg, active=active
        )
        if mat_id is None:  # the BVH walk and the brute oracle give prim ids alone
            mat_id = scene.prim_mat_id[idx.clamp(min=0).to(torch.int64)]
        hit = (t, idx, normal, front_face, mat_id)

    # every draw of the step in one call (one launch on the card)
    with span("step.draws"):
        drawn = rng.draws(seed, pixel_id, sample_id, bounce,
                          _step_draws(use_nee, cfg.rr_start > 0))
    if use_nee:
        graphs.STATS["nee_steps"] += 1
        return (*_shade_nee(scene, o, d, light, throughput, active, prev_pdf, bounce,
                            cfg, hit, drawn, tile_passes), None)
    args = (o, d, light, throughput, active, prev_pdf, *hit, drawn[0], drawn[1],
            drawn[-1] if cfg.rr_start > 0 else None, bounce, scene.mat_bank,
            scene.sky, cfg.rr_start, cfg.adaptive_offset)
    shadow = torch.zeros((), dtype=torch.int64, device=o.device)
    if not from_winners:
        with span("step.shade"):
            return (*shade.shade_reference(*args), shadow, tile_passes, None)
    with span("step.shade" if bank is None else "step.shade_bank"):
        out = shade.shade_hit(*args, bank=bank)
    return (*out[:7], shadow, tile_passes, None if bank is None else out[7:])


def _shade_nee(scene, o, d, light, throughput, active, prev_pdf, bounce, cfg, hit,
               drawn, tile_passes):
    """`_bounce_step`'s shading with next-event estimation, plain torch:
    the sky, the emission weighted by the power heuristic against the light
    sampler's density, the light sample and its shadow ray (through the
    closest hit), the BSDF's sample and its pdf for the next bounce's MIS,
    the offset, Russian roulette and the masked state update. `hit` is the
    step's (t, idx, normal, front_face, mat_id), `drawn` its draws
    (`_step_draws(True, ...)`). Returns `_bounce_step`'s items but the
    last."""
    t, idx, normal, front_face, mat_id = hit
    with span("step.update"):
        rays_counted = active.sum(dtype=torch.int64)
    with span("step.sky_emission"):
        miss = idx < 0
        # sky on miss
        sky = bsdf.sky_color(d, scene.sky)
        light = light + torch.where((active & miss)[:, None], throughput * sky, 0.0)

        hit_live = active & ~miss
        point = o + t[:, None] * d
        mat_row = _fetch_material(scene, idx, mat_id)
        albedo = mat_row[:, 0:3]
        mat_type = mat_row[:, 3]
        emission = mat_row[:, 4:7]
        power = mat_row[:, 7]
        fuzz = mat_row[:, 8]

        # emission, weighted by the power heuristic against the light
        # sampler's density for the same direction
        emissive = bsdf.is_emissive(mat_type, power)
        count_emission = hit_live & emissive
        emit = throughput * emission * power[:, None]
        pdf_l_hit = _light_pdf_toward(scene, o, d, t, idx)
        w_bsdf = torch.where(
            prev_pdf > 0.0,
            (prev_pdf * prev_pdf)
            / torch.clamp(prev_pdf * prev_pdf + pdf_l_hit * pdf_l_hit, min=1e-20),
            1.0,
        )
        emit = emit * w_bsdf[:, None]
        light = light + torch.where(count_emission[:, None], emit, 0.0)
    unit_vec, u_fres = drawn[0], drawn[1]

    # next-event estimation + MIS on the Lambertian and glossy lobes; both
    # satisfy f * cos = albedo * pdf_b, so the light route contributes
    #   tp * albedo * L * pdf_b(ldir) / pdf_l * w_light
    with span("step.nee"):
        is_diffuse = (mat_type == 0.0) | (mat_type == 2.0)
        is_glossy = (mat_type < 0.0) & (fuzz > 0.0) & (fuzz < 1.0)
        refl = vm.reflect(d, normal)
        u_pick, ul = drawn[2], drawn[3]
        ldir, ldist, lrad, pdf_l, lprim, lvalid = _sample_light(
            scene, point, u_pick, ul[0], ul[1]
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
    with span("step.nee"):
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
    with span("step.sample_bsdf"):
        d_out, offset_sign = bsdf.sample_bsdf(
            d, normal, front_face, mat_type, fuzz, unit_vec, u_fres
        )
    with span("step.update"):
        if cfg.adaptive_offset:
            scale = torch.clamp(torch.abs(point).amax(dim=-1), min=1.0)
            new_o = point + (1e-4 * offset_sign * scale)[..., None] * normal
        else:
            new_o = point + (1e-4 * offset_sign)[..., None] * normal
        new_tp = throughput * albedo

        # Russian roulette (unbiased early termination), from bounce rr_start
        # on; `bounce` is an int (scan) or a per-lane tensor (wavefront)
        if cfg.rr_start > 0:
            u_rr = drawn[-1]
            p = torch.clamp(new_tp.amax(dim=-1), 0.05, 1.0)
            do_rr = bounce >= cfg.rr_start
            if not isinstance(do_rr, torch.Tensor):  # a scan step: one bool
                do_rr = torch.full_like(p, do_rr, dtype=torch.bool)  # a fill, no upload
            new_tp = new_tp * torch.where(do_rr, 1.0 / p, 1.0)[..., None]
            hit_live = hit_live & (~do_rr | (u_rr < p))

        # MIS counterweight for the next bounce: the sampled lobe's pdf of the
        # direction just scattered, on lanes where light sampling ran
        pdf_next = torch.where(
            is_glossy,
            bsdf.glossy_pdf(refl, fuzz, d_out),
            torch.clamp(vm.dot(normal, d_out), min=0.0) / math.pi,
        )
        new_pdf = torch.where(nee_ran, pdf_next, 0.0)

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
    RNG stream ids; sample_id: which spp sample this is (an int or a
    one-element integer tensor); seed: u32 seed.
    Returns (radiance (N, 3), rays_traced int64 scalar tensor).

    Runs on the `_Scan` program of (N, seed, cfg) (`scan_entry`,
    `scan_samples`), whose bounce blocks the card replays as CUDA graphs.
    """
    entry = scan_entry(scene, None, None, o.shape[0], seed, cfg)
    entry.program.begin(pixel_id, sample_id)
    entry.program.load_rays(o, d)
    scan_samples(entry, 1, raygen=False)
    return entry.program.result()


# bounce steps of one captured scan block: the host reads the loop
# condition once a block (chosen on the card, PERF.md)
SCAN_BLOCK = 8


def scan_entry(scene, width, height, n, seed, cfg) -> "graphs.Entry":
    """The cached `_Scan` entry of one render shape: `n` lanes (a pass's
    pixels or a tile shard's block) of a width x height image (None for
    `trace`, which takes its rays from the caller), `seed` and `cfg`, on
    `scene`. Samples, bounces, cameras and first sample ids are not in the
    key: `begin` writes them into the program's buffers."""
    key = ("scan", width, height, n, seed, cfg)
    return graphs.entry(key, scene,
                        lambda: _Scan(scene, n, width, height, seed, cfg))


def scan_samples(entry, samples: int, raygen: bool = True) -> None:
    """`samples` samples on `entry`'s program, after its `begin`: each
    `start_sample` (without `raygen`, the rays `load_rays` put there),
    its bounces, `end_sample`.

    Where the entry replays graphs (and on the CPU, which runs the same
    functions eagerly) the bounces run as `bounce_block`s (and a shorter
    `last_block` where max_depth % SCAN_BLOCK is not 0) until max_depth or
    until no lane is live, the report read after each block. A block whose
    lanes all die part way runs its other steps on no live lane: the image
    and the rays do not change, and `STATS["idle_steps"]` counts them.
    Where the card runs eagerly (`graphs.eager()`, the BVH walk) the loop is
    the one before graphs: one `bounce_step` and one read a bounce, and no
    idle step."""
    sc = entry.program
    stepwise = entry.device.type == "cuda" and not entry.replayed()
    report = None
    for _ in range(samples):
        if raygen:
            entry.run("start_sample")
        bounce, live = 0, sc.n > 0
        while bounce < sc.cfg.max_depth and live:
            if stepwise:
                name, k = "bounce_step", 1
            elif sc.cfg.max_depth - bounce < sc.block:
                name, k = "last_block", sc.last
            else:
                name, k = "bounce_block", sc.block
            entry.run(name)
            report = entry.read()
            bounce += k
            live = report[0] > 0
        entry.run("end_sample")
    if report is not None:  # the program's idle steps since `begin`
        graphs.STATS["idle_steps"] += int(report[5])


# wavefront cadences (the reference's defaults; its MPT_* sweep knobs are
# not ported)
BANK_K_MAX = 8  # largest automatic pixel-group banking width
SORT_EVERY = 4  # advances between pool sorts (at most spb)
DRAIN_WIDTH = 1024  # the pool narrows to this once the queue is empty


def trace_wavefront(scene, camera, width, height, spp, seed,
                    cfg: RenderConfig = DEFAULT_CONFIG,
                    pool_size: int | None = None,
                    sample_offset: int = 0,
                    pixel_offset: int = 0,
                    n_pixels: int | None = None,
                    row_stride: int = 1):
    """Persistent-wavefront path tracing with lane regeneration. `seed` is
    the u32 seed word; the samples traced are `sample_offset` ..
    `sample_offset + spp - 1` of every pixel (a progressive render passes
    the samples it already holds).

    `pixel_offset` / `n_pixels` / `row_stride` restrict the queue to
    `n_pixels` pixels from `pixel_offset` on (a tile shard): local pixel l
    is pixel `pixel_offset + l + (l // width) * (row_stride - 1) * width`,
    so at a stride of 1 the range is contiguous and at n it takes every
    n-th row. Pixel ids stay global for ray generation and the RNG, while
    the queue's shape and the returned framebuffer cover the local range
    alone, in local order.

    A fixed pool of lanes works through the queue of work items, each
    `bank_k` adjacent pixels x `spb` samples. When a path ends, its radiance
    joins the lane's accumulator; when the item's last path ends, the lane
    banks the accumulator to the framebuffer and restarts on the next item.
    RNG streams key on (pixel, sample, bounce), never on the lane, so the
    estimate equals `trace`'s up to framebuffer addition order.

    Host loop: advances run in windows of `flush_every`; banks collect in
    per-lane pending slots and reach the framebuffer in one `index_add_`
    per window; the loop condition (queue left, or more live lanes than the
    drain width) is read once per window. Once it fails, the live lanes are
    compacted to `DRAIN_WIDTH` and advanced in blocks of `sort_every` until
    none is left, read once per block. The windows and the drain blocks
    work on the static buffers of a `_Wavefront`, cached per render shape
    by `render/graphs.py`, which on the card runs each as one replay of a
    captured CUDA graph (`graphs.eager()` runs them eagerly instead).

    Returns (rgb_sum (n_pixels, 3) f32, rays int, stats): stats has
    `tile_passes` (closest-hit tile passes, 2^20 ray-triangle tests each)
    and `shadow_rays` (NEE shadow rays, included in rays). Divide rgb_sum
    by spp.
    """
    if cfg.sort_key != "tileset":
        raise ValueError(f"unknown sort key {cfg.sort_key!r}")
    n_pix = n_pixels if n_pixels is not None else width * height
    if n_pix * spp > (1 << 31):
        raise ValueError(f"{n_pix * spp} work items overflow the queue")
    if row_stride < 1:
        raise ValueError(f"row_stride must be positive, got {row_stride}")
    pool = int(pool_size) if pool_size is not None else min(n_pix * spp, 1 << 15)
    shape = (width, height, spp, seed, cfg, pool, pixel_offset, n_pix, row_stride)
    entry = graphs.entry(shape, scene, lambda: _Wavefront(scene, *shape))
    wf = entry.program
    wf.start(camera, sample_offset)
    # (next_item, live lanes, rays, shadow rays, tile passes): what each
    # window and drain block leaves in `wf.report`, and the host reads
    queued = min(pool, wf.total)
    report = [queued, queued, 0, 0, 0.0]
    while report[0] < wf.total or report[1] > wf.drain_stop:
        entry.run("window")
        report = entry.read()
    wf.compact()
    while report[1] > 0:  # live lanes, all of them in the drain's width
        entry.run("drain_block")
        report = entry.read()
    return wf.flush(), int(report[2]), dict(tile_passes=report[4],
                                            shadow_rays=int(report[3]))


class _Wavefront:
    """One render shape of `trace_wavefront`: its host plan, its static
    buffers, and the functions that advance them. `window` and
    `drain_block` read and write the buffers alone (on the card
    `render/graphs.py` captures them), and leave (next_item, live lanes,
    rays, shadow rays, tile passes) in `report` for the host; `start`,
    `compact` and `flush` run once a render, eagerly.

    Per render, `start` takes what changes between calls of one shape: the
    camera, whose basis it copies into `basis`, and the first sample id,
    which it writes into `sample_offset`; both are read on the device.

    A lane's state (`wfk.LANE_FIELDS`) holds its work item and sample
    chunk, its path, and the pixel and sample its item names, which every
    restart writes (`wfk.restart_lanes`) and the advance's bounce steps
    read. The regeneration runs on `render/kernels/wavefront.py`'s kernels:
    the restart, the window's queue pop, and the pool sort's key and
    gather (the sort itself is `torch.argsort`)."""

    def __init__(self, scene, width, height, spp, seed, cfg, pool,
                 pixel_offset, n_pix, row_stride):
        self.scene, self.width, self.height = scene, width, height
        self.seed, self.cfg, self.pool = seed, cfg, pool
        self.pixel_offset = pixel_offset
        self.bpi = max(1, cfg.bounces_per_iter)
        # samples per bank: a lane traces all spp samples of its pixels when
        # the image alone fills the pool, else one sample per item
        spb = spp if n_pix >= pool else 1
        chunks = spp // spb
        bank_k = 1
        if spb == spp:
            k_req = cfg.bank_k or BANK_K_MAX
            for k in (16, 8, 4, 2, 1):
                # queue-depth guard: grouping shortens the queue k-fold; keep
                # it >= 4 pool fills unless bank_k was asked for
                deep_enough = bool(cfg.bank_k) or (n_pix // k) * chunks >= 4 * pool
                if (k <= k_req and n_pix % k == 0 and n_pix // k >= pool
                        and deep_enough):
                    bank_k = k
                    break
        self.n_pix, self.spb, self.bank_k = n_pix, spb, bank_k
        self.groups = n_pix // bank_k
        self.lane_plan = wfk.LanePlan(width, height, self.groups, bank_k, spb,
                                      pixel_offset, seed, row_stride)
        self.per_item = bank_k * spb  # path completions per work item
        self.plan = shade.BankPlan(cfg.max_depth, cfg.clamp_radiance, bank_k, spb,
                                   self.per_item)
        self.total = self.groups * chunks
        self.ka = ka = 3 * bank_k  # accumulator width
        # a lane completes at most one path per advance, so it banks at most
        # once per window of flush_every <= per_item advances: one pending
        # slot each
        self.sort_every = min(spb, SORT_EVERY)
        self.flush_every = max(1, self.per_item // self.sort_every) * self.sort_every
        self.sorting = cfg.sort_lanes and scene.num_tris > 0
        self.drain_w = min(pool, DRAIN_WIDTH)
        self.drain_stop = self.drain_w if pool > self.drain_w else 0
        # the BVH walk reads the host on every level: no capture
        self.capturable = cfg.intersector != "bvh"

        dev = scene.device
        i64 = dict(dtype=torch.int64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.i64, self.f32 = i64, f32
        self.basis = torch.zeros((4, 3), **f32)
        self.sample_offset = torch.zeros((), **i64)
        self.lane_ids = torch.arange(pool, **i64)
        self.st = self._lanes(pool)
        # the drain's lanes: the live ones, compacted, once the queue is empty
        self.drain = self._lanes(self.drain_w) if pool > self.drain_w else None
        # rows >= groups are private dummy rows: a lane with no pending bank
        # adds its zero row there, so every index of a scatter is distinct
        self.fb = torch.zeros((self.groups + pool, ka), **f32)
        self.next_item = torch.zeros((), **i64)
        self.counters = dict(rays=torch.zeros((), **i64),
                             shadow=torch.zeros((), **i64),
                             tile_passes=torch.zeros((), **f32))
        self.report = torch.zeros(5, dtype=torch.float64, device=dev)

    def _lanes(self, n):
        i64, f32, ka = self.i64, self.f32, self.ka
        return dict(
            item=torch.zeros(n, **i64), schunk=torch.zeros(n, **i64),
            acc=torch.zeros((n, ka), **f32), o=torch.zeros((n, 3), **f32),
            d=torch.zeros((n, 3), **f32), bounce=torch.zeros(n, **i64),
            light=torch.zeros((n, 3), **f32), tp=torch.zeros((n, 3), **f32),
            prev_pdf=torch.zeros(n, **f32),
            alive=torch.zeros(n, dtype=torch.bool, device=self.lane_ids.device),
            pixel=torch.zeros(n, **i64), sample=torch.zeros(n, **i64))

    @staticmethod
    def _store(bufs, st):
        for k in wfk.LANE_FIELDS:
            bufs[k].copy_(st[k])

    def _report(self, alive):
        c = self.counters
        self.report.copy_(torch.stack([
            self.next_item.to(torch.float64), alive.sum().to(torch.float64),
            c["rays"].to(torch.float64), c["shadow"].to(torch.float64),
            c["tile_passes"].to(torch.float64)]))

    # ---- the lane program

    def advance(self, st):
        """bpi bounce steps and the per-path bookkeeping. Returns the new
        state and the masks `more` (the lane restarts on its item's next
        sample) and `bank` (the lane finished its item). At one bounce an
        advance the step's shading banks the paths that ended
        (`shade.shade_hit` with its bank: one kernel on the card); with
        more, with NEE, or on the BVH walk and the brute oracle,
        `shade.bank_paths` does after the steps."""
        cfg, counters = self.cfg, self.counters
        alive, bounce = st["alive"], st["bounce"]
        o, d, light, tp, prev_pdf, pixel, sample = (
            st[k] for k in ("o", "d", "light", "tp", "prev_pdf", "pixel", "sample"))
        fused = ((alive, st["schunk"], st["acc"], self.plan) if self.bpi == 1
                 else None)
        still = alive
        for k in range(self.bpi):
            with span("wavefront.counters"):
                step_active = still & (bounce + k < cfg.max_depth)
            o, d, light, tp, still, prev_pdf, c, sh, tpass, banked = _bounce_step(
                self.scene, o, d, light, tp, step_active, prev_pdf, pixel,
                sample, bounce + k if k else bounce, self.seed, cfg, bank=fused,
            )
            with span("wavefront.counters"):
                counters["rays"] += c
                counters["shadow"] += sh
                counters["tile_passes"] += tpass
        if banked is None:
            with span("wavefront.bank"):
                light, acc, bounce_next, still, schunk, more, bank = shade.bank_paths(
                    light, still, alive, bounce, st["schunk"], st["acc"], self.plan,
                    self.bpi)
        else:
            acc, bounce_next, schunk, more, bank = banked
        st = dict(st, o=o, d=d, light=light, tp=tp, prev_pdf=prev_pdf, acc=acc,
                  bounce=bounce_next, alive=still, schunk=schunk)
        return st, more, bank

    def restart_lanes(self, st, restart):
        """Fresh primary rays where `restart` (the lane's (item, schunk)
        changed), and every lane's pixel and sample: one kernel."""
        with span("wavefront.restart_lanes"):
            return wfk.restart_lanes(st, restart, self.basis, self.sample_offset,
                                     self.lane_plan)

    def sort_pool(self, st, pend=None):
        """Reorder the lanes by tile-set signature (stable); the pending
        banks (pend_idx, pend_rgb) ride along."""
        with span("wavefront.sort_pool"):
            key = wfk.tileset_key(st["o"], st["d"], st["alive"],
                                  self.scene.mm_coarse_box, T_MIN)
            return wfk.permute_lanes(torch.argsort(key, stable=True), st, pend)

    # ---- once a render, eagerly

    def start(self, camera, sample_offset: int):
        """The first pool of lanes for `camera`, samples from
        `sample_offset` on; the framebuffer and the counters at 0."""
        with span("wavefront.start"):
            self.basis.copy_(camera_basis(camera, self.width, self.height))
            self.sample_offset.fill_(sample_offset)
            st = self._lanes(self.pool)
            st["item"].copy_(self.lane_ids)
            # every lane restarts; those past the queue's end stay dead
            st = self.restart_lanes(st, torch.ones_like(st["alive"]))
            st["alive"] = st["item"] < self.total
            self._store(self.st, st)
            self.fb.zero_()
            for c in self.counters.values():
                c.zero_()
            self.next_item.fill_(min(self.pool, self.total))

    def compact(self):
        """After the feed: clear the residue of dead lanes (lanes that
        banked in the feed hold none; cleared regardless, so the flush adds
        nothing twice) and, where the pool is wider than the drain, move the
        live lanes first into the drain's buffers."""
        with span("wavefront.compact"):
            st = self.st
            dead = ~st["alive"]
            st["light"].copy_(torch.where(dead[:, None], 0.0, st["light"]))
            st["acc"].copy_(torch.where(dead[:, None], 0.0, st["acc"]))
            if self.drain is not None:
                live_first = torch.argsort((~st["alive"]).to(torch.int8), stable=True)
                self._store(self.drain, {k: v[live_first][:self.drain_w]
                                         for k, v in st.items()})

    def flush(self):
        """Every dead lane whose item is real banks its accumulator; returns
        the framebuffer's (n_pix, 3) rows, a copy of the static buffer."""
        with span("wavefront.flush"):
            st = self.drain if self.drain is not None else self.st
            w = st["item"].shape[0]
            banked = ~st["alive"] & (st["item"] < self.total)
            idx = torch.where(banked, st["item"] % self.groups,
                              self.groups + self.lane_ids[:w])
            self.fb.index_add_(0, idx, st["acc"])
            # (groups, 3K) rows are K row-major (pixel, rgb) blocks
            return self.fb[:self.groups].reshape(self.n_pix, 3).clone()

    # ---- the functions the card replays as CUDA graphs

    def window(self):
        """`flush_every` advances of the feed: the queue refills lanes, and
        their banks reach the framebuffer in one scatter."""
        st, total, groups = dict(self.st), self.total, self.groups
        next_item = self.next_item
        pend = (groups + self.lane_ids,
                torch.zeros((self.pool, self.ka), **self.f32))
        for _ in range(self.flush_every // self.sort_every):
            for _ in range(self.sort_every):
                st, more, bank = self.advance(st)
                with span("wavefront.queue"):
                    # in place on the item, accumulator and pending bank
                    restart, next_item = wfk.queue_pop(
                        bank, more, st["item"], st["acc"], *pend, next_item, total,
                        groups)
                st = self.restart_lanes(st, restart)
            if self.sorting:
                st, pend = self.sort_pool(st, pend)
        with span("wavefront.queue"):
            self.fb.index_add_(0, pend[0], pend[1])
            self._store(self.st, st)
            self.next_item.copy_(next_item)
            self._report(st["alive"])

    def drain_block(self):
        """`sort_every` advances of the drain: no queue left, the live
        lanes fit `drain_w`."""
        st = dict(self.drain)
        for _ in range(self.sort_every):
            st, more, _ = self.advance(st)
            st = self.restart_lanes(st, more)
        if self.sorting:
            st, _ = self.sort_pool(st)
        with span("wavefront.queue"):
            self._store(self.drain, st)
            self._report(st["alive"])


class _Scan:
    """One render shape of the scan integrator (`trace`, `render_tile`):
    its static buffers and the functions that advance them. `start_sample`,
    `bounce_block`, `last_block`, `bounce_step` and `end_sample` read and
    write the buffers alone (on the card `render/graphs.py` captures them);
    each block or step leaves (any live lane, bounce, rays, shadow rays,
    tile passes, idle steps) in `report` for the host. Idle steps are those
    run with no live lane, which the eager loop does not run.

    Per call, `begin` takes what changes between calls of one shape: the
    pixel ids, the camera's basis and the first sample id, copied into
    `pixel_id`, `basis` and `sample_id`; `end_sample` moves `sample_id` on,
    so one entry serves every sample, pass, progressive step and camera."""

    def __init__(self, scene, n, width, height, seed, cfg):
        self.scene, self.n, self.width, self.height = scene, n, width, height
        self.seed, self.cfg = seed, cfg
        self.block = min(SCAN_BLOCK, max(cfg.max_depth, 1))
        self.last = cfg.max_depth % self.block
        # the BVH walk reads the host on every level: no capture
        self.capturable = cfg.intersector != "bvh"
        dev = scene.device
        i64 = dict(dtype=torch.int64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.pixel_id = torch.zeros(n, **i64)
        self.basis = torch.zeros((4, 3), **f32)
        self.sample_id = torch.zeros((), **i64)
        self.bounce = torch.zeros((), **i64)
        self.o, self.d, self.light, self.tp, self.acc = (
            torch.zeros((n, 3), **f32) for _ in range(5))
        self.active = torch.zeros(n, dtype=torch.bool, device=dev)
        self.prev_pdf = torch.zeros(n, **f32)
        self.counters = dict(rays=torch.zeros((), **i64),
                             shadow=torch.zeros((), **i64),
                             tile_passes=torch.zeros((), **f32),
                             idle=torch.zeros((), **i64))
        self.report = torch.zeros(6, dtype=torch.float64, device=dev)

    # ---- once a call, eagerly

    def begin(self, pixel_id, first_sample, basis=None):
        """A call's pixel ids, first sample id (an int or a one-element
        tensor) and camera basis (a `camera_basis` on the device; None for
        `trace`); the accumulator and the counters at 0."""
        with span("scan.begin"):
            self.pixel_id.copy_(pixel_id)
            if isinstance(first_sample, torch.Tensor):
                self.sample_id.copy_(first_sample.reshape(()))
            else:
                self.sample_id.fill_(first_sample)
            if basis is not None:
                self.basis.copy_(basis)
            self.acc.zero_()
            for c in self.counters.values():
                c.zero_()

    def load_rays(self, o, d):
        """`trace`'s primary rays, made by its caller, in place of
        `start_sample`'s."""
        self.o.copy_(o)
        self.d.copy_(d)
        self._reset_lanes()

    def result(self):
        """(rgb_sum (n, 3), rays int64 0-d tensor): copies of the buffers."""
        with span("scan.result"):
            return self.acc.clone(), self.counters["rays"].clone()

    # ---- the functions the card replays as CUDA graphs

    def _reset_lanes(self):
        self.light.zero_()
        self.tp.fill_(1.0)
        self.active.fill_(True)
        self.prev_pdf.zero_()
        self.bounce.zero_()

    def start_sample(self):
        """Sample `sample_id`'s jittered primary rays; every lane live."""
        o, d = rays_from_basis(self.basis, self.width, self.height,
                               self.pixel_id, self.sample_id, self.seed)
        self.o.copy_(o)
        self.d.copy_(d)
        self._reset_lanes()

    def bounce_step(self):
        """One bounce step: the eager loop's unit (`scan_samples`)."""
        self._steps(1)

    def bounce_block(self):
        """`SCAN_BLOCK` bounce steps."""
        self._steps(self.block)

    def last_block(self):
        """The `max_depth % SCAN_BLOCK` steps left after the full blocks."""
        self._steps(self.last)

    def end_sample(self):
        """The sample's radiance (clamped per sample where the cfg says)
        joins the accumulator; the next sample id."""
        light = self.light
        if self.cfg.clamp_radiance:
            light = torch.clamp(light, 0.0, 1.0)
        self.acc.add_(light)
        self.sample_id.add_(1)

    def _steps(self, k):
        c = self.counters
        o, d, light, tp, active, prev_pdf = (
            self.o, self.d, self.light, self.tp, self.active, self.prev_pdf)
        bounce = self.bounce
        for _ in range(k):
            with span("scan.counters"):
                c["idle"] += (~active.any()).to(torch.int64)
            o, d, light, tp, active, prev_pdf, rays, shadow, passes, _ = _bounce_step(
                self.scene, o, d, light, tp, active, prev_pdf, self.pixel_id,
                self.sample_id, bounce, self.seed, self.cfg,
            )
            with span("scan.counters"):
                c["rays"] += rays
                c["shadow"] += shadow
                c["tile_passes"] += passes
                bounce = bounce + 1
        with span("scan.counters"):
            for buf, value in ((self.o, o), (self.d, d), (self.light, light),
                               (self.tp, tp), (self.active, active),
                               (self.prev_pdf, prev_pdf), (self.bounce, bounce)):
                buf.copy_(value)
            self.report.copy_(torch.stack([
                active.any().to(torch.float64), bounce.to(torch.float64),
                c["rays"].to(torch.float64), c["shadow"].to(torch.float64),
                c["tile_passes"].to(torch.float64), c["idle"].to(torch.float64)]))
