"""The bounce step on the card around the closest-hit kernel: three kernels.

The JAX package runs its bounce step (`_bounce_step`,
`metalpathtracer_tpu/render/integrator.py:315`) inside `jax.jit`, where XLA
fuses the exact sphere pass (`_sphere_hit_exact`,
`render/pallas/intersect_mm.py:1279`), the closest hit's epilogue (`:1315`)
and the shading into a few fusions; run as separate torch kernels they are
some 270 launches a bounce step. Here each is one hand-written CUDA kernel:

    sphere_pass   csrc/sphere_pass.cu   the exact ray-sphere test of each
                  lane against the S spheres: (t, prim id, slot); the
                  kernel `hit_front` without its feature pointers (on a
                  scene with triangles `intersect_mm.hit_front` launches it
                  with them: the closest hit's front end)
    hit_epilogue  csrc/hit_epilogue.cu  the triangle winner's plane refine,
                  the merge with the sphere pass, the normal flipped to
                  oppose the ray: (t, idx, normal, front_face, mat_id)
    shade         csrc/shade.cu         the bounce step after its closest hit
                  without next-event estimation: sky, emission, the BSDF's
                  sample, the origin offset, throughput, Russian roulette
                  and the masked state update, and the live lanes' count
    shade_bank    csrc/shade.cu         `shade`, then the wavefront
                  advance's bank of the paths that finished (`bank_paths`)
                  in the same thread: one launch a step of the wavefront at
                  one bounce an advance
    shade_hit,    csrc/shade.cu         `shade` and `shade_bank` from the
    shade_bank_hit                      closest hit's raw winners (the
                  triangle kernel's and the sphere pass's): the epilogue in
                  registers, then the shading; the bounce step's route
                  without next-event estimation on the tile intersector,
                  where the epilogue and the shading were two launches

CUDA tensors launch the kernel (and count the launch in the wrapper's
`launches`; the kernel adds to its device tally, `_build.tally`); CPU
tensors take the plain twin (`*_reference`), which the tests hold against
the JAX package; any other device raises. Each kernel computes what its
twin computes in the twin's order of operations, each rounded on its own,
so that on the card the two agree bit for bit.
"""

from __future__ import annotations

import numbers
from typing import NamedTuple

import torch

from metalpathtracer_torch.core import vecmath as vm
from metalpathtracer_torch.render import bsdf
from metalpathtracer_torch.render.intersect import TRI_PARALLEL_EPS, ray_sphere
from metalpathtracer_torch.render.kernels import _build

_INF = float("inf")
_INDEX_BYTES = {torch.int32: 4, torch.int64: 8}


def _device_of(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type


# --------------------------------------------------------------------------
# the sphere pass
# --------------------------------------------------------------------------


def sphere_pass(o, d, sph_center, sph_radius, sph_ids, t_min: float):
    """Each ray's nearest sphere: o, d (N, 3) f32 rays; sph_center (S, 3),
    sph_radius (S,) f32 and sph_ids (S,) int32 the sphere SoA (padding
    spheres have radius 0). Returns (t (N,) f32, inf on a miss; idx (N,)
    int32 the sphere's primitive id, -1 on a miss; slot (N,) int32 the
    first slot of the smallest t, 0 on a miss)."""
    n, s = o.shape[0], sph_center.shape[0]
    f32 = torch.float32
    _build.check_tensors("sphere_pass", [
        ("o", o, f32, (n, 3)), ("d", d, f32, (n, 3)),
        ("sph_center", sph_center, f32, (s, 3)),
        ("sph_radius", sph_radius, f32, (s,)),
        ("sph_ids", sph_ids, torch.int32, (s,)),
    ], o.device)
    if _device_of("sphere_pass", o) == "cpu":
        return sphere_pass_reference(o, d, sph_center, sph_radius, sph_ids, t_min)
    t = torch.empty(n, dtype=f32, device=o.device)
    idx = torch.empty(n, dtype=torch.int32, device=o.device)
    slot = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:  # the front end's kernel without its operands: the winner alone
        _build.launch("hit_front", (o.contiguous(), d.contiguous(), None, None,
                                    sph_center, sph_radius, sph_ids),
                      (t, idx, slot, None, None, None), (n, s, float(t_min)),
                      o.device, align=4)
        sphere_pass.launches += 1
    return t, idx, slot


sphere_pass.launches = 0


def sphere_pass_reference(o, d, sph_center, sph_radius, sph_ids, t_min: float):
    """Plain torch twin of `sphere_pass`: `ray_sphere` over the (N, S)
    pairs and `torch.min` over the spheres (the first slot of equal t)."""
    n = o.shape[0]
    if sph_center.shape[0] == 0:
        return (torch.full((n,), _INF, dtype=torch.float32, device=o.device),
                torch.full((n,), -1, dtype=torch.int32, device=o.device),
                torch.zeros((n,), dtype=torch.int32, device=o.device))
    t = ray_sphere(o[:, None, :], d[:, None, :], sph_center[None, :, :],
                   sph_radius[None, :], t_min)
    t_best, slot = torch.min(t, dim=1)
    idx = torch.where(torch.isinf(t_best), -1, sph_ids[slot])
    return t_best, idx, slot.to(torch.int32)


# --------------------------------------------------------------------------
# the closest hit's epilogue
# --------------------------------------------------------------------------


def hit_epilogue(o, d, t_tri, col, t_s, i_s, slot, refine, sph_center,
                 sph_mat_id, t_min: float):
    """The closest hit from its two passes. o, d (N, 3) f32 rays; t_tri
    (N,) f32 and col (N,) int32 the triangle kernel's winner (t and kernel
    column, -1 on a miss), both None on a scene without triangles; t_s,
    i_s, slot (N,) the sphere pass's (`sphere_pass`); refine (T, 8) f32 the
    rows [n, n.v0, prim, mat, 0, 0] of the kernel's columns; sph_center
    (S, 3) f32, sph_mat_id (S,) int32.
    Returns (t (N,) f32, idx (N,) int32 (-1 on a miss), normal (N, 3) f32
    opposing d, front_face (N,) bool, mat_id (N,) int32); normal and mat_id
    are garbage on a miss."""
    n, s = o.shape[0], sph_center.shape[0]
    f32, i32 = torch.float32, torch.int32
    tris = t_tri is not None
    _build.check_tensors("hit_epilogue", [
        ("o", o, f32, (n, 3)), ("d", d, f32, (n, 3)),
        ("t_s", t_s, f32, (n,)), ("i_s", i_s, i32, (n,)), ("slot", slot, i32, (n,)),
        ("refine", refine, f32, (refine.shape[0], 8)),
        ("sph_center", sph_center, f32, (s, 3)),
        ("sph_mat_id", sph_mat_id, i32, (s,)),
    ] + ([("t_tri", t_tri, f32, (n,)), ("col", col, i32, (n,))] if tris else []),
        o.device)
    if _device_of("hit_epilogue", o) == "cpu":
        return hit_epilogue_reference(o, d, t_tri, col, t_s, i_s, slot, refine,
                                      sph_center, sph_mat_id, t_min)
    dev = o.device
    t = torch.empty(n, dtype=f32, device=dev)
    idx = torch.empty(n, dtype=i32, device=dev)
    normal = torch.empty((n, 3), dtype=f32, device=dev)
    front = torch.empty(n, dtype=torch.bool, device=dev)
    mat_id = torch.empty(n, dtype=i32, device=dev)
    if n:
        _build.launch("hit_epilogue", (o.contiguous(), d.contiguous(), t_tri, col,
                                       t_s, i_s, slot, refine, sph_center, sph_mat_id),
                      (t, idx, normal, front, mat_id), (n, int(tris), s, float(t_min)),
                      dev)
        hit_epilogue.launches += 1
    return t, idx, normal, front, mat_id


hit_epilogue.launches = 0


def hit_epilogue_reference(o, d, t_tri, col, t_s, i_s, slot, refine, sph_center,
                           sph_mat_id, t_min: float):
    """Plain torch twin of `hit_epilogue`: the winner's refine row gathered,
    its t re-derived from its plane (a re-test that rejects the kernel's
    winner keeps the kernel's t), merged with the sphere pass."""
    n = o.shape[0]
    if sph_center.shape[0]:
        k = slot.to(torch.int64)
        c, m_s = sph_center[k], sph_mat_id[k]
    else:
        c = torch.zeros_like(o)
        m_s = torch.zeros((n,), dtype=torch.int32, device=o.device)
    sph_n = vm.normalize(o + t_s[:, None] * d - c)
    if t_tri is not None:
        row = refine[col.clamp(min=0).to(torch.int64)]
        nvec = row[:, 0:3]
        ndotv0 = row[:, 3]
        i_t = row[:, 4].to(torch.int32)
        m_t = row[:, 5].to(torch.int32)
        denom = vm.dot(nvec, d)
        parallel = torch.abs(denom) <= TRI_PARALLEL_EPS
        t_plane = (ndotv0 - vm.dot(nvec, o)) / torch.where(parallel, 1.0, denom)
        t_exact = torch.where((~parallel) & (t_plane > t_min), t_plane, _INF)
        # an exact re-test that rejects the kernel's winner keeps the
        # kernel's t rather than reporting a miss (no edge sparkle)
        tri_hit = (col >= 0) & torch.isfinite(t_tri)
        t_t = torch.where(
            tri_hit, torch.where(torch.isfinite(t_exact), t_exact, t_tri), _INF
        )
        i_t = torch.where(tri_hit, i_t, -1)
        tri_n = vm.normalize(nvec)
    else:
        t_t = torch.full((n,), _INF, dtype=torch.float32, device=o.device)
        i_t = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        m_t = torch.zeros((n,), dtype=torch.int32, device=o.device)
        tri_n = torch.zeros_like(o)
    tri_wins = t_t < t_s
    t = torch.where(tri_wins, t_t, t_s)
    idx = torch.where(tri_wins, i_t, i_s)
    mat_id = torch.where(tri_wins, m_t, m_s)
    normal = vm.where3(tri_wins, tri_n, sph_n)
    front_face = vm.dot(normal, d) < 0.0
    normal = vm.where3(front_face, normal, -normal)
    return t, idx, normal, front_face, mat_id


# --------------------------------------------------------------------------
# the shading
# --------------------------------------------------------------------------


def _bounce_operand(bounce, n: int, device):
    """(tensor or None, layout, value) of the bounce for the kernel: a
    Python int by value, one element read by every lane (minus its index
    bytes), or one a lane (its index bytes)."""
    if isinstance(bounce, numbers.Integral):
        return None, 0, int(bounce)
    if not isinstance(bounce, torch.Tensor) or bounce.dtype.is_floating_point:
        raise ValueError(f"shade: bounce must be an int or an integer tensor, got "
                         f"{type(bounce).__name__} {getattr(bounce, 'dtype', '')}")
    if bounce.device != device:
        raise ValueError(f"shade: bounce is on {bounce.device}, not {device}")
    if bounce.dtype not in _INDEX_BYTES:
        bounce = bounce.to(torch.int64)
    size = _INDEX_BYTES[bounce.dtype]
    if bounce.numel() == 1:
        return bounce.contiguous(), -size, 0
    if tuple(bounce.shape) != (n,):
        raise ValueError(f"shade: bounce of shape {tuple(bounce.shape)} for {n} lanes")
    return bounce.contiguous(), size, 0


def _lane_checks(n, o, d, light, throughput, active, prev_pdf, unit_vec, u_fresnel,
                 u_rr, mat_bank, sky, rr: bool):
    """The shading's (name, tensor, dtype, shape) checks of the lane state,
    the draws (u_rr with roulette alone) and the tables
    (`_build.check_tensors`)."""
    f32 = torch.float32
    if rr and u_rr is None:
        raise ValueError("the shading: u_rr is needed with rr_start > 0")
    u_rr = u_rr if rr else None
    return [
        ("o", o, f32, (n, 3)), ("d", d, f32, (n, 3)), ("light", light, f32, (n, 3)),
        ("throughput", throughput, f32, (n, 3)), ("active", active, torch.bool, (n,)),
        ("prev_pdf", prev_pdf, f32, (n,)), ("unit_vec", unit_vec, f32, (n, 3)),
        ("u_fresnel", u_fresnel, f32, (n,)),
        ("mat_bank", mat_bank, f32, (mat_bank.shape[0], 16)), ("sky", sky, f32, (2, 3)),
    ] + ([("u_rr", u_rr, f32, (n,))] if u_rr is not None else [])


def _winner_checks(n, t_tri, col, t_s, i_s, slot, refine, sph_center, sph_mat_id):
    """The (name, tensor, dtype, shape) checks of the closest hit's winners
    and the epilogue's tables."""
    f32, i32, s = torch.float32, torch.int32, sph_center.shape[0]
    if (t_tri is None) != (col is None):
        raise ValueError("the closest hit's winners: t_tri and col are both tensors "
                         "or both None")
    return [
        ("t_s", t_s, f32, (n,)), ("i_s", i_s, i32, (n,)), ("slot", slot, i32, (n,)),
        ("refine", refine, f32, (refine.shape[0], 8)),
        ("sph_center", sph_center, f32, (s, 3)), ("sph_mat_id", sph_mat_id, i32, (s,)),
    ] + ([("t_tri", t_tri, f32, (n,)), ("col", col, i32, (n,))]
         if t_tri is not None else [])


# the bank's widths: the pixels of a work item a wavefront render picks
# (`integrator._Wavefront`), one kernel instance each
BANK_WIDTHS = (1, 2, 4, 8, 16)


def _bank_checks(name, n, bounce, alive, schunk, acc, plan):
    """The bank's checks: `bounce` an int64 tensor, one a lane; the lane
    state; a plan of one of BANK_WIDTHS whose item the kernel's 32-bit slot
    division covers."""
    if not isinstance(bounce, torch.Tensor):
        raise ValueError(f"{name}: bounce must be an int64 tensor, one a lane, "
                         f"got {type(bounce).__name__}")
    if plan.bank_k not in BANK_WIDTHS or plan.spb < 1:
        raise ValueError(f"{name}: bank_k {plan.bank_k} must be one of "
                         f"{BANK_WIDTHS} and spb {plan.spb} positive")
    if plan.per_item != plan.bank_k * plan.spb or plan.per_item >= 1 << 31:
        raise ValueError(f"{name}: per_item {plan.per_item} must be bank_k * spb "
                         "and below 2^31")
    i64 = torch.int64
    return [("bounce", bounce, i64, (n,)), ("alive", alive, torch.bool, (n,)),
            ("schunk", schunk, i64, (n,)), ("acc", acc, torch.float32,
                                            (n, 3 * plan.bank_k))]


def _outputs(n, dev, bank_k=0):
    """New tensors for a shading's outputs (o, d, light, throughput, active,
    prev_pdf, rays: zeroed) and, with the bank, (acc, bounce, schunk, more,
    bank)."""
    f32, i64 = torch.float32, torch.int64
    outs = tuple(torch.empty((n, 3), dtype=f32, device=dev) for _ in range(4)) + (
        torch.empty(n, dtype=torch.bool, device=dev),
        torch.empty(n, dtype=f32, device=dev),
        torch.zeros((), dtype=i64, device=dev))
    if bank_k:
        outs += (torch.empty((n, 3 * bank_k), dtype=f32, device=dev),
                 torch.empty(n, dtype=i64, device=dev),
                 torch.empty(n, dtype=i64, device=dev),
                 torch.empty(n, dtype=torch.bool, device=dev),
                 torch.empty(n, dtype=torch.bool, device=dev))
    return outs


def _check_refine(name, refine):
    """The kernel reads a refine row as two 16-byte loads."""
    if not refine.is_contiguous() or refine.data_ptr() % 16:
        raise ValueError(f"{name}: refine must be contiguous and 16-byte aligned")


def _plan_scalars(plan):
    return (int(plan.max_depth), int(bool(plan.clamp_radiance)), int(plan.bank_k),
            int(plan.spb), int(plan.per_item))


def shade(o, d, light, throughput, active, prev_pdf, t, idx, normal, front_face,
          mat_id, unit_vec, u_fresnel, u_rr, bounce, mat_bank, sky,
          rr_start: int, adaptive_offset: bool):
    """One bounce step's shading without next-event estimation, after its
    closest hit. The lane state o, d, light, throughput (N, 3) f32, active
    (N,) bool, prev_pdf (N,) f32; the hit t (N,) f32, idx (N,) int32 (-1 on
    a miss), normal (N, 3) f32, front_face (N,) bool, mat_id (N,) int32; the
    step's draws unit_vec (N, 3), u_fresnel (N,) and, with rr_start > 0,
    u_rr (N,) (None otherwise); bounce an int or an integer tensor of one
    element or one a lane; mat_bank (M, 16) f32; sky (2, 3) f32.
    Returns (o, d, light, throughput, active, prev_pdf, rays): new tensors,
    active the lanes that hit and survived, rays an int64 0-d tensor, the
    lanes live on entry."""
    n = o.shape[0]
    f32, dev = torch.float32, o.device
    rr = rr_start > 0
    _build.check_tensors("shade", _lane_checks(
        n, o, d, light, throughput, active, prev_pdf, unit_vec, u_fresnel,
        u_rr, mat_bank, sky, rr) + [
        ("t", t, f32, (n,)), ("idx", idx, torch.int32, (n,)),
        ("normal", normal, f32, (n, 3)), ("front_face", front_face, torch.bool, (n,)),
        ("mat_id", mat_id, torch.int32, (n,))], dev)
    if _device_of("shade", o) == "cpu":
        return shade_reference(o, d, light, throughput, active, prev_pdf, t, idx,
                               normal, front_face, mat_id, unit_vec, u_fresnel, u_rr,
                               bounce, mat_bank, sky, rr_start, adaptive_offset)
    b, layout, value = _bounce_operand(bounce, n, dev) if rr else (None, 0, 0)
    outs = _outputs(n, dev)
    if n:
        ins = tuple(x.contiguous() for x in (o, d, light, throughput, active, prev_pdf,
                                             t, idx, normal, front_face, mat_id,
                                             unit_vec, u_fresnel))
        _build.launch("shade", (*ins, u_rr.contiguous() if rr else None, b, mat_bank,
                                sky), outs,
                      (n, int(rr_start), int(bool(adaptive_offset)), layout, value),
                      dev, align=4)
        shade.launches += 1
    return outs


shade.launches = 0


def shade_reference(o, d, light, throughput, active, prev_pdf, t, idx, normal,
                    front_face, mat_id, unit_vec, u_fresnel, u_rr, bounce, mat_bank,
                    sky, rr_start: int, adaptive_offset: bool):
    """Plain torch twin of `shade`: the bounce step's shading as the
    reference writes it (`render/bsdf.py`'s sky and sample, the 1e-4
    offset, Russian roulette), every lane computed and the state updated
    where the lane hit and survived."""
    rays = active.sum(dtype=torch.int64)
    miss = idx < 0
    sky_rgb = bsdf.sky_color(d, sky)
    light = light + torch.where((active & miss)[:, None], throughput * sky_rgb, 0.0)

    hit_live = active & ~miss
    point = o + t[:, None] * d
    mat_row = mat_bank[mat_id.to(torch.int64)]
    albedo = mat_row[:, 0:3]
    mat_type = mat_row[:, 3]
    emission = mat_row[:, 4:7]
    power = mat_row[:, 7]
    fuzz = mat_row[:, 8]
    count_emission = hit_live & bsdf.is_emissive(mat_type, power)
    emit = throughput * emission * power[:, None]
    light = light + torch.where(count_emission[:, None], emit, 0.0)

    d_out, offset_sign = bsdf.sample_bsdf(d, normal, front_face, mat_type, fuzz,
                                          unit_vec, u_fresnel)
    if adaptive_offset:
        scale = torch.clamp(torch.abs(point).amax(dim=-1), min=1.0)
        new_o = point + (1e-4 * offset_sign * scale)[..., None] * normal
    else:
        new_o = point + (1e-4 * offset_sign)[..., None] * normal
    new_tp = throughput * albedo

    # Russian roulette (unbiased early termination), from bounce rr_start
    # on; `bounce` is an int (scan) or a per-lane tensor (wavefront)
    if rr_start > 0:
        p = torch.clamp(new_tp.amax(dim=-1), 0.05, 1.0)
        do_rr = bounce >= rr_start
        if not isinstance(do_rr, torch.Tensor):  # one bool for every lane
            do_rr = torch.full_like(p, do_rr, dtype=torch.bool)  # a fill, no upload
        new_tp = new_tp * torch.where(do_rr, 1.0 / p, 1.0)[..., None]
        hit_live = hit_live & (~do_rr | (u_rr < p))

    o = vm.where3(hit_live, new_o, o)
    d = vm.where3(hit_live, d_out, d)
    throughput = torch.where(hit_live[:, None], new_tp, throughput)
    prev_pdf = torch.where(hit_live, torch.zeros_like(prev_pdf), prev_pdf)
    return o, d, light, throughput, hit_live, prev_pdf, rays


# --------------------------------------------------------------------------
# the shading and the wavefront's bank in one launch
# --------------------------------------------------------------------------


class BankPlan(NamedTuple):
    """What a wavefront render's bank of finished paths is fixed by: the
    path depth, the per-sample clamp of radiance, the pixels of a work item
    (`bank_k`, 3 accumulator floats each), the samples a pixel of an item
    banks (`spb`) and the paths an item finishes (`per_item` = bank_k *
    spb)."""

    max_depth: int
    clamp_radiance: bool
    bank_k: int
    spb: int
    per_item: int


def bank_paths(light, still, alive, bounce, schunk, acc, plan: BankPlan,
               bounces: int = 1):
    """The wavefront advance's bank, plain torch: after `bounces` bounce
    steps from `bounce` (N,) int64, a lane `alive` (N,) bool on entry whose
    path ended (not `still` live, or at max_depth) adds its `light` (N, 3)
    (clamped to [0, 1] with `clamp_radiance`) to accumulator slot `schunk //
    spb` of `acc` (N, 3 bank_k), its light goes to 0, and it moves on to its
    item's next path (`more`) or finishes the item (`bank`, schunk back to 0).
    Returns (light, acc, bounce, alive, schunk, more, bank): new tensors."""
    bank_k, spb = plan.bank_k, plan.spb
    bounce_next = bounce + bounces
    survivors = still & (bounce_next < plan.max_depth)
    path_done = alive & ~survivors

    # the finished path joins accumulator slot schunk // spb
    ps = torch.clamp(light, 0.0, 1.0) if plan.clamp_radiance else light
    if bank_k == 1:
        acc = acc + torch.where(path_done[:, None], ps, 0.0)
    else:
        slot = (torch.arange(bank_k, device=light.device)[None, :]
                == (schunk // spb)[:, None])  # (N, K)
        mask = path_done[:, None] & slot
        acc = acc + torch.where(mask[:, :, None], ps[:, None, :],
                                0.0).reshape(-1, 3 * bank_k)
    light = torch.where(path_done[:, None], 0.0, light)
    schunk_next = schunk + path_done.to(torch.int64)
    more = path_done & (schunk_next < plan.per_item)
    bank = path_done & ~more  # the item is finished
    schunk = torch.where(path_done, torch.where(bank, 0, schunk_next), schunk)
    return light, acc, bounce_next, survivors, schunk, more, bank


def shade_bank(o, d, light, throughput, active, prev_pdf, t, idx, normal, front_face,
               mat_id, unit_vec, u_fresnel, u_rr, bounce, mat_bank, sky,
               rr_start: int, adaptive_offset: bool, alive, schunk, acc,
               plan: BankPlan):
    """`shade` on the wavefront's lanes, then the advance's bank of the
    paths that ended (`bank_paths`, one bounce step an advance), in one
    launch on the card. The arguments of `shade`, with `bounce` (N,) int64
    one a lane, then the lane state alive (N,) bool, schunk (N,) int64 and
    acc (N, 3 plan.bank_k) f32, and the render's `plan`.
    Returns (o, d, light, throughput, alive, prev_pdf, rays, acc, bounce,
    schunk, more, bank): new tensors; light is 0 on the lanes that banked,
    alive the lanes whose path goes on, bounce one step on."""
    n = o.shape[0]
    f32, dev = torch.float32, o.device
    rr = rr_start > 0
    bank_checks = _bank_checks("shade_bank", n, bounce, alive, schunk, acc, plan)
    _build.check_tensors("shade_bank", _lane_checks(
        n, o, d, light, throughput, active, prev_pdf, unit_vec, u_fresnel,
        u_rr, mat_bank, sky, rr) + [
        ("t", t, f32, (n,)), ("idx", idx, torch.int32, (n,)),
        ("normal", normal, f32, (n, 3)), ("front_face", front_face, torch.bool, (n,)),
        ("mat_id", mat_id, torch.int32, (n,))] + bank_checks, dev)
    if _device_of("shade_bank", o) == "cpu":
        return shade_bank_reference(o, d, light, throughput, active, prev_pdf, t, idx,
                                    normal, front_face, mat_id, unit_vec, u_fresnel,
                                    u_rr, bounce, mat_bank, sky, rr_start,
                                    adaptive_offset, alive, schunk, acc, plan)
    outs = _outputs(n, dev, plan.bank_k)
    if n:
        ins = tuple(x.contiguous() for x in (o, d, light, throughput, active, prev_pdf,
                                             t, idx, normal, front_face, mat_id,
                                             unit_vec, u_fresnel))
        state = tuple(x.contiguous() for x in (alive, schunk, acc))
        _build.launch("shade_bank", (*ins, u_rr.contiguous() if rr else None,
                                     bounce.contiguous(), mat_bank, sky, *state), outs,
                      (n, int(rr_start), int(bool(adaptive_offset)),
                       *_plan_scalars(plan)),
                      dev, align=4)
        shade_bank.launches += 1
    return outs


shade_bank.launches = 0


def shade_bank_reference(o, d, light, throughput, active, prev_pdf, t, idx, normal,
                         front_face, mat_id, unit_vec, u_fresnel, u_rr, bounce,
                         mat_bank, sky, rr_start: int, adaptive_offset: bool, alive,
                         schunk, acc, plan: BankPlan):
    """Plain torch twin of `shade_bank`: `shade_reference`, then
    `bank_paths` of one bounce step."""
    o, d, light, throughput, still, prev_pdf, rays = shade_reference(
        o, d, light, throughput, active, prev_pdf, t, idx, normal, front_face,
        mat_id, unit_vec, u_fresnel, u_rr, bounce, mat_bank, sky, rr_start,
        adaptive_offset)
    light, acc, bounce, alive, schunk, more, bank = bank_paths(
        light, still, alive, bounce, schunk, acc, plan)
    return (o, d, light, throughput, alive, prev_pdf, rays, acc, bounce, schunk, more,
            bank)


# --------------------------------------------------------------------------
# the shading from the closest hit's raw winners: the epilogue in registers
# --------------------------------------------------------------------------


def shade_hit(o, d, light, throughput, active, prev_pdf, t_tri, col, t_s, i_s, slot,
              refine, sph_center, sph_mat_id, t_min: float, unit_vec, u_fresnel, u_rr,
              bounce, mat_bank, sky, rr_start: int, adaptive_offset: bool):
    """`hit_epilogue` then `shade`, in one launch on the card: the lane
    state (as `shade`'s), the closest hit's winners and the epilogue's
    tables (as `hit_epilogue`'s: t_tri and col None on a scene without
    triangles), then the draws, the bounce and the tables (as `shade`'s).
    Returns what `shade` returns."""
    n = o.shape[0]
    dev = o.device
    rr = rr_start > 0
    _build.check_tensors("shade_hit", _lane_checks(
        n, o, d, light, throughput, active, prev_pdf, unit_vec, u_fresnel,
        u_rr, mat_bank, sky, rr) + _winner_checks(
        n, t_tri, col, t_s, i_s, slot, refine, sph_center, sph_mat_id), dev)
    if _device_of("shade_hit", o) == "cpu":
        return shade_hit_reference(o, d, light, throughput, active, prev_pdf, t_tri,
                                   col, t_s, i_s, slot, refine, sph_center, sph_mat_id,
                                   t_min, unit_vec, u_fresnel, u_rr, bounce, mat_bank,
                                   sky, rr_start, adaptive_offset)
    b, layout, value = _bounce_operand(bounce, n, dev) if rr else (None, 0, 0)
    _check_refine("shade_hit", refine)
    outs = _outputs(n, dev)
    if n:
        tris = t_tri is not None
        ins = tuple(x.contiguous() for x in (o, d, light, throughput, active, prev_pdf))
        hit = tuple(None if x is None else x.contiguous()
                    for x in (t_tri, col, t_s, i_s, slot))
        _build.launch("shade_hit", (*ins, *hit, refine, sph_center, sph_mat_id,
                                    unit_vec.contiguous(), u_fresnel.contiguous(),
                                    u_rr.contiguous() if rr else None, b, mat_bank, sky),
                      outs, (n, int(tris), sph_center.shape[0], float(t_min),
                             int(rr_start), int(bool(adaptive_offset)), layout, value),
                      dev, align=4)
        shade_hit.launches += 1
    return outs


shade_hit.launches = 0


def shade_hit_reference(o, d, light, throughput, active, prev_pdf, t_tri, col, t_s,
                        i_s, slot, refine, sph_center, sph_mat_id, t_min: float,
                        unit_vec, u_fresnel, u_rr, bounce, mat_bank, sky,
                        rr_start: int, adaptive_offset: bool):
    """Plain torch twin of `shade_hit`: `hit_epilogue_reference`, then
    `shade_reference`."""
    hit = hit_epilogue_reference(o, d, t_tri, col, t_s, i_s, slot, refine, sph_center,
                                 sph_mat_id, t_min)
    return shade_reference(o, d, light, throughput, active, prev_pdf, *hit, unit_vec,
                           u_fresnel, u_rr, bounce, mat_bank, sky, rr_start,
                           adaptive_offset)


def shade_bank_hit(o, d, light, throughput, active, prev_pdf, t_tri, col, t_s, i_s,
                   slot, refine, sph_center, sph_mat_id, t_min: float, unit_vec,
                   u_fresnel, u_rr, bounce, mat_bank, sky, rr_start: int,
                   adaptive_offset: bool, alive, schunk, acc, plan: BankPlan):
    """`hit_epilogue` then `shade_bank`, in one launch on the card: the
    arguments of `shade_hit` (with `bounce` an int64 tensor, one a lane),
    then `shade_bank`'s lane state and plan. Returns what `shade_bank`
    returns."""
    n = o.shape[0]
    dev = o.device
    rr = rr_start > 0
    bank_checks = _bank_checks("shade_bank_hit", n, bounce, alive, schunk, acc, plan)
    _build.check_tensors("shade_bank_hit", _lane_checks(
        n, o, d, light, throughput, active, prev_pdf, unit_vec, u_fresnel,
        u_rr, mat_bank, sky, rr) + _winner_checks(
        n, t_tri, col, t_s, i_s, slot, refine, sph_center, sph_mat_id) + bank_checks,
        dev)
    if _device_of("shade_bank_hit", o) == "cpu":
        return shade_bank_hit_reference(o, d, light, throughput, active, prev_pdf, t_tri,
                                        col, t_s, i_s, slot, refine, sph_center,
                                        sph_mat_id, t_min, unit_vec, u_fresnel, u_rr,
                                        bounce, mat_bank, sky, rr_start,
                                        adaptive_offset, alive, schunk, acc, plan)
    _check_refine("shade_bank_hit", refine)
    outs = _outputs(n, dev, plan.bank_k)
    if n:
        tris = t_tri is not None
        ins = tuple(x.contiguous() for x in (o, d, light, throughput, active, prev_pdf))
        hit = tuple(None if x is None else x.contiguous()
                    for x in (t_tri, col, t_s, i_s, slot))
        state = tuple(x.contiguous() for x in (alive, schunk, acc))
        _build.launch("shade_bank_hit", (*ins, *hit, refine, sph_center, sph_mat_id,
                                         unit_vec.contiguous(), u_fresnel.contiguous(),
                                         u_rr.contiguous() if rr else None,
                                         bounce.contiguous(), mat_bank, sky, *state),
                      outs, (n, int(tris), sph_center.shape[0], float(t_min),
                             int(rr_start), int(bool(adaptive_offset)),
                             *_plan_scalars(plan)),
                      dev, align=4)
        shade_bank_hit.launches += 1
    return outs


shade_bank_hit.launches = 0


def shade_bank_hit_reference(o, d, light, throughput, active, prev_pdf, t_tri, col,
                             t_s, i_s, slot, refine, sph_center, sph_mat_id,
                             t_min: float, unit_vec, u_fresnel, u_rr, bounce, mat_bank,
                             sky, rr_start: int, adaptive_offset: bool, alive, schunk,
                             acc, plan: BankPlan):
    """Plain torch twin of `shade_bank_hit`: `hit_epilogue_reference`, then
    `shade_bank_reference`."""
    hit = hit_epilogue_reference(o, d, t_tri, col, t_s, i_s, slot, refine, sph_center,
                                 sph_mat_id, t_min)
    return shade_bank_reference(o, d, light, throughput, active, prev_pdf, *hit,
                                unit_vec, u_fresnel, u_rr, bounce, mat_bank, sky,
                                rr_start, adaptive_offset, alive, schunk, acc, plan)
