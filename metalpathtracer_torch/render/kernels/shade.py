"""The bounce step's shading on the card: one kernel entry.

The JAX package runs its bounce step (`_bounce_step`,
`metalpathtracer_tpu/render/integrator.py:315`) inside `jax.jit`, where XLA
fuses the closest hit's epilogue (`render/pallas/intersect_mm.py:1315`)
and the shading into a few fusions; run as separate torch kernels they are
a launch an operation. Here they are one hand-written CUDA kernel entry of
`csrc/shade.cu`:

    shade_hit   from the closest hit's raw winners (the triangle kernel's
                and the sphere pass's, `intersect_mm.closest_hit_mm_winners`)
                the epilogue in registers (`intersect_mm.hit_epilogue`'s
                refine, merge and normal), then the bounce step's shading
                without next-event estimation: sky, emission, the BSDF's
                sample, the origin offset, throughput, Russian roulette and
                the masked state update, and the live lanes' count; given
                `bank=`, then the wavefront advance's bank of the paths that
                finished (`bank_paths`) in the same thread: one launch a
                step of the wavefront at one bounce an advance

CUDA tensors launch the kernel (and count the launch in the wrapper's
`launches`; the kernel adds to its device tally, `_build.tally`); CPU
tensors take the plain twin (`shade_hit_reference`: the epilogue's twin,
`shade_reference`, then `bank_paths` where a bank is given), which the
tests hold against the JAX package; any other device raises. The kernel
computes what its twin computes in the twin's order of operations, each
rounded on its own, so that on the card the two agree bit for bit. The
BVH and brute intersectors, which give the epilogue's output and no
winners, shade with `shade_reference` and bank with `bank_paths`.
"""

from __future__ import annotations

import inspect
import numbers
from typing import NamedTuple

import torch

from metalpathtracer_torch.core import vecmath as vm
from metalpathtracer_torch.render import bsdf
from metalpathtracer_torch.render.kernels import _build
from metalpathtracer_torch.render.kernels.intersect_mm import hit_epilogue_reference

_INDEX_BYTES = {torch.int32: 4, torch.int64: 8}


# --------------------------------------------------------------------------
# the shading's operands
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


def _bank_checks(n, bounce, alive, schunk, acc, plan):
    """The bank's checks: `bounce` an int64 tensor, one a lane; the lane
    state; a plan of one of BANK_WIDTHS whose item the kernel's 32-bit slot
    division covers."""
    if not isinstance(bounce, torch.Tensor):
        raise ValueError(f"shade_hit: bounce must be an int64 tensor, one a lane, "
                         f"got {type(bounce).__name__}")
    if plan.bank_k not in BANK_WIDTHS or plan.spb < 1:
        raise ValueError(f"shade_hit: bank_k {plan.bank_k} must be one of "
                         f"{BANK_WIDTHS} and spb {plan.spb} positive")
    if plan.per_item != plan.bank_k * plan.spb or plan.per_item >= 1 << 31:
        raise ValueError(f"shade_hit: per_item {plan.per_item} must be bank_k * spb "
                         "and below 2^31")
    i64 = torch.int64
    return [("bounce", bounce, i64, (n,)), ("alive", alive, torch.bool, (n,)),
            ("schunk", schunk, i64, (n,)), ("acc", acc, torch.float32,
                                            (n, 3 * plan.bank_k))]


def _outputs(n, dev, bank_k=0):
    """New tensors for the shading's outputs (o, d, light, throughput,
    active, prev_pdf, rays: zeroed) and, with the bank, (acc, bounce,
    schunk, more, bank)."""
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


def _check_refine(refine):
    """The kernel reads a refine row as two 16-byte loads."""
    if not refine.is_contiguous() or refine.data_ptr() % 16:
        raise ValueError("shade_hit: refine must be contiguous and 16-byte aligned")


def shade_reference(o, d, light, throughput, active, prev_pdf, t, idx, normal,
                    front_face, mat_id, unit_vec, u_fresnel, u_rr, bounce, mat_bank,
                    sky, rr_start: int, adaptive_offset: bool):
    """One bounce step's shading without next-event estimation after its
    closest hit, plain torch, as the reference writes it (`render/bsdf.py`'s
    sky and sample, the 1e-4 offset, Russian roulette): every lane
    computed and the state updated where the lane hit and survived. The
    lane state o, d, light, throughput (N, 3) f32, active (N,) bool,
    prev_pdf (N,) f32; the hit t (N,) f32, idx (N,) int32 (-1 on a miss),
    normal (N, 3) f32, front_face (N,) bool, mat_id (N,) int32; the step's
    draws unit_vec (N, 3), u_fresnel (N,) and, with rr_start > 0, u_rr (N,)
    (None otherwise); bounce an int or an integer tensor of one element or
    one a lane; mat_bank (M, 16) f32; sky (2, 3) f32.
    Returns (o, d, light, throughput, active, prev_pdf, rays): new tensors,
    active the lanes that hit and survived, rays an int64 0-d tensor, the
    lanes live on entry. The BVH and brute intersectors' shading, and
    `shade_hit_reference`'s after the epilogue."""
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
# the wavefront advance's bank of finished paths
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


# --------------------------------------------------------------------------
# the shading from the closest hit's raw winners: the epilogue in registers
# --------------------------------------------------------------------------


def shade_hit(o, d, light, throughput, active, prev_pdf, t_tri, col, t_s, i_s, slot,
              refine, sph_center, sph_mat_id, t_min: float, unit_vec, u_fresnel, u_rr,
              bounce, mat_bank, sky, rr_start: int, adaptive_offset: bool, bank=None):
    """`intersect_mm.hit_epilogue` then `shade_reference` (and, given a
    bank, `bank_paths`), in one launch on the card: the lane state (as
    `shade_reference` takes it), the closest hit's winners and the
    epilogue's tables (as `hit_epilogue` takes them: t_tri and col None on a
    scene without triangles), then the draws, the bounce and the tables (as
    `shade_reference` takes them). `bank` (the wavefront's lanes at one
    bounce an advance) is (alive (N,) bool, schunk (N,) int64, acc (N, 3
    plan.bank_k) f32, plan: `BankPlan`), with `bounce` then an int64
    tensor, one a lane.
    Returns what `shade_reference` returns; with a bank, light is 0 on the
    lanes that banked, active the lanes whose path goes on, and (acc,
    bounce, schunk, more, bank) of `bank_paths` follow, bounce one step
    on."""
    n = o.shape[0]
    dev = o.device
    rr = rr_start > 0
    checks = [] if bank is None else _bank_checks(n, bounce, *bank)
    _build.check_tensors("shade_hit", _lane_checks(
        n, o, d, light, throughput, active, prev_pdf, unit_vec, u_fresnel,
        u_rr, mat_bank, sky, rr) + _winner_checks(
        n, t_tri, col, t_s, i_s, slot, refine, sph_center, sph_mat_id) + checks, dev)
    if _build.device_of("shade_hit", o) == "cpu":
        return shade_hit_reference(o, d, light, throughput, active, prev_pdf, t_tri,
                                   col, t_s, i_s, slot, refine, sph_center, sph_mat_id,
                                   t_min, unit_vec, u_fresnel, u_rr, bounce, mat_bank,
                                   sky, rr_start, adaptive_offset, bank=bank)
    if bank is None:  # the bank's pointers null, bank_k 0
        b, layout, value = _bounce_operand(bounce, n, dev) if rr else (None, 0, 0)
        state, plan = (None,) * 3, (0, 0, 0, 0, 0)
    else:  # the bounce one a lane, int64
        b, layout, value = bounce.contiguous(), 8, 0
        state = tuple(x.contiguous() for x in bank[:3])
        p = bank[3]
        plan = (int(p.max_depth), int(bool(p.clamp_radiance)), int(p.bank_k),
                int(p.spb), int(p.per_item))
    _check_refine(refine)
    outs = _outputs(n, dev, plan[2])
    if n:
        ins = tuple(x.contiguous() for x in (o, d, light, throughput, active, prev_pdf))
        hit = tuple(None if x is None else x.contiguous()
                    for x in (t_tri, col, t_s, i_s, slot))
        _build.launch("shade_hit", (*ins, *hit, refine, sph_center, sph_mat_id,
                                    unit_vec.contiguous(), u_fresnel.contiguous(),
                                    u_rr.contiguous() if rr else None, b, mat_bank, sky,
                                    *state),
                      outs + (None,) * (12 - len(outs)),
                      (n, int(t_tri is not None), sph_center.shape[0], float(t_min),
                       int(rr_start), int(bool(adaptive_offset)), layout, value, *plan),
                      dev, align=4)
        shade_hit.launches += 1
    return outs


shade_hit.launches = 0
# where the bounce sits among `shade_hit`'s (and its twin's) positional
# arguments
BOUNCE_ARG = tuple(inspect.signature(shade_hit).parameters).index("bounce")


def shade_hit_reference(o, d, light, throughput, active, prev_pdf, t_tri, col, t_s,
                        i_s, slot, refine, sph_center, sph_mat_id, t_min: float,
                        unit_vec, u_fresnel, u_rr, bounce, mat_bank, sky,
                        rr_start: int, adaptive_offset: bool, bank=None):
    """Plain torch twin of `shade_hit`: `hit_epilogue_reference`, then
    `shade_reference`, then, given a bank, `bank_paths` of one bounce
    step."""
    hit = hit_epilogue_reference(o, d, t_tri, col, t_s, i_s, slot, refine, sph_center,
                                 sph_mat_id, t_min)
    out = shade_reference(o, d, light, throughput, active, prev_pdf, *hit, unit_vec,
                          u_fresnel, u_rr, bounce, mat_bank, sky, rr_start,
                          adaptive_offset)
    if bank is None:
        return out
    o, d, light, throughput, still, prev_pdf, rays = out
    alive, schunk, acc, plan = bank
    light, acc, bounce, alive, schunk, more, banked = bank_paths(
        light, still, alive, bounce, schunk, acc, plan)
    return (o, d, light, throughput, alive, prev_pdf, rays, acc, bounce, schunk, more,
            banked)
