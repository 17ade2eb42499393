"""The persistent wavefront's regeneration on the card: four kernels.

The JAX package refills its wavefront's lanes inside the jitted window
(`one_advance`, `restart_lanes`, `pix_samp_of` and `maybe_sort`'s tile-set
branch, `metalpathtracer_tpu/render/integrator.py:979-995, 768-779, 624-638,
835-870, 916-940`), where XLA fuses it into a few fusions; run as separate
torch kernels it is some 76 launches an advance. Here each part is one
hand-written CUDA kernel of `csrc/wavefront.cu`:

    restart_lanes  each lane's pixel and sample from its work item, and
                   where it restarts the jittered primary ray (its threefry
                   pair drawn in the kernel) and the reset path state
    queue_pop      the window's queue after an advance: banked lanes hand
                   their accumulators to the pending bank and take the next
                   items in lane order (in place), and the restart mask
    tileset_key    each lane's tile-set signature over the scene's coarse
                   boxes, the pool sort's key (`torch.argsort` sorts it)
    permute_lanes  the lane state (and the pending bank) gathered by the
                   sort's permutation into contiguous fields

CUDA tensors launch the kernel (and count the launch in the wrapper's
`launches`; the kernel adds to its device tally, `_build.tally`); CPU
tensors take the plain twin (`*_reference`), which the tests hold against
the JAX package and the composition the kernels replaced; any other device
raises. Each kernel computes what its twin computes on the card, each
operation rounded on its own in the twin's order, so that there the two
agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from metalpathtracer_torch.render.camera import rays_from_basis
from metalpathtracer_torch.render.kernels import _build
from metalpathtracer_torch.render.kernels.intersect_mm import _cull_hit_mask

# a wavefront lane's state (`integrator._Wavefront`): its dtype and its
# trailing shape (acc's width is 3 bank_k)
LANE_FIELDS = ("item", "schunk", "acc", "o", "d", "bounce", "light", "tp",
               "prev_pdf", "alive", "pixel", "sample")
_F32, _I64, _BOOL = torch.float32, torch.int64, torch.bool
LANE_DTYPES = dict(item=_I64, schunk=_I64, acc=_F32, o=_F32, d=_F32, bounce=_I64,
                   light=_F32, tp=_F32, prev_pdf=_F32, alive=_BOOL, pixel=_I64,
                   sample=_I64)
MAX_BOXES = 32  # bits of the tile-set key


class LanePlan(NamedTuple):
    """What a wavefront render's lanes map to: the image (`width`,
    `height`), the work items (`groups` items of `bank_k` pixels, `spb`
    samples a pixel a chunk), the first pixel of the render's range
    (`pixel_offset`: pixel ids stay global), the u32 seed word, and the
    image rows between two rows of the range (`row_stride`: 1 for a
    contiguous range, n for every n-th row of a tile shard)."""

    width: int
    height: int
    groups: int
    bank_k: int
    spb: int
    pixel_offset: int
    seed: int
    row_stride: int = 1


def _lane_checks(lanes, fields, n, ka=None):
    """(name, tensor, dtype, shape) of `fields` of the lane dict."""
    shapes = dict(acc=(n, ka), o=(n, 3), d=(n, 3), light=(n, 3), tp=(n, 3))
    return [(k, lanes[k], LANE_DTYPES[k], shapes.get(k, (n,))) for k in fields]


# --------------------------------------------------------------------------
# the restart
# --------------------------------------------------------------------------


def pixel_sample(item, schunk, sample_offset, plan: LanePlan):
    """(pixel, sample) int64 of each lane: item % groups names a framebuffer
    row of bank_k pixels, item // groups the item's sample chunk;
    `sample_offset` (a 0-d int64 tensor or an int) the render's first
    sample id. Local pixel l is global pixel pixel_offset + l + (l // width)
    * (row_stride - 1) * width: local row i is image row i * row_stride
    past the range's first."""
    local = (item % plan.groups) * plan.bank_k + schunk // plan.spb
    pixel = (plan.pixel_offset + local
             + (local // plan.width) * ((plan.row_stride - 1) * plan.width))
    sample = (item // plan.groups) * plan.spb + schunk % plan.spb + sample_offset
    return pixel, sample


_RESTART_READS = ("item", "schunk", "o", "d", "tp", "bounce", "prev_pdf", "alive")


def restart_lanes(lanes: dict, restart, basis, sample_offset, plan: LanePlan) -> dict:
    """Every lane's pixel and sample, and fresh primary rays where
    `restart`. `lanes` holds the wavefront's lane fields (`LANE_FIELDS`;
    this reads item, schunk, o, d, tp, bounce, prev_pdf and alive), restart
    (N,) bool, basis the camera's (4, 3) f32 `camera_basis`, sample_offset
    a 0-d int64 tensor (read on the device). Returns a new dict: `lanes`
    with new o, d, tp (1 where restarted), bounce (0), prev_pdf (0), alive
    (| restart), pixel and sample."""
    n = lanes["item"].shape[0]
    dev = lanes["item"].device
    _build.check_tensors("restart_lanes", _lane_checks(
        lanes, _RESTART_READS, n) + [
        ("restart", restart, _BOOL, (n,)), ("basis", basis, _F32, (4, 3)),
        ("sample_offset", sample_offset, _I64, ())], dev)
    if _build.device_of("restart_lanes", lanes["item"]) == "cpu":
        return restart_lanes_reference(lanes, restart, basis, sample_offset, plan)
    o, d, tp = (torch.empty((n, 3), dtype=_F32, device=dev) for _ in range(3))
    bounce, pixel, sample = (torch.empty(n, dtype=_I64, device=dev) for _ in range(3))
    prev_pdf = torch.empty(n, dtype=_F32, device=dev)
    alive = torch.empty(n, dtype=_BOOL, device=dev)
    if n:
        _build.launch("restart_lanes", tuple(lanes[k].contiguous() for k in _RESTART_READS)
                      + (restart.contiguous(), basis.contiguous(), sample_offset),
                      (o, d, tp, bounce, prev_pdf, alive, pixel, sample),
                      (n, int(plan.width), int(plan.height), int(plan.groups),
                       int(plan.bank_k), int(plan.spb), int(plan.pixel_offset),
                       int(plan.row_stride), int(plan.seed) & 0xFFFFFFFF), dev,
                      align=8)
        restart_lanes.launches += 1
    return dict(lanes, o=o, d=d, tp=tp, bounce=bounce, prev_pdf=prev_pdf, alive=alive,
                pixel=pixel, sample=sample)


restart_lanes.launches = 0


def restart_lanes_reference(lanes: dict, restart, basis, sample_offset,
                            plan: LanePlan) -> dict:
    """Plain torch twin of `restart_lanes`: `pixel_sample`, the camera's
    `rays_from_basis` (its jitter drawn by `core/rng.py`) for every lane,
    and the masked reset."""
    pixel, sample = pixel_sample(lanes["item"], lanes["schunk"], sample_offset, plan)
    no, nd = rays_from_basis(basis, plan.width, plan.height, pixel, sample, plan.seed)
    r = restart[:, None]
    return dict(
        lanes, o=torch.where(r, no, lanes["o"]), d=torch.where(r, nd, lanes["d"]),
        tp=torch.where(r, 1.0, lanes["tp"]),
        bounce=torch.where(restart, 0, lanes["bounce"]),
        prev_pdf=torch.where(restart, 0.0, lanes["prev_pdf"]),
        alive=lanes["alive"] | restart, pixel=pixel, sample=sample)


# --------------------------------------------------------------------------
# the queue
# --------------------------------------------------------------------------


def queue_pop(bank, more, item, acc, pend_idx, pend_rgb, next_item, total: int,
              groups: int):
    """The window's queue after an advance, IN PLACE on item, acc, pend_idx
    and pend_rgb (the window's own tensors: the copies torch.where made
    were the kernels' traffic). bank, more (N,) bool: the lanes that
    finished their work item, and those that go on to its next path; item
    (N,) int64; acc, pend_rgb (N, ka) f32 the accumulators and the pending
    bank's rows; pend_idx (N,) int64 its framebuffer rows; next_item a 0-d
    int64 tensor, the queue's head. A banked lane parks its accumulator
    (row item % groups) and zeroes it, and takes item next_item + (its rank
    among banked lanes, in lane order) where that is below `total`.
    Returns (restart (N,) bool = more | regenerated, the queue's new head:
    a new 0-d tensor, min(next_item + banked lanes, total))."""
    n = item.shape[0]
    dev = item.device
    ka = acc.shape[1] if acc.dim() == 2 else 0
    _build.check_tensors("queue_pop", [
        ("bank", bank, _BOOL, (n,)), ("more", more, _BOOL, (n,)),
        ("item", item, _I64, (n,)), ("acc", acc, _F32, (n, ka)),
        ("pend_idx", pend_idx, _I64, (n,)), ("pend_rgb", pend_rgb, _F32, (n, ka)),
        ("next_item", next_item, _I64, ())], dev)
    if _build.device_of("queue_pop", item) == "cpu":
        return queue_pop_reference(bank, more, item, acc, pend_idx, pend_rgb, next_item,
                                   total, groups)
    for name, t in (("item", item), ("acc", acc), ("pend_idx", pend_idx),
                    ("pend_rgb", pend_rgb)):
        if not t.is_contiguous():
            raise ValueError(f"queue_pop: {name} is updated in place and must be "
                             "contiguous")
    restart = torch.empty(n, dtype=_BOOL, device=dev)
    next_out = torch.empty((), dtype=_I64, device=dev)
    if n:
        _build.launch("queue_pop", (bank.contiguous(), more.contiguous(), next_item,
                                    item, acc, pend_idx, pend_rgb),
                      (restart, next_out), (n, ka, int(total), int(groups)), dev)
        queue_pop.launches += 1
    else:
        next_out.copy_(next_item)
    return restart, next_out


queue_pop.launches = 0


def queue_pop_reference(bank, more, item, acc, pend_idx, pend_rgb, next_item,
                        total: int, groups: int):
    """Plain torch twin of `queue_pop` (in place too): the window's queue as
    torch.where, a cumsum for the ranks, and a clamp."""
    pend_idx.copy_(torch.where(bank, item % groups, pend_idx))
    pend_rgb.copy_(torch.where(bank[:, None], acc, pend_rgb))
    acc.copy_(torch.where(bank[:, None], 0.0, acc))
    # a banked lane's rank among banked lanes
    new_item = next_item + torch.cumsum(bank.to(torch.int64), 0) - 1
    regen = bank & (new_item < total)
    item.copy_(torch.where(regen, new_item, item))
    return more | regen, torch.clamp(next_item + bank.sum(), max=total)


# --------------------------------------------------------------------------
# the pool sort
# --------------------------------------------------------------------------


def tileset_bits(o, d, alive, coarse_box, t_min: float):
    """Each lane's tile-set signature, int64: bit c set where the live
    lane's ray enters coarse box c (the quantity the subgroup cull unions;
    `_cull_hit_mask`'s slab test). Dead lanes and lanes that enter no box
    share 0 (neither costs kernel work)."""
    chit, _ = _cull_hit_mask(o, d, alive.to(torch.float32), coarse_box, t_min)
    bits = 1 << torch.arange(coarse_box.shape[0], dtype=torch.int64, device=o.device)
    return (chit.to(torch.int64) * bits[:, None]).sum(dim=0)


def tileset_key(o, d, alive, coarse_box, t_min: float):
    """The pool sort's key: `tileset_bits` - 2^31 as int32 (N,), an
    order-preserving map of the 32-bit signature, which torch's stable
    argsort orders as it orders the int64 signature. o, d (N, 3) f32,
    alive (N,) bool, coarse_box (C, 8) f32 with C <= 32."""
    n, nc = o.shape[0], coarse_box.shape[0]
    if nc > MAX_BOXES:
        raise ValueError(f"tileset_key: {nc} coarse boxes, at most {MAX_BOXES}")
    _build.check_tensors("tileset_key", [
        ("o", o, _F32, (n, 3)), ("d", d, _F32, (n, 3)), ("alive", alive, _BOOL, (n,)),
        ("coarse_box", coarse_box, _F32, (nc, 8))], o.device)
    if _build.device_of("tileset_key", o) == "cpu":
        return tileset_key_reference(o, d, alive, coarse_box, t_min)
    key = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        _build.launch("tileset_key", (o.contiguous(), d.contiguous(), alive.contiguous(),
                                      coarse_box.contiguous()),
                      (key,), (n, nc, float(t_min)), o.device, align=4)
        tileset_key.launches += 1
    return key


tileset_key.launches = 0


def tileset_key_reference(o, d, alive, coarse_box, t_min: float):
    """Plain torch twin of `tileset_key`."""
    return (tileset_bits(o, d, alive, coarse_box, t_min) - (1 << 31)).to(torch.int32)


def permute_lanes(perm, lanes: dict, pend=None):
    """Row perm[i] of every lane field (`LANE_FIELDS`) into row i, and of
    the pending bank (pend_idx (N,) int64, pend_rgb (N, ka) f32) where one
    is given. Returns (a dict of new contiguous fields, the new pending bank
    or None)."""
    n = perm.shape[0]
    dev = perm.device
    if set(lanes) != set(LANE_FIELDS):
        raise ValueError(f"permute_lanes: lane fields {sorted(lanes)}, not "
                         f"{sorted(LANE_FIELDS)}")
    ka = lanes["acc"].shape[1] if lanes["acc"].dim() == 2 else 0
    checks = [("perm", perm, _I64, (n,))] + _lane_checks(lanes, LANE_FIELDS, n, ka)
    if pend is not None:
        checks += [("pend_idx", pend[0], _I64, (n,)), ("pend_rgb", pend[1], _F32, (n, ka))]
    _build.check_tensors("permute_lanes", checks, dev)
    if _build.device_of("permute_lanes", perm) == "cpu":
        return permute_lanes_reference(perm, lanes, pend)
    out = {k: torch.empty_like(lanes[k], memory_format=torch.contiguous_format)
           for k in LANE_FIELDS}
    pend_out = None if pend is None else tuple(torch.empty_like(
        p, memory_format=torch.contiguous_format) for p in pend)
    order = ("o", "d", "acc", "light", "tp", "prev_pdf", "item", "schunk", "bounce",
             "alive", "pixel", "sample")
    if n:
        _build.launch("permute_lanes",
                      (perm.contiguous(), *(lanes[k].contiguous() for k in order),
                       *((None, None) if pend is None else (p.contiguous() for p in pend))),
                      (*(out[k] for k in order),
                       *((None, None) if pend is None else pend_out)),
                      (n, ka), dev, align=8)
        permute_lanes.launches += 1
    return out, pend_out


permute_lanes.launches = 0


def permute_lanes_reference(perm, lanes: dict, pend=None):
    """Plain torch twin of `permute_lanes`: one index a field."""
    out = {k: lanes[k][perm] for k in LANE_FIELDS}
    return out, None if pend is None else (pend[0][perm], pend[1][perm])
