"""Closest hit with ray-triangle intersection as dot products over tiles.

Port of `metalpathtracer_tpu/render/pallas/intersect_mm.py`. Every Moller-
Trumbore determinant is linear in the 12 ray features

    X = [d, o x d, o, o.d, |o|^2, 1]

with per-triangle weights (n = e1 x e2):

    a  = -d.n
    su = (o x d).e2 - d.(e2 x v0)
    sv = -(o x d).e1 - d.(v0 x e1)
    st = o.n - v0.n

Only 19 of the 48 weights are non-zero, so the slab keeps one compact row of
16 floats per triangle, [n, v0.n, e1, v0 x e1, e2, e2 x v0] (`tri_weight_slab`),
and the CUDA kernel `csrc/mm_closest_hit.cu` runs each determinant as the FMA
chain of its non-zero terms over 9 ray features (d, o x d, o). The plain
twin expands the tiles it gathers to the dense (4, 12) form
(`expand_slab`) and takes the four 12-term dot products as one batched
matmul. Before the kernel, the CUDA kernel `csrc/cull_tiles.cu` slab-tests
every ray against every tile box and reduces the result per 128-lane
subgroup, from which each subgroup's entry-ordered list of passing tiles is
sorted. Around them: the exact sphere pass and the plane-t refine of the
winner.

TPU workarounds of the reference that are not ported, and why:
- the bf16 hi/lo "pack" weight slab and the precision modes: they work
  around Mosaic's reduced-precision f32 matmul; the kernel computes in f32;
- the dense (features, 4 * tile_p) weight layout and its 16-feature
  padding: an MXU operand and a Mosaic DMA alignment rule; the slab here is
  the 16 non-redundant floats of each triangle;
- the resident/streaming split (VMEM residency cap, SMEM list guard): VMEM
  and SMEM capacity; one kernel reads its lists from global memory;
- `BLOCK_R` padding: N is padded to a multiple of 128 (one subgroup);
- the cull kernel's `CULL_KERNEL_MIN_TILES` routing, its padding of the
  tiles to a multiple of 128 and its fold of the lane bound mod 128: TPU
  dispatch cost and lane-layout rules; the CUDA cull serves every scene
  and writes the lane bound directly;
- `PACKED_ARGMIN`, regroup and `LAST_PLAN`: measured neutral or a loss on
  the TPU, and `LAST_PLAN` goes stale;
- the `MPT_*` environment knobs: TPU sweep settings.
"""

from __future__ import annotations

import numpy as np
import torch

from metalpathtracer_torch.core import vecmath as vm
from metalpathtracer_torch.render.intersect import ray_sphere
from metalpathtracer_torch.render.kernels import _build
from metalpathtracer_torch.scene import PRIM_SPHERE, PRIM_TRIANGLE

T_MIN = 1e-4
TRI_PARALLEL_EPS = 1e-5
NUM_FEATURES = 12
SLAB_FLOATS = 16  # one compact slab row: [n, v0.n, e1, v0 x e1, e2, e2 x v0]
LANES = 128  # rays per subgroup: one tile list, one CUDA block
TILE_P_SMALL = 128  # triangles per tile up to TILE_SWITCH_TRIS ...
TILE_P_LARGE = 256  # ... and beyond
TILE_SWITCH_TRIS = 24 * 1024
# subgroups per batched matmul in the plain twin: bounds its temporaries
# to ~0.3 GB each at tile_p 128
TWIN_GROUP_CHUNK = 1024
# (ray, tile) pairs per step of the plain cull: ~64 MB per f32 temporary
CULL_TWIN_PAIRS = 1 << 24
RECIP_CLIP = 1e30  # the cull's reciprocal clip: finite, so no inf * 0
_INF = float("inf")


# --------------------------------------------------------------------------
# host tables
# --------------------------------------------------------------------------


def _kd_order(cent: np.ndarray, tile_p: int) -> np.ndarray:
    """Triangle order in which every run of `tile_p` is one cell of a
    recursive longest-axis median split (split points at multiples of
    tile_p), so each tile's AABB is tight."""
    order = np.empty(len(cent), np.int64)
    out_pos = 0

    def split(idx):
        nonlocal out_pos
        n_i = len(idx)
        if n_i <= tile_p:
            order[out_pos:out_pos + n_i] = idx
            out_pos += n_i
            return
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        k = max(tile_p, (n_i // 2) // tile_p * tile_p)
        part = np.argpartition(c[:, axis], k)
        split(idx[part[:k]])
        split(idx[part[k:]])

    split(np.arange(len(cent)))
    return order


def tri_weight_slab(v0, v1, v2, tile_p: int) -> np.ndarray:
    """The compact f32 weight slab (n_tiles, tile_p, 16) of triangles in
    column order: row [n, v0.n, e1, v0 x e1, e2, e2 x v0] per column, n = e1 x
    e2 and v0.n the f32 sum of v0 * n. `expand_slab` turns it into the dense
    determinant weights. Columns past the last triangle are zero (never
    accepted: |a| = 0)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    pad_t = (-t) % tile_p if t else tile_p
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    w = np.zeros((t + pad_t, SLAB_FLOATS), np.float32)
    w[:t] = np.concatenate([n, np.sum(v0 * n, 1, keepdims=True), e1,
                            np.cross(v0, e1), e2, np.cross(e2, v0)], axis=1)
    return w.reshape(-1, tile_p, SLAB_FLOATS)


def expand_slab(w: torch.Tensor) -> torch.Tensor:
    """Dense determinant weights (..., 4, 12) of compact slab rows (..., 16):
    for each column, rows [wa, wu, wv, wt] over the features X, so that
    X . w[..., k] is determinant k (k = a, su, sv, st):
      wa = [-n, 0, 0, 0, 0, 0, 0, 0, 0, 0]
      wu = [-(e2 x v0), e2, 0, 0, 0, 0, 0, 0, 0]
      wv = [-(v0 x e1), -e1, 0, 0, 0, 0, 0, 0, 0]
      wt = [0, 0, 0, 0, 0, 0, n, 0, 0, -v0.n]
    (each entry a 3-vector but the last three). Negation is exact, so these
    are the bits of the formula; a zero row expands to zeros, some of them
    -0."""
    n, v0n = w[..., 0:3], w[..., 3:4]
    e1, v0xe1 = w[..., 4:7], w[..., 7:10]
    e2, e2xv0 = w[..., 10:13], w[..., 13:16]
    z1 = torch.zeros_like(v0n)
    z3 = torch.zeros_like(n)
    wa = torch.cat([-n, z3, z3, z1, z1, z1], dim=-1)
    wu = torch.cat([-e2xv0, e2, z3, z1, z1, z1], dim=-1)
    wv = torch.cat([-v0xe1, -e1, z3, z1, z1, z1], dim=-1)
    wt = torch.cat([z3, z3, n, z1, z1, -v0n], dim=-1)
    return torch.stack([wa, wu, wv, wt], dim=-2)


def build_weights(prim_type, p0, p1, p2) -> dict:
    """Per-scene intersection tables (numpy, once per scene).

    Returns dict with:
      w: compact f32 weight slab (n_tiles, tile_p, 16) — see `tri_weight_slab`
      tri_ids: int32 (T_padded,) original primitive index per column, -1 pad
      tri_refine: f32 (T_padded, 8) rows [n, n.v0 (f64 sum), prim, mat, 0, 0]
        in column order (mat is filled in by `upload_scene`)
      tile_box: f32 (n_tiles, 8) per-tile AABB [lo3, 0, hi3, 0]; padding
        tiles are empty (lo = +inf, hi = -inf)
      n_tris: real triangle count
      sph_center/sph_radius/sph_ids: the sphere SoA padded to a multiple of
        8 (padding radius 0, id -1).
    """
    prim_type = np.asarray(prim_type)
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)

    tri_sel = np.nonzero(prim_type == PRIM_TRIANGLE)[0]
    sph_sel = np.nonzero(prim_type == PRIM_SPHERE)[0]
    tile_p = TILE_P_SMALL if len(tri_sel) <= TILE_SWITCH_TRIS else TILE_P_LARGE

    if len(tri_sel):
        cent = (p0[tri_sel] + p1[tri_sel] + p2[tri_sel]) / 3.0
        tri_sel = tri_sel[_kd_order(cent, tile_p)]

    v0, v1, v2 = p0[tri_sel], p1[tri_sel], p2[tri_sel]
    t = len(tri_sel)
    w = tri_weight_slab(v0, v1, v2, tile_p)
    n_cols = w.shape[0] * tile_p
    pad_t = n_cols - t
    tri_ids = np.concatenate(
        [tri_sel.astype(np.int32), np.full(pad_t, -1, np.int32)]
    )

    n = np.cross(v1 - v0, v2 - v0)
    refine = np.zeros((n_cols, 8), np.float32)
    refine[:t, 0:3] = n
    refine[:t, 3] = np.sum(
        v0.astype(np.float64) * n.astype(np.float64), axis=1
    ).astype(np.float32)
    refine[:, 4] = tri_ids.astype(np.float32)

    n_tiles = n_cols // tile_p
    tile_box = np.zeros((max(n_tiles, 1), 8), np.float32)
    tile_box[:, 0:3] = np.inf
    tile_box[:, 4:7] = -np.inf
    for i in range(n_tiles):
        a, b = i * tile_p, min((i + 1) * tile_p, t)
        if a >= t:
            continue
        vs = np.concatenate([v0[a:b], v1[a:b], v2[a:b]])
        tile_box[i, 0:3] = vs.min(axis=0)
        tile_box[i, 4:7] = vs.max(axis=0)

    s = len(sph_sel)
    pad_s = (-s) % 8 if s else 8
    sph_center = np.concatenate([p0[sph_sel], np.zeros((pad_s, 3), np.float32)])
    sph_radius = np.concatenate([p1[sph_sel, 0], np.zeros(pad_s, np.float32)])
    sph_ids = np.concatenate(
        [sph_sel.astype(np.int32), np.full(pad_s, -1, np.int32)]
    )

    return dict(
        w=w,
        tri_ids=tri_ids,
        tri_refine=refine,
        tile_box=tile_box,
        n_tris=t,
        sph_center=sph_center.astype(np.float32),
        sph_radius=sph_radius.astype(np.float32),
        sph_ids=sph_ids,
    )


# --------------------------------------------------------------------------
# the kernel and its plain twin
# --------------------------------------------------------------------------


def mm_closest_hit(lists, counts, smin, x, lane_bound, w, t_min: float,
                   return_walked: bool = False):
    """Closest accepted hit per ray over its subgroup's tile list.

    lists (G, nt) int32: each 128-lane subgroup's passing tiles, nearest
      entry first; counts (G,) int32 its passing-tile count; smin (G, nt)
      f32 the subgroup-min entry at each list position (+inf past counts);
    x (G*128, 12) f32 ray features; lane_bound (G*128,) f32 each lane's
      relevance bound; w the compact (nt, tile_p, 16) f32 weight slab.
    Returns (t (G*128,) f32, col (G*128,) int32 kernel column, -1 on miss),
    and with `return_walked` also walked (G,) int32: the list positions
    each subgroup tested before its early exit, which is what the kernel's
    work (walked x 128 x tile_p ray-triangle pairs) is counted from.

    CUDA tensors launch `csrc/mm_closest_hit.cu` (and count the launch in
    `mm_closest_hit.launches`); CPU tensors take the plain twin
    `mm_closest_hit_reference`. Any other device raises.
    """
    g, nt = lists.shape
    n = g * LANES
    tile_p = w.shape[1]
    _build.check_tensors("mm_closest_hit", [
        ("lists", lists, torch.int32, (g, nt)),
        ("counts", counts, torch.int32, (g,)),
        ("smin", smin, torch.float32, (g, nt)),
        ("x", x, torch.float32, (n, NUM_FEATURES)),
        ("lane_bound", lane_bound, torch.float32, (n,)),
        ("w", w, torch.float32, (nt, tile_p, SLAB_FLOATS)),
    ], x.device)
    if x.device.type == "cpu":
        return mm_closest_hit_reference(lists, counts, smin, x, lane_bound,
                                        w, t_min, return_walked)
    if x.device.type != "cuda":
        raise ValueError(f"mm_closest_hit: no kernel for device {x.device}")
    t = torch.empty(n, dtype=torch.float32, device=x.device)
    col = torch.empty(n, dtype=torch.int32, device=x.device)
    walked = (torch.empty(g, dtype=torch.int32, device=x.device)
              if return_walked else None)
    _build.launch("mm_closest_hit", (lists, counts, smin, x, lane_bound, w),
            (t, col, walked), (g, nt, tile_p, float(t_min)), x.device)
    mm_closest_hit.launches += 1
    return (t, col, walked) if return_walked else (t, col)


mm_closest_hit.launches = 0


def mm_closest_hit_reference(lists, counts, smin, x, lane_bound, w,
                             t_min: float, return_walked: bool = False):
    """Plain torch twin of the kernel: the same walk over list positions,
    vectorised across subgroups (TWIN_GROUP_CHUNK at a time), with the same
    early-exit test, acceptance, division and tie rules, and the same
    walked counts. The gathered tiles are expanded to the dense weights and
    the determinants come from a batched f32 matmul, whose summation order
    may differ from the kernel's FMA chains in the last bits."""
    g, nt = lists.shape
    tile_p = w.shape[1]
    dev = x.device
    xg = x.view(g, LANES, NUM_FEATURES)
    lb = lane_bound.view(g, LANES)
    best_t = torch.full((g, LANES), _INF, dtype=torch.float32, device=dev)
    best_c = torch.full((g, LANES), -1, dtype=torch.int32, device=dev)
    walked = torch.zeros((g,), dtype=torch.int32, device=dev)
    thr = lb.amax(dim=1)
    live = torch.arange(g, device=dev)
    cnt = counts.to(torch.int64)
    for j in range(nt):
        live = live[(j < cnt[live]) & (smin[live, j] <= thr[live])]
        if live.numel() == 0:
            break
        walked[live] += 1
        for part in live.split(TWIN_GROUP_CHUNK):
            tiles = lists[part, j].to(torch.int64)
            wd = expand_slab(w[tiles]).view(-1, tile_p * 4, NUM_FEATURES)
            det = torch.bmm(xg[part], wd.transpose(1, 2))
            det = det.view(-1, LANES, tile_p, 4)
            sa, su, sv, st = det.unbind(dim=-1)
            s = torch.where(sa < 0.0, -1.0, 1.0)
            sas, sus, svs, sts = sa * s, su * s, sv * s, st * s
            ok = ((sas > TRI_PARALLEL_EPS) & (sus >= 0.0) & (svs >= 0.0)
                  & (sus + svs <= sas) & (sts > t_min * sas))
            t_all = torch.where(ok, sts / sas, _INF)
            t_tile, c_tile = torch.min(t_all, dim=2)  # lowest column on ties
            bt = best_t[part]
            better = t_tile < bt
            best_t[part] = torch.where(better, t_tile, bt)
            col = (tiles[:, None] * tile_p + c_tile).to(torch.int32)
            best_c[part] = torch.where(better, col, best_c[part])
            thr[part] = torch.minimum(best_t[part], lb[part]).amax(dim=1)
    out = best_t.view(-1), best_c.view(-1)
    return (*out, walked) if return_walked else out


# --------------------------------------------------------------------------
# closest hit around the kernel
# --------------------------------------------------------------------------


def ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """X = [d, o x d, o, o.d, |o|^2, 1] — (N, 12) float32."""
    m = vm.cross(o, d)
    od = (o * d).sum(dim=-1, keepdim=True)
    oo = (o * o).sum(dim=-1, keepdim=True)
    return torch.cat([d, m, o, od, oo, torch.ones_like(od)], dim=-1)


def _cull_hit_mask(o, d, active, tile_box, t_min):
    """Slab test of every ray against every box, in the reference's
    unclipped form (its XLA branch; the wavefront's tileset sort key
    runs it over the coarse boxes). Returns (hit (nt, N)
    bool: can this active ray enter this tile's box?, enter (nt, N) f32:
    its entry distance, >= t_min). Any hit inside a box lies at t >= enter,
    which is what lets entry-ordered lists exit early."""
    n = o.shape[0]
    nt = tile_box.shape[0]
    inv = 1.0 / d
    enter = torch.full((nt, n), t_min, dtype=torch.float32, device=o.device)
    exit_ = torch.full((nt, n), _INF, dtype=torch.float32, device=o.device)
    for a in range(3):
        lo = tile_box[:, a][:, None]
        hi = tile_box[:, 4 + a][:, None]
        oa = o[:, a][None, :]
        ia = inv[:, a][None, :]
        t0 = (lo - oa) * ia
        t1 = (hi - oa) * ia
        # 0 * inf = NaN when a direction component is 0 and the origin sits
        # on the box plane: that axis must not constrain (conservative)
        a_lo = torch.minimum(t0, t1)
        a_hi = torch.maximum(t0, t1)
        enter = torch.maximum(enter, torch.where(torch.isnan(a_lo), -_INF, a_lo))
        exit_ = torch.minimum(exit_, torch.where(torch.isnan(a_hi), _INF, a_hi))
    hit = (exit_ > enter) & (active.reshape(1, n) > 0.5)
    return hit, enter


# --------------------------------------------------------------------------
# the cull kernel and its plain twin
# --------------------------------------------------------------------------


def cull_tiles(x, active, tile_box, t_min: float, occ=None):
    """Per-subgroup cull of rays against tile AABBs (the reference's
    `_cull_pass`). x (N, 12) f32 ray features, N a multiple of 128;
    active (N,) f32 (> 0.5 = live); tile_box (nt, 8) f32; occ (N,) f32
    optional per-lane occlusion bound. Returns
      sgm (N/128, nt) bool: does any lane of the subgroup enter the tile?
      gent (N/128, nt) f32: the subgroup-min entry, +inf where none does;
      lane_bound (N,) f32: per lane, the max entry over the tiles it
        enters, -inf where it enters none.

    CUDA tensors launch `csrc/cull_tiles.cu` (and count the launch in
    `cull_tiles.launches`); CPU tensors take `cull_pass_reference`. Any
    other device raises.
    """
    n, nt = x.shape[0], tile_box.shape[0]
    f32 = torch.float32
    _build.check_tensors("cull_tiles", [
        ("x", x, f32, (n, NUM_FEATURES)),
        ("active", active, f32, (n,)),
        ("tile_box", tile_box, f32, (nt, 8)),
    ] + ([] if occ is None else [("occ", occ, f32, (n,))]), x.device)
    if n % LANES:
        raise ValueError(f"cull_tiles: {n} rays is not a multiple of {LANES}")
    if x.device.type == "cpu":
        return cull_pass_reference(x, active, tile_box, t_min, occ)
    if x.device.type != "cuda":
        raise ValueError(f"cull_tiles: no kernel for device {x.device}")
    g = n // LANES
    sgm = torch.empty((g, nt), dtype=torch.bool, device=x.device)
    gent = torch.empty((g, nt), dtype=f32, device=x.device)
    lane_bound = torch.empty((n,), dtype=f32, device=x.device)
    _build.launch("cull_tiles", (x, active, occ, tile_box), (sgm, gent, lane_bound),
            (g, nt, float(t_min)), x.device)
    cull_tiles.launches += 1
    return sgm, gent, lane_bound


cull_tiles.launches = 0


def cull_pass_reference(x, active, tile_box, t_min: float, occ=None):
    """Plain torch twin of the cull kernel, in the reference kernel's
    arithmetic: reciprocals clipped to +-1e30 (no inf * 0 NaN), inactive
    lanes' bound folded to -inf, NaN-propagating min/max. One repair: a
    lane enters a box where exit >= entry, not exit > entry, so a flat box
    (the tile of an axis-aligned planar mesh) is entered where a ray
    crosses its plane. Bit-equal to the kernel, and to the reference's
    `_cull_pass` on generic rays and boxes; where a direction component is
    0 it is tighter than `_cull_hit_mask` (a ray lying in a flat box's plane
    enters it there, not here). Works through the rays CULL_TWIN_PAIRS
    (ray, tile) pairs at a time."""
    n, nt = x.shape[0], tile_box.shape[0]
    g = n // LANES
    dev = x.device
    inv = torch.clamp(1.0 / x[:, 0:3], -RECIP_CLIP, RECIP_CLIP)
    o = x[:, 6:9]
    bound = active.reshape(n) > 0.5
    occv = torch.full((n,), _INF, device=dev) if occ is None else occ
    bound = torch.where(bound, occv, -_INF)
    t_min_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
    sgm = torch.empty((g, nt), dtype=torch.bool, device=dev)
    gent = torch.empty((g, nt), dtype=torch.float32, device=dev)
    lane_bound = torch.empty((n,), dtype=torch.float32, device=dev)
    step = max(1, CULL_TWIN_PAIRS // (LANES * max(nt, 1)))
    for g0 in range(0, g, step):
        g1 = min(g, g0 + step)
        rays = slice(g0 * LANES, g1 * LANES)
        en = ex = None
        for a in range(3):
            oa = o[rays, a][None, :]
            ia = inv[rays, a][None, :]
            t0 = (tile_box[:, a][:, None] - oa) * ia
            t1 = (tile_box[:, 4 + a][:, None] - oa) * ia
            a_lo = torch.minimum(t0, t1)
            a_hi = torch.maximum(t0, t1)
            if a == 0:
                en, ex = torch.maximum(a_lo, t_min_t), a_hi
            else:
                en, ex = torch.maximum(en, a_lo), torch.minimum(ex, a_hi)
        hit = (ex >= en) & (en <= bound[rays][None, :])  # (nt, rays)
        k = g1 - g0
        sgm[g0:g1] = hit.reshape(nt, k, LANES).any(dim=2).T
        gent[g0:g1] = torch.where(hit, en, _INF).reshape(nt, k, LANES).amin(dim=2).T
        lane_bound[rays] = torch.where(hit, en, -_INF).amax(dim=0)
    return sgm, gent, lane_bound


def _cull_tile_lists(x, active, tile_box, t_min, occ=None):
    """Entry-ordered passing-tile lists per 128-lane subgroup:
      lists (G, nt) int32: passing tiles first, nearest entry first
      counts (G,) int32
      smin (G, nt) f32: the subgroup-min entry at each list position
        (ascending; +inf at non-passing positions)
      lane_bound (N,) f32: per lane, max entry over its passing tiles.
    One stable sort gives both the sorted entries and the permutation;
    equal entries keep ascending tile order."""
    sgm, gent, lane_bound = cull_tiles(x, active, tile_box, t_min, occ)
    counts = sgm.sum(dim=1).to(torch.int32)
    smin, lists = torch.sort(gent.contiguous(), dim=1, stable=True)
    return lists.to(torch.int32), counts, smin, lane_bound


def kernel_inputs(scene, o, d, occ, active=None, t_min=T_MIN):
    """The kernel's inputs for rays (o, d), padded with inactive lanes to
    a multiple of 128: (lists, counts, smin, x, lane_bound). `occ` (N,) is
    each lane's occlusion bound (+inf for none); `active` (N,) bool or
    None for all lanes."""
    n = o.shape[0]
    pad = (-n) % LANES
    x = ray_features(o, d)
    if active is None:
        act = torch.ones((n,), dtype=torch.float32, device=o.device)
    else:
        act = active.to(torch.float32)
    if pad:
        x = torch.cat([x, x.new_zeros((pad, NUM_FEATURES))])
        act = torch.cat([act, act.new_zeros((pad,))])
        occ = torch.cat([occ, occ.new_full((pad,), _INF)])
    lists, counts, smin, lane_bound = _cull_tile_lists(
        x, act, scene.mm_tile_box, t_min, occ
    )
    return lists, counts, smin, x, torch.minimum(lane_bound, occ)


def _sphere_hit_exact(scene, o, d, t_min):
    """Exact dense sphere pass over the (N, S) pairs. Returns (t, prim idx
    (-1 on miss), center, material-bank id) of each lane's nearest sphere;
    equal t picks the lowest slot."""
    t = ray_sphere(o[:, None, :], d[:, None, :], scene.sph_center[None, :, :],
                   scene.sph_radius[None, :], t_min)
    t_best, slot = torch.min(t, dim=1)
    idx = torch.where(torch.isinf(t_best), -1, scene.sph_ids[slot])
    return t_best, idx, scene.sph_center[slot], scene.sph_mat_id[slot]


def closest_hit_mm_full(scene, o, d, t_min=T_MIN, active=None, occ_t=None):
    """Closest hit: the triangle kernel and the exact sphere pass, merged.

    Returns (t, idx, normal, front_face, mat_id, tile_passes). idx is -1 on
    miss (normal and mat_id are garbage there; callers mask). `active` (N,)
    bool drops finished lanes from every tile list. `occ_t` (N,) optional:
    a per-lane bound past which hits do not matter to the caller (a shadow
    ray's light distance); tiles entered beyond it are pruned, so the hit
    is exact for t <= occ_t and unspecified-but-farther beyond.
    tile_passes counts the (128-lane subgroup, tile) pairs of the lists in
    units of 2^20 ray-triangle tests.
    """
    n = o.shape[0]
    t_s, i_s, c, m_s = _sphere_hit_exact(scene, o, d, t_min)
    sph_n = vm.normalize(o + t_s[:, None] * d - c)

    if scene.num_tris > 0:
        # the sphere pass already bounds the winner
        occ = t_s if occ_t is None else torch.minimum(t_s, occ_t)
        lists, counts, smin, x, lane_bound = kernel_inputs(
            scene, o, d, occ, active, t_min
        )
        t_t, col = mm_closest_hit(lists, counts, smin, x, lane_bound,
                                  scene.mm_w, t_min)
        tile_p = scene.mm_w.shape[1]
        tile_passes = counts.sum().to(torch.float32) * (
            LANES * tile_p / float(1 << 20)
        )
        t_t, col = t_t[:n], col[:n]

        # one (N, 8) row gather: [n, n.v0, prim id, material id]; the
        # winner's t is re-derived exactly from its plane
        row = scene.mm_refine[col.clamp(min=0).to(torch.int64)]
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
        tri_hit = (col >= 0) & torch.isfinite(t_t)
        t_t = torch.where(
            tri_hit, torch.where(torch.isfinite(t_exact), t_exact, t_t), _INF
        )
        i_t = torch.where(tri_hit, i_t, -1)
        tri_n = vm.normalize(nvec)
    else:
        t_t = torch.full((n,), _INF, dtype=torch.float32, device=o.device)
        i_t = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        m_t = torch.zeros((n,), dtype=torch.int32, device=o.device)
        tri_n = torch.zeros_like(o)
        tile_passes = torch.zeros((), dtype=torch.float32, device=o.device)

    tri_wins = t_t < t_s
    t = torch.where(tri_wins, t_t, t_s)
    idx = torch.where(tri_wins, i_t, i_s)
    mat_id = torch.where(tri_wins, m_t, m_s)
    normal = vm.where3(tri_wins, tri_n, sph_n)
    front_face = vm.dot(normal, d) < 0.0
    normal = vm.where3(front_face, normal, -normal)
    return t, idx, normal, front_face, mat_id, tile_passes
