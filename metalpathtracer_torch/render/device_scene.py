"""TorchScene: the packed scene and its intersection tables as tensors.

Port of `metalpathtracer_tpu/render/device_scene.py`, holding only what the
render path reads: the primitive SoA and `geom_table` (brute oracle), the
material bank, the linearized BVH of the study intersector
(`render/traverse.py`; built only on request, since no other path reads
it), the closest-hit tables, the wavefront's coarse boxes, the sphere SoA
and the light table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from metalpathtracer_torch.accel.bvh import build_bvh
from metalpathtracer_torch.render.bsdf import SKY_HORIZON, SKY_ZENITH
from metalpathtracer_torch.render.kernels.intersect_mm import (
    TILE_P_LARGE,
    TILE_P_SMALL,
    build_weights,
    tri_weight_slab,
)
from metalpathtracer_torch.scene import PRIM_TRIANGLE, HostScene, PackedScene


@dataclasses.dataclass(frozen=True)
class TorchScene:
    # primitives (SoA, padded)
    prim_type: torch.Tensor  # int32 (P,)
    p0: torch.Tensor  # float32 (P, 3)
    p1: torch.Tensor  # float32 (P, 3)
    p2: torch.Tensor  # float32 (P, 3)
    geom_table: torch.Tensor  # float32 (P, 16) [p0, p1, p2, prim_type, 0...]
    # materials: distinct rows [albedo(3), type, emission(3), power, fuzz, 0...]
    mat_bank: torch.Tensor  # float32 (M, 16), M padded to 8
    prim_mat_id: torch.Tensor  # int32 (P,)
    # linearized BVH (accel/bvh.py): node i owns row i, the root is node 0;
    # no rows (and max_depth 0) on a scene uploaded without its BVH
    node_lo: torch.Tensor  # float32 (M, 3)
    node_hi: torch.Tensor  # float32 (M, 3)
    node_a: torch.Tensor  # int32 (M,) leaf: first slot; internal: left child
    node_b: torch.Tensor  # int32 (M,) leaf: +count; internal: -right child
    prim_indices: torch.Tensor  # int32 (P,) leaf slots -> primitives
    # closest-hit tables (render/kernels/intersect_mm.build_weights)
    mm_w: torch.Tensor  # float32 (n_tiles, tile_p, 16) compact weight slab
    mm_tri_ids: torch.Tensor  # int32 (n_tiles*tile_p,) column -> primitive
    mm_refine: torch.Tensor  # float32 (n_tiles*tile_p, 8) [n, n.v0, prim, mat]
    mm_tile_box: torch.Tensor  # float32 (n_tiles, 8) [lo3, 0, hi3, 0]
    # float32 (<= N_COARSE, 8): boxes over contiguous tile ranges, the
    # wavefront's tileset sort key
    mm_coarse_box: torch.Tensor
    sph_center: torch.Tensor  # float32 (S, 3)
    sph_radius: torch.Tensor  # float32 (S,)
    sph_ids: torch.Tensor  # int32 (S,)
    sph_mat_id: torch.Tensor  # int32 (S,)
    # light table for next-event estimation: every emissive primitive,
    # picked in proportion to its flux
    light_kind: torch.Tensor  # int32 (L,) 0 = sphere, 1 = triangle
    light_prim: torch.Tensor  # int32 (L,) primitive index
    light_q0: torch.Tensor  # float32 (L, 3) sphere center / tri v0
    light_e1: torch.Tensor  # float32 (L, 3) tri edge1; sphere [r, 0, 0]
    light_e2: torch.Tensor  # float32 (L, 3) tri edge2
    light_normal: torch.Tensor  # float32 (L, 3) unit normal (0 for spheres)
    light_emission: torch.Tensor  # float32 (L, 3) emission_color * power
    light_area: torch.Tensor  # float32 (L,)
    light_pick_p: torch.Tensor  # float32 (L,)
    light_cdf: torch.Tensor  # float32 (L,) inclusive CDF of pick_p
    prim_light_id: torch.Tensor  # int32 (P,) light row per prim, -1 if none
    # constants of a bounce step, uploaded once with the scene so that no
    # step uploads a host value (a CUDA graph could not capture it)
    sky: torch.Tensor  # float32 (2, 3) [SKY_HORIZON, SKY_ZENITH]
    frame_axes: torch.Tensor  # float32 (2, 3) [y, x]: NEE cone-frame helpers
    max_depth: int  # deepest BVH node (root = 1): bounds the traversal stack
    num_tris: int
    num_lights: int

    @property
    def device(self) -> torch.device:
        return self.p0.device


# coarse boxes of the tileset sort key (the reference's measured default;
# its MPT_COARSE_BOXES sweep knob and >32-box two-word key are not ported)
N_COARSE = 32


def _coarse_boxes(tile_box: np.ndarray, n_coarse: int = N_COARSE) -> np.ndarray:
    """Merge the per-tile AABBs into <= n_coarse boxes over contiguous tile
    id ranges (tiles are kd-ordered, so a range is spatially compact). One
    slab test per coarse box gives a ray its tile-set signature, the
    wavefront pool's sort key. Never more boxes than tiles; slots past the
    last range are empty boxes (lo = +inf, hi = -inf), which the slab test
    enters for every live lane, so they add the same bit to every key."""
    nt = tile_box.shape[0]
    n_coarse = max(1, min(n_coarse, nt))
    out = np.zeros((n_coarse, 8), np.float32)
    out[:, 0:3] = np.inf
    out[:, 4:7] = -np.inf
    group = max(1, -(-nt // n_coarse))
    for c in range(min(n_coarse, -(-nt // group))):
        a, b = c * group, min((c + 1) * group, nt)
        out[c, 0:3] = tile_box[a:b, 0:3].min(axis=0)
        out[c, 4:7] = tile_box[a:b, 4:7].max(axis=0)
    return out


def _build_light_table(packed: PackedScene) -> dict:
    """Light table over every emissive primitive. Pick weights are
    proportional to flux (max emission channel x power x area)."""
    p = packed.num_padded
    real = np.arange(p) < packed.num_real
    brightness = packed.emission_power * packed.emission_color.max(axis=-1)
    sel = np.nonzero(real & (brightness > 0.0))[0].astype(np.int32)
    n = len(sel)

    kind = np.where(packed.prim_type[sel] == PRIM_TRIANGLE, 1, 0).astype(np.int32)
    q0 = packed.p0[sel].astype(np.float32)
    e1 = np.where(
        kind[:, None] == 1,
        packed.p1[sel] - packed.p0[sel],
        np.concatenate([packed.p1[sel, 0:1], np.zeros((n, 2), np.float32)], axis=1),
    ).astype(np.float32)
    e2 = np.where(kind[:, None] == 1, packed.p2[sel] - packed.p0[sel], 0.0).astype(
        np.float32
    )
    cr = np.cross(e1, e2)
    crlen = np.linalg.norm(cr, axis=-1)
    normal = np.where(
        (kind == 1)[:, None] & (crlen > 0)[:, None],
        cr / np.maximum(crlen, 1e-20)[:, None],
        0.0,
    ).astype(np.float32)
    radius = packed.p1[sel, 0]
    area = np.where(kind == 1, 0.5 * crlen, 4.0 * np.pi * radius * radius).astype(
        np.float32
    )
    weight = brightness[sel] * area
    total = weight.sum()
    pick_p = (weight / total if total > 0 else weight).astype(np.float32)

    # at least one row, so the table is never empty (zero-weight padding)
    pad = max(1 - n, 0)

    def padr(a, fill=0):
        if not pad:
            return a
        return np.concatenate([a, np.full((pad, *a.shape[1:]), fill, a.dtype)])

    prim_light_id = np.full(p, -1, np.int32)
    prim_light_id[sel] = np.arange(n, dtype=np.int32)

    cdf = np.cumsum(padr(pick_p))
    if total > 0:
        cdf[-1] = 1.0  # fp drift must not let the search overrun

    return dict(
        kind=padr(kind),
        prim=padr(sel, fill=-1),
        q0=padr(q0),
        e1=padr(e1),
        e2=padr(e2),
        normal=padr(normal),
        emission=padr(
            (packed.emission_color[sel] * packed.emission_power[sel, None]).astype(
                np.float32
            )
        ),
        area=padr(area),
        pick_p=padr(pick_p),
        cdf=cdf.astype(np.float32),
        prim_light_id=prim_light_id,
        n=n,
    )


def _to_device(arrays: dict, max_depth: int, num_tris: int, num_lights: int,
               device) -> TorchScene:
    arrays = dict(arrays, sky=np.stack([SKY_HORIZON, SKY_ZENITH]),
                  frame_axes=np.eye(3, dtype=np.float32)[[1, 0]])
    return TorchScene(
        # np.array copies: tables from a JAX scene are read-only views
        **{k: torch.as_tensor(np.array(v), device=device)
           for k, v in arrays.items()},
        max_depth=int(max_depth),
        num_tris=int(num_tris),
        num_lights=int(num_lights),
    )


def upload_scene(host: PackedScene | HostScene, device,
                 bvh: bool = False) -> TorchScene:
    """Pack the scene (if needed), build its tables, and move them to
    `device`. The BVH is read by `intersector="bvh"` alone, and building it
    costs more than every other table together on a large mesh: `bvh=True`
    builds it, and without it the node tables stay empty (`closest_hit_bvh`
    then raises)."""
    packed = host.pack() if isinstance(host, HostScene) else host
    prim_indices = np.zeros(packed.num_padded, np.int32)
    if bvh:
        tree = build_bvh(packed)
        prim_indices[: tree.prim_indices.shape[0]] = tree.prim_indices
        nodes = dict(node_lo=tree.node_lo, node_hi=tree.node_hi,
                     node_a=tree.node_a, node_b=tree.node_b)
        bvh_depth = tree.max_depth
    else:
        nodes = dict(node_lo=np.zeros((0, 3), np.float32),
                     node_hi=np.zeros((0, 3), np.float32),
                     node_a=np.zeros(0, np.int32), node_b=np.zeros(0, np.int32))
        bvh_depth = 0
    w = build_weights(packed.prim_type, packed.p0, packed.p1, packed.p2)

    p = packed.num_padded
    geom = np.zeros((p, 16), np.float32)
    geom[:, 0:3] = packed.p0
    geom[:, 3:6] = packed.p1
    geom[:, 6:9] = packed.p2
    geom[:, 9] = packed.prim_type
    mat = np.zeros((p, 16), np.float32)
    mat[:, 0:3] = packed.albedo
    mat[:, 3] = packed.material_type
    mat[:, 4:7] = packed.emission_color
    mat[:, 7] = packed.emission_power
    mat[:, 8] = packed.fuzz

    lights = _build_light_table(packed)

    mat_bank, prim_mat_id = np.unique(mat, axis=0, return_inverse=True)
    pad_m = (-mat_bank.shape[0]) % 8
    mat_bank = np.concatenate([mat_bank, np.zeros((pad_m, 16), np.float32)])
    prim_mat_id = prim_mat_id.reshape(-1).astype(np.int32)

    # material ids ride in the intersection rows (refine col 5, sphere SoA)
    refine = w["tri_refine"]
    tri_real = w["tri_ids"] >= 0
    refine[tri_real, 5] = prim_mat_id[w["tri_ids"][tri_real]]
    sph_real = w["sph_ids"] >= 0
    sph_mat_id = np.zeros(w["sph_ids"].shape[0], np.int32)
    sph_mat_id[sph_real] = prim_mat_id[w["sph_ids"][sph_real]]

    arrays = dict(
        prim_type=packed.prim_type.astype(np.int32),
        p0=packed.p0,
        p1=packed.p1,
        p2=packed.p2,
        geom_table=geom,
        mat_bank=mat_bank.astype(np.float32),
        prim_mat_id=prim_mat_id,
        **nodes,
        prim_indices=prim_indices,
        mm_w=w["w"],
        mm_tri_ids=w["tri_ids"],
        mm_refine=refine,
        mm_tile_box=w["tile_box"],
        mm_coarse_box=_coarse_boxes(w["tile_box"]),
        sph_center=w["sph_center"],
        sph_radius=w["sph_radius"],
        sph_ids=w["sph_ids"],
        sph_mat_id=sph_mat_id,
        **{f"light_{k}": lights[k] for k in (
            "kind", "prim", "q0", "e1", "e2", "normal", "emission", "area",
            "pick_p", "cdf")},
        prim_light_id=lights["prim_light_id"],
    )
    return _to_device(arrays, bvh_depth, w["n_tris"], lights["n"], device)


def scene_from_jax(arrays: dict, device) -> TorchScene:
    """The port's scene from a JAX `DeviceScene`'s arrays (field name ->
    numpy array, plus the ints `max_depth`, `num_tris` and `num_lights`).
    Every table is copied; the weight slab is rebuilt from p0/p1/p2 in
    `mm_tri_ids` column order in the port's compact f32 layout, since the
    JAX slab is a dense bf16 hi/lo split."""
    tri_ids = np.asarray(arrays["mm_tri_ids"])
    n_tiles = np.asarray(arrays["mm_tile_box"]).shape[0]
    tile_p = tri_ids.shape[0] // n_tiles
    if tile_p not in (TILE_P_SMALL, TILE_P_LARGE):
        raise ValueError(f"unexpected tile size {tile_p}")
    real = tri_ids[tri_ids >= 0]
    p0, p1, p2 = (np.asarray(arrays[k], np.float32) for k in ("p0", "p1", "p2"))
    w = tri_weight_slab(p0[real], p1[real], p2[real], tile_p)
    if w.shape[0] != n_tiles:
        raise ValueError("mm_tri_ids does not match mm_tile_box")
    tables = {f.name: arrays[f.name] for f in dataclasses.fields(TorchScene)
              if f.name not in ("mm_w", "sky", "frame_axes", "max_depth",
                                "num_tris", "num_lights")}
    tables["mm_w"] = w
    return _to_device(tables, arrays["max_depth"], arrays["num_tris"],
                      arrays["num_lights"], device)
