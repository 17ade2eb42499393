"""Lockstep BVH traversal over the ray wavefront: the study intersector.

Port of `metalpathtracer_tpu/render/traverse.py` (`closest_hit_bvh`):
- every ray carries its own fixed-size stack as a row of an (N, S) int32
  tensor; all rays step together, one node pop per ray per step, with masks
  in place of per-lane control flow;
- the stack bound S is the tree's measured depth + 2 (`scene.max_depth`); a
  push that would pass it is dropped;
- a leaf is one dense (N, 8) intersection block per step (LEAF_SIZE = 8);
- the box test prunes against each ray's current best t;
- the loop is a Python `while` that ends when every ray's stack is empty,
  read from the device once per step.
It runs neither hand-written kernel: gathers of four node arrays and a leaf
block per step, and as many steps as the longest walk of any ray. "auto"
never selects it.
"""

from __future__ import annotations

import torch

from metalpathtracer_torch.accel.bvh import LEAF_SIZE
from metalpathtracer_torch.render.intersect import (
    INF,
    T_MIN,
    intersect_prims_block,
    ray_aabb,
)


def closest_hit_bvh(scene, o, d, t_min=T_MIN):
    """Closest hit via BVH traversal.

    Args: `scene` TorchScene, `o`/`d` float32 (N, 3) on its device. Returns
    (t, prim_idx): float32 (N,), int32 (N,) with -1 on miss.
    """
    if scene.node_a.shape[0] == 0:
        raise ValueError("the scene was uploaded without its BVH: "
                         "upload_scene(..., bvh=True)")
    n = o.shape[0]
    dev = o.device
    stack_size = int(scene.max_depth) + 2
    inv_d = 1.0 / d  # inf on zero components is fine (see ray_aabb)

    # slot 0 holds the root, node 0
    stack = torch.zeros((n, stack_size), dtype=torch.int32, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    leaf_arange = torch.arange(LEAF_SIZE, dtype=torch.int64, device=dev)[None, :]
    last_slot = scene.prim_indices.shape[0] - 1
    o_b, d_b = o[:, None, :], d[:, None, :]

    def push(stack, ok, col, value):
        """stack[row, col] = value on rows where `ok`; the other rows keep
        what they hold (their column is clamped into range and rewritten
        with its own content)."""
        col = torch.where(ok, col, 0)[:, None]
        old = stack.gather(1, col)
        return stack.scatter(1, col, torch.where(ok[:, None], value[:, None], old))

    while bool(sp.gt(0).any()):
        active = sp > 0
        top = torch.clamp(sp - 1, min=0)
        node = torch.where(active, stack.gather(1, top[:, None])[:, 0], 0).to(torch.int64)
        sp = torch.where(active, sp - 1, sp)

        lo = scene.node_lo[node]
        hi = scene.node_hi[node]
        a = scene.node_a[node]
        b = scene.node_b[node]

        hit_box = active & ray_aabb(o, inv_d, lo, hi, t_min, best_t)
        is_leaf = b > 0

        # leaf: one (N, 8) gathered intersection block
        slot = a.to(torch.int64)[:, None] + leaf_arange  # into prim_indices
        lane_ok = (hit_box & is_leaf)[:, None] & (leaf_arange < b[:, None])
        pidx = scene.prim_indices[slot.clamp(0, last_slot)].to(torch.int64)
        t_blk = intersect_prims_block(
            o_b, d_b, scene.prim_type[pidx], scene.p0[pidx], scene.p1[pidx],
            scene.p2[pidx], t_min,
        )
        t_blk = torch.where(lane_ok, t_blk, INF)
        t_leaf, j = torch.min(t_blk, dim=1)
        better = t_leaf < best_t
        best_t = torch.where(better, t_leaf, best_t)
        best_i = torch.where(better, pidx.gather(1, j[:, None])[:, 0].to(torch.int32),
                             best_i)

        # internal: push the left child, then the right (popped right first)
        can_push = hit_box & ~is_leaf & (sp + 2 <= stack_size)
        stack = push(stack, can_push, sp, a)
        stack = push(stack, can_push, sp + 1, -b)
        sp = torch.where(can_push, sp + 2, sp)
    return best_t, best_i
