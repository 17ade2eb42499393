"""Sweep-SAH BVH builder producing linearized arrays for device traversal.

Copy of `metalpathtracer_tpu/accel/bvh.py` (numpy only), which the port
keeps for itself as it keeps its scene layer: top-down recursion, full-sweep
surface-area heuristic on all 3 axes, leaves of <= `leaf_size` primitives,
and the compact node encoding

    leaf:     count > 0,  left_first = first slot in `prim_indices`
    internal: count = -right_child_index, left_first = left_child_index

Splits sort by primitive centroid; the sweeps are vectorized numpy; the
output is SoA float32/int32 arrays. `tests/test_torch_bvh.py` holds the
arrays equal to the reference builder's.

A native C++ builder with the same output contract is bound in
`metalpathtracer_torch.accel.native` for large scenes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from metalpathtracer_torch.scene.types import PackedScene

LEAF_SIZE = 8  # primitives a leaf may hold; the traversal tests 8 per leaf
TRAVERSAL_COST = 0.125  # SAH cost of one node visit, in primitive tests


@dataclasses.dataclass
class BVHArrays:
    """Linearized BVH. Node i owns rows i of each array; root is node 0."""

    node_lo: np.ndarray  # float32 (M, 3)
    node_hi: np.ndarray  # float32 (M, 3)
    node_a: np.ndarray  # int32 (M,)  leaf: first index slot; internal: left child
    node_b: np.ndarray  # int32 (M,)  leaf: +count; internal: -right child
    prim_indices: np.ndarray  # int32 (P,) permutation into primitive arrays
    num_nodes: int

    @property
    def max_depth(self) -> int:
        """Deepest node (root = 1); bounds the traversal stack."""
        depth = {0: 1}
        best = 1
        stack = [0]
        while stack:
            n = stack.pop()
            if self.node_b[n] < 0:
                for c in (self.node_a[n], -self.node_b[n]):
                    depth[int(c)] = depth[n] + 1
                    best = max(best, depth[n] + 1)
                    stack.append(int(c))
        return best


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


NATIVE_THRESHOLD = 20_000  # above this the C++ builder is used when built


def build_bvh(
    scene: PackedScene, leaf_size: int = LEAF_SIZE, backend: str = "auto"
) -> BVHArrays:
    """Build over the scene's real (unpadded) primitives.

    backend: "auto" (C++ builder for large scenes when compiled — see
    native/bvh_builder.cpp), "numpy", or "native"."""
    lo_all, hi_all = scene.aabbs()
    n = scene.num_real
    lo, hi = lo_all[:n], hi_all[:n]
    if backend != "numpy":
        from metalpathtracer_torch.accel import native

        if backend == "native" or (n > NATIVE_THRESHOLD and native.native_available()):
            if native.native_available():
                return native.build_bvh_native(lo, hi, leaf_size)
            if backend == "native":
                raise RuntimeError(
                    "native BVH builder requested but not built; run `make -C native`"
                )
    return build_bvh_from_aabbs(lo, hi, leaf_size)


def build_bvh_from_aabbs(
    lo: np.ndarray, hi: np.ndarray, leaf_size: int = LEAF_SIZE
) -> BVHArrays:
    n = lo.shape[0]
    if n == 0:
        raise ValueError("cannot build BVH over zero primitives")
    lo = lo.astype(np.float32)
    hi = hi.astype(np.float32)
    centroids = 0.5 * (lo + hi)

    max_nodes = max(1, 2 * n)
    node_lo = np.zeros((max_nodes, 3), np.float32)
    node_hi = np.zeros((max_nodes, 3), np.float32)
    node_a = np.zeros(max_nodes, np.int32)
    node_b = np.zeros(max_nodes, np.int32)
    indices = np.arange(n, dtype=np.int32)
    num_nodes = 1

    # worklist of (node_id, start, end) ranges over `indices`
    stack = [(0, 0, n)]
    while stack:
        node, start, end = stack.pop()
        idx = indices[start:end]
        count = end - start
        box_lo = lo[idx].min(axis=0)
        box_hi = hi[idx].max(axis=0)
        node_lo[node] = box_lo
        node_hi[node] = box_hi

        split = None
        if count > leaf_size:
            split = _best_sah_split(lo[idx], hi[idx], centroids[idx])
            if split is None:
                # degenerate spread (coincident/invalid boxes): force a
                # median split — traversal only tests LEAF_SIZE prims per
                # leaf, so an oversized leaf would silently drop hits
                split = (0, count // 2)
        if split is None:
            node_a[node] = start
            node_b[node] = count
            continue

        axis, k = split
        order = np.argsort(centroids[idx, axis], kind="stable")
        indices[start:end] = idx[order]
        left_id, right_id = num_nodes, num_nodes + 1
        num_nodes += 2
        node_a[node] = left_id
        node_b[node] = -right_id
        stack.append((right_id, start + k, end))
        stack.append((left_id, start, start + k))

    return BVHArrays(
        node_lo=node_lo[:num_nodes],
        node_hi=node_hi[:num_nodes],
        node_a=node_a[:num_nodes],
        node_b=node_b[:num_nodes],
        prim_indices=indices,
        num_nodes=num_nodes,
    )


def _best_sah_split(lo, hi, centroids):
    """Full-sweep SAH over all 3 axes.

    Returns (axis, left_count) or None to make a leaf (degenerate spread)."""
    count = lo.shape[0]
    parent_sa = _surface_area(lo.min(0), hi.max(0))
    if parent_sa <= 0.0 or not np.isfinite(parent_sa):
        return None

    best = (np.inf, None, None)
    for axis in range(3):
        order = np.argsort(centroids[:, axis], kind="stable")
        slo, shi = lo[order], hi[order]
        # prefix sweep: AABB of prims [0..i]
        left_lo = np.minimum.accumulate(slo, 0)
        left_hi = np.maximum.accumulate(shi, 0)
        # suffix sweep: AABB of prims [i..n)
        right_lo = np.minimum.accumulate(slo[::-1], 0)[::-1]
        right_hi = np.maximum.accumulate(shi[::-1], 0)[::-1]

        ks = np.arange(1, count)
        sa_l = _surface_area(left_lo[:-1], left_hi[:-1])
        sa_r = _surface_area(right_lo[1:], right_hi[1:])
        cost = TRAVERSAL_COST + (sa_l * ks + sa_r * (count - ks)) / parent_sa
        k = int(np.argmin(cost))
        if cost[k] < best[0]:
            best = (float(cost[k]), axis, k + 1)

    _, axis, k = best
    if axis is None:
        return None
    # degenerate: all centroids identical on the best axis → median split
    if k == 0 or k == count:
        k = count // 2
    return axis, k


def validate_bvh(bvh: BVHArrays, lo: np.ndarray, hi: np.ndarray) -> None:
    """Assert structural invariants. Raises AssertionError."""
    n = lo.shape[0]
    seen = np.zeros(n, bool)
    stack = [(0, None)]
    while stack:
        node, parent = stack.pop()
        assert 0 <= node < bvh.num_nodes
        if parent is not None:
            assert np.all(bvh.node_lo[node] >= bvh.node_lo[parent] - 1e-4)
            assert np.all(bvh.node_hi[node] <= bvh.node_hi[parent] + 1e-4)
        b = int(bvh.node_b[node])
        a = int(bvh.node_a[node])
        if b > 0:  # leaf
            prims = bvh.prim_indices[a : a + b]
            assert not seen[prims].any(), "primitive in two leaves"
            seen[prims] = True
            assert np.all(lo[prims] >= bvh.node_lo[node] - 1e-4)
            assert np.all(hi[prims] <= bvh.node_hi[node] + 1e-4)
        else:
            stack.append((a, node))
            stack.append((-b, node))
    assert seen.all(), "not every primitive is covered by a leaf"
