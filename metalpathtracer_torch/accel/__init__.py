"""The BVH builders of the study intersector (`intersector="bvh"`)."""

from metalpathtracer_torch.accel.bvh import (
    BVHArrays,
    LEAF_SIZE,
    build_bvh,
    build_bvh_from_aabbs,
    validate_bvh,
)

__all__ = [
    "BVHArrays",
    "LEAF_SIZE",
    "build_bvh",
    "build_bvh_from_aabbs",
    "validate_bvh",
]
