"""The hand-written CUDA kernels (closest hit, tile cull, the RNG's threefry,
and the bounce step's sphere pass, hit epilogue and shading), their plain
twins, their tables, and how they are built and launched.

The names of the reference's `metalpathtracer_tpu.render.pallas`."""

from metalpathtracer_torch.render.kernels.intersect_mm import (
    build_weights,
    closest_hit_mm,
    ray_features,
)

__all__ = ["build_weights", "closest_hit_mm", "ray_features"]
