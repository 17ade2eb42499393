"""The hand-written CUDA kernels (closest hit, tile cull, sphere pass and
hit epilogue in `intersect_mm`; the RNG's threefry; the bounce step's
shading in `shade`; the wavefront's regeneration in `wavefront`), their
plain twins, their tables, and how they are built and launched.

The names of the reference's `metalpathtracer_tpu.render.pallas`."""

from metalpathtracer_torch.render.kernels.intersect_mm import (
    build_weights,
    closest_hit_mm,
    ray_features,
)

__all__ = ["build_weights", "closest_hit_mm", "ray_features"]
