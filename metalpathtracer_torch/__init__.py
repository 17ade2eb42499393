"""metalpathtracer_torch — the path tracer on PyTorch and CUDA.

A port of `metalpathtracer_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper card. The JAX package is the reference this package is tested
against; module names mirror it so each module's counterpart is easy to
find. This package never imports jax.

What is ported so far is the CLI's default render path:
`cli.main` -> `render.pipeline.render_image` -> `render.integrator.trace`
-> `_bounce_step` -> `_trace_rays` -> `render.kernels.intersect_mm.
closest_hit_mm_full`, whose triangle pass runs the hand-written CUDA kernel
in `csrc/mm_closest_hit.cu`.

The host scene layer (`metalpathtracer_tpu.scene`) is plain numpy and is
imported from the JAX package as it is, so there is one copy of it; the
port reaches it through `metalpathtracer_torch.scene`.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
