"""metalpathtracer_torch — the path tracer on PyTorch and CUDA.

A port of `metalpathtracer_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper card. The JAX package is the reference this package is tested
against; module names mirror it so each module's counterpart is easy to
find. This package never imports jax, nor anything of the JAX package.

What is ported so far are the CLI's two render paths:
`cli.main` -> `render.pipeline.render_image` (the scan,
`render.integrator.trace`) or `render_image_wavefront` (the persistent
wavefront, `trace_wavefront`) -> `_bounce_step` -> `_trace_rays` ->
`render.kernels.intersect_mm.closest_hit_mm_full`, whose triangle pass runs
the hand-written CUDA kernels `csrc/cull_tiles.cu` and
`csrc/mm_closest_hit.cu`; every random draw (`core.rng`) runs the third,
`csrc/threefry.cu`, through `render.kernels.threefry`.

The host scene layer (`metalpathtracer_torch.scene`: scene model, XML and
OBJ loaders, presets) is plain numpy, the port's own copy of the
reference's; `tests/test_torch_scene.py` holds the two to equal packed
scenes and equal errors.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
