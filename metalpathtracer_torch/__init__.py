"""metalpathtracer_torch — the path tracer on PyTorch and CUDA.

A port of `metalpathtracer_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper card. The JAX package is the reference this package is tested
against; module names mirror it so each module's counterpart is easy to
find. This package never imports jax, nor anything of the JAX package.

What is ported so far are the CLI's two render paths:
`cli.main` -> `render.pipeline.render_image` (the scan,
`render.integrator.trace`) or `render_image_wavefront` (the persistent
wavefront, `trace_wavefront`) -> `_bounce_step` ->
`render.kernels.intersect_mm.closest_hit_mm_winners`, whose triangle pass
runs the hand-written CUDA kernels `csrc/cull_tiles.cu` (the cull, which
sorts each subgroup's tile list itself) and `csrc/mm_closest_hit.cu` after
the front end (`csrc/sphere_pass.cu`: the
sphere pass and every per-lane operand of the cull and the closest hit);
every random draw (`core.rng`) runs `csrc/threefry.cu` through
`render.kernels.threefry` (a bounce step's draws in one launch), and the
step's shading without next-event estimation runs `csrc/shade.cu`
(`render.kernels.shade.shade_hit`) from the closest hit's winners, the
epilogue computed in its registers, on the wavefront at one bounce an
advance with the advance's bank of finished paths in the same launch. With
next-event estimation the closest hit ends in its own epilogue
(`closest_hit_mm_full`, `csrc/hit_epilogue.cu`) and the plain NEE shading
takes its output; the BVH and brute intersectors shade in plain torch
(`shade_reference`).

The host scene layer (`metalpathtracer_torch.scene`: scene model, XML and
OBJ loaders, presets) is plain numpy, the port's own copy of the
reference's; `tests/test_torch_scene.py` holds the two to equal packed
scenes and equal errors.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
