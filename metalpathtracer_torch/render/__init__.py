"""Camera, BSDFs, intersection, both integrators and the pipeline.

The names of the reference's `metalpathtracer_tpu.render`; the port's
scene class `TorchScene` stands in for its `DeviceScene`.
"""

from metalpathtracer_torch.render.camera import Camera, InputState, viewport_basis
from metalpathtracer_torch.render.device_scene import TorchScene, upload_scene
from metalpathtracer_torch.render.kernels import closest_hit_mm
from metalpathtracer_torch.render.integrator import (
    DEFAULT_CONFIG,
    REFERENCE_CONFIG,
    RenderConfig,
    trace,
    trace_wavefront,
)
from metalpathtracer_torch.render.pipeline import (
    AccumState,
    accumulate,
    accumulate_wavefront,
    generate_rays,
    init_accum,
    render_image,
    render_image_wavefront,
    to_image,
)

DeviceScene = TorchScene

__all__ = [
    "Camera",
    "InputState",
    "viewport_basis",
    "DeviceScene",
    "TorchScene",
    "upload_scene",
    "RenderConfig",
    "DEFAULT_CONFIG",
    "REFERENCE_CONFIG",
    "trace",
    "trace_wavefront",
    "AccumState",
    "accumulate",
    "accumulate_wavefront",
    "init_accum",
    "render_image",
    "render_image_wavefront",
    "to_image",
    "generate_rays",
    "closest_hit_mm",
]
