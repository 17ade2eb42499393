"""Camera state and viewport-basis ray setup.

Port of `Camera`, `Camera.reset`, `Camera.look_at` and `viewport_basis`
from `metalpathtracer_tpu/render/camera.py`: the Ray-Tracing-in-One-Weekend
basis (w = -forward, u = up x w, v = w x u; the image plane at focal
length 1). The camera is a small frozen dataclass of float32 CPU tensors;
`viewport_basis` computes in float32 on the tensors' device, op for op as
the reference does, so rays agree with it to an ulp.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from metalpathtracer_torch.core import vecmath as vm


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32))


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor  # float32 (3,)
    forward: torch.Tensor  # float32 (3,), unit
    up: torch.Tensor  # float32 (3,), unit
    vfov_deg: torch.Tensor  # float32 scalar

    @staticmethod
    def reset() -> "Camera":
        """Position (0, 20, 50) looking down -Z at a 60 degree fov."""
        return Camera(
            position=_f32([0.0, 20.0, 50.0]),
            forward=_f32([0.0, 0.0, -1.0]),
            up=_f32([0.0, 1.0, 0.0]),
            vfov_deg=_f32(60.0),
        )

    @staticmethod
    def look_at(position, target, up=(0.0, 1.0, 0.0), vfov_deg=60.0) -> "Camera":
        position = np.asarray(position, np.float32)
        fwd = np.asarray(target, np.float32) - position
        fwd = fwd / np.linalg.norm(fwd)
        upv = np.asarray(up, np.float32)
        right = np.cross(fwd, upv)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        return Camera(
            position=_f32(position),
            forward=_f32(fwd),
            up=_f32(true_up),
            vfov_deg=_f32(vfov_deg),
        )


def viewport_basis(cam: Camera, width: int, height: int):
    """Camera basis -> image-plane vectors, float32 (3,) tensors.

    Returns (origin, first_pixel, viewport_u, viewport_v): a ray through
    normalized screen coords (sx, sy) in [0,1]^2 (sy = 0 at the TOP row) is
        dir = first_pixel + sx*viewport_u + sy*viewport_v - origin.
    """
    aspect = width / height
    fov_rad = cam.vfov_deg * (math.pi / 180.0)
    half_h = torch.tan(fov_rad * 0.5)
    half_w = aspect * half_h

    fwd = cam.forward / torch.linalg.vector_norm(cam.forward)
    w = -fwd
    u = vm.cross(cam.up, w)
    u = u / torch.linalg.vector_norm(u)
    v = vm.cross(w, u)

    viewport_u = u * (2.0 * half_w)
    viewport_v = -v * (2.0 * half_h)
    first_pixel = cam.position - w - 0.5 * viewport_u - 0.5 * viewport_v
    return cam.position, first_pixel, viewport_u, viewport_v
