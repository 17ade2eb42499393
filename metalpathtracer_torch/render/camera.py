"""Camera state, controls and viewport-basis ray setup.

Port of `metalpathtracer_tpu/render/camera.py`: the Ray-Tracing-in-One-
Weekend basis (w = -forward, u = up x w, v = w x u; the image plane at
focal length 1). The camera is a small frozen dataclass of float32 CPU
tensors; `viewport_basis` computes in float32 on the tensors' device, op
for op as the reference does, so rays agree with it to an ulp.
`camera_basis` packs that basis into one tensor and `rays_from_basis`
jitters the primary rays from it (the math of the reference's
`pipeline.py::generate_rays`); they live here, below the pipeline, so that
the integrator and the wavefront's restart kernel import them directly.

The controls (`move`, `rotate`, `zoom`, `apply_inputs`) are host numpy, as
in the reference, and each returns a new camera: movement 0.1 per step on
the y-locked horizontal basis, rotation 0.002 rad per pixel of drag, zoom a
vertical-fov change of 0.1 per unit clamped to 30..120 degrees.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from metalpathtracer_torch.core import rng, vecmath as vm

MOVEMENT_SPEED = 0.1
ROTATION_SPEED = 0.002
ZOOM_SPEED = 0.1
FOV_MIN, FOV_MAX = 30.0, 120.0


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


def _np(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def move(cam: Camera, movement_input) -> Camera:
    """WASD/space/C translation with the y-locked horizontal basis.
    `movement_input` is the (x=strafe, y=vertical, z=forward) input vector;
    zero input is a no-op."""
    mi = _np(movement_input)
    if float(np.dot(mi, mi)) == 0.0:
        return cam
    fwd = _np(cam.forward)
    world_up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(fwd, world_up)
    right /= np.linalg.norm(right)
    fwd_horiz = np.cross(world_up, right)
    step = right * mi[0] + world_up * mi[1] + fwd_horiz * mi[2]
    step = MOVEMENT_SPEED * step / np.linalg.norm(step)
    return dataclasses.replace(cam, position=_f32(_np(cam.position) + step))


def _quat_rotate(v: np.ndarray, axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotate v around unit axis by angle (Rodrigues' formula, the action
    of the unit quaternion)."""
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    return (
        v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1.0 - c)
    ).astype(np.float32)


def rotate(cam: Camera, rotation_input) -> Camera:
    """Mouse-drag look: pitch around camera-right by -dy*speed, then yaw
    around the recomputed up by -dx*speed."""
    ri = _np(rotation_input)
    if float(np.dot(ri, ri)) == 0.0:
        return cam
    fwd = _np(cam.forward)
    world_up = np.array([0.0, 1.0, 0.0], np.float32)

    right = np.cross(fwd, world_up)
    fwd = _quat_rotate(fwd, right, -ri[1] * ROTATION_SPEED)
    fwd /= np.linalg.norm(fwd)

    right = np.cross(fwd, world_up)
    up = np.cross(right, fwd)
    up /= np.linalg.norm(up)
    fwd = _quat_rotate(fwd, up, -ri[0] * ROTATION_SPEED)
    fwd /= np.linalg.norm(fwd)
    return dataclasses.replace(
        cam, forward=_f32(fwd), up=_f32(up)
    )


def zoom(cam: Camera, amount: float) -> Camera:
    """Scroll zoom = fov change, clamped."""
    if amount == 0:
        return cam
    fov = float(np.clip(float(cam.vfov_deg) + amount * ZOOM_SPEED, FOV_MIN, FOV_MAX))
    return dataclasses.replace(cam, vfov_deg=_f32(fov))


def apply_inputs(cam: Camera, inputs) -> tuple[Camera, bool]:
    """Consume an InputState: reset, move, rotate, zoom. Returns (camera,
    changed); `changed` triggers accumulation reset in the progressive
    renderer."""
    changed = False
    if inputs.reset:
        cam, changed = Camera.reset(), True
    if float(np.dot(_np(inputs.movement), _np(inputs.movement))) != 0.0:
        cam, changed = move(cam, inputs.movement), True
    if float(np.dot(_np(inputs.rotation), _np(inputs.rotation))) != 0.0:
        cam, changed = rotate(cam, inputs.rotation), True
    if inputs.zoom != 0.0:
        cam, changed = zoom(cam, inputs.zoom), True
    return cam, changed


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


def camera_basis(camera: Camera, width: int, height: int) -> torch.Tensor:
    """`viewport_basis`'s four vectors as rows of one (4, 3) float32 tensor
    on the camera's device: [origin, first_pixel, viewport_u, viewport_v].
    A caller moves it to the render device once per render."""
    return torch.stack(list(viewport_basis(camera, width, height)))


def rays_from_basis(basis: torch.Tensor, width: int, height: int, pixel_id,
                    sample_id, seed):
    """Jittered primary rays: screen coords sx = (px+u)/W, sy = (py+v)/H
    with u, v ~ U[0,1); row 0 is the TOP of the image. `basis` is a
    `camera_basis` on `pixel_id`'s device, `pixel_id` an int64 tensor of
    u32 pixel ids; nothing is moved between devices."""
    origin, first_pixel, vu, vv = basis.unbind(0)
    px = (pixel_id % width).to(torch.float32)
    py = (pixel_id // width).to(torch.float32)
    u1, u2 = rng.uniform2(seed, pixel_id, sample_id, 0, rng.PURPOSE_JITTER_X)
    sx = (px + u1) / width
    sy = (py + u2) / height
    d = (
        first_pixel[None, :]
        + sx[:, None] * vu[None, :]
        + sy[:, None] * vv[None, :]
        - origin[None, :]
    )
    # vector_norm accumulates as XLA's jnp.linalg.norm does (bit-equal)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = origin.expand_as(d)
    return o, d


@dataclasses.dataclass
class InputState:
    """Per-frame input snapshot. The write side is the interactive front
    end; `clear()` consumes the one-shot inputs each frame."""

    movement: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2, np.float32)
    )
    zoom: float = 0.0
    reset: bool = False

    def clear(self) -> None:
        self.rotation = np.zeros(2, np.float32)
        self.zoom = 0.0
        self.reset = False
