"""Vectorized 3D math over (..., 3) float32 tensors.

Port of `metalpathtracer_tpu/core/vecmath.py`: the same shape-polymorphic
helpers, each op in the same order so results agree with the reference to
the last ulp where the underlying torch op rounds like XLA's.

A dot product is three products and then two adds in one fixed order,
(a0 b0 + a1 b1) + a2 b2: the order of torch's CPU sum over three elements,
so that nothing changes on the CPU, while on the card a reduction kernel
would pick an order of its own. The hand-written kernels of the bounce
step (`csrc/sphere_pass.cu`, `hit_epilogue.cu`, `shade.cu`) take the same
order, which keeps them bit-equal to their plain versions built on these
helpers (the front end's ray features, `o.d` and `|o|^2`, included).
"""

from __future__ import annotations

import torch

# the reference's ray epsilon (`metalpathtracer_tpu/core/vecmath.py:16`),
# which its intersection tests and scatter offsets use
RAY_EPS = 1e-4


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing (3,) axis; keeps no trailing
    dim."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def dot_keepdims(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return dot(a, b)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product over the trailing (3,) axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(a))


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: a / |a|, with 0 where |a|^2 <= eps (one degenerate
    lane must not poison the wavefront with NaNs)."""
    norm2 = length_squared(a)
    inv = torch.where(norm2 > eps, 1.0 / torch.sqrt(norm2), 0.0)
    return a * inv[..., None]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction `d` about normal `n`."""
    return d - 2.0 * dot_keepdims(d, n) * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """GLSL `refract` for unit `d`, `n` and ratio `eta`; the 0-vector on
    total internal reflection."""
    cos_i = -dot_keepdims(d, n)
    eta3 = eta[..., None]
    sin2_t = (eta3 * eta3) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = eta3 * d + (eta3 * cos_i - cos_t) * n
    return torch.where(tir, torch.zeros_like(refr), refr)


def schlick_reflectance(cos_theta: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation to Fresnel reflectance. The fifth power is
    multiplied out as XLA's integer power does it: x * ((x * x) * (x * x))."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cos_theta
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def mix(a, b, t: torch.Tensor) -> torch.Tensor:
    """Linear interpolation a + (b - a) * t."""
    return a + (b - a) * t


def where3(mask: torch.Tensor, a, b) -> torch.Tensor:
    """`torch.where` with a (...,)-shaped mask broadcast over trailing (3,)."""
    return torch.where(mask[..., None], a, b)
