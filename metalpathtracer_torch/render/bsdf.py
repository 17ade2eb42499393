"""BSDF sampling and the sky miss shader, vectorized over the wavefront.

Port of `metalpathtracer_tpu/render/bsdf.py`. Conventions:

- material_type == 0: Lambertian (normal + uniform-sphere point)
- material_type <  0: mirror; `fuzz` adds glossy roughness
- material_type >  0 (and != 2): dielectric with IOR = material_type,
  Schlick reflectance + total internal reflection
- material_type == 2: emissive marker, scatters Lambertian

Every lane evaluates every lobe and selects.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from metalpathtracer_torch.core import vecmath as vm

SKY_HORIZON = np.array([1.0, 1.0, 1.0], np.float32)
SKY_ZENITH = np.array([0.6, 0.7, 1.0], np.float32)


def sky_color(d_unit: torch.Tensor, sky: torch.Tensor) -> torch.Tensor:
    """Miss shader: vertical gradient white -> pale blue. `d_unit` is the
    unit ray direction (..., 3); `sky` the (2, 3) rows [SKY_HORIZON,
    SKY_ZENITH] on its device (the scene's `sky`, uploaded with it)."""
    t = 0.5 * (d_unit[..., 1] + 1.0)
    return vm.mix(sky[0], sky[1], t[..., None])


def is_emissive(material_type, emission_power):
    """Hit emits when `emissionPower > 0 || materialType == 2`."""
    return (emission_power > 0.0) | (material_type == 2.0)


def glossy_pdf(refl_unit, fuzz, w):
    """Solid-angle pdf of the fuzzy-mirror lobe `normalize(refl + fuzz*s)`,
    s uniform on the unit sphere:

        p(w) = (cos 2theta + r^2) / (2 pi r sqrt(r^2 - sin^2 theta))

    inside the cone sin theta < r = fuzz, 0 outside it or when r is outside
    (0, 1). The derivation is in `metalpathtracer_tpu.render.bsdf.glossy_pdf`."""
    r2 = fuzz * fuzz
    cos_t = vm.dot(refl_unit, w)
    sin2 = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
    disc = r2 - sin2
    inside = (disc > 0.0) & (cos_t > 0.0) & (fuzz > 0.0) & (fuzz < 1.0)
    root = torch.sqrt(torch.clamp(disc, min=1e-20))
    pdf = (2.0 * cos_t * cos_t - 1.0 + r2) / (
        2.0 * math.pi * torch.clamp(fuzz, min=1e-8) * root
    )
    return torch.where(inside, pdf, 0.0)


def sample_bsdf(d_in, normal, front_face, material_type, fuzz, unit_vec,
                u_fresnel):
    """Sample the scatter direction for every lane.

    d_in (N, 3) unit incoming direction; normal (N, 3) unit, flipped to
    oppose d_in; front_face (N,) bool; material_type, fuzz (N,);
    unit_vec (N, 3) uniform sphere sample; u_fresnel (N,) uniform.
    Returns (d_out (N, 3) unit, offset_sign (N,)): +1 offsets the new
    origin along the normal, -1 for transmission.
    """
    is_dielectric = (material_type > 0.0) & (material_type != 2.0)
    is_mirror = material_type < 0.0

    # Lambertian lobe; a degenerate normal+unit ~ 0 falls back to the normal
    lam = vm.normalize(normal + unit_vec)
    lam = vm.where3(vm.length_squared(lam) > 1e-12, lam, normal)

    # mirror / glossy lobe; a fuzzed direction under the surface falls back
    # to the pure reflection
    refl = vm.reflect(d_in, normal)
    mirror = vm.normalize(refl + fuzz[..., None] * unit_vec)
    mirror = vm.where3(vm.dot(mirror, normal) > 0.0, mirror, vm.normalize(refl))

    # dielectric lobe
    ior = torch.where(is_dielectric, material_type, 1.5)
    eta = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(vm.dot(-d_in, normal), 0.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = eta * sin_theta > 1.0
    reflectance = vm.schlick_reflectance(cos_theta, eta)
    choose_reflect = cannot_refract | (reflectance > u_fresnel)
    refracted = vm.refract(d_in, normal, eta)
    diel = vm.where3(choose_reflect, vm.normalize(refl), vm.normalize(refracted))

    d_out = vm.where3(is_dielectric, diel, vm.where3(is_mirror, mirror, lam))
    transmitted = is_dielectric & ~choose_reflect
    offset_sign = torch.where(transmitted, -1.0, 1.0)
    return d_out, offset_sign
