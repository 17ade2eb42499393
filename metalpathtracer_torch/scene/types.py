"""Scene data model: host-side primitive soup + device-side SoA arrays.

The reference stores a unified sphere/triangle "primitive soup" as an
array-of-structs (`MetalCpp Path Tracer/Scene/Scene.h:17-23`: tagged union of
type + data0..2 + Material) and serializes it to GPU float4 arrays
(`Scene/Scene.h:99-118`). Here the layout is structure-of-arrays: separate
typed `(P,)`/`(P, 3)` arrays, padded to a multiple of LANE_PAD, so every
field uploads as one contiguous tensor.

Material conventions preserved from the reference
(`Scene/Material.h:8-14`, `Renderer/Shaders/Scatter.h:22-43`,
`PathTracing.h:245`):

- ``material_type == 0``  → Lambertian
- ``material_type <  0``  → perfect mirror
- ``material_type >  0``  → dielectric with IOR = material_type
- ``material_type == 2``  → treated as emissive marker (with emission fields)
- ``emission_power > 0``  → adds `emission_color * power` at each hit

Extension beyond the reference: a ``fuzz`` field (default 0) for glossy
reflection (BASELINE config 3 requires glossy+specular), and a ``metallic``
scene stays expressible through the same float convention.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

PRIM_SPHERE = 0
PRIM_TRIANGLE = 1
PRIM_NONE = 2  # padding lanes; never intersected

LANE_PAD = 8  # pad primitive counts to a multiple of this (f32 sublane)


@dataclasses.dataclass
class Material:
    """Plain material record (reference `Scene/Material.h:8-14`)."""

    albedo: tuple = (0.8, 0.8, 0.8)
    material_type: float = 0.0
    emission_color: tuple = (0.0, 0.0, 0.0)
    emission_power: float = 0.0
    fuzz: float = 0.0  # glossy roughness; 0 = perfect mirror (extension)


@dataclasses.dataclass
class HostScene:
    """Mutable host-side scene under construction (reference `Scene::addPrimitive`,
    `Scene/Scene.h:38-66`). Use `add_sphere` / `add_triangles`, then `pack()`."""

    prim_type: list = dataclasses.field(default_factory=list)
    p0: list = dataclasses.field(default_factory=list)
    p1: list = dataclasses.field(default_factory=list)
    p2: list = dataclasses.field(default_factory=list)
    materials: list = dataclasses.field(default_factory=list)

    def add_sphere(self, center, radius: float, material: Material) -> None:
        self.prim_type.append(PRIM_SPHERE)
        self.p0.append(np.asarray(center, np.float32))
        self.p1.append(np.array([radius, 0.0, 0.0], np.float32))
        self.p2.append(np.zeros(3, np.float32))
        self.materials.append(material)

    def add_triangle(self, v0, v1, v2, material: Material) -> None:
        self.prim_type.append(PRIM_TRIANGLE)
        self.p0.append(np.asarray(v0, np.float32))
        self.p1.append(np.asarray(v1, np.float32))
        self.p2.append(np.asarray(v2, np.float32))
        self.materials.append(material)

    def add_mesh(self, vertices, faces, position, scale, material: Material) -> None:
        """Bake `position + scale * vertex` world-space triangles, one shared
        material — reference `Scene/SceneLoader.cpp:107-131`."""
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        pos = np.asarray(position, np.float32)
        world = pos[None, :] + np.float32(scale) * vertices
        for f in faces:
            self.add_triangle(world[f[0]], world[f[1]], world[f[2]], material)

    @property
    def primitive_count(self) -> int:
        return len(self.prim_type)

    @property
    def triangle_count(self) -> int:
        return sum(1 for t in self.prim_type if t == PRIM_TRIANGLE)

    def pack(self) -> "PackedScene":
        return PackedScene.from_host(self)


@dataclasses.dataclass
class PackedScene:
    """Immutable NumPy SoA scene, padded to LANE_PAD, pre-BVH.

    The reference keeps primitives stable-sorted spheres-first before BVH
    build (`Scene/Scene.h:72-75`); we preserve insertion order instead — the
    BVH references primitives through `prim_indices` so order is free.
    """

    prim_type: np.ndarray  # int32 (P,)
    p0: np.ndarray  # float32 (P, 3) sphere center / tri v0
    p1: np.ndarray  # float32 (P, 3) [radius,0,0] / tri v1
    p2: np.ndarray  # float32 (P, 3) zeros / tri v2
    albedo: np.ndarray  # float32 (P, 3)
    material_type: np.ndarray  # float32 (P,)
    emission_color: np.ndarray  # float32 (P, 3)
    emission_power: np.ndarray  # float32 (P,)
    fuzz: np.ndarray  # float32 (P,)
    num_real: int  # primitives before padding

    @staticmethod
    def from_host(h: HostScene) -> "PackedScene":
        n = h.primitive_count
        if n == 0:
            raise ValueError("cannot pack an empty scene")
        pad = (-n) % LANE_PAD
        total = n + pad

        def pad3(rows):
            arr = np.stack(rows).astype(np.float32)
            return np.concatenate([arr, np.zeros((pad, 3), np.float32)])

        def pad1(vals, dtype=np.float32, fill=0):
            arr = np.asarray(vals, dtype)
            return np.concatenate([arr, np.full((pad,), fill, dtype)])

        mats = h.materials
        return PackedScene(
            prim_type=pad1(h.prim_type, np.int32, PRIM_NONE),
            p0=pad3(h.p0),
            p1=pad3(h.p1),
            p2=pad3(h.p2),
            albedo=pad3([np.asarray(m.albedo, np.float32) for m in mats]),
            material_type=pad1([m.material_type for m in mats]),
            emission_color=pad3(
                [np.asarray(m.emission_color, np.float32) for m in mats]
            ),
            emission_power=pad1([m.emission_power for m in mats]),
            fuzz=pad1([m.fuzz for m in mats]),
            num_real=n,
        )

    @property
    def num_padded(self) -> int:
        return int(self.prim_type.shape[0])

    def aabbs(self) -> tuple:
        """Per-primitive AABBs (lo, hi), each (P, 3) — reference computes these
        inside the SAH sweep (`Scene/Scene.h:200-213`)."""
        is_sphere = (self.prim_type == PRIM_SPHERE)[:, None]
        radius = self.p1[:, 0:1]
        sph_lo, sph_hi = self.p0 - radius, self.p0 + radius
        tri_lo = np.minimum(np.minimum(self.p0, self.p1), self.p2)
        tri_hi = np.maximum(np.maximum(self.p0, self.p1), self.p2)
        lo = np.where(is_sphere, sph_lo, tri_lo)
        hi = np.where(is_sphere, sph_hi, tri_hi)
        # padding lanes get empty boxes that never win a SAH split
        none = (self.prim_type == PRIM_NONE)[:, None]
        lo = np.where(none, np.float32(np.inf), lo)
        hi = np.where(none, np.float32(-np.inf), hi)
        return lo.astype(np.float32), hi.astype(np.float32)
