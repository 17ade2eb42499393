"""Built-in scenes used by tests, benchmarks, and the BASELINE configs.

The reference ships exactly one scene (`MetalCpp Path Tracer/scene.xml`:
ground sphere r=10000 + floating sphere + emissive sphere + bunny mesh).
These presets reproduce it plus the BASELINE.json milestone scenes.
"""

from __future__ import annotations

import numpy as np

from metalpathtracer_torch.scene.types import HostScene, Material

WHITE = Material(albedo=(0.73, 0.73, 0.73))
RED = Material(albedo=(0.65, 0.05, 0.05))
GREEN = Material(albedo=(0.12, 0.45, 0.15))


def cornell_spheres() -> HostScene:
    """BASELINE config 1: Cornell-style box built from huge analytic spheres,
    diffuse only, with one emissive sphere light. CPU-runnable at 256x256."""
    s = HostScene()
    big = 1e4
    half = 2.5  # box half-width
    # floor / ceiling / back / left / right as giant spheres tangent to the box
    s.add_sphere((0, -big, 0), big, WHITE)  # floor at y=0
    s.add_sphere((0, big + 2 * half, 0), big, WHITE)  # ceiling at y=5
    s.add_sphere((0, half, -(big + half)), big, WHITE)  # back wall at z=-2.5
    s.add_sphere((-(big + half), half, 0), big, RED)  # left wall x=-2.5
    s.add_sphere((big + half, half, 0), big, GREEN)  # right wall x=+2.5
    # light: emissive sphere hanging just below the ceiling (top half embedded)
    s.add_sphere(
        (0, 2 * half, 0),
        1.0,
        Material(albedo=(0, 0, 0), emission_color=(1.0, 0.9, 0.7),
                 emission_power=5.0),
    )
    # two diffuse spheres inside the box
    s.add_sphere((-1.0, 0.8, -0.8), 0.8, Material(albedo=(0.8, 0.7, 0.2)))
    s.add_sphere((1.1, 0.6, 0.6), 0.6, Material(albedo=(0.2, 0.4, 0.8)))
    return s


def cornell_materials() -> HostScene:
    """BASELINE configs 3/4 material coverage: glossy, mirror, dielectric,
    emissive in the Cornell sphere box."""
    s = cornell_spheres()
    # replace the two interior spheres' roles and add specular ones
    s.add_sphere((0.0, 0.5, 1.2), 0.5,
                 Material(albedo=(0.95, 0.95, 0.95), material_type=-1.0))
    s.add_sphere((-0.2, 0.45, 0.1), 0.45,
                 Material(albedo=(1.0, 1.0, 1.0), material_type=1.5))
    s.add_sphere((1.6, 0.4, -1.2), 0.4,
                 Material(albedo=(0.9, 0.6, 0.2), material_type=-1.0, fuzz=0.3))
    return s


def sky_only() -> HostScene:
    """A scene whose only radiance is the sky gradient: a single non-emissive
    sphere far behind the camera. Used for the analytic-sky statistical test."""
    s = HostScene()
    s.add_sphere((0, 0, 1e6), 1.0, WHITE)
    return s


def furnace(albedo: float = 1.0) -> HostScene:
    """Furnace test: an albedo-`albedo` sphere inside a uniform emissive
    environment sphere. For albedo=1 the render must equal the environment
    radiance exactly (SURVEY.md §4.3)."""
    s = HostScene()
    s.add_sphere((0, 0, -3), 1.0, Material(albedo=(albedo,) * 3))
    # enclosing emissive sphere, viewed from inside; emission 1, no sky reachable
    s.add_sphere(
        (0, 0, 0), 100.0,
        Material(albedo=(0, 0, 0), emission_color=(1, 1, 1), emission_power=1.0),
    )
    return s


def reference_default(bunny_path: str | None = None) -> HostScene:
    """The reference's shipped scene (`MetalCpp Path Tracer/scene.xml:1-23`):
    ground sphere r=10000, floating sphere r=40 at y=100, emissive sphere r=10
    at y=20, and (if `bunny_path` given) the bunny mesh at (-25,0,0) scale 10."""
    s = HostScene()
    grey = Material(albedo=(0.8, 0.8, 0.8))
    s.add_sphere((0, -10000, 0), 10000.0, grey)
    s.add_sphere((0, 100, 0), 40.0, grey)
    s.add_sphere(
        (0, 20, 0), 10.0,
        Material(albedo=(0, 0, 0), emission_color=(1.0, 0.9, 0.7),
                 emission_power=5.0),
    )
    if bunny_path is not None:
        from metalpathtracer_torch.scene.obj_loader import load_obj

        verts, faces = load_obj(bunny_path)
        s.add_mesh(verts, faces, position=(-25, 0, 0), scale=10.0,
                   material=Material(albedo=(0.9, 0.5, 0.3)))
    return s


def cornell_mesh(subdivisions: int = 2) -> HostScene:
    """Cornell sphere box + a triangulated icosphere mesh: the smallest
    preset whose `num_tris > 0`, so the triangle kernels actually run."""
    from metalpathtracer_torch.scene.procgen import icosphere

    s = cornell_spheres()
    verts, faces = icosphere(subdivisions=subdivisions, radius=0.7)
    s.add_mesh(verts, faces, position=(0.2, 1.6, -1.0), scale=1.0,
               material=Material(albedo=(0.85, 0.55, 0.25)))
    return s


def reference_bunny70k(bunny_path: str | None = None) -> HostScene:
    """BASELINE config 3 at its stated scale: the reference scene with the
    bunny midpoint-subdivided twice (4,968 -> 79,488 tris; same surface).
    311 tiles of 256 triangles in the closest-hit tables."""
    import os

    from metalpathtracer_torch.scene.obj_loader import load_obj
    from metalpathtracer_torch.scene.procgen import subdivide

    if bunny_path is None:
        bunny_path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "assets", "bunny.obj",
        )
    s = reference_default()
    verts, faces = load_obj(bunny_path)
    verts, faces = subdivide(verts, faces, levels=2)
    # glossy metal (BASELINE config 3: "glossy+specular"); the base scene
    # carries the specular/diffuse sphere mix
    s.add_mesh(verts, faces, position=(-25, 0, 0), scale=10.0,
               material=Material(albedo=(0.9, 0.5, 0.3),
                                 material_type=1.0, fuzz=0.15))
    return s


def reference_bunny300k(bunny_path: str | None = None) -> HostScene:
    """The reference scene with the bunny midpoint-subdivided three times
    (4,968 -> 317,952 tris): a coherent mesh of 1,242 tiles of 256 whose
    weight slab (20 MB) no longer fits a small cache (the only other scene
    of that scale is the incoherent random_tri_cloud, on which every
    subgroup passes nearly every tile by construction)."""
    import os

    from metalpathtracer_torch.scene.obj_loader import load_obj
    from metalpathtracer_torch.scene.procgen import subdivide

    if bunny_path is None:
        bunny_path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "assets", "bunny.obj",
        )
    s = reference_default()
    verts, faces = load_obj(bunny_path)
    verts, faces = subdivide(verts, faces, levels=3)
    s.add_mesh(verts, faces, position=(-25, 0, 0), scale=10.0,
               material=Material(albedo=(0.9, 0.5, 0.3),
                                 material_type=1.0, fuzz=0.15))
    return s


def random_tri_cloud(n_tris: int, seed: int = 0, extent: float = 10.0) -> HostScene:
    """Synthetic triangle soup for BVH scaling benchmarks."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n_tris, 3)).astype(np.float32)
    offs = rng.normal(0, 0.15, (n_tris, 2, 3)).astype(np.float32)
    s = HostScene()
    m = Material(albedo=(0.7, 0.7, 0.7))
    for i in range(n_tris):
        v0 = centers[i]
        s.add_triangle(v0, v0 + offs[i, 0], v0 + offs[i, 1], m)
    return s
