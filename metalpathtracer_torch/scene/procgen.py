"""Procedural mesh generation + OBJ writing.

The reference ships exactly one mesh (the bunny). Tests and the BASELINE
benchmark configs need meshes at controlled scales; these generators write
standard OBJ files consumable by `scene.obj_loader` (or any other tool).
"""

from __future__ import annotations

import numpy as np


def cube(size: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Axis-aligned cube centered at origin: (8, 3) verts, (12, 3) tris."""
    s = size * 0.5
    v = np.array(
        [
            [-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
            [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
        ],
        np.float32,
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # -z
            [4, 5, 6], [4, 6, 7],  # +z
            [0, 1, 5], [0, 5, 4],  # -y
            [3, 7, 6], [3, 6, 2],  # +y
            [0, 4, 7], [0, 7, 3],  # -x
            [1, 2, 6], [1, 6, 5],  # +x
        ],
        np.int32,
    )
    return v, f


def icosphere(subdivisions: int = 2, radius: float = 1.0):
    """Geodesic sphere: 20*4^n triangles (n=2 → 320, n=4 → 5120)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts = [v / np.linalg.norm(v) for v in verts]
    cache: dict = {}

    def midpoint(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = verts[a] + verts[b]
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(m)
        return cache[key]

    tris = [tuple(f) for f in faces]
    for _ in range(subdivisions):
        nxt = []
        for a, b, c in tris:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        tris = nxt
    v = (np.asarray(verts) * radius).astype(np.float32)
    f = np.asarray(tris, np.int32)
    return v, f


def subdivide(vertices: np.ndarray, faces: np.ndarray, levels: int = 1):
    """Midpoint 1:4 triangle subdivision (no smoothing — the surface is
    unchanged; triangle count x4 per level). Used to build bunny-scale
    benchmark meshes from the reference's 4,968-tri decimated bunny
    (BASELINE config 3 names ~70k tris: two levels -> 79,488)."""
    verts = [np.asarray(v, np.float64) for v in vertices]
    tris = [tuple(int(i) for i in f) for f in faces]
    for _ in range(levels):
        cache: dict = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                cache[key] = len(verts)
                verts.append((verts[a] + verts[b]) * 0.5)
            return cache[key]

        nxt = []
        for a, b, c in tris:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        tris = nxt
    return (np.asarray(verts, np.float32),
            np.asarray(tris, np.int32))


def plane(size: float = 1.0, divisions: int = 1):
    """XZ-plane grid at y=0 with 2*divisions^2 triangles."""
    n = divisions + 1
    xs = np.linspace(-size / 2, size / 2, n, dtype=np.float32)
    vx, vz = np.meshgrid(xs, xs, indexing="ij")
    v = np.stack([vx.ravel(), np.zeros(n * n, np.float32), vz.ravel()], axis=1)
    faces = []
    for i in range(divisions):
        for j in range(divisions):
            a = i * n + j
            b = a + 1
            c = a + n
            d = c + 1
            faces += [(a, d, b), (a, c, d)]
    return v, np.asarray(faces, np.int32)


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
              comment: str = "generated by metalpathtracer_torch") -> None:
    with open(path, "w") as f:
        f.write(f"# {comment}\n")
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
