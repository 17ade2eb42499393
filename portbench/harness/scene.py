"""The benchmark's own scene input: a configuration's scene as plain arrays.

A configuration file (`portbench/configs/<name>.json`) states its scene as
spheres and meshes; a mesh names an OBJ file under `portbench/assets/`, its
placement (`position + scale * vertex`, in float32 as the source bakes it)
and how many times it is midpoint-subdivided (1:4, in float64, then cast to
float32). The arrays made here are handed to both sides: the program gets
them through its own scene types (`harness/program.py`), the plain reference
builds its geometry from them (`harness/reference.py`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

SPHERE, TRIANGLE = 0, 1


@dataclasses.dataclass
class SceneArrays:
    """One row a primitive: type (0 sphere, 1 triangle), p0 (center / v0),
    p1 ([radius, 0, 0] / v1), p2 (zeros / v2) and the material's fields."""

    kind: np.ndarray  # int32 (P,)
    p0: np.ndarray  # float32 (P, 3)
    p1: np.ndarray
    p2: np.ndarray
    albedo: np.ndarray  # float32 (P, 3)
    material_type: np.ndarray  # float32 (P,)
    emission: np.ndarray  # float32 (P, 3)
    power: np.ndarray  # float32 (P,)
    fuzz: np.ndarray  # float32 (P,)

    @property
    def n_triangles(self) -> int:
        return int((self.kind == TRIANGLE).sum())


def load_obj(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """Vertex positions (float32 (V, 3)) and fan-triangulated faces
    (int64 (F, 3), 0-based) of an OBJ file; other statements are skipped."""
    verts, faces = [], []
    for line in Path(path).read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = []
            for tok in parts[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            faces.extend((idx[0], idx[i], idx[i + 1]) for i in range(1, len(idx) - 1))
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError(f"{path}: face index out of range")
    return v, f


def subdivide(tris: np.ndarray, levels: int) -> np.ndarray:
    """Midpoint 1:4 subdivision of float64 triangles (F, 3, 3), each face
    followed by its four children in the order (a, ab, ca), (ab, b, bc),
    (ca, bc, c), (ab, bc, ca)."""
    for _ in range(levels):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) * 0.5, (b + c) * 0.5, (c + a) * 0.5
        kids = np.stack([np.stack(k, 1) for k in (
            (a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))], 1)
        tris = kids.reshape(-1, 3, 3)
    return tris


def _material(m: dict):
    return (np.asarray(m.get("albedo", (0.8, 0.8, 0.8)), np.float32),
            np.float32(m.get("material_type", 0.0)),
            np.asarray(m.get("emission", (0.0, 0.0, 0.0)), np.float32),
            np.float32(m.get("power", 0.0)), np.float32(m.get("fuzz", 0.0)))


def build(scene: dict, root: Path) -> SceneArrays:
    """The arrays of a configuration's `scene` (spheres first, then each
    mesh's triangles, in the file's order); `root` is the benchmark's
    folder, which mesh files are relative to."""
    rows = []  # (kind, p0, p1, p2, material) blocks
    for s in scene.get("spheres", []):
        p0 = np.asarray(s["center"], np.float32)[None]
        p1 = np.asarray([[s["radius"], 0.0, 0.0]], np.float32)
        rows.append((SPHERE, p0, p1, np.zeros((1, 3), np.float32), _material(s)))
    for m in scene.get("meshes", []):
        v, f = load_obj(root / m["file"])
        tris = subdivide(v.astype(np.float64)[f], int(m.get("subdivide", 0)))
        tris = tris.astype(np.float32)
        world = (np.asarray(m["position"], np.float32)
                 + np.float32(m.get("scale", 1.0)) * tris)
        rows.append((TRIANGLE, world[:, 0], world[:, 1], world[:, 2], _material(m)))
    n = [r[1].shape[0] for r in rows]

    def cat(i):
        return np.concatenate([r[i] for r in rows]).astype(np.float32)

    def mat(j, shape):
        return np.concatenate([np.broadcast_to(r[4][j], (k, *shape))
                               for r, k in zip(rows, n)]).astype(np.float32)

    return SceneArrays(
        kind=np.concatenate([np.full(k, r[0], np.int32) for r, k in zip(rows, n)]),
        p0=cat(1), p1=cat(2), p2=cat(3),
        albedo=mat(0, (3,)), material_type=mat(1, ()), emission=mat(2, (3,)),
        power=mat(3, ()), fuzz=mat(4, ()))
