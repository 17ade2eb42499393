"""Wavefront OBJ mesh loader (positions + triangulated faces).

Replaces the reference's vendored tiny_obj_loader as used by
`MetalCpp Path Tracer/Scene/SceneLoader.cpp:20-73`: only vertex positions and
face connectivity are consumed (no normals/uvs/materials). tiny_obj_loader
triangulates polygons by default, so we fan-triangulate n-gons to match the
triangle counts the reference prints at `SceneLoader.cpp:72`.
"""

from __future__ import annotations

import os

import numpy as np


class ObjError(ValueError):
    pass


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file.

    Returns `(vertices, faces)`: float32 (V, 3) positions and int32 (F, 3)
    triangle indices. Polygonal faces are fan-triangulated; other statements
    (vn/vt/usemtl/o/g/s/mtllib/...) are ignored.
    """
    if not os.path.exists(path):
        raise ObjError(f"OBJ file not found: {path}")

    verts: list = []
    faces: list = []
    with open(path, "r", errors="replace") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                if len(parts) < 4:
                    raise ObjError(f"{path}:{lineno}: malformed vertex: {line!r}")
                verts.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            elif tag == "f":
                if len(parts) < 4:
                    raise ObjError(f"{path}:{lineno}: face with <3 vertices")
                idx = [_parse_face_index(tok, len(verts), path, lineno)
                       for tok in parts[1:]]
                for i in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[i], idx[i + 1]))

    vertices = np.asarray(verts, np.float32).reshape(-1, 3)
    tri = np.asarray(faces, np.int32).reshape(-1, 3)
    if tri.size and (tri.min() < 0 or tri.max() >= len(vertices)):
        raise ObjError(f"{path}: face index out of range")
    return vertices, tri


def _parse_face_index(token: str, nverts: int, path: str, lineno: int) -> int:
    """OBJ face tokens are `v`, `v/vt`, `v//vn`, or `v/vt/vn`; indices are
    1-based, negative means relative-to-end."""
    s = token.split("/")[0]
    try:
        i = int(s)
    except ValueError as e:
        raise ObjError(f"{path}:{lineno}: bad face index {token!r}") from e
    if i > 0:
        return i - 1
    if i < 0:
        return nverts + i
    raise ObjError(f"{path}:{lineno}: face index 0 is invalid")
