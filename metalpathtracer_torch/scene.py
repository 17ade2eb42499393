"""The host scene layer: scene model, XML/OBJ loaders and presets.

It is plain numpy and shared with the JAX package as it is
(`metalpathtracer_tpu.scene`), so the two packages cannot drift apart on
what a scene is; importing it loads no jax. The port reaches it only
through this module.
"""

from metalpathtracer_tpu.scene import (
    PRIM_NONE,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    HostScene,
    Material,
    ObjError,
    PackedScene,
    SceneParseError,
    load_obj,
    load_scene_xml,
    presets,
)

__all__ = [
    "HostScene",
    "Material",
    "PackedScene",
    "PRIM_SPHERE",
    "PRIM_TRIANGLE",
    "PRIM_NONE",
    "load_obj",
    "ObjError",
    "load_scene_xml",
    "SceneParseError",
    "presets",
]
