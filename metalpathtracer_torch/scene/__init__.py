"""The host scene layer: scene model, XML/OBJ loaders and presets.

Plain numpy. It is the port's own copy of the reference's scene layer
(`metalpathtracer_tpu/scene/`), so the port imports nothing of the JAX
package; `tests/test_torch_scene.py` holds the two copies to equal packed
arrays and equal errors.
"""

from metalpathtracer_torch.scene import presets
from metalpathtracer_torch.scene.obj_loader import ObjError, load_obj
from metalpathtracer_torch.scene.types import (
    PRIM_NONE,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    HostScene,
    Material,
    PackedScene,
)
from metalpathtracer_torch.scene.xml_loader import SceneParseError, load_scene_xml

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
