"""scene.xml parser — the framework's public scene-description API.

Preserves the reference schema exactly (`MetalCpp Path Tracer/Scene/
SceneLoader.cpp:75-133`): a `<Scene>` root containing

    <Sphere position="x,y,z" radius="r" albedo="r,g,b"
            emission="r,g,b" materialType="t" emissionPower="p" />
    <Mesh file="path.obj" position="x,y,z" scale="s" albedo="r,g,b"
          emission="r,g,b" materialType="t" emissionPower="p" />

with the reference defaults (radius=1, scale=1, materialType=0,
emissionPower=0). Extensions: an optional `fuzz` attribute (glossy
roughness, default 0) and *relative* mesh paths resolved against the XML
file's directory — the reference hard-codes absolute paths
(SURVEY.md appendix 4), which we deliberately fix.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from metalpathtracer_torch.scene.obj_loader import load_obj
from metalpathtracer_torch.scene.types import HostScene, Material


class SceneParseError(ValueError):
    pass


def _parse_vec3(s, default=(0.0, 0.0, 0.0)):
    """Comma-separated triple, like the reference's `sscanf "%f,%f,%f"`
    (`SceneLoader.cpp:14-18`). Missing components default to 0."""
    if s is None:
        return tuple(default)
    parts = [p.strip() for p in s.split(",")]
    vals = []
    for p in parts[:3]:
        try:
            vals.append(float(p))
        except ValueError:
            vals.append(0.0)
    while len(vals) < 3:
        vals.append(0.0)
    return tuple(vals)


def _parse_float(s, default: float) -> float:
    if s is None:
        return default
    try:
        return float(s)
    except ValueError:
        return default


def _material_from(e: ET.Element) -> Material:
    return Material(
        albedo=_parse_vec3(e.get("albedo")),
        material_type=_parse_float(e.get("materialType"), 0.0),
        emission_color=_parse_vec3(e.get("emission")),
        emission_power=_parse_float(e.get("emissionPower"), 0.0),
        fuzz=_parse_float(e.get("fuzz"), 0.0),
    )


def load_scene_xml(path: str, scene: HostScene | None = None) -> HostScene:
    """Parse a scene.xml into a HostScene (reference
    `SceneLoader::LoadSceneFromXML`, `SceneLoader.cpp:75-133`)."""
    try:
        tree = ET.parse(path)
    except ET.ParseError as e:
        raise SceneParseError(f"failed to parse scene XML {path}: {e}") from e
    except OSError as e:
        raise SceneParseError(f"failed to load scene XML {path}: {e}") from e

    root = tree.getroot()
    if root.tag != "Scene":
        raise SceneParseError(f"{path}: expected <Scene> root, got <{root.tag}>")

    if scene is None:
        scene = HostScene()
    base_dir = os.path.dirname(os.path.abspath(path))

    for e in root:
        if e.tag == "Sphere":
            scene.add_sphere(
                center=_parse_vec3(e.get("position")),
                radius=_parse_float(e.get("radius"), 1.0),
                material=_material_from(e),
            )
        elif e.tag == "Mesh":
            file_attr = e.get("file")
            if not file_attr:
                raise SceneParseError(f"{path}: <Mesh> missing 'file' attribute")
            mesh_path = file_attr
            if not os.path.isabs(mesh_path):
                mesh_path = os.path.join(base_dir, mesh_path)
            verts, faces = load_obj(mesh_path)
            scene.add_mesh(
                verts,
                faces,
                position=_parse_vec3(e.get("position")),
                scale=_parse_float(e.get("scale"), 1.0),
                material=_material_from(e),
            )
        # unknown elements are ignored, like the reference's tag dispatch
    return scene
