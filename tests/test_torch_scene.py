"""The port's copy of the host scene layer (`metalpathtracer_torch.scene`)
against the reference's (`metalpathtracer_tpu.scene`).

Both are plain numpy and the same code, so every packed array must be
bit-equal with its dtype, and a malformed scene or mesh must raise the same
error type with the same message on both sides.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from metalpathtracer_torch import scene as tscene
from metalpathtracer_tpu import scene as jscene
from metalpathtracer_tpu.scene import presets as jpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML_SCENES = sorted(os.path.basename(p)
                    for p in glob.glob(os.path.join(REPO, "scenes", "*.xml")))
PRESETS = ["cornell_spheres", "cornell_materials", "cornell_mesh",
           "reference_default", "reference_bunny70k"]


def _assert_packed_equal(mine, theirs):
    assert type(mine).__name__ == type(theirs).__name__ == "PackedScene"
    for f in dataclasses.fields(theirs):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    for a, b in zip(mine.aabbs(), theirs.aabbs()):
        np.testing.assert_array_equal(a, b)


def test_every_shipped_scene_is_compared():
    assert "reference.xml" in XML_SCENES and len(XML_SCENES) >= 5


@pytest.mark.parametrize("name", XML_SCENES)
def test_xml_scene_packs_equal(name):
    path = os.path.join(REPO, "scenes", name)
    mine = tscene.load_scene_xml(path)
    theirs = jscene.load_scene_xml(path)
    assert isinstance(mine, tscene.HostScene)
    assert mine.primitive_count == theirs.primitive_count
    _assert_packed_equal(mine.pack(), theirs.pack())


@pytest.mark.parametrize("name", PRESETS)
def test_preset_packs_equal(name):
    mine = getattr(tscene.presets, name)()
    theirs = getattr(jpresets, name)()
    assert mine.triangle_count == theirs.triangle_count
    _assert_packed_equal(mine.pack(), theirs.pack())


def test_reference_default_finds_the_bunny_by_path():
    bunny = os.path.join(REPO, "assets", "bunny.obj")
    mine = tscene.presets.reference_default(bunny)
    assert mine.triangle_count == 4968
    _assert_packed_equal(mine.pack(), jpresets.reference_default(bunny).pack())


OBJ_CASES = {
    "missing": None,
    "index_out_of_range": "v 0 0 0\nf 1 2 9\n",
    "bad_index": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 x 3\n",
    "index_zero": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 0 1 2\n",
    "short_vertex": "v 0 0\n",
    "short_face": "v 0 0 0\nv 1 0 0\nf 1 2\n",
}

XML_CASES = {
    "missing": None,
    "not_a_scene": "<NotAScene/>",
    "truncated": "<Scene><Sphere",
    "mesh_without_file": "<Scene><Mesh position='0,0,0'/></Scene>",
    "mesh_file_missing": "<Scene><Mesh file='nowhere.obj'/></Scene>",
    "mesh_file_malformed": "<Scene><Mesh file='bad.obj'/></Scene>",
}


def _raised(fn, path):
    with pytest.raises(ValueError) as e:
        fn(path)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("case", sorted(OBJ_CASES))
def test_malformed_obj_raises_the_same(tmp_path, case):
    path = tmp_path / "m.obj"
    if OBJ_CASES[case] is not None:
        path.write_text(OBJ_CASES[case])
    mine = _raised(tscene.load_obj, str(path))
    assert mine == _raised(jscene.load_obj, str(path))
    assert mine[0] == "ObjError"


@pytest.mark.parametrize("case", sorted(XML_CASES))
def test_malformed_xml_raises_the_same(tmp_path, case):
    (tmp_path / "bad.obj").write_text("v 0 0 0\nf 1 2 3\n")
    path = tmp_path / "s.xml"
    if XML_CASES[case] is not None:
        path.write_text(XML_CASES[case])
    mine = _raised(tscene.load_scene_xml, str(path))
    assert mine == _raised(jscene.load_scene_xml, str(path))
    assert mine[0] in ("SceneParseError", "ObjError")


def test_empty_scene_does_not_pack():
    with pytest.raises(ValueError, match="empty scene"):
        tscene.HostScene().pack()
    with pytest.raises(ValueError, match="empty scene"):
        jscene.HostScene().pack()
