"""The port's intersection tables and scene upload against the JAX reference.

`build_weights` is the same numpy on both sides, so every table must be
bit-equal: the kd partition (`tri_ids`), the refine rows, the tile boxes
and the sphere SoA. The weight slab differs only in layout and type: the
port keeps f32 (n_tiles, tile_p, 4, 12); the reference keeps a bf16 hi/lo
split (n_tiles, 64, 4*tile_p) that works around Mosaic's matmul precision.
Splitting the port's slab the same way must give the reference's bits.
"""

import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from metalpathtracer_torch.render.device_scene import scene_from_jax, upload_scene
from metalpathtracer_torch.render.kernels import intersect_mm as tmm
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu.render.pallas import intersect_mm as jmm
from metalpathtracer_tpu.scene import load_scene_xml, presets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = {
    "reference": lambda: load_scene_xml(os.path.join(REPO, "scenes", "reference.xml")),
    "cornell_mesh": lambda: presets.cornell_mesh(),
    "cornell_spheres": lambda: presets.cornell_spheres(),  # no triangles
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    packed = SCENES[request.param]().pack()
    args = (packed.prim_type, packed.p0, packed.p1, packed.p2)
    return request.param, packed, tmm.build_weights(*args), jmm.build_weights(*args)


def test_tables_bit_equal(case):
    _, _, t, j = case
    assert t["n_tris"] == j["n_tris"]
    for key in ("tri_ids", "tri_refine", "tile_box", "sph_center", "sph_radius",
                "sph_ids"):
        assert t[key].dtype == j[key].dtype, key
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def test_reference_scene_has_39_tiles_of_128():
    packed = SCENES["reference"]().pack()
    t = tmm.build_weights(packed.prim_type, packed.p0, packed.p1, packed.p2)
    assert t["w"].shape == (39, 128, 4, tmm.NUM_FEATURES)
    assert t["n_tris"] == 4968


def test_slab_hi_lo_split_matches_reference_pack(case):
    _, _, t, j = case
    w = t["w"]  # (nt, tile_p, 4, 12) f32
    nt, tile_p = w.shape[:2]
    # the reference's layout: (nt, 16 features, [wa | wu | wv | wt] columns)
    w16 = np.zeros((nt, 16, 4 * tile_p), np.float32)
    w16[:, :12] = w.transpose(0, 3, 2, 1).reshape(nt, 12, 4 * tile_p)
    bf = ml_dtypes.bfloat16
    wh = w16.astype(bf)
    wl = (w16 - wh.astype(np.float32)).astype(bf)
    packed = np.concatenate([wh, wh, wl, wl], axis=1)  # (nt, 64, 4*tile_p)
    ref = j["w_all"]
    assert ref.dtype == bf and ref.shape == packed.shape
    np.testing.assert_array_equal(packed.view(np.uint16), ref.view(np.uint16))


def test_slab_columns_past_the_mesh_are_zero(case):
    _, _, t, _ = case
    flat = t["w"].reshape(-1, 4, tmm.NUM_FEATURES)
    assert not flat[t["n_tris"]:].any()
    assert (t["tri_ids"][t["n_tris"]:] == -1).all()


def _jax_arrays(js) -> dict:
    out = {}
    for f in dataclasses.fields(js):
        v = getattr(js, f.name)
        out[f.name] = v if isinstance(v, int) else np.asarray(v)
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_jax_equals_upload_scene(name):
    host = SCENES[name]()
    mine = upload_scene(host, "cpu")
    theirs = scene_from_jax(_jax_arrays(j_upload(host)), "cpu")
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert mine.mm_w.dtype == torch.float32
    assert mine.device == torch.device("cpu")
