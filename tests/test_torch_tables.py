"""The port's intersection tables and scene upload against the JAX reference.

`build_weights` is the same numpy on both sides, so every table must be
bit-equal: the kd partition (`tri_ids`), the refine rows, the tile boxes
and the sphere SoA. The weight slab differs in layout and type: the port
keeps a compact f32 (n_tiles, tile_p, 16) row per triangle, the reference a
dense bf16 hi/lo split (n_tiles, 64, 4*tile_p) that works around Mosaic's
matmul precision. Expanding the port's slab to the dense weights
(`expand_slab`) must give the dense formula bit for bit, and splitting that
the reference's way must give the reference's bits.
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
from metalpathtracer_torch import scene as tscene
from metalpathtracer_tpu import scene as jscene
from metalpathtracer_tpu.scene import presets as jpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each scene from a package's scene module and its presets module
SCENES = {
    "reference": lambda m, p: m.load_scene_xml(
        os.path.join(REPO, "scenes", "reference.xml")),
    "cornell_mesh": lambda m, p: p.cornell_mesh(),
    "cornell_spheres": lambda m, p: p.cornell_spheres(),  # no triangles
}


def _port_scene(name):
    return SCENES[name](tscene, tscene.presets)


def _jax_scene(name):
    return SCENES[name](jscene, jpresets)


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    packed = _port_scene(request.param).pack()
    args = (packed.prim_type, packed.p0, packed.p1, packed.p2)
    return request.param, packed, tmm.build_weights(*args), jmm.build_weights(*args)


def _dense(w) -> np.ndarray:
    """The port's compact slab expanded to (nt, tile_p, 4, 12)."""
    return tmm.expand_slab(torch.as_tensor(w)).numpy()


def _dense_formula(packed, tri_ids, tile_p) -> np.ndarray:
    """The dense weights of the triangles in column order, straight from the
    formula (rows [wa, wu, wv, wt] over [d, o x d, o, o.d, |o|^2, 1])."""
    real = tri_ids[tri_ids >= 0]
    v0, v1, v2 = packed.p0[real], packed.p1[real], packed.p2[real]
    e1, e2 = v1 - v0, v2 - v0
    n = np.cross(e1, e2)
    t = len(real)
    z1, z3 = np.zeros((t, 1), np.float32), np.zeros((t, 3), np.float32)
    wa = np.concatenate([-n, z3, z3, z1, z1, z1], axis=1)
    wu = np.concatenate([-np.cross(e2, v0), e2, z3, z1, z1, z1], axis=1)
    wv = np.concatenate([-np.cross(v0, e1), -e1, z3, z1, z1, z1], axis=1)
    wt = np.concatenate([z3, z3, n, z1, z1, -np.sum(v0 * n, 1, keepdims=True)],
                        axis=1)
    w = np.zeros((len(tri_ids), 4, tmm.NUM_FEATURES), np.float32)
    w[:t] = np.stack([wa, wu, wv, wt], axis=1)
    return w.reshape(-1, tile_p, 4, tmm.NUM_FEATURES)


def test_tables_bit_equal(case):
    _, _, t, j = case
    assert t["n_tris"] == j["n_tris"]
    for key in ("tri_ids", "tri_refine", "tile_box", "sph_center", "sph_radius",
                "sph_ids"):
        assert t[key].dtype == j[key].dtype, key
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def test_reference_scene_has_39_tiles_of_128():
    packed = _port_scene("reference").pack()
    t = tmm.build_weights(packed.prim_type, packed.p0, packed.p1, packed.p2)
    assert t["w"].shape == (39, 128, tmm.SLAB_FLOATS)
    assert t["w"].dtype == np.float32
    assert t["n_tris"] == 4968


def test_expanded_slab_is_the_dense_formula(case):
    _, packed, t, _ = case
    w = t["w"]
    dense = _dense(w)
    assert dense.shape == (*w.shape[:2], 4, tmm.NUM_FEATURES)
    formula = _dense_formula(packed, t["tri_ids"], w.shape[1])
    # bit for bit on the triangles (negation is exact, -0 included); the
    # padding columns are zero in value
    k = t["n_tris"]
    flat, flat_f = dense.reshape(-1, 4, 12), formula.reshape(-1, 4, 12)
    np.testing.assert_array_equal(flat[:k].view(np.uint32), flat_f[:k].view(np.uint32))
    assert not flat[k:].any() and not flat_f[k:].any()
    # features o.d and |o|^2 have no weight anywhere
    assert not dense[..., 9:11].any()


def test_slab_hi_lo_split_matches_reference_pack(case):
    _, _, t, j = case
    w = _dense(t["w"])  # (nt, tile_p, 4, 12) f32, through the expansion
    # padding columns: the expansion's -0 are the reference's +0
    w.reshape(-1, 4, tmm.NUM_FEATURES)[t["n_tris"]:] = 0.0
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
    flat = t["w"].reshape(-1, tmm.SLAB_FLOATS)
    assert not flat[t["n_tris"]:].any()
    assert not _dense(t["w"]).reshape(-1, 4, tmm.NUM_FEATURES)[t["n_tris"]:].any()
    assert (t["tri_ids"][t["n_tris"]:] == -1).all()


def _jax_arrays(js) -> dict:
    out = {}
    for f in dataclasses.fields(js):
        v = getattr(js, f.name)
        out[f.name] = v if isinstance(v, int) else np.asarray(v)
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_jax_equals_upload_scene(name):
    mine = upload_scene(_port_scene(name), "cpu", bvh=True)
    theirs = scene_from_jax(_jax_arrays(j_upload(_jax_scene(name))), "cpu")
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert mine.mm_w.dtype == torch.float32
    assert mine.mm_w.shape[2] == tmm.SLAB_FLOATS
    assert mine.device == torch.device("cpu")
