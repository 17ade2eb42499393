"""The port's camera and primary rays against the JAX reference.

`viewport_basis` and `pipeline.generate_rays` run the same float32 ops in
the same order on both sides. tan, sqrt and XLA's fused cross product may
round differently from torch's, so the tolerances are:
- camera fields: bit-equal (the same numpy math builds both);
- `viewport_basis`: within 1 ulp of each vector's largest component (a
  component that should be 0 may come out as +-1e-10 from XLA's fused
  cross product, which no elementwise ulp bound can absorb);
- `generate_rays` given the same basis: within 1 ulp of each ray's largest
  component;
- `generate_rays` end to end: the direction is `first_pixel - origin + ...`,
  so a 1-ulp difference in the basis comes back as up to an ulp of the
  camera position's magnitude: within 4 ulp of max|position|.
The port's jitter comes from the same threefry words (test_torch_rng.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.core import rng as trng
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import pipeline as tpipe
from metalpathtracer_tpu.core import rng as jrng
from metalpathtracer_tpu.render import camera as jcam
from metalpathtracer_tpu.render import pipeline as jpipe

CAMERAS = {
    "reset": lambda m: m.Camera.reset(),
    "look_at": lambda m: m.Camera.look_at((3.0, 4.0, 12.0), (0.0, 1.0, 0.0),
                                          vfov_deg=45.0),
    "look_at_down": lambda m: m.Camera.look_at((0.0, 5.0, 0.0), (2.0, 0.0, -4.0),
                                               vfov_deg=50.0),
}
SIZES = [(32, 32), (64, 36), (17, 29)]


def _assert_vec_ulp(got, want, maxulp=1):
    """|got - want| <= maxulp ulps of each vector's largest component."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.spacing(np.abs(want).max(axis=-1, keepdims=True))
    err = np.abs(got - want) / scale
    assert (err <= maxulp).all(), f"max {err.max()} ulp"


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_fields_equal(name):
    j = CAMERAS[name](jcam)
    t = CAMERAS[name](tcam)
    for field in ("position", "forward", "up", "vfov_deg"):
        got = getattr(t, field)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j, field)))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_viewport_basis_within_one_ulp(name, size):
    w, h = size
    jb = jcam.viewport_basis(CAMERAS[name](jcam), w, h)
    tb = tcam.viewport_basis(CAMERAS[name](tcam), w, h)
    for jv, tv in zip(jb, tb):
        _assert_vec_ulp(tv.numpy(), jv)


def _rays(name, w, h):
    seed = 7
    n = w * h
    jo, jd = jpipe.generate_rays(
        CAMERAS[name](jcam), w, h, jnp.arange(n, dtype=jnp.uint32),
        jnp.uint32(3), jrng.seed_from_int(seed),
    )
    to, td = tpipe.generate_rays(
        CAMERAS[name](tcam), w, h, torch.arange(n, dtype=torch.int64), 3,
        trng.seed_from_int(seed),
    )
    return (np.asarray(jo), np.asarray(jd)), (to.numpy(), td.numpy())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_generate_rays_same_basis_within_one_ulp(name, size, monkeypatch):
    # hand the port the JAX basis: what is left is generate_rays' own math
    w, h = size
    basis = [torch.as_tensor(np.array(v))
             for v in jcam.viewport_basis(CAMERAS[name](jcam), w, h)]
    # `camera_basis` (render/camera.py) looks the basis up on its module
    monkeypatch.setattr(tcam, "viewport_basis", lambda cam, w_, h_: basis)
    (jo, jd), (to, td) = _rays(name, w, h)
    np.testing.assert_array_equal(to, jo)
    _assert_vec_ulp(td, jd)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_generate_rays_end_to_end(name, size):
    w, h = size
    (jo, jd), (to, td) = _rays(name, w, h)
    np.testing.assert_array_equal(to, jo)
    pos = np.abs(np.asarray(CAMERAS[name](jcam).position)).max()
    np.testing.assert_allclose(td, jd, rtol=0,
                               atol=4 * float(np.spacing(np.float32(pos))))
