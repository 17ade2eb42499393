"""Statistical tests of the port's estimators on the CPU: next-event
estimation with MIS, and Russian roulette, against the naive estimator of
the same integral.

The port's counterparts of tests/test_render.py's statistical tests, at
the reference's scenes, sizes, sample counts, seeds and thresholds: two
estimators of one integral must agree in the mean within the stated
relative error (0.05, 0.08 or 0.15, per test as in the reference). The
port draws the reference's threefry words, so each mean is the reference's
up to float rounding. The MIS counterweight must return the sampler's own
density: rtol 2e-4, the reference's bound.
"""

import numpy as np
import pytest
import torch

from metalpathtracer_torch.render.camera import Camera
from metalpathtracer_torch.render.device_scene import upload_scene
from metalpathtracer_torch.render.integrator import (
    RenderConfig,
    _light_pdf_toward,
    _sample_light,
)
from metalpathtracer_torch.render.pipeline import render_image
from metalpathtracer_torch.scene import HostScene, Material, presets

torch.set_num_threads(1)

CORNELL_CAM = Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


def _means_agree(scene, cam, size, naive, other, bound):
    """Relative difference of the image means of two renders, each given as
    (spp, seed, RenderConfig, spp_per_pass)."""
    means = []
    for spp, seed, cfg, per_pass in (naive, other):
        img, _ = render_image(scene, cam, size, size, spp=spp, seed=seed, cfg=cfg,
                              spp_per_pass=per_pass)
        assert torch.isfinite(img).all()
        means.append(float(img.mean()))
    m0, m1 = means
    assert abs(m0 - m1) / m0 < bound, (m0, m1)


def test_nee_matches_naive_mean():
    # NEE is another estimator of the same integral: the means must agree
    scene = upload_scene(presets.cornell_spheres(), "cpu")
    _means_agree(scene, CORNELL_CAM, 24,
                 (64, 21, RenderConfig(), None),
                 (16, 22, RenderConfig(nee=True, max_depth=16), None), 0.05)


def test_rr_unbiased_mean():
    scene = upload_scene(presets.cornell_spheres(), "cpu")
    _means_agree(scene, CORNELL_CAM, 24,
                 (48, 31, RenderConfig(), None),
                 (48, 32, RenderConfig(rr_start=3), None), 0.15)


def test_nee_second_emitter_not_lost():
    # NEE samples the light table; a second, dimmer emitter must still
    # contribute, through the table or the BSDF route
    s = HostScene()
    s.add_sphere((0, -10000, 0), 10000.0, Material(albedo=(0.8, 0.8, 0.8)))
    s.add_sphere((-2, 4, 0), 1.0, Material(albedo=(0, 0, 0),
                 emission_color=(1, 1, 1), emission_power=5))
    s.add_sphere((2, 4, 0), 1.0, Material(albedo=(0, 0, 0),
                 emission_color=(1, 1, 1), emission_power=4))
    s.add_sphere((0, 0, 0), 50.0, Material(albedo=(0, 0, 0)))
    cam = Camera.look_at((0, 3, 8), (0, 0, 0), vfov_deg=50.0)
    _means_agree(upload_scene(s, "cpu"), cam, 24,
                 (512, 1, RenderConfig(max_depth=2), 128),
                 (256, 2, RenderConfig(max_depth=2, nee=True), 128), 0.08)


def test_nee_unbiased_horizon_straddling_light():
    # a half-buried emissive sphere straddles the horizon of nearby ground
    # points: cone samples below the surface are legitimate zero-valued NEE
    # draws, so the BSDF route stays suppressed for them
    s = HostScene()
    s.add_sphere((0, -10000, 0), 10000.0, Material(albedo=(0.75, 0.75, 0.75)))
    s.add_sphere((0, 0.0, -2.0), 1.5,
                 Material(albedo=(0, 0, 0), emission_color=(1.0, 0.9, 0.8),
                          emission_power=4.0))
    cam = Camera.look_at((0, 1.5, 6.0), (0, 0.5, -2.0), vfov_deg=45.0)
    _means_agree(upload_scene(s, "cpu"), cam, 16,
                 (96, 11, RenderConfig(max_depth=8), None),
                 (96, 12, RenderConfig(max_depth=8, nee=True), None), 0.05)


def test_nee_mis_mesh_light_matches_naive():
    # an emissive quad (a mesh light of two triangles) and an emissive
    # sphere: the light table and MIS stay unbiased against the naive
    # estimator where an area light cannot be cone-sampled
    s = HostScene()
    s.add_sphere((0, -10000, 0), 10000.0, Material(albedo=(0.7, 0.7, 0.7)))
    quad = Material(albedo=(0, 0, 0), emission_color=(1.0, 0.9, 0.8),
                    emission_power=6)
    s.add_triangle((-2, 4, -2), (2, 4, -2), (2, 4, 2), quad)
    s.add_triangle((-2, 4, -2), (2, 4, 2), (-2, 4, 2), quad)
    s.add_sphere((4, 2, 0), 0.7, Material(albedo=(0, 0, 0),
                 emission_color=(0.5, 0.7, 1.0), emission_power=3))
    s.add_sphere((0, 0, 0), 50.0, Material(albedo=(0, 0, 0)))  # enclosure
    scene = upload_scene(s, "cpu")
    assert scene.num_lights == 3
    cam = Camera.look_at((0, 3, 8), (0, 0.5, 0), vfov_deg=55.0)
    _means_agree(scene, cam, 24,
                 (512, 1, RenderConfig(max_depth=3), 128),
                 (192, 2, RenderConfig(max_depth=3, nee=True), 64), 0.08)


def test_nee_glossy_matches_naive_mean():
    # glossy lobes run NEE + MIS too: on the materials scene (glossy, mirror,
    # dielectric, emissive) the means agree with the naive estimator
    scene = upload_scene(presets.cornell_materials(), "cpu")
    _means_agree(scene, CORNELL_CAM, 24,
                 (96, 41, RenderConfig(max_depth=8), None),
                 (48, 42, RenderConfig(max_depth=8, nee=True), None), 0.05)


@pytest.fixture(scope="module")
def two_lights():
    """A sphere light and a triangle light, well apart."""
    s = HostScene()
    s.add_sphere((0, 10, 0), 2.0, Material(albedo=(0, 0, 0),
                 emission_color=(1, 1, 1), emission_power=5))
    s.add_triangle((8, -1, -1), (8, 1, -1), (8, 0, 1.5),
                   Material(albedo=(0, 0, 0), emission_color=(1, 1, 1),
                            emission_power=5))
    scene = upload_scene(s, "cpu")
    assert scene.num_lights == 2
    return scene


def _uniforms(seed, n):
    key = np.random.default_rng(seed)
    return [torch.as_tensor(key.random(n).astype(np.float32)) for _ in range(3)]


def test_mis_counterweight_matches_sampler_density(two_lights):
    # `_light_pdf_toward` must return the density `_sample_light` drew the
    # direction with: a mismatch biases every power-heuristic weight
    n = 4096
    point = torch.zeros((n, 3))
    ldir, ldist, _, pdf_fwd, lprim, valid = _sample_light(
        two_lights, point, *_uniforms(5, n))
    pdf_rev = _light_pdf_toward(two_lights, point, ldir, ldist, lprim)
    v = valid.numpy()
    assert v.sum() > n * 0.95
    np.testing.assert_allclose(pdf_rev.numpy()[v], pdf_fwd.numpy()[v], rtol=2e-4)


def test_light_sampler_pdf_integrates_to_solid_angle(two_lights):
    # for draws from one light, E[1 / pdf_sa] is the solid angle it subtends:
    # the cone sampler's in closed form, the triangle sampler's against a
    # uniform-area Monte Carlo reference; within 8%, the reference's bound
    n = 20000
    _, _, _, pdf, lprim, valid = _sample_light(
        two_lights, torch.zeros((n, 3)), *_uniforms(3, n))
    pdf, lprim, valid = pdf.numpy(), lprim.numpy(), valid.numpy()
    pick_p = two_lights.light_pick_p.numpy()[:2]
    prim_of = two_lights.light_prim.numpy()[:2]
    for row in range(2):
        sel = valid & (lprim == prim_of[row])
        assert sel.sum() > 500
        omega = np.mean(pick_p[row] / pdf[sel])
        if int(two_lights.light_kind[row]) == 0:  # sphere: the cone
            expect = 2 * np.pi * (1 - np.sqrt(1 - (2.0 / 10.0) ** 2))
        else:
            v0, e1, e2 = np.array([8, -1, -1.0]), np.array([0, 2, 0.0]), np.array([0, 1, 2.5])
            a = np.random.default_rng(11).random((200000, 2))
            su = np.sqrt(a[:, 0])
            pts = v0 + (1 - su)[:, None] * e1 + (a[:, 1] * su)[:, None] * e2
            nrm = np.cross(e1, e2)
            area = np.linalg.norm(nrm) / 2
            dist = np.linalg.norm(pts, axis=1)
            cosl = np.abs(pts @ (nrm / np.linalg.norm(nrm))) / dist
            expect = float(np.mean(cosl / dist**2) * area)
        assert abs(omega - expect) / expect < 0.08, (row, omega, expect)
