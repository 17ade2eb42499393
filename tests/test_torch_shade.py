"""The bounce step's plain twins (the sphere pass and the closest hit's
epilogue, `render/kernels/intersect_mm.py`; the shading,
`render/kernels/shade.py::shade_reference`) against the JAX reference, and
the restructured bounce step against the plain step it replaced, on the
CPU.

On a CPU tensor each wrapper runs its twin; the CUDA kernels
(`csrc/sphere_pass.cu`, `hit_epilogue.cu`, `shade.cu`) are held bit-equal
to the same twins on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances:
- the sphere pass: the reference's `_sphere_hit_exact` runs its quadratic
  through XLA, which contracts b*b - a*c into an FMA, visible (~1e-4
  relative) on the r=10000 ground sphere: t at the closest hit's bound
  (rtol 5e-4, atol 1e-2, tests/test_intersect_mm.py's), prim ids, centers
  and material ids equal;
- the closest hit through the epilogue against the reference's
  `closest_hit_mm_full`: tests/test_torch_closest_hit.py's bound (t at
  rtol 5e-4, atol 1e-2; normals at atol 1e-5; ids, materials and front
  faces equal) but for the reference's documented edge flips (its bf16
  hi/lo split), at most 1% of lanes;
- one shading step after `_trace_rays` against the reference's
  `_bounce_step`: tests/test_torch_render.py's (atol 1e-4 on every float
  output; masks and ray counts equal) and its rtol 5e-4 on the new
  origins, taken of the hit distance t: a new origin is a hit point
  o + t d, and on the r=1e4 wall spheres the reference's FMA-contracted
  quadratic moves t by up to ~2.4e-4 relative, so the point moves along
  its ray by that share of t, ~1e-3 in a component near 0 (a point on the
  floor; the closest hit's bound, rtol 5e-4 on t, tests/test_intersect_mm.py);
- the restructured `_bounce_step` against the plain step before it
  (`_before_bounce_step` below, with `core/vecmath.py`'s dot products
  summed by `torch.sum` as they were): `torch.equal`, since the fixed
  order of the dot's adds is the CPU sum's own;
- `closest_hit_mm`, `surface_interaction`, `length` against the
  reference's: as the neighbouring tests (t at rtol 5e-4, atol 1e-2; the
  surface frame at rtol 1e-6, atol 1e-6; `length` at rtol 1e-6).
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.core import rng, vecmath as vm
from metalpathtracer_torch.render import bsdf
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render import intersect as ti
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.render.kernels import intersect_mm as tmm
from metalpathtracer_torch.render.kernels import shade as tsh
from metalpathtracer_torch.render.pipeline import generate_rays
from metalpathtracer_torch import scene as tscene
from metalpathtracer_torch.scene import presets, procgen
from metalpathtracer_tpu.core import rng as jrng
from metalpathtracer_tpu.core import vecmath as jvm
from metalpathtracer_tpu.render import integrator as jint
from metalpathtracer_tpu.render import intersect as ji
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu.render.pallas import intersect_mm as jmm
from metalpathtracer_tpu import scene as jscene
from metalpathtracer_tpu.scene import presets as jpresets
from metalpathtracer_tpu.scene import procgen as jprocgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MIN = 1e-4
# the suite runs in several pytest-xdist workers at once: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _every_material(p, gen, m):
    """The Cornell sphere box of `cornell_materials` (Lambertian walls, an
    emissive light, a mirror, a dielectric of IOR 1.5, a mirror with fuzz
    0.3), an emissive-marker sphere (type 2) and a fuzzy-mirror icosphere
    mesh (fuzz 0.5), built with one package's presets, procgen and types."""
    s = p.cornell_materials()
    s.add_sphere((-1.5, 0.3, 0.8), 0.3, m.Material(albedo=(0.6, 0.6, 0.9),
                                                   material_type=2.0))
    verts, faces = gen.icosphere(subdivisions=2, radius=0.6)
    s.add_mesh(verts, faces, position=(1.0, 2.2, -1.0), scale=1.0,
               material=m.Material(albedo=(0.8, 0.8, 0.7), material_type=-1.0,
                                   fuzz=0.5))
    return s


@pytest.fixture(scope="module")
def every_material():
    return (j_upload(_every_material(jpresets, jprocgen, jscene)),
            t_upload(_every_material(presets, procgen, tscene), "cpu"))


@pytest.fixture(scope="module")
def reference_scene():
    path = os.path.join(REPO, "scenes", "reference.xml")
    return (j_upload(jscene.load_scene_xml(path)),
            t_upload(tscene.load_scene_xml(path), "cpu"))


def _cam(m):
    return m.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


def _rays(n, seed, span=30.0, center=(0.0, 20.0, 40.0)):
    """Random rays about the reference scene, every other one aimed at the
    bunny (tests/test_torch_closest_hit.py's)."""
    r = np.random.default_rng(seed)
    o = (r.uniform(-span, span, (n, 3)) + np.asarray(center)).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    target = np.asarray([-25.0, 5.0, 0.0]) + r.uniform(-6.0, 6.0, (n, 3))
    d[1::2] = (target - o)[1::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _box_rays(n, seed):
    """Random rays inside the Cornell box (origins in its interior)."""
    r = np.random.default_rng(seed)
    o = (r.uniform(-2.2, 2.2, (n, 3)) + [0.0, 2.5, 0.0]).astype(np.float32)
    d = r.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


# ---------------------------------------------------------------------------
# the sphere pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which,n", [("reference", 700), ("every_material", 2048)])
def test_sphere_pass_matches_reference(reference_scene, every_material, which, n):
    js, ts = reference_scene if which == "reference" else every_material
    o, d = _rays(n, n) if which == "reference" else _box_rays(n, n)
    jt, jidx, jc, jm = (np.asarray(v) for v in jmm._sphere_hit_exact(
        js, jnp.asarray(o), jnp.asarray(d), T_MIN))
    t, idx, slot = tmm.sphere_pass(torch.as_tensor(o), torch.as_tensor(d),
                                   ts.sph_center, ts.sph_radius, ts.sph_ids, T_MIN)
    assert t.dtype == torch.float32 and idx.dtype == slot.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(np.isinf(t.numpy()), np.isinf(jt))
    f = np.isfinite(jt)
    assert f.mean() > 0.2
    np.testing.assert_allclose(t.numpy()[f], jt[f], rtol=5e-4, atol=1e-2)
    k = slot.long()
    np.testing.assert_array_equal(ts.sph_center[k].numpy()[f], jc[f])
    np.testing.assert_array_equal(ts.sph_mat_id[k].numpy()[f], jm[f])
    assert (slot.numpy()[~f] == 0).all()


def test_sphere_pass_ties_take_the_lowest_slot_and_no_spheres_miss():
    o = torch.tensor([[0.0, 0.0, -5.0], [0.0, 10.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    center = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
    radius = torch.tensor([1.0, 1.0, 1.0])
    ids = torch.tensor([7, 3, 9], dtype=torch.int32)
    t, idx, slot = tmm.sphere_pass(o, d, center, radius, ids, T_MIN)
    assert t[0] == 4.0 and idx.tolist() == [7, -1] and slot.tolist() == [0, 0]
    assert torch.isinf(t[1])
    t, idx, slot = tmm.sphere_pass(o, d, center[:0], radius[:0], ids[:0], T_MIN)
    assert torch.isinf(t).all() and idx.tolist() == [-1, -1] and slot.tolist() == [0, 0]


# ---------------------------------------------------------------------------
# the epilogue: the closest hit through it
# ---------------------------------------------------------------------------


def _mesh_only(m):
    s = m.HostScene()
    verts, faces = (procgen if m is tscene else jprocgen).icosphere(2, 3.0)
    s.add_mesh(verts, faces, position=(-25.0, 5.0, 0.0), scale=1.0,
               material=m.Material(albedo=(0.5, 0.5, 0.5)))
    return s


def _edge_flips(tt, ti_, jt, ji_, ts, o, d):
    """Lanes whose winners differ; each must be one of the reference's edge
    flips (its bf16 hi/lo split): the port's winner passes the exact test
    and is nearer, or the reference's winner fails it."""
    diff = ti_ != ji_
    k = np.nonzero(diff)[0]
    for lane in k:
        prims = [p for p in (ti_[lane], ji_[lane]) if p >= 0]
        t_exact = {p: float(ti.ray_triangle(
            torch.as_tensor(o[lane]), torch.as_tensor(d[lane]), ts.p0[p], ts.p1[p],
            ts.p2[p])) if int(ts.prim_type[p]) == tscene.PRIM_TRIANGLE else None
            for p in prims}
        port_ok = ti_[lane] >= 0 and t_exact[ti_[lane]] is not None and \
            math.isfinite(t_exact[ti_[lane]]) and tt[lane] < jt[lane]
        ref_bad = ji_[lane] >= 0 and t_exact[ji_[lane]] is not None and \
            math.isinf(t_exact[ji_[lane]])
        assert port_ok or ref_bad, lane
    assert diff.mean() <= 0.01
    return diff


@pytest.mark.parametrize("which", ["reference", "every_material", "mesh_only"])
def test_hit_epilogue_matches_reference_closest_hit(reference_scene, every_material,
                                                    which):
    if which == "reference":
        (js, ts), (o, d) = reference_scene, _rays(2048, 3)
    elif which == "every_material":
        (js, ts), (o, d) = every_material, _box_rays(2048, 4)
    else:
        js, ts = j_upload(_mesh_only(jscene)), t_upload(_mesh_only(tscene), "cpu")
        o, d = _rays(1024, 5)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    t_s, i_s, slot = tmm.sphere_pass(ot, dt, ts.sph_center, ts.sph_radius,
                                     ts.sph_ids, T_MIN)
    t_tri = col = None
    if ts.num_tris:
        args = tmm.kernel_inputs(ts, ot, dt, t_s, None, T_MIN)
        t_tri, col = (v[:len(o)] for v in tmm.mm_closest_hit(*args, ts.mm_w, T_MIN))
    out = tmm.hit_epilogue(ot, dt, t_tri, col, t_s, i_s, slot, ts.mm_refine,
                           ts.sph_center, ts.sph_mat_id, T_MIN)
    # the wrapper's route on the CPU is the twin itself
    for a, b in zip(out, tmm.hit_epilogue_reference(
            ot, dt, t_tri, col, t_s, i_s, slot, ts.mm_refine, ts.sph_center,
            ts.sph_mat_id, T_MIN)):
        assert torch.equal(a, b) or torch.allclose(a, b, equal_nan=True, rtol=0, atol=0)
    tt, tidx, tn, tf, tm = (v.numpy() for v in out)
    jt, jidx, jn, jf, jm, _ = (np.asarray(v) for v in jmm.closest_hit_mm_full(
        js, jnp.asarray(o), jnp.asarray(d)))
    diff = _edge_flips(tt, tidx, jt, jidx, ts, o, d)
    hit = (jidx >= 0) & ~diff
    assert hit.mean() > 0.05
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=5e-4, atol=1e-2)
    np.testing.assert_allclose(tn[hit], jn[hit], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tf[hit], jf[hit])
    np.testing.assert_array_equal(tm[hit], jm[hit])
    np.testing.assert_array_equal(np.isinf(tt[~diff]), jidx[~diff] < 0)
    if which == "mesh_only":
        assert ts.num_tris > 0 and (tidx[hit] >= 0).all()


# ---------------------------------------------------------------------------
# the shading step against the reference's bounce step
# ---------------------------------------------------------------------------


def _lane_state(n, seed):
    r = np.random.default_rng(seed)
    light = r.uniform(0, 0.5, (n, 3)).astype(np.float32)
    tp = r.uniform(0.02, 1.0, (n, 3)).astype(np.float32)
    active = r.uniform(size=n) > 0.2
    prev_pdf = np.where(r.uniform(size=n) > 0.5, r.uniform(0.1, 2.0, n),
                        0.0).astype(np.float32)
    return light, tp, active, prev_pdf


def _shade_step(ts, state, pix, sample, bounce, seed, cfg):
    """`_trace_rays`, the step's draws and `shade_reference`: the port's
    bounce step without next-event estimation, written out."""
    o, d, light, tp, active, prev_pdf = (torch.as_tensor(a) for a in state)
    t, idx, normal, front, mat_id, passes = tint._trace_rays(ts, o, d, cfg, active)
    drawn = rng.draws(seed, torch.as_tensor(pix), sample, bounce,
                      tint._step_draws(False, cfg.rr_start > 0))
    out = tsh.shade_reference(o, d, light, tp, active, prev_pdf, t, idx, normal, front,
                              mat_id, drawn[0], drawn[1],
                              drawn[-1] if cfg.rr_start > 0 else None, bounce,
                              ts.mat_bank, ts.sky, cfg.rr_start, cfg.adaptive_offset)
    return (*out, passes)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("rr_start", [0, 1])
def test_shade_step_matches_reference_bounce_step(every_material, rr_start, adaptive):
    js, ts = every_material
    w = h = 32
    n, seed, sample = w * h, 11, 3
    pix = np.arange(n)
    o, d = generate_rays(_cam(tcam), w, h, torch.as_tensor(pix), sample, seed)
    state = (o.numpy(), d.numpy(), *_lane_state(n, 5))
    jcfg = jint.RenderConfig(max_depth=8, rr_start=rr_start, adaptive_offset=adaptive)
    tcfg = tint.RenderConfig(max_depth=8, rr_start=rr_start, adaptive_offset=adaptive)
    materials = set()
    for bounce in (2, 3):  # the second step starts where the reference's first ended
        j_out = jint._bounce_step(
            js, *(jnp.asarray(a) for a in state), jnp.asarray(pix.astype(np.uint32)),
            jnp.uint32(sample), jnp.uint32(bounce), jrng.seed_from_int(seed), jcfg)
        t_out = _shade_step(ts, state, pix, sample, bounce, seed, tcfg)
        hit = tint._trace_rays(ts, torch.as_tensor(state[0]),
                               torch.as_tensor(state[1]), tcfg)
        t_hit = np.where(np.isfinite(hit[0].numpy()), hit[0].numpy(), 0.0)
        names = ("o", "d", "light", "throughput", "active", "prev_pdf", "rays")
        for name, t, j in zip(names, t_out, j_out):
            t, j = t.numpy(), np.asarray(j)
            if name in ("active", "rays"):
                np.testing.assert_array_equal(t, j, err_msg=name)
            elif name == "o":
                moved = np.linalg.norm(t - j, axis=-1)
                far = moved > 1e-4 + 5e-4 * t_hit
                assert not far.any(), (bounce, np.nonzero(far)[0])
            else:
                np.testing.assert_allclose(t, j, rtol=0.0, atol=1e-4, err_msg=name)
        live = state[4] & (hit[1].numpy() >= 0)
        materials |= set(ts.mat_bank[hit[4].long()][:, 3].numpy()[live].tolist())
        state = tuple(np.array(v) for v in j_out[:6])
    # Lambertian, mirror, dielectric and the emissive marker were all shaded
    assert {0.0, -1.0, 1.5, 2.0} <= materials


@pytest.mark.parametrize("kind", ["int", "0-d", "per-lane int64", "per-lane int32"])
def test_shade_takes_the_bounce_in_every_layout(every_material, kind):
    _, ts = every_material
    n, seed, sample, bounce = 512, 2, 1, 3
    pix = np.arange(n)
    o, d = _box_rays(n, 9)
    cfg = tint.RenderConfig(max_depth=8, rr_start=2)
    state = (o, d, *_lane_state(n, 6))
    want = _shade_step(ts, state, pix, sample, bounce, seed, cfg)
    b = {"int": bounce, "0-d": torch.tensor(bounce),
         "per-lane int64": torch.full((n,), bounce),
         "per-lane int32": torch.full((n,), bounce, dtype=torch.int32)}[kind]
    got = _shade_step(ts, state, pix, sample, b, seed, cfg)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_wrappers_reject_bad_inputs(every_material):
    _, ts = every_material
    o, d = (torch.as_tensor(v) for v in _box_rays(8, 1))
    with pytest.raises(ValueError):
        tmm.sphere_pass(o.double(), d, ts.sph_center, ts.sph_radius, ts.sph_ids, T_MIN)
    with pytest.raises(ValueError):
        tmm.sphere_pass(o[:, :2], d, ts.sph_center, ts.sph_radius, ts.sph_ids, T_MIN)
    with pytest.raises(ValueError):  # no kernel for the device
        tmm.sphere_pass(o.to("meta"), d.to("meta"), ts.sph_center.to("meta"),
                        ts.sph_radius.to("meta"), ts.sph_ids.to("meta"), T_MIN)
    t_s, i_s, slot = tmm.sphere_pass(o, d, ts.sph_center, ts.sph_radius, ts.sph_ids,
                                     T_MIN)
    with pytest.raises(ValueError):
        tmm.hit_epilogue(o, d, None, None, t_s, i_s.long(), slot, ts.mm_refine,
                         ts.sph_center, ts.sph_mat_id, T_MIN)
    with pytest.raises(ValueError):
        tsh._bounce_operand(torch.zeros(3), 8, o.device)
    with pytest.raises(ValueError):
        tsh._bounce_operand(torch.zeros(5, dtype=torch.int64), 8, o.device)


# ---------------------------------------------------------------------------
# the restructured bounce step against the plain step before it
# ---------------------------------------------------------------------------


def _before_sphere_hit_exact(scene, o, d, t_min):
    t = ti.ray_sphere(o[:, None, :], d[:, None, :], scene.sph_center[None, :, :],
                      scene.sph_radius[None, :], t_min)
    t_best, slot = torch.min(t, dim=1)
    idx = torch.where(torch.isinf(t_best), -1, scene.sph_ids[slot])
    return t_best, idx, scene.sph_center[slot], scene.sph_mat_id[slot]


def _before_closest_hit(scene, o, d, t_min=T_MIN, active=None, occ_t=None):
    n = o.shape[0]
    t_s, i_s, c, m_s = _before_sphere_hit_exact(scene, o, d, t_min)
    sph_n = vm.normalize(o + t_s[:, None] * d - c)
    if scene.num_tris > 0:
        occ = t_s if occ_t is None else torch.minimum(t_s, occ_t)
        lists, counts, smin, x, lane_bound = tmm.kernel_inputs(
            scene, o, d, occ, active, t_min)
        t_t, col = tmm.mm_closest_hit(lists, counts, smin, x, lane_bound,
                                      scene.mm_w, t_min)
        tile_passes = counts.sum().to(torch.float32) * (
            tmm.LANES * scene.mm_w.shape[1] / float(1 << 20))
        t_t, col = t_t[:n], col[:n]
        row = scene.mm_refine[col.clamp(min=0).to(torch.int64)]
        nvec, ndotv0 = row[:, 0:3], row[:, 3]
        i_t, m_t = row[:, 4].to(torch.int32), row[:, 5].to(torch.int32)
        denom = vm.dot(nvec, d)
        parallel = torch.abs(denom) <= tmm.TRI_PARALLEL_EPS
        t_plane = (ndotv0 - vm.dot(nvec, o)) / torch.where(parallel, 1.0, denom)
        t_exact = torch.where((~parallel) & (t_plane > t_min), t_plane, math.inf)
        tri_hit = (col >= 0) & torch.isfinite(t_t)
        t_t = torch.where(tri_hit, torch.where(torch.isfinite(t_exact), t_exact, t_t),
                          math.inf)
        i_t = torch.where(tri_hit, i_t, -1)
        tri_n = vm.normalize(nvec)
    else:
        t_t = torch.full((n,), math.inf)
        i_t = torch.full((n,), -1, dtype=torch.int32)
        m_t = torch.zeros((n,), dtype=torch.int32)
        tri_n = torch.zeros_like(o)
        tile_passes = torch.zeros(())
    tri_wins = t_t < t_s
    t = torch.where(tri_wins, t_t, t_s)
    idx = torch.where(tri_wins, i_t, i_s)
    mat_id = torch.where(tri_wins, m_t, m_s)
    normal = vm.where3(tri_wins, tri_n, sph_n)
    front_face = vm.dot(normal, d) < 0.0
    normal = vm.where3(front_face, normal, -normal)
    return t, idx, normal, front_face, mat_id, tile_passes


def _before_trace_rays(scene, o, d, cfg, active=None, occ_t=None):
    if cfg.intersector in ("auto", "mm"):
        return _before_closest_hit(scene, o, d, T_MIN, active, occ_t)
    t, idx = ti.closest_hit_bruteforce(scene, o, d, T_MIN, chunk=cfg.brute_chunk)
    row = scene.geom_table[idx.clamp(min=0).to(torch.int64)]
    _, normal, front_face = ti.surface_interaction_packed(row, o, d, t)
    return t, idx, normal, front_face, None, torch.zeros(())


def _before_bounce_step(scene, o, d, light, throughput, active, prev_pdf,
                        pixel_id, sample_id, bounce, seed, cfg):
    """The plain bounce step as it was before the shading kernel, op for op."""
    rays_counted = active.sum(dtype=torch.int64)
    shadow_counted = torch.zeros((), dtype=torch.int64)
    t, idx, normal, front_face, mat_id, tile_passes = _before_trace_rays(
        scene, o, d, cfg, active=active)
    miss = idx < 0
    sky = bsdf.sky_color(d, scene.sky)
    light = light + torch.where((active & miss)[:, None], throughput * sky, 0.0)
    hit_live = active & ~miss
    point = o + t[:, None] * d
    mat_row = tint._fetch_material(scene, idx, mat_id)
    albedo, mat_type = mat_row[:, 0:3], mat_row[:, 3]
    emission, power, fuzz = mat_row[:, 4:7], mat_row[:, 7], mat_row[:, 8]
    use_nee = cfg.nee and scene.num_lights > 0
    emissive = bsdf.is_emissive(mat_type, power)
    count_emission = hit_live & emissive
    emit = throughput * emission * power[:, None]
    if use_nee:
        pdf_l_hit = tint._light_pdf_toward(scene, o, d, t, idx)
        w_bsdf = torch.where(
            prev_pdf > 0.0,
            (prev_pdf * prev_pdf)
            / torch.clamp(prev_pdf * prev_pdf + pdf_l_hit * pdf_l_hit, min=1e-20),
            1.0)
        emit = emit * w_bsdf[:, None]
    light = light + torch.where(count_emission[:, None], emit, 0.0)
    drawn = rng.draws(seed, pixel_id, sample_id, bounce,
                      tint._step_draws(use_nee, cfg.rr_start > 0))
    unit_vec, u_fres = drawn[0], drawn[1]
    if use_nee:
        is_diffuse = (mat_type == 0.0) | (mat_type == 2.0)
        is_glossy = (mat_type < 0.0) & (fuzz > 0.0) & (fuzz < 1.0)
        refl = vm.reflect(d, normal)
        u_pick, ul = drawn[2], drawn[3]
        ldir, ldist, lrad, pdf_l, lprim, lvalid = tint._sample_light(
            scene, point, u_pick, ul[0], ul[1])
        cos_s = vm.dot(normal, ldir)
        pdf_b_l = torch.where(is_glossy, bsdf.glossy_pdf(refl, fuzz, ldir),
                              torch.clamp(cos_s, min=0.0) / math.pi)
        cand = (hit_live & (cos_s > 0.0) & lvalid & ~emissive
                & (is_diffuse | (is_glossy & (pdf_b_l > 0.0))))
        s_o = point + 1e-3 * normal
        st, sidx, _, _, _, s_passes = _before_trace_rays(
            scene, s_o, ldir, cfg, active=cand, occ_t=ldist * 1.001)
        tile_passes = tile_passes + s_passes
        shadow_counted = cand.sum(dtype=torch.int64)
        rays_counted = rays_counted + shadow_counted
        lit = cand & (sidx == lprim)
        w_light = (pdf_l * pdf_l) / torch.clamp(pdf_l * pdf_l + pdf_b_l * pdf_b_l,
                                                min=1e-20)
        scale = pdf_b_l * w_light / torch.clamp(pdf_l, min=1e-12)
        contrib = throughput * albedo * lrad * scale[..., None]
        light = light + torch.where(lit[:, None], contrib, 0.0)
        nee_ran = hit_live & (is_diffuse | is_glossy) & ~emissive
    d_out, offset_sign = bsdf.sample_bsdf(d, normal, front_face, mat_type, fuzz,
                                          unit_vec, u_fres)
    if cfg.adaptive_offset:
        scale = torch.clamp(torch.abs(point).amax(dim=-1), min=1.0)
        new_o = point + (1e-4 * offset_sign * scale)[..., None] * normal
    else:
        new_o = point + (1e-4 * offset_sign)[..., None] * normal
    new_tp = throughput * albedo
    if cfg.rr_start > 0:
        u_rr = drawn[-1]
        p = torch.clamp(new_tp.amax(dim=-1), 0.05, 1.0)
        do_rr = bounce >= cfg.rr_start
        if not isinstance(do_rr, torch.Tensor):
            do_rr = torch.full_like(p, do_rr, dtype=torch.bool)
        new_tp = new_tp * torch.where(do_rr, 1.0 / p, 1.0)[..., None]
        hit_live = hit_live & (~do_rr | (u_rr < p))
    if use_nee:
        pdf_next = torch.where(is_glossy, bsdf.glossy_pdf(refl, fuzz, d_out),
                               torch.clamp(vm.dot(normal, d_out), min=0.0) / math.pi)
        new_pdf = torch.where(nee_ran, pdf_next, 0.0)
    else:
        new_pdf = torch.zeros_like(prev_pdf)
    o = vm.where3(hit_live, new_o, o)
    d = vm.where3(hit_live, d_out, d)
    throughput = torch.where(hit_live[:, None], new_tp, throughput)
    prev_pdf = torch.where(hit_live, new_pdf, prev_pdf)
    return (o, d, light, throughput, hit_live, prev_pdf, rays_counted,
            shadow_counted, tile_passes)


@pytest.mark.parametrize("case", ["plain", "rr_fixed_offset", "nee_rr", "brute",
                                  "per_lane_bounce"])
def test_restructured_bounce_step_equals_the_step_before_it(every_material, monkeypatch,
                                                            case):
    _, ts = every_material
    w = h = 24
    n, seed, sample = w * h, 13, 2
    pix = torch.arange(n)
    o, d = generate_rays(_cam(tcam), w, h, pix, sample, seed)
    light, tp, active, prev_pdf = (torch.as_tensor(a) for a in _lane_state(n, 8))
    cfg = tint.RenderConfig(
        max_depth=8, rr_start=0 if case in ("plain", "brute") else 1,
        adaptive_offset=case != "rr_fixed_offset", nee=case == "nee_rr",
        intersector="brute" if case == "brute" else "auto")
    bounce = torch.full((n,), 2) if case == "per_lane_bounce" else 2
    args = (ts, o, d, light, tp, active, prev_pdf, pix, sample, bounce, seed, cfg)
    now = tint._bounce_step(*args)
    with monkeypatch.context() as m:  # the dot products as they were summed
        m.setattr(vm, "dot", lambda a, b: (a * b).sum(dim=-1))
        m.setattr(vm, "dot_keepdims", lambda a, b: (a * b).sum(dim=-1, keepdim=True))
        m.setattr(vm, "length_squared", lambda a: (a * a).sum(dim=-1))
        before = _before_bounce_step(*args)
    for a, b in zip(now, before):
        assert torch.equal(a, b)
    assert bool(now[4].any()) and bool((now[2] != light).any())


# ---------------------------------------------------------------------------
# the JAX package's last public functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_closest_hit_mm_matches_reference(reference_scene, masked):
    from metalpathtracer_tpu.render.pallas import closest_hit_mm as j_closest_hit_mm
    from metalpathtracer_torch.render.kernels import closest_hit_mm

    js, ts = reference_scene
    n = 1024
    o, d = _rays(n, 21)
    active = np.random.default_rng(22).uniform(size=n) > 0.3 if masked else None
    jt, jidx = (np.asarray(v) for v in j_closest_hit_mm(
        js, jnp.asarray(o), jnp.asarray(d), T_MIN,
        None if active is None else jnp.asarray(active)))
    tt, tidx = closest_hit_mm(ts, torch.as_tensor(o), torch.as_tensor(d), T_MIN,
                              None if active is None else torch.as_tensor(active))
    tt, tidx = tt.numpy(), tidx.numpy()
    live = np.ones(n, bool) if active is None else active
    diff = _edge_flips(tt[live], tidx[live], jt[live], jidx[live], ts, o[live], d[live])
    hit = (jidx[live] >= 0) & ~diff
    assert hit.mean() > 0.2
    np.testing.assert_allclose(tt[live][hit], jt[live][hit], rtol=5e-4, atol=1e-2)


def test_surface_interaction_matches_reference(reference_scene):
    js, ts = reference_scene
    o, d = _rays(600, 31)
    tj, ij = ji.closest_hit_bruteforce(js, jnp.asarray(o), jnp.asarray(d))
    tj, ij = np.asarray(tj), np.array(ij)
    t = np.where(ij >= 0, tj, 1.0).astype(np.float32)  # misses: any finite t
    pj, nj, fj = (np.asarray(v) for v in ji.surface_interaction(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(ij)))
    pt, nt, ft = ti.surface_interaction(ts, torch.as_tensor(o), torch.as_tensor(d),
                                        torch.as_tensor(t), torch.as_tensor(ij))
    hit = ij >= 0
    assert hit.mean() > 0.2 and (ij[hit] >= 3).any() and (ij[hit] < 3).any()
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nt.numpy()[hit], nj[hit], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ft.numpy()[hit], fj[hit])


def test_length_and_ray_eps_match_reference():
    a = np.random.default_rng(41).standard_normal((257, 3)).astype(np.float32) * 30
    np.testing.assert_allclose(vm.length(torch.as_tensor(a)).numpy(),
                               np.asarray(jvm.length(jnp.asarray(a))), rtol=1e-6)
    np.testing.assert_array_equal(vm.length(torch.zeros(2, 3)).numpy(), [0.0, 0.0])
    assert vm.RAY_EPS == jvm.RAY_EPS == 1e-4
