"""The shading that starts from the closest hit's raw winners
(`render/kernels/shade.py::shade_hit`, with and without the wavefront's
bank) and the bounce step's route through it
(`render/integrator.py::_bounce_step` without next-event estimation on the
tile intersector) on the CPU, where the wrapper runs its plain twin:
against the composition it replaced (the closest hit through its
epilogue, `closest_hit_mm_full`, then `shade_reference` and, with the
bank, `bank_paths`), against the JAX reference's bounce step, and small
scan and wavefront renders against renders on the old route. The CUDA
entry (`csrc/shade.cu`'s `shade_hit`) is held bit-equal to the same twin
on the card (tests/test_torch_cuda.py, chip_smoke.py phase 18).

Tolerances:
- the new route against the old composition, step and render: bit for bit
  (`torch.equal`; a float tensor compared by its bits, so that a NaN lane
  of light is held too), since the twins run the same torch operations;
- one step against the reference's `_bounce_step`:
  tests/test_torch_shade.py's (atol 1e-4 on every float output; masks and
  ray counts equal; the new origins within 1e-4 + 5e-4 t, a hit point's
  share of the r=1e4 wall spheres' FMA-contracted t).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.core import rng
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.render.kernels import intersect_mm as tmm
from metalpathtracer_torch.render.kernels import shade as tsh
from metalpathtracer_torch.render.pipeline import (
    generate_rays,
    render_image,
    render_image_wavefront,
)
from metalpathtracer_torch import scene as tscene
from metalpathtracer_torch.scene import presets, procgen
from metalpathtracer_tpu.core import rng as jrng
from metalpathtracer_tpu.render import integrator as jint
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu import scene as jscene
from metalpathtracer_tpu.scene import presets as jpresets
from metalpathtracer_tpu.scene import procgen as jprocgen

T_MIN = 1e-4
torch.set_num_threads(1)


def _spheres(p, gen, m):
    """Every sphere material: the Cornell sphere box of `cornell_materials`
    (Lambertian walls, an emissive light, a mirror, a dielectric, a fuzzy
    mirror) and an emissive-marker sphere (type 2); no triangle."""
    s = p.cornell_materials()
    s.add_sphere((-1.5, 0.3, 0.8), 0.3, m.Material(albedo=(0.6, 0.6, 0.9),
                                                   material_type=2.0))
    return s


def _triangles(p, gen, m):
    """Every material on meshes alone, open to the sky: a Lambertian floor
    quad, and icospheres of a mirror, a fuzzy mirror, a dielectric, an
    emitter and an emissive marker."""
    s = m.HostScene()
    grey = m.Material(albedo=(0.7, 0.7, 0.7))
    s.add_triangle((-6, 0, -6), (6, 0, -6), (-6, 0, 6), grey)
    s.add_triangle((6, 0, -6), (6, 0, 6), (-6, 0, 6), grey)
    verts, faces = gen.icosphere(subdivisions=1, radius=0.6)
    for pos, mat in (
            ((-1.5, 1.0, 0.0), m.Material(albedo=(0.9, 0.9, 0.9), material_type=-1.0)),
            ((0.0, 1.0, -1.0), m.Material(albedo=(0.8, 0.7, 0.7), material_type=-1.0,
                                          fuzz=0.4)),
            ((1.5, 1.0, 0.0), m.Material(albedo=(1.0, 1.0, 1.0), material_type=1.5)),
            ((0.0, 2.6, 0.5), m.Material(albedo=(0.0, 0.0, 0.0),
                                         emission_color=(1.0, 0.9, 0.7),
                                         emission_power=4.0)),
            ((0.0, 0.7, 1.5), m.Material(albedo=(0.5, 0.8, 0.5), material_type=2.0))):
        s.add_mesh(verts, faces, position=pos, scale=1.0, material=mat)
    return s


def _both(p, gen, m):
    """The sphere box with a fuzzy-mirror icosphere mesh and a Lambertian
    one (tests/test_torch_shade.py's `_every_material` and more)."""
    s = _spheres(p, gen, m)
    verts, faces = gen.icosphere(subdivisions=2, radius=0.6)
    s.add_mesh(verts, faces, position=(1.0, 2.2, -1.0), scale=1.0,
               material=m.Material(albedo=(0.8, 0.8, 0.7), material_type=-1.0,
                                   fuzz=0.5))
    s.add_mesh(verts, faces, position=(-1.2, 1.8, 0.4), scale=0.5,
               material=m.Material(albedo=(0.3, 0.8, 0.4)))
    return s


SCENES = {"spheres": _spheres, "triangles": _triangles, "both": _both}


@pytest.fixture(scope="module")
def scenes():
    return {k: t_upload(build(presets, procgen, tscene), "cpu")
            for k, build in SCENES.items()}


def _cam(m):
    return m.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


def _same(a, b):
    """Bit for bit: a float tensor by its bits (NaN where both are the same
    NaN), any other by value."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _lanes(scene, n, seed):
    """A step's lanes: the camera's rays from a few pixels, scattered rays
    in the box, rays that leave it (lanes that miss), light with NaN on some
    lanes and above 1 on others, dead lanes, and a prev_pdf."""
    r = np.random.default_rng(seed)
    pix = torch.arange(n)
    o, d = generate_rays(_cam(tcam), 32, 32, pix * 3 % 1024, 1, seed)
    o, d = o.clone(), d.clone()
    inner = torch.as_tensor(r.uniform(size=n) < 0.5)
    o_in = torch.as_tensor((r.uniform(-2.0, 2.0, (n, 3)) + [0.0, 2.5, 0.0])
                           .astype(np.float32))
    d_in = r.standard_normal((n, 3))
    d_in = torch.as_tensor((d_in / np.linalg.norm(d_in, axis=-1, keepdims=True))
                           .astype(np.float32))
    o = torch.where(inner[:, None], o_in, o)
    d = torch.where(inner[:, None], d_in, d)
    # rays from in front of the box's open side, away from it: they miss
    away = torch.as_tensor(r.uniform(size=n) < 0.1)
    o_out = torch.as_tensor((r.uniform(-1.0, 1.0, (n, 3)) + [0.0, 2.5, 12.0])
                            .astype(np.float32))
    d_out = np.concatenate([r.uniform(-0.1, 0.1, (n, 2)), np.ones((n, 1))], axis=1)
    d_out = torch.as_tensor((d_out / np.linalg.norm(d_out, axis=-1, keepdims=True))
                            .astype(np.float32))
    o = torch.where(away[:, None], o_out, o)
    d = torch.where(away[:, None], d_out, d)
    light = torch.as_tensor(r.uniform(0.0, 1.5, (n, 3)).astype(np.float32))
    light[r.uniform(size=n) < 0.05] = float("nan")
    tp = torch.as_tensor(r.uniform(0.02, 1.0, (n, 3)).astype(np.float32))
    active = torch.as_tensor(r.uniform(size=n) > 0.2)
    prev_pdf = torch.as_tensor(np.where(r.uniform(size=n) > 0.5,
                                        r.uniform(0.1, 2.0, n), 0.0).astype(np.float32))
    return o, d, light, tp, active, prev_pdf, pix


def _old_bounce_step(scene, o, d, light, throughput, active, prev_pdf, pixel_id,
                     sample_id, bounce, seed, cfg, bank=None):
    """The bounce step's route before the shading took the winners: the
    closest hit through its epilogue (`_trace_rays`: `closest_hit_mm_full`),
    the step's draws, then the shading (`shade_reference`) and, with the
    bank, the bank (`bank_paths`). With NEE, or off the tile intersector,
    the step as it is."""
    if cfg.nee or cfg.intersector not in ("auto", "mm"):
        return tint._bounce_step(scene, o, d, light, throughput, active, prev_pdf,
                                 pixel_id, sample_id, bounce, seed, cfg, bank)
    o, d = o.contiguous(), d.contiguous()
    t, idx, normal, front, mat_id, passes = tint._trace_rays(scene, o, d, cfg,
                                                             active=active)
    drawn = rng.draws(seed, pixel_id, sample_id, bounce,
                      tint._step_draws(False, cfg.rr_start > 0))
    args = (o, d, light, throughput, active, prev_pdf, t, idx, normal, front, mat_id,
            drawn[0], drawn[1], drawn[-1] if cfg.rr_start > 0 else None, bounce,
            scene.mat_bank, scene.sky, cfg.rr_start, cfg.adaptive_offset)
    shadow = torch.zeros((), dtype=torch.int64)
    o, d, light, throughput, active, prev_pdf, rays = tsh.shade_reference(*args)
    if bank is None:
        return o, d, light, throughput, active, prev_pdf, rays, shadow, passes, None
    alive, schunk, acc, plan = bank
    light, acc, bounce, active, schunk, more, banked = tsh.bank_paths(
        light, active, alive, bounce, schunk, acc, plan)
    return (o, d, light, throughput, active, prev_pdf, rays, shadow, passes,
            (acc, bounce, schunk, more, banked))


def _count(monkeypatch):
    """Calls of the shading's wrapper (`shade_hit`, and `shade_hit_bank`
    where a bank was given) and of the epilogue's (`hit_epilogue`), counted
    as they go through."""
    calls = dict(shade_hit=0, shade_hit_bank=0, hit_epilogue=0)
    shade_hit, hit_epilogue = tsh.shade_hit, tmm.hit_epilogue

    def counted_shade(*a, bank=None):
        calls["shade_hit" if bank is None else "shade_hit_bank"] += 1
        return shade_hit(*a, bank=bank)

    def counted_epilogue(*a):
        calls["hit_epilogue"] += 1
        return hit_epilogue(*a)
    monkeypatch.setattr(tsh, "shade_hit", counted_shade)
    monkeypatch.setattr(tmm, "hit_epilogue", counted_epilogue)
    return calls


# name -> (rr_start, adaptive_offset, bank: None or (bank_k, spb, clamp))
STEP_CASES = {
    "plain": (0, True, None),
    "rr_fixed_offset": (1, False, None),
    **{f"bank_k{k}_spb{spb}": (2 if k in (1, 4) else 0, k != 2, (k, spb, spb == 4))
       for k in (1, 2, 4, 8) for spb in (1, 4)},
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
@pytest.mark.parametrize("which", sorted(SCENES))
def test_step_from_the_winners_equals_the_epilogue_then_the_shading(
        scenes, monkeypatch, which, case):
    scene = scenes[which]
    rr_start, adaptive, banking = STEP_CASES[case]
    n, seed, sample, max_depth = 600, 17, 1, 6
    o, d, light, tp, active, prev_pdf, pix = _lanes(scene, n, 3 + len(case))
    cfg = tint.RenderConfig(max_depth=max_depth, rr_start=rr_start,
                            adaptive_offset=adaptive)
    bank, bounce = None, 2
    if banking is not None:
        k, spb, clamp = banking
        r = np.random.default_rng(5)
        plan = tsh.BankPlan(max_depth, clamp, k, spb, k * spb)
        alive = torch.as_tensor(r.uniform(size=n) > 0.15)
        bounce = torch.as_tensor(r.integers(0, max_depth, n))
        active = active & alive  # the wavefront's step_active
        schunk = torch.as_tensor(r.integers(0, plan.per_item, n))
        acc = torch.as_tensor(r.uniform(0.0, 3.0, (n, 3 * k)).astype(np.float32))
        bank = (alive, schunk, acc, plan)
    args = (scene, o, d, light, tp, active, prev_pdf, pix, sample, bounce, seed, cfg)
    calls = _count(monkeypatch)
    got = tint._bounce_step(*args, bank=bank)
    # one shading from the winners a step, and no epilogue of its own
    assert calls == dict(hit_epilogue=0, shade_hit=int(bank is None),
                         shade_hit_bank=int(bank is not None))
    want = _old_bounce_step(*args, bank=bank)
    assert len(got) == len(want) == 10
    for g, w in zip(got[:9], want[:9]):
        assert _same(g, w)
    if bank is not None:
        assert len(got[9]) == len(want[9]) == 5
        assert all(_same(g, w) for g, w in zip(got[9], want[9]))
        assert bool(got[9][3].any() or got[9][4].any())  # a path ended
    else:
        assert got[9] is None and want[9] is None
    # the lanes that miss, that hit, that were dead, and the NaN lanes
    hit = tmm.closest_hit_mm_full(scene, o, d, T_MIN, active=active)
    live_hit = active & (hit[1] >= 0)
    assert bool((active & (hit[1] < 0)).any()) and bool(live_hit.any())
    assert bool((~active).any()) and bool(torch.isnan(got[2]).any())


def test_every_material_is_shaded_on_the_new_route(scenes):
    for which, scene in scenes.items():
        o, d, *_ = _lanes(scene, 2000, 8)
        t, idx, normal, front, mat_id, _ = tmm.closest_hit_mm_full(scene, o, d, T_MIN)
        row = scene.mat_bank[mat_id.long()][idx >= 0]
        types = set(row[:, 3].tolist())
        assert {0.0, -1.0, 1.5, 2.0} <= types, (which, types)
        assert bool((row[:, 7] > 0).any()), which  # an emitter with power
        if which != "spheres":
            assert scene.num_tris > 0
        else:
            assert scene.num_tris == 0


@pytest.mark.parametrize("rr_start", [0, 1])
def test_step_from_the_winners_matches_reference_bounce_step(rr_start):
    js = j_upload(_both(jpresets, jprocgen, jscene))
    ts = t_upload(_both(presets, procgen, tscene), "cpu")
    w = h = 32
    n, seed, sample = w * h, 11, 3
    pix = np.arange(n)
    o, d = generate_rays(_cam(tcam), w, h, torch.as_tensor(pix), sample, seed)
    r = np.random.default_rng(5)
    state = (o.numpy(), d.numpy(), r.uniform(0, 0.5, (n, 3)).astype(np.float32),
             r.uniform(0.02, 1.0, (n, 3)).astype(np.float32), r.uniform(size=n) > 0.2,
             np.where(r.uniform(size=n) > 0.5, r.uniform(0.1, 2.0, n),
                      0.0).astype(np.float32))
    jcfg = jint.RenderConfig(max_depth=8, rr_start=rr_start)
    tcfg = tint.RenderConfig(max_depth=8, rr_start=rr_start)
    for bounce in (2, 3):  # the second step starts where the reference's first ended
        j_out = jint._bounce_step(
            js, *(jnp.asarray(a) for a in state), jnp.asarray(pix.astype(np.uint32)),
            jnp.uint32(sample), jnp.uint32(bounce), jrng.seed_from_int(seed), jcfg)
        t_out = tint._bounce_step(ts, *(torch.as_tensor(a) for a in state),
                                  torch.as_tensor(pix), sample, bounce, seed, tcfg)
        t_hit = tmm.closest_hit_mm_full(ts, torch.as_tensor(state[0]),
                                        torch.as_tensor(state[1]))[0].numpy()
        t_hit = np.where(np.isfinite(t_hit), t_hit, 0.0)
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
        state = tuple(np.array(v) for v in j_out[:6])


# name -> (integrator, scene, cfg keywords)
RENDER_CASES = {
    "scan_both": ("scan", "both", dict(max_depth=5)),
    "scan_spheres_rr": ("scan", "spheres", dict(max_depth=5, rr_start=2)),
    "scan_triangles": ("scan", "triangles", dict(max_depth=4, clamp_radiance=True)),
    "wavefront_both": ("wavefront", "both", dict(max_depth=5)),
    "wavefront_spheres_bank_k2": ("wavefront", "spheres",
                                  dict(max_depth=5, bank_k=2, clamp_radiance=True)),
    "wavefront_triangles_two_bounces": ("wavefront", "triangles",
                                        dict(max_depth=5, bounces_per_iter=2)),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_on_the_new_route_equals_the_old_route(scenes, monkeypatch, case):
    integrator, which, kw = RENDER_CASES[case]
    scene, cfg = scenes[which], tint.RenderConfig(**kw)

    def render():
        if integrator == "scan":
            return render_image(scene, _cam(tcam), 16, 12, 2, seed=3, cfg=cfg)
        return render_image_wavefront(scene, _cam(tcam), 16, 12, 2, seed=3, cfg=cfg,
                                      pool_size=64)

    calls = _count(monkeypatch)
    got, rays = render()
    fused = ("shade_hit_bank" if integrator == "wavefront"
             and cfg.bounces_per_iter == 1 else "shade_hit")
    assert calls[fused] > 0
    assert sum(calls.values()) == calls[fused]  # no epilogue, no other shading
    with monkeypatch.context() as m:
        m.setattr(tint, "_bounce_step", _old_bounce_step)
        want, want_rays = render()
    assert _same(got, want) and rays == want_rays
    assert got.mean() > 0.01 and math.isfinite(float(got.mean()))


def _winner_args(scene, n=64, rr_start=0):
    o, d, light, tp, active, prev_pdf, pix = _lanes(scene, n, 1)
    t_tri, col, t_s, i_s, slot, _ = tmm.closest_hit_mm_winners(scene, o, d, T_MIN,
                                                               active=active)
    drawn = rng.draws(7, pix, 1, 2, tint._step_draws(False, rr_start > 0))
    return (o, d, light, tp, active, prev_pdf, t_tri, col, t_s, i_s, slot,
            scene.mm_refine, scene.sph_center, scene.sph_mat_id, T_MIN, drawn[0],
            drawn[1], drawn[-1] if rr_start else None, 2, scene.mat_bank, scene.sky,
            rr_start, True)


def test_closest_hit_mm_full_is_the_winners_then_the_epilogue(scenes):
    for scene in scenes.values():
        o, d, light, tp, active, *_ = _lanes(scene, 300, 2)
        t_tri, col, t_s, i_s, slot, passes = tmm.closest_hit_mm_winners(
            scene, o, d, T_MIN, active=active)
        assert (t_tri is None) == (col is None) == (scene.num_tris == 0)
        got = tmm.closest_hit_mm_full(scene, o, d, T_MIN, active=active)
        want = tmm.hit_epilogue(o, d, t_tri, col, t_s, i_s, slot, scene.mm_refine,
                                scene.sph_center, scene.sph_mat_id, T_MIN)
        for g, w in zip(got, (*want, passes)):
            assert _same(g, w)


def test_wrappers_reject_bad_inputs(scenes):
    scene = scenes["both"]
    args = _winner_args(scene)
    assert len(tsh.shade_hit(*args)) == 7
    bad = list(args)
    bad[8] = args[8].double()  # t_s
    with pytest.raises(ValueError, match="t_s"):
        tsh.shade_hit(*bad)
    bad = list(args)
    bad[7] = None  # col without t_tri
    with pytest.raises(ValueError, match="t_tri and col"):
        tsh.shade_hit(*bad)
    bad = list(args)
    bad[10] = args[10][:-1]  # slot
    with pytest.raises(ValueError, match="slot"):
        tsh.shade_hit(*bad)
    bad = list(args)
    bad[11] = args[11][:, :4]  # refine rows of 4
    with pytest.raises(ValueError, match="refine"):
        tsh.shade_hit(*bad)
    with pytest.raises(ValueError):  # no kernel for the device
        tsh.shade_hit(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                        for a in args))
    with pytest.raises(ValueError, match="u_rr"):  # roulette without its draw
        tsh.shade_hit(*args[:21], 2, True)
    n = args[0].shape[0]
    plan = tsh.BankPlan(6, False, 4, 2, 8)
    bounce = torch.full((n,), 2)
    bank_args = args[:18] + (bounce,) + args[19:]
    alive, schunk = torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int64)
    acc = torch.zeros((n, 12))
    assert len(tsh.shade_hit(*bank_args, bank=(alive, schunk, acc, plan))) == 12
    with pytest.raises(ValueError, match="acc"):
        tsh.shade_hit(*bank_args, bank=(alive, schunk, acc[:, :3], plan))
    with pytest.raises(ValueError, match="bounce"):
        tsh.shade_hit(*args, bank=(alive, schunk, acc, plan))  # an int bounce
    with pytest.raises(ValueError, match="bank_k"):
        tsh.shade_hit(*bank_args, bank=(alive, schunk, acc, plan._replace(spb=0)))
    with pytest.raises(ValueError, match="bank_k 3 must be one of"):  # no wavefront's
        tsh.shade_hit(*bank_args, bank=(alive, schunk, torch.zeros((n, 9)),
                                        plan._replace(bank_k=3, per_item=6)))
    with pytest.raises(ValueError, match="per_item"):
        tsh.shade_hit(*bank_args, bank=(alive, schunk, acc, plan._replace(per_item=9)))
    with pytest.raises(ValueError, match="schunk"):
        tsh.shade_hit(*bank_args, bank=(alive, schunk.int(), acc, plan))
