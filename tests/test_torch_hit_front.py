"""The closest hit's front end (`render/kernels/intersect_mm.py::hit_front`)
and the wavefront's shading with its bank (`render/kernels/shade.py::
shade_hit` given `bank=`) on the CPU, where each wrapper runs its plain
twin: against the plain code each replaced, against the JAX reference, and
a small wavefront render against the advance as it was. The CUDA kernels
(`csrc/sphere_pass.cu`'s `hit_front`, `csrc/shade.cu`'s `shade_hit` with
its bank) are held bit-equal to the same twins on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 18).

Tolerances:
- the front end against the plain pass before it (the sphere pass, then
  `ray_features` with its dot products summed by `torch.sum`, the cast, the
  padding and the occlusion bound): `torch.equal`, since `vm.dot`'s fixed
  order of adds is the CPU sum's own;
- against the reference's `ray_features` (its first 12 columns) and
  `_sphere_hit_exact`: tests/test_torch_closest_hit.py's and
  tests/test_torch_shade.py's bounds (d, o and the 1 column equal, o x d at
  rtol 1e-6, atol 1e-4, o.d and |o|^2 at rtol 1e-6; t at rtol 5e-4, atol
  1e-2; sphere ids equal);
- the shading with its bank against the shading without it and the bank
  code of the advance before it: `torch.equal` (the same torch
  operations);
- a wavefront render against one on the advance and closest hit before
  them: `torch.equal`; against the JAX reference's wavefront:
  tests/test_torch_wavefront.py's bound (under 2% of pixels off by > 1e-3,
  means within 5e-3, equal ray counts).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.core import rng, vecmath as vm
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.render.kernels import intersect_mm as tmm
from metalpathtracer_torch.render.kernels import shade as tsh
from metalpathtracer_torch.render.pipeline import render_image_wavefront
from metalpathtracer_torch import scene as tscene
from metalpathtracer_torch.scene import presets
from metalpathtracer_tpu.render import camera as jcam
from metalpathtracer_tpu.render import integrator as jint
from metalpathtracer_tpu.render import render_image_wavefront as j_render_wavefront
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu.render.pallas import intersect_mm as jmm
from metalpathtracer_tpu import scene as jscene
from metalpathtracer_tpu.scene import presets as jpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MIN = 1e-4
INF = float("inf")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference_scene():
    path = os.path.join(REPO, "scenes", "reference.xml")
    return (j_upload(jscene.load_scene_xml(path)),
            t_upload(tscene.load_scene_xml(path), "cpu"))


def _rays(n, seed):
    """Random rays about the reference scene, every other one aimed at the
    bunny (tests/test_torch_closest_hit.py's)."""
    r = np.random.default_rng(seed)
    o = (r.uniform(-30.0, 30.0, (n, 3)) + [0.0, 20.0, 40.0]).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    target = np.asarray([-25.0, 5.0, 0.0]) + r.uniform(-6.0, 6.0, (n, 3))
    d[1::2] = (target - o)[1::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _masks(n, seed):
    r = np.random.default_rng(seed + 1000)
    active = r.uniform(size=n) > 0.25
    occ = np.where(r.uniform(size=n) > 0.5, r.uniform(1.0, 200.0, n),
                   np.inf).astype(np.float32)
    return torch.as_tensor(active), torch.as_tensor(occ)


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------


def _before_ray_features(o, d):
    """`ray_features` as it was: its dot products summed by `torch.sum`."""
    m = vm.cross(o, d)
    od = (o * d).sum(dim=-1, keepdim=True)
    oo = (o * o).sum(dim=-1, keepdim=True)
    return torch.cat([d, m, o, od, oo, torch.ones_like(od)], dim=-1)


def _before_front(o, d, active, occ_t, center, radius, ids):
    """The sphere pass, the features, the cast, the padding and the
    occlusion bound as `closest_hit_mm_full` and `kernel_inputs` ran them
    before the front end."""
    n = o.shape[0]
    t_s, i_s, slot = tmm.sphere_pass_reference(o, d, center, radius, ids, T_MIN)
    occ = t_s if occ_t is None else torch.minimum(t_s, occ_t)
    pad = (-n) % 128
    x = _before_ray_features(o, d)
    act = (torch.ones((n,), dtype=torch.float32) if active is None
           else active.to(torch.float32))
    if pad:
        x = torch.cat([x, x.new_zeros((pad, 12))])
        act = torch.cat([act, act.new_zeros((pad,))])
        occ = torch.cat([occ, occ.new_full((pad,), INF)])
    return t_s, i_s, slot, x, act, occ


@pytest.mark.parametrize("occ_given", [False, True])
@pytest.mark.parametrize("active_given", [False, True])
@pytest.mark.parametrize("n", [1, 100, 128, 1000])
def test_hit_front_equals_the_plain_pass_before_it(reference_scene, n, active_given,
                                                   occ_given):
    _, ts = reference_scene
    o, d = (torch.as_tensor(a) for a in _rays(n, n))
    active, occ_t = _masks(n, n)
    args = (o, d, active if active_given else None, occ_t if occ_given else None,
            ts.sph_center, ts.sph_radius, ts.sph_ids)
    before = tmm.hit_front.launches
    got = tmm.hit_front(*args, T_MIN)
    assert tmm.hit_front.launches == before  # the CPU runs the twin
    want = _before_front(*args)
    n_pad = -(-n // 128) * 128
    assert [tuple(g.shape) for g in got] == [(n,)] * 3 + [(n_pad, 12), (n_pad,), (n_pad,)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(tmm.ray_features(o, d), _before_ray_features(o, d))
    x, act, occ = got[3:]
    assert not x[n:].any() and not act[n:].any() and torch.isinf(occ[n:]).all()


@pytest.mark.parametrize("n", [1, 300])
def test_hit_front_without_spheres(reference_scene, n):
    _, ts = reference_scene
    o, d = (torch.as_tensor(a) for a in _rays(n, n + 7))
    active, occ_t = _masks(n, n + 7)
    args = (o, d, active, occ_t, ts.sph_center[:0], ts.sph_radius[:0], ts.sph_ids[:0])
    t_s, i_s, slot, x, act, occ = tmm.hit_front(*args, T_MIN)
    assert torch.isinf(t_s).all() and (i_s == -1).all() and (slot == 0).all()
    assert torch.equal(occ[:n], occ_t)
    for g, w in zip((t_s, i_s, slot, x, act, occ), _before_front(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [700, 2048])
def test_hit_front_matches_reference(reference_scene, n):
    js, ts = reference_scene
    o, d = _rays(n, n + 11)
    jx = np.asarray(jmm.ray_features(jnp.asarray(o), jnp.asarray(d)))
    jt, jidx, _, _ = (np.asarray(v) for v in jmm._sphere_hit_exact(
        js, jnp.asarray(o), jnp.asarray(d), T_MIN))
    t_s, i_s, _, x, act, occ = tmm.hit_front(torch.as_tensor(o), torch.as_tensor(d),
                                             None, None, ts.sph_center, ts.sph_radius,
                                             ts.sph_ids, T_MIN)
    x = x[:n].numpy()
    np.testing.assert_array_equal(x[:, 0:3], jx[:, 0:3])
    np.testing.assert_array_equal(x[:, 6:9], jx[:, 6:9])
    np.testing.assert_array_equal(x[:, 11], jx[:, 11])
    np.testing.assert_allclose(x[:, 3:6], jx[:, 3:6], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(x[:, 9:11], jx[:, 9:11], rtol=1e-6)
    np.testing.assert_array_equal(i_s.numpy(), jidx)
    f = np.isfinite(jt)
    assert f.mean() > 0.2
    np.testing.assert_array_equal(np.isinf(t_s.numpy()), ~f)
    np.testing.assert_allclose(t_s.numpy()[f], jt[f], rtol=5e-4, atol=1e-2)
    assert (act[:n] == 1.0).all() and torch.equal(occ[:n], t_s)


def test_hit_front_rejects_bad_operands(reference_scene):
    _, ts = reference_scene
    o, d = (torch.as_tensor(a) for a in _rays(64, 3))
    sph = (ts.sph_center, ts.sph_radius, ts.sph_ids)
    with pytest.raises(ValueError, match="active"):
        tmm.hit_front(o, d, torch.ones(64), None, *sph, T_MIN)
    with pytest.raises(ValueError, match="occ_t"):
        tmm.hit_front(o, d, None, torch.ones(63), *sph, T_MIN)
    with pytest.raises(ValueError, match="no kernel"):
        tmm.hit_front(o.to("meta"), d.to("meta"), None, None,
                      *(s.to("meta") for s in sph), T_MIN)


def test_closest_hit_runs_the_front_end_once_a_call(reference_scene, monkeypatch):
    # a scene with triangles takes the front end, one of spheres alone the
    # sphere pass; both once a closest hit, and never both
    _, ts = reference_scene
    glass = t_upload(tscene.load_scene_xml(
        os.path.join(REPO, "scenes", "cornell_glass.xml")), "cpu")
    calls = []
    front, sphere_pass = tmm.hit_front, tmm.sphere_pass
    monkeypatch.setattr(tmm, "hit_front",
                        lambda *a: calls.append("front") or front(*a))
    monkeypatch.setattr(tmm, "sphere_pass",
                        lambda *a: calls.append("spheres") or sphere_pass(*a))
    o, d = (torch.as_tensor(a) for a in _rays(300, 5))
    active, occ_t = _masks(300, 5)
    tmm.closest_hit_mm_full(ts, o, d, T_MIN, active=active, occ_t=occ_t)
    tmm.closest_hit_mm_full(glass, o, d, T_MIN, active=active)
    assert calls == ["front", "spheres"]


# ---------------------------------------------------------------------------
# the shading with the wavefront's bank
# ---------------------------------------------------------------------------


def _before_bank(light, still, alive, bounce, schunk, acc, plan, bpi=1):
    """The advance's bank as `_Wavefront.advance` wrote it, op for op."""
    bank_k, spb = plan.bank_k, plan.spb
    bounce_next = bounce + bpi
    survivors = still & (bounce_next < plan.max_depth)
    path_done = alive & ~survivors
    ps = torch.clamp(light, 0.0, 1.0) if plan.clamp_radiance else light
    if bank_k == 1:
        acc = acc + torch.where(path_done[:, None], ps, 0.0)
    else:
        slot = (torch.arange(bank_k)[None, :] == (schunk // spb)[:, None])
        mask = path_done[:, None] & slot
        acc = acc + torch.where(mask[:, :, None], ps[:, None, :],
                                0.0).reshape(-1, 3 * bank_k)
    light = torch.where(path_done[:, None], 0.0, light)
    schunk_next = schunk + path_done.to(torch.int64)
    more = path_done & (schunk_next < plan.per_item)
    bank = path_done & ~more
    schunk = torch.where(path_done, torch.where(bank, 0, schunk_next), schunk)
    return light, acc, bounce_next, survivors, schunk, more, bank


def _bank_inputs(scene, n, seed, bank_k, clamp, rr_start):
    """A wavefront step's shading and bank operands: random lanes (some at
    their last bounce, some dead, light above 1 where clamp bites), their
    closest hit's winners and their draws (`shade.shade_hit`'s arguments,
    the bounce at `shade.BOUNCE_ARG`)."""
    r = np.random.default_rng(seed)
    max_depth, spb = 6, 2
    plan = tsh.BankPlan(max_depth, clamp, bank_k, spb, bank_k * spb)
    o, d = (torch.as_tensor(a) for a in _rays(n, seed))
    alive = torch.as_tensor(r.uniform(size=n) > 0.15)
    bounce = torch.as_tensor(r.integers(0, max_depth + 1, n))
    active = alive & (bounce < max_depth)
    light = torch.as_tensor(r.uniform(0.0, 1.5, (n, 3)).astype(np.float32))
    tp = torch.as_tensor(r.uniform(0.02, 1.0, (n, 3)).astype(np.float32))
    prev_pdf = torch.as_tensor(r.uniform(0.0, 2.0, n).astype(np.float32))
    schunk = torch.as_tensor(r.integers(0, plan.per_item, n))
    acc = torch.as_tensor(r.uniform(0.0, 3.0, (n, 3 * bank_k)).astype(np.float32))
    t_tri, col, t_s, i_s, slot, _ = tmm.closest_hit_mm_winners(scene, o, d, T_MIN,
                                                               active=active)
    drawn = rng.draws(7, torch.arange(n), 1, bounce,
                      tint._step_draws(False, rr_start > 0))
    shade_args = (o, d, light, tp, active, prev_pdf, t_tri, col, t_s, i_s, slot,
                  scene.mm_refine, scene.sph_center, scene.sph_mat_id, T_MIN, drawn[0],
                  drawn[1], drawn[-1] if rr_start else None, bounce, scene.mat_bank,
                  scene.sky, rr_start, True)
    return shade_args, (alive, schunk, acc, plan)


@pytest.mark.parametrize("rr_start", [0, 2])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("bank_k", [1, 8])
def test_shade_bank_equals_shade_then_the_bank_before_it(reference_scene, bank_k,
                                                         clamp, rr_start):
    _, ts = reference_scene
    n = 1000
    shade_args, bank = _bank_inputs(ts, n, 40 + bank_k, bank_k, clamp, rr_start)
    got = tsh.shade_hit(*shade_args, bank=bank)
    assert got == tuple(got) and len(got) == 12
    o, d, light, tp, still, prev_pdf, rays = tsh.shade_hit(*shade_args)
    alive, schunk, acc, plan = bank
    light, acc, bounce, survivors, schunk, more, banked = _before_bank(
        light, still, alive, shade_args[tsh.BOUNCE_ARG], schunk, acc, plan)
    want = (o, d, light, tp, survivors, prev_pdf, rays, acc, bounce, schunk, more,
            banked)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(tsh.shade_hit_reference(*shade_args, bank=bank)[7], acc)
    # lanes that go on, that finish a path and restart, and that bank
    done = alive & ~survivors
    assert bool(survivors.any()) and bool(more.any()) and bool(banked.any())
    assert bool((done & (light == 0).all(dim=1)).any())
    if clamp:
        assert bool((shade_args[2] > 1.0).any())


def test_bank_paths_is_the_bank_before_it_at_two_bounces(reference_scene):
    _, ts = reference_scene
    shade_args, (alive, schunk, acc, plan) = _bank_inputs(ts, 500, 9, 4, True, 0)
    still = shade_args[4]
    light, bounce = shade_args[2], shade_args[tsh.BOUNCE_ARG]
    got = tsh.bank_paths(light, still, alive, bounce, schunk, acc, plan, 2)
    want = _before_bank(light, still, alive, bounce, schunk, acc, plan, bpi=2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_shade_bank_rejects_bad_operands(reference_scene):
    _, ts = reference_scene
    shade_args, (alive, schunk, acc, plan) = _bank_inputs(ts, 256, 3, 2, False, 0)
    with pytest.raises(ValueError, match="acc"):
        tsh.shade_hit(*shade_args, bank=(alive, schunk, acc[:, :3], plan))
    with pytest.raises(ValueError, match="schunk"):
        tsh.shade_hit(*shade_args, bank=(alive, schunk.to(torch.int32), acc, plan))
    with pytest.raises(ValueError, match="bounce"):
        bad = shade_args[:tsh.BOUNCE_ARG] + (3,) + shade_args[tsh.BOUNCE_ARG + 1:]
        tsh.shade_hit(*bad, bank=(alive, schunk, acc, plan))
    with pytest.raises(ValueError, match="bank_k"):
        tsh.shade_hit(*shade_args, bank=(alive, schunk, acc, plan._replace(spb=0)))


# ---------------------------------------------------------------------------
# the wavefront on the new advance against the advance before it
# ---------------------------------------------------------------------------


def _before_closest_hit_mm_full(scene, o, d, t_min=T_MIN, active=None, occ_t=None):
    """`closest_hit_mm_full` as it was: the sphere pass, then the plain
    kernel inputs (features, cast, padding, cull, sort), the closest hit and
    the epilogue."""
    n = o.shape[0]
    t_s, i_s, slot = tmm.sphere_pass(o, d, scene.sph_center, scene.sph_radius,
                                     scene.sph_ids, t_min)
    t_t = col = None
    if scene.num_tris > 0:
        occ = t_s if occ_t is None else torch.minimum(t_s, occ_t)
        lists, counts, smin, x, lane_bound = tmm.kernel_inputs(scene, o, d, occ, active,
                                                               t_min)
        t_t, col = tmm.mm_closest_hit(lists, counts, smin, x, lane_bound, scene.mm_w,
                                      t_min)
        tile_passes = counts.sum().to(torch.float32) * (
            128 * scene.mm_w.shape[1] / float(1 << 20))
        t_t, col = t_t[:n], col[:n]
    else:
        tile_passes = torch.zeros((), dtype=torch.float32)
    t, idx, normal, front_face, mat_id = tmm.hit_epilogue(
        o, d, t_t, col, t_s, i_s, slot, scene.mm_refine, scene.sph_center,
        scene.sph_mat_id, t_min)
    return t, idx, normal, front_face, mat_id, tile_passes


def _before_bounce_step(scene, o, d, light, tp, active, prev_pdf, pixel, sample, bounce,
                        seed, cfg):
    """`_bounce_step` as it was without next-event estimation on the tile
    intersector: the closest hit through its epilogue (`_trace_rays`), the
    draws, then the shading (`shade_reference`); every other route as it
    is."""
    if cfg.nee or cfg.intersector not in ("auto", "mm"):
        return tint._bounce_step(scene, o, d, light, tp, active, prev_pdf, pixel,
                                 sample, bounce, seed, cfg)[:9]
    o, d = o.contiguous(), d.contiguous()
    t, idx, normal, front, mat_id, tile_passes = tint._trace_rays(scene, o, d, cfg,
                                                                  active=active)
    drawn = rng.draws(seed, pixel, sample, bounce, tint._step_draws(False,
                                                                    cfg.rr_start > 0))
    out = tsh.shade_reference(o, d, light, tp, active, prev_pdf, t, idx, normal, front,
                              mat_id, drawn[0], drawn[1],
                              drawn[-1] if cfg.rr_start > 0 else None, bounce,
                              scene.mat_bank, scene.sky, cfg.rr_start,
                              cfg.adaptive_offset)
    return (*out, torch.zeros((), dtype=torch.int64), tile_passes)


def _before_advance(self, st):
    """`_Wavefront.advance` as it was: every step shaded after the closest
    hit's epilogue, then the plain bank."""
    cfg, counters = self.cfg, self.counters
    alive, bounce = st["alive"], st["bounce"]
    o, d, light, tp, prev_pdf = (st[k] for k in ("o", "d", "light", "tp", "prev_pdf"))
    # the pixel and sample the lane's last restart wrote (`wfk.restart_lanes`)
    pixel, sample = st["pixel"], st["sample"]
    still = alive
    for k in range(self.bpi):
        step_active = still & (bounce + k < cfg.max_depth)
        o, d, light, tp, still, prev_pdf, c, sh, tpass = _before_bounce_step(
            self.scene, o, d, light, tp, step_active, prev_pdf, pixel, sample,
            bounce + k, self.seed, cfg)
        counters["rays"] += c
        counters["shadow"] += sh
        counters["tile_passes"] += tpass
    light, acc, bounce_next, survivors, schunk, more, bank = _before_bank(
        light, still, alive, bounce, st["schunk"], st["acc"], self.plan, self.bpi)
    st = dict(st, o=o, d=d, light=light, tp=tp, prev_pdf=prev_pdf, acc=acc,
              bounce=bounce_next, alive=survivors, schunk=schunk)
    return st, more, bank


def _cornell_cam(m):
    return m.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


# name -> (scene, width, height, spp, cfg, pool)
WAVEFRONT_CASES = {
    "spheres_bank_k2_clamp": ("cornell", 16, 16, 4,
                              dict(max_depth=6, bank_k=2, clamp_radiance=True), 64),
    "triangles_sorted": ("bunny", 24, 16, 2, dict(max_depth=5), 128),
    "nee_rr": ("cornell", 16, 16, 2, dict(max_depth=6, nee=True, rr_start=2), 64),
    "two_bounces": ("cornell", 16, 16, 2, dict(max_depth=6, bounces_per_iter=2), 64),
    "rr_bank_k1": ("cornell", 16, 12, 1, dict(max_depth=6, rr_start=1), 64),
}


@pytest.fixture(scope="module")
def wavefront_scenes():
    return {"cornell": t_upload(presets.cornell_spheres(), "cpu"),
            "bunny": t_upload(presets.reference_default(
                os.path.join(REPO, "assets", "bunny.obj")), "cpu")}


@pytest.mark.parametrize("case", sorted(WAVEFRONT_CASES))
def test_wavefront_equals_the_advance_before_it(wavefront_scenes, monkeypatch, case):
    which, w, h, spp, cfg, pool = WAVEFRONT_CASES[case]
    scene = wavefront_scenes[which]
    cfg = tint.RenderConfig(**cfg)
    cam = _cornell_cam(tcam) if which == "cornell" else tcam.Camera.reset()

    def render():
        return render_image_wavefront(scene, cam, w, h, spp, seed=5, cfg=cfg,
                                      pool_size=pool, return_stats=True)

    banked, shade_hit = [], tsh.shade_hit
    monkeypatch.setattr(tsh, "shade_hit", lambda *a, bank=None: banked.append(
        bank is not None) or shade_hit(*a, bank=bank))
    got, rays, stats = render()
    monkeypatch.undo()
    # the step banks in its shading (from the closest hit's winners, on
    # the tile intersector) exactly where it shades at one bounce an
    # advance without NEE
    assert any(banked) == (cfg.bounces_per_iter == 1 and not cfg.nee)
    with monkeypatch.context() as m:
        m.setattr(tint._Wavefront, "advance", _before_advance)
        m.setattr(tint, "closest_hit_mm_full", _before_closest_hit_mm_full)
        m.setattr(tmm, "ray_features", _before_ray_features)
        want, want_rays, want_stats = render()
    assert torch.equal(got, want) and rays == want_rays and stats == want_stats
    assert got.mean() > 0.01


def test_wavefront_bank_matches_reference_wavefront(wavefront_scenes):
    cfg = dict(max_depth=6, bank_k=2, clamp_radiance=True)
    theirs, j_rays = j_render_wavefront(j_upload(jpresets.cornell_spheres()),
                                        _cornell_cam(jcam), 16, 16, spp=4, seed=5,
                                        cfg=jint.RenderConfig(**cfg), pool_size=64)
    theirs = np.asarray(theirs)
    mine, rays = render_image_wavefront(wavefront_scenes["cornell"], _cornell_cam(tcam),
                                        16, 16, spp=4, seed=5,
                                        cfg=tint.RenderConfig(**cfg), pool_size=64)
    mine = mine.numpy()
    assert mine.shape == theirs.shape == (16, 16, 3)
    assert np.isfinite(mine).all()
    assert (np.abs(mine - theirs) > 1e-3).mean() < 0.02
    assert abs(mine.mean() - theirs.mean()) < 5e-3
    assert rays == j_rays
