"""The wavefront's regeneration kernels (`render/kernels/wavefront.py`:
`restart_lanes`, `queue_pop`, `tileset_key`, `permute_lanes`) on the CPU,
where each wrapper runs its plain twin: against the JAX package, against
numpy references, and small wavefront renders on the new route against the
composition it replaced. The CUDA kernels (`csrc/wavefront.cu`) are held
bit-equal to the same twins on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 19).

Tolerances:
- the restart's rays against the JAX package's `generate_rays`: one ulp
  (ROADMAP's rule for rays: the two packages' jitter words are bit-equal,
  the divisions and the norm round alike on the CPU); pixel and sample ids
  exactly;
- the tile-set key against a key built from the JAX package's
  `_cull_hit_mask`, the queue pop against a numpy cumsum, the gather
  against numpy indexing: exactly (integer results and moved bits);
- renders on the new route against the old composition: bit for bit
  (`torch.equal`), since the twins run the torch operations the old route
  ran; against the JAX package's wavefront: the render bounds of
  tests/test_torch_wavefront.py (under 2% of pixels differ by > 1e-3,
  means within 5e-3), equal ray counts.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import graphs
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.render.kernels import wavefront as twfk
from metalpathtracer_torch.render.kernels.intersect_mm import _cull_hit_mask
from metalpathtracer_torch.render.pipeline import (
    camera_basis,
    rays_from_basis,
    render_image_wavefront,
)
from metalpathtracer_torch.scene import presets
from metalpathtracer_tpu.render import camera as jcam
from metalpathtracer_tpu.render import integrator as jint
from metalpathtracer_tpu.render import pipeline as jpipe
from metalpathtracer_tpu.render import render_image_wavefront as j_render_wavefront
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu.render.pallas import intersect_mm as jmm
from metalpathtracer_tpu.scene import presets as jpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MIN = 1e-4
torch.set_num_threads(1)


def _cornell_cam(m):
    return m.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


def _lanes(n, ka, seed, groups=None, chunks=4):
    """A lane dict of `twfk.LANE_FIELDS` with numpy-seeded contents."""
    r = np.random.default_rng(seed)
    groups = groups or n
    f = lambda *s: torch.as_tensor(r.standard_normal(s).astype(np.float32))  # noqa: E731
    i = lambda hi: torch.as_tensor(r.integers(0, hi, n).astype(np.int64))  # noqa: E731
    return dict(item=i(groups * chunks), schunk=i(8), acc=f(n, ka), o=f(n, 3),
                d=f(n, 3), bounce=i(32), light=f(n, 3), tp=f(n, 3), prev_pdf=f(n),
                alive=torch.as_tensor(r.random(n) < 0.6), pixel=i(1 << 20),
                sample=i(1 << 10))


# --------------------------------------------------------------------------
# the restart
# --------------------------------------------------------------------------

# (width, height, bank_k, spb, pixel_offset, sample_offset, row_stride):
# whole images, contiguous row ranges and the dealt rows of a tile shard
# (every row_stride-th row from pixel_offset's), first samples 0 and later
RESTART_CASES = {
    "image": (32, 24, 1, 1, 0, 0, 1),
    "bank4_spb2_offsets": (40, 30, 4, 2, 0, 6, 1),
    "shard_rows": (64, 48, 2, 4, 64 * 20, 3, 1),
    "shard_late_samples": (48, 32, 8, 1, 48 * 9, 1021, 1),
    "shard_dealt_rows": (64, 48, 2, 4, 64 * 3, 3, 4),
    "shard_dealt_late_samples": (48, 32, 8, 1, 48 * 1, 1021, 2),
}


def _dealt(local, w, offset, stride):
    """Local pixel ids -> image pixel ids of a range whose row i is image
    row i * stride past the first's (numpy)."""
    return offset + (local // w) * stride * w + local % w


@pytest.mark.parametrize("case", sorted(RESTART_CASES))
def test_restart_twin_matches_the_reference_generate_rays(case):
    w, h, bank_k, spb, offset, sample_offset, stride = RESTART_CASES[case]
    # a contiguous shard of half the rows left, or all rows of a dealt one
    n_pix = (w * h - offset) // 2 if stride == 1 else (h // stride) * w
    groups = n_pix // bank_k
    plan = twfk.LanePlan(w, h, groups, bank_k, spb, offset, 0xC0FFEE, stride)
    n = 700
    r = np.random.default_rng(len(case))
    item = r.integers(0, groups * 3, n)
    schunk = r.integers(0, bank_k * spb, n)
    lanes = _lanes(n, 3 * bank_k, 1)
    lanes.update(item=torch.as_tensor(item), schunk=torch.as_tensor(schunk))
    restart = torch.ones(n, dtype=torch.bool)
    cam = _cornell_cam(tcam)
    out = twfk.restart_lanes(lanes, restart, camera_basis(cam, w, h),
                             torch.tensor(sample_offset), plan)
    # the ids: numpy's integer arithmetic
    pixel = _dealt((item % groups) * bank_k + schunk // spb, w, offset, stride)
    sample = (item // groups) * spb + schunk % spb + sample_offset
    assert pixel.max() < w * h
    np.testing.assert_array_equal(out["pixel"].numpy(), pixel)
    np.testing.assert_array_equal(out["sample"].numpy(), sample)
    jo, jd = jpipe.generate_rays(_cornell_cam(jcam), w, h,
                                 jnp.asarray(pixel, jnp.uint32),
                                 jnp.asarray(sample, jnp.uint32), plan.seed)
    np.testing.assert_array_max_ulp(out["d"].numpy(), np.asarray(jd), maxulp=1)
    np.testing.assert_array_max_ulp(out["o"].numpy(), np.asarray(jo), maxulp=1)
    assert out["alive"].all() and (out["tp"] == 1.0).all()
    assert (out["bounce"] == 0).all() and (out["prev_pdf"] == 0.0).all()


def test_restart_keeps_the_lanes_that_do_not_restart():
    w, h = 20, 10
    plan = twfk.LanePlan(w, h, 200, 1, 1, 0, 3)
    lanes = _lanes(300, 3, 2, groups=200)
    restart = torch.as_tensor(np.random.default_rng(4).random(300) < 0.3)
    basis = camera_basis(tcam.Camera.reset(), w, h)
    out = twfk.restart_lanes(lanes, restart, basis, torch.tensor(2), plan)
    keep = ~restart
    for k in ("o", "d", "tp", "bounce", "prev_pdf", "alive", "item", "schunk",
              "acc", "light"):
        assert torch.equal(out[k][keep], lanes[k][keep]), k
    pixel, sample = twfk.pixel_sample(lanes["item"], lanes["schunk"], 2, plan)
    o, d = rays_from_basis(basis, w, h, pixel, sample, plan.seed)
    assert torch.equal(out["d"][restart], d[restart])
    assert torch.equal(out["o"][restart], o[restart])
    assert torch.equal(out["pixel"], pixel) and torch.equal(out["sample"], sample)


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_pixel_sample_deals_the_rows(stride):
    # rank r of `stride` ranks: local row i is image row i * stride + r, the
    # columns and samples as on a contiguous range
    w, h, bank_k, spb = 24, 32, 4, 2
    n_local = (h // stride) * w
    groups = n_local // bank_k
    item = torch.arange(groups * 3)
    schunk = item % (bank_k * spb)
    for r in range(stride):
        plan = twfk.LanePlan(w, h, groups, bank_k, spb, r * w, 9, stride)
        pixel, sample = twfk.pixel_sample(item, schunk, 5, plan)
        local, same = twfk.pixel_sample(item, schunk, 5,
                                        twfk.LanePlan(w, h, groups, bank_k, spb, 0, 9))
        assert torch.equal(sample, same)
        assert torch.equal(pixel, (local // w * stride + r) * w + local % w)
        assert torch.equal(pixel // w % stride, torch.full_like(pixel, r))
    # every pixel of the image once over the ranks' whole ranges
    every = torch.arange(n_local)
    ids = torch.cat([twfk.pixel_sample(every, torch.zeros_like(every), 0, twfk.LanePlan(
        w, h, n_local, 1, 1, r * w, 9, stride))[0] for r in range(stride)])
    assert torch.equal(ids.sort().values, torch.arange(w * h))


# --------------------------------------------------------------------------
# the queue
# --------------------------------------------------------------------------


def _queue_reference(bank, more, item, acc, pend_idx, pend_rgb, next_item, total,
                     groups):
    """The window's queue in numpy: a cumsum's ranks."""
    item, acc, pend_idx, pend_rgb = (x.copy() for x in (item, acc, pend_idx, pend_rgb))
    pend_idx[bank] = item[bank] % groups
    pend_rgb[bank] = acc[bank]
    acc[bank] = 0.0
    new_item = next_item + np.cumsum(bank) - 1
    regen = bank & (new_item < total)
    item[regen] = new_item[regen]
    return (item, acc, pend_idx, pend_rgb, more | regen,
            min(next_item + int(bank.sum()), total))


@pytest.mark.parametrize("n", [1024, 16384, 32768])
@pytest.mark.parametrize("runs_out", [False, True])
def test_queue_pop_twin_matches_a_numpy_cumsum(n, runs_out):
    r = np.random.default_rng(n + runs_out)
    ka, groups = 6, 5000
    bank = r.random(n) < 0.2
    more = ~bank & (r.random(n) < 0.3)
    item = r.integers(0, 4 * groups, n)
    acc = r.standard_normal((n, ka)).astype(np.float32)
    pend_idx = groups + np.arange(n)
    pend_rgb = np.zeros((n, ka), np.float32)
    next_item = 30000
    # the queue runs out part-way through the banked lanes, or not at all
    total = next_item + (int(bank.sum()) // 2 if runs_out else 10 * n)
    want = _queue_reference(bank, more, item, acc, pend_idx, pend_rgb, next_item,
                            total, groups)
    t = [torch.as_tensor(x) for x in (item, acc, pend_idx, pend_rgb)]
    restart, head = twfk.queue_pop(torch.as_tensor(bank), torch.as_tensor(more), *t,
                                   torch.tensor(next_item), total, groups)
    for got, exp in zip(t, want[:4]):  # updated in place
        np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(restart.numpy(), want[4])
    assert head.shape == () and int(head) == want[5]
    # where it runs out, some banked lanes do not restart
    assert (int(head) == total) == runs_out == bool((~want[4][bank]).any())


# --------------------------------------------------------------------------
# the pool sort
# --------------------------------------------------------------------------


def _key_rays(boxes, n, seed):
    """Rays against `boxes`: random, some with zero direction components,
    some with origins on a box's planes, a third dead."""
    r = np.random.default_rng(seed)
    o = r.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d[r.random((n, 3)) < 0.15] = 0.0
    d[:5] = [[0, 0, 1], [0, 1, 0], [1, 0, 0], [0, 0, 0], [0, -1, 0]]
    on = r.random(n) < 0.2
    c = r.integers(0, boxes.shape[0], n)
    a = r.integers(0, 3, n)
    lo_or_hi = r.integers(0, 2, n) * 4
    o[on, a[on]] = boxes[c[on], lo_or_hi[on] + a[on]]
    alive = r.random(n) < 0.67
    return o, d, alive


def _box_sets():
    scene = t_upload(presets.reference_default(os.path.join(REPO, "assets", "bunny.obj")),
                     "cpu")
    r = np.random.default_rng(7)
    boxes = np.zeros((32, 8), np.float32)
    boxes[:, 0:3] = r.uniform(-10, 10, (32, 3))
    boxes[:, 4:7] = boxes[:, 0:3] + r.uniform(0, 6, (32, 3))
    boxes[3, 4:7] = boxes[3, 0:3]  # flat
    return {"reference_scene": scene.mm_coarse_box.numpy(), "random_32": boxes,
            "random_7": boxes[:7]}


@pytest.mark.parametrize("which", ["reference_scene", "random_32", "random_7"])
def test_tileset_key_twin_matches_the_reference_cull_mask(which):
    boxes = _box_sets()[which]
    o, d, alive = _key_rays(boxes, 3000, len(which))
    chit, _ = jmm._cull_hit_mask(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(alive, jnp.float32), jnp.asarray(boxes),
                                 T_MIN)
    chit = np.asarray(chit).astype(np.int64)
    want = (chit << np.arange(boxes.shape[0], dtype=np.int64)[:, None]).sum(axis=0)
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(alive),
            torch.as_tensor(boxes), T_MIN)
    np.testing.assert_array_equal(twfk.tileset_bits(*args).numpy(), want)
    key = twfk.tileset_key(*args)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy().astype(np.int64), want - (1 << 31))
    assert (want[~alive] == 0).all() and (want[alive] > 0).any()
    # the int32 key sorts as the int64 signature does
    assert torch.equal(torch.argsort(key, stable=True),
                       torch.argsort(torch.as_tensor(want), stable=True))


@pytest.mark.parametrize("pending", [False, True])
@pytest.mark.parametrize("ka", [3, 12, 24])
def test_permute_lanes_twin_matches_numpy_indexing(pending, ka):
    n = 2048
    lanes = _lanes(n, ka, ka)
    perm = np.random.default_rng(ka).permutation(n)
    pend = (torch.as_tensor(np.arange(n) * 3), torch.randn(n, ka)) if pending else None
    out, pend_out = twfk.permute_lanes(torch.as_tensor(perm), lanes, pend)
    assert set(out) == set(twfk.LANE_FIELDS)
    for k, v in lanes.items():
        np.testing.assert_array_equal(out[k].numpy(), v.numpy()[perm])
        assert out[k].is_contiguous() and out[k].dtype == v.dtype
    if pending:
        for got, src in zip(pend_out, pend):
            np.testing.assert_array_equal(got.numpy(), src.numpy()[perm])
    else:
        assert pend_out is None


# --------------------------------------------------------------------------
# renders: the new route against the composition it replaced
# --------------------------------------------------------------------------

_OLD_FIELDS = ("item", "schunk", "acc", "o", "d", "bounce", "light", "tp", "prev_pdf",
               "alive")


def _old_tileset_key(scene, o, d, alive):
    chit, _ = _cull_hit_mask(o, d, alive.to(torch.float32), scene.mm_coarse_box, T_MIN)
    nc = scene.mm_coarse_box.shape[0]
    bits = 1 << torch.arange(nc, dtype=torch.int64, device=o.device)
    return (chit.to(torch.int64) * bits[:, None]).sum(dim=0)


class _OldWavefront:
    """`_Wavefront`'s regeneration as it was before the kernels: the
    pixel and sample recomputed every advance, the restart, queue and sort
    as torch compositions (methods patched onto `tint._Wavefront`)."""

    @staticmethod
    def _store(bufs, st):
        for k in _OLD_FIELDS:
            bufs[k].copy_(st[k])

    def pix_samp_of(self, item, schunk):
        pixel = ((item % self.groups) * self.bank_k + schunk // self.spb
                 + self.pixel_offset)
        sample = (item // self.groups) * self.spb + schunk % self.spb \
            + self.sample_offset
        return pixel, sample

    def ray_for(self, item, schunk):
        pixel, sample = self.pix_samp_of(item, schunk)
        return rays_from_basis(self.basis, self.width, self.height, pixel, sample,
                               self.seed)

    def advance(self, st):
        pixel, sample = self.pix_samp_of(st["item"], st["schunk"])
        return _NEW_ADVANCE(self, dict(st, pixel=pixel, sample=sample))

    def restart_lanes(self, st, restart):
        no, nd = self.ray_for(st["item"], st["schunk"])
        r = restart[:, None]
        return dict(
            st, o=torch.where(r, no, st["o"]), d=torch.where(r, nd, st["d"]),
            tp=torch.where(r, 1.0, st["tp"]),
            bounce=torch.where(restart, 0, st["bounce"]),
            prev_pdf=torch.where(restart, 0.0, st["prev_pdf"]),
            alive=st["alive"] | restart,
        )

    def sort_pool(self, st, pend=None):
        ka = self.ka
        key = _old_tileset_key(self.scene, st["o"], st["d"], st["alive"])
        perm = torch.argsort(key, stable=True)
        fparts = [st["o"], st["d"], st["acc"], st["light"], st["tp"],
                  st["prev_pdf"][:, None]]
        iparts = [st["item"], st["schunk"], st["bounce"], st["alive"].to(torch.int64)]
        if pend is not None:
            fparts.append(pend[1])
            iparts.append(pend[0])
        fpack = torch.cat(fparts, dim=1)[perm]
        ipack = torch.stack(iparts, dim=1)[perm]
        st = dict(
            st, o=fpack[:, 0:3], d=fpack[:, 3:6], acc=fpack[:, 6:6 + ka],
            light=fpack[:, 6 + ka:9 + ka], tp=fpack[:, 9 + ka:12 + ka],
            prev_pdf=fpack[:, 12 + ka], item=ipack[:, 0], schunk=ipack[:, 1],
            bounce=ipack[:, 2], alive=ipack[:, 3] > 0,
        )
        if pend is None:
            return st, None
        return st, (ipack[:, 4], fpack[:, 13 + ka:])

    def start(self, camera, sample_offset):
        self.basis.copy_(camera_basis(camera, self.width, self.height))
        self.sample_offset.fill_(sample_offset)
        item0 = self.lane_ids.clone()
        schunk0 = torch.zeros(self.pool, **self.i64)
        o0, d0 = self.ray_for(item0, schunk0)
        self._store(self.st, dict(
            item=item0, schunk=schunk0,
            acc=torch.zeros((self.pool, self.ka), **self.f32),
            o=o0, d=d0, bounce=torch.zeros(self.pool, **self.i64),
            light=torch.zeros((self.pool, 3), **self.f32),
            tp=torch.ones((self.pool, 3), **self.f32),
            prev_pdf=torch.zeros(self.pool, **self.f32), alive=item0 < self.total,
        ))
        self.fb.zero_()
        for c in self.counters.values():
            c.zero_()
        self.next_item.fill_(min(self.pool, self.total))

    def window(self):
        st, total, groups = {k: self.st[k] for k in _OLD_FIELDS}, self.total, self.groups
        next_item = self.next_item
        pend = (groups + self.lane_ids, torch.zeros((self.pool, self.ka), **self.f32))
        for _ in range(self.flush_every // self.sort_every):
            for _ in range(self.sort_every):
                st, more, bank = self.advance(st)
                pend = (torch.where(bank, st["item"] % groups, pend[0]),
                        torch.where(bank[:, None], st["acc"], pend[1]))
                st["acc"] = torch.where(bank[:, None], 0.0, st["acc"])
                new_item = next_item + torch.cumsum(bank.to(torch.int64), 0) - 1
                regen = bank & (new_item < total)
                st["item"] = torch.where(regen, new_item, st["item"])
                st = self.restart_lanes(st, more | regen)
                next_item = torch.clamp(next_item + bank.sum(), max=total)
            if self.sorting:
                st, pend = self.sort_pool(st, pend)
        self.fb.index_add_(0, pend[0], pend[1])
        self._store(self.st, st)
        self.next_item.copy_(next_item)
        self._report(st["alive"])

    def drain_block(self):
        st = {k: self.drain[k] for k in _OLD_FIELDS}
        for _ in range(self.sort_every):
            st, more, _ = self.advance(st)
            st = self.restart_lanes(st, more)
        if self.sorting:
            st, _ = self.sort_pool(st)
        self._store(self.drain, st)
        self._report(st["alive"])


_NEW_ADVANCE = tint._Wavefront.advance


def _on_old_route(monkeypatch):
    for name in ("_store", "pix_samp_of", "ray_for", "advance", "restart_lanes",
                 "sort_pool", "start", "window", "drain_block"):
        monkeypatch.setattr(tint._Wavefront, name, _OldWavefront.__dict__[name],
                            raising=False)


# name -> (scene, width, height, spp, cfg, pool, (pixel_offset, n_pixels) or
# None): every case has a queue longer than its pool; the last one's pool is
# wider than the drain
RENDER_CASES = {
    "bunny_bpi1_bank1_sorted": ("bunny", 24, 16, 2, dict(max_depth=5, bank_k=1), 128,
                                None),
    "bunny_bpi2_bank2_sorted_rows": ("bunny", 24, 16, 2,
                                     dict(max_depth=5, bank_k=2, bounces_per_iter=2), 96,
                                     (48, 288)),
    "bunny_bank4_nee": ("bunny", 32, 16, 2, dict(max_depth=4, bank_k=4, nee=True), 64,
                        None),
    "bunny_bank8_unsorted": ("bunny", 32, 32, 1,
                             dict(max_depth=5, bank_k=8, sort_lanes=False), 64, None),
    "cornell_bpi2_nee_rr": ("cornell", 16, 16, 2,
                            dict(max_depth=6, bounces_per_iter=2, nee=True, rr_start=2),
                            64, None),
    "bunny_drain_sorted": ("bunny", 64, 40, 1, dict(max_depth=6, bank_k=2), 1280, None),
}


@pytest.fixture(scope="module")
def render_scenes():
    return {"cornell": t_upload(presets.cornell_spheres(), "cpu"),
            "bunny": t_upload(presets.reference_default(
                os.path.join(REPO, "assets", "bunny.obj")), "cpu")}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_wavefront_on_the_kernels_equals_the_old_composition(render_scenes, monkeypatch,
                                                            case):
    which, w, h, spp, cfg, pool, pixels = RENDER_CASES[case]
    scene = render_scenes[which]
    cfg = tint.RenderConfig(**cfg)
    cam = _cornell_cam(tcam) if which == "cornell" else tcam.Camera.reset()
    offset, n_pixels = pixels or (0, None)

    def render():
        graphs.clear()
        try:
            return tint.trace_wavefront(scene, cam, w, h, spp, 9, cfg, pool,
                                        sample_offset=1, pixel_offset=offset,
                                        n_pixels=n_pixels)
        finally:
            graphs.clear()

    calls = {}
    for name in ("restart_lanes", "queue_pop", "tileset_key", "permute_lanes"):
        real = getattr(twfk, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(twfk, name, counted)
    new_img, new_rays, new_stats = render()
    on_new = dict(calls)
    with monkeypatch.context() as m:
        _on_old_route(m)
        old_img, old_rays, old_stats = render()
    assert calls == on_new  # the old route calls none of the kernels
    assert torch.equal(new_img.view(torch.int32), old_img.view(torch.int32))
    assert new_rays == old_rays and new_stats == old_stats
    sorting = cfg.sort_lanes and scene.num_tris > 0
    assert on_new["restart_lanes"] > 1 and on_new["queue_pop"] > 0
    assert ("tileset_key" in on_new) == sorting
    assert on_new.get("tileset_key") == on_new.get("permute_lanes")


def test_wavefront_on_the_kernels_matches_the_reference_wavefront():
    cfg = dict(max_depth=5, bank_k=2, bounces_per_iter=1)
    theirs, j_rays = j_render_wavefront(
        j_upload(jpresets.cornell_spheres()), _cornell_cam(jcam), 16, 16, spp=4, seed=7,
        cfg=jint.RenderConfig(**cfg), pool_size=64)
    theirs = np.asarray(theirs)
    graphs.clear()
    mine, rays = render_image_wavefront(
        t_upload(presets.cornell_spheres(), "cpu"), _cornell_cam(tcam), 16, 16, spp=4,
        seed=7, cfg=tint.RenderConfig(**cfg), pool_size=64)
    graphs.clear()
    mine = mine.numpy()
    assert mine.shape == theirs.shape == (16, 16, 3)
    assert np.isfinite(mine).all()
    assert (np.abs(mine - theirs) > 1e-3).mean() < 0.02
    assert abs(mine.mean() - theirs.mean()) < 5e-3
    assert rays == j_rays


def test_advance_reads_the_restart_pixel_and_sample(render_scenes):
    """The advance draws with the pixel and sample the restart left in the
    lane state: lanes given other ids draw other paths."""
    scene = render_scenes["cornell"]
    graphs.clear()
    wf = tint._Wavefront(scene, 16, 16, 2, 5, tint.RenderConfig(max_depth=4), 64, 0, 256, 1)
    wf.start(_cornell_cam(tcam), 0)
    st = dict(wf.st)
    pixel, sample = twfk.pixel_sample(st["item"], st["schunk"], wf.sample_offset,
                                      wf.lane_plan)
    assert torch.equal(st["pixel"], pixel) and torch.equal(st["sample"], sample)
    a, _, _ = wf.advance(dict(st))
    b, _, _ = wf.advance(dict(st, sample=st["sample"] + 1))
    assert not torch.equal(a["d"], b["d"])


# --------------------------------------------------------------------------
# the wrappers' checks
# --------------------------------------------------------------------------


def _restart_args(n=64):
    lanes = _lanes(n, 3, 0, groups=n)
    plan = twfk.LanePlan(8, 8, n, 1, 1, 0, 1)
    return lanes, torch.ones(n, dtype=torch.bool), camera_basis(
        tcam.Camera.reset(), 8, 8), torch.tensor(0), plan


def _queue_args(n=64):
    return (torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool),
            torch.zeros(n, dtype=torch.int64), torch.zeros(n, 3),
            torch.zeros(n, dtype=torch.int64), torch.zeros(n, 3),
            torch.tensor(0), 10, 4)


def _key_args(n=64):
    return (torch.zeros(n, 3), torch.ones(n, 3), torch.ones(n, dtype=torch.bool),
            torch.zeros(4, 8), T_MIN)


def _to_meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


BAD_CALLS = {
    "restart_bad_dtype": lambda: twfk.restart_lanes(
        dict(_restart_args()[0], item=torch.zeros(64, dtype=torch.int32)),
        *_restart_args()[1:]),
    "restart_bad_basis": lambda: twfk.restart_lanes(
        _restart_args()[0], _restart_args()[1], torch.zeros(3, 3), *_restart_args()[3:]),
    "restart_sample_offset_not_0d": lambda: twfk.restart_lanes(
        *_restart_args()[:3], torch.zeros(1, dtype=torch.int64), _restart_args()[4]),
    "restart_meta_device": lambda: twfk.restart_lanes(
        {k: _to_meta(v) for k, v in _restart_args()[0].items()},
        *(_to_meta(x) for x in _restart_args()[1:])),
    "queue_bad_dtype": lambda: twfk.queue_pop(
        *_queue_args()[:2], torch.zeros(64, dtype=torch.int32), *_queue_args()[3:]),
    "queue_bad_shape": lambda: twfk.queue_pop(
        *_queue_args()[:5], torch.zeros(64, 4), *_queue_args()[6:]),
    "queue_mixed_device": lambda: twfk.queue_pop(
        _to_meta(_queue_args()[0]), *_queue_args()[1:]),
    "queue_meta_device": lambda: twfk.queue_pop(*(_to_meta(x) for x in _queue_args())),
    "key_bad_dtype": lambda: twfk.tileset_key(
        *_key_args()[:2], torch.ones(64), *_key_args()[3:]),
    "key_too_many_boxes": lambda: twfk.tileset_key(
        *_key_args()[:3], torch.zeros(33, 8), T_MIN),
    "key_meta_device": lambda: twfk.tileset_key(*(_to_meta(x) for x in _key_args())),
    "permute_missing_field": lambda: twfk.permute_lanes(
        torch.arange(8), {k: v for k, v in _lanes(8, 3, 0).items() if k != "pixel"}),
    "permute_bad_perm_dtype": lambda: twfk.permute_lanes(
        torch.arange(8, dtype=torch.int32), _lanes(8, 3, 0)),
    "permute_bad_pend_shape": lambda: twfk.permute_lanes(
        torch.arange(8), _lanes(8, 3, 0), (torch.zeros(8, dtype=torch.int64),
                                           torch.zeros(8, 6))),
    "permute_meta_device": lambda: twfk.permute_lanes(
        torch.arange(8, device="meta"), {k: _to_meta(v) for k, v in _lanes(8, 3, 0).items()}),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrappers_reject_bad_operands(case):
    with pytest.raises(ValueError):
        BAD_CALLS[case]()


def test_the_regeneration_runs_in_its_spans(render_scenes, monkeypatch):
    """Each kernel's call is inside its profiler range: the restart in
    `wavefront.restart_lanes` (the first pool's inside `wavefront.start`),
    the queue in `wavefront.queue`, the key and gather in
    `wavefront.sort_pool`; the advance opens no `wavefront.bank` at one
    bounce an advance."""
    opened, where = [], {}
    class _Span:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            opened.append(self.name)

        def __exit__(self, *exc):
            opened.pop()

    monkeypatch.setattr(tint, "span", _Span)
    for name in ("restart_lanes", "queue_pop", "tileset_key", "permute_lanes"):
        real = getattr(twfk, name)

        def spied(*a, _real=real, _name=name, **k):
            where.setdefault(_name, set()).add(tuple(opened))
            return _real(*a, **k)
        monkeypatch.setattr(twfk, name, spied)
    seen = []
    real_bank = tint.shade.bank_paths
    monkeypatch.setattr(tint.shade, "bank_paths",
                        lambda *a, **k: (seen.append(tuple(opened)), real_bank(*a, **k))[1])
    graphs.clear()
    render_image_wavefront(render_scenes["bunny"], tcam.Camera.reset(), 24, 16, 2,
                           cfg=tint.RenderConfig(max_depth=4), pool_size=128)
    graphs.clear()
    assert where["restart_lanes"] == {("wavefront.restart_lanes",),
                                      ("wavefront.start", "wavefront.restart_lanes")}
    assert where["queue_pop"] == {("wavefront.queue",)}
    assert where["tileset_key"] == where["permute_lanes"] == {("wavefront.sort_pool",)}
    # at one bounce an advance without NEE the shading banks (here its twin
    # calls the plain bank): no `wavefront.bank` range
    assert seen and not any("wavefront.bank" in where for where in seen)
