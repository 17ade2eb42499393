"""The port's progressive state (`AccumState`, `init_accum`, `accumulate`,
`accumulate_wavefront`, `to_image`) and the `sample_offset` of both
integrators, against the port's batch renders and the JAX reference, on
the CPU.

Tolerances:
- structural, bit for bit (`torch.equal`): `accumulate` in chunks of k
  samples adds the passes `render_image` adds with `spp_per_pass=k`, in
  the same order, so the two images are equal; a render split by
  `sample_offset` adds the same passes too. It is NOT bit-equal to a
  render with another pass size: float addition is not associative;
- `accumulate_wavefront` vs `accumulate`, step for step: the estimate is
  the same, only the framebuffer's addition order differs: rtol 1e-5,
  atol 1e-6 on the running mean (tests/test_torch_wavefront.py's bound),
  and equal ray counts;
- against the JAX state: the render bound of tests/test_torch_render.py
  (under 2% of pixels differ by > 1e-3, means within 5e-3): a path whose
  hit flips at an edge takes another, equally valid, bounce chain;
- `to_image`: the same division and clamp on the same array: rtol 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.core import rng as trng
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render import pipeline as tpipe
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.scene import presets
from metalpathtracer_tpu.core import rng as jrng
from metalpathtracer_tpu.render import camera as jcam
from metalpathtracer_tpu.render import integrator as jint
from metalpathtracer_tpu.render import pipeline as jpipe
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu.scene import presets as jpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "assets", "bunny.obj")
torch.set_num_threads(1)

W, H, DEPTH, SEED = 24, 16, 4, 9


def _cam(m, name):
    if name == "cornell":
        return m.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
    return m.Camera.reset()


def _host(p, name):
    return p.cornell_spheres() if name == "cornell" else p.reference_default(BUNNY)


@pytest.fixture(scope="module", params=["cornell", "reference"])
def case(request):
    name = request.param
    return name, t_upload(_host(presets, name), "cpu"), _cam(tcam, name)


def _render_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(a).all()
    assert (np.abs(a - b) > 1e-3).mean() < 0.02
    assert abs(a.mean() - b.mean()) < 5e-3


def test_init_accum():
    st = tpipe.init_accum(5, 3, "cpu")
    assert st.rgb_sum.shape == (3, 5, 3) and st.rgb_sum.dtype == torch.float32
    assert st.rgb_sum.device == torch.device("cpu") and not st.rgb_sum.any()
    assert st.spp == 0 and isinstance(st.spp, int)


def test_accumulate_equals_render_image_bit_for_bit(case):
    _, scene, cam = case
    cfg = tint.RenderConfig(max_depth=DEPTH)
    seed = trng.seed_from_int(SEED)
    st = tpipe.init_accum(W, H, "cpu")
    st = tpipe.accumulate(st, scene, cam, W, H, 3, seed, cfg)
    assert st.spp == 3
    st = tpipe.accumulate(st, scene, cam, W, H, 3, seed, cfg)
    assert st.spp == 6 and isinstance(st.spp, int)
    batch, _ = tpipe.render_image(scene, cam, W, H, 6, seed=SEED, cfg=cfg,
                                  spp_per_pass=3)
    assert torch.equal(tpipe.to_image(st, clamp=False), batch)
    # another pass size sums in another order: close, not equal
    other, _ = tpipe.render_image(scene, cam, W, H, 6, seed=SEED, cfg=cfg,
                                  spp_per_pass=6)
    torch.testing.assert_close(other, batch, rtol=1e-5, atol=1e-6)


def test_accumulate_matches_the_reference_state(case):
    name, scene, cam = case
    seed = trng.seed_from_int(SEED)
    st = tpipe.init_accum(W, H, "cpu")
    js = jpipe.init_accum(W, H)
    j_scene = j_upload(_host(jpresets, name))
    for _ in range(2):
        st = tpipe.accumulate(st, scene, cam, W, H, 3, seed,
                              tint.RenderConfig(max_depth=DEPTH))
        js = jpipe.accumulate(js, j_scene, _cam(jcam, name), W, H, 3,
                              jrng.seed_from_int(SEED),
                              jint.RenderConfig(max_depth=DEPTH))
    assert st.spp == int(js.spp) == 6
    _render_close(st.rgb_sum.numpy() / 6, np.asarray(js.rgb_sum) / 6)


def test_accumulate_wavefront_matches_accumulate_step_for_step(case):
    _, scene, cam = case
    cfg = tint.RenderConfig(max_depth=DEPTH)
    seed = trng.seed_from_int(SEED)
    scan = wave = tpipe.init_accum(W, H, "cpu")
    for step in range(3):
        scan = tpipe.accumulate(scan, scene, cam, W, H, 2, seed, cfg)
        wave, rays = tpipe.accumulate_wavefront(wave, scene, cam, W, H, 2, seed,
                                                cfg, pool_size=128)
        assert wave.spp == scan.spp == 2 * (step + 1)
        torch.testing.assert_close(tpipe.to_image(wave, clamp=False),
                                   tpipe.to_image(scan, clamp=False),
                                   rtol=1e-5, atol=1e-6)
        # the rays of these two samples, as the scan route counts them
        _, scan_rays = tpipe.render_image(scene, cam, W, H, 2, seed=SEED, cfg=cfg,
                                          sample_offset=2 * step)
        assert isinstance(rays, int) and rays == scan_rays


def test_accumulate_wavefront_matches_the_reference():
    name = "reference"  # one compile of the reference's wavefront is enough
    scene, cam = t_upload(_host(presets, name), "cpu"), _cam(tcam, name)
    cfg = tint.RenderConfig(max_depth=DEPTH)
    st = tpipe.init_accum(W, H, "cpu")
    js = jpipe.init_accum(W, H)
    j_scene = j_upload(_host(jpresets, name))
    for _ in range(2):
        st, rays = tpipe.accumulate_wavefront(st, scene, cam, W, H, 2,
                                              trng.seed_from_int(SEED), cfg,
                                              pool_size=128)
        js, j_rays = jpipe.accumulate_wavefront(
            js, j_scene, _cam(jcam, name), W, H, 2, jrng.seed_from_int(SEED),
            jint.RenderConfig(max_depth=DEPTH), pool_size=128)
        assert abs(rays - int(j_rays)) <= 0.01 * int(j_rays)
    assert st.spp == int(js.spp) == 4
    _render_close(st.rgb_sum.numpy() / 4, np.asarray(js.rgb_sum) / 4)


@pytest.mark.parametrize("clamp", [True, False])
def test_to_image_matches_the_reference(clamp):
    r = np.random.default_rng(3)
    rgb = r.uniform(0.0, 9.0, (6, 8, 3)).astype(np.float32)
    for spp in (0, 1, 5):
        mine = tpipe.to_image(tpipe.AccumState(torch.as_tensor(rgb), spp), clamp)
        theirs = jpipe.to_image(
            jpipe.AccumState(jnp.asarray(rgb), jnp.asarray(spp, jnp.int32)), clamp)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6)
        if spp < 5:  # sums up to 9 over at most 1 sample: the clamp bites
            assert (float(mine.max()) <= 1.0) == clamp


def test_render_image_sample_offset_splits_a_render_exactly(case):
    _, scene, cam = case
    cfg = tint.RenderConfig(max_depth=DEPTH)
    whole, rays = tpipe.render_image(scene, cam, W, H, 4, seed=SEED, cfg=cfg,
                                     spp_per_pass=2)
    a, ra = tpipe.render_image(scene, cam, W, H, 2, seed=SEED, cfg=cfg)
    b, rb = tpipe.render_image(scene, cam, W, H, 2, seed=SEED, cfg=cfg,
                                sample_offset=2)
    # a * 2 and b * 2 are the passes' sums again, exactly
    assert torch.equal((a * 2 + b * 2) / 4, whole)
    assert ra + rb == rays
    assert not torch.equal(a, b)


def test_render_image_sample_offset_matches_the_reference(case):
    name, scene, cam = case
    mine, rays = tpipe.render_image(scene, cam, W, H, 2, seed=SEED,
                                    cfg=tint.RenderConfig(max_depth=DEPTH),
                                    sample_offset=5)
    theirs, j_rays = jpipe.render_image(
        j_upload(_host(jpresets, name)), _cam(jcam, name), W, H, 2, seed=SEED,
        cfg=jint.RenderConfig(max_depth=DEPTH), sample_offset=5)
    _render_close(mine.numpy(), theirs)
    assert abs(rays - j_rays) <= 0.01 * j_rays


@pytest.mark.parametrize("offset", [0, 3, (1 << 32) - 1])
def test_trace_wavefront_sample_offset_matches_scan(case, offset):
    # the last case wraps: sample ids are u32 words
    _, scene, cam = case
    cfg = tint.RenderConfig(max_depth=DEPTH)
    seed = trng.seed_from_int(SEED)
    fb, rays, _ = tint.trace_wavefront(scene, cam, W, H, 2, seed, cfg, 128,
                                       sample_offset=offset)
    scan, scan_rays = tpipe.render_image(scene, cam, W, H, 2, seed=SEED, cfg=cfg,
                                         sample_offset=offset)
    torch.testing.assert_close(fb.reshape(H, W, 3) / 2, scan, rtol=1e-5, atol=1e-6)
    assert rays == scan_rays


@pytest.mark.parametrize("route", ["scan", "wavefront"])
def test_accumulate_leaves_its_input_state_as_it_was(case, route):
    _, scene, cam = case
    cfg = tint.RenderConfig(max_depth=DEPTH)
    seed = trng.seed_from_int(SEED)
    st = tpipe.accumulate(tpipe.init_accum(W, H, "cpu"), scene, cam, W, H, 1,
                          seed, cfg)
    before = st.rgb_sum.clone()
    if route == "scan":
        new = tpipe.accumulate(st, scene, cam, W, H, 1, seed, cfg)
    else:
        new, _ = tpipe.accumulate_wavefront(st, scene, cam, W, H, 1, seed, cfg,
                                            pool_size=128)
    assert st.spp == 1 and torch.equal(st.rgb_sum, before)
    assert new.spp == 2 and not torch.equal(new.rgb_sum, before)
    assert new.rgb_sum.data_ptr() != st.rgb_sum.data_ptr()
    # both states stay usable: the same step again gives the same state
    again = (tpipe.accumulate(st, scene, cam, W, H, 1, seed, cfg) if route == "scan"
             else tpipe.accumulate_wavefront(st, scene, cam, W, H, 1, seed, cfg,
                                             pool_size=128)[0])
    assert torch.equal(again.rgb_sum, new.rgb_sum)


# ---------------------------------------------------------------------------
# utils/metrics.py
# ---------------------------------------------------------------------------

def test_metrics_match_the_reference():
    from metalpathtracer_torch.utils import RenderStats, relative_mse, rmse
    from metalpathtracer_tpu.utils import RenderStats as JStats
    from metalpathtracer_tpu.utils import relative_mse as j_relative_mse
    from metalpathtracer_tpu.utils import rmse as j_rmse

    r = np.random.default_rng(0)
    a, b = r.uniform(0, 2, (2, 6, 8, 3)).astype(np.float32)
    assert rmse(a, b) == j_rmse(a, b) and rmse(a, a) == 0.0
    assert relative_mse(a, b) == j_relative_mse(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        rmse(a, b[:3])
    for args in [(64, 36, 4, 0.5, 1000), (64, 36, 4, 0.0, None), (8, 8, 1, 2.0, None)]:
        mine, theirs = RenderStats(*args), JStats(*args)
        assert mine.to_dict() == theirs.to_dict()
        assert mine.json_line() == theirs.json_line()


def test_timed_render_times_a_render(case):
    from metalpathtracer_torch.utils import Timer, timed_render

    _, scene, cam = case
    cfg = tint.RenderConfig(max_depth=2)
    (img, rays), stats = timed_render(tpipe.render_image, scene, cam, 8, 6, 2,
                                      seed=1, cfg=cfg, repeats=2)
    want, want_rays = tpipe.render_image(scene, cam, 8, 6, 2, seed=1, cfg=cfg)
    assert torch.equal(img, want) and rays == want_rays == stats.rays
    assert (stats.width, stats.height, stats.spp) == (8, 6, 2)
    assert stats.seconds > 0 and stats.mrays_per_sec > 0
    with Timer() as t:
        pass
    assert 0 <= t.seconds < 1.0


def test_profile_trace_writes_a_chrome_trace(case, tmp_path):
    import json

    from metalpathtracer_torch.utils import profile_trace

    _, scene, cam = case
    with profile_trace(str(tmp_path / "trace")) as prof:
        tpipe.render_image(scene, cam, 8, 6, 1, cfg=tint.RenderConfig(max_depth=1))
    assert len(prof.key_averages()) > 0
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
