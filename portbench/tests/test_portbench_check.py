"""The check that decides `correct`, at a tiny size on the CPU: the plain
reference against the port, the control (the reference in bfloat16 in the
program's place) failing the cells' limits, and a whole run with the timed
path broken underneath coming out not correct, once for each fault the
cells can have (a pass that returns its state unchanged; half of each
pass's samples left out and the mean taken over the rest; the answer
altered where it is produced). Only this file imports both sides."""

import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harness import bench, manifest, program, reference, scene
from metalpathtracer_torch.render import pipeline

DATA = manifest.ROOT / "tests" / "data"

CELLS = ("reference.wavefront_720p", "reference.scan_720p", "bunny300k.wavefront_512",
         "cornell_glass.nee_512")
TINY = dict(width=32, height=18, max_depth=4, spp_per_pass=2, check_pixels=64, pool=256)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# config 4's cell: its configuration, traffic mix and limits are in the
# benchmark's folders, and BENCHMARK.json does not list it yet (its rate
# spreads too widely on the card: PERF.md, section 7)
PENDING = {"configs": [{"name": "cornell_glass", "file": "portbench/configs/cornell_glass.json"}],
           "workloads": [{"name": "cornell_glass.nee_512", "config": "cornell_glass",
                          "traffic": "nee_512", "chips": 1}]}


def spec():
    """BENCHMARK.json with the cells that PENDING holds and it lacks."""
    out = manifest.load_json(manifest.REPO / "BENCHMARK.json")
    for key, entries in PENDING.items():
        have = {e["name"] for e in out[key]}
        out[key] = out[key] + [e for e in entries if e["name"] not in have]
    return out


def tiny_cell(name):
    cell = manifest.Cell(spec(), name)
    cell.traffic = dict(cell.traffic, **TINY)
    return cell


def run_tiny(cell, prog=program, seed=2**31 + 77, seconds=0.3):
    return bench.run(cell, seed, seconds, False, "cpu", time.perf_counter(), prog)


@pytest.mark.parametrize("name", CELLS)
def test_the_port_passes_its_check_on_the_cpu(name):
    result, lines = run_tiny(tiny_cell(name))
    assert result["correct"], lines
    assert result["checks"]["gap_mean"]["value"] < 1e-6
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"msamples_per_s", "pass_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks"
    assert lines[-1].startswith("check samples_a_pixel")


def test_reference_matches_the_port_per_sample():
    """One sample of every pixel: the reference's radiance against the
    port's one-sample image (no clamp, no accumulation)."""
    cell = tiny_cell("reference.scan_720p")
    arrays = scene.build(cell.config["scene"], cell.root)
    passes = program.Passes(program.upload(arrays, "cpu"), cell.config,
                            dict(cell.traffic, spp_per_pass=1), 5)
    passes.run()
    port = passes.state.rgb_sum.reshape(-1, 3)
    geo = reference.Geometry(arrays, "cpu")
    basis = reference.camera_basis(cell.config["camera"], TINY["width"], TINY["height"])
    n = TINY["width"] * TINY["height"]
    ref = reference.radiance(geo, basis, TINY["width"], TINY["height"], 5,
                             torch.arange(n), torch.zeros(n, dtype=torch.int64),
                             dict(cell.config["render"], max_depth=TINY["max_depth"]))
    torch.testing.assert_close(ref, port, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integrator", ["wavefront", "scan"])
def test_reference_matches_the_port_per_sample_with_nee_and_roulette(integrator):
    """Config 4 at its depth of 16, NEE and roulette from bounce 3 on: one
    sample of every pixel on three seeds, the reference's radiance against
    the port's one-sample image. No pixel ties or grazes an edge here, so
    every one is held to the same tolerance."""
    cell = tiny_cell("cornell_glass.nee_512")
    render = dict(cell.config["render"], max_depth=16)
    assert render["nee"] and render["rr_start"] == 3
    arrays = scene.build(cell.config["scene"], cell.root)
    geo = reference.Geometry(arrays, "cpu")
    basis = reference.camera_basis(cell.config["camera"], TINY["width"], TINY["height"])
    n = TINY["width"] * TINY["height"]
    for seed in (5, 2**31 + 77, 123456789):
        passes = program.Passes(program.upload(arrays, "cpu"), cell.config,
                                dict(cell.traffic, integrator=integrator, max_depth=16,
                                     spp_per_pass=1), seed)
        assert passes.cfg.nee and passes.cfg.rr_start == 3
        passes.run()
        port = passes.state.rgb_sum.reshape(-1, 3)
        ref = reference.radiance(geo, basis, TINY["width"], TINY["height"], seed,
                                 torch.arange(n), torch.zeros(n, dtype=torch.int64),
                                 render)
        torch.testing.assert_close(ref, port, rtol=1e-5, atol=1e-5)
        # next-event estimation moved the estimate: without it the paths differ
        off = reference.radiance(geo, basis, TINY["width"], TINY["height"], seed,
                                 torch.arange(n), torch.zeros(n, dtype=torch.int64),
                                 dict(render, nee=False, rr_start=0))
        assert (off - port).abs().max() > 0.1


@pytest.mark.parametrize("config,traffic", [("reference", "scan_720p"),
                                            ("bunny300k", "wavefront_512"),
                                            ("multimesh", "sharded4_1080p")])
def test_the_reference_without_nee_is_as_it_was(config, traffic):
    """With neither `nee` nor `rr_start` set, the reference's radiance is
    bit for bit what it was before it gained them (`data/nee_off_radiance.npz`:
    two samples of every pixel of a 32x18 view at the traffic's depth)."""
    cfg = manifest.load_json(manifest.ROOT / "configs" / f"{config}.json")
    depth = int(manifest.load_json(manifest.ROOT / "traffic" / f"{traffic}.json")["max_depth"])
    assert "nee" not in cfg["render"] and "rr_start" not in cfg["render"]
    geo = reference.Geometry(scene.build(cfg["scene"], manifest.ROOT), "cpu")
    w, h = 32, 18
    basis = reference.camera_basis(cfg["camera"], w, h)
    pix = torch.arange(w * h).repeat_interleave(2)
    smp = torch.arange(2).repeat(w * h)
    got = reference.radiance(geo, basis, w, h, 2**31 + 5, pix, smp,
                             dict(cfg["render"], max_depth=depth))
    assert np.array_equal(got.numpy(), np.load(DATA / "nee_off_radiance.npz")[config])


def test_the_config_file_is_the_programs_loading_of_the_xml():
    """`configs/cornell_glass.json` is `scenes/cornell_glass.xml` as the
    program loads it, seen by config 4's camera."""
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.scene.xml_loader import load_scene_xml

    cfg = manifest.load_json(manifest.ROOT / "configs" / "cornell_glass.json")
    packed = load_scene_xml(str(manifest.REPO / "scenes" / "cornell_glass.xml")).pack()
    arrays = scene.build(cfg["scene"], manifest.ROOT)
    n = packed.num_real
    assert arrays.kind.shape[0] == n == 9 and arrays.n_triangles == cfg["triangles"] == 0
    pairs = {"kind": packed.prim_type, "p0": packed.p0, "p1": packed.p1, "p2": packed.p2,
             "albedo": packed.albedo, "material_type": packed.material_type,
             "emission": packed.emission_color, "power": packed.emission_power,
             "fuzz": packed.fuzz}
    for key, theirs in pairs.items():
        assert np.array_equal(getattr(arrays, key), theirs[:n]), key
    cam = Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
    for key in ("position", "forward", "up", "vfov_deg"):
        assert np.array_equal(np.float32(cfg["camera"][key]), getattr(cam, key).numpy()), key


def test_an_emissive_triangle_with_nee_is_refused_by_the_reference():
    cfg = manifest.load_json(manifest.ROOT / "configs" / "multimesh.json")
    cfg["scene"]["meshes"][-1].update(emission=[1.0, 1.0, 1.0], power=1.0)
    geo = reference.Geometry(scene.build(cfg["scene"], manifest.ROOT), "cpu")
    basis = reference.camera_basis(cfg["camera"], 8, 8)
    pix = torch.arange(4)
    with pytest.raises(ValueError, match="emissive triangles"):
        reference.radiance(geo, basis, 8, 8, 1, pix, torch.zeros_like(pix),
                           dict(cfg["render"], max_depth=2, nee=True))


def one_light(center, radius):
    """A geometry of one emitting sphere."""
    arrays = scene.build({"spheres": [{"center": center, "radius": radius,
                                       "emission": [1.0, 1.0, 1.0], "power": 2.0}]},
                         manifest.ROOT)
    return reference.Geometry(arrays, "cpu")


def test_the_cone_pdf_integrates_to_one_over_the_cone():
    """Directions uniform on the sphere, at a fixed seed: 4 pi times the
    mean of the pdf over those inside the cone is 1 within a few standard
    errors; every light sample lies in the cone, with the pdf of its
    direction."""
    geo = one_light([0.3, 4.0, -1.0], 1.5)
    point = torch.zeros(1, 3)
    g = torch.Generator().manual_seed(7)
    k = 1 << 20
    z = 2.0 * torch.rand(k, generator=g) - 1.0
    phi = 2.0 * math.pi * torch.rand(k, generator=g)
    r = torch.sqrt(1.0 - z * z)
    w = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    axis = reference.normalize(geo.light_center - point)
    cos_max = math.sqrt(1.0 - 1.5 ** 2 / float(reference.dot(geo.light_center, geo.light_center)))
    inside = (reference.dot(w, axis) > cos_max).double()
    pdf = float(reference.sphere_cone_pdf(geo.light_center, geo.light_radius, point))
    est = 4.0 * math.pi * pdf * inside
    assert abs(float(est.mean()) - 1.0) < 4.0 * float(est.std()) / math.sqrt(k)
    u = torch.rand(3, 4096, generator=g)
    ldir, dist, _, lpdf, row, valid = reference.sample_light(
        geo, point.expand(4096, 3), u[0], u[1], u[2])
    assert bool(valid.all())
    torch.testing.assert_close(dist, torch.linalg.vector_norm(geo.light_center, dim=-1)
                               .expand(4096))
    assert bool((reference.dot(ldir, axis) >= cos_max - 1e-6).all())
    t, hit = geo.closest_hit(point.expand(4096, 3), ldir)
    assert bool((hit == row).all())
    toward = reference.light_pdf_toward(geo, point.expand(4096, 3), hit)
    torch.testing.assert_close(toward, lpdf)
    # from inside the light no direction is drawn
    _, _, _, pdf_in, _, valid_in = reference.sample_light(
        geo, geo.light_center.expand(4, 3), u[0, :4], u[1, :4], u[2, :4])
    assert not bool(valid_in.any()) and bool((pdf_in == 0).all())


def test_the_two_mis_weights_of_a_direction_add_up_to_one():
    g = torch.Generator().manual_seed(3)
    a, b = torch.rand(2, 10000, generator=g) * torch.tensor([[1e-3], [1e3]])
    torch.testing.assert_close(reference.mis_weight(a, b) + reference.mis_weight(b, a),
                               torch.ones_like(a))


def test_a_path_that_roulette_kills_adds_nothing_after_its_bounce():
    """Inside a grey glowing sphere (albedo 0.5, every hit emits): with
    roulette from bounce 1 a path goes on past bounce 1 only where its RR
    uniform is under p = 0.25. A killed path's radiance at depth 16 is its
    radiance after two bounces; a survivor's is more."""
    arrays = scene.build({"spheres": [{"center": [0, 0, 0], "radius": 10.0,
                                       "albedo": [0.5, 0.5, 0.5],
                                       "emission": [1.0, 1.0, 1.0], "power": 0.5}]},
                         manifest.ROOT)
    geo = reference.Geometry(arrays, "cpu")
    cam = {"position": [0, 0, 0], "forward": [0, 0, -1], "up": [0, 1, 0], "vfov_deg": 60}
    basis = reference.camera_basis(cam, 16, 16)
    pix = torch.arange(256)
    smp = torch.zeros_like(pix)
    render = dict(clamp_radiance=False, adaptive_offset=True, rr_start=1)
    long = reference.radiance(geo, basis, 16, 16, 9, pix, smp, dict(render, max_depth=16))
    short = reference.radiance(geo, basis, 16, 16, 9, pix, smp, dict(render, max_depth=2))
    u, _ = reference.uniforms(9, pix, smp, 1, reference.PURPOSE_RR)
    killed = u >= 0.25
    assert 0 < int(killed.sum()) < 256
    assert torch.equal(long[killed], short[killed])
    assert bool((long[~killed] > short[~killed]).all())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    import control

    cell = tiny_cell(name)
    for seed in (1, 2, 3):
        nums = control.control_numbers(cell, seed, 5, "cpu")
        assert any(nums[k] > cell.limits[k] for k in nums), nums


class Faulty:
    """The harness's program module with its passes broken."""

    def __init__(self, fault):
        self.fault = fault
        for k in ("upload", "stats", "tallies", "release", "peak_bytes", "profiling",
                  "device_busy"):
            setattr(self, k, getattr(program, k))
        fault_ = fault

        class Passes(program.Passes):
            def run(self):
                if fault_ == "unchanged":
                    return pipeline.to_image(self.state).cpu().numpy(), 0
                if fault_ == "half":
                    full, before = self.spp, self.state
                    self.spp = full // 2
                    _, rays = super().run()
                    self.spp = full
                    added = (self.state.rgb_sum - before.rgb_sum) * (full / (full // 2))
                    self.state = pipeline.AccumState(before.rgb_sum + added,
                                                     before.spp + full)
                    return pipeline.to_image(self.state).cpu().numpy(), rays
                img, rays = super().run()
                return img[..., ::-1].copy(), rays  # red and blue swapped

        self.Passes = Passes


def test_a_non_finite_image_has_no_number():
    from harness import compare

    img = np.full((4, 3), np.nan, np.float32)
    assert compare.numbers({4: img}, {4: np.zeros((4, 3))}) == {
        "gap_mean": None, "off_share": None}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_pass_is_not_correct(name, fault):
    result, lines = run_tiny(tiny_cell(name), Faulty(fault))
    assert not result["correct"], lines
    assert result["failed"] > 0


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """A short run of the scan cell on the card: correct, with its metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, str(manifest.ROOT / "run.py"), "--workload",
                          "reference.scan_720p", "--seed", str(2**31 + 3), "--seconds",
                          "2", "--trace", "1"], capture_output=True, text=True,
                         timeout=600, cwd=str(manifest.REPO))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert "hit.device_ms_per_pass" in result["metrics"]


# ---------------------------------------------------------------------------
# the tile-sharded cell: four ranks of gloo on the CPU
# ---------------------------------------------------------------------------

SHARDED = "multimesh.sharded4_1080p"
TINY_SHARDED = dict(width=32, height=16, max_depth=3, spp_per_pass=2, check_pixels=64)


def sharded_cell():
    cell = manifest.Cell(manifest.load_json(manifest.REPO / "BENCHMARK.json"), SHARDED)
    cell.traffic = dict(cell.traffic, **TINY_SHARDED)
    return cell


def sharded_run(fault=None, seconds=0.3):
    from harness import sharded

    cell = sharded_cell()
    leader = sharded.Leader(cell, 2**31 + 9, "cpu", backend="gloo")
    if fault is not None:
        base = leader.Passes

        def make(scene_, config, traffic, seed):
            p = base(scene_, config, traffic, seed)
            run = p.run

            def broken():
                before = p.state
                img, rays = run()  # every rank joins the pass's collectives
                if fault == "unchanged":
                    p.state = before
                    return np.zeros_like(img), rays
                if fault == "exchange":  # the other ranks' blocks never arrive
                    img = img.copy()
                    img[img.shape[0] // 4:] = 0.0
                elif fault == "altered":
                    img = img[..., ::-1].copy()
                elif fault == "half":  # rank 0's block: half its samples, rescaled
                    img = img.copy()
                    img[:img.shape[0] // 4] *= 0.5
                return img, rays

            p.run = broken
            return p

        leader.Passes = make
    try:
        return bench.run(cell, 2**31 + 9, seconds, False, "cpu", time.perf_counter(),
                         leader)
    except BaseException:
        leader.close(kill=True)
        raise


def test_the_sharded_port_passes_its_check_on_four_gloo_ranks():
    result, lines = sharded_run()
    assert result["correct"], lines
    assert result["checks"]["gap_mean"]["value"] < 1e-6
    assert result["device"]["count"] == 4


@pytest.mark.parametrize("fault", ["unchanged", "half", "exchange", "altered"])
def test_a_broken_sharded_pass_is_not_correct(fault):
    result, lines = sharded_run(fault)
    assert not result["correct"], lines
