"""The final scene of "Ray Tracing in One Weekend" (P. Shirley, T. D. Black,
S. Hollasch, v4.0.1, section 14.1 "A Final Render") on the port, on the CPU.

- `book_spheres` follows the book's loop and its order of random draws with
  a stated generator, and wrote the sphere list of the benchmark's
  configuration `portbench/configs/rtiow_final.json`; the configuration is
  held equal to its output, and the scene to the book's rules (the
  material shares, the radii, the exclusion around (4, 0.2, 0)).
- The port's scan and wavefront render every sphere of the configuration,
  sample by sample, as the benchmark's plain reference does
  (`portbench/harness/reference.py`, loaded by path as the benchmark's own
  tests load it), at 24x14 pixels, 2 samples, depth 50, with glass hit
  from outside and inside and fuzzed metal hit.
- `graphs.STATS["sphere_tests"]` counts the ray-sphere tests handed to the
  sphere pass: lanes times the sphere table's rows (its padding too, as
  the kernel's loop runs them), once a call.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import program, reference, scene  # noqa: E402
from metalpathtracer_torch.render import graphs  # noqa: E402
from metalpathtracer_torch.render.kernels import intersect_mm  # noqa: E402

CONFIG = BENCH / "configs" / "rtiow_final.json"
# the generator of the configuration's spheres: numpy's PCG64, one
# `random()` a draw of the book's `random_double()`
GEN_SEED = 14
LOOKFROM, LOOKAT = (13.0, 2.0, 3.0), (0.0, 0.0, 0.0)
W, H, SPP, DEPTH = 24, 14, 2, 50


def book_spheres(seed: int = GEN_SEED) -> list[dict]:
    """The book's final scene as the configuration's sphere list, drawn in
    the book's order: for a, b in [-11, 11), choose_mat, then the center's
    x and z offsets (x first: the book leaves the order of a constructor's
    arguments to its compiler); a center within 0.9 of (4, 0.2, 0) is
    skipped and draws nothing more; otherwise 80% Lambertian with albedo
    random3 * random3 (the first factor drawn first), 15% metal with albedo
    U(0.5, 1)^3 and then fuzz U(0, 0.5), 5% glass of IOR 1.5. Before them
    the ground, after them the three large spheres."""
    g = np.random.default_rng(seed)

    def rand():
        return float(g.random())

    out = [dict(center=[0.0, -1000.0, 0.0], radius=1000.0, albedo=[0.5, 0.5, 0.5])]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rand()
            center = [a + 0.9 * rand(), 0.2, b + 0.9 * rand()]
            off = [center[0] - 4.0, center[1] - 0.2, center[2] - 0.0]
            if math.sqrt(off[0] * off[0] + off[1] * off[1] + off[2] * off[2]) <= 0.9:
                continue
            if choose < 0.8:
                c1 = [rand() for _ in range(3)]
                c2 = [rand() for _ in range(3)]
                out.append(dict(center=center, radius=0.2,
                                albedo=[p * q for p, q in zip(c1, c2)]))
            elif choose < 0.95:
                albedo = [0.5 + 0.5 * rand() for _ in range(3)]
                out.append(dict(center=center, radius=0.2, albedo=albedo,
                                material_type=-1.0, fuzz=0.5 * rand()))
            else:
                out.append(dict(center=center, radius=0.2, albedo=[1.0, 1.0, 1.0],
                                material_type=1.5))
    out.append(dict(center=[0.0, 1.0, 0.0], radius=1.0, albedo=[1.0, 1.0, 1.0],
                    material_type=1.5))
    out.append(dict(center=[-4.0, 1.0, 0.0], radius=1.0, albedo=[0.4, 0.2, 0.1]))
    out.append(dict(center=[4.0, 1.0, 0.0], radius=1.0, albedo=[0.7, 0.6, 0.5],
                    material_type=-1.0, fuzz=0.0))
    return out


def book_forward() -> list[float]:
    """The camera's forward: the float32 unit vector from lookfrom toward
    lookat."""
    d = np.subtract(LOOKAT, LOOKFROM)
    return [float(x) for x in (d / np.linalg.norm(d)).astype(np.float32)]


def load_config() -> dict:
    return json.loads(CONFIG.read_text())


def test_the_configuration_is_the_generators_output():
    cfg = load_config()
    assert cfg["scene"]["spheres"] == book_spheres()
    assert cfg["scene"]["meshes"] == [] and cfg["triangles"] == 0
    assert cfg["camera"] == {"position": list(LOOKFROM), "forward": book_forward(),
                             "up": [0.0, 1.0, 0.0], "vfov_deg": 20.0}
    assert cfg["source_settings"] == {
        "width": 1200, "height": 675, "max_depth": 50, "spp": 500, "vfov": 20,
        "lookfrom": list(LOOKFROM), "lookat": list(LOOKAT), "defocus_angle": 0.6,
        "focus_dist": 10}
    assert cfg["reduced"] == ["spp"]
    assert cfg["render"] == {"clamp_radiance": False, "adaptive_offset": True,
                             "nee": False, "rr_start": 0}
    assert any(f"seeded {GEN_SEED}" in a for a in cfg["assumed"])


def test_the_scene_follows_the_book():
    spheres = book_spheres()
    ground, small, big = spheres[0], spheres[1:-3], spheres[-3:]
    assert ground == dict(center=[0.0, -1000.0, 0.0], radius=1000.0,
                          albedo=[0.5, 0.5, 0.5])
    assert [s["radius"] for s in big] == [1.0, 1.0, 1.0]
    assert all(s["radius"] == 0.2 and s["center"][1] == 0.2 for s in small)
    # one sphere at most in each grid cell [a, a + 0.9) x [b, b + 0.9), none
    # within 0.9 of (4, 0.2, 0)
    cells = {(math.floor(s["center"][0]), math.floor(s["center"][2])) for s in small}
    assert len(cells) == len(small)
    assert all(0.0 <= s["center"][0] - math.floor(s["center"][0]) < 0.9
               and 0.0 <= s["center"][2] - math.floor(s["center"][2]) < 0.9
               for s in small)
    assert all(math.dist(s["center"], (4.0, 0.2, 0.0)) > 0.9 for s in small)
    assert {a for a, _ in cells} <= set(range(-11, 11))
    assert {b for _, b in cells} <= set(range(-11, 11))
    skipped = 22 * 22 - len(small)
    assert 0 < skipped <= 4  # the cells (3|4, -1|0) alone can come that close
    kinds = {"diffuse": [], "metal": [], "glass": []}
    for s in small:
        mt = s.get("material_type", 0.0)
        kinds["diffuse" if mt == 0.0 else "metal" if mt == -1.0 else "glass"].append(s)
    assert all(0.0 <= c < 1.0 for s in kinds["diffuse"] for c in s["albedo"])
    assert all(0.5 <= c < 1.0 for s in kinds["metal"] for c in s["albedo"])
    assert all(0.0 <= s["fuzz"] < 0.5 for s in kinds["metal"])
    assert all(s["material_type"] == 1.5 and s["albedo"] == [1.0, 1.0, 1.0]
               for s in kinds["glass"])
    # the shares: 80 / 15 / 5 %, each within three binomial deviations
    n = len(small)
    for kind, p in (("diffuse", 0.8), ("metal", 0.15), ("glass", 0.05)):
        assert abs(len(kinds[kind]) / n - p) < 3 * math.sqrt(p * (1 - p) / n), kind
    # about as many distinct materials as spheres
    arrays = scene.build(load_config()["scene"], BENCH)
    mats = np.concatenate([arrays.albedo, arrays.material_type[:, None],
                           arrays.fuzz[:, None]], 1)
    assert np.unique(mats, axis=0).shape[0] >= len(spheres) - len(kinds["glass"]) - 2


@pytest.fixture(scope="module")
def rtiow():
    """The configuration, its scene arrays and the port's scene on the CPU."""
    cfg = load_config()
    arrays = scene.build(cfg["scene"], BENCH)
    return cfg, arrays, program.upload(arrays, "cpu")


def _port_samples(cfg, dev_scene, integrator, seed):
    """The port's radiance of samples 0 .. SPP - 1 of every pixel, one
    (W * H, 3) tensor a sample: the sums after passes of one sample each,
    through the benchmark's `program.Passes` over the progressive entries."""
    traffic = dict(integrator=integrator, width=W, height=H, max_depth=DEPTH,
                   spp_per_pass=1, pool=256)
    passes = program.Passes(dev_scene, cfg, traffic, seed)
    out, before = [], torch.zeros((W * H, 3))
    for _ in range(SPP):
        passes.run()
        total = passes.state.rgb_sum.reshape(-1, 3).clone()
        out.append(total - before)
        before = total
    return out


@pytest.mark.parametrize("integrator", ["scan", "wavefront"])
def test_the_port_renders_the_scene_as_the_reference_does(rtiow, integrator,
                                                          monkeypatch):
    """Every pixel's samples 0 and 1 on three seeds at depth 50, with every
    sphere of the configuration: the reference's radiance against the
    port's, each pixel at rtol and atol 1e-5 (the benchmark's CPU tests'
    tolerance: the sample-1 image is the difference of the port's sums)
    but at most 1% of them (3 of 336) a sample. Those are paths that part:
    the port normalises a primary ray by `torch.linalg.vector_norm`, the
    reference by the square root of its dot product, so on this camera,
    whose axes are not the world's, a direction can differ in its last bit
    or two, and on a ray that grazes one of the 483 small spheres that
    moves the hit and the path after it (12 seeds at this size: 0 to 2
    such pixels a sample). The reference's scatter calls are recorded:
    glass is hit from outside and from inside, and fuzzed metal is hit."""
    cfg, arrays, dev_scene = rtiow
    geo = reference.Geometry(arrays, "cpu")
    basis = reference.camera_basis(cfg["camera"], W, H)
    seen = dict(glass_out=0, glass_in=0, fuzzed_metal=0)
    scatter = reference.sample_bsdf

    def recording(d, n, front, mtype, fuzz, unit, u_fresnel):
        glass = mtype > 0
        seen["glass_out"] += int((glass & front).sum())
        seen["glass_in"] += int((glass & ~front).sum())
        seen["fuzzed_metal"] += int(((mtype < 0) & (fuzz > 0)).sum())
        return scatter(d, n, front, mtype, fuzz, unit, u_fresnel)

    monkeypatch.setattr(reference, "sample_bsdf", recording)
    n = W * H
    render = dict(cfg["render"], max_depth=DEPTH)
    for seed in (5, 2**31 + 77, 123456789):
        port = _port_samples(cfg, dev_scene, integrator, seed)
        for sample, got in enumerate(port):
            want = reference.radiance(geo, basis, W, H, seed, torch.arange(n),
                                      torch.full((n,), sample, dtype=torch.int64),
                                      render)
            close = torch.isclose(got, want, rtol=1e-5, atol=1e-5).all(1)
            assert int((~close).sum()) <= n // 100, (seed, sample, (~close).nonzero())
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("integrator", ["scan", "wavefront"])
def test_sphere_tests_count_lanes_times_spheres_a_call(rtiow, integrator, monkeypatch):
    """`STATS["sphere_tests"]` after a pass: the lanes each call of the
    sphere pass was handed times the rows of the sphere table (the
    scene's 487 spheres and one padding row, all of which the kernel's loop
    tests), summed over the calls."""
    cfg, arrays, dev_scene = rtiow
    real = int((arrays.kind == scene.SPHERE).sum())
    assert real == len(cfg["scene"]["spheres"]) == 487
    assert int((dev_scene.sph_ids >= 0).sum()) == real
    spheres = dev_scene.sph_center.shape[0]
    assert spheres == 488  # padded to a multiple of 8
    lanes = []
    sphere_pass = intersect_mm.sphere_pass

    def counted(o, *args):
        lanes.append(o.shape[0])
        return sphere_pass(o, *args)

    monkeypatch.setattr(intersect_mm, "sphere_pass", counted)
    graphs.clear()
    graphs.zero_stats()
    traffic = dict(integrator=integrator, width=W, height=H, max_depth=DEPTH,
                   spp_per_pass=SPP, pool=256)
    program.Passes(dev_scene, cfg, traffic, 7).run()
    graphs.clear()
    assert lanes and graphs.STATS["sphere_tests"] == sum(lanes) * spheres
    if integrator == "scan":  # every lane of every step, live or not
        # a sample runs blocks of 8 steps until no lane is live, and the
        # last block of 50 % 8 = 2 steps where it gets that far
        steps = {8, 16, 24, 32, 40, 48, 50}
        assert set(lanes) == {W * H}
        assert len(lanes) in {a + b for a in steps for b in steps}


def test_zero_stats_zeroes_the_sphere_tests_and_clear_keeps_them():
    graphs.zero_stats()
    graphs.STATS["sphere_tests"] += 3
    graphs.clear()
    assert graphs.STATS["sphere_tests"] == 3
    graphs.zero_stats()
    assert graphs.STATS["sphere_tests"] == 0
