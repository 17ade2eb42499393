"""The check that decides `correct`, at a tiny size on the CPU: the plain
reference against the port, the control (the reference in bfloat16 in the
program's place) failing the cells' limits, and a whole run with the timed
path broken underneath coming out not correct, once for each fault the
cells can have (a pass that returns its state unchanged; half of each
pass's samples left out and the mean taken over the rest; the answer
altered where it is produced). Only this file imports both sides."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harness import bench, manifest, program, reference, scene
from metalpathtracer_torch.render import pipeline

CELLS = ("reference.wavefront_720p", "reference.scan_720p", "bunny300k.wavefront_512")
TINY = dict(width=32, height=18, max_depth=4, spp_per_pass=2, check_pixels=64, pool=256)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny_cell(name):
    cell = manifest.Cell(manifest.load_json(manifest.REPO / "BENCHMARK.json"), name)
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
