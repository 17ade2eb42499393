"""The port's shading, integrator, pipeline and CLI against the JAX reference.

Tolerances:
- one `_bounce_step` on identical inputs: the port draws the same threefry
  words and finds the same hits, so masks and ray counts are equal and
  every float output agrees to atol 1e-4 (sin/cos, sqrt and fused sums
  round differently by an ulp or so); the new origins, which are hit
  points, also to rtol 5e-4: on the Cornell box's r=1e4 wall spheres the
  reference's FMA-contracted quadratic moves t by up to ~2e-4 relative
  (the t bound of tests/test_intersect_mm.py);
- whole renders: a path whose hit flips at a triangle edge or a grazing
  sphere goes down another, equally valid, bounce chain, so renders are
  compared as tests/test_intersect_mm.py:76-78 compares two intersectors:
  under 2% of pixels differ by more than 1e-3, and the means differ by
  under 5e-3. Against the committed goldens (the reference's CPU renders)
  the RMSE is under 1e-2: the few divergent pixels (0.2% or fewer) carry
  differences up to ~0.3 each, which no tighter bound survives;
- the furnace: exactly 1.0, as every path adds exactly one unit of light.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch import cli as tcli
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.render.pipeline import generate_rays, render_image
from metalpathtracer_tpu.core import rng as jrng
from metalpathtracer_tpu.render import camera as jcam
from metalpathtracer_tpu.render import integrator as jint
from metalpathtracer_tpu.render import render_image as j_render_image
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_torch.scene import presets
from metalpathtracer_tpu.scene import presets as jpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
# the suite runs in several pytest-xdist workers at once: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _cornell_cam(m):
    return m.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


# the cases of tests/test_golden.py; `scene` and `camera` take the package's
# presets or camera module, so each side renders its own scene
GOLDEN = {
    "cornell_64_diffuse": dict(scene=lambda p: p.cornell_spheres(), camera=_cornell_cam,
                               width=64, height=64, spp=8, seed=42),
    "cornell_materials": dict(scene=lambda p: p.cornell_materials(), camera=_cornell_cam,
                              width=48, height=48, spp=8, seed=7),
    "reference_scene": dict(
        scene=lambda p: p.reference_default(
            os.path.join(REPO, "assets", "bunny.obj")),
        camera=lambda m: m.Camera.reset(),
        width=64, height=36, spp=4, seed=3,
    ),
}


@pytest.fixture(scope="module")
def cornell_mesh():
    # spheres, a light and 320 triangles
    return j_upload(jpresets.cornell_mesh()), t_upload(presets.cornell_mesh(), "cpu")


@pytest.mark.parametrize("nee,rr_start", [(False, 0), (True, 1)])
def test_bounce_step_matches_reference(cornell_mesh, nee, rr_start):
    js, ts = cornell_mesh
    w = h = 24
    n = w * h
    seed = 11
    pix = np.arange(n)
    o, d = generate_rays(_cornell_cam(tcam), w, h, torch.as_tensor(pix), 3, seed)
    r = np.random.default_rng(5)
    light = r.uniform(0, 0.5, (n, 3)).astype(np.float32)
    tp = r.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    active = r.uniform(size=n) > 0.2
    prev_pdf = np.where(r.uniform(size=n) > 0.5, r.uniform(0.1, 2.0, n),
                        0.0).astype(np.float32)
    args = (o.numpy(), d.numpy(), light, tp, active, prev_pdf)
    bounce = 2
    jcfg = jint.RenderConfig(max_depth=8, nee=nee, rr_start=rr_start)
    tcfg = tint.RenderConfig(max_depth=8, nee=nee, rr_start=rr_start)
    j_out = jint._bounce_step(
        js, *(jnp.asarray(a) for a in args), jnp.asarray(pix.astype(np.uint32)),
        jnp.uint32(3), jnp.uint32(bounce), jrng.seed_from_int(seed), jcfg,
    )
    t_out = tint._bounce_step(
        ts, *(torch.as_tensor(a) for a in args), torch.as_tensor(pix), 3, bounce,
        seed, tcfg,
    )
    names = ("o", "d", "light", "throughput", "active", "prev_pdf", "rays",
             "shadow_rays", "tile_passes")
    for name, t, j in zip(names, t_out, j_out):
        t, j = t.numpy(), np.asarray(j)
        if name in ("active", "rays", "shadow_rays"):
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            rtol = 5e-4 if name == "o" else 0.0
            np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-4, err_msg=name)
    if nee:
        assert int(t_out[7]) > 0  # shadow rays were traced
    assert (t_out[2].numpy() != light).any()


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_render_image_matches_reference(name):
    case = GOLDEN[name]
    size = (case["width"], case["height"], case["spp"])
    mine, rays = render_image(t_upload(case["scene"](presets), "cpu"),
                              case["camera"](tcam), *size,
                              seed=case["seed"], cfg=tint.RenderConfig(max_depth=8))
    theirs, j_rays = j_render_image(j_upload(case["scene"](jpresets)),
                                    case["camera"](jcam), *size,
                                    seed=case["seed"],
                                    cfg=jint.RenderConfig(max_depth=8))
    mine, theirs = mine.numpy(), np.asarray(theirs)
    assert mine.shape == (case["height"], case["width"], 3)
    assert np.isfinite(mine).all()
    diff = np.abs(mine - theirs)
    assert (diff > 1e-3).mean() < 0.02
    assert abs(mine.mean() - theirs.mean()) < 5e-3
    assert abs(rays - j_rays) <= 0.01 * j_rays
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
        golden = z["image"]
    assert float(np.sqrt(((mine - golden) ** 2).mean())) < 1e-2


def test_furnace_is_exactly_one():
    scene = t_upload(presets.furnace(1.0), "cpu")
    cam = tcam.Camera.look_at((0, 0, 0), (0, 0, -3), vfov_deg=40.0)
    img, _ = render_image(scene, cam, 24, 24, spp=16, seed=2,
                          cfg=tint.RenderConfig(max_depth=64))
    np.testing.assert_array_equal(img.numpy(), 1.0)


def test_spp_passes_sum_in_the_same_order():
    scene = t_upload(presets.cornell_spheres(), "cpu")
    cam = _cornell_cam(tcam)
    a, _ = render_image(scene, cam, 16, 16, spp=4, seed=1, spp_per_pass=1)
    b, _ = render_image(scene, cam, 16, 16, spp=4, seed=1, spp_per_pass=4)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_brute_intersector_renders_like_mm(cornell_mesh):
    _, ts = cornell_mesh
    cam = _cornell_cam(tcam)
    a, _ = render_image(ts, cam, 24, 24, spp=2, seed=5,
                        cfg=tint.RenderConfig(max_depth=6, intersector="brute"))
    b, _ = render_image(ts, cam, 24, 24, spp=2, seed=5,
                        cfg=tint.RenderConfig(max_depth=6, intersector="mm"))
    diff = np.abs(a.numpy() - b.numpy())
    assert (diff > 1e-3).mean() < 0.02
    assert abs(a.numpy().mean() - b.numpy().mean()) < 5e-3


STATS_KEYS = {"output", "width", "height", "spp", "seconds", "spp_per_sec",
              "rays", "mrays_per_sec"}


def test_cli_writes_png_on_cpu(tmp_path, capsys):
    from metalpathtracer_tpu.io.png import read_png

    out = tmp_path / "ref.png"
    npz = tmp_path / "ref.npz"
    rc = tcli.main([
        "--scene", os.path.join(REPO, "scenes", "reference.xml"),
        "--width", "32", "--height", "18", "--spp", "2", "--max-depth", "4",
        "--output", str(out), "--npz", str(npz), "--stats-json", "--device", "cpu",
        "--nee", "--rr-start", "2",
    ])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (18, 32, 3) and img.max() > 0
    with np.load(npz) as z:
        assert z["radiance"].shape == (18, 32, 3)
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(stats) == STATS_KEYS
    assert stats["rays"] > 32 * 18 * 2


@pytest.mark.parametrize("flag", ["--tile-shard"])
def test_cli_rejects_flags_not_ported(flag):
    # no flag of the reference is left to port: the one argparse rejected
    # while the sharded path was missing is defined, and off by default
    parser = tcli.build_parser()
    assert parser.parse_args(["--scene", "s.xml", flag]).tile_shard is True
    assert parser.parse_args(["--scene", "s.xml"]).tile_shard is False
    with pytest.raises(SystemExit) as e:  # still no flag the reference lacks
        parser.parse_args(["--scene", "s.xml", "--sample-shard"])
    assert e.value.code == 2


def _cli_radiance(tmp_path, name, extra, size=("32", "32")):
    npz = tmp_path / f"{name}.npz"
    argv = ["--scene", os.path.join(REPO, "scenes", "cornell.xml"), "--width",
            size[0], "--height", size[1], "--spp", "2", "--max-depth", "4",
            "--device", "cpu", "--stats-json", "--output",
            str(tmp_path / f"{name}.png"), "--npz", str(npz)]
    assert tcli.main(argv + extra) == 0
    with np.load(npz) as z:
        return z["radiance"]


@pytest.mark.parametrize("extra", [[], ["--wavefront"]], ids=["scan", "wavefront"])
def test_cli_tile_shard_in_a_world_of_one(tmp_path, capsys, extra):
    # no launcher and no process group: the sharded branch renders the
    # whole image, equal to the unsharded branch's
    plain = _cli_radiance(tmp_path, "plain", extra)
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sharded = _cli_radiance(tmp_path, "sharded", extra + ["--tile-shard"])
    sharded_stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_array_equal(sharded, plain)
    assert sharded_stats["rays"] == stats["rays"] and set(sharded_stats) == STATS_KEYS
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_cli_tile_shard_takes_precedence_over_checkpoint(tmp_path, capsys):
    # the reference's if / elif order: --tile-shard wins, no file is written
    ck = tmp_path / "ck.npz"
    plain = _cli_radiance(tmp_path, "plain", [])
    sharded = _cli_radiance(tmp_path, "sharded",
                            ["--tile-shard", "--checkpoint", str(ck)])
    np.testing.assert_array_equal(sharded, plain)
    assert not ck.exists()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_tile_shard_under_a_two_rank_launcher(tmp_path):
    # what a launcher does: one process per rank, the world described in the
    # environment; gloo on the CPU. One PNG and one stats line, from rank 0,
    # and the image equals the unsharded one
    plain = _cli_radiance(tmp_path, "plain", [])
    argv = [sys.executable, "-m", "metalpathtracer_torch.cli", "--scene",
            os.path.join(REPO, "scenes", "cornell.xml"), "--width", "32", "--height",
            "32", "--spp", "2", "--max-depth", "4", "--device", "cpu", "--stats-json",
            "--tile-shard"]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    ranks = []
    for rank in range(2):
        out = tmp_path / f"rank{rank}"
        out.mkdir()
        ranks.append(subprocess.Popen(
            argv + ["--output", str(out / "img.png"), "--npz", str(out / "img.npz")],
            cwd=REPO, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=120) for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in ranks] == [0, 0], outs
    # rank 1 is silent (but for what torch's own store may warn of)
    assert outs[1][0] == ""
    assert "Scene loaded" in outs[0][1] and "wrote" in outs[0][1]
    assert "Scene loaded" not in outs[1][1] and "wrote" not in outs[1][1]
    lines = outs[0][0].strip().splitlines()
    assert len(lines) == 1 and set(json.loads(lines[0])) == STATS_KEYS
    assert sorted(f.name for f in (tmp_path / "rank0").iterdir()) == ["img.npz", "img.png"]
    assert list((tmp_path / "rank1").iterdir()) == []
    with np.load(tmp_path / "rank0" / "img.npz") as z:
        np.testing.assert_array_equal(z["radiance"], plain)


@pytest.mark.parametrize("device,env", [("cuda:7", {}), ("cuda", {
    "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "7"})],
    ids=["explicit_index", "local_rank"])
def test_cli_tile_shard_refuses_a_device_it_does_not_have(monkeypatch, capsys,
                                                          device, env):
    # an index past the visible cards is an error: no wrap-around, no CPU
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert torch.cuda.device_count() <= 7
    rc = tcli.main(["--scene", os.path.join(REPO, "scenes", "cornell.xml"),
                    "--tile-shard", "--device", device])
    assert rc == 2
    assert "no device cuda:7" in capsys.readouterr().err
    import torch.distributed as dist

    assert not dist.is_initialized()


@pytest.mark.parametrize("flag", ["--resume", "--checkpoint=x.npz"])
def test_cli_accepts_checkpoint_flags(flag):
    args = tcli.build_parser().parse_args(["--scene", "s.xml", flag])
    assert args.resume == (flag == "--resume")
    assert args.checkpoint == ("x.npz" if flag.startswith("--checkpoint") else None)
    assert args.checkpoint_every == 16


def test_cli_has_every_flag_of_the_reference_but_tile_shard():
    from metalpathtracer_tpu import cli as jcli

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    mine, theirs = flags(tcli.build_parser()), flags(jcli.build_parser())
    assert theirs - mine == set()  # --tile-shard was the last one
    assert mine - theirs == {"--device"}
    assert tcli.build_parser().parse_args(["--scene", "s"]).device == "cuda"
    choices = {a.dest: a.choices for a in tcli.build_parser()._actions}
    assert choices["intersector"] == ["auto", "mm", "bvh", "brute"]


def test_port_never_imports_jax(tmp_path):
    # a fresh interpreter: import every module of the port and run its CLI,
    # on the scan and on the wavefront path, both tile-sharded branches (a
    # world of one, and a gloo group of one that the launcher's environment
    # describes), the checkpoint branch with a resume, the BVH intersector,
    # and two frames of the viewer (on a pty of
    # its own, drained by a thread); neither jax nor the JAX package
    # (metalpathtracer_tpu) may be loaded
    code = f"""
import importlib, os, pkgutil, pty, sys, threading, time
import metalpathtracer_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from metalpathtracer_torch import cli
argv = ["--scene", {os.path.join(REPO, "scenes", "reference.xml")!r},
        "--width", "16", "--height", "9", "--spp", "1", "--max-depth", "2",
        "--output", {str(tmp_path / "x.png")!r}, "--device", "cpu"]
assert cli.main(argv) == 0
assert cli.main(argv + ["--wavefront"]) == 0
assert cli.main(argv + ["--intersector", "bvh"]) == 0
assert cli.main(argv + ["--tile-shard"]) == 0
assert cli.main(argv + ["--tile-shard", "--wavefront"]) == 0
import socket
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
import torch.distributed as dist
assert cli.main(argv + ["--tile-shard", "--wavefront"]) == 0
assert not dist.is_initialized()
for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
    del os.environ[k]
ck = ["--checkpoint", {str(tmp_path / "ck.npz")!r}, "--checkpoint-every", "1"]
assert cli.main(argv + ck) == 0
assert cli.main(argv[:7] + ["2"] + argv[8:] + ck + ["--resume"]) == 0
from metalpathtracer_torch.io.checkpoint import load_checkpoint
assert load_checkpoint(ck[1], "cpu")[0].spp == 2
from metalpathtracer_torch import viewer
master, slave = pty.openpty()
shown = []
def drain():
    while True:
        try:
            data = os.read(master, 65536)
        except OSError:
            return
        if not data:
            return
        shown.append(data)
threading.Thread(target=drain, daemon=True).start()
saved = os.dup(0), os.dup(1)
os.dup2(slave, 0); os.dup2(slave, 1)
try:
    assert viewer.main(["--scene", argv[1], "--width", "32", "--height", "16",
                        "--max-depth", "2", "--max-frames", "2", "--no-mouse",
                        "--device", "cpu"]) == 0
    sys.stdout.flush()
finally:
    os.dup2(saved[0], 0); os.dup2(saved[1], 1)
deadline = time.time() + 30  # the drain thread may still be reading
while b"2 spp |" not in b"".join(shown) and time.time() < deadline:
    time.sleep(0.05)
assert b"2 spp |" in b"".join(shown), shown[-1:]
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not leaked, leaked
reference = sorted(m for m in sys.modules if m.split(".")[0] == "metalpathtracer_tpu")
assert not reference, reference
print("no jax")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("no jax")
