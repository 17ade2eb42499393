#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`metalpathtracer_torch`) on one card.

Builds the hand-written CUDA closest-hit kernel from `metalpathtracer_torch/
csrc/`, holds it to its plain PyTorch twin and to the brute-force oracle at
the shapes of the CLI's default render, then drives that render through the
port's CLI at full size (scenes/reference.xml, 1280x720, spp 4, depth 32)
and checks that every bounce went through the kernel. Phases, each raising
on failure:

1. set up: the card, TF32 off, the kernel build;
2. kernel vs twin on the 921,600 primary rays and the rays left after one
   bounce: hit columns equal except at near-ties and triangle edges, t
   within the CPU tests' bound; kernel and twin timed with CUDA events;
3. `closest_hit_mm_full` with the kernel vs the brute-force oracle on a
   65,536-ray subset (tests/test_intersect_mm.py's criteria);
4. the slice: the port's `cli.main` at full size on `cuda`, with launch
   counts reset just before and read just after;
5. the slice vs itself on the twin (320x180, spp 2, depth 8), and a render
   of the reference-scene golden case vs tests/golden/reference_scene.npz.

The second-to-last lines of standard output are the kernels' JSON record and
the card's name and power limit; the last line is the result JSON. Writes
images and the compiler log under chiprun_out/chip_smoke/.

Usage:
    python3 chip_smoke.py            # what a check runs
    python3 chip_smoke.py --profile  # also a torch.profiler table of the slice
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
T_MIN = 1e-4
# t of a hit both sides agree on: the CPU tests' closest-hit bound
# (tests/test_torch_closest_hit.py, from tests/test_intersect_mm.py)
T_RTOL, T_ATOL = 5e-4, 1e-2
# a ray whose winners differ may pass this close to a triangle edge
# (barycentric units, float64): a float32 accept/reject flip
EDGE_MARGIN = 1e-3
# at most this share of rays may differ at all
MAX_MISMATCH = 1e-4
KERNEL_SOURCE = "metalpathtracer_torch/csrc/mm_closest_hit.cu"
REPLACES = "metalpathtracer_tpu/render/pallas/intersect_mm.py:477"
ALSO_REPLACES = "metalpathtracer_tpu/render/pallas/intersect_mm.py:555"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def edge_margin(scene, o, d, prim):
    """Float64 Moller-Trumbore of each ray against triangle `prim` (numpy
    arrays; prim -1 or a sphere gives +inf): the smallest barycentric
    coordinate's distance from 0, i.e. how close the ray passes to an edge."""
    import numpy as np

    from metalpathtracer_torch.scene import PRIM_TRIANGLE

    p0 = scene.p0.cpu().numpy().astype(np.float64)
    p1 = scene.p1.cpu().numpy().astype(np.float64)
    p2 = scene.p2.cpu().numpy().astype(np.float64)
    is_tri = scene.prim_type.cpu().numpy() == PRIM_TRIANGLE
    prim = np.asarray(prim)
    ok = (prim >= 0) & is_tri[np.maximum(prim, 0)]
    k = np.maximum(prim, 0)
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    e1 = p1[k] - p0[k]
    e2 = p2[k] - p0[k]
    h = np.cross(d, e2)
    a = np.sum(e1 * h, -1)
    a = np.where(np.abs(a) < 1e-300, 1e-300, a)
    s = o - p0[k]
    u = np.sum(s * h, -1) / a
    v = np.sum(d * np.cross(s, e1), -1) / a
    margin = np.abs(np.stack([u, v, 1.0 - u - v], -1)).min(-1)
    return np.where(ok, margin, np.inf)


def judge_mismatches(scene, o, d, prim_a, t_a, prim_b, t_b, what: str):
    """Where two closest hits name different primitives, each such ray must
    be a near-tie (both hit, t within 1e-4 relative) or pass within
    EDGE_MARGIN of an edge of either winner; at most MAX_MISMATCH of the
    rays may differ. Returns (n_mismatch, n_near_tie, n_edge)."""
    import numpy as np

    diff = (prim_a != prim_b).nonzero().flatten()
    n = prim_a.shape[0]
    if diff.numel() == 0:
        return 0, 0, 0
    k = diff.cpu().numpy()
    ta = t_a[diff].cpu().numpy()
    tb = t_b[diff].cpu().numpy()
    pa = prim_a[diff].cpu().numpy()
    pb = prim_b[diff].cpu().numpy()
    oo = o[diff].cpu().numpy()
    dd = d[diff].cpu().numpy()
    with np.errstate(invalid="ignore"):  # inf - inf where both miss
        tie = (np.isfinite(ta) & np.isfinite(tb)
               & (np.abs(ta - tb) <= 1e-4 * np.maximum(np.abs(tb), 1.0)))
    edge = (np.minimum(edge_margin(scene, oo, dd, pa), edge_margin(scene, oo, dd, pb))
            < EDGE_MARGIN)
    bad = ~(tie | edge)
    if bad.any():
        raise RuntimeError(
            f"{what}: {int(bad.sum())} rays differ away from any tie or edge, "
            f"e.g. ray {int(k[bad][0])}: prim {int(pa[bad][0])} t {ta[bad][0]} "
            f"vs prim {int(pb[bad][0])} t {tb[bad][0]}"
        )
    if len(k) > MAX_MISMATCH * n:
        raise RuntimeError(f"{what}: {len(k)} of {n} rays differ "
                           f"(bound {MAX_MISMATCH:g})")
    return len(k), int(tie.sum()), int((edge & ~tie).sum())


@contextlib.contextmanager
def twin_closest_hit():
    """Route `closest_hit_mm_full` through the kernel's plain twin."""
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    kernel = tmm.mm_closest_hit
    tmm.mm_closest_hit = tmm.mm_closest_hit_reference
    try:
        yield
    finally:
        tmm.mm_closest_hit = kernel


def phase_setup():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if not (ROOT / "metalpathtracer_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from the root of a checkout of the repo")
    card = nvidia_smi()
    log(f"[1] card: {card}")
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from metalpathtracer_torch.render.kernels import _build

    t0 = time.perf_counter()
    so = _build.build("mm_closest_hit")
    build_s = time.perf_counter() - t0
    compiler_log = so.with_name(so.name + ".log").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "nvcc.log").write_text(compiler_log)
    log(f"[1] built {so.name} in {build_s:.2f} s; ptxas:")
    for line in compiler_log.splitlines():
        if "ptxas" in line:
            log(f"    {line.strip()}")
    return card, build_s


def phase_kernel_vs_twin(scene, dev, w=1280, h=720):
    import torch

    from metalpathtracer_torch.core import rng
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.pipeline import generate_rays

    n = w * h
    seed = rng.seed_from_int(0)
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    o, d = generate_rays(Camera.reset(), w, h, pix, 0, seed)
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    step = tint._bounce_step(
        scene, o, d, torch.zeros((n, 3), device=dev), torch.ones((n, 3), device=dev),
        ones, torch.zeros((n,), device=dev), pix, 0, 0, seed, tint.RenderConfig(),
    )
    sets = {"primary": (o, d, None), "bounce1": (step[0], step[1], step[4])}
    record = {}
    for name, (so, sd, act) in sets.items():
        t_s = tmm._sphere_hit_exact(scene, so, sd, T_MIN)[0]
        args = tmm.kernel_inputs(scene, so, sd, t_s, act, T_MIN) + (scene.mm_w, T_MIN)
        tk, ck = tmm.mm_closest_hit(*args)
        tr, cr = tmm.mm_closest_hit_reference(*args)
        torch.cuda.synchronize()
        tk, ck, tr, cr = tk[:n], ck[:n], tr[:n], cr[:n]
        tri_ids = scene.mm_tri_ids.long()

        def prim(col):
            return torch.where(col >= 0, tri_ids[col.clamp(min=0).long()], -1)

        n_mis, n_tie, n_edge = judge_mismatches(
            scene, so, sd, prim(ck), tk, prim(cr), tr, f"kernel vs twin ({name})")
        same = (ck == cr) & torch.isfinite(tr)
        err = (tk[same] - tr[same]).abs()
        bound = T_RTOL * tr[same].abs() + T_ATOL
        if not bool((err <= bound).all()):
            raise RuntimeError(f"kernel vs twin ({name}): t off by {float(err.max())}")
        both_miss = (ck == -1) & (cr == -1)
        if not bool(torch.isinf(tk[both_miss]).all()):
            raise RuntimeError(f"kernel vs twin ({name}): a miss has a finite t")
        hits = int((cr >= 0).sum())
        k_ms = cuda_ms(lambda: tmm.mm_closest_hit(*args), 20)
        r_ms = cuda_ms(lambda: tmm.mm_closest_hit_reference(*args), 3)
        passing = float(args[1].float().mean())
        record[name] = dict(
            rays=n, active=int(act.sum()) if act is not None else n,
            triangle_hits=hits, mismatches=n_mis, near_ties=n_tie, edges=n_edge,
            max_abs_err=float(err.max()) if err.numel() else 0.0,
            ms=k_ms, plain_ms=r_ms, mean_passing_tiles=passing,
        )
        log(f"[2] {name}: {hits} triangle hits, {n_mis} differ "
            f"({n_tie} near-ties, {n_edge} edges), max |dt| "
            f"{record[name]['max_abs_err']:.3g}; kernel {k_ms:.3f} ms, "
            f"twin {r_ms:.3f} ms, {passing:.2f} passing tiles per subgroup")
    return sets, record


def phase_oracle(scene, sets):
    import torch

    from metalpathtracer_torch.render.intersect import closest_hit_bruteforce
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    g = torch.Generator(device="cpu").manual_seed(0)
    o_p, d_p, _ = sets["primary"]
    o_b, d_b, act = sets["bounce1"]
    live = act.nonzero().flatten().cpu()
    pick_p = torch.randperm(o_p.shape[0], generator=g)[:32768].to(o_p.device)
    pick_b = live[torch.randperm(live.numel(), generator=g)[:32768]].to(o_p.device)
    o = torch.cat([o_p[pick_p], o_b[pick_b]])
    d = torch.cat([d_p[pick_p], d_b[pick_b]])
    before = tmm.mm_closest_hit.launches
    t1, i1, *_ = tmm.closest_hit_mm_full(scene, o, d, T_MIN)
    if tmm.mm_closest_hit.launches != before + 1:
        raise RuntimeError("closest_hit_mm_full did not launch the kernel")
    t0, i0 = closest_hit_bruteforce(scene, o, d, T_MIN, chunk=1024)
    n_mis, n_tie, n_edge = judge_mismatches(scene, o, d, i1, t1, i0, t0,
                                            "kernel path vs brute oracle")
    same = (i1 == i0) & torch.isfinite(t0)
    err = (t1[same] - t0[same]).abs()
    if not bool((err <= T_RTOL * t0[same].abs() + T_ATOL).all()):
        raise RuntimeError(f"kernel path vs brute oracle: t off by {float(err.max())}")
    hits = int((i0 >= 0).sum())
    tri_hits = int((i0 >= 3).sum())
    log(f"[3] {o.shape[0]} rays: {hits} hits ({tri_hits} triangles), "
        f"{n_mis} differ ({n_tie} near-ties, {n_edge} edges), "
        f"max |dt| {float(err.max()):.3g}")
    return dict(rays=o.shape[0], hits=hits, mismatches=n_mis,
                max_abs_err=float(err.max()))


def phase_slice(profile: bool, w=1280, h=720, device="cuda"):
    import numpy as np
    import torch

    from metalpathtracer_torch import cli
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    png = OUT / f"reference_{w}x{h}.png"
    npz = OUT / f"reference_{w}x{h}.npz"
    argv = ["--scene", str(ROOT / "scenes" / "reference.xml"), "--width", str(w),
            "--height", str(h), "--spp", "4", "--max-depth", "32", "--stats-json",
            "--device", device, "--output", str(png), "--npz", str(npz)]
    steps = [0]
    twin_calls = [0]
    bounce_step = tint._bounce_step
    twin = tmm.mm_closest_hit_reference

    def counted_step(*a, **k):
        steps[0] += 1
        return bounce_step(*a, **k)

    def counted_twin(*a, **k):
        twin_calls[0] += 1
        return twin(*a, **k)

    tint._bounce_step = counted_step
    tmm.mm_closest_hit_reference = counted_twin
    out = io.StringIO()
    try:
        torch.cuda.synchronize()
        tmm.mm_closest_hit.launches = 0
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        launches = tmm.mm_closest_hit.launches
    finally:
        tint._bounce_step = bounce_step
        tmm.mm_closest_hit_reference = twin
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    if twin_calls[0]:
        raise RuntimeError(f"the slice ran the plain twin {twin_calls[0]} times")
    if launches < steps[0] or steps[0] == 0:
        raise RuntimeError(f"{launches} kernel launches for {steps[0]} bounces")
    with np.load(npz) as z:
        img = z["radiance"]
    if img.shape != (h, w, 3) or not np.isfinite(img).all():
        raise RuntimeError(f"bad image: {img.shape}, finite {np.isfinite(img).all()}")
    if not img.mean() > 0.05:
        raise RuntimeError(f"image is black: mean {img.mean()}")
    log(f"[4] cli: {stats['seconds']} s, {stats['rays']} rays, "
        f"{stats['mrays_per_sec']} Mrays/s, {steps[0]} bounces, {launches} "
        f"kernel launches, image mean {img.mean():.4f}")
    result = dict(stats=stats, bounces=steps[0], launches=launches,
                  image_mean=float(img.mean()))
    if profile:
        result["profile"] = profile_slice(argv)
    return result


def profile_slice(argv) -> str:
    """Run the slice once more under torch.profiler; keep the kernel table."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from metalpathtracer_torch import cli

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with contextlib.redirect_stdout(io.StringIO()), profile(activities=acts) as prof:
        cli.main(argv)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (OUT / "profile.txt").write_text(table)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time for e in events)
    span_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events)) if events else 0.0
    summary = (f"device kernel time {busy_us / 1e3:.1f} ms over a device span of "
               f"{span_us / 1e3:.1f} ms ({len(events)} kernels)")
    log(f"[4] profile: {summary}; table in {OUT / 'profile.txt'}")
    log(table)
    return summary


def phase_slice_vs_twin(device="cuda"):
    import numpy as np
    import torch

    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.pipeline import render_image
    from metalpathtracer_torch.scene import load_scene_xml, presets

    host = load_scene_xml(str(ROOT / "scenes" / "reference.xml"))
    scene = upload_scene(host, device)
    cfg = RenderConfig(max_depth=8)
    a, _ = render_image(scene, Camera.reset(), 320, 180, 2, seed=1, cfg=cfg)
    with twin_closest_hit():
        b, _ = render_image(scene, Camera.reset(), 320, 180, 2, seed=1, cfg=cfg)
    a, b = a.cpu().numpy(), b.cpu().numpy()
    frac = float((np.abs(a - b) > 1e-3).mean())
    dmean = float(abs(a.mean() - b.mean()))
    if not (np.isfinite(a).all() and frac < 0.02 and dmean < 5e-3):
        raise RuntimeError(f"kernel vs twin render: {frac} divergent, mean diff {dmean}")
    log(f"[5] 320x180 spp 2 depth 8: {frac:.5f} of pixels differ by > 1e-3, "
        f"means differ by {dmean:.2e}")

    # the golden reference-scene case of tests/test_golden.py, on the card
    golden_scene = upload_scene(
        presets.reference_default(str(ROOT / "assets" / "bunny.obj")), device)
    img, _ = render_image(golden_scene, Camera.reset(), 64, 36, 4, seed=3, cfg=cfg)
    img = img.cpu().numpy()
    with np.load(ROOT / "tests" / "golden" / "reference_scene.npz") as z:
        golden = z["image"]
    rmse = float(np.sqrt(((img - golden) ** 2).mean()))
    gfrac = float((np.abs(img - golden) > 1e-3).mean())
    if not (rmse < 1e-2 and gfrac < 0.02):
        raise RuntimeError(f"golden reference_scene: RMSE {rmse}, {gfrac} divergent")
    log(f"[5] golden reference_scene on {device}: RMSE {rmse:.2e}, {gfrac:.5f} divergent")
    return dict(divergent=frac, mean_diff=dmean, golden_rmse=rmse)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the slice with torch.profiler")
    args = ap.parse_args(argv)

    card, build_s = phase_setup()
    import torch

    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.scene import load_scene_xml

    dev = torch.device("cuda")
    scene = upload_scene(load_scene_xml(str(ROOT / "scenes" / "reference.xml")), dev)
    log(f"[1] reference scene: {scene.num_tris} triangles in "
        f"{scene.mm_tile_box.shape[0]} tiles of {scene.mm_w.shape[1]}")
    sets, kvt = phase_kernel_vs_twin(scene, dev)
    oracle = phase_oracle(scene, sets)
    slice_ = phase_slice(args.profile)
    twin = phase_slice_vs_twin()

    kernels = {"kernels": [{
        "name": "mm_closest_hit", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "also_replaces": ALSO_REPLACES,
        "launches": slice_["launches"],
        "max_abs_err": kvt["primary"]["max_abs_err"],
        "ms": kvt["primary"]["ms"], "plain_ms": kvt["primary"]["plain_ms"],
    }]}
    summary = dict(card=card, build_s=build_s, kernel_vs_twin=kvt, oracle=oracle,
                   slice=slice_, slice_vs_twin=twin)
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
