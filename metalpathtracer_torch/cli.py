"""Command-line renderer on PyTorch.

Port of `metalpathtracer_tpu/cli.py`: load a scene, render it with the
scan or the persistent-wavefront integrator, or progressively with
checkpoints and resume, and write a PNG (and optionally the linear
radiance as npz). The one flag of the reference that is not ported yet,
`--tile-shard`, is not defined, so argparse rejects it.

Usage:
    python -m metalpathtracer_torch.cli --scene scenes/reference.xml \
        --width 1280 --height 720 --spp 4 --device cuda --stats-json \
        [--wavefront]
    python -m metalpathtracer_torch.cli --scene scenes/cornell.xml \
        --spp 128 --checkpoint runs/cornell.npz --checkpoint-every 16 \
        [--resume]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="metalpathtracer_torch",
        description="Progressive Monte Carlo path tracer on PyTorch/CUDA",
    )
    p.add_argument("--scene", required=True, help="scene.xml path")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=64, help="samples per pixel")
    p.add_argument("--max-depth", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default=None,
                   help="output PNG (default runs/<scene>.png)")
    p.add_argument("--npz", default=None, help="also dump linear radiance npz")
    p.add_argument("--camera-pos", default="0,20,50", help="x,y,z")
    p.add_argument("--camera-target", default=None, help="x,y,z look-at point")
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "mm", "bvh", "brute"],
                   help="closest-hit backend (auto = mm, the tile kernels; "
                        "bvh = the lockstep BVH walk, a study path; "
                        "brute = the brute-force oracle)")
    p.add_argument("--nee", action="store_true", help="next-event estimation")
    p.add_argument("--rr-start", type=int, default=0,
                   help="first Russian-roulette bounce (0 = off)")
    p.add_argument("--clamp", action="store_true",
                   help="per-sample [0,1] radiance clamp")
    p.add_argument("--spp-per-pass", type=int, default=None)
    p.add_argument("--wavefront", action="store_true",
                   help="persistent-wavefront integrator with lane "
                        "regeneration (fastest on open scenes)")
    p.add_argument("--pool-size", type=int, default=None,
                   help="wavefront lane-pool size (default: auto)")
    p.add_argument("--bounces-per-iter", type=int, default=1,
                   help="wavefront bounces per regeneration cycle")
    p.add_argument("--checkpoint", default=None,
                   help="progressive checkpoint path (save after each pass)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--checkpoint-every", type=int, default=16,
                   help="samples between checkpoint writes")
    p.add_argument("--stats-json", action="store_true",
                   help="print a machine-readable stats line")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    return p


def _vec3(s: str):
    parts = [float(x) for x in s.split(",")]
    if len(parts) != 3:
        raise ValueError(f"expected x,y,z got {s!r}")
    return tuple(parts)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from metalpathtracer_torch.io.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from metalpathtracer_torch.io.png import write_png
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.pipeline import (
        accumulate,
        init_accum,
        render_image,
        render_image_wavefront,
        to_image,
    )
    from metalpathtracer_torch.scene import load_scene_xml

    device = torch.device(args.device)
    host = load_scene_xml(args.scene)
    print(
        f"Scene loaded: {host.primitive_count} primitives "
        f"({host.primitive_count - host.triangle_count} spheres, "
        f"{host.triangle_count} triangles)",
        file=sys.stderr,
    )
    t0 = time.time()
    # the BVH serves the study intersector alone
    scene = upload_scene(host, device, bvh=args.intersector == "bvh")
    print(
        f"tables: {scene.mm_tile_box.shape[0]} tiles of {scene.mm_w.shape[1]}"
        + (f"; BVH: {scene.node_a.shape[0]} nodes, depth {scene.max_depth}"
           if args.intersector == "bvh" else "")
        + f"; built+uploaded to {device} in {time.time() - t0:.2f}s",
        file=sys.stderr,
    )

    pos = _vec3(args.camera_pos)
    if args.camera_target is not None:
        cam = Camera.look_at(pos, _vec3(args.camera_target), vfov_deg=args.fov)
    else:
        cam = dataclasses.replace(
            Camera.reset(),
            position=torch.as_tensor(np.asarray(pos, np.float32)),
            vfov_deg=torch.as_tensor(np.float32(args.fov)),
        )

    cfg = RenderConfig(
        max_depth=args.max_depth,
        intersector=args.intersector,
        clamp_radiance=args.clamp,
        rr_start=args.rr_start,
        nee=args.nee,
        bounces_per_iter=args.bounces_per_iter,
    )

    output = args.output
    if output is None:
        base = os.path.splitext(os.path.basename(args.scene))[0]
        os.makedirs("runs", exist_ok=True)
        output = os.path.join("runs", f"{base}.png")

    t0 = time.time()
    if args.checkpoint:
        import hashlib

        # fingerprint the run: resuming with another scene, camera or
        # config would blend two renders into one accumulation
        with open(args.scene, "rb") as f:
            scene_sha = hashlib.sha256(f.read()).hexdigest()[:16]
        fingerprint = {
            "scene_sha": scene_sha,
            "size": f"{args.width}x{args.height}",
            "camera": f"{args.camera_pos}|{args.camera_target}|{args.fov}",
            "cfg": repr(cfg),
        }
        state = init_accum(args.width, args.height, device)
        run_seed = args.seed
        if args.resume and os.path.exists(args.checkpoint):
            state, run_seed, meta = load_checkpoint(args.checkpoint, device)
            mismatches = [
                f"  {k}: checkpoint={meta[k]!s} run={v}"
                for k, v in fingerprint.items()
                if k in meta and str(meta[k]) != v
            ]
            if mismatches:
                print(
                    f"error: checkpoint {args.checkpoint} was written by a "
                    "different run; refusing to blend accumulations:\n"
                    + "\n".join(mismatches),
                    file=sys.stderr,
                )
                return 2
            if not meta:
                print("warning: checkpoint has no fingerprint (old format); "
                      "cannot validate it matches this run", file=sys.stderr)
            # the checkpoint's seed wins: mixing seeds across the resume
            # boundary would break the bit-identical-resume contract
            print(f"resumed at {state.spp} spp (seed {run_seed})",
                  file=sys.stderr)
        while state.spp < args.spp:
            k = min(args.checkpoint_every, args.spp - state.spp)
            state = accumulate(
                state, scene, cam, args.width, args.height, k,
                run_seed & 0xFFFFFFFF, cfg,
            )
            save_checkpoint(args.checkpoint, state, run_seed, meta=fingerprint)
            print(f"checkpoint at {state.spp}/{args.spp} spp", file=sys.stderr)
        img, rays = to_image(state, clamp=False), None
    elif args.wavefront:
        img, rays = render_image_wavefront(
            scene, cam, args.width, args.height, args.spp,
            seed=args.seed, cfg=cfg, pool_size=args.pool_size,
        )
    else:
        img, rays = render_image(
            scene, cam, args.width, args.height, args.spp,
            seed=args.seed, cfg=cfg, spp_per_pass=args.spp_per_pass,
        )
    img = img.cpu().numpy()  # waits for the device
    dt = time.time() - t0

    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    write_png(output, img)
    if args.npz:
        np.savez_compressed(args.npz, radiance=img, spp=args.spp, seed=args.seed)

    stats = {
        "output": output,
        "width": args.width,
        "height": args.height,
        "spp": args.spp,
        "seconds": round(dt, 3),
        "spp_per_sec": round(args.spp / dt, 3),
    }
    if rays is not None:
        stats["rays"] = int(rays)
        stats["mrays_per_sec"] = round(rays / dt / 1e6, 3)
    print(
        f"wrote {output}: {args.width}x{args.height} @ {args.spp} spp in {dt:.2f}s"
        + (f" ({stats['mrays_per_sec']} Mrays/s)" if rays is not None else ""),
        file=sys.stderr,
    )
    if args.stats_json:
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
