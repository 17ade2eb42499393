"""Command-line renderer on PyTorch.

Port of `metalpathtracer_tpu/cli.py`: load a scene, render it with the
scan or the persistent-wavefront integrator, progressively with
checkpoints and resume, or tile-sharded over the ranks of a process group,
and write a PNG (and optionally the linear radiance as npz).

`--tile-shard` splits the image's rows over a `torch.distributed` world,
one process per device: the one a launcher describes in the environment
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`, as
`torchrun` sets them; backend nccl for CUDA devices, gloo for the CPU), or
a group the caller initialised; with neither, a world of one. Under a
launcher a bare `--device cuda` means this rank's `LOCAL_RANK`-th card
(in a caller's group: the card the caller made current).
Rank 0 alone writes the image and the stats line.

Usage:
    python -m metalpathtracer_torch.cli --scene scenes/reference.xml \
        --width 1280 --height 720 --spp 4 --device cuda --stats-json \
        [--wavefront]
    python -m metalpathtracer_torch.cli --scene scenes/cornell.xml \
        --spp 128 --checkpoint runs/cornell.npz --checkpoint-every 16 \
        [--resume]
    torchrun --nproc-per-node 4 -m metalpathtracer_torch.cli \
        --scene scenes/multimesh.xml --width 1920 --height 1080 --spp 16 \
        --tile-shard [--wavefront]
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
    p.add_argument("--tile-shard", action="store_true",
                   help="shard pixel rows across the ranks of the process "
                        "group (one process per device)")
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


def _join_world(device):
    """The world a `--tile-shard` run renders in: (rank, device, whether
    this call initialised the group). A bare "cuda" becomes, under a
    launcher, this rank's `LOCAL_RANK`-th card, and in a group the caller
    initialised, the card the caller made current."""
    import torch
    import torch.distributed as dist

    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if device.type == "cuda" and device.index is None:
        if launched:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        elif dist.is_initialized() and torch.cuda.device_count() > 0:
            device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda" and device.index is not None:
        if device.index >= torch.cuda.device_count():
            raise ValueError(
                f"no device {device}: {torch.cuda.device_count()} CUDA "
                "devices are visible to this rank")
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return dist.get_rank(), device, False
    if not launched:
        return 0, device, False
    dist.init_process_group(
        "gloo" if device.type == "cpu" else "nccl",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank(), device, True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if not args.tile_shard:
        return _render(args, device, 0)
    try:
        rank, device, ours = _join_world(device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        return _render(args, device, rank)
    finally:
        if ours:
            torch.distributed.destroy_process_group()


def _render(args, device, rank: int) -> int:
    """Render as `main` parsed it. Every rank of a `--tile-shard` world
    renders its rows and holds the whole image; `rank` 0 reports and
    writes."""
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

    def say(text):
        if rank == 0:
            print(text, file=sys.stderr)

    host = load_scene_xml(args.scene)
    say(
        f"Scene loaded: {host.primitive_count} primitives "
        f"({host.primitive_count - host.triangle_count} spheres, "
        f"{host.triangle_count} triangles)"
    )
    t0 = time.time()
    # the BVH serves the study intersector alone
    scene = upload_scene(host, device, bvh=args.intersector == "bvh")
    say(
        f"tables: {scene.mm_tile_box.shape[0]} tiles of {scene.mm_w.shape[1]}"
        + (f"; BVH: {scene.node_a.shape[0]} nodes, depth {scene.max_depth}"
           if args.intersector == "bvh" else "")
        + f"; built+uploaded to {device} in {time.time() - t0:.2f}s"
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
        output = os.path.join("runs", f"{base}.png")  # made where it is written

    t0 = time.time()
    if args.tile_shard:
        from metalpathtracer_torch.parallel import (
            render_image_sharded,
            render_image_wavefront_sharded,
        )

        if args.wavefront:
            img, rays = render_image_wavefront_sharded(
                scene, cam, args.width, args.height, args.spp,
                seed=args.seed, cfg=cfg, pool_size=args.pool_size,
            )
        else:
            img, rays = render_image_sharded(
                scene, cam, args.width, args.height, args.spp,
                seed=args.seed, cfg=cfg,
            )
    elif args.checkpoint:
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
    if rank != 0:
        return 0

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
