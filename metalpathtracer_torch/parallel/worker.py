"""One rank of a sharded job list, and the launcher of a world of them.

A test or a smoke script describes a world (its size, backend, device and
a list of jobs) in a JSON spec; `launch` starts one fresh interpreter per
rank on it, waits for all of them within a time limit, and raises if one
fails or hangs. Each rank joins the process group through a file store
(`init_method="file://..."`), runs the jobs in order and writes one
`<job>.rank<r>.pt` per job into the spec's `out_dir` (`load_result` reads
it back).

Usage (what `launch` runs for each rank):
    python -m metalpathtracer_torch.parallel.worker SPEC.json RANK

The spec:
    world      number of ranks
    store      path of the file store (must not exist before the launch)
    backend    "gloo" or "nccl"
    device     "cpu", "cuda" (this rank's LOCAL_RANK-th card) or "cuda:N"
    timeout_s  limit of a collective, and of the group's start
    threads    intra-op threads per rank (default 1)
    out_dir    where the results go
    jobs       a list of dicts, each with a `name` and a `kind`:
      kind "render":     `fn` (an entry point of `parallel.sharding`),
                         `scene`, `camera`, `width`, `height`, `spp`,
                         `seed`, `cfg`, `mesh`, optional `pool_size`;
                         result: image, rays, seconds
      kind "accumulate": `scene`, `camera`, `width`, `height`, `steps` (a
                         list of sample counts), `seed`, `cfg`, `mesh`,
                         optional `pool_size`, optional `checkpoint` (a
                         path: after the first step the gathered state is
                         written by rank 0, read back by every rank, cut to
                         its rows and continued); result: rgb_sum (whole),
                         spp, rays (per step), seconds (per step)
      kind "raises":     a render job that must raise ValueError on every
                         rank; result: message
      kind "cli":        `argv` for `cli.main`; result: rc, stdout
    `scene` is {"preset": name, "kwargs": {...}} or {"xml": path};
    `camera` is "reset" or {"look_at": [position, target, vfov_deg]};
    `mesh` is {"axis": "tiles" | "samples"} or {"grid": [n_tiles, n_samples]};
    `cfg` holds keyword arguments of `RenderConfig`.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import resource
import signal
import subprocess
import sys
import time
from pathlib import Path


def _scene(spec, device, cache):
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.scene import load_scene_xml, presets

    key = json.dumps(spec, sort_keys=True)
    if key not in cache:
        if "xml" in spec:
            host = load_scene_xml(spec["xml"])
        else:
            host = getattr(presets, spec["preset"])(**spec.get("kwargs", {}))
        cache[key] = upload_scene(host, device)
    return cache[key]


def _camera(spec):
    from metalpathtracer_torch.render.camera import Camera

    if spec == "reset":
        return Camera.reset()
    position, target, fov = spec["look_at"]
    return Camera.look_at(tuple(position), tuple(target), vfov_deg=fov)


def _mesh(spec):
    from metalpathtracer_torch.parallel import sharding

    if "grid" in spec:
        return sharding.make_mesh_2d(*spec["grid"])
    return sharding.make_mesh(axis=spec["axis"])


def _render(job, device, scenes):
    from metalpathtracer_torch.parallel import sharding
    from metalpathtracer_torch.render.integrator import RenderConfig

    kwargs = dict(seed=job["seed"], cfg=RenderConfig(**job.get("cfg", {})),
                  mesh=_mesh(job["mesh"]))
    if "pool_size" in job:
        kwargs["pool_size"] = job["pool_size"]
    t0 = time.perf_counter()
    img, rays = getattr(sharding, job["fn"])(
        _scene(job["scene"], device, scenes), _camera(job["camera"]),
        job["width"], job["height"], job["spp"], **kwargs)
    img = img.cpu()  # waits for the device
    return dict(image=img, rays=rays, seconds=time.perf_counter() - t0)


def _accumulate(job, device, scenes, rank, barrier):
    from metalpathtracer_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from metalpathtracer_torch.parallel import sharding
    from metalpathtracer_torch.render.integrator import RenderConfig

    scene, cam = _scene(job["scene"], device, scenes), _camera(job["camera"])
    mesh, cfg = _mesh(job["mesh"]), RenderConfig(**job.get("cfg", {}))
    state = sharding.init_accum_sharded(job["width"], job["height"], mesh, device)
    rays, seconds = [], []
    for k, n in enumerate(job["steps"]):
        t0 = time.perf_counter()
        state, r = sharding.accumulate_sharded(
            state, scene, cam, n, job["seed"], cfg, mesh, job.get("pool_size"))
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        rays.append(r)
        if k == 0 and job.get("checkpoint"):
            whole = sharding.gather_accum(state, mesh)
            if rank == 0:
                save_checkpoint(job["checkpoint"], whole, job["seed"])
            barrier()  # the file is whole before any rank reads it
            loaded, _, _ = load_checkpoint(job["checkpoint"], device)
            state = sharding.shard_accum(loaded, mesh)
    whole = sharding.gather_accum(state, mesh)
    return dict(rgb_sum=whole.rgb_sum.cpu(), spp=whole.spp, rays=rays,
                seconds=seconds)


def _cli(job):
    from metalpathtracer_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(job["argv"])
    return dict(rc=rc, stdout=out.getvalue())


def run_rank(spec: dict, rank: int, around=contextlib.nullcontext) -> None:
    """Run the spec's jobs as rank `rank`. `around()` is a context manager
    entered around every job; what it yields (a dict it may fill on exit)
    is kept in the job's result as `counts`."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(int(spec.get("threads", 1)))
    world = int(spec["world"])
    device = torch.device(spec["device"])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if device.type == "cuda":
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: no device {device} "
                               f"({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(device)
    if world > 1:
        dist.init_process_group(
            spec["backend"], init_method=f"file://{spec['store']}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=float(spec["timeout_s"])))

    def barrier():
        if world > 1:
            dist.barrier()

    out_dir = Path(spec["out_dir"])
    scenes: dict = {}
    finished = False
    try:
        for job in spec["jobs"]:
            barrier()  # the ranks start a job together
            t0 = time.perf_counter()
            with around() as counts:
                if job["kind"] == "render":
                    result = _render(job, device, scenes)
                elif job["kind"] == "accumulate":
                    result = _accumulate(job, device, scenes, rank, barrier)
                elif job["kind"] == "raises":
                    try:
                        _render(job, device, scenes)
                    except ValueError as e:
                        result = dict(message=str(e))
                    else:
                        raise RuntimeError(f"{job['name']}: no ValueError")
                elif job["kind"] == "cli":
                    result = _cli(job)
                else:
                    raise ValueError(f"unknown job kind {job['kind']!r}")
            if counts is not None:
                result["counts"] = dict(counts)
            tmp = out_dir / f".{job['name']}.rank{rank}.tmp"
            torch.save(result, tmp)
            os.replace(tmp, out_dir / f"{job['name']}.rank{rank}.pt")
            # one line a job into the rank's log: where a world stopped, and
            # how long and how large each job ran
            print(f"rank {rank}: {job['name']} done in "
                  f"{time.perf_counter() - t0:.2f} s, max RSS "
                  f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024} MiB",
                  file=sys.stderr, flush=True)
        finished = True
    finally:
        if world > 1:
            if finished:
                # no rank tears its group down while a peer's last messages
                # to it may still be in flight
                barrier()
            dist.destroy_process_group()


def load_result(out_dir, name: str, rank: int = 0) -> dict:
    import torch

    return torch.load(Path(out_dir) / f"{name}.rank{rank}.pt", weights_only=True)


def launch(spec: dict, limit_s: float, command=None) -> float:
    """Start the spec's world (one interpreter per rank, `command` + [spec
    file, rank]; default: this module), wait at most `limit_s` seconds for
    all ranks, stop every one of them if a rank fails or the time runs
    out, and raise then. A rank has succeeded when it exited with code 0
    and left the result of every job: an exit status can be lost (a child
    reaped elsewhere, or SIGCHLD ignored, reads as 0), so a world whose
    ranks stopped part way raises too, and never passes for a whole one.
    Returns the wall seconds of the whole launch."""
    out_dir = Path(spec["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    spec_file = out_dir / "spec.json"
    spec_file.write_text(json.dumps(spec))
    if command is None:
        command = [sys.executable, "-m", "metalpathtracer_torch.parallel.worker"]
    root = str(Path(__file__).resolve().parents[2])
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    logs = [open(out_dir / f"rank{r}.log", "w+") for r in range(spec["world"])]
    ranks = [subprocess.Popen([*command, str(spec_file), str(r)], stdout=log,
                              stderr=subprocess.STDOUT, env=child_env)
             for r, log in enumerate(logs)]
    failed = None
    try:
        waiting = set(range(len(ranks)))
        while waiting and failed is None:
            if time.perf_counter() - t0 > limit_s:
                failed = f"ranks {sorted(waiting)} still ran after {limit_s} s"
                break
            for r in sorted(waiting):
                rc = ranks[r].poll()
                if rc is None:
                    continue
                waiting.discard(r)
                if rc != 0:
                    failed = f"rank {r} exited with code {rc}"
            time.sleep(0.05)
        if failed is None:
            for r in range(len(ranks)):
                missing = [job["name"] for job in spec["jobs"]
                           if not (out_dir / f"{job['name']}.rank{r}.pt").exists()]
                if missing:
                    failed = f"rank {r} exited without the results of {missing}"
                    break
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
            p.wait()
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            tails.append(f"--- rank {r} ---\n" + log.read()[-2000:])
            log.close()
    if failed:
        raise RuntimeError(f"sharded launch: {failed}\n" + "\n".join(tails))
    return time.perf_counter() - t0


def _die_with_launcher() -> None:
    """Have the kernel stop this rank when the process that started it
    dies (Linux's parent-death signal): a rank must not run on, and keep a
    world's files and cores, after its launcher was killed."""
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.getppid() == 1:  # the launcher died before the call
        os._exit(1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__.split("Usage")[0].strip(), file=sys.stderr)
        print("usage: python -m metalpathtracer_torch.parallel.worker "
              "SPEC.json RANK", file=sys.stderr)
        return 2
    _die_with_launcher()
    run_rank(json.loads(Path(argv[0]).read_text()), int(argv[1]))
    # every result is on disk: leave without the interpreter's teardown, in
    # which a rank of a gloo world could abort ("terminate called without an
    # active exception", exit code -6) after its last job and so fail the
    # world it had finished
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    raise SystemExit(main())
