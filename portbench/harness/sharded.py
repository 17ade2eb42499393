"""Tile-sharded passes over several cards: one process a card.

The process of `run.py` is rank 0 (`Leader`). It starts the other ranks as
fresh interpreters of this file, one a card, and every rank joins the
process group (nccl on the cards, gloo on the CPU for the tests) at
`tcp://localhost:<a free port>`. Each rank builds the cell's scene from
its configuration file and uploads it to its own card. A pass is the
program's `parallel.accumulate_sharded` (each rank traces its row block
with the wavefront integrator, sample ids continuing) then
`parallel.gather_accum` (the blocks joined on every rank); rank 0 resolves
the whole image and brings it to the host.

Rank 0 drives the others by commands, one broadcast integer each: a pass,
a fresh image, a profile's start or end, a sum of the program's counters,
the device memory peak, the profile's busy time, stop. So every rank runs
the same passes, and a run's window is rank 0's.
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

STOP, PASS, RESET, STATS, PEAK, PROFILE_ON, PROFILE_OFF, BUSY = range(8)
STAT_KEYS = ("captures", "capture_s", "replays", "eager_runs", "reads", "idle_steps",
             "nee_steps")
TIMEOUT = datetime.timedelta(seconds=300)


def _join(rank: int, world: int, port: int, backend: str, device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=TIMEOUT)


def make_passes(program, scene, config, traffic, seed, rank):
    """The sharded passes of one rank, on the program's entry points."""
    from metalpathtracer_torch.parallel import sharding

    class ShardedPasses(program.Passes):
        def __init__(self):
            self.mesh = sharding.make_mesh()
            self.rank = rank
            self.raw_seed = seed
            super().__init__(scene, config, traffic, seed)

        def reset(self):
            self.state = sharding.init_accum_sharded(self.width, self.height,
                                                     self.mesh, self.device)

        def run(self):
            self.state, rays = sharding.accumulate_sharded(
                self.state, self.scene, self.camera, self.spp, self.raw_seed,
                self.cfg, self.mesh, self.pool)
            whole = sharding.gather_accum(self.state, self.mesh)
            if self.rank:
                return None, rays
            return self.to_host(whole), rays

    return ShardedPasses()


class _Rank:
    """What every rank does for a command."""

    def __init__(self, program, device):
        self.program, self.device = program, device
        self.prof = None

    def _sum(self, values, op=None):
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM)
        return t.tolist()

    def stats(self) -> dict:
        own = self.program.stats()
        return dict(zip(STAT_KEYS, self._sum([float(own[k]) for k in STAT_KEYS])))

    def peak(self) -> int:
        own = (torch.cuda.max_memory_allocated(self.device)
               if self.device.type == "cuda" else 0)
        return int(self._sum([float(own)], dist.ReduceOp.MAX)[0])

    def busy(self, busy_ns: float, window_ns: float) -> tuple[float, float]:
        """Busy and window seconds averaged over the ranks."""
        b, w = self._sum([busy_ns, window_ns])
        n = dist.get_world_size()
        return b / n / 1e9, w / n / 1e9


class Leader(_Rank):
    """Rank 0: the harness's program for a sharded cell (the interface of
    `harness.program`, each call also run by the other ranks)."""

    def __init__(self, cell, seed: int, device, backend: str = "nccl"):
        from harness import program

        device = torch.device(device)
        super().__init__(program, device)
        self.world = int(cell.traffic["ranks"])
        self.upload, self.tallies = program.upload, program.tallies
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        here = Path(__file__).resolve()
        self.children = []
        for r in range(1, self.world):
            dev = f"cuda:{r}" if device.type == "cuda" else "cpu"
            self.children.append(subprocess.Popen(
                [sys.executable, str(here), "--seed", str(seed), "--rank", str(r),
                 "--world", str(self.world), "--port", str(port), "--backend", backend,
                 "--device", dev, "--root", str(cell.root),
                 "--config", json.dumps(cell.config), "--traffic", json.dumps(cell.traffic)]))
        _join(0, self.world, port, backend, device)
        leader = self

        class Passes:
            def __new__(cls, scene, config, traffic, seed):
                passes = make_passes(program, scene, config, traffic, seed, 0)
                run, reset = passes.run, passes.reset

                def run_all():
                    leader.command(PASS)
                    return run()

                def reset_all():
                    leader.command(RESET)
                    reset()

                passes.run, passes.reset = run_all, reset_all
                return passes

        self.Passes = Passes

    def command(self, cmd: int) -> None:
        dist.broadcast(torch.tensor([cmd], dtype=torch.int64, device=self.device), 0)

    def stats(self) -> dict:
        self.command(STATS)
        return super().stats()

    def peak_bytes(self, device) -> int:
        self.command(PEAK)
        return self.peak()

    def profiling(self, on: bool) -> None:
        self.command(PROFILE_ON if on else PROFILE_OFF)

    def device_busy(self, busy_ns: float, window_ns: float):
        self.command(BUSY)
        return self.busy(busy_ns, window_ns)

    def release(self) -> None:
        """Stop the other ranks, leave the group, and wait for every rank."""
        from harness import program

        program.release()
        if self.children:
            self.command(STOP)
            dist.destroy_process_group()
        self.close()

    def close(self, kill: bool = False) -> None:
        """Wait for the other ranks (`kill`: stop them first)."""
        for child in self.children:
            if kill:
                child.kill()
            try:
                child.wait(timeout=120)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        if kill:
            self.children = []
            return
        bad = [c.returncode for c in self.children if c.returncode]
        self.children = []
        if bad:
            raise RuntimeError(f"a rank failed: exit codes {bad}")


def follow(args) -> int:
    """A rank other than 0: the cell's scene on its card, then rank 0's
    commands until STOP."""
    sys.path[:0] = [str(Path(args.root)), str(Path(args.root).parent)]
    from harness import program, scene, trace

    try:  # stop with the process that started this rank
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    device = torch.device(args.device)
    torch.set_num_threads(1)
    _join(args.rank, args.world, args.port, args.backend, device)
    config, traffic = json.loads(args.config), json.loads(args.traffic)
    arrays = scene.build(config["scene"], Path(args.root))
    passes = make_passes(program, program.upload(arrays, device), config, traffic,
                         args.seed, args.rank)
    me = _Rank(program, device)
    cmd = torch.zeros(1, dtype=torch.int64, device=device)
    busy = (0.0, 0.0)
    while True:
        dist.broadcast(cmd, 0)
        c = int(cmd.item())
        if c == STOP:
            break
        if c == PASS:
            if me.prof is not None:
                from torch.profiler import record_function

                with record_function("portbench/pass"):
                    passes.run()
            else:
                passes.run()
        elif c == RESET:
            passes.reset()
        elif c == STATS:
            me.stats()
        elif c == PEAK:
            me.peak()
        elif c == PROFILE_ON:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            me.prof = profile(activities=acts)
            me.prof.__enter__()
        elif c == PROFILE_OFF:
            me.prof.__exit__(None, None, None)
            ev = trace.events(me.prof)
            ranges = [r for r in ev["host"] if r[0] == "portbench/pass"]
            lo = min(r[1] for r in ranges) if ranges else 0
            hi = max(r[2] for r in ranges) if ranges else 0
            busy = (float(trace.busy_ns(trace.clip(ev["device"], lo, hi))), float(hi - lo))
            me.prof = None
        elif c == BUSY:
            me.busy(*busy)
    program.release()
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one follower rank of a sharded cell")
    for a in ("--backend", "--device", "--root", "--config", "--traffic"):
        ap.add_argument(a, required=True)
    for a in ("--seed", "--rank", "--world", "--port"):
        ap.add_argument(a, type=int, required=True)
    return follow(ap.parse_args(argv))


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
