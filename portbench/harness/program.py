"""The system under test: `metalpathtracer_torch`'s progressive entries.

A pass adds `spp_per_pass` samples to every pixel of the configuration's
view through the program's public progressive entry and ends when the
resolved image (`pipeline.to_image`) is on the host:

- integrator "scan": `pipeline.accumulate` (the CLI's default route);
- integrator "wavefront": `pipeline.accumulate_wavefront` (the viewer's
  and `render_image_wavefront`'s path), with the traffic's pool.

Sample ids continue from pass to pass, so the image converges.
"""

from __future__ import annotations

import numpy as np
import torch

from metalpathtracer_torch.core import rng
from metalpathtracer_torch.render import graphs, integrator, pipeline
from metalpathtracer_torch.render.camera import Camera
from metalpathtracer_torch.render.device_scene import upload_scene
from metalpathtracer_torch.scene.types import LANE_PAD, PRIM_NONE, PackedScene


def upload(arrays, device):
    """The benchmark's scene arrays as the program's device scene, through
    its packed scene type (rows padded to LANE_PAD with empty rows)."""
    n = arrays.kind.shape[0]
    pad = (-n) % LANE_PAD

    def p(a, fill=0):
        return np.concatenate([a, np.full((pad, *a.shape[1:]), fill, a.dtype)])

    packed = PackedScene(
        prim_type=p(arrays.kind, PRIM_NONE), p0=p(arrays.p0), p1=p(arrays.p1),
        p2=p(arrays.p2), albedo=p(arrays.albedo), material_type=p(arrays.material_type),
        emission_color=p(arrays.emission), emission_power=p(arrays.power),
        fuzz=p(arrays.fuzz), num_real=n)
    return upload_scene(packed, device)


def camera(c: dict) -> Camera:
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return Camera(position=f32(c["position"]), forward=f32(c["forward"]),
                  up=f32(c["up"]), vfov_deg=f32(c["vfov_deg"]))


class Passes:
    """Back-to-back passes of one cell on the program."""

    def __init__(self, scene, config: dict, traffic: dict, seed: int):
        self.scene = scene
        self.width, self.height = int(traffic["width"]), int(traffic["height"])
        self.spp = int(traffic["spp_per_pass"])
        self.kind = traffic["integrator"]
        if self.kind not in ("scan", "wavefront"):
            raise ValueError(f"unknown integrator {self.kind!r}")
        self.pool = traffic.get("pool")
        r = config["render"]
        self.cfg = integrator.RenderConfig(
            max_depth=int(traffic["max_depth"]),
            clamp_radiance=bool(r.get("clamp_radiance", False)),
            adaptive_offset=bool(r.get("adaptive_offset", True)),
            nee=bool(r.get("nee", False)),
            rr_start=int(r.get("rr_start", 0)))
        self.camera = camera(config["camera"])
        self.seed = rng.seed_from_int(seed)
        self.device = scene.device
        self.reset()

    def reset(self) -> None:
        """A fresh image: the next pass traces samples 0 .. spp - 1."""
        self.state = pipeline.init_accum(self.width, self.height, self.device)

    def to_host(self, state) -> np.ndarray:
        """The resolved image of `state` in the client's host buffer (page-
        locked where there is a card, made once): the copy returns when the
        image is on the host. The buffer is the next pass's too."""
        img = pipeline.to_image(state)
        if getattr(self, "host", None) is None:
            self.host = torch.empty(img.shape, dtype=img.dtype,
                                    pin_memory=img.is_cuda)
        self.host.copy_(img)
        return self.host.numpy()

    def run(self):
        """One pass. Returns (the image on the host as float32 (H, W, 3)
        numpy, in the buffer the next pass overwrites; rays the program
        counted in the pass)."""
        if self.kind == "wavefront":
            self.state, rays = pipeline.accumulate_wavefront(
                self.state, self.scene, self.camera, self.width, self.height,
                self.spp, self.seed, self.cfg, self.pool)
            return self.to_host(self.state), rays
        self.state = pipeline.accumulate(
            self.state, self.scene, self.camera, self.width, self.height,
            self.spp, self.seed, self.cfg)
        img = self.to_host(self.state)
        entry = integrator.scan_entry(self.scene, self.width, self.height,
                                      self.width * self.height, self.seed, self.cfg)
        return img, int(entry.program.counters["rays"])

    @property
    def samples_done(self) -> int:
        return self.state.spp


def stats() -> dict:
    """A copy of the program's loop counters (`render/graphs.py` STATS)."""
    return dict(graphs.STATS)


def tallies(device) -> dict:
    from metalpathtracer_torch.render.kernels import _build

    return _build.tallies(device)


def release() -> None:
    """Drop the program's cached render programs and their graphs."""
    graphs.clear()


def peak_bytes(device) -> int:
    """The device memory peak since set-up (one card)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def profiling(on: bool) -> None:
    """A profile starts or ends (one process: nothing else to tell)."""


def device_busy(busy_ns: float, window_ns: float) -> tuple[float, float]:
    """Busy and window seconds of the profiled passes (one card)."""
    return busy_ns / 1e9, window_ns / 1e9
