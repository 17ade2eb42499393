"""Rendering pipeline: ray generation, sample batching, progressive state.

Port of `metalpathtracer_tpu/render/pipeline.py`: `generate_rays` (the
math on a basis already on the device, `camera_basis` and
`rays_from_basis`, is in `render/camera.py`), `render_tile`, `render_image`, `render_image_wavefront`, and the
progressive state `AccumState` with `init_accum`, `accumulate`,
`accumulate_wavefront` and `to_image`. Samples of a pass are traced one
after another and summed; passes split spp as the reference does, so the
sums are taken in the same order. A pass runs on the integrator's `_Scan`
program, the counterpart of the reference's jitted `_render_pass`.

Progressive accumulation keeps `(rgb_sum, spp)`, not a running average, so
a resumed render adds exactly what an uninterrupted one adds; the division
and the display clamp happen in `to_image`.
"""

from __future__ import annotations

import dataclasses

import torch

from metalpathtracer_torch.core import rng
from metalpathtracer_torch.render.camera import Camera, camera_basis, rays_from_basis
from metalpathtracer_torch.render.integrator import (
    DEFAULT_CONFIG,
    RenderConfig,
    scan_entry,
    scan_samples,
    trace_wavefront,
)
from metalpathtracer_torch.utils.metrics import span


def generate_rays(camera: Camera, width: int, height: int, pixel_id, sample_id,
                  seed):
    """Jittered primary rays from `camera`: `rays_from_basis` of its
    `camera_basis`, moved to `pixel_id`'s device."""
    basis = camera_basis(camera, width, height).to(pixel_id.device)
    return rays_from_basis(basis, width, height, pixel_id, sample_id, seed)


def render_tile(scene, camera, width, height, pixel_id, sample_ids, seed, cfg):
    """Render the samples `sample_ids` (consecutive ints, in order: a
    range) for the given pixels. Returns (rgb_sum (N, 3), rays_traced int64
    scalar tensor).

    Runs on the `_Scan` program of this shape (`integrator.scan_entry`):
    `begin` copies the pixel ids, the camera's basis and the first sample
    id into its buffers, then each sample is `start_sample`, its bounce
    blocks and `end_sample` (`integrator.scan_samples`), which on the card
    are replays of captured CUDA graphs (`render/graphs.py`)."""
    ids = list(sample_ids)
    if ids != list(range(ids[0], ids[0] + len(ids)) if ids else []):
        raise ValueError(f"sample ids must be consecutive, got {ids}")
    entry = scan_entry(scene, width, height, pixel_id.shape[0], seed, cfg)
    entry.program.begin(pixel_id, ids[0] if ids else 0,
                        camera_basis(camera, width, height).to(pixel_id.device))
    scan_samples(entry, len(ids))
    return entry.program.result()


def render_image(scene, camera: Camera, width: int, height: int, spp: int,
                 seed: int = 0, cfg: RenderConfig = DEFAULT_CONFIG,
                 spp_per_pass: int | None = None, sample_offset: int = 0):
    """Render a full image on the scene's device: samples `sample_offset`
    .. `sample_offset + spp - 1` of every pixel. Returns (image (H, W, 3)
    float32 linear mean, rays_traced int)."""
    if spp <= 0:
        raise ValueError(f"spp must be positive, got {spp}")
    if spp_per_pass is None:
        spp_per_pass = max(1, min(spp, (1 << 22) // max(1, width * height)))
    dev = scene.device
    pixel_id = torch.arange(width * height, dtype=torch.int64, device=dev)
    seed_u32 = rng.seed_from_int(seed)
    rgb = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    rays = 0
    done = 0
    while done < spp:
        k = min(spp_per_pass, spp - done)
        sample_ids = range(sample_offset + done, sample_offset + done + k)
        part, r = render_tile(scene, camera, width, height, pixel_id,
                              sample_ids, seed_u32, cfg)
        rgb = rgb + part.reshape(height, width, 3)
        rays += int(r)
        done += k
    return rgb / spp, rays


def render_image_wavefront(scene, camera: Camera, width: int, height: int,
                           spp: int, seed: int = 0,
                           cfg: RenderConfig = DEFAULT_CONFIG,
                           pool_size: int | None = None,
                           return_stats: bool = False):
    """Render through the persistent-wavefront integrator (see
    `integrator.trace_wavefront`): the estimate of `render_image`, all spp
    in one queue with pool-sized live state. Returns (image (H, W, 3) f32,
    rays_traced int), plus with `return_stats` a dict: `tile_passes` and
    `shadow_rays` (NEE shadow rays, included in rays_traced)."""
    if spp <= 0:
        raise ValueError(f"spp must be positive, got {spp}")
    if pool_size is None:
        pool_size = min(width * height * spp, 1 << 15)
    rgb_sum, rays, stats = trace_wavefront(
        scene, camera, width, height, spp, rng.seed_from_int(seed), cfg,
        int(pool_size),
    )
    img = rgb_sum.reshape(height, width, 3) / spp
    if return_stats:
        return img, rays, stats
    return img, rays


# ---------------------------------------------------------------------------
# Progressive accumulation: an explicit state that can be checkpointed
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AccumState:
    """`rgb_sum` lives on the render device; `spp` is a host int, so that
    reading it never waits for the device. A checkpoint stores it as the
    reference's int32 scalar (`io/checkpoint.py`)."""

    rgb_sum: torch.Tensor  # float32 (H, W, 3) sum of per-sample radiance
    spp: int  # samples accumulated so far


def init_accum(width: int, height: int, device) -> AccumState:
    return AccumState(
        rgb_sum=torch.zeros((height, width, 3), dtype=torch.float32,
                            device=device),
        spp=0,
    )


def accumulate(state: AccumState, scene, camera: Camera, width: int,
               height: int, n_samples: int, seed,
               cfg: RenderConfig = DEFAULT_CONFIG) -> AccumState:
    """Add `n_samples` new samples to the progressive state; `seed` is the
    u32 seed word. The sample counter doubles as the RNG sample id, so a
    camera change is just a fresh `init_accum`. Returns a new state: the
    one passed in is not modified and stays valid. Its span
    (`entry.accumulate`) carries the first sample id."""
    with span("entry.accumulate", str(state.spp)):
        pixel_id = torch.arange(width * height, dtype=torch.int64,
                                device=scene.device)
        sample_ids = range(state.spp, state.spp + n_samples)
        rgb_sum, _ = render_tile(scene, camera, width, height, pixel_id,
                                 sample_ids, seed, cfg)
        return AccumState(
            rgb_sum=state.rgb_sum + rgb_sum.reshape(height, width, 3),
            spp=state.spp + n_samples,
        )


def accumulate_wavefront(state: AccumState, scene, camera: Camera, width: int,
                         height: int, n_samples: int, seed,
                         cfg: RenderConfig = DEFAULT_CONFIG,
                         pool_size: int | None = None):
    """`accumulate` on the persistent-wavefront integrator, the interactive
    front end's path: sample ids continue at `state.spp` (`sample_offset`),
    so progressive estimates match the scan route's up to addition order.
    Returns (new state, rays_traced int); the state passed in is not
    modified. Its span (`entry.accumulate_wavefront`) carries the first
    sample id."""
    with span("entry.accumulate_wavefront", str(state.spp)):
        fb, rays, _ = trace_wavefront(
            scene, camera, width, height, n_samples, seed, cfg, pool_size,
            sample_offset=state.spp,
        )
        return (
            AccumState(
                rgb_sum=state.rgb_sum + fb.reshape(height, width, 3),
                spp=state.spp + n_samples,
            ),
            rays,
        )


def to_image(state: AccumState, clamp: bool = True) -> torch.Tensor:
    """Resolve the progressive state to a linear image: the running mean,
    clamped to [0, 1] for display unless `clamp` is off. Its span
    (`entry.to_image`) carries the samples it resolves."""
    with span("entry.to_image", str(state.spp)):
        img = state.rgb_sum / float(max(state.spp, 1))
        return torch.clamp(img, 0.0, 1.0) if clamp else img
