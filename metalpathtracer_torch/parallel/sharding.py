"""Multi-device rendering: tile and sample sharding over `torch.distributed`.

Port of `metalpathtracer_tpu/parallel/sharding.py`. The two scaling axes:

- **tile sharding**: the image's rows are dealt out over the ranks, rank
  r of n taking rows r, r + n, r + 2n, ... (its *block*, a (H / n, W, 3)
  tensor whose row i is image row i n + r); each rank traces its block
  alone, and the blocks join by one `all_gather`. Dealt rows, not one
  contiguous band each, because the work is uneven down an image (a sky
  band costs one ray a path and no triangle test): every rank gets an
  even share of every band, and no rank waits long for the slowest.
  The shard-local renders trace these rows, `block_rows` cuts a whole
  image into its blocks and `join_rows` joins them back; a checkpoint
  holds the whole image in its usual row order;
- **sample sharding**: every rank renders the whole image with its own
  slice of the spp budget; the partial sums join by one `all_reduce`.

The RNG streams are positional: a draw depends on (pixel, sample, bounce),
never on the lane or the rank (`core/rng.py`). A tile-sharded render
therefore adds, pixel by pixel, the samples the render of one device adds,
in the same order, a sample-sharded one the same samples in another order,
and the two axes compose into a 2-D mesh (tiles, samples). (One thing does
depend on the lanes a ray shares its subgroup with: where it meets two
triangles at exactly one t, a shared edge, the closest hit keeps the one
its subgroup's tile order reaches first. The scan integrator's subgroups
are 128 consecutive pixels of a block, so whenever the width is a
multiple of 128 (1280, 1920) each lies within one image row, as on the
whole image; the wavefront's follow its queue, so a sharded wavefront
image can differ from the whole one's at such a pixel: 1 of 921,600 on
the reference scene at 1280x720.)

One process drives one device: every render path is bound by its host's
dispatch, so one Python thread feeding several devices would scale by
nothing. Every rank uploads the scene (a few MB); rays never cross ranks.

Two layers. The *shard-local* functions (`shard_render`,
`shard_render_wavefront`, `shard_accumulate`) take the shard's indices and
return its part; they call no collective, so a loop over the indices in
one process computes what the ranks compute. The entry points check their
arguments (every rank before its first collective, so a bad argument
raises on all ranks and none waits for one that left), call the
shard-local function with the mesh's indices and join the parts. A world
of one calls no collective at all.

`STATS` counts this rank's own traced rays and tile passes (closest-hit
tile passes, 2^20 ray-triangle tests each; the wavefront integrator
reports them, the scan does not), summed over the shard-local calls: the
balance of work between ranks.

The reference's cached jit functions, `shard_map`, `check_vma` and buffer
donation have no counterpart: nothing here is compiled, and
`accumulate_sharded` returns a new state and leaves its input valid.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from metalpathtracer_torch.core import rng
from metalpathtracer_torch.render.integrator import (
    DEFAULT_CONFIG,
    RenderConfig,
    trace_wavefront,
)
from metalpathtracer_torch.render.pipeline import AccumState, render_tile
from metalpathtracer_torch.utils.metrics import span

# this rank's own work, summed over its shard-local calls
STATS = {"rays": 0, "tile_passes": 0.0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tiles, samples) grid of ranks and this rank's place in it: rank =
    tile_index * n_samples + sample_index. `tiles_group` joins the ranks of
    this rank's column (one sample slice, every tile block), `samples_group`
    those of its row (one tile block, every sample slice); None stands for
    the default process group (a 1-D mesh) or for no group (a world of
    one)."""

    n_tiles: int
    n_samples: int
    tile_index: int = 0
    sample_index: int = 0
    tiles_group: object = None
    samples_group: object = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.n_tiles, self.n_samples

    @property
    def size(self) -> int:
        return self.n_tiles * self.n_samples


def _world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# the row and column groups of a 2-D grid, made once per default group:
# (n_tiles, n_samples) -> (default group, tiles_group, samples_group)
_grid_groups: dict = {}


def make_mesh(n: int | None = None, axis: str = "tiles") -> Mesh:
    """1-D mesh over the default process group, along `axis` ("tiles" or
    "samples"). `n`, when given, must be the world size: a process cannot
    stand outside its own group."""
    if axis not in ("tiles", "samples"):
        raise ValueError(f"unknown mesh axis {axis!r}")
    rank, world = _world()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} needs a process group of {n} ranks, "
                         f"this one has {world}")
    if axis == "tiles":
        return Mesh(world, 1, tile_index=rank)
    return Mesh(1, world, sample_index=rank)


def make_mesh_2d(n_tiles: int, n_samples: int) -> Mesh:
    """2-D (tiles, samples) mesh over the default process group, whose size
    must be n_tiles * n_samples. Every rank must call it (it makes the row
    and column groups, a collective)."""
    rank, world = _world()
    if n_tiles * n_samples != world:
        raise ValueError(f"a {n_tiles}x{n_samples} mesh needs a process group "
                         f"of {n_tiles * n_samples} ranks, this one has {world}")
    ti, si = divmod(rank, n_samples)
    if n_tiles == 1 or n_samples == 1:  # a row or a column is the whole world
        return Mesh(n_tiles, n_samples, ti, si)
    default = dist.group.WORLD
    made = _grid_groups.get((n_tiles, n_samples))
    if made is None or made[0] is not default:
        # every rank makes every group, in one order
        rows = [dist.new_group([t * n_samples + s for s in range(n_samples)])
                for t in range(n_tiles)]
        cols = [dist.new_group([t * n_samples + s for t in range(n_tiles)])
                for s in range(n_samples)]
        made = (default, cols[si], rows[ti])
        _grid_groups[(n_tiles, n_samples)] = made
    return Mesh(n_tiles, n_samples, ti, si, tiles_group=made[1],
                samples_group=made[2])


def _check_divisible(height: int, n: int) -> None:
    if height % n != 0:
        raise ValueError(
            f"image height {height} must divide evenly across {n} tile shards"
        )


# ---------------------------------------------------------------------------
# the joins
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """`t` where the group's backend can reach it: gloo moves host memory
    alone, so a tensor on a card is staged through the host; any other
    backend (nccl) gets the tensor where it lies."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _gather_rows(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The blocks of the "tiles" axis, joined into the whole image; on
    every rank."""
    if mesh.n_tiles == 1:
        return block
    mine = _wire(block.contiguous(), mesh.tiles_group)
    parts = [torch.empty_like(mine) for _ in range(mesh.n_tiles)]
    dist.all_gather(parts, mine, group=mesh.tiles_group)
    return join_rows(parts).to(block.device)


def _sum_samples(part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The partial sums of the "samples" axis, added; on every rank."""
    if mesh.n_samples == 1:
        return part
    total = _wire(part.contiguous(), mesh.samples_group)
    if total is part:
        total = part.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.samples_group)
    return total.to(part.device)


def _sum_rays(rays: int, mesh: Mesh, device, tiles: bool = True,
              samples: bool = True) -> int:
    """A ray count summed over the named axes of the mesh."""
    for on, n, group in ((tiles, mesh.n_tiles, mesh.tiles_group),
                         (samples, mesh.n_samples, mesh.samples_group)):
        if on and n > 1:
            with span("shard.rays"):
                wire = "cpu" if dist.get_backend(group) == "gloo" else device
                count = torch.tensor(rays, dtype=torch.int64, device=wire)
                dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
                rays = int(count)
    return rays


# ---------------------------------------------------------------------------
# the shard-local layer: no collective
# ---------------------------------------------------------------------------


def shard_render(scene, camera, width: int, height: int, spp: int, seed: int,
                 cfg: RenderConfig, tile_index: int = 0, n_tiles: int = 1,
                 sample_index: int = 0, n_samples: int = 1):
    """The scan integrator on one shard: block `tile_index` of `n_tiles`
    (rows tile_index, tile_index + n_tiles, ...), samples
    `sample_index * spp / n_samples` onward, in one pass. Returns
    (rgb_sum (height / n_tiles, width, 3), rays int)."""
    rows_per = height // n_tiles
    spp_per = spp // n_samples
    i64 = dict(dtype=torch.int64, device=scene.device)
    rows = torch.arange(rows_per, **i64)[:, None] * n_tiles + tile_index
    pixel_id = (rows * width + torch.arange(width, **i64)).reshape(-1)
    sample_ids = range(sample_index * spp_per, (sample_index + 1) * spp_per)
    rgb_sum, rays = render_tile(scene, camera, width, height, pixel_id,
                                sample_ids, rng.seed_from_int(seed), cfg)
    rays = int(rays)
    STATS["rays"] += rays
    return rgb_sum.reshape(rows_per, width, 3), rays


def shard_render_wavefront(scene, camera, width: int, height: int, spp: int,
                           seed: int, cfg: RenderConfig,
                           pool_size: int | None = None, tile_index: int = 0,
                           n_tiles: int = 1, sample_index: int = 0,
                           n_samples: int = 1, sample_offset: int = 0):
    """The wavefront integrator on one shard: its queue, lane pool and
    framebuffer cover the shard's block alone (rows tile_index,
    tile_index + n_tiles, ...: `trace_wavefront`'s `row_stride`), while
    pixel and sample ids stay global. Returns (rgb_sum (height / n_tiles,
    width, 3), rays)."""
    rows_per = height // n_tiles
    spp_per = spp // n_samples
    fb, rays, stats = trace_wavefront(
        scene, camera, width, height, spp_per, rng.seed_from_int(seed), cfg,
        pool_size, sample_offset=sample_offset + sample_index * spp_per,
        pixel_offset=tile_index * width, n_pixels=rows_per * width,
        row_stride=n_tiles,
    )
    STATS["rays"] += rays
    STATS["tile_passes"] += stats["tile_passes"]
    return fb.reshape(rows_per, width, 3), rays


def shard_accumulate(state: AccumState, scene, camera, n_samples: int,
                     seed: int, cfg: RenderConfig, pool_size: int | None,
                     tile_index: int, n_tiles: int):
    """`n_samples` more samples on the block `state` holds (block
    `tile_index` of `n_tiles`). Returns (new state, this block's rays)."""
    rows_per, width = state.rgb_sum.shape[:2]
    fb, rays = shard_render_wavefront(
        scene, camera, width, rows_per * n_tiles, n_samples, seed, cfg,
        pool_size, tile_index, n_tiles, sample_offset=state.spp,
    )
    return AccumState(state.rgb_sum + fb, state.spp + n_samples), rays


def block_rows(rgb: torch.Tensor, tile_index: int, n_tiles: int):
    """Block `tile_index` of `n_tiles` of a whole (H, W, 3) image: its rows
    tile_index, tile_index + n_tiles, ... (a view)."""
    _check_divisible(rgb.shape[0], n_tiles)
    return rgb[tile_index::n_tiles]


def join_rows(parts) -> torch.Tensor:
    """The whole (H, W, 3) image from the blocks of every tile index, in
    order: `block_rows`' inverse."""
    return torch.stack(parts, dim=1).reshape(-1, *parts[0].shape[1:])


# ---------------------------------------------------------------------------
# one-shot renders
# ---------------------------------------------------------------------------


def render_image_sharded(scene, camera, width: int, height: int, spp: int,
                         seed: int = 0, cfg: RenderConfig = DEFAULT_CONFIG,
                         mesh: Mesh | None = None):
    """Tile-sharded render over a 1-D mesh. Returns (image (H, W, 3), rays)
    on every rank. Each rank traces every n-th row; equal to
    `render_image` in one pass for any number of ranks."""
    if mesh is None:
        mesh = make_mesh()
    _check_divisible(height, mesh.n_tiles)
    block, rays = shard_render(scene, camera, width, height, spp, seed, cfg,
                               mesh.tile_index, mesh.n_tiles)
    rays = _sum_rays(rays, mesh, scene.device, samples=False)
    return _gather_rows(block, mesh) / spp, rays


def render_image_wavefront_sharded(scene, camera, width: int, height: int,
                                   spp: int, seed: int = 0,
                                   cfg: RenderConfig = DEFAULT_CONFIG,
                                   mesh: Mesh | None = None,
                                   pool_size: int | None = None):
    """Tile-sharded render where each rank runs the wavefront integrator
    over its own block of rows; the framebuffer gather is the one exchange of
    pixels. Equal to the wavefront render of one device."""
    if spp <= 0:
        raise ValueError(f"spp must be positive, got {spp}")
    if mesh is None:
        mesh = make_mesh()
    _check_divisible(height, mesh.n_tiles)
    block, rays = shard_render_wavefront(
        scene, camera, width, height, spp, seed, cfg, pool_size,
        mesh.tile_index, mesh.n_tiles)
    rays = _sum_rays(rays, mesh, scene.device, samples=False)
    return _gather_rows(block, mesh) / spp, rays


def render_image_sample_sharded(scene, camera, width: int, height: int,
                                spp: int, seed: int = 0,
                                cfg: RenderConfig = DEFAULT_CONFIG,
                                mesh: Mesh | None = None):
    """Sample-sharded render: rank i traces samples [i*spp/n, (i+1)*spp/n)
    of every pixel; the partial sums join by one `all_reduce`."""
    if mesh is None:
        mesh = make_mesh(axis="samples")
    n = mesh.n_samples
    if spp % n != 0:
        raise ValueError(f"spp {spp} must divide evenly across {n} shards")
    part, rays = shard_render(scene, camera, width, height, spp, seed, cfg,
                              sample_index=mesh.sample_index,
                              n_samples=mesh.n_samples)
    rays = _sum_rays(rays, mesh, scene.device, tiles=False)
    return _sum_samples(part, mesh) / spp, rays


def render_image_sample_sharded_wavefront(scene, camera, width: int,
                                          height: int, spp: int, seed: int = 0,
                                          cfg: RenderConfig = DEFAULT_CONFIG,
                                          mesh: Mesh | None = None,
                                          pool_size: int | None = None):
    """Sample-sharded render on the wavefront integrator: rank i traces
    samples [i*spp/n, (i+1)*spp/n) of every pixel through a pool of its
    own (`sample_offset` keeps the RNG streams global)."""
    if mesh is None:
        mesh = make_mesh(axis="samples")
    n = mesh.n_samples
    if spp % n != 0:
        raise ValueError(f"spp {spp} must divide evenly across {n} shards")
    part, rays = shard_render_wavefront(
        scene, camera, width, height, spp, seed, cfg, pool_size,
        sample_index=mesh.sample_index, n_samples=mesh.n_samples)
    rays = _sum_rays(rays, mesh, scene.device, tiles=False)
    return _sum_samples(part, mesh) / spp, rays


def _default_2d() -> Mesh:
    """Two sample slices and world / 2 tile blocks; a world of one is 1x1."""
    world = _world()[1]
    return make_mesh_2d(1, 1) if world == 1 else make_mesh_2d(world // 2, 2)


def _check_2d(height: int, spp: int, mesh: Mesh) -> None:
    _check_divisible(height, mesh.n_tiles)
    if spp % mesh.n_samples != 0:
        raise ValueError(
            f"spp {spp} must divide across {mesh.n_samples} sample shards")


def render_image_sharded_2d_wavefront(scene, camera, width: int, height: int,
                                      spp: int, seed: int = 0,
                                      cfg: RenderConfig = DEFAULT_CONFIG,
                                      mesh: Mesh | None = None,
                                      pool_size: int | None = None):
    """Composed tile x sample sharding on the wavefront integrator: tiles
    split the rows (local pools and framebuffers), samples split spp."""
    if mesh is None:
        mesh = _default_2d()
    _check_2d(height, spp, mesh)
    part, rays = shard_render_wavefront(
        scene, camera, width, height, spp, seed, cfg, pool_size,
        mesh.tile_index, mesh.n_tiles, mesh.sample_index, mesh.n_samples)
    rays = _sum_rays(rays, mesh, scene.device)
    return _gather_rows(_sum_samples(part, mesh), mesh) / spp, rays


def render_image_sharded_2d(scene, camera, width: int, height: int, spp: int,
                            seed: int = 0, cfg: RenderConfig = DEFAULT_CONFIG,
                            mesh: Mesh | None = None):
    """Composed tile x sample sharding over a 2-D mesh on the scan
    integrator: tiles split the rows, samples split spp."""
    if mesh is None:
        mesh = _default_2d()
    _check_2d(height, spp, mesh)
    part, rays = shard_render(scene, camera, width, height, spp, seed, cfg,
                              mesh.tile_index, mesh.n_tiles,
                              mesh.sample_index, mesh.n_samples)
    rays = _sum_rays(rays, mesh, scene.device)
    return _gather_rows(_sum_samples(part, mesh), mesh) / spp, rays


# ---------------------------------------------------------------------------
# progressive tile-sharded accumulation
# ---------------------------------------------------------------------------


def init_accum_sharded(width: int, height: int, mesh: Mesh, device) -> AccumState:
    """Row-sharded progressive state: an `AccumState` whose `rgb_sum` is
    this rank's (height / n, width, 3) block (`block_rows`' layout) on
    `device`."""
    _check_divisible(height, mesh.n_tiles)
    return AccumState(
        rgb_sum=torch.zeros((height // mesh.n_tiles, width, 3),
                            dtype=torch.float32, device=device),
        spp=0,
    )


def accumulate_sharded(state: AccumState, scene, camera, n_samples: int,
                       seed: int = 0, cfg: RenderConfig = DEFAULT_CONFIG,
                       mesh: Mesh | None = None,
                       pool_size: int | None = None) -> tuple[AccumState, int]:
    """Add `n_samples` per pixel to a tile-sharded progressive state: each
    rank traces its block of rows with the wavefront integrator, the sample
    ids continuing at `state.spp`, so the estimate is that of an unsharded
    render of the same total spp. The one collective is the ray count's.
    Checkpoint through `gather_accum`, resume through `shard_accum`.
    Returns (new state, rays traced in this step by all ranks)."""
    if n_samples <= 0:
        raise ValueError(f"n_samples must be positive, got {n_samples}")
    if mesh is None:
        mesh = make_mesh()
    with span("entry.accumulate_sharded", str(state.spp)):
        state, rays = shard_accumulate(state, scene, camera, int(n_samples), seed,
                                       cfg, pool_size, mesh.tile_index, mesh.n_tiles)
        return state, _sum_rays(rays, mesh, scene.device, samples=False)


def gather_accum(state: AccumState, mesh: Mesh) -> AccumState:
    """The whole (H, W, 3) state from every rank's block, in the image's row
    order, on every rank: what `io.checkpoint.save_checkpoint` writes."""
    return AccumState(_gather_rows(state.rgb_sum, mesh), state.spp)


def shard_accum(state: AccumState, mesh: Mesh) -> AccumState:
    """This rank's block of a whole state (one `load_checkpoint` read):
    what `accumulate_sharded` continues from."""
    block = block_rows(state.rgb_sum, mesh.tile_index, mesh.n_tiles)
    return AccumState(block.contiguous(), state.spp)
