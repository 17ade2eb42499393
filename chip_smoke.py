#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`metalpathtracer_torch`) on one card.

Builds the hand-written CUDA kernels from `metalpathtracer_torch/csrc/` (one
`nvcc` a source, started together), holds each to its plain PyTorch version
at the shapes the render paths give it, then drives those paths through the
port's entry points at full size and checks that every advance went through
the kernels of its path: the closest hit, the tile cull, the RNG's
threefry, the bounce step's front end, and its shading, which without NEE
starts from the closest hit's winners and runs the epilogue in its own
registers (`shade_hit`, on the wavefront at one bounce an advance with
the bank: the shading that also banks the finished paths); the epilogue's
own kernel runs with NEE (its closest hits and shadow rays'), and the BVH
path shades in plain torch; and the wavefront's regeneration: the restart
(each lane's pixel and sample, and where it restarts its jittered primary
ray), the window's queue pop, and the pool sort's key and gather
(`csrc/wavefront.cu`). Eleven kernel entries in seven sources.
Phases, each raising on failure:

1. set up: the card, TF32 off, the kernel builds, the instructions the
   cull kernel's slab-test loop issues per (ray, tile) pair and those every
   lane of the threefry kernel issues for each count of counter blocks in
   a bundle (their SASS);
2. `mm_closest_hit` vs its plain twin on the reference scene's 921,600
   primary rays, the rays left after one bounce, the pool-width set (the
   arguments of the 100th `mm_closest_hit` call of the flagship wavefront
   render: 32,768 lanes after the tileset sort) and two sets of a viewer
   frame at 512x288, depth 8 (the 5th call on its 16,384-lane pool and
   the first on the 1,024 lanes it drains at), all captured by wrapping
   the function: hit columns equal except at near-ties and
   triangle edges, t within the CPU tests' bound, and the walked list
   positions equal on every subgroup whose 128 lanes agree on t bit for
   bit; each set's tested pairs, bound and share of the bound;
3. `closest_hit_mm_full` on the kernels vs the brute-force oracle on a
   65,536-ray subset (tests/test_intersect_mm.py's criteria);
4. the tile cull vs its plain versions, bit-equal: the entry the paths
   launch, `_cull_tile_lists` (the cull that sorts each subgroup's row into
   the closest hit's lists in its block, by rank or by radix as the row's
   length picks), against `cull_tile_lists_reference`, and the plain
   cull's entry `cull_tiles` against `cull_pass_reference`, at 39 tiles
   (921,600 primary rays, the 32,768 pool lanes of the same flagship
   advance, and the viewer frame's 16,384 and 1,024 lanes of the same two
   advances), 311 tiles (bunny70k) and 1,242 tiles (bunny300k), the latter
   two on 32,768 rays after one bounce with an active mask and the sphere
   pass's occlusion bound; each set's route, both entries' device times,
   the plain cull followed by the torch ops that sorted its rows before
   (`tail_ms`), the lists entry's bound and its issue estimate (the SASS
   count per pair of the rank route's function at one instruction per lane
   per clock on every SM);
5. `mm_closest_hit` at tile_p 256 (bunny300k) vs its twin on 32,768
   primary and 32,768 bounce-1 rays, and vs the brute oracle on 8,192;
6. the scan path: `cli.main` at 1280x720, spp 4, depth 32 (its bounce
   blocks replayed as CUDA graphs, as a user's call runs them);
7. the wavefront path: `cli.main --wavefront` at the same size (pool 2^15),
   its image against the scan path's;
8. the large-scene legs: `render_image_wavefront` on bunny70k and
   bunny300k at 512x512, spp 2, depth 8, pool 2^15;
9. small renders (320x180, spp 2, depth 8) of both paths on the kernels vs
   on the plain versions, and vs on the RNG's twin alone and on the bounce
   step's twins alone (each bit-equal), and the golden
   reference-scene case vs tests/golden/reference_scene.npz;
10. the checkpointed CLI: `cli.main --checkpoint --checkpoint-every 2` at
    1280x720, depth 32, to 2 spp, then `--resume` to 4 spp, and the same to
    4 spp without interruption: the two images bit-equal, both against
    phase 6's within the render limit, as many launches on the card as
    phase 6 made, and a resume with another `--fov` exits 2 and leaves the
    file as it was;
11. the progressive wavefront: four `accumulate_wavefront` steps of 1 spp
    at 1280x720, depth 32, pool 2^15 against four `accumulate` steps, step
    for step within the render limit, with the sample ids continuing;
12. the viewer at its defaults (512x288, depth 8, 1 spp per frame): its
    loop in this process on a counted path, five frames with torch's
    synchronising calls counted (`SyncCounter`) and ten without, each
    timed, the fifth frame's accumulation held against five `accumulate`
    steps within the render limit and the frame shown against the
    accumulation it resolves, and the flagged calls per frame, in all and
    from the RNG's modules; then `python3 -m metalpathtracer_torch.viewer
    --max-frames 60 --no-mouse` in a child under a pty with
    `MPT_VIEWER_TRACE=1`, the child's stderr and the pty drained while it
    runs; a `w` key written into the pty after frame 30 must bring the
    displayed frame back to 1 spp; frames per second over frames 10 on and
    kernel launches per frame are read from the child's trace lines (how
    many frames reach the terminal is the terminal's own rate: the writer
    is latest-wins);
13. the BVH study path: `closest_hit_bvh` against the brute oracle on phase
    3's 65,536 rays (phase 3's criteria), its time beside
    `closest_hit_mm_full`'s on the same rays, and `cli.main --intersector
    bvh` at 320x180, spp 2, depth 8, on the scan and with `--wavefront`,
    against the `mm` render: it must launch neither tile kernel nor the
    front end, the hit epilogue or the shading kernel (it shades in plain
    torch), run on its integrator's eager loop by config (no warm-up,
    capture or replay) and equal its render under `graphs.eager()` bit for
    bit;
14. the sharded path (`parallel/sharding.py` over `torch.distributed`):
    a. `cli.main --tile-shard` and `--tile-shard --wavefront` on the
       flagship in a world of one: images bit-equal to phases 6 and 7's,
       the same rays, the same launches of each kernel;
    b. the reference's config 5 at full width: `scenes/multimesh.xml`,
       1920x1080, depth 8, `init_accum_sharded` and four
       `accumulate_sharded` steps of 4 spp in a world of one, against
       `render_image_wavefront` of the same 16 spp (rtol 1e-6, atol 1e-7,
       equal rays); one line a step with its advances and launches;
    c. two ranks on the one card: this script started twice as a rank
       (`--shard-rank`), both on `cuda:0`, joined by gloo over a file store
       (NCCL refuses two ranks on one device, so the joins stage through
       the host); each runs `cli.main --tile-shard` on the flagship on both
       integrators and two `accumulate_sharded` steps of config 5; rank 0's
       scan image is bit-equal to part a's; its wavefront image and its
       accumulation (against part b's after two steps) are equal but for
       pixels where a ray meets two triangles at one t (`same_but_ties`: at
       most 1e-4 of the pixels; none on two ranks), every rank launched
       both kernels on every bounce step and no plain version, and the
       per-rank launches are summed.
       The same jobs run in a world of one rank started the same way, and
       the seconds of both are printed side by side;
    d. each rank's own work in config 5's pass over four tile ranks, rank
       after rank on one card: rays, tile passes and seconds a pass of the
       dealt rows (counted by `sharding.STATS`) and of the contiguous row
       blocks the ranks traced before; the dealt rows' busiest rank must be
       within 5% of the mean in rays and in tile passes;
15. next-event estimation and Russian roulette on the card (NEE,
    `rr_start` 3), each held to the same render on the CPU (plain
    versions) within the render limit: the reference's config 4
    (`scenes/cornell_glass.xml`, 512x512, depth 16; spp cut from 1024 to 2;
    spheres alone, so it launches no tile kernel) and `scenes/multimesh.xml` at
    320x180, spp 2, depth 8 on both integrators, whose shadow rays go
    through both kernels; NEE shades in plain torch, by config: the
    front end (as the sphere pass on config 4) and the hit epilogue run
    twice a bounce step (its closest hit and its shadow rays'), the four
    shading kernels never;
16. `threefry_bundle` vs its plain twin (run after phase 5, with the other
    kernels' comparisons), at the bundles the paths give it: the bounce
    step's (lobe and Fresnel, per-lane sample ids and bounces; 32,768
    lanes) and the restart's jitter of the flagship's advance
    CAPTURE_CALL, the scan's 921,600-lane jitter and first bounce step, a
    viewer frame's pool call 5 (16,384 lanes) and drain call 1, config 4's
    first bounce step (its five draws: lobe, Fresnel, light pick, light,
    Russian roulette; 262,144 lanes) and the Mosaic probe's own call as a
    bundle of one (`benchmarks/mosaic_probe.py`: seed 42, an (8, 128) int32
    tile of ids, sample 3, bounce 0, purpose 7, unit vectors): uniforms
    bit-equal, unit vectors bit-equal or within 4 ulp of 1.0 (the gap
    printed); each with its device, call and plain time and its bound, the
    larger of its bytes at the memory rate and what its lanes issue (the
    SASS count) at the pipes' rates on every SM; a bounce step's bundle
    also against its draws as separate launches (bundles of one, Fresnel,
    light pick and Russian roulette as pairs, as `uniform1` drew them
    before the bundle), and with `--against` against the other tree's
    kernel in turns;
17. both integrators' loops as CUDA graphs (`render/graphs.py`) against
    the eager loop (`graphs.eager()`): the wavefront's windows on the
    flagship, four progressive 1-spp steps, the viewer's loop for
    GRAPH_VIEWER_FRAMES (30) frames with a `w` key after frame 15, one
    config-5 step and the bunny300k leg; the scan's bounce blocks on phase
    6's flagship, phase 10's checkpointed render (to 4 spp in steps of 2, each written to
    disk: seconds until on disk), the viewer's loop with `--integrator
    scan` for 60 frames with the key, and config 4 (phase 15's). Each: a
    counted render on each loop, then the graph path's first render with
    its captures and their seconds, then GRAPH_REPEATS timed renders of
    each loop in turns (median and range); every render's images
    `torch.equal` and its launches on the card (the kernels' tallies)
    equal to the eager loop's, on the scan plus what its idle steps (run
    by a block past its last live lane, counted in the program's report)
    launch, each an eager bounce step's launches (the flagships' exactly
    408 / 408 / 408 and 128 / 128 / 132 on both loops, PERF.md; the bounce
    step's front end and shading kernel 408 and 128 each: on the wavefront
    `shade_bank_hit_kernel`, on the scan `shade_hit_kernel`, each the other
    0; the hit epilogue's own kernel 0); host reads
    a render (one a window, drain block or scan block; on the scan's eager
    loop one a bounce step), flagged synchronising calls inside windows
    and blocks (0 on both loops); the busy share of one profiled render of
    each loop (the union of its device intervals over its own wall time;
    its kernel events held against its tallies) and, on the graph loop,
    the replays' share of one unprofiled render between CUDA events; then
    the closest hit, the cull, the threefry bundle and the bounce step's
    kernels of call GRAPH_CALL inside a captured flagship window, and of a
    captured bounce block of the flagship scan, the viewer's scan frames
    and config 4 (its bundle, sphere pass and epilogue: no triangle, NEE), as
    the last replay computed them: each bit-equal to an eager launch of its
    kernel at the same inputs, and held against its plain version by
    phases 2, 4, 16 and 18's criteria;
18. (run after phase 16) the bounce step's kernels (`hit_front`, and as
    `sphere_pass` without the closest hit's operands; `hit_epilogue`;
    `shade_hit`, without and with the bank: `shade_bank_hit`) vs their
    plain twins, bit-equal (NaN where both are NaN), at the calls the paths make:
    the flagship scan's first and second bounce steps (921,600 lanes), the
    flagship wavefront's advance CAPTURE_CALL (32,768 lanes), a viewer
    frame's pool call 5 (16,384) and drain call 1 (1,024), the bunny300k
    leg's first step (32,768) and config 4's first step (262,144 lanes,
    spheres alone; its closest hit and its shadow rays', the sphere pass and
    the epilogue alone; without NEE, its shading); the shading without and
    with the bank at each of these shapes (`complete_shading_set`: where a
    step shaded from the winners, the epilogue's call at those winners, and
    the shading with bank operands made from the call's, or the bank
    dropped), and the front end also on 921,523 of the scan's
    lanes (not whole 128-lane subgroups) with an active mask and an
    occlusion bound; each with its device, call and plain time and its
    bound, the larger of its bytes at the memory rate and its operations
    (counted from its source) at the f32 peak; then the global loads each
    function of `csrc/shade.cu` issues before its first global store (its
    SASS), of this tree's build and, with `--against`, the other's;
19. (run after phase 18) the wavefront's regeneration kernels
    (`restart_lanes`, `queue_pop`, `tileset_key`, `permute_lanes`) vs their
    plain twins, bit-equal (NaN where both are NaN), at the calls the paths
    make: the flagship wavefront's advance CAPTURE_CALL (32,768 lanes: its
    queue pop and restart, and the sort after it), a viewer frame's pool
    (16,384) and drain (1,024) calls, the queue at the drain's width
    (the viewer pool's call cut to 1,024 lanes: the drain pops no queue),
    and advance CAPTURE_CALL of a tile shard (rank 2 of 4 of config 5:
    every 4th row, `row_stride` 4; every restarted pixel on its rows);
    each with its device, call and plain time, the time of one PyTorch call
    that computes the same function where there is one (`torch.cumsum` for
    the queue's ranks, `index_select` of the packed lane state for the
    gather) and its bound, the larger of its bytes at the memory rate and
    its operations (the restart's threefry at the int32 rate, its rays and
    the key's slab tests at the f32 peak). Phase 17 also holds each of the
    four, inside a captured flagship window as the last replay computed
    it, to an eager launch and to its twin; and every wavefront path of
    phases 7, 8 and 17 must launch them (the key and the gather as often
    as each other).
No earlier path runs at a smaller depth than before. Every path through
`trace_wavefront` (phases 7, 8, 9, 11, 12, 14, 15) runs its windows as CUDA
graph replays, and every scan render (phases 6, 9, 10, 11, 12, 14, 15) its
bounce blocks, as a user's call does; the captures of kernel calls (phases
2, 4, 16) and the plain versions run on the eager loop, since a replay runs
no Python and a plain version reads the device on the host. Each path of
phases 6-8, 10-12, 14, 15 and 17 runs with every launch count set to 0 just
before it and read just after, and with the plain versions counted (they
must not run). A launch is counted where it runs: each kernel adds to a
tally on the device (`render/kernels/_build.py`), which a graph replay
moves as an eager launch does; the wrappers' Python counts hold the
eager launches and those traced into a capture, and must equal the
tallies where nothing was replayed (the regeneration's kernels too).
Every traced bounce step must launch
both tile kernels once and the threefry kernel exactly once (its bundle),
with at least two draws, the front end at least once, and exactly one of
the shading kernels or, with NEE, the plain shading; a step that does not
shade from the closest hit's winners launches the hit epilogue.
A kernel's `ms` is its device time: 20 calls captured in one CUDA graph,
replayed between CUDA events (`device_ms`); its `call_ms` is the mean of 20
wrapper calls back to back between CUDA events (`call_ms`), which reads the
host's enqueue rate where the kernel is shorter than the wrapper's host
work; plain versions are timed as calls. Renders are timed by host clocks
around work that ends in a synchronise. A kernel's bound is the larger of
its operations at the f32 CUDA-core peak (67 TFLOP/s) and its bytes at the
memory rate (3.35 TB/s), both of an H100 SXM at 700 W; the closest hit's
operations are 38 flop per (ray, triangle) pair its subgroups walked, the
cull's 12 per (ray, tile) pair.

The second-to-last lines of standard output are the kernels' JSON record and
the card's name and power limit; the last line is the result JSON. Writes
images, compiler logs and a summary into the gitignored directory `OUT`.

Usage:
    python3 chip_smoke.py            # what a check runs
    python3 chip_smoke.py --profile  # also torch.profiler tables of the
                                     # wavefront path and the bunny300k leg
    python3 chip_smoke.py --sweep    # also time `mm_closest_hit` built
                                     # with 1, 2, 4 and 8 column slices
                                     # and 1 and 4 rays per thread,
                                     # `cull_tile_lists` with at most 8,
                                     # 16 and 32 warps per block, aiming at 64, 128
                                     # and 256 warps per SM, and `threefry`
                                     # with 64, 128 and 256 threads a block,
                                     # and `mm_closest_hit` at cluster
                                     # widths 1, 2, 4 and 8 at 8, 128, 256
                                     # and 7,200 subgroups, on the device
    python3 chip_smoke.py --against _archive/parent
                                     # also time the three kernels built
                                     # from another checkout's sources
                                     # against this one's, and the flagship
                                     # CLI renders of both trees, in turns
    python3 chip_smoke.py --scan-blocks
                                     # phase 1, then the scan's SCAN_BLOCK
                                     # at 1, 4, 8 and max_depth on the
                                     # flagship scan and the viewer's scan
                                     # frames, timed in turns; then [R]:
                                     # device time by profiler range of a
                                     # render of both flagships on the graph
                                     # path (replays through their capture-
                                     # time node maps), and
                                     # the graph path's seconds and device
                                     # time of both and the bunny300k leg
                                     # (--profile runs [R] too); inside the
                                     # closest hit's inputs and the bank,
                                     # device time by kernel name
    python3 chip_smoke.py --cards 4  # phases 1, 6, 7 and 14 alone, 14c with
                                     # one rank on each of 4 cards, joined
                                     # by nccl (a machine with 4 cards),
                                     # 14d on the first
    python3 chip_smoke.py --shard-rank SPEC.json RANK
                                     # one rank of phase 14c's worlds (the
                                     # script starts these itself)
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import inspect
import io
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
sys.path.insert(0, str(ROOT))

# the prefix of the port's profiler ranges: device events of that name are
# the ranges' own spans, not work
from metalpathtracer_torch.utils.metrics import SPAN_PREFIX  # noqa: E402
T_MIN = 1e-4
# t of a hit both sides agree on: the CPU tests' closest-hit bound
# (tests/test_torch_closest_hit.py, from tests/test_intersect_mm.py)
T_RTOL, T_ATOL = 5e-4, 1e-2
# a ray whose winners differ may pass this close to a triangle edge
# (barycentric units, float64): a float32 accept/reject flip
EDGE_MARGIN = 1e-3
# at most this share of rays may differ at all
MAX_MISMATCH = 1e-4
# two renders of one estimator: share of pixels that may differ by > 1e-3
# (a path flipping at a triangle edge), and the bound on their means
IMG_FRAC, IMG_MEAN = 0.02, 5e-3
TPU_FILE = "metalpathtracer_tpu/render/pallas/intersect_mm.py"
KERNELS = {
    "mm_closest_hit": dict(source="metalpathtracer_torch/csrc/mm_closest_hit.cu",
                           replaces=f"{TPU_FILE}:477",
                           also_replaces=f"{TPU_FILE}:555"),
    "cull_tile_lists": dict(source="metalpathtracer_torch/csrc/cull_tiles.cu",
                            replaces=f"{TPU_FILE}:712",
                            also_replaces=f"{TPU_FILE}:1008"),
    "threefry": dict(source="metalpathtracer_torch/csrc/threefry.cu",
                     replaces="benchmarks/mosaic_probe.py:42"),
    # the bounce step's XLA fusions (no Pallas body): the sphere pass with
    # the closest hit's operands (the front end), the closest hit's
    # epilogue, and the shading without next-event estimation from the
    # closest hit's raw winners (the epilogue in the shading's registers),
    # with the wavefront advance's bank where given
    "hit_front": dict(source="metalpathtracer_torch/csrc/sphere_pass.cu",
                      replaces=f"{TPU_FILE}:1279",
                      also_replaces=f"{TPU_FILE}:395, {TPU_FILE}:1340"),
    "hit_epilogue": dict(source="metalpathtracer_torch/csrc/hit_epilogue.cu",
                         replaces=f"{TPU_FILE}:1315"),
    # the entry's two device kernels: `shade_hit_kernel` and, given the
    # bank, `shade_bank_hit_kernel<K>`
    "shade_hit": dict(source="metalpathtracer_torch/csrc/shade.cu",
                      replaces="metalpathtracer_tpu/render/integrator.py:315",
                      also_replaces=f"{TPU_FILE}:1315"),
    "shade_bank_hit": dict(source="metalpathtracer_torch/csrc/shade.cu",
                           replaces="metalpathtracer_tpu/render/integrator.py:315",
                           also_replaces="metalpathtracer_tpu/render/integrator.py:702, "
                                         f"{TPU_FILE}:1315"),
}
# the wavefront's regeneration (no Pallas body either: the JAX package's
# XLA fusions of its jitted window's lane refill and pool sort)
TPU_INTEGRATOR = "metalpathtracer_tpu/render/integrator.py"
WAVEFRONT_CU = "metalpathtracer_torch/csrc/wavefront.cu"
KERNELS.update(
    restart_lanes=dict(source=WAVEFRONT_CU, replaces=f"{TPU_INTEGRATOR}:768",
                       also_replaces=f"{TPU_INTEGRATOR}:624, "
                                     "metalpathtracer_tpu/render/pipeline.py:33"),
    queue_pop=dict(source=WAVEFRONT_CU, replaces=f"{TPU_INTEGRATOR}:979"),
    tileset_key=dict(source=WAVEFRONT_CU, replaces=f"{TPU_INTEGRATOR}:835",
                     also_replaces=f"{TPU_FILE}:967"),
    permute_lanes=dict(source=WAVEFRONT_CU, replaces=f"{TPU_INTEGRATOR}:916"))
# their wrappers (render/kernels/wavefront.py), by the names of their
# device tallies, and the keys of their launches in a counted path's record
REGEN = ("restart_lanes", "queue_pop", "tileset_key", "permute_lanes")
REGEN_KEYS = ("restart_launches", "queue_launches", "key_launches", "permute_launches")
# the bounce step's device kernels (`<name>_kernel`), and the keys of their
# launches in a counted path's record: the front end, the hit epilogue, and
# the shading from the closest hit's winners without and with the bank (one
# of the two, or NEE's or the BVH and brute intersectors' plain shading, a
# bounce step). Each is counted by its entry's device tally
# (render/kernels/_build.py): the two shadings by the one entry
# `shade_hit`'s, whose second slot counts the bank's kernel
SHADING = ("hit_front", "hit_epilogue", "shade_hit", "shade_bank_hit")
SHADING_KEYS = ("front_launches", "epilogue_launches", "shade_hit_launches",
                "shade_bank_hit_launches")
# their wrappers and the kernel each launches: `intersect_mm.hit_front` the
# front end, `intersect_mm.sphere_pass` the same kernel without the closest
# hit's operands (a scene of spheres alone), `intersect_mm.hit_epilogue`
# the epilogue, `shade.shade_hit` the shading
WRAPPER_KERNEL = {"hit_front": "hit_front", "sphere_pass": "hit_front",
                  "hit_epilogue": "hit_epilogue", "shade_hit": "shade_hit"}
# the names the wrappers' calls are recorded and compared under, and the
# kernel each launches: the wrapper's, and for a `shade_hit` call given a
# bank its kernel's, `shade_bank_hit` (`as_call`)
CALL_KERNEL = {**WRAPPER_KERNEL, "shade_bank_hit": "shade_bank_hit"}
SHADING_CALLS = tuple(CALL_KERNEL)
# the large-scene legs of the reference's bench.py
LEG_W = LEG_H = 512
LEG_SPP, LEG_DEPTH, POOL = 2, 8, 1 << 15
# the flagship advance whose closest-hit and cull calls are captured (on the
# eager loop)
CAPTURE_CALL = 100
# an H100 SXM's published peaks (NVIDIA's data sheet, 700 W): f32 outside
# the tensor cores, and device memory
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
FLOP_PER_PAIR = 38  # 19 FMAs: the four determinants of one (ray, triangle)
CULL_FLOP_PER_PAIR = 12  # the slab test of one (ray, tile box)
# the list cull's sets timed against another checkout's list cull: the
# scan's bounce step, the pool call, and bunny300k's
AGAINST_CULL = ("reference_primary", "reference_pool", "bunny300k_bounce1")
H100_SMS = 132  # the SMs the peaks above are summed over
# int32 instructions an SM issues a clock: 16 INT32 units in each of its 4
# partitions (NVIDIA's Hopper architecture white paper); the integer
# multiply-adds (IMAD, which the compiler also uses for adds, shifts and
# moves) issue on the FMA pipe at the same rate (the CUDA programming
# guide's throughput table, compute capability 9.0); and an SM issues at
# most one warp instruction a clock in each partition, on any pipe
INT32_PER_SM_CLOCK = 64
ISSUE_PER_SM_CLOCK = 128
# SASS opcodes (before the first '.') on the int32 ALU pipe and on the FMA
# pipe's integer side; any other (VIADD, whose pipe is not published, loads,
# float work) counts in the issue total alone
SASS_ALU_OPS = frozenset(("IADD3", "IADD", "SHF", "SHL", "SHR", "LOP3", "LOP", "LEA",
                          "ISETP", "SEL", "PRMT", "IMNMX", "IABS"))
SASS_FMA_INT_OPS = frozenset(("IMAD", "IMUL"))
SASS_INST = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
# the draws' purposes (core/rng.py), and the probe's 7
PURPOSE_NAMES = {0: "jitter", 1: "lobe", 2: "fresnel", 3: "rr", 4: "light",
                 6: "light_pick", 7: "probe"}
# the reference's config 5 (benchmarks/run_configs.py): multimesh at 1080p,
# depth 8, 16 spp accumulated tile-sharded in steps of spp / 4
CONFIG5_SIZE, CONFIG5_DEPTH, CONFIG5_SPP = (1920, 1080), 8, 16
CONFIG5_STEP = CONFIG5_SPP // 4
# config 5 over four tile ranks, as the sharded cell runs it; the rank
# whose dealt rows phase 19 records
SHARD_TILES, SHARD_RANK = 4, 2
# a collective of phase 14c's ranks, and a whole world of them, may take
RANK_TIMEOUT_S, WORLD_LIMIT_S = 120, 420
SWEEP_SLICES, SWEEP_RAYS = (1, 2, 4, 8), (1, 4)
SWEEP_WARPS, SWEEP_FILL = (8, 16, 32), (64, 128, 256)
SWEEP_THREADS = (64, 128, 256)
SWEEP_CLUSTERS = (1, 2, 4, 8)  # CTAs a closest-hit walk is shared over
SWEEP_GROUPS = (8, 128, 7200)  # subgroups of the tile_p 256 sets made for it


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's record, after the seconds since the script
    started."""
    print(f"{time.perf_counter() - _T0:7.1f} s  {msg}", flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int) -> float:
    """Mean time of one call of `fn` over `reps` calls back to back, after
    one warm-up, read by CUDA events on the stream: where a call's host
    work (checks, allocation, the ctypes call) outlasts its kernels, this
    is the host's enqueue rate, not the device's time."""
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


def device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph, the graph replayed `replays` times between CUDA events, after a
    warm-up call. The host is out of the reading; the graph's gap between
    two kernel nodes (well under a microsecond) is in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def cull_sass(so: Path) -> dict:
    """The cull kernel's SASS (`cuobjdump -sass` of its library, kept in
    OUT), of the function the paths' few-tile rows run (the list cull's
    rank route, `cull_tiles_kernel<1, 0>`): the innermost loop with the most
    FMULs is the slab-test loop, whose FMULs are 6 per (ray, tile) pair, so
    its instructions (NOPs aside) over its pairs are the instructions issued
    per pair. With the card's top SM clock (nvidia-smi clocks.max.sm) for
    the issue estimate."""
    functions = sass(so, "cull_tiles").split("Function : ")[1:]
    text = next((f for f in functions if "cull_tiles_kernelILi1ELi0E" in
                 f.splitlines()[0]), None)
    if text is None:
        raise RuntimeError("cull_tiles: no rank-route function in the SASS")
    insts, labels, pending = [], {}, []
    for line in text.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = SASS_INST.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        insts.append((addr, m.group(3), m.group(4)))
    back = []
    for addr, op, rest in insts:
        if not op.startswith("BRA"):
            continue
        t = re.search(r"\(\s*(\.L_x_\d+)\s*\)", rest)
        target = labels.get(t.group(1)) if t else None
        if target is None:
            h = re.search(r"0x([0-9a-f]+)", rest)
            target = int(h.group(1), 16) if h else None
        if target is not None and target <= addr:
            back.append((target, addr))
    loops = []
    for lo, hi in back:
        if any(lo <= lo2 and hi2 <= hi and (lo2, hi2) != (lo, hi)
               for lo2, hi2 in back):
            continue  # holds another loop: not innermost
        body = [op for a, op, _ in insts if lo <= a <= hi and op != "NOP"]
        fmul = sum(op.startswith("FMUL") for op in body)
        if fmul:
            loops.append((fmul, len(body), body))
    if not loops:
        raise RuntimeError("cull_tiles: no slab-test loop found in the SASS")
    fmul, n, body = max(loops)
    ops = {}
    for op in body:
        key = op.split(".")[0]
        ops[key] = ops.get(key, 0) + 1
    pairs = fmul / 6
    return dict(loop_instructions=n, pairs_per_iteration=pairs, per_pair=n / pairs,
                opcodes=dict(sorted(ops.items(), key=lambda kv: -kv[1])),
                clock_hz=top_sm_clock_hz())


def sass(so: Path, name: str, keep: bool = True) -> str:
    """`cuobjdump -sass` of a kernel's library, kept in OUT (`keep`)."""
    from metalpathtracer_torch.render.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    if keep:
        (OUT / f"sass_{name}.txt").write_text(text)
    return text


def shade_loads(so: Path) -> dict:
    """Per function of a build of `csrc/shade.cu` (its SASS, not kept: this
    tree's six functions, `shade_hit_kernel` and `shade_bank_hit_kernel<K>`):
    its global loads (LDG) before its first global store (STG) in the
    SASS's order, how many of those are 16-byte loads, and all its global
    loads. A lane's loads that come after a store of its own wait
    on that store where the pointers may alias."""
    out = {}
    for chunk in sass(so, "shade", keep=False).split("Function : ")[1:]:
        m = re.search(r"(shade\w*?_kernel)(?:ILi(n?\d+)E)?", chunk.splitlines()[0])
        if not m:
            continue
        name = m.group(1) + (f"<{m.group(2).replace('n', '-')}>" if m.group(2) else "")
        ops = [i.group(3) for i in map(SASS_INST.search, chunk.splitlines()) if i]
        first = next((k for k, op in enumerate(ops) if op.startswith("STG")), len(ops))
        before = [op for op in ops[:first] if op.startswith("LDG")]
        out[name] = dict(loads_before_store=len(before),
                         wide_before_store=sum(".128" in op for op in before),
                         loads=sum(op.startswith("LDG") for op in ops))
    return out


def top_sm_clock_hz() -> float:
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    return float(clock) * 1e6


def threefry_sass(so: Path) -> dict:
    """Per count K of counter blocks in a bundle (1 to 8), the threefry
    kernel function built for K: its body's instructions (up to its first
    EXIT without a predicate) as (address, opcode, predicated), and the
    address spans of the body its forward branches may skip (the loads of
    an operand passed by value, the stores of the modes a bundle does not
    draw). A branch out of the body either leaves it (its span runs to the
    EXIT) or comes back (its span runs to where it lands: sinf's and cosf's
    range reduction for |t| > 105,615, which no t in [0, 2 pi) takes, lands
    right after it). What every lane of every bundle of K blocks issues is
    then the body outside every span (`lane_issue`): the rounds of the K
    chains and their injections. Raises on an indirect branch, and where
    fewer than 60 integer instructions a block (20 rounds of add, rotate,
    xor) lie outside the spans."""
    per_blocks = {}
    for chunk in sass(so, "threefry").split("Function : ")[1:]:
        m = re.search(r"threefry_kernelILi(\d)E", chunk.splitlines()[0])
        if not m:
            continue
        k = int(m.group(1))
        insts = [(int(i.group(1), 16), i.group(3), bool(i.group(2)), i.group(4))
                 for i in map(SASS_INST.search, chunk.splitlines())
                 if i and i.group(3) != "NOP"]
        if any(op.startswith(("BRX", "JMX")) for _, op, _, _ in insts):
            raise RuntimeError(f"threefry K={k}: an indirect branch")
        body = next(n for n, (_, op, p, _) in enumerate(insts)
                    if op == "EXIT" and not p) + 1
        end = insts[body - 1][0]
        index = {a: n for n, (a, _, _, _) in enumerate(insts)}

        def target(rest):
            return int(re.search(r"0x([0-9a-f]+)", rest).group(1), 16)

        def landing(t):
            """Where lanes branching to `t` past the EXIT come back into
            the body, or None where they exit."""
            n = index[t]
            for _ in range(len(insts)):
                a, op, p, rest = insts[n]
                if op == "EXIT" and not p:
                    return None
                if op.startswith("BRA") and not p:
                    if target(rest) <= end:
                        return target(rest)
                    n = index[target(rest)]
                else:
                    n += 1
            raise RuntimeError(f"threefry K={k}: the code at {t:#x} never ends")

        spans = []
        for a, op, _, rest in insts[:body]:
            if not op.startswith("BRA") or target(rest) <= a:
                continue
            land = target(rest) if target(rest) <= end else landing(target(rest))
            spans.append((a, end + 1 if land is None else land))
        fn = dict(instructions=[(a, op, p) for a, op, p, _ in insts[:body]],
                  spans=spans)
        lane = lane_issue(fn)
        if lane["alu"] + lane["fma"] < 60 * k:
            raise RuntimeError(f"threefry K={k}: {lane} outside the branches, fewer "
                               "than the rounds of its blocks")
        per_blocks[k] = fn
    if sorted(per_blocks) != list(range(1, 9)):
        raise RuntimeError(f"threefry: SASS functions for K = {sorted(per_blocks)}")
    return dict(per_blocks=per_blocks, clock_hz=top_sm_clock_hz())


def lane_issue(fn) -> dict:
    """What every lane of a threefry function (`threefry_sass`'s) issues,
    whatever its bundle's modes and operand layouts: the instructions
    outside every span a forward branch may skip and without a predicate,
    on the int32 ALU pipe, on the FMA pipe's integer side, and in all.
    Each count is a lower one: what a lane may skip is left out."""
    alu = fma = issued = 0
    for addr, op, predicated in fn["instructions"]:
        if predicated or any(lo < addr < hi for lo, hi in fn["spans"]):
            continue
        key = op.split(".")[0]
        issued += 1
        alu += key in SASS_ALU_OPS
        fma += key in SASS_FMA_INT_OPS
    return dict(alu=alu, fma=fma, issued=issued,
                clocks=max(alu / INT32_PER_SM_CLOCK, fma / INT32_PER_SM_CLOCK,
                           issued / ISSUE_PER_SM_CLOCK))


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


def wrapper_module(name: str):
    """The module whose attribute `name` the port calls for a bounce-step
    wrapper (looked up at every call, so swapping it reroutes the calls)."""
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import shade as tsh

    return tsh if name == "shade_hit" else tmm


def call_wrapper(name: str) -> str:
    """The wrapper of a recorded call's name (SHADING_CALLS)."""
    return "shade_hit" if name == "shade_bank_hit" else name


def as_call(wrapper: str, fn, args, kw) -> tuple:
    """A call of the bounce-step wrapper `wrapper` (`fn`) as (name
    (SHADING_CALLS), positional arguments), bound to `fn`'s signature: a
    `shade_hit` call given a bank is `shade_bank_hit`, its bank the last
    argument."""
    bound = inspect.signature(fn).bind(*args, **kw)
    bank = bound.arguments.pop("bank", None)
    if bank is None:
        return wrapper, bound.args
    return "shade_bank_hit", (*bound.args, bank)


@contextlib.contextmanager
def plain_versions(which=("mm_closest_hit", "cull_tile_lists", "threefry") + SHADING
                   + REGEN):
    """Route the kernels named in `which` through their plain versions (the
    threefry kernel's wrapper is `threefry_bundle`, which every draw goes
    through; the bounce step's and the regeneration's wrappers are looked
    up on their modules at every call, and `hit_front` names the sphere
    pass's wrapper too, which launches its kernel), on the eager loop: a
    plain version reads the device on the host, which no CUDA graph may
    capture."""
    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import threefry as tfk
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    plain = {"mm_closest_hit": (tmm, "mm_closest_hit", tmm.mm_closest_hit_reference),
             "cull_tile_lists": (tmm, "_cull_tile_lists", tmm.cull_tile_lists_reference),
             "threefry": (tfk, "threefry_bundle", tfk.threefry_bundle_reference),
             **{w: (wrapper_module(w), w, getattr(wrapper_module(w), f"{w}_reference"))
                for w in WRAPPER_KERNEL},
             **{k: (twfk, k, getattr(twfk, f"{k}_reference")) for k in REGEN}}
    which = [w for k in which for w in (
        [w for w, kk in WRAPPER_KERNEL.items() if kk == k] if k in SHADING else [k])]
    kernels = {k: getattr(plain[k][0], plain[k][1]) for k in which}
    graphs.clear()
    for k in which:
        setattr(plain[k][0], plain[k][1], plain[k][2])
    try:
        with graphs.eager():
            yield
    finally:
        for k, fn in kernels.items():
            setattr(plain[k][0], plain[k][1], fn)
        graphs.clear()


@contextlib.contextmanager
def counted_path(tiles: bool = True):
    """Count one path's bounce steps, kernel launches, threefry draws and
    plain-version calls: every count is 0 on entry; the dict is filled on
    exit. `mm_launches`, `cull_launches` (`cull_radix` of them sorted by
    radix), `threefry_launches` and
    `threefry_draws` are what ran on the card: the kernels' own tallies
    (`kernels/_build.py`), which a CUDA graph's replay moves as an eager
    launch does. `mm_calls`, `cull_calls` (`cull_routes` by sort route),
    `threefry_calls` and `steps` are the wrappers' and the bounce step's
    Python calls: the eager launches and
    the launches traced into a capture. Every traced bounce step must launch
    both tile kernels once and the threefry kernel exactly once (one
    bundle), with at least two draws, and no plain version may run; a
    replay runs what its capture traced. A run that replayed nothing must
    have launched on the card exactly what its wrappers counted. The graph
    cache is cleared on entry and on exit: its key holds no function, and
    the bounce step is swapped here. Without `tiles` (a scene of spheres
    alone, which launches no tile kernel) the threefry kernel alone must
    run on every step. The bounce step's kernels likewise (SHADING_KEYS:
    `front_launches`, `epilogue_launches`, `shade_hit_launches` the
    tallies, `*_calls` the wrappers'; the front end's kernel also runs as
    the sphere pass on a scene of spheres alone, whose wrapper's calls
    `front_calls` counts too): every traced step must run the front end at
    least once (its closest hit; twice with a shadow ray), and exactly one
    shading: the kernel from the closest hit's winners (with or without
    the wavefront's bank), which runs the epilogue itself, or the plain
    shading with next-event estimation (`nee_steps`, counted in
    `graphs.STATS`), whose closest hit runs the hit epilogue. The
    wavefront's regeneration kernels likewise (REGEN_KEYS the
    tallies, `<wrapper>_calls` the wrappers'; `require_regen` holds a
    wavefront path to them), and their plain versions must not run."""
    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render.kernels import _build
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import shade as tsh
    from metalpathtracer_torch.render.kernels import threefry as tfk
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    calls = dict(plain_mm=0, plain_cull=0, plain_threefry=0, plain_shading=0,
                 plain_regen=0)
    odd_steps = []  # (bundle launches, draws) of a step that broke the rule
    odd_shading = []  # (shading launches, NEE steps) of a step that broke it
    originals = (tint._bounce_step, tmm.mm_closest_hit_reference,
                 tmm.cull_tile_lists_reference, tfk.threefry_bundle_reference)
    twins = {k: getattr(wrapper_module(k), f"{k}_reference") for k in WRAPPER_KERNEL}
    regen_twins = {k: getattr(twfk, f"{k}_reference") for k in REGEN}

    def counter(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    def shadings():
        return tsh.shade_hit.launches

    def step(*a, **k):
        step.calls += 1
        bundle = tfk.threefry_bundle
        launches, draws = bundle.launches, bundle.draws
        shaded, nee = shadings(), graphs.STATS["nee_steps"]
        out = originals[0](*a, **k)
        launches, draws = bundle.launches - launches, bundle.draws - draws
        if launches != 1 or draws < 2:
            odd_steps.append((launches, draws))
        shaded, nee = shadings() - shaded, graphs.STATS["nee_steps"] - nee
        if shaded + nee != 1:
            odd_shading.append((shaded, nee))
        return out

    step.calls = 0
    graphs.clear()
    tint._bounce_step = step
    tmm.mm_closest_hit_reference = counter("plain_mm", originals[1])
    tmm.cull_tile_lists_reference = counter("plain_cull", originals[2])
    tfk.threefry_bundle_reference = counter("plain_threefry", originals[3])
    for k, fn in twins.items():
        setattr(wrapper_module(k), f"{k}_reference", counter("plain_shading", fn))
    for k, fn in regen_twins.items():
        setattr(twfk, f"{k}_reference", counter("plain_regen", fn))
    result = {}
    try:
        torch.cuda.synchronize()
        tmm.mm_closest_hit.launches = 0
        tmm._cull_tile_lists.launches = 0
        tmm._cull_tile_lists.routes = {"rank": 0, "radix": 0}
        tfk.threefry_bundle.launches = tfk.threefry_bundle.draws = 0
        for k in WRAPPER_KERNEL:
            getattr(wrapper_module(k), k).launches = 0
        for k in REGEN:
            getattr(twfk, k).launches = 0
        _build.zero_tallies()
        replays = graphs.STATS["replays"]
        nee_steps = graphs.STATS["nee_steps"]
        yield result
    finally:
        (tint._bounce_step, tmm.mm_closest_hit_reference,
         tmm.cull_tile_lists_reference, tfk.threefry_bundle_reference) = originals
        for k, fn in twins.items():
            setattr(wrapper_module(k), f"{k}_reference", fn)
        for k, fn in regen_twins.items():
            setattr(twfk, f"{k}_reference", fn)
        graphs.clear()
    replayed = graphs.STATS["replays"] - replays
    done = executed()
    shading = executed_shading()
    result.update(calls, steps=step.calls, mm_calls=tmm.mm_closest_hit.launches,
                  cull_calls=tmm._cull_tile_lists.launches,
                  cull_routes=dict(tmm._cull_tile_lists.routes),
                  threefry_calls=tfk.threefry_bundle.launches,
                  threefry_call_draws=tfk.threefry_bundle.draws,
                  mm_launches=done[0], mm_clustered=clustered_launches(),
                  cull_launches=done[1], cull_radix=cull_radix_launches(),
                  threefry_launches=done[2], threefry_draws=done[3], replays=replayed,
                  front_calls=tmm.hit_front.launches + tmm.sphere_pass.launches,
                  epilogue_calls=tmm.hit_epilogue.launches,
                  shade_hit_calls=tsh.shade_hit.launches,
                  **dict(zip(SHADING_KEYS, shading)),
                  **{f"{k}_calls": getattr(twfk, k).launches for k in REGEN},
                  **dict(zip(REGEN_KEYS, executed_regen())),
                  nee_steps=graphs.STATS["nee_steps"] - nee_steps)
    if any(calls.values()):
        raise RuntimeError(f"the path ran a plain version: {calls}")
    if result["steps"] == 0 or tiles and min(result["mm_calls"],
                                             result["cull_calls"]) < result["steps"]:
        raise RuntimeError(f"not every bounce step launched both kernels: {result}")
    if min(result["front_calls"], result["epilogue_calls"] + result["shade_hit_calls"]) \
            < result["steps"]:
        raise RuntimeError(f"not every bounce step launched the front end and the "
                           f"hit epilogue (alone or in its shading): {result}")
    if odd_steps:
        raise RuntimeError(f"{len(odd_steps)} bounce steps did not launch one bundle "
                           f"of at least two draws, e.g. (launches, draws) "
                           f"{odd_steps[0]}: {result}")
    if odd_shading:
        raise RuntimeError(f"{len(odd_shading)} bounce steps did not shade exactly once "
                           f"(a shading kernel, or the plain shading with NEE), e.g. "
                           f"(launches, NEE steps) {odd_shading[0]}: {result}")
    shaded = shading[2] + shading[3]  # the shading's kernels, with the bank or not
    if min(done[:3] if tiles else done[2:3]) == 0 or shading[0] == 0 or (
            shading[1] + shaded == 0) or (
            shaded == 0 and result["nee_steps"] < result["steps"]):
        raise RuntimeError(f"a kernel ran no time on the card: {result}")
    if not replayed and (done != (result["mm_calls"], result["cull_calls"],
                                  result["threefry_calls"],
                                  result["threefry_call_draws"])
                         or (*shading[:2], shaded) != (result["front_calls"],
                                                       result["epilogue_calls"],
                                                       result["shade_hit_calls"])):
        raise RuntimeError(f"the card ran other launches than the wrappers made: "
                           f"{result}")
    if not replayed and any(result[key] != result[f"{k}_calls"]
                            for k, key in zip(REGEN, REGEN_KEYS)):
        raise RuntimeError(f"the card ran other regeneration launches than the "
                           f"wrappers made: {result}")


def require_regen(counts, what: str, sorting: bool = True):
    """A wavefront path's counted record (`counted_path`) must have run the
    regeneration's kernels: the restart and the queue pop, and with
    `sorting` (a scene with triangles) the sort's key and gather, as often
    as each other."""
    regen = [counts[k] for k in REGEN_KEYS]
    if min(regen[:2]) == 0 or (sorting and min(regen[2:]) == 0) or regen[2] != regen[3]:
        raise RuntimeError(f"{what}: the regeneration's kernels {REGEN} ran {regen} "
                           f"times on the card")


def regen_text(counts) -> str:
    """The regeneration kernels' launches of a counted path, for a log."""
    return ", ".join(f"{k} {counts[key]}" for k, key in zip(REGEN, REGEN_KEYS))


def executed_regen() -> tuple:
    """The regeneration kernels' launches (REGEN) run on this process's
    card since the tallies were last zeroed: one read."""
    import torch

    from metalpathtracer_torch.render.kernels import _build

    done = _build.tallies(torch.device("cuda", torch.cuda.current_device()))
    return tuple(done.get(k, (0, 0))[0] for k in REGEN)


def shading_text(counts) -> str:
    """The bounce step's kernels' launches of a counted path, for a log."""
    return ", ".join(f"{k} {counts[key]}" for k, key in zip(SHADING, SHADING_KEYS))


def executed_shading() -> tuple:
    """The bounce step's kernels' launches (SHADING: front end, hit
    epilogue, the shading without and with the bank) run on this process's
    card since the tallies were last zeroed: one read."""
    import torch

    from metalpathtracer_torch.render.kernels import _build

    done = _build.tallies(torch.device("cuda", torch.cuda.current_device()))
    hit, bank_hit = done.get("shade_hit", (0, 0))
    return (*(done.get(k, (0, 0))[0] for k in SHADING[:2]), hit - bank_hit, bank_hit)


def executed() -> tuple:
    """(closest-hit launches, cull launches, threefry launches, threefry
    draws) run on this process's card since the tallies were last zeroed:
    one read."""
    import torch

    from metalpathtracer_torch.render.kernels import _build

    done = _build.tallies(torch.device("cuda", torch.cuda.current_device()))
    return (done.get("mm_closest_hit", (0, 0))[0], done.get("cull_tile_lists", (0, 0))[0],
            *done.get("threefry", (0, 0)))


def cull_radix_launches() -> int:
    """The list cull's launches that sorted by radix on this process's card
    since the tallies were last zeroed (its tally's second slot)."""
    import torch

    from metalpathtracer_torch.render.kernels import _build

    done = _build.tallies(torch.device("cuda", torch.cuda.current_device()))
    return done.get("cull_tile_lists", (0, 0))[1]


def clustered_launches() -> int:
    """The closest hit's launches that shared walks over clusters on this
    process's card since the tallies were last zeroed (its tally's second
    slot)."""
    import torch

    from metalpathtracer_torch.render.kernels import _build

    done = _build.tallies(torch.device("cuda", torch.cuda.current_device()))
    return done.get("mm_closest_hit", (0, 0))[1]


class SyncCounter:
    """Counts the synchronising CUDA calls torch makes (`torch.cuda`'s sync
    debug mode set to warn; the warnings are counted, not shown), in all
    and by the source line that made them (`sites`). The mode flags reads
    of device values on the host and also uploads of host scalars and
    small tensors from pageable memory. `in_windows` counts those made
    while a wavefront window or drain block ran (`graphs.Entry.run`), and
    `windows` the runs."""

    def __init__(self):
        self.count = 0
        self.sites: dict[str, int] = {}
        self.in_windows = self.windows = self._depth = 0

    def __enter__(self):
        import torch

        self._mode = torch.cuda.get_sync_debug_mode()
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def count(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                self.count += 1
                self.in_windows += self._depth > 0
                site = f"{Path(filename).name}:{lineno}"
                self.sites[site] = self.sites.get(site, 0) + 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = count
        from metalpathtracer_torch.render import graphs

        run = self._run = graphs.Entry.run

        def watched(entry, name):
            self.windows += 1
            self._depth += 1
            try:
                run(entry, name)
            finally:
                self._depth -= 1

        graphs.Entry.run = watched
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        from metalpathtracer_torch.render import graphs

        torch.cuda.set_sync_debug_mode(self._mode)
        graphs.Entry.run = self._run
        self._catch.__exit__(*exc)
        return False


def compare_images(a, b, what: str):
    """Two renders of one estimator: under IMG_FRAC of pixels differ by more
    than 1e-3 and the means agree within IMG_MEAN."""
    import numpy as np

    frac = float((np.abs(a - b) > 1e-3).mean())
    dmean = float(abs(a.mean() - b.mean()))
    if not (np.isfinite(a).all() and np.isfinite(b).all() and frac < IMG_FRAC
            and dmean < IMG_MEAN):
        raise RuntimeError(f"{what}: {frac} of pixels differ, means by {dmean}")
    return frac, dmean


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
    sources = sorted({_build.source_of(k) for k in _build.ENTRY_ARGS})
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(_build.build, sources)))
    build_s = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    log(f"[1] built {len(_build.ENTRY_ARGS)} kernel entries from {len(libs)} sources in {build_s:.2f} s; "
        "ptxas:")
    for name, so in libs.items():
        compiler_log = so.with_name(so.name + ".log").read_text()
        (OUT / f"nvcc_{name}.log").write_text(compiler_log)
        for line in compiler_log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line):
                log(f"    {name}: {line.strip()}")
    sass = cull_sass(libs["cull_tiles"])
    log(f"[1] cull_tiles SASS: the slab-test loop issues {sass['loop_instructions']} "
        f"instructions for {sass['pairs_per_iteration']:g} (ray, tile) pairs, "
        f"{sass['per_pair']:.2f} per pair ({sass['opcodes']}); top SM clock "
        f"{sass['clock_hz'] / 1e6:.0f} MHz")
    tsass = threefry_sass(libs["threefry"])
    fns = tsass["per_blocks"]
    log("[1] threefry SASS, instructions of the kernel for K counter blocks to its "
        "exit: " + ", ".join(f"K={k} {len(v['instructions'])}" for k, v in fns.items())
        + "; what every lane issues (int32 ALU, IMAD, all): "
        + ", ".join("K={} ({alu}, {fma}, {issued})".format(k, **lane_issue(v))
                    for k, v in fns.items()))
    return card, build_s, sass, tsass


def primary_and_bounce(scene, w, h, stride=1, draws=None, cam=None, cfg=None):
    """Primary rays of every `stride`-th pixel of a w x h view from `cam`
    (the default camera), and the rays one bounce later under `cfg` (the
    default config), with its live mask. `draws`, a list, receives the
    `threefry_bundle` calls' arguments (the jitter, the first bounce
    step's draws)."""
    import torch

    from metalpathtracer_torch.core import rng
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.pipeline import generate_rays

    dev = scene.device
    seed = rng.seed_from_int(0)
    pix = torch.arange(0, w * h, stride, dtype=torch.int64, device=dev)
    n = pix.shape[0]
    with recorded_draws() as recorded:
        o, d = generate_rays(cam or Camera.reset(), w, h, pix, 0, seed)
        step = tint._bounce_step(
            scene, o, d, torch.zeros((n, 3), device=dev), torch.ones((n, 3), device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev), torch.zeros((n,), device=dev),
            pix, 0, 0, seed, cfg or tint.RenderConfig(),
        )
    if draws is not None:
        draws.extend(recorded)
    return {"primary": (o, d, None), "bounce1": (step[0], step[1], step[4])}


def sphere_t(scene, o, d):
    """Each ray's nearest sphere's t (the sphere pass), the occlusion bound
    `closest_hit_mm_full` gives the cull."""
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    return tmm.sphere_pass(o, d, scene.sph_center, scene.sph_radius, scene.sph_ids,
                           T_MIN)[0]


def closest_hit_set(scene, o, d, act):
    """`mm_closest_hit`'s arguments for rays (o, d) as `closest_hit_mm_full`
    makes them (the sphere pass's t as occlusion bound), with the rays."""
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    t_s = sphere_t(scene, o, d)
    args = tmm.kernel_inputs(scene, o, d, t_s, act, T_MIN) + (scene.mm_w, T_MIN)
    return dict(args=args, o=o, d=d,
                active=int(act.sum()) if act is not None else o.shape[0])


def captured_set(args, active, min_hits=1):
    """A set from captured `mm_closest_hit` arguments: the rays are read
    back from the features x = [d, o x d, o, ...]. `min_hits`: the triangle
    hits the set must hold for the comparison to count."""
    x = args[3]
    return dict(args=args, o=x[:, 6:9], d=x[:, 0:3], min_hits=min_hits,
                active=int((active > 0.5).sum()))


def closest_hit_bound(args, walked, cluster=1):
    """The least time of one `mm_closest_hit` call on the card: the pairs
    its subgroups walked (walked x 128 x tile_p) at FLOP_PER_PAIR, and the
    bytes it must move (inputs once: features, lane bounds, counts, the
    walked list and smin entries, the distinct tiles walked at 64 B per
    triangle; outputs (t, col) once). `cluster`: the CTAs, each on an SM of
    its own, that the call shared each subgroup's walk over."""
    import torch

    lists, counts, _, x, lane_bound, w, _ = args
    tile_p = w.shape[1]
    walked = walked.long()
    n_walked = int(walked.sum())
    pos = torch.arange(lists.shape[1], device=lists.device)[None, :] < walked[:, None]
    tiles = int(lists[pos].unique().numel())
    nbytes = (x.numel() * 4 + lane_bound.numel() * 4 + counts.numel() * 4
              + n_walked * 8 + tiles * tile_p * w.shape[2] * 4 + x.shape[0] * 8)
    pairs = n_walked * 128 * tile_p
    flop_ms = pairs * FLOP_PER_PAIR / PEAK_F32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    # one subgroup's walk runs on the `cluster` SMs of its cluster: the
    # longest walk at their share of the peak is a second lower bound, which
    # the uneven walks can exceed
    longest_ms = (int(walked.max()) * 128 * tile_p * FLOP_PER_PAIR
                  / (PEAK_F32_FLOPS * cluster / H100_SMS) * 1e3
                  if walked.numel() else 0.0)
    q = torch.quantile(walked.float(), torch.tensor([0.5, 0.9], device=walked.device))
    return dict(pairs=pairs, tiles_read=tiles, bytes=nbytes,
                bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes",
                walked_p50=float(q[0]), walked_p90=float(q[1]),
                walked_max=int(walked.max()), longest_walk_ms=longest_ms,
                cluster=cluster)


def phase_kernel_vs_twin(scene, sets):
    import torch

    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    record = {}
    for name, st in sets.items():
        args, so, sd = st["args"], st["o"], st["d"]
        n = so.shape[0]
        tk, ck, wk = tmm.mm_closest_hit(*args, return_walked=True)
        tr, cr, wr = tmm.mm_closest_hit_reference(*args, return_walked=True)
        torch.cuda.synchronize()
        what = f"mm_closest_hit vs twin ({name}, tile_p {scene.mm_w.shape[1]})"
        # the walk reads only t: subgroups whose lanes agree on t bit for bit
        # must have walked the same list positions
        agree = (tk.view(-1, 128) == tr.view(-1, 128)).all(dim=1)
        if not torch.equal(wk[agree], wr[agree]):
            raise RuntimeError(f"{what}: walked positions differ on "
                               f"{int((wk[agree] != wr[agree]).sum())} subgroups")
        tk, ck, tr, cr = tk[:n], ck[:n], tr[:n], cr[:n]
        tri_ids = scene.mm_tri_ids.long()

        def prim(col):
            return torch.where(col >= 0, tri_ids[col.clamp(min=0).long()], -1)

        n_mis, n_tie, n_edge = judge_mismatches(
            scene, so, sd, prim(ck), tk, prim(cr), tr, what)
        same = (ck == cr) & torch.isfinite(tr)
        err = (tk[same] - tr[same]).abs()
        bound = T_RTOL * tr[same].abs() + T_ATOL
        if not bool((err <= bound).all()):
            raise RuntimeError(f"{what}: t off by {float(err.max())}")
        both_miss = (ck == -1) & (cr == -1)
        if not bool(torch.isinf(tk[both_miss]).all()):
            raise RuntimeError(f"{what}: a miss has a finite t")
        hits = int((cr >= 0).sum())
        if hits < st.get("min_hits", 1):
            raise RuntimeError(f"{what}: no triangle hits")
        k_ms = device_ms(lambda: tmm.mm_closest_hit(*args))
        c_ms = call_ms(lambda: tmm.mm_closest_hit(*args), 20)
        r_ms = call_ms(lambda: tmm.mm_closest_hit_reference(*args), 3)
        passing = float(args[1].float().mean())
        g = wk.numel()
        b = closest_hit_bound(args, wk, mm_cluster(args))
        record[name] = dict(
            rays=n, active=st["active"], subgroups=g,
            triangle_hits=hits, mismatches=n_mis, near_ties=n_tie, edges=n_edge,
            max_abs_err=float(err.max()) if err.numel() else 0.0,
            ms=k_ms, call_ms=c_ms, plain_ms=r_ms, mean_passing_tiles=passing,
            walked_kernel=int(wk.sum()), walked_twin=int(wr.sum()),
            walk_compared=int(agree.sum()), **b, share=b["bound_ms"] / k_ms,
        )
        log(f"    {what}: {hits} triangle hits, {n_mis} differ "
            f"({n_tie} near-ties, {n_edge} edges), max |dt| "
            f"{record[name]['max_abs_err']:.3g}; kernel {k_ms:.4f} ms on the "
            f"device, {c_ms:.4f} ms per call, twin {r_ms:.3f} ms, "
            f"{passing:.2f} passing tiles per subgroup")
        log(f"    {what}: walked positions kernel {int(wk.sum())} "
            f"({int(wk.sum()) / g:.2f} per subgroup; median {b['walked_p50']:.0f}, "
            f"p90 {b['walked_p90']:.0f}, max {b['walked_max']}), twin "
            f"{int(wr.sum())}, equal on all {int(agree.sum())} of {g} subgroups "
            f"whose lanes agree on t; {b['pairs']} pairs, {b['tiles_read']} tiles "
            f"read, bound {b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}), "
            f"{100 * b['bound_ms'] / k_ms:.1f}% of it reached; cluster width "
            f"{b['cluster']}, the longest walk on its {b['cluster']} SM(s) "
            f"{b['longest_walk_ms'] * 1e3:.2f} us")
    return record


def mm_cluster(args) -> int:
    """The cluster width `mm_closest_hit` takes for a set's arguments on
    this card."""
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    lists, w = args[0], args[5]
    return tmm.cluster_width(lists.shape[0], w.shape[1],
                             tmm.card_sms(lists.device.index or 0))


def launcher(kernel: str, args, **build):
    """(launch, outputs): `launch()` runs `kernel` (the build that
    `_build.launch`'s `defines` / `csrc` select) on a set's arguments into
    outputs of its own, uncounted, as the sweep and the comparison with
    another checkout time it. `mm_closest_hit` takes the cluster width the
    wrapper would (`mm_cluster`)."""
    import torch

    from metalpathtracer_torch.render.kernels import _build
    from metalpathtracer_torch.render.kernels import threefry as tfk

    if kernel == "threefry":
        seed, pix, sample, bounce, draws = args
        device = pix.device
        ins, flat, views, scalars = tfk.launch_plan(seed, pix, sample, bounce, draws,
                                                    device)

        def launch_bundle():
            _build.launch("threefry", ins, (flat,), scalars, device, align=4, **build)

        return launch_bundle, views
    if kernel == "mm_closest_hit":
        lists, counts, smin, x, lb, w, t_min = args
        g, nt = lists.shape
        outs = (torch.empty(g * 128, device=x.device),
                torch.empty(g * 128, dtype=torch.int32, device=x.device), None)
        ins = (lists, counts, smin, x, lb, w)
        scalars = (g, nt, w.shape[1], float(t_min), mm_cluster(args))
    elif kernel == "cull_tile_lists":
        x, active, box, t_min, occ = args
        g, nt = x.shape[0] // 128, box.shape[0]
        outs = (torch.empty((g, nt), dtype=torch.int32, device=x.device),
                torch.empty(g, dtype=torch.int32, device=x.device),
                torch.empty((g, nt), device=x.device), torch.empty(g * 128, device=x.device))
        ins, scalars = (x, active, occ, box), (g, nt, float(t_min))
    else:
        x, active, box, t_min, occ = args
        g, nt = x.shape[0] // 128, box.shape[0]
        outs = (torch.empty((g, nt), dtype=torch.bool, device=x.device),
                torch.empty((g, nt), device=x.device), torch.empty(g * 128, device=x.device))
        ins, scalars = (x, active, occ, box), (g, nt, float(t_min))

    def launch():
        _build.launch(kernel, ins, outs, scalars, x.device, **build)

    return launch, outs[:2] if outs[2] is None else outs


def cull_and_tail(args):
    """(launch, outputs): the plain cull's entry `cull_tiles` followed by
    the torch ops that made the closest hit's lists of its rows before the
    list cull sorted them in its blocks: the any flags summed, one stable
    sort, the casts, and the lane bound's minimum with occ. `outputs` is a
    list that each launch refills with (lists, counts, smin, lane_bound)."""
    import torch

    launch_rows, (sgm, gent, lb) = launcher("cull_tiles", args)
    occ = args[4]
    outs = []

    def launch():
        launch_rows()
        counts = sgm.sum(dim=1).to(torch.int32)
        smin, lists = torch.sort(gent, dim=1, stable=True)
        outs[:] = (lists.to(torch.int32), counts, smin,
                   lb if occ is None else torch.minimum(lb, occ))

    launch()
    return launch, outs


def kernel_args(kernel: str, st):
    return st["args"] if kernel == "mm_closest_hit" else st


def phase_sweep(kernel: str, variants: dict, sets: dict):
    """`kernel` built with each of `variants` (name -> -D defines), on every
    set: outputs bit-equal to the default build's, and each timed on the
    device (device_ms)."""
    import torch

    from metalpathtracer_torch.render.kernels import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(
            lambda d: _build.build(kernel, d), variants.values())))
    log(f"[S] {kernel}: built {len(libs)} variants in {time.perf_counter() - t0:.2f} s")
    for k, so in libs.items():
        for line in so.with_name(so.name + ".log").read_text().splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line):
                log(f"    {k}: {line.strip()}")
    record = {}
    for name, st in sets.items():
        args = kernel_args(kernel, st)
        launch, ref = launcher(kernel, args)
        launch()
        row = {}
        for k, defines in variants.items():
            launch, outs = launcher(kernel, args, defines=defines)
            launch()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                raise RuntimeError(f"sweep {kernel} {name}: {k} differs from the "
                                   "default build")
            row[k] = device_ms(launch)
        record[name] = row
        log(f"[S] {kernel} {name}: "
            + ", ".join(f"{k} {ms * 1e3:.2f} us" for k, ms in row.items()))
    return record


def subgroup_set(st, idx):
    """The set of subgroups `idx` (repeats allowed) of set `st`."""
    import torch

    lists, counts, smin, x, lb, w, t_min = st["args"]
    lanes = (idx[:, None] * 128 + torch.arange(128, device=idx.device)).reshape(-1)
    return dict(args=(lists[idx].contiguous(), counts[idx].contiguous(),
                      smin[idx].contiguous(), x[lanes].contiguous(),
                      lb[lanes].contiguous(), w, t_min))


def cluster_sets(mm_sets):
    """The closest hit's calls at the paths' subgroup counts on both tile
    widths: at tile_p 128 the reference scene's sets (the scan's 7,200
    subgroups, the pool's 256, a viewer frame's 128 and its drain's 8); at
    tile_p 256 bunny300k's bounce (256) and SWEEP_GROUPS of its subgroups,
    spread evenly or repeated."""
    import torch

    sets = {k: v for k, v in mm_sets.items() if k.startswith("reference_")}
    base = mm_sets["bunny300k_bounce1"]
    g = base["args"][0].shape[0]
    sets["bunny300k_bounce1"] = base
    for n in SWEEP_GROUPS:
        idx = (torch.arange(n, device=base["args"][0].device) * g // n if n <= g
               else torch.arange(n, device=base["args"][0].device) % g)
        sets[f"bunny300k_bounce1_g{n}"] = subgroup_set(base, idx)
    return sets


def phase_cluster_sweep(sets: dict):
    """`mm_closest_hit` at every cluster width that a set's tile_p allows:
    (t, col, walked) bit-equal to one CTA's, each width timed on the device
    (device_ms, a CUDA graph of its launches), beside the width that
    `cluster_width` picks for the set."""
    import torch

    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    record = {}
    for name, st in sets.items():
        args = st["args"]
        g, tile_p = args[0].shape[0], args[5].shape[1]
        ref = tmm._launch(*args, True, 1)
        row = {}
        for c in SWEEP_CLUSTERS:
            if tile_p % (c * tmm.CLUSTER_SLICE_COLS):
                continue
            out = tmm._launch(*args, True, c)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise RuntimeError(f"cluster sweep {name}: width {c} differs from one CTA")
            row[c] = device_ms(lambda: tmm._launch(*args, False, c))
        walked = ref[2].long()
        record[name] = dict(subgroups=g, tile_p=tile_p, rule=mm_cluster(args),
                            best=min(row, key=row.get), walked_max=int(walked.max()),
                            walked_mean=float(walked.float().mean()),
                            ms={str(c): ms for c, ms in row.items()})
        log(f"[S] mm_closest_hit {name} ({g} subgroups, tile_p {tile_p}, walks "
            f"max {int(walked.max())}, mean {float(walked.float().mean()):.2f}): "
            + ", ".join(f"C={c} {ms * 1e3:.2f} us" for c, ms in row.items())
            + f"; the rule takes {record[name]['rule']}, the fastest is "
            f"{record[name]['best']}")
    return record


def phase_against(other: Path, kernel_sets: dict):
    """Each kernel built from `other`'s sources (a checkout of another
    commit) and from this one's, on every set: outputs bit-equal, and both
    timed on the device in turns other, this, this, other."""
    import torch

    csrc = other / "metalpathtracer_torch" / "csrc"
    record = {}
    for kernel, sets in kernel_sets.items():
        for name, st in sets.items():
            args = kernel_args(kernel, st)
            runs = {"other": launcher(kernel, args, csrc=csrc),
                    "this": launcher(kernel, args)}
            for launch, _ in runs.values():
                launch()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(runs["other"][1], runs["this"][1])):
                raise RuntimeError(f"{kernel} {name}: {other}'s build differs")
            times = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                times[who].append(device_ms(runs[who][0]))
            record[f"{kernel}/{name}"] = times
            log(f"[A] {kernel} {name}: other " + ", ".join(
                f"{t * 1e3:.2f}" for t in times["other"]) + " us; this "
                + ", ".join(f"{t * 1e3:.2f}" for t in times["this"]) + " us")
    return record


def phase_against_renders(other: Path):
    """The flagship through each tree's `cli.main`, on both integrators, in
    turns other, this, this, other: each turn a child whose working
    directory is the tree calls it twice, so each reading is a pair (a
    fresh process's seconds, with its first launches and imports; then
    the same render again, whose kernel launches each tree's device tallies
    count). The images must equal the other tree's bit for bit (both trees
    draw the same randoms and run kernels bit-equal to the same plain
    versions; a difference raises), and so lie within the render limit of
    it (`compare_images`, recorded). A small render of each tree first
    builds its kernels."""
    import numpy as np

    code = ("import json, sys, torch\nfrom metalpathtracer_torch import cli\n"
            "from metalpathtracer_torch.render.kernels import _build\n"
            "for _ in range(int(sys.argv[1])):\n    _build.zero_tallies()\n"
            "    assert cli.main(sys.argv[2:]) == 0\n"
            "print(json.dumps({k: v[0] for k, v in "
            "_build.tallies(torch.device('cuda', 0)).items()}))\n")

    def cli(tree, argv, times):
        proc = subprocess.run(
            [sys.executable, "-c", code, str(times), *argv, "--output",
             str(OUT / "against.png")], cwd=str(tree), capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree} {argv}: exit {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        lines = proc.stdout.strip().splitlines()
        return ([json.loads(line)["seconds"] for line in lines[-times - 1:-1]],
                json.loads(lines[-1]))

    for tree in (other, ROOT):
        cli(tree, flagship_argv(64, 36), 1)
    record = {}
    for name, extra in (("scan", []), ("wavefront", ["--wavefront"])):
        seconds, images, tallies = {"other": [], "this": []}, {}, {}
        for k, who in enumerate(("other", "this", "this", "other")):
            npz = OUT / f"against_{name}_{k}.npz"
            secs, tallies[who] = cli(other if who == "other" else ROOT,
                                     flagship_argv() + extra + ["--npz", str(npz)], 2)
            seconds[who].append(secs)
            images.setdefault(who, radiance(npz))
            npz.unlink()
        same = bool(np.array_equal(images["other"], images["this"]))
        if not same:
            raise RuntimeError(f"[A] cli {name}: the image differs from {other}'s at "
                               f"{int((images['other'] != images['this']).sum())} values")
        # where the trees round an operation otherwise, two renders of one
        # estimator: within the render limit
        frac, dmean = compare_images(images["this"], images["other"],
                                     f"cli {name}: this tree vs {other}")
        record[name] = dict(seconds=seconds, images_equal=same, divergent=frac,
                            mean_diff=dmean, tallies=tallies)
        log(f"[A] cli {name} 1280x720 spp 4 depth 32 (fresh process, again): other "
            + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in seconds["other"]) + " s; this "
            + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in seconds["this"])
            + f" s; images equal: {same} ({frac:.5f} of pixels differ by > 1e-3, "
            f"means by {dmean:.2e}); launches of a render on the card: other "
            f"{tallies['other']}, this {tallies['this']}")
    return record


def oracle_rays(sets, n_each):
    """`n_each` primary rays and `n_each` live bounce-1 rays, picked by a
    seeded permutation."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(0)
    o_p, d_p, _ = sets["primary"]
    o_b, d_b, act = sets["bounce1"]
    live = act.nonzero().flatten().cpu()
    pick_p = torch.randperm(o_p.shape[0], generator=g)[:n_each].to(o_p.device)
    pick_b = live[torch.randperm(live.numel(), generator=g)[:n_each]].to(o_p.device)
    return (torch.cat([o_p[pick_p], o_b[pick_b]]),
            torch.cat([d_p[pick_p], d_b[pick_b]]))


def phase_oracle(scene, sets, n_each, chunk):
    import torch

    from metalpathtracer_torch.render.intersect import closest_hit_bruteforce
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    o, d = oracle_rays(sets, n_each)
    before = tmm.mm_closest_hit.launches, tmm._cull_tile_lists.launches
    t1, i1, *_ = tmm.closest_hit_mm_full(scene, o, d, T_MIN)
    if (tmm.mm_closest_hit.launches, tmm._cull_tile_lists.launches) != (
            before[0] + 1, before[1] + 1):
        raise RuntimeError("closest_hit_mm_full did not launch both kernels")
    t0, i0 = closest_hit_bruteforce(scene, o, d, T_MIN, chunk=chunk)
    what = f"kernel path vs brute oracle ({scene.num_tris} triangles)"
    n_mis, n_tie, n_edge = judge_mismatches(scene, o, d, i1, t1, i0, t0, what)
    same = (i1 == i0) & torch.isfinite(t0)
    err = (t1[same] - t0[same]).abs()
    if not bool((err <= T_RTOL * t0[same].abs() + T_ATOL).all()):
        raise RuntimeError(f"{what}: t off by {float(err.max())}")
    hits = int((i0 >= 0).sum())
    tri_hits = int((i0 >= 3).sum())
    log(f"    {what}, {o.shape[0]} rays: {hits} hits ({tri_hits} triangles), "
        f"{n_mis} differ ({n_tie} near-ties, {n_edge} edges), "
        f"max |dt| {float(err.max()):.3g}")
    return dict(rays=o.shape[0], hits=hits, triangle_hits=tri_hits,
                mismatches=n_mis, max_abs_err=float(err.max()))


def cull_args_of(scene, o, d, act):
    """The cull's arguments for rays (o, d) as `closest_hit_mm_full` makes
    them (the sphere pass's t as occlusion bound)."""
    import torch

    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    t_s = sphere_t(scene, o, d)
    a = (torch.ones((o.shape[0],), device=o.device) if act is None
         else act.to(torch.float32))
    return tmm.ray_features(o, d), a, scene.mm_tile_box, T_MIN, t_s


def cull_bound(args):
    """The least time of one list cull call: CULL_FLOP_PER_PAIR on every
    (ray, tile) pair, and the bytes of its inputs and outputs once: 8 per
    (subgroup, tile) (list and smin), 4 per subgroup (its count) and 4 per
    lane (lane_bound)."""
    x, active, tile_box, _, occ = args
    n, nt = x.shape[0], tile_box.shape[0]
    nbytes = (x.numel() + active.numel() + tile_box.numel()
              + (0 if occ is None else occ.numel())) * 4 \
        + (n // 128) * (nt * 8 + 4) + n * 4
    flop_ms = n * nt * CULL_FLOP_PER_PAIR / PEAK_F32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(pairs=n * nt, bytes=nbytes, bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes")


def phase_cull(name, args, sass):
    """The list cull `_cull_tile_lists` vs `cull_tile_lists_reference`, and
    the plain cull `cull_tiles` vs `cull_pass_reference`, on the inputs
    closest_hit_mm_full gives them: bit-equal outputs (a NaN lane bound
    where the plain version has one), and each timed; beside them the plain
    cull followed by the torch ops that sorted its rows before the list
    cull did (`cull_and_tail`, this tree's build). `sass` (cull_sass) gives
    the issue estimate: the loop's instructions per pair at one per lane
    per clock of every SM at the card's top SM clock."""
    import torch

    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    n, nt = args[0].shape[0], args[2].shape[0]
    route = tmm.sort_route(nt)
    for entry, plain, names in (
            (tmm._cull_tile_lists, tmm.cull_tile_lists_reference,
             ("lists", "counts", "smin", "lane_bound")),
            (tmm.cull_tiles, tmm.cull_pass_reference, ("sgm", "gent", "lane_bound"))):
        out_k, out_r = entry(*args), plain(*args)
        torch.cuda.synchronize()
        for what, k, r in zip(names, out_k, out_r):
            same = k == r
            if k.dtype.is_floating_point:
                same |= torch.isnan(k) & torch.isnan(r)
            if k.dtype != r.dtype or not bool(same.all()):
                raise RuntimeError(f"{entry.__name__} vs plain ({name}): {what} differs "
                                   f"at {int((~same).sum())} places")
    fin = torch.isfinite(out_r[1])  # the plain cull's gent
    err = float((out_k[1][fin] - out_r[1][fin]).abs().max()) if fin.any() else 0.0
    k_ms = device_ms(lambda: tmm._cull_tile_lists(*args))
    rows_ms = device_ms(lambda: tmm.cull_tiles(*args))
    tail_ms = device_ms(cull_and_tail(args)[0])
    c_ms = call_ms(lambda: tmm._cull_tile_lists(*args), 20)
    r_ms = call_ms(lambda: tmm.cull_tile_lists_reference(*args), 3)
    b = cull_bound(args)
    issue_ms = n * nt * sass["per_pair"] / (H100_SMS * 128 * sass["clock_hz"]) * 1e3
    rec = dict(rays=n, tiles=nt, route=route, active=int((args[1] > 0.5).sum()),
               max_abs_err=err, passing=float(out_r[0].float().mean()), ms=k_ms,
               rows_ms=rows_ms, tail_ms=tail_ms, call_ms=c_ms, plain_ms=r_ms, **b,
               share=b["bound_ms"] / k_ms, issue_ms=issue_ms,
               issue_share=issue_ms / k_ms)
    log(f"    cull vs plain ({name}): {n} rays x {nt} tiles, {route} sort, both "
        f"entries bit-equal, {rec['passing']:.4f} of (subgroup, tile) pairs pass; "
        f"lists {k_ms * 1e3:.2f} us on the device ({c_ms * 1e3:.2f} us per call), "
        f"plain cull {rows_ms * 1e3:.2f} us, plain cull and its torch tail "
        f"{tail_ms * 1e3:.2f} us, plain versions {r_ms:.3f} ms; bound "
        f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}), {100 * rec['share']:.1f}% "
        f"of it reached; issue estimate {issue_ms * 1e3:.2f} us "
        f"({100 * rec['issue_share']:.1f}%)")
    return rec


def flagship_argv(w=1280, h=720):
    return ["--scene", str(ROOT / "scenes" / "reference.xml"), "--width", str(w),
            "--height", str(h), "--spp", "4", "--max-depth", "32", "--stats-json",
            "--device", "cuda"]


class _Captured(Exception):
    pass


def _clone(args):
    """The tensors of `args` cloned, inside plain tuples too (a shading's
    bank); anything else as it is."""
    import torch

    return tuple(a.clone() if isinstance(a, torch.Tensor)
                 else _clone(a) if type(a) is tuple else a for a in args)


def capture_calls(run, picks: dict, stop: bool, shading: dict | None = None):
    """`run()` with the kernels wrapped. `picks` maps a name to
    `pick(i, lanes, k)`: asked at every `mm_closest_hit` call (the i-th of
    the run, the k-th on that many lanes, both from 1), and where it says
    yes that call's arguments and those of the `_cull_tile_lists` call of the
    same advance are cloned under the name, and so are the arguments of
    every `threefry_bundle` call after it until the next `mm_closest_hit`
    call (the advance's bundles: the bounce step's, then the restart's
    jitter). With `shading` (a dict) the same bounce step's front end
    (before the closest hit), hit epilogue and shading calls are cloned
    into `shading[name]` as {call name (SHADING_CALLS): args}. With
    `stop` the run is ended at the call after the last pick.
    Returns {name: (mm_args, cull_args, [bundle_args, ...])}."""
    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import threefry as tfk

    kernels = tmm.mm_closest_hit, tmm._cull_tile_lists, tfk.threefry_bundle
    shading_kernels = {k: getattr(wrapper_module(k), k) for k in WRAPPER_KERNEL}
    seen = {"mm": 0, "by_lanes": {}, "cull": None, "drawing": None, "front": None}
    captured = {}

    def cull(*args, **kw):
        seen["cull"] = args  # (x, active, tile_box, t_min, occ)
        return kernels[1](*args, **kw)

    def shaded(kernel):
        def wrapped(*args, **kw):
            if kernel == "hit_front":
                seen["front"] = _clone(args)
            elif seen["drawing"] is not None and shading is not None:
                name, call = as_call(kernel, shading_kernels[kernel], args, kw)
                shading[seen["drawing"]].setdefault(name, _clone(call))
            return shading_kernels[kernel](*args, **kw)
        wrapped.launches = 0
        return wrapped

    def mm(*args, **kw):
        lanes = args[3].shape[0]
        seen["mm"] += 1
        seen["drawing"] = None
        if stop and len(captured) == len(picks):
            raise _Captured
        k = seen["by_lanes"][lanes] = seen["by_lanes"].get(lanes, 0) + 1
        for name, pick in picks.items():
            if name not in captured and pick(seen["mm"], lanes, k):
                captured[name] = _clone(args), _clone(seen["cull"]), []
                seen["drawing"] = name
                if shading is not None:
                    shading[name] = {"hit_front": seen["front"]}
        return kernels[0](*args, **kw)

    def draw(*args, **kw):
        if seen["drawing"] is not None:
            captured[seen["drawing"]][2].append(_clone(args))
        return kernels[2](*args, **kw)

    # the kernels count their launches on the module's names, which are
    # these wrappers while they are in place; the run is eager, so that the
    # wrappers see every call with its values (a CUDA graph replays none)
    mm.launches = mm.clustered = cull.launches = draw.launches = draw.draws = 0
    cull.routes = {"rank": 0, "radix": 0}
    graphs.clear()
    tmm.mm_closest_hit, tmm._cull_tile_lists, tfk.threefry_bundle = mm, cull, draw
    for k in WRAPPER_KERNEL:
        setattr(wrapper_module(k), k, shaded(k))
    try:
        with graphs.eager():
            run()
    except _Captured:
        pass
    finally:
        tmm.mm_closest_hit, tmm._cull_tile_lists, tfk.threefry_bundle = kernels
        for k, fn in shading_kernels.items():
            setattr(wrapper_module(k), k, fn)
        graphs.clear()
    torch.cuda.synchronize()
    if len(captured) != len(picks):
        raise RuntimeError(f"captured {sorted(captured)} of {sorted(picks)}: the run "
                           f"made {seen['mm']} calls, by lanes {seen['by_lanes']}")
    return captured


@contextlib.contextmanager
def recorded_draws():
    """Every `threefry_bundle` call's arguments, cloned into the yielded
    list."""
    from metalpathtracer_torch.render.kernels import threefry as tfk

    kernel, draws = tfk.threefry_bundle, []

    def draw(*args, **kw):
        draws.append(_clone(args))
        return kernel(*args, **kw)

    draw.launches = draw.draws = 0
    tfk.threefry_bundle = draw
    try:
        yield draws
    finally:
        tfk.threefry_bundle = kernel


@contextlib.contextmanager
def recorded_shading():
    """Every call of the bounce step's kernels' wrappers (WRAPPER_KERNEL),
    its arguments cloned into the yielded {call name (SHADING_CALLS):
    [args, ...]}; the calls go through."""
    kernels = {k: getattr(wrapper_module(k), k) for k in WRAPPER_KERNEL}
    calls = {k: [] for k in SHADING_CALLS}

    def recorder(kernel):
        def wrapped(*args, **kw):
            name, call = as_call(kernel, kernels[kernel], args, kw)
            calls[name].append(_clone(call))
            return kernels[kernel](*args, **kw)
        wrapped.launches = 0
        return wrapped

    for k in WRAPPER_KERNEL:
        setattr(wrapper_module(k), k, recorder(k))
    try:
        yield calls
    finally:
        for k, fn in kernels.items():
            setattr(wrapper_module(k), k, fn)


def shading_steps(scene, w, h, steps, stride=1, cam=None, cfg=None, seed=0):
    """The bounce step's kernels' calls in the first `steps` bounce steps of
    the primary rays of every `stride`-th pixel of a w x h view from `cam`
    (the default camera) under `cfg` (the default config), as `trace`
    starts them: one {kernel: [args, ...]} a step."""
    import torch

    from metalpathtracer_torch.core import rng
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.pipeline import generate_rays

    dev = scene.device
    seed = rng.seed_from_int(seed)
    pix = torch.arange(0, w * h, stride, dtype=torch.int64, device=dev)
    n = pix.shape[0]
    o, d = generate_rays(cam or Camera.reset(), w, h, pix, 0, seed)
    state = (torch.zeros((n, 3), device=dev), torch.ones((n, 3), device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev), torch.zeros((n,), device=dev))
    out = []
    for bounce in range(steps):
        with recorded_shading() as calls:
            o, d, *state = tint._bounce_step(scene, o, d, *state, pix, 0, bounce, seed,
                                             cfg or tint.RenderConfig())[:6]
        out.append(calls)
    torch.cuda.synchronize()
    return out


def capture_pool_call(shading=None):
    """The CAPTURE_CALL-th `mm_closest_hit` call of the flagship wavefront
    render, and the `_cull_tile_lists` and `threefry` calls of the same advance
    (and into `shading` its bounce step's kernels' calls)."""
    from metalpathtracer_torch import cli

    def run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            cli.main(flagship_argv() + ["--wavefront", "--output",
                                        str(OUT / "capture.png")])

    return capture_calls(run, {"pool": lambda i, lanes, k: i == CAPTURE_CALL},
                         stop=True, shading=shading)["pool"]


VIEWER_SIZE, VIEWER_DEPTH = (512, 288), 8  # the viewer's defaults
VIEWER_DRAIN = 1024  # the lanes a wavefront frame drains at


class NullDisplay:
    """Stands in for the viewer's display writer: keeps the last frame."""

    def post(self, img, status):
        self.last = img

    def post_text(self, text):
        pass


def viewer_loop(scene, integrator="wavefront"):
    from metalpathtracer_torch import viewer
    from metalpathtracer_torch.render.integrator import RenderConfig

    display = NullDisplay()
    return viewer._ViewerLoop(scene, *VIEWER_SIZE, 1,
                              RenderConfig(max_depth=VIEWER_DEPTH), 0, integrator,
                              display), display


def capture_viewer_calls(scene, shading=None):
    """Of one viewer frame at the defaults: the 5th `mm_closest_hit` call on
    the viewer's pool and the first on the drain's lanes, each with its
    `_cull_tile_lists` and `threefry` calls (and into `shading` its bounce step's
    kernels' calls)."""
    from metalpathtracer_torch import viewer

    loop, _ = viewer_loop(scene)
    return capture_calls(
        lambda: loop.step(lambda: []),
        {"viewer_pool": lambda i, lanes, k: lanes == viewer.POOL_SIZE and k == 5,
         "viewer_drain": lambda i, lanes, k: lanes == VIEWER_DRAIN and k == 1},
        stop=False, shading=shading)


def run_cli(argv, profile_name=None):
    """cli.main(argv) on a counted path; returns (stats, counts)."""
    from metalpathtracer_torch import cli

    out = io.StringIO()
    with counted_path() as counts, contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    if profile_name:
        stats["profile"] = profile(lambda: cli.main(argv), profile_name,
                                   counts["mm_launches"])
    return stats, counts


def check_image(npz, shape):
    import numpy as np

    with np.load(npz) as z:
        img = z["radiance"]
    if img.shape != shape or not np.isfinite(img).all():
        raise RuntimeError(f"bad image: {img.shape}, finite {np.isfinite(img).all()}")
    if not img.mean() > 0.05:
        raise RuntimeError(f"image is black: mean {img.mean()}")
    return img


def phase_paths(profile_on: bool, w=1280, h=720):
    """The scan and the wavefront path through the CLI at full size."""
    base = flagship_argv(w, h)
    result, images = {}, {}
    for name, extra in (("scan", []), ("wavefront", ["--wavefront"])):
        png, npz = OUT / f"{name}_{w}x{h}.png", OUT / f"{name}_{w}x{h}.npz"
        stats, counts = run_cli(
            base + extra + ["--output", str(png), "--npz", str(npz)],
            profile_name=f"{name}_{w}x{h}" if profile_on and name == "wavefront"
            else None)
        images[name] = check_image(npz, (h, w, 3))
        result[name] = dict(stats=stats, counts=counts,
                            image_mean=float(images[name].mean()))
        if name == "scan":
            result[name]["image"] = images[name]
        else:
            require_regen(counts, f"[7] {name}")
        log(f"[{6 if name == 'scan' else 7}] {name}: {stats['seconds']} s, "
            f"{stats['rays']} rays, {stats['mrays_per_sec']} Mrays/s, "
            f"{counts['steps']} bounce steps traced, launches on the card: mm_closest_hit "
            f"{counts['mm_launches']} ({counts['mm_clustered']} clustered), "
            f"cull_tile_lists {counts['cull_launches']} ({counts['cull_radix']} radix), "
            f"threefry {counts['threefry_launches']} ({counts['threefry_draws']} draws), "
            f"{shading_text(counts)}, {regen_text(counts)}; "
            f"image mean {images[name].mean():.4f}")
    frac, dmean = compare_images(images["wavefront"], images["scan"],
                                 "wavefront vs scan image")
    result["wavefront"].update(vs_scan_divergent=frac, vs_scan_mean_diff=dmean)
    log(f"[7] wavefront vs scan: {frac:.5f} of pixels differ by > 1e-3, "
        f"means by {dmean:.2e}")
    return result


def phase_legs(scenes, profile_on: bool):
    """bench.py's large-scene legs through render_image_wavefront."""
    import numpy as np
    import torch

    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.pipeline import render_image_wavefront

    cfg = RenderConfig(max_depth=LEG_DEPTH)
    result = {}
    for name, scene in scenes.items():
        def leg():
            img, rays, stats = render_image_wavefront(
                scene, Camera.reset(), LEG_W, LEG_H, LEG_SPP, seed=0, cfg=cfg,
                pool_size=POOL, return_stats=True)
            return img.cpu().numpy(), rays, stats

        with counted_path() as counts:
            t0 = time.perf_counter()
            img, rays, stats = leg()  # .cpu() waits for the device
            dt = time.perf_counter() - t0
        if img.shape != (LEG_H, LEG_W, 3) or not np.isfinite(img).all():
            raise RuntimeError(f"{name}: bad image {img.shape}")
        if not img.mean() > 0.05:
            raise RuntimeError(f"{name}: image is black: mean {img.mean()}")
        require_regen(counts, f"[8] {name}")
        rec = dict(seconds=dt, rays=rays, mrays_per_sec=rays / dt / 1e6,
                   image_mean=float(img.mean()), counts=counts,
                   tiles=scene.mm_tile_box.shape[0], **stats)
        if profile_on and name == "bunny300k":
            rec["profile"] = profile(leg, f"leg_{name}", counts["mm_launches"])
        result[name] = rec
        torch.cuda.empty_cache()
        log(f"[8] {name} ({scene.num_tris} triangles, {rec['tiles']} tiles): "
            f"{dt:.3f} s, {rays} rays, {rec['mrays_per_sec']:.3f} Mrays/s, "
            f"{counts['steps']} bounce steps traced, launches on the card: mm_closest_hit "
            f"{counts['mm_launches']} ({counts['mm_clustered']} clustered), "
            f"cull_tile_lists {counts['cull_launches']} ({counts['cull_radix']} radix), "
            f"threefry {counts['threefry_launches']}, {shading_text(counts)}, "
            f"{regen_text(counts)}; image mean {img.mean():.4f}")
    return result


# kernel-name families of the profile's groups, in order of matching
KERNEL_FAMILIES = (
    *((k, (f"{k}_kernel",)) for k in SHADING + REGEN),
    ("mm_closest_hit", ("mm_closest_hit_kernel",)),
    ("cull_tiles", ("cull_tiles_kernel",)),
    ("threefry", ("threefry_kernel",)),
    ("sort", ("sort", "radix", "Sort")),
    ("scan (cumsum)", ("scan", "Scan")),
    ("reduce", ("reduce_kernel", "Reduce")),
    ("gather, index", ("index", "gather", "Index")),
    ("elementwise", ("elementwise", "Elementwise")),
    ("copy, fill", ("Memcpy", "Memset", "copy", "fill")),
)


def profile(fn, name, steps: int) -> str:
    """Run fn once to warm it (a render shape seen before captures its
    graphs there; `cli.main` uploads its scene anew, so each of its runs
    warms up and captures), then once more under torch.profiler; keep the
    kernel table and the device time by kernel family. `steps`: the
    closest-hit launches of one run on the card, one a bounce step on the
    profiled paths (no NEE), for the events a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with contextlib.redirect_stdout(io.StringIO()):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), tprofile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.duration_ns() / 1e3, e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and not e.name().startswith(SPAN_PREFIX)]
    busy_us = sum(us for _, us, _, _ in events)
    span_us = ((max(e[3] for e in events) - min(e[2] for e in events)) / 1e3
               if events else 0.0)
    families = {}
    for ename, us, _, _ in events:
        fam = next((f for f, keys in KERNEL_FAMILIES if any(k in ename for k in keys)),
                   "other")
        n, t = families.get(fam, (0, 0.0))
        families[fam] = (n + 1, t + us)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (OUT / f"profile_{name}.txt").write_text(table)
    summary = (f"device time {busy_us / 1e3:.1f} ms over a device span of "
               f"{span_us / 1e3:.1f} ms ({len(events)} device events, "
               f"{len(events) / steps:.1f} a bounce step), profiled wall {wall:.3f} s "
               "(the profiler's host cost in it; phase 17 reads the busy share); by "
               "family: " + ", ".join(
                   f"{f} {t / 1e3:.2f} ms ({100 * t / busy_us:.1f}%, {n} events)"
                   for f, (n, t) in sorted(families.items(), key=lambda kv: -kv[1][1])))
    log(f"    profile {name}: {summary}; table in {OUT / f'profile_{name}.txt'}")
    return summary


# the ranges whose device events `range_table` also splits by kernel name
SPLIT_RANGES = ("hit.front", "hit.kernel_inputs", "wavefront.bank", "step.shade",
                "step.shade_bank", "wavefront.restart_lanes", "wavefront.queue",
                "wavefront.sort_pool")


def kernel_label(name: str) -> str:
    """A device event's kernel name, short: no return type, namespaces or
    parameter list; the template arguments that name the operation kept."""
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"\(anonymous namespace\)::|at::native::|at_cuda_detail::|c10::|"
                  r"std::", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:140]


def range_table(fn, name: str) -> dict:
    """`fn()` on the graph path by the port's spans: warm runs until one
    captures and warms nothing, then up to 3 runs under torch.profiler
    (host and device), keeping the first whose replays all match their
    graphs' capture-time node maps, else the one with the fewest that do
    not (the profiler loses records). Each device event is charged by
    `metrics.charge_events`: an eager one to the innermost span
    (SPAN_PREFIX) open at its launch, a replay's through its graph's map to
    the span that captured its node; events launched outside every span
    are "(no range)". Returns {range: [device ms, events]} with the replays
    and the unmatched ones, and logs the table with each range's events a
    bounce step (`steps`: the run's closest-hit launches, one a bounce step
    on these paths), and the events of SPLIT_RANGES by kernel name
    (`split`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.utils import metrics

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    best = None
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(4):
            before = dict(graphs.STATS)
            fn()
            if (graphs.STATS["captures"] == before["captures"]
                    and graphs.STATS["eager_runs"] == before["eager_runs"]):
                break
        torch.cuda.synchronize()
        for _ in range(3):
            with tprofile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            got = metrics.charge_events(*metrics.profile_events(prof), graphs.span_maps())
            if best is None or got[2] < best[2]:
                best = got
            if got[2] == 0:
                break
    charges, replays, unmatched = best
    steps = max(1, sum("mm_closest_hit_kernel" in ename for _, _, ename in charges))
    table, split = {}, {}
    for key, ns, ename in charges:
        row = table.setdefault(key, [0.0, 0])
        row[0] += ns / 1e6
        row[1] += 1
        if key in SPLIT_RANGES:
            row = split.setdefault(key, {}).setdefault(kernel_label(ename), [0.0, 0])
            row[0] += ns / 1e6
            row[1] += 1
    total = sum(v[0] for v in table.values())
    lines = [f"{k}: {v[0]:.2f} ms ({100 * v[0] / total:.1f}%), {v[1]} events, "
             f"{v[1] / steps:.1f} a bounce step"
             for k, v in sorted(table.items(), key=lambda kv: -kv[1][0])]
    log(f"    ranges {name} (graph path, profiled): {total:.1f} ms of device time in "
        f"{len(charges)} events, {len(charges) / steps:.1f} a bounce step over "
        f"{steps} steps; {replays} replays, {unmatched} unmatched; " + "; ".join(lines))
    for key, kernels in split.items():
        log(f"    inside {key} ({name}), by kernel: " + "; ".join(
            f"{k}: {v[0]:.2f} ms, {v[1]} events, {v[1] / steps:.1f} a bounce step"
            for k, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])))
    return dict(total_ms=total, events=len(charges), steps=steps, ranges=table,
                split=split, replays=replays, unmatched=unmatched)


def phase_ranges(scene, bunny, card) -> dict:
    """Where a bounce step's device time goes, by the port's profiler
    ranges, and what the graph path takes: the flagship scan (1280x720,
    spp 4, depth 32), the flagship wavefront (the same, pool 2^15) and, with
    `bunny`, the bunny300k leg. Each: a range table of one render on the
    graph path (`range_table`), then a warm render, GRAPH_REPEATS
    timed ones (median and range) and one profiled (`device_busy`: its
    device time, events and busy share)."""
    import statistics

    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render import pipeline as tpipe
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.integrator import RenderConfig

    cam = Camera.reset()
    paths = {
        "flagship_scan": lambda: tpipe.render_image(
            scene, cam, 1280, 720, 4, seed=0, cfg=RenderConfig(max_depth=32)),
        "flagship_wavefront": lambda: tpipe.render_image_wavefront(
            scene, cam, 1280, 720, 4, seed=0, cfg=RenderConfig(max_depth=32),
            pool_size=POOL)}
    if bunny is not None:
        paths["bunny300k_leg"] = lambda: tpipe.render_image_wavefront(
            bunny, cam, LEG_W, LEG_H, LEG_SPP, seed=0,
            cfg=RenderConfig(max_depth=LEG_DEPTH), pool_size=POOL)
    record = {}
    for name, fn in paths.items():
        graphs.clear()
        rec = {"ranges": range_table(fn, name)}
        fn()
        torch.cuda.synchronize()
        secs = []
        for _ in range(GRAPH_REPEATS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        busy = device_busy(fn, f"{name}, replayed")
        rec.update(graph_s=secs, graph_median_s=statistics.median(secs),
                   device_ms=busy["busy_ms"], kernel_ms=busy["kernel_ms"],
                   events=busy["events"], busy_share=busy["busy_share"],
                   tallies=busy["tallies"])
        log(f"[R] {name} on the graph path: median {rec['graph_median_s']:.4f} s "
            f"({min(secs):.4f}-{max(secs):.4f}, {len(secs)} renders); profiled: "
            f"device busy {busy['busy_ms']:.1f} ms (kernels {busy['kernel_ms']:.1f} ms, "
            f"{busy['events']} events, busy {100 * busy['busy_share']:.1f}%); launches "
            f"{busy['tallies']} ({card})")
        record[name] = rec
        graphs.clear()
        torch.cuda.empty_cache()
    (OUT / "ranges.json").write_text(json.dumps(record, indent=1))
    return record


def phase_small_vs_plain(scene):
    """Both paths at 320x180 spp 2 depth 8 on the kernels vs on the plain
    versions and vs on the RNG's twin alone, and the golden reference-scene
    case."""
    import numpy as np
    import torch

    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.pipeline import (
        render_image,
        render_image_wavefront,
    )
    from metalpathtracer_torch.scene import presets

    cfg = RenderConfig(max_depth=8)
    result = {}
    for name, fn in (("scan", render_image), ("wavefront", render_image_wavefront)):
        a, ra = fn(scene, Camera.reset(), 320, 180, 2, seed=1, cfg=cfg)
        # the RNG kernel against its twin: the same draws, so the same image
        with plain_versions(("threefry",)):
            c, rc = fn(scene, Camera.reset(), 320, 180, 2, seed=1, cfg=cfg)
        if not torch.equal(a, c) or ra != rc:
            raise RuntimeError(f"{name}: the render with the RNG's twin differs "
                               f"at {int((a != c).sum())} values, rays {ra} vs {rc}")
        # the bounce step's kernels against their twins: bit-equal kernels,
        # so the same image
        with plain_versions(SHADING):
            e, re_ = fn(scene, Camera.reset(), 320, 180, 2, seed=1, cfg=cfg)
        if not torch.equal(a, e) or ra != re_:
            raise RuntimeError(f"{name}: the render with the bounce step's twins "
                               f"differs at {int((a != e).sum())} values, rays {ra} vs "
                               f"{re_}")
        # the regeneration's kernels against their twins likewise
        if name == "wavefront":
            with plain_versions(REGEN):
                g, rg = fn(scene, Camera.reset(), 320, 180, 2, seed=1, cfg=cfg)
            if not torch.equal(a, g) or ra != rg:
                raise RuntimeError(f"{name}: the render with the regeneration's twins "
                                   f"differs at {int((a != g).sum())} values, rays {ra} "
                                   f"vs {rg}")
        with plain_versions():
            b, rb = fn(scene, Camera.reset(), 320, 180, 2, seed=1, cfg=cfg)
        frac, dmean = compare_images(a.cpu().numpy(), b.cpu().numpy(),
                                     f"{name} kernels vs plain versions")
        result[name] = dict(divergent=frac, mean_diff=dmean, rays=ra, plain_rays=rb)
        log(f"[9] {name} 320x180 spp 2 depth 8, kernels vs plain: {frac:.5f} of "
            f"pixels differ by > 1e-3, means by {dmean:.2e}, rays {ra} vs {rb}; "
            "with the RNG's twin alone, with the bounce step's twins alone "
            "(the front end's, the hit epilogue's and the four shadings') and, on "
            "the wavefront, with the regeneration's four twins alone: bit-equal")

    # the golden reference-scene case of tests/test_golden.py, on the card
    golden_scene = upload_scene(
        presets.reference_default(str(ROOT / "assets" / "bunny.obj")), "cuda")
    img, _ = render_image(golden_scene, Camera.reset(), 64, 36, 4, seed=3, cfg=cfg)
    img = img.cpu().numpy()
    with np.load(ROOT / "tests" / "golden" / "reference_scene.npz") as z:
        golden = z["image"]
    rmse = float(np.sqrt(((img - golden) ** 2).mean()))
    gfrac = float((np.abs(img - golden) > 1e-3).mean())
    if not (rmse < 1e-2 and gfrac < IMG_FRAC):
        raise RuntimeError(f"golden reference_scene: RMSE {rmse}, {gfrac} divergent")
    log(f"[9] golden reference_scene on cuda: RMSE {rmse:.2e}, {gfrac:.5f} divergent")
    result["golden_rmse"] = rmse
    return result


def radiance(npz):
    import numpy as np

    with np.load(npz) as z:
        return z["radiance"]


def phase_checkpoint(scan):
    """The checkpointed CLI at full size: to 2 spp, resumed to 4, against 4
    spp without interruption and against the scan path (`scan`: phase 6's
    image and counts)."""
    import numpy as np

    from metalpathtracer_torch import cli
    from metalpathtracer_torch.io.checkpoint import load_checkpoint, save_checkpoint

    ck, whole = OUT / "ck.npz", OUT / "ck_whole.npz"
    for f in (ck, whole):
        f.unlink(missing_ok=True)

    def argv(name, path, spp):
        return flagship_argv() + [
            "--spp", str(spp), "--checkpoint", str(path), "--checkpoint-every", "2",
            "--output", str(OUT / f"{name}.png"), "--npz", str(OUT / f"{name}.npz")]

    first, c1 = run_cli(argv("ck_first", ck, 2))
    resumed, c2 = run_cli(argv("ck_resumed", ck, 4) + ["--resume"])
    straight, c3 = run_cli(argv("ck_straight", whole, 4))
    a, b = radiance(OUT / "ck_resumed.npz"), radiance(OUT / "ck_straight.npz")
    if a.shape != scan["image"].shape or not np.array_equal(a, b):
        raise RuntimeError("the resumed render differs from the uninterrupted one: "
                           f"{int((a != b).sum())} values")
    frac, dmean = compare_images(a, scan["image"], "checkpointed vs scan image")
    # launches on the card (the tallies), as the scan path made: the scan's
    # graphs trace only a shape's first blocks, so traced steps differ
    keys = ("mm_launches", "cull_launches", "threefry_launches")
    launches = {k: c1[k] + c2[k] for k in keys}
    for got in (launches, c3):
        for k in keys:
            if got[k] != scan["counts"][k]:
                raise RuntimeError(f"checkpointed render: {k} {got[k]}, the scan "
                                   f"path made {scan['counts'][k]}")
    # one write of the 1280x720 state, timed alone
    state, seed, meta = load_checkpoint(str(ck), "cuda")
    if state.spp != 4:
        raise RuntimeError(f"the checkpoint holds {state.spp} spp")
    t0 = time.perf_counter()
    save_checkpoint(str(OUT / "ck_copy.npz"), state, seed, meta=meta)
    write_s = time.perf_counter() - t0
    # another --fov: refused with exit code 2, the file left as it was
    before = ck.read_bytes()
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv("ck_refused", ck, 6) + ["--resume", "--fov", "50"])
    if rc != 2 or "camera:" not in err.getvalue() or ck.read_bytes() != before:
        raise RuntimeError(f"a resume with another --fov returned {rc}")
    log(f"[10] checkpointed CLI: to 2 spp {first['seconds']} s, resumed to 4 spp "
        f"{resumed['seconds']} s, 4 spp without interruption {straight['seconds']} s "
        f"(one checkpoint write {write_s:.3f} s); resumed and uninterrupted images "
        f"bit-equal; vs scan {frac:.5f} of pixels differ by > 1e-3, means by "
        f"{dmean:.2e}; launches per 4 spp: mm_closest_hit {c3['mm_launches']}, "
        f"cull_tile_lists {c3['cull_launches']}, threefry {c3['threefry_launches']}; "
        "another --fov exits 2")
    return dict(first_s=first["seconds"], resumed_s=resumed["seconds"],
                straight_s=straight["seconds"], write_s=write_s, counts=c3,
                vs_scan_divergent=frac, vs_scan_mean_diff=dmean)


def phase_progressive(scene, scan_image, depth=32):
    """Four accumulate_wavefront steps of 1 spp at the size of `scan_image`
    (phase 6's, 1280x720) against four accumulate steps, step for step."""
    import torch

    from metalpathtracer_torch.render import pipeline as tpipe
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.integrator import RenderConfig

    h, w = scan_image.shape[:2]
    cfg, cam = RenderConfig(max_depth=depth), Camera.reset()
    means = {}
    record = {}
    for name in ("scan", "wavefront"):
        state = tpipe.init_accum(w, h, scene.device)
        means[name], rays, secs = [], 0, []
        with counted_path() as counts:
            for _ in range(4):
                t0 = time.perf_counter()
                if name == "scan":
                    state = tpipe.accumulate(state, scene, cam, w, h, 1, 0, cfg)
                else:
                    state, r = tpipe.accumulate_wavefront(state, scene, cam, w, h, 1,
                                                          0, cfg, pool_size=POOL)
                    rays += r
                means[name].append(tpipe.to_image(state, clamp=False).cpu().numpy())
                secs.append(time.perf_counter() - t0)
        if state.spp != 4:
            raise RuntimeError(f"{name}: {state.spp} spp after four steps")
        record[name] = dict(step_s=secs, rays=rays, counts=counts)
    worst = (0.0, 0.0)
    for k, (a, b) in enumerate(zip(means["wavefront"], means["scan"])):
        worst = max(worst, compare_images(a, b, f"progressive step {k + 1}"))
    # the samples are 0..3, not four times sample 0: the mean after four
    # steps is the scan path's 4-spp image, and step 2 added another sample
    frac, dmean = compare_images(means["wavefront"][3], scan_image,
                                 "progressive wavefront vs scan image")
    first, second = means["wavefront"][0], 2 * means["wavefront"][1] - means["wavefront"][0]
    if float(abs(first - second).mean()) < 1e-3:
        raise RuntimeError("step 2 repeated step 1's sample")
    wf = record["wavefront"]
    log(f"[11] progressive wavefront: 4 steps of 1 spp in "
        + ", ".join(f"{t:.3f}" for t in wf["step_s"]) + f" s, {wf['rays']} rays, "
        f"launches: mm_closest_hit {wf['counts']['mm_launches']}, cull_tile_lists "
        f"{wf['counts']['cull_launches']}, threefry {wf['counts']['threefry_launches']}; "
        "accumulate steps in "
        + ", ".join(f"{t:.3f}" for t in record["scan"]["step_s"]) + " s; step for "
        f"step at most {worst[0]:.5f} of pixels differ by > 1e-3, means by "
        f"{worst[1]:.2e}; after 4 steps vs the scan image {frac:.5f}, {dmean:.2e}")
    torch.cuda.empty_cache()
    return dict(record, worst_divergent=worst[0], worst_mean_diff=worst[1],
                vs_scan_divergent=frac)


VIEWER_FRAMES, VIEWER_KEY_AFTER, VIEWER_STEADY_FROM = 60, 30, 10


def phase_viewer(scene, child_argv=()):
    """The viewer at its defaults: its loop in this process on a counted
    path, then the program itself in a child under a pty (`child_argv`:
    further arguments for it)."""
    import os
    import pty
    import re
    import statistics
    import threading

    import numpy as np

    from metalpathtracer_torch import viewer
    from metalpathtracer_torch.render import pipeline as tpipe

    size = VIEWER_SIZE
    counted_frames, plain_frames = 5, 10

    def step_frames(loop, first, n):
        dts = []
        for k in range(first, first + n):
            t0 = time.perf_counter()
            if not loop.step(lambda: []) or loop.shown_spp != k:
                raise RuntimeError(f"viewer loop: frame {k} shows "
                                   f"{loop.shown_spp} spp")
            dts.append(time.perf_counter() - t0)
        return dts

    with counted_path() as counts:
        loop, display = viewer_loop(scene)
        with SyncCounter() as syncs:
            dt_counted = step_frames(loop, 1, counted_frames)
        fifth, last_shown = loop.state, display.last
        dt_plain = step_frames(loop, counted_frames + 1, plain_frames)
    if last_shown.shape != (size[1], size[0], 3) or not np.array_equal(
            last_shown, viewer._srgb_u8(fifth).cpu().numpy()):
        raise RuntimeError("viewer loop: the frame shown is not its accumulation")
    want = tpipe.init_accum(*size, scene.device)
    for _ in range(counted_frames):
        want = tpipe.accumulate(want, scene, loop.cam, *size, 1, loop.seed, loop.cfg)
    frac, dmean = compare_images(tpipe.to_image(fifth, clamp=False).cpu().numpy(),
                                 tpipe.to_image(want, clamp=False).cpu().numpy(),
                                 "viewer frame 5 vs five accumulate steps")
    dispatched = loop.state.spp
    rng_syncs = sum(n for site, n in syncs.sites.items()
                    if site.split(":")[0] in ("rng.py", "threefry.py"))
    log(f"[12] viewer loop in process at {size[0]}x{size[1]}, depth {VIEWER_DEPTH}: "
        f"{dispatched} frames, launches: mm_closest_hit {counts['mm_launches']}, "
        f"cull_tile_lists {counts['cull_launches']} "
        f"({counts['mm_launches'] / dispatched:.1f} per frame), threefry "
        f"{counts['threefry_launches']} ({counts['threefry_launches'] / dispatched:.1f} "
        f"per frame); frame 5 vs five "
        f"accumulate steps: {frac:.5f} of pixels differ by > 1e-3, means by "
        f"{dmean:.2e}; frames 2-5 with synchronising calls counted "
        f"{statistics.median(dt_counted[1:]):.3f} s each (median), frames 6-15 "
        f"without {statistics.median(dt_plain):.3f} s; "
        f"{syncs.count / counted_frames:.1f} flagged synchronising calls per frame, "
        f"{rng_syncs / counted_frames:.1f} of them from the RNG's modules; by "
        "source line: " + ", ".join(
            f"{site} {n / counted_frames:.1f}" for site, n in
            sorted(syncs.sites.items(), key=lambda kv: -kv[1])[:12]))

    master, slave = pty.openpty()
    env = dict(os.environ, MPT_VIEWER_TRACE="1", PYTHONPATH=str(ROOT))
    child = subprocess.Popen(
        [sys.executable, "-m", "metalpathtracer_torch.viewer", "--scene",
         str(ROOT / "scenes" / "reference.xml"), "--max-frames", str(VIEWER_FRAMES),
         "--no-mouse", *child_argv],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE, close_fds=True,
        cwd=str(ROOT), env=env)
    os.close(slave)
    lines, shown = [], dict(bytes=0, blocks=False, statuses=[])
    key_sent = threading.Event()

    def drain_stderr():
        for raw in child.stderr:
            line = raw.decode(errors="replace").rstrip()
            lines.append(line)
            if line.startswith(f"frame {VIEWER_KEY_AFTER}:") and not key_sent.is_set():
                key_sent.set()
                os.write(master, b"w")

    def drain_pty():
        while True:
            try:
                data = os.read(master, 1 << 20)
            except OSError:
                return
            if not data:
                return
            shown["bytes"] += len(data)
            shown["blocks"] |= "▀".encode() in data
            shown["statuses"] += re.findall(rb"(\d+) spp \|", data)

    threads = [threading.Thread(target=f, daemon=True)
               for f in (drain_stderr, drain_pty)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    try:
        rc = child.wait(timeout=420)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        # with the child gone the pty's read fails and its thread ends
        for th in threads:
            th.join(timeout=30)
        os.close(master)
    wall = time.perf_counter() - t0
    (OUT / "viewer_stderr.txt").write_text("\n".join(lines))
    pat = re.compile(r"frame (\d+): dispatch ([\d.]+)s poll ([\d.]+)s fetch ([\d.]+)s "
                     r"dt ([\d.]+)s spp (\d+) mm (\d+) cull (\d+)$")
    frames = [tuple(float(v) for v in m.groups())
              for m in map(pat.match, lines) if m]
    if rc != 0 or len(frames) != VIEWER_FRAMES:
        raise RuntimeError(f"viewer child: exit code {rc}, {len(frames)} frames; "
                           + " | ".join(lines[-5:]))
    # the writer is latest-wins: how many frames reach the terminal is the
    # terminal's rate, so only that it drew at all is held
    if not key_sent.is_set() or not shown["blocks"]:
        raise RuntimeError(f"viewer child: key sent {key_sent.is_set()}, drew "
                           f"{shown['blocks']}, {shown['bytes']} bytes")
    spp = [int(f[5]) for f in frames]
    reset_at = [k for k in range(1, len(spp)) if spp[k] == 1]
    # one key: one reset, after the key's frame, from a count that had grown
    if (len(reset_at) != 1 or not VIEWER_KEY_AFTER < reset_at[0] <= VIEWER_KEY_AFTER + 4
            or spp[:reset_at[0]] != list(range(1, reset_at[0] + 1))
            or spp[reset_at[0]:] != list(range(1, len(spp) - reset_at[0] + 1))):
        raise RuntimeError(f"viewer child: displayed spp {spp}")
    steady = [f for f in frames if f[0] >= VIEWER_STEADY_FROM]
    fps = len(steady) / sum(f[4] for f in steady)
    dts = sorted(f[4] for f in steady)
    rec = dict(
        frames=len(frames), wall_s=wall, fps=fps, dt_median_s=statistics.median(dts),
        dt_min_s=dts[0], dt_max_s=dts[-1], reset_at_frame=reset_at[0],
        reset_frame_dt_s=frames[reset_at[0]][4],
        mm_launches_per_frame=statistics.median(f[6] for f in steady),
        cull_launches_per_frame=statistics.median(f[7] for f in steady),
        pty_bytes=shown["bytes"], statuses_seen=len(shown["statuses"]))
    if min(rec["mm_launches_per_frame"], rec["cull_launches_per_frame"]) < 1:
        raise RuntimeError(f"viewer child: a frame launched no kernel: {rec}")
    log(f"[12] viewer child under a pty: {len(frames)} frames at {size[0]}x{size[1]}, "
        f"depth {VIEWER_DEPTH}, "
        f"1 spp per frame in {wall:.1f} s with start-up; frames "
        f"{VIEWER_STEADY_FROM} on: {fps:.3f} "
        f"frames per second (dt median {rec['dt_median_s']:.3f} s, "
        f"{dts[0]:.3f}-{dts[-1]:.3f} s); per frame: mm_closest_hit "
        f"{rec['mm_launches_per_frame']:g} launches, cull_tile_lists "
        f"{rec['cull_launches_per_frame']:g}; the key "
        f"after frame {VIEWER_KEY_AFTER} reset the display to 1 spp at frame "
        f"{reset_at[0]} (that frame's dt {rec['reset_frame_dt_s']:.3f} s); "
        f"{shown['bytes'] / 1e6:.1f} MB reached the terminal, "
        f"{len(shown['statuses'])} whole frames with their status line")
    rec["loop"] = dict(
        counts=counts, frames=dispatched, syncs_per_frame=syncs.count / counted_frames,
        rng_syncs_per_frame=rng_syncs / counted_frames,
        dt_counted_s=dt_counted, dt_plain_s=dt_plain, vs_accumulate_divergent=frac,
        vs_accumulate_mean_diff=dmean)
    return rec


def phase_bvh(sets, n_each, chunk):
    """closest_hit_bvh against the brute oracle and beside
    closest_hit_mm_full on phase 3's rays, and a CLI render through it. The
    reference scene is uploaded once more, with its BVH, which no other
    phase reads."""
    import numpy as np
    import torch

    from metalpathtracer_torch import cli
    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.intersect import closest_hit_bruteforce
    from metalpathtracer_torch.render.kernels import _build
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import shade as tsh
    from metalpathtracer_torch.render.traverse import closest_hit_bvh
    from metalpathtracer_torch.scene import load_scene_xml

    host = load_scene_xml(str(ROOT / "scenes" / "reference.xml"))
    t0 = time.perf_counter()
    upload_scene(host, "cuda")
    bare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = upload_scene(host, "cuda", bvh=True)
    upload_s = time.perf_counter() - t0
    log(f"[13] reference scene built and uploaded in {bare_s:.2f} s without its "
        f"BVH, {upload_s:.2f} s with it")
    o, d = oracle_rays(sets, n_each)
    before = tmm.mm_closest_hit.launches, tmm._cull_tile_lists.launches
    closest_hit_bvh(scene, o[:1024], d[:1024])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t1, i1 = closest_hit_bvh(scene, o, d, T_MIN)
    torch.cuda.synchronize()
    bvh_ms = (time.perf_counter() - t0) * 1e3
    if (tmm.mm_closest_hit.launches, tmm._cull_tile_lists.launches) != before:
        raise RuntimeError("closest_hit_bvh launched a tile kernel")
    mm_ms = call_ms(lambda: tmm.closest_hit_mm_full(scene, o, d, T_MIN), 5)
    t0_, i0 = closest_hit_bruteforce(scene, o, d, T_MIN, chunk=chunk)
    what = f"BVH walk vs brute oracle ({scene.num_tris} triangles)"
    n_mis, n_tie, n_edge = judge_mismatches(scene, o, d, i1, t1, i0, t0_, what)
    same = (i1 == i0) & torch.isfinite(t0_)
    err = (t1[same] - t0_[same]).abs()
    if not bool((err <= T_RTOL * t0_[same].abs() + T_ATOL).all()):
        raise RuntimeError(f"{what}: t off by {float(err.max())}")
    log(f"[13] {what}, {o.shape[0]} rays (stack of {scene.max_depth + 2}, "
        f"{scene.node_a.shape[0]} nodes): {int((i0 >= 0).sum())} hits, {n_mis} "
        f"differ, max |dt| {float(err.max()):.3g}; the walk {bvh_ms:.1f} ms, "
        f"closest_hit_mm_full {mm_ms:.3f} ms per call on the same rays")

    # the BVH walk reads the host on every level: both integrators run it on
    # their eager loop by config (no warm-up, capture or replay), and equal
    # their renders under `graphs.eager()`
    images, seconds, routes = {}, {}, {}
    counts = {}
    for name, kind, extra in (("bvh", "bvh", []), ("bvh_wavefront", "bvh", ["--wavefront"]),
                              ("mm", "mm", [])):
        def argv(tag):
            return ["--scene", str(ROOT / "scenes" / "reference.xml"), "--width", "320",
                    "--height", "180", "--spp", "2", "--max-depth", "8", "--device",
                    "cuda", "--stats-json", "--intersector", kind, "--output",
                    str(OUT / f"small_{tag}.png"), "--npz",
                    str(OUT / f"small_{tag}.npz")] + extra

        def shading_calls():  # (front end, hit epilogue, the shading from
            # the closest hit's winners)
            return (tmm.hit_front.launches + tmm.sphere_pass.launches,
                    tmm.hit_epilogue.launches, tsh.shade_hit.launches)

        launches = tmm.mm_closest_hit.launches, tmm._cull_tile_lists.launches
        shaded = shading_calls()
        before = dict(graphs.STATS)
        out = io.StringIO()
        torch.cuda.synchronize()
        _build.zero_tallies()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv(name))
        if rc != 0:
            raise RuntimeError(f"cli.main --intersector {kind} {extra} returned {rc}")
        # the bounce step's kernels' launches on the card, this render alone
        counts[name] = dict(zip(SHADING_KEYS, executed_shading()),
                            **dict(zip(REGEN_KEYS, executed_regen())))
        moved = {k: graphs.STATS[k] - before[k] for k in before}
        ran = tmm.mm_closest_hit.launches - launches[0]
        if (ran > 0) != (kind == "mm"):
            raise RuntimeError(f"--intersector {kind} launched {ran} closest-hit kernels")
        # the BVH walk has no front end or epilogue, and shades the hit it
        # resolves in plain torch; the tile route shades from its winners
        # (NEE off) on the shading kernel
        shaded = tuple(a - b for a, b in zip(shading_calls(), shaded))
        mm = kind == "mm"
        if (shaded[0] > 0) != mm or shaded[1] or (shaded[2] > 0) != mm:
            raise RuntimeError(f"--intersector {kind} {extra}: (front end, hit "
                               f"epilogue, shading from the winners) calls {shaded}")
        seconds[name] = json.loads(out.getvalue().strip().splitlines()[-1])["seconds"]
        images[name] = check_image(OUT / f"small_{name}.npz", (180, 320, 3))
        if kind == "bvh":
            if moved["captures"] or moved["replays"] or not moved["eager_runs"]:
                raise RuntimeError(f"cli {extra} --intersector bvh: {moved}, not the "
                                   "eager loop by config")
            with graphs.eager(), contextlib.redirect_stdout(io.StringIO()):
                if cli.main(argv(name + "_eager")) != 0:
                    raise RuntimeError(f"cli {extra} --intersector bvh under eager()")
            again = radiance(OUT / f"small_{name}_eager.npz")
            if not np.array_equal(images[name], again):
                raise RuntimeError(f"cli {extra} --intersector bvh: the render differs "
                                   "from its eager render")
            routes[name] = moved
    frac, dmean = compare_images(images["bvh"], images["mm"], "bvh vs mm render")
    frac_w, dmean_w = compare_images(images["bvh_wavefront"], images["mm"],
                                     "bvh wavefront vs mm render")
    log(f"[13] cli --intersector bvh 320x180 spp 2 depth 8: scan {seconds['bvh']} s, "
        f"wavefront {seconds['bvh_wavefront']} s (mm: {seconds['mm']} s); both on "
        f"their eager loop by config ({routes['bvh']['eager_runs']} and "
        f"{routes['bvh_wavefront']['eager_runs']} eager runs, no capture or replay) "
        f"and bit-equal to their renders under graphs.eager(); against mm "
        f"{frac:.5f} / {frac_w:.5f} of pixels differ by > 1e-3, means by "
        f"{dmean:.2e} / {dmean_w:.2e}; no tile kernel, sphere pass, hit epilogue "
        f"or shading kernel launched (the plain shading on every step)")
    return dict(rays=o.shape[0], mismatches=n_mis, max_abs_err=float(err.max()),
                walk_ms=bvh_ms, mm_full_ms=mm_ms, render_s=seconds, routes=routes,
                counts=counts,
                upload_s=upload_s, upload_without_bvh_s=bare_s,
                render_divergent=frac, render_mean_diff=dmean,
                wavefront_divergent=frac_w, wavefront_mean_diff=dmean_w)


def same_but_ties(a, b, what: str) -> int:
    """Two wavefront renders of one image under different queue layouts (a
    whole image and its row blocks): a ray that meets two triangles at one t
    (a shared edge) takes whichever its subgroup's tile order reaches first,
    and the subgroups differ with the layout. So the images are equal but
    for such pixels: at most MAX_MISMATCH of the pixels may differ at all,
    and those within the render limit. Returns how many differ."""
    differing = int((a != b).any(axis=-1).sum())
    if differing > MAX_MISMATCH * a.shape[0] * a.shape[1]:
        raise RuntimeError(f"{what}: {differing} pixels differ")
    compare_images(a, b, what)
    return differing


def phase_sharded_cli(paths):
    """14a: the CLI's tile-sharded branches in a world of one against the
    unsharded renders of phases 6 and 7 (`paths`)."""
    import numpy as np

    result = {}
    for name, extra in (("scan", []), ("wavefront", ["--wavefront"])):
        npz = OUT / f"tile_shard_{name}.npz"
        stats, counts = run_cli(flagship_argv() + extra + [
            "--tile-shard", "--output", str(OUT / f"tile_shard_{name}.png"),
            "--npz", str(npz)])
        want = paths[name]
        if not np.array_equal(radiance(npz), radiance(OUT / f"{name}_1280x720.npz")):
            raise RuntimeError(f"--tile-shard {name}: the image differs from the "
                               "unsharded one")
        if stats["rays"] != want["stats"]["rays"] or any(
                counts[k] != want["counts"][k]
                for k in ("mm_launches", "cull_launches", "threefry_launches")):
            raise RuntimeError(f"--tile-shard {name}: {stats['rays']} rays, {counts}; "
                               f"unsharded {want['stats']['rays']}, {want['counts']}")
        result[name] = dict(stats=stats, counts=counts)
        log(f"[14a] cli --tile-shard {name} in a world of one: {stats['seconds']} s, "
            f"{stats['rays']} rays, launches: mm_closest_hit {counts['mm_launches']}, "
            f"cull_tile_lists {counts['cull_launches']}, threefry "
            f"{counts['threefry_launches']}; image bit-equal to phase "
            f"{6 if name == 'scan' else 7}'s")
    return result


def phase_config5():
    """14b: config 5 in a world of one: four accumulate_sharded steps
    against one render_image_wavefront of the same spp. Returns the record
    and the accumulation after two steps (on the host), which 14c's ranks
    must reproduce."""
    import torch

    from metalpathtracer_torch.parallel import sharding
    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.pipeline import render_image_wavefront
    from metalpathtracer_torch.scene import load_scene_xml

    w, h = CONFIG5_SIZE
    t0 = time.perf_counter()
    scene = upload_scene(load_scene_xml(str(ROOT / "scenes" / "multimesh.xml")), "cuda")
    upload_s = time.perf_counter() - t0
    cfg, cam, mesh = RenderConfig(max_depth=CONFIG5_DEPTH), Camera.reset(), sharding.make_mesh()
    if mesh.size != 1:
        raise RuntimeError(f"phase 14b runs in a world of one, not {mesh.shape}")
    state = sharding.init_accum_sharded(w, h, mesh, scene.device)
    rays, secs, after_two = 0, [], None
    per_step = []
    with counted_path() as counts:
        while state.spp < CONFIG5_SPP:
            before, reads = executed(), graphs.STATS["reads"]
            t0 = time.perf_counter()
            state, r = sharding.accumulate_sharded(state, scene, cam, CONFIG5_STEP,
                                                   seed=5, cfg=cfg, mesh=mesh)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rays += r
            launched = tuple(b - a for a, b in zip(before, executed()))
            per_step.append(dict(samples=(state.spp - CONFIG5_STEP, state.spp - 1),
                                 advances=launched[0], launched=launched, rays=r,
                                 reads=graphs.STATS["reads"] - reads))
            log(f"[14b] step {len(per_step)}, samples {state.spp - CONFIG5_STEP}-"
                f"{state.spp - 1}: {launched[0]} advances (one closest hit each), "
                f"launches {launched[:3]} ({launched[3]} draws), "
                f"{per_step[-1]['reads']} windows and drain blocks, {r} rays")
            if state.spp == 2 * CONFIG5_STEP:
                after_two = state.rgb_sum.cpu()
    img = (sharding.gather_accum(state, mesh).rgb_sum / CONFIG5_SPP)
    with counted_path() as whole_counts:
        t0 = time.perf_counter()
        want, want_rays = render_image_wavefront(scene, cam, w, h, CONFIG5_SPP, seed=5,
                                                 cfg=cfg)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
    if img.shape != (h, w, 3) or not bool(torch.isfinite(img).all()) or not float(
            img.mean()) > 0.05:
        raise RuntimeError(f"config 5: bad image {tuple(img.shape)}, mean {float(img.mean())}")
    worst = float((img - want).abs().max())
    if not torch.allclose(img, want, rtol=1e-6, atol=1e-7) or rays != want_rays:
        raise RuntimeError(f"config 5: four steps differ from one render by {worst}; "
                           f"rays {rays} vs {want_rays}")
    from metalpathtracer_torch.io.png import write_png

    write_png(str(OUT / "config5.png"), img.cpu().numpy())
    step_s = sum(secs)
    log(f"[14b] config 5 (multimesh, {scene.num_tris} triangles in "
        f"{scene.mm_tile_box.shape[0]} tiles, uploaded in {upload_s:.2f} s) at {w}x{h}, "
        f"depth {CONFIG5_DEPTH}, {CONFIG5_SPP} spp in steps of {CONFIG5_STEP}, world of "
        "one: accumulate_sharded steps " + ", ".join(f"{t:.3f}" for t in secs)
        + f" s ({step_s:.3f} s, {rays / step_s / 1e6:.3f} Mrays/s), {rays} rays, launches: "
        f"mm_closest_hit {counts['mm_launches']}, cull_tile_lists {counts['cull_launches']}, "
        f"threefry {counts['threefry_launches']}; "
        f"render_image_wavefront of {CONFIG5_SPP} spp {whole_s:.3f} s "
        f"({whole_counts['mm_launches']} launches); max |difference| {worst:.3g} "
        f"(rtol 1e-6, atol 1e-7), rays equal; image mean {float(img.mean()):.4f}")
    del scene
    torch.cuda.empty_cache()
    return dict(upload_s=upload_s, step_s=secs, rays=rays, counts=counts,
                per_step=per_step, whole_s=whole_s, whole_counts=whole_counts, max_abs_diff=worst,
                image_mean=float(img.mean())), after_two


def rank_jobs(tag: str):
    """What each rank of phase 14c runs: the flagship through the CLI's
    tile-sharded branches, and two accumulate_sharded steps of config 5."""
    def cli_job(name, extra):
        return dict(name=name, kind="cli", argv=flagship_argv() + extra + [
            "--tile-shard", "--output", str(OUT / f"{tag}_{name}.png"),
            "--npz", str(OUT / f"{tag}_{name}.npz")])

    return [
        cli_job("scan", []), cli_job("wavefront", ["--wavefront"]),
        dict(name="config5", kind="accumulate",
             scene={"xml": str(ROOT / "scenes" / "multimesh.xml")}, camera="reset",
             width=CONFIG5_SIZE[0], height=CONFIG5_SIZE[1],
             steps=[CONFIG5_STEP, CONFIG5_STEP], seed=5,
             cfg={"max_depth": CONFIG5_DEPTH}, mesh={"axis": "tiles"}),
    ]


def shard_rank(spec_file: str, rank: int) -> int:
    """One rank of a world of phase 14c: the spec's jobs, each on a counted
    path (every bounce step through both kernels, no plain version)."""
    import torch

    from metalpathtracer_torch.parallel import worker

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worker.run_rank(json.loads(Path(spec_file).read_text()), rank, around=counted_path)
    return 0


def phase_ranks(sharded_cli, after_two, card, cards=1):
    """14c: the jobs of `rank_jobs` in a world of one rank and in a world of
    several, each rank a child of this script: two ranks that share cuda:0
    and join by gloo, or with `cards` > 1 one rank on each of that many
    cards, joined by nccl."""
    import numpy as np
    import torch

    from metalpathtracer_torch.parallel import worker

    ranks = 2 if cards == 1 else cards
    where = "on the one card" if cards == 1 else f"on {cards} cards (nccl)"
    record = {}
    for key, world in (("alone", 1), ("together", ranks)):
        tag = f"world{world}"
        out = OUT / tag
        if out.exists():
            for f in out.iterdir():
                f.unlink()
        spec = dict(world=world, store=str(out / "store"),
                    backend="gloo" if cards == 1 else "nccl",
                    device="cuda:0" if cards == 1 else "cuda",
                    timeout_s=RANK_TIMEOUT_S, threads=4,
                    out_dir=str(out), jobs=rank_jobs(tag))
        wall = worker.launch(spec, WORLD_LIMIT_S, command=[
            sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank"])
        rec = dict(wall_s=wall)
        for job in spec["jobs"]:
            name = job["name"]
            results = [worker.load_result(out, name, r) for r in range(world)]
            launches = {k: sum(res["counts"][k] for res in results)
                        for k in ("steps", "mm_launches", "cull_launches",
                                  "threefry_launches", "threefry_draws",
                                  *SHADING_KEYS, *REGEN_KEYS)}
            by_rank = [res["counts"]["mm_launches"] for res in results]
            if job["kind"] == "cli":
                if any(res["rc"] != 0 for res in results) or any(
                        res["stdout"] for res in results[1:]):
                    raise RuntimeError(f"{tag} {name}: a rank failed or rank > 0 wrote")
                stats = json.loads(results[0]["stdout"].strip().splitlines()[-1])
                mine = radiance(OUT / f"{tag}_{name}.npz")
                want = radiance(OUT / f"tile_shard_{name}.npz")
                # the scan's subgroups are 128 pixels in a row on any layout
                if name == "scan" and not np.array_equal(mine, want):
                    raise RuntimeError(f"{tag} scan: the image differs from the "
                                       "world of one's")
                differing = same_but_ties(mine, want, f"{tag} {name} vs a world of one")
                if stats["rays"] != sharded_cli[name]["stats"]["rays"]:
                    raise RuntimeError(f"{tag} {name}: {stats['rays']} rays")
                rec[name] = dict(seconds=stats["seconds"], rays=stats["rays"],
                                 launches=launches, mm_launches_by_rank=by_rank,
                                 pixels_differing=differing)
                (OUT / f"{tag}_{name}.npz").unlink()  # 6 MB each: compared, not kept
            else:
                for res in results:
                    if res["spp"] != 2 * CONFIG5_STEP or not torch.equal(
                            res["rgb_sum"], results[0]["rgb_sum"]):
                        raise RuntimeError(f"{tag} {name}: the ranks hold different "
                                           "accumulations")
                differing = same_but_ties(
                    results[0]["rgb_sum"].numpy(), after_two.numpy(),
                    f"{tag} {name} vs phase 14b after two steps")
                rec[name] = dict(seconds=sum(results[0]["seconds"]),
                                 step_s=results[0]["seconds"],
                                 rays=sum(results[0]["rays"]), launches=launches,
                                 mm_launches_by_rank=by_rank,
                                 pixels_differing=differing)
        for f in out.glob("*.pt"):  # 25 MB a rank: not kept among the artifacts
            f.unlink()
        record[key] = rec
    for name in ("scan", "wavefront", "config5"):
        one, more = record["alone"][name], record["together"][name]
        if one["rays"] != more["rays"]:
            raise RuntimeError(f"{ranks} ranks {name}: rays {more['rays']} vs "
                               f"{one['rays']}")
        log(f"[14c] {name}: one rank alone {one['seconds']:.3f} s "
            f"({one['launches']['mm_launches']} launches of each kernel), {ranks} "
            f"ranks {where} together {more['seconds']:.3f} s (mm_closest_hit "
            f"{' + '.join(map(str, more['mm_launches_by_rank']))} = "
            f"{more['launches']['mm_launches']}, cull_tile_lists "
            f"{more['launches']['cull_launches']}, threefry "
            f"{more['launches']['threefry_launches']}), {more['rays']} rays, "
            f"{more['pixels_differing']} pixels differ from the world of one's "
            f"({one['pixels_differing']} of the lone rank's); {card}")
    log(f"[14c] whole worlds with start-up and uploads: one rank "
        f"{record['alone']['wall_s']:.1f} s, {ranks} ranks "
        f"{record['together']['wall_s']:.1f} s")
    return record


def phase_rank_balance(card, passes: int = 8, warm: int = 3) -> dict:
    """14d: each rank's own work in config 5's pass (CONFIG5_STEP spp, POOL
    lanes) over SHARD_TILES tile ranks, rank after rank on the one card (a
    rank's trace calls no collective, so it is the same on any card):
    the rays, tile passes and seconds a pass of the dealt rows
    (`shard_render_wavefront`, counted by `sharding.STATS`) and of the
    contiguous row block each rank traced before (`trace_wavefront` over
    rows r H / n .. (r + 1) H / n - 1), `passes` passes after `warm`, the
    sample ids continuing. Raises unless the dealt rows' busiest rank is
    within 5% of the ranks' mean in rays and in tile passes."""
    import statistics

    import torch

    from metalpathtracer_torch.core import rng
    from metalpathtracer_torch.parallel import sharding
    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig, trace_wavefront
    from metalpathtracer_torch.scene import load_scene_xml

    scene = upload_scene(load_scene_xml(str(ROOT / "scenes" / "multimesh.xml")), "cuda")
    (w, h), n, spp = CONFIG5_SIZE, SHARD_TILES, CONFIG5_STEP
    cfg, cam, n_local = RenderConfig(max_depth=CONFIG5_DEPTH), Camera.reset(), h // n * w

    def block(r, k):
        _, rays, stats = trace_wavefront(
            scene, cam, w, h, spp, rng.seed_from_int(5), cfg, POOL, sample_offset=k * spp,
            pixel_offset=r * n_local, n_pixels=n_local)
        return rays, stats["tile_passes"]

    def dealt(r, k):
        before = dict(sharding.STATS)
        sharding.shard_render_wavefront(scene, cam, w, h, spp, 5, cfg, POOL, tile_index=r,
                                        n_tiles=n, sample_offset=k * spp)
        return (sharding.STATS["rays"] - before["rays"],
                sharding.STATS["tile_passes"] - before["tile_passes"])

    record = {}
    for layout, fn in (("blocks", block), ("dealt", dealt)):
        ranks = []
        for r in range(n):
            rays, tiles, ms = [], [], []
            for k in range(warm + passes):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(r, k)
                torch.cuda.synchronize()
                if k >= warm:
                    ms.append((time.perf_counter() - t0) * 1e3)
                    rays.append(got[0])
                    tiles.append(got[1])
            ranks.append(dict(rays=statistics.mean(rays), tile_passes=statistics.mean(tiles),
                              ms=statistics.median(ms), ms_min=min(ms), ms_max=max(ms)))
        graphs.clear()
        ratio = {k: max(p[k] for p in ranks) / statistics.mean(p[k] for p in ranks)
                 for k in ("rays", "tile_passes", "ms")}
        record[layout] = dict(per_rank=ranks, max_over_mean=ratio)
        log(f"[14d] config 5's pass over {n} ranks, {layout}, each rank's own trace a pass "
            f"(mean of {passes}; ms median, min-max): " + "; ".join(
                f"rank {r} {p['rays']:.0f} rays, {p['tile_passes']:.2f} tile passes, "
                f"{p['ms']:.2f} ms ({p['ms_min']:.2f}-{p['ms_max']:.2f})"
                for r, p in enumerate(ranks))
            + "; busiest / mean: " + ", ".join(f"{k} {v:.3f}" for k, v in ratio.items())
            + f"; {card}")
    if max(record["dealt"]["max_over_mean"][k] for k in ("rays", "tile_passes")) > 1.05:
        raise RuntimeError(f"[14d] dealt rows off balance: {record['dealt']['max_over_mean']}")
    del scene
    torch.cuda.empty_cache()
    return record


def config4_camera():
    """Config 4's camera (`benchmarks/run_configs.py`)."""
    from metalpathtracer_torch.render.camera import Camera

    return Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


def phase_nee(card):
    """15: NEE + Russian roulette renders on the card against the same
    renders on the CPU."""
    import torch

    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.kernels import _build
    from metalpathtracer_torch.render.pipeline import (
        render_image,
        render_image_wavefront,
    )
    from metalpathtracer_torch.scene import load_scene_xml

    def both(name):
        host = load_scene_xml(str(ROOT / "scenes" / name))
        return upload_scene(host, "cuda"), upload_scene(host, "cpu")

    record = {}
    # config 4 of benchmarks/run_configs.py, spp cut from 1024 to 2
    cam = config4_camera()
    cfg = RenderConfig(max_depth=16, nee=True, rr_start=3)
    on_card, on_cpu = both("cornell_glass.xml")
    torch.cuda.synchronize()
    _build.zero_tallies()
    t0 = time.perf_counter()
    a, ra = render_image(on_card, cam, 512, 512, 2, seed=4, cfg=cfg)
    a = a.cpu().numpy()
    card_s = time.perf_counter() - t0
    mm_n, cull_n, bundles, draws = executed()  # on the card, replays too
    sph_n, epi_n, hit_n, bank_hit_n = executed_shading()
    if mm_n or cull_n:
        raise RuntimeError("cornell_glass has no triangle, yet a kernel was launched")
    if bundles == 0:
        raise RuntimeError("config 4 launched no RNG kernel")
    # NEE shades in plain torch, by config: the closest hit (the sphere pass,
    # the front end's kernel without operands, and the epilogue) twice a
    # step, the shading kernels never
    if hit_n or bank_hit_n or not sph_n == epi_n > 0 or sph_n % 2:
        raise RuntimeError(f"config 4: {SHADING} launches "
                           f"{(sph_n, epi_n, hit_n, bank_hit_n)}")
    t0 = time.perf_counter()
    b, rb = render_image(on_cpu, cam, 512, 512, 2, seed=4, cfg=cfg)
    cpu_s = time.perf_counter() - t0
    frac, dmean = compare_images(a, b.numpy(), "config 4 (NEE, rr_start 3) card vs CPU")
    if not a.mean() > 0.05 or abs(ra - rb) > 0.01 * rb:
        raise RuntimeError(f"config 4: mean {a.mean()}, rays {ra} vs {rb}")
    record["config4"] = dict(card_s=card_s, cpu_s=cpu_s, rays=ra, cpu_rays=rb,
                             divergent=frac, mean_diff=dmean, threefry_launches=bundles,
                             threefry_draws=draws, front_launches=sph_n,
                             epilogue_launches=epi_n, shade_hit_launches=hit_n,
                             shade_bank_hit_launches=bank_hit_n)
    log(f"[15] config 4 (cornell_glass, NEE, rr_start 3) 512x512 spp 2 depth 16: "
        f"{card_s:.3f} s on the card ({card}), {cpu_s:.1f} s on the CPU; {ra} vs {rb} "
        f"rays; {frac:.5f} of pixels differ by > 1e-3, means by {dmean:.2e}; no "
        f"tile kernel launched (spheres alone), threefry {bundles} launches, "
        f"{draws} draws, hit_front {sph_n} (as the sphere pass), hit_epilogue {epi_n}, "
        f"shade_hit {hit_n}, shade_bank_hit {bank_hit_n} (NEE shades in plain torch)")

    # a scene with triangles and a light: the shadow rays go through the kernels
    cfg = RenderConfig(max_depth=8, nee=True, rr_start=3)
    on_card, on_cpu = both("multimesh.xml")
    for name, fn in (("scan", render_image), ("wavefront", render_image_wavefront)):
        kwargs = dict(return_stats=True) if name == "wavefront" else {}
        with counted_path() as counts:
            t0 = time.perf_counter()
            out = fn(on_card, Camera.reset(), 320, 180, 2, seed=4, cfg=cfg, **kwargs)
            a = out[0].cpu().numpy()
            card_s = time.perf_counter() - t0
        b = fn(on_cpu, Camera.reset(), 320, 180, 2, seed=4, cfg=cfg)
        frac, dmean = compare_images(a, b[0].numpy(), f"multimesh NEE {name} card vs CPU")
        if abs(out[1] - b[1]) > 0.01 * b[1]:
            raise RuntimeError(f"multimesh NEE {name}: rays {out[1]} vs {b[1]}")
        shadow = out[2]["shadow_rays"] if name == "wavefront" else None
        if shadow is not None and not 0 < shadow < out[1]:
            raise RuntimeError(f"multimesh NEE wavefront: {shadow} shadow rays")
        # each closest hit (the step's and its shadow ray's) runs the front
        # end and the epilogue; the shading is plain torch
        if counts["shade_hit_launches"] or counts["shade_bank_hit_launches"] or not (
                counts["front_launches"] == counts["epilogue_launches"]
                == counts["mm_launches"] > 0) or counts["nee_steps"] != counts["steps"]:
            raise RuntimeError(f"multimesh NEE {name}: {counts}")
        record[f"multimesh_{name}"] = dict(card_s=card_s, rays=out[1], cpu_rays=b[1],
                                           shadow_rays=shadow, counts=counts,
                                           divergent=frac, mean_diff=dmean)
        log(f"[15] multimesh NEE, rr_start 3, {name} 320x180 spp 2 depth 8: "
            f"{card_s:.3f} s on the card, {out[1]} vs {b[1]} rays"
            + (f" ({shadow} shadow rays)" if shadow is not None else "")
            + f", launches: mm_closest_hit {counts['mm_launches']}, cull_tile_lists "
            f"{counts['cull_launches']}, threefry {counts['threefry_launches']} "
            f"({counts['threefry_draws']} draws), {shading_text(counts)}, "
            f"{counts['steps']} bounce steps traced ({counts['nee_steps']} on the plain "
            f"NEE shading); {frac:.5f} of pixels differ by > 1e-3, means by {dmean:.2e}")
    torch.cuda.empty_cache()
    return record


def config4_draws():
    """The bundle of config 4's first bounce step (the reference's
    `benchmarks/run_configs.py` config 4: `scenes/cornell_glass.xml` at
    512x512 with NEE and `rr_start` 3, so five draws), and its jitter."""
    import torch

    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.scene import load_scene_xml

    scene = upload_scene(load_scene_xml(str(ROOT / "scenes" / "cornell_glass.xml")),
                         "cuda")
    draws = []
    primary_and_bounce(scene, 512, 512, draws=draws, cam=config4_camera(),
                       cfg=RenderConfig(max_depth=16, nee=True, rr_start=3))
    torch.cuda.synchronize()
    return draws


def draw_sets(scan_draws, pool_draws, of_viewer, config4):
    """Phase 16's bundles by name: the probe's call (a bundle of one) and
    those captured (the scan's 921,600-lane jitter and first bounce step,
    the flagship's advance at call CAPTURE_CALL, a viewer frame's pool call
    5 and drain call 1, config 4's first bounce step)."""
    import torch

    dev = pool_draws[0][1].device
    probe = torch.arange(1024, dtype=torch.int32, device=dev).reshape(8, 128)
    sets = {"probe": (42, probe, 3, 0, ((7, "unit_vector"),))}
    for where, draws in (("scan", scan_draws), ("pool", pool_draws),
                         *((k, v[2]) for k, v in of_viewer.items()),
                         ("config4", config4)):
        for args in draws:
            name = f"{where}_" + "+".join(PURPOSE_NAMES.get(p, str(p))
                                          for p, _ in args[4])
            while name in sets:
                name += "'"
            sets[name] = args
    return sets


def draw_bound(args, tsass):
    """The least time of one `threefry_bundle` call: its bytes (each tensor
    operand read once, every draw's output written once) at the memory
    rate, and what every lane issues (`lane_issue` of the kernel built for
    the bundle's counter blocks) at the pipes' rates on every SM at the
    card's top SM clock."""
    import math

    import torch

    from metalpathtracer_torch.render.kernels import threefry as tfk

    lanes = [v for v in args[1:4] if isinstance(v, torch.Tensor)]
    n = math.prod(tfk._broadcast_shapes(v.shape for v in lanes))
    draws = args[4]
    nbytes = sum(v.numel() * v.element_size() for v in lanes) + n * 4 * sum(
        tfk.ROWS[mode] for _, mode in draws)
    blocks = sum(2 if mode == "triple" else 1 for _, mode in draws)
    lane = lane_issue(tsass["per_blocks"][blocks])
    op_ms = n * lane["clocks"] / (H100_SMS * tsass["clock_hz"]) * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(lanes=n, bytes=nbytes, lane_issue=lane, bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes")


def separate_calls(args):
    """A bundle's draws as the launches before the bundle made them: one
    bundle of one each, a "single" drawn as a pair (`uniform1` took a
    pair's first row). Returns (launch all, the outputs to compare with
    the bundle's)."""
    from metalpathtracer_torch.render.kernels import threefry as tfk

    seed, pix, sample, bounce, draws = args

    def launch():
        outs = [tfk.threefry(seed, pix, sample, bounce, purpose,
                             "pair" if mode == "single" else mode)
                for purpose, mode in draws]
        return [o[0] if mode == "single" else o for o, (_, mode) in zip(outs, draws)]

    return launch


def phase_threefry(sets, tsass):
    """16: `threefry_bundle` vs its plain twin at every captured bundle:
    uniforms bit-equal, unit vectors bit-equal or within 4 ulp of 1.0 (the
    gap stated); each timed on the device, per call and plain, and a bundle
    of several draws also as separate launches (`separate_calls`)."""
    import torch

    from metalpathtracer_torch.render.kernels import threefry as tfk

    ulp = float(torch.finfo(torch.float32).eps)
    record = {}
    for name, args in sets.items():
        launches = tfk.threefry_bundle.launches
        got = tfk.threefry_bundle(*args)
        if tfk.threefry_bundle.launches != launches + 1:
            raise RuntimeError(f"threefry {name}: the bundle made "
                               f"{tfk.threefry_bundle.launches - launches} launches")
        want = tfk.threefry_bundle_reference(*args)
        torch.cuda.synchronize()
        differ, err = 0, 0.0
        for (purpose, mode), g, w in zip(args[4], got, want):
            if g.shape != w.shape:
                raise RuntimeError(f"threefry {name} ({purpose}, {mode}): shape "
                                   f"{tuple(g.shape)} vs {tuple(w.shape)}")
            bad = int((g != w).sum())
            e = float((g - w).abs().max()) if bad else 0.0
            if bad and (mode != "unit_vector" or e > 4 * ulp):
                raise RuntimeError(f"threefry {name} ({purpose}, {mode}): {bad} values "
                                   f"differ from the twin, by at most {e:.3g}")
            differ, err = differ + bad, max(err, e)
        k_ms = device_ms(lambda: tfk.threefry_bundle(*args))
        c_ms = call_ms(lambda: tfk.threefry_bundle(*args), 20)
        p_ms = call_ms(lambda: tfk.threefry_bundle_reference(*args), 3)
        b = draw_bound(args, tsass)
        rec = dict(draws=[list(d) for d in args[4]], differ=differ, max_abs_err=err,
                   max_ulp=err / ulp, ms=k_ms, call_ms=c_ms, plain_ms=p_ms, **b,
                   share=b["bound_ms"] / k_ms)
        line = ""
        if len(args[4]) > 1:
            launch = separate_calls(args)
            for g, s in zip(got, launch()):
                if not torch.equal(g, s):
                    raise RuntimeError(f"threefry {name}: a separate draw differs "
                                       "from the bundle's")
            rec["separate_ms"] = device_ms(launch)
            line = (f"; as {len(args[4])} separate launches "
                    f"{rec['separate_ms'] * 1e3:.2f} us on the device")
        record[name] = rec
        kinds = ", ".join("int" if isinstance(v, int) else
                          f"{str(v.dtype)[6:]}{tuple(v.shape)}" for v in args[1:4])
        lane = b["lane_issue"]
        log(f"    threefry {name} ("
            + ", ".join(mode for _, mode in args[4])
            + f"; {b['lanes']} lanes; pixel, sample, bounce: {kinds}): "
            + ("bit-equal to the twin" if not differ else
               f"{differ} values differ by at most {err / ulp:.1f} ulp of 1.0")
            + f"; kernel {k_ms * 1e3:.2f} us on the device, {c_ms * 1e3:.2f} us per "
            f"call, twin {p_ms:.3f} ms; bound {b['bound_ms'] * 1e3:.2f} us "
            f"({b['bound_by']}: {b['bytes']} bytes; a lane issues {lane['alu']} int32 "
            f"ALU, {lane['fma']} IMAD, {lane['issued']} in all), "
            f"{100 * b['bound_ms'] / k_ms:.1f}% of it reached" + line)
        if b["bound_ms"] > k_ms:
            raise RuntimeError(f"threefry {name}: the kernel took {k_ms * 1e3:.2f} us, "
                               f"less than its bound {b['bound_ms'] * 1e3:.2f} us: "
                               f"the bound counts more than the call must do")
    return record


# ---------------------------------------------------------------------------
# 17: the wavefront's windows as CUDA graphs against the eager loop
# ---------------------------------------------------------------------------

GRAPH_REPEATS = 3  # timed renders of each loop, in turns
# the wavefront viewer's frames (key after half of them): its eager loop
# runs ~3 frames a second, the most expensive path of the phase
GRAPH_VIEWER_FRAMES = 30
# the `mm_closest_hit` call of a captured flagship window whose kernels are
# held against their plain versions
GRAPH_CALL = 5
# the flagship's counts (PERF.md): mm_closest_hit, cull_tile_lists, threefry;
# on the wavefront and on the scan (4 samples of 32 bounce steps, each with a
# live lane, and a jitter bundle a sample)
# (the restart draws the wavefront's jitter itself: threefry launches one
# bundle a bounce step, 408, where it launched 817 with the jitter's 409)
FLAGSHIP_LAUNCHES = (408, 408, 408)
# the flagship wavefront's restarts (408 advances and the start's) and its
# sorts' keys and gathers (one every four advances); its queue pops are
# those of the advances before the drain
FLAGSHIP_RESTARTS, FLAGSHIP_SORTS = 409, 102
SCAN_FLAGSHIP_LAUNCHES = (128, 128, 132)


# f32 operations a lane (and a sphere) of the bounce step's kernels, counted
# from their sources (csrc/sphere_pass.cu, hit_epilogue.cu, shade.cu): the
# quadratic of one sphere, d.d once; the front end's features (o x d, o.d,
# |o|^2) and occlusion bound; the epilogue's two normals, plane refine and
# flip; the shading of a lane that hit (material, emission, the three lobes
# and the Fresnel choice, offset, roulette) and of every lane (the sky); the
# bank's clamp and its accumulator adds (3 a pixel of the item)
SPHERE_FLOP, SPHERE_LANE_FLOP = 30, 5
FRONT_LANE_FLOP = 20
EPILOGUE_FLOP = 50
SHADE_HIT_FLOP, SHADE_LANE_FLOP = 260, 15
BANK_LANE_FLOP = 3


def shading_bound(kernel: str, args) -> dict:
    """The least time of one call of a bounce-step wrapper's kernel on the
    card: the bytes it must move (each input once, each output once; the
    refine rows and material rows it reads counted as the distinct rows
    these inputs need, the shading's per-hit inputs on the lanes that hit
    here) at the memory rate, and its operations (f32, counted from the
    source; the shading's per-hit work on the lanes that hit here) at the
    f32 peak."""
    import torch

    n = args[0].shape[0]
    if kernel == "sphere_pass":
        s = args[2].shape[0]
        nbytes = 24 * n + 20 * s + 12 * n
        flop = n * (SPHERE_LANE_FLOP + SPHERE_FLOP * s)
    elif kernel == "hit_front":
        # o, d; active and occ_t where given; the spheres; t, idx and slot;
        # x, act and occ on every padded lane
        active, occ_t, s = args[2], args[3], args[4].shape[0]
        n_pad = n + (-n) % 128
        nbytes = (24 * n + (n if active is not None else 0)
                  + (4 * n if occ_t is not None else 0) + 20 * s + 12 * n
                  + 56 * n_pad)
        flop = n * (SPHERE_LANE_FLOP + SPHERE_FLOP * s + FRONT_LANE_FLOP)
    elif kernel == "hit_epilogue":
        t_tri, col, s = args[2], args[3], args[8].shape[0]
        rows = int(col.clamp(min=0).unique().numel()) if col is not None else 0
        nbytes = (24 * n + (8 * n if t_tri is not None else 0) + 12 * n + 32 * rows
                  + 16 * s + 25 * n)
        flop = n * EPILOGUE_FLOP
    else:  # `shade_hit`, and with the bank `shade_bank_hit`
        # every lane reads its state (o, d, light, throughput: 48 B; active,
        # prev_pdf: 5 B) and writes 53 B; a live lane reads the winners (the
        # sphere pass's t, id and slot: 12 B; the triangle kernel's t and
        # column: 8 B) and, where a triangle won the pass, its refine row
        # (32 B, counted as the distinct rows); a lane that hit reads its
        # draws (unit vector, Fresnel uniform: 16 B; with roulette its
        # uniform, and a bounce a lane) and its material row (the distinct
        # rows); the epilogue's work on the lanes that hit. With the bank
        # every lane also reads its bounce, alive flag, schunk and
        # accumulator and writes them back with its more and bank flags
        from metalpathtracer_torch.render.kernels import intersect_mm as tmm
        from metalpathtracer_torch.render.kernels import shade as tsh

        active, t_tri, col, s = args[4], args[6], args[7], args[12].shape[0]
        u_rr, bounce = args[17], args[tsh.BOUNCE_ARG]
        bank = kernel == "shade_bank_hit"
        idx, mat_id = tmm.hit_epilogue(args[0], args[1], *args[6:15])[1::3]
        hits_mask = active & (idx >= 0)
        hits = int(hits_mask.sum())
        live = int(active.sum())
        rows = int(mat_id[hits_mask].unique().numel())
        tri_rows = (int(col[active & (col >= 0)].unique().numel())
                    if col is not None else 0)
        per_hit = 16
        if u_rr is not None:
            per_hit += 4
            if not bank and isinstance(bounce, torch.Tensor) and bounce.numel() == n > 1:
                per_hit += bounce.element_size()
        nbytes = (53 * n + live * (12 + (8 if t_tri is not None else 0))
                  + 32 * tri_rows + 16 * s + per_hit * hits + 64 * rows + 24
                  + 53 * n + 8)
        flop = hits * (SHADE_HIT_FLOP + EPILOGUE_FLOP) + n * SHADE_LANE_FLOP
        if bank:
            ka = args[-1][2].shape[1]  # the bank, last
            nbytes += n * (8 + 1 + 8 + 4 * ka) + n * (4 * ka + 8 + 8 + 1 + 1)
            flop += n * (BANK_LANE_FLOP + ka)
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flop / PEAK_F32_FLOPS * 1e3
    return dict(bytes=nbytes, flop=flop, bound_ms=max(byte_ms, flop_ms),
                bound_by="bytes" if byte_ms >= flop_ms else "operations")


def bounce_kernel_vs_twin(kernel: str, args, what: str) -> dict:
    """One call of a bounce-step wrapper's kernel (`kernel` names the
    call, SHADING_CALLS) against its twin on the same inputs: bit for
    bit (NaN where both are NaN: a lane that misses has a NaN normal on
    both), then its device time, call time, the twin's call time and the
    bound."""
    import torch

    wrapper = call_wrapper(kernel)
    module = wrapper_module(wrapper)
    fn, twin = getattr(module, wrapper), getattr(module, f"{wrapper}_reference")
    got, want = fn(*args), twin(*args)
    torch.cuda.synchronize()
    bad, err = 0, 0.0
    for a, b in zip(got, want):
        if a.dtype.is_floating_point:
            bad += int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())
            both = torch.isfinite(a) & torch.isfinite(b)
            if bool(both.any()):
                err = max(err, float((a[both] - b[both]).abs().max()))
        else:
            bad += int((a != b).sum())
    if bad:
        raise RuntimeError(f"[18] {kernel} vs its twin ({what}): {bad} values differ, "
                           f"max |difference| {err}")
    ms = device_ms(lambda: fn(*args))
    c_ms = call_ms(lambda: fn(*args), 20)
    p_ms = call_ms(lambda: twin(*args), 3)
    b = shading_bound(kernel, args)
    rec = dict(lanes=args[0].shape[0], ms=ms, call_ms=c_ms, plain_ms=p_ms,
               max_abs_err=err, **b, share=b["bound_ms"] / ms)
    log(f"    {kernel} vs twin ({what}, {rec['lanes']} lanes): bit-equal; kernel "
        f"{ms * 1e3:.2f} us on the device, {c_ms * 1e3:.2f} us per call, twin "
        f"{p_ms:.3f} ms; bound {b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}: "
        f"{b['bytes'] / 1e6:.1f} MB, {b['flop'] / 1e6:.1f} Mflop), "
        f"{100 * rec['share']:.1f}% of it reached")
    return rec


def bank_operands_of(shade_args, seed: int = 18):
    """A `shade_bank_hit` call's operands from a `shade_hit` call's: its
    bounce one a lane (int64), and the bank last: lanes alive where they are
    active and on a quarter of the others, random item chunks and
    accumulators, and the flagship's plan (depth 32, 4 pixels an item, 4
    samples a pixel)."""
    import torch

    from metalpathtracer_torch.render.kernels import shade as tsh

    at = tsh.BOUNCE_ARG
    o, active, bounce = shade_args[0], shade_args[4], shade_args[at]
    n, dev = o.shape[0], o.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if not isinstance(bounce, torch.Tensor) or bounce.numel() != n:
        bounce = torch.full((n,), int(bounce), dtype=torch.int64, device=dev)
    plan = tsh.BankPlan(32, False, 4, 4, 16)
    alive = active | (torch.rand(n, generator=gen, device=dev) < 0.25)
    schunk = torch.randint(0, plan.per_item, (n,), generator=gen, device=dev)
    acc = torch.rand((n, 3 * plan.bank_k), generator=gen, device=dev) * 3.0
    return (*shade_args[:at], bounce.to(torch.int64), *shade_args[at + 1:],
            (alive, schunk, acc, plan))


def complete_shading_set(calls: dict) -> dict:
    """A bounce step's recorded shading calls completed to every bounce
    kernel at its shape: where the step shaded from the winners
    (`shade_hit` or `shade_bank_hit`), the epilogue's call at those
    winners and the other of the two shading calls (the bank dropped, or
    made by `bank_operands_of`)."""
    calls = dict(calls)
    if "shade_bank_hit" in calls and "shade_hit" not in calls:
        calls["shade_hit"] = calls["shade_bank_hit"][:-1]
    if "shade_hit" in calls and "shade_bank_hit" not in calls:
        calls["shade_bank_hit"] = bank_operands_of(calls["shade_hit"])
    if "shade_hit" in calls:
        hit_args = calls["shade_hit"]
        calls.setdefault("hit_epilogue", (hit_args[0], hit_args[1], *hit_args[6:15]))
    return calls


def padded_front_of(front_args, drop: int = 77, seed: int = 18):
    """`hit_front`'s operands for all but the last `drop` lanes of a call's
    rays (not whole 128-lane subgroups), with a random active mask and
    occlusion bound."""
    import torch

    o, d = front_args[0], front_args[1]
    n, dev = o.shape[0] - drop, o.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    active = torch.rand(n, generator=gen, device=dev) < 0.75
    occ_t = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                        torch.rand(n, generator=gen, device=dev) * 200.0, float("inf"))
    return (o[:n].contiguous(), d[:n].contiguous(), active, occ_t, *front_args[4:])


def phase_bounce_kernels(sets: dict) -> dict:
    """18: the bounce step's kernels (`csrc/sphere_pass.cu`'s front end and
    sphere pass, `hit_epilogue.cu`, `shade.cu`'s shading without and with
    the bank) against their twins at the calls the paths make (`sets`: name
    -> {call name (SHADING_CALLS): args}), each bit-equal, with its device,
    call and plain time and its bound."""
    record = {}
    for name, calls in sets.items():
        for call in SHADING_CALLS:
            if calls.get(call) is not None:
                record[f"{name}_{call}"] = dict(
                    set=name, kernel=CALL_KERNEL[call], wrapper=call,
                    **bounce_kernel_vs_twin(call, calls[call], name))
    return record


@contextlib.contextmanager
def recorded_in_capture(call: int):
    """The kernels wrapped: while a CUDA graph is being captured, the
    `call`-th `mm_closest_hit` call's arguments and outputs are cloned, with
    those of the `_cull_tile_lists` and `hit_front` calls before it and of the
    first `hit_epilogue`, `threefry_bundle` and `shade_hit` calls after it
    (its bounce step's); on a scene without triangles, which
    launches no tile kernel, the `call`-th bundle of more than one draw (a
    bounce step's), and the `call`-th sphere pass and hit epilogue. The
    clones are made inside the capture, so they are outputs of the graph:
    after a replay they hold what that replay computed. Yields {kernel or
    wrapper: (args, outputs)}, filled as the capture runs."""
    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import threefry as tfk

    kernels = tmm.mm_closest_hit, tmm._cull_tile_lists, tfk.threefry_bundle
    shading_kernels = {k: getattr(wrapper_module(k), k) for k in WRAPPER_KERNEL}
    got, seen = {}, {"mm": 0, "cull": None, "steps": 0, "hit_front": None,
                     "sphere_calls": 0}

    def shaded(kernel):
        def wrapped(*args, **kw):
            out = shading_kernels[kernel](*args, **kw)
            name, call_args = as_call(kernel, shading_kernels[kernel], args, kw)
            if torch.cuda.is_current_stream_capturing() and name not in got:
                if kernel == "hit_front":
                    seen["hit_front"] = _clone(args), _clone(out)
                elif kernel == "sphere_pass":
                    seen["sphere_calls"] += 1
                    if seen["mm"] == 0 and seen["sphere_calls"] == call:
                        got["sphere_pass"] = _clone(args), _clone(out)
                elif "mm" in got or (kernel == "hit_epilogue" and "sphere_pass" in got):
                    got[name] = _clone(call_args), _clone(out)
            return out
        wrapped.launches = 0
        return wrapped

    def cull(*args, **kw):
        out = kernels[1](*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            seen["cull"] = _clone(args), _clone(out)
        return out

    def mm(*args, **kw):
        out = kernels[0](*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            seen["mm"] += 1
            if seen["mm"] == call:
                got["mm"], got["cull"] = (_clone(args), _clone(out)), seen["cull"]
                got["hit_front"] = seen["hit_front"]
        return out

    def draw(*args, **kw):
        out = kernels[2](*args, **kw)
        if torch.cuda.is_current_stream_capturing() and "threefry" not in got:
            seen["steps"] += len(args[4]) > 1
            if "mm" in got or (seen["mm"] == 0 and seen["steps"] == call):
                got["threefry"] = _clone(args), _clone(out)
        return out

    mm.launches = mm.clustered = cull.launches = draw.launches = draw.draws = 0
    cull.routes = {"rank": 0, "radix": 0}
    graphs.clear()
    tmm.mm_closest_hit, tmm._cull_tile_lists, tfk.threefry_bundle = mm, cull, draw
    for k in WRAPPER_KERNEL:
        setattr(wrapper_module(k), k, shaded(k))
    try:
        yield got
    finally:
        tmm.mm_closest_hit, tmm._cull_tile_lists, tfk.threefry_bundle = kernels
        for k, fn in shading_kernels.items():
            setattr(wrapper_module(k), k, fn)
        graphs.clear()


# profiled renders of one path and loop, at most, until one is whole
PROFILE_ATTEMPTS = 3
# idle seconds inside the profile before and after the render
PROFILE_PAD_S = 0.1
# the kernels' names in the profiler's device events
KERNEL_EVENT_NAMES = ("mm_closest_hit_kernel", "cull_tiles_kernel", "threefry_kernel",
                      *(f"{k}_kernel" for k in SHADING))


def device_busy(fn, what: str) -> dict:
    """One `fn()` under torch.profiler (CUDA activity), the kernels'
    tallies zeroed before it: its wall time on the host clock (from the
    call to the end of its device work, the profiler's cost in it), the
    union of its device intervals (the kernels, copies and fills CUPTI
    records, of a graph replay as of eager launches), the sum of their
    durations, its device events, and the kernels' events by name
    (KERNEL_EVENT_NAMES) beside their tallies. The busy share is the union over the wall time,
    both of this one render.

    The profiler loses records: a whole graph replay's kernels may be
    missing from a profile, and a few events at a render's start or end
    (two profiles of one render differ by tens of events). A profile whose
    kernels' events fall short of their tallies is taken again, up
    to PROFILE_ATTEMPTS times, and the fullest is kept with its shortfall
    (`short`, by kernel; `lost`, every attempt's). More events than
    launches raises. The raw events are read (`kineto_results`): building
    the profiler's Python event list costs ~0.1 ms an event, minutes for a
    60-frame viewer run."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from metalpathtracer_torch.render.kernels import _build

    cuda = torch.autograd.DeviceType.CUDA
    best, lost = None, []
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        _build.zero_tallies()
        with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
            warnings.simplefilter("ignore")
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_PAD_S)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                time.sleep(PROFILE_PAD_S)
        spans = [(e.start_ns(), e.end_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda and not e.name().startswith(SPAN_PREFIX)]
        by_kernel = tuple(sum(k in name for _, _, name in spans)
                          for k in KERNEL_EVENT_NAMES)
        tallies = executed()[:3] + executed_shading()
        short = tuple(t - k for k, t in zip(by_kernel, tallies))
        if min(short) < 0:
            raise RuntimeError(f"[17] {what}: the profile holds {by_kernel} kernel "
                               f"events, the tallies {tallies} launches")
        lost.append(short)
        union, end = 0, None
        for start, stop, _ in sorted(spans):
            if end is None or start > end:
                union += stop - start
                end = stop
            elif stop > end:
                union += stop - end
                end = stop
        got = dict(wall_s=wall, busy_ms=union / 1e6,
                   kernel_ms=sum(t - s for s, t, _ in spans) / 1e6,
                   span_s=(max(t for _, t, _ in spans)
                           - min(s for s, _, _ in spans)) / 1e9,
                   events=len(spans), by_kernel=by_kernel, tallies=tallies,
                   short=short, attempts=attempt, lost=lost,
                   busy_share=union / 1e9 / wall)
        if best is None or sum(short) < sum(best["short"]):
            best = got
        if not any(short):
            break
    return best


def window_share(fn) -> dict:
    """One `fn()` on the graph loop without the profiler, a CUDA event
    recorded on the stream before and after each window or drain block:
    the render's wall time on the host clock and its windows' time on the
    device between their events. A replay is queued whole, so its events
    hold its kernels and the gaps between its nodes, not the host's work;
    their sum over the wall is an upper bound of the device's busy share in
    an unprofiled render, beside `device_busy`'s profiled one."""
    import torch

    from metalpathtracer_torch.render import graphs

    run, pairs = graphs.Entry.run, []

    def timed(entry, name):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run(entry, name)
        b.record()
        pairs.append((a, b))

    torch.cuda.synchronize()
    graphs.Entry.run = timed
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        graphs.Entry.run = run
    inside = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
    return dict(wall_s=wall, windows_s=inside, windows=len(pairs),
                share=inside / wall)


def graph_workloads(scene, bunny, multimesh):
    """Phase 17's paths: name -> fn() giving (the tensors both loops must
    give bit for bit, rays or None, per-frame launches or None)."""
    from metalpathtracer_torch.parallel import sharding
    from metalpathtracer_torch.render import pipeline as tpipe
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.integrator import RenderConfig

    cam = Camera.reset()

    def flagship():
        img, rays = tpipe.render_image_wavefront(
            scene, cam, 1280, 720, 4, seed=0, cfg=RenderConfig(max_depth=32),
            pool_size=POOL)
        return [img], rays, None

    def progressive():
        state, outs, rays = tpipe.init_accum(1280, 720, scene.device), [], 0
        for _ in range(4):
            state, r = tpipe.accumulate_wavefront(
                state, scene, cam, 1280, 720, 1, 0, RenderConfig(max_depth=32),
                pool_size=POOL)
            outs.append(state.rgb_sum)
            rays += r
        return outs, rays, None

    def viewer30():  # the eager loop takes ~0.3 s a frame: 30, not 60
        return viewer_frames(scene, "wavefront", GRAPH_VIEWER_FRAMES,
                             GRAPH_VIEWER_FRAMES // 2)

    def config5_step():
        mesh = sharding.make_mesh()
        state = sharding.init_accum_sharded(*CONFIG5_SIZE, mesh, multimesh.device)
        state, rays = sharding.accumulate_sharded(
            state, multimesh, cam, CONFIG5_STEP, seed=5,
            cfg=RenderConfig(max_depth=CONFIG5_DEPTH), mesh=mesh)
        return [state.rgb_sum], rays, None

    def bunny300k_leg():
        img, rays = tpipe.render_image_wavefront(
            bunny, cam, LEG_W, LEG_H, LEG_SPP, seed=0,
            cfg=RenderConfig(max_depth=LEG_DEPTH), pool_size=POOL)
        return [img], rays, None

    return {"flagship": flagship, "progressive_4x1spp": progressive,
            f"viewer_{GRAPH_VIEWER_FRAMES}_frames": viewer30,
            "config5_step": config5_step,
            "bunny300k_leg": bunny300k_leg}


def scan_shading(eager, run) -> tuple:
    """The bounce step's kernels' launches a scan render on the graph loop
    must make: the eager loop's (SHADING: front end, hit epilogue, shading)
    plus an eager bounce step's for every idle step its blocks ran."""
    steps, want = eager["stats"]["reads"], []
    for launched in eager["shading"]:
        per_step, rest = divmod(launched, steps)
        if rest:
            raise RuntimeError(f"{eager['shading']} shading launches in {steps} steps: "
                               "not a whole number a step")
        want.append(launched + run["stats"]["idle_steps"] * per_step)
    return tuple(want)


def scan_launches(eager, run, samples: int) -> tuple:
    """The launches a scan render on the graph loop must make: the eager
    loop's (`graphs.eager()`: a step and a read a bounce, no idle step)
    plus, for every idle step its blocks ran, what an eager bounce step
    launches: (closest hit, cull, threefry, draws) a step from the eager
    render, whose reads are its steps, after its one jitter bundle (of one
    draw) a sample."""
    steps, want = eager["stats"]["reads"], []
    for k, jitter in enumerate((0, 0, samples, samples)):
        per_step, rest = divmod(eager["launched"][k] - jitter, steps)
        if rest:
            raise RuntimeError(f"{eager['launched']} launches in {steps} steps and "
                               f"{samples} samples: not a whole number a step")
        want.append(eager["launched"][k] + run["stats"]["idle_steps"] * per_step)
    return tuple(want)


def graph_vs_eager(name, fn, card, samples=None, flagship=None, tiles=True):
    """One path on both loops: counted runs compared bit for bit and count
    for count, GRAPH_REPEATS timed renders of each in turns, the flagged
    synchronising calls inside windows or blocks, and the device's busy
    share. Every render's launches are read from the kernels' tallies (what
    ran on the card, replays included) and held to the eager loop's: equal
    on the wavefront; on the scan (`samples`, the samples a render traces)
    equal but for the idle steps its blocks ran past their last live lane
    (`scan_launches`). `flagship`: the launches the eager loop must make;
    `tiles`: whether the path launches the tile kernels (`counted_path`)."""
    import statistics

    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render.kernels import _build

    scan = samples is not None

    def once(eager):
        torch.cuda.synchronize()
        _build.zero_tallies()
        before = dict(graphs.STATS)  # not zeroed: `counted_path` reads it too
        with graphs.eager() if eager else contextlib.nullcontext():
            t0 = time.perf_counter()
            outs, rays, frames = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        return dict(outs=outs, rays=rays, frames=frames, s=secs, launched=executed(),
                    shading=executed_shading(), regen=executed_regen(),
                    stats={k: v - before[k] for k, v in graphs.STATS.items()})

    def same(a, b, what):
        if len(a["outs"]) != len(b["outs"]) or not all(
                torch.equal(x, y) for x, y in zip(a["outs"], b["outs"])):
            bad = [int((x != y).sum()) for x, y in zip(a["outs"], b["outs"])]
            raise RuntimeError(f"[17] {name}: {what}: the images differ at {bad} values")
        if a["rays"] != b["rays"] or (not scan and a["frames"] != b["frames"]):
            raise RuntimeError(f"[17] {name}: {what}: rays {a['rays']} vs {b['rays']}, "
                               f"per-frame launches differ")
        want = scan_launches(a, b, samples) if scan else a["launched"]
        if b["launched"] != want:
            raise RuntimeError(f"[17] {name}: {what}: the card ran {b['launched']} "
                               f"(closest hit, cull, threefry, draws), the eager loop "
                               f"{a['launched']}, {b['stats']['idle_steps']} idle steps: "
                               f"{want} expected")
        want = scan_shading(a, b) if scan else a["shading"]
        if b["shading"] != want:
            raise RuntimeError(f"[17] {name}: {what}: the card ran {b['shading']} "
                               f"{SHADING}, the eager loop "
                               f"{a['shading']}, {b['stats']['idle_steps']} idle steps: "
                               f"{want} expected")
        if b["regen"] != a["regen"] or (scan and any(a["regen"])):
            raise RuntimeError(f"[17] {name}: {what}: the card ran {b['regen']} {REGEN}, "
                               f"the eager loop {a['regen']}")

    graphs.clear()
    counted = {}
    for path in ("eager", "graph"):
        with counted_path(tiles) as counts, SyncCounter() as syncs:
            run = once(path == "eager")
        run.update(counts=counts, flagged=syncs.count, in_windows=syncs.in_windows,
                   windows=syncs.windows)
        counted[path] = run
    eager, graph = counted["eager"], counted["graph"]
    same(eager, graph, "counted graph run vs eager run")
    if flagship and (eager["launched"][:3] != flagship or graph["launched"] !=
                     eager["launched"]):
        raise RuntimeError(f"[17] {name}: launches {eager['launched']} eager, "
                           f"{graph['launched']} replayed; {flagship} expected on both")
    # the flagship's bounce steps (one closest hit each) each run the front
    # end and one shading kernel from the closest hit's winners, which runs
    # the epilogue itself: `shade_hit_kernel` on the scan,
    # `shade_bank_hit_kernel` on the wavefront (one bounce an advance); the
    # epilogue's own kernel runs no time
    steps = flagship[0] if flagship else 0
    want = (steps, 0, steps, 0) if scan else (steps, 0, 0, steps)
    if flagship and not (eager["shading"] == graph["shading"] == want):
        raise RuntimeError(f"[17] {name}: the bounce step's kernels {SHADING} ran "
                           f"{eager['shading']} eager, {graph['shading']} replayed; "
                           f"{want} expected on both")
    restarts, queue, keys, gathers = eager["regen"]
    if flagship and not scan and not (
            restarts == FLAGSHIP_RESTARTS and keys == gathers == FLAGSHIP_SORTS
            and 0 < queue < steps):
        raise RuntimeError(f"[17] {name}: the regeneration's kernels {REGEN} ran "
                           f"{eager['regen']}; {FLAGSHIP_RESTARTS} restarts and "
                           f"{FLAGSHIP_SORTS} sorts expected")
    # counted_path cleared the cache: this render warms up and captures the
    # graphs that the timed renders replay
    first = once(False)
    same(eager, first, "first graph render vs eager")
    times = {"eager": [], "graph": []}
    steady = None
    for r in range(GRAPH_REPEATS):
        for path in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            run = once(path == "eager")
            same(eager, run, f"repeat {r + 1} on the {path} loop")
            times[path].append(run["s"])
            if path == "graph":
                steady = run["stats"]
                if steady["captures"] or steady["eager_runs"]:
                    raise RuntimeError(f"[17] {name}: a repeat captured: {steady}")
    with SyncCounter() as syncs:
        once(False)
    replay_flagged = (syncs.in_windows, syncs.windows)
    reads = eager["stats"]["reads"]
    # a window, drain block or scan block (or, on the scan's eager loop, a
    # bounce step) is followed by one read; a scan sample's start and end
    # are not
    ends = 2 * samples if scan else 0
    if not (steady["replays"] == steady["reads"] + ends
            and eager["stats"]["eager_runs"] == reads + ends
            and (scan or steady["reads"] == reads)):
        raise RuntimeError(f"[17] {name}: host reads {steady} on the graph loop, "
                           f"{eager['stats']} on the eager loop")
    if eager["in_windows"] or replay_flagged[0]:
        raise RuntimeError(f"[17] {name}: flagged synchronising calls inside windows: "
                           f"eager {eager['in_windows']}, replays {replay_flagged[0]}")
    with graphs.eager():
        busy_e = device_busy(fn, f"{name}, eager")
    busy_g = device_busy(fn, f"{name}, replayed")
    windows = window_share(fn)
    for b, want in ((busy_e, eager), (busy_g, graph)):
        if b["tallies"] != want["launched"][:3] + want["shading"]:
            raise RuntimeError(f"[17] {name}: a profiled render launched {b['tallies']}, "
                               f"its loop's counted render {want['launched']}")
    med = {k: statistics.median(v) for k, v in times.items()}
    launched = dict(zip(("mm_launches", "cull_launches", "threefry_launches",
                         "threefry_draws"), eager["launched"]),
                    **dict(zip(SHADING_KEYS, eager["shading"])),
                    **dict(zip(REGEN_KEYS, eager["regen"])))
    idle = steady["idle_steps"]
    rec = dict(
        launched=launched, launched_graph=graph["launched"],
        shading_graph=graph["shading"], idle_steps=idle,
        steps=eager["counts"]["steps"],
        traced_steps_graph=graph["counts"]["steps"], counts_eager=eager["counts"],
        counts_graph=graph["counts"], rays=eager["rays"], tensors=len(eager["outs"]),
        eager_s=times["eager"], graph_s=times["graph"], eager_median_s=med["eager"],
        graph_median_s=med["graph"], speedup=med["eager"] / med["graph"],
        captures_first_render=first["stats"]["captures"],
        capture_s=first["stats"]["capture_s"], first_render_s=first["s"],
        reads_per_render=steady["reads"], reads_eager=reads,
        windows_per_render=steady["replays"],
        flagged_eager=eager["flagged"], flagged_in_windows_eager=eager["in_windows"],
        flagged_replays=syncs.count, flagged_in_windows_replays=replay_flagged[0],
        profile_eager=busy_e, profile_graph=busy_g, window_share=windows)
    if eager["frames"]:
        per = [statistics.median(f[k] for f in eager["frames"]) for k in range(3)]
        rec.update(frames=len(eager["frames"]), mm_per_frame=per[0],
                   cull_per_frame=per[1], threefry_per_frame=per[2],
                   fps_eager=len(eager["frames"]) / med["eager"],
                   fps_graph=len(eager["frames"]) / med["graph"])
    c = launched
    log(f"[17] {name}: graph vs eager bit-equal ({len(eager['outs'])} tensors, "
        f"{GRAPH_REPEATS + 2} renders a loop), rays {eager['rays']}; launches on the "
        f"card (eager loop): mm_closest_hit {c['mm_launches']}, "
        f"cull_tile_lists {c['cull_launches']}, threefry {c['threefry_launches']} "
        f"({c['threefry_draws']} draws), {shading_text(c)}, {regen_text(c)}"
        + (f", graph loop {graph['launched']} and {graph['shading']} with {idle} idle "
           f"steps past the last live lane" if scan
           else ", equal in every render of both loops")
        + f"; {rec['steps']} bounce steps "
        f"({rec['traced_steps_graph']} traced by the graph loop's first render)"
        + (f" ({rec['mm_per_frame']:g} / {rec['cull_per_frame']:g} / "
           f"{rec['threefry_per_frame']:g} a frame, median)" if eager["frames"] else "")
        + f"; seconds eager {med['eager']:.4f} ({min(times['eager']):.4f}-"
        f"{max(times['eager']):.4f}), graph {med['graph']:.4f} "
        f"({min(times['graph']):.4f}-{max(times['graph']):.4f}), "
        f"{rec['speedup']:.2f}x"
        + (f", {rec['fps_eager']:.2f} -> {rec['fps_graph']:.2f} frames a second"
           if eager["frames"] else "")
        + f"; first render {first['s']:.3f} s with {rec['captures_first_render']} "
        f"captures in {rec['capture_s']:.3f} s; host reads a render {reads} eager, "
        f"{steady['reads']} replayed ({steady['replays']} replays); flagged calls "
        f"inside windows or blocks 0 on both loops ({eager['flagged']} in the eager "
        f"render, {syncs.count} in a replayed one, all outside); profiled render: "
        + "; ".join(
            f"{k} {b['wall_s']:.4f} s, device busy {b['busy_ms']:.1f} ms "
            f"({b['events']} events; profile {b['attempts']} of up to "
            f"{PROFILE_ATTEMPTS} kept, its kernel events short of the tallies by "
            f"{b['short']}, each profile's {b['lost']}), "
            f"busy {100 * b['busy_share']:.1f}%"
            for k, b in (("eager", busy_e), ("replayed", busy_g)))
        + f"; unprofiled replayed render {windows['wall_s']:.4f} s, its "
        f"{windows['windows']} replays {windows['windows_s']:.4f} s on the device "
        f"between events ({100 * windows['share']:.1f}%, the busy share's upper "
        f"bound) ({card})")
    return rec


def phase_in_window(scene, sass, tsass, what="window", render=None, call=GRAPH_CALL):
    """17: inside one captured flagship window (or, with `render`, a scan
    render's captured bounce block, `what`), the closest hit, the cull and
    the bounce step's threefry bundle of call `call`, as the last replay
    computed them: each bit-equal to an eager launch of its kernel at the
    same inputs, and held against its plain version by the criteria of
    phases 2, 4, 16 and 18; the bounce step's front end and shading from
    the closest hit's winners (`shade_bank_hit` in a wavefront window,
    `shade_hit` in a scan block) likewise. A scene without triangles holds
    its bundle, its sphere pass and its epilogue (config 4 shades in plain
    torch, with NEE)."""
    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render import pipeline as tpipe
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import threefry as tfk

    if render is None:
        def render():
            tpipe.render_image_wavefront(scene, Camera.reset(), 1280, 720, 4, seed=0,
                                         cfg=RenderConfig(max_depth=32),
                                         pool_size=POOL)
    graphs.clear()
    graphs.zero_stats()
    with recorded_in_capture(call) as rec:
        render()
    torch.cuda.synchronize()
    stats = dict(graphs.STATS)
    # a scene without triangles has no closest-hit call to anchor the step,
    # and shades in plain torch with NEE (config 4)
    kernels = ({"threefry", "sphere_pass", "hit_epilogue"} if scene.num_tris == 0
               else {"mm", "cull", "threefry", "hit_front",
                     "shade_hit" if what.endswith("_block") else "shade_bank_hit"})
    if stats["captures"] == 0 or stats["replays"] < 2 or set(rec) != kernels:
        raise RuntimeError(f"[17] in-{what}: recorded {sorted(rec)}, {stats}")
    for kname, fn in (("mm", tmm.mm_closest_hit), ("cull", tmm._cull_tile_lists),
                      ("threefry", tfk.threefry_bundle),
                      *((k, getattr(wrapper_module(call_wrapper(k)), call_wrapper(k)))
                        for k in SHADING_CALLS)):
        if kname not in rec:
            continue
        args, out = rec[kname]
        again = fn(*args)
        if not all(torch.equal(a, b) or (a.dtype.is_floating_point and bool(
                ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()))
                for a, b in zip(again, out)):
            raise RuntimeError(f"[17] in-{what}: the graph's {kname} node differs "
                               "from an eager launch at its inputs")
    log(f"[17] in a captured {what} ({stats['replays']} replays), call "
        f"{call}: each kernel's graph node ({', '.join(sorted(rec))}) bit-equal "
        "to an eager launch at the same inputs; against the plain versions:")
    tf_args = rec["threefry"][0]
    name = f"in_{what}_" + "+".join(PURPOSE_NAMES.get(p, str(p)) for p, _ in tf_args[4])
    out = dict(stats=stats, threefry=phase_threefry({name: tf_args}, tsass)[name])
    if "mm" in rec:
        (mm_args, _), (cull_args, _) = rec["mm"], rec["cull"]
        out["mm"] = phase_kernel_vs_twin(
            scene, {f"in_{what}": captured_set(mm_args, cull_args[1])})[f"in_{what}"]
        out["cull"] = phase_cull(f"in_{what}", cull_args, sass)
    for kname in SHADING_CALLS:
        if kname in rec:
            out[kname] = bounce_kernel_vs_twin(kname, rec[kname][0], f"in_{what}")
    graphs.clear()
    return out


def scan_workloads(scene, glass):
    """Phase 17's scan paths: name -> (fn() giving (the tensors both loops
    must give bit for bit, rays or None, per-frame launches or None), the
    samples a render traces, the launches its eager loop must make or
    None, whether it launches the tile kernels)."""
    from metalpathtracer_torch.io.checkpoint import save_checkpoint
    from metalpathtracer_torch.render import pipeline as tpipe
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.integrator import RenderConfig

    cam, cfg = Camera.reset(), RenderConfig(max_depth=32)

    def flagship_scan():  # phase 6's render
        img, rays = tpipe.render_image(scene, cam, 1280, 720, 4, seed=0, cfg=cfg)
        return [img], rays, None

    def checkpointed():  # phase 10's: to 4 spp in steps of 2, each on disk
        state = tpipe.init_accum(1280, 720, scene.device)
        while state.spp < 4:
            state = tpipe.accumulate(state, scene, cam, 1280, 720, 2, 0, cfg)
            save_checkpoint(str(OUT / "ck_graphs.npz"), state, 0,
                            meta={"cfg": repr(cfg)})
        return [state.rgb_sum], None, None

    def viewer60_scan():
        return viewer_frames(scene, "scan")

    def config4():  # phase 15's
        img, rays = tpipe.render_image(
            glass, config4_camera(), 512, 512, 2, seed=4,
            cfg=RenderConfig(max_depth=16, nee=True, rr_start=3))
        return [img], rays, None

    return {"flagship_scan": (flagship_scan, 4, SCAN_FLAGSHIP_LAUNCHES, True),
            "checkpointed_scan": (checkpointed, 4, SCAN_FLAGSHIP_LAUNCHES, True),
            "viewer_60_frames_scan": (viewer60_scan, VIEWER_FRAMES, None, True),
            "config4_scan": (config4, 2, None, False)}


def viewer_frames(scene, integrator, frames=VIEWER_FRAMES, key_after=VIEWER_KEY_AFTER):
    """The viewer's loop for `frames` frames at its defaults, with a `w` key
    after frame `key_after`: (the accumulations at the key and at the end,
    None, each frame's launches on the card)."""
    loop, _ = viewer_loop(scene, integrator)
    outs, per_frame = [], []
    for k in range(1, frames + 1):
        keys = [("key", "w")] if k == key_after else []
        before = executed()[:3]
        if not loop.step(lambda: keys):
            raise RuntimeError("viewer loop: quit")
        per_frame.append(tuple(b - a for a, b in zip(before, executed()[:3])))
        if k in (key_after, frames):
            outs.append(loop.state.rgb_sum)
    if loop.state.spp != frames - key_after:
        raise RuntimeError(f"viewer loop: {loop.state.spp} spp after the key")
    return outs, None, per_frame


def phase_graphs(scene, bunny, card, sass, tsass):
    """17: graph against eager on the wavefront's flagship, four
    progressive steps, GRAPH_VIEWER_FRAMES viewer frames with a camera
    move, a config-5 step and the bunny300k leg, and on the scan's
    flagship, checkpointed render, 60 viewer frames with a camera move and
    config 4; then the
    kernels inside a captured flagship window, and inside a captured
    bounce block of the flagship scan, the viewer's scan frames and config
    4."""
    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render import pipeline as tpipe
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.scene import load_scene_xml

    multimesh = upload_scene(load_scene_xml(str(ROOT / "scenes" / "multimesh.xml")),
                             "cuda")
    glass = upload_scene(load_scene_xml(str(ROOT / "scenes" / "cornell_glass.xml")),
                         "cuda")
    record = {name: graph_vs_eager(name, fn, card,
                                   flagship=FLAGSHIP_LAUNCHES if name == "flagship"
                                   else None)
              for name, fn in graph_workloads(scene, bunny, multimesh).items()}
    for name, (fn, samples, flagship, tiles) in scan_workloads(scene, glass).items():
        record[name] = graph_vs_eager(name, fn, card, samples=samples,
                                      flagship=flagship, tiles=tiles)
    record["in_window"] = phase_in_window(scene, sass, tsass)
    record["regen_in_window"] = phase_regen_in_window(scene)
    # the bounce step GRAPH_CALL of a captured block (the block's last step
    # where it is shorter)
    call = min(GRAPH_CALL, tint.SCAN_BLOCK)
    cam = Camera.reset()
    for name, where, render in (
            ("flagship_scan", scene, lambda: tpipe.render_image(
                scene, cam, 1280, 720, 4, seed=0, cfg=RenderConfig(max_depth=32))),
            ("viewer_scan", scene, lambda: viewer_frames(scene, "scan")),
            ("config4_scan", glass, lambda: tpipe.render_image(
                glass, config4_camera(), 512, 512, 2, seed=4,
                cfg=RenderConfig(max_depth=16, nee=True, rr_start=3)))):
        record[f"in_block_{name}"] = phase_in_window(where, sass, tsass,
                                                     f"{name}_block", render, call)
    del multimesh, glass
    graphs.clear()
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# --scan-blocks: the scan's SCAN_BLOCK on the card
# ---------------------------------------------------------------------------

SCAN_BLOCK_SWEEP = (1, 4, 8)  # and each path's max_depth
SWEEP_TURNS = 5  # timed runs of each block value (and of the eager loop), in turns
SWEEP_FRAMES = 30  # viewer frames a timed run


def phase_scan_blocks(scene, card):
    """--scan-blocks: the flagship scan (1280x720, spp 4, depth 32) and the
    viewer's scan frames (its defaults, 1 spp a frame, SWEEP_FRAMES frames
    a run) with `integrator.SCAN_BLOCK` at 1, 4, 8 and the path's
    max_depth, and on the eager loop (`graphs.eager()`: a step and a read a
    bounce). Each block value gets its own cache entry, built and captured
    first (its capture seconds and the card memory it holds), then
    SWEEP_TURNS timed runs of every value in turns: seconds (median and
    range), host reads, replays, launches on the card and idle steps a run,
    and, for the flagship, one profiled run's device time and busy share
    (`device_busy`). Images bit-equal across every value and the eager
    loop. Then the flagship scan's device time by kernel family on the
    graph path at the module's SCAN_BLOCK (`profile`)."""
    import statistics

    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render import pipeline as tpipe
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.kernels import _build

    def flagship():
        img, rays = tpipe.render_image(scene, Camera.reset(), 1280, 720, 4, seed=0,
                                       cfg=RenderConfig(max_depth=32))
        return [img], rays

    def frames():
        loop, _ = viewer_loop(scene, "scan")
        for _ in range(SWEEP_FRAMES):
            loop.step(lambda: [])
        return [loop.state.rgb_sum], None

    default = tint.SCAN_BLOCK
    record = {}
    try:
        for name, fn, depth in (("flagship_scan", flagship, 32),
                                ("viewer_scan_frames", frames, VIEWER_DEPTH)):
            values = ["eager", *sorted(set(SCAN_BLOCK_SWEEP) | {depth})]
            entries, made, runs = {}, {}, {v: [] for v in values}

            def once(v):
                graphs._cache.clear()
                graphs._cache.update(entries.get(v, {}))
                torch.cuda.synchronize()
                _build.zero_tallies()
                before = dict(graphs.STATS)
                with graphs.eager() if v == "eager" else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    outs, rays = fn()
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                moved = {k: graphs.STATS[k] - before[k] for k in before}
                return dict(outs=outs, rays=rays, s=secs, launched=executed(), **moved)

            for v in values[1:]:
                tint.SCAN_BLOCK = v
                graphs.clear()
                torch.cuda.synchronize()
                mem = torch.cuda.memory_reserved()
                first = once(v)
                entries[v] = dict(graphs._cache)
                made[v] = dict(first_s=first["s"], captures=first["captures"],
                               capture_s=first["capture_s"],
                               reserved_mb=(torch.cuda.memory_reserved() - mem) / 2**20)
            for turn in range(SWEEP_TURNS):
                for v in (values if turn % 2 == 0 else values[::-1]):
                    runs[v].append(once(v))
            want = runs["eager"][0]
            for v, rs in runs.items():
                for r in rs:
                    if not all(torch.equal(a, b) for a, b in zip(r["outs"], want["outs"])) \
                            or r["rays"] != want["rays"]:
                        raise RuntimeError(f"[SB] {name}, block {v}: the image differs "
                                           "from the eager loop's")
                    if v != "eager" and (r["captures"] or r["eager_runs"]):
                        raise RuntimeError(f"[SB] {name}, block {v}: a timed run captured")
            rec = {}
            for v, rs in runs.items():
                secs = [r["s"] for r in rs]
                last = rs[-1]
                rec[str(v)] = dict(
                    seconds=secs, median_s=statistics.median(secs), reads=last["reads"],
                    replays=last["replays"], launched=last["launched"],
                    idle_steps=last["idle_steps"], **made.get(v, {}))
                if name == "flagship_scan":
                    graphs._cache.clear()
                    if v != "eager":
                        graphs._cache.update(entries[v])
                    with graphs.eager() if v == "eager" else contextlib.nullcontext():
                        busy = device_busy(fn, f"scan blocks {v}")
                    rec[str(v)].update(device_ms=busy["busy_ms"],
                                       busy_share=busy["busy_share"])
                r = rec[str(v)]
                log(f"[SB] {name}, block {v}: median {r['median_s']:.4f} s ("
                    f"{min(secs):.4f}-{max(secs):.4f}, {len(secs)} runs in turns); "
                    f"{r['reads']} host reads, {r['replays']} replays, launches "
                    f"{r['launched']}, {r['idle_steps']} idle steps a run"
                    + (f"; first run {r['first_s']:.3f} s with {r['captures']} captures "
                       f"in {r['capture_s']:.3f} s, {r['reserved_mb']:.0f} MiB reserved"
                       if v != "eager" else "")
                    + (f"; profiled: device busy {r['device_ms']:.1f} ms, "
                       f"{100 * r['busy_share']:.1f}% of its wall" if "device_ms" in r
                       else "") + f" ({card})")
            record[name] = rec
            entries.clear()
            graphs.clear()
            torch.cuda.empty_cache()
        # where the flagship scan's device time goes on the graph path, at
        # the module's SCAN_BLOCK: a warm render, then a profiled one
        tint.SCAN_BLOCK = default
        record["profile_flagship_scan"] = profile(
            flagship, f"scan_graph_block{default}_1280x720", 128)
    finally:
        tint.SCAN_BLOCK = default
        graphs.clear()
    (OUT / "scan_blocks.json").write_text(json.dumps(record, indent=1))
    return record

# ---------------------------------------------------------------------------
# 19: the wavefront's regeneration kernels (csrc/wavefront.cu)
# ---------------------------------------------------------------------------

# what a restarted lane computes besides its loads and stores: its threefry
# pair's integer work (20 rounds of add, rotate and xor, 5 key injections;
# the int64 divisions of its item into pixel and sample left out, so a
# lower count) and the ray's f32 operations (the two screen coordinates,
# three components of four operations and a subtraction, the norm's three
# products, two adds and root, three divisions)
RESTART_INT_OPS = 20 * 3 + 5 * 2
RAYGEN_FLOP = 4 + 3 * 5 + 6 + 3


def _deep_clone(a):
    """Clones of every tensor in `a` (tuples, lists and dicts walked; a
    NamedTuple plan kept as it is)."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, dict):
        return {k: _deep_clone(v) for k, v in a.items()}
    if isinstance(a, (tuple, list)) and not hasattr(a, "_fields"):
        return type(a)(_deep_clone(v) for v in a)
    return a


def _regen_lanes(args) -> int:
    return args[0]["item"].shape[0] if isinstance(args[0], dict) else args[0].shape[0]


def regen_flat(kernel: str, out, args) -> tuple:
    """A regeneration wrapper's outputs as a flat tuple of tensors: the
    queue's returns, then the operands it updates in place."""
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    if kernel == "queue_pop":
        return (*out, *args[2:6])
    if kernel == "tileset_key":
        return (out,)
    if kernel == "restart_lanes":
        return tuple(out[k] for k in twfk.LANE_FIELDS)
    return (*(out[0][k] for k in twfk.LANE_FIELDS), *(out[1] or ()))


@contextlib.contextmanager
def recorded_regen(picks: dict):
    """The regeneration kernels' wrappers wrapped while the block runs:
    `picks` maps a set's name to (lanes, {wrapper: k}), and the k-th call
    of that wrapper on that many lanes (from 1) has its arguments cloned,
    before the call (the queue updates its operands in place), into the
    yielded {name: {wrapper: args}}. The calls go through."""
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    kernels = {k: getattr(twfk, k) for k in REGEN}
    seen, got = {}, {name: {} for name in picks}

    def recorder(kernel):
        def wrapped(*args, **kw):
            lanes = _regen_lanes(args)
            k = seen[(kernel, lanes)] = seen.get((kernel, lanes), 0) + 1
            for name, (want_lanes, at) in picks.items():
                if lanes == want_lanes and at.get(kernel) == k:
                    got[name][kernel] = _deep_clone(args)
            return kernels[kernel](*args, **kw)
        wrapped.launches = 0
        return wrapped

    for k in REGEN:
        setattr(twfk, k, recorder(k))
    try:
        yield got
    finally:
        for k, fn in kernels.items():
            setattr(twfk, k, fn)


def regen_bound(kernel: str, args) -> dict:
    """The least time of one call of a regeneration kernel on the card: the
    bytes it must move for this call's data (each input once, each output
    once; a lane that does not restart copies its state, one that restarts
    writes a new one; the queue moves the accumulator rows of the lanes
    that banked; the key reads the rays of live lanes) at the memory rate,
    and its operations (the restarted lanes' threefry at the int32 rate and
    their rays at the f32 peak; the key's slab tests at the f32 peak)."""
    n = _regen_lanes(args)
    int_ops = flop = 0
    if kernel == "restart_lanes":
        r = int(args[1].sum())
        state = 36 + 8 + 4 + 1  # o, d, tp; bounce; prev_pdf; alive
        nbytes = n * (16 + 1 + 16) + (n - r) * 2 * state + r * state + 48 + 8
        int_ops, flop = r * RESTART_INT_OPS, r * RAYGEN_FLOP
    elif kernel == "queue_pop":
        b, ka = int(args[0].sum()), args[3].shape[1]
        nbytes = n * (1 + 1 + 8 + 1) + b * (3 * 4 * ka + 8 + 8) + 16
    elif kernel == "tileset_key":
        live, nc = int(args[2].sum()), args[3].shape[0]
        nbytes = n * (1 + 4) + live * 24 + nc * 32
        flop = live * nc * CULL_FLOP_PER_PAIR
    else:
        ka = args[1]["acc"].shape[1]
        row = 4 * (3 + 3 + ka + 3 + 3 + 1) + 8 * 5 + 1
        if args[2] is not None:
            row += 8 + 4 * ka
        nbytes = n * (8 + 2 * row)
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (flop / PEAK_F32_FLOPS
              + int_ops / (INT32_PER_SM_CLOCK * H100_SMS * _sm_clock_hz())) * 1e3
    return dict(bytes=nbytes, flop=flop, int_ops=int_ops, bound_ms=max(byte_ms, ops_ms),
                bound_by="bytes" if byte_ms >= ops_ms else "operations")


_CLOCK = []


def _sm_clock_hz() -> float:
    if not _CLOCK:
        _CLOCK.append(top_sm_clock_hz())
    return _CLOCK[0]


def regen_library(kernel: str, args):
    """One PyTorch call that computes a regeneration kernel's function,
    where there is one: the queue's ranks (`torch.cumsum` of the bank
    mask), the gather (`index_select` of the lane state packed into one
    byte tensor, packed outside the timing). The port calls neither."""
    import torch

    if kernel == "queue_pop":
        bank = args[0]
        return lambda: torch.cumsum(bank, 0)
    if kernel == "permute_lanes":
        perm, lanes, pend = args
        n = perm.shape[0]
        parts = [lanes[k] for k in sorted(lanes)] + list(pend or ())
        pack = torch.cat([t.reshape(n, -1).view(torch.uint8) for t in parts], 1)
        return lambda: torch.index_select(pack, 0, perm)
    return None


def regen_vs_twin(kernel: str, args, what: str) -> dict:
    """One call of a regeneration kernel against its twin on the same
    inputs (each on its own clones: the queue works in place): bit for bit
    (NaN where both are NaN); then its device time, call time, the twin's
    call time, the library call's device time and the bound."""
    import torch

    from metalpathtracer_torch.render.kernels import wavefront as twfk

    fn, twin = getattr(twfk, kernel), getattr(twfk, f"{kernel}_reference")
    mine, theirs = _deep_clone(args), _deep_clone(args)
    got = regen_flat(kernel, fn(*mine), mine)
    want = regen_flat(kernel, twin(*theirs), theirs)
    torch.cuda.synchronize()
    bad, err = 0, 0.0
    for a, b in zip(got, want, strict=True):
        if a.dtype.is_floating_point:
            bad += int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())
            both = torch.isfinite(a) & torch.isfinite(b)
            if bool(both.any()):
                err = max(err, float((a[both] - b[both]).abs().max()))
        else:
            bad += int((a != b).sum())
    if bad:
        raise RuntimeError(f"[19] {kernel} vs its twin ({what}): {bad} values differ, "
                           f"max |difference| {err}")
    work = _deep_clone(args)
    ms = device_ms(lambda: fn(*work))
    c_ms = call_ms(lambda: fn(*work), 20)
    plain = _deep_clone(args)
    p_ms = call_ms(lambda: twin(*plain), 3)
    lib = regen_library(kernel, args)
    lib_ms = device_ms(lib) if lib is not None else None
    b = regen_bound(kernel, args)
    rec = dict(lanes=_regen_lanes(args), ms=ms, call_ms=c_ms, plain_ms=p_ms,
               library_ms=lib_ms, max_abs_err=err, **b, share=b["bound_ms"] / ms)
    log(f"    {kernel} vs twin ({what}, {rec['lanes']} lanes): bit-equal; kernel "
        f"{ms * 1e3:.2f} us on the device, {c_ms * 1e3:.2f} us per call, twin "
        f"{p_ms:.3f} ms, library call "
        + (f"{lib_ms * 1e3:.2f} us" if lib_ms is not None else "none")
        + f"; bound {b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}: "
        f"{b['bytes'] / 1e6:.2f} MB), {100 * rec['share']:.1f}% of it reached")
    return rec


def advance_picks() -> dict:
    """The regeneration calls of a render's advance CAPTURE_CALL, as
    `recorded_regen` picks them: the restart after it (the start's being
    the first), its queue pop, and the sort after it (every fourth
    advance's)."""
    return {"restart_lanes": CAPTURE_CALL + 1, "queue_pop": CAPTURE_CALL,
            "tileset_key": CAPTURE_CALL // 4, "permute_lanes": CAPTURE_CALL // 4}


def capture_shard_regen(scene) -> dict:
    """The regeneration calls of a tile shard's advance CAPTURE_CALL (the
    flagship pool set's picks): rank SHARD_RANK of SHARD_TILES's block of
    config 5's pass on `scene` (`shard_render_wavefront` at CONFIG5_SIZE,
    depth CONFIG5_DEPTH, CONFIG5_STEP spp, POOL lanes: every SHARD_TILES-th
    row, the restart's `row_stride`), run eagerly and stopped after it.
    Raises unless the restart's plan deals the rows and every lane's pixel
    lies on the block's rows. Returns {"shard": {wrapper: args}}."""
    from metalpathtracer_torch.parallel import sharding
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    (w, h), cfg = CONFIG5_SIZE, RenderConfig(max_depth=CONFIG5_DEPTH)

    def run():
        sharding.shard_render_wavefront(scene, Camera.reset(), w, h, CONFIG5_STEP, 5, cfg,
                                        POOL, tile_index=SHARD_RANK, n_tiles=SHARD_TILES)

    with recorded_regen({"shard": (POOL, advance_picks())}) as got:
        capture_calls(run, {"shard": lambda i, lanes, k: i == CAPTURE_CALL}, stop=True)
    lanes, _, _, offset, plan = got["shard"]["restart_lanes"]
    pixel, _ = twfk.pixel_sample(lanes["item"], lanes["schunk"], offset, plan)
    rows = pixel // w
    if plan.row_stride != SHARD_TILES or not bool(
            ((rows % SHARD_TILES == SHARD_RANK) & (rows < h)).all()):
        raise RuntimeError(f"[19] the shard's restart: row_stride {plan.row_stride}, rows "
                           f"{sorted(set((rows % SHARD_TILES).tolist()))} mod {SHARD_TILES}")
    return got


def regen_sets(pool: dict, viewer: dict) -> dict:
    """Phase 19's calls: the flagship advance's (`pool`) and a viewer
    frame's pool and drain calls (`viewer`), and the queue at the drain's
    width, made from the viewer pool's call (its first VIEWER_DRAIN lanes:
    the drain pops no queue)."""
    sets = {**pool, **viewer}
    q = viewer["viewer_pool"]["queue_pop"]
    w = VIEWER_DRAIN
    sets["viewer_drain"]["queue_pop"] = (
        *(t[:w].contiguous() for t in q[:6]), *q[6:])
    return sets


def phase_regen(sets: dict) -> dict:
    """19: the regeneration kernels against their twins at the calls the
    paths make (`sets`: name -> {wrapper: args}), each bit-equal, with its
    device, call and plain time, the library call's and the bound."""
    record = {}
    for name, calls in sets.items():
        for kernel in REGEN:
            if kernel in calls:
                record[f"{name}_{kernel}"] = dict(
                    set=name, kernel=kernel, **regen_vs_twin(kernel, calls[kernel], name))
    missing = [f"{name}_{k}" for name in sets for k in REGEN
               if f"{name}_{k}" not in record]
    if missing:
        raise RuntimeError(f"[19] no call recorded for {missing}")
    return record


@contextlib.contextmanager
def recorded_regen_in_capture(lanes: int):
    """The regeneration kernels' wrappers wrapped: while a CUDA graph is
    being captured, the first call of each on `lanes` lanes has its
    arguments cloned before it and its outputs (and the queue's updated
    operands) after it; the clones are graph nodes, so after a replay they
    hold that replay's values. Yields {wrapper: (args, outputs)}."""
    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    kernels = {k: getattr(twfk, k) for k in REGEN}
    got = {}

    def recorder(kernel):
        def wrapped(*args, **kw):
            take = (torch.cuda.is_current_stream_capturing() and kernel not in got
                    and _regen_lanes(args) == lanes)
            before = _deep_clone(args) if take else None
            out = kernels[kernel](*args, **kw)
            if take:
                got[kernel] = before, tuple(t.clone() for t in regen_flat(kernel, out, args))
            return out
        wrapped.launches = 0
        return wrapped

    graphs.clear()
    for k in REGEN:
        setattr(twfk, k, recorder(k))
    try:
        yield got
    finally:
        for k, fn in kernels.items():
            setattr(twfk, k, fn)
        graphs.clear()


def phase_regen_in_window(scene) -> dict:
    """17 (and 19): inside one captured flagship window, the first call of
    each regeneration kernel on the pool's lanes as the last replay
    computed it: bit-equal to an eager launch at the same inputs and to its
    twin."""
    import torch

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render import pipeline as tpipe
    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    graphs.zero_stats()
    with recorded_regen_in_capture(POOL) as rec:
        tpipe.render_image_wavefront(scene, Camera.reset(), 1280, 720, 4, seed=0,
                                     cfg=RenderConfig(max_depth=32), pool_size=POOL)
    torch.cuda.synchronize()
    stats = dict(graphs.STATS)
    if stats["captures"] == 0 or stats["replays"] < 2 or set(rec) != set(REGEN):
        raise RuntimeError(f"[17] regeneration in a window: recorded {sorted(rec)}, "
                           f"{stats}")
    out = {}
    for kernel, (args, recorded) in rec.items():
        for who, fn in (("eager launch", getattr(twfk, kernel)),
                        ("twin", getattr(twfk, f"{kernel}_reference"))):
            mine = _deep_clone(args)
            again = regen_flat(kernel, fn(*mine), mine)
            if not all(torch.equal(a, b) or (a.dtype.is_floating_point and bool(
                    ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()))
                    for a, b in zip(again, recorded, strict=True)):
                raise RuntimeError(f"[17] the window's {kernel} node differs from its "
                                   f"{who} at its inputs")
        out[kernel] = dict(lanes=_regen_lanes(args), bit_equal=True)
    log(f"[17] in a captured window ({stats['replays']} replays): the first "
        f"{', '.join(REGEN)} call on {POOL} lanes each bit-equal to an eager launch and "
        "to its twin at the same inputs")
    return dict(stats=stats, kernels=out)


def _launches():
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    return tmm.mm_closest_hit.launches, tmm._cull_tile_lists.launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the wavefront path and the bunny300k leg")
    ap.add_argument("--sweep", action="store_true",
                    help="also time mm_closest_hit built with 1, 2, 4 and 8 "
                         "column slices per tile and 1 and 4 rays per thread, "
                         "cull_tile_lists with at most 8, 16 and 32 warps per "
                         "block aiming at 64, 128 and 256 warps per SM, "
                         "threefry with 64, 128 and 256 threads a block, and "
                         "mm_closest_hit at cluster widths 1, 2, 4 and 8")
    ap.add_argument("--against", metavar="DIR",
                    help="also time the three kernels built from the sources "
                         "of the checkout DIR against this one's, and run both "
                         "trees' flagship CLI renders, in turns, images compared")
    ap.add_argument("--cards", type=int, default=1, metavar="N",
                    help="run phases 1, 6, 7 and 14 alone, phase 14c with one "
                         "rank on each of N cards joined by nccl")
    ap.add_argument("--scan-blocks", action="store_true",
                    help="run phase 1 and the SCAN_BLOCK sweep of the scan's graphs "
                         "alone")
    ap.add_argument("--shard-rank", nargs=2, metavar=("SPEC", "RANK"),
                    help="run as one rank of a world of phase 14c (the script "
                         "starts these itself)")
    args = ap.parse_args(argv)
    if args.shard_rank:
        return shard_rank(args.shard_rank[0], int(args.shard_rank[1]))

    t_start = time.perf_counter()
    card, build_s, sass, tsass = phase_setup()
    import torch

    if args.cards > 1:
        if args.cards > torch.cuda.device_count():
            raise SystemExit(f"chip_smoke: --cards {args.cards}, but "
                             f"{torch.cuda.device_count()} are visible")
        paths = phase_paths(False)
        sharded_cli = phase_sharded_cli(paths)
        _, after_two = phase_config5()
        phase_ranks(sharded_cli, after_two, card, cards=args.cards)
        phase_rank_balance(card)
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        return 0

    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.scene import load_scene_xml, presets

    dev = torch.device("cuda")
    scene = upload_scene(load_scene_xml(str(ROOT / "scenes" / "reference.xml")), dev)
    if args.scan_blocks:
        phase_scan_blocks(scene, card)
        log("[R] device time by range, and the graph path, of both flagships and "
            "the bunny300k leg")
        phase_ranges(scene, upload_scene(presets.reference_bunny300k(), dev), card)
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        return 0
    big = {}
    for name, preset in (("bunny70k", presets.reference_bunny70k),
                         ("bunny300k", presets.reference_bunny300k)):
        t0 = time.perf_counter()
        big[name] = upload_scene(preset(), dev)
        log(f"[1] {name}: {big[name].num_tris} triangles in "
            f"{big[name].mm_tile_box.shape[0]} tiles of {big[name].mm_w.shape[1]}, "
            f"built and uploaded in {time.perf_counter() - t0:.2f} s")
    log(f"[1] reference scene: {scene.num_tris} triangles in "
        f"{scene.mm_tile_box.shape[0]} tiles of {scene.mm_w.shape[1]}")

    scan_draws = []
    ref_sets = primary_and_bounce(scene, 1280, 720, draws=scan_draws)
    # the bounce step's kernels' calls: the flagship scan's first two steps
    # (921,600 lanes), the pool advance's and a viewer frame's
    shading_sets = {f"scan_step{k}": {kernel: v[0] for kernel, v in calls.items() if v}
                    for k, calls in enumerate(shading_steps(scene, 1280, 720, 2), 1)}
    # and the regeneration kernels' calls of the same advance (the restart
    # after it, the start's being the first; the sort after it, every
    # fourth advance's), and of a viewer frame's pool and drain
    from metalpathtracer_torch import viewer as tviewer

    with recorded_regen({"pool": (POOL, advance_picks())}) as regen_pool:
        mm_pool, cull_pool, pool_draws = capture_pool_call(shading_sets)
    viewer_picks = {
        "viewer_pool": (tviewer.POOL_SIZE, {"restart_lanes": 5, "queue_pop": 5,
                                            "tileset_key": 2, "permute_lanes": 2}),
        "viewer_drain": (VIEWER_DRAIN, {"restart_lanes": 1, "tileset_key": 1,
                                        "permute_lanes": 1})}
    with recorded_regen(viewer_picks) as regen_viewer:
        of_viewer = capture_viewer_calls(scene, shading_sets)
    # and of a tile shard's advance: the rows dealt, a row_stride above 1
    regen_shard = capture_shard_regen(
        upload_scene(load_scene_xml(str(ROOT / "scenes" / "multimesh.xml")), dev))
    sets = {k: closest_hit_set(scene, *v) for k, v in ref_sets.items()}
    sets["pool"] = captured_set(mm_pool, cull_pool[1])
    # the drain's lanes are the longest paths: they may all be among spheres
    for k, (mm_args, cull_args, _) in of_viewer.items():
        sets[k] = captured_set(mm_args, cull_args[1],
                               min_hits=0 if k == "viewer_drain" else 1)
    log(f"[2] mm_closest_hit vs twin, reference scene: 921,600 rays, the "
        f"{mm_pool[3].shape[0]} lanes of call {CAPTURE_CALL} of the flagship "
        f"wavefront render, and of a viewer frame the "
        + " and ".join(str(v[0][3].shape[0]) for v in of_viewer.values())
        + " lanes of a pool call and a drain call")
    kvt = phase_kernel_vs_twin(scene, sets)
    log("[3] the kernel path vs the brute oracle")
    oracle = phase_oracle(scene, ref_sets, 32768, chunk=1024)

    # 32,768 rays of a 512x512 view (every 8th pixel), as the legs' pool
    leg_sets = {k: primary_and_bounce(s, LEG_W, LEG_H, stride=8)
                for k, s in big.items()}
    log("[4] the tile cull (the lists and the plain rows) vs its plain versions")
    cull_sets = {"reference_primary": cull_args_of(scene, *ref_sets["primary"]),
                 "reference_pool": cull_pool,
                 **{f"reference_{k}": v[1] for k, v in of_viewer.items()}}
    for k, lsets in leg_sets.items():
        cull_sets[f"{k}_bounce1"] = cull_args_of(big[k], *lsets["bounce1"])
    cull = {k: phase_cull(k, v, sass) for k, v in cull_sets.items()}
    if big["bunny300k"].mm_w.shape[1] != 256:
        raise RuntimeError("bunny300k is not at tile_p 256")
    log("[5] mm_closest_hit at tile_p 256 (bunny300k)")
    sets256 = {k: closest_hit_set(big["bunny300k"], *v)
               for k, v in leg_sets["bunny300k"].items()}
    kvt256 = phase_kernel_vs_twin(big["bunny300k"], sets256)
    oracle256 = phase_oracle(big["bunny300k"], leg_sets["bunny300k"], 4096,
                             chunk=4096)
    mm_sets = {**{f"reference_{k}": v for k, v in sets.items()},
               **{f"bunny300k_{k}": v for k, v in sets256.items()}}
    log("[16] threefry_bundle vs its plain twin: the probe's call, the scan's "
        f"921,600-lane bundles, the bundles of the flagship's advance {CAPTURE_CALL}, "
        "of a viewer frame's pool call 5 and drain call 1, and of config 4's first "
        "bounce step")
    t0 = time.perf_counter()
    draw_args = draw_sets(scan_draws, pool_draws, of_viewer, config4_draws())
    draws = phase_threefry(draw_args, tsass)
    log(f"[16] {len(draws)} bundles compared and timed in "
        f"{time.perf_counter() - t0:.1f} s")
    del scan_draws, pool_draws
    # the bunny300k leg's first step (32,768 lanes) and config 4's (262,144
    # lanes, spheres alone, NEE: its closest hits, the step's and the shadow
    # rays', without the shading kernel)
    (calls,) = shading_steps(big["bunny300k"], LEG_W, LEG_H, 1, stride=8)
    shading_sets["bunny300k_step1"] = {kernel: v[0] for kernel, v in calls.items() if v}
    glass = upload_scene(load_scene_xml(str(ROOT / "scenes" / "cornell_glass.xml")), dev)
    (calls,) = shading_steps(glass, 512, 512, 1, cam=config4_camera(), seed=4,
                             cfg=RenderConfig(max_depth=16, nee=True, rr_start=3))
    if calls["shade_hit"] or calls["shade_bank_hit"] or calls["hit_front"] or len(
            calls["sphere_pass"]) != 2 or len(calls["hit_epilogue"]) != 2:
        raise RuntimeError(f"config 4's step: {[(k, len(v)) for k, v in calls.items()]}")
    for k, label in enumerate(("config4_step1", "config4_shadow1")):
        shading_sets[label] = {kernel: calls[kernel][k]
                               for kernel in ("sphere_pass", "hit_epilogue")}
    # config 4's step without NEE shades on the kernel, from the sphere
    # pass's winners: its shading at 262,144 lanes
    (calls,) = shading_steps(glass, 512, 512, 1, cam=config4_camera(), seed=4,
                             cfg=RenderConfig(max_depth=16, rr_start=3))
    shading_sets["config4_step1_no_nee"] = {"shade_hit": calls["shade_hit"][0]}
    del calls, glass
    # every shading entry at the shapes where the paths shade (the scan,
    # the pool advance, the viewer's pool and drain, config 4, the bunny
    # leg's step), on operands made from the step's (`complete_shading_set`);
    # and the front end at a lane count that is not whole subgroups
    for name in list(shading_sets):
        shading_sets[name] = complete_shading_set(shading_sets[name])
    shading_sets["scan_step1_padded"] = {
        "hit_front": padded_front_of(shading_sets["scan_step1"]["hit_front"])}
    log("[18] the bounce step's kernels vs their twins: "
        + ", ".join(f"{k} ({next(iter(v.values()))[0].shape[0]} lanes: "
                    f"{', '.join(v)})" for k, v in shading_sets.items()))
    t0 = time.perf_counter()
    bounce_kernels = phase_bounce_kernels(shading_sets)
    log(f"[18] {len(bounce_kernels)} calls compared and timed in "
        f"{time.perf_counter() - t0:.1f} s")
    # the shading's loads before its first store, by function, in this
    # tree's build and (with --against) the other tree's
    from metalpathtracer_torch.render.kernels import _build

    builds = {"this": _build.build("shade")}
    if args.against:
        builds["other"] = _build.build(
            "shade", csrc=Path(args.against).resolve() / "metalpathtracer_torch" / "csrc")
    loads = {who: shade_loads(so) for who, so in builds.items()}
    for who, fns in loads.items():
        log(f"[18] shade.cu SASS ({who} tree), global loads before the first global "
            "store (16-byte ones) of all: " + ", ".join(
                f"{k} {v['loads_before_store']} ({v['wide_before_store']}) of "
                f"{v['loads']}" for k, v in fns.items()))
    del shading_sets
    log("[19] the regeneration's kernels vs their twins: the flagship's advance "
        f"{CAPTURE_CALL} (its queue pop and restart, and the sort after it), a viewer "
        "frame's pool and drain calls, the queue at the drain's width, and advance "
        f"{CAPTURE_CALL} of rank {SHARD_RANK} of {SHARD_TILES}'s dealt rows of config 5 "
        f"(row_stride {SHARD_TILES})")
    t0 = time.perf_counter()
    regen = phase_regen({**regen_sets(regen_pool, regen_viewer), **regen_shard})
    log(f"[19] {len(regen)} calls compared and timed in {time.perf_counter() - t0:.1f} s")
    del regen_pool, regen_viewer, regen_shard
    torch.cuda.empty_cache()
    sweep = against = None
    if args.sweep:
        log(f"[S] mm_closest_hit with {SWEEP_SLICES} column slices per tile and "
            f"{SWEEP_RAYS} rays per thread; cull_tile_lists with at most {SWEEP_WARPS} "
            f"warps per block, aiming at {SWEEP_FILL} warps per SM; threefry with "
            f"{SWEEP_THREADS} threads a block")
        sweep = {
            "mm_closest_hit": phase_sweep("mm_closest_hit", {
                f"K={k},R={r}": (f"MM_SLICES={k}", f"MM_RAYS={r}")
                for r in SWEEP_RAYS for k in SWEEP_SLICES}, mm_sets),
            "cull_tile_lists": phase_sweep("cull_tile_lists", {
                f"W={w},F={f}": (f"CULL_WARPS={w}", f"CULL_FILL={f}")
                for f in SWEEP_FILL for w in SWEEP_WARPS}, cull_sets),
            "threefry": phase_sweep("threefry", {
                f"T={t}": (f"THREEFRY_THREADS={t}",) for t in SWEEP_THREADS},
                draw_args)}
        log(f"[S] mm_closest_hit's cluster widths {SWEEP_CLUSTERS} at the paths' "
            "subgroup counts")
        sweep["mm_cluster"] = phase_cluster_sweep(cluster_sets(mm_sets))
    if args.against:
        log(f"[A] the three kernels built from {args.against} and from this checkout")
        against = phase_against(Path(args.against).resolve(),
                                {"cull_tile_lists": {k: cull_sets[k] for k in AGAINST_CULL},
                                 "mm_closest_hit": mm_sets,
                                 "threefry": {k: v for k, v in draw_args.items()
                                              if len(v[4]) > 1}})
        against["renders"] = phase_against_renders(Path(args.against).resolve())
    del leg_sets, sets, sets256, mm_sets, mm_pool, cull_pool, cull_sets, of_viewer
    del draw_args

    paths = phase_paths(args.profile)
    ranges = None
    if args.profile:
        log("[R] device time by range, and the graph path, of both flagships and "
            "the bunny300k leg")
        ranges = phase_ranges(scene, big["bunny300k"], card)
    legs = phase_legs(big, args.profile)
    small = phase_small_vs_plain(scene)
    scan = dict(image=paths["scan"].pop("image"), counts=paths["scan"]["counts"])
    checkpointed = phase_checkpoint(scan)
    progressive = phase_progressive(scene, scan["image"])
    viewer = phase_viewer(scene)
    bvh = phase_bvh(ref_sets, 32768, chunk=1024)
    log("[17] the wavefront's windows as CUDA graphs against the eager loop")
    graph = phase_graphs(scene, big["bunny300k"], card, sass, tsass)
    del scene, big, ref_sets
    torch.cuda.empty_cache()
    sharded_cli = phase_sharded_cli(paths)
    config5, after_two = phase_config5()
    two_ranks = phase_ranks(sharded_cli, after_two, card)
    del after_two
    rank_balance = phase_rank_balance(card)
    for name in ("scan", "wavefront"):  # compared; what comes back stays small
        (OUT / f"tile_shard_{name}.npz").unlink()
    nee = phase_nee(card)

    main_path = paths["wavefront"]["counts"]
    # the main path's shapes: the pool call, and its advance's bounce step
    mm, cl, tf = kvt["pool"], cull["reference_pool"], draws["pool_lobe+fresnel"]
    # every counted path's launches, beside the main path's
    per_path = {"scan": paths["scan"]["counts"], "wavefront": main_path,
                **{k: v["counts"] for k, v in legs.items()},
                "checkpointed": checkpointed["counts"],
                "progressive_wavefront": progressive["wavefront"]["counts"],
                "viewer_15_frames": viewer["loop"]["counts"],
                "tile_shard_scan": sharded_cli["scan"]["counts"],
                "tile_shard_wavefront": sharded_cli["wavefront"]["counts"],
                "config5_accumulate_sharded": config5["counts"],
                **{f"two_ranks_{k}": two_ranks["together"][k]["launches"]
                   for k in ("scan", "wavefront", "config5")},
                "nee_multimesh_scan": nee["multimesh_scan"]["counts"],
                "nee_multimesh_wavefront": nee["multimesh_wavefront"]["counts"]}
    kernels = {"kernels": [
        dict(name="mm_closest_hit", route="cuda", **KERNELS["mm_closest_hit"],
             launches=main_path["mm_launches"], max_abs_err=mm["max_abs_err"],
             ms=mm["ms"], call_ms=mm["call_ms"], plain_ms=mm["plain_ms"],
             bound_ms=mm["bound_ms"],
             bound_by=mm["bound_by"], share=mm["share"], library_ms=None,
             cluster=mm["cluster"], longest_walk_ms=mm["longest_walk_ms"],
             launches_by_path={k: v["mm_launches"] for k, v in per_path.items()}),
        dict(name="cull_tile_lists", route="cuda", **KERNELS["cull_tile_lists"],
             launches=main_path["cull_launches"], max_abs_err=cl["max_abs_err"],
             ms=cl["ms"], call_ms=cl["call_ms"], plain_ms=cl["plain_ms"],
             bound_ms=cl["bound_ms"],
             bound_by=cl["bound_by"], share=cl["share"], library_ms=None,
             sort_route=cl["route"], rows_ms=cl["rows_ms"], tail_ms=cl["tail_ms"],
             launches_by_path={k: v["cull_launches"] for k, v in per_path.items()},
             radix_launches_by_path={k: v.get("cull_radix") for k, v in per_path.items()}),
        # torch.rand is Philox, another function: no PyTorch call computes it
        dict(name="threefry", route="cuda", **KERNELS["threefry"],
             launches=main_path["threefry_launches"],
             max_abs_err=max(v["max_abs_err"] for v in draws.values()),
             ms=tf["ms"], call_ms=tf["call_ms"], plain_ms=tf["plain_ms"],
             bound_ms=tf["bound_ms"], bound_by=tf["bound_by"], share=tf["share"],
             library_ms=None,
             launches_by_path={k: v["threefry_launches"] for k, v in per_path.items()},
             draws_by_path={k: v["threefry_draws"] for k, v in per_path.items()}),
    ]}
    # the bounce step's kernels: each one's launches are those of the path
    # that runs it (every path is counted from 0), and its times at that
    # path's shape: the front end and the shading with the bank from the
    # winners on the main path (the wavefront: the pool advance), the
    # shading from the winners on the scan flagship (its first bounce step,
    # 921,600 lanes); the epilogue's own kernel on the NEE path (the
    # multimesh wavefront; timed at the pool advance's winners); no single
    # PyTorch call computes any of them
    where = {"hit_front": ("wavefront", "pool_hit_front"),
             "hit_epilogue": ("nee_multimesh_wavefront", "pool_hit_epilogue"),
             "shade_hit": ("scan", "scan_step1_shade_hit"),
             "shade_bank_hit": ("wavefront", "pool_shade_bank_hit")}
    for kernel, key in zip(SHADING, SHADING_KEYS):
        path, call = where[kernel]
        at = bounce_kernels[call]
        kernels["kernels"].append(dict(
            name=kernel, route="cuda", **KERNELS[kernel],
            launches=per_path[path][key], launches_path=path, lanes=at["lanes"],
            max_abs_err=max(v["max_abs_err"] for v in bounce_kernels.values()
                            if v["kernel"] == kernel),
            ms=at["ms"], call_ms=at["call_ms"], plain_ms=at["plain_ms"],
            bound_ms=at["bound_ms"], bound_by=at["bound_by"], share=at["share"],
            library_ms=None,
            launches_by_path={k: v[key] for k, v in per_path.items()}))
    # the regeneration's kernels: the main path's launches, and their times
    # at its shape (the pool advance); the library call where one PyTorch
    # call computes the same function
    for kernel, key in zip(REGEN, REGEN_KEYS):
        at = regen[f"pool_{kernel}"]
        kernels["kernels"].append(dict(
            name=kernel, route="cuda", **KERNELS[kernel],
            launches=main_path[key], launches_path="wavefront", lanes=at["lanes"],
            max_abs_err=max(v["max_abs_err"] for v in regen.values()
                            if v["kernel"] == kernel),
            ms=at["ms"], call_ms=at["call_ms"], plain_ms=at["plain_ms"],
            bound_ms=at["bound_ms"], bound_by=at["bound_by"], share=at["share"],
            library_ms=at["library_ms"],
            launches_by_path={k: v.get(key) for k, v in per_path.items()}))
    summary = dict(card=card, build_s=build_s, cull_sass=sass, against=against,
                   mm_vs_twin=kvt, oracle=oracle,
                   cull_vs_plain=cull, mm_vs_twin_tile_p256=kvt256,
                   oracle_tile_p256=oracle256,
                   threefry_lane={k: lane_issue(v)
                                  for k, v in tsass["per_blocks"].items()},
                   threefry_vs_twin=draws, bounce_kernels_vs_twins=bounce_kernels,
                   regen_vs_twins=regen,
                   shade_sass_loads=loads,
                   sweep=sweep, paths=paths, legs=legs,
                   small_vs_plain=small, checkpointed=checkpointed,
                   progressive=progressive, viewer=viewer, bvh=bvh,
                   sharded_cli=sharded_cli, config5=config5, two_ranks=two_ranks,
                   rank_balance=rank_balance,
                   nee=nee, graphs=graph, ranges=ranges,
                   total_s=time.perf_counter() - t_start)
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    log(f"done in {summary['total_s']:.1f} s")
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
