#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`metalpathtracer_torch`) on one card.

Builds the hand-written CUDA kernels from `metalpathtracer_torch/csrc/` (one
`nvcc` each, started together), holds each to its plain PyTorch version at
the shapes the render paths give it, then drives those paths through the
port's entry points at full size and checks that every advance went through
the three kernels (the closest hit, the tile cull, the RNG's threefry).
Phases, each raising on failure:

1. set up: the card, TF32 off, the kernel builds, the instructions the
   cull kernel's slab-test loop issues per (ray, tile) pair and those of
   each threefry mode's kernel (their SASS);
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
4. `cull_tiles` vs its plain version, bit-equal, at 39 tiles (921,600
   primary rays, the 32,768 pool lanes of the same flagship advance, and
   the viewer frame's 16,384 and 1,024 lanes of the same two advances),
   311 tiles (bunny70k) and 1,242 tiles (bunny300k), the latter two on
   32,768 rays after one bounce with an active mask and the sphere pass's
   occlusion bound; with its issue estimate (the SASS count per pair at
   one instruction per lane per clock on every SM);
5. `mm_closest_hit` at tile_p 256 (bunny300k) vs its twin on 32,768
   primary and 32,768 bounce-1 rays, and vs the brute oracle on 8,192;
6. the scan path: `cli.main` at 1280x720, spp 4, depth 32;
7. the wavefront path: `cli.main --wavefront` at the same size (pool 2^15),
   its image against the scan path's;
8. the large-scene legs: `render_image_wavefront` on bunny70k and
   bunny300k at 512x512, spp 2, depth 8, pool 2^15;
9. small renders (320x180, spp 2, depth 8) of both paths on the kernels vs
   on the plain versions, and vs on the RNG's twin alone (bit-equal), and
   the golden reference-scene case vs tests/golden/reference_scene.npz;
10. the checkpointed CLI: `cli.main --checkpoint --checkpoint-every 2` at
    1280x720, depth 32, to 2 spp, then `--resume` to 4 spp, and the same to
    4 spp without interruption: the two images bit-equal, both against
    phase 6's within the render limit, as many launches as phase 6 made,
    and a resume with another `--fov` exits 2 and leaves the file as it was;
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
    bvh` at 320x180, spp 2, depth 8 against the `mm` render; it must launch
    neither kernel;
14. the sharded path (`parallel/sharding.py` over `torch.distributed`):
    a. `cli.main --tile-shard` and `--tile-shard --wavefront` on the
       flagship in a world of one: images bit-equal to phases 6 and 7's,
       the same rays, the same launches of each kernel;
    b. the reference's config 5 at full width: `scenes/multimesh.xml`,
       1920x1080, depth 8, `init_accum_sharded` and four
       `accumulate_sharded` steps of 4 spp in a world of one, against
       `render_image_wavefront` of the same 16 spp (rtol 1e-6, atol 1e-7,
       equal rays);
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
15. next-event estimation and Russian roulette on the card (NEE,
    `rr_start` 3), each held to the same render on the CPU (plain
    versions) within the render limit: the reference's config 4
    (`scenes/cornell_glass.xml`, 512x512, depth 16; spp cut from 1024 to 2;
    spheres alone, so it launches no tile kernel) and `scenes/multimesh.xml` at
    320x180, spp 2, depth 8 on both integrators, whose shadow rays go
    through both kernels;
16. `threefry` vs its plain twin (run after phase 5, with the other
    kernels' comparisons), at the shapes the paths give it: the draws of
    the flagship's advance CAPTURE_CALL (the lobe and Fresnel draws with
    per-lane sample ids and bounces, the restart's jitter; 32,768 lanes),
    the scan's 921,600-lane jitter and first-bounce draws, a viewer frame's
    pool call 5 (16,384 lanes) and drain call 1, and the Mosaic probe's own
    call (`benchmarks/mosaic_probe.py`: seed 42, an (8, 128) int32 tile of
    ids, sample 3, bounce 0, purpose 7, unit vectors): uniforms bit-equal,
    unit vectors bit-equal or within 4 ulp of 1.0 (the gap printed); each
    with its device, call and plain time and its bound, the larger of its
    bytes at the memory rate and its integer instructions (the SASS count)
    at 64 a clock on every SM.
No earlier path runs at a smaller depth than before. Each path of phases
6-8, 10-12, 14 and 15 runs with every launch count set to 0 just before it and read
just after, and with the plain versions counted (they must not run); a
bounce step must launch both tile kernels once and threefry at least twice.
A kernel's `ms` is its device time: 20 calls captured in one CUDA
graph, replayed between CUDA events (`device_ms`); its `call_ms` is the
mean of 20 wrapper calls back to back between CUDA events (`call_ms`),
which reads the host's enqueue rate where the kernel is shorter than the
wrapper's host work; plain versions are timed as calls. Renders are timed
by host clocks around work that ends in a synchronise. A kernel's bound is
the larger of its operations at the f32 CUDA-core peak (67 TFLOP/s) and
its bytes at the memory rate (3.35 TB/s), both of an H100 SXM at 700 W;
the closest hit's operations are 38 flop per (ray, triangle) pair its
subgroups walked, the cull's 12 per (ray, tile) pair.

The second-to-last lines of standard output are the kernels' JSON record and
the card's name and power limit; the last line is the result JSON. Writes
images, compiler logs and a summary into the gitignored directory `OUT`.

Usage:
    python3 chip_smoke.py            # what a check runs
    python3 chip_smoke.py --profile  # also torch.profiler tables of the
                                     # wavefront path and the bunny300k leg
    python3 chip_smoke.py --sweep    # also time `mm_closest_hit` built
                                     # with 1, 2, 4 and 8 column slices
                                     # and 1 and 4 rays per thread, and
                                     # `cull_tiles` with at most 8, 16 and
                                     # 32 warps per block, aiming at 64, 128
                                     # and 256 warps per SM, on the device
    python3 chip_smoke.py --against _archive/parent
                                     # also time both tile kernels built
                                     # from another checkout's sources
                                     # against this one's, and the flagship
                                     # CLI renders of both trees, in turns
    python3 chip_smoke.py --cards 4  # phases 1, 6, 7 and 14 alone, 14c with
                                     # one rank on each of 4 cards, joined
                                     # by nccl (a machine with 4 cards)
    python3 chip_smoke.py --shard-rank SPEC.json RANK
                                     # one rank of phase 14c's worlds (the
                                     # script starts these itself)
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
    "cull_tiles": dict(source="metalpathtracer_torch/csrc/cull_tiles.cu",
                       replaces=f"{TPU_FILE}:712"),
    "threefry": dict(source="metalpathtracer_torch/csrc/threefry.cu",
                     replaces="benchmarks/mosaic_probe.py:42"),
}
# the large-scene legs of the reference's bench.py
LEG_W = LEG_H = 512
LEG_SPP, LEG_DEPTH, POOL = 2, 8, 1 << 15
# the flagship advance whose closest-hit and cull calls are captured
CAPTURE_CALL = 100
# an H100 SXM's published peaks (NVIDIA's data sheet, 700 W): f32 outside
# the tensor cores, and device memory
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
FLOP_PER_PAIR = 38  # 19 FMAs: the four determinants of one (ray, triangle)
CULL_FLOP_PER_PAIR = 12  # the slab test of one (ray, tile box)
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
# a collective of phase 14c's ranks, and a whole world of them, may take
RANK_TIMEOUT_S, WORLD_LIMIT_S = 120, 420
SWEEP_SLICES, SWEEP_RAYS = (1, 2, 4, 8), (1, 4)
SWEEP_WARPS, SWEEP_FILL = (8, 16, 32), (64, 128, 256)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    OUT): the innermost loop with the most FMULs is the slab-test loop,
    whose FMULs are 6 per (ray, tile) pair, so its instructions (NOPs
    aside) over its pairs are the instructions issued per pair. With the card's top SM
    clock (nvidia-smi clocks.max.sm) for the issue estimate."""
    text = sass(so, "cull_tiles")
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


def sass(so: Path, name: str) -> str:
    """`cuobjdump -sass` of a kernel's library, kept in OUT."""
    from metalpathtracer_torch.render.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    (OUT / f"sass_{name}.txt").write_text(text)
    return text


def top_sm_clock_hz() -> float:
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    return float(clock) * 1e6


def threefry_sass(so: Path) -> dict:
    """Per mode, the threefry kernel function's instructions up to its
    first EXIT without a predicate, as (address, opcode, predicated), and
    the address ranges its three operand branches skip (pixel, sample,
    bounce: the first three branches, each jumping over the loads of a
    per-lane operand when that operand is passed by value). The pair and
    triple functions branch nowhere else, which is checked: what a lane
    issues is then the function but for the skipped ranges (`lane_issue`)."""
    from metalpathtracer_torch.render.kernels import threefry as tfk

    names = {v: k for k, v in tfk.MODES.items()}
    per_mode = {}
    for chunk in sass(so, "threefry").split("Function : ")[1:]:
        m = re.search(r"threefry_kernelILi(\d)E", chunk.splitlines()[0])
        if not m:
            continue
        mode = names[int(m.group(1))]
        insts = []
        for i in map(SASS_INST.search, chunk.splitlines()):
            if not i or i.group(3) == "NOP":
                continue
            insts.append((int(i.group(1), 16), i.group(3), bool(i.group(2)),
                          i.group(4)))
            if i.group(3) == "EXIT" and not i.group(2):
                break
        branches = [(a, int(re.search(r"0x([0-9a-f]+)", rest).group(1), 16))
                    for a, op, _, rest in insts if op.startswith("BRA")]
        operands = branches[:3]
        for lo, hi in operands:
            if hi <= lo or not any(lo < a < hi and op.startswith("LDG")
                                   for a, op, _, _ in insts):
                raise RuntimeError(f"threefry {mode}: branch {lo:#x} -> {hi:#x} "
                                   f"skips no operand load")
        if mode != "unit_vector" and len(branches) != 3:
            raise RuntimeError(f"threefry {mode}: {len(branches)} branches in the "
                               f"SASS, the lane count follows 3")
        per_mode[mode] = dict(instructions=[(a, op, p) for a, op, p, _ in insts],
                              operands=operands)
    if sorted(per_mode) != sorted(tfk.MODES):
        raise RuntimeError(f"threefry: SASS functions for {sorted(per_mode)}")
    return dict(per_mode=per_mode, clock_hz=top_sm_clock_hz())


def lane_issue(fn, per_lane) -> dict:
    """What one lane of a threefry function (`threefry_sass`'s) issues when
    its operands (pixel, sample, bounce) are tensors where `per_lane` is
    true and values elsewhere: the instructions outside the ranges skipped
    for values, on the int32 ALU pipe, on the FMA pipe's integer side, and
    in all. An instruction under a predicate is left out, since a lane may
    skip it, so each count is a lower one."""
    skip = [r for r, lane in zip(fn["operands"], per_lane) if not lane]
    alu = fma = issued = 0
    for addr, op, predicated in fn["instructions"]:
        if predicated or any(lo < addr < hi for lo, hi in skip):
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


@contextlib.contextmanager
def plain_versions(which=("mm_closest_hit", "cull_tiles", "threefry")):
    """Route the kernels named in `which` through their plain versions."""
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import threefry as tfk

    plain = {"mm_closest_hit": (tmm, tmm.mm_closest_hit_reference),
             "cull_tiles": (tmm, tmm.cull_pass_reference),
             "threefry": (tfk, tfk.threefry_reference)}
    kernels = {k: getattr(plain[k][0], k) for k in which}
    for k in which:
        setattr(plain[k][0], k, plain[k][1])
    try:
        yield
    finally:
        for k, fn in kernels.items():
            setattr(plain[k][0], k, fn)


@contextlib.contextmanager
def counted_path():
    """Count one path's bounce steps, kernel launches and plain-version
    calls: every count is 0 on entry; the dict is filled on exit. Every
    bounce step must launch both tile kernels once and the RNG's at least
    twice (the lobe and the Fresnel draw), and no plain version may run."""
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import threefry as tfk

    calls = dict(steps=0, plain_mm=0, plain_cull=0, plain_threefry=0)
    originals = (tint._bounce_step, tmm.mm_closest_hit_reference,
                 tmm.cull_pass_reference, tfk.threefry_reference)

    def counter(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    tint._bounce_step = counter("steps", originals[0])
    tmm.mm_closest_hit_reference = counter("plain_mm", originals[1])
    tmm.cull_pass_reference = counter("plain_cull", originals[2])
    tfk.threefry_reference = counter("plain_threefry", originals[3])
    result = {}
    try:
        import torch

        torch.cuda.synchronize()
        tmm.mm_closest_hit.launches = 0
        tmm.cull_tiles.launches = 0
        tfk.threefry.launches = 0
        yield result
    finally:
        (tint._bounce_step, tmm.mm_closest_hit_reference,
         tmm.cull_pass_reference, tfk.threefry_reference) = originals
    result.update(calls, mm_launches=tmm.mm_closest_hit.launches,
                  cull_launches=tmm.cull_tiles.launches,
                  threefry_launches=tfk.threefry.launches)
    if calls["plain_mm"] or calls["plain_cull"] or calls["plain_threefry"]:
        raise RuntimeError(f"the path ran a plain version: {calls}")
    if calls["steps"] == 0 or min(result["mm_launches"],
                                  result["cull_launches"]) < calls["steps"]:
        raise RuntimeError(f"not every bounce step launched both kernels: {result}")
    if result["threefry_launches"] < 2 * calls["steps"]:
        raise RuntimeError(f"the bounce steps launched too few RNG kernels: {result}")


class SyncCounter:
    """Counts the synchronising CUDA calls torch makes (`torch.cuda`'s sync
    debug mode set to warn; the warnings are counted, not shown), in all
    and by the source line that made them (`sites`). The mode flags reads
    of device values on the host and also uploads of host scalars and
    small tensors from pageable memory."""

    def __init__(self):
        self.count = 0
        self.sites: dict[str, int] = {}

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
                site = f"{Path(filename).name}:{lineno}"
                self.sites[site] = self.sites.get(site, 0) + 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = count
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(self._mode)
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
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as ex:
        libs = dict(zip(KERNELS, ex.map(_build.build, KERNELS)))
    build_s = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    log(f"[1] built {len(libs)} kernels in {build_s:.2f} s; ptxas:")
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
    fns = tsass["per_mode"]
    log("[1] threefry SASS, instructions of each mode's kernel to its exit: "
        + ", ".join(f"{k} {len(v['instructions'])}" for k, v in fns.items())
        + "; a lane with every operand per lane issues (int32 ALU, IMAD, all): "
        + ", ".join("{} ({alu}, {fma}, {issued})".format(k, **lane_issue(fns[k], (True,) * 3))
                    for k in ("pair", "triple")) + "; a unit vector counts as a pair")
    return card, build_s, sass, tsass


def primary_and_bounce(scene, w, h, stride=1, draws=None):
    """Primary rays of every `stride`-th pixel of a w x h view from the
    default camera, and the rays one bounce later (with its live mask).
    `draws`, a list, receives the `threefry` calls' arguments (the jitter,
    the first bounce's lobe and Fresnel draws)."""
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
        o, d = generate_rays(Camera.reset(), w, h, pix, 0, seed)
        step = tint._bounce_step(
            scene, o, d, torch.zeros((n, 3), device=dev), torch.ones((n, 3), device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev), torch.zeros((n,), device=dev),
            pix, 0, 0, seed, tint.RenderConfig(),
        )
    if draws is not None:
        draws.extend(recorded)
    return {"primary": (o, d, None), "bounce1": (step[0], step[1], step[4])}


def closest_hit_set(scene, o, d, act):
    """`mm_closest_hit`'s arguments for rays (o, d) as `closest_hit_mm_full`
    makes them (the sphere pass's t as occlusion bound), with the rays."""
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    t_s = tmm._sphere_hit_exact(scene, o, d, T_MIN)[0]
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


def closest_hit_bound(args, walked):
    """The least time of one `mm_closest_hit` call on the card: the pairs
    its subgroups walked (walked x 128 x tile_p) at FLOP_PER_PAIR, and the
    bytes it must move (inputs once: features, lane bounds, counts, the
    walked list and smin entries, the distinct tiles walked at 64 B per
    triangle; outputs (t, col) once)."""
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
    # one subgroup's walk runs on one SM: the longest walk at one SM's share
    # of the peak is a second lower bound, which the uneven walks can exceed
    longest_ms = (int(walked.max()) * 128 * tile_p * FLOP_PER_PAIR
                  / (PEAK_F32_FLOPS / H100_SMS) * 1e3) if walked.numel() else 0.0
    q = torch.quantile(walked.float(), torch.tensor([0.5, 0.9], device=walked.device))
    return dict(pairs=pairs, tiles_read=tiles, bytes=nbytes,
                bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes",
                walked_p50=float(q[0]), walked_p90=float(q[1]),
                walked_max=int(walked.max()), longest_walk_ms=longest_ms)


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
        b = closest_hit_bound(args, wk)
        g = wk.numel()
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
            f"{100 * b['bound_ms'] / k_ms:.1f}% of it reached; the longest walk "
            f"on one SM {b['longest_walk_ms'] * 1e3:.2f} us")
    return record


def launcher(kernel: str, args, **build):
    """(launch, outputs): `launch()` runs `kernel` (the build that
    `_build.launch`'s `defines` / `csrc` select) on a set's arguments into
    outputs of its own, uncounted, as the sweep and the comparison with
    another checkout time it."""
    import torch

    from metalpathtracer_torch.render.kernels import _build

    if kernel == "mm_closest_hit":
        lists, counts, smin, x, lb, w, t_min = args
        g, nt = lists.shape
        outs = (torch.empty(g * 128, device=x.device),
                torch.empty(g * 128, dtype=torch.int32, device=x.device), None)
        ins, scalars = (lists, counts, smin, x, lb, w), (g, nt, w.shape[1], float(t_min))
    else:
        x, active, box, t_min, occ = args
        g, nt = x.shape[0] // 128, box.shape[0]
        outs = (torch.empty((g, nt), dtype=torch.bool, device=x.device),
                torch.empty((g, nt), device=x.device), torch.empty(g * 128, device=x.device))
        ins, scalars = (x, active, occ, box), (g, nt, float(t_min))

    def launch():
        _build.launch(kernel, ins, outs, scalars, x.device, **build)

    return launch, outs[:2] if outs[2] is None else outs


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
    the same render again). The images must equal the other tree's where
    both trees draw the same randoms and run the same kernels. A small
    render of each tree first builds its kernels."""
    import numpy as np

    code = ("import json, sys\nfrom metalpathtracer_torch import cli\n"
            "for _ in range(int(sys.argv[1])):\n    assert cli.main(sys.argv[2:]) == 0\n")

    def cli(tree, argv, times):
        proc = subprocess.run(
            [sys.executable, "-c", code, str(times), *argv, "--output",
             str(OUT / "against.png")], cwd=str(tree), capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree} {argv}: exit {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        return [json.loads(line)["seconds"] for line in
                proc.stdout.strip().splitlines()[-times:]]

    for tree in (other, ROOT):
        cli(tree, flagship_argv(64, 36), 1)
    record = {}
    for name, extra in (("scan", []), ("wavefront", ["--wavefront"])):
        seconds, images = {"other": [], "this": []}, {}
        for k, who in enumerate(("other", "this", "this", "other")):
            npz = OUT / f"against_{name}_{k}.npz"
            seconds[who].append(cli(other if who == "other" else ROOT,
                                    flagship_argv() + extra + ["--npz", str(npz)], 2))
            images.setdefault(who, radiance(npz))
            npz.unlink()
        same = bool(np.array_equal(images["other"], images["this"]))
        record[name] = dict(seconds=seconds, images_equal=same)
        log(f"[A] cli {name} 1280x720 spp 4 depth 32 (fresh process, again): other "
            + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in seconds["other"]) + " s; this "
            + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in seconds["this"])
            + f" s; images equal: {same}")
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
    before = tmm.mm_closest_hit.launches, tmm.cull_tiles.launches
    t1, i1, *_ = tmm.closest_hit_mm_full(scene, o, d, T_MIN)
    if (tmm.mm_closest_hit.launches, tmm.cull_tiles.launches) != (
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
    """`cull_tiles`' arguments for rays (o, d) as `closest_hit_mm_full`
    makes them (the sphere pass's t as occlusion bound)."""
    import torch

    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    t_s = tmm._sphere_hit_exact(scene, o, d, T_MIN)[0]
    a = (torch.ones((o.shape[0],), device=o.device) if act is None
         else act.to(torch.float32))
    return tmm.ray_features(o, d), a, scene.mm_tile_box, T_MIN, t_s


def cull_bound(args):
    """The least time of one `cull_tiles` call: CULL_FLOP_PER_PAIR on every
    (ray, tile) pair, and the bytes of its inputs and outputs once."""
    x, active, tile_box, _, occ = args
    n, nt = x.shape[0], tile_box.shape[0]
    nbytes = (x.numel() + active.numel() + occ.numel() + tile_box.numel()) * 4 \
        + (n // 128) * nt * 5 + n * 4
    flop_ms = n * nt * CULL_FLOP_PER_PAIR / PEAK_F32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(pairs=n * nt, bytes=nbytes, bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes")


def phase_cull(name, args, sass):
    """cull_tiles vs cull_pass_reference on the inputs closest_hit_mm_full
    gives them: bit-equal outputs, and both timed. `sass` (cull_sass) gives
    the issue estimate: the loop's instructions per pair at one per lane
    per clock of every SM at the card's top SM clock."""
    import torch

    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    out_k = tmm.cull_tiles(*args)
    out_r = tmm.cull_pass_reference(*args)
    torch.cuda.synchronize()
    for what, k, r in zip(("sgm", "gent", "lane_bound"), out_k, out_r):
        if not torch.equal(k, r):
            bad = int((k != r).sum())
            raise RuntimeError(f"cull_tiles vs plain ({name}): {what} differs "
                               f"at {bad} places")
    fin = torch.isfinite(out_r[1])
    err = float((out_k[1][fin] - out_r[1][fin]).abs().max()) if fin.any() else 0.0
    k_ms = device_ms(lambda: tmm.cull_tiles(*args))
    c_ms = call_ms(lambda: tmm.cull_tiles(*args), 20)
    r_ms = call_ms(lambda: tmm.cull_pass_reference(*args), 3)
    n, nt = args[0].shape[0], args[2].shape[0]
    b = cull_bound(args)
    issue_ms = n * nt * sass["per_pair"] / (H100_SMS * 128 * sass["clock_hz"]) * 1e3
    rec = dict(rays=n, tiles=nt, active=int((args[1] > 0.5).sum()), max_abs_err=err,
               passing=float(out_r[0].float().mean()), ms=k_ms, call_ms=c_ms,
               plain_ms=r_ms, **b, share=b["bound_ms"] / k_ms, issue_ms=issue_ms,
               issue_share=issue_ms / k_ms)
    log(f"    cull_tiles vs plain ({name}): {n} rays x {nt} tiles, bit-equal, "
        f"{rec['passing']:.4f} of (subgroup, tile) pairs pass; kernel {k_ms * 1e3:.2f} us on the device, {c_ms * 1e3:.2f} us "
        f"per call, plain {r_ms:.3f} ms; bound {b['bound_ms'] * 1e3:.2f} us "
        f"({b['bound_by']}), {100 * rec['share']:.1f}% of it reached; issue "
        f"estimate {issue_ms * 1e3:.2f} us ({100 * rec['issue_share']:.1f}%)")
    return rec


def flagship_argv(w=1280, h=720):
    return ["--scene", str(ROOT / "scenes" / "reference.xml"), "--width", str(w),
            "--height", str(h), "--spp", "4", "--max-depth", "32", "--stats-json",
            "--device", "cuda"]


class _Captured(Exception):
    pass


def _clone(args):
    import torch

    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def capture_calls(run, picks: dict, stop: bool):
    """`run()` with the three kernels wrapped. `picks` maps a name to
    `pick(i, lanes, k)`: asked at every `mm_closest_hit` call (the i-th of
    the run, the k-th on that many lanes, both from 1), and where it says
    yes that call's arguments and those of the `cull_tiles` call of the
    same advance are cloned under the name, and so are the arguments of
    every `threefry` call after it until the next `mm_closest_hit` call
    (the advance's draws: the scatter's, then the restart's jitter). With
    `stop` the run is ended at the call after the last pick. Returns
    {name: (mm_args, cull_args, [threefry_args, ...])}."""
    import torch

    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
    from metalpathtracer_torch.render.kernels import threefry as tfk

    kernels = tmm.mm_closest_hit, tmm.cull_tiles, tfk.threefry
    seen = {"mm": 0, "by_lanes": {}, "cull": None, "drawing": None}
    captured = {}

    def cull(*args, **kw):
        seen["cull"] = args  # (x, active, tile_box, t_min, occ)
        return kernels[1](*args, **kw)

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
        return kernels[0](*args, **kw)

    def draw(*args, **kw):
        if seen["drawing"] is not None:
            captured[seen["drawing"]][2].append(_clone(args))
        return kernels[2](*args, **kw)

    # the kernels count their launches on the module's names, which are
    # these wrappers while they are in place
    mm.launches = cull.launches = draw.launches = 0
    tmm.mm_closest_hit, tmm.cull_tiles, tfk.threefry = mm, cull, draw
    try:
        run()
    except _Captured:
        pass
    finally:
        tmm.mm_closest_hit, tmm.cull_tiles, tfk.threefry = kernels
    torch.cuda.synchronize()
    if len(captured) != len(picks):
        raise RuntimeError(f"captured {sorted(captured)} of {sorted(picks)}: the run "
                           f"made {seen['mm']} calls, by lanes {seen['by_lanes']}")
    return captured


@contextlib.contextmanager
def recorded_draws():
    """Every `threefry` call's arguments, cloned into the yielded list."""
    from metalpathtracer_torch.render.kernels import threefry as tfk

    kernel, draws = tfk.threefry, []

    def draw(*args, **kw):
        draws.append(_clone(args))
        return kernel(*args, **kw)

    draw.launches = 0
    tfk.threefry = draw
    try:
        yield draws
    finally:
        tfk.threefry = kernel


def capture_pool_call():
    """The CAPTURE_CALL-th `mm_closest_hit` call of the flagship wavefront
    render, and the `cull_tiles` and `threefry` calls of the same advance."""
    from metalpathtracer_torch import cli

    def run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            cli.main(flagship_argv() + ["--wavefront", "--output",
                                        str(OUT / "capture.png")])

    return capture_calls(run, {"pool": lambda i, lanes, k: i == CAPTURE_CALL},
                         stop=True)["pool"]


VIEWER_SIZE, VIEWER_DEPTH = (512, 288), 8  # the viewer's defaults
VIEWER_DRAIN = 1024  # the lanes a wavefront frame drains at


class NullDisplay:
    """Stands in for the viewer's display writer: keeps the last frame."""

    def post(self, img, status):
        self.last = img

    def post_text(self, text):
        pass


def viewer_loop(scene):
    from metalpathtracer_torch import viewer
    from metalpathtracer_torch.render.integrator import RenderConfig

    display = NullDisplay()
    return viewer._ViewerLoop(scene, *VIEWER_SIZE, 1,
                              RenderConfig(max_depth=VIEWER_DEPTH), 0, "wavefront",
                              display), display


def capture_viewer_calls(scene):
    """Of one viewer frame at the defaults: the 5th `mm_closest_hit` call on
    the viewer's pool and the first on the drain's lanes, each with its
    `cull_tiles` and `threefry` calls."""
    from metalpathtracer_torch import viewer

    loop, _ = viewer_loop(scene)
    return capture_calls(
        lambda: loop.step(lambda: []),
        {"viewer_pool": lambda i, lanes, k: lanes == viewer.POOL_SIZE and k == 5,
         "viewer_drain": lambda i, lanes, k: lanes == VIEWER_DRAIN and k == 1},
        stop=False)


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
                                   counts["steps"])
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
        log(f"[{6 if name == 'scan' else 7}] {name}: {stats['seconds']} s, "
            f"{stats['rays']} rays, {stats['mrays_per_sec']} Mrays/s, "
            f"{counts['steps']} bounce steps, launches: mm_closest_hit "
            f"{counts['mm_launches']}, cull_tiles {counts['cull_launches']}, "
            f"threefry {counts['threefry_launches']}; "
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
        rec = dict(seconds=dt, rays=rays, mrays_per_sec=rays / dt / 1e6,
                   image_mean=float(img.mean()), counts=counts,
                   tiles=scene.mm_tile_box.shape[0], **stats)
        if profile_on and name == "bunny300k":
            rec["profile"] = profile(leg, f"leg_{name}", counts["steps"])
        result[name] = rec
        torch.cuda.empty_cache()
        log(f"[8] {name} ({scene.num_tris} triangles, {rec['tiles']} tiles): "
            f"{dt:.3f} s, {rays} rays, {rec['mrays_per_sec']:.3f} Mrays/s, "
            f"{counts['steps']} bounce steps, launches: mm_closest_hit "
            f"{counts['mm_launches']}, cull_tiles {counts['cull_launches']}, "
            f"threefry {counts['threefry_launches']}; image mean {img.mean():.4f}")
    return result


def profile(fn, name, steps: int) -> str:
    """Run fn once more under torch.profiler; keep the kernel table. `steps`:
    the bounce steps (advances) of one run, for the kernels a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), tprofile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (OUT / f"profile_{name}.txt").write_text(table)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time for e in events)
    span_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events)) if events else 0.0
    ours = {}
    for e in events:
        for k in ("mm_closest_hit_kernel", "cull_tiles_kernel", "threefry_kernel"):
            if k in e.name:
                n, us = ours.get(k, (0, 0.0))
                ours[k] = (n + 1, us + e.device_time)
    summary = (f"device kernel time {busy_us / 1e3:.1f} ms over a device span of "
               f"{span_us / 1e3:.1f} ms ({len(events)} kernels, {len(events) / steps:.1f} "
               f"a bounce step), profiled wall "
               f"{wall:.3f} s; " + ", ".join(
                   f"{k} {n} launches, {us / 1e3:.2f} ms ({us / n:.1f} us each)"
                   for k, (n, us) in ours.items()))
    log(f"    profile {name}: {summary}; table in {OUT / f'profile_{name}.txt'}")
    return summary


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
        with plain_versions():
            b, rb = fn(scene, Camera.reset(), 320, 180, 2, seed=1, cfg=cfg)
        frac, dmean = compare_images(a.cpu().numpy(), b.cpu().numpy(),
                                     f"{name} kernels vs plain versions")
        result[name] = dict(divergent=frac, mean_diff=dmean, rays=ra, plain_rays=rb)
        log(f"[9] {name} 320x180 spp 2 depth 8, kernels vs plain: {frac:.5f} of "
            f"pixels differ by > 1e-3, means by {dmean:.2e}, rays {ra} vs {rb}; "
            "with the RNG's twin alone: bit-equal")

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
    launches = {k: c1[k] + c2[k] for k in
                ("steps", "mm_launches", "cull_launches", "threefry_launches")}
    for got in (launches, c3):
        for k in ("steps", "mm_launches", "cull_launches", "threefry_launches"):
            want = scan["counts"]["threefry_launches" if k[0] == "t" else "steps"]
            if got[k] != want:
                raise RuntimeError(f"checkpointed render: {k} {got[k]}, the scan "
                                   f"path made {want}")
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
        f"cull_tiles {c3['cull_launches']}, threefry {c3['threefry_launches']}; "
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
        f"launches: mm_closest_hit {wf['counts']['mm_launches']}, cull_tiles "
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
        f"cull_tiles {counts['cull_launches']} "
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
        f"{rec['mm_launches_per_frame']:g} launches, cull_tiles "
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
    import torch

    from metalpathtracer_torch import cli
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.intersect import closest_hit_bruteforce
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm
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
    before = tmm.mm_closest_hit.launches, tmm.cull_tiles.launches
    closest_hit_bvh(scene, o[:1024], d[:1024])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t1, i1 = closest_hit_bvh(scene, o, d, T_MIN)
    torch.cuda.synchronize()
    bvh_ms = (time.perf_counter() - t0) * 1e3
    if (tmm.mm_closest_hit.launches, tmm.cull_tiles.launches) != before:
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

    images = {}
    seconds = {}
    for kind in ("bvh", "mm"):
        argv = ["--scene", str(ROOT / "scenes" / "reference.xml"), "--width", "320",
                "--height", "180", "--spp", "2", "--max-depth", "8", "--device", "cuda",
                "--stats-json", "--intersector", kind, "--output",
                str(OUT / f"small_{kind}.png"), "--npz", str(OUT / f"small_{kind}.npz")]
        launches = tmm.mm_closest_hit.launches, tmm.cull_tiles.launches
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"cli.main --intersector {kind} returned {rc}")
        ran = tmm.mm_closest_hit.launches - launches[0]
        if (ran > 0) != (kind == "mm"):
            raise RuntimeError(f"--intersector {kind} launched {ran} closest-hit kernels")
        seconds[kind] = json.loads(out.getvalue().strip().splitlines()[-1])["seconds"]
        images[kind] = check_image(OUT / f"small_{kind}.npz", (180, 320, 3))
    frac, dmean = compare_images(images["bvh"], images["mm"], "bvh vs mm render")
    log(f"[13] cli --intersector bvh 320x180 spp 2 depth 8: {seconds['bvh']} s "
        f"(mm: {seconds['mm']} s); {frac:.5f} of pixels differ by > 1e-3, means by "
        f"{dmean:.2e}; no tile kernel launched")
    return dict(rays=o.shape[0], mismatches=n_mis, max_abs_err=float(err.max()),
                walk_ms=bvh_ms, mm_full_ms=mm_ms, render_s=seconds,
                upload_s=upload_s, upload_without_bvh_s=bare_s,
                render_divergent=frac, render_mean_diff=dmean)


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
            f"cull_tiles {counts['cull_launches']}, threefry "
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
    with counted_path() as counts:
        while state.spp < CONFIG5_SPP:
            t0 = time.perf_counter()
            state, r = sharding.accumulate_sharded(state, scene, cam, CONFIG5_STEP,
                                                   seed=5, cfg=cfg, mesh=mesh)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rays += r
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
        f"mm_closest_hit {counts['mm_launches']}, cull_tiles {counts['cull_launches']}, "
        f"threefry {counts['threefry_launches']}; "
        f"render_image_wavefront of {CONFIG5_SPP} spp {whole_s:.3f} s "
        f"({whole_counts['mm_launches']} launches); max |difference| {worst:.3g} "
        f"(rtol 1e-6, atol 1e-7), rays equal; image mean {float(img.mean()):.4f}")
    del scene
    torch.cuda.empty_cache()
    return dict(upload_s=upload_s, step_s=secs, rays=rays, counts=counts,
                whole_s=whole_s, whole_counts=whole_counts, max_abs_diff=worst,
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
                                  "threefry_launches")}
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
            f"{more['launches']['mm_launches']}, cull_tiles "
            f"{more['launches']['cull_launches']}, threefry "
            f"{more['launches']['threefry_launches']}), {more['rays']} rays, "
            f"{more['pixels_differing']} pixels differ from the world of one's "
            f"({one['pixels_differing']} of the lone rank's); {card}")
    log(f"[14c] whole worlds with start-up and uploads: one rank "
        f"{record['alone']['wall_s']:.1f} s, {ranks} ranks "
        f"{record['together']['wall_s']:.1f} s")
    return record


def phase_nee(card):
    """15: NEE + Russian roulette renders on the card against the same
    renders on the CPU."""
    import torch

    from metalpathtracer_torch.render.camera import Camera
    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.render.kernels import threefry as tfk
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
    cam = Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
    cfg = RenderConfig(max_depth=16, nee=True, rr_start=3)
    on_card, on_cpu = both("cornell_glass.xml")
    launches = _launches()
    draws = tfk.threefry.launches
    t0 = time.perf_counter()
    a, ra = render_image(on_card, cam, 512, 512, 2, seed=4, cfg=cfg)
    a = a.cpu().numpy()
    card_s = time.perf_counter() - t0
    if _launches() != launches:
        raise RuntimeError("cornell_glass has no triangle, yet a kernel was launched")
    draws = tfk.threefry.launches - draws
    if draws == 0:
        raise RuntimeError("config 4 launched no RNG kernel")
    t0 = time.perf_counter()
    b, rb = render_image(on_cpu, cam, 512, 512, 2, seed=4, cfg=cfg)
    cpu_s = time.perf_counter() - t0
    frac, dmean = compare_images(a, b.numpy(), "config 4 (NEE, rr_start 3) card vs CPU")
    if not a.mean() > 0.05 or abs(ra - rb) > 0.01 * rb:
        raise RuntimeError(f"config 4: mean {a.mean()}, rays {ra} vs {rb}")
    record["config4"] = dict(card_s=card_s, cpu_s=cpu_s, rays=ra, cpu_rays=rb,
                             divergent=frac, mean_diff=dmean, threefry_launches=draws)
    log(f"[15] config 4 (cornell_glass, NEE, rr_start 3) 512x512 spp 2 depth 16: "
        f"{card_s:.3f} s on the card ({card}), {cpu_s:.1f} s on the CPU; {ra} vs {rb} "
        f"rays; {frac:.5f} of pixels differ by > 1e-3, means by {dmean:.2e}; no "
        f"tile kernel launched (spheres alone), threefry {draws} launches")

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
        record[f"multimesh_{name}"] = dict(card_s=card_s, rays=out[1], cpu_rays=b[1],
                                           shadow_rays=shadow, counts=counts,
                                           divergent=frac, mean_diff=dmean)
        log(f"[15] multimesh NEE, rr_start 3, {name} 320x180 spp 2 depth 8: "
            f"{card_s:.3f} s on the card, {out[1]} vs {b[1]} rays"
            + (f" ({shadow} shadow rays)" if shadow is not None else "")
            + f", launches: mm_closest_hit {counts['mm_launches']}, cull_tiles "
            f"{counts['cull_launches']}, threefry {counts['threefry_launches']} over "
            f"{counts['steps']} bounce steps; "
            f"{frac:.5f} of pixels differ by > 1e-3, means by {dmean:.2e}")
    torch.cuda.empty_cache()
    return record


def draw_sets(scan_draws, pool_draws, of_viewer):
    """Phase 16's draws by name: the probe's call and those captured (the
    scan's 921,600-lane jitter and first bounce, the flagship's advance at
    call CAPTURE_CALL, a viewer frame's pool call 5 and drain call 1)."""
    import torch

    dev = pool_draws[0][1].device
    probe = torch.arange(1024, dtype=torch.int32, device=dev).reshape(8, 128)
    sets = {"probe": (42, probe, 3, 0, 7, "unit_vector")}
    for where, draws in (("scan", scan_draws), ("pool", pool_draws),
                         *((k, v[2]) for k, v in of_viewer.items())):
        for args in draws:
            name = f"{where}_{PURPOSE_NAMES.get(args[4], args[4])}"
            while name in sets:
                name += "'"
            sets[name] = args
    return sets


def draw_bound(args, tsass):
    """The least time of one `threefry` call: its bytes (each tensor
    operand read once, the output written once) at the memory rate, and
    what its lanes issue (`lane_issue` of the mode's function with this
    call's operands) at the pipes' rates on every SM at the card's top SM
    clock. A unit vector is counted at the pair's lane: its own function
    adds the mapping's float work and branches to sinf/cosf's range
    reduction for |t| > 105,615, which no t in [0, 2 pi) takes."""
    import math

    import torch

    from metalpathtracer_torch.render.kernels import threefry as tfk

    lanes = [v for v in args[1:4] if isinstance(v, torch.Tensor)]
    n = math.prod(tfk._broadcast_shapes(v.shape for v in lanes))
    mode = args[5]
    nbytes = sum(v.numel() * v.element_size() for v in lanes) + n * 4 * (
        2 if mode == "pair" else 3)
    lane = lane_issue(tsass["per_mode"]["triple" if mode == "triple" else "pair"],
                      [isinstance(v, torch.Tensor) for v in args[1:4]])
    op_ms = n * lane["clocks"] / (H100_SMS * tsass["clock_hz"]) * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(lanes=n, bytes=nbytes, lane_issue=lane, bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes")


def phase_threefry(sets, tsass):
    """16: `threefry` vs its plain twin at every captured shape: uniforms
    bit-equal, unit vectors bit-equal or within 4 ulp of 1.0 (the gap
    stated); each timed on the device, per call and plain."""
    import torch

    from metalpathtracer_torch.render.kernels import threefry as tfk

    ulp = float(torch.finfo(torch.float32).eps)
    record = {}
    for name, args in sets.items():
        got = tfk.threefry(*args)
        want = tfk.threefry_reference(*args)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise RuntimeError(f"threefry {name}: shape {tuple(got.shape)} vs "
                               f"{tuple(want.shape)}")
        differ = int((got != want).sum())
        err = float((got - want).abs().max()) if differ else 0.0
        if differ and (args[5] != "unit_vector" or err > 4 * ulp):
            raise RuntimeError(f"threefry {name} ({args[5]}): {differ} values differ "
                               f"from the twin, by at most {err:.3g}")
        k_ms = device_ms(lambda: tfk.threefry(*args))
        c_ms = call_ms(lambda: tfk.threefry(*args), 20)
        p_ms = call_ms(lambda: tfk.threefry_reference(*args), 3)
        b = draw_bound(args, tsass)
        record[name] = dict(mode=args[5], purpose=args[4], differ=differ,
                            max_abs_err=err, max_ulp=err / ulp, ms=k_ms, call_ms=c_ms,
                            plain_ms=p_ms, **b, share=b["bound_ms"] / k_ms)
        kinds = ", ".join("int" if isinstance(v, int) else
                          f"{str(v.dtype)[6:]}{tuple(v.shape)}" for v in args[1:4])
        lane = b["lane_issue"]
        log(f"    threefry {name} ({args[5]}, {b['lanes']} lanes; pixel, sample, "
            f"bounce: {kinds}): "
            + ("bit-equal to the twin" if not differ else
               f"{differ} values differ by at most {err / ulp:.1f} ulp of 1.0")
            + f"; kernel {k_ms * 1e3:.2f} us on the device, {c_ms * 1e3:.2f} us per "
            f"call, twin {p_ms:.3f} ms; bound {b['bound_ms'] * 1e3:.2f} us "
            f"({b['bound_by']}: {b['bytes']} bytes; a lane issues {lane['alu']} int32 "
            f"ALU, {lane['fma']} IMAD, {lane['issued']} in all), "
            f"{100 * b['bound_ms'] / k_ms:.1f}% of it reached")
        if b["bound_ms"] > k_ms:
            raise RuntimeError(f"threefry {name}: the kernel took {k_ms * 1e3:.2f} us, "
                               f"less than its bound {b['bound_ms'] * 1e3:.2f} us: "
                               f"the bound counts more than the call must do")
    return record


def _launches():
    from metalpathtracer_torch.render.kernels import intersect_mm as tmm

    return tmm.mm_closest_hit.launches, tmm.cull_tiles.launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the wavefront path and the bunny300k leg")
    ap.add_argument("--sweep", action="store_true",
                    help="also time mm_closest_hit built with 1, 2, 4 and 8 "
                         "column slices per tile and 1 and 4 rays per thread, "
                         "and cull_tiles with at most 8, 16 and 32 warps per "
                         "block aiming at 64, 128 and 256 warps per SM")
    ap.add_argument("--against", metavar="DIR",
                    help="also time both tile kernels built from the sources "
                         "of the checkout DIR against this one's, and run both "
                         "trees' flagship CLI renders, in turns, images compared")
    ap.add_argument("--cards", type=int, default=1, metavar="N",
                    help="run phases 1, 6, 7 and 14 alone, phase 14c with one "
                         "rank on each of N cards joined by nccl")
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
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        return 0

    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.scene import load_scene_xml, presets

    dev = torch.device("cuda")
    scene = upload_scene(load_scene_xml(str(ROOT / "scenes" / "reference.xml")), dev)
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
    mm_pool, cull_pool, pool_draws = capture_pool_call()
    of_viewer = capture_viewer_calls(scene)
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
    log("[4] cull_tiles vs its plain version")
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
    log("[16] threefry vs its plain twin: the probe's call, the scan's 921,600-lane "
        f"draws, the draws of the flagship's advance {CAPTURE_CALL} and of a viewer "
        "frame's pool call 5 and drain call 1")
    t0 = time.perf_counter()
    draws = phase_threefry(draw_sets(scan_draws, pool_draws, of_viewer), tsass)
    log(f"[16] {len(draws)} draws compared and timed in "
        f"{time.perf_counter() - t0:.1f} s")
    del scan_draws, pool_draws
    sweep = against = None
    if args.sweep:
        log(f"[S] mm_closest_hit with {SWEEP_SLICES} column slices per tile and "
            f"{SWEEP_RAYS} rays per thread; cull_tiles with at most {SWEEP_WARPS} "
            f"warps per block, aiming at {SWEEP_FILL} warps per SM")
        sweep = {
            "mm_closest_hit": phase_sweep("mm_closest_hit", {
                f"K={k},R={r}": (f"MM_SLICES={k}", f"MM_RAYS={r}")
                for r in SWEEP_RAYS for k in SWEEP_SLICES}, mm_sets),
            "cull_tiles": phase_sweep("cull_tiles", {
                f"W={w},F={f}": (f"CULL_WARPS={w}", f"CULL_FILL={f}")
                for f in SWEEP_FILL for w in SWEEP_WARPS}, cull_sets)}
    if args.against:
        log(f"[A] both kernels built from {args.against} and from this checkout")
        against = phase_against(Path(args.against).resolve(),
                                {"cull_tiles": cull_sets, "mm_closest_hit": mm_sets})
        against["renders"] = phase_against_renders(Path(args.against).resolve())
    del leg_sets, sets, sets256, mm_sets, mm_pool, cull_pool, cull_sets, of_viewer

    paths = phase_paths(args.profile)
    legs = phase_legs(big, args.profile)
    small = phase_small_vs_plain(scene)
    scan = dict(image=paths["scan"].pop("image"), counts=paths["scan"]["counts"])
    checkpointed = phase_checkpoint(scan)
    progressive = phase_progressive(scene, scan["image"])
    viewer = phase_viewer(scene)
    bvh = phase_bvh(ref_sets, 32768, chunk=1024)
    del scene, big, ref_sets
    torch.cuda.empty_cache()
    sharded_cli = phase_sharded_cli(paths)
    config5, after_two = phase_config5()
    two_ranks = phase_ranks(sharded_cli, after_two, card)
    del after_two
    for name in ("scan", "wavefront"):  # compared; what comes back stays small
        (OUT / f"tile_shard_{name}.npz").unlink()
    nee = phase_nee(card)

    main_path = paths["wavefront"]["counts"]
    # the main path's shapes: the pool call, and its advance's lobe draw
    mm, cl, tf = kvt["pool"], cull["reference_pool"], draws["pool_lobe"]
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
             launches_by_path={k: v["mm_launches"] for k, v in per_path.items()}),
        dict(name="cull_tiles", route="cuda", **KERNELS["cull_tiles"],
             launches=main_path["cull_launches"], max_abs_err=cl["max_abs_err"],
             ms=cl["ms"], call_ms=cl["call_ms"], plain_ms=cl["plain_ms"],
             bound_ms=cl["bound_ms"],
             bound_by=cl["bound_by"], share=cl["share"], library_ms=None,
             launches_by_path={k: v["cull_launches"] for k, v in per_path.items()}),
        # torch.rand is Philox, another function: no PyTorch call computes it
        dict(name="threefry", route="cuda", **KERNELS["threefry"],
             launches=main_path["threefry_launches"],
             max_abs_err=max(v["max_abs_err"] for v in draws.values()),
             ms=tf["ms"], call_ms=tf["call_ms"], plain_ms=tf["plain_ms"],
             bound_ms=tf["bound_ms"], bound_by=tf["bound_by"], share=tf["share"],
             library_ms=None,
             launches_by_path={k: v["threefry_launches"] for k, v in per_path.items()}),
    ]}
    summary = dict(card=card, build_s=build_s, cull_sass=sass, against=against,
                   mm_vs_twin=kvt, oracle=oracle,
                   cull_vs_plain=cull, mm_vs_twin_tile_p256=kvt256,
                   oracle_tile_p256=oracle256,
                   threefry_lane={k: lane_issue(tsass["per_mode"][k], (True,) * 3)
                                  for k in ("pair", "triple")},
                   threefry_vs_twin=draws, sweep=sweep, paths=paths, legs=legs,
                   small_vs_plain=small, checkpointed=checkpointed,
                   progressive=progressive, viewer=viewer, bvh=bvh,
                   sharded_cli=sharded_cli, config5=config5, two_ranks=two_ranks,
                   nee=nee,
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
