"""Build, load and launch the hand-written CUDA kernels.

Each kernel is a plain C entry point `<name>_launch(pointers..., scalars...,
device, stream, tally)` that returns a CUDA error code, beside
`<name>_error_string(code)`, in `csrc/<source>.cu`: its own file, or another
kernel's where `SOURCES` says so (two entry points of one source). A source
is compiled with `nvcc` for Hopper (`sm_90a`) into a shared library under
`metalpathtracer_torch/_build/` at first use, keyed on a hash of the source
and the flags, loaded with `ctypes`, and launched on the current stream by
`launch`.

Every launch also adds to its kernel's `tally` on the device: thread 0 of
block 0 adds one launch (and the threefry kernel its draws, the closest hit
its launches that shared walks over thread block clusters, the list cull its
launches that sorted by radix, the shading its launches with the bank). A
CUDA graph's replay runs the kernels it captured, and so moves their
tallies as eager launches do, while it runs none of the wrappers' Python. Nothing here runs
at import time: the CPU-only test environment imports every module and has
no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the log
)
# the kernels whose entry point lives in another kernel's source: the
# closest hit's front end in the sphere pass's (the same kernel, which
# without feature pointers writes the sphere winner alone); the shading
# from the closest hit's raw winners (the epilogue in registers, the
# wavefront's bank where given) in the shading's; the wavefront's four
# regeneration kernels in one source; the cull that sorts its rows into the
# closest hit's lists in the plain cull's
SOURCES = {"cull_tile_lists": "cull_tiles", "hit_front": "sphere_pass",
           "shade_hit": "shade", "restart_lanes": "wavefront",
           "queue_pop": "wavefront", "tileset_key": "wavefront",
           "permute_lanes": "wavefront"}
# flags of one source's build: the bounce step's, the restart's and the
# cull's kernels round every product on their own, as their plain versions'
# separate torch kernels do (nvcc would contract a * b + c into one FMA)
KERNEL_FLAGS = {name: ("-fmad=false",)
                for name in ("cull_tiles", "sphere_pass", "hit_epilogue", "shade",
                             "wavefront")}


def device_of(kernel: str, x: torch.Tensor) -> str:
    """"cpu" or "cuda", the device type of `x` that `kernel`'s wrapper
    serves (the CPU by the plain twin); raises on any other."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for device {x.device}")
    return x.device.type


def source_of(kernel: str) -> str:
    """The `csrc/<source>.cu` stem that holds `kernel`'s entry point."""
    return SOURCES.get(kernel, kernel)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(candidate):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "build only where the CUDA toolkit is installed"
        )
    return candidate


def build(name: str, defines: tuple = (), csrc: Path = CSRC_DIR) -> Path:
    """Compile the source of kernel `name` (`<csrc>/<source_of(name)>.cu`)
    unless a library of the same source and flags exists; `defines`
    ("NAME=value", ...) become -D flags (a sweep's variants of a
    compile-time constant), and `csrc` may name another checkout's sources
    (a comparison with an earlier kernel). The compiler's output goes to
    `<library>.log`."""
    name = source_of(name)
    # the source and every header beside it (`#include "*.cuh"`)
    src = b"".join(p.read_bytes() for p in [Path(csrc) / f"{name}.cu",
                                             *sorted(Path(csrc).glob("*.cuh"))])
    flags = (*NVCC_FLAGS, *KERNEL_FLAGS.get(name, ()), *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    so = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(Path(csrc) / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_name(so.name + ".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never load a torn file
    return so


@functools.cache
def load_library(name: str, defines: tuple = (), csrc: Path = CSRC_DIR) -> ctypes.CDLL:
    """The loaded library of kernel `name`'s source (one load a source)."""
    if name in SOURCES:
        return load_library(SOURCES[name], defines, csrc)
    return ctypes.CDLL(str(build(name, defines, csrc)))


# each kernel's C entry point: its pointer count and scalar types (the
# device, the stream and the tally follow them)
ENTRY_ARGS = {
    # n_groups, n_tiles, tile_p, t_min, the cluster width
    "mm_closest_hit": (9, (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_int)),
    "cull_tiles": (7, (ctypes.c_int, ctypes.c_int, ctypes.c_float)),
    "cull_tile_lists": (8, (ctypes.c_int, ctypes.c_int, ctypes.c_float)),
    # n, seed, the draw count and 8 packed draws, then (layout, value) of
    # pixel, sample, bounce
    "threefry": (4, (ctypes.c_longlong, ctypes.c_uint32, ctypes.c_int)
                 + (ctypes.c_uint64,) * 8 + (ctypes.c_int, ctypes.c_uint32) * 3),
    # n, the sphere count, t_min
    "hit_front": (13, (ctypes.c_longlong, ctypes.c_int, ctypes.c_float)),
    # n, whether there are triangles, the sphere count, t_min
    "hit_epilogue": (15, (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float)),
    # n, whether there are triangles, the sphere count, t_min, rr_start,
    # adaptive offset, the bounce's (layout, value), then the bank's
    # max_depth, clamp, bank_k (0: no bank), spb, per_item
    "shade_hit": (35, (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong)),
    # n, width, height, groups, bank_k, spb, pixel_offset, row_stride, the seed word
    "restart_lanes": (19, (ctypes.c_longlong,) * 8 + (ctypes.c_uint32,)),
    # n, the accumulator's width, total, groups
    "queue_pop": (9, (ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong)),
    # n, the coarse boxes, t_min
    "tileset_key": (5, (ctypes.c_longlong, ctypes.c_int, ctypes.c_float)),
    # n, the accumulator's width
    "permute_lanes": (29, (ctypes.c_longlong, ctypes.c_int)),
}


def check_tensors(kernel: str, expect, device):
    """Raise unless every (name, tensor, dtype, shape) of `expect` has its
    dtype and shape and lies on `device`."""
    for name, tensor, dtype, shape in expect:
        if tensor.dtype != dtype or tuple(tensor.shape) != shape:
            raise ValueError(
                f"{kernel}: {name} must be {dtype} {shape}, "
                f"got {tensor.dtype} {tuple(tensor.shape)}"
            )
        if tensor.device != device:
            raise ValueError(f"{kernel}: {name} is on {tensor.device}, "
                             f"not {device}")


@functools.cache
def entry(kernel: str, defines: tuple = (), csrc: Path = CSRC_DIR):
    """(launch, error_string) of `kernel`'s library, typed for ctypes."""
    lib = load_library(kernel, defines, csrc)
    n_ptr, scalars = ENTRY_ARGS[kernel]
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [*scalars, ctypes.c_int,
                                               ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{kernel}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def launch(kernel: str, inputs, outputs, scalars, device, defines: tuple = (),
           csrc: Path = CSRC_DIR, align: int = 16):
    """Launch `kernel` on `device`'s current stream: pointers of `inputs`
    and `outputs` (None passes a null pointer), then `scalars`. Inputs must
    be contiguous and `align`-byte aligned. `defines` selects a build of the
    source with those preprocessor definitions (a sweep's variants), and
    `csrc` a build of another checkout's source of the same entry point (a
    comparison); the render path takes the package's own source and
    constants. Raises on a refused launch."""
    for tensor in inputs:
        if tensor is not None and (not tensor.is_contiguous()
                                   or tensor.data_ptr() % align):
            raise ValueError(f"{kernel}: inputs must be contiguous and "
                             f"{align}-byte aligned")
    fn, err = entry(kernel, tuple(defines), csrc)
    rc = fn(*(None if v is None else v.data_ptr() for v in (*inputs, *outputs)),
            *scalars, device.index or 0,
            torch.cuda.current_stream(device).cuda_stream,
            tally(kernel, device).data_ptr())
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {rc} ({err(rc).decode()})"
        )


_tallies: dict = {}


def tally(kernel: str, device) -> torch.Tensor:
    """`kernel`'s (launches, draws) on `device` since the last
    `zero_tallies`, a (2,) int64 tensor there that the kernel adds to
    itself (the closest hit's second slot: its clustered launches;
    `cull_tile_lists`': its launches that sorted by radix; `shade_hit`'s:
    its launches with the bank, `shade_bank_hit_kernel<K>`'s). Made
    at the kernel's first launch on the device, which a stream capture may
    not be: it would capture the zeroing (a graph's warm-up launches
    first)."""
    key = (kernel, torch.device(device).index or 0)
    found = _tallies.get(key)
    if found is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}: first launch on {device} inside a "
                               "stream capture; launch it once before")
        found = _tallies[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return found


def tallies(device) -> dict:
    """{kernel: (launches, draws)} of every kernel launched on `device`
    (`mm_closest_hit`: (launches, clustered launches); `cull_tile_lists`:
    (launches, radix launches); `shade_hit`: (launches, launches with the
    bank)): one read of the
    device, after the work queued before it."""
    index = torch.device(device).index or 0
    names = [k for k, i in _tallies if i == index]
    if not names:
        return {}
    rows = torch.stack([_tallies[(k, index)] for k in names]).tolist()
    return {k: tuple(r) for k, r in zip(names, rows)}


def zero_tallies() -> None:
    """Every tally at 0, queued on each tally's device."""
    for t in _tallies.values():
        t.zero_()
