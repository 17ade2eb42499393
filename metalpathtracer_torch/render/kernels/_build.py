"""Build, load and launch the hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C entry point
`<name>_launch(pointers..., scalars..., device, stream)` that returns a CUDA
error code, and `<name>_error_string(code)`. It is compiled with `nvcc` for
Hopper (`sm_90a`) into a shared library under `metalpathtracer_torch/_build/`
at first use, keyed on a hash of the source and the flags, loaded with
`ctypes`, and launched on the current stream by `launch`. Nothing here runs
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
    """Compile `<csrc>/<name>.cu` unless a library of the same source and
    flags exists; `defines` ("NAME=value", ...) become -D flags (a sweep's
    variants of a compile-time constant), and `csrc` may name another
    checkout's sources (a comparison with an earlier kernel). The
    compiler's output goes to `<library>.log`."""
    src = (Path(csrc) / f"{name}.cu").read_bytes()
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
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
    return ctypes.CDLL(str(build(name, defines, csrc)))


# each kernel's C entry point: its pointer count and scalar types (the
# device and the stream follow them)
ENTRY_ARGS = {
    "mm_closest_hit": (9, (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float)),
    "cull_tiles": (7, (ctypes.c_int, ctypes.c_int, ctypes.c_float)),
    # n, mode, seed, purpose, then (layout, value) of pixel, sample, bounce
    "threefry": (4, (ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32,
                     ctypes.c_uint32) + (ctypes.c_int, ctypes.c_uint32) * 3),
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
                                               ctypes.c_void_p]
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
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {rc} ({err(rc).decode()})"
        )
