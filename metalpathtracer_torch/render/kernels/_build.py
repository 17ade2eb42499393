"""Build and load the hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C entry point. It is
compiled with `nvcc` for Hopper (`sm_90a`) into a shared library under
`metalpathtracer_torch/_build/` at first use, keyed on a hash of the source
and the flags, and loaded with `ctypes`. Nothing here runs at import time:
the CPU-only test environment imports every module and has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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
