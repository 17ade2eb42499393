"""ctypes bindings for the native C++ BVH builder (native/bvh_builder.cpp).

Copy of `metalpathtracer_tpu/accel/native.py` (numpy and ctypes only).
Same output contract as the NumPy builder (`accel/bvh.py`); used
automatically for large scenes where Python-side sweeps get slow, when the
shared library `native/libmptbvh.so` has been built (`make -C native`);
`build_bvh` takes the NumPy builder otherwise. The port never builds it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from metalpathtracer_torch.accel.bvh import BVHArrays, LEAF_SIZE

_LIB_PATHS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native", "libmptbvh.so"),
    "libmptbvh.so",
]

_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    for path in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.mpt_build_bvh.restype = ctypes.c_int
        lib.mpt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # lo
            ctypes.POINTER(ctypes.c_float),  # hi
            ctypes.c_int,  # n
            ctypes.c_int,  # leaf_size
            ctypes.POINTER(ctypes.c_float),  # node_lo
            ctypes.POINTER(ctypes.c_float),  # node_hi
            ctypes.POINTER(ctypes.c_int),  # node_a
            ctypes.POINTER(ctypes.c_int),  # node_b
            ctypes.POINTER(ctypes.c_int),  # prim_indices
        ]
        if lib.mpt_abi_version() == 1:
            _lib = lib
            return _lib
    _load_failed = True
    return None


def native_available() -> bool:
    return _load() is not None


def build_bvh_native(
    lo: np.ndarray, hi: np.ndarray, leaf_size: int = LEAF_SIZE
) -> BVHArrays:
    """Build via the C++ builder. Raises RuntimeError if unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native BVH builder not built; run `make -C native`"
        )
    n = lo.shape[0]
    if n == 0:
        raise ValueError("cannot build BVH over zero primitives")
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    node_lo = np.zeros((2 * n, 3), np.float32)
    node_hi = np.zeros((2 * n, 3), np.float32)
    node_a = np.zeros(2 * n, np.int32)
    node_b = np.zeros(2 * n, np.int32)
    prim_indices = np.zeros(n, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    num = lib.mpt_build_bvh(
        lo.ctypes.data_as(fp),
        hi.ctypes.data_as(fp),
        n,
        leaf_size,
        node_lo.ctypes.data_as(fp),
        node_hi.ctypes.data_as(fp),
        node_a.ctypes.data_as(ip),
        node_b.ctypes.data_as(ip),
        prim_indices.ctypes.data_as(ip),
    )
    if num <= 0:
        raise RuntimeError(f"native BVH build failed (rc={num})")
    return BVHArrays(
        node_lo=node_lo[:num],
        node_hi=node_hi[:num],
        node_a=node_a[:num],
        node_b=node_b[:num],
        prim_indices=prim_indices,
        num_nodes=int(num),
    )
