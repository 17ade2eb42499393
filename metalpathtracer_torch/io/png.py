"""Minimal dependency-free PNG encoder for render output.

Copy of `metalpathtracer_tpu/io/png.py` (numpy only): the JAX package's
`io/__init__` also loads its checkpoint module, which imports jax, so the
port carries its own. Linear radiance -> sRGB 8-bit PNG via zlib.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 transfer curve on linear [0,1] radiance."""
    img = np.clip(img, 0.0, 1.0)
    return np.where(
        img <= 0.0031308, img * 12.92, 1.055 * np.power(img, 1 / 2.4) - 0.055
    )


def write_png(path: str, img: np.ndarray, srgb: bool = True) -> None:
    """Write (H, W, 3) float linear [0,1] or uint8 image as RGB PNG."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
    if img.dtype != np.uint8:
        f = linear_to_srgb(img.astype(np.float32)) if srgb else np.clip(img, 0, 1)
        img = (f * 255.0 + 0.5).astype(np.uint8)

    h, w, _ = img.shape
    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
