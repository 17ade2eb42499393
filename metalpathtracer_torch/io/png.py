"""Minimal dependency-free PNG encoder (and reader) for render output.

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


def read_png(path: str) -> np.ndarray:
    """Read back an 8-bit RGB PNG written by `write_png` (tests/round-trip
    only: no interlace, no palette, filter-0 scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("only 8-bit RGB supported")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    prev = np.zeros(w * 3, np.uint8)
    for y in range(h):
        line = raw[y * stride : (y + 1) * stride]
        filt, body = line[0], np.frombuffer(line[1:], np.uint8).copy()
        if filt == 0:
            row = body
        elif filt == 2:  # Up
            row = (body + prev).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        rows.append(row)
        prev = row
    return np.stack(rows).reshape(h, w, 3)
