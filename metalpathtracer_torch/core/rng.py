"""Counter-based threefry-2x32 RNG with positional sample streams.

Port of `metalpathtracer_tpu/core/rng.py`. Every draw is a pure function of
(global seed, pixel id, sample index, bounce, purpose), so a pixel gets the
same randoms whatever device, batch or lane renders it, and the port draws
bit for bit the same u32 words as the JAX reference.

torch has almost no uint32 arithmetic, so u32 words live in int64 tensors
holding values in [0, 2^32), and every add and shift is masked with
`& 0xFFFFFFFF` to wrap as uint32 does.
"""

from __future__ import annotations

import math

import torch

# Draw purposes within one (pixel, sample, bounce) step: no two draws in a
# bounce share a counter.
PURPOSE_JITTER_X = 0  # sub-pixel jitter
PURPOSE_LOBE = 1  # BSDF lobe / scatter direction
PURPOSE_FRESNEL = 2  # dielectric reflect-vs-refract
PURPOSE_RR = 3  # Russian-roulette survival
PURPOSE_LIGHT = 4  # next-event-estimation light sampling
PURPOSE_LENS = 5  # depth-of-field lens sampling (future)
PURPOSE_LIGHT_PICK = 6  # which light the NEE shadow ray targets

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # threefry key-schedule parity constant
_MASK = 0xFFFFFFFF


def _u32(x, device=None) -> torch.Tensor:
    """Coerce to a u32 word in an int64 tensor, wrapping Python ints
    (negative seeds, >32-bit values) and int tensors mod 2^32."""
    if isinstance(x, int):
        return torch.tensor(x & _MASK, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, over broadcastable u32 words (Python ints
    or integer tensors). Returns two int64 tensors of u32 words; bit-equal
    to the reference's `threefry2x32`."""
    device = next(
        (v.device for v in (k0, k1, c0, c1) if isinstance(v, torch.Tensor)),
        None,
    )
    k0 = _u32(k0, device)
    k1 = _u32(k1, device)
    x0 = _u32(c0, device)
    x1 = _u32(c1, device)

    ks = (k0, k1, _PARITY ^ k0 ^ k1)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK

    for block in range(5):  # 5 blocks of 4 rounds = 20 rounds
        rots = _ROTATIONS[0:4] if block % 2 == 0 else _ROTATIONS[4:8]
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        # key injection after each 4-round block
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _MASK
    return x0, x1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """u32 word -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (2.0**-24)


def _counter1(bounce, purpose, high: int = 0):
    """Second counter word: (bounce << 8) | purpose | high, as u32."""
    if isinstance(bounce, int) and isinstance(purpose, int):
        return (((bounce & _MASK) << 8) | (purpose & _MASK) | high) & _MASK
    return (((_u32(bounce) << 8) & _MASK) | _u32(purpose) | high) & _MASK


def uniform2(seed, pixel_id, sample_id, bounce, purpose):
    """Two independent U[0,1) float32 tensors shaped like `pixel_id`.

    `seed` is a u32 scalar; `pixel_id` an integer tensor of lane ids;
    `sample_id`/`bounce`/`purpose` are scalars or broadcastable tensors.
    """
    c1 = _counter1(bounce, purpose)
    b0, b1 = threefry2x32(seed, pixel_id, sample_id, c1)
    return bits_to_uniform(b0), bits_to_uniform(b1)


def uniform1(seed, pixel_id, sample_id, bounce, purpose):
    u, _ = uniform2(seed, pixel_id, sample_id, bounce, purpose)
    return u


def uniform3(seed, pixel_id, sample_id, bounce, purpose):
    """Three independent U[0,1) floats per lane (two counter blocks)."""
    u0, u1 = uniform2(seed, pixel_id, sample_id, bounce, purpose)
    c1 = _counter1(bounce, purpose, 0x80000000)
    b0, _ = threefry2x32(seed, pixel_id, sample_id, c1)
    return u0, u1, bits_to_uniform(b0)


def random_unit_vector(seed, pixel_id, sample_id, bounce, purpose=PURPOSE_LOBE):
    """Uniform point on the unit sphere, shaped `pixel_id.shape + (3,)`:
    z = 2u1 - 1, t = 2 pi u2, r = sqrt(1 - z^2) with independent u1, u2."""
    u1, u2 = uniform2(seed, pixel_id, sample_id, bounce, purpose)
    z = 2.0 * u1 - 1.0
    t = (2.0 * math.pi) * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(t), r * torch.sin(t), z], dim=-1)


def seed_from_int(seed: int) -> int:
    """The u32 seed word of a Python int (negative and wide ints wrap)."""
    return seed & _MASK
