"""The RNG's draws on the card: threefry-2x32 and its mappings in one kernel.

Port of the Pallas kernel of `benchmarks/mosaic_probe.py` (`kernel`, :42),
which computes the reference's `core/rng.py` sampler inside one kernel:
threefry-2x32 of (seed, pixel id, sample id, bounce, purpose), the top 24
bits of each word as a uniform, and a uniform point on the unit sphere.
`threefry` draws for every lane in one of three modes:

    "pair"         (2, *shape) f32: both words' uniforms (uniform2, uniform1)
    "triple"       (3, *shape) f32: the pair and the first word of a second
                   block with c1's top bit set (uniform3)
    "unit_vector"  (*shape, 3) f32: random_unit_vector's point

CUDA operands launch the CUDA kernel `csrc/threefry.cu` (and count the
launch in `threefry.launches`); CPU operands take the plain twin
`threefry_reference`: `threefry2x32` below, whose words are bit-equal to
the reference's, and the mappings op by op. Any other device raises. The
twin and the kernel draw the same words and the same uniforms; the unit
vectors round every operation alike.

torch has almost no uint32 arithmetic, so the twin keeps u32 words in
int64 tensors holding values in [0, 2^32), and masks every add and shift
with `& 0xFFFFFFFF` to wrap as uint32 does.
"""

from __future__ import annotations

import itertools
import math
import numbers

import torch

from metalpathtracer_torch.render.kernels import _build

MODES = {"pair": 0, "triple": 1, "unit_vector": 2}
_INDEX_BYTES = {torch.int32: 4, torch.int64: 8}
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # threefry key-schedule parity constant
_MASK = 0xFFFFFFFF
_HIGH = 0x80000000  # c1 bit of uniform3's second block


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


def threefry_reference(seed, pixel_id, sample_id, bounce, purpose, mode: str):
    """Plain torch twin of the kernel: the int64 threefry above and the
    op-by-op mappings, stacked as the kernel writes them."""
    c1 = _counter1(bounce, purpose)
    b0, b1 = threefry2x32(seed, pixel_id, sample_id, c1)
    u0, u1 = bits_to_uniform(b0), bits_to_uniform(b1)
    if mode == "pair":
        return torch.stack([u0, u1])
    if mode == "triple":
        c1 = _counter1(bounce, purpose, _HIGH)
        b2, _ = threefry2x32(seed, pixel_id, sample_id, c1)
        return torch.stack([u0, u1, bits_to_uniform(b2)])
    if mode != "unit_vector":
        raise ValueError(f"threefry: unknown mode {mode!r}")
    z = 2.0 * u0 - 1.0
    t = (2.0 * math.pi) * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(t), r * torch.sin(t), z], dim=-1)


def _broadcast_shapes(shapes):
    """The broadcast of `shapes`, as `torch.broadcast_shapes` gives it;
    that function imports sympy on its first call, ~5 s of a fresh
    process on the card's host."""
    shapes = [tuple(s) for s in shapes]
    if all(s == shapes[0] for s in shapes):
        return shapes[0]
    out = []
    for dims in itertools.zip_longest(*(s[::-1] for s in shapes), fillvalue=1):
        sizes = set(dims) - {1}
        if len(sizes) > 1:
            raise ValueError(f"threefry: shapes {shapes} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out[::-1])


def _operand(name: str, v, shape, n: int, device):
    """(tensor or None, layout, value) of one lane operand for the kernel:
    a Python int by value; a tensor per lane (layout = its index bytes) or
    one element for every lane (minus that), without a copy where it is
    int32 or int64 and contiguous."""
    if isinstance(v, numbers.Integral):
        return None, 0, int(v) & _MASK
    if not isinstance(v, torch.Tensor) or v.dtype.is_floating_point or \
            v.dtype.is_complex:
        raise ValueError(f"threefry: {name} must be an int or an integer "
                         f"tensor, got {type(v).__name__} "
                         f"{getattr(v, 'dtype', '')}")
    if v.device != device:
        raise ValueError(f"threefry: {name} is on {v.device}, not {device}")
    if v.dtype not in _INDEX_BYTES:
        v = v.to(torch.int64)
    if v.numel() == 1 and n != 1:
        return v.contiguous(), -_INDEX_BYTES[v.dtype], 0
    if v.numel() != n:
        v = v.expand(shape)
    v = v.contiguous()
    return v, _INDEX_BYTES[v.dtype], 0


def threefry(seed, pixel_id, sample_id, bounce, purpose, mode: str):
    """Draws of `mode` (see the module) for every lane of the broadcast
    shape of `pixel_id`, `sample_id` and `bounce`: each an int or an integer
    tensor, reduced mod 2^32. `seed` and `purpose` are ints. The operands'
    device picks the route: CUDA launches `csrc/threefry.cu`, the CPU runs
    `threefry_reference`, any other device raises. On the card no operand
    is read on the host and a Python int never becomes a tensor, so a call
    can be captured in a CUDA graph."""
    if mode not in MODES:
        raise ValueError(f"threefry: unknown mode {mode!r}")
    lanes = [v for v in (pixel_id, sample_id, bounce)
             if isinstance(v, torch.Tensor)]
    device = lanes[0].device if lanes else torch.device("cpu")
    if device.type == "cpu":
        return threefry_reference(seed, pixel_id, sample_id, bounce, purpose,
                                  mode)
    if device.type != "cuda":
        raise ValueError(f"threefry: no kernel for device {device}")
    if not (isinstance(seed, numbers.Integral)
            and isinstance(purpose, numbers.Integral)):
        raise ValueError("threefry: seed and purpose must be Python ints on "
                         "the card")
    shape = _broadcast_shapes(v.shape for v in lanes)
    n = math.prod(shape)
    ops = [_operand(name, v, shape, n, device) for name, v in
           (("pixel_id", pixel_id), ("sample_id", sample_id), ("bounce", bounce))]
    out_shape = (*shape, 3) if mode == "unit_vector" else \
        (3 if mode == "triple" else 2, *shape)
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    if n == 0:
        return out
    scalars = [n, MODES[mode], int(seed) & _MASK, int(purpose) & _MASK]
    for _, layout, value in ops:
        scalars += [layout, value]
    _build.launch("threefry", [t for t, _, _ in ops], (out,), scalars, device,
                  align=4)
    threefry.launches += 1
    return out


threefry.launches = 0
