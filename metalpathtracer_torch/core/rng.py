"""Counter-based threefry-2x32 RNG with positional sample streams.

Port of `metalpathtracer_tpu/core/rng.py`. Every draw is a pure function of
(global seed, pixel id, sample index, bounce, purpose), so a pixel gets the
same randoms whatever device, batch or lane renders it, and the port draws
bit for bit the same u32 words as the JAX reference.

The draws (`uniform1`, `uniform2`, `uniform3`, `random_unit_vector`) go
through `render/kernels/threefry.py::threefry`, and `draws` makes several
of one (seed, pixel, sample, bounce) through `threefry_bundle`: on the card
one launch of the CUDA kernel `csrc/threefry.cu` a call, on the CPU its
plain twin, which is that module's `threefry2x32` (re-exported here) and
the mappings.
"""

from __future__ import annotations

from metalpathtracer_torch.render.kernels import threefry as _kernel
from metalpathtracer_torch.render.kernels.threefry import (  # noqa: F401 (the twin)
    _u32,
    bits_to_uniform,
    threefry2x32,
)

# Draw purposes within one (pixel, sample, bounce) step: no two draws in a
# bounce share a counter.
PURPOSE_JITTER_X = 0  # sub-pixel jitter
PURPOSE_LOBE = 1  # BSDF lobe / scatter direction
PURPOSE_FRESNEL = 2  # dielectric reflect-vs-refract
PURPOSE_RR = 3  # Russian-roulette survival
PURPOSE_LIGHT = 4  # next-event-estimation light sampling
PURPOSE_LENS = 5  # depth-of-field lens sampling (future)
PURPOSE_LIGHT_PICK = 6  # which light the NEE shadow ray targets


def _draw(seed, pixel_id, sample_id, bounce, purpose, mode):
    # looked up on the module at every draw, so that a caller may swap it
    return _kernel.threefry(seed, pixel_id, sample_id, bounce, purpose, mode)


def draws(seed, pixel_id, sample_id, bounce, spec):
    """Every draw of `spec`, a tuple of (purpose, mode) with the modes of
    `render/kernels/threefry.py`, for one (seed, pixel, sample, bounce): a
    tuple of tensors in `spec`'s order, each what `uniform1` ("single"),
    `uniform2` ("pair", stacked), `uniform3` ("triple", stacked) or
    `random_unit_vector` ("unit_vector") gives for its purpose."""
    # looked up on the module at every call, as `_draw` is
    return _kernel.threefry_bundle(seed, pixel_id, sample_id, bounce, spec)


def uniform2(seed, pixel_id, sample_id, bounce, purpose):
    """Two independent U[0,1) float32 tensors shaped like `pixel_id`.

    `seed` is a u32 scalar; `pixel_id` an integer tensor of lane ids;
    `sample_id`/`bounce` are ints or broadcastable integer tensors, and
    `purpose` an int.
    """
    u = _draw(seed, pixel_id, sample_id, bounce, purpose, "pair")
    return u[0], u[1]


def uniform1(seed, pixel_id, sample_id, bounce, purpose):
    """The first of `uniform2`'s uniforms, drawn alone."""
    return _draw(seed, pixel_id, sample_id, bounce, purpose, "single")


def uniform3(seed, pixel_id, sample_id, bounce, purpose):
    """Three independent U[0,1) floats per lane (two counter blocks)."""
    u = _draw(seed, pixel_id, sample_id, bounce, purpose, "triple")
    return u[0], u[1], u[2]


def random_unit_vector(seed, pixel_id, sample_id, bounce, purpose=PURPOSE_LOBE):
    """Uniform point on the unit sphere, shaped `pixel_id.shape + (3,)`:
    z = 2u1 - 1, t = 2 pi u2, r = sqrt(1 - z^2) with independent u1, u2."""
    return _draw(seed, pixel_id, sample_id, bounce, purpose, "unit_vector")


def seed_from_int(seed: int) -> int:
    """The u32 seed word of a Python int (negative and wide ints wrap)."""
    return seed & 0xFFFFFFFF
