"""The port's threefry RNG (`metalpathtracer_torch.core.rng`) against the JAX
reference, on the same numpy inputs.

Tolerances:
- threefry words and `seed_from_int` must be bit-equal: the port emulates
  uint32 arithmetic in int64 with a mask after every add and shift, so any
  difference is a bug, not rounding;
- uniforms must be bit-equal: the top 24 bits of a word times 2^-24 is an
  exact float32 conversion on both sides;
- `random_unit_vector` goes through sin/cos, which torch and XLA evaluate
  with different approximations: within 4 ulp of 1.0 (the components lie
  in [-1, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.core import rng as trng
from metalpathtracer_tpu.core import rng as jrng

SEEDS = [0, 1, 42, -1, -123456789, 2**32, 2**32 + 7, 2**40 + 3, 0xFFFFFFFF]
SAMPLES = [0, 3, 2**32 - 1]
BOUNCES = [0, 7, 31]
PURPOSES = [
    jrng.PURPOSE_JITTER_X, jrng.PURPOSE_LOBE, jrng.PURPOSE_FRESNEL,
    jrng.PURPOSE_RR, jrng.PURPOSE_LIGHT, jrng.PURPOSE_LENS,
    jrng.PURPOSE_LIGHT_PICK,
]
ULP_1 = float(np.finfo(np.float32).eps)  # one ulp of 1.0f


def _pixel_ids() -> np.ndarray:
    """Edge ids up to 2^32 - 1 plus random ones, as uint64."""
    r = np.random.default_rng(0)
    edges = np.array([0, 1, 255, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                     np.uint64)
    return np.concatenate([edges, r.integers(0, 2**32, 249, dtype=np.uint64)])


PIX = _pixel_ids()
PIX_J = jnp.asarray(PIX.astype(np.uint32))
PIX_T = torch.as_tensor(PIX.astype(np.int64))


def _words(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_u32_wraps_python_ints():
    assert int(trng._u32(-1)) == 0xFFFFFFFF
    assert int(trng._u32(2**32 + 5)) == 5
    assert int(trng._u32(-(2**40) - 1)) == (-(2**40) - 1) & 0xFFFFFFFF
    assert int(trng._u32(torch.tensor(-2))) == 0xFFFFFFFE


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_from_int_matches(seed):
    assert trng.seed_from_int(seed) == int(jrng.seed_from_int(seed))


def test_threefry_known_answer():
    # the same vector JAX's own threefry is checked with in tests/test_rng.py
    from jax._src.prng import threefry_2x32

    k = np.array([0x13198A2E, 0x03707344], np.uint32)
    c = np.arange(64, dtype=np.uint32)
    expected = np.asarray(threefry_2x32(k, c)).reshape(2, 32).astype(np.int64)
    g0, g1 = trng.threefry2x32(int(k[0]), int(k[1]),
                               torch.arange(32), torch.arange(32, 64))
    np.testing.assert_array_equal(g0.numpy(), expected[0])
    np.testing.assert_array_equal(g1.numpy(), expected[1])


@pytest.mark.parametrize("k0", [0, 0x13198A2E, -7, 2**33 + 9])
@pytest.mark.parametrize("k1", [0, 0xFFFFFFFF, 2**32 + 1])
def test_threefry_words_bit_equal(k0, k1):
    r = np.random.default_rng(k0 & 0xFFFF)
    c1 = r.integers(0, 2**32, PIX.shape[0], dtype=np.uint64)
    j0, j1 = jrng.threefry2x32(k0, k1, PIX_J, jnp.asarray(c1.astype(np.uint32)))
    t0, t1 = trng.threefry2x32(k0, k1, PIX_T, torch.as_tensor(c1.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy(), _words(j0))
    np.testing.assert_array_equal(t1.numpy(), _words(j1))


_juniform2 = jax.jit(jrng.uniform2)
_juniform3 = jax.jit(jrng.uniform3)


@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_bit_equal(seed, sample):
    seed_u32 = seed & 0xFFFFFFFF
    for bounce in BOUNCES:
        for purpose in PURPOSES:
            ju0, ju1, ju2 = _juniform3(jnp.uint32(seed_u32), PIX_J,
                                       jnp.uint32(sample), jnp.uint32(bounce),
                                       jnp.uint32(purpose))
            tu0, tu1, tu2 = trng.uniform3(seed, PIX_T, sample, bounce, purpose)
            for t, j in ((tu0, ju0), (tu1, ju1), (tu2, ju2)):
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            tu1_only = trng.uniform1(seed, PIX_T, sample, bounce, purpose)
            np.testing.assert_array_equal(tu1_only.numpy(), np.asarray(ju0))


def test_uniform_with_tensor_bounce_and_sample():
    # per-lane bounce and sample tensors draw the same words as scalars
    bounce = torch.arange(PIX.shape[0]) % 32
    sample = torch.arange(PIX.shape[0]) * 977
    tu0, tu1 = trng.uniform2(9, PIX_T, sample, bounce, jrng.PURPOSE_LIGHT)
    ju0, ju1 = _juniform2(jnp.uint32(9), PIX_J,
                          jnp.asarray(sample.numpy().astype(np.uint32)),
                          jnp.asarray(bounce.numpy().astype(np.uint32)),
                          jnp.uint32(jrng.PURPOSE_LIGHT))
    np.testing.assert_array_equal(tu0.numpy(), np.asarray(ju0))
    np.testing.assert_array_equal(tu1.numpy(), np.asarray(ju1))


@pytest.mark.parametrize("seed", [0, -1, 2**32 + 7])
@pytest.mark.parametrize("bounce", [0, 5])
def test_random_unit_vector_within_ulps(seed, bounce):
    j = np.asarray(jrng.random_unit_vector(jnp.uint32(seed & 0xFFFFFFFF),
                                           PIX_J, jnp.uint32(4), bounce))
    t = trng.random_unit_vector(seed, PIX_T, 4, bounce).numpy()
    assert t.shape == j.shape == (PIX.shape[0], 3)
    np.testing.assert_allclose(t, j, rtol=0, atol=4 * ULP_1)
