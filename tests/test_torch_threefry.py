"""The RNG kernel's wrapper (`metalpathtracer_torch.render.kernels.threefry`)
on the CPU, where it runs its plain twin, against the JAX reference's
`core/rng.py`, on the same inputs.

The kernel replaces the Pallas kernel of `benchmarks/mosaic_probe.py`, whose
call is written out here (that script sets environment defaults when it is
imported): `threefry2x32(42, pix, 3, 7)` over pix = arange(1024) as an
(8, 128) int32 tile, mapped to the unit sphere, which the probe holds to
`random_unit_vector(42, arange(1024), 3, 0, purpose=7)`.

Tolerances: uniforms are bit-equal (the top 24 bits of a u32 word times
2^-24 is exact on both sides); unit vectors go through sin/cos, which torch
and XLA approximate differently: within 4 ulp of 1.0, as
tests/test_torch_rng.py holds them. The kernel itself is held to the twin,
bit-equal, on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.core import rng as trng
from metalpathtracer_torch.render.kernels import threefry as tfk
from metalpathtracer_tpu.core import rng as jrng

ULP_1 = float(np.finfo(np.float32).eps)
N = 257


def _j_uniforms(seed, pix, sample, bounce, purpose, high=0):
    """The reference's two uniforms of one counter block, as numpy."""
    c1 = ((jnp.asarray(np.asarray(bounce, np.uint64).astype(np.uint32))
           << jnp.uint32(8)) | jnp.uint32(purpose) | jnp.uint32(high))
    b0, b1 = jrng.threefry2x32(seed & 0xFFFFFFFF,
                               jnp.asarray(np.asarray(pix).astype(np.uint32)),
                               jnp.asarray(np.asarray(sample, np.uint64)
                                           .astype(np.uint32)), c1)
    return (np.asarray(jrng.bits_to_uniform(b0)),
            np.asarray(jrng.bits_to_uniform(b1)))


def test_probe_call_matches_the_reference():
    # benchmarks/mosaic_probe.py:63-94: pix (8, 128) int32, seed 42, sample
    # 3, c1 = 7 (bounce 0, purpose 7); the kernel's (3, 8, 128) planes are
    # stacked to (1024, 3) against the reference's vectors
    pix = torch.arange(1024, dtype=torch.int32).reshape(8, 128)
    got = trng.random_unit_vector(42, pix, 3, 0, purpose=7)
    assert got.shape == (8, 128, 3) and got.dtype == torch.float32
    planes = got.permute(2, 0, 1).numpy()  # the probe's out_ref layout
    stacked = np.stack([planes[0].reshape(-1), planes[1].reshape(-1),
                        planes[2].reshape(-1)], axis=-1)
    ref = np.asarray(jrng.random_unit_vector(
        jnp.uint32(42), jnp.arange(1024, dtype=jnp.uint32), jnp.uint32(3),
        jnp.uint32(0), purpose=7))
    np.testing.assert_allclose(stacked, ref, rtol=0, atol=4 * ULP_1)
    # the probe's own words: threefry2x32(seed, pix, 3, 7)
    ju0, ju1 = _j_uniforms(42, np.arange(1024), 3, 0, 7)
    z = 2.0 * ju0 - 1.0
    np.testing.assert_array_equal(stacked[:, 2], z.astype(np.float32))
    pair = tfk.threefry(42, pix, 3, 0, 7, "pair")
    np.testing.assert_array_equal(pair[0].reshape(-1).numpy(), ju0)
    np.testing.assert_array_equal(pair[1].reshape(-1).numpy(), ju1)


def _operands(seed_rng, per_lane: bool, dtype):
    pix = seed_rng.integers(0, 2**32, N, dtype=np.uint64)
    sample = seed_rng.integers(0, 2**34, N, dtype=np.uint64)  # some >= 2^32
    bounce = seed_rng.integers(0, 40, N, dtype=np.uint64)
    pix_t = torch.as_tensor(pix.astype(np.int64)).to(dtype)
    if per_lane:
        return (pix, sample, bounce), (pix_t, torch.as_tensor(sample.astype(np.int64)),
                                       torch.as_tensor(bounce.astype(np.int64)))
    s, b = 2**32 + 5, 7
    return (pix, np.full(N, s % 2**32, np.uint64), np.full(N, b, np.uint64)), (pix_t, s, b)


@pytest.mark.parametrize("seed", [0, -1, 2**32 + 7])
@pytest.mark.parametrize("per_lane", [False, True], ids=["scalar", "per_lane"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_operands_bit_equal_to_the_reference(seed, per_lane, dtype):
    r = np.random.default_rng(abs(seed) % 97)
    (pix, sample, bounce), (pix_t, s_t, b_t) = _operands(r, per_lane, dtype)
    if dtype == torch.int32:  # an int32 id wraps to the same u32 word
        pix = pix_t.numpy().astype(np.int64) & 0xFFFFFFFF
    ju0, ju1 = _j_uniforms(seed, pix, sample, bounce, trng.PURPOSE_LIGHT)
    u = tfk.threefry(seed, pix_t, s_t, b_t, trng.PURPOSE_LIGHT, "pair")
    assert u.shape == (2, N) and u.dtype == torch.float32
    np.testing.assert_array_equal(u[0].numpy(), ju0)
    np.testing.assert_array_equal(u[1].numpy(), ju1)
    # uniform3's second block sets c1's top bit
    j2, _ = _j_uniforms(seed, pix, sample, bounce, trng.PURPOSE_LIGHT, 0x80000000)
    u3 = tfk.threefry(seed, pix_t, s_t, b_t, trng.PURPOSE_LIGHT, "triple")
    assert u3.shape == (3, N)
    np.testing.assert_array_equal(u3[0].numpy(), ju0)
    np.testing.assert_array_equal(u3[2].numpy(), j2)
    ref3 = np.asarray(jrng.uniform3(
        jnp.uint32(seed & 0xFFFFFFFF), jnp.asarray(pix.astype(np.uint32)),
        jnp.asarray(sample.astype(np.uint32)), jnp.asarray(bounce.astype(np.uint32)),
        jnp.uint32(trng.PURPOSE_LIGHT)))
    np.testing.assert_array_equal(torch.stack(trng.uniform3(
        seed, pix_t, s_t, b_t, trng.PURPOSE_LIGHT)).numpy(), ref3)


def test_two_dimensional_ids_and_single_element_operands():
    # a 2-D pixel_id keeps its shape; 0-d and one-element tensors broadcast
    pix = torch.arange(6 * 40, dtype=torch.int64).reshape(6, 40) * 7919
    ju0, ju1 = _j_uniforms(9, pix.numpy().reshape(-1), np.full(240, 11),
                           np.full(240, 3), trng.PURPOSE_FRESNEL)
    for sample, bounce in ((11, 3), (torch.tensor(11), torch.tensor([3])),
                           (torch.full((6, 40), 11), torch.tensor(3, dtype=torch.int32))):
        u = tfk.threefry(9, pix, sample, bounce, trng.PURPOSE_FRESNEL, "pair")
        assert u.shape == (2, 6, 40)
        np.testing.assert_array_equal(u[0].reshape(-1).numpy(), ju0)
        np.testing.assert_array_equal(u[1].reshape(-1).numpy(), ju1)
        v = tfk.threefry(9, pix, sample, bounce, trng.PURPOSE_FRESNEL, "unit_vector")
        assert v.shape == (6, 40, 3)
        np.testing.assert_array_equal(v[..., 2].reshape(-1).numpy(),
                                      (2.0 * ju0 - 1.0).astype(np.float32))


def test_draws_are_the_wrappers_outputs():
    # core/rng.py's draws are views of one wrapper call each
    pix = torch.arange(64)
    u = tfk.threefry(5, pix, 2, 1, trng.PURPOSE_LOBE, "pair")
    u1, u2 = trng.uniform2(5, pix, 2, 1, trng.PURPOSE_LOBE)
    assert torch.equal(u1, u[0]) and torch.equal(u2, u[1])
    assert torch.equal(trng.uniform1(5, pix, 2, 1, trng.PURPOSE_LOBE), u[0])
    assert torch.equal(trng.random_unit_vector(5, pix, 2, 1),
                       tfk.threefry(5, pix, 2, 1, trng.PURPOSE_LOBE, "unit_vector"))


def test_cpu_runs_the_twin_and_counts_no_launch():
    before = tfk.threefry.launches
    out = tfk.threefry(1, torch.arange(8), 0, 0, 0, "triple")
    assert tfk.threefry.launches == before
    assert torch.equal(out, tfk.threefry_reference(1, torch.arange(8), 0, 0, 0,
                                                   "triple"))


def test_unsupported_device_and_mode_raise():
    meta = torch.empty(16, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfk.threefry(0, meta, 0, 0, 0, "pair")
    with pytest.raises(ValueError, match="no kernel"):
        trng.uniform1(0, meta, 0, 0, 0)
    with pytest.raises(ValueError, match="unknown mode"):
        tfk.threefry(0, torch.arange(4), 0, 0, 0, "quad")


def test_operand_layouts():
    # what the kernel is handed: ints by value (mod 2^32), int32/int64
    # tensors per lane without a copy, one element for every lane, other
    # integer types widened; floats and other devices refused
    cpu = torch.device("cpu")
    assert tfk._operand("s", -1, (4,), 4, cpu) == (None, 0, 0xFFFFFFFF)
    assert tfk._operand("s", np.int64(2**32 + 3), (4,), 4, cpu) == (None, 0, 3)
    lanes = torch.arange(4, dtype=torch.int32)
    t, layout, _ = tfk._operand("s", lanes, (4,), 4, cpu)
    assert layout == 4 and t.data_ptr() == lanes.data_ptr()
    one = torch.tensor(5)
    t, layout, _ = tfk._operand("s", one, (4,), 4, cpu)
    assert layout == -8 and t.data_ptr() == one.data_ptr()
    t, layout, _ = tfk._operand("s", torch.arange(4, dtype=torch.uint8), (4,), 4, cpu)
    assert layout == 8 and t.dtype == torch.int64
    t, layout, _ = tfk._operand("s", torch.arange(2)[:, None], (2, 3), 6, cpu)
    assert layout == 8 and t.shape == (2, 3) and t.is_contiguous()
    with pytest.raises(ValueError, match="integer"):
        tfk._operand("s", torch.zeros(4), (4,), 4, cpu)
    with pytest.raises(ValueError, match="is on meta"):
        tfk._operand("s", torch.empty(4, dtype=torch.int64, device="meta"),
                     (4,), 4, cpu)


@pytest.mark.parametrize("shapes", [[(5,), (5,), (5,)], [(5,), ()], [(2, 1), (3,)],
                                    [(1, 4), (3, 1), (4,)], [(0,), (1,)]])
def test_broadcast_shapes_as_torch(shapes):
    assert tfk._broadcast_shapes(shapes) == tuple(torch.broadcast_shapes(*shapes))


def test_broadcast_shapes_refuses_what_torch_refuses():
    with pytest.raises(ValueError, match="do not broadcast"):
        tfk._broadcast_shapes([(3,), (4,)])
