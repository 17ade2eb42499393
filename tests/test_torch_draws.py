"""A bounce step's draws in one call: `threefry_bundle` (the RNG kernel's
wrapper, `metalpathtracer_torch.render.kernels.threefry`), `core/rng.py`'s
`draws` and the bounce step that makes them, on the CPU, where the wrapper
runs its plain twin, against the JAX reference's `core/rng.py` on the same
inputs.

Tolerances: every draw of a bundle is bit-equal to the same draw made
alone (`threefry_reference`), and a bounce step through one bundle is
bit-equal to the same step through its separate draws: the same words and
the same op-by-op mappings. Against the reference, uniforms are bit-equal
(the top 24 bits of a u32 word times 2^-24 is exact on both sides); unit
vectors go through sin/cos, which torch and XLA approximate differently:
within 4 ulp of 1.0, as tests/test_torch_rng.py holds them. The kernel
itself is held to the twin, bit-equal, on the card
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.core import rng as trng
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render.camera import Camera
from metalpathtracer_torch.render.device_scene import upload_scene
from metalpathtracer_torch.render.kernels import threefry as tfk
from metalpathtracer_torch.render.pipeline import generate_rays
from metalpathtracer_torch.scene import presets
from metalpathtracer_tpu.core import rng as jrng

ULP_1 = float(np.finfo(np.float32).eps)
N = 193

# every bundle the paths make, and a bundle of one in each mode
SPECS = {
    "step": tint._step_draws(False, False),
    "nee_rr_step": tint._step_draws(True, True),
    "nee_step": tint._step_draws(True, False),
    "rr_step": tint._step_draws(False, True),
    "single": ((trng.PURPOSE_FRESNEL, "single"),),
    "pair": ((trng.PURPOSE_JITTER_X, "pair"),),
    "triple": ((trng.PURPOSE_LIGHT, "triple"),),
    "unit_vector": ((7, "unit_vector"),),
}


def _operands(seed_rng, per_lane: bool, dtype):
    """(numpy u64 words, the port's operands) as tests/test_torch_threefry.py
    makes them: pixel ids of `dtype`, samples up to 2^34, bounces under 40;
    per lane, or sample and bounce as ints."""
    pix = seed_rng.integers(0, 2**32, N, dtype=np.uint64)
    sample = seed_rng.integers(0, 2**34, N, dtype=np.uint64)
    bounce = seed_rng.integers(0, 40, N, dtype=np.uint64)
    pix_t = torch.as_tensor(pix.astype(np.int64)).to(dtype)
    if dtype == torch.int32:  # an int32 id wraps to the same u32 word
        pix = pix_t.numpy().astype(np.int64).astype(np.uint64) & 0xFFFFFFFF
    if per_lane:
        return (pix, sample, bounce), (pix_t, torch.as_tensor(sample.astype(np.int64)),
                                       torch.as_tensor(bounce.astype(np.int64)))
    s, b = 2**32 + 9, 5
    return (pix, np.full(N, s % 2**32, np.uint64), np.full(N, b, np.uint64)), (pix_t, s, b)


def _reference_draw(seed, words, purpose, mode):
    """The JAX reference's draw of `mode`, as numpy."""
    pix, sample, bounce = (jnp.asarray(w.astype(np.uint32)) for w in words)
    args = (jnp.uint32(seed & 0xFFFFFFFF), pix, sample, bounce)
    if mode == "unit_vector":
        return np.asarray(jrng.random_unit_vector(*args, purpose=purpose))
    draw = {"single": jrng.uniform1, "pair": jrng.uniform2, "triple": jrng.uniform3}[mode]
    out = draw(*args, jnp.uint32(purpose))
    return np.asarray(out) if mode == "single" else np.stack([np.asarray(u) for u in out])


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("per_lane", [False, True], ids=["by_value", "per_lane"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_bundle_bit_equal_to_single_draws_and_the_reference(spec, per_lane, dtype):
    seed = -3
    r = np.random.default_rng(len(spec) + 2 * per_lane)
    words, (pix, sample, bounce) = _operands(r, per_lane, dtype)
    draws = SPECS[spec]
    got = tfk.threefry_bundle(seed, pix, sample, bounce, draws)
    assert len(got) == len(draws)
    for (purpose, mode), g in zip(draws, got):
        alone = tfk.threefry_reference(seed, pix, sample, bounce, purpose, mode)
        assert g.dtype == torch.float32 and g.shape == alone.shape
        assert torch.equal(g, alone), (purpose, mode)
        want = _reference_draw(seed, words, purpose, mode)
        assert g.shape == want.shape
        if mode == "unit_vector":
            np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=4 * ULP_1)
        else:
            np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("per_lane", [False, True], ids=["by_value", "per_lane"])
def test_single_is_the_pairs_first_row_and_uniform1(per_lane):
    r = np.random.default_rng(11)
    _, (pix, sample, bounce) = _operands(r, per_lane, torch.int64)
    single, pair = tfk.threefry_bundle(8, pix, sample, bounce,
                                       ((trng.PURPOSE_RR, "single"),
                                        (trng.PURPOSE_RR, "pair")))
    assert torch.equal(single, pair[0])
    assert torch.equal(trng.uniform1(8, pix, sample, bounce, trng.PURPOSE_RR), single)
    u3 = trng.uniform3(8, pix, sample, bounce, trng.PURPOSE_RR)
    assert torch.equal(u3[0], single)


def test_rng_draws_is_the_bundle():
    pix = torch.arange(50)
    spec = SPECS["nee_rr_step"]
    got = trng.draws(4, pix, 1, 2, spec)
    want = tfk.threefry_bundle(4, pix, 1, 2, spec)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got[0], trng.random_unit_vector(4, pix, 1, 2))
    u1, u2 = trng.uniform2(4, pix, 1, 2, trng.PURPOSE_LIGHT)
    assert torch.equal(got[3], torch.stack([u1, u2]))


def test_cpu_bundle_counts_no_launch_or_draw():
    launches, draws = tfk.threefry_bundle.launches, tfk.threefry_bundle.draws
    tfk.threefry_bundle(1, torch.arange(8), 0, 0, SPECS["nee_rr_step"])
    trng.uniform1(1, torch.arange(8), 0, 0, 2)
    assert (tfk.threefry_bundle.launches, tfk.threefry_bundle.draws) == (launches, draws)


def test_bundle_checks_its_draws():
    pix = torch.arange(4)
    with pytest.raises(ValueError, match="unknown mode"):
        tfk.threefry_bundle(0, pix, 0, 0, ((1, "quad"),))
    with pytest.raises(ValueError, match="1 to 8 draws"):
        tfk.threefry_bundle(0, pix, 0, 0, ())
    with pytest.raises(ValueError, match="1 to 8 draws"):
        tfk.threefry_bundle(0, pix, 0, 0, ((1, "single"),) * 9)
    with pytest.raises(ValueError, match="8 counter blocks"):  # a triple takes two
        tfk.threefry_bundle(0, pix, 0, 0, ((1, "triple"),) * 5)
    meta = torch.empty(16, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfk.threefry_bundle(0, meta, 0, 0, SPECS["step"])
    with pytest.raises(ValueError, match="no kernel"):
        trng.draws(0, meta, 0, 0, SPECS["step"])


def test_launch_plan_is_one_allocation_of_packed_draws():
    # what the kernel is handed: one output allocation whose views are the
    # draws, in order, and each draw packed as purpose | mode << 32 | row << 40
    pix = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    draws = SPECS["nee_rr_step"] + ((5, "triple"),)
    ins, flat, views, scalars = tfk.launch_plan(-1, pix, torch.tensor(7), 3, draws,
                                                torch.device("cpu"))
    assert ins[0].data_ptr() == pix.data_ptr() and ins[2] is None
    assert flat.shape == (11 * 6,)
    assert [tuple(v.shape) for v in views] == [(2, 3, 3), (2, 3), (2, 3), (2, 2, 3),
                                               (2, 3), (3, 2, 3)]
    rows = [0, 3, 4, 5, 7, 8]
    starts = [v.data_ptr() for v in views]
    assert starts == [flat.data_ptr() + 4 * 6 * row for row in rows]
    n, seed, count, *packed = scalars[:11]
    assert (n, seed, count) == (6, 0xFFFFFFFF, 6)
    modes = [tfk.MODES[m] for _, m in draws]
    assert packed == [p | m << 32 | row << 40
                      for (p, _), m, row in zip(draws, modes, rows)] + [0, 0]
    assert scalars[11:] == [4, 0, -8, 0, 0, 3]  # (layout, value) of each operand


def _step_inputs(wavefront: bool):
    """A bounce step's inputs on the Cornell mesh (a light, spheres and
    triangles): the scan's int sample and bounce, or the wavefront's
    per-lane ones."""
    w = h = 20
    n = w * h
    pix = torch.arange(n)
    o, d = generate_rays(_cornell_camera(), w, h, pix, 3, 11)
    r = np.random.default_rng(6)
    state = (torch.as_tensor(r.uniform(0, 0.5, (n, 3)).astype(np.float32)),
             torch.as_tensor(r.uniform(0.2, 1.0, (n, 3)).astype(np.float32)),
             torch.as_tensor(r.uniform(size=n) > 0.2),
             torch.as_tensor(np.where(r.uniform(size=n) > 0.5, r.uniform(0.1, 2.0, n),
                                      0.0).astype(np.float32)))
    if wavefront:
        sample = torch.as_tensor(r.integers(0, 2**33, n))
        bounce = torch.as_tensor(r.integers(0, 6, n))
    else:
        sample, bounce = 3, 2
    return (o, d, *state, pix, sample, bounce, 11)


def _cornell_camera():
    return Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


def _separate_draws(seed, pixel_id, sample_id, bounce, spec):
    """`rng.draws` as the bounce step made its draws before the bundle: one
    call of the RNG's function for each."""
    out = []
    for purpose, mode in spec:
        if mode == "single":
            out.append(trng.uniform1(seed, pixel_id, sample_id, bounce, purpose))
        elif mode == "pair":
            out.append(torch.stack(trng.uniform2(seed, pixel_id, sample_id, bounce,
                                                 purpose)))
        else:
            assert mode == "unit_vector" and purpose == trng.PURPOSE_LOBE
            out.append(trng.random_unit_vector(seed, pixel_id, sample_id, bounce))
    return tuple(out)


@pytest.fixture(scope="module")
def cornell_mesh():
    return upload_scene(presets.cornell_mesh(), "cpu")


@pytest.mark.parametrize("wavefront", [False, True], ids=["scan", "wavefront"])
@pytest.mark.parametrize("nee,rr_start", [(True, 1), (False, 0), (False, 2)])
def test_bounce_step_through_one_bundle_equals_separate_draws(
        cornell_mesh, monkeypatch, wavefront, nee, rr_start):
    cfg = tint.RenderConfig(max_depth=8, nee=nee, rr_start=rr_start)
    inputs = _step_inputs(wavefront)
    specs = []
    bundle = trng.draws

    def spy(*args):
        specs.append(args[4])
        return bundle(*args)

    monkeypatch.setattr(trng, "draws", spy)
    one = tint._bounce_step(cornell_mesh, *inputs, cfg)
    assert specs == [tint._step_draws(nee and cornell_mesh.num_lights > 0,
                                      rr_start > 0)]
    if nee:
        assert len(specs[0]) == 5 and int(one[7]) > 0  # shadow rays were traced
    monkeypatch.setattr(trng, "draws", _separate_draws)
    separate = tint._bounce_step(cornell_mesh, *inputs, cfg)
    assert one[9] is None and separate[9] is None  # no bank given
    for a, b in zip(one[:9], separate[:9]):
        assert torch.equal(a, b)
