"""The hand-written CUDA closest-hit kernel against its plain twin and the
brute-force oracle. These tests need an NVIDIA card (sm_90a) and nvcc; where
there is none they skip. On a machine with the card, without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernel's determinants are 12-term float32 FMA chains, the
twin's come from a float32 batched matmul, so the two may round differently
in the last bit: hit columns equal on all but 0.1% of rays (each such ray a
near-tie or a triangle edge), t at the closest-hit bound of the CPU tests
(rtol 5e-4, atol 1e-2).
"""

import os

import numpy as np
import pytest
import torch

from metalpathtracer_torch.render.device_scene import upload_scene
from metalpathtracer_torch.render.intersect import closest_hit_bruteforce
from metalpathtracer_torch.render.kernels import intersect_mm as tmm
from metalpathtracer_torch.scene import load_scene_xml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MIN = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return upload_scene(load_scene_xml(os.path.join(REPO, "scenes", "reference.xml")),
                        "cuda")


def _rays(n, seed):
    """Random rays, every other one aimed at the bunny."""
    r = np.random.default_rng(seed)
    o = (r.uniform(-30, 30, (n, 3)) + [0.0, 20.0, 40.0]).astype(np.float32)
    d = r.standard_normal((n, 3))
    target = np.asarray([-25.0, 5.0, 0.0]) + r.uniform(-6.0, 6.0, (n, 3))
    d[1::2] = (target - o)[1::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.as_tensor(o, device="cuda"),
            torch.as_tensor(d.astype(np.float32), device="cuda"))


@pytest.mark.parametrize("n", [128, 5000, 65536])
def test_kernel_matches_twin(scene, n):
    o, d = _rays(n, n)
    occ = torch.full((n,), float("inf"), device="cuda")
    args = tmm.kernel_inputs(scene, o, d, occ) + (scene.mm_w, T_MIN)
    before = tmm.mm_closest_hit.launches
    t, col = tmm.mm_closest_hit(*args)
    torch.cuda.synchronize()
    assert tmm.mm_closest_hit.launches == before + 1
    t_ref, col_ref = tmm.mm_closest_hit_reference(*args)
    same = col == col_ref
    assert (~same).float().mean().item() <= 1e-3
    assert int((col_ref >= 0).sum()) > n // 10
    hit = same & (col_ref >= 0)
    torch.testing.assert_close(t[hit], t_ref[hit], rtol=5e-4, atol=1e-2)
    assert torch.isinf(t[same & (col_ref < 0)]).all()


def test_closest_hit_on_card_matches_brute_oracle(scene):
    o, d = _rays(20000, 7)
    t1, i1, *_ = tmm.closest_hit_mm_full(scene, o, d)
    t0, i0 = closest_hit_bruteforce(scene, o, d, chunk=1024)
    same = i1 == i0
    assert (~same).float().mean().item() <= 1e-3
    hit = same & (i0 >= 0)
    torch.testing.assert_close(t1[hit], t0[hit], rtol=5e-4, atol=1e-2)


def test_cuda_wrapper_rejects_bad_inputs(scene):
    o, d = _rays(256, 3)
    occ = torch.full((256,), float("inf"), device="cuda")
    lists, counts, smin, x, lb = tmm.kernel_inputs(scene, o, d, occ)
    with pytest.raises(ValueError):
        tmm.mm_closest_hit(lists, counts, smin, x.cpu(), lb, scene.mm_w, T_MIN)
    with pytest.raises(ValueError):
        tmm.mm_closest_hit(lists, counts, smin, x[:, :].t().contiguous().t(), lb,
                           scene.mm_w, T_MIN)
