"""The hand-written CUDA kernels against their plain twins: the closest-hit
kernel (also against the brute-force oracle; its walks shared over thread
block clusters bit-equal to one CTA's), the tile cull (the plain rows and
the entry-ordered lists it sorts in its blocks) and the RNG's
threefry (bit-equal in every mode and every bundle of draws the paths make,
one launch a bundle, also inside a CUDA graph), the bounce step's and
the wavefront regeneration's kernels (bit-equal, eagerly and inside a
CUDA graph), and the
wavefront integrator, the progressive path (checkpointed CLI, progressive
wavefront, the viewer's frames) and the BVH study path on the card,
each replay's device events against its graph's capture-time span map,
and the scan's count of ray-sphere tests under replays (the benchmark's
final scene of "Ray Tracing in One Weekend", 487 spheres).
These tests need an NVIDIA card (sm_90a)
and nvcc; where there is none they skip. On a machine with the card,
without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the closest-hit kernel's determinants are float32 FMA chains,
the twin's come from a float32 batched matmul, so the two may round
differently in the last bit: hit columns equal on all but 0.1% of rays
(each such ray a near-tie or a triangle edge), t at the closest-hit bound of
the CPU tests (rtol 5e-4, atol 1e-2), and the walked list positions equal
on every subgroup whose 128 lanes agree on t bit for bit (the early exit
reads only t). Ties between identical triangles are exact on both sides:
the lowest column, then the earliest list position. The cull kernel and its twin compute
the same IEEE operations in the same order, and reduce over sets whose
order does not matter: bit-equal (torch.equal, which holds -0 == +0). Wavefront vs scan on
the card: tests/test_torch_wavefront.py's rtol 1e-5, atol 1e-6; the same for
`accumulate_wavefront` vs `accumulate`. A resumed checkpointed render vs the
uninterrupted one: bit-equal (the same passes in the same order). The BVH
walk vs the brute oracle: the same per-pair arithmetic, so bit-equal t and
equal primitives; its render vs `mm`'s: under 2% of pixels differ by > 1e-3,
means within 5e-3. Row blocks of the sharded path vs the whole image: the
scan bit-equal (its subgroups are 128 pixels in a row on either layout);
the wavefront equal but for rays that meet two triangles at exactly one t,
where the subgroup's tile order picks the winner and the subgroups follow
the queue: at most 1e-4 of the pixels may differ at all.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from metalpathtracer_torch.render.camera import Camera
from metalpathtracer_torch.render.device_scene import upload_scene
from metalpathtracer_torch.render.integrator import RenderConfig
from metalpathtracer_torch.render.intersect import closest_hit_bruteforce
from metalpathtracer_torch.render.kernels import intersect_mm as tmm
from metalpathtracer_torch.render import pipeline as tpipe
from metalpathtracer_torch.render.pipeline import render_image, render_image_wavefront
from metalpathtracer_torch.render.traverse import closest_hit_bvh
from metalpathtracer_torch.scene import load_scene_xml, presets

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


@pytest.fixture(scope="module")
def bunny70k():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return upload_scene(presets.reference_bunny70k(), "cuda")  # tile_p 256


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


def _cull_args(o, d, seed, tile_box):
    """cull_tiles' inputs for rays (o, d): features, a 75% live mask and a
    mix of finite and infinite occlusion bounds."""
    n = o.shape[0]
    r = np.random.default_rng(seed)
    act = torch.as_tensor((r.uniform(size=n) > 0.25).astype(np.float32), device="cuda")
    occ = np.where(r.uniform(size=n) > 0.5, r.uniform(1.0, 200.0, n), np.inf)
    return (tmm.ray_features(o, d), act, tile_box, T_MIN,
            torch.as_tensor(occ.astype(np.float32), device="cuda"))


def _assert_cull_equal(args):
    before = tmm.cull_tiles.launches
    out = tmm.cull_tiles(*args)
    torch.cuda.synchronize()
    assert tmm.cull_tiles.launches == before + 1
    ref = tmm.cull_pass_reference(*args)
    for name, k, r in zip(("sgm", "gent", "lane_bound"), out, ref):
        assert k.dtype == r.dtype and torch.equal(k, r), name
    return out


@pytest.mark.parametrize("n", [128, 4992, 65536])
def test_cull_kernel_matches_twin(scene, n):
    o, d = _rays(n, n + 1)
    sgm, _, _ = _assert_cull_equal(_cull_args(o, d, n, scene.mm_tile_box))
    assert sgm.any()


def test_cull_kernel_matches_twin_over_many_tile_chunks(bunny70k):
    # 311 tiles: two full chunks of 128 and a partial one
    o, d = _rays(8192, 11)
    sgm, _, _ = _assert_cull_equal(_cull_args(o, d, 11, bunny70k.mm_tile_box))
    assert sgm.any() and not sgm.all()


def test_cull_kernel_matches_twin_on_edge_cases(scene):
    # zero direction components, flat and empty boxes, zero-padded lanes
    box = torch.zeros((3, 8), device="cuda")
    box[0, 0:3], box[0, 4:7] = 0.0, 1.0
    box[1, 0:3] = torch.tensor([0.0, 0.0, 2.0])
    box[1, 4:7] = torch.tensor([1.0, 1.0, 2.0])
    box[2, 0:3], box[2, 4:7] = float("inf"), float("-inf")
    o = torch.zeros((256, 3), device="cuda")
    d = torch.zeros((256, 3), device="cuda")
    o[:6] = torch.tensor([[0.5, 0.5, -3], [0.0, 0.5, -3], [-3, 0.5, 2.0],
                          [2.0, 0.5, 0.5], [0.5, 0.5, 0.5], [-3, -3, -3]])
    d[:6] = torch.tensor([[0, 0, 1.0], [0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0],
                          [0, 0, -1.0], [0.577, 0.577, 0.577]])
    act = torch.zeros(256, device="cuda")
    act[:6] = 1.0
    sgm, gent, lb = _assert_cull_equal(
        (tmm.ray_features(o, d), act, box, T_MIN, None))
    assert sgm[0].tolist() == [True, True, True] and not sgm[1].any()
    assert gent[0, 1].item() == 5.0  # the flat box, crossed at z = 2


@pytest.fixture(scope="module")
def bunny300k_boxes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return upload_scene(presets.reference_bunny300k(), "cuda").mm_tile_box


def _random_boxes(nt, seed):
    """`nt` AABBs of sizes 0.5-8 where the rays go, on the card."""
    r = np.random.default_rng(seed)
    lo = r.uniform(-40, 20, (nt, 3))
    box = np.zeros((nt, 8), np.float32)
    box[:, 0:3] = lo
    box[:, 4:7] = lo + r.uniform(0.5, 8.0, (nt, 3))
    return torch.as_tensor(box, device="cuda")


@pytest.mark.parametrize("nt", [1, 31, 33, 129, 1242])
def test_cull_kernel_matches_twin_at_tile_counts(scene, bunny300k_boxes, nt):
    # fewer tiles than the warps that split them, and counts on both sides
    # of multiples of 32; 1,242 are bunny300k's boxes
    box = bunny300k_boxes if nt == 1242 else _random_boxes(nt, nt)
    assert box.shape[0] == nt
    o, d = _rays(4096, nt)
    sgm, _, lb = _assert_cull_equal(_cull_args(o, d, nt, box))
    assert sgm.any() and (lb > float("-inf")).any()


@pytest.mark.parametrize("n", [1 << 15, 921600])
def test_cull_kernel_matches_twin_at_pool_width(scene, n):
    # 32,768 lanes: the wavefront pool's width (16 warps per block), and
    # the scan's 921,600 (7,200 subgroups of 2 warps); on the reference
    # scene's boxes
    o, d = _rays(n, 41)
    sgm, _, _ = _assert_cull_equal(_cull_args(o, d, 41, scene.mm_tile_box))
    assert sgm.any() and not sgm.all()


@pytest.mark.parametrize("case", ["inactive_subgroup", "t_min_0", "occ_-inf",
                                  "occ_+inf", "occ_none"])
def test_cull_kernel_matches_twin_on_masks_and_bounds(scene, case):
    n = 1024
    o, d = _rays(n, 43)
    x, act, box, t_min, occ = _cull_args(o, d, 43, _random_boxes(129, 43))
    if case == "inactive_subgroup":
        act[256:384] = 0.0
    elif case == "t_min_0":
        t_min = 0.0
    elif case == "occ_none":
        occ = None
    else:
        occ = torch.full((n,), float(case[4:]), device="cuda")
    sgm, gent, lb = _assert_cull_equal((x, act, box, t_min, occ))
    if case in ("inactive_subgroup", "occ_-inf"):
        dead = slice(256, 384) if case == "inactive_subgroup" else slice(0, n)
        assert not sgm[dead.start // 128:dead.stop // 128].any()
        assert torch.isinf(gent[dead.start // 128:dead.stop // 128]).all()
        assert (lb[dead] == float("-inf")).all()
    else:
        assert sgm.any()


@pytest.mark.parametrize("permute", ["tiles", "lanes"])
def test_cull_kernel_is_equivariant_under_permutation(bunny70k, permute):
    # tiles permuted: the columns of sgm and gent permute, lane_bound stays;
    # lanes permuted inside each subgroup: lane_bound permutes, sgm and gent
    # stay -- whatever order the kernel's reductions take
    n = 4096
    o, d = _rays(n, 47)
    x, act, box, t_min, occ = _cull_args(o, d, 47, bunny70k.mm_tile_box)
    sgm, gent, lb = _assert_cull_equal((x, act, box, t_min, occ))
    r = np.random.default_rng(48)
    if permute == "tiles":
        perm = torch.as_tensor(r.permutation(box.shape[0]), device="cuda")
        sgm_p, gent_p, lb_p = _assert_cull_equal((x, act, box[perm], t_min, occ))
        assert torch.equal(sgm_p, sgm[:, perm]) and torch.equal(gent_p, gent[:, perm])
        assert torch.equal(lb_p, lb)
    else:
        idx = torch.as_tensor(np.concatenate(
            [k * 128 + r.permutation(128) for k in range(n // 128)]), device="cuda")
        sgm_p, gent_p, lb_p = _assert_cull_equal(
            (x[idx].contiguous(), act[idx], box, t_min, occ[idx]))
        assert torch.equal(sgm_p, sgm) and torch.equal(gent_p, gent)
        assert torch.equal(lb_p, lb[idx])


def _assert_lists_equal(args):
    """`_cull_tile_lists` on the card against its twin: lists and counts
    equal, smin and lane_bound equal bit for bit (-0 == +0; a NaN where the
    twin has one, with its bits); one launch, counted by the wrapper under
    its route and by the kernel's tally (its second slot: radix launches)."""
    from metalpathtracer_torch.render.kernels import _build

    route = tmm.sort_route(args[2].shape[0])
    tally0 = _build.tallies("cuda").get("cull_tile_lists", (0, 0))
    before = tmm._cull_tile_lists.launches, tmm._cull_tile_lists.routes[route]
    out = tmm._cull_tile_lists(*args)
    torch.cuda.synchronize()
    assert (tmm._cull_tile_lists.launches,
            tmm._cull_tile_lists.routes[route]) == (before[0] + 1, before[1] + 1)
    tally = _build.tallies("cuda")["cull_tile_lists"]
    assert (tally[0] - tally0[0], tally[1] - tally0[1]) == (1, int(route == "radix"))
    ref = tmm.cull_tile_lists_reference(*args)
    for name, k, r in zip(("lists", "counts", "smin", "lane_bound"), out, ref):
        assert k.dtype == r.dtype and k.shape == r.shape, name
        if k.dtype == torch.int32:
            assert torch.equal(k, r), name
        else:
            nan = torch.isnan(r)
            assert torch.equal(torch.isnan(k), nan), name
            assert torch.equal(k[~nan], r[~nan]), name
            assert torch.equal(k[nan].view(torch.int32), r[nan].view(torch.int32)), name
    return out


@pytest.mark.parametrize("nt", [1, 31, 33, 129, tmm.RANK_SORT_MAX_TILES - 1,
                                tmm.RANK_SORT_MAX_TILES, tmm.RANK_SORT_MAX_TILES + 1,
                                1242, 4096])
def test_tile_lists_kernel_matches_twin_at_tile_counts(bunny300k_boxes, nt):
    # both sort routes, each side of the threshold between them; 1,242 are
    # bunny300k's boxes, 4,096 a 1M-triangle mesh's count
    box = bunny300k_boxes if nt == 1242 else _random_boxes(nt, nt)
    o, d = _rays(4096, nt + 3)
    lists, counts, smin, lb = _assert_lists_equal(_cull_args(o, d, nt, box))
    assert counts.any() and (lb > float("-inf")).any()


@pytest.mark.parametrize("n", [1 << 15, 921600])
def test_tile_lists_kernel_matches_twin_at_pool_width(scene, n):
    # the pool's 32,768 lanes and the scan's 921,600 on the reference
    # scene's 39 boxes (the rank sort)
    o, d = _rays(n, 53)
    lists, counts, _, _ = _assert_lists_equal(_cull_args(o, d, 53, scene.mm_tile_box))
    assert counts.any() and (counts < scene.mm_tile_box.shape[0]).any()


@pytest.mark.parametrize("n", [1 << 15, 921600])
def test_tile_lists_kernel_matches_twin_on_bunny300k(bunny300k_boxes, n):
    # 1,242 tiles (the radix sort) at the pool's and the scan's lane counts
    o, d = _rays(n, 59)
    _, counts, _, _ = _assert_lists_equal(_cull_args(o, d, 59, bunny300k_boxes))
    assert counts.any()


@pytest.mark.parametrize("nt", [40, 600])
def test_tile_lists_kernel_keeps_tile_order_on_ties(nt):
    # duplicated boxes give equal entries at two tiles: the lower tile first
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    box = _random_boxes(nt, 61)
    box[nt // 2:] = box[:nt // 2]
    o, d = _rays(8192, 61)
    lists, counts, smin, _ = _assert_lists_equal(_cull_args(o, d, 61, box))
    same = smin[:, 1:] == smin[:, :-1]
    assert (same & torch.isfinite(smin[:, 1:])).any()
    assert (lists[:, 1:][same] > lists[:, :-1][same]).all()


@pytest.mark.parametrize("nt", [129, 600])
@pytest.mark.parametrize("case", ["inactive_subgroup", "t_min_0", "occ_-inf",
                                  "occ_+inf", "occ_none", "occ_nan"])
def test_tile_lists_kernel_matches_twin_on_masks_and_bounds(scene, case, nt):
    # the plain cull's mask and bound cases, and a NaN occ, on either route
    n = 1024
    o, d = _rays(n, 43)
    x, act, box, t_min, occ = _cull_args(o, d, 43, _random_boxes(nt, 43))
    if case == "inactive_subgroup":
        act[256:384] = 0.0
    elif case == "t_min_0":
        t_min = 0.0
    elif case == "occ_none":
        occ = None
    elif case == "occ_nan":
        occ[::5] = float("nan")
    else:
        occ = torch.full((n,), float(case[4:]), device="cuda")
    lists, counts, smin, lb = _assert_lists_equal((x, act, box, t_min, occ))
    if case in ("inactive_subgroup", "occ_-inf"):
        dead = slice(2, 3) if case == "inactive_subgroup" else slice(0, n // 128)
        assert (counts[dead] == 0).all() and torch.isinf(smin[dead]).all()
        assert torch.equal(lists[dead][0].cpu(), torch.arange(nt, dtype=torch.int32))
    elif case == "occ_nan":
        assert torch.isnan(lb[::5]).all()
    else:
        assert counts.any()


def test_kernel_at_tile_p_256_matches_twin(bunny70k):
    assert bunny70k.mm_w.shape[1] == 256
    o, d = _rays(16384, 5)
    occ = torch.full((16384,), float("inf"), device="cuda")
    args = tmm.kernel_inputs(bunny70k, o, d, occ) + (bunny70k.mm_w, T_MIN)
    t, col = tmm.mm_closest_hit(*args)
    t_ref, col_ref = tmm.mm_closest_hit_reference(*args)
    same = col == col_ref
    assert (~same).float().mean().item() <= 1e-3
    assert int((col_ref >= 0).sum()) > 1000
    hit = same & (col_ref >= 0)
    torch.testing.assert_close(t[hit], t_ref[hit], rtol=5e-4, atol=1e-2)


def _assert_walks_agree(t, t_ref, walked, walked_ref):
    """Walked positions equal on every subgroup whose lanes agree on t bit
    for bit; nearly every subgroup must."""
    same = (t.view(-1, 128) == t_ref.view(-1, 128)).all(dim=1)
    assert same.float().mean().item() >= 0.9
    assert torch.equal(walked[same], walked_ref[same])


@pytest.mark.parametrize("which", ["tile_p128", "tile_p256"])
def test_kernel_matches_twin_at_pool_width(scene, bunny70k, which):
    # 32,768 rays: the wavefront pool's width
    sc = scene if which == "tile_p128" else bunny70k
    assert sc.mm_w.shape[1] == int(which[6:])
    n = 1 << 15
    o, d = _rays(n, 21)
    occ = torch.full((n,), float("inf"), device="cuda")
    args = tmm.kernel_inputs(sc, o, d, occ) + (sc.mm_w, T_MIN)
    t, col, walked = tmm.mm_closest_hit(*args, return_walked=True)
    t_ref, col_ref, walked_ref = tmm.mm_closest_hit_reference(*args, return_walked=True)
    assert torch.equal(tmm.mm_closest_hit(*args)[1], col)  # the null walked pointer
    same = col == col_ref
    assert (~same).float().mean().item() <= 1e-3
    hit = same & (col_ref >= 0)
    assert int(hit.sum()) > n // 10
    torch.testing.assert_close(t[hit], t_ref[hit], rtol=5e-4, atol=1e-2)
    assert (walked <= args[1]).all() and int(walked.sum()) > 0
    _assert_walks_agree(t, t_ref, walked, walked_ref)


def _tie_case(order, cols=(5, 40, 100, 128 + 3)):
    """One subgroup of 128 rays straight down -z onto one triangle that the
    slab holds at each of `cols`: by default columns 5, 40 and 100 of tile 0
    (three column slices at any K up to 4, and three CTAs of a cluster of 4)
    and column 3 of tile 1. `order` is the list."""
    tile_p = 128
    v = np.zeros((2 * tile_p, 3, 3), np.float32)  # zero rows: never accepted
    tri = np.asarray([[-2.0, -2.0, -5.0], [2.0, -2.0, -5.0], [0.0, 2.0, -5.0]],
                     np.float32)
    for c in cols:
        v[c] = tri
    w = tmm.tri_weight_slab(v[:, 0], v[:, 1], v[:, 2], tile_p)
    r = np.random.default_rng(3)
    o = np.zeros((128, 3), np.float32)
    o[:, :2] = r.uniform(-0.5, 0.5, (128, 2))
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (128, 1))
    dev = "cuda"
    x = tmm.ray_features(torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev))
    return (torch.tensor([order], dtype=torch.int32, device=dev),
            torch.tensor([2], dtype=torch.int32, device=dev),
            torch.zeros((1, 2), device=dev), x,
            torch.full((128,), float("inf"), device=dev),
            torch.as_tensor(w, device=dev), T_MIN)


@pytest.mark.parametrize("order,winner", [((0, 1), 5), ((1, 0), 128 + 3)])
def test_kernel_tie_rules(scene, order, winner):
    # inside a tile the lowest column wins; across tiles the first in list
    # order keeps an equal t
    args = _tie_case(order)
    t, col, walked = tmm.mm_closest_hit(*args, return_walked=True)
    t_ref, col_ref, walked_ref = tmm.mm_closest_hit_reference(*args, return_walked=True)
    assert (col == winner).all() and torch.equal(col, col_ref)
    assert torch.equal(t, t_ref)
    torch.testing.assert_close(t, torch.full_like(t, 5.0))
    assert walked.tolist() == walked_ref.tolist() == [2]


def test_kernel_walks_no_tile_and_every_tile(scene):
    n = 512
    o, d = _rays(n, 31)
    occ = torch.full((n,), float("inf"), device="cuda")
    lists, counts, smin, x, lb = tmm.kernel_inputs(scene, o, d, occ)
    g, nt = lists.shape
    # subgroup 0 passes no tile; the others get every tile in id order,
    # entered at 0, with no lane bound, so no list position exits early
    counts = torch.full((g,), nt, dtype=torch.int32, device="cuda")
    counts[0] = 0
    lists = torch.arange(nt, dtype=torch.int32, device="cuda").repeat(g, 1)
    smin = torch.zeros((g, nt), device="cuda")
    lb = torch.full_like(lb, float("inf"))
    args = (lists, counts, smin, x, lb, scene.mm_w, T_MIN)
    t, col, walked = tmm.mm_closest_hit(*args, return_walked=True)
    t_ref, col_ref, walked_ref = tmm.mm_closest_hit_reference(*args, return_walked=True)
    assert walked.tolist() == walked_ref.tolist() == [0] + [nt] * (g - 1)
    assert (col[:128] == -1).all() and torch.isinf(t[:128]).all()
    same = col == col_ref
    assert (~same).float().mean().item() <= 1e-3 and int((col_ref >= 0).sum()) > 50
    torch.testing.assert_close(t[same & (col_ref >= 0)], t_ref[same & (col_ref >= 0)],
                               rtol=5e-4, atol=1e-2)


# ---------------------------------------------------------------------------
# the closest hit's walks shared over thread block clusters: every width
# bit-equal to one CTA (the one-CTA launch is the kernel as it was)
# ---------------------------------------------------------------------------


def _widths(tile_p):
    return [c for c in (1, 2, 4, 8) if tile_p % (c * tmm.CLUSTER_SLICE_COLS) == 0]


def _at_width(args, cluster, return_walked=True):
    # the kernel with each walk forced onto `cluster` CTAs
    return tmm._launch(*args, return_walked, cluster)


def _assert_widths_agree(args, widths):
    """(t, col, walked) of every width in `widths` torch.equal to one CTA's;
    returns one CTA's."""
    one = _at_width(args, 1)
    for c in widths:
        got = _at_width(args, c)
        torch.cuda.synchronize()
        for name, a, b in zip(("t", "col", "walked"), got, one):
            assert torch.equal(a, b), f"cluster {c}: {name} differs from one CTA"
    return one


@pytest.mark.parametrize("lanes", [1 << 15, 1024])
@pytest.mark.parametrize("which", ["tile_p128", "tile_p256"])
def test_clustered_kernel_equals_one_cta_and_the_twin(scene, bunny70k, which, lanes):
    # the wavefront pool's 32,768 lanes and a drain call's 1,024, at every
    # cluster width the tile width allows; one CTA against the twin as the
    # kernel always was (the twin's batched matmul may round otherwise)
    sc = scene if which == "tile_p128" else bunny70k
    tile_p = sc.mm_w.shape[1]
    assert tile_p == int(which[6:])
    o, d = _rays(lanes, 41 + lanes)
    occ = torch.full((lanes,), float("inf"), device="cuda")
    args = tmm.kernel_inputs(sc, o, d, occ) + (sc.mm_w, T_MIN)
    widths = _widths(tile_p)
    assert len(widths) == (3 if tile_p == 128 else 4)
    t, col, walked = _assert_widths_agree(args, widths)
    t_ref, col_ref, walked_ref = tmm.mm_closest_hit_reference(*args, return_walked=True)
    same = col == col_ref
    assert (~same).float().mean().item() <= 1e-3
    hit = same & (col_ref >= 0)
    assert int(hit.sum()) > lanes // 20
    torch.testing.assert_close(t[hit], t_ref[hit], rtol=5e-4, atol=1e-2)
    assert int(walked.max()) > 1
    _assert_walks_agree(t, t_ref, walked, walked_ref)


@pytest.mark.parametrize("cols,winners", [
    ((5, 40, 100, 128 + 3), (5, 128 + 3)),     # the lowest column in CTA 0
    ((70, 100, 128 + 40), (70, 128 + 40)),     # in CTAs 2 and 3 of four
    ((100, 36, 128 + 96), (36, 128 + 96)),     # a later CTA's tie in tile 1
])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_clustered_kernel_tie_rules(scene, cluster, cols, winners):
    # equal t in columns that lie in different CTAs of a cluster: the lowest
    # column wins inside a tile, and across tiles the first in list order
    for order, winner in zip(((0, 1), (1, 0)), winners):
        args = _tie_case(order, cols)
        t, col, walked = _at_width(args, cluster)
        t_ref, col_ref, walked_ref = tmm.mm_closest_hit_reference(*args,
                                                                  return_walked=True)
        assert (col == winner).all() and torch.equal(col, col_ref)
        assert torch.equal(t, t_ref)
        assert walked.tolist() == walked_ref.tolist() == [2]


@pytest.mark.parametrize("which", ["tile_p128", "tile_p256"])
def test_clustered_kernel_walks_no_tile_and_every_tile(scene, bunny70k, which):
    # counts 0 and every tile with no exit, at every width
    sc = scene if which == "tile_p128" else bunny70k
    n = 1024
    o, d = _rays(n, 33)
    occ = torch.full((n,), float("inf"), device="cuda")
    lists, counts, smin, x, lb = tmm.kernel_inputs(sc, o, d, occ)
    g, nt = lists.shape
    counts = torch.full((g,), nt, dtype=torch.int32, device="cuda")
    counts[0] = 0
    lists = torch.arange(nt, dtype=torch.int32, device="cuda").repeat(g, 1)
    smin = torch.zeros((g, nt), device="cuda")
    lb = torch.full_like(lb, float("inf"))
    args = (lists, counts, smin, x, lb, sc.mm_w, T_MIN)
    t, col, walked = _assert_widths_agree(args, _widths(sc.mm_w.shape[1]))
    assert walked.tolist() == [0] + [nt] * (g - 1)
    assert (col[:128] == -1).all() and torch.isinf(t[:128]).all()
    assert int((col >= 0).sum()) > 50


def test_clustered_kernel_in_a_cuda_graph_and_its_tally(scene):
    # a clustered launch captured and replayed equals its eager launch; the
    # tally's second slot counts clustered launches, replays included, and
    # no one-CTA launch
    from metalpathtracer_torch.render.kernels import _build

    n = 1 << 15
    o, d = _rays(n, 47)
    occ = torch.full((n,), float("inf"), device="cuda")
    args = tmm.kernel_inputs(scene, o, d, occ) + (scene.mm_w, T_MIN)
    eager = _at_width(args, 4)
    torch.cuda.synchronize()
    _build.zero_tallies()
    clustered = tmm.mm_closest_hit.clustered
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = _at_width(args, 4)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(replayed, eager))
    assert _build.tallies("cuda")["mm_closest_hit"] == (3, 3)
    _at_width(args, 1)
    tmm.mm_closest_hit(*args)  # the pool's 256 subgroups: the rule clusters them
    torch.cuda.synchronize()
    assert _build.tallies("cuda")["mm_closest_hit"] == (5, 4)
    assert tmm.mm_closest_hit.clustered == clustered + 2  # the capture and the rule's


def test_cluster_width_on_the_card_at_the_paths_shapes(scene):
    # the scan's 7,200 subgroups take one CTA; the pool's 256 and a drain's 8
    # take a cluster
    sms = tmm.card_sms(0)
    assert tmm.cluster_width(7200, 128, sms) == 1
    assert tmm.cluster_width(7200, 256, sms) == 1
    assert tmm.cluster_width(256, 128, sms) > 1 and tmm.cluster_width(8, 128, sms) > 1
    assert tmm.cluster_width(256, 256, sms) > 1 and tmm.cluster_width(8, 256, sms) > 1


def test_clustered_kernel_rejects_bad_widths(scene):
    o, d = _rays(256, 3)
    occ = torch.full((256,), float("inf"), device="cuda")
    args = tmm.kernel_inputs(scene, o, d, occ) + (scene.mm_w, T_MIN)
    for bad in (0, 3, 8, 16):  # 8 CTAs leave tile_p 128 16 columns each
        with pytest.raises(ValueError, match="cluster"):
            _at_width(args, bad)


def test_wavefront_on_card_matches_scan(scene):
    cfg = RenderConfig(max_depth=6, bank_k=2)
    cam = Camera.reset()
    a, ra = render_image(scene, cam, 64, 36, 4, seed=7, cfg=cfg)
    launches = tmm.mm_closest_hit.launches, tmm._cull_tile_lists.launches
    b, rb = render_image_wavefront(scene, cam, 64, 36, 4, seed=7, cfg=cfg,
                                   pool_size=128)
    assert tmm.mm_closest_hit.launches > launches[0]
    assert tmm._cull_tile_lists.launches > launches[1]
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    assert ra == rb


def _launches():
    # what ran on the card, by the kernels' tallies: a graph replay runs
    # the kernels, not their wrappers
    return _counted()[:2]


def test_checkpointed_cli_on_card_resumes_bit_equal(scene, tmp_path, capsys):
    from metalpathtracer_torch import cli
    from metalpathtracer_torch.io.checkpoint import load_checkpoint

    def argv(out, ck, npz):
        return ["--scene", os.path.join(REPO, "scenes", "reference.xml"), "--width",
                "64", "--height", "36", "--max-depth", "6", "--device", "cuda",
                "--output", str(tmp_path / out), "--checkpoint", str(tmp_path / ck),
                "--checkpoint-every", "2", "--npz", str(tmp_path / npz)]

    before = _launches()
    assert cli.main(argv("a.png", "ck.npz", "a.npz") + ["--spp", "2"]) == 0
    assert cli.main(argv("a.png", "ck.npz", "a.npz") + ["--spp", "4", "--resume"]) == 0
    state, _, _ = load_checkpoint(str(tmp_path / "ck.npz"), "cuda")
    assert state.spp == 4 and state.rgb_sum.is_cuda
    assert cli.main(argv("b.png", "ck2.npz", "b.npz") + ["--spp", "4"]) == 0
    after = _launches()
    assert after[0] > before[0] and after[1] > before[1]
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert np.array_equal(a["radiance"], b["radiance"])
        assert a["radiance"].mean() > 0.05
    saved = (tmp_path / "ck.npz").read_bytes()
    capsys.readouterr()
    assert cli.main(argv("c.png", "ck.npz", "c.npz")
                    + ["--spp", "6", "--resume", "--fov", "50"]) == 2
    assert "camera:" in capsys.readouterr().err
    assert (tmp_path / "ck.npz").read_bytes() == saved


def test_accumulate_wavefront_on_card_matches_accumulate(scene):
    cfg = RenderConfig(max_depth=6)
    cam = Camera.reset()
    scan = wave = tpipe.init_accum(64, 36, "cuda")
    for step in range(4):
        before = _launches()
        scan = tpipe.accumulate(scan, scene, cam, 64, 36, 1, 7, cfg)
        wave, rays = tpipe.accumulate_wavefront(wave, scene, cam, 64, 36, 1, 7, cfg,
                                                pool_size=256)
        assert min(a - b for a, b in zip(_launches(), before)) >= 2
        assert wave.spp == scan.spp == step + 1 and wave.rgb_sum.is_cuda
        torch.testing.assert_close(tpipe.to_image(wave, clamp=False),
                                   tpipe.to_image(scan, clamp=False),
                                   rtol=1e-5, atol=1e-6)
        _, scan_rays = render_image(scene, cam, 64, 36, 1, seed=7, cfg=cfg,
                                    sample_offset=step)
        assert rays == scan_rays
    batch, _ = render_image(scene, cam, 64, 36, 4, seed=7, cfg=cfg, spp_per_pass=1)
    assert torch.equal(tpipe.to_image(scan, clamp=False), batch)


def test_closest_hit_bvh_on_card_matches_brute_oracle(scene):
    scene = upload_scene(load_scene_xml(os.path.join(REPO, "scenes", "reference.xml")),
                         "cuda", bvh=True)
    o, d = _rays(8192, 13)
    before = _launches()
    t, idx = closest_hit_bvh(scene, o, d)
    assert _launches() == before  # the study path runs neither kernel
    t0, i0 = closest_hit_bruteforce(scene, o, d, chunk=1024)
    assert torch.equal(idx, i0) and torch.equal(t, t0)
    assert int((idx >= 3).sum()) > 1000
    cfg = RenderConfig(max_depth=4, intersector="bvh")
    a, _ = render_image(scene, Camera.reset(), 64, 36, 2, seed=3, cfg=cfg)
    b, _ = render_image(scene, Camera.reset(), 64, 36, 2, seed=3,
                        cfg=RenderConfig(max_depth=4))
    assert ((a - b).abs() > 1e-3).float().mean().item() < 0.02
    assert abs(float(a.mean()) - float(b.mean())) < 5e-3


def test_viewer_frames_on_card(scene):
    from metalpathtracer_torch import viewer

    class Display:
        posts = []

        def post(self, img, status):
            self.posts.append((img.copy(), status))

        def post_text(self, text):
            pass

    s = viewer._ViewerLoop(scene, 128, 72, 1, RenderConfig(max_depth=4), 0,
                           "wavefront", Display())
    before = _launches()
    for k in range(1, 4):
        assert s.step(lambda: []) and s.shown_spp == k == s.state.spp
    assert min(a - b for a, b in zip(_launches(), before)) >= 5
    # every frame lands in the one pinned buffer; a shown frame is a copy
    host = s._host
    assert host.is_pinned() and not host.is_cuda
    # three frames of the loop are three accumulate_wavefront steps
    want = tpipe.init_accum(128, 72, "cuda")
    for _ in range(3):
        want, _ = tpipe.accumulate_wavefront(want, scene, s.cam, 128, 72, 1, 0, s.cfg,
                                             pool_size=128 * 72)
    want = viewer._srgb_u8(want).cpu().numpy().astype(np.int16)
    assert (np.abs(Display.posts[-1][0].astype(np.int16) - want) <= 1).mean() > 0.98
    assert s.step(lambda: [("key", "w")]) and s.shown_spp == 4
    assert s.step(lambda: []) and s.shown_spp == 1 and s._host is host
    assert not np.array_equal(Display.posts[-1][0], Display.posts[-2][0])
    fresh, _ = tpipe.accumulate_wavefront(
        tpipe.init_accum(128, 72, "cuda"), scene, s.cam, 128, 72, 1, 0, s.cfg,
        pool_size=128 * 72)
    want = viewer._srgb_u8(fresh).cpu().numpy().astype(np.int16)
    got = Display.posts[-1][0].astype(np.int16)
    assert got.shape == (72, 128, 3) and (np.abs(got - want) <= 1).mean() > 0.98


def test_sharded_row_blocks_on_card_match_the_whole_image(scene):
    from metalpathtracer_torch.parallel import sharding as sh

    w, h, spp, n = 512, 288, 2, 4  # a block is 36,864 pixels: 288 subgroups
    cfg, cam = RenderConfig(max_depth=8), Camera.reset()
    whole, rays = render_image(scene, cam, w, h, spp, seed=2, cfg=cfg,
                               spp_per_pass=spp)
    parts = [sh.shard_render(scene, cam, w, h, spp, 2, cfg, i, n) for i in range(n)]
    assert torch.equal(sh.join_rows([p[0] for p in parts]) / spp, whole)
    assert sum(p[1] for p in parts) == rays
    whole, rays = render_image_wavefront(scene, cam, w, h, spp, seed=2, cfg=cfg)
    parts = [sh.shard_render_wavefront(scene, cam, w, h, spp, 2, cfg, None, i, n)
             for i in range(n)]
    img = sh.join_rows([p[0] for p in parts]) / spp
    differing = int((img != whole).any(dim=-1).sum())
    assert differing <= 1e-4 * w * h, differing
    assert sum(p[1] for p in parts) == rays


def test_sharded_entry_points_on_card_in_a_world_of_one(scene):
    from metalpathtracer_torch.parallel import sharding as sh

    cfg, cam = RenderConfig(max_depth=8), Camera.reset()
    a, ra = render_image_wavefront(scene, cam, 320, 180, 2, seed=1, cfg=cfg)
    b, rb = sh.render_image_wavefront_sharded(scene, cam, 320, 180, 2, seed=1, cfg=cfg)
    assert torch.equal(a, b) and ra == rb and b.is_cuda
    mesh = sh.make_mesh()
    state = sh.init_accum_sharded(320, 180, mesh, "cuda")
    want = tpipe.init_accum(320, 180, "cuda")
    for _ in range(2):
        state, r = sh.accumulate_sharded(state, scene, cam, 1, seed=1, cfg=cfg,
                                         mesh=mesh)
        want, r_want = tpipe.accumulate_wavefront(want, scene, cam, 320, 180, 1, 1, cfg)
        assert r == r_want
    assert state.spp == 2 and torch.equal(state.rgb_sum, want.rgb_sum)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _draw_operands(n, kind, card):
    """The RNG's operands as the paths pass them: the scan's (int sample and
    bounce), the wavefront's (per-lane int64 tensors) and the probe's kind
    (int32 ids, a 0-d bounce tensor on the card, a one-element sample)."""
    r = np.random.default_rng(n)
    pix = torch.as_tensor(r.integers(0, 2**32, n).astype(np.int64), device=card)
    if kind == "scan":
        return pix, 3, 1
    if kind == "wavefront":
        return (pix, torch.as_tensor(r.integers(0, 2**33, n), device=card),
                torch.as_tensor(r.integers(0, 32, n), device=card))
    return (pix.to(torch.int32), torch.tensor([2**32 + 3], device=card),
            torch.tensor(7, dtype=torch.int32, device=card))


@pytest.mark.parametrize("kind", ["scan", "wavefront", "probe"])
@pytest.mark.parametrize("mode", ["pair", "triple", "unit_vector"])
@pytest.mark.parametrize("n", [1024, 32768, 921600])
def test_threefry_kernel_matches_twin(card, n, mode, kind):
    from metalpathtracer_torch.render.kernels import threefry as tfk

    pix, sample, bounce = _draw_operands(n, kind, card)
    before = tfk.threefry_bundle.launches
    got = tfk.threefry(-5, pix, sample, bounce, 4, mode)
    torch.cuda.synchronize()
    assert tfk.threefry_bundle.launches == before + 1
    want = tfk.threefry_reference(-5, pix, sample, bounce, 4, mode)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want), int((got != want).sum())


def test_threefry_kernel_in_a_cuda_graph(card):
    # no operand is read on the host: the draws can be captured and replayed
    from metalpathtracer_torch.core import rng as trng
    from metalpathtracer_torch.render.kernels import threefry as tfk

    pix, sample, bounce = _draw_operands(32768, "wavefront", card)
    trng.uniform2(9, pix, sample, bounce, 2)  # builds and loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        u = trng.uniform2(9, pix, sample, bounce, 2)
        v = trng.random_unit_vector(9, pix, sample, bounce)
        w = trng.uniform3(9, pix, 4, 0, 0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(u), tfk.threefry_reference(9, pix, sample, bounce, 2,
                                                              "pair"))
    assert torch.equal(v, tfk.threefry_reference(9, pix, sample, bounce, 1,
                                                 "unit_vector"))
    assert torch.equal(torch.stack(w), tfk.threefry_reference(9, pix, 4, 0, 0, "triple"))


# the bundles the paths make: a bounce step's (lobe and Fresnel; with NEE and
# Russian roulette all five), and a bundle of one in each mode
BUNDLES = {
    "step": ((1, "unit_vector"), (2, "single")),
    "nee_rr_step": ((1, "unit_vector"), (2, "single"), (6, "single"), (4, "pair"),
                    (3, "single")),
    "pair": ((0, "pair"),),
    "triple": ((4, "triple"),),
    "unit_vector": ((7, "unit_vector"),),
    "single": ((3, "single"),),
}


def _same_draws(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(g, w), int((g != w).sum())


@pytest.mark.parametrize("kind", ["scan", "wavefront", "probe"])
@pytest.mark.parametrize("spec", sorted(BUNDLES))
@pytest.mark.parametrize("n", [1, 1024, 32768, 921600])
def test_threefry_bundle_matches_twin(card, n, spec, kind):
    from metalpathtracer_torch.render.kernels import threefry as tfk

    pix, sample, bounce = _draw_operands(n, kind, card)
    draws = BUNDLES[spec]
    launches, drawn = tfk.threefry_bundle.launches, tfk.threefry_bundle.draws
    got = tfk.threefry_bundle(-5, pix, sample, bounce, draws)
    torch.cuda.synchronize()
    assert tfk.threefry_bundle.launches == launches + 1
    assert tfk.threefry_bundle.draws == drawn + len(draws)
    _same_draws(got, tfk.threefry_bundle_reference(-5, pix, sample, bounce, draws))


@pytest.mark.parametrize("spec", sorted(BUNDLES))
@pytest.mark.parametrize("n", [1, 1024, 32768, 921600])
def test_threefry_bundle_in_a_cuda_graph(card, n, spec):
    from metalpathtracer_torch.render.kernels import threefry as tfk

    pix, sample, bounce = _draw_operands(n, "wavefront", card)
    draws = BUNDLES[spec]
    tfk.threefry_bundle(3, pix, sample, bounce, draws)  # builds and loads the kernel
    torch.cuda.synchronize()
    launches = tfk.threefry_bundle.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tfk.threefry_bundle(3, pix, sample, bounce, draws)
    assert tfk.threefry_bundle.launches == launches + 1
    graph.replay()
    torch.cuda.synchronize()
    _same_draws(got, tfk.threefry_bundle_reference(3, pix, sample, bounce, draws))


def test_kernel_tally_counts_eager_and_replayed_launches(card):
    # the kernel adds to its tally itself: a replay counts as a launch, while
    # the wrapper's Python counter sees only the capture
    from metalpathtracer_torch.render.kernels import _build
    from metalpathtracer_torch.render.kernels import threefry as tfk

    pix, sample, bounce = _draw_operands(32768, "wavefront", card)
    draws = BUNDLES["nee_rr_step"]
    tfk.threefry_bundle(3, pix, sample, bounce, draws)  # builds and loads the kernel
    torch.cuda.synchronize()
    _build.zero_tallies()
    launches = tfk.threefry_bundle.launches
    for _ in range(2):
        tfk.threefry_bundle(3, pix, sample, bounce, draws)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tfk.threefry_bundle(3, pix, sample, bounce, draws)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert tfk.threefry_bundle.launches == launches + 3
    assert _build.tallies(card)["threefry"] == (5, 5 * len(draws))


def test_bounce_step_launches_one_bundle(scene):
    # NEE and Russian roulette on: five draws, one launch
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render.kernels import threefry as tfk

    n = 4096
    o, d = _rays(n, 5)
    pix = torch.arange(n, device="cuda")
    cfg = RenderConfig(max_depth=8, nee=True, rr_start=1)
    launches, drawn = tfk.threefry_bundle.launches, tfk.threefry_bundle.draws
    tint._bounce_step(scene, o, d, torch.zeros((n, 3), device="cuda"),
                      torch.ones((n, 3), device="cuda"),
                      torch.ones((n,), dtype=torch.bool, device="cuda"),
                      torch.zeros((n,), device="cuda"), pix, 0, 2, 7, cfg)
    torch.cuda.synchronize()
    assert tfk.threefry_bundle.launches == launches + 1
    assert tfk.threefry_bundle.draws == drawn + (5 if scene.num_lights else 3)


# ---------------------------------------------------------------------------
# the bounce step's kernels (render/kernels/intersect_mm.py: the sphere
# pass, the front end and the hit epilogue; render/kernels/shade.py: the
# shading from the winners, with and without the wavefront's bank; and the
# plain route of the BVH and brute intersectors) against their plain twins
# on the card: bit for bit, as each rounds every operation of its twin alone
# and in its order (a lane that misses everything has a NaN normal on both
# sides)
# ---------------------------------------------------------------------------


def _bit_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.is_floating_point:
            assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        else:
            assert torch.equal(a, b)


def _bounce_scene(which, scene, bunny70k=None):
    if which == "reference":
        return scene
    if which == "glass":  # spheres alone
        return _glass()
    return bunny70k  # tile_p 256


def _hit_parts(s, o, d):
    """The sphere pass's and the triangle kernel's results for rays (o, d)."""
    t_s, i_s, slot = tmm.sphere_pass(o, d, s.sph_center, s.sph_radius, s.sph_ids, T_MIN)
    if not s.num_tris:
        return t_s, i_s, slot, None, None
    args = tmm.kernel_inputs(s, o, d, t_s, None, T_MIN) + (s.mm_w, T_MIN)
    t_t, col = tmm.mm_closest_hit(*args)
    return t_s, i_s, slot, t_t[:o.shape[0]], col[:o.shape[0]]


@pytest.mark.parametrize("which", ["reference", "glass"])
@pytest.mark.parametrize("n", [1, 1000, 32768, 921600])
def test_sphere_pass_kernel_matches_twin(scene, n, which):
    s = _bounce_scene(which, scene)
    o, d = _rays(n, n + 1)
    args = (o, d, s.sph_center, s.sph_radius, s.sph_ids, T_MIN)
    before = tmm.sphere_pass.launches
    got = tmm.sphere_pass(*args)
    assert tmm.sphere_pass.launches == before + 1
    _bit_equal(got, tmm.sphere_pass_reference(*args))
    assert n < 1000 or bool((got[1] >= 0).any())
    # no spheres at all: every lane misses
    empty = tmm.sphere_pass(o, d, s.sph_center[:0], s.sph_radius[:0], s.sph_ids[:0],
                            T_MIN)
    _bit_equal(empty, tmm.sphere_pass_reference(o, d, s.sph_center[:0],
                                                s.sph_radius[:0], s.sph_ids[:0], T_MIN))


@pytest.mark.parametrize("which", ["reference", "glass", "bunny70k", "no_spheres"])
@pytest.mark.parametrize("n", [1, 1000, 32768, 921600])
def test_hit_epilogue_kernel_matches_twin(scene, bunny70k, n, which):
    s = _bounce_scene("reference" if which == "no_spheres" else which, scene, bunny70k)
    o, d = _rays(n, n + 2)
    t_s, i_s, slot, t_t, col = _hit_parts(s, o, d)
    center, mat = s.sph_center, s.sph_mat_id
    if which == "no_spheres":
        center, mat = center[:0], mat[:0]
        t_s = torch.full_like(t_s, float("inf"))
        i_s, slot = torch.full_like(i_s, -1), torch.zeros_like(slot)
    args = (o, d, t_t, col, t_s, i_s, slot, s.mm_refine, center, mat, T_MIN)
    before = tmm.hit_epilogue.launches
    got = tmm.hit_epilogue(*args)
    assert tmm.hit_epilogue.launches == before + 1
    _bit_equal(got, tmm.hit_epilogue_reference(*args))
    assert n < 1000 or bool((got[1] >= 0).any())


@pytest.mark.parametrize("which", ["reference", "bunny70k", "no_spheres"])
@pytest.mark.parametrize("masks", ["none", "active", "occ", "both"])
@pytest.mark.parametrize("n", [1, 1000, 32768, 921600])
def test_hit_front_kernel_matches_twin(scene, bunny70k, n, masks, which):
    s = bunny70k if which == "bunny70k" else scene
    sph = (s.sph_center, s.sph_radius, s.sph_ids)
    if which == "no_spheres":
        sph = tuple(v[:0] for v in sph)
    o, d = _rays(n, n + 4)
    r = np.random.default_rng(n)
    active = torch.as_tensor(r.uniform(size=n) > 0.25, device="cuda")
    occ_t = torch.as_tensor(np.where(r.uniform(size=n) > 0.5, r.uniform(1.0, 200.0, n),
                                     np.inf).astype(np.float32), device="cuda")
    args = (o, d, active if masks in ("active", "both") else None,
            occ_t if masks in ("occ", "both") else None, *sph, T_MIN)
    before = tmm.hit_front.launches
    got = tmm.hit_front(*args)
    assert tmm.hit_front.launches == before + 1
    _bit_equal(got, tmm.hit_front_reference(*args))
    assert got[3].shape == (n + (-n) % 128, 12)


def _winner_operands(s, n, seed, rr_start, bounce_kind="0-d"):
    """A scan step's shading operands from the closest hit's winners on
    the card: random lanes (some dead, light NaN on a few), the winners of
    the sphere pass and the triangle kernel, and the draws."""
    from metalpathtracer_torch.core import rng
    from metalpathtracer_torch.render import integrator as tint

    r = np.random.default_rng(seed)
    o, d = _rays(n, seed)

    def dev(a):
        return torch.as_tensor(a, device="cuda")

    light = r.uniform(0, 0.5, (n, 3)).astype(np.float32)
    light[r.uniform(size=n) < 0.01] = np.nan
    active = dev(r.uniform(size=n) > 0.2)
    bounce = {"0-d": torch.tensor(3, device="cuda"),
              "per-lane": dev(r.integers(0, 6, n))}[bounce_kind]
    t_tri, col, t_s, i_s, slot, _ = tmm.closest_hit_mm_winners(s, o, d, T_MIN,
                                                               active=active)
    drawn = rng.draws(7, torch.arange(n, device="cuda"), 1, bounce,
                      tint._step_draws(False, rr_start > 0))
    return (o, d, dev(light), dev(r.uniform(0.02, 1.0, (n, 3)).astype(np.float32)),
            active, dev(r.uniform(0, 2, n).astype(np.float32)), t_tri, col, t_s, i_s,
            slot, s.mm_refine, s.sph_center, s.sph_mat_id, T_MIN, drawn[0], drawn[1],
            drawn[-1] if rr_start else None, bounce, s.mat_bank, s.sky, rr_start,
            rr_start == 0)


def _bank_of(args, seed, bank_k, clamp, spb=4, max_depth=6):
    """The wavefront's bank for a step's winner operands (`_winner_operands`
    with a per-lane bounce): the lanes alive (those active and some dead
    ones), their item chunks and accumulators, and the plan."""
    from metalpathtracer_torch.render.kernels import shade as tsh

    n = args[0].shape[0]
    r = np.random.default_rng(seed)
    plan = tsh.BankPlan(max_depth, clamp, bank_k, spb, spb * bank_k)
    return (args[4] | torch.as_tensor(r.uniform(size=n) < 0.2, device="cuda"),
            torch.as_tensor(r.integers(0, plan.per_item, n), device="cuda"),
            torch.as_tensor(r.uniform(0.0, 3.0, (n, 3 * bank_k)).astype(np.float32),
                            device="cuda"), plan)


@pytest.mark.parametrize("which", ["reference", "glass", "bunny70k"])
@pytest.mark.parametrize("rr_start", [0, 2])
@pytest.mark.parametrize("n", [1, 1024, 16384, 32768, 921600])
def test_shade_hit_kernel_matches_twin(scene, bunny70k, n, rr_start, which):
    from metalpathtracer_torch.render.kernels import shade as tsh

    s = _bounce_scene(which, scene, bunny70k)
    args = _winner_operands(s, n, n + 5, rr_start)
    before = tsh.shade_hit.launches
    got = tsh.shade_hit(*args)
    assert tsh.shade_hit.launches == before + 1
    _bit_equal(got, tsh.shade_hit_reference(*args))
    assert int(got[6]) == int(args[4].sum())
    # the same as the epilogue's kernel, then the plain shading
    hit = tmm.hit_epilogue(*args[:2], *args[6:15])
    _bit_equal(got, tsh.shade_reference(*args[:6], *hit, *args[15:]))


@pytest.mark.parametrize("which", ["reference", "glass"])
@pytest.mark.parametrize("rr_start,clamp", [(0, False), (2, True)])
@pytest.mark.parametrize("bank_k", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 1024, 16384, 32768, 921600])
def test_shade_bank_hit_kernel_matches_twin(scene, n, bank_k, rr_start, clamp, which):
    from metalpathtracer_torch.render.kernels import shade as tsh

    s = _bounce_scene(which, scene)
    args = _winner_operands(s, n, n + 6, rr_start, "per-lane")
    bank = _bank_of(args, n + bank_k, bank_k, clamp)
    before = tsh.shade_hit.launches
    got = tsh.shade_hit(*args, bank=bank)
    assert tsh.shade_hit.launches == before + 1
    assert len(got) == 12
    _bit_equal(got, tsh.shade_hit_reference(*args, bank=bank))
    if n >= 1024:  # lanes go on, finish a path, and bank
        assert bool(got[4].any()) and bool(got[10].any()) and bool(got[11].any())


@pytest.mark.parametrize("which", ["reference", "glass"])
@pytest.mark.parametrize("bank_k", [0, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("rr_start,clamp", [(0, False), (2, True)])
@pytest.mark.parametrize("n", [1, 1024, 32768])
def test_the_plain_route_on_the_card_equals_shade_hit(scene, n, rr_start, clamp, bank_k,
                                                      which):
    # the BVH and brute intersectors' route: the epilogue's kernel, then
    # `shade_reference` and (with the bank, bank_k 0 meaning none)
    # `bank_paths` in plain torch on the card, bit for bit what `shade_hit`
    # computes from the winners in one launch
    from metalpathtracer_torch.render.kernels import shade as tsh

    s = _bounce_scene(which, scene)
    args = _winner_operands(s, n, n + 7 + bank_k, rr_start, "per-lane")
    bank = _bank_of(args, n + bank_k, bank_k, clamp) if bank_k else None
    got = tsh.shade_hit(*args, bank=bank)
    hit = tmm.hit_epilogue(*args[:2], *args[6:15])
    want = tsh.shade_reference(*args[:6], *hit, *args[15:])
    if bank is not None:
        o, d, light, tp, still, prev_pdf, rays = want
        alive, schunk, acc, plan = bank
        light, acc, bounce, alive, schunk, more, banked = tsh.bank_paths(
            light, still, alive, args[tsh.BOUNCE_ARG], schunk, acc, plan)
        want = (o, d, light, tp, alive, prev_pdf, rays, acc, bounce, schunk, more,
                banked)
    assert len(got) == len(want) == (12 if bank_k else 7)
    _bit_equal(got, want)


@pytest.mark.parametrize("entry", ["shade_hit", "shade_bank_hit"])
def test_shading_entries_in_a_cuda_graph_equal_their_twins(scene, entry):
    # captured once and replayed on new operands copied into the captured
    # inputs: what a wavefront window or a scan block does; `shade_hit`
    # without a bank and with one (its bank kernel, which its tally's second
    # slot counts)
    from metalpathtracer_torch.render.kernels import _build
    from metalpathtracer_torch.render.kernels import shade as tsh

    n = 32768
    banked = entry == "shade_bank_hit"

    def operands(seed):
        args = _winner_operands(scene, n, seed, 2, "per-lane" if banked else "0-d")
        return args, (_bank_of(args, seed, 4, True) if banked else None)

    static, bank = operands(41)
    tsh.shade_hit(*static, bank=bank)  # the warm-up launch makes the kernel's tally
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tsh.shade_hit(*static, bank=bank)
    before = _build.tallies("cuda")["shade_hit"]
    for seed in (42, 43):
        fresh, fresh_bank = operands(seed)
        for a, b in zip((*static, *(bank or ())), (*fresh, *(fresh_bank or ()))):
            if isinstance(a, torch.Tensor) and a.data_ptr() not in (
                    scene.mm_refine.data_ptr(), scene.sph_center.data_ptr(),
                    scene.sph_mat_id.data_ptr(), scene.mat_bank.data_ptr(),
                    scene.sky.data_ptr()):
                a.copy_(b)
        graph.replay()
        torch.cuda.synchronize()
        _bit_equal(out, tsh.shade_hit_reference(*static, bank=bank))
        assert bool(out[4].any())
    after = _build.tallies("cuda")["shade_hit"]
    assert (after[0] - before[0], after[1] - before[1]) == (2, 2 if banked else 0)


def test_bounce_kernels_count_replays(scene):
    # each kernel adds to its tally itself: a replay counts as a launch
    from metalpathtracer_torch.render.kernels import _build
    from metalpathtracer_torch.render import integrator as tint

    n = 4096
    o, d = _rays(n, 11)
    state = (torch.zeros((n, 3), device="cuda"), torch.ones((n, 3), device="cuda"),
             torch.ones((n,), dtype=torch.bool, device="cuda"),
             torch.zeros((n,), device="cuda"))
    pix = torch.arange(n, device="cuda")
    cfg = RenderConfig(max_depth=8, rr_start=1)

    def step():
        return tint._bounce_step(scene, o, d, *state, pix, 0, 2, 7, cfg)

    want = step()
    torch.cuda.synchronize()
    _build.zero_tallies()
    step()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    done = _build.tallies("cuda")
    for k in ("hit_front", "shade_hit", "mm_closest_hit", "threefry"):
        assert done[k][0] == 4, (k, done[k])
    assert done["shade_hit"][1] == 0  # no launch of the bank's kernel
    # the epilogue runs in the shading's registers
    assert done.get("hit_epilogue", (0, 0))[0] == 0, done["hit_epilogue"]
    _bit_equal(got[:7], want[:7])


def test_shade_bank_counts_replays(scene):
    # the wavefront's step at one bounce an advance: the front end, the
    # closest hit, one bundle and the shading with its bank, which computes
    # the epilogue
    from metalpathtracer_torch.render.kernels import _build
    from metalpathtracer_torch.render.kernels import shade as tsh
    from metalpathtracer_torch.render import integrator as tint

    shade_args = _winner_operands(scene, 4096, 13, 1, "per-lane")
    bank = _bank_of(shade_args, 13, 4, True, spb=2)
    o, d, light, tp, active, prev_pdf = shade_args[:6]
    bounce = shade_args[tsh.BOUNCE_ARG]
    pix = torch.arange(4096, device="cuda")
    cfg = RenderConfig(max_depth=6, rr_start=1, clamp_radiance=True)

    def step():
        return tint._bounce_step(scene, o, d, light, tp, active, prev_pdf, pix, 0,
                                 bounce, 7, cfg, bank=bank)

    want = step()
    torch.cuda.synchronize()
    _build.zero_tallies()
    step()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    done = _build.tallies("cuda")
    for k in ("hit_front", "shade_hit", "mm_closest_hit", "threefry"):
        assert done[k][0] == 4, (k, done[k])
    assert done["shade_hit"][1] == 4  # every launch the bank's kernel
    assert done.get("hit_epilogue", (0, 0))[0] == 0
    _bit_equal(got[:7] + tuple(got[9]), want[:7] + tuple(want[9]))


def test_bounce_step_routes_nee_to_the_plain_shading(scene):
    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render import integrator as tint
    from metalpathtracer_torch.render.kernels import shade as tsh

    n = 4096
    o, d = _rays(n, 12)
    args = (torch.zeros((n, 3), device="cuda"), torch.ones((n, 3), device="cuda"),
            torch.ones((n,), dtype=torch.bool, device="cuda"),
            torch.zeros((n,), device="cuda"), torch.arange(n, device="cuda"), 0, 2, 7)
    # without NEE the shading from the winners (its epilogue in registers);
    # with it the closest hit's and the shadow rays' epilogues and the plain
    # shading
    for nee, shaded, passes, epilogues in ((False, 1, 1, 0), (True, 0, 2, 2)):
        counts = (tsh.shade_hit.launches,
                  tmm.hit_front.launches + tmm.sphere_pass.launches,
                  tmm.hit_epilogue.launches, graphs.STATS["nee_steps"])
        tint._bounce_step(scene, o, d, *args, RenderConfig(max_depth=8, nee=nee))
        torch.cuda.synchronize()
        moved = (tsh.shade_hit.launches - counts[0],
                 tmm.hit_front.launches + tmm.sphere_pass.launches - counts[1],
                 tmm.hit_epilogue.launches - counts[2],
                 graphs.STATS["nee_steps"] - counts[3])
        assert scene.num_lights > 0
        assert moved == (shaded, passes, epilogues, int(nee))


# ---------------------------------------------------------------------------
# the wavefront's windows as CUDA graphs (render/graphs.py) against the
# eager loop: bit-equal images, equal counts
# ---------------------------------------------------------------------------


def _counted():
    # the kernels' device tallies: a replay runs no wrapper, only kernels
    from metalpathtracer_torch.render.kernels import _build

    # (the shading's entry: `shade_hit_kernel`'s launches, then those of
    # `shade_bank_hit_kernel<K>`, its tally's second slot)
    done = _build.tallies("cuda")
    hit, bank_hit = done.get("shade_hit", (0, 0))
    return (done.get("mm_closest_hit", (0, 0))[0], done.get("cull_tile_lists", (0, 0))[0],
            *done.get("threefry", (0, 0)),
            *(done.get(k, (0, 0))[0] for k in ("hit_front", "hit_epilogue")),
            hit - bank_hit, bank_hit,
            *(done.get(k, (0, 0))[0]
              for k in ("restart_lanes", "queue_pop", "tileset_key", "permute_lanes")))


def _clustered():
    # the closest hit's launches that shared walks over clusters
    from metalpathtracer_torch.render.kernels import _build

    return _build.tallies("cuda").get("mm_closest_hit", (0, 0))[1]


def _render_counted(fn, eager):
    from metalpathtracer_torch.render import graphs

    before = _counted()
    with graphs.eager() if eager else contextlib.nullcontext():
        out = fn()
    torch.cuda.synchronize()
    return out, tuple(a - b for a, b in zip(_counted(), before))


# (width, height, spp, cfg, pool): no drain (pool within the drain width),
# a drain, NEE with Russian roulette, two bounces an advance
GRAPH_CASES = {
    "feed_only": (64, 36, 4, dict(max_depth=6, bank_k=2), 128),
    "feed_and_drain": (256, 144, 2, dict(max_depth=8), 4096),
    "nee_rr": (128, 72, 2, dict(max_depth=8, nee=True, rr_start=2), 2048),
    "two_bounces": (128, 72, 2, dict(max_depth=6, bounces_per_iter=2), 2048),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_windows_equal_the_eager_loop(scene, case):
    from metalpathtracer_torch.render import graphs

    w, h, spp, cfg, pool = GRAPH_CASES[case]
    cfg = RenderConfig(**cfg)
    graphs.clear()

    def render():
        return render_image_wavefront(scene, Camera.reset(), w, h, spp, seed=3,
                                      cfg=cfg, pool_size=pool, return_stats=True)

    (a, ra, sa), ca = _render_counted(render, eager=True)
    graphs.zero_stats()
    (b, rb, sb), cb = _render_counted(render, eager=False)
    first = dict(graphs.STATS)
    graphs.zero_stats()
    (c, rc, sc), cc = _render_counted(render, eager=False)
    again = dict(graphs.STATS)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert ra == rb == rc and sa == sb == sc
    # every kernel ran, but the shading kernels, which NEE's plain shading
    # replaces (by config), and the epilogue, which without NEE runs in the
    # shading's registers; at one bounce an advance the shading banks
    # (shade_bank_hit_kernel), at two it is shade_hit_kernel and the plain
    # bank
    assert ca == cb == cc and min(ca[:5]) > 0 and (ca[5] > 0) == cfg.nee
    assert (ca[6] + ca[7] > 0) != cfg.nee
    assert (ca[7] > 0) == (not cfg.nee and cfg.bounces_per_iter == 1)
    assert (ca[6] > 0) == (not cfg.nee and cfg.bounces_per_iter > 1)
    # the regeneration runs on its kernels on every route: restart, queue,
    # the sort's key and gather
    assert min(ca[8:]) > 0 and ca[10] == ca[11]
    # a new shape warms each function up eagerly and captures it on its
    # second run; the next render replays every window and drain block
    assert first["captures"] >= 1 and first["replays"] >= 1
    assert again["captures"] == again["eager_runs"] == 0
    assert again["replays"] == again["reads"] > 0


def test_a_camera_move_between_replays(scene):
    from metalpathtracer_torch.render import graphs

    cfg = RenderConfig(max_depth=6)
    moved = Camera.look_at((4.0, 22.0, 46.0), (0.0, 12.0, 0.0), vfov_deg=50.0)
    graphs.clear()
    render_image_wavefront(scene, Camera.reset(), 128, 72, 2, seed=1, cfg=cfg,
                           pool_size=2048)
    render_image_wavefront(scene, Camera.reset(), 128, 72, 2, seed=1, cfg=cfg,
                           pool_size=2048)
    graphs.zero_stats()
    got, rays = render_image_wavefront(scene, moved, 128, 72, 2, seed=1, cfg=cfg,
                                       pool_size=2048)
    assert graphs.STATS["captures"] == 0 and graphs.STATS["replays"] > 0
    with graphs.eager():
        want, want_rays = render_image_wavefront(scene, moved, 128, 72, 2, seed=1,
                                                 cfg=cfg, pool_size=2048)
    assert torch.equal(got, want) and rays == want_rays


def test_a_capture_serves_three_progressive_steps(scene):
    from metalpathtracer_torch.render import graphs

    cfg = RenderConfig(max_depth=6)
    graphs.clear()
    graphs.zero_stats()
    state = want = tpipe.init_accum(128, 72, "cuda")
    captures = []
    for _ in range(3):
        state, rays = tpipe.accumulate_wavefront(state, scene, Camera.reset(), 128,
                                                 72, 1, 7, cfg, pool_size=2048)
        captures.append(graphs.STATS["captures"])
        with graphs.eager():
            want, want_rays = tpipe.accumulate_wavefront(
                want, scene, Camera.reset(), 128, 72, 1, 7, cfg, pool_size=2048)
        assert torch.equal(state.rgb_sum, want.rgb_sum) and rays == want_rays
    assert len(graphs._cache) == 1
    assert captures[0] >= 1 and captures[0] == captures[1] == captures[2]


def test_a_failed_capture_raises(scene, monkeypatch):
    from metalpathtracer_torch.render import graphs

    cull = tmm._cull_tile_lists

    def syncing(*args, **kw):
        out = cull(*args, **kw)
        out[1].any().item()  # a host read: no stream capture allows it
        return out

    syncing.launches = 0  # the kernel's wrapper counts on the module's name
    syncing.routes = {"rank": 0, "radix": 0}
    monkeypatch.setattr(tmm, "_cull_tile_lists", syncing)
    graphs.clear()
    with pytest.raises(RuntimeError):
        render_image_wavefront(scene, Camera.reset(), 128, 72, 2, seed=1,
                               cfg=RenderConfig(max_depth=6), pool_size=2048)
    assert len(graphs._cache) == 0
    torch.cuda.synchronize()
    monkeypatch.setattr(tmm, "_cull_tile_lists", cull)
    # the card is usable after the failed capture
    a, _ = render_image_wavefront(scene, Camera.reset(), 64, 36, 1, seed=1,
                                  cfg=RenderConfig(max_depth=4), pool_size=128)
    assert torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# the scan's blocks as CUDA graphs against the eager loop (`graphs.eager()`:
# one bounce step and one read a bounce, as before the blocks): bit-equal
# images and rays; the card's launches equal but for the steps a block ran
# past its last live lane, each of which launches what a bounce step does
# ---------------------------------------------------------------------------


def _scan_run(fn, eager):
    """fn() on one loop: (its result, launches on the card, graphs.STATS
    moved by it)."""
    from metalpathtracer_torch.render import graphs

    before = dict(graphs.STATS)
    out, launched = _render_counted(fn, eager)
    return out, launched, {k: v - before[k] for k, v in graphs.STATS.items()}


def _scan_launches_agree(eager, graph, samples):
    """The graph run's launches are the eager loop's plus its idle steps',
    each an eager bounce step's: (closest hit, cull, threefry, draws,
    front end, hit epilogue, shade_hit_kernel, shade_bank_hit_kernel) per
    step from the eager run, whose reads are its steps; the jitter draws
    one bundle (of one draw) a sample."""
    (_, e, es), (_, g, gs) = eager, graph
    assert es["idle_steps"] == 0 and es["reads"] > 0
    for k, jitter in enumerate((0, 0, samples, samples, 0, 0, 0, 0)):
        per_step, rest = divmod(e[k] - jitter, es["reads"])
        assert rest == 0
        assert g[k] == e[k] + gs["idle_steps"] * per_step


def _glass():
    return upload_scene(load_scene_xml(os.path.join(REPO, "scenes", "cornell_glass.xml")),
                        "cuda")


def _glass_cam():
    return Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


# name -> (scene: "reference" or "glass", fn(scene) -> list of tensors and
# rays, samples a render draws a jitter for)
SCAN_GRAPH_CASES = {
    "flagship_small": ("reference", lambda s: render_image(
        s, Camera.reset(), 128, 72, 2, seed=3, cfg=RenderConfig(max_depth=32)), 2),
    "nee_rr": ("glass", lambda s: render_image(
        s, _glass_cam(), 128, 128, 2, seed=4,
        cfg=RenderConfig(max_depth=16, nee=True, rr_start=3)), 2),
    "checkpointed_2_2_1": ("reference", lambda s: _accumulated(s, (2, 2, 1)), 5),
    "row_block": ("reference", lambda s: _row_block(s), 2),
}


def _accumulated(scene, steps):
    state, outs = tpipe.init_accum(64, 36, "cuda"), []
    for n in steps:
        state = tpipe.accumulate(state, scene, Camera.reset(), 64, 36, n, 5,
                                 RenderConfig(max_depth=8))
        outs.append(state.rgb_sum)
    return outs, state.spp


def _row_block(scene):
    from metalpathtracer_torch.parallel import sharding

    return sharding.shard_render(scene, Camera.reset(), 128, 72, 2, 6,
                                 RenderConfig(max_depth=8), 1, 4)


@pytest.mark.parametrize("case", sorted(SCAN_GRAPH_CASES))
def test_scan_graph_blocks_equal_the_eager_loop(scene, case):
    from metalpathtracer_torch.render import graphs

    which, fn, samples = SCAN_GRAPH_CASES[case]
    s = scene if which == "reference" else _glass()
    graphs.clear()
    eager = _scan_run(lambda: fn(s), eager=True)
    first = _scan_run(lambda: fn(s), eager=False)
    again = _scan_run(lambda: fn(s), eager=False)
    for run in (first, again):
        out, want = run[0], eager[0]
        tensors = out[0] if isinstance(out[0], list) else [out[0]]
        wanted = want[0] if isinstance(want[0], list) else [want[0]]
        assert all(torch.equal(a, b) for a, b in zip(tensors, wanted))
        assert out[1] == want[1]
        _scan_launches_agree(eager, run, samples)
    assert first[2]["captures"] >= 1
    assert again[2]["captures"] == again[2]["eager_runs"] == 0
    assert again[2]["replays"] > again[2]["reads"] > 0
    assert again[2]["reads"] <= eager[2]["reads"]  # one read a block, not a step


def test_scan_graph_camera_move_between_replays(scene):
    from metalpathtracer_torch.render import graphs

    cfg = RenderConfig(max_depth=8)
    moved = Camera.look_at((4.0, 22.0, 46.0), (0.0, 12.0, 0.0), vfov_deg=50.0)
    graphs.clear()
    for _ in range(2):
        render_image(scene, Camera.reset(), 128, 72, 2, seed=1, cfg=cfg)
    graphs.zero_stats()
    got, rays = render_image(scene, moved, 128, 72, 2, seed=1, cfg=cfg)
    assert graphs.STATS["captures"] == 0 and graphs.STATS["replays"] > 0
    with graphs.eager():
        want, want_rays = render_image(scene, moved, 128, 72, 2, seed=1, cfg=cfg)
    assert torch.equal(got, want) and rays == want_rays


def test_scan_graph_capture_serves_three_progressive_steps(scene):
    # a step of one sample runs each function once: the first step warms
    # them up, the second captures them, and its capture serves the second,
    # third and fourth
    from metalpathtracer_torch.render import graphs

    cfg = RenderConfig(max_depth=8)
    graphs.clear()
    graphs.zero_stats()
    state = want = tpipe.init_accum(128, 72, "cuda")
    captures = []
    for _ in range(4):
        state = tpipe.accumulate(state, scene, Camera.reset(), 128, 72, 1, 7, cfg)
        captures.append(graphs.STATS["captures"])
        with graphs.eager():
            want = tpipe.accumulate(want, scene, Camera.reset(), 128, 72, 1, 7, cfg)
        assert torch.equal(state.rgb_sum, want.rgb_sum)
    assert len(graphs._cache) == 1
    assert captures[0] == 0 and captures[1] >= 1
    assert captures[1] == captures[2] == captures[3]


@pytest.fixture(scope="module")
def rtiow():
    """The benchmark's final scene of "Ray Tracing in One Weekend" (487
    spheres, no mesh) on the card through the port's own scene types, and
    its camera."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from metalpathtracer_torch.scene.types import HostScene, Material

    with open(os.path.join(REPO, "portbench", "configs", "rtiow_final.json")) as f:
        cfg = json.load(f)
    host = HostScene()
    for s in cfg["scene"]["spheres"]:
        host.add_sphere(s["center"], s["radius"], Material(
            albedo=tuple(s["albedo"]), material_type=s.get("material_type", 0.0),
            fuzz=s.get("fuzz", 0.0)))
    c = cfg["camera"]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    camera = Camera(position=f32(c["position"]), forward=f32(c["forward"]),
                    up=f32(c["up"]), vfov_deg=f32(c["vfov_deg"]))
    return upload_scene(host, "cuda"), camera


def test_scan_graph_counts_sphere_tests_at_each_replay(rtiow, monkeypatch):
    # a scene of spheres alone at depth 50: each replayed block adds the
    # lanes times the sphere table's rows (487 spheres and one padding row)
    # of each of its steps, as counted at its capture, and the counter adds
    # no node to any graph
    from metalpathtracer_torch.render import graphs, integrator

    scene, camera = rtiow
    w, h, seed, cfg = 160, 90, 3, RenderConfig(max_depth=50)
    n, spheres = w * h, scene.sph_center.shape[0]
    assert spheres == 488

    def replayed_sample():
        graphs.clear()
        state = tpipe.init_accum(w, h, "cuda")
        for _ in range(6):  # warm-ups and captures, until a sample makes none
            graphs.zero_stats()
            state = tpipe.accumulate(state, scene, camera, w, h, 1, seed, cfg)
            if graphs.STATS["captures"] == graphs.STATS["eager_runs"] == 0:
                break
        graphs.zero_stats()
        launches = tmm.sphere_pass.launches
        state = tpipe.accumulate(state, scene, camera, w, h, 1, seed, cfg)
        entry = integrator.scan_entry(scene, w, h, n, seed, cfg)
        stats = dict(graphs.STATS)
        assert stats["captures"] == stats["eager_runs"] == 0 and stats["replays"] > 0
        assert tmm.sphere_pass.launches == launches  # no Python ran a step
        nodes = {k: v[0] for k, v in entry.nodes.items()}
        counts = dict(entry.sphere_tests)
        steps = int(entry.program.bounce)  # the sample's steps, idle ones too
        graphs.clear()
        return state.rgb_sum, stats, nodes, counts, steps

    img, stats, nodes, counts, steps = replayed_sample()
    # whole blocks of 8 steps until no lane lives, then the last 2 (on the
    # CPU the third sample of these 14,400 lanes runs all 50)
    assert steps in (16, 24, 32, 40, 48, 50)
    assert stats["sphere_tests"] == n * spheres * steps
    assert counts["bounce_block"] == n * spheres * 8
    assert counts.get("last_block", n * spheres * 2) == n * spheres * 2
    assert counts["start_sample"] == counts["end_sample"] == 0
    monkeypatch.setattr(integrator, "_count_sphere_tests", lambda scene, o: None)
    img_off, stats_off, nodes_off, _, steps_off = replayed_sample()
    assert stats_off["sphere_tests"] == 0
    assert nodes_off == nodes and stats_off["replayed_ops"] == stats["replayed_ops"]
    assert steps_off == steps and torch.equal(img_off, img)


@pytest.mark.parametrize("integrator", ["scan", "wavefront"])
def test_bvh_cli_on_card_runs_eagerly_and_equals_its_eager_render(scene, tmp_path,
                                                                  integrator):
    from metalpathtracer_torch import cli
    from metalpathtracer_torch.render import graphs

    def run(name):
        argv = ["--scene", os.path.join(REPO, "scenes", "reference.xml"), "--width",
                "96", "--height", "54", "--spp", "2", "--max-depth", "6",
                "--device", "cuda", "--intersector", "bvh", "--output",
                str(tmp_path / f"{name}.png"), "--npz", str(tmp_path / f"{name}.npz")]
        assert cli.main(argv + (["--wavefront"] if integrator == "wavefront" else [])) == 0
        with np.load(tmp_path / f"{name}.npz") as z:
            return z["radiance"]

    graphs.clear()
    graphs.zero_stats()
    got = run("graph_path")
    # by config: every function ran eagerly, none was warmed up on a side
    # stream, captured or replayed
    assert graphs.STATS["captures"] == graphs.STATS["replays"] == 0
    assert graphs.STATS["eager_runs"] > 0
    with graphs.eager():
        want = run("eager")
    assert np.array_equal(got, want) and got.mean() > 0.05


@pytest.mark.parametrize("integrator", ["scan", "wavefront"])
def test_flagship_shades_from_the_winners(scene, tmp_path, integrator):
    # the main path (1280x720, spp 4, depth 32): every bounce step shades
    # from the closest hit's winners, so the epilogue's kernel runs no time;
    # the other kernels' launches are the flagship's (PERF.md)
    from metalpathtracer_torch import cli
    from metalpathtracer_torch.render import graphs

    argv = ["--scene", os.path.join(REPO, "scenes", "reference.xml"), "--width",
            "1280", "--height", "720", "--spp", "4", "--max-depth", "32", "--device",
            "cuda", "--output", str(tmp_path / "f.png")]
    argv += ["--wavefront"] if integrator == "wavefront" else []
    graphs.clear()
    for eager in (True, False):
        clustered = _clustered()
        launched = _render_counted(lambda: cli.main(argv), eager)[1]
        clustered = _clustered() - clustered
        mm, cull, bundles, _, front, epilogue, hit, bank_hit, *regen = launched
        if integrator == "wavefront":
            # the restart draws the jitter itself: one bundle a bounce step;
            # every step's shading banks (one bounce an advance)
            assert (mm, cull, bundles, front, bank_hit) == (408, 408, 408, 408, 408)
            assert clustered == mm  # the pool's 256 subgroups share their walks
            assert epilogue == hit == 0
            assert regen[0] == 409 and min(regen) > 0
        else:  # the graph loop's idle steps launch a step's kernels too
            assert (mm, cull, bundles - 4, front, hit) == (mm, mm, mm, mm, mm)
            assert mm >= 128 and (mm == 128 or not eager)
            assert clustered == 0  # 7,200 subgroups: one CTA each
            assert epilogue == bank_hit == 0
            assert not any(regen)


# ---------------------------------------------------------------------------
# the wavefront's regeneration kernels (csrc/wavefront.cu) against their
# twins, bit for bit, eagerly and replayed in a CUDA graph; the flagship on
# them
# ---------------------------------------------------------------------------

REGEN = ("restart_lanes", "queue_pop", "tileset_key", "permute_lanes")


def _regen_operands(scene, kernel, n, seed):
    """A regeneration kernel's operands at n lanes, from numpy seeds: the
    lane state of a pool whose items run out part-way (`queue_pop`'s
    bank and more masks, its queue head and total), rays at the reference
    scene's coarse boxes with zero direction components, origins on box
    planes and dead lanes (`tileset_key`), a permutation with the pending
    bank (`permute_lanes`)."""
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    r = np.random.default_rng(seed)
    dev = "cuda"
    ka, groups = 12, 3 * n
    f = lambda *s: torch.as_tensor(r.standard_normal(s).astype(np.float32),  # noqa: E731
                                   device=dev)
    i = lambda hi: torch.as_tensor(r.integers(0, hi, n), device=dev)  # noqa: E731
    lanes = dict(item=i(4 * groups), schunk=i(16), acc=f(n, ka), o=f(n, 3), d=f(n, 3),
                 bounce=i(32), light=f(n, 3), tp=f(n, 3), prev_pdf=f(n),
                 alive=torch.as_tensor(r.random(n) < 0.6, device=dev), pixel=i(1 << 20),
                 sample=i(1 << 10))
    if kernel == "restart_lanes":
        plan = twfk.LanePlan(1280, 720, groups, 4, 4, 1280 * 7, 0x5EED)
        basis = tpipe.camera_basis(Camera.reset(), 1280, 720).to(dev)
        return (lanes, torch.as_tensor(r.random(n) < 0.4, device=dev), basis,
                torch.tensor(5, device=dev), plan)
    if kernel == "queue_pop":
        bank = torch.as_tensor(r.random(n) < 0.15, device=dev)
        more = ~bank & torch.as_tensor(r.random(n) < 0.3, device=dev)
        head = int(r.integers(0, 1 << 20))
        total = head + int(bank.sum()) // 2  # the queue runs out part-way
        return (bank, more, lanes["item"], lanes["acc"], i(groups), f(n, ka),
                torch.tensor(head, device=dev), total, groups)
    if kernel == "tileset_key":
        boxes = scene.mm_coarse_box
        o, d = lanes["o"] * 20.0, lanes["d"]
        d[torch.as_tensor(r.random((n, 3)) < 0.15, device=dev)] = 0.0
        on = torch.as_tensor(r.random(n) < 0.2, device=dev)
        c = torch.as_tensor(r.integers(0, boxes.shape[0], n), device=dev)
        a = torch.as_tensor(r.integers(0, 3, n), device=dev)
        rows = torch.arange(n, device=dev)
        o[rows[on], a[on]] = boxes[c[on], a[on]]
        return o, d, lanes["alive"], boxes, T_MIN
    perm = torch.as_tensor(r.permutation(n), device=dev)
    return perm, lanes, (i(groups), f(n, ka))


def _regen_call(kernel, args):
    """A regeneration kernel's (or twin's) outputs as a flat tuple: the
    in-place queue's updated tensors after its returns."""
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    out = getattr(twfk, kernel)(*args)
    if kernel == "queue_pop":
        return (*out, *args[2:6])
    if kernel == "tileset_key":
        return (out,)
    if kernel == "restart_lanes":
        return tuple(out[k] for k in twfk.LANE_FIELDS)
    return (*(out[0][k] for k in twfk.LANE_FIELDS), *out[1])


def _fresh(args):
    """Clones of the tensors of `args` (and of a lane dict's): the queue
    updates its operands in place."""
    def clone(a):
        if isinstance(a, dict):
            return {k: v.clone() for k, v in a.items()}
        if isinstance(a, tuple) and not hasattr(a, "_fields"):  # not a plan
            return tuple(clone(x) for x in a)
        return a.clone() if isinstance(a, torch.Tensor) else a
    return tuple(clone(a) for a in args)


@pytest.mark.parametrize("n", [1024, 16384, 32768])
@pytest.mark.parametrize("kernel", REGEN)
def test_regen_kernel_matches_twin(scene, kernel, n):
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    args = _regen_operands(scene, kernel, n, n + len(kernel))
    twin = getattr(twfk, f"{kernel}_reference")
    before = getattr(twfk, kernel).launches
    got = _regen_call(kernel, _fresh(args))
    assert getattr(twfk, kernel).launches == before + 1
    with pytest.MonkeyPatch.context() as m:  # the wrapper's name runs its twin
        m.setattr(twfk, kernel, twin)
        want = _regen_call(kernel, _fresh(args))
    torch.cuda.synchronize()
    _bit_equal(got, want)
    if kernel == "queue_pop":  # lanes regenerate, and the queue runs out
        restart, head, item = got[0], got[1], got[2]
        assert bool(restart.any()) and int(head) == args[7]
        assert bool((args[0] & ~restart).any())
    if kernel == "tileset_key":
        assert int((got[0] != -(1 << 31)).sum()) > 0


@pytest.mark.parametrize("n", [1024, 32768])
def test_restart_lanes_deals_rows_like_its_twin(scene, n):
    # rank 2 of 4 tile shards of 1920x1080: every lane's pixel is on an
    # image row 2 mod 4, and the kernel is bit-equal to its twin
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    lanes, restart, _, offset, _ = _regen_operands(scene, "restart_lanes", n, n + 3)
    w, h, stride, r = 1920, 1080, 4, 2
    groups = (h // stride) * w // 4
    plan = twfk.LanePlan(w, h, groups, 4, 4, r * w, 0x5EED, stride)
    basis = tpipe.camera_basis(Camera.reset(), w, h).to("cuda")
    args = (lanes, restart, basis, offset, plan)
    got = _regen_call("restart_lanes", _fresh(args))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(twfk, "restart_lanes", twfk.restart_lanes_reference)
        want = _regen_call("restart_lanes", _fresh(args))
    torch.cuda.synchronize()
    _bit_equal(got, want)
    pixel = got[twfk.LANE_FIELDS.index("pixel")]
    local = (lanes["item"] % groups) * 4 + lanes["schunk"] // 4
    assert torch.equal(pixel, (local // w * stride + r) * w + local % w)
    assert bool((pixel // w % stride == r).all()) and int(pixel.max()) < w * h


@pytest.mark.parametrize("n", [1024, 16384, 32768])
@pytest.mark.parametrize("kernel", REGEN)
def test_regen_kernel_in_a_cuda_graph_equals_its_twin(scene, kernel, n):
    # captured once and replayed on new operands copied into the captured
    # inputs, as a wavefront window replays them
    from metalpathtracer_torch.render.kernels import wavefront as twfk

    static = _regen_operands(scene, kernel, n, 7)
    fn = getattr(twfk, kernel)
    _regen_call(kernel, _fresh(static))  # the warm-up launch makes the tally
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _regen_call(kernel, static)

    def copy_into(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                dst[k].copy_(src[k])
        elif isinstance(dst, tuple) and not hasattr(dst, "_fields"):
            for a, b in zip(dst, src):
                copy_into(a, b)
        elif isinstance(dst, torch.Tensor) and dst.data_ptr() != scene.mm_coarse_box.data_ptr():
            dst.copy_(src)

    for seed in (8, 9):
        fresh = _regen_operands(scene, kernel, n, seed)
        if kernel == "queue_pop":  # the captured call's total and groups
            fresh = (*fresh[:7], *static[7:])
        copy_into(static, fresh)
        kept = _fresh(static)
        graph.replay()
        torch.cuda.synchronize()
        with pytest.MonkeyPatch.context() as m:
            m.setattr(twfk, kernel, getattr(twfk, f"{kernel}_reference"))
            want = _regen_call(kernel, kept)
        _bit_equal(out, want)
    assert fn is getattr(twfk, kernel)


def test_flagship_wavefront_regenerates_on_the_kernels(scene):
    # the main path on both loops: the same image, and per render one
    # restart a bounce step and the start's, one queue pop an advance of the
    # feed, one key and gather every four advances; the jitter is drawn in
    # the restart, so threefry draws a bounce step's bundle alone
    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.render.kernels import _build

    def render():
        return render_image_wavefront(scene, Camera.reset(), 1280, 720, 4, seed=0,
                                      cfg=RenderConfig(max_depth=32), pool_size=1 << 15)

    graphs.clear()
    torch.cuda.synchronize()
    _build.zero_tallies()
    runs = []
    for eager in (True, False, False):
        (img, rays), _ = _render_counted(render, eager)
        done = _build.tallies("cuda")
        runs.append((img, rays, tuple(done.get(k, (0, 0))[0] for k in REGEN),
                     done["threefry"], done["mm_closest_hit"][0]))
        _build.zero_tallies()
    (img, rays, regen, threefry, steps) = runs[0]
    for other in runs[1:]:
        assert torch.equal(img, other[0]) and rays == other[1]
        assert other[2:] == runs[0][2:]
    restart, queue, key, permute = regen
    assert steps == 408 and threefry == (408, 816)
    assert restart == steps + 1 and 0 < queue < steps
    assert key == permute == steps // 4


# ---------------------------------------------------------------------------
# the spans on the graph path: each replay's device events against the node
# map its capture recorded (`graphs.span_maps`, `metrics.charge_events`),
# and `STATS["replayed_ops"]` against the replayed events of the profile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["scan", "wavefront", "rtiow_scan"])
def test_replays_match_their_capture_span_maps(request, kind):
    # rtiow_scan: the scan on the benchmark's scene of spheres alone, whose
    # closest hit is the sphere pass (`hit.sphere_pass`)
    from torch.profiler import ProfilerActivity, profile

    from metalpathtracer_torch.render import graphs
    from metalpathtracer_torch.utils import metrics

    w, h, spp, cfg = 160, 90, 2, RenderConfig(max_depth=8)
    if kind == "rtiow_scan":
        scene, camera = request.getfixturevalue("rtiow")
    else:
        scene, camera = request.getfixturevalue("scene"), Camera.reset()

    def one_pass(state):
        if kind != "wavefront":
            state = tpipe.accumulate(state, scene, camera, w, h, spp, 5, cfg)
        else:  # 28,800 paths through 4,096 lanes: windows and drain blocks
            state, _ = tpipe.accumulate_wavefront(state, scene, camera, w, h,
                                                  spp, 5, cfg, 4096)
        return tpipe.to_image(state)

    graphs.clear()
    state = tpipe.init_accum(w, h, "cuda")
    for _ in range(4):  # until a pass captures and warms nothing
        before = dict(graphs.STATS)
        one_pass(state)
        if (graphs.STATS["captures"] == before["captures"]
                and graphs.STATS["eager_runs"] == before["eager_runs"]):
            break
    torch.cuda.synchronize()
    graphs.zero_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_pass(state)
        torch.cuda.synchronize()
    device, host = metrics.profile_events(prof)
    charges, replays, unmatched = metrics.charge_events(device, host, graphs.span_maps())
    launches = {corr for name, _, _, corr in host if name.startswith("cudaGraphLaunch")}
    replayed = [d for d in device if d[3] in launches]
    maps = graphs.span_maps()
    assert replays == graphs.STATS["replays"] > 0 and graphs.STATS["eager_runs"] == 0
    assert unmatched == 0, (replays, unmatched, {k: list(v) for k, v in maps.items()})
    assert len(replayed) == graphs.STATS["replayed_ops"]
    assert all(span != metrics.NO_SPAN for span, _, _ in charges)
    charged = {span for span, _, _ in charges}
    if kind == "rtiow_scan":
        assert {span for span, _, name in charges if "hit_front_kernel" in name} == {
            "hit.sphere_pass"}
        assert "hit.mm_closest_hit" not in charged and "hit.front" not in charged
    else:
        assert "hit.mm_closest_hit" in charged and "hit.front" in charged
    graphs.clear()
