"""The hand-written CUDA kernels against their plain twins: the closest-hit
kernel (also against the brute-force oracle), the tile cull and the RNG's
threefry (bit-equal in every mode, also inside a CUDA graph), and the
wavefront integrator, the progressive path (checkpointed CLI, progressive
wavefront, the viewer's frames) and the BVH study path on the card. These tests need an NVIDIA card (sm_90a)
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


def _tie_case(order):
    """One subgroup of 128 rays straight down -z onto one triangle that the
    slab holds four times: columns 5, 40 and 100 of tile 0 (three column
    slices at any K up to 4) and column 3 of tile 1. `order` is the list."""
    tile_p = 128
    v = np.zeros((2 * tile_p, 3, 3), np.float32)  # zero rows: never accepted
    tri = np.asarray([[-2.0, -2.0, -5.0], [2.0, -2.0, -5.0], [0.0, 2.0, -5.0]],
                     np.float32)
    for c in (5, 40, 100, tile_p + 3):
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


def test_wavefront_on_card_matches_scan(scene):
    cfg = RenderConfig(max_depth=6, bank_k=2)
    cam = Camera.reset()
    a, ra = render_image(scene, cam, 64, 36, 4, seed=7, cfg=cfg)
    launches = tmm.mm_closest_hit.launches, tmm.cull_tiles.launches
    b, rb = render_image_wavefront(scene, cam, 64, 36, 4, seed=7, cfg=cfg,
                                   pool_size=128)
    assert tmm.mm_closest_hit.launches > launches[0]
    assert tmm.cull_tiles.launches > launches[1]
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    assert ra == rb


def _launches():
    return tmm.mm_closest_hit.launches, tmm.cull_tiles.launches


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
    assert torch.equal(torch.cat([p[0] for p in parts]) / spp, whole)
    assert sum(p[1] for p in parts) == rays
    whole, rays = render_image_wavefront(scene, cam, w, h, spp, seed=2, cfg=cfg)
    parts = [sh.shard_render_wavefront(scene, cam, w, h, spp, 2, cfg, None, i, n)
             for i in range(n)]
    img = torch.cat([p[0] for p in parts]) / spp
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
    before = tfk.threefry.launches
    got = tfk.threefry(-5, pix, sample, bounce, 4, mode)
    torch.cuda.synchronize()
    assert tfk.threefry.launches == before + 1
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
