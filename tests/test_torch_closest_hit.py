"""The port's closest hit (`render/kernels/intersect_mm.py`) against the JAX
reference and against the port's brute-force oracle, on the CPU.

On a CPU tensor the kernel wrapper runs its plain twin, so these tests hold
the twin (and everything around the kernel: features, cull, lists, refine,
sphere merge) to the reference. The CUDA kernel is held to the same twin on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances:
- the cull (lists, counts, smin, lane_bound) is the same float32 slab test
  in the same order, so it must be bit-equal;
- ray features: d and o are copied, so exact; o x d, o.d and |o|^2 within
  rtol 1e-6 (XLA fuses the cross product into FMAs);
- closest hit vs the reference: hit indices, materials and front faces
  equal; t at rtol 5e-4, atol 1e-2 (tests/test_intersect_mm.py's bound: the
  reference's giant ground sphere quadratic is FMA-contracted by XLA);
  normals at atol 1e-5; `tile_passes` equal. The one allowed difference is
  an edge flip of the reference: its kernel tests in a bf16 hi/lo split
  (~2^-16 relative), the port's twin in f32, so at a triangle edge the
  reference may reject a hit that the exact Moller-Trumbore test accepts,
  or accept one that it rejects. A lane may differ only so, and such lanes
  are at most 1% (0 or 1 of 2048 here);
- closest hit vs the port's brute oracle: indices equal, t as above.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.render.intersect import closest_hit_bruteforce, ray_triangle
from metalpathtracer_torch.render.kernels import intersect_mm as tmm
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu.render.pallas import intersect_mm as jmm
from metalpathtracer_torch import scene as tscene
from metalpathtracer_tpu import scene as jscene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MIN = 1e-4
# the suite runs in several pytest-xdist workers at once: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    path = os.path.join(REPO, "scenes", "reference.xml")
    return j_upload(jscene.load_scene_xml(path)), t_upload(tscene.load_scene_xml(path), "cpu")


def _rays(n, seed, span=30.0, center=(0.0, 20.0, 40.0)):
    """The distribution of tests/test_intersect_mm.py's random_rays, with
    every other ray aimed at the bunny (centred at (-25, 5, 0)), so both
    the spheres and the triangle kernel see many hits."""
    r = np.random.default_rng(seed)
    o = r.uniform(-span, span, (n, 3)).astype(np.float32)
    o += np.asarray(center, np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    aim = np.arange(n) % 2 == 1
    target = np.asarray([-25.0, 5.0, 0.0]) + r.uniform(-6.0, 6.0, (n, 3))
    d[aim] = (target - o)[aim]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _masks(n, seed):
    r = np.random.default_rng(seed + 1000)
    active = r.uniform(size=n) > 0.25
    occ = np.where(r.uniform(size=n) > 0.5, r.uniform(1.0, 200.0, n),
                   np.inf).astype(np.float32)
    return active, occ


def test_ray_features_match():
    o, d = _rays(300, 1)
    j = np.asarray(jmm.ray_features(jnp.asarray(o), jnp.asarray(d)))
    t = tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d)).numpy()
    assert t.shape == (300, tmm.NUM_FEATURES)
    np.testing.assert_array_equal(t[:, 0:3], j[:, 0:3])
    np.testing.assert_array_equal(t[:, 6:9], j[:, 6:9])
    np.testing.assert_array_equal(t[:, 11], j[:, 11])
    np.testing.assert_allclose(t[:, 3:6], j[:, 3:6], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(t[:, 9:11], j[:, 9:11], rtol=1e-6)
    assert not j[:, 12:].any()  # the reference's 4 padding features


@pytest.mark.parametrize("n", [128, 640, 2048])
def test_cull_tile_lists_bit_equal(scenes, n):
    js, ts = scenes
    o, d = _rays(n, n)
    active, occ = _masks(n, n)
    jx = jmm.ray_features(jnp.asarray(o), jnp.asarray(d))
    tx = tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    jout = jmm._cull_tile_lists(
        jx, jnp.asarray(active.astype(np.float32)), js.mm_tile_box, T_MIN,
        jnp.asarray(occ), block_r=128,
    )
    tout = tmm._cull_tile_lists(
        tx, torch.as_tensor(active.astype(np.float32)), ts.mm_tile_box, T_MIN,
        torch.as_tensor(occ),
    )
    for name, t, j in zip(("lists", "counts", "smin", "lane_bound"), tout, jout):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    counts = tout[1].numpy()
    assert counts.max() > 0 and counts.min() < ts.mm_tile_box.shape[0]


def _exact_t(ts, o, d, idx):
    """The exact Moller-Trumbore t of triangle `idx` (inf for a sphere,
    a miss or a rejected test)."""
    prim = torch.as_tensor(np.maximum(idx, 0)).long()
    t = ray_triangle(torch.as_tensor(o), torch.as_tensor(d), ts.p0[prim],
                     ts.p1[prim], ts.p2[prim]).numpy()
    tri = (idx >= 0) & (ts.prim_type[prim].numpy() == tscene.PRIM_TRIANGLE)
    return np.where(tri, t, np.inf)


def _compare_hits(t_out, j_out, ts=None, o=None, d=None):
    tt, ti, tn, tf, tm, tp = t_out
    jt, ji, jn, jf, jm, jp = (np.asarray(v) for v in j_out)
    diff = ti.numpy() != ji
    if diff.any():
        # only reference edge flips: the port's winner passes the exact test
        # and is nearer, or the reference's winner fails the exact test
        k = np.nonzero(diff)[0]
        port_ok = np.isfinite(_exact_t(ts, o[k], d[k], ti.numpy()[k])) & (
            tt.numpy()[k] < jt[k])
        ref_bad = np.isinf(_exact_t(ts, o[k], d[k], ji[k])) & (ji[k] >= 3)
        assert (port_ok | ref_bad).all(), k[~(port_ok | ref_bad)]
        assert diff.mean() <= 0.01
    hit = (ji >= 0) & ~diff
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=5e-4, atol=1e-2)
    np.testing.assert_allclose(tn.numpy()[hit], jn[hit], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tf.numpy()[hit], jf[hit])
    np.testing.assert_array_equal(tm.numpy()[hit], jm[hit])
    np.testing.assert_array_equal(np.isinf(tt.numpy()[~diff]), ji[~diff] < 0)
    assert float(tp) == float(jp)
    return hit


@pytest.mark.parametrize("n", [64, 700, 2048])
def test_closest_hit_matches_reference_with_masks(scenes, n):
    js, ts = scenes
    o, d = _rays(n, n)
    active, occ = _masks(n, n)
    j_out = jmm.closest_hit_mm_full(js, jnp.asarray(o), jnp.asarray(d),
                                    active=jnp.asarray(active),
                                    occ_t=jnp.asarray(occ))
    t_out = tmm.closest_hit_mm_full(ts, torch.as_tensor(o), torch.as_tensor(d),
                                    active=torch.as_tensor(active),
                                    occ_t=torch.as_tensor(occ))
    hit = _compare_hits(t_out, j_out, ts, o, d)
    tri = hit & (np.asarray(j_out[1]) >= 3)  # prims 0-2 are the spheres
    assert tri.sum() > 0 and float(t_out[5]) > 0


@pytest.mark.parametrize("n", [64, 700, 2048])
def test_closest_hit_matches_brute_oracle(scenes, n):
    _, ts = scenes
    o, d = _rays(n, n)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    t0, i0 = closest_hit_bruteforce(ts, o, d)
    t1, i1, *_ = tmm.closest_hit_mm_full(ts, o, d)
    np.testing.assert_array_equal(i1.numpy(), i0.numpy())
    f = np.isfinite(t0.numpy())
    assert f.sum() > n // 10
    np.testing.assert_allclose(t1.numpy()[f], t0.numpy()[f], rtol=5e-4, atol=1e-2)

    # with masks: active lanes agree with the oracle wherever the oracle's
    # hit lies within the lane's occlusion bound (inactive lanes join no
    # tile list; their answer is whatever their subgroup's list gives)
    active, occ = _masks(n, n)
    t2, i2, *_ = tmm.closest_hit_mm_full(ts, o, d, active=torch.as_tensor(active),
                                         occ_t=torch.as_tensor(occ))
    exact = active & (t0.numpy() <= occ)
    assert exact.sum() > n // 10
    np.testing.assert_array_equal(i2.numpy()[exact], i0.numpy()[exact])


def test_giant_sphere_precision():
    # r=10000 ground alone: no triangles, so the exact sphere pass answers
    def build(m):
        s = m.HostScene()
        s.add_sphere((0, -10000, 0), 10000.0, m.Material())
        return s

    dirs = np.array([[0, -1, 0], [0.6, -0.8, 0], [0, -0.7071, 0.7071], [1, 0, 0]],
                    np.float32)
    o = np.array([[0.0, 5.0, 0.0]] * 4, np.float32)
    ts = t_upload(build(tscene), "cpu")
    assert ts.num_tris == 0
    t_out = tmm.closest_hit_mm_full(ts, torch.as_tensor(o), torch.as_tensor(dirs))
    j_out = jmm.closest_hit_mm_full(j_upload(build(jscene)), jnp.asarray(o),
                                    jnp.asarray(dirs))
    _compare_hits(t_out, j_out, ts, o, dirs)
    t = t_out[0].numpy()
    np.testing.assert_allclose(t[0], 5.0, atol=1e-3)
    assert int(t_out[1][3]) == -1
    t0, _ = closest_hit_bruteforce(ts, torch.as_tensor(o), torch.as_tensor(dirs))
    np.testing.assert_allclose(t[:3], t0.numpy()[:3], rtol=1e-6)


def _kernel_args(ts, n, seed):
    o, d = _rays(n, seed)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    occ = torch.full((n,), float("inf"))
    return tmm.kernel_inputs(ts, o, d, occ)


def test_cpu_wrapper_runs_the_twin_and_counts_no_launch(scenes):
    _, ts = scenes
    lists, counts, smin, x, lb = _kernel_args(ts, 300, 5)
    assert x.shape == (384, tmm.NUM_FEATURES)  # padded to a multiple of 128
    before = tmm.mm_closest_hit.launches
    t, col = tmm.mm_closest_hit(lists, counts, smin, x, lb, ts.mm_w, T_MIN)
    assert tmm.mm_closest_hit.launches == before
    t_ref, col_ref = tmm.mm_closest_hit_reference(lists, counts, smin, x, lb,
                                                  ts.mm_w, T_MIN)
    assert torch.equal(t, t_ref) and torch.equal(col, col_ref)
    assert t.dtype == torch.float32 and col.dtype == torch.int32
    assert (col >= 0).sum() > 0 and (col[300:] == -1).all()


def test_wrapper_rejects_bad_inputs(scenes):
    _, ts = scenes
    lists, counts, smin, x, lb = _kernel_args(ts, 128, 6)
    with pytest.raises(ValueError):
        tmm.mm_closest_hit(lists, counts, smin, x.double(), lb, ts.mm_w, T_MIN)
    with pytest.raises(ValueError):
        tmm.mm_closest_hit(lists, counts, smin, x[:64], lb, ts.mm_w, T_MIN)
    meta = [v.to("meta") for v in (lists, counts, smin, x, lb, ts.mm_w)]
    with pytest.raises(ValueError, match="no kernel"):
        tmm.mm_closest_hit(*meta, T_MIN)


# (subgroups, tile_p): the scan's 921,600 lanes, the viewer's scan, the
# wavefront pool (2^15 lanes), the viewer's pool (2^14), a drain (1,024)
SCAN, VIEWER_SCAN, POOL, VIEWER_POOL, DRAIN = 7200, 1152, 256, 128, 8
H100_SMS = 132


@pytest.mark.parametrize("n_groups,tile_p,width", [
    (SCAN, 128, 1), (SCAN, 256, 1), (VIEWER_SCAN, 128, 1), (VIEWER_SCAN, 256, 1),
    (POOL, 128, 4), (POOL, 256, 4), (VIEWER_POOL, 128, 4), (VIEWER_POOL, 256, 8),
    (DRAIN, 128, 4), (DRAIN, 256, 8)])
def test_cluster_width_at_the_paths_shapes(n_groups, tile_p, width):
    # the scan fills the card with one CTA a subgroup; the wavefront's pool
    # and drain share each walk over a cluster, as wide as the tile allows
    # while the call's CTAs stay within CLUSTER_CTAS_PER_SM an SM
    assert tmm.cluster_width(n_groups, tile_p, H100_SMS) == width


@pytest.mark.parametrize("sms", [66, 114, 132])
@pytest.mark.parametrize("tile_p", [32, 64, 128, 256, 512])
def test_cluster_width_keeps_whole_slices(tile_p, sms):
    # every width is a power of two up to MAX_CLUSTER that leaves each CTA
    # whole CLUSTER_SLICE_COLS columns (its warps' slices keep their unroll),
    # never grows with the subgroup count, and clusters only a call whose
    # CTAs fit the rule's share of the card
    widths = [tmm.cluster_width(g, tile_p, sms) for g in range(1, 20000, 7)]
    for g, c in zip(range(1, 20000, 7), widths):
        assert c in (1, 2, 4, 8) and c <= tmm.MAX_CLUSTER
        assert tile_p % (c * tmm.CLUSTER_SLICE_COLS) == 0
        assert c == 1 or g * c <= tmm.CLUSTER_CTAS_PER_SM * sms
    assert widths == sorted(widths, reverse=True)
    assert widths[0] == min(tmm.MAX_CLUSTER, tile_p // tmm.CLUSTER_SLICE_COLS)
    assert widths[-1] == 1


def test_cpu_wrapper_counts_no_clustered_launch(scenes):
    # a CPU tensor never launches and never asks the card for its width
    _, ts = scenes
    lists, counts, smin, x, lb = _kernel_args(ts, 512, 8)
    before = tmm.mm_closest_hit.launches, tmm.mm_closest_hit.clustered
    got = tmm.mm_closest_hit(lists, counts, smin, x, lb, ts.mm_w, T_MIN,
                             return_walked=True)
    assert (tmm.mm_closest_hit.launches, tmm.mm_closest_hit.clustered) == before
    ref = tmm.mm_closest_hit_reference(lists, counts, smin, x, lb, ts.mm_w, T_MIN,
                                       return_walked=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("cluster", [0, 3, 8, 16, -2])
def test_launch_rejects_bad_cluster_widths(scenes, cluster):
    # tile_p 128 splits into 1, 2 or 4 slices of 32 columns; nothing else
    # reaches the card
    _, ts = scenes
    assert ts.mm_w.shape[1] == 128
    lists, counts, smin, x, lb = _kernel_args(ts, 128, 6)
    before = tmm.mm_closest_hit.launches
    with pytest.raises(ValueError, match="cluster"):
        tmm._launch(lists, counts, smin, x, lb, ts.mm_w, T_MIN, False, cluster)
    assert tmm.mm_closest_hit.launches == before


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_early_exit_equals_full_scan(scenes, seed):
    # the best-t early exit may only skip tiles that cannot change any
    # lane's answer: walking every passing tile gives the same result
    _, ts = scenes
    lists, counts, smin, x, lb = _kernel_args(ts, 1024, 40 + seed)
    t, col = tmm.mm_closest_hit_reference(lists, counts, smin, x, lb, ts.mm_w,
                                          T_MIN)
    no_exit = torch.full_like(lb, float("inf"))
    t_all, col_all = tmm.mm_closest_hit_reference(lists, counts, smin, x, no_exit,
                                                  ts.mm_w, T_MIN)
    assert torch.equal(col, col_all)
    assert torch.equal(t, t_all)
    assert (col >= 0).sum() > 100


def test_sphere_tie_picks_the_lowest_slot():
    # two identical spheres: the exact sphere pass reports the first
    def build(m):
        s = m.HostScene()
        s.add_sphere((0, 0, -5), 1.0, m.Material(albedo=(0.1, 0.2, 0.3)))
        s.add_sphere((0, 0, -5), 1.0, m.Material(albedo=(0.9, 0.8, 0.7)))
        return s

    o = np.zeros((3, 3), np.float32)
    d = np.array([[0, 0, -1], [0.1, 0, -1], [0, 1, 0]], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_out = tmm.closest_hit_mm_full(t_upload(build(tscene), "cpu"), torch.as_tensor(o),
                                    torch.as_tensor(d))
    j_out = jmm.closest_hit_mm_full(j_upload(build(jscene)), jnp.asarray(o),
                                    jnp.asarray(d))
    np.testing.assert_array_equal(t_out[1].numpy(), [0, 0, -1])
    np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
    np.testing.assert_array_equal(t_out[4].numpy()[:2], np.asarray(j_out[4])[:2])


def _dense_slab(ts) -> torch.Tensor:
    """The dense (n_tiles, tile_p, 4, 12) weights of the scene's triangles
    in column order, from the formula (the layout the slab had before it
    was compacted)."""
    tri_ids = ts.mm_tri_ids.numpy()
    real = tri_ids[tri_ids >= 0]
    v0, v1, v2 = (ts.p0.numpy()[real], ts.p1.numpy()[real], ts.p2.numpy()[real])
    e1, e2 = v1 - v0, v2 - v0
    n = np.cross(e1, e2)
    t = len(real)
    z1, z3 = np.zeros((t, 1), np.float32), np.zeros((t, 3), np.float32)
    w = np.zeros((len(tri_ids), 4, tmm.NUM_FEATURES), np.float32)
    w[:t] = np.stack([
        np.concatenate([-n, z3, z3, z1, z1, z1], axis=1),
        np.concatenate([-np.cross(e2, v0), e2, z3, z1, z1, z1], axis=1),
        np.concatenate([-np.cross(v0, e1), -e1, z3, z1, z1, z1], axis=1),
        np.concatenate([z3, z3, n, z1, z1, -np.sum(v0 * n, 1, keepdims=True)], axis=1),
    ], axis=1)
    return torch.as_tensor(w.reshape(-1, ts.mm_w.shape[1], 4, tmm.NUM_FEATURES))


def _tile_hits(x, wd, t_min):
    """Per lane of x (128, 12), the closest accepted (t, column) in one dense
    tile wd (tile_p, 4, 12): the twin's arithmetic on one subgroup and tile."""
    tile_p = wd.shape[0]
    det = torch.bmm(x[None], wd.view(1, tile_p * 4, tmm.NUM_FEATURES).transpose(1, 2))
    sa, su, sv, st = det.view(tmm.LANES, tile_p, 4).unbind(dim=-1)
    s = torch.where(sa < 0.0, -1.0, 1.0)
    sas, sus, svs, sts = sa * s, su * s, sv * s, st * s
    ok = ((sas > tmm.TRI_PARALLEL_EPS) & (sus >= 0.0) & (svs >= 0.0)
          & (sus + svs <= sas) & (sts > t_min * sas))
    return torch.min(torch.where(ok, sts / sas, float("inf")), dim=1)


def _plain_walk(lists, counts, smin, x, lb, wd, t_min):
    """The contract written out one subgroup and one list position at a
    time on the dense weights: (t, col, walked)."""
    g = lists.shape[0]
    tile_p = wd.shape[1]
    t_out = torch.full((g, tmm.LANES), float("inf"))
    c_out = torch.full((g, tmm.LANES), -1, dtype=torch.int32)
    walked = []
    for k in range(g):
        rays = slice(k * tmm.LANES, (k + 1) * tmm.LANES)
        best, bcol, n = t_out[k], c_out[k], 0
        for j in range(int(counts[k])):
            thr = float(torch.minimum(best, lb[rays]).max())
            if not float(smin[k, j]) <= thr:
                break
            n += 1
            tile = int(lists[k, j])
            t, c = _tile_hits(x[rays], wd[tile], t_min)
            better = t < best
            best = torch.where(better, t, best)
            bcol = torch.where(better, (tile * tile_p + c).to(torch.int32), bcol)
        t_out[k], c_out[k] = best, bcol
        walked.append(n)
    return t_out.view(-1), c_out.view(-1), torch.tensor(walked, dtype=torch.int32)


@pytest.mark.parametrize("n", [128, 2048])
def test_twin_walk_equals_a_plain_walk(scenes, n):
    # the twin on the compact slab against the contract on the dense slab:
    # the same walked positions and the same (t, col), bit for bit
    _, ts = scenes
    lists, counts, smin, x, lb = _kernel_args(ts, n, 60 + n)
    t, col, walked = tmm.mm_closest_hit_reference(lists, counts, smin, x, lb,
                                                  ts.mm_w, T_MIN, return_walked=True)
    t_p, col_p, walked_p = _plain_walk(lists, counts, smin, x, lb, _dense_slab(ts),
                                       T_MIN)
    assert walked.dtype == torch.int32 and walked.shape == (n // 128,)
    assert torch.equal(walked, walked_p)
    assert torch.equal(t, t_p) and torch.equal(col, col_p)
    assert (walked <= counts).all() and int(walked.sum()) > 0
    # the wrapper on CPU tensors returns the twin's count
    assert torch.equal(tmm.mm_closest_hit(lists, counts, smin, x, lb, ts.mm_w, T_MIN,
                                          return_walked=True)[2], walked)


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_on_compact_slab_equals_dense_evaluation(scenes, seed):
    # the twin gathers compact tiles and expands them; evaluating the dense
    # slab directly, with the twin's walk as it was before the compact
    # layout, must give the same (t, col) bit for bit
    _, ts = scenes
    lists, counts, smin, x, lb = _kernel_args(ts, 2048, 80 + seed)
    t, col = tmm.mm_closest_hit_reference(lists, counts, smin, x, lb, ts.mm_w, T_MIN)

    wd = _dense_slab(ts)
    g, nt = lists.shape
    tile_p = wd.shape[1]
    wf = wd.view(nt, tile_p * 4, tmm.NUM_FEATURES)
    xg = x.view(g, tmm.LANES, tmm.NUM_FEATURES)
    lbg = lb.view(g, tmm.LANES)
    best_t = torch.full((g, tmm.LANES), float("inf"))
    best_c = torch.full((g, tmm.LANES), -1, dtype=torch.int32)
    thr = lbg.amax(dim=1)
    live = torch.arange(g)
    for j in range(nt):
        live = live[(j < counts[live]) & (smin[live, j] <= thr[live])]
        if live.numel() == 0:
            break
        tiles = lists[live, j].long()
        det = torch.bmm(xg[live], wf[tiles].transpose(1, 2))
        sa, su, sv, st = det.view(-1, tmm.LANES, tile_p, 4).unbind(dim=-1)
        s = torch.where(sa < 0.0, -1.0, 1.0)
        sas, sus, svs, sts = sa * s, su * s, sv * s, st * s
        ok = ((sas > tmm.TRI_PARALLEL_EPS) & (sus >= 0.0) & (svs >= 0.0)
              & (sus + svs <= sas) & (sts > T_MIN * sas))
        t_tile, c_tile = torch.min(torch.where(ok, sts / sas, float("inf")), dim=2)
        better = t_tile < best_t[live]
        best_t[live] = torch.where(better, t_tile, best_t[live])
        best_c[live] = torch.where(better, (tiles[:, None] * tile_p + c_tile).int(),
                                   best_c[live])
        thr[live] = torch.minimum(best_t[live], lbg[live]).amax(dim=1)
    assert torch.equal(t, best_t.view(-1)) and torch.equal(col, best_c.view(-1))
    assert (col >= 0).sum() > 100
