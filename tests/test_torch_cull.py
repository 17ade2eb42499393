"""The port's tile cull (`cull_tiles`, its plain twin `cull_pass_reference`,
and `_cull_tile_lists` with its twin `cull_tile_lists_reference`) against
the JAX reference's `_cull_pass` and `_cull_tile_lists`, on the CPU.

On a CPU tensor `cull_tiles` runs the twin, which computes in the reference
cull kernel's arithmetic (reciprocals clipped to +-1e30, inactive lanes'
bound folded to -inf). Tolerances:
- against the reference's Pallas `_cull_kernel` (interpret mode, which the
  reference routes to at >= 512 tiles): bit-equal on any rays;
- against the reference's XLA branch (< 512 tiles, unclipped reciprocals
  with a NaN guard): bit-equal on generic rays, which have no zero
  direction component;
- against the port's own unclipped `_cull_hit_mask` on edge cases: equal,
  except at flat boxes (lo == hi on one axis). A ray lying in such a box's
  plane enters it in the unclipped form (0 * inf = NaN, guarded as "no
  constraint") and not in the clipped one (0 * 1e30 = 0 pins the slab to
  one point); a ray in a triangle's plane cannot hit it, so both are
  sound. A ray crossing the plane enters it only in the port's cull,
  which tests exit >= entry where the reference tests exit > entry: the
  reference never enters a flat box, so the triangles of an axis-aligned
  planar tile are invisible to it (test_flat_tile_is_hit).
The CUDA kernel is held to the twin bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.render.kernels import intersect_mm as tmm
from metalpathtracer_tpu.render import upload_scene as j_upload
from metalpathtracer_tpu.render.pallas import intersect_mm as jmm
from metalpathtracer_torch import scene as tscene
from metalpathtracer_tpu import scene as jscene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MIN = 1e-4
INF = np.inf
torch.set_num_threads(1)


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = (r.uniform(-30, 30, (n, 3)) + [0.0, 20.0, 40.0]).astype(np.float32)
    d = r.standard_normal((n, 3))
    target = np.asarray([-25.0, 5.0, 0.0]) + r.uniform(-20.0, 20.0, (n, 3))
    d[1::2] = (target - o)[1::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _masks(n, seed):
    r = np.random.default_rng(seed + 1000)
    active = (r.uniform(size=n) > 0.25).astype(np.float32)  # 75% live
    occ = np.where(r.uniform(size=n) > 0.5, r.uniform(1.0, 200.0, n),
                   INF).astype(np.float32)
    return active, occ


def _random_boxes(nt, seed):
    """`nt` AABBs of sizes 0.5-8 scattered where the rays go."""
    r = np.random.default_rng(seed)
    lo = r.uniform(-40, 20, (nt, 3)).astype(np.float32)
    hi = lo + r.uniform(0.5, 8.0, (nt, 3)).astype(np.float32)
    box = np.zeros((nt, 8), np.float32)
    box[:, 0:3] = lo
    box[:, 4:7] = hi
    return box


def _both(o, d, active, occ, tile_box):
    """(JAX _cull_pass outputs, port cull_tiles outputs) as numpy."""
    jx = jmm.ray_features(jnp.asarray(o), jnp.asarray(d))
    j = jmm._cull_pass(jx, jnp.asarray(active), jnp.asarray(tile_box), T_MIN,
                       jnp.asarray(occ), interpret=True)
    tx = tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    t = tmm.cull_tiles(tx, torch.as_tensor(active), torch.as_tensor(tile_box),
                       T_MIN, torch.as_tensor(occ))
    return [np.asarray(v) for v in j], [v.numpy() for v in t]


def _assert_equal(j, t):
    for name, jv, tv in zip(("sgm", "gent", "lane_bound"), j, t):
        assert tv.dtype == jv.dtype, name
        np.testing.assert_array_equal(tv, jv, err_msg=name)


def test_twin_matches_reference_cull_kernel():
    # 600 tiles >= CULL_KERNEL_MIN_TILES: the reference runs its Pallas
    # _cull_kernel (interpret mode on the CPU)
    n, nt = 2048, 600
    assert nt >= jmm.CULL_KERNEL_MIN_TILES
    o, d = _rays(n, 1)
    active, occ = _masks(n, 1)
    j, t = _both(o, d, active, occ, _random_boxes(nt, 2))
    _assert_equal(j, t)
    sgm, _, lb = t
    assert t[0].shape == (n // 128, nt) and t[2].shape == (n,)
    assert 0.05 < sgm.mean() < 0.95  # a real mix of passing and culled tiles
    assert np.isfinite(lb).mean() > 0.3
    assert (lb[active == 0] == -INF).all()


def test_twin_matches_reference_xla_branch_on_the_reference_scene():
    path = os.path.join(REPO, "scenes", "reference.xml")
    tile_box = j_upload(jscene.load_scene_xml(path)).mm_tile_box
    assert tile_box.shape[0] == 39 < jmm.CULL_KERNEL_MIN_TILES  # XLA branch
    np.testing.assert_array_equal(
        np.asarray(tile_box),
        t_upload(tscene.load_scene_xml(path), "cpu").mm_tile_box.numpy())
    n = 2048
    o, d = _rays(n, 3)
    active, occ = _masks(n, 3)
    j, t = _both(o, d, active, occ, np.array(tile_box))
    _assert_equal(j, t)
    assert t[0].any() and not t[0].all()


def _eager_cull(o, d, active, occ, tile_box):
    """Per-(tile, lane) hit and entry of the port's unclipped slab test,
    with the occlusion bound applied as the reference's XLA branch does."""
    hit, en = tmm._cull_hit_mask(torch.as_tensor(o), torch.as_tensor(d),
                                 torch.as_tensor(active), torch.as_tensor(tile_box),
                                 T_MIN)
    hit, en = hit.numpy(), en.numpy()
    return hit & (en <= occ[None, :]), en


def _clipped_cull(o, d, active, occ, tile_box):
    """Per-(tile, lane) hit and entry of the clipped twin: one tile at a
    time, read off the lane bound (-inf = the lane does not enter)."""
    x = tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    hits, ens = [], []
    for j in range(tile_box.shape[0]):
        _, _, lb = tmm.cull_pass_reference(x, torch.as_tensor(active),
                                           torch.as_tensor(tile_box[j:j + 1]),
                                           T_MIN, torch.as_tensor(occ))
        hits.append(lb.numpy() > -INF)
        ens.append(lb.numpy())
    return np.stack(hits), np.stack(ens)


def test_edge_cases_against_the_unclipped_cull():
    # boxes: a unit cube, a flat square in z = 2 (an axis-aligned planar
    # mesh's tile), and an empty box (lo = +inf, hi = -inf)
    box = np.zeros((3, 8), np.float32)
    box[0, 0:3], box[0, 4:7] = [0, 0, 0], [1, 1, 1]
    box[1, 0:3], box[1, 4:7] = [0, 0, 2], [1, 1, 2]
    box[2, 0:3], box[2, 4:7] = INF, -INF
    n = 128
    o = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    rays = [
        ((0.5, 0.5, -3), (0, 0, 1)),    # d.x = d.y = 0, through both boxes
        ((0.5, -3, 0.5), (0, 1, 0)),    # d.x = d.z = 0, through the cube
        ((2.0, 0.5, 0.5), (0, 1, 0)),   # d.x = 0, origin outside the x slab
        ((0.0, 0.5, -3), (0, 0, 1)),    # d.x = 0, origin on the x = 0 face
        ((-3, 0.5, 2.0), (1, 0, 0)),    # d.z = 0, in the flat box's plane
        ((0.5, -3, 2.0), (0, 1, 0)),    # the same along y
        ((-3, 0.5, 2.5), (1, 0, 0)),    # d.z = 0, above the flat box
        ((-3, -3, -3), (0.577, 0.577, 0.577)),  # generic, through the cube
        ((0.5, 0.5, -3), (0, 0, -1)),   # pointing away
        ((0.5, 0.5, 0.5), (0, 0, 1)),   # starting inside the cube
    ]
    for i, (oo, dd) in enumerate(rays):
        o[i], d[i] = oo, dd
    in_plane = {4, 5}
    active = np.zeros(n, np.float32)
    active[:len(rays)] = 1.0
    active[7] = 0.0  # an inactive lane through the cube
    occ = np.full(n, INF, np.float32)
    occ[9] = 1e-5  # bounded below t_min: enters nothing
    # lanes len(rays).. are zero-padded rays (o = d = 0), inactive

    hit_e, en_e = _eager_cull(o, d, active, occ, box)
    hit_c, en_c = _clipped_cull(o, d, active, occ, box)

    # the two forms differ only at the flat box: the port enters it where a
    # ray crosses its plane (exit == entry; the reference's strict exit >
    # entry never does), and the clipped form does not enter it along its
    # plane (in_plane)
    only_c = {(int(t), int(r)) for t, r in zip(*np.nonzero(hit_c & ~hit_e))}
    only_e = {(int(t), int(r)) for t, r in zip(*np.nonzero(hit_e & ~hit_c))}
    assert only_c == {(1, 0), (1, 3)}
    assert only_e == {(1, r) for r in in_plane}
    assert en_c[1, 0] == en_c[1, 3] == np.float32(5.0)
    # where both enter, they enter at the same distance
    both = hit_e & hit_c
    np.testing.assert_array_equal(en_c[both], en_e[both])

    assert hit_c[0, [0, 1, 3, 8, 9]].tolist() == [True, True, True, False, False]
    assert not hit_c[1, [1, 2, 6, 8]].any()
    assert en_c[0, 0] == np.float32(3.0)
    # inactive and zero-padded lanes enter nothing
    assert not hit_c[:, 7].any() and not hit_c[:, len(rays):].any()
    # an empty box bounds nothing on any axis (inf - o and -inf - o span
    # the whole line), so every live lane enters it at t_min in both forms,
    # as in the reference (whose coarse-box padding counts on the opposite)
    live = (active > 0.5) & (occ >= T_MIN)
    assert (hit_c[2] == live).all() and (hit_e[2] == live).all()
    assert (en_c[2][live] == np.float32(T_MIN)).all()

    # the subgroup outputs of the clipped twin are the reductions of its
    # per-lane answers
    sgm, gent, lb = tmm.cull_pass_reference(
        tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d)),
        torch.as_tensor(active), torch.as_tensor(box), T_MIN,
        torch.as_tensor(occ))
    np.testing.assert_array_equal(sgm.numpy()[0], hit_c.any(axis=1))
    np.testing.assert_array_equal(gent.numpy()[0],
                                  np.where(hit_c, en_c, INF).min(axis=1))
    np.testing.assert_array_equal(lb.numpy(),
                                  np.where(hit_c, en_c, -INF).max(axis=0))


def test_tile_lists_equal_on_either_cull():
    # the lists, counts, smin and lane bound of the reference (Pallas cull
    # at 600 tiles) and of the port are equal
    n, nt = 1024, 600
    o, d = _rays(n, 5)
    active, occ = _masks(n, 5)
    box = _random_boxes(nt, 6)
    jx = jmm.ray_features(jnp.asarray(o), jnp.asarray(d))
    jout = jmm._cull_tile_lists(jx, jnp.asarray(active), jnp.asarray(box), T_MIN,
                                jnp.asarray(occ), block_r=128, interpret=True)
    tx = tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    tout = tmm._cull_tile_lists(tx, torch.as_tensor(active), torch.as_tensor(box),
                                T_MIN, torch.as_tensor(occ))
    for name, t, j in zip(("lists", "counts", "smin", "lane_bound"), tout, jout):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert tout[1].numpy().max() > 0


def test_twin_steps_through_rays_in_chunks(monkeypatch):
    # the twin's ray chunking changes nothing
    n, nt = 1024, 50
    o, d = _rays(n, 7)
    active, occ = _masks(n, 7)
    args = (tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d)),
            torch.as_tensor(active), torch.as_tensor(_random_boxes(nt, 8)), T_MIN,
            torch.as_tensor(occ))
    whole = tmm.cull_pass_reference(*args)
    monkeypatch.setattr(tmm, "CULL_TWIN_PAIRS", 3 * 128 * nt)  # 3 subgroups
    parts = tmm.cull_pass_reference(*args)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def _equivariance_case(which, seed):
    """Twin inputs on the reference scene's 39 tile boxes or on 200 random
    boxes: 1,024 rays (8 subgroups), a 75% live mask, mixed occlusion."""
    n = 1024
    if which == "reference":
        path = os.path.join(REPO, "scenes", "reference.xml")
        box = t_upload(tscene.load_scene_xml(path), "cpu").mm_tile_box
    else:
        box = torch.as_tensor(_random_boxes(200, seed))
    o, d = _rays(n, seed)
    active, occ = _masks(n, seed)
    return (tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d)),
            torch.as_tensor(active), box, T_MIN, torch.as_tensor(occ))


@pytest.mark.parametrize("which", ["reference", "random"])
@pytest.mark.parametrize("permute", ["tiles", "lanes"])
def test_twin_is_equivariant_under_permutation(which, permute):
    # the kernel reduces over tiles and lanes in an order of its own
    # (threads, warps, shared atomics): the twin's outputs must not depend
    # on either order. Permuting the tiles permutes the columns of sgm and
    # gent and leaves lane_bound; permuting the lanes inside each subgroup
    # permutes lane_bound and leaves sgm and gent.
    x, active, box, t_min, occ = _equivariance_case(which, 11)
    sgm, gent, lb = tmm.cull_pass_reference(x, active, box, t_min, occ)
    assert sgm.any() and not sgm.all() and (lb > -INF).any()
    r = np.random.default_rng(12)
    if permute == "tiles":
        perm = torch.as_tensor(r.permutation(box.shape[0]))
        sgm_p, gent_p, lb_p = tmm.cull_pass_reference(x, active, box[perm], t_min, occ)
        assert torch.equal(sgm_p, sgm[:, perm]) and torch.equal(gent_p, gent[:, perm])
        assert torch.equal(lb_p, lb)
    else:
        g = x.shape[0] // 128
        idx = torch.as_tensor(np.concatenate(
            [k * 128 + r.permutation(128) for k in range(g)]))
        sgm_p, gent_p, lb_p = tmm.cull_pass_reference(x[idx], active[idx], box,
                                                      t_min, occ[idx])
        assert torch.equal(sgm_p, sgm) and torch.equal(gent_p, gent)
        assert torch.equal(lb_p, lb[idx])


def test_wrapper_counts_no_launch_on_cpu_and_rejects_bad_inputs():
    n = 256
    o, d = _rays(n, 9)
    x = tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    act = torch.ones(n)
    box = torch.as_tensor(_random_boxes(10, 9))
    before = tmm.cull_tiles.launches
    out = tmm.cull_tiles(x, act, box, T_MIN)
    assert tmm.cull_tiles.launches == before
    ref = tmm.cull_pass_reference(x, act, box, T_MIN)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[0].dtype == torch.bool
    with pytest.raises(ValueError, match="multiple of 128"):
        tmm.cull_tiles(x[:200], act[:200], box, T_MIN)
    with pytest.raises(ValueError):
        tmm.cull_tiles(x, act.bool(), box, T_MIN)
    with pytest.raises(ValueError):
        tmm.cull_tiles(x, act, box, T_MIN, occ=torch.ones(n, dtype=torch.float64))
    with pytest.raises(ValueError, match="no kernel"):
        tmm.cull_tiles(x.to("meta"), act.to("meta"), box.to("meta"), T_MIN)


def _composed_lists(x, active, box, t_min, occ):
    """The entry-ordered lists as the port composed them around the plain
    cull before its kernel sorted them: the twin cull, the any flags
    summed, one stable torch.sort, the casts, then the closest hit's
    minimum of the lane bound with occ."""
    sgm, gent, lb = tmm.cull_pass_reference(x, active, box, t_min, occ)
    counts = sgm.sum(dim=1).to(torch.int32)
    smin, lists = torch.sort(gent.contiguous(), dim=1, stable=True)
    if occ is not None:
        lb = torch.minimum(lb, occ)
    return lists.to(torch.int32), counts, smin, lb


def _tile_list_case(case):
    """(o, d, active, occ, box) of 512 rays (4 subgroups) for one case of
    the sorted lists: 40 random boxes unless the case says otherwise."""
    n, seed = 512, 21
    o, d = _rays(n, seed)
    active, occ = _masks(n, seed)
    nt = {"nt_1": 1, "nt_rank_max": tmm.RANK_SORT_MAX_TILES,
          "nt_radix_min": tmm.RANK_SORT_MAX_TILES + 1}.get(case, 40)
    box = _random_boxes(nt, seed)
    if case == "nt_1":
        box[0, 0:3], box[0, 4:7] = [-40.0, -10.0, -20.0], [0.0, 20.0, 20.0]
    elif case == "ties":
        box[20:] = box[:20]  # duplicated boxes: equal entries at two tiles
    elif case == "none_and_all":
        # every box holds the point p; subgroup 0 is dead and enters
        # nothing, subgroup 1 starts at p and enters every tile at t_min
        p = np.asarray([-10.0, 5.0, 10.0], np.float32)
        r = np.random.default_rng(seed)
        box[:, 0:3] = p - r.uniform(0.5, 8.0, (nt, 3))
        box[:, 4:7] = p + r.uniform(0.5, 8.0, (nt, 3))
        active[:128] = 0.0
        active[128:256] = 1.0
        o[128:256] = p
        occ[128:256] = INF
    elif case == "occ_nan":
        occ[::5] = np.nan
    elif case == "occ_-inf":
        occ[:] = -INF
    elif case == "occ_none":
        occ = None
    return o, d, active, occ, box


@pytest.mark.parametrize("case", ["ties", "none_and_all", "occ_nan", "occ_-inf",
                                  "occ_none", "nt_1", "nt_rank_max", "nt_radix_min"])
def test_tile_list_twin_matches_composition_and_reference(case):
    # the lists' twin (what the kernel is held to on the card) against the
    # composition it replaced and against the reference's _cull_tile_lists
    # (its XLA cull below 512 tiles), whose lane bound has no minimum with
    # occ: that is taken here in numpy, which keeps a NaN occ as torch does
    o, d, active, occ, box = _tile_list_case(case)
    tocc = None if occ is None else torch.as_tensor(occ)
    targs = (tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d)),
             torch.as_tensor(active), torch.as_tensor(box), T_MIN, tocc)
    twin = tmm.cull_tile_lists_reference(*targs)
    composed = _composed_lists(*targs)
    assert [t.dtype for t in twin] == [torch.int32, torch.int32, torch.float32,
                                        torch.float32]
    jx = jmm.ray_features(jnp.asarray(o), jnp.asarray(d))
    jout = jmm._cull_tile_lists(jx, jnp.asarray(active), jnp.asarray(box), T_MIN,
                                None if occ is None else jnp.asarray(occ), block_r=128)
    jout = [np.asarray(j) for j in jout]
    if occ is not None:
        jout[3] = np.minimum(jout[3], occ)
    for name, t, c, j in zip(("lists", "counts", "smin", "lane_bound"), twin,
                             composed, jout):
        np.testing.assert_array_equal(t.numpy(), c.numpy(), err_msg=name)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    # a stable sort: tiles of equal entries in ascending order, the entered
    # tiles first
    lists, counts, smin, lb = (t.numpy() for t in twin)
    for g in range(lists.shape[0]):
        same = smin[g, 1:] == smin[g, :-1]
        assert (lists[g, 1:][same] > lists[g, :-1][same]).all()
        assert np.isfinite(smin[g, :counts[g]]).all()
        assert np.isinf(smin[g, counts[g]:]).all()
    if case == "ties":
        assert any((smin[g, 1:] == smin[g, :-1])[:counts[g] - 1].any()
                   for g in range(lists.shape[0]))
    elif case == "none_and_all":
        assert counts[0] == 0 and counts[1] == box.shape[0]
        np.testing.assert_array_equal(lists[1], np.arange(box.shape[0]))
        assert (smin[1] == np.float32(T_MIN)).all()
    elif case == "occ_nan":
        assert np.isnan(lb[::5]).all() and not np.isnan(lb[1::5]).any()
    elif case == "occ_-inf":
        assert (counts == 0).all() and (lb == -INF).all()
    else:
        assert counts.max() > 0


@pytest.mark.parametrize("nt,route", [(1, "rank"), (39, "rank"), (81, "rank"),
                                      (tmm.RANK_SORT_MAX_TILES, "rank"),
                                      (tmm.RANK_SORT_MAX_TILES + 1, "radix"),
                                      (1242, "radix"), (4096, "radix"),
                                      (tmm.RADIX_SORT_MAX_TILES, "radix")])
def test_sort_route_by_row_length(nt, route):
    # the reference scene's 39 tiles and the multimesh's 81 are ranked,
    # bunny300k's 1,242 and a 1M-triangle mesh's 4,096 radix-sorted
    assert tmm.sort_route(nt) == route


def test_tile_lists_wrapper_counts_no_launch_on_cpu_and_rejects_bad_inputs():
    n = 256
    o, d = _rays(n, 9)
    x = tmm.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    act = torch.ones(n)
    box = torch.as_tensor(_random_boxes(10, 9))
    before = tmm._cull_tile_lists.launches, dict(tmm._cull_tile_lists.routes)
    out = tmm._cull_tile_lists(x, act, box, T_MIN)
    assert (tmm._cull_tile_lists.launches, tmm._cull_tile_lists.routes) == before
    ref = tmm.cull_tile_lists_reference(x, act, box, T_MIN)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(ValueError, match="multiple of 128"):
        tmm._cull_tile_lists(x[:200], act[:200], box, T_MIN)
    with pytest.raises(ValueError):
        tmm._cull_tile_lists(x, act.bool(), box, T_MIN)
    with pytest.raises(ValueError):
        tmm._cull_tile_lists(x, act, box, T_MIN, occ=torch.ones(n, dtype=torch.float64))
    with pytest.raises(ValueError, match="no kernel"):
        tmm._cull_tile_lists(x.to("meta"), act.to("meta"), box.to("meta"), T_MIN)
    with pytest.raises(ValueError, match="a block sorts"):
        tmm.sort_route(tmm.RADIX_SORT_MAX_TILES + 1)


def test_flat_tile_is_hit():
    # a unit quad in the plane y = 0: its one tile box is flat. The port
    # finds the brute oracle's hits; the reference's cull (exit > entry)
    # never enters the box, so its tile path misses the quad.
    from metalpathtracer_torch.render.intersect import closest_hit_bruteforce

    def build(m):
        s = m.HostScene()
        s.add_triangle((0, 0, 0), (1, 0, 0), (1, 0, 1), m.Material())
        s.add_triangle((0, 0, 0), (1, 0, 1), (0, 0, 1), m.Material())
        return s

    ts = t_upload(build(tscene), "cpu")
    assert (ts.mm_tile_box[0, 1] == ts.mm_tile_box[0, 5]).item()  # flat in y
    o = np.array([[0.5, 1.0, 0.5], [0.3, -1.0, 0.2], [0.9, 2.0, 0.1]], np.float32)
    d = np.array([[0, -1, 0], [0.1, 1, 0], [-0.2, -1, 0.3]], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_o, i_o = closest_hit_bruteforce(ts, torch.as_tensor(o), torch.as_tensor(d))
    t, i, *_ = tmm.closest_hit_mm_full(ts, torch.as_tensor(o), torch.as_tensor(d))
    assert (i_o.numpy() >= 0).all()
    np.testing.assert_array_equal(i.numpy(), i_o.numpy())
    np.testing.assert_allclose(t.numpy(), t_o.numpy(), rtol=1e-6)
    _, j_i = jmm.closest_hit_mm(j_upload(build(jscene)), jnp.asarray(o), jnp.asarray(d))
    assert (np.asarray(j_i) == -1).all()
