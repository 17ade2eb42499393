"""The port's checkpoints (`io/checkpoint.py`, `io/png.read_png`) and the
CLI's `--checkpoint` / `--resume` branch, against the JAX package, on the
CPU.

Tolerances:
- a round trip, and a checkpoint carried between the two packages: the
  npz holds the same keys and dtypes on both sides, and the arrays come
  back bit for bit (`torch.equal`, `assert_array_equal`);
- a resumed render vs the same checkpointed render without interruption,
  with the same `--checkpoint-every`: the same passes are added in the
  same order, so the images are bit-equal (`torch.equal` on the npz
  radiance), also when the first half was rendered by the JAX package and
  when it is resumed from a checkpoint the JAX package wrote from the
  port's own sums;
- a checkpointed render vs the default branch (one pass of all samples):
  another addition order: rtol 1e-5, atol 1e-6, not bit-equal;
- the port's first half vs the JAX package's first half: the render bound
  of tests/test_torch_render.py (under 2% of pixels differ by > 1e-3,
  means within 5e-3).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalpathtracer_torch import cli as tcli
from metalpathtracer_torch.core import rng as trng
from metalpathtracer_torch.io import checkpoint as tck
from metalpathtracer_torch.io import png as tpng
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render import pipeline as tpipe
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.scene import load_scene_xml
from metalpathtracer_tpu import cli as jcli
from metalpathtracer_tpu import io as jio
from metalpathtracer_tpu.render import pipeline as jpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
torch.set_num_threads(1)

W = H = 16
VIEW = ["--camera-pos", "0,2.5,9", "--camera-target", "0,2.5,0", "--fov", "40"]


def _state(seed=0, spp=7):
    r = np.random.default_rng(seed)
    return tpipe.AccumState(
        torch.as_tensor(r.uniform(0, 5, (H, W, 3)).astype(np.float32)), spp)


def _argv(out, scene=CORNELL, view=VIEW, size=W, depth="4"):
    return ["--scene", scene, "--width", str(size), "--height", str(size),
            "--max-depth", depth, "--output", str(out)] + view


def _radiance(path):
    with np.load(path) as z:
        return torch.as_tensor(z["radiance"])


def test_round_trip(tmp_path):
    path = str(tmp_path / "ck.npz")
    st = _state()
    tck.save_checkpoint(path, st, 123, meta={"size": "16x16", "cfg": "c"})
    back, seed, meta = tck.load_checkpoint(path, "cpu")
    assert torch.equal(back.rgb_sum, st.rgb_sum) and back.rgb_sum.dtype == torch.float32
    assert back.spp == 7 and isinstance(back.spp, int) and seed == 123
    assert {k: str(v) for k, v in meta.items()} == {"size": "16x16", "cfg": "c"}
    assert not os.path.exists(path + ".tmp.npz")  # written, then moved in place


def test_npz_has_the_reference_keys_and_dtypes(tmp_path):
    mine, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    st = _state()
    meta = {"scene_sha": "ab12", "size": "16x16"}
    tck.save_checkpoint(mine, st, -5, meta=meta)
    jio.save_checkpoint(
        theirs, jpipe.AccumState(jnp.asarray(st.rgb_sum.numpy()),
                                 jnp.asarray(st.spp, jnp.int32)), -5, meta=meta)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["spp"].dtype == np.int32 and a["spp"].shape == ()
        assert a["seed"].dtype == np.uint32 and int(a["seed"]) == 2**32 - 5
    assert tck.FORMAT_VERSION == jio.checkpoint.FORMAT_VERSION == 1


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "ck.npz")
    st = _state(1, spp=3)
    tck.save_checkpoint(path, st, 2**40 + 9, meta={"size": "16x16"})
    js, seed, meta = jio.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(js.rgb_sum), st.rgb_sum.numpy())
    assert int(js.spp) == 3 and js.spp.dtype == jnp.int32
    assert seed == 9 and str(meta["size"]) == "16x16"


def test_newer_format_version_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, _state(), 0)
    with np.load(path) as z:
        payload = dict(z)
    payload["format_version"] = np.asarray(tck.FORMAT_VERSION + 1)
    np.savez_compressed(path, **payload)
    with pytest.raises(ValueError, match="newer format"):
        tck.load_checkpoint(path, "cpu")


def test_read_png_reads_what_write_png_wrote(tmp_path):
    from metalpathtracer_tpu.io.png import read_png as j_read_png

    path = str(tmp_path / "x.png")
    img = np.random.default_rng(0).uniform(0, 1.2, (5, 7, 3)).astype(np.float32)
    tpng.write_png(path, img)
    back = tpng.read_png(path)
    assert back.shape == (5, 7, 3) and back.dtype == np.uint8
    np.testing.assert_array_equal(back, j_read_png(path))
    want = (tpng.linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(back, want)
    with open(path, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError):
        tpng.read_png(path)


@pytest.mark.parametrize("seed", [0, -7, 2**40 + 3])
def test_cli_resume_equals_the_uninterrupted_run(tmp_path, capsys, seed):
    ck, ck2 = str(tmp_path / "ck.npz"), str(tmp_path / "ck2.npz")
    a, b, c = (str(tmp_path / f"{n}.npz") for n in "abc")
    common = ["--device", "cpu", "--seed", str(seed), "--checkpoint-every", "2"]
    run = _argv(tmp_path / "o.png") + common + ["--checkpoint", ck]
    assert tcli.main(run + ["--spp", "2"]) == 0
    assert tck.load_checkpoint(ck, "cpu")[0].spp == 2
    assert tcli.main(run + ["--spp", "4", "--resume", "--npz", a]) == 0
    assert "resumed at 2 spp" in capsys.readouterr().err
    state, ck_seed, meta = tck.load_checkpoint(ck, "cpu")
    assert state.spp == 4 and ck_seed == seed & 0xFFFFFFFF
    assert set(meta) == {"scene_sha", "size", "camera", "cfg"}
    # without interruption, same chunks: bit-equal
    assert tcli.main(_argv(tmp_path / "o2.png") + common
                     + ["--checkpoint", ck2, "--spp", "4", "--npz", b]) == 0
    assert torch.equal(_radiance(a), _radiance(b))
    assert torch.equal(_radiance(a), tpipe.to_image(state, clamp=False))
    np.testing.assert_array_equal(tpng.read_png(str(tmp_path / "o.png")),
                                  tpng.read_png(str(tmp_path / "o2.png")))
    # the default branch adds all four samples in one pass: close, and the
    # same seed word (negative and 64-bit seeds wrap alike)
    assert tcli.main(_argv(tmp_path / "o3.png") + ["--device", "cpu", "--seed",
                                                   str(seed), "--spp", "4",
                                                   "--npz", c]) == 0
    torch.testing.assert_close(_radiance(c), _radiance(a), rtol=1e-5, atol=1e-6)
    # and the checkpoint's seed wins over a resume's --seed
    assert tcli.main(run + ["--spp", "6", "--resume", "--seed", "99",
                            "--npz", a]) == 0
    assert tck.load_checkpoint(ck, "cpu")[1] == seed & 0xFFFFFFFF
    assert tcli.main(_argv(tmp_path / "o2.png") + common
                     + ["--checkpoint", ck2, "--spp", "6", "--resume",
                        "--npz", b]) == 0
    assert torch.equal(_radiance(a), _radiance(b))


def test_reference_checkpoint_resumes_in_the_port(tmp_path, capsys):
    # the JAX package writes the first two samples; the port carries on. Its
    # image equals the port's own uninterrupted render when it resumes from
    # the same sums, and is within the render bound of it otherwise.
    ck = str(tmp_path / "j.npz")
    base = _argv(tmp_path / "j.png") + ["--checkpoint", ck, "--checkpoint-every", "2"]
    assert jcli.main(base + ["--spp", "2"]) == 0
    j_state, _, j_meta = jio.load_checkpoint(ck)
    assert int(j_state.spp) == 2
    # both packages fingerprint a run alike, the config's repr included
    own = str(tmp_path / "own.npz")
    port = _argv(tmp_path / "t.png") + ["--device", "cpu", "--checkpoint-every", "2"]
    assert tcli.main(port + ["--checkpoint", own, "--spp", "2"]) == 0
    t_state, _, t_meta = tck.load_checkpoint(own, "cpu")
    for k in ("scene_sha", "size", "camera", "cfg"):
        assert str(j_meta[k]) == str(t_meta[k]), k
    diff = np.abs(np.asarray(j_state.rgb_sum) - t_state.rgb_sum.numpy()) / 2
    assert (diff > 1e-3).mean() < 0.02

    # (1) the JAX package's file resumes in the port and is finished there
    a = str(tmp_path / "a.npz")
    assert tcli.main(port + ["--checkpoint", ck, "--spp", "4", "--resume",
                             "--npz", a]) == 0
    assert "resumed at 2 spp" in capsys.readouterr().err
    full = str(tmp_path / "full.npz")
    assert tcli.main(port + ["--checkpoint", str(tmp_path / "u.npz"), "--spp", "4",
                             "--npz", full]) == 0
    got, want = _radiance(a).numpy(), _radiance(full).numpy()
    assert (np.abs(got - want) > 1e-3).mean() < 0.02
    assert abs(got.mean() - want.mean()) < 5e-3

    # (2) the port's own first half, written by the JAX package's writer:
    # resumed in the port it is the uninterrupted render bit for bit
    via = str(tmp_path / "via.npz")
    jio.save_checkpoint(
        via, jpipe.AccumState(jnp.asarray(t_state.rgb_sum.numpy()),
                              jnp.asarray(2, jnp.int32)), 0,
        meta={k: str(v) for k, v in t_meta.items()})
    b = str(tmp_path / "b.npz")
    assert tcli.main(port + ["--checkpoint", via, "--spp", "4", "--resume",
                             "--npz", b]) == 0
    assert torch.equal(_radiance(b), _radiance(full))


MISMATCH = {
    "scene_sha": dict(scene=os.path.join(REPO, "scenes", "cornell_glass.xml")),
    "size": dict(size=24),
    "camera": dict(view=["--camera-pos", "0,2.5,9", "--camera-target", "0,2.5,0",
                         "--fov", "50"]),
    "cfg": dict(depth="5"),
}


@pytest.mark.parametrize("field", sorted(MISMATCH))
def test_cli_refuses_a_checkpoint_of_another_run(tmp_path, capsys, field):
    ck = str(tmp_path / "ck.npz")
    extra = ["--device", "cpu", "--checkpoint", ck, "--checkpoint-every", "2"]
    assert tcli.main(_argv(tmp_path / "o.png") + extra + ["--spp", "2"]) == 0
    before = open(ck, "rb").read()
    capsys.readouterr()
    rc = tcli.main(_argv(tmp_path / "o2.png", **MISMATCH[field]) + extra
                   + ["--spp", "4", "--resume"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "refusing to blend" in err and f"  {field}: checkpoint=" in err
    others = [k for k in MISMATCH if k != field]
    assert not any(f"  {k}: checkpoint=" in err for k in others)
    assert open(ck, "rb").read() == before  # left as it was
    assert not os.path.exists(str(tmp_path / "o2.png"))


def test_cli_warns_on_a_checkpoint_without_fingerprint(tmp_path, capsys):
    ck = str(tmp_path / "old.npz")
    scene = t_upload(load_scene_xml(CORNELL), "cpu")
    cam = tcam.Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
    st = tpipe.accumulate(tpipe.init_accum(W, H, "cpu"), scene, cam, W, H, 2,
                          trng.seed_from_int(0), tint.RenderConfig(max_depth=4))
    tck.save_checkpoint(ck, st, 0)  # no meta: the old format
    a = str(tmp_path / "a.npz")
    rc = tcli.main(_argv(tmp_path / "o.png") + [
        "--device", "cpu", "--checkpoint", ck, "--checkpoint-every", "2",
        "--spp", "4", "--resume", "--npz", a])
    assert rc == 0
    assert "warning: checkpoint has no fingerprint" in capsys.readouterr().err
    # it went on from the file's sums, and wrote the fingerprint this time
    assert set(tck.load_checkpoint(ck, "cpu")[2]) == {"scene_sha", "size",
                                                      "camera", "cfg"}
    want = tpipe.accumulate(st, scene, cam, W, H, 2, trng.seed_from_int(0),
                            tint.RenderConfig(max_depth=4))
    assert torch.equal(_radiance(a), tpipe.to_image(want, clamp=False))


def test_cli_checkpoint_without_resume_starts_over(tmp_path):
    ck = str(tmp_path / "ck.npz")
    run = _argv(tmp_path / "o.png") + ["--device", "cpu", "--checkpoint", ck,
                                       "--checkpoint-every", "1"]
    assert tcli.main(run + ["--spp", "2"]) == 0
    assert tcli.main(run + ["--spp", "1"]) == 0  # no --resume: from 0 spp
    assert tck.load_checkpoint(ck, "cpu")[0].spp == 1
    # --resume with the target already reached renders nothing more
    assert tcli.main(run + ["--spp", "1", "--resume"]) == 0
    assert tck.load_checkpoint(ck, "cpu")[0].spp == 1
