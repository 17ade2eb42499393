"""The port's viewer (`viewer.py`) and camera controls (`render/camera.py`)
against the JAX package, on the CPU.

Tolerances:
- the camera controls are the same host numpy on both sides: every field
  bit-equal after every step of a control sequence;
- the input decoder: the same events as the reference's for every byte
  stream of tests/test_viewer_input.py; on ESC-ESC sequences and alt-chords
  the reference is at fault (stray key events; alt+q quits) and the port
  is held to the right events instead;
- `_srgb_u8` vs `io.png.linear_to_srgb`: torch's and numpy's float32 pow
  may round differently, which moves a value that falls on a rounding
  boundary by one 8-bit step: at most 1 apart, and equal on 99% of values;
- the frames, the loop and the display writer are deterministic: exact counts.
Tests that wait on a pty, a pipe or a thread carry their own time limits.
"""

import io
import os
import select
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from metalpathtracer_torch import viewer as tviewer
from metalpathtracer_torch.io.png import linear_to_srgb
from metalpathtracer_torch.render import camera as tcam
from metalpathtracer_torch.render import integrator as tint
from metalpathtracer_torch.render import pipeline as tpipe
from metalpathtracer_torch.render.device_scene import upload_scene as t_upload
from metalpathtracer_torch.scene import presets
from metalpathtracer_tpu import viewer as jviewer
from metalpathtracer_tpu.render import camera as jcam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# camera controls
# ---------------------------------------------------------------------------

def _fields(c):
    return {f: np.asarray(getattr(c, f), np.float32)
            for f in ("position", "forward", "up", "vfov_deg")}


def _assert_cameras_equal(t, j):
    for name, want in _fields(j).items():
        got = getattr(t, name)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_control_constants_equal_the_reference():
    for name in ("MOVEMENT_SPEED", "ROTATION_SPEED", "ZOOM_SPEED", "FOV_MIN", "FOV_MAX"):
        assert getattr(tcam, name) == getattr(jcam, name), name


def test_move_semantics():
    c = tcam.Camera.reset()
    np.testing.assert_allclose(tcam.move(c, (0, 0, 1)).position.numpy(),
                               [0, 20, 49.9], atol=1e-6)
    np.testing.assert_allclose(tcam.move(c, (1, 0, 0)).position.numpy(),
                               [0.1, 20, 50], atol=1e-6)
    assert tcam.move(c, (0, 0, 0)) is c  # zero input is a no-op
    # movement is horizontal even when pitched
    pitched = tcam.rotate(c, (0.0, 200.0))
    assert abs(float(pitched.forward[1])) > 0.1
    assert float(tcam.move(pitched, (0, 0, 1)).position[1]) == float(c.position[1])


def test_rotate_yaw_and_zoom_clamps():
    c = tcam.Camera.reset()
    fwd = tcam.rotate(c, (100.0, 0.0)).forward.numpy()  # 100 px * 0.002 = 0.2 rad
    np.testing.assert_allclose(np.linalg.norm(fwd), 1.0, atol=1e-6)
    np.testing.assert_allclose(fwd, [np.sin(0.2), 0.0, -np.cos(0.2)], atol=1e-3)
    assert tcam.rotate(c, (0.0, 0.0)) is c and tcam.zoom(c, 0) is c
    assert float(tcam.zoom(c, 1000.0).vfov_deg) == 120.0
    assert float(tcam.zoom(c, -1000.0).vfov_deg) == 30.0
    assert float(tcam.zoom(c, 10.0).vfov_deg) == 61.0


CONTROL_STEPS = [
    ("move", (0, 0, 1)), ("rotate", (100.0, 0.0)), ("move", (1, 0, 0)),
    ("rotate", (-35.5, 212.0)), ("zoom", 10.0), ("move", (0.3, -1.0, 0.7)),
    ("rotate", (0.0, -900.0)), ("zoom", -1000.0), ("move", (0, 1, 0)),
    ("zoom", 1e4), ("rotate", (1e-3, 1e-3)), ("move", (0, 0, -1)),
]


@pytest.mark.parametrize("start", ["reset", "look_at"])
def test_controls_equal_the_reference_step_by_step(start):
    def first(m):
        return (m.Camera.reset() if start == "reset" else
                m.Camera.look_at((3.0, 4.0, 12.0), (0.0, 1.0, 0.0), vfov_deg=45.0))

    t, j = first(tcam), first(jcam)
    for op, arg in CONTROL_STEPS:
        t, j = getattr(tcam, op)(t, arg), getattr(jcam, op)(j, arg)
        _assert_cameras_equal(t, j)
    np.testing.assert_array_equal(
        tcam._quat_rotate(np.float32([1, 2, 3]), np.float32([0, 2, 0]), 0.3),
        jcam._quat_rotate(np.float32([1, 2, 3]), np.float32([0, 2, 0]), 0.3))


def test_apply_inputs_equals_the_reference():
    t, j = tcam.Camera.reset(), jcam.Camera.reset()
    ti, ji = tcam.InputState(), jcam.InputState()
    t2, changed = tcam.apply_inputs(t, ti)
    assert not changed and t2 is t
    frames = [
        dict(zoom=5.0), dict(movement=np.float32([0, 0, 1])),
        dict(rotation=np.float32([40.0, -12.0]), zoom=-3.0),
        dict(movement=np.float32([1, 1, 0]), rotation=np.float32([0, 80.0])),
        dict(reset=True), dict(reset=True, zoom=12.0), dict(),
    ]
    for frame in frames:
        for k, v in frame.items():
            setattr(ti, k, v)
            setattr(ji, k, v)
        t, t_changed = tcam.apply_inputs(t, ti)
        j, j_changed = jcam.apply_inputs(j, ji)
        assert t_changed == j_changed == bool(frame)
        _assert_cameras_equal(t, j)
        for st in (ti, ji):
            st.movement = np.zeros(3, np.float32)
            st.clear()
    assert ti.zoom == 0.0 and not ti.reset and not ti.rotation.any()


# ---------------------------------------------------------------------------
# the input decoder: every byte stream of tests/test_viewer_input.py through
# both decoders, then the two the reference gets wrong
# ---------------------------------------------------------------------------

class _RawStdin:
    """Unbuffered stdin stand-in over a pipe fd, so that `select` keeps
    seeing the unread bytes (a cbreak terminal delivers them one by one)."""

    def __init__(self, fd: int):
        self._fd = fd

    def fileno(self) -> int:
        return self._fd

    def read(self, n: int) -> str:
        return os.read(self._fd, n).decode()


@pytest.fixture
def feed(monkeypatch):
    """Replace sys.stdin with the read end of a pipe; returns a function
    that resets a decoder module's carried state and writes to the pipe."""
    r, w = os.pipe()
    monkeypatch.setattr(sys, "stdin", _RawStdin(r))
    yield lambda s: os.write(w, s.encode())
    os.close(w)
    os.close(r)


# each stream is a list of writes; the events of each write are read back
# before the next is made
STREAMS = {
    "plain_keys": ["wq "],
    "bare_esc": ["\x1b"],
    "esc_then_byte": ["\x1bx"],
    "arrows": ["\x1b[A\x1b[B\x1b[C\x1b[D"],
    "mouse_press_release": ["\x1b[<0;10;5M", "\x1b[<0;11;6m"],
    "drag": ["\x1b[<32;40;12M"],
    "scroll": ["\x1b[<64;1;1M\x1b[<65;1;1M"],
    "sgr_partial": ["\x1b[<32;1", "1;7M"],
    "sgr_malformed": ["\x1b[<32;zz;7Mw"],
    "sgr_overlong": ["\x1b[<" + "9" * 40 + "w"],
    "interleaved": ["a\x1b[<0;2;3Md"],
    "unknown_csi": ["\x1b[Zw"],
}
EXPECTED = {
    "plain_keys": [[("key", "w"), ("key", "q"), ("key", " ")]],
    "bare_esc": [[("key", "esc")]],
    "esc_then_byte": [[("key", "esc"), ("key", "x")]],
    "arrows": [[("key", "up"), ("key", "down"), ("key", "right"), ("key", "left")]],
    "mouse_press_release": [[("mouse", 0, 10, 5, True)], [("mouse", 0, 11, 6, False)]],
    "drag": [[("drag", 40, 12)]],
    "scroll": [[("scroll", -1), ("scroll", 1)]],
    "sgr_partial": [[], [("drag", 11, 7)]],
    "sgr_malformed": [[("key", "w")]],
    "interleaved": [[("key", "a"), ("mouse", 0, 2, 3, True), ("key", "d")]],
    "unknown_csi": [[("key", "w")]],
}


def _decode(module, feed, monkeypatch, writes):
    monkeypatch.setattr(module, "_sgr_partial", None)
    out = []
    for chunk in writes:
        feed(chunk)
        out.append(module._read_events(0.2))
    return out, module._sgr_partial


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_read_events_equals_the_reference(feed, monkeypatch, name):
    mine, partial = _decode(tviewer, feed, monkeypatch, STREAMS[name])
    theirs, j_partial = _decode(jviewer, feed, monkeypatch, STREAMS[name])
    assert mine == theirs and partial == j_partial is None
    if name in EXPECTED:
        assert mine == EXPECTED[name]
    else:  # the overlong payload: dropped, no mouse or drag events
        assert all(e[0] == "key" for evs in mine for e in evs)


def test_sgr_partial_is_carried_between_calls(feed, monkeypatch):
    monkeypatch.setattr(tviewer, "_sgr_partial", None)
    feed("\x1b[<32;1")
    assert tviewer._read_events(0.2) == [] and tviewer._sgr_partial == "32;1"
    feed("1;7M")
    assert tviewer._read_events(0.2) == [("drag", 11, 7)]
    assert tviewer._sgr_partial is None


@pytest.mark.parametrize("stream,events", [
    ("\x1b\x1b", [("key", "esc"), ("key", "esc")]),
    # alt+arrow as xterm sends it: the reference leaks "[" and "A" as keys
    ("\x1b\x1b[A", [("key", "esc"), ("key", "up")]),
    ("\x1b\x1b[<0;2;3Mw", [("key", "esc"), ("mouse", 0, 2, 3, True), ("key", "w")]),
    ("\x1b\x1b\x1bx", [("key", "esc"), ("key", "esc"), ("key", "esc"), ("key", "x")]),
])
def test_esc_esc_starts_a_new_sequence(feed, monkeypatch, stream, events):
    monkeypatch.setattr(tviewer, "_sgr_partial", None)
    feed(stream)
    got = tviewer._read_events(0.2)
    assert got == events
    assert not any(e in got for e in [("key", "["), ("key", "A"), ("key", "<")])


def test_reference_leaks_keys_on_esc_esc(feed, monkeypatch):
    # the fault the port does not carry: pinned so that the difference
    # between the two decoders is a known one
    monkeypatch.setattr(jviewer, "_sgr_partial", None)
    feed("\x1b\x1b[A")
    assert ("key", "[") in jviewer._read_events(0.2)


def test_alt_q_does_not_quit(feed, monkeypatch, scene):
    monkeypatch.setattr(tviewer, "_sgr_partial", None)
    feed("\x1bq")  # what a terminal sends for alt+q
    events = tviewer._read_events(0.2)
    assert events == [("key", "esc"), ("key", "q")]  # decoded as the reference does
    assert tviewer._drop_chords(events) == [("key", "esc")]
    feed("q\x1bwa\x1b[A\x1b")
    events = tviewer._drop_chords(tviewer._read_events(0.2))
    assert events == [("key", "q"), ("key", "esc"), ("key", "a"), ("key", "up"),
                      ("key", "esc")]
    loop = _loop(scene, _FakeDisplay())
    assert loop.step(lambda: [("key", "esc"), ("key", "q")]) is True
    assert loop.step(lambda: [("key", "q")]) is False


# ---------------------------------------------------------------------------
# _DisplayWriter, _srgb_u8, _frame_to_ansi
# ---------------------------------------------------------------------------

class _SlowOut(io.StringIO):
    """stdout stand-in whose writes block until released: a stalled pty."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()

    def write(self, s):
        self.gate.wait(timeout=10.0)
        return super().write(s)


def _frame(v):
    return np.full((4, 4, 3), v, np.uint8)


def test_display_writer_latest_wins(monkeypatch):
    out = _SlowOut()
    monkeypatch.setattr(sys, "stdout", out)
    w = tviewer._DisplayWriter()
    try:
        for v in range(8):
            w.post(_frame(v), f"|status {v}|")
        out.gate.set()
        w.drain(timeout=10.0)
        txt = out.getvalue()
        assert "|status 7|" in txt  # the newest frame always lands
        assert sum(f"|status {v}|" in txt for v in range(8)) < 8  # some dropped
    finally:
        w.stop()


def test_display_writer_posts_texts_and_drains(monkeypatch):
    out = _SlowOut()
    out.gate.set()  # a fast terminal
    monkeypatch.setattr(sys, "stdout", out)
    w = tviewer._DisplayWriter()
    try:
        w.post(_frame(1), "|s1|")
        w.post_text("MSG-A")
        w.post_text("MSG-B")
        w.drain(timeout=10.0)
        txt = out.getvalue()
        assert txt.index("MSG-A") < txt.index("MSG-B") and "|s1|" in txt
    finally:
        w.stop()


def test_display_writer_stop_unblocks_drain(monkeypatch):
    out = _SlowOut()  # the gate stays shut: a wedged terminal
    monkeypatch.setattr(sys, "stdout", out)
    w = tviewer._DisplayWriter()
    w.post(_frame(0), "|s|")
    t0 = time.perf_counter()
    w.stop()  # must not hang on the wedged write
    out.gate.set()
    w.drain(timeout=1.0)
    assert time.perf_counter() - t0 < 10.0


def test_srgb_u8_matches_linear_to_srgb():
    r = np.random.default_rng(0)
    rgb = r.uniform(0.0, 4.0, (36, 64, 3)).astype(np.float32)
    rgb[0, :8] = 0.0
    rgb[1, :8] = 0.002  # the curve's linear segment
    for spp in (0, 1, 3):
        got = tviewer._srgb_u8(tpipe.AccumState(torch.as_tensor(rgb), spp))
        assert got.dtype == torch.uint8 and got.shape == rgb.shape
        mean = rgb / np.float32(max(spp, 1))
        want = (linear_to_srgb(mean) * 255 + 0.5).astype(np.uint8)
        diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    assert int(got.numpy().max()) == 255 and int(got.numpy().min()) == 0


def test_frame_to_ansi_equals_the_reference():
    r = np.random.default_rng(1)
    u8 = r.integers(0, 256, (6, 5, 3)).astype(np.uint8)
    assert tviewer._frame_to_ansi(u8) == jviewer._frame_to_ansi(u8)
    f32 = r.uniform(0, 1.5, (5, 4, 3)).astype(np.float32)  # an odd height
    text = tviewer._frame_to_ansi(f32)
    assert text == jviewer._frame_to_ansi(f32)
    assert text.count("▀") == 2 * 4 and text.count("\n") == 1


# ---------------------------------------------------------------------------
# the frames and the loop, driven without a terminal
# ---------------------------------------------------------------------------

class _FakeDisplay:
    def __init__(self):
        self.posts, self.texts = [], []

    def post(self, img, status):
        self.posts.append((img.copy(), status))

    def post_text(self, text):
        self.texts.append(text)


@pytest.fixture(scope="module")
def scene():
    return t_upload(presets.cornell_spheres(), "cpu")


def _loop(scene, display, integrator="wavefront", trace=False):
    return tviewer._ViewerLoop(scene, 32, 16, 1, tint.RenderConfig(max_depth=3), 0,
                            integrator, display, trace=trace)


def test_viewer_constants():
    # the reference's sweep knobs are constants in the port
    assert (tviewer.POOL_SIZE, tviewer.BOUNCES_PER_ITER) == (1 << 14, 1)
    assert not hasattr(tviewer, "PIPE_DEPTH")  # one frame in flight, no queue
    src = open(tviewer.__file__).read()
    for knob in ("MPT_VIEWER_BPI", "MPT_VIEWER_PIPE", "MPT_VIEWER_POOL"):
        assert knob not in src
    assert "MPT_VIEWER_TRACE" in src


def test_frame_resolves_its_own_state():
    state = tpipe.AccumState(torch.full((2, 4, 3), 2.0), 2)
    frame = tviewer._Frame(state, 20)
    assert frame.ready() and (frame.spp, frame.rays) == (2, 20)
    img = frame.image()
    # (sum / spp) == 1.0 -> 255; a later state leaves the frame as it was
    assert img.dtype == np.uint8 and img.shape == (2, 4, 3) and int(img.min()) == 255
    later = tviewer._Frame(tpipe.AccumState(state.rgb_sum * 0.0, 3), None)
    assert int(later.image().max()) == 0 and int(frame.image().min()) == 255


def test_camera_change_restarts_at_one_spp(scene):
    display = _FakeDisplay()
    s = _loop(scene, display)
    for k in range(1, 4):
        assert s.step(lambda: []) is True
        # one frame in flight: the shown frame is the newest dispatched
        assert s.shown_spp == k == s.state.spp
    before = s.cam
    # the key arrives while frame 4 is shown: that frame still has the old
    # camera; the accumulation starts over
    assert s.step(lambda: [("key", "w")]) is True
    assert s.shown_spp == 4 and s.state.spp == 0
    assert not torch.equal(s.cam.position, before.position)
    assert s.step(lambda: []) is True
    assert s.shown_spp == 1 and s.frames_shown == 5
    assert [int(p[1].split(" spp |")[0].rsplit("K", 1)[1]) for p in display.posts] == [
        1, 2, 3, 4, 1]
    # a frame without input keeps accumulating; every other control resets
    assert s.step(lambda: []) and s.shown_spp == 2
    for ev in [("key", "left"), ("key", "+"), ("scroll", 1), ("key", "r")]:
        assert s.step(lambda ev=ev: [ev]) is True
        assert s.state.spp == 0, ev
    assert s.step(lambda: []) and s.shown_spp == 1
    # the first displayed frame after the reset equals a fresh 1-spp render
    fresh, _ = tpipe.accumulate_wavefront(
        tpipe.init_accum(32, 16, "cpu"), s.scene, s.cam, 32, 16, 1, 0, s.cfg,
        pool_size=32 * 16)
    np.testing.assert_array_equal(display.posts[-1][0],
                                  tviewer._srgb_u8(fresh).numpy())


def test_mouse_drag_rotates_and_release_ends_the_drag(scene):
    s = _loop(scene, _FakeDisplay())
    fwd = s.cam.forward.clone()
    s.step(lambda: [("drag", 5, 5)])  # no button held: ignored
    assert torch.equal(s.cam.forward, fwd) and s.state.spp == 1
    s.step(lambda: [("mouse", 0, 10, 5, True), ("drag", 14, 5)])
    assert not torch.equal(s.cam.forward, fwd)
    fwd = s.cam.forward.clone()
    s.step(lambda: [("mouse", 0, 14, 5, False), ("drag", 30, 9)])
    assert torch.equal(s.cam.forward, fwd)


def test_scan_integrator_accumulates_frame_by_frame(scene):
    display = _FakeDisplay()
    s = _loop(scene, display, integrator="scan")
    assert s.step(lambda: []) and s.shown_spp == 1 and s.state.spp == 1
    assert s.step(lambda: []) and s.shown_spp == 2
    want = tpipe.init_accum(32, 16, "cpu")
    for _ in range(2):
        want = tpipe.accumulate(want, s.scene, s.cam, 32, 16, 1, 0, s.cfg)
    np.testing.assert_array_equal(display.posts[-1][0], tviewer._srgb_u8(want).numpy())


def test_resize_resets_the_accumulation(scene):
    display = _FakeDisplay()
    s = _loop(scene, display)
    s.step(lambda: [])
    s.resize(16, 8)
    assert s.state.spp == 0 and display.texts == ["\x1b[2J"]
    s.step(lambda: [])
    assert s.shown_spp == 1 and display.posts[-1][0].shape == (8, 16, 3)


def test_a_blocked_writer_never_blocks_the_loop(monkeypatch, scene):
    out = _SlowOut()  # the gate stays shut: every terminal write hangs
    monkeypatch.setattr(sys, "stdout", out)
    display = tviewer._DisplayWriter()
    done = []

    def loop():
        s = _loop(scene, display)
        for _ in range(5):
            s.step(lambda: [])
        done.append(s.shown_spp)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    th.join(timeout=120.0)
    try:
        assert not th.is_alive() and done == [5]
        assert out.getvalue() == ""  # nothing got through, and nobody waited
    finally:
        display.stop()
        out.gate.set()


def test_trace_line_per_frame(capsys, scene):
    s = _loop(scene, _FakeDisplay(), trace=True)
    s.step(lambda: [])
    s.step(lambda: [])
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("frame ")]
    assert len(lines) == 2 and lines[0].startswith("frame 0: dispatch ")
    assert " dt " in lines[1] and lines[1].endswith("spp 2 mm 0 cull 0")


@pytest.mark.skipif(not hasattr(os, "openpty"), reason="no pty support")
def test_viewer_runs_three_frames_under_a_pty():
    import pty

    m, s = pty.openpty()
    env = dict(os.environ, MPT_VIEWER_TRACE="1", OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "metalpathtracer_torch.viewer", "--scene",
         os.path.join(REPO, "scenes", "cornell.xml"), "--width", "32", "--height",
         "16", "--max-depth", "3", "--max-frames", "3", "--device", "cpu"],
        stdin=s, stdout=s, stderr=subprocess.PIPE, close_fds=True, cwd=REPO, env=env)
    os.close(s)
    err = []
    drain = threading.Thread(target=lambda: err.append(p.stderr.read()), daemon=True)
    drain.start()  # the child's stderr is drained while it runs
    out = b""
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            if p.poll() is not None and not select.select([m], [], [], 0.2)[0]:
                break
            if select.select([m], [], [], 0.5)[0]:
                try:
                    out += os.read(m, 65536)
                except OSError:
                    break
    finally:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)
        drain.join(timeout=30)
        os.close(m)
    txt = out.decode(errors="replace")
    assert p.returncode == 0, err
    assert "▀" in txt and "3 spp |" in txt
    assert "\x1b[?1002h" in txt and "\x1b[?1006l" in txt  # mouse on, then off
    frames = [ln for ln in err[0].decode().splitlines() if ln.startswith("frame ")]
    assert len(frames) == 3
