"""Interactive progressive viewer in the terminal.

Port of `metalpathtracer_tpu/viewer.py`. The loop is

    key/mouse event -> InputState -> apply_inputs -> camera changed?
        -> reset accumulation : keep accumulating -> draw

Rendering uses the persistent-wavefront integrator
(`pipeline.accumulate_wavefront`; `--integrator scan` takes `accumulate`).
Output goes to the terminal as 24-bit-colour half-block characters (two
image rows per text row), so it runs over SSH with no display.

What the port keeps of the reference's structure, and what it replaces:
- one frame is in flight at a time: dispatch, gather input until its image
  is on the host, show it, apply the input. The reference queues three
  accumulate steps to hide the latency of its dispatch; here
  `accumulate_wavefront` reads its loop condition once per window of
  advances, so a frame is all but done when its dispatch returns, and a
  deeper queue would only show each frame later and make a camera change
  wait for as many dispatches. A camera change restarts the accumulation
  at 0 spp, so the next displayed frame has the new camera and 1 spp;
- each frame's sRGB uint8 image is resolved on the device (`_srgb_u8`) and
  copied into one pinned host buffer with a `non_blocking` copy followed
  by a CUDA event; the input loop polls `event.query()` and never waits on
  the device, and the viewer adds no synchronise of its own;
- terminal output is written by a latest-wins thread (`_DisplayWriter`),
  so a slow terminal drops frames and never stalls rendering;
- the accumulation functions return new states and leave their input as it
  was, so the PNG save reads the state on display.
The reference's sweep knobs are constants here: one bounce per advance and
a pool of 2^14 lanes.

Input decoding (`_read_events`) follows the reference byte for byte, except
that an ESC directly after an ESC starts a new sequence instead of leaking
its bytes as keys; `_drop_chords` then removes the key of an alt-chord
(ESC + key, as terminals send alt+q), so alt+q does not quit.

With `MPT_VIEWER_TRACE` set, every frame prints a line to stderr: the
times of its dispatch, poll and fetch, its `dt`, the samples it shows and
the launches of the two hand-written kernels during the frame; the frame
rate is read from these lines, which cost one `print` a frame.

Controls (mouse needs an xterm-compatible terminal; keys always work):

    mouse drag      rotate
    scroll wheel    zoom
    w/a/s/d         move (horizontal, y-locked)
    space/c         up / down
    arrows          rotate (yaw/pitch)
    +/-             zoom (fov)
    r               reset camera        p  save PNG to runs/
    q               quit

Usage:
    python -m metalpathtracer_torch.viewer --scene scenes/reference.xml
    python -m metalpathtracer_torch.viewer --scene scenes/cornell.xml \
        --device cpu --width 32 --height 16 --max-frames 3
"""

from __future__ import annotations

import os
import select
import sys
import termios
import threading
import time
import tty

import numpy as np

# xterm mouse reporting: button-event tracking (drag) + SGR extended coords
_MOUSE_ON = "\x1b[?1002h\x1b[?1006h"
_MOUSE_OFF = "\x1b[?1006l\x1b[?1002l"

POOL_SIZE = 1 << 14  # wavefront lanes of a viewer frame
BOUNCES_PER_ITER = 1  # wavefront bounces per advance

# partially received SGR mouse sequence carried across _read_events calls:
# terminal bytes can straddle the 10 ms per-byte select timeouts, and the
# leftover digits and ';' would otherwise come back as key events
_sgr_partial: str | None = None

_ARROWS = {"A": "up", "B": "down", "C": "right", "D": "left"}


def _read_events(timeout: float = 0.0) -> list[tuple]:
    """Non-blocking read of pending input events.

    Returns a list of ("key", ch), ("mouse", btn, x, y, is_press),
    ("drag", x, y) or ("scroll", direction) tuples. Arrow keys decode to
    ("key", "up"/"down"/"left"/"right"); SGR mouse sequences
    (ESC [ < b ; x ; y M/m) decode to mouse, drag and scroll events. ESC
    followed by a plain byte gives ("key", "esc") and the byte's key (an
    alt-chord, see `_drop_chords`); ESC followed by ESC gives ("key", "esc")
    and decodes the second ESC as the start of a sequence of its own.
    """
    global _sgr_partial
    events: list[tuple] = []

    def ready(wait: float) -> bool:
        return bool(select.select([sys.stdin], [], [], wait)[0])

    def read_sgr(seq: str) -> None:
        """Consume an SGR payload; stash the partial if bytes run dry."""
        global _sgr_partial
        while ready(0.01):
            c = sys.stdin.read(1)
            if c in "Mm":
                _sgr_partial = None
                try:
                    btn_s, x_s, y_s = seq.split(";")
                    btn = int(btn_s)
                    x, y = int(x_s), int(y_s)
                except ValueError:
                    return
                if btn & 64:  # scroll wheel
                    events.append(("scroll", -1 if (btn & 3) == 0 else 1))
                elif btn & 32:  # motion with button held = drag
                    events.append(("drag", x, y))
                else:
                    events.append(("mouse", btn & 3, x, y, c == "M"))
                return
            seq += c
            if len(seq) > 32:  # malformed stream; stop buffering
                _sgr_partial = None
                return
        _sgr_partial = seq  # bytes straddled the timeout; resume next call

    def read_escape() -> None:
        """Decode what follows an ESC that was just read."""
        while True:
            if not ready(0.01):
                events.append(("key", "esc"))
                return
            ch2 = sys.stdin.read(1)
            if ch2 == "\x1b":
                # the first ESC stood alone; this one starts over
                events.append(("key", "esc"))
                continue
            if ch2 != "[":
                events.append(("key", "esc"))
                events.append(("key", ch2))
                return
            if not ready(0.01):
                return
            ch3 = sys.stdin.read(1)
            if ch3 in _ARROWS:
                events.append(("key", _ARROWS[ch3]))
            elif ch3 == "<":
                # SGR mouse: <btn>;<x>;<y>(M=press/motion | m=release)
                read_sgr("")
            return

    if _sgr_partial is not None:
        read_sgr(_sgr_partial)
    while ready(timeout):
        timeout = 0.0
        ch = sys.stdin.read(1)
        if ch == "\x1b":
            read_escape()
        else:
            events.append(("key", ch))
    return events


def _drop_chords(events: list[tuple]) -> list[tuple]:
    """The events without the key of each alt-chord: a plain key directly
    after ("key", "esc") in one read arrived glued to the ESC, which is how
    terminals send alt+key. The "esc" stays (it commands nothing)."""
    out: list[tuple] = []
    after_esc = False
    for ev in events:
        is_esc = ev == ("key", "esc")
        if after_esc and ev[0] == "key" and not is_esc and len(ev[1]) == 1:
            after_esc = False
            continue
        after_esc = is_esc
        out.append(ev)
    return out


# one half-block cell, zero-padded fixed width so digit positions are
# static: the whole frame becomes a numpy byte-buffer fill
_CELL = "\x1b[38;2;000;000;000m\x1b[48;2;000;000;000m▀".encode()
_ROW_SUFFIX = "\x1b[0m\n".encode()


def _cell_digit_positions() -> list[int]:
    pos, i = [], 0
    while True:
        i = _CELL.find(b"000", i)
        if i < 0:
            return pos
        pos.append(i)
        i += 3


_DIGIT_POS = _cell_digit_positions()  # 6 triplets: fg r,g,b then bg r,g,b
assert len(_DIGIT_POS) == 6


class _DisplayWriter:
    """Latest-wins terminal writer thread.

    A 512x288 truecolour frame is ~3 MB of escape codes; a slow terminal
    or ssh pipe can take seconds to drain one. The render loop therefore
    never touches the terminal: it `post()`s the uint8 frame and the status
    line and moves on. This thread builds the ANSI text and writes it; when
    the terminal falls behind, intermediate frames are dropped. Progressive
    accumulation makes every displayed frame a refinement of the last, so
    drops cost smoothness, never content. Control messages (`post_text`)
    are never dropped.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._frame = None  # latest (img, status); older posts are dropped
        self._texts: list[str] = []  # control messages, never dropped
        self._posted = 0
        self._written = 0
        self._stop = False
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def post(self, img, status: str) -> None:
        with self._cond:
            self._frame = (img, status)
            self._posted += 1
            self._cond.notify()

    def post_text(self, text: str) -> None:
        with self._cond:
            self._texts.append(text)
            self._cond.notify()

    def drain(self, timeout: float = 10.0) -> None:
        """Block until the latest posted frame has reached the terminal."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while (
                (self._posted != self._written or self._texts)
                and not self._stop
                and time.perf_counter() < deadline
            ):
                self._cond.wait(0.05)

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._th.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._cond:
                while (
                    self._frame is None and not self._texts
                    and not self._stop
                ):
                    self._cond.wait()
                if self._stop and self._frame is None and not self._texts:
                    return
                frame, self._frame = self._frame, None
                texts, self._texts = self._texts, []
                seq = self._posted
            try:
                if frame is not None:
                    img, status = frame
                    sys.stdout.write("\x1b[H" + _frame_to_ansi(img) + status)
                for t in texts:
                    sys.stdout.write(t)
                sys.stdout.flush()
            except (OSError, ValueError):
                return  # terminal gone; the render loop exits on quit/EOF
            with self._cond:
                self._written = seq
                self._cond.notify_all()


def _srgb_u8(state):
    """Resolve an AccumState to an sRGB uint8 (H, W, 3) tensor on the
    state's device, so that a frame moves bytes to the host, not floats
    (`to_image` stays for PNG saves)."""
    import torch

    img = torch.clamp(state.rgb_sum / float(max(state.spp, 1)), 0.0, 1.0)
    srgb = torch.where(
        img <= 0.0031308, img * 12.92,
        1.055 * torch.pow(img, 1 / 2.4) - 0.055,
    )
    return (srgb * 255 + 0.5).to(torch.uint8)


def _frame_to_ansi(img: np.ndarray) -> str:
    """(H, W, 3) linear [0,1] f32 or sRGB uint8 (from `_srgb_u8`) ->
    truecolour half-block string (H/2 rows)."""
    if img.dtype == np.uint8:
        rgb = img.astype(np.uint16)
    else:
        from metalpathtracer_torch.io.png import linear_to_srgb

        rgb = (linear_to_srgb(img) * 255 + 0.5).astype(np.uint16)
    h = rgb.shape[0] & ~1
    w = rgb.shape[1]
    vals = np.concatenate([rgb[0:h:2], rgb[1:h:2]], axis=-1)  # (h/2, w, 6)

    buf = np.tile(
        np.frombuffer(_CELL, np.uint8), (h // 2, w, 1)
    )  # (h/2, w, cell_len)
    for k, p in enumerate(_DIGIT_POS):
        v = vals[..., k]
        buf[..., p] = v // 100 + 48
        buf[..., p + 1] = (v // 10) % 10 + 48
        buf[..., p + 2] = v % 10 + 48

    rows = buf.reshape(h // 2, w * len(_CELL))
    suffix = np.tile(np.frombuffer(_ROW_SUFFIX, np.uint8), (h // 2, 1))
    out = np.concatenate([rows, suffix], axis=1).tobytes()
    return out[:-1].decode("utf-8")  # drop the trailing newline


class _Frame:
    """One dispatched frame: its sample count, its rays, and its sRGB uint8
    image on the way to the host. On a CUDA device the image lands in
    `host`, a pinned buffer the caller keeps and hands to every frame."""

    def __init__(self, state, rays, host=None):
        import torch

        self.spp = state.spp
        self.rays = rays
        img = _srgb_u8(state)
        self._event = None
        if img.is_cuda:
            host.copy_(img, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            self._host = host
        else:
            self._host = img

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def image(self) -> np.ndarray:
        """The image on the host. Out of the pinned buffer it is a copy:
        the next frame overwrites the buffer while the display writer may
        still hold this one."""
        if self._event is None:
            return self._host.numpy()
        self._event.synchronize()
        return self._host.numpy().copy()


_MOVES = {"w": (0, 0, 1), "s": (0, 0, -1), "a": (-1, 0, 0), "d": (1, 0, 0),
          " ": (0, 1, 0), "c": (0, -1, 0)}
_TURNS = {"left": (-40.0, 0), "right": (40.0, 0), "up": (0, -40.0),
          "down": (0, 40.0)}
_HELP = ("drag rotate, wheel zoom, wasd/space/c move, +/- fov, "
         "r reset, p png, q quit")


class _ViewerLoop:
    """The viewer between the terminal's set-up and tear-down: the camera,
    the inputs, the accumulation (`state`) and the display writer. One
    `step` is one displayed frame; it reads its events through the function
    it is given, so it runs without a terminal."""

    def __init__(self, scene, width: int, height: int, spp_per_frame: int,
                 cfg, seed: int, integrator: str, display,
                 trace: bool = False):
        from metalpathtracer_torch.core import rng
        from metalpathtracer_torch.render.camera import Camera, InputState

        self.scene = scene
        self.width, self.height = width, height
        self.spp_per_frame = spp_per_frame
        self.cfg = cfg
        self.seed = rng.seed_from_int(seed)
        self.wavefront = integrator == "wavefront"
        self.display = display
        self.trace = trace
        self.cam = Camera.reset()
        self.inputs = InputState()
        self.drag_last: tuple[int, int] | None = None
        self.frames_shown = 0
        self.shown_spp = 0
        self._host = None
        self.restart()

    def restart(self) -> None:
        """Back to 0 spp at the current size and camera."""
        import torch

        from metalpathtracer_torch.render.pipeline import init_accum

        self.state = init_accum(self.width, self.height, self.scene.device)
        shape = (self.height, self.width, 3)
        if self.scene.device.type == "cuda" and (
                self._host is None or tuple(self._host.shape) != shape):
            self._host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)

    def _launched(self) -> tuple:
        """(closest-hit, cull) launches so far, for the trace line: the
        kernels' device tallies, which count a CUDA graph's replays too (one
        read of the card). The CPU launches no kernel."""
        if not (self.trace and self.scene.device.type == "cuda"):
            return 0, 0
        from metalpathtracer_torch.render.kernels import _build

        done = _build.tallies(self.scene.device)
        return tuple(done.get(k, (0, 0))[0] for k in ("mm_closest_hit", "cull_tile_lists"))

    def _advance(self, state):
        from metalpathtracer_torch.render.pipeline import (
            accumulate,
            accumulate_wavefront,
        )

        args = (state, self.scene, self.cam, self.width, self.height,
                self.spp_per_frame, self.seed, self.cfg)
        if not self.wavefront:
            return accumulate(*args), None
        # a small pool: a frame is ~1 spp of a small image, so the drain
        # stays short
        pool = min(POOL_SIZE, self.width * self.height * self.spp_per_frame)
        return accumulate_wavefront(*args, pool_size=pool)

    def resize(self, width: int, height: int) -> None:
        """A new size rebuilds the accumulation and resets the sample
        counter."""
        self.width, self.height = width, height
        self.restart()
        self.display.post_text("\x1b[2J")

    def _on_event(self, ev) -> str | None:
        """Fold one event into the inputs; returns "quit" or "save" for
        the two keys the loop acts on."""
        inputs = self.inputs
        kind = ev[0]
        if kind == "key":
            k = ev[1]
            if k == "q":
                return "quit"
            if k == "p":
                return "save"
            if k in _MOVES:
                inputs.movement = np.array(_MOVES[k], np.float32)
            elif k in _TURNS:
                inputs.rotation = inputs.rotation + np.array(_TURNS[k],
                                                             np.float32)
            elif k == "+":
                inputs.zoom = -20.0
            elif k == "-":
                inputs.zoom = 20.0
            elif k == "r":
                inputs.reset = True
        elif kind == "mouse":
            _, btn, x, y, press = ev
            self.drag_last = (x, y) if press and btn == 0 else None
        elif kind == "drag":
            _, x, y = ev
            if self.drag_last is not None:
                # one full image-width drag sweeps about half a turn
                s = 1600.0 / max(self.width, 1)
                dx = (x - self.drag_last[0]) * s
                dy = (y - self.drag_last[1]) * 2 * s  # half-block rows
                inputs.rotation = inputs.rotation + np.array([dx, dy],
                                                             np.float32)
            self.drag_last = (x, y)
        elif kind == "scroll":
            inputs.zoom += 12.0 * ev[1]
        return None

    def step(self, read_events=_read_events) -> bool:
        """Dispatch one frame, gather input until its image is on the
        host, show it, then apply the input. Returns False when the user
        quit."""
        from metalpathtracer_torch.render.camera import apply_inputs

        counts0 = self._launched()
        t0 = time.perf_counter()
        self.state, rays = self._advance(self.state)
        frame = _Frame(self.state, rays, self._host)
        t_disp = time.perf_counter()

        quit_req = save_req = False
        while True:
            for ev in _drop_chords(read_events()):
                what = self._on_event(ev)
                quit_req |= what == "quit"
                save_req |= what == "save"
            if quit_req or frame.ready():
                break
            time.sleep(0.002)
        if quit_req:
            return False

        t_poll = time.perf_counter()
        img = frame.image()
        dt = time.perf_counter() - t0
        if self.trace:
            mm, cull = (b - a for a, b in zip(counts0, self._launched()))
            print(
                f"frame {self.frames_shown}: dispatch {t_disp - t0:.3f}s "
                f"poll {t_poll - t_disp:.3f}s "
                f"fetch {time.perf_counter() - t_poll:.3f}s "
                f"dt {dt:.3f}s spp {frame.spp} mm {mm} cull {cull}",
                file=sys.stderr, flush=True,
            )

        if save_req:
            from metalpathtracer_torch.io.png import write_png
            from metalpathtracer_torch.render.pipeline import to_image

            os.makedirs("runs", exist_ok=True)
            out = f"runs/viewer_{int(time.time())}.png"
            write_png(out, to_image(self.state).cpu().numpy())
            self.display.post_text(f"\x1b[H\x1b[2Ksaved {out}\n")

        # apply the inputs gathered during the render
        self.cam, changed = apply_inputs(self.cam, self.inputs)
        self.inputs.movement = np.zeros(3, np.float32)
        self.inputs.clear()
        if changed:
            # the next displayed frame has the new camera, and 1 spp
            self.restart()

        mrays = (f" | {frame.rays / dt / 1e6:6.2f} Mrays/s"
                 if frame.rays is not None else "")
        self.display.post(
            img,
            f"\n\x1b[0m\x1b[2K{frame.spp} spp | "
            f"{1.0 / max(dt, 1e-9):5.1f} fps{mrays} | {_HELP}",
        )
        self.shown_spp = frame.spp
        self.frames_shown += 1
        return True


def run_viewer(scene_path: str, width: int = 512, height: int = 288,
               spp_per_frame: int = 1, max_depth: int = 8, seed: int = 0,
               max_frames: int | None = None, fit_terminal: bool = False,
               integrator: str = "wavefront", mouse: bool = True,
               device: str = "cuda") -> None:
    import torch

    from metalpathtracer_torch.render.device_scene import upload_scene
    from metalpathtracer_torch.render.integrator import RenderConfig
    from metalpathtracer_torch.scene import load_scene_xml

    dev = torch.device(device)
    scene = upload_scene(load_scene_xml(scene_path), dev)
    cfg = RenderConfig(max_depth=max_depth, bounces_per_iter=BOUNCES_PER_ITER)

    def terminal_render_size():
        try:
            cols, rows = os.get_terminal_size()
        except OSError:
            return width, height
        return max(16, cols), max(16, 2 * (rows - 1))

    if fit_terminal:
        width, height = terminal_render_size()

    trace = bool(os.environ.get("MPT_VIEWER_TRACE"))
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J")  # clear
    if mouse:
        sys.stdout.write(_MOUSE_ON)
        sys.stdout.flush()
    display = _DisplayWriter()  # terminal IO never blocks the render loop
    try:
        loop = _ViewerLoop(scene, width, height, spp_per_frame, cfg, seed,
                           integrator, display, trace)
        while max_frames is None or loop.frames_shown < max_frames:
            if fit_terminal:
                size = terminal_render_size()
                if size != (loop.width, loop.height):
                    loop.resize(*size)
            if not loop.step():
                return
        display.drain()  # the final frame must reach the terminal
    finally:
        display.stop()
        if mouse:
            sys.stdout.write(_MOUSE_OFF)
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="interactive terminal viewer")
    p.add_argument("--scene", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--spp-per-frame", type=int, default=1)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None,
                   help="exit after N frames (for testing)")
    p.add_argument("--fit-terminal", action="store_true",
                   help="track the terminal size (resize resets accumulation)")
    p.add_argument("--integrator", choices=("wavefront", "scan"),
                   default="wavefront")
    p.add_argument("--no-mouse", action="store_true",
                   help="skip xterm mouse reporting")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    a = p.parse_args(argv)
    run_viewer(a.scene, a.width, a.height, a.spp_per_frame, a.max_depth,
               a.seed, a.max_frames, a.fit_terminal, a.integrator,
               mouse=not a.no_mouse, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
