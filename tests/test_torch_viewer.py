"""Slice parity: the port's viewer (``io/visualizer.py``,
``io/visualizer_sink.py``, ``io/gl_render.py``, ``cwipc_window``) and the
pickers of ``registration/util.py`` against the JAX package's, on the CPU.

Equalities asserted, with their tolerances:

* The keymap: after the same keys, both packages' ``Visualizer`` hold the
  same state (tile filter and its mode, colorize, point size, pause and
  single step, timelapse, stop) and print the same text; ``w`` writes the
  same file, byte for byte; the rewind, reload, quality and edit keys
  reach the source and the editor in the same way.
* A displayed frame: the tile select's cloud (kernel 3's plain version on
  the CPU, and the colorize filter) bit-equal to the JAX viewer's, and
  the sink's splat image byte for byte, at five keymap states.
* The window sink: mouse orbit and keyboard interaction give equal
  cameras and images byte for byte; the caller's keys win over the
  camera keys, as in the JAX sink (cv2's window calls are scripted: the
  tests run without a display).
* The GL renderer (skipped without EGL, as tests/test_gl.py is): its image
  byte-equal to the JAX package's GL image; each point within 1.5 px of
  the splat's, as tests/test_gl.py:32 holds it; depth test, background,
  the permanent switch to the splat after a GL failure (logged once).
* The pickers: ``project_point_indices`` u/v within 1e-4 px and equal
  depths' finiteness, ``pick_index_at`` equal indices; ``pick_points``
  with scripted shift-clicks picks the same indices; headless it returns
  [] at once; ``show_pointcloud`` and the ``o3d_*`` fallbacks.
"""

import subprocess
import threading
import time

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.io import gl_render as jgl
from cwipc_util_tpu.io import visualizer as jvis
from cwipc_util_tpu.io import visualizer_sink as jsink
from cwipc_util_tpu.registration import util as jutil
from cwipc_util_tpu_torch.io import gl_render as pgl
from cwipc_util_tpu_torch.io import visualizer as pvis
from cwipc_util_tpu_torch.io import visualizer_sink as psink
from cwipc_util_tpu_torch.io.render import OrbitCamera, render_points
from cwipc_util_tpu_torch.models.synthetic import _generate_host
from cwipc_util_tpu_torch.registration import util as putil

cv2 = pytest.importorskip("cv2")

N = 4000


def _points(n=N, seed=7):
    rng = np.random.default_rng(seed)
    pts = np.zeros(n, port.POINT_DTYPE)
    pts["x"] = rng.uniform(-0.6, 0.6, n)
    pts["y"] = rng.uniform(0.2, 1.8, n)
    pts["z"] = rng.uniform(-0.6, 0.6, n)
    for f in ("r", "g", "b"):
        pts[f] = rng.integers(0, 256, n)
    pts["tile"] = rng.choice(np.array([1, 2, 3, 4], np.uint8), n)
    return pts


def _clouds(pts=None, ts=1234):
    pts = _points() if pts is None else pts
    return port.cwipc_from_numpy_array(pts, ts, device="cpu"), jc.cwipc_from_numpy_array(pts, ts)


class FakeSource:
    def __init__(self):
        self.seeked, self.reloaded, self.quality = [], [], 0

    def seek(self, ts):
        self.seeked.append(ts)
        return True

    def reload_config(self, conf):
        self.reloaded.append(conf)
        return True

    def select_next_tile_quality(self):
        self.quality += 1
        return self.quality


def _state(v):
    return (v.tilefilter, v.filter_mode, v.colorize, v.point_size_power, v.paused, v.single_step, v.stopped,
            v.timelapse_write_at > 0, v.timelapse_pause_at > 0)


KEYS = ["3i3m5", "07an n", "++---", "ff", " . ", "<", "z", "c", "e", "w", "t", "p", "r", "#", "q", "\x1b", "?h"]


@pytest.mark.parametrize("keys", KEYS, ids=[repr(k) for k in KEYS])
def test_keymap_equals_the_jax_visualizer(keys, tmp_path, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(cmd))
    monkeypatch.setenv("EDITOR", "myeditor")
    got = {}
    for name, mod, pc in (("port", pvis, _clouds()[0]), ("jax", jvis, _clouds()[1])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        v = mod.Visualizer(nodisplay=True)
        v.current_pc = pc
        src = FakeSource()
        v.set_source(src)
        states = []
        for k in keys:
            v.handle_command(k)
            states.append(_state(v))
        if v.timelapse_write_at or v.timelapse_pause_at:
            v.timelapse_write_at = v.timelapse_beep_at = 1.0 if v.timelapse_write_at else 0.0
            v.timelapse_pause_at = 1.0 if v.timelapse_pause_at else 0.0
            v._handle_timelapse()
            states.append(_state(v))
        out = capsys.readouterr()
        files = {p.name: p.read_bytes() for p in (tmp_path / name).iterdir()}
        here = str(tmp_path / name)
        got[name] = (states, out.out.replace(here, "<cwd>"), out.err, (src.seeked, src.reloaded, src.quality), files)
    assert got["port"] == got["jax"]
    if "e" in keys:
        assert calls == [["myeditor", "cameraconfig.json"]] * 2
    if keys in ("w", "t"):
        assert len(got["port"][4]) == 1 and next(iter(got["port"][4])).startswith("pointcloud_1234")


def test_single_step_repauses_after_one_frame():
    """'.' shows exactly one frame, then holds (reference run loop
    re-pauses: io/visualizer.py:175-178)."""
    viz = pvis.Visualizer(nodisplay=True)
    producer = threading.Thread(target=time.sleep, args=(1.5,))
    producer.start()
    viz.set_producer(producer)
    viz.paused = True
    for _ in range(3):
        viz.feed(_clouds()[0])
    runner = threading.Thread(target=viz.run)
    runner.start()
    try:
        time.sleep(0.2)
        assert viz.display_count == 0
        viz.handle_command(".")
        deadline = time.time() + 3
        while viz.display_count < 1 and time.time() < deadline:
            time.sleep(0.02)
        time.sleep(0.2)
        assert viz.display_count == 1 and viz.paused
    finally:
        viz.stop()
        runner.join(timeout=5)
        producer.join(timeout=5)


@pytest.fixture()
def splat(monkeypatch):
    """Both sinks draw with the numpy splat."""
    monkeypatch.setattr(pgl, "gl_available", lambda: False)
    monkeypatch.setattr(jgl, "gl_available", lambda: False)


FRAMES = [("all", ""), ("tile 2", "2"), ("tile 2, colorized", "2f"), ("mask 3 by n, colorized", "2fn"),
          ("index 3, point size 3", "i3++")]


@pytest.mark.parametrize("keys", [k for _, k in FRAMES], ids=[n for n, _ in FRAMES])
def test_displayed_frame_equals_the_jax_viewer(keys, splat):
    """The display cloud (tile select through kernel 3's plain version,
    colorize) bit-equal to the JAX viewer's; the sink's image byte for byte."""
    pc, jpc = _clouds()
    shown = {}
    for name, mod, cloud in (("port", pvis, pc), ("jax", jvis, jpc)):
        v = mod.Visualizer(nodisplay=False)
        for k in keys:
            v.handle_command(k)
        display = v._prepare_display_pc(cloud)
        v.window.feed(display, clear=True)
        shown[name] = (display.get_numpy_array(), v.window.get_image(), v.window.point_size)
        if name == "port":
            assert v.window.renderer == "splat"
    assert shown["port"][0].tobytes() == shown["jax"][0].tobytes()
    assert shown["port"][2] == shown["jax"][2]
    assert shown["port"][1].tobytes() == shown["jax"][1].tobytes()
    assert (shown["port"][1] != 0).any()
    assert (len(shown["port"][0]) == N) == (keys == "")


def _mouse(win):
    win._on_mouse(cv2.EVENT_LBUTTONDOWN, 100, 100, 0, None)
    win._on_mouse(cv2.EVENT_MOUSEMOVE, 160, 130, 0, None)
    win._on_mouse(cv2.EVENT_LBUTTONUP, 160, 130, 0, None)
    win._on_mouse(cv2.EVENT_RBUTTONDOWN, 10, 10, 0, None)
    win._on_mouse(cv2.EVENT_MOUSEMOVE, 10, 40, 0, None)
    win._on_mouse(cv2.EVENT_RBUTTONUP, 10, 40, 0, None)
    win._on_mouse(cv2.EVENT_MOUSEWHEEL, 0, 0, -1, None)


def _camera(win):
    c = win.camera
    return (c.azimuth, c.elevation, c.distance, tuple(c.center))


def test_mouse_orbit_equals_the_jax_sink(splat):
    pc, jpc = _clouds()
    got = {}
    for name, mod, cloud in (("port", psink, pc), ("jax", jsink, jpc)):
        win = mod.cwipc_window_sink(name)
        win.feed(cloud, True)
        _mouse(win)
        got[name] = (_camera(win), win.get_image().tobytes())
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == pytest.approx(0.6)


INTERACT = [("caller's keys win", "aw+-q", "a", "a"), ("camera keys, then any key", None, "ad[+-x", "x"),
            ("timeout", "q", "a", "\0")]


@pytest.mark.parametrize("responses,script,want", [c[1:] for c in INTERACT], ids=[c[0] for c in INTERACT])
def test_interact_equals_the_jax_sink(responses, script, want, splat, monkeypatch):
    pc, jpc = _clouds()
    shown = []
    monkeypatch.setattr(cv2, "imshow", lambda title, img: shown.append(img.copy()))
    got = {}
    for name, mod, cloud in (("port", psink, pc), ("jax", jsink, jpc)):
        keys = list(script)
        # the render's own waitKey(1) pumps the window; keys go to interact's
        monkeypatch.setattr(cv2, "waitKey", lambda ms: ord(keys.pop(0)) if keys and ms != 1 else -1)
        monkeypatch.setattr(cv2, "destroyWindow", lambda title: None)
        win = mod.cwipc_window_sink(name)
        win._gui = True
        win.feed(cloud, True)
        ch = win.interact(None, responses, 200)
        win.free()
        got[name] = (ch, _camera(win), [img.tobytes() for img in shown])
        shown.clear()
    assert got["port"] == got["jax"]
    assert got["port"][0] == want


def test_cwipc_window_is_the_sink(splat):
    pc, jpc = _clouds()
    win, jwin = port.cwipc_window("t"), jc.cwipc_window("t")
    assert isinstance(win, psink.cwipc_window_sink)
    win.caption("caption")
    assert win.feed(pc, True) and jwin.feed(jpc, True)
    assert win.get_image().tobytes() == jwin.get_image().tobytes()
    assert win.interact("prompt", None, 10) == "\0"


# ---- the GL renderer ----------------------------------------------------------------------------------------

gl = pytest.mark.skipif(not pgl.gl_available(), reason="no EGL/GL")


def _scene():
    cam = OrbitCamera(center=(0, 1, 0), distance=2.5)
    xyz = np.array([[0, 1, 0], [0.3, 1.2, 0.1], [-0.2, 0.8, -0.1], [0.1, 1.1, 0.4]], np.float32)
    rgb = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0]], np.uint8)
    return cam, xyz, rgb


@gl
def test_gl_image_equals_the_jax_gl_and_the_splat():
    """Byte-equal to the JAX package's GL image; every point within 1.5 px
    of the splat's (tests/test_gl.py:32: half-pixel centre conventions
    differ), same colours."""
    cam, xyz, rgb = _scene()
    img = pgl.render_points_gl(xyz, rgb, 320, 240, cam, point_size=3)
    assert img.tobytes() == jgl.render_points_gl(xyz, rgb, 320, 240, cam, point_size=3).tobytes()
    sw = render_points(xyz, rgb, 320, 240, cam, point_size=3)
    for color in map(tuple, rgb):
        m_sw, m_gl = np.argwhere((sw == color).all(-1)), np.argwhere((img == color).all(-1))
        assert len(m_sw) and len(m_gl), color
        assert np.abs(m_sw.mean(0) - m_gl.mean(0)).max() <= 1.5, color


@gl
def test_gl_depth_background_and_empty():
    cam = OrbitCamera(center=(0, 1, 0), distance=2.0)
    view = cam.view_matrix()
    eye = -np.linalg.inv(view[:3, :3]) @ view[:3, 3]
    near = np.array([0, 1, 0], np.float64)
    far = near + (near - eye) * 0.5
    img = pgl.render_points_gl(np.array([far, near], np.float32), np.array([[255, 0, 0], [0, 255, 0]], np.uint8),
                               320, 240, cam, point_size=5)
    assert (img == (0, 255, 0)).all(-1).any() and not (img == (255, 0, 0)).all(-1).any()
    img = pgl.render_points_gl(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8), 64, 48, cam,
                               background=(10, 20, 30))
    assert img.shape == (48, 64, 3) and (img == (10, 20, 30)).all()


@gl
def test_gl_sink_draws_and_a_gl_failure_switches_to_the_splat_once(monkeypatch):
    pc, _ = _clouds()
    win = psink.cwipc_window_sink("t")
    assert win.feed(pc, True) and win.renderer == "gl" and (win.get_image() != 0).any()
    logged = []
    monkeypatch.setattr(psink, "cwipc_log", lambda level, module, msg: logged.append(msg))

    def boom(*a, **kw):
        raise RuntimeError("synthetic GL loss")

    monkeypatch.setattr(pgl, "render_points_gl", boom)
    for _ in range(2):
        assert win.feed(pc, True) and win.renderer == "splat" and win._gl_broken
    assert len(logged) == 1 and "synthetic GL loss" in logged[0]
    assert win.get_image().tobytes() == render_points(*_xyz_rgb(pc), 640, 480, win.camera).tobytes()


def _xyz_rgb(pc):
    a = pc.get_numpy_array()
    return np.stack([a["x"], a["y"], a["z"]], -1), np.stack([a["r"], a["g"], a["b"]], -1)


# ---- the pickers --------------------------------------------------------------------------------------------


def test_project_and_pick_index_equal_the_jax_pickers():
    body = _generate_host(80, 80, 0.0)  # the synthetic source's body surface, as the JAX test's cloud
    xyz = np.stack([body["x"], body["y"], body["z"]], -1).astype(np.float32)
    cam, w, h = OrbitCamera(), 640, 480
    u, v, z = putil.project_point_indices(xyz, cam, w, h)
    ju, jv, jz = jutil.project_point_indices(xyz, cam, w, h)
    np.testing.assert_array_equal(np.isfinite(u), np.isfinite(ju))
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-4)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(z, jz)
    onscreen = np.where(np.isfinite(u) & (u >= 10) & (u < w - 10) & (v >= 10) & (v < h - 10))[0]
    assert onscreen.size > 100
    hits = 0
    for idx in onscreen[:: onscreen.size // 25][:25]:
        got = putil.pick_index_at(xyz, cam, w, h, float(u[idx]), float(v[idx]))
        assert got == jutil.pick_index_at(xyz, cam, w, h, float(u[idx]), float(v[idx])) >= 0
        assert (u[got] - u[idx]) ** 2 + (v[got] - v[idx]) ** 2 <= 12**2 and z[got] <= z[idx] * 1.02 + 1e-6
        hits += int(got == idx)
    assert hits >= 5
    assert putil.pick_index_at(xyz, cam, w, h, -500.0, -500.0) == jutil.pick_index_at(xyz, cam, w, h, -500.0,
                                                                                       -500.0) == -1


def scripted_gui(monkeypatch, clicks):
    """cv2's window calls scripted: each waitKey replays the next (x, y)
    of ``clicks`` as a shift-click (or a plain click when flagged), then
    returns no key."""
    callbacks = {}
    for mod in (psink, jsink):
        monkeypatch.setattr(mod, "_try_cv2_gui", lambda: True)
    monkeypatch.setattr(cv2, "namedWindow", lambda title: None)
    monkeypatch.setattr(cv2, "destroyWindow", lambda title: None)
    monkeypatch.setattr(cv2, "imshow", lambda title, img: None)
    monkeypatch.setattr(cv2, "setMouseCallback", lambda title, cb: callbacks.__setitem__(title, cb))
    queue = []

    def wait_key(ms):
        if queue and ms != 1:  # not the render's own waitKey(1)
            x, y, shift = queue.pop(0)
            flags = cv2.EVENT_FLAG_SHIFTKEY if shift else 0
            for cb in list(callbacks.values()):
                cb(cv2.EVENT_LBUTTONDOWN, x, y, flags, None)
        return -1

    monkeypatch.setattr(cv2, "waitKey", wait_key)

    def rearm():
        queue[:] = list(clicks)
        callbacks.clear()

    return rearm


def test_pick_points_with_scripted_clicks_equals_the_jax_picker(monkeypatch):
    pts = _points(2000)
    pc, jpc = _clouds(pts)
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], -1).astype(np.float32)
    u, v, _ = putil.project_point_indices(xyz, OrbitCamera(), 640, 480)
    ok = np.where(np.isfinite(u) & (u > 20) & (u < 620) & (v > 20) & (v < 460))[0]
    far = [ok[np.argmin(u[ok])], ok[np.argmax(u[ok])], ok[np.argmin(v[ok])]]
    clicks = [(int(round(u[i])), int(round(v[i])), True) for i in far]
    # a plain click orbits and picks nothing; a second click on a picked
    # point adds nothing
    clicks = clicks[:1] + [(5, 5, False), clicks[0]] + clicks[1:]
    rearm = scripted_gui(monkeypatch, clicks)
    rearm()
    got = putil.pick_points("t", pc, count=3, timeout_ms=2000)
    rearm()
    want = jutil.pick_points("t", jpc, count=3, timeout_ms=2000)
    assert got == want and len(got) == 3 and len(set(got)) == 3


def test_pickers_headless_and_show(monkeypatch, capsys):
    """Headless: pick_points returns [] at once; show_pointcloud renders
    and waits out its timeout; open3d is absent, so the o3d helpers fall
    back to them."""
    monkeypatch.delenv("DISPLAY", raising=False)
    pc, jpc = _clouds(_points(500))
    t_0 = time.time()
    assert putil.pick_points("t", pc, count=4, timeout_ms=5000) == jutil.pick_points("t", jpc, 4, 100) == []
    assert putil.o3d_pick_points("t", pc) == []
    assert time.time() - t_0 < 1.0
    putil.show_pointcloud("t", pc, timeout_ms=50)
    shown = []
    monkeypatch.setattr(putil, "show_pointcloud", lambda title, cloud, timeout_ms=5000: shown.append(cloud))
    assert putil.o3d_show_points("t", pc) is None and shown == [pc]
    with pytest.raises(RuntimeError, match="open3d"):
        putil.o3d_show_points("t", object())
    assert putil._as_wrapper_or_o3d(pc) == (pc, None)
    assert "Press any key to close" in capsys.readouterr().out
