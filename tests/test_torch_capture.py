"""Slice parity: the port's capture side (cameraconfig, the capturer
registry and base framework, file playback, the software renderer and the
source wrappers) against the JAX package, on the CPU.

Equalities asserted, with their tolerances:

* cameraconfig JSON written by either package is read back unchanged by
  the other; ``default_cameraconfig`` gives equal dicts.
* The capturer registries list the same types; ``cwipc_check_module``
  gives the same answers; the camera shims refuse to import in both.
* ``rgb_to_hsv``, ``greenscreen_mask`` and ``remove_greenscreen`` are
  bit-equal on a seeded cloud; the checks of tests/test_capturer_base.py
  hold for the port's base framework.
* PLY, dump and compressed files and a 3-camera recording written by the
  JAX package play back in the port as equal clouds (bytes equal); the
  fused replay has xyz allclose at rtol 1e-6 (atol 0), rgb and tiles equal.
* ``render_points`` gives a bit-equal image and depth at point sizes 1
  and 3 from three views.
"""

import json
import os

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu import codec as jcodec
from cwipc_util_tpu.io import render as jrender
from cwipc_util_tpu.models import capturer as jcapturer
from cwipc_util_tpu.models import capturer_base as jbase
from cwipc_util_tpu.models import playback as jplayback
from cwipc_util_tpu.registration import cameraconfig as jcameraconfig
from cwipc_util_tpu.registration.util import cwipc_transform as j_transform
from cwipc_util_tpu_torch.core.errors import CwipcError
from cwipc_util_tpu_torch.io import render
from cwipc_util_tpu_torch.models import capturer, capturer_base, playback
from cwipc_util_tpu_torch.registration import cameraconfig

N = 3000


def _points(n=N, seed=3):
    rng = np.random.default_rng(seed)
    pts = np.zeros(n, port.POINT_DTYPE)
    for f in ("x", "y", "z"):
        pts[f] = rng.uniform(-1, 1, n).astype(np.float32)
    pts["y"] += 1.0
    for f in ("r", "g", "b"):
        pts[f] = rng.integers(0, 256, n)
    pts["tile"] = rng.choice(np.array([1, 2, 4], np.uint8), n)
    return pts


# ---- cameraconfig ------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cameraconfig_json_crosses_unchanged(tmp_path, writer):
    w_mod, r_mod = (jcameraconfig, cameraconfig) if writer == "jax" else (cameraconfig, jcameraconfig)
    assert w_mod.default_cameraconfig("playback", ["a", "b"]) == r_mod.default_cameraconfig("playback", ["a", "b"])
    fn = str(tmp_path / "cameraconfig.json")
    with open(fn, "w") as fp:
        json.dump(w_mod.default_cameraconfig("synthetic", ["a", "b", "c"]), fp)
    cfg = w_mod.CameraConfig(fn)
    cfg.load()
    T = np.identity(4)
    T[:3, 3] = [0.1, -0.25, 1 / 3]
    cfg.set_transform(1, T)
    cfg.set_entry_from_string("camera.2.serial=xyz")
    cfg.set_entry_from_string("correspondence=0.0042")
    cfg.save()
    written = open(fn).read()
    other = r_mod.CameraConfig(fn)
    other.load()
    assert other.camera_count() == 3 and other.get_type() == "synthetic"
    assert other.get_serial_dict() == {"a": 1, "b": 2, "xyz": 4}
    np.testing.assert_array_equal(other.get_transform(1).get_matrix(), T)
    assert not other.is_dirty() and not other.all_identity()
    assert other.get_entry("correspondence") == 0.0042
    other.save()
    assert open(fn).read() == written
    assert os.path.exists(fn + "~")


# ---- the registry and the shims ------------------------------------------------


def test_registry_and_check_module_agree():
    assert capturer.cwipc_capturer_registry() == jcapturer.cwipc_capturer_registry() == ["synthetic", "playback"]
    for name in ("codec", "kinect", "realsense2", "orbbec", "synthetic", "playback", "nonesuch"):
        assert port.cwipc_check_module(name) == jc.cwipc_check_module(name), name
    for shim in ("kinect", "orbbec", "realsense2"):
        with pytest.raises(ImportError, match="plugin not installed"):
            __import__(f"cwipc_util_tpu_torch.{shim}")
    with pytest.raises(CwipcError, match="no camera types detected"):
        port.cwipc_capturer("auto", device="cpu")
    with pytest.raises(CwipcError, match="unknown capturer type"):
        port.cwipc_capturer('{"type": "nonesuch"}', device="cpu")
    src = port.cwipc_capturer('{"type": "synthetic", "npoints": 900}', device="cpu")
    src.start()
    pc = src.get()
    src.stop()
    assert pc.count() == 900 and pc._device.type == "cpu"


# ---- the base framework (tests/test_capturer_base.py, on the port) ---------------


class FakeCamera(capturer_base.CwipcBaseCamera):
    phases = []

    def __init__(self, config, index):
        super().__init__(config)
        self.index = index
        self.frames_left = 3

    def pre_start_all_cameras(self):
        FakeCamera.phases.append(("pre", self.index))

    def start_camera(self):
        FakeCamera.phases.append(("start", self.index))
        return True

    def start_camera_streaming(self):
        FakeCamera.phases.append(("stream", self.index))
        return True

    def stop_camera(self):
        pass

    def eof(self):
        return self.frames_left <= 0

    def capture_pointcloud(self):
        if self.frames_left <= 0:
            return None
        self.frames_left -= 1
        arr = np.zeros(10, port.POINT_DTYPE)
        arr["x"] = self.index
        arr["r"] = 100 + self.index
        return arr


class FakeCapture(capturer_base.CwipcBaseCapture):
    def create_cameras(self):
        self.cameras = [FakeCamera(cfg, i) for i, cfg in enumerate(self.config.cameras)]


def _make_source(ncam=2):
    cfg = capturer_base.CwipcBaseCaptureConfig("fake")
    for i in range(ncam):
        cam = capturer_base.CwipcBaseCameraConfig(serial=f"cam{i}", camera_type="fake")
        cam.trafo[0, 3] = i * 10.0
        cfg.cameras.append(cam)
    return capturer_base.cwipc_capturer_impl_base(FakeCapture(cfg), device="cpu")


def test_base_lifecycle_tiles_and_config():
    FakeCamera.phases = []
    src = _make_source(2)
    assert src.start()
    assert [p[0] for p in FakeCamera.phases] == ["pre", "pre", "start", "start", "stream", "stream"]
    assert src.grabber.cameras[0].is_sync_master and not src.grabber.cameras[1].is_sync_master
    pc = src.get()
    assert pc.count() == 20 and pc._device.type == "cpu"
    arr = pc.get_numpy_array()
    assert np.allclose(arr[arr["tile"] == 1]["x"], 0.0) and np.allclose(arr[arr["tile"] == 2]["x"], 11.0)
    for _ in range(2):
        assert not src.eof()
        src.get()
    assert src.eof()
    src.stop()
    src = _make_source(3)
    assert src.maxtile() == 4 and src.get_tileinfo_dict(0)["ncamera"] == 3
    info = src.get_tileinfo_dict(2)
    assert info["cameraMask"] == 2 and info["cameraName"] == b"cam1"
    with pytest.raises(CwipcError):
        src.get_tileinfo_dict(9)
    raw = src.get_tileinfo_raw(2)
    assert raw.cameraMask == 2 and raw.cameraName == b"cam1" and raw.ncamera == 1
    data = json.loads(src.get_config())
    assert data["type"] == "fake" and len(data["camera"]) == 3
    data["camera"][0]["serial"] = "renamed"
    assert src.reload_config(json.dumps(data))
    assert src.grabber.config.cameras[0].serial == "renamed"


def test_greenscreen_bit_equal_to_jax():
    rgb = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 255]], np.uint8)
    hsv = capturer_base.rgb_to_hsv(rgb)
    assert np.allclose(hsv[:, 0], [0, 120, 240, 0], atol=1e-6)
    assert capturer_base.greenscreen_mask(np.array([[30, 200, 40], [200, 30, 40], [10, 10, 10]], np.uint8)).tolist() \
        == [True, False, False]
    pts = _points(20000, seed=8)
    pts["g"] = np.maximum(pts["g"], 100)  # plenty of greens
    rgb = np.stack([pts["r"], pts["g"], pts["b"]], -1)
    assert capturer_base.rgb_to_hsv(rgb).tobytes() == jbase.rgb_to_hsv(rgb).tobytes()
    for kw in ({}, {"hue_tolerance": 20.0, "min_saturation": 0.5}):
        mask = capturer_base.greenscreen_mask(rgb, **kw)
        np.testing.assert_array_equal(mask, jbase.greenscreen_mask(rgb, **kw))
        assert 0 < mask.sum() < len(mask)
        pc = port.cwipc_from_numpy_array(pts, 77, device="cpu")
        pc._set_cellsize(0.01)
        got = capturer_base.remove_greenscreen(pc, **kw)
        jpc = jc.cwipc_from_numpy_array(pts, 77)
        jpc._set_cellsize(0.01)
        want = jbase.remove_greenscreen(jpc, **kw)
        assert got.get_bytes() == want.get_bytes()
        assert (got.timestamp(), got.cellsize(), got._device.type) == (want.timestamp(), want.cellsize(), "cpu")


# ---- playback ------------------------------------------------------------------------


def _write_frames(d, ext, pts):
    """Three frames written by the JAX package, as tests/test_pipeline.py
    writes its playback directories."""
    for i in range(3):
        pc = jc.cwipc_from_numpy_array(pts[i::3], 1000 + i)
        pc._set_cellsize(0.004)
        fn = os.path.join(d, f"frame-{1000 + i}{ext}")
        if ext == ".ply":
            jc.cwipc_write(fn, pc, jc.CWIPC_FLAGS_BINARY)
        elif ext == ".cwipcdump":
            jc.cwipc_write_debugdump(fn, pc)
        else:
            enc = jcodec.cwipc_new_encoder()
            enc.feed(pc)
            with open(fn, "wb") as fp:
                fp.write(enc.get_bytes())


@pytest.mark.parametrize("ext", [".ply", ".cwipcdump", ".cwicpc"])
def test_playback_of_jax_files(tmp_path, ext):
    _write_frames(str(tmp_path), ext, _points())
    got_src = playback.cwipc_playback(str(tmp_path), ext=ext, device="cpu")
    want_src = jplayback.cwipc_playback(str(tmp_path), ext=ext)
    assert got_src.start() and want_src.start()
    frames = 0
    while not want_src.eof():
        assert not got_src.eof()
        got, want = got_src.get(), want_src.get()
        assert got._device.type == "cpu"
        assert got.get_bytes() == want.get_bytes()
        assert (got.timestamp(), got.cellsize()) == (want.timestamp(), want.cellsize())
        frames += 1
    assert frames == 3 and got_src.eof()
    assert got_src.maxtile() == want_src.maxtile() == 1
    # the list form, trimmed by in/outpoint, as the script layer passes it
    files = sorted(str(tmp_path / f) for f in os.listdir(tmp_path))
    src = playback.cwipc_playback(files, ext=ext, inpoint=1001, outpoint=1001, device="cpu")
    assert [src.get().timestamp()] == [1001] and src.eof()


def test_playback_loop_retimestamp_tileconfig_and_directory(tmp_path, monkeypatch):
    """The options of tests/test_pipeline.py's playback tests, on the port:
    single-file loop serves a cached clone, retimestamp takes the wall
    clock, tileconfig.json gives the tile info, and a playback config's
    relative directory resolves against the config's own directory."""
    import time

    d = tmp_path / "rec"
    d.mkdir()
    _write_frames(str(d), ".ply", _points())
    reads = []
    orig = playback._Filesource._read_file
    monkeypatch.setattr(playback._Filesource, "_read_file", lambda self, f: reads.append(f) or orig(self, f))
    src = playback.cwipc_playback([str(d / "frame-1000.ply")], loop=True, device="cpu")
    src.start()
    got = [src.get() for _ in range(5)]
    assert len(reads) == 1 and not src.eof()
    assert all(pc.get_bytes() == got[0].get_bytes() for pc in got)
    src.stop()
    src = playback.cwipc_playback(str(d), ext=".ply", retimestamp=True, device="cpu")
    assert abs(src.get().timestamp() - time.time() * 1000.0) < 60_000
    info = [{"cameraName": "a", "cameraMask": 1, "normal": {"x": 0, "y": 0, "z": 1}}]
    (d / "tileconfig.json").write_text(json.dumps({"tileInfo": info}))
    src = playback.cwipc_playback(str(d), ext=".ply", device="cpu")
    assert src.maxtile() == 1 and src.get_tileinfo_dict(0) == info[0]
    cfg = tmp_path / "cameraconfig.json"
    cfg.write_text(json.dumps({"type": "playback", "directory": "rec"}))
    got = port.cwipc_capturer(str(cfg), device="cpu")
    want = jc.cwipc_capturer(str(cfg))
    while not want.eof():
        assert got.get().get_bytes() == want.get().get_bytes()
    assert got.eof()


def test_multicam_recording_replays_fused_as_jax(tmp_path):
    pts = _points(9000, seed=21)
    rng = np.random.default_rng(4)
    cameras = []
    for cam in range(3):
        sub = pts[pts["tile"] == 1 << cam].copy()
        sub["tile"] = 0
        jc.cwipc_write(str(tmp_path / f"cam{cam}.ply"), jc.cwipc_from_numpy_array(sub, 500), jc.CWIPC_FLAGS_BINARY)
        T = np.identity(4)
        if cam:
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            T[:3, :3] = q * np.sign(np.linalg.det(q))
            T[:3, 3] = rng.uniform(-0.5, 0.5, 3)
        cameras.append(dict(filename=f"cam{cam}.ply", type="playback", trafo=T.tolist()))
    cfg = dict(version=3, type="playback", camera=cameras, loop=True)
    fn = str(tmp_path / "cameraconfig.json")
    with open(fn, "w") as fp:
        json.dump(cfg, fp)
    got_src = port.cwipc_capturer(fn, device="cpu")
    want_src = jc.cwipc_capturer(fn)
    assert json.loads(got_src.get_config()) == json.loads(want_src.get_config())
    assert got_src.maxtile() == want_src.maxtile() == 4
    for t in range(4):
        assert got_src.get_tileinfo_dict(t) == want_src.get_tileinfo_dict(t)
    got_src.start()
    want_src.start()
    for _ in range(2):
        got, want = got_src.get().get_numpy_array(), want_src.get().get_numpy_array()
        assert len(got) == len(want) == 9000
        for f in ("x", "y", "z"):
            np.testing.assert_allclose(got[f], want[f], rtol=1e-6, atol=0)
        for f in ("r", "g", "b", "tile"):
            np.testing.assert_array_equal(got[f], want[f])
        assert sorted(np.unique(got["tile"])) == [1, 2, 4]
    got_src.stop()
    want_src.stop()
    # the host transform of the JAX package is what the device replay computes
    sub = jc.cwipc_read(str(tmp_path / "cam1.ply"), 0)
    moved = j_transform(sub, np.asarray(cameras[1]["trafo"], np.float32)).get_numpy_array()
    np.testing.assert_array_equal(got[got["tile"] == 2]["x"], moved["x"])


# ---- render ----------------------------------------------------------------------------


@pytest.mark.parametrize("point_size", [1, 3])
def test_render_points_bit_equal(point_size):
    pts = _points(20000, seed=5)
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], -1).astype(np.float64)
    rgb = np.stack([pts["r"], pts["g"], pts["b"]], -1)
    for az, el in ((0.0, 1.45), (np.pi / 2, 0.8), (0.3, -0.2)):
        cams = [mod.OrbitCamera(center=(0.0, 1.0, 0.0), distance=3.0, azimuth=az, elevation=el)
                for mod in (render, jrender)]
        np.testing.assert_array_equal(cams[0].view_matrix(), cams[1].view_matrix())
        got = render.render_points(xyz, rgb, 320, 240, cams[0], point_size=point_size, background=(80, 80, 80),
                                   return_depth=True)
        want = jrender.render_points(xyz, rgb, 320, 240, cams[1], point_size=point_size, background=(80, 80, 80),
                                     return_depth=True)
        assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
        assert (got[1] > 0).sum() > 1000


# ---- the source wrappers --------------------------------------------------------------


def test_source_and_sink_wrappers():
    src = port.cwipc_synthetic(0, 900, device="cpu")
    info = src.get_tileinfo_raw(1)
    d = src.get_tileinfo_dict(1)
    assert info.cameraMask == d["cameraMask"] and info.normal.z == d["normal"]["z"]
    assert src.get_tileinfo_raw(250) is None
    w = port.cwipc_activesource_wrapper(src)
    assert w.start() and w.available(True) and w.maxtile() == 3
    assert w.get().count() == 900
    moved = w.detach()
    assert w.get() is None and w.eof() and moved.get().count() == 900
    moved.stop()
    with pytest.raises(CwipcError):
        port.cwipc_source_wrapper(None).as_cwipc_source_p()
    with pytest.raises(CwipcError):
        port.cwipc_sink_wrapper(None).as_cwipc_sink_p()
    assert not port.cwipc_sink_wrapper(None).feed(None, True)
