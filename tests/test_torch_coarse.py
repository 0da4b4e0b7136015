"""Slice parity: the port's coarse registration against the JAX package's,
on the CPU.

The marker scene is that of tests/test_registration.py:420-464: an ArUco
5x5 marker 0 (with its white quiet zone) as a floor of points, 0.2 m a
side; here three cameras each see it at their own offset, as tiles 1, 2
and 4 of one cloud (``chip_smoke.marker_scene``, which phase 17 (c) runs
on the card).  Tolerances: ``MultiCameraCoarseAruco``'s transforms
equal the JAX package's within 1e-9 (both render and detect on the host,
from the same points), and each camera's marker centre lands within 2 cm
of the origin.  The pre-seed stub of tests/test_registration.py:575-635 is
mirrored: a camera seeded with ``set_transformation`` starts the marker
chain (translations within 1e-9), and without it the chain cannot start.
The interactive color target falls back on a headless host to the
automated detector (transforms equal to the automated class's, and to the
JAX interactive class's within 1e-9); with a display (cv2's window
scripted) the same shift-clicks give transforms within 1e-9 of the JAX
interactive class's, and a window that cannot open raises in both.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

import chip_smoke
import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.registration import coarse as jcoarse
from cwipc_util_tpu_torch.registration import coarse, multicoarse
from cwipc_util_tpu_torch.registration.util import cwipc_transform

def test_aruco_matches_jax_on_the_marker_scene():
    m = chip_smoke.marker_scene()
    algo = coarse.MultiCameraCoarseAruco()
    pc = port.cwipc_from_numpy_matrix(m, 0, device="cpu")
    algo.set_tiled_pointcloud(pc)
    assert algo.run(), "marker not found/registered"
    jalgo = jcoarse.MultiCameraCoarseAruco()
    jalgo.set_tiled_pointcloud(jc.cwipc_from_numpy_matrix(m, 0))
    assert jalgo.run()
    got, want = algo.get_result_transformations(), jalgo.get_result_transformations()
    assert len(got) == len(want) == 3
    for cam, (T, Tj) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(T, Tj, rtol=0, atol=1e-9)
        tile = port.cwipc_tilefilter(pc, 1 << cam)
        center = cwipc_transform(tile, T).get_numpy_matrix(onlyGeometry=True).mean(axis=0)
        assert np.linalg.norm(center) < 0.02, f"camera {cam}: marker center off by {center}"
    full = algo.get_result_pointcloud_full()
    assert full.count() == pc.count() and full._device.type == "cpu"


def test_multicoarse_names_the_coarse_classes():
    for name in ("MultiCameraCoarse", "MultiCameraCoarseAruco", "MultiCameraCoarseArucoRgb",
                 "MultiCameraCoarseColorTarget", "MultiCameraCoarseColorTargetInteractive", "fit_rigid"):
        assert getattr(multicoarse, name) is getattr(coarse, name)
    rng = np.random.default_rng(2)
    src = rng.normal(size=(4, 3))
    T = coarse.fit_rigid(src, src @ np.diag([1.0, -1.0, -1.0]).T + [0.5, 0.0, 1.0])
    np.testing.assert_allclose(T, jcoarse.fit_rigid(src, src @ np.diag([1.0, -1.0, -1.0]).T + [0.5, 0.0, 1.0]),
                               rtol=0, atol=1e-12)


def color_target_scene():
    """Two cameras (tiles 1 and 2) that each see the four color blobs of the
    target, 40 points a blob with 5 mm of noise, at their own offset."""
    rng = np.random.default_rng(9)
    parts = []
    for cam, offset in enumerate(((0.2, 0.0, 0.1), (-0.1, 0.0, 0.3))):
        for idx, (ref, _) in enumerate(sorted(coarse.MultiCameraCoarseColorTarget.COLORS.values(),
                                              key=lambda v: v[1])):
            corner = coarse._marker_world_corners()[idx] + offset
            blob = np.zeros((40, 7), np.float32)
            blob[:, 0:3] = corner + rng.normal(scale=0.005, size=(40, 3))
            blob[:, 3:6] = ref
            blob[:, 6] = 1 << cam
            parts.append(blob)
    return np.concatenate(parts)


def test_color_target_matches_jax_and_interactive_raises(monkeypatch):
    m = color_target_scene()
    algo = coarse.MultiCameraCoarseColorTarget()
    algo.set_tiled_pointcloud(port.cwipc_from_numpy_matrix(m, 0, device="cpu"))
    jalgo = jcoarse.MultiCameraCoarseColorTarget()
    jalgo.set_tiled_pointcloud(jc.cwipc_from_numpy_matrix(m, 0))
    assert algo.run() and jalgo.run()
    for T, Tj in zip(algo.get_result_transformations(), jalgo.get_result_transformations(), strict=True):
        np.testing.assert_allclose(T, Tj, rtol=0, atol=1e-9)
    # the interactive variant: headless, the pickers return no points and
    # it falls back to the automated detector, as the JAX class does
    # (registration/coarse.py:359-366, registration/util.py:345-360); with
    # a display the user's shift-clicks pick the corners
    monkeypatch.delenv("DISPLAY", raising=False)
    interactive = coarse.MultiCameraCoarseColorTargetInteractive()
    interactive.set_tiled_pointcloud(port.cwipc_from_numpy_matrix(m, 0, device="cpu"))
    jinteractive = jcoarse.MultiCameraCoarseColorTargetInteractive()
    jinteractive.set_tiled_pointcloud(jc.cwipc_from_numpy_matrix(m, 0))
    assert interactive.run() and jinteractive.run()
    for T, Tj, Tp in zip(interactive.get_result_transformations(), jinteractive.get_result_transformations(),
                         algo.get_result_transformations(), strict=True):
        np.testing.assert_allclose(T, Tj, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(T, Tp)
    # with a display (cv2's window scripted: each tile's picker gets the
    # shift-click whose pick lands nearest each coloured corner that the
    # automated detector found, red, green, blue, yellow), both packages'
    # pickers give the same transforms; a window that cannot open raises
    # in both
    from test_torch_viewer import scripted_gui

    from cwipc_util_tpu_torch.io.render import OrbitCamera
    from cwipc_util_tpu_torch.registration.util import pick_index_at, project_point_indices

    clicks = []
    real_find = coarse.MultiCameraCoarseColorTarget._find_markers
    for pc_cam in range(2):
        tile = port.cwipc_tilefilter(port.cwipc_from_numpy_matrix(m, 0, device="cpu"), 1 << pc_cam)
        corners = real_find(coarse.MultiCameraCoarseColorTarget(), tile)[0]
        xyz = tile.get_numpy_matrix(onlyGeometry=True)
        u, v, z = project_point_indices(xyz, OrbitCamera(), 640, 480)
        for c in corners:
            i = int(np.argmin(((xyz - c) ** 2).sum(1)))
            # pick_index_at's rule on the projections computed once, over
            # the pixels around the corner's
            best = None
            for x in range(int(round(u[i])) - 12, int(round(u[i])) + 13):
                for y in range(int(round(v[i])) - 12, int(round(v[i])) + 13):
                    d2 = (u - x) ** 2 + (v - y) ** 2
                    cand = np.where(d2 <= 144)[0]
                    if cand.size == 0:
                        continue
                    front = cand[z[cand] <= z[cand].min() * 1.02]
                    miss = np.linalg.norm(xyz[front[np.argmin(d2[front])]] - c)
                    if best is None or miss < best[0]:
                        best = (miss, x, y)
            assert pick_index_at(xyz, OrbitCamera(), 640, 480, best[1], best[2]) >= 0
            clicks.append((best[1], best[2], True))
    rearm = scripted_gui(monkeypatch, clicks)
    monkeypatch.setenv("DISPLAY", ":0")
    got = {}
    for name, mod, cloud in (("port", coarse, port.cwipc_from_numpy_matrix(m, 0, device="cpu")),
                             ("jax", jcoarse, jc.cwipc_from_numpy_matrix(m, 0))):
        rearm()
        interactive = mod.MultiCameraCoarseColorTargetInteractive()
        interactive.set_tiled_pointcloud(cloud)
        assert interactive.run()
        got[name] = interactive.get_result_transformations()
    for T, Tj in zip(got["port"], got["jax"], strict=True):
        np.testing.assert_allclose(T, Tj, rtol=0, atol=1e-9)
    import cv2

    def no_window(title):
        raise cv2.error("no display")

    monkeypatch.setattr(cv2, "namedWindow", no_window)
    for mod, cloud in ((coarse, port.cwipc_from_numpy_matrix(m, 0, device="cpu")),
                       (jcoarse, jc.cwipc_from_numpy_matrix(m, 0))):
        interactive = mod.MultiCameraCoarseColorTargetInteractive()
        interactive.set_tiled_pointcloud(cloud)
        with pytest.raises(cv2.error, match="no display"):
            interactive.run()


class StubCoarse(coarse.MultiCameraCoarse):
    def __init__(self, obs):
        super().__init__()
        self._obs = obs

    def camera_count(self):
        return len(self._obs)

    def get_pc_for_camnum(self, camnum):
        return camnum  # _find_markers keys on it directly

    def _find_markers(self, camnum):
        return {mid: np.asarray(c, np.float64) for mid, c in self._obs[camnum].items()}


def _observations():
    # marker 5 lives at a known world pose; neither camera sees marker 0,
    # so camera 1 can only register through camera 0's pose of marker 5
    w5 = coarse._marker_world_corners() + np.array([1.0, 0.0, 0.5])
    t0 = np.array([0.3, 0.1, -0.2])
    t1 = np.array([-0.5, 0.2, 0.4])
    return [{5: w5 - t0}, {5: w5 - t1}], t0, t1


def test_preseeded_camera_seeds_marker_propagation():
    obs, t0, t1 = _observations()
    algo = StubCoarse(obs)
    T0 = np.identity(4)
    T0[:3, 3] = t0
    algo.set_transformation(0, T0)
    assert algo.run(), "camera 1 did not register through the pre-seed"
    T1 = algo.get_result_transformations()[1]
    np.testing.assert_allclose(T1[:3, 3], t1, atol=1e-9)
    np.testing.assert_allclose(T1[:3, :3], np.identity(3), atol=1e-9)
    assert not StubCoarse(_observations()[0]).run()
