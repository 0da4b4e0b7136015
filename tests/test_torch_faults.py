"""Repairs of faults the port had against the JAX package, and the oracle
test of the small-cloud outlier route away from the origin, on the CPU.

* ``_cwipc_log_emit`` is exported from the port's package and listed in
  its ``__all__``, as the JAX package's (``__init__.py:68``, ``:249``):
  the logger callback of tests/test_api.py:279-288 gets the message.
* The guided "show" of ``register`` shows the stage's cloud in
  ``show_pointcloud`` and asks again; where it cannot show, it prints
  ``register: cannot show:`` and the error and asks again, as the JAX
  script does (``scripts/cwipc_register.py:459-465``).  (The headless
  fallback of ``MultiCameraCoarseColorTargetInteractive`` is held in
  tests/test_torch_coarse.py.)
* ``cwipc_remove_outliers`` on a 1 x 1 m sheet of 3,000 points 2 m and more
  from the origin (n <= 4096: the brute-force route), k 30, mult 1: the
  keep mask equals a float64 scipy cKDTree oracle's (keep where the mean
  distance to the k nearest is at most mean + mult * stddev).  The port
  forms d2 from coordinate differences (``ops/outliers.py``); the JAX
  package forms |a|^2 + |b|^2 - 2ab (its ``ops/outliers.py:95-102``) and may
  differ from the oracle there, so it is held to the JAX package only near
  the origin (tests/test_torch_exact_chain.py).
"""

import io
import json
import sys

import numpy as np
import pytest
from scipy.spatial import cKDTree
from test_torch_cli import _args

import cwipc_util_tpu_torch as port
from cwipc_util_tpu_torch.registration import fine, util
from cwipc_util_tpu_torch.registration.cameraconfig import CameraConfig, default_cameraconfig
from cwipc_util_tpu_torch.scripts import cwipc_register


def test_logger_callback():
    messages = []

    def cb(level, message):
        messages.append((level, message.decode("utf8")))

    port.cwipc_log_configure(port.CWIPC_LOG_LEVEL_DEBUG, cb)
    try:
        port._cwipc_log_emit(port.CWIPC_LOG_LEVEL_DEBUG, "test_module", "This is a test log message")
    finally:
        port.cwipc_log_configure(port.CWIPC_LOG_LEVEL_WARNING, None)
    assert any("This is a test log message" in m for _, m in messages)
    assert all(lvl == port.CWIPC_LOG_LEVEL_DEBUG for lvl, m in messages if "test log message" in m)
    assert "_cwipc_log_emit" in port.__all__


class _StillFlow:
    """A multi-camera algorithm that leaves every camera where it is."""

    def __init__(self):
        self.pc = None

    def set_aligner_class(self, cls):
        pass

    def set_analyzer_class(self, cls):
        pass

    def set_tiled_pointcloud(self, pc):
        self.pc = pc

    def set_original_transform(self, cam_index, matrix):
        pass

    def run(self):
        return True

    def report_change(self):
        return "no change"

    def get_result_pointcloud_full(self):
        return self.pc.clone()

    def get_result_transformations(self):
        return [np.identity(4)]


def test_guided_show_prints_and_asks_again(monkeypatch, capsys):
    reg = cwipc_register.Registrator(_args("--guided", "--device", "cpu"))
    reg.cameraconfig = CameraConfig("unused.json")
    reg.cameraconfig.load(json.dumps(default_cameraconfig("synthetic", ["a"])).encode())
    gen = port.cwipc_synthetic(0, 1000, device="cpu")
    gen.start()
    cloud = gen.get()
    gen.stop()
    shown = []
    real = util.show_pointcloud

    def show(title, pc, timeout_ms=5000):
        # headless, the window waits out its timeout: a short one here
        shown.append((title, pc.count()))
        if len(shown) > 1:
            raise port.CwipcError("no window")
        real(title, pc, timeout_ms=50)

    monkeypatch.setattr(util, "show_pointcloud", show)
    monkeypatch.setattr(sys, "stdin", io.StringIO("show\nshow\nyes\n"))
    assert reg._run_multicam(cloud, _StillFlow, fine.RegistrationComputer_ICP_Point2Point, None, "fine alignment")
    out = capsys.readouterr().out
    assert out.count("Accept (yes/no/show)") == 3
    assert shown == [("Result after fine alignment", cloud.count())] * 2
    assert "Press any key to close" in out and "register: cannot show: no window" in out


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_small_cloud_outliers_follow_the_oracle_off_the_origin(shift):
    rng = np.random.default_rng(11)
    n = 3000
    pts = np.zeros(n, port.POINT_DTYPE)
    pts["x"] = rng.uniform(0.0, 1.0, n) + shift
    pts["y"] = rng.uniform(0.0, 1.0, n)
    pts["z"] = 2.0 + rng.normal(0.0, 0.002, n)
    pts["r"] = rng.integers(0, 256, n)
    pts["tile"] = 1
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], -1).astype(np.float64)
    assert np.linalg.norm(xyz, axis=1).min() > 1.99
    dist, _ = cKDTree(xyz).query(xyz, k=31)
    md = dist[:, 1:].mean(axis=1)
    want = md <= md.mean() + md.std(ddof=1)
    pc = port.cwipc_from_numpy_array(pts, 0, device="cpu")
    out = port.cwipc_remove_outliers(pc, 30, 1.0, False).get_numpy_array()
    kept = {r.tobytes() for r in out}
    got = np.array([r.tobytes() in kept for r in pts])
    assert len(kept) == len(out)
    assert 0 < want.sum() < n
    np.testing.assert_array_equal(got, want)
