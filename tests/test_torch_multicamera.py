"""Registration parity, multi-camera: the port's analyzers and
MultiCameraIterative / MultiCameraOneToAllOthers against the JAX package's,
on scenes made once in numpy and handed to both packages.

* The analyzers: every correspondence measure within rtol 1e-5 of JAX's
  and the overlap fitness/rmse within rtol 1e-5 (the NN distances behind
  them agree to rtol 1e-6, tests/test_torch_knn.py).
* The 3-camera fixture of scripts/cwipc_create_analysis_test.py at 4k
  points (simulatecams seed 42, noise 2 mm seed 43, per-camera
  perturbation(42 + cam, 0.03, 0.06)): the port's filters give the same
  scene bit for bit.
* MultiCameraIterative and MultiCameraOneToAllOthers, with the automatic
  correspondence and the point-to-point aligner: the same sequence of
  (camera, accepted) steps, and per-camera mode correspondences after
  registration (the register script's check_alignment) within 5 %
  relative of JAX's (measured: within 1e-5 relative, poses within
  2.1e-6 m).  The flow with the default GICP aligner is compared in
  tests/test_torch_gicp_flow.py, on a scene whose normals are determined:
  the 4k-point body here is sampled on rings, so many Morton
  neighbourhoods are nearly collinear and their normals undetermined.
  Poses are not compared here: a tile is a partial view of a body nearly
  symmetric about the vertical axis, so the geometry does not fix the
  pose about that axis.
* nn_grid_params: the same grid for every aligner pair of the flow.
"""

import math

import numpy as np
import pytest

import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.filters.noise import NoiseFilter as JNoise
from cwipc_util_tpu.filters.simulatecams import SimulatecamsFilter as JSim
from cwipc_util_tpu.ops.knn import nn_grid_params as jax_grid_params
from cwipc_util_tpu.registration import analyze as janalyze
from cwipc_util_tpu.registration import fine as jfine
from cwipc_util_tpu.registration import multicamera as jmulti
from cwipc_util_tpu.registration import util as jutil
from cwipc_util_tpu_torch.filters.noise import NoiseFilter
from cwipc_util_tpu_torch.filters.simulatecams import SimulatecamsFilter
from cwipc_util_tpu_torch.ops.knn import nn_grid_params
from cwipc_util_tpu_torch.registration import analyze, fine, multicamera, util


def _translation(x, y, z):
    T = np.identity(4)
    T[:3, 3] = (x, y, z)
    return T


def perturbation(seed, max_translation, max_rotation):
    """scripts/cwipc_create_analysis_test.py:24-35."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-max_translation, max_translation, 3)
    angle = rng.uniform(-max_rotation, max_rotation)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.identity(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)
    T = np.identity(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


@pytest.fixture(scope="module")
def body():
    """The 4k-point synthetic body as an Nx7 matrix (the JAX source's)."""
    gen = jc.cwipc_synthetic(0, 4000)
    gen.start()
    pc = gen.get()
    gen.stop()
    return pc.get_numpy_matrix()


def _scene(pkg, sim, noise, util_mod, m, **kw):
    pc = pkg.cwipc_from_numpy_matrix(m, 0, **kw)
    pc = noise(0.002, seed=43).filter(sim(3, hard=False, seed=42).filter(pc))
    parts = [util_mod.cwipc_transform(pkg.cwipc_tilefilter(pc, 1 << cam), perturbation(42 + cam, 0.03, 0.06))
             for cam in range(3)]
    return pkg.cwipc_join_multi(parts)


@pytest.fixture(scope="module")
def scenes(body):
    j = _scene(jc, JSim, JNoise, jutil, body)
    p = _scene(port, SimulatecamsFilter, NoiseFilter, util, body, device="cpu")
    assert j.get_numpy_array().tobytes() == p.get_numpy_array().tobytes()
    return j, p


def _clouds(src_m, ref_m):
    return (jc.cwipc_from_numpy_matrix(src_m, 0), jc.cwipc_from_numpy_matrix(ref_m, 0),
            port.cwipc_from_numpy_matrix(src_m, 0, device="cpu"),
            port.cwipc_from_numpy_matrix(ref_m, 0, device="cpu"))


def _moved(m, T):
    out = m.copy()
    out[:, :3] = m[:, :3] @ T[:3, :3].T + T[:3, 3]
    return out.astype(np.float32)


def _modes(analyzer_mod, pc):
    """The register script's check_alignment (scripts/cwipc_register.py:
    354-385): each camera's tile against all other tiles, mode measure."""
    out = []
    for cam in range(3):
        an = analyzer_mod.RegistrationAnalyzerSymmetric()
        an.set_source_pointcloud(pc, 1 << cam)
        an.set_reference_pointcloud(pc, 255 - (1 << cam))
        an.set_correspondence_measure("mode")
        an.run()
        out.append(an.get_results().minCorrespondence)
    return np.array(out)


def test_analyzers_match_jax(body):
    shifted = _moved(body, _translation(0.01, 0, 0))
    js, jr, ps, pr = _clouds(shifted, body.astype(np.float32))
    for cls in ("RegistrationAnalyzer", "RegistrationAnalyzerSymmetric"):
        for measure in ("mean", "tmean", "median", "mode", "2mode", "q=90"):
            res = []
            for mod, src, ref in ((janalyze, js, jr), (analyze, ps, pr)):
                an = getattr(mod, cls)()
                an.set_source_pointcloud(src)
                an.set_reference_pointcloud(ref)
                an.set_correspondence_measure(measure)
                an.run()
                res.append(an.get_results())
            a, b = res
            assert a.sourcePointCount == b.sourcePointCount and a.referencePointCount == b.referencePointCount
            np.testing.assert_allclose(b.minCorrespondence, a.minCorrespondence, rtol=1e-5)
            np.testing.assert_allclose(b.mean, a.mean, rtol=1e-5)
            assert abs(b.minCorrespondenceCount - a.minCorrespondenceCount) <= 2
    fit = []
    for mod, src, ref in ((janalyze, js, jr), (analyze, ps, pr)):
        an = mod.OverlapAnalyzer()
        an.set_source_pointcloud(src)
        an.set_reference_pointcloud(ref)
        an.set_correspondence(0.006)
        an.run()
        fit.append((an.get_results().fitness, an.get_results().rmse))
    assert 0 < fit[0][0] < 1
    np.testing.assert_allclose(fit[1], fit[0], rtol=1e-5)


def _run_strategy(multi_mod, fine_mod, cls_name, scene):
    steps, pairs = [], []

    class Strategy(getattr(multi_mod, cls_name)):
        def _confirm_step(self, cam_index, before, after):
            ok = super()._confirm_step(cam_index, before, after)
            steps.append((cam_index, ok))
            return ok

    class Aligner(fine_mod.RegistrationComputer_ICP_Point2Point):
        def run(self):
            corr = self.correspondence or self._auto_correspondence()
            pairs.append((self.get_filtered_source_pointcloud().get_numpy_matrix(onlyGeometry=True),
                          self.get_filtered_reference_pointcloud().get_numpy_matrix(onlyGeometry=True),
                          corr))
            return super().run()

    algo = Strategy()
    algo.set_aligner_class(Aligner)
    algo.set_tiled_pointcloud(scene)
    assert algo.run()
    return algo, steps, pairs


@pytest.mark.parametrize("cls_name", ["MultiCameraIterative", "MultiCameraOneToAllOthers"])
def test_strategy_matches_jax(scenes, cls_name):
    j_scene, p_scene = scenes
    j_algo, j_steps, _ = _run_strategy(jmulti, jfine, cls_name, j_scene)
    p_algo, p_steps, p_pairs = _run_strategy(multicamera, fine, cls_name, p_scene)
    assert p_steps == j_steps
    assert len(p_algo.get_result_transformations()) == 3 and len(p_pairs) >= 2
    before_j, before_p = _modes(janalyze, j_scene), _modes(analyze, p_scene)
    np.testing.assert_allclose(before_p, before_j, rtol=1e-5)
    j_after = _modes(janalyze, j_algo.get_result_pointcloud_full())
    p_after = _modes(analyze, p_algo.get_result_pointcloud_full())
    np.testing.assert_allclose(p_after, j_after, rtol=0.05)
    assert p_after.max() < before_p.max() / 2
    np.testing.assert_allclose(
        [r.minCorrespondence for r in p_algo.post_analysis_results],
        [r.minCorrespondence for r in j_algo.post_analysis_results], rtol=0.05)
    # the grid each aligner pair would get on the card, in both packages
    for src, ref, corr in p_pairs:
        a = jax_grid_params(src.astype(np.float32), ref.astype(np.float32), float(corr))
        b = nn_grid_params(src.astype(np.float32), ref.astype(np.float32), float(corr))
        assert a is not None and b is not None
        assert a[:5] == b[:5]
        np.testing.assert_array_equal(a[5], b[5])
