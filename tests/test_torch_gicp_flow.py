"""Registration parity with the default GICP aligner: the port's normals and
MultiCameraIterative flow against the JAX package's, on scenes made once in
numpy and handed to both packages.

The scene is a convex, asymmetric polyhedron (a box with one side sloped
and a wedge on one face; no symmetry fixes a pose), 4,000 points sampled
uniformly on its faces, turned into 3 camera tiles by simulatecams (hard
assignment, seed 42), 2 mm noise (seed 43) and a perturbation per camera
(perturbation(42 + cam, ...)).  Both packages build it bit for bit.

* ``test_normals_match_jax_where_determined``: at 1 m the Morton-window
  neighbourhoods leave a few points of each tile with two collinear
  neighbours only (eigen-gap < 1e-12: the normal is any direction
  perpendicular to them).  Every other point, eigen-gap above 1e-6, has
  the same normal in both packages to |dot| >= 1 - 1e-5 (measured: 1 -
  1.4e-6).  The degenerate points are where the two eigen-solvers may
  differ (LAPACK's eigh in JAX, Jacobi sweeps in the port); GICP weighs
  such a "normal" 1 / eps = 1000 times, which moved the 1 m flow's poses
  millimetres apart between the packages (measured on the CPU; with
  JAX's normals substituted in the port, its first step agreed within
  2e-6 m).
* ``test_gicp_flow_matches_jax``: the same body at 10 cm, where the
  normal radius (2 cm) spans the Morton windows: no point is degenerate
  (every eigen-gap above 7e-4, 99.3 % of them above 1e-2), with
  perturbations of 1 cm and 0.06 rad: the same sequence of (camera, accepted) steps, per-camera mode
  correspondences within 5 % relative of JAX's (measured: 4.9e-7) and
  every pose within 1e-5 m and 1e-5 rad of JAX's (measured: 4.3e-8 m,
  0 rad).
"""

import jax.numpy as jnp
import numpy as np
from scipy.spatial import ConvexHull
from test_torch_multicamera import _modes, perturbation
from test_torch_registration import _eigen_gap

import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.core.buffers import buffer_from_numpy as jax_buffer
from cwipc_util_tpu.filters.noise import NoiseFilter as JNoise
from cwipc_util_tpu.filters.simulatecams import SimulatecamsFilter as JSim
from cwipc_util_tpu.registration import analyze as janalyze
from cwipc_util_tpu.registration import fine as jfine
from cwipc_util_tpu.registration import multicamera as jmulti
from cwipc_util_tpu.registration import util as jutil
from cwipc_util_tpu.registration.normals import estimate_normals as jax_normals
from cwipc_util_tpu_torch.filters.noise import NoiseFilter
from cwipc_util_tpu_torch.filters.simulatecams import SimulatecamsFilter
from cwipc_util_tpu_torch.registration import analyze, fine, multicamera, util
from cwipc_util_tpu_torch.registration.normals import estimate_normals

# the body at scale 1: a 0.5 x 1.0 x 0.35 m box, its +x side sloped from
# y 0.6 up to x 0.1, and a wedge out to z 0.32 on its +z face
HULL = np.array([
    [-0.25, 0, -0.175], [0.25, 0, -0.175], [0.25, 0, 0.175], [-0.25, 0, 0.175],
    [-0.25, 1.0, -0.175], [0.1, 1.0, -0.175], [0.1, 1.0, 0.175], [-0.25, 1.0, 0.175],
    [0.25, 0.6, -0.175], [0.25, 0.6, 0.175], [-0.1, 0.5, 0.32],
])
NPOINTS = 4000


def _body(scale, seed):
    """NPOINTS points uniform on the hull's faces, as an Nx7 matrix."""
    tri = HULL[ConvexHull(HULL).simplices] * scale
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    rng = np.random.default_rng(seed)
    face = rng.choice(len(tri), NPOINTS, p=area / area.sum())
    u, v = rng.random(NPOINTS), rng.random(NPOINTS)
    out = u + v > 1
    u[out], v[out] = 1 - u[out], 1 - v[out]
    t = tri[face]
    m = np.zeros((NPOINTS, 7), np.float32)
    m[:, :3] = t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + v[:, None] * (t[:, 2] - t[:, 0])
    m[:, 3:6] = rng.integers(0, 256, (NPOINTS, 3))
    m[:, 6] = 1
    return m


def _scene(pkg, sim, noise, util_mod, m, translation, **kw):
    pc = pkg.cwipc_from_numpy_matrix(m, 0, **kw)
    pc = noise(0.002, seed=43).filter(sim(3, hard=True, seed=42).filter(pc))
    parts = [util_mod.cwipc_transform(pkg.cwipc_tilefilter(pc, 1 << cam), perturbation(42 + cam, translation, 0.06))
             for cam in range(3)]
    return pkg.cwipc_join_multi(parts)


def _scenes(scale, seed, translation):
    m = _body(scale, seed)
    j = _scene(jc, JSim, JNoise, jutil, m, translation)
    p = _scene(port, SimulatecamsFilter, NoiseFilter, util, m, translation, device="cpu")
    assert j.get_numpy_array().tobytes() == p.get_numpy_array().tobytes()
    return j, p


def _tiles(pc):
    arr = pc.get_numpy_array()
    for cam in range(3):
        a = arr[arr["tile"] == 1 << cam]
        yield a, np.stack([a["x"], a["y"], a["z"]], -1)


def _normal_radius(a):
    """The radius the GICP aligner takes for this cloud."""
    pc = port.cwipc_from_numpy_array(a, 0, device="cpu")
    return float(np.float32(fine.RegistrationComputer_ICP_Generalized()._effective_normal_radius(pc)))


def test_normals_match_jax_where_determined():
    _, p_scene = _scenes(1.0, 7, 0.03)
    n_degenerate = 0
    for a, xyz in _tiles(p_scene):
        r = _normal_radius(a)
        want = np.asarray(jax_normals(jax_buffer(a, 2048), jnp.float32(r)))[:len(a)]
        got = estimate_normals(port.buffer_from_numpy(a, 2048, device="cpu"), r).numpy()[:len(a)]
        gap = _eigen_gap(xyz, np.float32(r))
        determined = gap > 1e-6
        dots = np.abs((got * want).sum(1))
        assert dots[determined].min() >= 1 - 1e-5, dots[determined].min()
        assert (gap[~determined] < 1e-12).all()
        n_degenerate += int((~determined).sum())
    assert 0 < n_degenerate < 0.005 * NPOINTS


def _run(multi_mod, scene):
    steps = []

    class Strategy(multi_mod.MultiCameraIterative):
        def _confirm_step(self, cam_index, before, after):
            ok = super()._confirm_step(cam_index, before, after)
            steps.append((cam_index, ok))
            return ok

    algo = Strategy()
    algo.set_tiled_pointcloud(scene)
    assert algo.run()
    return algo, steps


def test_gicp_flow_matches_jax():
    j_scene, p_scene = _scenes(0.1, 4, 0.01)
    gap = np.concatenate([_eigen_gap(xyz, np.float32(_normal_radius(a))) for a, xyz in _tiles(p_scene)])
    assert (gap > 1e-2).mean() >= 0.99 and gap.min() > 1e-6
    assert multicamera.DEFAULT_FINE_ALIGNMENT_ALGORITHM is fine.RegistrationComputer_ICP_Generalized
    assert jmulti.DEFAULT_FINE_ALIGNMENT_ALGORITHM is jfine.RegistrationComputer_ICP_Generalized
    j_algo, j_steps = _run(jmulti, j_scene)
    p_algo, p_steps = _run(multicamera, p_scene)
    assert p_steps == j_steps and all(ok for _, ok in p_steps)
    for Tj, Tp in zip(j_algo.get_result_transformations(), p_algo.get_result_transformations(), strict=True):
        dt, dr = jutil.transformation_compare(np.asarray(Tj, np.float64), np.asarray(Tp, np.float64))
        assert dt <= 1e-5 and dr <= 1e-5, (dt, dr)
    before = _modes(analyze, p_scene)
    j_after = _modes(janalyze, j_algo.get_result_pointcloud_full())
    p_after = _modes(analyze, p_algo.get_result_pointcloud_full())
    np.testing.assert_allclose(p_after, j_after, rtol=0.05)
    assert p_after.max() < before.max() / 3

