"""Registration parity, pairwise: the port's registration/normals.py,
fine.py and analyze.py against the JAX package's, on clouds made once in
numpy and handed to both packages (never each package's own trig).

* ``estimate_normals``: on a noisy sphere, wherever the smallest
  eigenvalue of a point's neighbourhood covariance is separated from the
  next (gap above 1 % of the largest, from a float64 recomputation; most
  points), and at every point that is not degenerate (gap above 1e-6:
  all but 6 of 6,000, whose gaps are below 1e-12), the signed normals (the
  outward flip fixes the sign) agree to dot >= 1 - 1e-5 (measured: 1 -
  5e-7).  At a degenerate point the eigenvector is not determined, and
  the port's Jacobi sweeps and JAX's eigh may return different ones
  (tests/test_torch_gicp_flow.py).
* ``_icp_fused``, all three variants, two-scale NN on both sides, on the
  whole-cloud 4k pair of tests/test_registration.py:172: both recover the
  inverse transform within 4 mm and 0.02 rad (that test's limits), and the
  two poses agree within 1 mm and 5e-3 rad, the JAX package's own
  fused-vs-host bound (tests/test_registration.py:212-214).  Measured on
  the CPU: within 1.1e-7 m of each other for all three variants.
* ``_icp_fused`` with an explicit column grid: the port's plain kernel 5
  against JAX's grid loop in interpret mode, the same bounds.
* The host loop (``per_iteration_callback`` set) against the fused loop,
  within the same bounds.

The analyzers and the multi-camera strategies are in
tests/test_torch_multicamera.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.core.buffers import buffer_from_numpy as jax_buffer
from cwipc_util_tpu.registration import fine as jfine
from cwipc_util_tpu.registration.normals import estimate_normals as jax_normals
from cwipc_util_tpu.registration.util import transformation_compare
from cwipc_util_tpu_torch.ops.knn import nn_grid_params
from cwipc_util_tpu_torch.ops.nn_select import nn_select
from cwipc_util_tpu_torch.registration import analyze, fine
from cwipc_util_tpu_torch.registration.normals import estimate_normals

VARIANTS = [
    "RegistrationComputer_ICP_Point2Point",
    "RegistrationComputer_ICP_Point2Plane",
    "RegistrationComputer_ICP_Generalized",
]


def _rotation_y(angle):
    c, s = math.cos(angle), math.sin(angle)
    T = np.identity(4)
    T[0, 0], T[0, 2], T[2, 0], T[2, 2] = c, s, -s, c
    return T


def _translation(x, y, z):
    T = np.identity(4)
    T[:3, 3] = (x, y, z)
    return T


@pytest.fixture(scope="module")
def body():
    """The 4k-point synthetic body as an Nx7 matrix (the JAX source's)."""
    gen = jc.cwipc_synthetic(0, 4000)
    gen.start()
    pc = gen.get()
    gen.stop()
    return pc.get_numpy_matrix()


def _moved(m, T):
    out = m.copy()
    out[:, :3] = m[:, :3] @ T[:3, :3].T + T[:3, 3]
    return out.astype(np.float32)


def _clouds(src_m, ref_m):
    """(jax source, jax reference, port source, port reference) wrappers."""
    return (jc.cwipc_from_numpy_matrix(src_m, 0), jc.cwipc_from_numpy_matrix(ref_m, 0),
            port.cwipc_from_numpy_matrix(src_m, 0, device="cpu"),
            port.cwipc_from_numpy_matrix(ref_m, 0, device="cpu"))


def _align(cls, src, ref, corr=0.05, callback=None):
    al = cls()
    al.set_source_pointcloud(src)
    al.set_reference_pointcloud(ref)
    al.set_correspondence(corr)
    al.per_iteration_callback = callback
    assert al.run()
    return al.get_result_transformation()


def _recovers(T, true_T):
    dt, dr = transformation_compare(T @ true_T, np.identity(4))
    assert dt < 0.004 and dr < 0.02, (dt, dr)


def _agree(a, b):
    dt, dr = transformation_compare(a, b)
    assert dt < 1e-3 and dr < 5e-3, (dt, dr)
    return dt, dr


def _eigen_gap(pts, radius, window=16):
    """(l2 - l1) / l3 of each point's neighbourhood covariance, in float64,
    over the neighbours estimate_normals takes (the +/-window Morton
    neighbours within radius)."""
    from cwipc_util_tpu_torch.ops.voxelize import morton3

    v = np.floor(pts / np.float32(radius)).astype(np.int32)
    v -= v.min(0)
    key = morton3(*(torch.from_numpy(np.ascontiguousarray(v[:, a])) for a in range(3))).numpy()
    order = np.argsort(key, kind="stable")
    sp = pts[order].astype(np.float64)
    n = len(sp)
    s, sw, sww = np.zeros((n, 3)), np.zeros(n), np.zeros((n, 3, 3))
    for w in range(-window, window + 1):
        nb = np.arange(n) + w
        d = np.roll(sp, -w, axis=0) - sp
        ok = ((nb >= 0) & (nb < n) & ((d * d).sum(1) <= radius * radius)).astype(np.float64)
        s += d * ok[:, None]
        sw += ok
        sww += d[:, :, None] * d[:, None, :] * ok[:, None, None]
    mean = s / sw[:, None]
    lam = np.linalg.eigvalsh(sww / sw[:, None, None] - mean[:, :, None] * mean[:, None, :])
    gap = np.empty(n)
    gap[order] = (lam[:, 1] - lam[:, 0]) / np.maximum(lam[:, 2], 1e-30)
    return gap


def test_normals_match_jax():
    rng = np.random.default_rng(11)
    v = rng.normal(size=(6000, 3))
    pts = (v / np.linalg.norm(v, axis=1, keepdims=True) * 0.5 + [1.5, 2.0, -1.0]
           + rng.normal(scale=0.001, size=(6000, 3))).astype(np.float32)
    arr = np.zeros(6000, port.POINT_DTYPE)
    arr["x"], arr["y"], arr["z"] = pts.T
    want = np.asarray(jax_normals(jax_buffer(arr, 8192), jnp.float32(0.1)))
    got = estimate_normals(port.buffer_from_numpy(arr, 8192, device="cpu"), 0.1).numpy()
    assert not got[6000:].any()
    dots = (got[:6000] * want[:6000]).sum(1)
    gap = _eigen_gap(pts, 0.1)
    sep = gap > 1e-2
    assert sep.mean() > 0.9
    assert dots[sep].min() >= 1 - 1e-5, dots[sep].min()
    # every point that is not degenerate, not only the well-separated band
    determined = gap > 1e-6
    assert (gap[~determined] < 1e-12).all() and (~determined).sum() < 10
    assert dots[determined].min() >= 1 - 1e-5, dots[determined].min()
    # outward from the centroid on a sphere: along the radius
    radial = (pts - pts.mean(0)) / np.linalg.norm(pts - pts.mean(0), axis=1, keepdims=True)
    assert ((got[:6000] * radial).sum(1) > 0.9).mean() > 0.99


@pytest.mark.parametrize("cls", VARIANTS)
def test_icp_fused_matches_jax(body, cls):
    true_T = _translation(0.01, 0.005, -0.008) @ _rotation_y(0.03)
    js, jr, ps, pr = _clouds(_moved(body, true_T), body.astype(np.float32))
    T_jax = _align(getattr(jfine, cls), js, jr)
    T_port = _align(getattr(fine, cls), ps, pr)
    _recovers(T_jax, true_T)
    _recovers(T_port, true_T)
    _agree(T_jax, T_port)


def test_icp_grid_matches_jax(body):
    """One _icp_fused through the column grid on both sides: the port's
    plain kernel 5 on CPU tensors, JAX's Pallas kernel in interpret mode,
    with the grid nn_grid_params picks for the pair."""
    true_T = _translation(0.01, 0.005, -0.008) @ _rotation_y(0.03)
    src = _moved(body, true_T)[:, :3]
    ref = body[:, :3].astype(np.float32)
    n, cap = len(ref), 4096
    S = np.zeros((cap, 3), np.float32)
    R = np.zeros((cap, 3), np.float32)
    S[:n], R[:n] = src, ref
    params = nn_grid_params(src, ref, 0.05)
    assert params is not None
    perm, gy, gz, cap_r, cap_q, origin = params
    grid = (perm, gy, gz, cap_r, cap_q)
    z = np.zeros((cap, 3), np.float32)
    T_jax = np.asarray(jfine._icp_fused(
        jnp.asarray(S), jnp.int32(n), jnp.asarray(R), jnp.int32(n), jnp.float32(0.05), jnp.float32(1e-6),
        jnp.asarray(z), jnp.asarray(z), jnp.float32(1e-3), jnp.asarray(origin),
        variant="p2point", max_iters=30, grid=grid, grid_interpret=True), np.float64)
    n_i32 = torch.tensor(n, dtype=torch.int32)
    T_port = fine._icp_fused(
        torch.from_numpy(S), n_i32, torch.from_numpy(R), n_i32, 0.05, 1e-6,
        torch.zeros(cap, 3), torch.zeros(cap, 3), 1e-3, origin,
        variant="p2point", max_iters=30, grid=grid).numpy().astype(np.float64)
    _recovers(T_jax, true_T)
    _recovers(T_port, true_T)
    _agree(T_jax, T_port)


@pytest.mark.parametrize("cls", [VARIANTS[2]])
def test_host_loop_matches_fused(body, cls):
    """The per-iteration host loop (a callback is set) lands on the fused
    loop's pose, as in the JAX package."""
    true_T = _translation(0.008, -0.004, 0.006) @ _rotation_y(-0.025)
    _, _, ps, pr = _clouds(_moved(body, true_T), body.astype(np.float32))
    errs = []
    T_host = _align(getattr(fine, cls), ps, pr, callback=lambda it, err: errs.append(err))
    T_fused = _align(getattr(fine, cls), ps, pr)
    assert len(errs) >= 2 and errs[-1] < errs[0]
    _agree(T_host, T_fused)
    _recovers(T_host, true_T)


def test_kernel_not_launched_on_cpu(body):
    """CPU clouds never reach kernel 5: the analyzers and aligners take the
    two-scale search there, as the JAX package does on the CPU."""
    before = nn_select.launches
    _, _, ps, pr = _clouds(_moved(body, _translation(0.004, 0, 0)), body.astype(np.float32))
    _align(fine.RegistrationComputer_ICP_Point2Point, ps, pr)
    an = analyze.RegistrationAnalyzerSymmetric()
    an.set_source_pointcloud(ps)
    an.set_reference_pointcloud(pr)
    an.run()
    assert nn_select.launches == before
