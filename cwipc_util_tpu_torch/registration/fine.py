"""Pairwise fine alignment: the ICP family on the cloud's device.

The port of cwipc_util_tpu/registration/fine.py (reference:
python/cwipc/registration/fine.py, built on Open3D there):

* RegistrationComputer -- base class with the auto-correspondence
  heuristic (half the centroid distance, reference fine.py:53-62);
* point-to-point ICP -- closed-form Kabsch/SVD update;
* point-to-plane ICP -- reference normals from registration/normals.py,
  a 6x6 linearized solve per iteration;
* generalized (plane-to-plane) ICP, the default -- disc covariances
  C = I - (1-eps) n n^T on both clouds, correspondences weighted by
  M_i = (C_ref + R C_src R^T)^-1, four Gauss-Newton steps per iteration.

:func:`_icp_fused` runs the whole loop on the clouds' device.  Its nearest
neighbours come from the column grid (kernel 5, ops/knn.py) when a grid is
given -- on CUDA, ``run`` asks ``nn_grid_params`` for one -- and from the
two-scale search otherwise.  The host loop in ``run`` serves a
``per_iteration_callback``.  The JAX module's CWIPC_FUSED_ICP,
CWIPC_GRID_NN and CWIPC_GRID_NN_MIN switches are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.buffers import buffer_from_arrays
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..ops.knn import grid_searcher, nn_grid_params, nn_search, two_scale_searcher
from ..ops.outliers import _full_f32_matmul
from .abstract import AlignmentAlgorithm, RegistrationTransformation
from .util import BaseAlgorithm, cwipc_transform, transformation_identity

DEFAULT_MAX_ITERATIONS = 30
DEFAULT_RELATIVE_TOLERANCE = 1e-6


def _small_rotation_t(x: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation from small-angle parameters ([3] f32)."""
    theta = torch.sqrt((x * x).sum())
    k = x / torch.clamp_min(theta, 1e-20)
    z = torch.zeros((), dtype=x.dtype, device=x.device)
    K = torch.stack([
        torch.stack([z, -k[2], k[1]]),
        torch.stack([k[2], z, -k[0]]),
        torch.stack([-k[1], k[0], z]),
    ])
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta < 1e-12, eye, R)


def _delta_from_x(x: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=x.dtype, device=x.device)
    T[:3, :3] = _small_rotation_t(x[:3])
    T[:3, 3] = x[3:6]
    return T


@_full_f32_matmul()
def _icp_fused(src0, src_count, ref_xyz, ref_count, corr, tol, ref_normals, src_normals, gicp_eps,
               grid_vmin=None, *, variant: str, max_iters: int, grid=None):
    """The ICP loop on the clouds' device; returns the 4x4 f32 pose.

    ``grid`` = (perm, gy, gz, cap_r, cap_q) from ``nn_grid_params`` with its
    origin ``grid_vmin`` selects the column-grid NN (kernel 5 on CUDA, its
    plain version on the CPU) with the exact brute-force fixup; without it
    the two-scale search runs.  Break rules as in the JAX module: stop with
    the pose unchanged when fewer than 3 matches remain; stop after applying
    the step when the rmse stabilises within ``tol``.  The loop reads its
    stop flag on the host after each iteration.  Every coordinate and pose
    product runs in full f32 (the JAX module's Precision.HIGHEST)."""
    dev = src0.device
    f32 = torch.float32
    cap = src0.shape[0]
    rcap = ref_xyz.shape[0]
    row = torch.arange(cap, dtype=torch.int32, device=dev)
    I3 = torch.eye(3, dtype=f32, device=dev)
    I6 = torch.eye(6, dtype=f32, device=dev)
    eps = float(gicp_eps)

    def delta_p2point(src, dst, w, m):
        wn = torch.clamp_min(m, 1.0)
        cs = (src * w[:, None]).sum(0) / wn
        cd = (dst * w[:, None]).sum(0) / wn
        H = ((src - cs) * w[:, None]).T @ (dst - cd)
        U, _s, Vt = torch.linalg.svd(H)
        d = torch.sign(torch.linalg.det(Vt.T @ U.T))
        D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
        R = (Vt.T @ D) @ U.T
        T4 = torch.eye(4, dtype=f32, device=dev)
        T4[:3, :3] = R
        T4[:3, 3] = cd - R @ cs
        return T4

    def delta_p2plane(src, dst, idx_c, w):
        n = ref_normals[idx_c]
        c = torch.linalg.cross(src, n, dim=1)
        A = torch.cat([c, n], dim=1)  # [cap, 6]
        b = ((dst - src) * n).sum(1)
        Aw = A * w[:, None]
        G = Aw.T @ A
        g = Aw.T @ b
        # a tiny Tikhonov term stands in for lstsq's min-norm behaviour on
        # (near-)degenerate scenes; well-conditioned solves are unchanged
        G = G + I6 * (1e-8 * torch.clamp_min(torch.trace(G) / 6.0, 1.0))
        return _delta_from_x(torch.linalg.solve(G, g))

    def disc(nrm):
        nn = nrm[:, :, None] * nrm[:, None, :]
        okn = (nrm * nrm).sum(1) > 0.5
        return torch.where(okn[:, None, None], I3[None] - (1.0 - eps) * nn, I3[None])

    def delta_gicp(src, dst, idx_c, w, T):
        n_d = ref_normals[idx_c]
        n_s = src_normals @ T[:3, :3].T
        # closed-form batched 3x3 inverse of C_ref + R C_src R^T, weighted
        C = disc(n_d) + disc(n_s)
        a, b, c = C[:, 0, 0], C[:, 0, 1], C[:, 0, 2]
        d, e, f = C[:, 1, 0], C[:, 1, 1], C[:, 1, 2]
        g, h, i = C[:, 2, 0], C[:, 2, 1], C[:, 2, 2]
        co00 = e * i - f * h
        co01 = c * h - b * i
        co02 = b * f - c * e
        co10 = f * g - d * i
        co11 = a * i - c * g
        co12 = c * d - a * f
        co20 = d * h - e * g
        co21 = b * g - a * h
        co22 = a * e - b * d
        det = a * co00 + b * co10 + c * co20
        inv_det = w / torch.where(det.abs() > 1e-30, det, 1.0)
        M = torch.stack([
            torch.stack([co00, co01, co02], dim=1),
            torch.stack([co10, co11, co12], dim=1),
            torch.stack([co20, co21, co22], dim=1),
        ], dim=1) * inv_det[:, None, None]

        Td = torch.eye(4, dtype=f32, device=dev)
        zero = torch.zeros((cap,), dtype=f32, device=dev)
        eye_j = I3.expand(cap, 3, 3)
        for _ in range(4):
            cur = src @ Td[:3, :3].T + Td[:3, 3]
            r = dst - cur
            S = torch.stack([
                torch.stack([zero, -cur[:, 2], cur[:, 1]], dim=1),
                torch.stack([cur[:, 2], zero, -cur[:, 0]], dim=1),
                torch.stack([-cur[:, 1], cur[:, 0], zero], dim=1),
            ], dim=1)  # [cap, 3, 3]
            J = torch.cat([-S, eye_j], dim=2)  # [cap, 3, 6]
            JtM = torch.einsum("mij,mik->mjk", J, M)  # [cap, 6, 3]
            A6 = torch.einsum("mji,mjk->ik", JtM.transpose(1, 2), J)
            b6 = torch.einsum("mjk,mk->j", JtM, r)
            A6 = A6 + I6 * (1e-9 * torch.clamp_min(torch.trace(A6) / 6.0, 1.0))
            Td = _delta_from_x(torch.linalg.solve(A6, b6)) @ Td
        return Td

    svalid = row < src_count
    if grid is not None:
        g_perm, g_gy, g_gz, g_cap_r, g_cap_q = grid
        nn_query = grid_searcher(ref_xyz, ref_count, corr, grid_vmin, perm=g_perm, gy=g_gy, gz=g_gz,
                                 cap_r=g_cap_r, cap_q=g_cap_q)
    else:
        nn_query = two_scale_searcher(ref_xyz, ref_count, corr)

    T = torch.eye(4, dtype=f32, device=dev)
    prev_err = torch.tensor(torch.inf, dtype=f32, device=dev)
    for _ in range(max_iters):
        src = src0 @ T[:3, :3].T + T[:3, 3]
        dist, idx = nn_query(src, src_count)
        valid = torch.isfinite(dist) & svalid
        w = valid.to(f32)
        m = w.sum()
        err = torch.sqrt(torch.where(valid, dist * dist, 0.0).sum() / torch.clamp_min(m, 1.0))
        idx_c = torch.clamp(idx, 0, rcap - 1).long()
        dst = ref_xyz[idx_c]
        if variant == "p2point":
            delta = delta_p2point(src, dst, w, m)
        elif variant == "p2plane":
            delta = delta_p2plane(src, dst, idx_c, w)
        else:
            delta = delta_gicp(src, dst, idx_c, w, T)
        too_few = m < 3.0
        delta = torch.where(too_few, torch.eye(4, dtype=f32, device=dev), delta)
        T = delta @ T
        conv = (prev_err - err).abs() < tol * torch.clamp_min(prev_err, 1e-12)
        prev_err = err
        if bool(too_few | conv):  # host read: the loop's stop flag
            break
    return T


class RegistrationComputer(BaseAlgorithm, AlignmentAlgorithm):
    """Base class for the pairwise aligners."""

    max_iterations = DEFAULT_MAX_ITERATIONS
    _fused_variant: Optional[str] = None  # set by subclasses that fuse

    def __init__(self) -> None:
        BaseAlgorithm.__init__(self)
        self.correspondence: Optional[float] = None
        self._transformation = transformation_identity()
        self._result_pc: Optional[cwipc_pointcloud_wrapper] = None
        self.per_iteration_callback: Optional[Callable[[int, float], None]] = None

    def set_correspondence(self, correspondence: float) -> None:
        self.correspondence = correspondence

    def _auto_correspondence(self) -> float:
        """Half the distance between the two cloud centroids, with a floor
        (reference heuristic, fine.py:53-62)."""
        a = self.get_filtered_source_pointcloud().get_numpy_matrix(onlyGeometry=True)
        b = self.get_filtered_reference_pointcloud().get_numpy_matrix(onlyGeometry=True)
        if a.shape[0] == 0 or b.shape[0] == 0:
            return 0.1
        d = float(np.linalg.norm(a.mean(axis=0) - b.mean(axis=0)))
        return max(d / 2, 0.02)

    # -- results ---------------------------------------------------------------

    def get_result_transformation(self) -> RegistrationTransformation:
        return self._transformation

    def get_result_pointcloud(self) -> cwipc_pointcloud_wrapper:
        if self._result_pc is None:
            self._result_pc = cwipc_transform(self.get_source_pointcloud(), self._transformation)
        return self._result_pc

    def get_result_pointcloud_full(self) -> cwipc_pointcloud_wrapper:
        from .. import cwipc_join

        moved = self.get_result_pointcloud()
        return cwipc_join(moved, self.get_reference_pointcloud())

    # -- the ICP loop ------------------------------------------------------------

    def _correspondences(self, src_xyz: np.ndarray, corr: float):
        """NN matches src -> ref through the two-scale search (the JAX
        module's host loop does the same)."""
        n = src_xyz.shape[0]
        z = np.zeros(n, np.uint32)
        rbuf = self._ref_buf
        sbuf = buffer_from_arrays(src_xyz.astype(np.float32), z, n, device=rbuf.device)
        dist, idx = nn_search(sbuf.xyz, sbuf.count, rbuf.xyz, rbuf.count, corr)
        dist = dist.cpu().numpy()[:n]
        idx = idx.cpu().numpy()[:n]
        return np.isfinite(dist), idx, dist

    def _solve_step(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        dst_idx: np.ndarray,
        src_idx: np.ndarray,
        T: np.ndarray,
    ) -> np.ndarray:
        raise NotImplementedError

    def run(self) -> bool:
        src_pc = self.get_filtered_source_pointcloud()
        ref_pc = self.get_filtered_reference_pointcloud()
        if src_pc.count() == 0 or ref_pc.count() == 0:
            return False
        corr = self.correspondence if self.correspondence else self._auto_correspondence()

        self._ref_buf = ref_pc._access_buffer()
        self._ref_xyz = ref_pc.get_numpy_matrix(onlyGeometry=True).astype(np.float64)
        self._prepare_reference()

        if self._fused_variant is not None and self.per_iteration_callback is None:
            sbuf = src_pc._access_buffer()
            rbuf = self._ref_buf
            dev = rbuf.device
            refn = np.zeros((rbuf.capacity, 3), np.float32)
            srcn = np.zeros((sbuf.capacity, 3), np.float32)
            if self._fused_variant in ("p2plane", "gicp"):
                refn[: self._ref_normals.shape[0]] = self._ref_normals
            if self._fused_variant == "gicp":
                srcn[: self._src_normals.shape[0]] = self._src_normals
            # on CUDA the column grid (kernel 5) runs inside the loop when
            # the scene fits one; on the CPU the two-scale search, as the
            # JAX package takes there
            grid, grid_vmin = None, None
            if dev.type == "cuda":
                params = nn_grid_params(
                    src_pc.get_numpy_matrix(onlyGeometry=True).astype(np.float32),
                    self._ref_xyz.astype(np.float32), float(corr),
                )
                if params is not None:
                    perm_, gy_, gz_, cr_, cq_, grid_vmin = params
                    grid = (perm_, gy_, gz_, cr_, cq_)
            T_dev = _icp_fused(
                sbuf.xyz, sbuf.count, rbuf.xyz, rbuf.count,
                float(np.float32(corr)), float(np.float32(DEFAULT_RELATIVE_TOLERANCE)),
                torch.from_numpy(refn).to(dev), torch.from_numpy(srcn).to(dev),
                float(np.float32(getattr(self, "gicp_epsilon", 1e-3))),
                grid_vmin,
                variant=self._fused_variant,
                max_iters=self.max_iterations,
                grid=grid,
            )
            self._transformation = T_dev.cpu().numpy().astype(np.float64)
            self._result_pc = None
            return True

        src0 = src_pc.get_numpy_matrix(onlyGeometry=True).astype(np.float64)
        T = np.identity(4)
        prev_err = np.inf
        for it in range(self.max_iterations):
            src = src0 @ T[:3, :3].T + T[:3, 3]
            ok, idx, dist = self._correspondences(src, corr)
            if ok.sum() < 3:
                break
            err = float(np.sqrt((dist[ok] ** 2).mean()))
            if self.per_iteration_callback:
                self.per_iteration_callback(it, err)
            delta = self._solve_step(
                src[ok], self._ref_xyz[idx[ok]], idx[ok], np.nonzero(ok)[0], T
            )
            T = delta @ T
            if abs(prev_err - err) < DEFAULT_RELATIVE_TOLERANCE * max(prev_err, 1e-12):
                break
            prev_err = err
        self._transformation = T
        self._result_pc = None
        return True

    def _prepare_reference(self) -> None:
        pass


def _kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Closed-form rigid transform minimizing |R src + t - dst|^2."""
    cs = src.mean(axis=0)
    cd = dst.mean(axis=0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = cd - R @ cs
    T = np.identity(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class RegistrationComputer_ICP_Point2Point(RegistrationComputer):
    """Point-to-point ICP (reference: fine.py:81-133)."""

    _fused_variant = "p2point"

    def _solve_step(self, src, dst, dst_idx, src_idx, T):
        return _kabsch(src, dst)


class RegistrationComputer_Tensor_ICP_Point2Point(RegistrationComputer_ICP_Point2Point):
    """Alias of the point-to-point aligner; the reference's "tensor"
    variant (fine.py:135-210) exists for its per-iteration callback, which
    the base class supports directly here."""


class RegistrationComputer_ICP_Point2Plane(RegistrationComputer):
    """Point-to-plane ICP: minimizes sum(((R s + t - d) . n_d)^2) with
    normals estimated on the device (reference: fine.py:212-288, normal
    radius 0.02 / 30 neighbours, outward orientation)."""

    normal_radius = 0.02  # reference default; raised to cover sparse clouds
    _fused_variant = "p2plane"

    def _effective_normal_radius(self, pc: cwipc_pointcloud_wrapper) -> float:
        """The neighbourhood must span a few points: max(configured radius,
        3x the cloud's point spacing)."""
        spacing = pc.cellsize()
        if spacing <= 0:
            m = pc.get_numpy_matrix(onlyGeometry=True)
            if m.shape[0] > 1:
                sample = m[:: max(1, m.shape[0] // 256)][:256]
                d2 = ((sample[:, None, :] - sample[None, :, :]) ** 2).sum(-1)
                np.fill_diagonal(d2, np.inf)
                spacing = float(np.median(np.sqrt(d2.min(axis=1))))
            else:
                spacing = 0.01
        return max(self.normal_radius, spacing * 3)

    def _normals(self, pc: cwipc_pointcloud_wrapper) -> np.ndarray:
        from .normals import estimate_normals

        radius = float(np.float32(self._effective_normal_radius(pc)))
        normals = estimate_normals(pc._access_buffer(), radius).cpu().numpy()
        return normals[: pc.count()].astype(np.float64)

    def _prepare_reference(self) -> None:
        self._ref_normals = self._normals(self.get_filtered_reference_pointcloud())

    def _solve_step(self, src, dst, dst_idx, src_idx, T):
        n = self._ref_normals[dst_idx]
        # linearized rotation: x = [rx, ry, rz, tx, ty, tz]
        c = np.cross(src, n)
        A = np.concatenate([c, n], axis=1)  # [m, 6]
        b = np.sum((dst - src) * n, axis=1)  # [m]
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
        rx, ry, rz, tx, ty, tz = x
        T = np.identity(4)
        T[:3, :3] = _small_rotation(rx, ry, rz)
        T[:3, 3] = (tx, ty, tz)
        return T


def _small_rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    """Proper rotation from small-angle parameters (via Rodrigues)."""
    theta = float(np.sqrt(rx * rx + ry * ry + rz * rz))
    if theta < 1e-12:
        return np.identity(3)
    k = np.array([rx, ry, rz]) / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.identity(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class RegistrationComputer_ICP_Generalized(RegistrationComputer_ICP_Point2Plane):
    """Generalized (plane-to-plane) ICP, the reference's default fine
    aligner (reference: fine.py:290-317, o3d GeneralizedICP there, after
    Segal et al.): every point carries a disc covariance
    C = I - (1 - eps) n n^T (eps along the normal, 1 in-plane) from its
    estimated normal; each correspondence is weighted by the Mahalanobis
    matrix M_i = (C_ref_i + R C_src_i R^T)^-1 and damped Gauss-Newton steps
    solve the 6x6 normal equations."""

    gicp_epsilon = 1e-3  # Segal's disc regularization along the normal
    _fused_variant = "gicp"

    def _prepare_reference(self) -> None:
        super()._prepare_reference()
        self._src_normals = self._normals(self.get_filtered_source_pointcloud())

    def _solve_step(self, src, dst, dst_idx, src_idx, T):
        eps = self.gicp_epsilon
        n_d = self._ref_normals[dst_idx]  # [m, 3]
        # source normals rotated into the current pose
        n_s = self._src_normals[src_idx] @ T[:3, :3].T

        def disc_cov(n):
            # I - (1-eps) n n^T; unnormalized/zero normals fall back to I
            nn = n[:, :, None] * n[:, None, :]
            ok = np.sum(n * n, axis=1) > 0.5
            return np.where(
                ok[:, None, None], np.identity(3)[None] - (1.0 - eps) * nn,
                np.identity(3)[None],
            )

        M = np.linalg.inv(disc_cov(n_d) + disc_cov(n_s))
        # Gauss-Newton on the Mahalanobis cost with FIXED matches and
        # weights, iterated a few times: one linearized step underestimates
        # the motion under the disc model's strong anisotropy
        m = src.shape[0]
        Td = np.identity(4)
        cur = src
        for _ in range(4):
            r = dst - cur
            S = np.zeros((m, 3, 3))
            S[:, 0, 1] = -cur[:, 2]
            S[:, 0, 2] = cur[:, 1]
            S[:, 1, 0] = cur[:, 2]
            S[:, 1, 2] = -cur[:, 0]
            S[:, 2, 0] = -cur[:, 1]
            S[:, 2, 1] = cur[:, 0]
            J = np.concatenate([-S, np.broadcast_to(np.identity(3), (m, 3, 3))], axis=2)  # [m,3,6]
            JtM = np.einsum("mij,mik->mjk", J, M)  # [m, 6, 3]
            A = np.einsum("mji,mjk->ik", JtM.transpose(0, 2, 1), J)  # 6x6
            b = np.einsum("mjk,mk->j", JtM, r)
            # light Levenberg damping keeps degenerate scenes solvable
            A = A + np.identity(6) * (1e-9 * max(np.trace(A) / 6.0, 1.0))
            x = np.linalg.solve(A, b)
            rx, ry, rz, tx, ty, tz = x
            Ts = np.identity(4)
            Ts[:3, :3] = _small_rotation(rx, ry, rz)
            Ts[:3, 3] = (tx, ty, tz)
            Td = Ts @ Td
            cur = src @ Td[:3, :3].T + Td[:3, 3]
            if np.abs(x).max() < 1e-9:
                break
        return Td


DEFAULT_FINE_ALIGNMENT_ALGORITHM = RegistrationComputer_ICP_Generalized

# Reference-parity name (reference: registration/fine.py:16,321-325): the
# reference types ICP outcomes as open3d's RegistrationResult.
RegistrationResult = Any

ALL_FINE_ALIGNMENT_ALGORITHMS = [
    RegistrationComputer_ICP_Point2Point,
    RegistrationComputer_ICP_Point2Plane,
    RegistrationComputer_ICP_Generalized,
]

HELP_FINE_ALIGNMENT_ALGORITHMS = """
Fine alignment algorithms:
    RegistrationComputer_ICP_Point2Point   classic point-to-point ICP
    RegistrationComputer_ICP_Point2Plane   point-to-plane ICP
    RegistrationComputer_ICP_Generalized   plane-to-plane GICP (default)
"""
