"""Software point renderer: cloud -> RGB image (numpy, vectorized).

The port of cwipc_util_tpu/io/render.py, copied unchanged: the z-buffer
stays a numpy splat on the host.  Among points that land on one pixel in
one pass, numpy's fancy assignment lets the last write win; a device
splat (``index_put_``) has no defined winner among duplicates on CUDA, so
the image and the depth would not be those of the JAX package.

The reference renders with immediate-mode OpenGL (reference:
src/cwipc_window.cpp:74-134, src/window_util.cpp:61-149).  This renderer
produces the same kind of orbit-camera view as a numpy z-buffered point
splat, usable headless (tests, PNG snapshots, cv2 windows) — no GL context
required.  It is also the camera model for the coarse-registration
render-to-image path (registration/coarse.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


class OrbitCamera:
    """Simple orbit camera: azimuth/elevation/distance around a center."""

    def __init__(
        self,
        center: Tuple[float, float, float] = (0.0, 1.0, 0.0),
        distance: float = 3.0,
        azimuth: float = 0.0,
        elevation: float = 0.0,
        fov_deg: float = 60.0,
    ):
        self.center = np.asarray(center, np.float64)
        self.distance = distance
        self.azimuth = azimuth
        self.elevation = elevation
        self.fov_deg = fov_deg
        self._mouse_x = 0.0
        self._mouse_y = 0.0

    # Mouse-orbit protocol, matching the reference viewer's feel
    # (reference: src/cwipc_window.cpp:303-328 — left-drag dx/100 orbits,
    # right-drag dy/100 raises/lowers the eye, scroll dy/10 zooms).
    # Pure methods so the orbit math is testable without a window.
    def on_mouse_move(self, x: float, y: float, left: bool, right: bool) -> None:
        dx = x - self._mouse_x
        dy = y - self._mouse_y
        if left:
            self.azimuth += dx / 100.0
            self.elevation = float(
                np.clip(self.elevation + dy / 100.0, -1.55, 1.55)
            )
        if right:
            self.center = self.center + np.array([0.0, dy / 100.0, 0.0])
        self._mouse_x = x
        self._mouse_y = y

    def on_mouse_scroll(self, deltay: float) -> None:
        self.distance = max(0.1, self.distance + deltay / 10.0)

    def view_matrix(self) -> np.ndarray:
        ca, sa = math.cos(self.azimuth), math.sin(self.azimuth)
        ce, se = math.cos(self.elevation), math.sin(self.elevation)
        # camera position on the orbit sphere
        eye = self.center + self.distance * np.array([sa * ce, se, ca * ce])
        fwd = self.center - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        nr = np.linalg.norm(right)
        if nr < 1e-9:
            right = np.array([1.0, 0.0, 0.0])
        else:
            right /= nr
        up = np.cross(right, fwd)
        m = np.eye(4)
        m[0, :3] = right
        m[1, :3] = up
        m[2, :3] = -fwd
        m[:3, 3] = -m[:3, :3] @ eye
        return m


def render_points(
    xyz: np.ndarray,
    rgb: np.ndarray,
    width: int = 640,
    height: int = 480,
    camera: Optional[OrbitCamera] = None,
    point_size: int = 1,
    background: Tuple[int, int, int] = (0, 0, 0),
    return_depth: bool = False,
):
    """Z-buffered point splat. xyz [N,3] float, rgb [N,3] uint8.

    Returns image [H,W,3] uint8 (and linear depth [H,W] float32 with
    return_depth, 0 where empty).
    """
    if camera is None:
        camera = OrbitCamera()
    img = np.empty((height, width, 3), np.uint8)
    img[:] = background
    depth_img = np.zeros((height, width), np.float32)
    if xyz.shape[0] == 0:
        return (img, depth_img) if return_depth else img

    view = camera.view_matrix()
    cam_pts = xyz @ view[:3, :3].T + view[:3, 3]
    z = -cam_pts[:, 2]  # positive depth in front of camera
    in_front = z > 1e-6
    cam_pts = cam_pts[in_front]
    z = z[in_front]
    rgb = rgb[in_front]

    f = 0.5 * height / math.tan(math.radians(camera.fov_deg) / 2)
    u = (cam_pts[:, 0] / z) * f + width / 2
    v = -(cam_pts[:, 1] / z) * f + height / 2
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    ok = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    ui, vi, z, rgb = ui[ok], vi[ok], z[ok], rgb[ok]
    if ui.size == 0:
        return (img, depth_img) if return_depth else img

    # z-buffer: sort far-to-near, later (nearer) writes win within a pass;
    # across splat passes each write is depth-tested against the buffer so
    # a far point's splat wing cannot cover a near point's center
    order = np.argsort(-z, kind="stable")
    ui, vi, z, rgb = ui[order], vi[order], z[order], rgb[order]
    r = max(0, point_size // 2)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            uu = ui + dx
            vv = vi + dy
            inb = (uu >= 0) & (uu < width) & (vv >= 0) & (vv < height)
            uu, vv, zz, cc = uu[inb], vv[inb], z[inb], rgb[inb]
            cur = depth_img[vv, uu]
            win = (cur == 0) | (zz < cur)
            img[vv[win], uu[win]] = cc[win]
            depth_img[vv[win], uu[win]] = zz[win]
    return (img, depth_img) if return_depth else img


# ---------------------------------------------------------------------------
# Skeleton overlay (the viewer's k4abt skeleton rendering,
# reference: src/cwipc_window.cpp:136-238)
# ---------------------------------------------------------------------------

# The azure-kinect body-tracking joint hierarchy: (child, parent) pairs over
# the standard 32-joint set (pelvis=0 root).
K4ABT_BONES = [
    (1, 0), (2, 1), (3, 2), (26, 3),            # spine + neck + head
    (4, 2), (5, 4), (6, 5), (7, 6), (8, 7), (9, 8), (10, 7),   # left arm/hand
    (11, 2), (12, 11), (13, 12), (14, 13), (15, 14), (16, 15), (17, 14),  # right arm/hand
    (18, 0), (19, 18), (20, 19), (21, 20),      # left leg
    (22, 0), (23, 22), (24, 23), (25, 24),      # right leg
    (27, 26), (28, 26), (29, 26), (30, 26), (31, 26),  # face points
]


def fuse_skeletons(collections, n_joints: int = 32):
    """Merge per-camera skeleton observations by per-joint confidence
    (reference: cwipc_window.cpp skeleton fusion): for each tracked BODY
    (skeleton index) and each joint, keep the observation with the highest
    confidence.  Fusing across skeleton indices would weld two people's
    joints into one chimera body.

    `collections` is a list of (n_skeletons, n_joints, joints) tuples as
    returned by core.pointcloud.parse_skeleton_collection.  Returns a list
    of per-body joint lists (each of length n_joints, entries may be None).
    """
    n_bodies = max((n_s for n_s, _n_j, _j in collections), default=0)
    bodies = [[None] * n_joints for _ in range(n_bodies)]
    for n_s, n_j, joints in collections:
        for s in range(n_s):
            best = bodies[s]
            for j in range(min(n_j, n_joints)):
                joint = joints[s * n_j + j]
                if best[j] is None or joint.confidence > best[j].confidence:
                    best[j] = joint
    return bodies


def draw_line(img: np.ndarray, p0, p1, color=(255, 255, 0)) -> None:
    """Rasterize a 2D line segment by dense sampling (numpy, no cv2 needed)."""
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    us = np.linspace(p0[0], p1[0], n).round().astype(int)
    vs = np.linspace(p0[1], p1[1], n).round().astype(int)
    ok = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
    img[vs[ok], us[ok]] = color


def render_skeleton_overlay(
    img: np.ndarray,
    joints,
    camera: OrbitCamera,
    min_confidence: int = 1,
    joint_color=(255, 0, 255),
    bone_color=(255, 255, 0),
) -> None:
    """Project fused joints with the same camera model as render_points and
    draw bones + joints onto an existing image, in place."""
    h, w = img.shape[:2]
    view = camera.view_matrix()
    f = 0.5 * h / math.tan(math.radians(camera.fov_deg) / 2)

    def project(joint):
        if joint is None or joint.confidence < min_confidence:
            return None
        p = np.array([joint.x, joint.y, joint.z, 1.0])
        cam_p = view @ p
        z = -cam_p[2]
        if z <= 1e-6:
            return None
        u = cam_p[0] / z * f + w / 2
        v = -cam_p[1] / z * f + h / 2
        return (u, v)

    pts2d = [project(j) for j in joints]
    for child, parent in K4ABT_BONES:
        if child < len(pts2d) and parent < len(pts2d):
            a, b = pts2d[child], pts2d[parent]
            if a is not None and b is not None:
                draw_line(img, a, b, bone_color)
    for p in pts2d:
        if p is None:
            continue
        ui, vi = int(round(p[0])), int(round(p[1]))
        if 1 <= ui < w - 1 and 1 <= vi < h - 1:
            img[vi - 1 : vi + 2, ui - 1 : ui + 2] = joint_color
