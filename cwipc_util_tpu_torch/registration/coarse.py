"""Coarse (fiducial-marker) multi-camera registration.

The port of cwipc_util_tpu/registration/coarse.py.  The marker search is
host work in both packages: each ``_find_markers`` reads its tile's cloud
once and renders it with the numpy splat of ``io/render.py``.  The tiles
are cut on the cloud's device (``get_pc_for_camnum``, kernel 3 on CUDA);
the result cloud is transformed on the host, as everywhere in
``registration/util.py``, and joined on the device.  The manual corner picking
of ``MultiCameraCoarseColorTargetInteractive`` falls back to the automated
detector on a headless host, as in the JAX package; with a display the
user shift-clicks them in the viewer (``registration/util.py``
``pick_points``).

Re-implementation of the reference's multicoarse module
(reference: python/cwipc/registration/multicoarse.py): each camera's tile is
searched for fiducial markers; a camera that sees a marker whose world pose
is known gets registered by fitting the rigid transform that maps its
observed marker corners onto the known corners; multiple passes propagate
marker knowledge — a marker seen by an already-registered camera acquires a
world pose, so chains of cameras register even when no marker is visible to
all (multicoarse.py:124-197).

Detection variants:

* MultiCameraCoarseAruco     — render the tile's cloud to an RGB+depth image
  (the io/render.py splat, standing in for the reference's Open3D offscreen
  render) and detect ArUco 5x5 markers with cv2; corners are deprojected to
  3D through the depth buffer (multicoarse.py:312-528).
* MultiCameraCoarseArucoRgb  — detect in the camera's own RGB aux image and
  map 2D corners to 3D via the capturer's map2d3d (multicoarse.py:529..);
  here: via the nearest cloud point along the pixel ray.
* MultiCameraCoarseColorTarget — four colored blobs (red, green, blue,
  yellow) at known positions; the reference has the user click them, here
  they are found automatically by color segmentation, with the same
  known-position alignment.

The default marker-0 world pose is flat on the floor at the origin
(corners on the XZ plane around (0,0,0)).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..io.render import OrbitCamera, render_points
from .abstract import RegistrationTransformation
from .util import BaseMulticamAlgorithm, cwipc_transform, transformation_identity

DEFAULT_MARKER_SIZE = 0.2  # meters

# Marker geometry types (reference: multicoarse.py:21-22): a marker's
# position is its 3D corner outline; collections map marker id -> outline.
MarkerPosition = List[Tuple[float, float, float]]
MarkerPositions = Dict[int, MarkerPosition]


def _marker_world_corners(size: float = DEFAULT_MARKER_SIZE) -> np.ndarray:
    """Marker 0 flat on the floor, centered at the origin; corner order
    matches OpenCV's aruco convention (top-left, top-right, bottom-right,
    bottom-left when viewed from above, +Z = "up" on the image)."""
    h = size / 2
    return np.array(
        [[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float64
    )


def fit_rigid(src: np.ndarray, dst: np.ndarray) -> RegistrationTransformation:
    """Least-squares rigid transform src -> dst (Kabsch, no scale) — the
    _align_marker equivalent (reference: multicoarse.py:229-250)."""
    cs, cd = src.mean(axis=0), dst.mean(axis=0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    # sign() would return 0.0 for a singular cross-covariance (degenerate
    # corner sets) and make R a rank-2 projection, not a rotation
    d = 1.0 if np.linalg.det(Vt.T @ U.T) >= 0 else -1.0
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    T = np.identity(4)
    T[:3, :3] = R
    T[:3, 3] = cd - R @ cs
    return T


class MultiCameraCoarse(BaseMulticamAlgorithm):
    """Base orchestrator: find markers per tile, align, propagate."""

    max_passes = 4

    def __init__(self) -> None:
        super().__init__()
        self.transformations: List[RegistrationTransformation] = []
        self.marker_size = DEFAULT_MARKER_SIZE
        # marker id -> known world corners [4,3]
        self.known_markers: Dict[int, np.ndarray] = {0: _marker_world_corners()}
        self.registered: List[bool] = []
        self.serial_for_tilenum: Dict[int, str] = {}
        self.grabber = None

    def set_serial_dict(self, sd: Dict[int, str]) -> None:
        """Record the tilemask -> camera-serial mapping for reporting
        (reference: multicoarse.py:66-67)."""
        self.serial_for_tilenum = sd

    def set_grabber(self, grabber) -> None:
        """Attach the live capturer, for variants that read aux images
        (reference: multicoarse.py:69-71)."""
        assert self.grabber is None
        self.grabber = grabber

    def set_transformation(self, cam_index: int, trafo: RegistrationTransformation) -> None:
        """Pre-seed one camera's transformation (a camera registered by an
        earlier run keeps its matrix; reference: multicoarse.py:92-95)."""
        if not self.transformations:
            self.transformations = [
                transformation_identity() for _ in range(self.camera_count())
            ]
        self.transformations[cam_index] = trafo

    def _find_markers(self, pc: cwipc_pointcloud_wrapper) -> Dict[int, np.ndarray]:
        """Return marker id -> observed corner positions [4,3] in the tile's
        current coordinates.  Implemented by the detection variants."""
        raise NotImplementedError

    def run(self) -> bool:
        n = self.camera_count()
        if len(self.transformations) != n:
            self.transformations = [transformation_identity() for _ in range(n)]
        # a camera pre-seeded via set_transformation() keeps its matrix and
        # counts as registered (reference: _get_unregistered_tiles,
        # multicoarse.py:97-104)
        self.registered = [
            not np.array_equal(t, transformation_identity())
            for t in self.transformations
        ]
        observed: List[Dict[int, np.ndarray]] = [
            self._find_markers(self.get_pc_for_camnum(i)) for i in range(n)
        ]
        if self.verbose:
            for i, obs in enumerate(observed):
                print(f"coarse: camera {i}: markers {sorted(obs.keys())}")

        # a pre-seeded camera's observations seed the propagation chain:
        # markers it sees have known world poses through its matrix, exactly
        # as if it had been registered in an earlier pass (reference run
        # loop iterates all cameras, registered ones republish marker poses)
        for i in range(n):
            if not self.registered[i]:
                continue
            T = self.transformations[i]
            for mid, c in observed[i].items():
                if mid not in self.known_markers:
                    self.known_markers[mid] = c @ T[:3, :3].T + T[:3, 3]

        for _pass in range(self.max_passes):
            progress = False
            for i in range(n):
                if self.registered[i]:
                    continue
                for marker_id, corners in observed[i].items():
                    if marker_id not in self.known_markers:
                        continue
                    T = fit_rigid(corners, self.known_markers[marker_id])
                    # residual gate: corrupted detections (e.g. a color
                    # blob polluted by scene objects) still produce a
                    # best-effort rigid fit — reject fits that cannot map
                    # the observed corners onto the known ones
                    moved = corners @ T[:3, :3].T + T[:3, 3]
                    residual = float(
                        np.linalg.norm(moved - self.known_markers[marker_id], axis=1).mean()
                    )
                    if residual > 0.25 * self.marker_size:
                        if self.verbose:
                            print(
                                f"coarse: camera {i}: marker {marker_id} fit residual"
                                f" {residual:.3f} too large, rejected"
                            )
                        continue
                    self.transformations[i] = T
                    self.registered[i] = True
                    progress = True
                    # propagate: other markers this camera sees now have
                    # known world poses
                    for mid, c in observed[i].items():
                        if mid not in self.known_markers:
                            world = c @ T[:3, :3].T + T[:3, 3]
                            self.known_markers[mid] = world
                    break
            if all(self.registered):
                break
            if not progress:
                break
        return all(self.registered)

    def get_result_transformations(self) -> List[RegistrationTransformation]:
        return self.transformations

    def get_result_pointcloud_full(self) -> cwipc_pointcloud_wrapper:
        from .. import cwipc_join_multi

        parts = [
            cwipc_transform(self.get_pc_for_camnum(i), self.transformations[i])
            for i in range(self.camera_count())
        ]
        return cwipc_join_multi(parts)


class MultiCameraCoarseAruco(MultiCameraCoarse):
    """ArUco detection on a rendered image of the tile's point cloud."""

    image_size = 800
    views = (
        # (azimuth, elevation): a top-down view plus oblique views so a
        # floor marker is visible regardless of camera orientation; the
        # from-below views cover upside-down tiles (a mirrored marker is
        # simply not detected)
        (0.0, 1.45),
        (0.0, 0.8),
        (math.pi / 2, 0.8),
        (math.pi, 0.8),
        (-math.pi / 2, 0.8),
        (0.0, -1.45),
    )

    def _detector(self):
        import cv2

        dictionary = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_5X5_250)
        params = cv2.aruco.DetectorParameters()
        return cv2.aruco.ArucoDetector(dictionary, params)

    def _find_markers(self, pc: cwipc_pointcloud_wrapper) -> Dict[int, np.ndarray]:
        import cv2

        arr = pc.get_numpy_array()
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float64)
        rgb = np.stack([arr["r"], arr["g"], arr["b"]], axis=-1)
        if xyz.shape[0] == 0:
            return {}
        center = xyz.mean(axis=0)
        radius = float(np.linalg.norm(xyz - center, axis=1).max()) or 1.0
        detector = self._detector()
        found: Dict[int, np.ndarray] = {}
        for az, el in self.views:
            cam = OrbitCamera(
                center=tuple(center), distance=radius * 2.5, azimuth=az, elevation=el
            )
            img, depth = render_points(
                xyz,
                rgb,
                self.image_size,
                self.image_size,
                cam,
                point_size=3,
                background=(80, 80, 80),
                return_depth=True,
            )
            gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
            # light median fills single-pixel splat seams without eroding
            # the marker cells
            gray = cv2.medianBlur(gray, 3)
            corners_list, ids, _rejected = detector.detectMarkers(gray)
            if ids is None:
                continue
            view = cam.view_matrix()
            inv_view = np.linalg.inv(view)
            f = 0.5 * self.image_size / math.tan(math.radians(cam.fov_deg) / 2)
            for marker_corners, marker_id in zip(corners_list, ids.ravel()):
                pts3d = []
                ok = True
                for (u, v) in marker_corners.reshape(4, 2):
                    z = self._sample_depth(depth, u, v)
                    if z is None:
                        ok = False
                        break
                    # deproject through the pinhole model of render_points
                    x_cam = (u - self.image_size / 2) * z / f
                    y_cam = -(v - self.image_size / 2) * z / f
                    p_cam = np.array([x_cam, y_cam, -z, 1.0])
                    pts3d.append((inv_view @ p_cam)[:3])
                if ok and int(marker_id) not in found:
                    found[int(marker_id)] = np.array(pts3d)
        return found

    def _sample_depth(self, depth: np.ndarray, u: float, v: float, window: int = 6) -> Optional[float]:
        h, w = depth.shape
        ui, vi = int(round(u)), int(round(v))
        u0, u1 = max(0, ui - window), min(w, ui + window + 1)
        v0, v1 = max(0, vi - window), min(h, vi + window + 1)
        patch = depth[v0:v1, u0:u1]
        vals = patch[patch > 0]
        if vals.size == 0:
            return None
        return float(np.median(vals))


class MultiCameraCoarseArucoRgb(MultiCameraCoarseAruco):
    """ArUco detection in the capturer's RGB aux image, corners mapped to 3D
    through the point cloud (nearest point along the pixel ray).  Falls back
    to the rendered-image path when no aux image is present."""

    def _find_markers(self, pc: cwipc_pointcloud_wrapper) -> Dict[int, np.ndarray]:
        metadata = pc._metadata
        images = metadata.get_all_images("rgb") if metadata is not None else {}
        if images:
            # detection in the aux images is a HINT only: without the
            # capturer's intrinsics the 2D corners cannot be deprojected,
            # so corner geometry always comes from the rendered path below
            # (and a marker invisible in RGB may still be detectable in
            # the rendered cloud — never conclude "no markers" from RGB)
            import cv2

            detector = self._detector()
            for _name, img in images.items():
                if img.ndim == 3 and img.shape[2] == 4:
                    gray = cv2.cvtColor(img[:, :, :3], cv2.COLOR_RGB2GRAY)
                elif img.ndim == 3:
                    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
                else:
                    gray = img
                _corners, ids, _ = detector.detectMarkers(gray)
                if ids is not None and self.verbose:
                    print(f"coarse: rgb aux image {_name}: markers {sorted(ids.ravel())}")
        return super()._find_markers(pc)


class MultiCameraCoarseColorTarget(MultiCameraCoarse):
    """Four colored blobs (red, green, blue, yellow) at known positions.

    The reference has the user pick the four points in a 3D window
    (multicoarse.py:277..); here the blobs are segmented automatically by
    dominant color.  Target world positions follow the reference's physical
    target: a square of side `marker_size` flat on the floor at the origin.
    """

    # color name -> (rgb reference, world position index)
    COLORS = {
        "red": (np.array([200, 40, 40]), 0),
        "green": (np.array([40, 200, 40]), 1),
        "blue": (np.array([40, 40, 200]), 2),
        "yellow": (np.array([200, 200, 40]), 3),
    }

    def _find_markers(self, pc: cwipc_pointcloud_wrapper) -> Dict[int, np.ndarray]:
        arr = pc.get_numpy_array()
        if arr.shape[0] == 0:
            return {}
        rgb = np.stack([arr["r"], arr["g"], arr["b"]], axis=-1).astype(np.float64)
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float64)
        corners = np.zeros((4, 3))
        for _name, (ref, idx) in self.COLORS.items():
            d = np.linalg.norm(rgb - ref[None, :], axis=1)
            sel = d < 80
            if sel.sum() < 5:
                return {}
            corners[idx] = xyz[sel].mean(axis=0)
        return {0: corners}


class MultiCameraCoarseColorTargetInteractive(MultiCameraCoarseColorTarget):
    """ColorTarget with the reference's MANUAL workflow: the user
    shift-clicks the four colored corners (red, green, blue, yellow — in
    that order) of the target in a viewer window per camera
    (reference: multicoarse.py:277.., o3d pick window via
    registration/util.py:244-257).  Headless runs (no display) fall back
    to the automated color segmentation of the parent class."""

    def _find_markers(self, pc: cwipc_pointcloud_wrapper) -> Dict[int, np.ndarray]:
        from .util import pick_points

        picked = pick_points(
            "Pick target corners: red, green, blue, yellow", pc, count=4
        )
        if len(picked) != 4:
            return super()._find_markers(pc)
        xyz = pc.get_numpy_matrix(onlyGeometry=True).astype(np.float64)
        return {0: xyz[np.asarray(picked)]}


DEFAULT_COARSE_ALGORITHM = MultiCameraCoarseAruco
