"""Registration helper functions on wrapper point clouds.

The port of cwipc_util_tpu/registration/util.py: transforms, masked tile
selection, direction/floor filters, per-tile downsample, tile census,
radius percentiles and the algorithm base classes.  Every cloud these
helpers derive stays on its input's device.

The viewer pickers (``project_point_indices``, ``pick_index_at``,
``pick_points``, ``show_pointcloud`` and the ``o3d_*`` helpers) read the
cloud to the host once and project with the numpy renderer's camera, as
the JAX package's do.  On a headless host ``pick_points`` returns no
points at once, so callers fall back to their automated detectors.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from .. import (
    cwipc_downsample,
    cwipc_from_numpy_matrix,
    cwipc_join,
    cwipc_tilefilter,
)
from ..core.buffers import PointBuffer, bucket_capacity
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..ops import compaction

RegistrationTransformation = np.ndarray  # 4x4 float64
Vector3 = np.ndarray
# Loose array aliases used in reference signatures (util.py:26-27)
Point_array_xyz = np.ndarray
Point_array_rgb = np.ndarray


def transformation_identity() -> RegistrationTransformation:
    return np.identity(4)


def transformation_invert(m: RegistrationTransformation) -> RegistrationTransformation:
    return np.linalg.inv(np.asarray(m, np.float64))


def transformation_frompython(m) -> RegistrationTransformation:
    return np.asarray(m, np.float64).reshape(4, 4)


def transformation_topython(m: RegistrationTransformation) -> List[List[float]]:
    return [list(map(float, row)) for row in np.asarray(m).reshape(4, 4)]


def transformation_is_identity(m: RegistrationTransformation, epsilon: float = 1e-6) -> bool:
    return bool(np.allclose(np.asarray(m), np.identity(4), atol=epsilon))


def transformation_compare(
    a: RegistrationTransformation, b: RegistrationTransformation
) -> Tuple[float, float]:
    """(translation distance, rotation angle in radians) between transforms."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    r = a[:3, :3] @ b[:3, :3].T
    cos_angle = (np.trace(r) - 1.0) / 2.0
    angle = float(np.arccos(np.clip(cos_angle, -1.0, 1.0)))
    return dt, angle


def transformation_get_translation(matrix: RegistrationTransformation) -> Vector3:
    """The translation column of a 4x4 transform (reference util.py:68-70)."""
    rv: Vector3 = matrix[0:3, 3]
    return rv


def _derived(m: np.ndarray, pc: cwipc_pointcloud_wrapper, cellsize: bool = True) -> cwipc_pointcloud_wrapper:
    """A new cloud from an Nx7 matrix, on ``pc``'s device, with its timestamp
    (and its cellsize unless told otherwise)."""
    new_pc = cwipc_from_numpy_matrix(m, pc.timestamp(), device=pc._device)
    if cellsize:
        new_pc._set_cellsize(pc.cellsize())
    return new_pc


def cwipc_transform(
    pc: cwipc_pointcloud_wrapper, transform: RegistrationTransformation
) -> cwipc_pointcloud_wrapper:
    """Apply a 4x4 transform to a cloud (reference: registration/util.py:295-309)."""
    m = pc.get_numpy_matrix()
    t = np.asarray(transform, np.float64).reshape(4, 4)
    m[:, 0:3] = m[:, 0:3] @ t[:3, :3].T + t[:3, 3]
    return _derived(m, pc)


def cwipc_tilefilter_masked(
    pc: cwipc_pointcloud_wrapper, mask: int
) -> cwipc_pointcloud_wrapper:
    """Select points whose tile has any of the mask bits set (AND-mask select,
    reference: registration/util.py:98-112) -- unlike cwipc_tilefilter's
    exact match.  The cut is an order-preserving compaction on the cloud's
    device (kernel 3 on CUDA) and one read of its count: the result keeps
    the capacity bucket of its own points, as a cloud built from them
    would, since the queries that take it scan every slot."""
    buf = pc._access_buffer()
    keep = (((buf.rgba >> 24) & 0xFF) & int(mask)) != 0
    out = compaction.compact(buf, keep & buf.valid_mask())
    n = int(out.count)
    cap = bucket_capacity(n)
    return cwipc_pointcloud_wrapper(PointBuffer(xyz=out.xyz[:cap], rgba=out.rgba[:cap], count=out.count),
                                    pc.timestamp(), pc.cellsize(), _count_hint=n)


def cwipc_direction_filter(
    pc: cwipc_pointcloud_wrapper,
    direction: Union[Vector3, Tuple[float, float, float]],
    threshold: float,
) -> cwipc_pointcloud_wrapper:
    """Keep points whose estimated outward normal faces ``direction``
    (reference: registration/util.py:114-144, with the Morton-window normal
    estimator of registration/normals.py)."""
    from .normals import estimate_normals

    d = np.asarray(direction, np.float64).reshape(3)
    norm = np.linalg.norm(d)
    if norm != 0:
        d = d / norm
    buf = pc._access_buffer()
    cellsize = pc.cellsize() if pc.cellsize() > 0 else 0.02
    normals = estimate_normals(buf, max(cellsize * 4, 0.02)).cpu().numpy()
    n = pc.count()
    keep = (normals[:n] @ d) >= threshold
    return _derived(pc.get_numpy_matrix()[keep], pc)


def cwipc_floor_filter(
    pc: cwipc_pointcloud_wrapper, level: float = 0.1, keep_floor: bool = False
) -> cwipc_pointcloud_wrapper:
    """Split off points near the floor (y < level); keep floor or the rest."""
    m = pc.get_numpy_matrix()
    is_floor = m[:, 1] < level
    sel = is_floor if keep_floor else ~is_floor
    return _derived(m[sel], pc)


def cwipc_randomize_floor(
    pc: cwipc_pointcloud_wrapper, level: float = 0.1
) -> cwipc_pointcloud_wrapper:
    """Randomly shuffle the tile assignment of floor points (y < level)
    (reference: registration/util.py:146-168)."""
    m = pc.get_numpy_matrix()
    is_floor = m[:, 1] < level
    floor = m[is_floor]
    rest = m[~is_floor]
    tiles = floor[:, 6].copy()
    np.random.shuffle(tiles)
    floor[:, 6] = tiles
    return _derived(np.concatenate([floor, rest], axis=0), pc)


def get_tiles_used(pc: cwipc_pointcloud_wrapper) -> List[int]:
    """Distinct tile values present, ascending (reference: util.py:285-293)."""
    arr = pc.get_numpy_array()
    return [int(t) for t in np.unique(arr["tile"])]


def cwipc_tile_occupancy(pc: cwipc_pointcloud_wrapper) -> dict:
    """Census: tile value -> point count (reference: util.py:184-200)."""
    arr = pc.get_numpy_array()
    values, counts = np.unique(arr["tile"], return_counts=True)
    return {int(v): int(c) for v, c in zip(values, counts)}


def cwipc_compute_tile_occupancy(
    pc: cwipc_pointcloud_wrapper, cellsize: float = 0, filterfloor: bool = False
):
    """(tilenum, pointcount) pairs sorted by count descending, optionally
    after a voxel downsample at ``cellsize`` and/or floor removal -- the
    voxel pass is what makes multi-camera combination tiles (tile-OR of
    merged voxels) appear in the census (reference: util.py:184-200)."""
    work = pc
    if filterfloor:
        work = cwipc_floor_filter(work)
    if cellsize:
        work = cwipc_downsample(work, cellsize)
    census = cwipc_tile_occupancy(work)
    return sorted(census.items(), key=lambda tc: tc[1], reverse=True)


def cwipc_downsample_pertile(
    pc: cwipc_pointcloud_wrapper, cellsize: float
) -> cwipc_pointcloud_wrapper:
    """Downsample each tile independently so tiles never merge
    (reference: registration/util.py:170-182)."""
    result: Optional[cwipc_pointcloud_wrapper] = None
    for tilenum in get_tiles_used(pc):
        tile_pc = cwipc_tilefilter(pc, tilenum)
        tile_down = cwipc_downsample(tile_pc, cellsize)
        tile_pc.free()
        if result is None:
            result = tile_down
        else:
            joined = cwipc_join(result, tile_down)
            result.free()
            tile_down.free()
            result = joined
    if result is None:
        return pc.clone()
    return result


def cwipc_xz_radius_percentile(
    pc: cwipc_pointcloud_wrapper, percentile: float = 90.0
) -> float:
    """Percentile of point distance from the vertical axis through the
    centroid (reference: util.py:202-216) -- used to size correspondence
    search regions."""
    m = pc.get_numpy_matrix(onlyGeometry=True)
    if m.shape[0] == 0:
        return 0.0
    center = m.mean(axis=0)
    dx = m[:, 0] - center[0]
    dz = m[:, 2] - center[2]
    return float(np.percentile(np.sqrt(dx * dx + dz * dz), percentile))


def cwipc_center(pc: cwipc_pointcloud_wrapper) -> Tuple[float, float, float]:
    """Centroid of a point cloud (reference: registration/util.py:84-89)."""
    points = pc.get_numpy_matrix()[:, :3]
    return tuple(np.mean(points, axis=0))


def cwipc_colorized_copy(pc: cwipc_pointcloud_wrapper) -> cwipc_pointcloud_wrapper:
    """A copy colorized by camera (tile) with weight 0.8, keeping the
    source alive (reference: registration/util.py:91-96)."""
    from ..filters.colorize import ColorizeFilter

    cf = ColorizeFilter(0.8, "camera")
    cf.set_keep_source()
    return cf.filter(pc)


def cwipc_compute_radius(
    pc: cwipc_pointcloud_wrapper, level: float = 0.1
) -> Tuple[float, float, float]:
    """XZ-plane radius ignoring outliers, as (overall, non-floor, floor)
    99th-percentile distances; floor = points with Y < level (reference:
    registration/util.py:202-216).  Empty subsets contribute 0 instead of
    raising (the reference crashes on an all-floor or floor-less cloud)."""
    pc_np = pc.get_numpy_matrix(onlyGeometry=True).copy()
    is_floor_point = pc_np[:, 1] < level
    floor_pc_np = pc_np[is_floor_point]
    nonfloor_pc_np = pc_np[~is_floor_point]
    floor_pc_np[:, 1] = 0
    nonfloor_pc_np[:, 1] = 0
    floor_max = (
        float(np.percentile(np.linalg.norm(floor_pc_np, axis=1), 99))
        if floor_pc_np.size
        else 0.0
    )
    nonfloor_max = (
        float(np.percentile(np.linalg.norm(nonfloor_pc_np, axis=1), 99))
        if nonfloor_pc_np.size
        else 0.0
    )
    return max(floor_max, nonfloor_max), nonfloor_max, floor_max


def cwipc_limit_floor_to_radius(
    pc: cwipc_pointcloud_wrapper, radius: float, level: float = 0.1
) -> cwipc_pointcloud_wrapper:
    """Drop floor points (Y < level) farther than radius from the origin;
    non-floor points always pass (reference: registration/util.py:218-229,
    including its full-3D distance for the floor test)."""
    pc_np = pc.get_numpy_matrix()
    is_floor_point = pc_np[:, 1] < level
    floor_pc_np = pc_np[is_floor_point]
    nonfloor_pc_np = pc_np[~is_floor_point]
    keep_floor = np.linalg.norm(floor_pc_np[:, 0:3], axis=1) < radius
    new_pc_np = np.concatenate([floor_pc_np[keep_floor], nonfloor_pc_np], axis=0)
    return _derived(new_pc_np, pc, cellsize=False)


def algdoc(klass: type, indent: int) -> str:
    """Dedented, tab-indented class docstring for --help listings of
    algorithm classes (reference: registration/util.py:18-24)."""
    import textwrap

    doc = klass.__doc__
    if doc is None:
        doc = "No documentation available"
    return textwrap.indent(textwrap.dedent(doc), "\t" * indent)


# ---------------------------------------------------------------------------
# Base classes for algorithms (reference: registration/util.py:311-449)
# ---------------------------------------------------------------------------

from .abstract import Algorithm, MulticamAlgorithm, PointCloudFilter  # noqa: E402


class BaseAlgorithm(Algorithm):
    """Common source/reference handling for analysis & alignment algorithms."""

    def __init__(self) -> None:
        self._source_pointcloud: Optional[cwipc_pointcloud_wrapper] = None
        self._filtered_source_pointcloud: Optional[cwipc_pointcloud_wrapper] = None
        self.source_tilemask: Optional[int] = None
        self._reference_pointcloud: Optional[cwipc_pointcloud_wrapper] = None
        self._filtered_reference_pointcloud: Optional[cwipc_pointcloud_wrapper] = None
        self.reference_tilemask: Optional[int] = None
        self.verbose = False
        self.debug = False

    def set_source_pointcloud(self, pc: cwipc_pointcloud_wrapper, tilemask: Optional[int] = None) -> None:
        if tilemask is not None and tilemask != 0:
            pc = cwipc_tilefilter_masked(pc, tilemask)
        self._source_pointcloud = pc
        self._filtered_source_pointcloud = None
        self.source_tilemask = tilemask

    def set_reference_pointcloud(self, pc: cwipc_pointcloud_wrapper, tilemask: Optional[int] = None) -> None:
        if tilemask is not None and tilemask != 0:
            pc = cwipc_tilefilter_masked(pc, tilemask)
        self._reference_pointcloud = pc
        self._filtered_reference_pointcloud = None
        self.reference_tilemask = tilemask

    def get_source_pointcloud(self) -> cwipc_pointcloud_wrapper:
        assert self._source_pointcloud is not None
        return self._source_pointcloud

    def get_filtered_source_pointcloud(self) -> cwipc_pointcloud_wrapper:
        return self._filtered_source_pointcloud or self.get_source_pointcloud()

    def get_reference_pointcloud(self) -> cwipc_pointcloud_wrapper:
        assert self._reference_pointcloud is not None
        return self._reference_pointcloud

    def get_filtered_reference_pointcloud(self) -> cwipc_pointcloud_wrapper:
        return self._filtered_reference_pointcloud or self.get_reference_pointcloud()

    def apply_source_filter(self, filter: PointCloudFilter) -> None:
        self._filtered_source_pointcloud = filter(self.get_filtered_source_pointcloud())

    def apply_reference_filter(self, filter: PointCloudFilter) -> None:
        self._filtered_reference_pointcloud = filter(self.get_filtered_reference_pointcloud())


class BaseMulticamAlgorithm(MulticamAlgorithm):
    """Common per-tile handling for multi-camera algorithms."""

    def __init__(self) -> None:
        self.per_camera_tilenum: List[int] = []
        self.original_pointcloud: Optional[cwipc_pointcloud_wrapper] = None
        self.verbose = False
        self.debug = False

    def set_tiled_pointcloud(self, pc: cwipc_pointcloud_wrapper) -> None:
        self.original_pointcloud = pc
        self.per_camera_tilenum = list(get_tiles_used(pc))

    def tilemask_for_camera_index(self, cam_index: int) -> int:
        return self.per_camera_tilenum[cam_index]

    def camera_index_for_tilemask(self, tilenum: int) -> int:
        return self.per_camera_tilenum.index(tilenum)

    def camera_count(self) -> int:
        return len(self.per_camera_tilenum)

    def get_pc_for_tilemask(self, tilemask: int) -> cwipc_pointcloud_wrapper:
        assert self.original_pointcloud is not None
        return cwipc_tilefilter(self.original_pointcloud, tilemask)

    def get_pc_for_camnum(self, camnum: int) -> cwipc_pointcloud_wrapper:
        return self.get_pc_for_tilemask(self.tilemask_for_camera_index(camnum))

    def get_pointcloud_for_tilemask(self, tilenum: int) -> cwipc_pointcloud_wrapper:
        """Reference-parity name (reference: multicoarse.py:54-58)."""
        return self.get_pc_for_tilemask(tilenum)


def project_point_indices(
    xyz: np.ndarray, camera, width: int, height: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Project points with the software renderer's camera model: returns
    (u, v, depth) screen coordinates per point (NaN u/v for points behind
    the camera).  Factored out of the renderer so picking is testable
    without a window."""
    import math as _math

    view = camera.view_matrix()
    cam_pts = xyz @ view[:3, :3].T + view[:3, 3]
    z = -cam_pts[:, 2]
    f = 0.5 * height / _math.tan(_math.radians(camera.fov_deg) / 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.where(z > 1e-6, (cam_pts[:, 0] / z) * f + width / 2, np.nan)
        v = np.where(z > 1e-6, -(cam_pts[:, 1] / z) * f + height / 2, np.nan)
    return u, v, z


def pick_index_at(
    xyz: np.ndarray, camera, width: int, height: int, x: float, y: float,
    max_pixel_distance: float = 12.0,
) -> int:
    """The point index whose projection is nearest to screen (x, y), with
    nearer-in-depth winning among candidates inside the pixel radius;
    -1 when nothing is close enough.  (The deprojection core of the
    interactive picker, reference util.py:244-257 o3d pick window.)"""
    u, v, z = project_point_indices(xyz, camera, width, height)
    d2 = (u - x) ** 2 + (v - y) ** 2
    near = d2 <= max_pixel_distance**2
    cand = np.where(np.isfinite(d2) & near)[0]
    if cand.size == 0:
        return -1
    # among pixels within the radius prefer the closest to the camera
    # (front surface), then the closest to the click
    zc = z[cand]
    zmin = zc.min()
    front = cand[zc <= zmin * 1.02]
    return int(front[np.argmin(d2[front])])


def pick_points(
    title: str, pc: cwipc_pointcloud_wrapper, count: int = 4,
    timeout_ms: int = 120000,
) -> List[int]:
    """Interactive point picking: show the cloud in the software viewer
    and let the user shift-click `count` points; returns their indices
    (reference: registration/util.py:244-257, o3d VisualizerWithEditing).
    Headless runs (no GUI available) return [] immediately — callers fall
    back to the automated detector."""
    import time as _time

    from ..io.visualizer_sink import cwipc_window_sink

    window = cwipc_window_sink(title)
    try:
        # headless: skip the (full-cloud) render entirely — the caller
        # falls back to the automated detector anyway
        if not window._gui:
            return []
        window.feed(pc, True)
        import cv2

        m = pc.get_numpy_matrix(onlyGeometry=True).astype(np.float32)
        picked: List[int] = []

        def on_mouse(event, x, y, flags, _param):
            if event == cv2.EVENT_LBUTTONDOWN and (flags & cv2.EVENT_FLAG_SHIFTKEY):
                idx = pick_index_at(m, window.camera, window.width, window.height, x, y)
                if idx >= 0 and idx not in picked:
                    picked.append(idx)
                    print(f"pick_points: picked #{len(picked)}: index {idx} at {m[idx]}")
            else:
                window._on_mouse(event, x, y, flags, _param)

        cv2.setMouseCallback(window.title, on_mouse)
        print(f"pick_points: shift-click {count} points; q aborts")
        deadline = _time.time() + timeout_ms / 1000.0
        while len(picked) < count and _time.time() < deadline:
            key = cv2.waitKey(50)
            if key >= 0 and chr(key & 0xFF) == "q":
                break
        return picked
    finally:
        window.free(force=True)


def show_pointcloud(title: str, pc: cwipc_pointcloud_wrapper, timeout_ms: int = 5000) -> None:
    """Show a pointcloud in a viewer window until a key is pressed (or the
    timeout elapses in headless runs) — the interactive inspection helper
    used by registration flows (reference: registration/util.py:231-283,
    o3d show window; ours uses the software viewer sink)."""
    from ..io.visualizer_sink import cwipc_window_sink

    window = cwipc_window_sink(title)
    try:
        window.feed(pc, True)
        window.interact("Press any key to close", None, timeout_ms)
    finally:
        window.free(force=True)


def _as_wrapper_or_o3d(pc):
    """(wrapper_or_None, o3d_geometry_or_None) from either input kind."""
    if isinstance(pc, cwipc_pointcloud_wrapper):
        return pc, None
    return None, pc


def o3d_show_points(title: str, pc, from000: bool = False, keepopen: bool = False):
    """Show an open3d (or wrapper) point cloud in a window (reference:
    registration/util.py o3d_show_points).  Uses Open3D when installed;
    otherwise falls back to the software viewer (then the cloud must be a
    wrapper, keepopen is unsupported, and None is returned)."""
    try:
        import open3d  # type: ignore
    except ImportError:
        open3d = None
    wrapper, geom = _as_wrapper_or_o3d(pc)
    if open3d is not None:
        if geom is None:
            geom = wrapper.get_o3d_pointcloud()
        vis = open3d.visualization.Visualizer()
        vis.create_window(window_name=title)
        vis.add_geometry(geom)
        vis.add_geometry(open3d.geometry.TriangleMesh.create_coordinate_frame())
        if from000:
            view_control = vis.get_view_control()
            cam = view_control.convert_to_pinhole_camera_parameters()
            cam.extrinsic = transformation_identity()
            view_control.convert_from_pinhole_camera_parameters(cam)
        vis.run()
        if keepopen:
            return vis
        vis.destroy_window()
        return None
    if wrapper is None:
        raise RuntimeError("o3d_show_points: open3d not installed and input is not a cwipc")
    show_pointcloud(title, wrapper)
    return None


def o3d_pick_points(title: str, pc, from000: bool = False, limit: int = 64) -> List[int]:
    """Let the user pick points; returns picked indices (reference:
    registration/util.py o3d_pick_points, VisualizerWithEditing).  Uses
    Open3D when installed; otherwise the software-viewer picker
    (shift-click, q ends, at most `limit` picks; the cloud must then be a
    wrapper)."""
    try:
        import open3d  # type: ignore
    except ImportError:
        open3d = None
    wrapper, geom = _as_wrapper_or_o3d(pc)
    if open3d is not None:
        if geom is None:
            geom = wrapper.get_o3d_pointcloud()
        vis = open3d.visualization.VisualizerWithEditing()
        vis.create_window(window_name=title, width=1280, height=720)
        vis.add_geometry(geom)
        if from000:
            view_control = vis.get_view_control()
            cam = view_control.convert_to_pinhole_camera_parameters()
            cam.extrinsic = transformation_identity()
            view_control.convert_from_pinhole_camera_parameters(cam)
        vis.run()
        vis.destroy_window()
        return vis.get_picked_points()
    if wrapper is None:
        raise RuntimeError("o3d_pick_points: open3d not installed and input is not a cwipc")
    return pick_points(title, wrapper, count=limit)
