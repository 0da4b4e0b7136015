"""Registration helper functions on wrapper point clouds.

The port of cwipc_util_tpu/registration/util.py: transforms, masked tile
selection, direction/floor filters, per-tile downsample, tile census,
radius percentiles and the algorithm base classes.  Every cloud these
helpers derive stays on its input's device.

Not ported yet: the viewer pickers (``project_point_indices``,
``pick_index_at``, ``show_pointcloud``, ``o3d_*``) and ``pick_points``
on a host with a display; on a headless host ``pick_points`` returns no
points, as the JAX package's does, so callers fall back to their
automated detectors.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import numpy as np

from .. import (
    cwipc_downsample,
    cwipc_from_numpy_matrix,
    cwipc_join,
    cwipc_tilefilter,
)
from ..core.buffers import PointBuffer, bucket_capacity
from ..core.errors import CwipcError
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


def _try_cv2_gui() -> bool:
    """Whether a cv2 window can open: a display and cv2 (the JAX package's
    io/visualizer_sink.py:23-32)."""
    if not os.environ.get("DISPLAY") and os.name != "nt":
        return False
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def pick_points(title: str, pc: cwipc_pointcloud_wrapper, count: int = 4, timeout_ms: int = 120000) -> List[int]:
    """Interactive point picking in the viewer; returns the picked indices.
    Headless runs (no GUI) return [] at once, as the JAX package's do, and
    callers fall back to their automated detectors.  With a display it
    raises: the viewer is not ported yet (ROADMAP Queue 1 item 3)."""
    if not _try_cv2_gui():
        return []
    raise CwipcError(
        f"{title}: pick_points needs the viewer (io/visualizer_sink.py), which is not"
        " ported yet (ROADMAP Queue 1 item 3)"
    )
