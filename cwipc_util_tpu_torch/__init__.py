"""cwipc_util_tpu_torch — the point-cloud framework on PyTorch and CUDA.

The port of ``cwipc_util_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU.  It keeps the JAX package's module tree and public names;
clouds are fixed-capacity SoA buffers on a torch device.  The kernels of
the fused downsample -> outlier -> tilefilter chains and of
``cwipc_remove_outliers`` are hand-written CUDA (``csrc/``), built with
nvcc at first use; so are the nearest-neighbour kernel of the
multi-camera registration toolkit (``registration/``), the key+payload
sort (``ops/sort_kernel.py``) and the scan-rate probe
(``ops/scan_probe.py``).  The filters and their string factory are in
``filters/``.  Clouds are read and written as PLY files, cwipcdump files
and packets (``io/``), compressed by the CTC1 codec (``codec/``, whose
geometry stage runs on the card through kernels 1 and 3), and carried
between threads by the encoder/decoder and passthrough sinks and sources
(``net/``).

The device is explicit: sources and converters take ``device`` (default
``"cuda"``; without CUDA that raises :class:`CwipcError`), and every op
runs on its input's device.  On CPU tensors each kernel's plain PyTorch
version runs instead, which is how the parity tests run without a GPU.

This package imports neither jax nor ``cwipc_util_tpu``.
"""

from .abstract import (
    cwipc_activesource_abstract,
    cwipc_pointcloud_abstract,
    cwipc_sink_abstract,
    cwipc_source_abstract,
)
from .core.buffers import (
    POINT_DTYPE,
    POINT_SIZE,
    PointBuffer,
    buffer_from_arrays,
    buffer_from_bytes,
    buffer_from_numpy,
    buffer_to_bytes,
    buffer_to_numpy,
    resolve_device,
)
from .core.errors import CwipcError
from .core.metadata import cwipc_metadata
from .core.pointcloud import (
    CWIPC_API_VERSION,
    cwipc_dangling_allocations,
    cwipc_point,
    cwipc_point_array,
    cwipc_point_numpy_dtype,
    cwipc_pointcloud_wrapper,
    cwipc_skeleton_collection,
    cwipc_skeleton_joint,
    parse_skeleton_collection,
)
from .io.dump import (
    CWIPC_CWIPCDUMP_HEADER,
    CWIPC_CWIPCDUMP_VERSION,
    pointcloud_from_packet,
    read_debugdump,
    write_debugdump,
)
from .io.ply import CWIPC_FLAGS_BINARY, read_ply, write_ply
from .models.synthetic import cwipc_source_synthetic, cwipc_synthetic
from .ops import (
    cwipc_colormap,
    cwipc_crop,
    cwipc_downsample,
    cwipc_join,
    cwipc_join_multi,
    cwipc_remove_outliers,
    cwipc_tilefilter,
    cwipc_tilemap,
)
from .ops.chain import downsample_outliers_tilefilter, downsample_outliers_tilefilter_exact
from .utils.logging import (
    CWIPC_LOG_LEVEL_DEBUG,
    CWIPC_LOG_LEVEL_ERROR,
    CWIPC_LOG_LEVEL_NONE,
    CWIPC_LOG_LEVEL_TRACE,
    CWIPC_LOG_LEVEL_WARNING,
    cwipc_log_configure,
    cwipc_log_default_callback,
)
from .version import __version__

import numpy as _np

CWIPC_POINT_PACKETHEADER_MAGIC = 0x20201016


def cwipc_get_version() -> str:
    return __version__


def cwipc_from_points(points, timestamp: int, device=None) -> cwipc_pointcloud_wrapper:
    """Create a pointcloud from a cwipc_point array, a list of 7-tuples or
    packed record bytes, host-backed on ``device`` (``None`` means CUDA)."""
    import ctypes as _ctypes

    if not isinstance(points, _ctypes.Array):
        points = cwipc_point_array(values=points)
    data = bytes(memoryview(points).cast("B")) if len(points) else b""
    arr = _np.frombuffer(data, POINT_DTYPE).copy()
    return cwipc_pointcloud_wrapper(None, timestamp, 0.0, _host_points=arr, device=device)


def cwipc_from_numpy_array(np_points, timestamp: int, device=None) -> cwipc_pointcloud_wrapper:
    """Create a pointcloud from a structured numpy array (POINT_DTYPE fields).

    Host-backed: the device buffer is built on ``device`` (``None`` means
    CUDA) at first use.  The input is copied, so later changes by the
    caller do not leak in."""
    if np_points.dtype != POINT_DTYPE:
        np_points = np_points.astype(POINT_DTYPE)  # already a fresh copy
    else:
        np_points = np_points.copy()
    return cwipc_pointcloud_wrapper(None, timestamp, 0.0, _host_points=np_points, device=device)


def cwipc_from_numpy_matrix(np_points_matrix, timestamp: int, device=None) -> cwipc_pointcloud_wrapper:
    """Create a pointcloud from an Nx7 float matrix (x, y, z, r, g, b, tile),
    host-backed on ``device`` as :func:`cwipc_from_numpy_array`."""
    count = np_points_matrix.shape[0]
    if np_points_matrix.shape != (count, 7) or np_points_matrix.dtype not in (_np.float32, _np.float64):
        raise CwipcError(
            f"cwipc_from_numpy_matrix: need an Nx7 float32/float64 matrix, got"
            f" {np_points_matrix.shape} {np_points_matrix.dtype}"
        )
    arr = _np.zeros(count, POINT_DTYPE)
    arr["x"] = np_points_matrix[:, 0]
    arr["y"] = np_points_matrix[:, 1]
    arr["z"] = np_points_matrix[:, 2]
    arr["r"] = np_points_matrix[:, 3].astype(_np.uint8)
    arr["g"] = np_points_matrix[:, 4].astype(_np.uint8)
    arr["b"] = np_points_matrix[:, 5].astype(_np.uint8)
    arr["tile"] = np_points_matrix[:, 6].astype(_np.uint8)
    return cwipc_from_numpy_array(arr, timestamp, device)


def cwipc_from_o3d_pointcloud(o3d_pc, timestamp: int, device=None) -> cwipc_pointcloud_wrapper:
    """Create a pointcloud from an Open3D PointCloud (the tile is lost).

    Color scaling quirk preserved from the reference
    (python/cwipc/util.py:1203-1211): colors are multiplied by 256, not 255.
    """
    points = _np.asarray(o3d_pc.points)
    colors = _np.asarray(o3d_pc.colors)
    m = _np.zeros((points.shape[0], 7))
    m[:, 0:3] = points
    m[:, 3:6] = colors * 256
    return cwipc_from_numpy_matrix(m, timestamp, device)


def cwipc_from_packet(packet, device=None) -> cwipc_pointcloud_wrapper:
    return pointcloud_from_packet(packet, device)


def cwipc_read(filename: str, timestamp: int, device=None) -> cwipc_pointcloud_wrapper:
    """Read a pointcloud from a .ply file."""
    return read_ply(filename, timestamp, device)


def cwipc_write(filename: str, pointcloud: cwipc_pointcloud_wrapper, flags: int = 0) -> int:
    """Write a pointcloud to a .ply file (CWIPC_FLAGS_BINARY for binary)."""
    return write_ply(filename, pointcloud, flags)


def cwipc_read_debugdump(filename: str, device=None) -> cwipc_pointcloud_wrapper:
    return read_debugdump(filename, device)


def cwipc_write_debugdump(filename: str, pointcloud: cwipc_pointcloud_wrapper) -> int:
    return write_debugdump(filename, pointcloud)


__all__ = [
    "CWIPC_API_VERSION",
    "CWIPC_CWIPCDUMP_HEADER",
    "CWIPC_CWIPCDUMP_VERSION",
    "CWIPC_FLAGS_BINARY",
    "CWIPC_LOG_LEVEL_DEBUG",
    "CWIPC_LOG_LEVEL_ERROR",
    "CWIPC_LOG_LEVEL_NONE",
    "CWIPC_LOG_LEVEL_TRACE",
    "CWIPC_LOG_LEVEL_WARNING",
    "CWIPC_POINT_PACKETHEADER_MAGIC",
    "POINT_DTYPE",
    "POINT_SIZE",
    "CwipcError",
    "PointBuffer",
    "buffer_from_arrays",
    "buffer_from_bytes",
    "buffer_from_numpy",
    "buffer_to_bytes",
    "buffer_to_numpy",
    "cwipc_activesource_abstract",
    "cwipc_colormap",
    "cwipc_crop",
    "cwipc_dangling_allocations",
    "cwipc_downsample",
    "cwipc_from_numpy_array",
    "cwipc_from_numpy_matrix",
    "cwipc_from_o3d_pointcloud",
    "cwipc_from_packet",
    "cwipc_from_points",
    "cwipc_get_version",
    "cwipc_join",
    "cwipc_join_multi",
    "cwipc_log_configure",
    "cwipc_log_default_callback",
    "cwipc_metadata",
    "cwipc_point",
    "cwipc_point_array",
    "cwipc_point_numpy_dtype",
    "cwipc_pointcloud_abstract",
    "cwipc_pointcloud_wrapper",
    "cwipc_read",
    "cwipc_read_debugdump",
    "cwipc_remove_outliers",
    "cwipc_sink_abstract",
    "cwipc_source_abstract",
    "cwipc_source_synthetic",
    "cwipc_synthetic",
    "cwipc_tilefilter",
    "cwipc_tilemap",
    "cwipc_write",
    "cwipc_write_debugdump",
    "downsample_outliers_tilefilter",
    "downsample_outliers_tilefilter_exact",
    "resolve_device",
]
