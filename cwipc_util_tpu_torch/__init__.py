"""cwipc_util_tpu_torch — the point-cloud framework on PyTorch and CUDA.

The port of ``cwipc_util_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU.  It keeps the JAX package's module tree and public names;
clouds are fixed-capacity SoA buffers on a torch device.  The kernels of
the fused downsample -> outlier -> tilefilter chains and of
``cwipc_remove_outliers`` are hand-written CUDA (``csrc/``), built with
nvcc at first use; so is the nearest-neighbour kernel of the
multi-camera registration toolkit (``registration/``).

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
    cwipc_dangling_allocations,
    cwipc_point,
    cwipc_point_array,
    cwipc_pointcloud_wrapper,
)
from .models.synthetic import cwipc_source_synthetic, cwipc_synthetic
from .ops import (
    cwipc_downsample,
    cwipc_join,
    cwipc_join_multi,
    cwipc_remove_outliers,
    cwipc_tilefilter,
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

import numpy as _np


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


__all__ = [
    "CWIPC_LOG_LEVEL_DEBUG",
    "CWIPC_LOG_LEVEL_ERROR",
    "CWIPC_LOG_LEVEL_NONE",
    "CWIPC_LOG_LEVEL_TRACE",
    "CWIPC_LOG_LEVEL_WARNING",
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
    "cwipc_dangling_allocations",
    "cwipc_downsample",
    "cwipc_from_numpy_array",
    "cwipc_from_numpy_matrix",
    "cwipc_join",
    "cwipc_join_multi",
    "cwipc_log_configure",
    "cwipc_log_default_callback",
    "cwipc_metadata",
    "cwipc_point",
    "cwipc_point_array",
    "cwipc_pointcloud_abstract",
    "cwipc_pointcloud_wrapper",
    "cwipc_remove_outliers",
    "cwipc_sink_abstract",
    "cwipc_source_abstract",
    "cwipc_source_synthetic",
    "cwipc_synthetic",
    "cwipc_tilefilter",
    "downsample_outliers_tilefilter",
    "downsample_outliers_tilefilter_exact",
    "resolve_device",
]
