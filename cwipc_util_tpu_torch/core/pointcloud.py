"""Host-side point-cloud object with the reference-compatible API.

The port of cwipc_util_tpu/core/pointcloud.py, restricted to what the
ported ops use: construction from a device buffer or from host points, the
accessors (``get_numpy_matrix`` included), the timestamp/cellsize setters,
clone/free and the allocation counter.  The native handoff
(``as_cwipc_p``) and ``get_packet`` are not ported yet.

As in the JAX package, points live on the device and the host accessors
copy lazily and cache; ``count`` stays a device scalar until asked for.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Optional

import numpy as np
import torch

from .buffers import (
    POINT_SIZE,
    PointBuffer,
    buffer_from_numpy,
    buffer_to_numpy,
    resolve_device,
)
from .errors import CwipcError
from .metadata import cwipc_metadata

# ---------------------------------------------------------------------------
# ctypes point record — bit-compatible with the reference
# (include/cwipc_util/api.h:88-96, python/cwipc/util.py:260-294)
# ---------------------------------------------------------------------------


class cwipc_point(ctypes.Structure):
    """Point data as a ctypes structure: x,y,z float32; r,g,b,tile uint8."""

    _fields_ = [
        ("x", ctypes.c_float),
        ("y", ctypes.c_float),
        ("z", ctypes.c_float),
        ("r", ctypes.c_ubyte),
        ("g", ctypes.c_ubyte),
        ("b", ctypes.c_ubyte),
        ("tile", ctypes.c_ubyte),
    ]

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, cwipc_point):
            return False
        return all(
            getattr(self, f) == getattr(other, f)
            for f in ("x", "y", "z", "r", "g", "b", "tile")
        )

    def __ne__(self, other: Any) -> bool:
        return not self.__eq__(other)

    def __repr__(self) -> str:
        return (
            f"cwipc_point({self.x}, {self.y}, {self.z},"
            f" {self.r}, {self.g}, {self.b}, {self.tile})"
        )


assert ctypes.sizeof(cwipc_point) == POINT_SIZE


def cwipc_point_array(
    *, count: Optional[int] = None, values: Any = ()
) -> "ctypes.Array[cwipc_point]":
    """Create an array of cwipc_point, optionally initialized from a list of
    7-tuples, packed record bytes, or an existing cwipc_point array."""
    if isinstance(values, (bytes, bytearray, memoryview)):
        if count is None:
            count = len(values) // POINT_SIZE
        allocator = cwipc_point * count
        if isinstance(values, bytes):
            return allocator.from_buffer_copy(values)
        return allocator.from_buffer(values)
    if count is None:
        count = len(values)
    allocator = cwipc_point * count
    return allocator(*[cwipc_point(*v) if isinstance(v, tuple) else v for v in values])


# ---------------------------------------------------------------------------
# Allocation tracking (leak-test oracle)
# ---------------------------------------------------------------------------

_alloc_lock = threading.Lock()
_n_alloc = 0
_n_dealloc = 0


def _track_alloc() -> None:
    global _n_alloc
    with _alloc_lock:
        _n_alloc += 1


def _track_dealloc() -> None:
    global _n_dealloc
    with _alloc_lock:
        _n_dealloc += 1


def cwipc_dangling_allocations(log: bool) -> int:
    """Return the number of live (not-yet-freed) pointcloud objects."""
    from ..utils.logging import CWIPC_LOG_LEVEL_WARNING, _cwipc_log_emit

    with _alloc_lock:
        n = _n_alloc - _n_dealloc
    if log and n != 0:
        _cwipc_log_emit(
            CWIPC_LOG_LEVEL_WARNING,
            "cwipc_pointcloud",
            f"{n} free() mismatch. nAlloc={_n_alloc}, nFree={_n_dealloc}",
        )
    return abs(n)


# ---------------------------------------------------------------------------
# The point-cloud object
# ---------------------------------------------------------------------------


class cwipc_pointcloud_wrapper:
    """An opaque pointcloud: device SoA buffer + host metadata."""

    def __init__(
        self,
        buffer: Optional[PointBuffer] = None,
        timestamp: int = 0,
        cellsize: float = 0.0,
        _count_hint: Optional[int] = None,
        _host_points: Optional[np.ndarray] = None,
        device=None,
    ):
        """``_host_points`` (a POINT_DTYPE structured array) makes the
        wrapper host-backed: the device buffer is built on ``device`` at
        the first ``_access_buffer``.  The array doubles as the host
        accessor cache and must not be mutated by the caller afterwards."""
        self._buffer = buffer
        if buffer is not None:
            self._device: Optional[torch.device] = buffer.device
        elif _host_points is not None:
            self._device = resolve_device(device)
        else:
            self._device = None
        self._timestamp = int(timestamp)
        self._cellsize = float(cellsize)
        self._metadata: Optional[cwipc_metadata] = None
        self._points: Optional[ctypes.Array[cwipc_point]] = None
        self._bytes: Optional[bytearray] = None
        self._lazy_host: Optional[np.ndarray] = _host_points
        self._np_cache: Optional[np.ndarray] = _host_points
        if _host_points is not None and _count_hint is None:
            _count_hint = int(_host_points.shape[0])
        self._count_cache: Optional[int] = _count_hint
        self._owned = buffer is not None or _host_points is not None
        if self._owned:
            _track_alloc()

    def __del__(self):
        # at interpreter exit the module's globals may already be gone
        if getattr(self, "_owned", False) and _track_dealloc is not None:
            self.free()

    # -- ownership protocol (python/cwipc/util.py:599-628) ----------------

    def free(self, *, force: bool = False) -> None:
        if self._owned:
            self._owned = False
            _track_dealloc()
        self._buffer = None
        self._lazy_host = None
        self._np_cache = None
        self._points = None
        self._bytes = None

    def clone(self) -> "cwipc_pointcloud_wrapper":
        """Shallow copy: shares the buffer(s), new identity."""
        self._assert_alive()
        return cwipc_pointcloud_wrapper(
            self._buffer, self._timestamp, self._cellsize,
            _count_hint=self._count_cache, _host_points=self._lazy_host,
            device=self._device,
        )

    def _assert_alive(self) -> None:
        if self._buffer is None and self._lazy_host is None:
            raise CwipcError("cwipc: pointcloud already freed")

    # -- accessors ---------------------------------------------------------

    def _access_buffer(self) -> PointBuffer:
        self._assert_alive()
        if self._buffer is None:
            self._buffer = buffer_from_numpy(self._lazy_host, device=self._device)
        return self._buffer

    def timestamp(self) -> int:
        return self._timestamp

    def cellsize(self) -> float:
        return self._cellsize

    def _set_cellsize(self, cellsize: float) -> None:
        """Set cellsize; negative asks for the reference's guess heuristic.

        Quirk preserved from src/cwipc_util.cpp:176-204: the reference's
        "adjacent point" scan never advances its prev iterator, so the guess
        is the minimum distance from any point to the FIRST point.
        """
        if cellsize < 0 and (self._buffer is not None or self._lazy_host is not None):
            arr = self._numpy()
            if arr.shape[0] >= 2:
                xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1)
                d = np.linalg.norm(xyz[1:] - xyz[0], axis=-1)
                cellsize = float(d.min()) if d.size else 0.0
            else:
                cellsize = 0.0
        self._cellsize = float(cellsize)

    def _set_timestamp(self, timestamp: int) -> None:
        self._timestamp = int(timestamp)

    def count(self) -> int:
        if self._buffer is None and not self._owned:
            from ..utils.logging import CWIPC_LOG_LEVEL_WARNING, cwipc_log

            cwipc_log(CWIPC_LOG_LEVEL_WARNING, "cwipc_util", "count: freed pointcloud")
            return 0
        if self._count_cache is None:
            self._count_cache = int(self._access_buffer().count)
        return self._count_cache

    def get_uncompressed_size(self) -> int:
        return self.count() * POINT_SIZE

    def _numpy(self) -> np.ndarray:
        if self._np_cache is None:
            self._np_cache = buffer_to_numpy(self._access_buffer())
            self._count_cache = int(self._np_cache.shape[0])
        return self._np_cache

    def get_points(self) -> "ctypes.Array[cwipc_point]":
        if self._points is None:
            self._points = cwipc_point_array(values=self.get_bytes())
        return self._points

    def get_bytes(self) -> bytearray:
        if self._bytes is None:
            self._bytes = bytearray(self._numpy().tobytes())
        return self._bytes

    def get_numpy_array(self) -> np.ndarray:
        return self._numpy().copy()

    def get_numpy_matrix(self, onlyGeometry: bool = False) -> np.ndarray:
        arr = self._numpy()
        ncol = 3 if onlyGeometry else 7
        m = np.zeros((arr.shape[0], ncol), np.float32)
        m[:, 0] = arr["x"]
        m[:, 1] = arr["y"]
        m[:, 2] = arr["z"]
        if not onlyGeometry:
            m[:, 3] = arr["r"]
            m[:, 4] = arr["g"]
            m[:, 5] = arr["b"]
            m[:, 6] = arr["tile"]
        return m

    def access_metadata(self) -> cwipc_metadata:
        if self._metadata is None:
            self._metadata = cwipc_metadata()
        return self._metadata
