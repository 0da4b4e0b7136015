"""Host-side point-cloud object with the reference-compatible API.

The port of cwipc_util_tpu/core/pointcloud.py: construction from a
device buffer or from host points, the accessors, the timestamp/cellsize
setters, clone/free/detach, the allocation counter, the packet and the
native handoff (``as_cwipc_p``, through the port's loader in ``util.py``),
and the skeleton structs of the body-tracking metadata.

As in the JAX package, points live on the device and the host accessors
copy lazily and cache; ``count`` stays a device scalar until asked for.
A host-backed cloud (``_host_points``) remembers the device its buffer
goes to, and keeps it through clone and detach.
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

CWIPC_API_VERSION = 0x20260129

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

cwipc_point_numpy_dtype = [
    ("x", "<f4"),
    ("y", "<f4"),
    ("z", "<f4"),
    ("r", "u1"),
    ("g", "u1"),
    ("b", "u1"),
    ("tile", "u1"),
]


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
        self._native_handle: Optional[ctypes.c_void_p] = None
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
        if self._native_handle:
            from ..util import cwipc_util_dll_load

            dll = cwipc_util_dll_load()
            dll.cwipc_pointcloud_free.argtypes = [ctypes.c_void_p]
            dll.cwipc_pointcloud_free(self._native_handle)
            self._native_handle = None
        self._buffer = None
        self._lazy_host = None
        self._np_cache = None
        self._points = None
        self._bytes = None

    def detach(self) -> "cwipc_pointcloud_wrapper":
        """Hand ownership to a new wrapper; self no longer frees the data."""
        rv = cwipc_pointcloud_wrapper.__new__(cwipc_pointcloud_wrapper)
        rv.__dict__.update(self.__dict__)
        self._owned = False
        self._native_handle = None  # rv owns the native twin now
        self._buffer = None
        self._lazy_host = None
        self._np_cache = None
        self._points = None
        self._bytes = None
        return rv

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

    def as_cwipc_p(self) -> ctypes.c_void_p:
        """ctypes handle of a native twin of this cloud, for C code built
        against the native ABI (reference: util.py:594-597).  The first call
        builds the twin through the native ``cwipc_from_packet`` (same
        points, timestamp and cellsize); it is cached, freed with this
        wrapper and handed on by ``detach()``."""
        self._assert_alive()
        if self._native_handle:
            return self._native_handle
        from ..util import cwipc_util_dll_load

        dll = cwipc_util_dll_load()
        dll.cwipc_from_packet.restype = ctypes.c_void_p
        dll.cwipc_from_packet.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64,
        ]
        packet = bytes(self.get_packet())
        err = ctypes.c_char_p(None)
        handle = dll.cwipc_from_packet(packet, len(packet), ctypes.byref(err), CWIPC_API_VERSION)
        if not handle:
            raise CwipcError(err.value.decode("utf8") if err.value else "cwipc_from_packet failed")
        self._native_handle = ctypes.c_void_p(handle)
        return self._native_handle

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

    def get_o3d_pointcloud(self):
        """An Open3D point cloud of this cloud (needs open3d installed)."""
        import open3d  # optional dependency, imported only here

        m = self.get_numpy_matrix()
        pc = open3d.geometry.PointCloud()
        pc.points = open3d.utility.Vector3dVector(m[:, 0:3].astype(np.float64))
        pc.colors = open3d.utility.Vector3dVector((m[:, 3:6] / 255.0).astype(np.float64))
        return pc

    def get_packet(self) -> bytearray:
        from ..io.dump import packet_from_pointcloud

        return packet_from_pointcloud(self)

    def access_metadata(self) -> cwipc_metadata:
        if self._metadata is None:
            self._metadata = cwipc_metadata()
        return self._metadata


# ---------------------------------------------------------------------------
# Skeleton structures (k4abt body tracking interop,
# reference: include/cwipc_util/api.h:118-141, python/cwipc/util.py)
# ---------------------------------------------------------------------------


class cwipc_skeleton_joint(ctypes.Structure):
    """Per-joint skeleton information as reported by a body tracker."""

    _fields_ = [
        ("confidence", ctypes.c_uint32),
        ("x", ctypes.c_float),
        ("y", ctypes.c_float),
        ("z", ctypes.c_float),
        ("q_w", ctypes.c_float),
        ("q_x", ctypes.c_float),
        ("q_y", ctypes.c_float),
        ("q_z", ctypes.c_float),
    ]


class cwipc_skeleton_collection(ctypes.Structure):
    """Header of a skeleton collection; joints follow contiguously."""

    _fields_ = [
        ("n_skeletons", ctypes.c_uint32),
        ("n_joints", ctypes.c_uint32),
    ]


def parse_skeleton_collection(data: bytes):
    """Parse a skeleton-collection metadata blob into
    (n_skeletons, n_joints, [joint, ...])."""
    hdr = cwipc_skeleton_collection.from_buffer_copy(data[:8])
    joints = (cwipc_skeleton_joint * (hdr.n_skeletons * hdr.n_joints)).from_buffer_copy(data[8:])
    return hdr.n_skeletons, hdr.n_joints, list(joints)
