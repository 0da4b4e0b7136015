"""Fixed-capacity SoA point buffers on a torch device.

The port of cwipc_util_tpu/core/buffers.py.  A cloud is a fixed-capacity
structure of arrays on one device:

* ``xyz``   — float32 ``[capacity, 3]`` positions,
* ``rgba``  — int32 ``[capacity]`` holding the uint32 bit pattern
  ``tile<<24 | r<<16 | g<<8 | b`` (PCL's layout, as in the JAX package).
  It rides as int32 because torch on the CPU cannot shift a uint32
  tensor; the numpy boundary converts with ``.view``, so no bit changes.
  The tile byte is ``(rgba >> 24) & 0xFF``: the arithmetic shift fills the
  high bits with the sign, and the mask removes them.
* ``count`` — 0-d int32 tensor on the same device, the number of valid
  points.  Kernels read it through a pointer, so an op chain never waits
  for the host.

The device is explicit: converters take ``device``; ``None`` means CUDA
and raises :class:`CwipcError` where there is none.  The CPU is used only
when asked for by name.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .errors import CwipcError

# The reference's external point record: 16 bytes, little-endian
# (include/cwipc_util/api.h:88-96).
POINT_DTYPE = np.dtype(
    [
        ("x", "<f4"),
        ("y", "<f4"),
        ("z", "<f4"),
        ("r", "u1"),
        ("g", "u1"),
        ("b", "u1"),
        ("tile", "u1"),
    ]
)
POINT_SIZE = 16
assert POINT_DTYPE.itemsize == POINT_SIZE

MIN_CAPACITY = 128


def resolve_device(device=None) -> torch.device:
    """The device a new buffer goes to: CUDA unless another is named."""
    if device is None:
        if not torch.cuda.is_available():
            raise CwipcError(
                "cwipc_util_tpu_torch: no CUDA device; pass device='cpu' to"
                " run on the host"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CwipcError(f"cwipc_util_tpu_torch: device {dev} asked for, but CUDA is not available")
    return dev


def bucket_capacity(n: int) -> int:
    """Smallest power-of-two capacity >= n (min MIN_CAPACITY)."""
    n = int(n)
    if n <= MIN_CAPACITY:
        return MIN_CAPACITY
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class PointBuffer:
    """Device-resident SoA point cloud with padding + valid count."""

    xyz: torch.Tensor  # f32 [capacity, 3]
    rgba: torch.Tensor  # i32 [capacity], uint32 bit pattern
    count: torch.Tensor  # i32 0-d

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, dtype=torch.int32, device=self.device) < self.count

    def to_numpy_arrays(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """(xyz f32 [cap, 3], rgba uint32 [cap], count): the arguments of
        :func:`buffer_from_arrays`, and what ``np.asarray`` gives for the
        JAX package's buffer fields."""
        xyz = self.xyz.cpu().numpy()
        rgba = self.rgba.cpu().numpy().view(np.uint32)
        return xyz, rgba, int(self.count)


def pack_rgba(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """Pack int32 channels (values 0..255) into the int32 rgba word."""
    return (tile << 24) | (r << 16) | (g << 8) | b


def unpack_rgba(rgba: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unpack the int32 rgba word into (r, g, b, tile) int32 tensors."""
    r = (rgba >> 16) & 0xFF
    g = (rgba >> 8) & 0xFF
    b = rgba & 0xFF
    tile = (rgba >> 24) & 0xFF
    return r, g, b, tile


def buffer_from_arrays(xyz: np.ndarray, rgba_u32: np.ndarray, count: int, device=None) -> PointBuffer:
    """Build a buffer from host arrays of the full capacity: xyz f32
    [cap, 3], rgba uint32 [cap] and the valid count, as the JAX package's
    ``PointBuffer`` fields give them after ``np.asarray``/``int``."""
    dev = resolve_device(device)
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    rgba = np.ascontiguousarray(rgba_u32, dtype=np.uint32).view(np.int32)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or rgba.shape != (xyz.shape[0],):
        raise CwipcError(f"buffer_from_arrays: shapes {xyz.shape} and {rgba.shape} do not match")
    if not 0 <= int(count) <= xyz.shape[0]:
        raise CwipcError(f"buffer_from_arrays: count {count} outside [0, {xyz.shape[0]}]")
    return PointBuffer(
        xyz=torch.from_numpy(xyz.copy()).to(dev),
        rgba=torch.from_numpy(rgba.copy()).to(dev),
        count=torch.tensor(int(count), dtype=torch.int32, device=dev),
    )


def buffer_from_numpy(points: np.ndarray, capacity: int | None = None, device=None) -> PointBuffer:
    """Build a buffer from a structured array with POINT_DTYPE fields,
    padded to a capacity bucket."""
    if points.dtype != POINT_DTYPE:
        points = points.astype(POINT_DTYPE, copy=False)
    n = int(points.shape[0])
    cap = bucket_capacity(n) if capacity is None else capacity
    if cap < n:
        raise CwipcError(f"buffer_from_numpy: capacity {cap} < {n} points")
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n, 0] = points["x"]
    xyz[:n, 1] = points["y"]
    xyz[:n, 2] = points["z"]
    rgba = np.zeros((cap,), np.uint32)
    rgba[:n] = (
        (points["tile"].astype(np.uint32) << 24)
        | (points["r"].astype(np.uint32) << 16)
        | (points["g"].astype(np.uint32) << 8)
        | points["b"].astype(np.uint32)
    )
    return buffer_from_arrays(xyz, rgba, n, device)


def buffer_to_numpy(buf: PointBuffer) -> np.ndarray:
    """Copy a buffer back to a host structured array (trimmed to count)."""
    xyz, rgba, n = buf.to_numpy_arrays()
    out = np.zeros(n, POINT_DTYPE)
    out["x"] = xyz[:n, 0]
    out["y"] = xyz[:n, 1]
    out["z"] = xyz[:n, 2]
    rgba = rgba[:n]
    out["r"] = (rgba >> 16) & 0xFF
    out["g"] = (rgba >> 8) & 0xFF
    out["b"] = rgba & 0xFF
    out["tile"] = (rgba >> 24) & 0xFF
    return out


def buffer_from_bytes(
    data: bytes | bytearray | memoryview, capacity: int | None = None, device=None
) -> PointBuffer:
    """Build a buffer from packed 16-byte point records."""
    arr = np.frombuffer(bytes(data), dtype=POINT_DTYPE)
    return buffer_from_numpy(arr, capacity, device)


def buffer_to_bytes(buf: PointBuffer) -> bytearray:
    """Serialize a buffer to packed 16-byte point records."""
    return bytearray(buffer_to_numpy(buf).tobytes())
