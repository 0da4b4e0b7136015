"""Point-cloud compression codec: the CTC1 format, on PyTorch.

The port of cwipc_util_tpu/codec/__init__.py, with the same API surface
(``cwipc_encoder_params``, ``cwipc_new_encoder``, ``cwipc_new_encodergroup``,
``cwipc_new_decoder``) and the same byte stream: the two packages decode
each other's streams, and encode a cloud to the same bytes by the same
route.

* Geometry: the cloud is quantized at ``octree_bits`` depth.  A CUDA cloud
  runs the device program ``_encode_device_impl``: bounding box, step, the
  tile mask's compaction (kernel 3, ``ops/compaction.py``), the
  Morton-sort downsample (kernel 1, ``ops/voxelize.py``; the exact-key form
  at 10 bits) and the rebased Morton keys' deltas, then one host read of
  (count, deltas, rgba, step, vmin).  A CPU cloud runs the host twin
  ``_geometry_host``, as the JAX package does on its CPU backend.  Above
  10 bits the 45-bit keys are built on the host (``_feed_wide``).
* The host stage packs the sorted keys into an octree occupancy-byte
  stream, the colors into a JPEG plane in Morton order (or zlib bytes
  where that is smaller or cv2 is missing) and the tiles into zlib bytes.
* The native shim (``cwipc_util_tpu/native``, through ``util.py``) runs
  the host geometry stage, the octree pack/unpack and the decode tail in
  C; where it cannot be built or loaded, the numpy twins run, bit for bit
  the same.

The wire format ("CTC1") is the JAX package's own, deliberately not
bit-compatible with the reference's MPEG-anchor codec.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core.buffers import POINT_DTYPE, PointBuffer, resolve_device
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..ops import compaction
from ..ops.voxelize import downsample, morton3

MAGIC = b"CTC1"
_HDR_FMT = "<4sBBHIQ4fIII"
_HDR_SIZE = struct.calcsize(_HDR_FMT)

# header flag bits
# delta element width code: 0=u32 (legacy streams have flags==0), 1=u8,
# 2=u16, 3=u64
_FLAG_WIDTH_MASK = 0x03
_WIDTH_DTYPES = {0: np.uint32, 1: np.uint8, 2: np.uint16, 3: np.uint64}
_FLAG_WIDE_KEYS = 0x04  # 45-bit Morton keys (octree_bits > 10)
_FLAG_OCTREE = 0x08  # geometry = octree occupancy-byte stream (not deltas)
_FLAG_JPEG = 0x10  # colors = JPEG plane in Morton order (not zlib bytes)

_SENTINEL = 2**31 - 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the native shim's codec entry points: name -> argument types (all return int)
_NATIVE_SIGNATURES = {
    # keys int64 [n], n, depth, out uint8 -> bytes written
    "cwipc_enc_octree": (_P, _I, _I, _P),
    # stream, len, depth, keys int64 out, n -> keys decoded
    "cwipc_dec_octree": (_P, _I, _I, _P, _I),
    # points, n, tilemask, bits, exp_factor, voxelsize, keys, drgba, vmin, step* -> voxels
    "cwipc_enc_geometry": (_P, _I, ctypes.c_uint32, _I, _F, _F, _P, _P, _P, ctypes.POINTER(_F)),
    # occ, len, depth, wide, step, origin, colors, is_bgr, tiles, points out, n -> points
    "cwipc_dec_geometry": (_P, _I, _I, _I, _F, _P, _P, _I, _P, _P, _I),
}
_native_fns: dict = {}


def _native(name: str):
    """The ctypes function ``name`` of the native shim, or None where the
    shim cannot be built or loaded (the numpy twins then run)."""
    if name not in _native_fns:
        from ..util import cwipc_util_dll_load

        try:
            fn = getattr(cwipc_util_dll_load(), name)
        except (CwipcError, OSError, AttributeError):
            fn = None
        else:
            fn.argtypes = list(_NATIVE_SIGNATURES[name])
            fn.restype = ctypes.c_int
        _native_fns[name] = fn
    return _native_fns[name]


def native_loaded() -> bool:
    """Whether the native shim's codec entry points are in use."""
    return all(_native(name) is not None for name in _NATIVE_SIGNATURES)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _octree_pack_numpy(keys: np.ndarray, depth: int) -> np.ndarray:
    """Occupancy-byte stream (root-first) for sorted unique Morton keys.

    Level L holds one byte per occupied node: the 8-bit mask of occupied
    children.  Children of one node are consecutive in the Morton-sorted
    stream, so the masks are a bitwise_or.reduceat away."""
    levels = []
    cur = keys.astype(np.int64)
    for _ in range(depth):
        parents = cur >> 3
        child_bit = np.left_shift(np.uint8(1), (cur & 7).astype(np.uint8))
        newp = np.empty(len(cur), bool)
        newp[0] = True
        np.not_equal(parents[1:], parents[:-1], out=newp[1:])
        starts = np.nonzero(newp)[0]
        levels.append(np.bitwise_or.reduceat(child_bit, starts))
        cur = parents[starts]
    levels.reverse()
    return np.concatenate(levels)


def _octree_pack(keys: np.ndarray, depth: int) -> np.ndarray:
    """_octree_pack_numpy, in one C pass where the shim is loaded."""
    fn = _native("cwipc_enc_octree")
    if fn is not None and len(keys) and depth <= 15:
        k64 = np.ascontiguousarray(keys, np.int64)
        out = np.empty(len(keys) * depth + depth, np.uint8)
        total = fn(_ptr(k64), len(k64), depth, _ptr(out))
        if total >= 0:
            return out[:total]
    return _octree_pack_numpy(keys, depth)


# Per-byte expansion tables for _octree_unpack_numpy: for every occupancy
# mask value, the count of set bits and the set-bit indices packed as
# nibbles (ascending).
_OCC_COUNT = np.array([bin(m).count("1") for m in range(256)], np.int64)
_OCC_PACK = np.array(
    [
        sum(b << (4 * i) for i, b in enumerate(j for j in range(8) if m >> j & 1))
        for m in range(256)
    ],
    np.int64,
)


def _octree_unpack_numpy(stream: np.ndarray, depth: int, n: int) -> np.ndarray:
    """Inverse of _octree_pack_numpy: sorted unique keys from the byte stream."""
    cur = np.zeros(1, np.int64)
    pos = 0
    for level in range(depth):
        nn = len(cur)
        if pos + nn > len(stream):
            raise CwipcError("cwipc_decoder: truncated octree stream")
        masks = stream[pos : pos + nn]
        pos += nn
        counts = _OCC_COUNT[masks]
        total = int(counts.sum())
        # rank of each child within its node: position minus its node's start
        starts = np.repeat(np.cumsum(counts) - counts, counts)
        rank = np.arange(total, dtype=np.int64) - starts
        if level <= 9:
            # parent keys (<= 30 bits here) fit above the 32-bit nibble
            # pack: one repeat carries both
            combo = np.repeat((cur << 35) | _OCC_PACK[masks], counts)
            child = (combo >> (rank << 2)) & 7
            cur = (combo >> 32) | child
        else:  # deep wide-key levels: parents would overflow the combo
            parent_rep = np.repeat(cur << 3, counts)
            pack_rep = np.repeat(_OCC_PACK[masks], counts)
            child = (pack_rep >> (rank << 2)) & 7
            cur = parent_rep | child
    if pos != len(stream) or len(cur) != n:
        raise CwipcError("cwipc_decoder: inconsistent octree stream")
    return cur


def _octree_unpack(stream: np.ndarray, depth: int, n: int) -> np.ndarray:
    """_octree_unpack_numpy, in one C pass where the shim is loaded."""
    fn = _native("cwipc_dec_octree")
    if fn is not None and depth <= 15 and n > 0:
        sarr = np.ascontiguousarray(stream, np.uint8)
        keys = np.empty(n, np.int64)
        if fn(_ptr(sarr), len(sarr), depth, _ptr(keys), n) == n:
            return keys
        raise CwipcError("cwipc_decoder: inconsistent octree stream")
    return _octree_unpack_numpy(stream, depth, n)


def jpeg_available() -> bool:
    """Whether cv2 is importable, so colors may go as a JPEG plane."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def _jpeg_pack(rgb: np.ndarray, quality: int) -> Optional[bytes]:
    """Colors as a JPEG plane in Morton order (spatially local, so JPEG's
    DCT blocks see smooth gradients).  None where cv2 is unavailable: the
    colors then go lossless through zlib."""
    try:
        import cv2
    except ImportError:
        return None
    m = rgb.shape[0]
    w = max(16, int(np.ceil(np.sqrt(m) / 16.0)) * 16)
    h = (m + w - 1) // w
    img = np.zeros((h * w, 3), np.uint8)
    img[:m] = rgb[:, ::-1]  # cv2 is BGR
    img[m:] = rgb[-1, ::-1] if m else 0  # edge-pad: compresses to nothing
    ok, blob = cv2.imencode(
        ".jpg", img.reshape(h, w, 3), [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]
    )
    return blob.tobytes() if ok else None


def _jpeg_unpack_bgr(blob: bytes, n: int) -> np.ndarray:
    """Decode the JPEG color plane to an [n, 3] BGR array."""
    try:
        import cv2
    except ImportError as e:
        raise CwipcError("cwipc_decoder: JPEG colors need cv2") from e
    img = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise CwipcError("cwipc_decoder: corrupt JPEG color plane")
    bgr = img.reshape(-1, 3)
    if bgr.shape[0] < n:
        raise CwipcError("cwipc_decoder: JPEG color plane too small")
    return bgr[:n]


def _spread1by4_64(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of int64 x with two zero bits between each."""
    x = x.astype(np.int64) & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _compact1by4_64(x: np.ndarray) -> np.ndarray:
    """Inverse of _spread1by4_64."""
    x = x.astype(np.int64) & 0x1249249249249249
    x = (x | (x >> 2)) & 0x10C30C30C30C30C3
    x = (x | (x >> 4)) & 0x100F00F00F00F00F
    x = (x | (x >> 8)) & 0x1F0000FF0000FF
    x = (x | (x >> 16)) & 0x1F00000000FFFF
    x = (x | (x >> 32)) & 0x1FFFFF
    return x


def _spread1by2_np(x: np.ndarray) -> np.ndarray:
    """Forward Morton bit-spread for 10-bit cell coordinates (host)."""
    x = x.astype(np.uint32)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


# the 10-bit spread as a table: one gather per axis
_SPREAD_TAB = _spread1by2_np(np.arange(1024, dtype=np.uint32))


def _compact1by2(x: np.ndarray) -> np.ndarray:
    """Inverse of the Morton bit-spread: extract every third bit."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


# the cell coordinates of each 15-bit half of a 30-bit Morton code, packed
# (x5 | y5 << 10 | z5 << 20): two gathers decode a code
_H15 = np.arange(1 << 15, dtype=np.uint32)
_MORTON_TABLE = _compact1by2(_H15) | (_compact1by2(_H15 >> 1) << 10) | (_compact1by2(_H15 >> 2) << 20)
del _H15


def _morton_to_cells(morton: np.ndarray) -> tuple:
    """All three cell coordinates of 30-bit Morton codes."""
    m = morton.astype(np.uint32)
    packed = _MORTON_TABLE[m & 0x7FFF] | (_MORTON_TABLE[(m >> 15) & 0x7FFF] << 5)
    return packed & 0x3FF, (packed >> 10) & 0x3FF, (packed >> 20) & 0x3FF


def _geometry_numpy(arr: np.ndarray, *, octree_bits: int, exp_factor: float, voxelsize: float,
                    tilemask: int):
    """The host geometry stage in numpy, for octree_bits <= 10: the device
    program's f32 bbox and step arithmetic, cell quantization and clamping,
    PCL-truncated mean colors and OR'd tiles, quantizing the raw points.
    Returns (m, sorted unique keys int64, drgba uint32, step, vmin int32
    [3]); m == 0 for an empty (post-tilefilter) cloud."""
    if tilemask:
        arr = arr[(arr["tile"].astype(np.uint32) & np.uint32(tilemask)) != 0]
    n = arr.shape[0]
    zero3 = np.zeros(3, np.int32)
    if n == 0:
        return 0, None, None, 0.0, zero3
    axes = [np.ascontiguousarray(arr[f]) for f in ("x", "y", "z")]
    extent = np.maximum(
        np.float32(max(np.float32(a.max()) - np.float32(a.min()) for a in axes))
        * np.float32(max(exp_factor, 1.0)),
        np.float32(1e-6),
    )
    step = extent / np.float32(1 << octree_bits)
    if voxelsize > 0:
        step = np.maximum(step, np.float32(voxelsize))
    cap = (1 << min(octree_bits, 10)) - 1
    vmin = np.empty(3, np.int32)
    key = np.zeros(n, np.uint32)
    for axis, a in enumerate(axes):
        v = np.floor(a / step).astype(np.int32)
        vmin[axis] = v.min()
        key |= _SPREAD_TAB[np.clip(v - vmin[axis], 0, cap)] << np.uint32(axis)
    # (key, index) packed into one int64 and sorted: the order and the
    # sorted keys in one sort
    k64 = (key.astype(np.int64) << 32) | np.arange(n, dtype=np.int64)
    k64.sort()
    order = (k64 & 0xFFFFFFFF).astype(np.int64)
    ks = (k64 >> 32).astype(np.uint32)
    starts = np.flatnonzero(np.concatenate(([True], ks[1:] != ks[:-1])))
    counts = np.diff(np.append(starts, n)).astype(np.float32)
    m = len(starts)
    ends = np.append(starts[1:], n) - 1
    tile_s = np.ascontiguousarray(arr["tile"])[order]
    # per-voxel channel sums as differences of an int32 inclusive cumsum
    # (exact, wraparound included)
    chans = []
    for f in ("r", "g", "b"):
        cf = np.ascontiguousarray(arr[f])[order].astype(np.int32)
        cs = np.cumsum(cf, dtype=np.int32)
        srun = cs[ends] - cs[starts] + cf[starts]
        chans.append((srun.astype(np.float32) / counts).astype(np.uint32))
    mr, mg, mb = chans
    tile_or = np.bitwise_or.reduceat(tile_s, starts).astype(np.uint32)
    drgba = (tile_or << 24) | (mr << 16) | (mg << 8) | mb
    return m, ks[starts].astype(np.int64), drgba, float(step), vmin


def _geometry_host(pc: cwipc_pointcloud_wrapper, *, octree_bits: int, exp_factor: float, voxelsize: float,
                   tilemask: int):
    """The host geometry stage of a CPU cloud: the shim's
    ``cwipc_enc_geometry`` where it is loaded, else ``_geometry_numpy``
    (the same results)."""
    arr = pc._numpy()  # the wrapper's host cache; read-only here
    fn = _native("cwipc_enc_geometry") if octree_bits <= 10 else None
    if fn is not None:
        carr = np.ascontiguousarray(arr)
        n_all = carr.shape[0]
        keys = np.empty(max(n_all, 1), np.int64)
        drgba = np.empty(max(n_all, 1), np.uint32)
        vmin = np.zeros(3, np.int32)
        step_c = ctypes.c_float(0.0)
        m = fn(_ptr(carr), n_all, ctypes.c_uint32(tilemask), octree_bits, ctypes.c_float(max(exp_factor, 1.0)),
               ctypes.c_float(voxelsize), _ptr(keys), _ptr(drgba), _ptr(vmin), ctypes.byref(step_c))
        if m == 0:
            return 0, None, None, 0.0, np.zeros(3, np.int32)
        if m > 0:
            return m, keys[:m], drgba[:m], float(step_c.value), vmin
        # m < 0: arguments the shim refuses; the numpy twin takes them
    return _geometry_numpy(arr, octree_bits=octree_bits, exp_factor=exp_factor, voxelsize=voxelsize,
                           tilemask=tilemask)


def _encode_device_impl(xyz, rgba, count, *, octree_bits, exp_factor, voxelsize, tilemask):
    """The geometry stage as one device program: bounding box ->
    quantization step -> voxel-merge downsample (centroids already in
    Morton order) -> rebased Morton keys -> first-order deltas.  Returns
    (count, deltas, rgba, step, vmin) as tensors on the input's device;
    nothing here reads the device from the host.

    The downsample's output order is by floor(xyz/step) rebased to the
    occupied minimum cell, and the minimum occupied cell survives
    downsampling (its centroid stays inside it), so floor(centroid/step) -
    min reproduces the internal keys and the deltas are non-negative.  The
    step is computed in f32 here and handed to the downsample as a 0-dim
    tensor, as the JAX program does, so it and the stream are bit-equal to
    the JAX package's.
    """
    buf = PointBuffer(xyz=xyz, rgba=rgba, count=count)
    if tilemask:
        keep = (((rgba >> 24) & 0xFF) & int(tilemask)) != 0
        buf = compaction.compact(buf, keep & buf.valid_mask())
    valid = buf.valid_mask()[:, None]
    big = 3.0e38
    lo = torch.where(valid, buf.xyz, big).amin(dim=0)
    hi = torch.where(valid, buf.xyz, -big).amax(dim=0)
    extent = torch.clamp_min((hi - lo).amax() * max(exp_factor, 1.0), 1e-6)
    step = extent / (1 << octree_bits)
    if voxelsize > 0:
        step = torch.clamp_min(step, float(np.float32(voxelsize)))

    exact = octree_bits >= 10
    down = downsample(buf, step, exact_keys=exact, merged_exact=exact)
    dvalid = down.valid_mask()
    v = torch.floor(down.xyz / step).to(torch.int32)
    vmin = torch.where(dvalid[:, None], v, _SENTINEL).amin(dim=0)
    vmin = torch.where(vmin == _SENTINEL, 0, vmin)
    vr = torch.clamp(v - vmin, 0, (1 << min(octree_bits, 10)) - 1)
    mkey = torch.where(dvalid, morton3(vr[:, 0], vr[:, 1], vr[:, 2]), 0)
    deltas = torch.cat([mkey[:1], torch.diff(mkey)])
    return down.count, deltas, down.rgba, step, vmin


def _readback(t: torch.Tensor) -> np.ndarray:
    """The encoder's one host read a frame."""
    return t.cpu().numpy()


def _geometry_device(pc: cwipc_pointcloud_wrapper, *, octree_bits: int, exp_factor: float, tilemask: int,
                     voxelsize: float = 0.0):
    """The device program on the cloud's buffer and its one host read:
    (m, deltas uint32 [m], drgba uint32 [m], step, origin f64 [3])."""
    buf = pc._access_buffer()
    count, deltas, drgba, step, vmin = _encode_device_impl(
        buf.xyz, buf.rgba, buf.count, octree_bits=octree_bits, exp_factor=exp_factor, voxelsize=voxelsize,
        tilemask=tilemask)
    cap = deltas.shape[0]
    host = _readback(torch.cat([count.view(1), step.view(torch.int32).view(1), vmin, deltas, drgba]))
    m = int(host[0])
    step_f = float(host[1:2].view(np.float32)[0])
    origin = host[2:5].astype(np.float64) * step_f
    words = host.view(np.uint32)
    return m, words[5:5 + m], words[5 + cap:5 + cap + m], step_f, origin


def _empty_stream(octree_bits: int, pc: cwipc_pointcloud_wrapper) -> bytes:
    return struct.pack(_HDR_FMT, MAGIC, octree_bits, 0, 0, 0, pc.timestamp(), pc.cellsize(), 0.0, 0.0, 0.0,
                       0, 0, 0)


def _on_device(pc: cwipc_pointcloud_wrapper) -> bool:
    """The route of a cloud: the device program for a CUDA cloud, the host
    twin for a CPU one."""
    return pc._device is not None and pc._device.type == "cuda"


@dataclass
class cwipc_encoder_params:
    """Encoder parameters, field-compatible with the reference's struct
    (do_inter_frame, gop_size, exp_factor, octree_bits, jpeg_quality,
    macroblock_size, tilenumber, voxelsize)."""

    do_inter_frame: bool = False
    gop_size: int = 1
    exp_factor: float = 1.0
    octree_bits: int = 9
    jpeg_quality: int = 85
    macroblock_size: int = 16
    tilenumber: int = 0
    voxelsize: float = 0.0


class cwipc_encoder_wrapper:
    """Single-quality encoder; feed() compresses one cloud per call."""

    def __init__(self, params: Optional[cwipc_encoder_params] = None, **kw):
        if params is None:
            params = cwipc_encoder_params(**kw)
        self.params = params
        self._result: Optional[bytes] = None
        # deflate level from jpeg_quality: high quality buys more effort
        self._zlevel = 1 if params.jpeg_quality <= 90 else 6

    def free(self, *, force: bool = False) -> None:
        self._result = None

    def feed(self, pc: cwipc_pointcloud_wrapper) -> None:
        if self.params.octree_bits > 10:
            self._feed_wide(pc)
        elif _on_device(pc):
            self._feed_device(pc)
        else:
            self._feed_host(pc)

    def _geometry_args(self) -> dict:
        p = self.params
        return dict(octree_bits=p.octree_bits, exp_factor=float(max(p.exp_factor, 1.0)),
                    voxelsize=float(p.voxelsize), tilemask=int(p.tilenumber))

    def _feed_host(self, pc: cwipc_pointcloud_wrapper) -> None:
        """octree_bits <= 10 through the host twin (a CPU cloud)."""
        p = self.params
        m, keys, drgba, step, vmin = _geometry_host(pc, **self._geometry_args())
        if m == 0:
            self._result = _empty_stream(p.octree_bits, pc)
            return
        origin = vmin.astype(np.float64) * step
        self._result = self._pack(p, m, pc.timestamp(), step, origin, None, drgba, wide=False, keys=keys)

    def _feed_device(self, pc: cwipc_pointcloud_wrapper) -> None:
        """octree_bits <= 10 through the device program (a CUDA cloud; on
        a CPU cloud the kernels' plain versions run)."""
        p = self.params
        m, deltas, drgba, step, origin = _geometry_device(pc, **self._geometry_args())
        if m == 0:
            self._result = _empty_stream(p.octree_bits, pc)
            return
        self._result = self._pack(p, m, pc.timestamp(), step, origin, deltas, drgba, wide=False)

    def _feed_wide(self, pc: cwipc_pointcloud_wrapper) -> None:
        """octree_bits in (10, 15]: 45-bit Morton keys on the host (int64)."""
        p = self.params
        arr = pc.get_numpy_array()
        if p.tilenumber != 0:
            arr = arr[(arr["tile"] & p.tilenumber) != 0]
        n = arr.shape[0]
        if n == 0:
            self._result = _empty_stream(p.octree_bits, pc)
            return
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float64)
        lo = xyz.min(axis=0)
        extent = max(float((xyz.max(axis=0) - lo).max()) * max(p.exp_factor, 1.0), 1e-6)
        step = extent / (1 << p.octree_bits)
        if p.voxelsize > 0:
            step = max(step, p.voxelsize)
        coords = np.clip(
            np.floor((xyz - lo[None, :]) / step).astype(np.int64),
            0, (1 << p.octree_bits) - 1,
        )
        morton = (
            (_spread1by4_64(coords[:, 2]) << 2)
            | (_spread1by4_64(coords[:, 1]) << 1)
            | _spread1by4_64(coords[:, 0])
        )
        # merge duplicate voxels: mean color, OR'd tiles
        order = np.argsort(morton, kind="stable")
        morton = morton[order]
        rgba = (
            (arr["tile"].astype(np.uint32) << 24)
            | (arr["r"].astype(np.uint32) << 16)
            | (arr["g"].astype(np.uint32) << 8)
            | arr["b"].astype(np.uint32)
        )[order]
        new = np.empty(n, bool)
        new[0] = True
        np.not_equal(morton[1:], morton[:-1], out=new[1:])
        seg = np.cumsum(new) - 1
        m = int(seg[-1]) + 1
        counts = np.bincount(seg, minlength=m)
        mr = np.bincount(seg, ((rgba >> 16) & 0xFF).astype(np.float64), m) / counts
        mg = np.bincount(seg, ((rgba >> 8) & 0xFF).astype(np.float64), m) / counts
        mb = np.bincount(seg, (rgba & 0xFF).astype(np.float64), m) / counts
        tile_or = np.zeros(m, np.uint32)
        np.bitwise_or.at(tile_or, seg, (rgba >> 24) & 0xFF)
        drgba = (
            (tile_or << 24)
            | (mr.astype(np.uint32) << 16)
            | (mg.astype(np.uint32) << 8)
            | mb.astype(np.uint32)
        )
        self._result = self._pack(p, m, pc.timestamp(), step, lo, None, drgba, wide=True, keys=morton[new])

    def _pack(self, p, m, timestamp, step, origin, deltas, drgba, *, wide, keys=None):
        """Entropy stage: octree occupancy-byte geometry + JPEG color
        plane + zlib tile bytes (each with a lossless fallback).

        Callers holding the sorted keys pass them as ``keys`` (``deltas``
        is then unused); the device readback passes ``deltas`` and the
        keys are rebuilt by a wrapping uint32 cumsum."""
        flags = _FLAG_WIDE_KEYS if wide else 0
        if keys is not None:
            keys = keys.astype(np.int64, copy=False)
            depth = int(p.octree_bits) if wide else min(int(p.octree_bits), 10)
        elif wide:
            keys = np.cumsum(deltas.astype(np.int64), dtype=np.int64)
            depth = int(p.octree_bits)
        else:
            keys = np.cumsum(deltas.astype(np.uint32), dtype=np.uint32).astype(np.int64)
            depth = min(int(p.octree_bits), 10)
        # The octree stream is defined on sorted-unique keys: centroid
        # roundoff can make a key locally non-monotone, and far-edge
        # clamping can merge boundary voxels.  Re-sort only where the
        # keys are not already strictly increasing.
        if m > 1 and not bool(np.all(np.diff(keys) > 0)):
            uniq, first = np.unique(keys, return_index=True)
            keys = uniq
            drgba = drgba[first]
            m = len(uniq)
        occ = _octree_pack(keys, depth)
        pos_octree = zlib.compress(occ.tobytes(), self._zlevel)
        # adaptive-width delta stream: worth computing for small clouds only
        pos_blob = pos_octree
        flags |= _FLAG_OCTREE
        if m < 2048:
            deltas = np.diff(keys, prepend=np.int64(0))
            dmax = int(deltas.max()) if m else 0
            if dmax < 0x100:
                width, darr = 1, deltas.astype(np.uint8)
            elif dmax < 0x10000:
                width, darr = 2, deltas.astype(np.uint16)
            elif dmax < 2**32:
                width, darr = 0, deltas.astype(np.uint32)
            else:
                width, darr = 3, deltas.astype(np.uint64)
            pos_delta = zlib.compress(darr.tobytes(), self._zlevel)
            if len(pos_delta) < len(pos_octree):
                flags = (flags & ~_FLAG_OCTREE) | width
                pos_blob = pos_delta

        rgb = np.empty((m, 3), np.uint8)
        rgb[:, 0] = (drgba >> 16) & 0xFF
        rgb[:, 1] = (drgba >> 8) & 0xFF
        rgb[:, 2] = drgba & 0xFF
        col_jpeg = _jpeg_pack(rgb, p.jpeg_quality) if p.jpeg_quality < 100 else None
        if col_jpeg is not None and len(col_jpeg) < 3 * m // 2:
            # clearly winning: skip deflating the raw bytes
            flags |= _FLAG_JPEG
            col_blob = col_jpeg
        else:
            col_zlib = zlib.compress(rgb.tobytes(), self._zlevel)
            if col_jpeg is not None and len(col_jpeg) < len(col_zlib):
                flags |= _FLAG_JPEG
                col_blob = col_jpeg
            else:
                col_blob = col_zlib

        tiles = ((drgba >> 24) & 0xFF).astype(np.uint8)
        tile_blob = zlib.compress(tiles.tobytes(), self._zlevel)
        hdr = struct.pack(
            _HDR_FMT, MAGIC, p.octree_bits, flags, 0, m, timestamp,
            float(step), float(origin[0]), float(origin[1]), float(origin[2]),
            len(pos_blob), len(col_blob), len(tile_blob),
        )
        return hdr + pos_blob + col_blob + tile_blob

    def available(self, wait: bool = False) -> bool:
        return self._result is not None

    def get_encoded_size(self) -> int:
        return len(self._result) if self._result else 0

    def get_bytes(self) -> bytes:
        if self._result is None:
            raise CwipcError("cwipc_encoder: no encoded data available")
        rv = self._result
        self._result = None
        return rv

    def at_gop_boundary(self) -> bool:
        return True


class cwipc_encodergroup_wrapper:
    """Fan-out: one feed() compresses the cloud with every added encoder."""

    def __init__(self) -> None:
        self._encoders: List[cwipc_encoder_wrapper] = []

    def addencoder(self, version: int = 1, params: Optional[cwipc_encoder_params] = None,
                   **kw) -> cwipc_encoder_wrapper:
        enc = cwipc_encoder_wrapper(params=params, **kw)
        self._encoders.append(enc)
        return enc

    def feed(self, pc: cwipc_pointcloud_wrapper) -> None:
        # Shared-core multi-quality encode: members that differ only in
        # octree depth or jpeg quality share one geometry pass at the
        # deepest level, and each coarser level is derived on the host:
        # morton(x >> d) == morton(x) >> 3d, so ancestor keys are a shift
        # away, colors become unweighted child means and tiles OR together.
        groups: dict = {}
        for enc in self._encoders:
            p = enc.params
            if 0 < p.octree_bits <= 10 and p.voxelsize <= 0:
                key = (int(p.tilenumber), float(max(p.exp_factor, 1.0)))
                groups.setdefault(key, []).append(enc)
            else:
                enc.feed(pc)  # wide or voxelsize-bound: independent path
        for (tilemask, expf), encs in groups.items():
            if len(encs) == 1:
                encs[0].feed(pc)
            else:
                self._feed_group(pc, encs, tilemask, expf)

    def _feed_group(self, pc, encs, tilemask: int, expf: float) -> None:
        ob_max = max(e.params.octree_bits for e in encs)
        ts = pc.timestamp()
        # the solo encoder's route, so the deepest member stays bit-equal to
        # a solo encode on either route
        if _on_device(pc):
            m, deltas, drgba, step, origin = _geometry_device(pc, octree_bits=ob_max, exp_factor=expf,
                                                              tilemask=tilemask)
            if m:
                # sorted-unique fine keys (the cleanup _pack applies)
                keys = np.cumsum(deltas, dtype=np.uint32).astype(np.int64)
                uniq, first = np.unique(keys, return_index=True)
                if len(uniq) != m or not np.array_equal(uniq, keys):
                    keys, drgba, m = uniq, drgba[first], len(uniq)
        else:
            m, keys, drgba, step, vmin = _geometry_host(pc, octree_bits=ob_max, exp_factor=expf, voxelsize=0.0,
                                                        tilemask=tilemask)
            origin = vmin.astype(np.float64) * step if m else np.zeros(3)
        if m == 0:
            for e in encs:
                e._result = _empty_stream(e.params.octree_bits, pc)
            return
        for e in encs:
            p = e.params
            d = ob_max - p.octree_bits
            if d == 0:
                ke, rg, me = keys, drgba, m
            else:
                ck = keys >> (3 * d)  # ancestor keys, still sorted
                starts = np.flatnonzero(np.diff(ck, prepend=ck[0] - 1))
                me = len(starts)
                counts = np.diff(np.append(starts, m))
                r = np.add.reduceat((drgba >> 16) & 0xFF, starts) / counts
                g = np.add.reduceat((drgba >> 8) & 0xFF, starts) / counts
                b = np.add.reduceat(drgba & 0xFF, starts) / counts
                t = np.bitwise_or.reduceat(((drgba >> 24) & 0xFF).astype(np.uint32), starts)
                rg = (
                    (t.astype(np.uint32) << 24)
                    | (np.round(r).astype(np.uint32) << 16)
                    | (np.round(g).astype(np.uint32) << 8)
                    | np.round(b).astype(np.uint32)
                )
                ke = ck[starts]
            de = np.diff(ke, prepend=np.int64(0))
            e._result = e._pack(p, me, ts, step * (1 << d), origin, de, rg, wide=False)

    def close(self) -> None:
        self._encoders = []

    def free(self, *, force: bool = False) -> None:
        self.close()


class cwipc_decoder_wrapper:
    """Decoder for the CTC1 format.  Each decoded cloud is host-backed and
    builds its buffer on ``device`` (``None`` means CUDA) at first use."""

    def __init__(self, device=None) -> None:
        self._device = resolve_device(device)
        self._result: Optional[cwipc_pointcloud_wrapper] = None

    def free(self, *, force: bool = False) -> None:
        self._result = None

    def _cloud(self, timestamp: int, step: float, pts: np.ndarray) -> cwipc_pointcloud_wrapper:
        return cwipc_pointcloud_wrapper(None, timestamp, step, _host_points=pts, device=self._device)

    def feed(self, data: bytes) -> None:
        if len(data) < _HDR_SIZE:
            raise CwipcError("cwipc_decoder: packet too short")
        (magic, octree_bits, flags, _res, n, timestamp, step, ox, oy, oz,
         lpos, lcol, ltile) = struct.unpack(_HDR_FMT, data[:_HDR_SIZE])
        if magic != MAGIC:
            # name the likely source of a foreign stream: the reference's
            # MPEG-anchor cwipc_codec plugin, whose bitstream CTC1 is not
            raise CwipcError(
                "cwipc_decoder: not a CTC1 stream (magic "
                f"{magic!r}, expected {MAGIC!r}). This framework's codec "
                "uses its own CTC1 wire format and cannot decode "
                "MPEG-anchor bitstreams produced by the reference "
                "cwipc_codec plugin; re-encode the source material with "
                "this framework's encoder."
            )
        off = _HDR_SIZE
        if n == 0:
            self._result = self._cloud(timestamp, step, np.zeros(0, POINT_DTYPE))
            return
        pos_blob = data[off : off + lpos]
        off += lpos
        col_blob = data[off : off + lcol]
        off += lcol
        tile_blob = data[off : off + ltile]

        fn = _native("cwipc_dec_geometry")
        if fn is not None and flags & _FLAG_OCTREE:
            pts = self._decode_native(fn, pos_blob, col_blob, tile_blob, octree_bits, flags, n, step,
                                      (ox, oy, oz))
        else:
            pts = self._decode_numpy(pos_blob, col_blob, tile_blob, octree_bits, flags, n, step, (ox, oy, oz))
        self._result = self._cloud(timestamp, step, pts)

    @staticmethod
    def _decode_native(fn, pos_blob, col_blob, tile_blob, octree_bits, flags, n, step, origin) -> np.ndarray:
        """The shim's fused decode tail (octree streams): occupancy
        expansion, Morton -> cell -> position and the point records in one
        C pass, with the numpy tail's arithmetic."""
        try:
            occ = np.frombuffer(zlib.decompress(pos_blob), np.uint8)
            tile_raw = zlib.decompress(tile_blob)
            if flags & _FLAG_JPEG:
                colarr = np.ascontiguousarray(_jpeg_unpack_bgr(col_blob, n))
                is_bgr = 1
            else:
                col_raw = zlib.decompress(col_blob)
                if len(col_raw) != n * 3:
                    raise CwipcError("cwipc_decoder: inconsistent stream sizes")
                colarr = np.frombuffer(col_raw, np.uint8).reshape(n, 3)
                is_bgr = 0
        except zlib.error as e:
            raise CwipcError(f"cwipc_decoder: corrupt stream: {e}") from e
        if len(tile_raw) != n:
            raise CwipcError("cwipc_decoder: inconsistent stream sizes")
        wide = int(bool(flags & _FLAG_WIDE_KEYS))
        depth = int(octree_bits) if wide else min(int(octree_bits), 10)
        tiles = np.frombuffer(tile_raw, np.uint8)
        origin = np.array(origin, np.float32)
        pts = np.empty(n, POINT_DTYPE)
        got = fn(_ptr(occ), len(occ), depth, wide, ctypes.c_float(step), _ptr(origin), _ptr(colarr), is_bgr,
                 _ptr(tiles), _ptr(pts), n)
        if got != n:
            raise CwipcError("cwipc_decoder: inconsistent octree stream")
        return pts

    @staticmethod
    def _decode_numpy(pos_blob, col_blob, tile_blob, octree_bits, flags, n, step, origin) -> np.ndarray:
        """The decode tail in numpy: every geometry and color form."""
        try:
            tile_raw = zlib.decompress(tile_blob)
            if flags & _FLAG_OCTREE:
                occ = np.frombuffer(zlib.decompress(pos_blob), np.uint8)
                depth = int(octree_bits) if flags & _FLAG_WIDE_KEYS else min(int(octree_bits), 10)
                morton = _octree_unpack(occ, depth, n)
            else:
                dtype = _WIDTH_DTYPES[flags & _FLAG_WIDTH_MASK]
                deltas = np.frombuffer(zlib.decompress(pos_blob), dtype)
                if deltas.shape[0] != n:
                    raise CwipcError("cwipc_decoder: inconsistent stream sizes")
                if flags & _FLAG_WIDE_KEYS:
                    morton = np.cumsum(deltas.astype(np.int64), dtype=np.int64)
                else:
                    morton = np.cumsum(deltas.astype(np.uint32), dtype=np.uint32)
            if flags & _FLAG_JPEG:
                rgb = _jpeg_unpack_bgr(col_blob, n)[:, ::-1]
            else:
                col_raw = zlib.decompress(col_blob)
                if len(col_raw) != n * 3:
                    raise CwipcError("cwipc_decoder: inconsistent stream sizes")
                rgb = np.frombuffer(col_raw, np.uint8).reshape(n, 3)
        except zlib.error as e:
            raise CwipcError(f"cwipc_decoder: corrupt stream: {e}") from e
        if len(tile_raw) != n:
            raise CwipcError("cwipc_decoder: inconsistent stream sizes")
        if flags & _FLAG_WIDE_KEYS:
            morton = morton.astype(np.int64)
            cx = _compact1by4_64(morton)
            cy = _compact1by4_64(morton >> 1)
            cz = _compact1by4_64(morton >> 2)
        else:
            cx, cy, cz = _morton_to_cells(morton)
        xyz = np.empty((n, 3), np.float32)
        xyz[:, 0] = cx
        xyz[:, 1] = cy
        xyz[:, 2] = cz
        xyz += 0.5
        xyz *= step
        xyz += np.array(origin, np.float32)
        pts = np.empty(n, POINT_DTYPE)
        pts["x"] = xyz[:, 0]
        pts["y"] = xyz[:, 1]
        pts["z"] = xyz[:, 2]
        pts["r"] = rgb[:, 0]
        pts["g"] = rgb[:, 1]
        pts["b"] = rgb[:, 2]
        pts["tile"] = np.frombuffer(tile_raw, np.uint8)
        return pts

    def available(self, wait: bool = False) -> bool:
        return self._result is not None

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        rv = self._result
        self._result = None
        return rv


def cwipc_new_encoder(version: int = 1, params: Optional[cwipc_encoder_params] = None,
                      **kw) -> cwipc_encoder_wrapper:
    return cwipc_encoder_wrapper(params=params, **kw)


def cwipc_new_encodergroup() -> cwipc_encodergroup_wrapper:
    return cwipc_encodergroup_wrapper()


def cwipc_new_decoder(device=None) -> cwipc_decoder_wrapper:
    return cwipc_decoder_wrapper(device)
