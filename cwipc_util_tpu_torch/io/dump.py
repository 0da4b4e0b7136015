"""cwipcdump / packet serialization — bit-compatible with the reference.

The port of cwipc_util_tpu/io/dump.py.  Clouds read from a packet or a
file are host-backed and build their buffer on the caller's ``device``
(``None`` means CUDA) at first use.

Wire/file format (reference: include/cwipc_util/api.h:53-66):

    32-byte header: char hdr[4]="cpcd", uint32 magic=0x20210208,
                    uint64 timestamp, float cellsize, uint32 unused,
                    uint64 size(bytes of point data)
    followed by `size` bytes of packed 16-byte cwipc_point records.

The same layout is used for in-memory packets (`copy_packet`,
src/cwipc_util.cpp:252-290) and .cwipcdump files
(src/cwipc_util.cpp:499-641).
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.buffers import POINT_DTYPE, POINT_SIZE
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper

CWIPC_CWIPCDUMP_HEADER = b"cpcd"
CWIPC_CWIPCDUMP_VERSION = 0x20210208

_HDR_FMT = "<4sIQfIQ"
_HDR_SIZE = struct.calcsize(_HDR_FMT)
assert _HDR_SIZE == 32


def packet_from_pointcloud(pc: cwipc_pointcloud_wrapper) -> bytearray:
    data = pc.get_bytes()
    hdr = struct.pack(
        _HDR_FMT,
        CWIPC_CWIPCDUMP_HEADER,
        CWIPC_CWIPCDUMP_VERSION,
        pc.timestamp(),
        pc.cellsize(),
        0,
        len(data),
    )
    return bytearray(hdr) + data


def pointcloud_from_packet(packet: bytes, device=None) -> cwipc_pointcloud_wrapper:
    if len(packet) < _HDR_SIZE:
        raise CwipcError("cwipc_from_packet: packet too short")
    hdr, magic, timestamp, cellsize, _unused, size = struct.unpack_from(
        _HDR_FMT, packet, 0
    )
    if hdr != CWIPC_CWIPCDUMP_HEADER:
        raise CwipcError("cwipc_from_packet: bad header")
    if magic != CWIPC_CWIPCDUMP_VERSION:
        raise CwipcError("cwipc_from_packet: bad version")
    if len(packet) - _HDR_SIZE != size or size % POINT_SIZE != 0:
        raise CwipcError("cwipc_from_packet: inconsistent size")
    # host-backed: the raw packet bytes are the POINT_DTYPE layout; one
    # copy, since callers reuse their packet buffers
    pts = np.frombuffer(packet, dtype=POINT_DTYPE, offset=_HDR_SIZE).copy()
    return cwipc_pointcloud_wrapper(None, timestamp, cellsize, _host_points=pts, device=device)


def write_debugdump(filename: str, pc: cwipc_pointcloud_wrapper) -> int:
    try:
        with open(filename, "wb") as fp:
            fp.write(packet_from_pointcloud(pc))
    except OSError as e:
        raise CwipcError(f"cwipc_write_debugdump: {filename}: {e.strerror}") from e
    return 0


def read_debugdump(filename: str, device=None) -> cwipc_pointcloud_wrapper:
    try:
        with open(filename, "rb") as fp:
            data = fp.read()
    except OSError as e:
        raise CwipcError(f"cwipc_read_debugdump: {filename}: {e.strerror}") from e
    try:
        return pointcloud_from_packet(data, device)
    except CwipcError as e:
        raise CwipcError(f"cwipc_read_debugdump: {filename}: {e}") from e
