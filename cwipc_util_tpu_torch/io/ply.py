"""PLY reader/writer for cwipc point clouds.

The reference delegates to pcl::PLYReader / pcl::PLYWriter
(reference: src/cwipc_util.cpp:432-497).  For PointXYZRGBMask clouds PCL
emits ``property float x/y/z`` plus ``property uchar red/green/blue/alpha``
where the alpha byte carries the tile mask; we write the same layout (ascii
and binary_little_endian) and read a superset:

* float/double x, y, z
* colors as red/green/blue[/alpha] uchar, r/g/b, or a packed rgb/rgba uint
* alpha (or an explicit ``tile``/``mask`` property) becomes the tile byte

Unknown vertex properties are skipped; non-vertex elements are ignored.

The port of cwipc_util_tpu/io/ply.py.  A file reads into a host-backed
cloud whose buffer is built on the caller's ``device`` (``None`` means
CUDA) at first use.
"""

from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np

from ..core.buffers import POINT_DTYPE
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper

CWIPC_FLAGS_BINARY = 1

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(fp: io.BufferedReader) -> Tuple[str, int, List[Tuple[str, str]], List[Tuple[str, int, List[Tuple[str, str]]]]]:
    magic = fp.readline().strip()
    if magic != b"ply":
        raise CwipcError("ply: not a PLY file")
    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    while True:
        line = fp.readline()
        if not line:
            raise CwipcError("ply: truncated header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        kw = tokens[0]
        if kw == "comment" or kw == "obj_info":
            continue
        if kw == "format":
            fmt = tokens[1]
        elif kw == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif kw == "property":
            if not elements:
                raise CwipcError("ply: property before element")
            if tokens[1] == "list":
                # list property: record count type + item type, e.g. face indices
                elements[-1][2].append((tokens[4], f"list:{tokens[2]}:{tokens[3]}"))
            else:
                elements[-1][2].append((tokens[2], tokens[1]))
        elif kw == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise CwipcError(f"ply: unsupported format {fmt}")
    vertex = next((e for e in elements if e[0] == "vertex"), None)
    if vertex is None:
        raise CwipcError("ply: no vertex element")
    return fmt, vertex[1], vertex[2], elements


def _read_vertex_data(fp, fmt: str, count: int, props: List[Tuple[str, str]]) -> np.ndarray:
    if any(t.startswith("list:") for _, t in props):
        raise CwipcError("ply: list properties on vertex element not supported")
    endian = ">" if fmt == "binary_big_endian" else "<"
    dtype = np.dtype([(name, endian + _PLY_TYPES[typ]) for name, typ in props])
    if fmt == "ascii":
        text = fp.read().decode("ascii", "replace").split()
        ncol = len(props)
        if len(text) < count * ncol:
            raise CwipcError("ply: truncated ascii data")
        flat = text[: count * ncol]
        arr = np.zeros(count, dtype)
        cols = np.array(flat, dtype=object).reshape(count, ncol)
        for i, (name, typ) in enumerate(props):
            kind = _PLY_TYPES[typ]
            arr[name] = cols[:, i].astype(np.dtype(kind))
        return arr
    raw = fp.read(count * dtype.itemsize)
    if len(raw) < count * dtype.itemsize:
        raise CwipcError("ply: truncated binary data")
    return np.frombuffer(raw, dtype, count=count)


def _skip_element_data(fp, fmt: str, count: int, props: List[Tuple[str, str]]) -> None:
    """Consume the data of a non-vertex element declared BEFORE vertex, so
    the vertex read starts at the right offset."""
    if fmt == "ascii":
        # canonical ascii PLY: one row per line (holds for list rows too)
        for _ in range(count):
            if not fp.readline():
                raise CwipcError("ply: truncated ascii data")
        return
    if any(t.startswith("list:") for _, t in props):
        raise CwipcError("ply: list-property element before vertex not supported")
    endian = ">" if fmt == "binary_big_endian" else "<"
    rowsize = np.dtype([(name, endian + _PLY_TYPES[typ]) for name, typ in props]).itemsize
    if len(fp.read(count * rowsize)) < count * rowsize:
        raise CwipcError("ply: truncated binary data")


def read_ply(filename: str, timestamp: int, device=None) -> cwipc_pointcloud_wrapper:
    try:
        fp = open(filename, "rb")
    except OSError as e:
        raise CwipcError(f"cwipc_read: {filename}: {e.strerror}") from e
    with fp:
        fmt, count, props, elements = _parse_header(fp)
        for name, ecount, eprops in elements:
            if name == "vertex":
                break
            _skip_element_data(fp, fmt, ecount, eprops)
        arr = _read_vertex_data(fp, fmt, count, props)

    names = arr.dtype.names or ()

    def col(name: str) -> Optional[np.ndarray]:
        return arr[name] if name in names else None

    x, y, z = col("x"), col("y"), col("z")
    if x is None or y is None or z is None:
        raise CwipcError("ply: vertex element lacks x/y/z")
    xyz = np.stack([x, y, z], axis=-1).astype(np.float32)

    n = xyz.shape[0]
    r = g = b = None
    tile = np.zeros(n, np.uint8)
    if "red" in names:
        # tolerate partial color triplets (e.g. red-only grayscale exports)
        zero = np.zeros(n, np.uint8)
        r = col("red")
        g = col("green") if "green" in names else zero
        b = col("blue") if "blue" in names else zero
        if "alpha" in names:
            tile = arr["alpha"].astype(np.uint8)
    elif "r" in names and "g" in names and "b" in names:
        r, g, b = col("r"), col("g"), col("b")
    elif "rgba" in names:
        packed = arr["rgba"].astype(np.uint32)
        r = (packed >> 16) & 0xFF
        g = (packed >> 8) & 0xFF
        b = packed & 0xFF
        tile = ((packed >> 24) & 0xFF).astype(np.uint8)
    elif "rgb" in names:
        packed = arr["rgb"].view(np.uint32) if arr["rgb"].dtype.kind == "f" else arr["rgb"].astype(np.uint32)
        r = (packed >> 16) & 0xFF
        g = (packed >> 8) & 0xFF
        b = packed & 0xFF
    if r is None:
        r = g = b = np.zeros(n, np.uint8)
    if "tile" in names:
        tile = arr["tile"].astype(np.uint8)
    elif "mask" in names:
        tile = arr["mask"].astype(np.uint8)

    # host-backed cloud: the device buffer is built only when an op needs it
    pts = np.empty(n, POINT_DTYPE)
    pts["x"] = xyz[:, 0]
    pts["y"] = xyz[:, 1]
    pts["z"] = xyz[:, 2]
    pts["r"] = np.asarray(r, np.uint8)
    pts["g"] = np.asarray(g, np.uint8)
    pts["b"] = np.asarray(b, np.uint8)
    pts["tile"] = tile
    return cwipc_pointcloud_wrapper(None, timestamp, 0.0, _host_points=pts, device=device)


def write_ply(filename: str, pc: cwipc_pointcloud_wrapper, flags: int = 0) -> int:
    arr = pc.get_numpy_array()
    n = arr.shape[0]
    binary = bool(flags & CWIPC_FLAGS_BINARY)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        "comment Created by cwipc_util_tpu\n"
        f"element vertex {n}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "property uchar red\n"
        "property uchar green\n"
        "property uchar blue\n"
        "property uchar alpha\n"
        "end_header\n"
    )
    try:
        fp = open(filename, "wb")
    except OSError as e:
        raise CwipcError(f"cwipc_write: {filename}: {e.strerror}") from e
    with fp:
        fp.write(header.encode("ascii"))
        if binary:
            out = np.zeros(
                n,
                np.dtype(
                    [
                        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("red", "u1"), ("green", "u1"), ("blue", "u1"), ("alpha", "u1"),
                    ]
                ),
            )
            out["x"], out["y"], out["z"] = arr["x"], arr["y"], arr["z"]
            out["red"], out["green"], out["blue"] = arr["r"], arr["g"], arr["b"]
            out["alpha"] = arr["tile"]
            fp.write(out.tobytes())
        else:
            lines = []
            for p in arr:
                # %.9g round-trips float32 exactly
                lines.append(
                    "%.9g %.9g %.9g %d %d %d %d"
                    % (p["x"], p["y"], p["z"], p["r"], p["g"], p["b"], p["tile"])
                )
            fp.write(("\n".join(lines) + ("\n" if lines else "")).encode("ascii"))
    return 0
