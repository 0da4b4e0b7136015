"""Masked stream compaction and the per-point ops: compact, compact_cm,
tilefilter, tilemap, crop, colormap, join and transform44.

The port of cwipc_util_tpu/ops/compaction.py.  "Remove some points" is a
keep mask, an order-preserving compaction into a buffer of the same
capacity (kernel 3, ops/compact_kernel.py) and a new device count; nothing
waits for the host.  Semantics as in the reference:

* ``tilefilter(buf, t)`` keeps points whose tile == t, or all points when
  t == 0 (exact equality, not a bitmask test — cwipc_filters.cpp:295-299);
* ``tilemap``: tile' = lut[tile] through a 256-entry table
  (cwipc_filters.cpp:308-331);
* ``crop``: lower-inclusive, upper-exclusive box (cwipc_filters.cpp:347-354);
* ``colormap``: rgba' = (rgba & ~clear) | set on the packed word, so the
  masks may touch the tile byte (cwipc_filters.cpp:362-386);
* ``join``: pc1's points, then pc2's (cwipc_filters.cpp:388-418).

Padding slots past the count read zero after every op.
"""

from __future__ import annotations

import torch

from ..core.buffers import PointBuffer
from .compact_kernel import compact_kernel_cm


def compact_cm(x, y, z, rgba, keep, count) -> PointBuffer:
    """Compaction of coordinate rows (the fused chain's form): the [N, 3]
    output is materialized once, here."""
    cx, cy, cz, crgba, nkept = compact_kernel_cm(x, y, z, rgba, keep, count)
    return PointBuffer(xyz=torch.stack([cx, cy, cz], dim=-1), rgba=crgba, count=nkept)


def compact(buf: PointBuffer, keep: torch.Tensor) -> PointBuffer:
    """Keep the masked points of ``buf``, in order; padding slots are
    zeroed.  ``keep`` is bool [capacity], restricted to the valid region."""
    x, y, z = (buf.xyz[:, a].contiguous() for a in range(3))
    return compact_cm(x, y, z, buf.rgba, keep, buf.count)


def tile_keep(rgba: torch.Tensor, tile: int) -> torch.Tensor:
    """The tile test: points whose tile byte equals ``tile``, or all points
    for tile 0."""
    if int(tile) == 0:
        return torch.ones_like(rgba, dtype=torch.bool)
    return ((rgba >> 24) & 0xFF) == int(tile)


def tilefilter(buf: PointBuffer, tile: int) -> PointBuffer:
    """Select points with tile == tile, or all points when tile == 0."""
    return compact(buf, tile_keep(buf.rgba, tile))


def _i32(word: int) -> int:
    """The int32 of a uint32 bit pattern."""
    word = int(word) & 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


def tilemap(buf: PointBuffer, lut) -> PointBuffer:
    """Rewrite every point's tile through a 256-entry table (int tensor or
    sequence of 0..255)."""
    lut = torch.as_tensor(lut, device=buf.device).to(torch.int32)
    new_tile = lut[((buf.rgba >> 24) & 0xFF).long()]
    rgba = (buf.rgba & 0x00FFFFFF) | (new_tile << 24)
    return PointBuffer(xyz=buf.xyz, rgba=torch.where(buf.valid_mask(), rgba, 0), count=buf.count)


def crop(buf: PointBuffer, bbox) -> PointBuffer:
    """Keep the points inside [x0,x1) x [y0,y1) x [z0,z1); bbox holds
    (x0, x1, y0, y1, z0, z1), rounded to f32."""
    box = torch.as_tensor(bbox, dtype=torch.float32, device=buf.device)
    inside = ((buf.xyz >= box[0::2]) & (buf.xyz < box[1::2])).all(dim=-1)
    return compact(buf, inside)


def colormap(buf: PointBuffer, clear_bits: int, set_bits: int) -> PointBuffer:
    """rgba' = (rgba & ~clear_bits) | set_bits on the packed word (uint32
    masks; the tile byte included)."""
    rgba = (buf.rgba & ~_i32(clear_bits)) | _i32(set_bits)
    return PointBuffer(xyz=buf.xyz, rgba=torch.where(buf.valid_mask(), rgba, 0), count=buf.count)


def transform44(buf: PointBuffer, matrix) -> PointBuffer:
    """Apply a 4x4 homogeneous transform (rounded to f32) to every point:
    xyz @ R^T + t in full f32.  The product runs with TF32 off on the card
    (``_full_f32_matmul``), as the JAX package asks XLA for HIGHEST: TF32
    would smear coordinates by ~1e-3 relative."""
    from .outliers import _full_f32_matmul

    m = torch.as_tensor(matrix, dtype=torch.float32, device=buf.device).reshape(4, 4)
    with _full_f32_matmul():
        xyz = buf.xyz @ m[:3, :3].T + m[:3, 3]
    return PointBuffer(xyz=torch.where(buf.valid_mask()[:, None], xyz, 0.0), rgba=buf.rgba, count=buf.count)


def join(buf1: PointBuffer, buf2: PointBuffer, capacity: int) -> PointBuffer:
    """Concatenate two buffers into a buffer of the given capacity.

    Points of buf1 come first, then points of buf2, as in the reference
    (cwipc_filters.cpp:403-409).  The counts stay on the device: each point
    is scattered to its slot, or to a sink row past ``capacity`` that is
    cut off (points that do not fit are dropped; the count is the sum)."""
    dev = buf1.device
    cap = int(capacity)
    idx1 = torch.arange(buf1.capacity, dtype=torch.int32, device=dev)
    idx2 = torch.arange(buf2.capacity, dtype=torch.int32, device=dev)
    tgt1 = torch.where(idx1 < buf1.count, idx1, cap)
    tgt2 = idx2 + buf1.count
    tgt2 = torch.where((idx2 < buf2.count) & (tgt2 < cap), tgt2, cap)
    tgt = torch.cat([tgt1, tgt2]).long()
    xyz = torch.zeros((cap + 1, 3), dtype=torch.float32, device=dev)
    rgba = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    xyz[tgt] = torch.cat([buf1.xyz, buf2.xyz])
    rgba[tgt] = torch.cat([buf1.rgba, buf2.rgba])
    return PointBuffer(xyz=xyz[:cap], rgba=rgba[:cap], count=buf1.count + buf2.count)
