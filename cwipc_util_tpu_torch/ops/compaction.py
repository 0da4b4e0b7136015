"""Masked stream compaction (compact, compact_cm, tilefilter) and join.

The port of the slice's part of cwipc_util_tpu/ops/compaction.py.  "Remove
some points" is a keep mask, an order-preserving compaction into a buffer
of the same capacity (kernel 3, ops/compact_kernel.py) and a new device
count; nothing waits for the host.

``tilefilter(buf, t)`` keeps points whose tile == t, or all points when
t == 0 (exact equality, not a bitmask test — cwipc_filters.cpp:295-299).
tilemap, crop, colormap and transform44 are not ported yet.
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
