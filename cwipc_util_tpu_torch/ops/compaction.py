"""Masked stream compaction: compact, compact_cm and tilefilter.

The port of the slice's part of cwipc_util_tpu/ops/compaction.py.  "Remove
some points" is a keep mask, an order-preserving compaction into a buffer
of the same capacity (kernel 3, ops/compact_kernel.py) and a new device
count; nothing waits for the host.

``tilefilter(buf, t)`` keeps points whose tile == t, or all points when
t == 0 (exact equality, not a bitmask test — cwipc_filters.cpp:295-299).
tilemap, crop, colormap, join and transform44 are not ported yet.
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
