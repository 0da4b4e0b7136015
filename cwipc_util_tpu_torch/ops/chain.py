"""The fused downsample -> outlier removal -> tilefilter chain.

The port of cwipc_util_tpu/ops/chain.py's fast chain, the framework's hot
path.  The same channel-major flow: the segmented reduce (kernel 1) emits
coordinate rows, the window kNN (kernel 2) and the compaction (kernel 3)
consume rows, and the [N, 3] form is built once, at the output.  Counts
stay 0-d device tensors that the kernels read through pointers, so the
chain never waits for the host.
"""

from __future__ import annotations

import torch

from ..core.buffers import PointBuffer
from . import compaction, outliers, voxelize
from .window_knn import window_knn_mean_distance_cm


def downsample_outliers_tilefilter(
    buf: PointBuffer,
    cellsize: float,
    k: int,
    mult: float,
    tile: int,
    window: int = 16,
    out_capacity: int | None = None,
) -> PointBuffer:
    """Fused voxel downsample -> statistical outlier removal -> tilefilter.

    ``out_capacity`` bounds the post-downsample buffer; the outlier stage
    is the Morton sliding-window kNN over +/-``window`` neighbours, an
    approximation by contract (see the JAX module's docstring for its
    agreement with the exact chain)."""
    ocap = buf.capacity if out_capacity is None else out_capacity
    x, y, z, rgba, cnt = voxelize.downsample_cm(buf, cellsize, ocap)
    return chain_tail_cm(x, y, z, rgba, cnt, k=k, window=window, mult=mult, tile=tile)


def keep_mask(md, rgba, cnt, mult: float, tile: int) -> torch.Tensor:
    """The outlier keep mask from the mean distances, fused with the tile
    selection."""
    valid = torch.arange(md.shape[0], dtype=torch.int32, device=md.device) < cnt
    return outliers._keep_from_mean_dists(md, valid, mult) & compaction.tile_keep(rgba, tile)


def chain_tail_cm(x, y, z, rgba, cnt, *, k, window, mult, tile) -> PointBuffer:
    """Post-downsample tail of the fused chain on channel-major rows:
    window-kNN keep mask fused with the tile selection, then one
    compaction."""
    md = window_knn_mean_distance_cm(x, y, z, cnt, k, window)
    keep = keep_mask(md, rgba, cnt, mult, tile)
    return compaction.compact_cm(x, y, z, rgba, keep, cnt)
