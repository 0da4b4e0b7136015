"""The fused downsample -> outlier removal -> tilefilter chains.

The port of cwipc_util_tpu/ops/chain.py.  The fast chain is the
framework's hot path, in the same channel-major flow: the segmented reduce
(kernel 1) emits coordinate rows, the window kNN (kernel 2) and the
compaction (kernel 3) consume rows, and the [N, 3] form is built once, at
the output.  Counts stay 0-d device tensors that the kernels read through
pointers, so the fast chain never waits for the host.

The exact chain replaces the window kNN by the column-grid exact kNN
(kernel 4) and a brute-force fixup.
"""

from __future__ import annotations

import torch

from ..core.buffers import PointBuffer
from ..utils.trace import span
from . import compaction, outliers, voxelize
from .cols_knn import bruteforce_md_subset, cols_knn_mean_distance
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


def downsample_outliers_tilefilter_exact(
    buf: PointBuffer,
    cellsize: float,
    k: int,
    mult: float,
    tile: int,
    out_capacity: int,
    gy: int,
    gz: int,
    cap: int,
    chunk: int = 256,
    cell_normal: bool = False,
) -> tuple[PointBuffer, torch.Tensor]:
    """Exact-outlier variant of the fused chain: the outlier stage is the
    column-grid exact kNN (ops/cols_knn.py, kernel 4) plus a brute-force
    fixup for the ring-uncovered points, so the keep decisions match a
    brute-force oracle up to the order of floating-point summation.
    gy/gz/cap are the column-grid buckets of the downsampled cloud (y/z
    extents in cells, most points in one (y, z) column); ``chunk`` sets
    the planes' padding and the plain selection's chunk size.
    ``cell_normal`` is kept for the JAX signature and unused: kernel 4
    does not seed its bisection.

    Returns (result, n_uncovered): the 0-d count of points whose md came
    from the fixup.  The fixup reads that count on the host once (its trip
    count); the rest of the chain stays on the device."""
    with span("cwipc.exact"):
        x, y, z, rgba, cnt = voxelize.downsample_cm(buf, cellsize, out_capacity)
        xyz = torch.stack([x, y, z], dim=-1)
        # voxel_unique: the downsample postcondition allows the plain
        # selection's per-column pre-selection
        md, unc = cols_knn_mean_distance(xyz, cnt, cellsize, k, gy=gy, gz=gz, cap=cap, chunk=chunk,
                                         voxel_unique=True)
        md_fix = bruteforce_md_subset(xyz, cnt, unc, k)
        md = torch.where(unc, md_fix, md)
        keep = keep_mask(md, rgba, cnt, mult, tile)
        return compaction.compact_cm(x, y, z, rgba, keep, cnt), unc.sum(dtype=torch.int32)
