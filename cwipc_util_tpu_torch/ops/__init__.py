"""Point-cloud operators on wrapper objects — the reference op API.

The port of the slice's entry points of cwipc_util_tpu/ops/__init__.py.
Each op takes and returns a :class:`cwipc_pointcloud_wrapper`; the work
runs on the wrapper's device.  Timestamp and cellsize bookkeeping as in
the reference: downsample's result cellsize is max(input cellsize,
|requested|) (cwipc_filters.cpp:103-106); tilefilter and remove_outliers
pass both through; join takes the minima of its inputs
(cwipc_filters.cpp:411-414).

Not ported yet: tilemap, colormap, crop.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

from ..core.buffers import bucket_capacity
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper
from . import compaction, outliers, voxelize
from .cols_knn import bruteforce_md_subset, cols_knn_mean_distance

__all__ = [
    "cwipc_downsample",
    "cwipc_remove_outliers",
    "cwipc_tilefilter",
    "cwipc_join",
    "cwipc_join_multi",
]


def _wrap(buf, template: cwipc_pointcloud_wrapper, cellsize=None):
    return cwipc_pointcloud_wrapper(
        buf,
        template.timestamp(),
        template.cellsize() if cellsize is None else cellsize,
    )


def cwipc_downsample(
    pc: cwipc_pointcloud_wrapper, voxelsize: float
) -> cwipc_pointcloud_wrapper:
    """Voxelize to cubes of the given size; negative selects the plain grid
    (the same math here)."""
    cellsize = abs(float(voxelsize))
    if pc.cellsize() >= cellsize:
        cellsize = pc.cellsize()
    if cellsize <= 0:
        # zero-size voxels: no-op copy (a 1/cellsize quantization would
        # divide by zero)
        return pc.clone()
    buf = pc._access_buffer()
    # The single-Morton-key fast path is exact within a 1024^3-cell domain.
    # The bounding box comes from the host cache when there is one.
    if pc.count() == 0:
        extent_cells = 0.0
    elif pc._np_cache is not None:
        arr = pc._np_cache
        extent_cells = float(
            max(
                arr["x"].max() - arr["x"].min(),
                arr["y"].max() - arr["y"].min(),
                arr["z"].max() - arr["z"].min(),
            )
        ) / cellsize
    else:
        valid = buf.valid_mask()[:, None]
        lo = torch.where(valid, buf.xyz, 3.0e38).amin(dim=0)
        hi = torch.where(valid, buf.xyz, -3.0e38).amax(dim=0)
        extent_cells = float((hi - lo).max()) / cellsize
    if extent_cells >= 1023.0:
        raise CwipcError(
            "cwipc_downsample: scenes 1023 cells or wider need the exact-key"
            " downsample, which is not yet ported"
        )
    out = voxelize.downsample(buf, cellsize)
    return _wrap(out, pc, cellsize=cellsize)


def cwipc_tilefilter(pc: cwipc_pointcloud_wrapper, tile: int) -> cwipc_pointcloud_wrapper:
    """Select points whose tile equals `tile` (0 selects all points)."""
    buf = compaction.tilefilter(pc._access_buffer(), tile)
    return _wrap(buf, pc)


def _estimate_spacing(pc: cwipc_pointcloud_wrapper) -> float:
    """Typical point spacing: the cloud's cellsize if set, else a sampled
    median nearest-neighbor distance."""
    if pc.cellsize() > 0:
        return pc.cellsize()
    arr = pc.get_numpy_matrix(onlyGeometry=True)
    n = arr.shape[0]
    if n < 2:
        return 1.0
    # Nearest neighbors are searched in a window around each sample's own
    # array position: capture and Morton orders are spatially coherent, so
    # the window contains the true neighborhood.  (Searching a fixed
    # prefix — or a sparse subset — overestimates spacing by large factors
    # for samples far from it, which inflates the grid cells downstream.)
    step = max(1, n // 512)
    idxs = np.arange(0, n, step)[:512]
    half = 2048
    nns = []
    for i in idxs:
        lo, hi = max(0, i - half), min(n, i + half)
        d2 = ((arr[i] - arr[lo:hi]) ** 2).sum(-1)
        d2[i - lo] = np.inf
        d2[d2 == 0] = np.inf  # exact duplicates are not "spacing"
        m = d2.min()
        if np.isfinite(m):
            nns.append(np.sqrt(m))
    # clamp: an all-duplicate window must not produce a zero grid cell
    return max(1e-6, float(np.median(nns))) if nns else 1.0


def _cols_grid_params(xyz: np.ndarray, cell: float, budget: int = 8_000_000):
    """Host-side column-grid parameter choice for ops/cols_knn.py: pick
    the column axis minimizing plane*cap, bucket the extents and cap.
    Extents are PERCENTILE-clipped so a single far outlier cannot explode
    the dense plane — out-of-grid points are reported uncovered by the
    kernel and fixed up exactly by brute force.  Returns
    (perm, gy, gz, cap, origin_cells) or None when no axis fits the slot
    budget; origin_cells (absolute cell coords, UNPERMUTED [3]) must be
    passed to the kernel so the grid anchors at the clipped core — a
    global-min rebase would let one far-negative outlier shift the whole
    core out of the grid (every point uncovered -> O(N^2) fixup)."""
    lo = np.percentile(xyz, 0.5, axis=0)
    hi = np.percentile(xyz, 99.5, axis=0)
    core = xyz[np.all((xyz >= lo) & (xyz <= hi), axis=1)]
    if core.shape[0] < 2:
        core = xyz
    v = np.floor(core / cell).astype(np.int64)
    origin_cells = v.min(axis=0)
    v -= origin_cells
    ext = v.max(axis=0) + 1

    def bucket(x, step=32):
        return int(-(-int(x) // step) * step)

    best = None
    for ax in range(3):
        a1, a2 = [i for i in range(3) if i != ax]
        ck = v[:, a1] * (1 << 21) + v[:, a2]
        _, cnt = np.unique(ck, return_counts=True)
        # multiple-of-4 cap: nothing in the column grid needs a power of
        # two, and pow2 rounding wastes up to 2x slots (selection cost is
        # linear in slots)
        cap = max(8, int(-(-int(cnt.max()) // 4) * 4))
        gy, gz = bucket(ext[a1]), bucket(ext[a2])
        cost = gy * gz * cap
        if best is None or cost < best[0]:
            best = (cost, (ax, a1, a2), gy, gz, cap)
    cost, perm, gy, gz, cap = best
    if cost > budget:
        return None
    return perm, gy, gz, cap, origin_cells


def _remove_outliers_single(
    pc: cwipc_pointcloud_wrapper, k: int, mult: float
) -> cwipc_pointcloud_wrapper:
    """Small clouds (n <= 4096) take the brute-force kNN; larger ones the
    column grid (kernel 4 on CUDA, its plain version on the CPU) with a
    brute-force fixup for the ring-uncovered points."""
    buf = pc._access_buffer()
    n = pc.count()
    if n <= 1:
        return _wrap(buf, pc)
    k_eff = min(int(k), n - 1)
    if n <= 4096:
        out = outliers.remove_outliers(buf, k_eff, float(mult), method="exact")
        return _wrap(out, pc)
    xyz_host = pc.get_numpy_matrix(onlyGeometry=True).astype(np.float64)
    spacing = _estimate_spacing(pc)
    # ring covers < 4*cell; d_k ~ spacing*sqrt(k/pi) for surfaces
    cell = max(1.0, float(np.sqrt(k_eff / np.pi)) / 3.0) * spacing
    params = _cols_grid_params(xyz_host, cell)
    if params is None:
        # the JAX package takes a host KD-tree here
        raise CwipcError(
            "cwipc_remove_outliers: no column grid fits this cloud; the KD-tree"
            " route for such clouds is not yet ported"
        )
    perm, gy, gz, cap, origin_cells = params
    xyz_perm = buf.xyz[:, list(perm)]
    md, unc = cols_knn_mean_distance(
        xyz_perm, buf.count, cell, k_eff, gy=gy, gz=gz, cap=cap,
        vmin_override=origin_cells[list(perm)],
    )
    md_fix = bruteforce_md_subset(xyz_perm, buf.count, unc, k_eff)
    md = torch.where(unc, md_fix, md)
    keep = outliers._keep_from_mean_dists(md, buf.valid_mask(), float(mult))
    return _wrap(compaction.compact(buf, keep), pc)


def cwipc_remove_outliers(
    pc: cwipc_pointcloud_wrapper, kNeighbors: int, stdDesvMultThresh: float, perTile: bool
) -> cwipc_pointcloud_wrapper:
    """Statistical outlier removal, optionally per tile.

    The per-tile variant mirrors the reference (cwipc_filters.cpp:238-261):
    distinct tile values in order of first appearance, each selected with
    tilefilter (so a tile value of 0 selects the whole cloud — reference
    quirk preserved), cleaned independently and concatenated.
    """
    if not perTile:
        return _remove_outliers_single(pc, kNeighbors, stdDesvMultThresh)
    tiles_arr = pc.get_numpy_array()["tile"]
    _, first_idx = np.unique(tiles_arr, return_index=True)
    tiles_in_order = tiles_arr[np.sort(first_idx)]
    parts: List[cwipc_pointcloud_wrapper] = []
    for tile in tiles_in_order:
        sub = cwipc_tilefilter(pc, int(tile))
        parts.append(_remove_outliers_single(sub, kNeighbors, stdDesvMultThresh))
        sub.free()
    if not parts:
        return _wrap(pc._access_buffer(), pc)
    rv = parts[0]
    for p in parts[1:]:
        joined = cwipc_join(rv, p)
        rv.free()
        p.free()
        rv = joined
    rv._set_timestamp(pc.timestamp())
    rv._set_cellsize(pc.cellsize())
    return rv


def cwipc_join(
    pc1: cwipc_pointcloud_wrapper, pc2: cwipc_pointcloud_wrapper
) -> cwipc_pointcloud_wrapper:
    """Concatenate two pointclouds (pc1's points first)."""
    n1, n2 = pc1.count(), pc2.count()
    cap = bucket_capacity(n1 + n2)
    buf = compaction.join(pc1._access_buffer(), pc2._access_buffer(), capacity=cap)
    return cwipc_pointcloud_wrapper(
        buf,
        min(pc1.timestamp(), pc2.timestamp()),
        min(pc1.cellsize(), pc2.cellsize()),
        _count_hint=n1 + n2,
    )


def cwipc_join_multi(pcs: Iterable[cwipc_pointcloud_wrapper]) -> cwipc_pointcloud_wrapper:
    """Join clouds left to right, freeing the intermediate results."""
    it = iter(pcs)
    try:
        acc = next(it)
    except StopIteration:
        raise TypeError("cwipc_join_multi: empty iterable") from None
    first = True
    for pc in it:
        joined = cwipc_join(acc, pc)
        if not first:
            acc.free()
        acc = joined
        first = False
    return acc
