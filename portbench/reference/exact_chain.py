"""The plain reference of the exact cleaning chain, in PyTorch.

What cwipc's exact chain (downsample, statistical outlier removal, tile
filter) is to give for one frame, worked out from the frame's points
alone, on any device.  It imports nothing of the program under test.

1. Voxel downsample (PCL VoxelGrid, one grid, as the program documents
   it).  A point's cell is ``v = floor(x * (1 / cell))`` with the product
   rounded to float32, the configuration's rule; its offset in the cell
   is kept to 10 bits, ``q = floor((x * (1 / cell) - v) * 1024)`` in
   float32, and stands for the centre of its 1/1024 step.  A voxel's
   centroid is ``(v + mean((q + 0.5) / 1024)) * cell``, its colour the
   truncated mean of r, g and b, its tile the OR of its points' tiles.
   Voxels are ordered by the Morton key of ``v`` less the frame's least
   ``v``, 10 bits an axis.
2. For every voxel the mean distance to its k nearest other voxels,
   exactly: distances in blocks of rows against the slab of voxels whose
   y lies within ``slab`` of the block's, taken as final where the k-th
   distance is under ``slab``, and against all voxels elsewhere.
3. Keep where md <= mean + mult * sigma over all voxels (sigma with n - 1),
   and where the tile test passes (tile 0: every voxel).
4. The kept voxels in Morton order.

The floating-point steps (centroids, means, distances, moments) run in
``dtype``: float64 for the reference, bfloat16 for the control that must
fail the comparison.  The cell index, the offsets and the colours' sums
are integers by the rule above.
"""

from __future__ import annotations

import torch

MORTON_BITS = 10


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so that two zero bits follow each."""
    out = torch.zeros_like(x)
    for b in range(MORTON_BITS):
        out |= ((x >> b) & 1) << (3 * b)
    return out


def morton(vm: torch.Tensor) -> torch.Tensor:
    """Morton keys int64 [n] of non-negative cell coordinates int64 [n, 3]
    under 1024: x in the lowest bit of each triple, then y, then z."""
    return _part1by2(vm[:, 0]) | (_part1by2(vm[:, 1]) << 1) | (_part1by2(vm[:, 2]) << 2)


def f32_scale(x32: torch.Tensor, cell: float) -> torch.Tensor:
    """``x * (1 / cell)`` as float32 multiplies it: the float64 product of
    two float32 values is exact, and one rounding to float32 follows."""
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(cell, dtype=torch.float32)
    return (x32.to(torch.float64) * float(inv)).to(torch.float32)


def downsample(xyz32: torch.Tensor, rgba: torch.Tensor, n: int, cell: float, dtype=torch.float64) -> dict:
    """Step 1 for the first ``n`` points of xyz f32 [*, 3], rgba int32 [*]."""
    xyz32, rgba = xyz32[:n], rgba[:n]
    scaled = f32_scale(xyz32, cell)
    v = torch.floor(scaled).to(torch.int64)
    q = torch.clamp(((scaled - v.to(torch.float32)) * 1024.0).to(torch.int64), 0, 1023)
    vmin = v.amin(0)
    vm = v - vmin
    if int(vm.max()) >= 1 << MORTON_BITS:
        raise ValueError("the frame spans 1024 cells or more: outside the chain's Morton key")
    key, inv = torch.unique(morton(vm), sorted=True, return_inverse=True)
    m = key.shape[0]
    dev = xyz32.device

    def vsum(vals: torch.Tensor) -> torch.Tensor:
        return torch.zeros((m,) + vals.shape[1:], dtype=vals.dtype, device=dev).index_add_(0, inv, vals)

    cnt = vsum(torch.ones(n, dtype=torch.int64, device=dev))
    vox = torch.empty((m, 3), dtype=torch.int64, device=dev)
    vox[inv] = v  # every point of a voxel has its cell
    frac = vsum(((q.to(dtype) + 0.5) / 1024).to(dtype))
    cell_d = torch.tensor(cell, dtype=torch.float32).to(dtype)
    centroid = (vox.to(dtype) + frac / cnt[:, None].to(dtype)) * cell_d.to(dev)
    r, g, b = ((rgba >> s) & 0xFF for s in (16, 8, 0))
    if dtype == torch.float64:
        rgb = vsum(torch.stack([r, g, b], 1).to(torch.int64)) // cnt[:, None]
    else:  # the control: the mean colour in its own precision, truncated
        rgb = (vsum(torch.stack([r, g, b], 1).to(dtype)) / cnt[:, None].to(dtype)).to(torch.int64)
    tile = (rgba >> 24) & 0xFF
    bits = vsum(((tile[:, None] >> torch.arange(8, device=dev)) & 1).to(torch.int64))
    tile_or = ((bits > 0).to(torch.int64) << torch.arange(8, device=dev)).sum(1)
    return {"key": key, "vox": vox, "vmin": vmin, "count": cnt, "centroid": centroid, "rgb": rgb, "tile": tile_or}


def _knn_rows(rows: torch.Tensor, cand: torch.Tensor, self_col: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum and k-th of the k smallest distances from rows [B, 3] to cand
    [C, 3], leaving out column ``self_col[i]`` for row i (-1: none)."""
    d2 = ((rows[:, None, :] - cand[None, :, :]) ** 2).sum(-1)
    cols = torch.arange(cand.shape[0], device=cand.device)
    d2 = torch.where(cols[None, :] == self_col[:, None], torch.inf, d2)
    small = torch.topk(d2, k, dim=1, largest=False).values
    dist = torch.sqrt(small)
    return dist.sum(1), dist[:, -1]


def knn_mean_distance(c: torch.Tensor, k: int, slab: float, block: int = 1024) -> torch.Tensor:
    """Step 2: md [m] of centroids c [m, 3], in c's dtype, exact."""
    m = c.shape[0]
    order = torch.argsort(c[:, 1].to(torch.float64))
    cs = c[order]
    ys = cs[:, 1].to(torch.float64).contiguous()
    md = torch.empty(m, dtype=c.dtype, device=c.device)
    redo = []
    for i0 in range(0, m, block):
        i1 = min(m, i0 + block)
        lo = int(torch.searchsorted(ys, ys[i0] - slab))
        hi = int(torch.searchsorted(ys, ys[i1 - 1] + slab, right=True))
        self_col = torch.arange(i0, i1, device=c.device) - lo
        s, kth = _knn_rows(cs[i0:i1], cs[lo:hi], self_col, k)
        md[i0:i1] = s / k
        # a neighbour outside the slab is over ``slab`` away in y alone
        far = (kth.to(torch.float64) >= slab).nonzero().squeeze(1) + i0
        redo.append(far)
    far = torch.cat(redo)
    for j0 in range(0, far.shape[0], 256):
        rows = far[j0:j0 + 256]
        s, _ = _knn_rows(cs[rows], cs, rows, k)
        md[rows] = s / k
    out = torch.empty_like(md)
    out[order] = md
    return out


def threshold(md: torch.Tensor, mult: float) -> torch.Tensor:
    """Step 3's bound, mean + mult * sigma (n - 1), in md's dtype."""
    n = md.shape[0]
    mean = md.sum() / n
    var = ((md - mean) ** 2).sum() / max(n - 1, 1)
    return mean + mult * torch.sqrt(var)


def run(xyz32, rgba, n: int, *, cellsize: float, k: int, mult: float, tile: int, slab: float,
        dtype=torch.float64) -> dict:
    """Steps 1-4 for one frame: the downsample's fields, md, thr, keep and
    the kept voxels' indices in Morton order (``kept``)."""
    vox = downsample(xyz32, rgba, n, cellsize, dtype)
    md = knn_mean_distance(vox["centroid"], k, slab)
    thr = threshold(md, mult)
    keep = md <= thr
    if tile != 0:
        keep &= vox["tile"] == tile
    vox.update(md=md, thr=thr, keep=keep, kept=keep.nonzero().squeeze(1))
    return vox
